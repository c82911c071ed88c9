// golden_dump: runs a fixed query set through the REAL reference engine
// (google/supersonic built from /root/reference) on deterministic seeded
// inputs, and dumps both the inputs and the query outputs via FileSink
// (cursor/infrastructure/file_io.cc:194) in the reference's binary columnar
// wire format.  tests/test_golden.py reads these files back with
// supersonic_jax/io/file_io.py::read_reference_file, runs the same plans
// through the JAX engine, and asserts row-for-row equality — the
// bit-exactness correctness loop against the actual C++ engine (not a
// Python model of it).
//
// Query set: the guide queries (test/guide/{primer,group_sort,join}.cc)
// and the benchmark example workloads
// (supersonic/benchmark/examples/operation_example.cc:24-90), at sizes
// scaled to cross several 8192-row FileSink chunks.
//
// Usage: golden_dump <output_dir>    (writes *.dat + manifest on stdout)
//
// Manifest format, one line per file:
//   in  <case> <index> <filename> <rows> <name:TYPE:N|Y,...>
//   out <case> <filename> <rows> <name:TYPE:N|Y,...>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <memory>
#include <random>
#include <string>
#include <vector>

#include "supersonic/supersonic.h"
#include "supersonic/expression/core/stateful_expressions.h"
#include "supersonic/cursor/core/foreign_filter.h"
#include "supersonic/serialization/build_expression_from_proto.h"
#include "supersonic/utils/proto/expressions.pb.h"
#include "supersonic/cursor/core/merge_union_all.h"
#include "supersonic/cursor/core/rowid_merge_join.h"
#include "supersonic/cursor/core/scan_view.h"
#include "supersonic/cursor/infrastructure/file_io.h"
#include "supersonic/cursor/infrastructure/table.h"
#include "supersonic/cursor/infrastructure/writer.h"
#include "supersonic/utils/file.h"
#include "supersonic/utils/exception/failureor.h"

using namespace supersonic;  // NOLINT

namespace {

std::string g_outdir;

const char* TypeName(DataType t) {
  switch (t) {
    case INT32: return "INT32";
    case INT64: return "INT64";
    case UINT32: return "UINT32";
    case UINT64: return "UINT64";
    case FLOAT: return "FLOAT";
    case DOUBLE: return "DOUBLE";
    case BOOL: return "BOOL";
    case DATE: return "DATE";
    case DATETIME: return "DATETIME";
    case STRING: return "STRING";
    case BINARY: return "BINARY";
    case ENUM: return "ENUM";
    default: return "?";
  }
}

std::string SchemaSpec(const TupleSchema& schema) {
  std::string spec;
  for (int i = 0; i < schema.attribute_count(); ++i) {
    const Attribute& a = schema.attribute(i);
    if (i) spec += ",";
    spec += a.name();
    spec += ":";
    spec += TypeName(a.type());
    spec += a.is_nullable() ? ":Y" : ":N";
  }
  return spec;
}

void DumpView(const View& view, const std::string& filename) {
  File* f = File::OpenOrDie(g_outdir + "/" + filename, "w");
  std::unique_ptr<Sink> sink(FileOutput(f, TAKE_OWNERSHIP));
  SucceedOrDie(sink->Write(view));
  SucceedOrDie(sink->Finalize());
}

void DumpInput(const char* case_name, int index, const Table& table) {
  char filename[256];
  snprintf(filename, sizeof(filename), "%s_in%d.dat", case_name, index);
  DumpView(table.view(), filename);
  printf("in %s %d %s %llu %s\n", case_name, index, filename,
         (unsigned long long)table.view().row_count(),
         SchemaSpec(table.schema()).c_str());
}

void RunAndDump(const char* case_name, Operation* op) {
  std::unique_ptr<Operation> owned(op);
  owned->SetBufferAllocator(HeapBufferAllocator::Get(), false);
  std::unique_ptr<Cursor> cursor(SucceedOrDie(owned->CreateCursor()));
  char filename[256];
  snprintf(filename, sizeof(filename), "%s_out.dat", case_name);
  File* f = File::OpenOrDie(g_outdir + "/" + filename, "w");
  std::unique_ptr<Sink> sink(FileOutput(f, TAKE_OWNERSHIP));
  Writer writer(cursor.release());
  rowcount_t rows = SucceedOrDie(writer.WriteAll(sink.get()));
  SucceedOrDie(sink->Finalize());
  printf("out %s %s %llu %s\n", case_name, filename,
         (unsigned long long)rows,
         SchemaSpec(writer.schema()).c_str());
  fflush(stdout);
}

BufferAllocator* Alloc() { return HeapBufferAllocator::Get(); }

// ---------------------------------------------------------------------------
// Cases.  Every case builds its own seeded inputs, dumps them, then dumps
// the reference engine's output for a plan over those inputs.

// primer.cc:256-313: GROUP BY int32 key, SUM(double).
void CasePrimerSum() {
  TupleSchema schema;
  schema.add_attribute(Attribute("key", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("data", DOUBLE, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(101);
  std::uniform_int_distribution<int32> key_d(0, 96);
  std::uniform_real_distribution<double> val_d(-4.0, 4.0);
  for (int i = 0; i < 10000; ++i)
    w.AddRow().Int32(key_d(rng)).Double(val_d(rng));
  w.CheckSuccess();
  DumpInput("primer_sum", 0, table);

  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregation(SUM, "data", "data_sums");
  RunAndDump("primer_sum",
             GroupAggregate(ProjectNamedAttribute("key"), spec, NULL,
                            ScanView(table.view())));
}

// group_sort.cc employees: multi-aggregate group-by over a STRING key with
// a nullable INT32 input (COUNT counts non-NULL, column_aggregator.cc:198+).
void CaseGuideAgg() {
  TupleSchema schema;
  schema.add_attribute(Attribute("department", STRING, NOT_NULLABLE));
  schema.add_attribute(Attribute("age", INT32, NULLABLE));
  schema.add_attribute(Attribute("salary", INT32, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(202);
  std::uniform_int_distribution<int> dept_d(0, 6);
  std::uniform_int_distribution<int32> age_d(18, 65);
  std::uniform_int_distribution<int32> sal_d(1000, 20000);
  std::uniform_real_distribution<double> null_d(0.0, 1.0);
  const char* depts[7] = {"sales", "eng", "hr", "ops", "legal", "mkt", "it"};
  for (int i = 0; i < 12000; ++i) {
    w.AddRow().String(depts[dept_d(rng)]);
    if (null_d(rng) < 0.1) w.Null(); else w.Int32(age_d(rng));
    w.Int32(sal_d(rng));
  }
  w.CheckSuccess();
  DumpInput("guide_agg", 0, table);

  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregation(SUM, "salary", "salary_sum");
  spec->AddAggregation(MIN, "age", "age_min");
  spec->AddAggregation(MAX, "age", "age_max");
  spec->AddAggregation(COUNT, "age", "age_cnt");
  RunAndDump("guide_agg",
             GroupAggregate(ProjectNamedAttribute("department"), spec, NULL,
                            ScanView(table.view())));
}

// group_sort.cc sorting: ORDER BY grade DESC, id ASC (deterministic order).
void CaseGuideSort() {
  TupleSchema schema;
  schema.add_attribute(Attribute("id", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("grade", DOUBLE, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(303);
  std::uniform_int_distribution<int32> grade_d(2, 12);  // ties on purpose
  for (int i = 0; i < 9000; ++i)
    w.AddRow().Int32(i).Double(grade_d(rng) / 2.0);
  w.CheckSuccess();
  DumpInput("guide_sort", 0, table);

  SortOrder* order = new SortOrder();
  order->OrderByNamedAttribute("grade", DESCENDING);
  order->OrderByNamedAttribute("id", ASCENDING);
  RunAndDump("guide_sort",
             Sort(order, ProjectAllAttributes(),
                  std::numeric_limits<size_t>::max(),
                  ScanView(table.view())));
}

// join.cc books x authors: INNER UNIQUE hash join on a NULLABLE int32 FK
// (NULL keys never match, hash_join.cc:67-76) with DATE and BOOL columns.
void CaseGuideJoin() {
  TupleSchema authors;
  authors.add_attribute(Attribute("author_id", INT32, NOT_NULLABLE));
  authors.add_attribute(Attribute("name", STRING, NOT_NULLABLE));
  authors.add_attribute(Attribute("nobel", BOOL, NOT_NULLABLE));
  Table author_table(authors, Alloc());
  {
    TableRowWriter w(&author_table);
    std::mt19937 rng(404);
    std::uniform_int_distribution<int> coin(0, 1);
    for (int i = 0; i < 200; ++i) {
      char name[64];
      snprintf(name, sizeof(name), "author_%03d", i);
      w.AddRow().Int32(i).String(name).Bool(coin(rng) == 1);
    }
    w.CheckSuccess();
  }
  DumpInput("guide_join", 0, author_table);

  TupleSchema books;
  books.add_attribute(Attribute("book_id", INT32, NOT_NULLABLE));
  books.add_attribute(Attribute("author_id_ref", INT32, NULLABLE));
  books.add_attribute(Attribute("title", STRING, NOT_NULLABLE));
  books.add_attribute(Attribute("date_published", DATE, NULLABLE));
  Table book_table(books, Alloc());
  {
    TableRowWriter w(&book_table);
    std::mt19937 rng(505);
    std::uniform_int_distribution<int32> fk_d(0, 299);  // some dangle
    std::uniform_int_distribution<int32> date_d(0, 20000);
    std::uniform_real_distribution<double> null_d(0.0, 1.0);
    for (int i = 0; i < 15000; ++i) {
      w.AddRow().Int32(i);
      if (null_d(rng) < 0.05) w.Null(); else w.Int32(fk_d(rng));
      char title[64];
      snprintf(title, sizeof(title), "title_%05d", i);
      w.String(title);
      if (null_d(rng) < 0.1) w.Null(); else w.Date(date_d(rng));
    }
    w.CheckSuccess();
  }
  DumpInput("guide_join", 1, book_table);

  CompoundMultiSourceProjector* projector =
      new CompoundMultiSourceProjector();
  projector->add(0, ProjectNamedAttribute("book_id"));
  projector->add(0, ProjectNamedAttribute("title"));
  projector->add(0, ProjectNamedAttribute("date_published"));
  projector->add(1, ProjectNamedAttribute("name"));
  projector->add(1, ProjectNamedAttribute("nobel"));
  RunAndDump("guide_join",
             new HashJoinOperation(
                 INNER, ProjectNamedAttribute("author_id_ref"),
                 ProjectNamedAttribute("author_id"), projector, UNIQUE,
                 ScanView(book_table.view()),
                 ScanView(author_table.view())));
}

// operation_example.cc:46-59: 50 STRING group keys, MAX(int32).
Table* BuildBenchGroupInput() {
  TupleSchema schema;
  schema.add_attribute(Attribute("col0", STRING, NOT_NULLABLE));
  schema.add_attribute(Attribute("col1", INT32, NOT_NULLABLE));
  Table* table = new Table(schema, Alloc());
  TableRowWriter w(table);
  std::mt19937 rng(606);
  for (int i = 0; i < 20000; ++i) {
    char key[64];
    snprintf(key, sizeof(key), "test_string_%d", i % 50);
    w.AddRow().String(key).Int32((int32)rng());
  }
  w.CheckSuccess();
  return table;
}

Operation* BenchGroupOp(const Table& table) {
  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregation(MAX, "col1", "col1_maxes");
  return GroupAggregate(ProjectNamedAttribute("col0"), spec, NULL,
                        ScanView(table.view()));
}

void CaseBenchGroup() {
  std::unique_ptr<Table> table(BuildBenchGroupInput());
  DumpInput("bench_group", 0, *table);
  RunAndDump("bench_group", BenchGroupOp(*table));
}

// operation_example.cc:61-71: Compute col0 * (sin(col2) + exp(col1)) —
// value ranges bounded so exp() stays finite (semantics, not overflow).
void CaseBenchCompute() {
  TupleSchema schema;
  schema.add_attribute(Attribute("col0", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("col1", INT64, NOT_NULLABLE));
  schema.add_attribute(Attribute("col2", DOUBLE, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(707);
  std::uniform_int_distribution<int32> i32_d(-1000, 1000);
  std::uniform_int_distribution<int64> i64_d(-8, 8);
  std::uniform_real_distribution<double> d_d(0.0, 1.0);
  for (int i = 0; i < 20000; ++i)
    w.AddRow().Int32(i32_d(rng)).Int64(i64_d(rng)).Double(d_d(rng));
  w.CheckSuccess();
  DumpInput("bench_compute", 0, table);

  RunAndDump("bench_compute",
             Compute(Multiply(AttributeAt(0),
                              Plus(Sin(AttributeAt(2)),
                                   Exp(AttributeAt(1)))),
                     ScanView(table.view())));
}

// operation_example.cc:73-91: 2-key sort (INT32 ASC, STRING DESC); col0 has
// ties (small domain) broken deterministically by the distinct col1 strings.
Table* BuildBenchSortInput(int rows, int seed) {
  TupleSchema schema;
  schema.add_attribute(Attribute("col0", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("col1", STRING, NOT_NULLABLE));
  Table* table = new Table(schema, Alloc());
  TableRowWriter w(table);
  std::mt19937 rng(seed);
  std::uniform_int_distribution<int32> key_d(0, 999);
  for (int i = 0; i < rows; ++i) {
    char s[64];
    snprintf(s, sizeof(s), "test_string_%d", i);
    w.AddRow().Int32(key_d(rng)).String(s);
  }
  w.CheckSuccess();
  return table;
}

SortOrder* BenchSortOrder() {
  SortOrder* order = new SortOrder();
  order->OrderByNamedAttribute("col0", ASCENDING);
  order->OrderByNamedAttribute("col1", DESCENDING);
  return order;
}

Operation* BenchSortOp(const Table& table) {
  return Sort(BenchSortOrder(), ProjectAllAttributes(),
              std::numeric_limits<size_t>::max(), ScanView(table.view()));
}

void CaseBenchSort() {
  std::unique_ptr<Table> table(BuildBenchSortInput(20000, 808));
  DumpInput("bench_sort", 0, *table);
  RunAndDump("bench_sort", BenchSortOp(*table));
}

// operation_example.cc:93-97: merge-union of two sorted inputs.
void CaseBenchMerge() {
  std::unique_ptr<Table> t0(BuildBenchSortInput(20000, 909));
  std::unique_ptr<Table> t1(BuildBenchSortInput(35000, 910));
  DumpInput("bench_merge", 0, *t0);
  DumpInput("bench_merge", 1, *t1);
  std::vector<Operation*> children;
  children.push_back(BenchSortOp(*t0));
  children.push_back(BenchSortOp(*t1));
  RunAndDump("bench_merge", MergeUnionAll(BenchSortOrder(), children));
}

// operation_example.cc:99-116: LEFT_OUTER UNIQUE join on STRING keys of the
// sort output (20000 distinct keys) against the group output (50 keys) —
// most probe rows get NULL-padded rhs columns.
void CaseBenchJoin() {
  std::unique_ptr<Table> lhs_in(BuildBenchSortInput(20000, 1111));
  std::unique_ptr<Table> rhs_in(BuildBenchGroupInput());
  DumpInput("bench_join", 0, *lhs_in);
  DumpInput("bench_join", 1, *rhs_in);

  CompoundMultiSourceProjector* projector =
      new CompoundMultiSourceProjector();
  projector->add(0, ProjectAllAttributes("L."));
  projector->add(1, ProjectAllAttributes("R."));
  RunAndDump("bench_join",
             new HashJoinOperation(
                 LEFT_OUTER, ProjectAttributeAt(1), ProjectAttributeAt(0),
                 projector, UNIQUE,
                 BenchSortOp(*lhs_in), BenchGroupOp(*rhs_in)));
}

// primer.cc example 1 territory: Filter over a mixed schema incl. a
// nullable predicate column (NULL counts as false, filter.cc:169-198).
void CaseFilter() {
  TupleSchema schema;
  schema.add_attribute(Attribute("a", INT32, NULLABLE));
  schema.add_attribute(Attribute("b", DOUBLE, NOT_NULLABLE));
  schema.add_attribute(Attribute("s", STRING, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(1212);
  std::uniform_int_distribution<int32> a_d(0, 100);
  std::uniform_real_distribution<double> b_d(0.0, 1.0);
  std::uniform_real_distribution<double> null_d(0.0, 1.0);
  for (int i = 0; i < 15000; ++i) {
    w.AddRow();
    if (null_d(rng) < 0.1) w.Null(); else w.Int32(a_d(rng));
    w.Double(b_d(rng));
    char s[32];
    snprintf(s, sizeof(s), "s%d", i % 17);
    w.String(s);
  }
  w.CheckSuccess();
  DumpInput("filter_null", 0, table);

  // Predicate over the NULLABLE column: NULL -> row dropped.
  RunAndDump("filter_null",
             Filter(Greater(NamedAttribute("a"), ConstInt32(50)),
                    ProjectAllAttributes(), ScanView(table.view())));
}

// ScalarAggregate over an empty input: exactly one output row
// (SUM = NULL, COUNT = 0) — aggregate_scalar.cc:17.
void CaseScalarEmpty() {
  TupleSchema schema;
  schema.add_attribute(Attribute("x", DOUBLE, NOT_NULLABLE));
  Table table(schema, Alloc());
  DumpInput("scalar_empty", 0, table);

  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregation(SUM, "x", "x_sum");
  spec->AddAggregation(COUNT, "x", "x_cnt");
  RunAndDump("scalar_empty", ScalarAggregate(spec, ScanView(table.view())));
}

// Expression semantics sweep evaluated by the real engine: null algebra,
// IF/IFNULL/ISNULL, integer + nulling division, string length/case, and
// date extraction over DATE (elementary/string/date expression families).
void CaseExprMix() {
  TupleSchema schema;
  schema.add_attribute(Attribute("a", INT32, NULLABLE));
  schema.add_attribute(Attribute("b", DOUBLE, NOT_NULLABLE));
  schema.add_attribute(Attribute("s", STRING, NOT_NULLABLE));
  schema.add_attribute(Attribute("d", DATE, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(1313);
  std::uniform_int_distribution<int32> a_d(-50, 50);
  std::uniform_real_distribution<double> b_d(-2.0, 2.0);
  std::uniform_int_distribution<int32> date_d(0, 25000);
  std::uniform_real_distribution<double> null_d(0.0, 1.0);
  const char* words[5] = {"Alpha", "beta", "GAMMA_x", "", "delta delta"};
  for (int i = 0; i < 10000; ++i) {
    w.AddRow();
    if (null_d(rng) < 0.15) w.Null(); else w.Int32(a_d(rng));
    w.Double(b_d(rng));
    w.String(words[i % 5]);
    w.Date(date_d(rng));
  }
  w.CheckSuccess();
  DumpInput("expr_mix", 0, table);

  CompoundExpression* expr = new CompoundExpression();
  expr->AddAs("plus7", Plus(NamedAttribute("a"), ConstInt32(7)));
  expr->AddAs("isnull", IsNull(NamedAttribute("a")));
  expr->AddAs("ifnull", IfNull(NamedAttribute("a"), ConstInt32(-99)));
  expr->AddAs("ifgt", If(Greater(NamedAttribute("b"), ConstDouble(0.0)),
                         NamedAttribute("a"), ConstInt32(-1)));
  expr->AddAs("ndiv", DivideNulling(NamedAttribute("a"),
                                    Modulus(NamedAttribute("a"),
                                            ConstInt32(5))));
  expr->AddAs("slen", Length(NamedAttribute("s")));
  expr->AddAs("supper", ToUpper(NamedAttribute("s")));
  expr->AddAs("year", Year(NamedAttribute("d")));
  expr->AddAs("month", Month(NamedAttribute("d")));
  expr->AddAs("day", Day(NamedAttribute("d")));
  RunAndDump("expr_mix", Compute(expr, ScanView(table.view())));
}

// Limit with a non-zero offset (limit.cc:42).
void CaseLimit() {
  TupleSchema schema;
  schema.add_attribute(Attribute("a", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("b", DOUBLE, NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(1414);
  std::uniform_real_distribution<double> d(0.0, 1.0);
  for (int i = 0; i < 9000; ++i) {
    w.AddRow().Int32(i);
    if (d(rng) < 0.1) w.Null(); else w.Double(d(rng));
  }
  w.CheckSuccess();
  DumpInput("limit", 0, table);
  RunAndDump("limit", Limit(137, 4321, ScanView(table.view())));
}

// Coalesce: column-wise zip of two children (coalesce.cc:50).
void CaseCoalesce() {
  TupleSchema s0;
  s0.add_attribute(Attribute("a", INT32, NOT_NULLABLE));
  Table t0(s0, Alloc());
  TupleSchema s1;
  s1.add_attribute(Attribute("b", STRING, NOT_NULLABLE));
  s1.add_attribute(Attribute("c", INT64, NULLABLE));
  Table t1(s1, Alloc());
  {
    TableRowWriter w0(&t0);
    TableRowWriter w1(&t1);
    std::mt19937 rng(1515);
    std::uniform_real_distribution<double> d(0.0, 1.0);
    for (int i = 0; i < 11000; ++i) {
      w0.AddRow().Int32((int32)rng());
      char s[32];
      snprintf(s, sizeof(s), "c%d", i % 23);
      w1.AddRow().String(s);
      if (d(rng) < 0.2) w1.Null(); else w1.Int64((int64)(i * 7));
    }
    w0.CheckSuccess();
    w1.CheckSuccess();
  }
  DumpInput("coalesce", 0, t0);
  DumpInput("coalesce", 1, t1);
  std::vector<Operation*> children;
  children.push_back(ScanView(t0.view()));
  children.push_back(ScanView(t1.view()));
  RunAndDump("coalesce", Coalesce(children));
}

// AggregateClusters: streaming aggregate over key-clustered input
// (aggregate_clusters.cc:627) — input pre-sorted by the cluster key.
void CaseAggregateClusters() {
  TupleSchema schema;
  schema.add_attribute(Attribute("k", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("v", INT32, NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(1616);
  std::uniform_int_distribution<int32> run_d(1, 40);
  std::uniform_int_distribution<int32> v_d(-100, 100);
  std::uniform_real_distribution<double> d(0.0, 1.0);
  int32 key = 0;
  int rows = 0;
  while (rows < 12000) {
    int len = run_d(rng);
    for (int j = 0; j < len && rows < 12000; ++j, ++rows) {
      w.AddRow().Int32(key);
      if (d(rng) < 0.1) w.Null(); else w.Int32(v_d(rng));
    }
    key += 1 + (rng() % 3);  // strictly increasing cluster keys
  }
  w.CheckSuccess();
  DumpInput("agg_clusters", 0, table);
  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregation(SUM, "v", "sv");
  spec->AddAggregation(MIN, "v", "mn");
  spec->AddAggregation(COUNT, "v", "c");
  RunAndDump("agg_clusters",
             AggregateClusters(ProjectNamedAttribute("k"), spec,
                               ScanView(table.view())));
}

// RowidMergeJoin: ascending INT64 fk joined against right ROW IDS
// (rowid_merge_join.cc:62).
void CaseRowidJoin() {
  TupleSchema rs;
  rs.add_attribute(Attribute("name", STRING, NOT_NULLABLE));
  rs.add_attribute(Attribute("w", INT32, NOT_NULLABLE));
  Table right(rs, Alloc());
  const int n_right = 500;
  {
    TableRowWriter w(&right);
    std::mt19937 rng(1717);
    for (int i = 0; i < n_right; ++i) {
      char s[32];
      snprintf(s, sizeof(s), "r%03d", i);
      w.AddRow().String(s).Int32((int32)(rng() % 1000));
    }
    w.CheckSuccess();
  }
  TupleSchema ls;
  ls.add_attribute(Attribute("fk", INT64, NOT_NULLABLE));
  ls.add_attribute(Attribute("lv", INT32, NOT_NULLABLE));
  Table left(ls, Alloc());
  {
    TableRowWriter w(&left);
    std::mt19937 rng(1818);
    int64 key = 0;
    for (int i = 0; i < 9000; ++i) {
      // ascending, with duplicates, never beyond n_right-1
      if (rng() % 3 == 0) key = std::min<int64>(key + rng() % 4,
                                                n_right - 1);
      w.AddRow().Int64(key).Int32(i);
    }
    w.CheckSuccess();
  }
  DumpInput("rowid_join", 0, left);
  DumpInput("rowid_join", 1, right);
  CompoundMultiSourceProjector* projector =
      new CompoundMultiSourceProjector();
  projector->add(0, ProjectAllAttributes("L."));
  projector->add(1, ProjectAllAttributes("R."));
  RunAndDump("rowid_join",
             RowidMergeJoin(ProjectNamedAttribute("fk"), projector,
                            ScanView(left.view()),
                            ScanView(right.view())));
}

// ForeignFilter: ascending fk semi-joined against ascending unique keys,
// fk remapped to filter row ids (foreign_filter.cc:55).
void CaseForeignFilter() {
  TupleSchema fs;
  fs.add_attribute(Attribute("key", INT64, NOT_NULLABLE));
  Table filter_t(fs, Alloc());
  {
    TableRowWriter w(&filter_t);
    std::mt19937 rng(1919);
    int64 k = 0;
    for (int i = 0; i < 300; ++i) {
      k += 1 + rng() % 5;  // ascending unique
      w.AddRow().Int64(k);
    }
    w.CheckSuccess();
  }
  TupleSchema is;
  is.add_attribute(Attribute("fk", INT64, NOT_NULLABLE));
  is.add_attribute(Attribute("pv", INT32, NOT_NULLABLE));
  Table input_t(is, Alloc());
  {
    TableRowWriter w(&input_t);
    std::mt19937 rng(2020);
    int64 k = 0;
    for (int i = 0; i < 8000; ++i) {
      k += rng() % 2;  // ascending, duplicates allowed
      w.AddRow().Int64(k).Int32(i);
    }
    w.CheckSuccess();
  }
  DumpInput("foreign_filter", 0, filter_t);
  DumpInput("foreign_filter", 1, input_t);
  RunAndDump("foreign_filter",
             ForeignFilter(ProjectNamedAttribute("key"),
                           ProjectNamedAttribute("fk"),
                           ScanView(filter_t.view()),
                           ScanView(input_t.view())));
}

// Serialization interop: an ExpressionDescription proto built here is
// (a) deserialized by the reference's BuildExpressionFromProto
// (serialization/build_expression_from_proto.cc:754) and evaluated, and
// (b) dumped as raw wire bytes for the JAX engine's
// build_expression_from_proto_bytes to consume — proving the two engines
// agree from the SAME serialized predicate.
void CaseProtoExpr() {
  TupleSchema schema;
  schema.add_attribute(Attribute("a", INT32, NULLABLE));
  schema.add_attribute(Attribute("b", DOUBLE, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(2121);
  std::uniform_int_distribution<int32> a_d(-40, 40);
  std::uniform_real_distribution<double> b_d(-2.0, 2.0);
  std::uniform_real_distribution<double> nd(0.0, 1.0);
  for (int i = 0; i < 9000; ++i) {
    w.AddRow();
    if (nd(rng) < 0.15) w.Null(); else w.Int32(a_d(rng));
    w.Double(b_d(rng));
  }
  w.CheckSuccess();
  DumpInput("proto_expr", 0, table);

  // IF(IS_NULL(a), CAST(DOUBLE, const -1), a + b * const 2.0)
  common::ExpressionDescription desc;
  desc.set_type(common::OPERATION);
  common::OperationDescription* op = desc.mutable_operation();
  op->set_type(common::IF);
  {
    common::ExpressionDescription* cond = op->add_argument();
    cond->set_type(common::OPERATION);
    cond->mutable_operation()->set_type(common::IS_NULL);
    common::ExpressionDescription* v =
        cond->mutable_operation()->add_argument();
    v->set_type(common::VARIABLE);
    v->mutable_variable()->set_name("a");
  }
  {
    common::ExpressionDescription* then = op->add_argument();
    then->set_type(common::OPERATION);
    then->mutable_operation()->set_type(common::CAST);
    common::ExpressionDescription* ty =
        then->mutable_operation()->add_argument();
    ty->set_type(common::CONSTANT);
    ty->mutable_constant()->set_type(common::DATA_TYPE);
    ty->mutable_constant()->set_data_type_value(common::DOUBLE);
    common::ExpressionDescription* c =
        then->mutable_operation()->add_argument();
    c->set_type(common::CONSTANT);
    c->mutable_constant()->set_type(common::INT32);
    c->mutable_constant()->set_int32_value(-1);
  }
  {
    common::ExpressionDescription* els = op->add_argument();
    els->set_type(common::OPERATION);
    els->mutable_operation()->set_type(common::ADD);
    common::ExpressionDescription* va = els->mutable_operation()
        ->add_argument();
    va->set_type(common::VARIABLE);
    va->mutable_variable()->set_name("a");
    common::ExpressionDescription* mul = els->mutable_operation()
        ->add_argument();
    mul->set_type(common::OPERATION);
    mul->mutable_operation()->set_type(common::MULTIPLY);
    common::ExpressionDescription* vb = mul->mutable_operation()
        ->add_argument();
    vb->set_type(common::VARIABLE);
    vb->mutable_variable()->set_name("b");
    common::ExpressionDescription* two = mul->mutable_operation()
        ->add_argument();
    two->set_type(common::CONSTANT);
    two->mutable_constant()->set_type(common::DOUBLE);
    two->mutable_constant()->set_double_value(2.0);
  }

  std::string wire;
  desc.SerializeToString(&wire);
  {
    File* f = File::OpenOrDie(g_outdir + "/proto_expr.pb", "w");
    f->Write(wire.data(), wire.size());
    f->Close();
    printf("pb proto_expr proto_expr.pb %zu -\n", wire.size());
  }

  const Expression* expr = SucceedOrDie(BuildExpressionFromProto(desc));
  RunAndDump("proto_expr",
             Compute((new CompoundExpression)->AddAs("r", expr),
                     ScanView(table.view())));
}

// ToString printer formats (types_infrastructure.cc:45-110): BOOL ->
// TRUE/FALSE, DATE -> %Y/%m/%d, ints -> decimal.
void CaseToString() {
  TupleSchema schema;
  schema.add_attribute(Attribute("b", BOOL, NULLABLE));
  schema.add_attribute(Attribute("d", DATE, NOT_NULLABLE));
  schema.add_attribute(Attribute("i", INT32, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(2222);
  // < 24855: the reference's DATE printer runs through a 32-bit time_t
  // (types_infrastructure.cc:104-108) and wraps past 2038-01-19
  std::uniform_int_distribution<int32> d_d(0, 24800);
  std::uniform_int_distribution<int32> i_d(-500, 500);
  std::uniform_real_distribution<double> nd(0.0, 1.0);
  for (int i = 0; i < 9000; ++i) {
    w.AddRow();
    if (nd(rng) < 0.1) w.Null(); else w.Bool(rng() % 2 == 0);
    w.Date(d_d(rng)).Int32(i_d(rng));
  }
  w.CheckSuccess();
  DumpInput("tostring", 0, table);
  CompoundExpression* expr = new CompoundExpression();
  expr->AddAs("sb", ToString(NamedAttribute("b")));
  expr->AddAs("sd", ToString(NamedAttribute("d")));
  expr->AddAs("si", ToString(NamedAttribute("i")));
  RunAndDump("tostring", Compute(expr, ScanView(table.view())));
}

// Stateful (cross-row) expressions: Changed / RunningSum / Smudge /
// SmudgeIf / RunningMinWithFlush (stateful_expressions.h:30-71).  The
// reference carries state across 1024-row views; the JAX engine computes
// the same semantics as whole-column parallel scans (exprs/stateful.py).
void CaseStateful() {
  TupleSchema schema;
  schema.add_attribute(Attribute("v", INT64, NULLABLE));
  schema.add_attribute(Attribute("seq", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("flush", BOOL, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(555);
  std::uniform_int_distribution<int64> v_d(-1000000, 1000000);
  std::uniform_real_distribution<double> nd(0.0, 1.0);
  int32 seq = 0;
  for (int i = 0; i < 10000; ++i) {
    w.AddRow();
    if (nd(rng) < 0.2) w.Null(); else w.Int64(v_d(rng));
    if (nd(rng) < 0.3) seq += 1;  // runs of equal values for Changed
    w.Int32(seq);
    w.Bool(nd(rng) < 0.05);
  }
  w.CheckSuccess();
  DumpInput("stateful", 0, table);
  CompoundExpression* expr = new CompoundExpression();
  expr->AddAs("chg", Changed(NamedAttribute("seq")));
  expr->AddAs("rsum", RunningSum(NamedAttribute("v")));
  expr->AddAs("smu", Smudge(NamedAttribute("v")));
  expr->AddAs("smuif", SmudgeIf(NamedAttribute("v"),
                                NamedAttribute("flush")));
  expr->AddAs("rmin", RunningMinWithFlush(NamedAttribute("flush"),
                                          NamedAttribute("v")));
  RunAndDump("stateful", Compute(expr, ScanView(table.view())));
}

// String transforms incl. two-non-constant-column Concat (the JAX
// engine's cross-product-dictionary device path) and the MySQL-style
// Substring semantics (string_expressions.h:73-102).
void CaseStringOps() {
  TupleSchema schema;
  schema.add_attribute(Attribute("s", STRING, NULLABLE));
  schema.add_attribute(Attribute("s2", STRING, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(777);
  std::uniform_real_distribution<double> nd(0.0, 1.0);
  const char* words[7] = {"Alpha", "beta carotene", "GAMMA_x", "",
                          "delta delta", "a-b-a-b", "x"};
  const char* words2[5] = {"oo", "A", "-", "beta", "zz"};
  for (int i = 0; i < 10000; ++i) {
    w.AddRow();
    if (nd(rng) < 0.15) w.Null(); else w.String(words[rng() % 7]);
    w.String(words2[rng() % 5]);
  }
  w.CheckSuccess();
  DumpInput("string_ops", 0, table);
  CompoundExpression* expr = new CompoundExpression();
  expr->AddAs("sub", Substring(NamedAttribute("s"), ConstInt32(2),
                               ConstInt32(3)));
  expr->AddAs("subn", Substring(NamedAttribute("s"), ConstInt32(-3),
                                ConstInt32(2)));
  expr->AddAs("off", StringOffset(NamedAttribute("s"), ConstString("a")));
  expr->AddAs("rep", StringReplace(NamedAttribute("s"), ConstString("a"),
                                   ConstString("oo")));
  expr->AddAs("cat", Concat((new ExpressionList())
                                ->add(NamedAttribute("s"))
                                ->add(ConstString("-"))
                                ->add(NamedAttribute("s2"))));
  RunAndDump("string_ops", Compute(expr, ScanView(table.view())));
}

// MakeDate / MakeDatetime: mkgmtime_int64 NORMALIZES out-of-range
// months and days (month 13 -> next January, Feb 30 -> Mar 2,
// date_evaluators.cc:36-58); MakeDatetime adds hour/minute/second
// unchecked and NULLs rows whose date part lands before the epoch
// (date_bound_expressions.cc:123-126).
void CaseMakeDate() {
  TupleSchema schema;
  schema.add_attribute(Attribute("y", INT32, NULLABLE));
  schema.add_attribute(Attribute("m", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("d", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("y2", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("h", INT32, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(888);
  std::uniform_int_distribution<int32> y_d(2000, 2030);
  std::uniform_int_distribution<int32> m_d(-5, 20);
  std::uniform_int_distribution<int32> d_d(-10, 40);
  std::uniform_int_distribution<int32> y2_d(1969, 1973);
  std::uniform_int_distribution<int32> h_d(-30, 30);
  std::uniform_real_distribution<double> nd(0.0, 1.0);
  for (int i = 0; i < 9000; ++i) {
    w.AddRow();
    if (nd(rng) < 0.1) w.Null(); else w.Int32(y_d(rng));
    // y >= 2000 with m >= -5, d >= -10 keeps every "md" result past the
    // epoch (MAKEDATE would otherwise FAIL the whole query); y2 straddles
    // 1970 so "mdt" exercises its NULL-on-pre-epoch path
    w.Int32(m_d(rng)).Int32(d_d(rng)).Int32(y2_d(rng)).Int32(h_d(rng));
  }
  w.CheckSuccess();
  DumpInput("makedate", 0, table);
  CompoundExpression* expr = new CompoundExpression();
  expr->AddAs("md", MakeDate(NamedAttribute("y"), NamedAttribute("m"),
                             NamedAttribute("d")));
  expr->AddAs("mdt", MakeDatetime(NamedAttribute("y2"), NamedAttribute("m"),
                                  NamedAttribute("d"), NamedAttribute("h"),
                                  ConstInt32(90), ConstInt32(-5)));
  // AddMonths does NOT clamp the day (mkgmtime extrapolation,
  // date_evaluators.cc:71-83): pin it on month-end-crossing days
  expr->AddAs("addm", AddMonths(MakeDate(NamedAttribute("y"), ConstInt32(1),
                                         NamedAttribute("d")),
                                NamedAttribute("m")));
  RunAndDump("makedate", Compute(expr, ScanView(table.view())));
}

// *Local date operators and DateFormat/DateFormatLocal under a pinned
// non-UTC timezone: the reference renders these through localtime_r /
// gmtime_r + strftime (date_evaluators.cc:204-210,227-265).  Run LAST —
// it switches the process TZ.
void CaseDateLocal() {
  setenv("TZ", "America/New_York", 1);
  tzset();
  TupleSchema schema;
  schema.add_attribute(Attribute("t", DATETIME, NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(4242);
  // within 32-bit time_t: the reference's DateFormat documents itself as
  // not 64-bit-safe (date_expressions.h:163-166)
  std::uniform_int_distribution<int64> sec_d(0, 2100000000LL);
  std::uniform_real_distribution<double> nd(0.0, 1.0);
  for (int i = 0; i < 9000; ++i) {
    w.AddRow();
    if (nd(rng) < 0.1) w.Null();
    else w.Datetime(sec_d(rng) * 1000000LL);
  }
  // the 2024 New-York DST boundary instants, exactly
  const int64 probes[] = {1710050399LL, 1710050400LL, 1710053999LL,
                          1710054000LL, 1730613599LL, 1730613600LL};
  for (size_t i = 0; i < sizeof(probes) / sizeof(probes[0]); ++i) {
    w.AddRow();
    w.Datetime(probes[i] * 1000000LL);
  }
  w.CheckSuccess();
  DumpInput("date_local", 0, table);
  CompoundExpression* expr = new CompoundExpression();
  expr->AddAs("y", YearLocal(NamedAttribute("t")));
  expr->AddAs("mo", MonthLocal(NamedAttribute("t")));
  expr->AddAs("dy", DayLocal(NamedAttribute("t")));
  expr->AddAs("h", HourLocal(NamedAttribute("t")));
  expr->AddAs("mi", MinuteLocal(NamedAttribute("t")));
  expr->AddAs("wd", WeekdayLocal(NamedAttribute("t")));
  expr->AddAs("fmt", DateFormat(NamedAttribute("t"),
                                ConstString("%Y/%m/%d %a")));
  expr->AddAs("fmtl", DateFormatLocal(NamedAttribute("t"),
                                      ConstString("%Y/%m/%d %a")));
  RunAndDump("date_local", Compute(expr, ScanView(table.view())));
}

// CONCAT aggregation: per-group "," join in input order, NULL inputs
// skipped, all-NULL group -> NULL (aggregation_operators.h:235-283);
// non-string input stringified via PrintTyped (column_aggregator.cc:496+).
void CaseConcatAgg() {
  TupleSchema schema;
  schema.add_attribute(Attribute("k", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("s", STRING, NULLABLE));
  schema.add_attribute(Attribute("v", INT64, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(404);
  std::uniform_int_distribution<int32> key_d(0, 40);
  std::uniform_int_distribution<int> word_d(0, 9);
  std::uniform_real_distribution<double> null_d(0.0, 1.0);
  std::uniform_int_distribution<int64> val_d(-1000000, 1000000);
  const char* words[10] = {"ruby", "opal", "jade", "onyx", "pearl",
                           "topaz", "agate", "beryl", "coral", "flint"};
  for (int i = 0; i < 4000; ++i) {
    int32 k = key_d(rng);
    w.AddRow().Int32(k);
    // key 7: all inputs NULL -> NULL concat result for that group
    if (k == 7 || null_d(rng) < 0.15) w.Null();
    else w.String(words[word_d(rng)]);
    w.Int64(val_d(rng));
  }
  w.CheckSuccess();
  DumpInput("concat_agg", 0, table);

  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregation(CONCAT, "s", "cs");
  spec->AddAggregationWithDefinedOutputType(CONCAT, "v", "cv", STRING);
  // DISTINCT CONCAT: per-key value dedup in first-encounter order
  // (DistinctAggregator, column_aggregator.cc:308-343)
  spec->AddDistinctAggregation(CONCAT, "s", "csd");
  spec->AddAggregation(SUM, "v", "sv");
  RunAndDump("concat_agg",
             GroupAggregate(ProjectNamedAttribute("k"), spec, NULL,
                            ScanView(table.view())));
}

// CONCAT of FLOAT/DOUBLE inputs: values stringified via PrintTyped ->
// SimpleFtoa/SimpleDtoa — "%.6g"/"%.15g" with a round-trip retry at
// "%.8g"/"%.17g" (utils/strings/numbers.cc:1249-1297).  Special values
// are chosen to hit both the short form and the retry.
void CaseConcatFloat() {
  TupleSchema schema;
  schema.add_attribute(Attribute("k", INT32, NOT_NULLABLE));
  schema.add_attribute(Attribute("f", FLOAT, NULLABLE));
  schema.add_attribute(Attribute("d", DOUBLE, NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(606);
  std::uniform_int_distribution<int32> key_d(0, 20);
  std::uniform_real_distribution<double> null_d(0.0, 1.0);
  std::uniform_real_distribution<double> v_d(-10.0, 10.0);
  const float f_special[8] = {0.1f, 2.0f, 1e-7f, 1234567.0f, -0.0f,
                              3.14159274f, 16777216.0f, 1e30f};
  const double d_special[8] = {0.1, 2.0, 1e-17, 1.0 / 3.0, -0.0,
                               3.141592653589793, 9007199254740993.0,
                               1e300};
  std::uniform_int_distribution<int> sp_d(0, 7);
  for (int i = 0; i < 3000; ++i) {
    int32 k = key_d(rng);
    w.AddRow().Int32(k);
    double r = null_d(rng);
    if (r < 0.1) w.Null();
    else if (r < 0.4) w.Float(f_special[sp_d(rng)]);
    else w.Float(static_cast<float>(v_d(rng)));
    r = null_d(rng);
    if (r < 0.1) w.Null();
    else if (r < 0.4) w.Double(d_special[sp_d(rng)]);
    else w.Double(v_d(rng));
  }
  w.CheckSuccess();
  DumpInput("concat_float", 0, table);

  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregationWithDefinedOutputType(CONCAT, "f", "cf", STRING);
  spec->AddAggregationWithDefinedOutputType(CONCAT, "d", "cd", STRING);
  RunAndDump("concat_float",
             GroupAggregate(ProjectNamedAttribute("k"), spec, NULL,
                            ScanView(table.view())));
}

// ENUM (value map, tuple_schema.h:42) and BINARY (var-length wire path,
// file_io.cc:77-101) routed through group-by + sort; enums sort/compare
// by value number (types_infrastructure.cc:511-514).
void CaseEnumBinary() {
  EnumDefinition metal;
  CHECK(metal.AddEntry(0, "iron").is_success());
  CHECK(metal.AddEntry(1, "zinc").is_success());
  CHECK(metal.AddEntry(2, "gold").is_success());
  CHECK(metal.AddEntry(3, "lead").is_success());
  CHECK(metal.AddEntry(4, "tin").is_success());
  TupleSchema schema;
  schema.add_attribute(Attribute("e", metal, NULLABLE));
  schema.add_attribute(Attribute("b", BINARY, NULLABLE));
  schema.add_attribute(Attribute("v", INT64, NOT_NULLABLE));
  Table table(schema, Alloc());
  TableRowWriter w(&table);
  std::mt19937 rng(505);
  std::uniform_int_distribution<int32> e_d(0, 4);
  std::uniform_int_distribution<int> b_d(0, 5);
  std::uniform_real_distribution<double> null_d(0.0, 1.0);
  std::uniform_int_distribution<int64> val_d(-5000, 5000);
  const char* blobs[6] = {"\x00\x01", "ab", "\xff", "a", "zz\x00z", "q"};
  const size_t blob_len[6] = {2, 2, 1, 1, 4, 1};
  for (int i = 0; i < 6000; ++i) {
    w.AddRow();
    if (null_d(rng) < 0.08) w.Null();
    else w.Set<ENUM>(e_d(rng));
    if (null_d(rng) < 0.12) w.Null();
    else {
      int bi = b_d(rng);
      w.Binary(StringPiece(blobs[bi], blob_len[bi]));
    }
    w.Int64(val_d(rng));
  }
  w.CheckSuccess();
  DumpInput("enum_binary", 0, table);

  AggregationSpecification* spec = new AggregationSpecification();
  spec->AddAggregation(SUM, "v", "sv");
  spec->AddAggregation(COUNT, "b", "cb");
  std::vector<std::string> keys;
  keys.push_back("e");
  keys.push_back("b");
  SortOrder* order = new SortOrder();
  order->OrderByNamedAttribute("e", ASCENDING);
  order->OrderByNamedAttribute("b", ASCENDING);
  RunAndDump("enum_binary",
             Sort(order, ProjectAllAttributes(),
                  std::numeric_limits<size_t>::max(),
                  GroupAggregate(ProjectNamedAttributes(keys), spec, NULL,
                                 ScanView(table.view()))));
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    fprintf(stderr, "usage: golden_dump <output_dir>\n");
    return 1;
  }
  g_outdir = argv[1];
  CasePrimerSum();
  CaseGuideAgg();
  CaseGuideSort();
  CaseGuideJoin();
  CaseBenchGroup();
  CaseBenchCompute();
  CaseBenchSort();
  CaseBenchMerge();
  CaseBenchJoin();
  CaseFilter();
  CaseScalarEmpty();
  CaseExprMix();
  CaseLimit();
  CaseCoalesce();
  CaseAggregateClusters();
  CaseRowidJoin();
  CaseForeignFilter();
  CaseProtoExpr();
  CaseToString();
  CaseStateful();
  CaseStringOps();
  CaseMakeDate();
  CaseConcatAgg();
  CaseConcatFloat();
  CaseEnumBinary();
  CaseDateLocal();  // last: switches the process TZ
  return 0;
}

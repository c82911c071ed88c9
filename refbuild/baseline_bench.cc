// Empirical baseline: runs the BASELINE.json workloads through the REAL
// reference engine (google/supersonic, built from /root/reference with the
// shims in shims/).  Single-threaded, as the reference is by design
// (test/guide/primer.cc:33-34).  Prints per-op and pipeline times.
//
// Workloads mirror /root/repo/bench_ops.py and /root/repo/bench.py:
//   filter 8M            v > 0.5 over (fk,v,g)
//   groupby 8M->64       SUM(v) by g
//   groupby 8M->1M       SUM(v) by fk
//   sort 8M              by (g ASC, v DESC)
//   join 8M x 1M         INNER UNIQUE fk == pk, project v, w
//   pipeline 8M          filter -> join -> groupby(64) -> sort (bench.py)
#include <cstdio>
#include <ctime>
#include <memory>
#include <random>
#include <string>

#include "supersonic/supersonic.h"
#include "supersonic/cursor/core/merge_union_all.h"
#include "supersonic/cursor/core/scan_view.h"
#include "supersonic/cursor/infrastructure/table.h"
#include "supersonic/cursor/infrastructure/writer.h"
#include "supersonic/utils/exception/failureor.h"

using namespace supersonic;  // NOLINT

namespace {

double NowSec() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

const int kFactRows = 8 * 1000 * 1000;
const int kDimRows = 1000 * 1000;
const int kGroups = 64;

// Drains a cursor to end-of-stream; returns total rows (and defeats
// dead-code elimination by consuming a value).
size_t Drain(Cursor* cursor) {
  size_t rows = 0;
  while (true) {
    ResultView result = cursor->Next(1024);
    if (result.is_eos()) break;
    if (!result.has_data()) {
      fprintf(stderr, "cursor failure\n");
      std::abort();
    }
    rows += result.view().row_count();
  }
  return rows;
}

struct Bench {
  BufferAllocator* alloc;
  std::unique_ptr<Table> fact;
  std::unique_ptr<Table> dim;
  std::unique_ptr<Table> dim8;      // 1M rows, 125k keys x 8 dups
  std::unique_ptr<Table> fact8;     // 8M rows, fk in [0, 125k)
  std::unique_ptr<Table> fact2m;    // 8M rows, fk in [0, 2M) (half miss)
  std::unique_ptr<Table> fact_str;  // 8M rows, 50 string keys
  std::unique_ptr<Table> sorted_a;  // 4M rows sorted by (g ASC, v DESC)
  std::unique_ptr<Table> sorted_b;
  std::unique_ptr<Table> comp;      // (c0 i32, c1 i64, c2 double) 8M
  std::unique_ptr<Table> fact_sj;   // (fk STRING over 1M values, v) 8M
  std::unique_ptr<Table> dim_str;   // (pk STRING 1M distinct, w) 1M

  void BuildData() {
    std::mt19937 rng(42);
    std::uniform_int_distribution<int32> fk_d(0, kDimRows - 1);
    std::uniform_int_distribution<int32> g_d(0, kGroups - 1);
    std::uniform_real_distribution<float> v_d(0.0f, 1.0f);

    TupleSchema fact_schema;
    fact_schema.add_attribute(Attribute("fk", INT32, NOT_NULLABLE));
    fact_schema.add_attribute(Attribute("v", FLOAT, NOT_NULLABLE));
    fact_schema.add_attribute(Attribute("g", INT32, NOT_NULLABLE));
    fact.reset(new Table(fact_schema, alloc));
    fact->ReserveRowCapacity(kFactRows);
    for (int i = 0; i < kFactRows; ++i) {
      rowid_t row = fact->AddRow();
      fact->Set<INT32>(0, row, fk_d(rng));
      fact->Set<FLOAT>(1, row, v_d(rng));
      fact->Set<INT32>(2, row, g_d(rng));
    }

    TupleSchema dim_schema;
    dim_schema.add_attribute(Attribute("pk", INT32, NOT_NULLABLE));
    dim_schema.add_attribute(Attribute("w", INT32, NOT_NULLABLE));
    dim.reset(new Table(dim_schema, alloc));
    dim->ReserveRowCapacity(kDimRows);
    for (int i = 0; i < kDimRows; ++i) {
      rowid_t row = dim->AddRow();
      dim->Set<INT32>(0, row, i);
      dim->Set<INT32>(1, row, g_d(rng));
    }

    // NOT_UNIQUE build side: 125k distinct keys, each duplicated 8x
    const int kDupKeys = kDimRows / 8;
    dim8.reset(new Table(dim_schema, alloc));
    dim8->ReserveRowCapacity(kDimRows);
    for (int i = 0; i < kDimRows; ++i) {
      rowid_t row = dim8->AddRow();
      dim8->Set<INT32>(0, row, i / 8);
      dim8->Set<INT32>(1, row, g_d(rng));
    }
    std::uniform_int_distribution<int32> fk8_d(0, kDupKeys - 1);
    fact8.reset(new Table(fact->schema(), alloc));
    fact8->ReserveRowCapacity(kFactRows);
    std::uniform_int_distribution<int32> fk2m_d(0, 2 * kDimRows - 1);
    fact2m.reset(new Table(fact->schema(), alloc));
    fact2m->ReserveRowCapacity(kFactRows);
    for (int i = 0; i < kFactRows; ++i) {
      rowid_t row = fact8->AddRow();
      fact8->Set<INT32>(0, row, fk8_d(rng));
      fact8->Set<FLOAT>(1, row, v_d(rng));
      fact8->Set<INT32>(2, row, g_d(rng));
      row = fact2m->AddRow();
      fact2m->Set<INT32>(0, row, fk2m_d(rng));
      fact2m->Set<FLOAT>(1, row, v_d(rng));
      fact2m->Set<INT32>(2, row, g_d(rng));
    }

    // STRING group-by key: 50 distinct department-style strings
    static const char* kWords[50] = {
      "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
      "hotel", "india", "juliett", "kilo", "lima", "mike", "november",
      "oscar", "papa", "quebec", "romeo", "sierra", "tango", "uniform",
      "victor", "whiskey", "xray", "yankee", "zulu", "amber", "bronze",
      "copper", "dune", "ember", "flint", "granite", "harbor", "island",
      "jade", "krypton", "lagoon", "meadow", "nickel", "onyx", "prairie",
      "quartz", "ridge", "summit", "tundra", "umber", "valley", "willow",
      "zenith"};
    std::uniform_int_distribution<int> word_d(0, 49);
    TupleSchema str_schema;
    str_schema.add_attribute(Attribute("k", STRING, NOT_NULLABLE));
    str_schema.add_attribute(Attribute("v", FLOAT, NOT_NULLABLE));
    fact_str.reset(new Table(str_schema, alloc));
    fact_str->ReserveRowCapacity(kFactRows);
    for (int i = 0; i < kFactRows; ++i) {
      rowid_t row = fact_str->AddRow();
      fact_str->Set<STRING>(0, row, StringPiece(kWords[word_d(rng)]));
      fact_str->Set<FLOAT>(1, row, v_d(rng));
    }

    // expression-engine workload: the reference's own benchmark example
    // #2 shape (benchmark/examples/operation_example.cc:44-50) —
    // Compute(c0 * (Sin(c2) + Exp(c1))) over (INT32, INT64, DOUBLE),
    // value ranges kept finite so both engines do real math
    std::uniform_int_distribution<int32> c0_d(0, 999);
    std::uniform_int_distribution<int64> c1_d(-50, 50);
    std::uniform_real_distribution<double> c2_d(0.0, 1.0);
    TupleSchema comp_schema;
    comp_schema.add_attribute(Attribute("c0", INT32, NOT_NULLABLE));
    comp_schema.add_attribute(Attribute("c1", INT64, NOT_NULLABLE));
    comp_schema.add_attribute(Attribute("c2", DOUBLE, NOT_NULLABLE));
    comp.reset(new Table(comp_schema, alloc));
    comp->ReserveRowCapacity(kFactRows);
    for (int i = 0; i < kFactRows; ++i) {
      rowid_t row = comp->AddRow();
      comp->Set<INT32>(0, row, c0_d(rng));
      comp->Set<INT64>(1, row, c1_d(rng));
      comp->Set<DOUBLE>(2, row, c2_d(rng));
    }

    // STRING-key join: probe 8M random keys over a 1M-distinct-string
    // build side (the dictionary-code dense path on the JAX engine)
    TupleSchema sj_schema;
    sj_schema.add_attribute(Attribute("fk", STRING, NOT_NULLABLE));
    sj_schema.add_attribute(Attribute("v", FLOAT, NOT_NULLABLE));
    fact_sj.reset(new Table(sj_schema, alloc));
    fact_sj->ReserveRowCapacity(kFactRows);
    char buf[32];
    for (int i = 0; i < kFactRows; ++i) {
      rowid_t row = fact_sj->AddRow();
      snprintf(buf, sizeof(buf), "key_%07d", fk_d(rng));
      fact_sj->Set<STRING>(0, row, StringPiece(buf));
      fact_sj->Set<FLOAT>(1, row, v_d(rng));
    }
    TupleSchema ds_schema;
    ds_schema.add_attribute(Attribute("pk", STRING, NOT_NULLABLE));
    ds_schema.add_attribute(Attribute("w", INT32, NOT_NULLABLE));
    dim_str.reset(new Table(ds_schema, alloc));
    dim_str->ReserveRowCapacity(kDimRows);
    for (int i = 0; i < kDimRows; ++i) {
      rowid_t row = dim_str->AddRow();
      snprintf(buf, sizeof(buf), "key_%07d", i);
      dim_str->Set<STRING>(0, row, StringPiece(buf));
      dim_str->Set<INT32>(1, row, g_d(rng));
    }

    // two pre-sorted 4M halves for the merge-union workload
    sorted_a.reset(MaterializeSortedHalf(0));
    sorted_b.reset(MaterializeSortedHalf(1));
  }

  Operation* ComputeOp() {
    return Compute(Multiply(NamedAttribute("c0"),
                            Plus(Sin(NamedAttribute("c2")),
                                 Exp(NamedAttribute("c1")))),
                   ScanView(comp->view()));
  }

  Operation* JoinStrOp() {
    CompoundMultiSourceProjector* result = new CompoundMultiSourceProjector();
    result->add(0, ProjectNamedAttribute("v"));
    result->add(1, ProjectNamedAttribute("w"));
    return new HashJoinOperation(
        INNER, ProjectNamedAttribute("fk"), ProjectNamedAttribute("pk"),
        result, UNIQUE, ScanView(fact_sj->view()),
        ScanView(dim_str->view()));
  }

  Table* MaterializeSortedHalf(int which) {
    View half(fact->schema());
    half.ResetFromSubRange(fact->view(), which * (kFactRows / 2),
                           kFactRows / 2);
    SortOrder* order = new SortOrder();
    order->OrderByNamedAttribute("g", ASCENDING);
    order->OrderByNamedAttribute("v", DESCENDING);
    std::unique_ptr<Operation> op(
        Sort(order, ProjectAllAttributes(), 1LL << 62, ScanView(half)));
    op->SetBufferAllocator(alloc, false);
    std::unique_ptr<Cursor> cursor(SucceedOrDie(op->CreateCursor()));
    Table* out = new Table(fact->schema(), alloc);
    out->ReserveRowCapacity(kFactRows / 2);
    TableSink sink(out);
    Writer writer(cursor.release());
    SucceedOrDie(writer.WriteAll(&sink));
    SucceedOrDie(sink.Finalize());
    return out;
  }

  Operation* FilterOp() {
    return Filter(Greater(NamedAttribute("v"), ConstFloat(0.5f)),
                  ProjectAllAttributes(), ScanView(fact->view()));
  }

  Operation* GroupByOp(const char* key, int64 estimate) {
    AggregationSpecification* agg = new AggregationSpecification();
    agg->AddAggregation(SUM, "v", "sv");
    GroupAggregateOptions* options = new GroupAggregateOptions();
    options->set_estimated_result_row_count(estimate);
    return GroupAggregate(ProjectNamedAttribute(key), agg, options,
                          ScanView(fact->view()));
  }

  Operation* SortOp(Operation* child, const char* key1, const char* key2) {
    SortOrder* order = new SortOrder();
    order->OrderByNamedAttribute(key1, ASCENDING);
    if (key2 != NULL) order->OrderByNamedAttribute(key2, DESCENDING);
    return Sort(order, ProjectAllAttributes(), 1LL << 62, child);
  }

  Operation* JoinOp(Operation* lhs, Operation* rhs) {
    CompoundMultiSourceProjector* result = new CompoundMultiSourceProjector();
    result->add(0, ProjectNamedAttribute("v"));
    result->add(0, ProjectNamedAttribute("g"));
    result->add(1, ProjectNamedAttribute("w"));
    return new HashJoinOperation(
        INNER, ProjectNamedAttribute("fk"), ProjectNamedAttribute("pk"),
        result, UNIQUE, lhs, rhs);
  }

  // rhs multiset probe (row_hash_set.cc:581-599) / LEFT_OUTER NULL
  // emission (hash_join.cc:801-806)
  Operation* JoinVariant(Operation* lhs, Operation* rhs, JoinType jt,
                         KeyUniqueness uniq) {
    CompoundMultiSourceProjector* result = new CompoundMultiSourceProjector();
    result->add(0, ProjectNamedAttribute("v"));
    result->add(1, ProjectNamedAttribute("w"));
    return new HashJoinOperation(
        jt, ProjectNamedAttribute("fk"), ProjectNamedAttribute("pk"),
        result, uniq, lhs, rhs);
  }

  Operation* GroupByStrOp() {
    AggregationSpecification* agg = new AggregationSpecification();
    agg->AddAggregation(SUM, "v", "sv");
    GroupAggregateOptions* options = new GroupAggregateOptions();
    options->set_estimated_result_row_count(64);
    return GroupAggregate(ProjectNamedAttribute("k"), agg, options,
                          ScanView(fact_str->view()));
  }

  Operation* MergeUnionOp() {
    SortOrder* order = new SortOrder();
    order->OrderByNamedAttribute("g", ASCENDING);
    order->OrderByNamedAttribute("v", DESCENDING);
    std::vector<Operation*> children;
    children.push_back(ScanView(sorted_a->view()));
    children.push_back(ScanView(sorted_b->view()));
    return MergeUnionAll(order, children);
  }

  // bench.py's headline pipeline: filter -> join -> group-by(64) -> sort.
  Operation* PipelineOp() {
    CompoundMultiSourceProjector* result = new CompoundMultiSourceProjector();
    result->add(0, ProjectNamedAttribute("v"));
    result->add(1, ProjectNamedAttribute("w"));
    Operation* join = new HashJoinOperation(
        INNER, ProjectNamedAttribute("fk"), ProjectNamedAttribute("pk"),
        result, UNIQUE,
        Filter(Greater(NamedAttribute("v"), ConstFloat(0.5f)),
               ProjectAllAttributes(), ScanView(fact->view())),
        ScanView(dim->view()));
    AggregationSpecification* agg = new AggregationSpecification();
    agg->AddAggregation(SUM, "v", "sv");
    agg->AddAggregation(COUNT, "v", "c");
    GroupAggregateOptions* options = new GroupAggregateOptions();
    options->set_estimated_result_row_count(kGroups);
    Operation* grouped = GroupAggregate(
        ProjectNamedAttribute("w"), agg, options, join);
    SortOrder* order = new SortOrder();
    order->OrderByNamedAttribute("sv", DESCENDING);
    return Sort(order, ProjectAllAttributes(), 1LL << 62, grouped);
  }

  void Run(const char* name, Operation* op, double input_rows,
           int reps = 3) {
    std::unique_ptr<Operation> owned(op);
    owned->SetBufferAllocator(alloc, false);
    double best = 1e30;
    size_t rows = 0;
    for (int rep = 0; rep < reps; ++rep) {
      double t0 = NowSec();
      std::unique_ptr<Cursor> cursor(SucceedOrDie(owned->CreateCursor()));
      rows = Drain(cursor.get());
      double dt = NowSec() - t0;
      if (dt < best) best = dt;
    }
    printf("%-24s %9.1f ms   %10.1f M rows/s   (out rows=%zu)\n", name,
           best * 1e3, input_rows / best / 1e6, rows);
    fflush(stdout);
  }
};

// BASELINE.json config-scale workloads: the exact
// shapes the JAX engine runs at config scale —
//   config 3: sort 100M rows (k int32 uniform [0,2^30), v f32) by
//             (k ASC, v DESC)
//   config 4: join probe 100M (fk in [0,1M), v f32) x build 1M UNIQUE,
//             project (v, w)
// Run separately (--big) so the 8M sweep stays quick; best-of-1 — the
// reference is deterministic and minutes-long runs don't jitter at the
// margins that matter here.
struct BigBench {
  BufferAllocator* alloc;
  static const int64 kBigRows = 100LL * 1000 * 1000;
  std::unique_ptr<Table> big;    // (k, v) for config 3
  std::unique_ptr<Table> probe;  // (fk, v) for config 4
  std::unique_ptr<Table> dim;    // (pk, w) 1M

  void BuildData() {
    std::mt19937 rng(42);
    std::uniform_int_distribution<int32> k_d(0, (1 << 30) - 1);
    std::uniform_int_distribution<int32> fk_d(0, kDimRows - 1);
    std::uniform_int_distribution<int32> g_d(0, kGroups - 1);
    std::uniform_real_distribution<float> v_d(0.0f, 1.0f);

    TupleSchema big_schema;
    big_schema.add_attribute(Attribute("k", INT32, NOT_NULLABLE));
    big_schema.add_attribute(Attribute("v", FLOAT, NOT_NULLABLE));
    big.reset(new Table(big_schema, alloc));
    big->ReserveRowCapacity(kBigRows);
    for (int64 i = 0; i < kBigRows; ++i) {
      rowid_t row = big->AddRow();
      big->Set<INT32>(0, row, k_d(rng));
      big->Set<FLOAT>(1, row, v_d(rng));
    }

    TupleSchema probe_schema;
    probe_schema.add_attribute(Attribute("fk", INT32, NOT_NULLABLE));
    probe_schema.add_attribute(Attribute("v", FLOAT, NOT_NULLABLE));
    probe.reset(new Table(probe_schema, alloc));
    probe->ReserveRowCapacity(kBigRows);
    for (int64 i = 0; i < kBigRows; ++i) {
      rowid_t row = probe->AddRow();
      probe->Set<INT32>(0, row, fk_d(rng));
      probe->Set<FLOAT>(1, row, v_d(rng));
    }

    TupleSchema dim_schema;
    dim_schema.add_attribute(Attribute("pk", INT32, NOT_NULLABLE));
    dim_schema.add_attribute(Attribute("w", INT32, NOT_NULLABLE));
    dim.reset(new Table(dim_schema, alloc));
    dim->ReserveRowCapacity(kDimRows);
    for (int i = 0; i < kDimRows; ++i) {
      rowid_t row = dim->AddRow();
      dim->Set<INT32>(0, row, i);
      dim->Set<INT32>(1, row, g_d(rng));
    }
  }

  Operation* SortOp() {
    SortOrder* order = new SortOrder();
    order->OrderByNamedAttribute("k", ASCENDING);
    order->OrderByNamedAttribute("v", DESCENDING);
    return Sort(order, ProjectAllAttributes(), 1LL << 62,
                ScanView(big->view()));
  }

  Operation* JoinOp() {
    CompoundMultiSourceProjector* result = new CompoundMultiSourceProjector();
    result->add(0, ProjectNamedAttribute("v"));
    result->add(1, ProjectNamedAttribute("w"));
    return new HashJoinOperation(
        INNER, ProjectNamedAttribute("fk"), ProjectNamedAttribute("pk"),
        result, UNIQUE, ScanView(probe->view()), ScanView(dim->view()));
  }
};

// BASELINE.json config-2 workloads (scripts/bench_configs.py shapes):
// 10M rows, STRING key with 50 distinct values (4 aggregations) and an
// INT32 key over [0, 2^22) (~3.9M distinct, SUM).
struct Cfg2Bench {
  BufferAllocator* alloc;
  static const int64 kRows = 10LL * 1000 * 1000;
  std::unique_ptr<Table> fact2;

  void BuildData() {
    std::mt19937 rng(42);
    std::uniform_int_distribution<int> g_d(0, 49);
    std::uniform_int_distribution<int32> k_d(0, (1 << 22) - 1);
    std::uniform_real_distribution<float> v_d(0.0f, 1.0f);
    TupleSchema schema;
    schema.add_attribute(Attribute("g", STRING, NOT_NULLABLE));
    schema.add_attribute(Attribute("k", INT32, NOT_NULLABLE));
    schema.add_attribute(Attribute("v", FLOAT, NOT_NULLABLE));
    fact2.reset(new Table(schema, alloc));
    fact2->ReserveRowCapacity(kRows);
    char buf[16];
    for (int64 i = 0; i < kRows; ++i) {
      rowid_t row = fact2->AddRow();
      snprintf(buf, sizeof(buf), "cat_%02d", g_d(rng));
      fact2->Set<STRING>(0, row, StringPiece(buf));
      fact2->Set<INT32>(1, row, k_d(rng));
      fact2->Set<FLOAT>(2, row, v_d(rng));
    }
  }

  Operation* GroupBy50Op() {
    AggregationSpecification* agg = new AggregationSpecification();
    agg->AddAggregation(SUM, "v", "sv");
    agg->AddAggregation(MIN, "v", "mn");
    agg->AddAggregation(MAX, "v", "mx");
    agg->AddAggregation(COUNT, "v", "n");
    GroupAggregateOptions* options = new GroupAggregateOptions();
    options->set_estimated_result_row_count(64);
    return GroupAggregate(ProjectNamedAttribute("g"), agg, options,
                          ScanView(fact2->view()));
  }

  Operation* GroupByHiOp() {
    AggregationSpecification* agg = new AggregationSpecification();
    agg->AddAggregation(SUM, "v", "sv");
    GroupAggregateOptions* options = new GroupAggregateOptions();
    options->set_estimated_result_row_count(1 << 22);
    return GroupAggregate(ProjectNamedAttribute("k"), agg, options,
                          ScanView(fact2->view()));
  }
};

}  // namespace

int main(int argc, char** argv) {
  if (argc > 1 && std::string(argv[1]) == "--hybrid") {
    // spilling hybrid aggregate at the JAX engine's shape: 8M rows,
    // 1M distinct keys, 16 MB quota (forces the disk path)
    Bench bench;
    bench.alloc = HeapBufferAllocator::Get();
    double t0 = NowSec();
    bench.BuildData();
    fprintf(stderr, "data build: %.1f s\n", NowSec() - t0);
    AggregationSpecification* agg = new AggregationSpecification();
    agg->AddAggregation(SUM, "v", "sv");
    agg->AddAggregation(COUNT, "v", "c");
    bench.Run("hybrid spill 8M->1M",
              HybridGroupAggregate(ProjectNamedAttribute("fk"), agg,
                                   16 << 20, "/tmp/ss_hybrid",
                                   ScanView(bench.fact->view())),
              kFactRows, 1);
    return 0;
  }
  if (argc > 1 && std::string(argv[1]) == "--cfg2") {
    Cfg2Bench cfg2;
    cfg2.alloc = HeapBufferAllocator::Get();
    double t0 = NowSec();
    cfg2.BuildData();
    fprintf(stderr, "cfg2 data build: %.1f s\n", NowSec() - t0);
    Bench runner;
    runner.alloc = cfg2.alloc;
    runner.Run("groupby 10M->50 (4 aggs)", cfg2.GroupBy50Op(),
               (double)Cfg2Bench::kRows);
    runner.Run("groupby 10M->~3.9M SUM", cfg2.GroupByHiOp(),
               (double)Cfg2Bench::kRows);
    return 0;
  }
  if (argc > 1 && std::string(argv[1]) == "--big") {
    BigBench big;
    big.alloc = HeapBufferAllocator::Get();
    double t0 = NowSec();
    big.BuildData();
    fprintf(stderr, "big data build: %.1f s\n", NowSec() - t0);
    Bench runner;
    runner.alloc = big.alloc;
    runner.Run("sort 100M (config 3)", big.SortOp(),
               (double)BigBench::kBigRows, 1);
    runner.Run("join 100M x 1M (config 4)", big.JoinOp(),
               (double)BigBench::kBigRows, 1);
    return 0;
  }
  Bench bench;
  bench.alloc = HeapBufferAllocator::Get();
  double t0 = NowSec();
  bench.BuildData();
  fprintf(stderr, "data build: %.1f s\n", NowSec() - t0);

  bench.Run("filter 8M", bench.FilterOp(), kFactRows);
  bench.Run("groupby 8M->64", bench.GroupByOp("g", kGroups), kFactRows);
  bench.Run("groupby 8M->1M keys", bench.GroupByOp("fk", kDimRows),
            kFactRows);
  bench.Run("sort 8M by (g,v)",
            bench.SortOp(ScanView(bench.fact->view()), "g", "v"), kFactRows);
  bench.Run("join 8M x 1M",
            bench.JoinOp(ScanView(bench.fact->view()),
                         ScanView(bench.dim->view())),
            kFactRows);
  bench.Run("join 8M NOT_UNIQUE dup8",
            bench.JoinVariant(ScanView(bench.fact8->view()),
                              ScanView(bench.dim8->view()),
                              INNER, NOT_UNIQUE),
            kFactRows);
  bench.Run("join 8M LEFT_OUTER",
            bench.JoinVariant(ScanView(bench.fact2m->view()),
                              ScanView(bench.dim->view()),
                              LEFT_OUTER, UNIQUE),
            kFactRows);
  bench.Run("groupby_str 8M->50", bench.GroupByStrOp(), kFactRows);
  bench.Run("merge_union 2x4M", bench.MergeUnionOp(), kFactRows);
  bench.Run("compute 8M c0*(sin+exp)", bench.ComputeOp(), kFactRows);
  bench.Run("join_str 8M x 1M", bench.JoinStrOp(), kFactRows);
  bench.Run("pipeline 8M", bench.PipelineOp(), kFactRows);
  return 0;
}

"""Golden bit-exactness tests against the REAL reference engine.

`refbuild/bin/golden_dump` (the actual google/supersonic C++ engine built
from /root/reference) runs a fixed query set on deterministic seeded
inputs and dumps both inputs and outputs in the reference's own FileSink
wire format (file_io.cc:194).  The generated files are committed under
tests/golden/.  Here each case reads the inputs back through
`io.file_io.read_reference_file`, runs the SAME plan through this
engine, and asserts row-for-row equality with the C++ engine's output:

  * INT/UINT/BOOL/DATE/STRING columns and NULL masks: bit-exact.
  * FLOAT/DOUBLE columns: exact for order-insensitive ops (MIN/MAX/sort/
    filter), tiny-ULP tolerance where accumulation order (SUM) or libm
    (sin/exp) legitimately differs — the only documented divergences.

Regenerate with:  refbuild/bin/golden_dump tests/golden > tests/golden/manifest.txt
"""
from __future__ import annotations

import math
import pathlib

import numpy as np
import pytest

from supersonic_jax import (AggSpec, Aggregation, Compute, ConstInt32, Day,
                            DataType, DivideNulling, Exp, Filter, Greater,
                            GroupAggregate, HashJoin, If, IfNull, IsNull,
                            JoinType, KeyUniqueness, Length, MergeUnionAll,
                            Modulus, Month, Multiply, Plus, Projector,
                            ScalarAggregate, ScanTable, Sin, Sort, SortKey,
                            ToUpper, TupleSchema, Year, col, execute)
from supersonic_jax.io.file_io import read_reference_file

GOLDEN = pathlib.Path(__file__).parent / "golden"

pytestmark = pytest.mark.skipif(
    not (GOLDEN / "manifest.txt").exists(),
    reason="golden files not generated (run refbuild/bin/golden_dump)")

SUM, MIN, MAX, COUNT = (Aggregation.SUM, Aggregation.MIN, Aggregation.MAX,
                        Aggregation.COUNT)


# ENUM value maps are out-of-band in the FileSink wire format (the schema
# itself is out-of-band, file_io.cc:319); these mirror the definitions in
# refbuild/golden_dump.cc by column name.
from supersonic_jax import Attribute, EnumDefinition

GOLDEN_ENUMS = {
    "e": EnumDefinition(("iron", "zinc", "gold", "lead", "tin")),
}


def _parse_schema(spec: str) -> TupleSchema:
    attrs = []
    for part in spec.split(","):
        name, typ, nul = part.rsplit(":", 2)
        t = DataType(typ)
        if t == DataType.ENUM:
            attrs.append(Attribute(name, t, nul == "Y",
                                   enum=GOLDEN_ENUMS[name]))
        else:
            attrs.append((name, t, nul == "Y"))
    return TupleSchema.of(*attrs)


def _manifest():
    cases: dict[str, dict] = {}
    for line in (GOLDEN / "manifest.txt").read_text().splitlines():
        fields = line.split(" ")
        if fields[0] == "in":
            _, case, idx, fname, rows = fields[:5]
            spec = " ".join(fields[5:])
            cases.setdefault(case, {"in": []})["in"].append(
                (fname, int(rows), _parse_schema(spec)))
        elif fields[0] == "out":
            _, case, fname, rows = fields[:4]
            spec = " ".join(fields[4:])
            cases.setdefault(case, {"in": []})["out"] = (
                fname, int(rows), _parse_schema(spec))
    return cases


MANIFEST = _manifest() if (GOLDEN / "manifest.txt").exists() else {}


def _inputs(case: str) -> list:
    return [read_reference_file(schema, str(GOLDEN / fname))
            for fname, _rows, schema in MANIFEST[case]["in"]]


def _golden_out(case: str):
    fname, rows, schema = MANIFEST[case]["out"]
    t = read_reference_file(schema, str(GOLDEN / fname))
    assert int(t.num_rows) == rows
    return t


def _host_columns(table):
    """-> (values dict col->np array decoded to python-comparable form,
    valid dict col->bool array)."""
    n = int(table.num_rows)
    vals, valids = {}, {}
    for a in table.schema:
        c = table.columns[a.name]
        v = np.asarray(c.values)[:n]
        ok = (np.ones(n, dtype=bool) if c.valid is None
              else np.asarray(c.valid)[:n])
        if a.type in (DataType.STRING, DataType.BINARY):
            d = table.dicts[a.name]
            payloads = np.array(list(d.values) + [""], dtype=object)
            codes = np.clip(v.astype(np.int64), 0, len(d.values))
            v = payloads[np.where(ok, codes, len(d.values))]
        vals[a.name] = v
        valids[a.name] = ok
    return vals, valids


def assert_tables_match(actual, golden, sort_by: list[int] | None = None,
                        float_rtol: float = 0.0):
    """Column-positional comparison (names may differ across engines).

    sort_by: indices of exactly-typed columns forming a unique row key —
    both outputs are canonically ordered by them before comparison (used
    for hash-based ops whose row order is engine-defined).  None = ordered
    comparison.  float_rtol > 0 allows that relative error on FLOAT/DOUBLE
    values (summation-order / libm divergence); 0 = bit-exact floats.
    """
    a_names = actual.schema.names()
    g_names = golden.schema.names()
    assert len(a_names) == len(g_names), (a_names, g_names)
    assert int(actual.num_rows) == int(golden.num_rows)
    a_vals, a_ok = _host_columns(actual)
    g_vals, g_ok = _host_columns(golden)
    # type parity (FLOAT vs DOUBLE etc. must match the reference exactly)
    for an, gn in zip(actual.schema, golden.schema):
        assert an.type == gn.type, \
            f"column {an.name}: {an.type} != reference {gn.type}"
        assert an.nullable == gn.nullable, \
            f"column {an.name}: nullable {an.nullable} != {gn.nullable}"

    if sort_by is not None:
        def perm(vals, ok, names):
            keys = []
            for i in reversed(sort_by):
                v = vals[names[i]]
                assert ok[names[i]].all(), "sort_by column has NULLs"
                keys.append(v)
            return np.lexsort(keys)
        ap = perm(a_vals, a_ok, a_names)
        gp = perm(g_vals, g_ok, g_names)
    else:
        ap = gp = np.arange(int(actual.num_rows))

    for i, (an, gn) in enumerate(zip(a_names, g_names)):
        av, gv = a_vals[an][ap], g_vals[gn][gp]
        am, gm = a_ok[an][ap], g_ok[gn][gp]
        np.testing.assert_array_equal(
            am, gm, err_msg=f"null mask mismatch in column {i} ({gn})")
        av, gv = av[am], gv[gm]
        is_float = actual.schema.attribute(i).type in (DataType.FLOAT, DataType.DOUBLE)
        if is_float and float_rtol > 0.0:
            np.testing.assert_allclose(
                av.astype(np.float64), gv.astype(np.float64),
                rtol=float_rtol, atol=0.0,
                err_msg=f"value mismatch in column {i} ({gn})")
        else:
            np.testing.assert_array_equal(
                av, gv, err_msg=f"value mismatch in column {i} ({gn})")


# --- the cases (plans mirror refbuild/golden_dump.cc) ----------------------

def test_golden_primer_sum():
    (t,) = _inputs("primer_sum")
    out = execute(GroupAggregate(
        ["key"], [AggSpec(SUM, "data", "data_sums")], ScanTable(t)))
    # DOUBLE SUM: accumulation order differs (tile-parallel vs row-serial).
    assert_tables_match(out, _golden_out("primer_sum"), sort_by=[0],
                        float_rtol=1e-12)


def test_golden_guide_agg():
    (t,) = _inputs("guide_agg")
    out = execute(GroupAggregate(
        ["department"],
        [AggSpec(SUM, "salary", "salary_sum"),
         AggSpec(MIN, "age", "age_min"),
         AggSpec(MAX, "age", "age_max"),
         AggSpec(COUNT, "age", "age_cnt")],
        ScanTable(t)))
    # INT32 SUM wraps exactly; MIN/MAX/COUNT exact -> fully bit-exact.
    assert_tables_match(out, _golden_out("guide_agg"), sort_by=[0])


def test_golden_guide_sort():
    (t,) = _inputs("guide_sort")
    out = execute(Sort([SortKey("grade", ascending=False),
                        SortKey("id", ascending=True)], ScanTable(t)))
    assert_tables_match(out, _golden_out("guide_sort"))


def test_golden_guide_join():
    authors, books = _inputs("guide_join")
    out = execute(HashJoin(
        JoinType.INNER, ["author_id_ref"], ["author_id"],
        ScanTable(books), ScanTable(authors), KeyUniqueness.UNIQUE,
        lhs_projector=Projector.named("book_id", "title", "date_published"),
        rhs_projector=Projector.named("name", "nobel")))
    assert_tables_match(out, _golden_out("guide_join"), sort_by=[0])


def test_golden_bench_group():
    (t,) = _inputs("bench_group")
    out = execute(GroupAggregate(
        ["col0"], [AggSpec(MAX, "col1", "col1_maxes")], ScanTable(t)))
    assert_tables_match(out, _golden_out("bench_group"), sort_by=[0])


def test_golden_bench_compute():
    (t,) = _inputs("bench_compute")
    out = execute(Compute(
        (col("col0") * (Sin(col("col2")) + Exp(col("col1")))).as_("expr"),
        ScanTable(t)))
    # libm sin/exp vs XLA implementations differ in final ULPs.
    assert_tables_match(out, _golden_out("bench_compute"), float_rtol=1e-13)


def _bench_sort_keys():
    return [SortKey("col0", ascending=True), SortKey("col1", ascending=False)]


def test_golden_bench_sort():
    (t,) = _inputs("bench_sort")
    out = execute(Sort(_bench_sort_keys(), ScanTable(t)))
    assert_tables_match(out, _golden_out("bench_sort"))


def test_golden_bench_merge():
    t0, t1 = _inputs("bench_merge")
    out = execute(MergeUnionAll(
        _bench_sort_keys(),
        [Sort(_bench_sort_keys(), ScanTable(t0)),
         Sort(_bench_sort_keys(), ScanTable(t1))]))
    assert_tables_match(out, _golden_out("bench_merge"))


def test_golden_bench_join():
    lhs_in, rhs_in = _inputs("bench_join")
    lhs = Sort(_bench_sort_keys(), ScanTable(lhs_in))
    rhs = GroupAggregate(
        ["col0"], [AggSpec(MAX, "col1", "col1_maxes")], ScanTable(rhs_in))
    out = execute(HashJoin(
        JoinType.LEFT_OUTER, ["col1"], ["col0"], lhs, rhs,
        KeyUniqueness.UNIQUE,
        lhs_projector=Projector([("col0", "L.col0"), ("col1", "L.col1")]),
        rhs_projector=Projector([("col0", "R.col0"),
                                 ("col1_maxes", "R.col1_maxes")])))
    # L.col1 is a unique STRING key -> canonical order on it.
    assert_tables_match(out, _golden_out("bench_join"), sort_by=[1])


def test_golden_filter_null():
    (t,) = _inputs("filter_null")
    out = execute(Filter(Greater(col("a"), ConstInt32(50)), ScanTable(t)))
    assert_tables_match(out, _golden_out("filter_null"))


def test_golden_scalar_empty():
    (t,) = _inputs("scalar_empty")
    out = execute(ScalarAggregate(
        [AggSpec(SUM, "x", "x_sum"), AggSpec(COUNT, "x", "x_cnt")],
        ScanTable(t)))
    assert_tables_match(out, _golden_out("scalar_empty"))


def test_golden_expr_mix():
    (t,) = _inputs("expr_mix")
    a, b, s, d = col("a"), col("b"), col("s"), col("d")
    out = execute(Compute(
        [Plus(a, ConstInt32(7)).as_("plus7"),
         IsNull(a).as_("isnull"),
         IfNull(a, ConstInt32(-99)).as_("ifnull"),
         If(Greater(b, 0.0), a, ConstInt32(-1)).as_("ifgt"),
         DivideNulling(a, Modulus(a, ConstInt32(5))).as_("ndiv"),
         Length(s).as_("slen"),
         ToUpper(s).as_("supper"),
         Year(d).as_("year"),
         Month(d).as_("month"),
         Day(d).as_("day")],
        ScanTable(t)))
    # Integer inputs -> DOUBLE division is exact; everything else integral.
    assert_tables_match(out, _golden_out("expr_mix"))


def test_golden_limit():
    (t,) = _inputs("limit")
    from supersonic_jax import Limit
    out = execute(Limit(137, 4321, ScanTable(t)))
    assert_tables_match(out, _golden_out("limit"))


def test_golden_coalesce():
    t0, t1 = _inputs("coalesce")
    from supersonic_jax import Coalesce
    out = execute(Coalesce(ScanTable(t0), ScanTable(t1)))
    assert_tables_match(out, _golden_out("coalesce"))


def test_golden_agg_clusters():
    (t,) = _inputs("agg_clusters")
    from supersonic_jax import AggregateClusters
    out = execute(AggregateClusters(
        ["k"],
        [AggSpec(SUM, "v", "sv"), AggSpec(Aggregation.MIN, "v", "mn"),
         AggSpec(COUNT, "v", "c")],
        ScanTable(t)))
    # streaming cluster order == input cluster order: ordered compare
    assert_tables_match(out, _golden_out("agg_clusters"))


def test_golden_rowid_join():
    left, right = _inputs("rowid_join")
    from supersonic_jax import RowidMergeJoin
    out = execute(RowidMergeJoin(
        "fk", ScanTable(left), ScanTable(right),
        lhs_projector=Projector([("fk", "L.fk"), ("lv", "L.lv")]),
        rhs_projector=Projector([("name", "R.name"), ("w", "R.w")])))
    assert_tables_match(out, _golden_out("rowid_join"))


def test_golden_foreign_filter():
    filt, inp = _inputs("foreign_filter")
    from supersonic_jax import ForeignFilter
    out = execute(ForeignFilter("fk", "key", ScanTable(inp),
                                ScanTable(filt)))
    assert_tables_match(out, _golden_out("foreign_filter"))


def test_golden_proto_expression_interop():
    """Wire-format serialization interop: the SAME ExpressionDescription
    proto bytes that the reference's BuildExpressionFromProto evaluated
    (refbuild/golden_dump.cc::CaseProtoExpr) deserialize here through
    build_expression_from_proto_bytes and must produce the same rows."""
    from supersonic_jax.io.serialization import (
        build_expression_from_proto_bytes)

    (t,) = _inputs("proto_expr")
    wire = (GOLDEN / "proto_expr.pb").read_bytes()
    expr = build_expression_from_proto_bytes(wire)
    out = execute(Compute(expr.as_("r"), ScanTable(t)))
    # a + b*2.0: pure float arithmetic in both engines — bit-exact
    assert_tables_match(out, _golden_out("proto_expr"))


def test_golden_tostring():
    """Device ToString (bounded-domain dictionary LUT) must reproduce the
    reference printer formats exactly (types_infrastructure.cc:45-110):
    BOOL TRUE/FALSE, DATE %Y/%m/%d, ints decimal.

    Golden inputs stay below day 24855: the reference's DATE printer goes
    through a 32-bit time_t and wraps past 2038-01-19 (printing 1901/02
    dates) — a reference bug this engine does not reproduce."""
    from supersonic_jax import ToString

    (t,) = _inputs("tostring")
    out = execute(Compute(
        [ToString(col("b")).as_("sb"),
         ToString(col("d"), domain=(0, 25000)).as_("sd"),
         ToString(col("i"), domain=(-500, 500)).as_("si")],
        ScanTable(t)))
    assert_tables_match(out, _golden_out("tostring"))


def test_golden_stateful():
    """Cross-row stateful expressions vs the real engine
    (stateful_expressions.h:30-71): the reference carries per-cursor
    state across 1024-row views; this engine computes the same semantics
    as whole-column parallel scans (exprs/stateful.py) — results must be
    identical row for row."""
    from supersonic_jax import (Changed, RunningMinWithFlush, RunningSum,
                                Smudge, SmudgeIf)

    (t,) = _inputs("stateful")
    out = execute(Compute(
        [Changed(col("seq")).as_("chg"),
         RunningSum(col("v")).as_("rsum"),
         Smudge(col("v")).as_("smu"),
         SmudgeIf(col("v"), col("flush")).as_("smuif"),
         RunningMinWithFlush(col("flush"), col("v")).as_("rmin")],
        ScanTable(t)))
    assert_tables_match(out, _golden_out("stateful"))


def test_golden_string_ops():
    """String transforms vs the real engine (string_expressions.h:73-102;
    string_bound_expressions.cc): MySQL-style Substring incl. negative
    positions, 1-based StringOffset, StringReplace, and a Concat of two
    NON-constant string columns — this engine's cross-product
    dictionary device path."""
    from supersonic_jax import (Concat, StringOffset, StringReplace,
                                Substring)

    (t,) = _inputs("string_ops")
    out = execute(Compute(
        [Substring(col("s"), 2, 3).as_("sub"),
         Substring(col("s"), -3, 2).as_("subn"),
         StringOffset(col("s"), "a").as_("off"),
         StringReplace(col("s"), "a", "oo").as_("rep"),
         Concat(col("s"), "-", col("s2")).as_("cat")],
        ScanTable(t)))
    assert_tables_match(out, _golden_out("string_ops"))


def test_golden_makedate():
    """MakeDate/MakeDatetime vs the real engine: mkgmtime_int64
    NORMALIZES out-of-range months/days (month 13 -> next January, Feb 30
    -> Mar 2; date_evaluators.cc:36-58); MakeDatetime adds
    hour/minute/second unchecked and NULLs pre-epoch date parts
    (date_bound_expressions.cc:123-126)."""
    from supersonic_jax import AddMonths, Const, MakeDate, MakeDatetime

    (t,) = _inputs("makedate")
    out = execute(Compute(
        [MakeDate(col("y"), col("m"), col("d")).as_("md"),
         MakeDatetime(col("y2"), col("m"), col("d"), col("h"),
                      Const(90), Const(-5)).as_("mdt"),
         AddMonths(MakeDate(col("y"), Const(1), col("d")),
                   col("m")).as_("addm")],
        ScanTable(t)))
    assert_tables_match(out, _golden_out("makedate"))


def test_golden_date_local():
    """*Local date operators + DateFormat/DateFormatLocal vs the real
    engine under TZ=America/New_York (golden_dump pins the TZ and renders
    through localtime_r/gmtime_r + strftime, date_evaluators.cc:204-265).
    The engine side compiles the same IANA zone into day-LUT offsets
    (exprs/tz.py); every column must be bit-exact, including the 2024 DST
    boundary instants the input embeds."""
    from supersonic_jax import (DateFormat, DateFormatLocal, DayLocal,
                                HourLocal, MinuteLocal, MonthLocal,
                                WeekdayLocal, YearLocal, set_local_timezone)

    (t,) = _inputs("date_local")
    hi_us = 2_100_000_000 * 1_000_000
    set_local_timezone("America/New_York")
    try:
        out = execute(Compute(
            [YearLocal(col("t")).as_("y"),
             MonthLocal(col("t")).as_("mo"),
             DayLocal(col("t")).as_("dy"),
             HourLocal(col("t")).as_("h"),
             MinuteLocal(col("t")).as_("mi"),
             WeekdayLocal(col("t")).as_("wd"),
             DateFormat(col("t"), "%Y/%m/%d %a",
                        domain=(0, hi_us)).as_("fmt"),
             DateFormatLocal(col("t"), "%Y/%m/%d %a",
                             domain=(0, hi_us)).as_("fmtl")],
            ScanTable(t)))
    finally:
        set_local_timezone(None)
    assert_tables_match(out, _golden_out("date_local"))


def test_reference_format_roundtrip(tmp_path):
    """write_reference_file emits the same wire format read_reference_file
    parses — the write half of interchange with the C++ FileInputCursor."""
    from supersonic_jax.io.file_io import write_reference_file

    for case in ("guide_join", "expr_mix", "bench_merge"):
        for i, (fname, rows, schema) in enumerate(MANIFEST[case]["in"]):
            t = read_reference_file(schema, str(GOLDEN / fname))
            p = tmp_path / f"{case}_{i}.dat"
            write_reference_file(t, str(p))
            t2 = read_reference_file(schema, str(p))
            assert_tables_match(t2, t)


def test_golden_concat_agg():
    """In-plan CONCAT aggregation vs the C++ engine: "," separator, NULL
    inputs skipped, all-NULL group NULL, INT64 values stringified
    (aggregation_operators.h:235-283, column_aggregator.cc:496+)."""
    (t,) = _inputs("concat_agg")
    out = execute(GroupAggregate(
        ["k"],
        [AggSpec(Aggregation.CONCAT, "s", "cs"),
         AggSpec(Aggregation.CONCAT, "v", "cv"),
         AggSpec(Aggregation.CONCAT, "s", "csd", distinct=True),
         AggSpec(SUM, "v", "sv")],
        ScanTable(t)))
    # INT64 SUM wraps exactly; CONCAT byte-exact -> fully bit-exact.
    assert_tables_match(out, _golden_out("concat_agg"), sort_by=[0])


def test_golden_concat_float():
    """CONCAT of FLOAT/DOUBLE inputs vs the C++ engine: values rendered
    via SimpleFtoa/SimpleDtoa — "%.6g"/"%.15g" with round-trip retry at
    "%.8g"/"%.17g" (utils/strings/numbers.cc:1249-1297) — so the string
    results are byte-exact, including the retry-form values."""
    (t,) = _inputs("concat_float")
    out = execute(GroupAggregate(
        ["k"],
        [AggSpec(Aggregation.CONCAT, "f", "cf"),
         AggSpec(Aggregation.CONCAT, "d", "cd")],
        ScanTable(t)))
    assert_tables_match(out, _golden_out("concat_float"), sort_by=[0])


def test_golden_enum_binary():
    """ENUM (value-number compare, types_infrastructure.cc:511-514) and
    BINARY (var-length wire path, file_io.cc:77-101) through
    group-by + sort."""
    (t,) = _inputs("enum_binary")
    out = execute(Sort(
        [SortKey("e"), SortKey("b")],
        GroupAggregate(["e", "b"],
                       [AggSpec(SUM, "v", "sv"),
                        AggSpec(COUNT, "b", "cb")],
                       ScanTable(t))))
    assert_tables_match(out, _golden_out("enum_binary"))


def test_golden_tostring_no_domain_hints():
    """The SAME golden case as test_golden_tostring but WITHOUT domain=
    hints: unbounded ints render through the deferred-dictionary path
    (row-position codes on device, PrintTyped rendering at
    execute) and must still match the C++ engine's output
    byte for byte."""
    from supersonic_jax import ToString

    (t,) = _inputs("tostring")
    out = execute(Compute(
        [ToString(col("b")).as_("sb"),
         ToString(col("d")).as_("sd"),
         ToString(col("i")).as_("si")],
        ScanTable(t)))
    assert_tables_match(out, _golden_out("tostring"))

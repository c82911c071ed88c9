"""Aggregation tests (reference analogue: aggregate_groups_test.cc,
aggregate_scalar_test, aggregate_clusters_test)."""
import pytest

from supersonic_jax import (DOUBLE, INT64, STRING, AggregateClusters, AggSpec, DataType,
                            Aggregation, GroupAggregate, GroupAggregateOptions,
                            ScalarAggregate, ScanTable, Table, TupleSchema,
                            execute)

SUM, MIN, MAX, COUNT = (Aggregation.SUM, Aggregation.MIN, Aggregation.MAX,
                        Aggregation.COUNT)
FIRST, LAST = Aggregation.FIRST, Aggregation.LAST


def make_table():
    schema = TupleSchema.of(("k", STRING), ("v", INT64), ("x", DOUBLE))
    return Table.from_data(schema, {
        "k": ["b", "a", "b", None, "a", "b"],
        "v": [1, 2, 3, 4, None, 6],
        "x": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
    })


def test_group_sum_insertion_order():
    out = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "sv")],
                                 ScanTable(make_table())))
    # insertion order of first key occurrence: b, a, NULL
    assert out.to_pylist() == [("b", 10), ("a", 2), (None, 4)]


def test_group_count_min_max():
    out = execute(GroupAggregate(
        ["k"],
        [AggSpec(COUNT, "v", "c"), AggSpec(MIN, "v", "mn"),
         AggSpec(MAX, "v", "mx")],
        ScanTable(make_table())))
    assert out.to_pylist() == [
        ("b", 3, 1, 6), ("a", 1, 2, 2), (None, 1, 4, 4)]


def test_count_star():
    out = execute(GroupAggregate(["k"], [AggSpec(COUNT, None, "c")],
                                 ScanTable(make_table())))
    assert out.to_pylist() == [("b", 3), ("a", 2), (None, 1)]


def test_sum_all_null_group_is_null():
    schema = TupleSchema.of(("k", INT64), ("v", INT64))
    t = Table.from_data(schema, {"k": [1, 1, 2], "v": [None, None, 5]})
    out = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "s")],
                                 ScanTable(t)))
    assert out.to_pylist() == [(1, None), (2, 5)]


def test_first_last():
    out = execute(GroupAggregate(
        ["k"], [AggSpec(FIRST, "v", "f"), AggSpec(LAST, "v", "l")],
        ScanTable(make_table())))
    # FIRST/LAST include NULL values (assign semantics)
    assert out.to_pylist() == [("b", 1, 6), ("a", 2, None), (None, 4, 4)]


def test_multi_key_grouping():
    schema = TupleSchema.of(("k1", INT64), ("k2", INT64), ("v", INT64))
    t = Table.from_data(schema, {
        "k1": [1, 1, 2, 1], "k2": [1, 2, 1, 1], "v": [1, 2, 3, 4]})
    out = execute(GroupAggregate(["k1", "k2"], [AggSpec(SUM, "v", "s")],
                                 ScanTable(t)))
    assert out.to_pylist() == [(1, 1, 5), (1, 2, 2), (2, 1, 3)]


def test_distinct_count_sum():
    schema = TupleSchema.of(("k", INT64), ("v", INT64))
    t = Table.from_data(schema, {
        "k": [1, 1, 1, 2, 2], "v": [5, 5, 7, 5, 5]})
    out = execute(GroupAggregate(
        ["k"],
        [AggSpec(COUNT, "v", "dc", distinct=True),
         AggSpec(SUM, "v", "ds", distinct=True)],
        ScanTable(t)))
    assert out.to_pylist() == [(1, 2, 12), (2, 1, 5)]


def test_max_unique_keys_clamp():
    schema = TupleSchema.of(("k", INT64), ("v", INT64))
    t = Table.from_data(schema, {"k": [1, 2, 3, 4], "v": [1, 1, 1, 1]})
    out = execute(GroupAggregate(
        ["k"], [AggSpec(SUM, "v", "s")], ScanTable(t),
        GroupAggregateOptions(max_unique_keys_in_result=2)))
    rows = out.to_pylist()
    assert len(rows) == 2
    # overflow groups merged into the last kept group
    assert rows[0] == (1, 1)
    assert rows[1][1] == 3


def test_scalar_aggregate():
    out = execute(ScalarAggregate(
        [AggSpec(SUM, "v", "s"), AggSpec(COUNT, "v", "c"),
         AggSpec(MIN, "x", "mn")],
        ScanTable(make_table())))
    assert out.to_pylist() == [(16, 5, 1.0)]


def test_scalar_aggregate_empty_input():
    schema = TupleSchema.of(("v", INT64),)
    t = Table.from_data(schema, {"v": []})
    out = execute(ScalarAggregate(
        [AggSpec(SUM, "v", "s"), AggSpec(COUNT, "v", "c")], ScanTable(t)))
    assert out.to_pylist() == [(None, 0)]


def test_aggregate_clusters():
    schema = TupleSchema.of(("k", INT64), ("v", INT64))
    t = Table.from_data(schema, {
        "k": [1, 1, 3, 3, 2], "v": [1, 2, 3, 4, 5]})
    out = execute(AggregateClusters(["k"], [AggSpec(SUM, "v", "s")],
                                    ScanTable(t)))
    # clustered input: runs in encounter order; non-adjacent same keys stay
    # separate (streaming contract)
    assert out.to_pylist() == [(1, 3), (3, 7), (2, 5)]


def test_group_by_double_negzero():
    schema = TupleSchema.of(("k", DOUBLE), ("v", INT64))
    t = Table.from_data(schema, {"k": [0.0, -0.0], "v": [1, 2]})
    out = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "s")],
                                 ScanTable(t)))
    assert out.to_pylist() == [(0.0, 3)]


def test_multi_column_distinct():
    schema = TupleSchema.of(("k", INT64), ("a", INT64), ("b", INT64))
    t = Table.from_data(schema, {
        "k": [1, 1, 1, 2], "a": [5, 5, 7, 5], "b": [3, 4, 3, 3]})
    out = execute(GroupAggregate(
        ["k"],
        [AggSpec(Aggregation.COUNT, "a", "da", distinct=True),
         AggSpec(Aggregation.COUNT, "b", "db", distinct=True),
         AggSpec(Aggregation.SUM, "a", "sa")],
        ScanTable(t)))
    assert out.to_pylist() == [(1, 2, 2, 17), (2, 1, 1, 5)]


# ---------------------------------------------------------------------------
# Dense-domain aggregation (segmented reduce; stats/dict/enum bounds)
# ---------------------------------------------------------------------------

def _rand_table(n=500, seed=9, key_kind="int"):
    import numpy as np
    rng = np.random.default_rng(seed)
    if key_kind == "int":
        kt, kv = (DataType.INT32, rng.integers(5, 25, n).astype(np.int32))
        extra = {}
    elif key_kind == "string":
        kt = DataType.STRING
        kv = [f"k{int(x):02d}" for x in rng.integers(0, 17, n)]
        extra = {}
    schema = TupleSchema([
        Attribute("k", kt, False),
        Attribute("v", DataType.FLOAT, True),
        Attribute("s", DataType.STRING, True),
        Attribute("w", DataType.INT32, False),
    ])
    data = {
        "k": kv,
        "v": [None if rng.random() < 0.1 else float(x)
              for x in rng.random(n).astype(np.float32)],
        "s": [None if rng.random() < 0.1 else f"s{int(x)}"
              for x in rng.integers(0, 9, n)],
        "w": rng.integers(-100, 100, n).astype(np.int32),
    }
    return Table.from_data(schema, data)


SPECS = [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.COUNT, None, "c"),
         AggSpec(Aggregation.COUNT, "v", "cv"),
         AggSpec(Aggregation.MIN, "w", "wmin"),
         AggSpec(Aggregation.MAX, "w", "wmax"),
         AggSpec(Aggregation.MIN, "s", "smin"),
         AggSpec(Aggregation.FIRST, "s", "sf"),
         AggSpec(Aggregation.LAST, "v", "vl")]


@pytest.mark.parametrize("key_kind", ["int", "string"])
def test_dense_aggregation_matches_general(key_kind):
    # the dense (segmented-reduce) path must agree with the
    # sort-based general path on every aggregation kind
    import numpy as np
    t = _rand_table(key_kind=key_kind)
    dense = execute(GroupAggregate(["k"], SPECS, ScanTable(t)))
    # force the general path: nullable copy of the key column disables the
    # dense domain (NULL groups unsupported there)
    schema2 = TupleSchema([
        Attribute("k", t.schema.lookup("k").type, True)]
        + [t.schema.lookup(n) for n in ("v", "s", "w")])
    t2 = Table(schema2,
               {"k": t.columns["k"]._replace(
                   valid=jnp.ones(t.capacity, bool)),
                **{n: t.columns[n] for n in ("v", "s", "w")}},
               t.num_rows, t.dicts)
    general = execute(GroupAggregate(["k"], SPECS, ScanTable(t2)))
    drows = dense.to_pylist()
    grows = general.to_pylist()
    assert len(drows) == len(grows)
    for dr, gr in zip(drows, grows):
        assert dr[0] == gr[0]           # same key, same insertion order
        assert dr[1] == pytest.approx(gr[1], rel=1e-5)  # SUM f32 vs f64
        assert dr[2:] == gr[2:]


import jax.numpy as jnp  # noqa: E402
from supersonic_jax.schema import Attribute  # noqa: E402


def test_dense_aggregation_guard_flag():
    # re-running the compiled plan with keys outside the planned stats
    # domain must trip the guard flag
    import jax
    import numpy as np
    from supersonic_jax.ops.base import compile_plan

    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"k": np.array([1, 2, 3], np.int32),
         "v": np.array([1.0, 2.0, 3.0], np.float32)})
    plan = GroupAggregate(["k"], [AggSpec(Aggregation.SUM, "v", "sv")],
                          ScanTable(t))
    run, bound, leaves = compile_plan(plan)
    out, flags = jax.jit(run)(leaves)
    assert not np.asarray(flags).any()
    from supersonic_jax.batch import Column
    bad_k = jnp.asarray(np.array([1, 2, 50_000], np.int32))
    bad = Table(t.schema, {**t.columns,
                           "k": t.columns["k"]._replace(values=bad_k)},
                t.num_rows, t.dicts)
    out2, flags2 = jax.jit(run)([bad])
    assert np.asarray(flags2).any()


def test_string_aggregation_dictionaries_propagate():
    # MIN/MAX/FIRST/LAST of STRING carry the input dictionary (regression:
    # KeyError at materialization)
    t = Table.from_data(
        TupleSchema.of(("g", DataType.INT32, False),
                       ("s", DataType.STRING)),
        {"g": [1, 1, 2], "s": ["b", "a", "c"]})
    out = execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.MIN, "s", "smin"),
                AggSpec(Aggregation.MAX, "s", "smax"),
                AggSpec(Aggregation.FIRST, "s", "sf"),
                AggSpec(Aggregation.LAST, "s", "sl")], ScanTable(t)))
    assert out.to_pylist() == [(1, "a", "b", "b", "a"), (2, "c", "c", "c",
                                                         "c")]
    out2 = execute(ScalarAggregate(
        [AggSpec(Aggregation.MAX, "s", "m")], ScanTable(t)))
    assert out2.to_pylist() == [("c",)]


def test_multi_key_dense_matches_general():
    # composite dense domain (STRING dict x small int stats range) must
    # agree with the sort-based general path, including insertion order
    import numpy as np
    from supersonic_jax import (AggSpec, Aggregation, DataType,
                                GroupAggregate, ScanTable, Table,
                                TupleSchema, execute)
    rng = np.random.default_rng(9)
    cities = ["ams", "ber", "cdg"]
    n = 500
    t = Table.from_data(
        TupleSchema.of(("c", DataType.STRING, False),
                       ("d", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"c": [cities[i] for i in rng.integers(0, 3, n)],
         "d": [int(x) for x in rng.integers(10, 17, n)],
         "v": rng.random(n).astype(np.float32)})
    specs = [AggSpec(Aggregation.SUM, "v", "sv"),
             AggSpec(Aggregation.COUNT, None, "ct"),
             AggSpec(Aggregation.MIN, "v", "mn")]
    dense = execute(GroupAggregate(["c", "d"], specs, ScanTable(t)))
    from supersonic_jax.ops import aggregate as agg_mod
    saved = agg_mod._DENSE_DOMAIN_MAX
    try:
        agg_mod._DENSE_DOMAIN_MAX = 0  # force the general path
        general = execute(GroupAggregate(["c", "d"], specs, ScanTable(t)))
    finally:
        agg_mod._DENSE_DOMAIN_MAX = saved
    drows = dense.to_pylist()
    grows = general.to_pylist()
    assert len(drows) == len(grows)
    for a, b in zip(drows, grows):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
        assert abs(a[2] - b[2]) < 1e-3 * max(1.0, abs(b[2]))
        assert a[4] == b[4] if isinstance(a[4], str) else \
            abs(a[4] - b[4]) < 1e-6


def test_best_effort_and_hybrid_api_parity():
    # reference: BestEffortGroupAggregate (aggregate_groups.cc:989) may
    # emit partially-aggregated chunks; under static HBM budgeting a
    # single chunk is exact, so both variants must equal GroupAggregate.
    from supersonic_jax import (BestEffortGroupAggregate,
                                HybridGroupAggregate, ScanTable, Table,
                                TupleSchema, execute)
    t = Table.from_data(
        TupleSchema.of(("k", INT64), ("v", INT64)),
        {"k": [1, 2, 1, 3, 2], "v": [10, 20, 30, None, 50]})
    specs = [AggSpec(SUM, "v", "sv"), AggSpec(COUNT, "v", "cv")]
    base = execute(GroupAggregate(["k"], specs, ScanTable(t))).to_pylist()
    be = execute(BestEffortGroupAggregate(["k"], specs,
                                          ScanTable(t))).to_pylist()
    hy = execute(HybridGroupAggregate(["k"], specs,
                                      ScanTable(t))).to_pylist()
    assert base == be == hy
    assert base == [(1, 40, 2), (2, 70, 2), (3, None, 0)]


def test_int64_sum_exact_beyond_2_53():
    # exact wrapping integer SUM (reference: SUM accumulates in the output
    # type, aggregation_operators.h); the old f64 accumulation lost
    # low bits past 2^53 — the limb path must not
    big = (1 << 60) + 7
    t = Table.from_data(
        TupleSchema.of(("k", INT64), ("v", INT64)),
        {"k": [1, 1, 1, 2], "v": [big, big, 13, -5]})
    out = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "s")],
                                 ScanTable(t)))
    assert out.to_pylist() == [(1, ((2 * big + 13) + 2**63) % 2**64 - 2**63),
                               (2, -5)]


def test_int64_sum_wraps_like_cpp():
    # int64 overflow wraps mod 2^64 (two's complement), as C++ does
    m = (1 << 62) + 12345
    t = Table.from_data(
        TupleSchema.of(("k", INT64), ("v", INT64)),
        {"k": [1, 1, 1, 1], "v": [m, m, m, m]})
    out = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "s")],
                                 ScanTable(t)))
    w = (4 * m) % (1 << 64)
    if w >= 1 << 63:
        w -= 1 << 64
    assert out.to_pylist() == [(1, w)]


def test_uint64_sum_wraps():
    from supersonic_jax import DataType
    u = (1 << 63) + 99
    t = Table.from_data(
        TupleSchema.of(("k", INT64), ("v", DataType.UINT64)),
        {"k": [1, 1], "v": [u, u]})
    out = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "s")],
                                 ScanTable(t)))
    assert out.to_pylist() == [(1, (2 * u) % (1 << 64))]


def test_int32_sum_wraps_mod_2_32():
    from supersonic_jax import DataType
    v = 2**31 - 1
    t = Table.from_data(
        TupleSchema.of(("k", INT64), ("v", DataType.INT32)),
        {"k": [1, 1, 1], "v": [v, v, 2]})
    out = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "s")],
                                 ScanTable(t)))
    w = (2 * v + 2) % (1 << 32)
    if w >= 1 << 31:
        w -= 1 << 32
    assert out.to_pylist() == [(1, w)]


def test_int32_sum_with_int64_output_no_wrap():
    # explicit 64-bit output accumulates wide (and must kick the dense
    # path out in favor of the exact limb path)
    from supersonic_jax import DataType
    import numpy as np
    n = 5000
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT32, False),
                       ("v", DataType.INT32, False)),
        {"k": np.zeros(n, np.int32),
         "v": np.full(n, 2**30, np.int32)})
    out = execute(GroupAggregate(
        ["k"], [AggSpec(SUM, "v", "s", output_type=DataType.INT64)],
        ScanTable(t)))
    assert out.to_pylist() == [(0, n * 2**30)]


def test_concat_in_plan_basic():
    """In-plan CONCAT (reference: aggregation_operators.h:235-283): ","
    join in input order, NULLs skipped, all-NULL group -> NULL; numeric
    input stringified; result feeds downstream operators."""
    from supersonic_jax import Sort, SortKey

    t = Table.from_data(
        TupleSchema.of(("g", DataType.INT64), ("s", DataType.STRING, True),
                       ("v", DataType.INT64, True)),
        {"g": [2, 1, 2, 1, 3, 2], "s": ["a", "b", None, "c", "d", "a"],
         "v": [5, 6, 7, None, 8, 9]})
    out = execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.CONCAT, "s", "cs"),
                AggSpec(Aggregation.CONCAT, "v", "cv"),
                AggSpec(Aggregation.CONCAT, "s", "csd", distinct=True)],
        ScanTable(t)))
    assert out.to_pylist() == [(2, "a,a", "5,7,9", "a"),
                               (1, "b,c", "6", "b,c"),
                               (3, "d", "8", "d")]
    # downstream Sort consumes the concat column's codes fine
    out2 = execute(Sort([SortKey("g")], GroupAggregate(
        ["g"], [AggSpec(Aggregation.CONCAT, "s", "cs")], ScanTable(t))))
    assert out2.to_pylist() == [(1, "b,c"), (2, "a,a"), (3, "d")]


def test_concat_all_null_group_and_scalar():
    from supersonic_jax import ScalarAggregate

    t = Table.from_data(
        TupleSchema.of(("g", DataType.INT64), ("s", DataType.STRING, True)),
        {"g": [1, 1, 2], "s": [None, None, "x"]})
    out = execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.CONCAT, "s", "cs")], ScanTable(t)))
    assert out.to_pylist() == [(1, None), (2, "x")]
    sc = execute(ScalarAggregate(
        [AggSpec(Aggregation.CONCAT, "s", "c")], ScanTable(t)))
    assert sc.to_pylist() == [("x",)]


def test_concat_rejections():
    """Sort/group/join by a CONCAT result is rejected (codes not
    order-preserving); max_unique_keys + CONCAT rejected; distributed
    combine rejects CONCAT."""
    from supersonic_jax import SchemaError, Sort, SortKey
    from supersonic_jax.ops.aggregate import GroupAggregateOptions
    from supersonic_jax.parallel import combine_specification
    from supersonic_jax.ops.aggregate import AggregationSpecification

    t = Table.from_data(
        TupleSchema.of(("g", DataType.INT64), ("s", DataType.STRING, True)),
        {"g": [1, 2], "s": ["a", "b"]})
    plan = GroupAggregate(["g"], [AggSpec(Aggregation.CONCAT, "s", "cs")],
                          ScanTable(t))
    with pytest.raises(SchemaError, match="CONCAT"):
        execute(Sort([SortKey("cs")], plan))
    with pytest.raises(SchemaError, match="CONCAT"):
        execute(GroupAggregate(
            ["g"], [AggSpec(Aggregation.CONCAT, "s", "cs")], ScanTable(t),
            GroupAggregateOptions(max_unique_keys_in_result=1)))
    with pytest.raises(SchemaError, match="CONCAT"):
        combine_specification(AggregationSpecification(
            [AggSpec(Aggregation.CONCAT, "s", "cs")]))


def test_concat_via_serialization():
    """A deserialized reference plan containing CONCAT executes."""
    from supersonic_jax.io.serialization import build_aggregation

    t = Table.from_data(
        TupleSchema.of(("g", DataType.INT64), ("s", DataType.STRING, True)),
        {"g": [1, 2, 1], "s": ["x", "y", "z"]})
    spec = build_aggregation([
        {"aggregation": "concat", "input": "s", "output": "cs"}])
    out = execute(GroupAggregate(["g"], spec, ScanTable(t)))
    assert out.to_pylist() == [(1, "x,z"), (2, "y")]


def test_concat_clustered_and_formats():
    """CONCAT in AggregateClusters (streaming runs stay separate) and
    reference PrintTyped formats for BOOL/DATE inputs
    (types_infrastructure.cc:45-110)."""
    from supersonic_jax import AggregateClusters

    t = Table.from_data(
        TupleSchema.of(("g", INT64), ("s", STRING, True)),
        {"g": [1, 1, 2, 2, 1], "s": ["a", "b", "c", None, "d"]})
    out = execute(AggregateClusters(
        ["g"], [AggSpec(Aggregation.CONCAT, "s", "cs")], ScanTable(t)))
    assert out.to_pylist() == [(1, "a,b"), (2, "c"), (1, "d")]

    t2 = Table.from_data(
        TupleSchema.of(("g", INT64), ("b", DataType.BOOL, True),
                       ("d", DataType.DATE, True)),
        {"g": [1, 1], "b": [True, False], "d": [0, 365]})
    out2 = execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.CONCAT, "b", "cb"),
                AggSpec(Aggregation.CONCAT, "d", "cd")], ScanTable(t2)))
    assert out2.to_pylist() == [(1, "TRUE,FALSE", "1970/01/01,1971/01/01")]


def test_double_sum_fixedpoint_inf_nan():
    """DOUBLE SUM rides the fixed-point limb path (round 5): finite
    groups match numpy at f64 precision; inf/NaN addends follow IEEE
    addition per group (any NaN or mixed-sign infinities -> NaN,
    else +/-inf) — repaired from the nf/sg indicator scans."""
    import warnings

    import numpy as np

    from supersonic_jax import (AggSpec, Aggregation, DataType,
                                GroupAggregate, GroupAggregateOptions,
                                ScanTable, Table, TupleSchema, execute)

    rng = np.random.default_rng(0)
    n = 20000
    g = rng.integers(0, 9, n)
    v = rng.random(n) * 2e5 - 1e5
    v[np.where(g == 0)[0][0]] = np.nan
    v[np.where(g == 1)[0][0]] = np.inf
    v[np.where(g == 2)[0][0]] = -np.inf
    i3 = np.where(g == 3)[0][:2]
    v[i3[0]] = np.inf
    v[i3[1]] = -np.inf
    i4 = np.where(g == 4)[0][:2]
    v[i4[0]] = np.inf
    v[i4[1]] = np.nan
    t = Table.from_data(
        TupleSchema.of(("g", DataType.INT32, False),
                       ("v", DataType.DOUBLE, False)),
        {"g": g.astype(np.int32), "v": v})
    out = execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.SUM, "v", "sv")], ScanTable(t),
        GroupAggregateOptions(estimated_result_row_count=16)))
    got = dict(out.to_pylist())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for k in range(9):
            b = float(np.sum(v[g == k]))
            a = got[k]
            if np.isnan(b):
                assert np.isnan(a), (k, a, b)
            elif np.isinf(b):
                assert a == b, (k, a, b)
            else:
                assert abs(a - b) <= 1e-9 * max(1.0, abs(b)), (k, a, b)

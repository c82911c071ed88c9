"""Randomized differential tests: device engine vs the pure-python
reference engine over random tables with NULLs (SURVEY §4.6 golden-file
strategy)."""
import numpy as np
import pytest

from supersonic_jax import (DOUBLE, INT64, STRING, AggSpec, Aggregation,
                            Filter, GroupAggregate, HashJoin, JoinType,
                            KeyUniqueness, ScanTable, Sort, SortKey, Table,
                            TupleSchema, col, execute)
from supersonic_jax.reference import ref_engine as ref


def rand_table(rng, n, null_p=0.15):
    def maybe_null(vals):
        return [None if rng.random() < null_p else v for v in vals]

    schema = TupleSchema.of(("k", INT64), ("v", INT64), ("x", DOUBLE),
                            ("s", STRING))
    data = {
        "k": maybe_null(rng.integers(0, 6, n).tolist()),
        "v": maybe_null(rng.integers(-50, 50, n).tolist()),
        "x": maybe_null(np.round(rng.random(n) * 10, 3).tolist()),
        "s": maybe_null([f"w{int(i)}" for i in rng.integers(0, 5, n)]),
    }
    t = Table.from_data(schema, data)
    rows = t.to_pylist()
    return t, rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_differential(seed):
    rng = np.random.default_rng(seed)
    t, rows = rand_table(rng, 50)
    got = execute(Filter(col("v") > 0, ScanTable(t))).to_pylist()
    exp = ref.filter_rows(rows, lambda r: None if r[1] is None else r[1] > 0)
    assert got == exp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_differential(seed):
    rng = np.random.default_rng(seed + 10)
    t, rows = rand_table(rng, 60)
    got = execute(Sort([("k", True), SortKey("x", ascending=False)],
                       ScanTable(t))).to_pylist()
    exp = ref.sort_rows(rows, [(0, True), (2, False)])
    # stable + same comparator => identical row sequence
    assert got == exp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_string_desc_differential(seed):
    rng = np.random.default_rng(seed + 20)
    t, rows = rand_table(rng, 40)
    got = execute(Sort([SortKey("s", ascending=False), ("v", True)],
                       ScanTable(t))).to_pylist()
    exp = ref.sort_rows(rows, [(3, False), (1, True)])
    assert got == exp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_aggregate_differential(seed):
    rng = np.random.default_rng(seed + 30)
    t, rows = rand_table(rng, 80)
    got = execute(GroupAggregate(
        ["k", "s"],
        [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.COUNT, "x", "cx"),
         AggSpec(Aggregation.MIN, "v", "mn"),
         AggSpec(Aggregation.MAX, "x", "mx"),
         AggSpec(Aggregation.FIRST, "v", "fv"),
         AggSpec(Aggregation.LAST, "x", "lx"),
         AggSpec(Aggregation.COUNT, None, "n")],
        ScanTable(t))).to_pylist()
    exp = ref.group_aggregate(
        rows, [0, 3],
        [("sum", 1), ("count", 2), ("min", 1), ("max", 2),
         ("first", 1), ("last", 2), ("count_star", None)])
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g[:3] == e[:3] and g[4] == e[4] and g[6] == e[6] \
            and g[8] == e[8]
        for gi, ei in ((g[3], e[3]), (g[5], e[5]), (g[7], e[7])):
            if ei is None:
                assert gi is None
            else:
                assert gi == pytest.approx(ei)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.LEFT_OUTER])
def test_join_differential(seed, join_type):
    rng = np.random.default_rng(seed + 40)
    lt, lrows = rand_table(rng, 40)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": rng.choice(20, size=8, replace=False).tolist(),
             "w": rng.integers(0, 100, 8).tolist()}
    rt = Table.from_data(rs, rdata)
    rrows = rt.to_pylist()
    got = execute(HashJoin(join_type, ["k"], ["pk"], ScanTable(lt),
                           ScanTable(rt), KeyUniqueness.UNIQUE)).to_pylist()
    exp = ref.hash_join(lrows, rrows, 0, 0,
                        join_type == JoinType.LEFT_OUTER, rhs_width=2)
    assert got == exp


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.LEFT_OUTER])
@pytest.mark.parametrize("allow_dense", [True, False])
def test_join_not_unique_differential(seed, join_type, allow_dense):
    # duplicate build keys exercise the expansion (CSR dense or merge)
    rng = np.random.default_rng(seed + 60)
    lt, lrows = rand_table(rng, 35)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": rng.integers(0, 8, 12).tolist(),
             "w": rng.integers(0, 100, 12).tolist()}
    rt = Table.from_data(rs, rdata)
    rrows = rt.to_pylist()
    got = execute(HashJoin(join_type, ["k"], ["pk"], ScanTable(lt),
                           ScanTable(rt), KeyUniqueness.NOT_UNIQUE,
                           out_capacity=1024,
                           allow_dense_lookup=allow_dense)).to_pylist()
    exp = ref.hash_join(lrows, rrows, 0, 0,
                        join_type == JoinType.LEFT_OUTER, rhs_width=2)
    assert got == exp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extended_sort_limit_differential(seed):
    from supersonic_jax import ExtendedSort
    rng = np.random.default_rng(seed + 70)
    t, rows = rand_table(rng, 70)
    got = execute(ExtendedSort([("x", False), ("v", True)], ScanTable(t),
                               limit=9)).to_pylist()
    exp = ref.sort_rows(rows, [(2, False), (1, True)])[:9]
    assert got == exp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_multikey_group_differential(seed):
    # non-nullable small-domain keys take the composite dense path
    rng = np.random.default_rng(seed + 80)
    n = 90
    schema = TupleSchema.of(("a", INT64, False), ("s", STRING, False),
                            ("v", INT64), ("x", DOUBLE))
    data = {
        "a": rng.integers(0, 5, n).tolist(),
        "s": [f"g{int(i)}" for i in rng.integers(0, 4, n)],
        "v": [None if rng.random() < 0.2 else int(v)
              for v in rng.integers(-30, 30, n)],
        "x": np.round(rng.random(n) * 5, 3).tolist(),
    }
    t = Table.from_data(schema, data)
    rows = t.to_pylist()
    got = execute(GroupAggregate(
        ["a", "s"],
        [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.MIN, "x", "mn"),
         AggSpec(Aggregation.COUNT, None, "n")],
        ScanTable(t))).to_pylist()
    exp = ref.group_aggregate(rows, [0, 1],
                              [("sum", 2), ("min", 3), ("count_star", None)])
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g[0] == e[0] and g[1] == e[1] and g[2] == e[2] \
            and g[4] == e[4]
        if e[3] is None:
            assert g[3] is None
        else:
            assert g[3] == pytest.approx(e[3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int64_sum_differential_extreme_magnitudes(seed):
    # the exact limb SUM path vs python bignum arithmetic with C++ wrap
    rng = np.random.default_rng(seed + 400)
    n = 200
    ks = rng.integers(0, 5, n).tolist()
    vs = [None if rng.random() < 0.1 else
          int(rng.integers(-(2**62), 2**62))
          for _ in range(n)]
    schema = TupleSchema.of(("k", INT64, False), ("v", INT64))
    t = Table.from_data(schema, {"k": ks, "v": vs})
    got = execute(GroupAggregate(
        ["k"], [AggSpec(Aggregation.SUM, "v", "sv")],
        ScanTable(t))).to_pylist()

    def wrap(x):
        x %= 1 << 64
        return x - (1 << 64) if x >= 1 << 63 else x

    exp = {}
    order = []
    for k, v in zip(ks, vs):
        if k not in exp:
            exp[k] = None
            order.append(k)
        if v is not None:
            exp[k] = v if exp[k] is None else exp[k] + v
    want = [(k, None if exp[k] is None else wrap(exp[k])) for k in order]
    assert got == want

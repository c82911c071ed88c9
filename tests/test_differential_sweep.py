"""Differential tests x capacity-sweep harness.

The round-1 differential suite ran 35-90 rows at fixed capacity.  Here the
same device-vs-python-model comparisons run at 10-40x those sizes, across
the capacity sweep of testing/operation_testing.py (padding boundaries are
where masks leak), and at the edges it never exercised: out_capacity
overflow and high-duplication NOT_UNIQUE expansion near capacity.
"""
import numpy as np
import pytest

from supersonic_jax import (DOUBLE, INT64, STRING, AggSpec, Aggregation,
                            Filter, GroupAggregate, HashJoin, JoinType,
                            KeyUniqueness, ScanTable, Sort, SortKey, Table,
                            TupleSchema, col, execute)
from supersonic_jax.reference import ref_engine as ref
from supersonic_jax.testing.operation_testing import check_operation

SCHEMA = TupleSchema.of(("k", INT64), ("v", INT64), ("x", DOUBLE),
                        ("s", STRING))


def rand_data(rng, n, null_p=0.15, key_dom=25):
    def maybe_null(vals):
        return [None if rng.random() < null_p else v for v in vals]

    return {
        "k": maybe_null(rng.integers(0, key_dom, n).tolist()),
        "v": maybe_null(rng.integers(-50, 50, n).tolist()),
        "x": maybe_null(np.round(rng.random(n) * 10, 3).tolist()),
        "s": maybe_null([f"w{int(i)}" for i in rng.integers(0, 12, n)]),
    }


def rows_of(data, n):
    return [tuple(data[c][i] for c in ("k", "v", "x", "s"))
            for i in range(n)]


@pytest.mark.parametrize("seed,n", [(0, 1000), (1, 2500), (2, 777)])
def test_filter_differential_swept(seed, n):
    rng = np.random.default_rng(seed + 100)
    data = rand_data(rng, n)
    exp = ref.filter_rows(rows_of(data, n),
                          lambda r: None if r[1] is None else r[1] > 0)
    check_operation(
        lambda t: Filter(col("v") > 0, ScanTable(t)),
        [(SCHEMA, data)], exp)


@pytest.mark.parametrize("seed,n", [(0, 1200), (1, 3000)])
def test_sort_differential_swept(seed, n):
    rng = np.random.default_rng(seed + 110)
    data = rand_data(rng, n)
    exp = ref.sort_rows(rows_of(data, n), [(0, True), (2, False)])
    check_operation(
        lambda t: Sort([("k", True), SortKey("x", ascending=False)],
                       ScanTable(t)),
        [(SCHEMA, data)], exp)


@pytest.mark.parametrize("seed,n", [(0, 1500), (1, 4000)])
def test_group_aggregate_differential_swept(seed, n):
    rng = np.random.default_rng(seed + 120)
    data = rand_data(rng, n, key_dom=60)
    exp = ref.group_aggregate(
        rows_of(data, n), [0],
        [("sum", 1), ("min", 1), ("max", 1), ("count", 2),
         ("count_star", None)])
    check_operation(
        lambda t: GroupAggregate(
            ["k"],
            [AggSpec(Aggregation.SUM, "v", "sv"),
             AggSpec(Aggregation.MIN, "v", "mn"),
             AggSpec(Aggregation.MAX, "v", "mx"),
             AggSpec(Aggregation.COUNT, "x", "cx"),
             AggSpec(Aggregation.COUNT, None, "c")],
            ScanTable(t)),
        [(SCHEMA, data)], exp)


@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.LEFT_OUTER])
@pytest.mark.parametrize("allow_dense", [True, False])
def test_join_differential_swept(join_type, allow_dense):
    rng = np.random.default_rng(130)
    n = 1200
    data = rand_data(rng, n, key_dom=40)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": rng.choice(60, size=25, replace=False).tolist(),
             "w": rng.integers(0, 100, 25).tolist()}
    rrows = [(rdata["pk"][i], rdata["w"][i]) for i in range(25)]
    exp = ref.hash_join(rows_of(data, n), rrows, 0, 0,
                        join_type == JoinType.LEFT_OUTER, rhs_width=2)
    check_operation(
        lambda lt, rt: HashJoin(join_type, ["k"], ["pk"], ScanTable(lt),
                                ScanTable(rt), KeyUniqueness.UNIQUE,
                                allow_dense_lookup=allow_dense),
        [(SCHEMA, data), (rs, rdata)], exp)


@pytest.mark.parametrize("allow_dense", [True, False])
def test_not_unique_expansion_near_capacity_differential(allow_dense):
    """High-duplication NOT_UNIQUE expansion with out_capacity at 100%
    and ~104% of the exact output size."""
    rng = np.random.default_rng(140)
    n, dup_keys, dups = 800, 10, 6
    data = rand_data(rng, n, null_p=0.05, key_dom=dup_keys)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": np.repeat(np.arange(dup_keys), dups).tolist(),
             "w": rng.integers(0, 100, dup_keys * dups).tolist()}
    rrows = [(rdata["pk"][i], rdata["w"][i])
             for i in range(dup_keys * dups)]
    exp = ref.hash_join(rows_of(data, n), rrows, 0, 0, False, rhs_width=2)
    for cap in (len(exp), int(len(exp) * 1.04)):
        got = execute(HashJoin(
            JoinType.INNER, ["k"], ["pk"],
            ScanTable(Table.from_data(SCHEMA, data)),
            ScanTable(Table.from_data(rs, rdata)),
            KeyUniqueness.NOT_UNIQUE, out_capacity=cap,
            allow_dense_lookup=allow_dense)).to_pylist()
        assert got == exp, f"cap={cap}"


def test_join_out_capacity_overflow_raises_differentially():
    from supersonic_jax.exprs.base import EvaluationError

    rng = np.random.default_rng(150)
    n = 500
    data = rand_data(rng, n, null_p=0.0, key_dom=5)
    rs = TupleSchema.of(("pk", INT64, False), ("w", INT64))
    rdata = {"pk": np.repeat(np.arange(5), 4).tolist(),
             "w": list(range(20))}
    exact = len(ref.hash_join(
        rows_of(data, n),
        [(rdata["pk"][i], rdata["w"][i]) for i in range(20)],
        0, 0, False, rhs_width=2))
    with pytest.raises(EvaluationError):
        execute(HashJoin(
            JoinType.INNER, ["k"], ["pk"],
            ScanTable(Table.from_data(SCHEMA, data)),
            ScanTable(Table.from_data(rs, rdata)),
            KeyUniqueness.NOT_UNIQUE, out_capacity=exact - 10))

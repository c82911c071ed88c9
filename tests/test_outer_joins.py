"""RIGHT_OUTER / FULL_OUTER hash joins.

The reference declares these in JoinType (proto/supersonic.proto:77-83)
but never implements them (hash_join.h:37 "not supported yet"); this
engine completes the enum — RIGHT_OUTER as a mirrored LEFT_OUTER,
FULL_OUTER as LEFT_OUTER ∪ NULL-padded anti rows over UnionAll
(ops/hash_join.py::_bind_outer_rewrite).  No golden is possible (the
reference cannot run these), so correctness is differential against a
row-wise Python oracle, NULL keys never matching on either side.
"""
import numpy as np
import pytest

from supersonic_jax import (DataType, Filter, HashJoin, JoinType,
                            KeyUniqueness, Projector, ScanTable, Table,
                            TupleSchema, col, execute)
from supersonic_jax.ops.union import UnionAll


def _rows(res):
    return [tuple(r) for r in res.to_pylist()]


def _canon(rows):
    return sorted(rows, key=lambda t: tuple((x is None, x) for x in t))


def _right_oracle(lrows, rrows, lk, rk):
    """Row-wise RIGHT_OUTER oracle; NULL keys never match."""
    lw = len(lrows[0]) if lrows else 0
    out = []
    for rr in rrows:
        hit = False
        for lr in lrows:
            if rr[rk] is not None and lr[lk] == rr[rk]:
                out.append(lr + rr)
                hit = True
        if not hit:
            out.append((None,) * lw + rr)
    return out


def _full_oracle(lrows, rrows, lk, rk):
    rw = len(rrows[0]) if rrows else 0
    out = []
    rmatched = [False] * len(rrows)
    for lr in lrows:
        hit = False
        for j, rr in enumerate(rrows):
            if lr[lk] is not None and lr[lk] == rr[rk]:
                out.append(lr + rr)
                hit = True
                rmatched[j] = True
        if not hit:
            out.append(lr + (None,) * rw)
    lw = len(lrows[0]) if lrows else 0
    for j, rr in enumerate(rrows):
        if not rmatched[j]:
            out.append((None,) * lw + rr)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("uniq", [KeyUniqueness.UNIQUE,
                                  KeyUniqueness.NOT_UNIQUE])
def test_right_and_full_outer_differential(seed, uniq):
    rng = np.random.default_rng(seed)
    nl, nr = 83, 41
    lk = [None if rng.random() < 0.15 else int(v)
          for v in rng.integers(0, 30, nl)]
    lv = [float(v) for v in rng.normal(size=nl)]
    if uniq == KeyUniqueness.UNIQUE:
        pool = list(rng.permutation(60)[:nr])
        rk = [None if rng.random() < 0.1 else int(v) for v in pool]
    else:
        rk = [None if rng.random() < 0.1 else int(v)
              for v in rng.integers(0, 30, nr)]
    rv = [int(v) for v in rng.integers(0, 1000, nr)]
    L = TupleSchema.of(("k", DataType.INT64, True), ("lv", DataType.DOUBLE))
    R = TupleSchema.of(("rk", DataType.INT64, True), ("rv", DataType.INT64))
    lt = Table.from_data(L, {"k": lk, "lv": lv})
    rt = Table.from_data(R, {"rk": rk, "rv": rv})
    lrows = list(zip(lk, lv))
    rrows = list(zip(rk, rv))
    got_r = _rows(execute(HashJoin(JoinType.RIGHT_OUTER, ["k"], ["rk"],
                                   ScanTable(lt), ScanTable(rt), uniq)))
    assert _canon(got_r) == _canon(_right_oracle(lrows, rrows, 0, 0))
    got_f = _rows(execute(HashJoin(JoinType.FULL_OUTER, ["k"], ["rk"],
                                   ScanTable(lt), ScanTable(rt), uniq)))
    assert _canon(got_f) == _canon(_full_oracle(lrows, rrows, 0, 0))


def test_full_outer_string_keys_and_projectors():
    L = TupleSchema.of(("k", DataType.STRING, True), ("lv", DataType.INT64))
    R = TupleSchema.of(("rk", DataType.STRING), ("rv", DataType.STRING))
    lt = Table.from_data(L, {"k": ["x", None, "y", "zz"],
                             "lv": [1, 2, 3, 4]})
    rt = Table.from_data(R, {"rk": ["y", "w", "x"],
                             "rv": ["Y", "W", "X"]})
    out = execute(HashJoin(
        JoinType.FULL_OUTER, ["k"], ["rk"], ScanTable(lt), ScanTable(rt),
        KeyUniqueness.UNIQUE,
        lhs_projector=Projector.named("lv"),
        rhs_projector=Projector.named("rv")))
    assert _canon(_rows(out)) == _canon([
        (1, "X"), (3, "Y"), (2, None), (4, None), (None, "W")])


def test_right_outer_with_fused_filter():
    L = TupleSchema.of(("k", DataType.INT64), ("lv", DataType.INT64))
    R = TupleSchema.of(("rk", DataType.INT64), ("rv", DataType.INT64))
    lt = Table.from_data(L, {"k": [1, 2, 3], "lv": [10, 20, 30]})
    rt = Table.from_data(R, {"rk": [2, 3, 4], "rv": [200, 300, 400]})
    # filter knocks out lhs k=3 BEFORE the join: rhs rk=3 must surface
    # as unmatched
    out = execute(HashJoin(
        JoinType.RIGHT_OUTER, ["k"], ["rk"],
        Filter(col("lv") < 25, ScanTable(lt)), ScanTable(rt)))
    assert _canon(_rows(out)) == _canon([
        (2, 20, 2, 200), (None, None, 3, 300), (None, None, 4, 400)])


def test_full_outer_empty_sides():
    L = TupleSchema.of(("k", DataType.INT64), ("lv", DataType.INT64))
    R = TupleSchema.of(("rk", DataType.INT64), ("rv", DataType.INT64))
    empty_l = Table.from_data(L, {"k": [], "lv": []})
    rt = Table.from_data(R, {"rk": [1], "rv": [10]})
    out = execute(HashJoin(JoinType.FULL_OUTER, ["k"], ["rk"],
                           ScanTable(empty_l), ScanTable(rt)))
    assert _rows(out) == [(None, None, 1, 10)]
    empty_r = Table.from_data(R, {"rk": [], "rv": []})
    lt = Table.from_data(L, {"k": [5], "lv": [50]})
    out = execute(HashJoin(JoinType.FULL_OUTER, ["k"], ["rk"],
                           ScanTable(lt), ScanTable(empty_r)))
    assert _rows(out) == [(5, 50, None, None)]


def test_union_all_basic():
    S = TupleSchema.of(("a", DataType.INT64, True), ("s", DataType.STRING))
    t1 = Table.from_data(S, {"a": [1, None], "s": ["x", "y"]})
    t2 = Table.from_data(S, {"a": [3], "s": ["z"]})
    out = execute(UnionAll(Filter(col("a") > 0, ScanTable(t1)),
                           ScanTable(t2)))
    assert _rows(out) == [(1, "x"), (3, "z")]
    # dictionary merge across differently-encoded children
    t3 = Table.from_data(S, {"a": [7], "s": ["aaa"]})
    out = execute(UnionAll(ScanTable(t2), ScanTable(t3)))
    assert _rows(out) == [(3, "z"), (7, "aaa")]


def test_union_all_schema_mismatch():
    from supersonic_jax.schema import SchemaError

    A = TupleSchema.of(("a", DataType.INT64),)
    B = TupleSchema.of(("b", DataType.INT64),)
    with pytest.raises(SchemaError):
        execute(UnionAll(ScanTable(Table.from_data(A, {"a": [1]})),
                         ScanTable(Table.from_data(B, {"b": [1]}))))


def test_outer_joins_capacity_sweep():
    """OperationTest-style sweep (testing/operation_testing.py): the
    outer-join rewrite and UnionAll must not leak capacity padding into
    results at any input capacity."""
    from supersonic_jax.testing.operation_testing import OperationTest

    L = TupleSchema.of(("k", DataType.INT64, True), ("lv", DataType.INT64))
    R = TupleSchema.of(("rk", DataType.INT64, True), ("rv", DataType.INT64))
    ldata = {"k": [1, 2, 2, None], "lv": [10, 20, 21, 40]}
    rdata = {"rk": [2, 3, None], "rv": [200, 300, 999]}

    t = OperationTest()
    t.add_input(L, ldata)
    t.add_input(R, rdata)
    t.set_ignore_row_order()
    t.set_expected_result([
        (2, 20, 2, 200), (2, 21, 2, 200),
        (None, None, 3, 300), (None, None, None, 999)])
    t.execute(lambda l, r: HashJoin(JoinType.RIGHT_OUTER, ["k"], ["rk"],
                                    l, r))

    t2 = OperationTest()
    t2.add_input(L, ldata)
    t2.add_input(R, rdata)
    t2.set_ignore_row_order()
    t2.set_expected_result([
        (1, 10, None, None), (2, 20, 2, 200), (2, 21, 2, 200),
        (None, 40, None, None),
        (None, None, 3, 300), (None, None, None, 999)])
    t2.execute(lambda l, r: HashJoin(JoinType.FULL_OUTER, ["k"], ["rk"],
                                     l, r))

    t3 = OperationTest()
    t3.add_input(L, ldata)
    t3.add_input(L, {"k": [7], "lv": [70]})
    t3.set_expected_result([
        (1, 10), (2, 20), (2, 21), (None, 40), (7, 70)])
    t3.execute(lambda a, b: UnionAll(a, b))

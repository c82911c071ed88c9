"""Filter, NOT_UNIQUE / LEFT_OUTER joins and MergeUnionAll at capacities
of 65K-140K rows against the row-at-a-time reference engine: mixed-sign
f32 with -0.0 and NaN, i64, f64 and nullable columns."""
from __future__ import annotations

import numpy as np
import pytest

from supersonic_jax import (ConstInt32, DataType, Filter, Greater, HashJoin,
                            JoinType, KeyUniqueness, MergeUnionAll,
                            ScanTable, Table, TupleSchema, col, execute)
from supersonic_jax.reference import ref_engine as ref

FILTER_ROWS = 140_000


def _nullable(rng, vals, p=0.2):
    return [None if rng.random() < p else v for v in vals.tolist()]


def _mixed_f32(rng, n):
    f = (rng.standard_normal(n) * 100).astype(np.float32)
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.1] = 0.0
    return f


FILTER_COLUMNS = {
    "f32": (DataType.FLOAT, False, _mixed_f32),
    "i64": (DataType.INT64, False,
            lambda rng, n: rng.integers(-2**62, 2**62, n)),
    "f64": (DataType.DOUBLE, False,
            lambda rng, n: rng.standard_normal(n) * 1e300),
    "nullable_i32": (DataType.INT32, True,
                     lambda rng, n: rng.integers(-9, 9, n).astype(np.int32)),
    "nullable_f64": (DataType.DOUBLE, True,
                     lambda rng, n: rng.standard_normal(n)),
    "bool": (DataType.BOOL, False, lambda rng, n: rng.random(n) < 0.5),
}


@pytest.mark.parametrize("kind", sorted(FILTER_COLUMNS))
def test_filter_large_against_reference(kind):
    rng = np.random.default_rng(len(kind))
    dt, nullable, make = FILTER_COLUMNS[kind]
    n = FILTER_ROWS
    p = rng.integers(-5, 5, n).astype(np.int32)
    x = make(rng, n)
    t = Table.from_data(TupleSchema.of(("p", DataType.INT32, False),
                                       ("x", dt, nullable)),
                        {"p": p, "x": _nullable(rng, x) if nullable else x})
    got = execute(Filter(Greater(col("p"), ConstInt32(0)), ScanTable(t)))
    exp = ref.filter_rows(t.to_pylist(), lambda r: r[0] > 0)
    assert got.to_pylist() == exp
    if not nullable and dt in (DataType.FLOAT, DataType.DOUBLE):
        # bit-exact: -0.0 keeps its sign
        width = np.dtype(x.dtype).itemsize
        gv = np.asarray(got.columns["x"].values)[:int(got.num_rows)]
        assert np.array_equal(gv.view(f"u{width}"),
                              x[p > 0].view(f"u{width}"))


def test_filter_large_keeps_nan_bits():
    rng = np.random.default_rng(1)
    n = FILTER_ROWS
    f = _mixed_f32(rng, n)
    f[rng.random(n) < 0.1] = np.nan
    p = rng.integers(-5, 5, n).astype(np.int32)
    t = Table.from_data(TupleSchema.of(("p", DataType.INT32, False),
                                       ("f", DataType.FLOAT, False)),
                        {"p": p, "f": f})
    got = execute(Filter(Greater(col("p"), ConstInt32(0)), ScanTable(t)))
    gv = np.asarray(got.columns["f"].values)[:int(got.num_rows)]
    assert np.array_equal(gv.view(np.uint32), f[p > 0].view(np.uint32))


def _join_tables(rng, nl, keys, dup):
    nr = keys * dup
    lhs = Table.from_data(
        TupleSchema.of(("lk", DataType.INT32, True),
                       ("lv", DataType.INT64, False),
                       ("lf", DataType.FLOAT, False)),
        {"lk": _nullable(rng, rng.integers(0, keys * 3 // 2, nl), 0.05),
         "lv": rng.integers(-2**40, 2**40, nl),
         "lf": _mixed_f32(rng, nl)})
    rhs = Table.from_data(
        TupleSchema.of(("rk", DataType.INT32, True),
                       ("rw", DataType.INT32, True),
                       ("rd", DataType.DOUBLE, False)),
        {"rk": _nullable(rng, rng.integers(0, keys, nr), 0.05),
         "rw": _nullable(rng, rng.integers(-99, 99, nr)),
         "rd": rng.standard_normal(nr)})
    return lhs, rhs


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "merge"])
@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.LEFT_OUTER],
                         ids=["inner", "left"])
def test_not_unique_join_large_against_reference(jt, dense):
    rng = np.random.default_rng(7)
    lhs, rhs = _join_tables(rng, nl=30_000, keys=5_000, dup=4)
    left_outer = jt == JoinType.LEFT_OUTER
    exp = ref.hash_join(lhs.to_pylist(), rhs.to_pylist(), 0, 0, left_outer)
    assert len(exp) > 65_536
    got = execute(HashJoin(jt, ["lk"], ["rk"], ScanTable(lhs),
                           ScanTable(rhs), KeyUniqueness.NOT_UNIQUE,
                           out_capacity=len(exp) + 100,
                           allow_dense_lookup=dense))
    assert got.to_pylist() == exp


@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.LEFT_OUTER],
                         ids=["inner", "left"])
def test_unique_join_large_against_reference(jt):
    rng = np.random.default_rng(8)
    nl, keys = 140_000, 20_000
    perm = rng.permutation(keys * 2)[:keys].astype(np.int32)
    lhs = Table.from_data(
        TupleSchema.of(("lk", DataType.INT32, False),
                       ("lf", DataType.FLOAT, False)),
        {"lk": rng.integers(0, keys * 2, nl).astype(np.int32),
         "lf": _mixed_f32(rng, nl)})
    rhs = Table.from_data(
        TupleSchema.of(("rk", DataType.INT32, False),
                       ("rv", DataType.INT64, True)),
        {"rk": perm, "rv": _nullable(rng, rng.integers(-2**50, 2**50, keys))})
    left_outer = jt == JoinType.LEFT_OUTER
    exp = ref.hash_join(lhs.to_pylist(), rhs.to_pylist(), 0, 0, left_outer)
    got = execute(HashJoin(jt, ["lk"], ["rk"], ScanTable(lhs),
                           ScanTable(rhs), KeyUniqueness.UNIQUE))
    assert got.to_pylist() == exp


MERGE_KEYS = {
    "f32_mixed_sign": (DataType.FLOAT, _mixed_f32, True),
    "i64_desc": (DataType.INT64,
                 lambda rng, n: rng.integers(-2**62, 2**62, n), False),
    "f64": (DataType.DOUBLE, lambda rng, n: rng.standard_normal(n) * 1e200,
            True),
}


@pytest.mark.parametrize("kind", sorted(MERGE_KEYS))
def test_merge_large_against_reference(kind):
    rng = np.random.default_rng(len(kind) + 3)
    dt, make, asc = MERGE_KEYS[kind]
    n = 40_000
    schema = TupleSchema.of(("k", dt, False), ("w", DataType.INT64, True))
    kids, rows = [], []
    for _ in range(2):
        t = Table.from_data(schema, {
            "k": make(rng, n),
            "w": _nullable(rng, rng.integers(-2**40, 2**40, n))})
        srt = ref.sort_rows(t.to_pylist(), [(0, asc)])
        rows.extend(srt)
        kids.append(ScanTable(Table.from_data(
            schema, {"k": np.array([r[0] for r in srt]),
                     "w": [r[1] for r in srt]})))
    got = execute(MergeUnionAll([("k", asc)], kids))
    assert got.to_pylist() == ref.sort_rows(rows, [(0, asc)])

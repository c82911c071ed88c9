"""Capacity-boundary stress tests.

Pins the engine's behavior at the edges the large-scale configs cross:

  * NOT_UNIQUE join expansion filling >90% of out_capacity (and the
    overflow raise just past 100%)
  * the approx_max_k (f32-exact below 2^24) vs lax.top_k group-extraction
    boundary — both branches produce identical groups
  * capacity above the boundary via the factored _APPROX_TOPK_MAX_CAP
    constant, so the top_k branch runs at test scale; the real >16M-row
    shapes run on the chip via scripts/stress_edges.py
"""
import numpy as np
import pytest

from supersonic_jax import (AggSpec, Aggregation, DataType, GroupAggregate,
                            GroupAggregateOptions, HashJoin, JoinType,
                            KeyUniqueness, ScanTable, Table, TupleSchema,
                            execute)
from supersonic_jax.exprs.base import EvaluationError
from supersonic_jax.ops import aggregate as agg_mod


def _join_tables(n_probe, n_build, dup, seed=0):
    """build side has `dup` rows per key -> output = n_probe * dup rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_build // dup, n_probe)
    probe = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("pv", DataType.INT64, False)),
        {"fk": keys, "pv": np.arange(n_probe)})
    build = Table.from_data(
        TupleSchema.of(("bk", DataType.INT64, False),
                       ("bv", DataType.INT64, False)),
        {"bk": np.repeat(np.arange(n_build // dup), dup),
         "bv": np.arange(n_build)})
    return probe, build


def _expected_rows(probe, build):
    fk = [r[0] for r in probe.to_pylist()]
    out = []
    bmap: dict = {}
    for bk, bv in build.to_pylist():
        bmap.setdefault(bk, []).append(bv)
    for k, pv in probe.to_pylist():
        for bv in bmap.get(k, []):
            out.append((k, pv, k, bv))
    return sorted(out)


@pytest.mark.parametrize("fill", [0.91, 0.97, 1.0])
def test_not_unique_join_near_out_capacity(fill):
    dup = 4
    n_probe, n_build = 200, 80
    probe, build = _join_tables(n_probe, n_build, dup)
    exact = n_probe * dup
    cap = int(np.ceil(exact / fill))
    out = execute(HashJoin(
        JoinType.INNER, ["fk"], ["bk"], ScanTable(probe), ScanTable(build),
        KeyUniqueness.NOT_UNIQUE, out_capacity=cap))
    assert int(out.num_rows) == exact
    assert sorted(out.to_pylist()) == _expected_rows(probe, build)


def test_not_unique_join_past_capacity_raises():
    dup = 4
    probe, build = _join_tables(200, 80, dup)
    exact = 200 * dup
    with pytest.raises(EvaluationError):
        execute(HashJoin(
            JoinType.INNER, ["fk"], ["bk"], ScanTable(probe),
            ScanTable(build), KeyUniqueness.NOT_UNIQUE,
            out_capacity=exact - 1))


def _groupby_rows(n, keys, seed=1):
    rng = np.random.default_rng(seed)
    return Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"k": rng.integers(0, keys, n), "v": rng.integers(0, 1000, n)})


def test_group_extraction_compaction_branch_matches_approx(monkeypatch):
    """Shrinking the boundary constant forces the general compaction
    extraction (the >=2^24-capacity path); results must equal the
    approx_max_k fast path's."""
    t = _groupby_rows(5000, 40)
    spec = [AggSpec(Aggregation.SUM, "v", "sv"),
            AggSpec(Aggregation.MIN, "v", "mn")]
    opts = GroupAggregateOptions(estimated_result_row_count=64)
    want = execute(GroupAggregate(["k"], spec, ScanTable(t), opts))
    monkeypatch.setattr(agg_mod, "_APPROX_TOPK_MAX_CAP", 1)
    got = execute(GroupAggregate(["k"], spec, ScanTable(t), opts))
    assert sorted(got.to_pylist()) == sorted(want.to_pylist())


def test_group_extraction_exact_at_24bit_scale():
    """A capacity just above 2^24 on the CPU backend: extraction must
    take the exact compaction path (the f32 (cap - pos) approx ranking
    would be inexact here — the reason the boundary exists)."""
    cap = (1 << 24) + 64
    n = 4096  # live rows; capacity padding provides the boundary crossing
    rng = np.random.default_rng(2)
    k = rng.integers(0, 37, n)
    v = rng.integers(0, 100, n)
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"k": k, "v": v}, capacity=cap)
    out = execute(GroupAggregate(
        ["k"], [AggSpec(Aggregation.SUM, "v", "sv")], ScanTable(t),
        GroupAggregateOptions(estimated_result_row_count=64)))
    want: dict = {}
    for ki, vi in zip(k.tolist(), v.tolist()):
        want[ki] = want.get(ki, 0) + vi
    got = dict(out.to_pylist())
    assert got == want

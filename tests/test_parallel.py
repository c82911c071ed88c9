"""Distributed execution tests on an emulated 8-device CPU mesh
(SURVEY.md §4.6: the multi-chip analogue of the reference's test harness).
Each distributed result is compared against the single-chip operator on the
same data."""
import numpy as np
import pytest

import jax

from supersonic_jax import (AggSpec, Aggregation, DataType, GroupAggregate,
                            HashJoin, JoinType, KeyUniqueness, ScanTable,
                            Sort, Table, TupleSchema, execute)
from supersonic_jax.parallel import (collect_table, dist_group_aggregate,
                                     dist_hash_join, dist_map, dist_sort,
                                     distribute_table, make_mesh,
                                     run_local_plan, shuffle)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device mesh")


def make_tables(n=200, m=40, seed=0):
    rng = np.random.default_rng(seed)
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"fk": rng.integers(0, m, n), "v": rng.integers(0, 100, n)})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False),
                       ("g", DataType.INT64, False)),
        {"pk": np.arange(m), "g": rng.integers(0, 5, m)})
    return fact, dim


def test_distribute_collect_roundtrip():
    mesh = make_mesh()
    fact, _ = make_tables()
    dist = distribute_table(fact, mesh)
    back = collect_table(dist)
    assert sorted(back.to_pylist()) == sorted(fact.to_pylist())


def test_dist_group_aggregate_matches_local():
    mesh = make_mesh()
    fact, _ = make_tables()
    spec = [AggSpec(Aggregation.SUM, "v", "sv"),
            AggSpec(Aggregation.COUNT, None, "c"),
            AggSpec(Aggregation.MIN, "v", "mn"),
            AggSpec(Aggregation.MAX, "v", "mx")]
    expected = execute(GroupAggregate(["fk"], spec, ScanTable(fact)))
    dist = distribute_table(fact, mesh)
    got = collect_table(dist_group_aggregate(mesh, dist, ["fk"], spec,
                                             out_cap_per_peer=256))
    assert sorted(got.to_pylist()) == sorted(expected.to_pylist())


def test_dist_hash_join_matches_local():
    mesh = make_mesh()
    fact, dim = make_tables()
    expected = execute(HashJoin(JoinType.INNER, ["fk"], ["pk"],
                                ScanTable(fact), ScanTable(dim),
                                KeyUniqueness.UNIQUE))
    dfact = distribute_table(fact, mesh)
    ddim = distribute_table(dim, mesh)
    got = collect_table(dist_hash_join(
        mesh, JoinType.INNER, ["fk"], ["pk"], dfact, ddim,
        KeyUniqueness.UNIQUE, out_cap_per_peer=256))
    assert sorted(got.to_pylist()) == sorted(expected.to_pylist())


def test_dist_sort_globally_sorted():
    mesh = make_mesh()
    fact, _ = make_tables()
    expected = execute(Sort(["v"], ScanTable(fact)))
    dist = distribute_table(fact, mesh)
    out = dist_sort(mesh, dist, ["v"], out_cap_per_peer=256)
    got = collect_table(out)
    # collect_table concatenates shards in mesh order => globally sorted
    assert [r[1] for r in got.to_pylist()] == \
        [r[1] for r in expected.to_pylist()]


def test_shuffle_preserves_rows():
    mesh = make_mesh()
    fact, _ = make_tables(n=64)
    dist = distribute_table(fact, mesh)
    P = mesh.devices.size

    def dest_fn(local):
        return (local.columns["fk"].values % P).astype(np.int32)

    got = collect_table(shuffle(mesh, dist, dest_fn, 64))
    assert sorted(got.to_pylist()) == sorted(fact.to_pylist())


def test_left_outer_dist_join():
    mesh = make_mesh()
    rng = np.random.default_rng(3)
    lhs = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),), {"k": [1, 2, 99]})
    rhs = Table.from_data(
        TupleSchema.of(("k2", DataType.INT64, False),
                       ("w", DataType.INT64, False)),
        {"k2": [1, 2, 3], "w": [10, 20, 30]})
    expected = execute(HashJoin(JoinType.LEFT_OUTER, ["k"], ["k2"],
                                ScanTable(lhs), ScanTable(rhs),
                                KeyUniqueness.UNIQUE))
    got = collect_table(dist_hash_join(
        mesh, JoinType.LEFT_OUTER, ["k"], ["k2"],
        distribute_table(lhs, mesh), distribute_table(rhs, mesh),
        KeyUniqueness.UNIQUE, out_cap_per_peer=32))
    assert sorted(got.to_pylist(), key=str) == \
        sorted(expected.to_pylist(), key=str)


def test_skew_aware_join_matches_local():
    from supersonic_jax.parallel.dist import dist_hash_join_skew
    rng = np.random.default_rng(11)
    n, m = 400, 50
    # heavy skew: 60% of probe rows hit key 7
    fk = np.where(rng.random(n) < 0.6, 7, rng.integers(0, m, n))
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("lv", DataType.INT64, False)),
        {"fk": fk, "lv": np.arange(n)})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False),
                       ("w", DataType.INT64, False)),
        {"pk": np.arange(m), "w": np.arange(m) * 10})
    expected = execute(HashJoin(JoinType.INNER, ["fk"], ["pk"],
                                ScanTable(lhs), ScanTable(rhs),
                                KeyUniqueness.UNIQUE))
    mesh = make_mesh()
    got = collect_table(dist_hash_join_skew(
        mesh, JoinType.INNER, ["fk"], ["pk"],
        distribute_table(lhs, mesh), distribute_table(rhs, mesh),
        KeyUniqueness.UNIQUE, out_cap_per_peer=512, hot_cap=64,
        min_frac=0.05))
    assert sorted(got.to_pylist()) == sorted(expected.to_pylist())


@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.LEFT_OUTER])
def test_ring_pipelined_join_matches_local(jt):
    from supersonic_jax.parallel.dist import dist_hash_join_ring
    rng = np.random.default_rng(13)
    n, m = 300, 40
    fk = rng.integers(0, m + 10, n)  # some keys have no build match
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("lv", DataType.INT64, False)),
        {"fk": fk, "lv": np.arange(n)})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False),
                       ("w", DataType.INT64, True)),
        {"pk": np.arange(m),
         "w": [None if i % 7 == 0 else i * 10 for i in range(m)]})
    expected = execute(HashJoin(jt, ["fk"], ["pk"],
                                ScanTable(lhs), ScanTable(rhs),
                                KeyUniqueness.UNIQUE))
    mesh = make_mesh()
    got = collect_table(dist_hash_join_ring(
        mesh, jt, ["fk"], ["pk"],
        distribute_table(lhs, mesh),
        distribute_table(rhs, mesh, keys=["pk"])))
    assert sorted(got.to_pylist(), key=str) == \
        sorted(expected.to_pylist(), key=str)


def test_skewed_exchange_overflow_raises():
    """A deliberately skewed shuffle must RAISE (ERROR_MEMORY_EXCEEDED
    semantics, memory.h:465) rather than silently drop rows: every row
    shares one group key, so the whole table funnels to a single peer
    whose buffer is deliberately undersized.  DISTINCT forces the
    raw-row shuffle (the pregroup path would legitimately collapse the
    hot key to one row per shard before the exchange)."""
    from supersonic_jax.exprs.base import EvaluationError

    mesh = make_mesh()
    n = 400
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"fk": np.zeros(n, dtype=np.int64),
         "v": np.arange(n, dtype=np.int64)})
    dist = distribute_table(fact, mesh)
    spec = [AggSpec(Aggregation.SUM, "v", "sv", distinct=True)]
    with pytest.raises(EvaluationError, match="exchange overflow"):
        dist_group_aggregate(mesh, dist, ["fk"], spec, out_cap_per_peer=8)


def test_skewed_join_shuffle_overflow_raises():
    """The join-side repartition must also surface overflow."""
    from supersonic_jax.exprs.base import EvaluationError

    mesh = make_mesh()
    n = 400
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False)),
        {"fk": np.zeros(n, dtype=np.int64)})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False),
                       ("w", DataType.INT64, False)),
        {"pk": np.arange(4), "w": np.arange(4) * 10})
    dl = distribute_table(lhs, mesh)
    dr = distribute_table(rhs, mesh)
    with pytest.raises(EvaluationError, match="exchange overflow"):
        dist_hash_join(mesh, JoinType.INNER, ["fk"], ["pk"], dl, dr,
                       KeyUniqueness.UNIQUE, out_cap_per_peer=8)


def test_skewed_exchange_default_caps_survive_hot_key():
    """With derived per-peer caps (capacity/P x skew factor) the same
    hot-key table shuffles without overflow and the result is exact."""
    mesh = make_mesh()
    n = 256
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"fk": np.zeros(n, dtype=np.int64),
         "v": np.arange(n, dtype=np.int64)})
    # generous per-shard capacity so cap/P * skew_factor >= n
    dist = distribute_table(fact, mesh, cap_per_shard=n)
    spec = [AggSpec(Aggregation.SUM, "v", "sv")]
    got = collect_table(dist_group_aggregate(mesh, dist, ["fk"], spec))
    assert got.to_pylist() == [(0, n * (n - 1) // 2)]


def test_dist_group_aggregate_quota_pregroup_stays_exact():
    """A memory_quota on the distributed group-by bounds the pregroup
    (best-effort partial aggregation per shard); the final combine still
    produces the exact answer (aggregate.h:233-246 contract)."""
    import warnings

    from supersonic_jax import GroupAggregateOptions

    mesh = make_mesh()
    fact, _ = make_tables(n=300, m=30)
    dist = distribute_table(fact, mesh)
    spec = [AggSpec(Aggregation.SUM, "v", "sv"),
            AggSpec(Aggregation.COUNT, "v", "cv")]
    # ~5-row pregroup budget per shard (row: k 8B + sv 8B+1 + cv 8B = 25B)
    opts = GroupAggregateOptions(memory_quota=125)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # per-shard degradation warnings
        got = collect_table(
            dist_group_aggregate(mesh, dist, ["fk"], spec, options=opts))
    want = execute(GroupAggregate(["fk"], spec, ScanTable(fact)))
    assert sorted(got.to_pylist()) == sorted(want.to_pylist())


def test_full_outer_dist_join():
    """FULL_OUTER distributes through dist_hash_join unchanged: both
    sides repartition by key hash, so a shard-local unmatched row is
    globally unmatched (ops/hash_join.py::_bind_outer_rewrite runs per
    shard)."""
    mesh = make_mesh()
    lhs = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("lv", DataType.INT64, False)),
        {"k": [1, 2, 2, 99], "lv": [10, 20, 21, 990]})
    rhs = Table.from_data(
        TupleSchema.of(("k2", DataType.INT64, False),
                       ("w", DataType.INT64, False)),
        {"k2": [2, 3, 4], "w": [200, 300, 400]})
    for jt in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
        expected = execute(HashJoin(jt, ["k"], ["k2"],
                                    ScanTable(lhs), ScanTable(rhs),
                                    KeyUniqueness.UNIQUE))
        got = collect_table(dist_hash_join(
            mesh, jt, ["k"], ["k2"],
            distribute_table(lhs, mesh), distribute_table(rhs, mesh),
            KeyUniqueness.UNIQUE, out_cap_per_peer=32))
        assert sorted(got.to_pylist(), key=str) == \
            sorted(expected.to_pylist(), key=str), jt


def test_dist_distinct_aggregate_matches_local():
    """Positive correctness of the raw-shuffle DISTINCT path:
    a distributed distinct-aggregate must equal
    the single-chip GroupAggregate on the same data."""
    rng = np.random.default_rng(7)
    n = 500
    fact = Table.from_data(
        TupleSchema.of(("g", DataType.INT64, False),
                       ("v", DataType.INT64, True)),
        {"g": rng.integers(0, 12, n),
         "v": [None if rng.random() < 0.1 else int(x)
               for x in rng.integers(0, 9, n)]})
    spec = [AggSpec(Aggregation.SUM, "v", "sv", distinct=True),
            AggSpec(Aggregation.COUNT, "v", "cv", distinct=True)]
    expected = execute(GroupAggregate(["g"], spec, ScanTable(fact)))
    mesh = make_mesh()
    got = collect_table(dist_group_aggregate(
        mesh, distribute_table(fact, mesh), ["g"], spec))
    assert sorted(got.to_pylist()) == sorted(expected.to_pylist())

"""Distributed execution over a device mesh (SURVEY.md §2.9, §5.8)."""
from .dist import (AXIS, check_exchange_overflow, collect_table,
                   combine_specification, dist_group_aggregate,
                   dist_hash_join, dist_hash_join_ring, dist_hash_join_skew,
                   dist_map, dist_sort, distribute_table, make_mesh,
                   run_local_plan, shuffle)
from .hashing import combine_hash, partition_of
from .multihost import global_mesh, initialize, is_multihost


PIPELINE_GROUPS = 8
PIPELINE_THRESHOLD = 0.25


def pipeline_data(n: int, m: int, seed: int = 0):
    """(fk, v, g) of the dry-run pipeline: n fact rows over m dim rows
    (pk = arange(m)) whose group g takes PIPELINE_GROUPS values."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fk = rng.integers(0, m, n).astype(np.int32)
    v = rng.random(n, dtype=np.float32)
    g = rng.integers(0, PIPELINE_GROUPS, m).astype(np.int32)
    return fk, v, g


def dryrun(n_devices: int, fact_rows: int = 4096, dim_rows: int = 512,
           seed: int = 0) -> dict:
    """Jit + execute one step of the full distributed pipeline
    (filter -> join -> group-by -> sort) over an n-device mesh, plus the
    ring (ppermute) join variant, at shapes large enough to exercise the
    exchange's near-capacity behavior (a 64-row wiring check would not
    catch capacity/overflow bugs), then the skew join and the exchange
    overflow raise at their fixed small shapes.  Results are VALIDATED
    against a host recomputation, not just non-empty.  Returns the
    pipeline's groups as {g: (sum v, count)}."""
    import jax
    import numpy as np

    from .. import (AggSpec, Aggregation, Const, DataType, Filter,
                    JoinType, KeyUniqueness, ScanTable, Table, TupleSchema,
                    col)
    from .dist import make_mesh

    mesh = make_mesh(n_devices)
    n, m = fact_rows, dim_rows
    fk, v, g = pipeline_data(n, m, seed)
    rng = np.random.default_rng(seed + 1)
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"fk": fk, "v": v})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(m, dtype=np.int32), "g": g})
    dfact = distribute_table(fact, mesh)
    ddim = distribute_table(dim, mesh, keys=["pk"])
    # the join's exchange takes the derived (shard_cap/P-scaled)
    # per-peer caps, the overflow-checked sizing the real pipeline uses;
    # the group count is known, so the aggregate and sort exchanges are
    # sized for it, as a caller would (derived caps there would carry
    # the join's capacity into an 8-row result)
    group_cap = 8 * PIPELINE_GROUPS

    def step(dfact, ddim):
        filtered = dist_map(
            mesh,
            lambda t: run_local_plan(
                lambda tt: Filter(col("v") > Const(PIPELINE_THRESHOLD,
                                                   DataType.FLOAT),
                                  ScanTable(tt)), t),
            dfact)
        joined = dist_hash_join(
            mesh, JoinType.INNER, ["fk"], ["pk"], filtered, ddim,
            KeyUniqueness.UNIQUE)
        agg = dist_group_aggregate(
            mesh, joined, ["g"],
            [AggSpec(Aggregation.SUM, "v", "sv"),
             AggSpec(Aggregation.COUNT, None, "c")],
            out_cap_per_peer=group_cap)
        out = dist_sort(mesh, agg, ["g"], out_cap_per_peer=group_cap)
        ring = dist_hash_join_ring(
            mesh, JoinType.INNER, ["fk"], ["pk"], filtered, ddim)
        return out, ring

    out, ring = jax.jit(step)(dfact, ddim)
    jax.block_until_ready(jax.tree_util.tree_leaves(out))
    # validate against host recomputation (exchange correctness, not
    # just liveness)
    keep = v > PIPELINE_THRESHOLD
    gj = g[fk[keep]]
    vk = v[keep].astype(np.float64)
    sums = np.bincount(gj, weights=vk, minlength=PIPELINE_GROUPS)
    abs_sums = np.bincount(gj, weights=np.abs(vk), minlength=PIPELINE_GROUPS)
    counts = np.bincount(gj, minlength=PIPELINE_GROUPS)
    res = collect_table(out)
    rows = res.to_pylist()
    got = {int(r[0]): (r[1], int(r[2])) for r in rows}
    assert [r[0] for r in rows] == sorted(got), "dist_sort order mismatch"
    assert set(got) == set(np.flatnonzero(counts)), "group set mismatch"
    for gid, (sv, c) in got.items():
        assert c == counts[gid], f"COUNT mismatch for group {gid}"
        # f32 sums accumulate in another order than the f64 reference
        assert abs(sv - sums[gid]) <= 1e-5 * abs_sums[gid], \
            f"SUM mismatch for group {gid}"
    ring_rows = int(np.sum(np.asarray(ring.num_rows)))
    assert ring_rows == int(keep.sum()), "ring join row count mismatch"

    # --- skew hot-key broadcast join: 60% of probe rows hit one key;
    # validated against a host join recomputation ---
    from .dist import dist_hash_join_skew

    # fixed small shapes: the exchange caps below are sized for them
    n, m = 4096, min(m, 512)
    fk_s = np.where(rng.random(n) < 0.6, 7,
                    rng.integers(0, m, n)).astype(np.int32)
    lv = np.arange(n, dtype=np.int32)
    skew_lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("lv", DataType.INT32, False)),
        {"fk": fk_s, "lv": lv})
    dskew = distribute_table(skew_lhs, mesh)
    skew_dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(m, dtype=np.int32), "g": g[:m]})
    skew_out = dist_hash_join_skew(
        mesh, JoinType.INNER, ["fk"], ["pk"], dskew,
        distribute_table(skew_dim, mesh, keys=["pk"]),
        KeyUniqueness.UNIQUE, out_cap_per_peer=1024, hot_cap=4096,
        min_frac=0.05)
    sres = collect_table(skew_out)
    want = sorted((int(a), int(b), int(a), int(g[a]))
                  for a, b in zip(fk_s, lv))
    got_rows = sorted(tuple(int(x) for x in r)
                      for r in sres.to_pylist())
    assert got_rows == want, "skew join mismatch vs host recomputation"

    # --- exchange overflow must RAISE (ERROR_MEMORY_EXCEEDED semantics,
    # memory.h:465), never silently drop: every row shares one key, so
    # the shuffle funnels into one deliberately undersized peer ---
    from ..exprs.base import EvaluationError

    hot = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.INT32, False)),
        {"fk": np.zeros(512, dtype=np.int32),
         "v": np.arange(512, dtype=np.int32)})
    dhot = distribute_table(hot, mesh)
    try:
        dist_group_aggregate(
            mesh, dhot, ["fk"],
            [AggSpec(Aggregation.SUM, "v", "sv", distinct=True)],
            out_cap_per_peer=8)
    except EvaluationError as e:
        assert "exchange overflow" in str(e)
    else:
        raise AssertionError(
            "skewed exchange overflow did not raise")
    return got

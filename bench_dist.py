"""Distributed-pipeline scaling benchmark over the GPUs of one host.

Runs the full filter -> join -> group-by -> sort pipeline over a 1-device
and an N-device mesh and reports rows/s and scaling efficiency
(``--analyze``: a per-component breakdown and the measured exchange
bytes, written to EXCHANGE.json).  Times are medians of warm runs ended
by ``block_until_ready``; every line names the card and its power
limit.  Exits non-zero when JAX finds no GPU.  The CPU rehearsal of the
same path is in the tests (tests/test_parallel.py).

Usage: ``python bench_dist.py [--devices N] [--analyze]``
"""
import argparse
import json
import sys

import numpy as np


def _setup():
    import jax

    from supersonic_jax.bench.device import (card_line,
                                             configure_compile_cache,
                                             require_gpu)

    configure_compile_cache()
    require_gpu()
    return jax, card_line()


def run(n_rows: int, n_dim: int, devices: int):
    jax, card = _setup()
    from supersonic_jax.bench.device import median_seconds

    from supersonic_jax import (AggSpec, Aggregation, Const, DataType,
                                Filter, JoinType, KeyUniqueness, ScanTable,
                                Table, TupleSchema, col)
    from supersonic_jax.parallel import (dist_group_aggregate,
                                         dist_hash_join, dist_map, dist_sort,
                                         distribute_table, make_mesh,
                                         run_local_plan)

    rng = np.random.default_rng(42)
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"fk": rng.integers(0, n_dim, n_rows).astype(np.int32),
         "v": rng.random(n_rows, dtype=np.float32)})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(n_dim, dtype=np.int32),
         "g": rng.integers(0, 64, n_dim).astype(np.int32)})

    def pipeline(mesh, dfact, ddim, per_peer):
        filtered = dist_map(
            mesh,
            lambda t: run_local_plan(
                lambda tt: Filter(col("v") > Const(0.5, DataType.FLOAT),
                                  ScanTable(tt)), t),
            dfact)
        joined = dist_hash_join(
            mesh, JoinType.INNER, ["fk"], ["pk"], filtered, ddim,
            KeyUniqueness.UNIQUE)  # derived per-peer caps (cap/P x skew)
        agg = dist_group_aggregate(
            mesh, joined, ["g"],
            [AggSpec(Aggregation.SUM, "v", "sv"),
             AggSpec(Aggregation.COUNT, None, "c")],
            out_cap_per_peer=256)
        return dist_sort(mesh, agg, ["g"], out_cap_per_peer=256)

    results = {}
    for P in (1, devices):
        mesh = make_mesh(P)
        dfact = distribute_table(fact, mesh)
        ddim = distribute_table(dim, mesh)
        per_peer = dfact._cap_hint

        stepped = jax.jit(lambda a, b: pipeline(mesh, a, b, per_peer))
        best = median_seconds(stepped, dfact, ddim)
        results[P] = n_rows / best
        print(f"P={P}: {best*1e3:9.3f} ms  {results[P]/1e6:8.1f} M rows/s"
              f"  [{card}]", file=sys.stderr)
    eff = results[devices] / (results[1] * devices)
    print(json.dumps({
        "metric": "dist_pipeline_scaling_efficiency",
        "value": eff,
        "unit": f"fraction of linear (1->{devices} devices)",
        "card": card,
    }))


def analyze(n_rows: int, n_dim: int, devices: int):
    """Component breakdown at each mesh size: local compute vs exchange
    time, shuffle bytes, and ring-join (ppermute overlap) vs repartition
    join."""
    jax, card = _setup()
    from supersonic_jax.bench.device import median_seconds

    from supersonic_jax import (AggSpec, Aggregation, Const, DataType,
                                Filter, HashJoin, JoinType, KeyUniqueness,
                                ScanTable, Table, TupleSchema, col)
    from supersonic_jax.parallel import (dist_group_aggregate,
                                         dist_hash_join, dist_map,
                                         dist_sort, distribute_table,
                                         make_mesh, run_local_plan, shuffle)
    from supersonic_jax.parallel.dist import (_key_dest_fn,
                                              dist_hash_join_ring)

    rng = np.random.default_rng(42)
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"fk": rng.integers(0, n_dim, n_rows).astype(np.int32),
         "v": rng.random(n_rows, dtype=np.float32)})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(n_dim, dtype=np.int32),
         "g": rng.integers(0, 64, n_dim).astype(np.int32)})

    def timed(fn, *args):
        return median_seconds(fn, *args), fn(*args)

    rows_per = {}
    print(f"{'P':>2} {'component':<26} {'ms':>9} {'M rows/s':>9}",
          file=sys.stderr)
    sweep = sorted({1, 2, 4, devices})
    table = {}
    exchange_log = {}
    for P in sweep:
        mesh = make_mesh(P)
        dfact = distribute_table(fact, mesh)
        ddim = distribute_table(dim, mesh)
        per_peer = dfact._cap_hint

        def rec(name, secs, P=P):
            table[(P, name)] = secs
            print(f"{P:>2} {name:<26} {secs*1e3:>9.3f} "
                  f"{n_rows/secs/1e6:>9.1f}  [{card}]", file=sys.stderr)

        # (1) embarrassingly-parallel local compute: filter
        filt = jax.jit(lambda d: dist_map(
            mesh, lambda t: run_local_plan(
                lambda tt: Filter(col("v") > Const(0.5, DataType.FLOAT),
                                  ScanTable(tt)), t), d))
        secs, filtered = timed(filt, dfact)
        rec("filter(local)", secs)

        # (2) the exchange alone: hash-repartition the filtered fact by fk
        exch = jax.jit(lambda d: shuffle(
            mesh, d, _key_dest_fn(["fk"], P), None, check=False)[0])
        secs, shuffled_fact = timed(exch, filtered)
        rec("exchange(fact by fk)", secs)

        # (3) repartition join (2 shuffles + local join)
        # derived per-peer caps (shard_cap/P x skew factor): receive
        # buffers shrink with P instead of staying at full shard capacity
        rj = jax.jit(lambda a, b: dist_hash_join(
            mesh, JoinType.INNER, ["fk"], ["pk"], a, b,
            KeyUniqueness.UNIQUE))
        secs, joined = timed(rj, filtered, ddim)
        rec("join(repartition)", secs)

        # (4) ring join: probe stays local, build rotates via ppermute —
        # the overlap design (no probe-side exchange at all)
        ring = jax.jit(lambda a, b: dist_hash_join_ring(
            mesh, JoinType.INNER, ["fk"], ["pk"], a, b))
        ddim_bykey = distribute_table(dim, mesh, keys=["pk"])
        secs, _ = timed(ring, filtered, ddim_bykey)
        rec("join(ring/ppermute)", secs)

        # (5) pregroup -> shuffle -> combine aggregate
        agg = jax.jit(lambda d: dist_group_aggregate(
            mesh, d, ["g"],
            [AggSpec(Aggregation.SUM, "v", "sv"),
             AggSpec(Aggregation.COUNT, None, "c")],
            out_cap_per_peer=256))
        secs, agged = timed(agg, joined)
        rec("group-by(pregroup+comb)", secs)

        # (6) sample sort
        srt = jax.jit(lambda d: dist_sort(mesh, d, ["g"],
                                          out_cap_per_peer=256))
        secs, _ = timed(srt, agged)
        rec("sort(sample+range)", secs)

        # (7) measured exchange accounting: the [P,P] src->dst row
        # matrices the shuffles actually moved, as bytes
        from supersonic_jax.parallel.dist import table_row_bytes

        def measure(d, keys):
            st = {}
            shuffle(mesh, d, _key_dest_fn(keys, P), None, check=False,
                    stats_out=st)
            return {"total_bytes": st["total_bytes"],
                    "offmesh_bytes": st["offmesh_bytes"],
                    "row_bytes": st["row_bytes"],
                    "rows": int(st["sent_rows"].sum())}

        ex = {"fact_shuffle_by_fk": measure(filtered, ["fk"]),
              "dim_shuffle_by_pk": measure(ddim, ["pk"])}
        # pregroup -> shuffle: measure the bytes of the pregrouped stream
        pre = jax.jit(lambda d: dist_map(
            mesh, lambda t: run_local_plan(
                lambda tt: __import__("supersonic_jax").BestEffortGroupAggregate(
                    ["g"], [AggSpec(Aggregation.SUM, "v", "sv"),
                            AggSpec(Aggregation.COUNT, None, "c")],
                    ScanTable(tt)), t), d))(joined)
        ex["groupby_pregroup_shuffle"] = measure(pre, ["g"])
        # ring join: the build side rotates P-1 times; bytes are
        # computed from the MEASURED per-shard live build rows
        build_rows = int(np.sum(np.asarray(ddim_bykey.num_rows)))
        rb = table_row_bytes(ddim_bykey.schema)
        ex["ring_build_rotation"] = {
            "total_bytes": (P - 1) * build_rows * rb,
            "offmesh_bytes": (P - 1) * build_rows * rb,
            "row_bytes": rb, "rows": (P - 1) * build_rows}
        exchange_log[str(P)] = ex
        for name, e in ex.items():
            print(f"   P={P} {name}: {e['offmesh_bytes']/1e6:.2f} MB "
                  f"off-shard / {e['total_bytes']/1e6:.2f} MB total",
                  file=sys.stderr)
    with open("EXCHANGE.json", "w") as f:
        json.dump({"fact_rows": n_rows, "dim_rows": n_dim,
                   "per_P": exchange_log}, f, indent=1)
    print("wrote EXCHANGE.json (measured per-config exchange bytes)",
          file=sys.stderr)
    print(json.dumps({
        "metric": "dist_component_analysis",
        "value": round(table[(devices, 'join(ring/ppermute)')]
                       / max(table[(devices, 'join(repartition)')], 1e-12),
                       3),
        "unit": "ring/repartition join time ratio at max P",
        "card": card,
    }))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=100_000)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--analyze", action="store_true",
                    help="component breakdown across a mesh-size sweep")
    a = ap.parse_args()
    if a.analyze:
        analyze(a.rows, a.dim, a.devices)
    else:
        run(a.rows, a.dim, a.devices)

"""Capacity-edge stress at benchmark-scale shapes.

Runs on the default backend (the GPU where there is one):
  1. 17M-row group-by: capacity crosses the 2^24 approx_max_k boundary,
     so group extraction takes the exact compaction path (approx_max_k is f32-bounded).
  2. NOT_UNIQUE join whose CSR expansion fills ~95% of out_capacity.
  3. zipf-1.3 skewed NOT_UNIQUE join near capacity (hot-key expansion).

Each case checksums against a NumPy computation of the same result.
Usage: python scripts/stress_edges.py [--small]  (--small: CPU-size smoke)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(small: bool):
    import jax

    from supersonic_jax import (AggSpec, Aggregation, DataType,
                                GroupAggregate, GroupAggregateOptions,
                                HashJoin, JoinType, KeyUniqueness,
                                ScanTable, Table, TupleSchema, execute)

    print(f"backend: {jax.devices()[0].platform}", file=sys.stderr)
    scale = 64 if small else 1

    # --- 1. group-by across the 2^24 capacity boundary ---------------
    n = (17_000_000 // scale) if not small else 300_000
    cap = max(n, (1 << 24) + 4096) if not small else n
    rng = np.random.default_rng(1)
    k = rng.integers(0, 63, n).astype(np.int64)
    v = rng.integers(0, 1000, n).astype(np.int64)
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"k": k, "v": v}, capacity=cap)
    t0 = time.perf_counter()
    out = execute(GroupAggregate(
        ["k"], [AggSpec(Aggregation.SUM, "v", "sv"),
                AggSpec(Aggregation.COUNT, None, "c")], ScanTable(t),
        GroupAggregateOptions(estimated_result_row_count=128)))
    rows = out.to_pylist()
    dt = time.perf_counter() - t0
    want_sv = np.bincount(k, weights=v.astype(np.float64), minlength=63)
    want_c = np.bincount(k, minlength=63)
    for ki, sv, c in rows:
        assert sv == int(want_sv[ki]), (ki, sv, int(want_sv[ki]))
        assert c == int(want_c[ki])
    print(f"1. group-by {n} rows @ cap {cap} (beyond-2^24 extraction): OK "
          f"({dt*1e3:.0f} ms incl. compile)", file=sys.stderr)

    # --- 2. NOT_UNIQUE join at ~95% of out_capacity ------------------
    n_probe = (8_000_000 // scale)
    n_keys = 100_000 // scale
    dup = 3
    fk = rng.integers(0, n_keys, n_probe).astype(np.int64)
    probe = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("pv", DataType.INT64, False)),
        {"fk": fk, "pv": np.arange(n_probe)})
    build = Table.from_data(
        TupleSchema.of(("bk", DataType.INT64, False),
                       ("bv", DataType.INT64, False)),
        {"bk": np.repeat(np.arange(n_keys), dup),
         "bv": np.arange(n_keys * dup)})
    exact = n_probe * dup
    cap95 = int(exact / 0.95)
    t0 = time.perf_counter()
    out = execute(HashJoin(
        JoinType.INNER, ["fk"], ["bk"], ScanTable(probe), ScanTable(build),
        KeyUniqueness.NOT_UNIQUE, out_capacity=cap95))
    n_out = int(out.num_rows)
    # order-insensitive checksum of the expanded rows
    got_pv = np.sort(np.asarray(out.columns["pv"].values)[:n_out])
    dt = time.perf_counter() - t0
    assert n_out == exact, (n_out, exact)
    want_pv = np.sort(np.repeat(np.arange(n_probe), dup))
    assert np.array_equal(got_pv, want_pv)
    print(f"2. NOT_UNIQUE join {n_probe}x{dup} at 95% cap: OK "
          f"({dt*1e3:.0f} ms incl. compile)", file=sys.stderr)

    # --- 3. zipf-skewed NOT_UNIQUE near capacity ----------------------
    zipf = np.minimum(rng.zipf(1.3, n_probe) - 1, n_keys - 1).astype(
        np.int64)
    probe_z = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False),
                       ("pv", DataType.INT64, False)),
        {"fk": zipf, "pv": np.arange(n_probe)})
    exact_z = n_probe * dup
    t0 = time.perf_counter()
    out = execute(HashJoin(
        JoinType.INNER, ["fk"], ["bk"], ScanTable(probe_z),
        ScanTable(build), KeyUniqueness.NOT_UNIQUE,
        out_capacity=int(exact_z / 0.93)))
    n_out = int(out.num_rows)
    dt = time.perf_counter() - t0
    assert n_out == exact_z, (n_out, exact_z)
    s_got = int(np.asarray(out.columns["bv"].values)[:n_out].sum())
    bv_per_key = np.arange(n_keys * dup).reshape(n_keys, dup).sum(axis=1)
    s_want = int(bv_per_key[zipf].sum())
    assert s_got == s_want, (s_got, s_want)
    print(f"3. zipf-1.3 NOT_UNIQUE join near cap: OK "
          f"({dt*1e3:.0f} ms incl. compile)", file=sys.stderr)
    print("stress_edges: all OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    main(ap.parse_args().small)

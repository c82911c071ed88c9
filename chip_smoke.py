#!/usr/bin/env python3
"""Smoke run of the query engine on NVIDIA GPUs.

Drives the engine through its user entry points (``execute``,
``compile_plan``) over every operator route at real sizes, in one
process, and compares each result with a plain numpy reference:

  device    the card (nvidia-smi name and power limit), JAX and XLA_FLAGS
  kernels   segment_reduce_multi at 8M rows, K in {64, 2048}, all modes
            fused, for each implementation, timed and checked
  headline  bench.py's filter -> join -> group-by(64) -> sort, 8M x 1M
  routes    Filter (f32 with -0.0/NaN, i64, f64, nullable), NOT_UNIQUE
            joins (dense CSR and merge probe, INNER and LEFT_OUTER),
            MergeUnionAll of 4M-row children, STRING-key group-by over
            dictionary expressions
  golden    the C++ reference engine's golden cases (tests/golden)
  scale     100M probe rows x 1M build rows, join -> group-by

Tolerances: counts, integer sums, MIN/MAX, row sets and order are exact;
an f32 SUM may differ from the float64 reference by 1e-5 * sum(|v|) of
its group (f32 sums accumulate in another order); DOUBLE columns use the
golden cases' own tolerances.

Usage:
  python chip_smoke.py             one card, every phase above
  python chip_smoke.py --chips 4   only the distributed pipeline over four
                                   cards (32M x 1M), checked against a
                                   one-card ``execute`` and numpy

Any mismatch or exception exits non-zero.  The last stdout line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

FULL = dict(
    kernel_rows=8_000_000, kernel_segments=(64, 2048),
    fact=8_000_000, dim=1_000_000,
    route_rows=2_000_000, join_probe=2_000_000, join_keys=100_000,
    join_dup=4, merge_child=4_000_000, string_rows=4_000_000,
    scale_probe=100_000_000, scale_build=1_000_000,
    dist_fact=32_000_000, dist_dim=1_000_000,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def f32_sum_ok(got, ref, abs_ref) -> bool:
    """|got - ref| <= 1e-5 * sum(|v|) per group."""
    got = np.asarray(got, np.float64)
    return bool(np.all(np.abs(got - ref) <= 1e-5 * abs_ref))


# ---------------------------------------------------------------- device

def phase_device():
    import jax

    from supersonic_jax.bench.device import card_line

    dev = jax.devices()[0]
    log(f"device: card {card_line()}")
    log(f"device: jax {jax.__version__}, {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


# --------------------------------------------------------------- kernels

def np_segment_reduce(values, mode, ids, k):
    """numpy reference of one segment_reduce request (sums in int64 /
    float64, wrapped back to the request's dtype)."""
    keep = (ids >= 0) & (ids < k)
    i, v = ids[keep], values[keep]
    if mode in ("sum", "count"):
        if v.dtype == np.float32:
            return np.bincount(i, weights=v.astype(np.float64), minlength=k)
        tot = np.zeros(k, np.int64)
        np.add.at(tot, i, v.astype(np.int64))
        return ((tot + 2**31) % 2**32 - 2**31).astype(np.int32)
    if v.dtype == np.float32:
        ident = np.inf if mode == "min" else -np.inf
    else:
        info = np.iinfo(v.dtype)
        ident = info.max if mode == "min" else info.min
    out = np.full(k, ident, v.dtype)
    if i.size:
        order = np.argsort(i, kind="stable")
        i, v = i[order], v[order]
        starts = np.flatnonzero(np.r_[True, i[1:] != i[:-1]])
        fn = np.minimum if mode == "min" else np.maximum
        out[i[starts]] = fn.reduceat(v, starts)
    return out


def phase_kernels(sz, rng, interpret=False):
    import jax
    import jax.numpy as jnp

    from supersonic_jax.bench.device import median_seconds
    from supersonic_jax.kernels import segment_reduce as sr

    n = sz["kernel_rows"]
    for k in sz["kernel_segments"]:
        chosen = sr.implementation(jax.devices()[0].platform, k)
        ids = rng.integers(-1, k + 1, n).astype(np.int32)
        vf = rng.standard_normal(n).astype(np.float32)
        vi = rng.integers(-2**30, 2**30, n).astype(np.int32)
        live = ((ids >= 0) & (ids < k)).astype(np.int32)
        pos = np.arange(n, dtype=np.int32)
        reqs = [(vf, "sum"), (vi, "sum"), (live, "count"), (vf, "min"),
                (vf, "max"), (vi, "min"), (vi, "max"), (pos, "min")]
        modes = [m for _, m in reqs]
        t0 = time.perf_counter()
        ref = [np_segment_reduce(v, m, ids, k) for v, m in reqs]
        np_s = time.perf_counter() - t0
        abs_f = np_segment_reduce(np.abs(vf), "sum", ids, k)
        d_ids = jnp.asarray(ids)
        d_vals = [jnp.asarray(v) for v, _ in reqs]
        log(f"kernels: K={k} n={n} numpy reference {np_s * 1e3:.3f} ms")
        for impl in sr.IMPLS:
            fn = jax.jit(lambda ids, *vs, impl=impl: sr.segment_reduce_multi(
                list(zip(vs, modes)), ids, k, impl=impl,
                interpret=interpret))
            compiled = fn.lower(d_ids, *d_vals).compile()
            if impl == chosen:
                log(f"kernels: K={k} memory_analysis({impl}): "
                    f"{compiled.memory_analysis()}")
            out = [np.asarray(o) for o in compiled(d_ids, *d_vals)]
            for (v, m), got, want in zip(reqs, out, ref):
                check(got.shape == (k,) and got.dtype == v.dtype,
                      f"kernels {impl} K={k} {m}: shape/dtype")
                if m == "sum" and v.dtype == np.float32:
                    check(f32_sum_ok(got, want, abs_f),
                          f"kernels {impl} K={k} f32 sum")
                else:
                    check(np.array_equal(got, want),
                          f"kernels {impl} K={k} {m} {v.dtype}")
            secs = median_seconds(compiled, d_ids, *d_vals)
            tag = " (chosen)" if impl == chosen else ""
            log(f"kernels: K={k} impl={impl}{tag} {secs * 1e3:.3f} ms "
                f"median of 5, {len(reqs)} fused requests")


# -------------------------------------------------------------- headline

def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def phase_headline(sz, rng):
    import jax

    import bench
    from supersonic_jax import execute
    from supersonic_jax.bench.device import median_seconds
    from supersonic_jax.ops.base import compile_plan

    fact, dim = bench.build_data(sz["fact"], sz["dim"], seed=42)
    plan = bench.headline_plan(fact, dim)
    sums, abs_sums, counts = bench.headline_reference(fact, dim)
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        out = execute(plan)
        rows = out.to_pylist()
        log(f"headline: execute {label} {time.perf_counter() - t0:.3f} s "
            f"({len(rows)} groups)")
        check(len(rows) == int(np.count_nonzero(counts)),
              "headline: group count")
        got_sv = np.array([r[1] for r in rows])
        check(bool(np.all(np.diff(got_sv) <= 0)), "headline: sort order")
        for g, sv, c in rows:
            check(c == counts[g], f"headline: COUNT of group {g}")
            check(f32_sum_ok([sv], sums[g], abs_sums[g]),
                  f"headline: SUM of group {g}")
    run, _bound, leaves = compile_plan(plan)
    compiled = jax.jit(run).lower(leaves).compile()
    log(f"headline: memory_analysis {compiled.memory_analysis()}")
    secs = median_seconds(compiled, leaves)
    log(f"headline: compiled plan {secs * 1e3:.3f} ms median of 5 "
        f"({sz['fact'] / secs / 1e6:.1f} M rows/s); "
        f"peak_bytes_in_use {_peak_bytes()}")


# ---------------------------------------------------------------- routes

def _cols(table):
    """Live rows as {name: (values, valid)} numpy arrays."""
    n = int(table.num_rows)
    out = {}
    for a in table.schema:
        c = table.columns[a.name]
        vals = np.asarray(c.values)[:n]
        valid = (np.ones(n, bool) if c.valid is None
                 else np.asarray(c.valid)[:n])
        out[a.name] = (vals, valid)
    return out


def _same_bits(got, want, what):
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape {got.dtype}{got.shape} vs "
          f"{want.dtype}{want.shape}")
    if got.dtype.kind == "f":
        iview = np.dtype(f"u{got.dtype.itemsize}")
        check(np.array_equal(got.view(iview), want.view(iview)),
              f"{what}: bits")
    else:
        check(np.array_equal(got, want), f"{what}: values")


def route_filter(sz, rng):
    from supersonic_jax import (ConstInt32, DataType, Filter, Greater,
                                ScanTable, Table, TupleSchema, col, execute)

    n = sz["route_rows"]
    f = rng.standard_normal(n).astype(np.float32)
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = np.nan
    data = {"p": rng.integers(-5, 5, n).astype(np.int32), "f": f,
            "i": rng.integers(-2**62, 2**62, n),
            "d": rng.standard_normal(n) * 1e300,
            "u": rng.integers(-1000, 1000, n).astype(np.int32)}
    u_valid = rng.random(n) < 0.7
    t = Table.from_arrays(
        TupleSchema.of(("p", DataType.INT32, False),
                       ("f", DataType.FLOAT, False),
                       ("i", DataType.INT64, False),
                       ("d", DataType.DOUBLE, False),
                       ("u", DataType.INT32, True)),
        data, {"u": u_valid}, n)
    out = _cols(execute(Filter(Greater(col("p"), ConstInt32(0)),
                               ScanTable(t))))
    keep = data["p"] > 0
    for name in ("p", "f", "i", "d"):
        _same_bits(out[name][0], data[name][keep], f"filter column {name}")
    uv, uok = out["u"]
    check(np.array_equal(uok, u_valid[keep]), "filter: nullable validity")
    check(np.array_equal(uv[uok], data["u"][keep][u_valid[keep]]),
          "filter: nullable values")
    log(f"routes: filter {n} rows -> {int(keep.sum())} ok")


def _np_join(lk, rk, left_outer):
    """(lhs row, rhs row or -1) pairs in the engine's order: lhs rows in
    order, each one's matches in rhs original order."""
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, "left")
    cnt = np.searchsorted(rs, lk, "right") - lo
    eff = np.maximum(cnt, 1) if left_outer else cnt
    li = np.repeat(np.arange(lk.shape[0]), eff)
    within = np.arange(li.shape[0]) - np.repeat(np.cumsum(eff) - eff, eff)
    matched = cnt[li] > 0
    ri = np.where(matched, order[np.minimum(lo[li] + within, rk.size - 1)],
                  -1)
    return li, ri


def route_joins(sz, rng):
    from supersonic_jax import (DataType, HashJoin, JoinType, KeyUniqueness,
                                ScanTable, Table, TupleSchema, execute)

    nl, keys, dup = sz["join_probe"], sz["join_keys"], sz["join_dup"]
    nr = keys * dup
    lk = rng.integers(0, keys * 3 // 2, nl).astype(np.int32)
    lv = rng.integers(-2**40, 2**40, nl)
    rk = rng.integers(0, keys, nr).astype(np.int32)
    rw = rng.integers(-1000, 1000, nr).astype(np.int32)
    rf = rng.standard_normal(nr).astype(np.float32)
    lhs = Table.from_data(TupleSchema.of(("lk", DataType.INT32, False),
                                         ("lv", DataType.INT64, False)),
                          {"lk": lk, "lv": lv})
    rhs = Table.from_data(TupleSchema.of(("rk", DataType.INT32, False),
                                         ("rw", DataType.INT32, False),
                                         ("rf", DataType.FLOAT, False)),
                          {"rk": rk, "rw": rw, "rf": rf})
    for jt in (JoinType.INNER, JoinType.LEFT_OUTER):
        left_outer = jt == JoinType.LEFT_OUTER
        li, ri = _np_join(lk, rk, left_outer)
        hit = ri >= 0
        for dense in (True, False):
            out = _cols(execute(HashJoin(
                jt, ["lk"], ["rk"], ScanTable(lhs), ScanTable(rhs),
                KeyUniqueness.NOT_UNIQUE, out_capacity=li.size + 1024,
                allow_dense_lookup=dense)))
            what = f"join {jt.value} {'dense' if dense else 'merge'}"
            _same_bits(out["lk"][0], lk[li], f"{what} lk")
            _same_bits(out["lv"][0], lv[li], f"{what} lv")
            for name, src in (("rk", rk), ("rw", rw), ("rf", rf)):
                vals, ok = out[name]
                check(np.array_equal(ok, hit), f"{what} {name} validity")
                _same_bits(vals[ok], src[ri[hit]], f"{what} {name}")
            log(f"routes: {what} {nl} x {nr} -> {li.size} rows ok")


def route_merge(sz, rng):
    from supersonic_jax import (DataType, MergeUnionAll, ScanTable, Table,
                                TupleSchema, execute)

    n = sz["merge_child"]
    schema = TupleSchema.of(("g", DataType.INT32, False),
                            ("v", DataType.FLOAT, False),
                            ("w", DataType.INT64, False))
    kids, parts = [], []
    for _ in range(2):
        g = rng.integers(0, 64, n).astype(np.int32)
        v = rng.random(n, dtype=np.float32)
        w = rng.integers(-2**40, 2**40, n)
        p = np.lexsort((-v, g))
        part = {"g": g[p], "v": v[p], "w": w[p]}
        parts.append(part)
        kids.append(ScanTable(Table.from_data(schema, part)))
    out = _cols(execute(MergeUnionAll([("g", True), ("v", False)], kids)))
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    perm = np.lexsort((-cat["v"], cat["g"]))  # stable: child order on ties
    for name in ("g", "v", "w"):
        _same_bits(out[name][0], cat[name][perm], f"merge column {name}")
    log(f"routes: merge 2 x {n} rows ok")


WORDS = ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliett", "kilo", "lima", "mike", "november",
         "oscar", "papa", "quebec", "romeo", "sierra", "tango", "uniform",
         "victor", "whiskey", "xray", "yankee", "zulu", "amber", "bronze",
         "copper", "dune", "ember", "flint", "granite", "harbor", "island",
         "jade", "krypton", "lagoon", "meadow", "nickel", "onyx", "prairie",
         "quartz", "ridge", "summit", "tundra", "umber", "valley",
         "willow", "zenith")


def route_strings(sz, rng):
    from supersonic_jax import (AggSpec, Aggregation, Compute, DataType,
                                GroupAggregate, Length, ScanTable, Table,
                                ToUpper, TupleSchema, col, execute)

    n = sz["string_rows"]
    widx = rng.integers(0, len(WORDS), n)
    v = rng.random(n, dtype=np.float32)
    words = np.array(WORDS, dtype=object)
    t = Table.from_data(TupleSchema.of(("k", DataType.STRING, False),
                                       ("v", DataType.FLOAT, False)),
                        {"k": list(words[widx]), "v": v})
    plan = GroupAggregate(
        ["ku"],
        [AggSpec(Aggregation.SUM, "v", "sv"),
         AggSpec(Aggregation.COUNT, None, "c"),
         AggSpec(Aggregation.MAX, "len", "ml")],
        Compute([ToUpper(col("k")).as_("ku"), Length(col("k")).as_("len"),
                 col("v")], ScanTable(t)))
    rows = execute(plan).to_pylist()
    _, first = np.unique(widx, return_index=True)
    seen = np.unique(widx)
    want_order = [WORDS[w].upper() for w in seen[np.argsort(first)]]
    check([r[0] for r in rows] == want_order,
          "strings: groups in first-appearance order")
    sums = np.bincount(widx, weights=v.astype(np.float64),
                       minlength=len(WORDS))
    counts = np.bincount(widx, minlength=len(WORDS))
    for ku, sv, c, ml in rows:
        w = WORDS.index(ku.lower())
        check(c == counts[w], f"strings: COUNT of {ku}")
        check(ml == len(ku), f"strings: MAX(LENGTH) of {ku}")
        check(f32_sum_ok([sv], sums[w], sums[w]), f"strings: SUM of {ku}")
    log(f"routes: STRING group-by {n} rows -> {len(rows)} groups ok")


def phase_routes(sz, rng):
    route_filter(sz, rng)
    route_joins(sz, rng)
    route_merge(sz, rng)
    route_strings(sz, rng)


# ---------------------------------------------------------------- golden

def phase_golden():
    spec = importlib.util.spec_from_file_location(
        "golden_cases", HERE / "tests" / "test_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.environ["TZ"] = "UTC"  # the goldens' *Local date semantics
    time.tzset()
    names = [n for n in dir(mod) if n.startswith("test_golden_")]
    check(len(names) > 0, "golden: no cases found")
    for name in names:
        getattr(mod, name)()
    log(f"golden: {len(names)} reference-engine cases ok")


# ----------------------------------------------------------------- scale

def phase_scale(sz, rng):
    import jax

    from supersonic_jax import (AggSpec, Aggregation, DataType,
                                GroupAggregate, GroupAggregateOptions,
                                HashJoin, JoinType, KeyUniqueness, Projector,
                                ScanTable, Table, TupleSchema, execute)
    from supersonic_jax.ops.base import compile_plan

    n, m = sz["scale_probe"], sz["scale_build"]
    fk = rng.integers(0, m, n).astype(np.int32)
    v = rng.random(n, dtype=np.float32)
    g = rng.integers(0, 64, m).astype(np.int32)
    fact = Table.from_data(TupleSchema.of(("fk", DataType.INT32, False),
                                          ("v", DataType.FLOAT, False)),
                           {"fk": fk, "v": v})
    dim = Table.from_data(TupleSchema.of(("pk", DataType.INT32, False),
                                         ("g", DataType.INT32, False)),
                          {"pk": np.arange(m, dtype=np.int32), "g": g})
    plan = GroupAggregate(
        ["g"], [AggSpec(Aggregation.SUM, "v", "sv"),
                AggSpec(Aggregation.COUNT, None, "c")],
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("g")),
        GroupAggregateOptions(estimated_result_row_count=64))
    run, _bound, leaves = compile_plan(plan)
    log(f"scale: memory_analysis "
        f"{jax.jit(run).lower(leaves).compile().memory_analysis()}")
    t0 = time.perf_counter()
    rows = execute(plan).to_pylist()
    log(f"scale: execute {n} x {m} {time.perf_counter() - t0:.3f} s; "
        f"peak_bytes_in_use {_peak_bytes()}")
    gj = g[fk]
    sums = np.bincount(gj, weights=v.astype(np.float64), minlength=64)
    counts = np.bincount(gj, minlength=64)
    check(len(rows) == int(np.count_nonzero(counts)), "scale: group count")
    for gid, sv, c in rows:
        check(c == counts[gid], f"scale: COUNT of group {gid}")
        check(f32_sum_ok([sv], sums[gid], sums[gid]),
              f"scale: SUM of group {gid}")
    log(f"scale: {len(rows)} groups ok")


# ----------------------------------------------------------- distributed

def phase_distributed(sz, n_devices):
    from supersonic_jax import (AggSpec, Aggregation, Const, DataType,
                                Filter, GroupAggregate, HashJoin, JoinType,
                                KeyUniqueness, ScanTable, Table, TupleSchema,
                                col, execute)
    from supersonic_jax.parallel import (PIPELINE_THRESHOLD, dryrun,
                                         pipeline_data)

    n, m = sz["dist_fact"], sz["dist_dim"]
    t0 = time.perf_counter()
    got = dryrun(n_devices, fact_rows=n, dim_rows=m)
    log(f"distributed: {n_devices} devices, {n} x {m} pipeline + ring, "
        f"skew and overflow checks vs numpy ok "
        f"({time.perf_counter() - t0:.3f} s)")
    fk, v, g = pipeline_data(n, m)
    fact = Table.from_data(TupleSchema.of(("fk", DataType.INT32, False),
                                          ("v", DataType.FLOAT, False)),
                           {"fk": fk, "v": v})
    dim = Table.from_data(TupleSchema.of(("pk", DataType.INT32, False),
                                         ("g", DataType.INT32, False)),
                          {"pk": np.arange(m, dtype=np.int32), "g": g})
    single = execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.SUM, "v", "sv"),
                AggSpec(Aggregation.COUNT, None, "c")],
        HashJoin(JoinType.INNER, ["fk"], ["pk"],
                 Filter(col("v") > Const(PIPELINE_THRESHOLD,
                                         DataType.FLOAT), ScanTable(fact)),
                 ScanTable(dim), KeyUniqueness.UNIQUE)))
    one = {int(r[0]): (r[1], int(r[2])) for r in single.to_pylist()}
    check(set(one) == set(got), "distributed vs one card: group set")
    keep = v > PIPELINE_THRESHOLD
    abs_sums = np.bincount(g[fk[keep]], weights=v[keep].astype(np.float64),
                           minlength=max(one) + 1)
    for gid, (sv, c) in one.items():
        check(c == got[gid][1], f"distributed vs one card: COUNT {gid}")
        check(abs(sv - got[gid][0]) <= 2e-5 * abs_sums[gid],
              f"distributed vs one card: SUM {gid}")
    log(f"distributed: matches one-card execute ({len(one)} groups)")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import jax

    from supersonic_jax.bench.device import (configure_compile_cache,
                                             require_gpu)

    dev = require_gpu()
    log(f"compile cache: {configure_compile_cache()}")
    check(len(jax.devices()) >= args.chips,
          f"--chips {args.chips} needs {args.chips} GPUs, found "
          f"{len(jax.devices())}")
    sz = dict(FULL)
    rng = np.random.default_rng(0)
    phase_device()
    if args.chips == 4:
        phases = [("distributed", lambda: phase_distributed(sz, 4))]
    else:
        phases = [("kernels", lambda: phase_kernels(sz, rng)),
                  ("headline", lambda: phase_headline(sz, rng)),
                  ("routes", lambda: phase_routes(sz, rng)),
                  ("golden", phase_golden),
                  ("scale", lambda: phase_scale(sz, rng))]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

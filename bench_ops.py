"""Per-operator benchmarks on one GPU: filter, group-by, sort, joins,
merge, string keys and expressions at 8M rows (1M-row build sides).

Each row is one plan compiled once (``compile_plan`` + ``jax.jit``) and
timed as the median of 5 warm runs, each ended by ``block_until_ready``.
Every line names the card and its power limit.  Exits non-zero when JAX
finds no GPU.

Usage: ``python bench_ops.py``
"""
import sys

import numpy as np


def main(n=8_000_000, m=1_000_000):
    import jax

    from supersonic_jax.bench.device import (card_line,
                                             configure_compile_cache,
                                             median_seconds, require_gpu)

    configure_compile_cache()
    require_gpu()
    card = card_line()
    from supersonic_jax import (AggSpec, Aggregation, Const, DataType, Filter,
                                GroupAggregate, GroupAggregateOptions,
                                HashJoin, JoinType, KeyUniqueness, Projector,
                                ScanTable, Sort, SortKey, Table, TupleSchema,
                                col)
    from supersonic_jax.ops.base import compile_plan

    rng = np.random.default_rng(42)
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False),
                       ("g", DataType.INT32, False)),
        {"fk": rng.integers(0, m, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32),
         "g": rng.integers(0, 64, n).astype(np.int32)})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("w", DataType.INT32, False)),
        {"pk": np.arange(m, dtype=np.int32),
         "w": rng.integers(0, 64, m).astype(np.int32)})

    def bench(name, plan, rows):
        run, _bound, leaves = compile_plan(plan)
        compiled = jax.jit(run).lower(leaves).compile()
        secs = median_seconds(compiled, leaves)
        print(f"{name:<28} {secs*1e3:9.3f} ms "
              f"{rows/secs/1e6:10.1f} M rows/s  [{card}]", file=sys.stderr)
        return secs

    results = {}
    results["filter"] = bench(
        "filter 8M",
        Filter(col("v") > Const(0.5, DataType.FLOAT), ScanTable(fact)), n)
    fact_d = Table.from_data(
        TupleSchema.of(("v", DataType.FLOAT, False),
                       ("d", DataType.DOUBLE, False),
                       ("g", DataType.INT32, False)),
        {"v": rng.random(n, dtype=np.float32),
         "d": rng.random(n) * 2e3 - 1e3,
         "g": rng.integers(0, 64, n).astype(np.int32)})
    results["filter_f64"] = bench(
        "filter 8M (DOUBLE payload)",
        Filter(col("v") > Const(0.5, DataType.FLOAT), ScanTable(fact_d)), n)
    results["groupby"] = bench(
        "groupby 8M->64",
        GroupAggregate(["g"], [AggSpec(Aggregation.SUM, "v", "sv")],
                       ScanTable(fact),
                       GroupAggregateOptions(estimated_result_row_count=64)), n)
    results["groupby_hi"] = bench(
        "groupby 8M->1M keys",
        GroupAggregate(["fk"], [AggSpec(Aggregation.SUM, "v", "sv")],
                       ScanTable(fact),
                       GroupAggregateOptions(estimated_result_row_count=m)), n)
    results["sort"] = bench(
        "sort 8M by (g,v)",
        Sort([("g", True), ("v", False)], ScanTable(fact)), n)
    results["join"] = bench(
        "join 8M x 1M",
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("w")), n)
    results["join_merge"] = bench(
        "join 8M x 1M (merge probe)",
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("w"),
                 allow_dense_lookup=False), n)
    results["join_multi"] = bench(
        "join 8M x 1M NOT_UNIQUE",
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(dim), KeyUniqueness.NOT_UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("w"),
                 out_capacity=n), n)
    # wide build side: 6 projected rhs columns ride the fat LUT as packed
    # lanes of one gather
    wide = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       *[(f"w{i}", DataType.INT32, False)
                         for i in range(6)]),
        {"pk": np.arange(m, dtype=np.int32),
         **{f"w{i}": rng.integers(0, 64, m).astype(np.int32)
            for i in range(6)}})
    results["join_wide"] = bench(
        "join 8M x 1M (6 rhs cols)",
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(wide), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named(*[f"w{i}" for i in range(6)])), n)

    # --- NOT_UNIQUE dup~8, LEFT_OUTER, string-key group-by,
    # merge-union (rows of refbuild/bin/baseline_bench too) ---
    dup_keys = m // 8
    dim8 = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("w", DataType.INT32, False)),
        {"pk": (np.arange(m, dtype=np.int32) // 8),
         "w": rng.integers(0, 64, m).astype(np.int32)})
    fact8 = Table.from_data(
        fact.schema,
        {"fk": rng.integers(0, dup_keys, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32),
         "g": rng.integers(0, 64, n).astype(np.int32)})
    results["join_dup8"] = bench(
        "join 8M NOT_UNIQUE dup8",
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact8),
                 ScanTable(dim8), KeyUniqueness.NOT_UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("w"),
                 out_capacity=8 * n), n)
    fact2m = Table.from_data(
        fact.schema,
        {"fk": rng.integers(0, 2 * m, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32),
         "g": rng.integers(0, 64, n).astype(np.int32)})
    results["join_left"] = bench(
        "join 8M LEFT_OUTER",
        HashJoin(JoinType.LEFT_OUTER, ["fk"], ["pk"], ScanTable(fact2m),
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("w")), n)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
             "golf", "hotel", "india", "juliett", "kilo", "lima", "mike",
             "november", "oscar", "papa", "quebec", "romeo", "sierra",
             "tango", "uniform", "victor", "whiskey", "xray", "yankee",
             "zulu", "amber", "bronze", "copper", "dune", "ember",
             "flint", "granite", "harbor", "island", "jade", "krypton",
             "lagoon", "meadow", "nickel", "onyx", "prairie", "quartz",
             "ridge", "summit", "tundra", "umber", "valley", "willow",
             "zenith"]
    warr = np.array(words, dtype=object)
    fact_str = Table.from_data(
        TupleSchema.of(("k", DataType.STRING, False),
                       ("v", DataType.FLOAT, False)),
        {"k": list(warr[rng.integers(0, 50, n)]),
         "v": rng.random(n, dtype=np.float32)})
    results["groupby_str"] = bench(
        "groupby_str 8M->50",
        GroupAggregate(["k"], [AggSpec(Aggregation.SUM, "v", "sv")],
                       ScanTable(fact_str),
                       GroupAggregateOptions(estimated_result_row_count=64)), n)
    # expression-engine workload: the reference's
    # own benchmark example #2 — Compute(c0 * (Sin(c2) + Exp(c1))) over
    # (INT32, INT64, DOUBLE), operation_example.cc:44-50 (value ranges
    # kept finite; mirrored in refbuild/baseline_bench.cc "compute 8M")
    from supersonic_jax import Compute
    from supersonic_jax.exprs import Exp, Sin

    comp = Table.from_data(
        TupleSchema.of(("c0", DataType.INT32, False),
                       ("c1", DataType.INT64, False),
                       ("c2", DataType.DOUBLE, False)),
        {"c0": rng.integers(0, 1000, n).astype(np.int32),
         "c1": rng.integers(-50, 51, n),
         "c2": rng.random(n)})
    results["compute"] = bench(
        "compute 8M c0*(sin+exp)",
        Compute([(col("c0") * (Sin(col("c2")) + Exp(col("c1"))))
                 .as_("out")], ScanTable(comp)), n)

    # STRING-key join: 8M probe x 1M-distinct-string build (dictionary
    # codes ride the dense fat-LUT path); C++ row: "join_str 8M x 1M"
    keys_m = np.array([f"key_{i:07d}" for i in range(m)])
    fact_sj = Table.from_data(
        TupleSchema.of(("fk", DataType.STRING, False),
                       ("v", DataType.FLOAT, False)),
        {"fk": list(keys_m[rng.integers(0, m, n)]),
         "v": rng.random(n, dtype=np.float32)})
    dim_str = Table.from_data(
        TupleSchema.of(("pk", DataType.STRING, False),
                       ("w", DataType.INT32, False)),
        {"pk": list(keys_m),
         "w": rng.integers(0, 64, m).astype(np.int32)})
    results["join_str"] = bench(
        "join_str 8M x 1M",
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact_sj),
                 ScanTable(dim_str), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("w")), n)

    from supersonic_jax import MergeUnionAll

    half = n // 2
    ga = rng.integers(0, 64, half).astype(np.int32)
    gb = rng.integers(0, 64, half).astype(np.int32)
    va = rng.random(half, dtype=np.float32)
    vb = rng.random(half, dtype=np.float32)
    pa = np.lexsort((-va, ga))
    pb = np.lexsort((-vb, gb))
    sorted_a = Table.from_data(
        TupleSchema.of(("g", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"g": ga[pa], "v": va[pa]})
    sorted_b = Table.from_data(sorted_a.schema, {"g": gb[pb], "v": vb[pb]})
    results["merge_union"] = bench(
        "merge_union 2x4M",
        MergeUnionAll([("g", True), ("v", False)],
                      [ScanTable(sorted_a), ScanTable(sorted_b)]), n)
    return results


if __name__ == "__main__":
    main()

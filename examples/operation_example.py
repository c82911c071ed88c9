"""The reference benchmark example workloads, on this engine.

Mirrors supersonic/benchmark/examples/operation_example.cc
:24-90: (1) 1M-row GROUP BY over 50 string keys with MAX; (2) Compute
``col0 * (sin(col2) + exp(col1))``; (3) two-key sort (ASC, DESC); (4)
merge-union of two sorted inputs; (5) LEFT_OUTER unique hash join of a
sort output against a group output.  Each workload runs under the
benchmark harness (per-node stats + GraphViz DOT, reference: DOTDrawer).

Usage: python examples/operation_example.py [--rows N] [--out DIR] [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_tables(rows: int):
    from supersonic_jax import DataType, Table, TupleSchema

    rng = np.random.default_rng(7)
    keys = [f"key_{i:02d}" for i in range(50)]
    t = Table.from_data(
        TupleSchema.of(("key", DataType.STRING, False),
                       ("col0", DataType.DOUBLE, False),
                       ("col1", DataType.DOUBLE, False),
                       ("col2", DataType.DOUBLE, False),
                       ("id", DataType.INT32, False)),
        {"key": [keys[i] for i in rng.integers(0, 50, rows)],
         "col0": rng.random(rows),
         "col1": rng.random(rows),
         "col2": rng.random(rows),
         "id": np.arange(rows, dtype=np.int32)})
    return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--out", default=None, help="DOT output directory")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from supersonic_jax import (AggSpec, Aggregation, Compute, Cos, Exp,
                                GroupAggregate, GroupAggregateOptions,
                                HashJoin, JoinType, KeyUniqueness,
                                MergeUnionAll, Projector, ScanTable, Sin,
                                Sort, SortKey, col)
    from supersonic_jax.bench import benchmark_plan, format_stats, save_dot

    t = build_tables(args.rows)

    # (1) group-by: 50 string keys, MAX(col0)
    group = GroupAggregate(
        ["key"], [AggSpec(Aggregation.MAX, "col0", "max0")], ScanTable(t),
        GroupAggregateOptions(estimated_result_row_count=64))
    # (2) compute: col0 * (sin(col2) + exp(col1))
    compute = Compute(
        (col("col0") * (Sin(col("col2")) + Exp(col("col1")))).as_("expr"),
        ScanTable(t))
    # (3) two-key sort ASC, DESC
    two_key_sort = Sort([("key", True), SortKey("col0", ascending=False)],
                        ScanTable(t))
    # (4) merge-union of two sorted inputs
    union = MergeUnionAll(
        ["col0"], [Sort(["col0"], ScanTable(t)), Sort(["col0"], ScanTable(t))])
    # (5) LEFT_OUTER unique join: sorted rows x group output
    join = HashJoin(
        JoinType.LEFT_OUTER, ["key"], ["key"],
        two_key_sort, group, KeyUniqueness.UNIQUE,
        lhs_projector=Projector.named("key", "col0"),
        rhs_projector=Projector([("max0", "group_max")]))

    for name, plan in [("group", group), ("compute", compute),
                       ("sort", two_key_sort), ("union", union),
                       ("join", join)]:
        stats = benchmark_plan(plan, iters=1)
        print(f"\n=== {name} ===", file=sys.stderr)
        print(format_stats(stats), file=sys.stderr)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            save_dot(stats, os.path.join(args.out, f"{name}.dot"), name)
    print("ok")


if __name__ == "__main__":
    main()

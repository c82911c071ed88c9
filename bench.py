"""Headline benchmark: filter -> hash-join -> group-by -> sort on one GPU.

The query: 8M fact rows (fk INT32, v FLOAT) filtered on ``v > 0.5``,
joined UNIQUE on fk = pk with a 1M-row dimension table (pk INT32, g
INT32), grouped by g (64 groups) with SUM(v) and COUNT(*), sorted by the
sum descending.  The same pipeline through the C++ reference engine is
``refbuild/bin/baseline_bench``'s "pipeline" row (refbuild/README.md).

Prints the card and its power limit, then ONE JSON line:
``{"metric", "value", "unit", "device"}`` — rows/s of the compiled plan,
median of 5 warm runs, each ended by ``block_until_ready``.  Exits
non-zero when JAX finds no GPU.

Usage: ``python bench.py``
"""
import json
import sys
import time

import numpy as np

FACT_ROWS = 8_000_000
DIM_ROWS = 1_000_000
GROUPS = 64


def build_data(fact_rows=FACT_ROWS, dim_rows=DIM_ROWS, seed=42):
    rng = np.random.default_rng(seed)
    fact = {
        "fk": rng.integers(0, dim_rows, fact_rows).astype(np.int32),
        "v": rng.random(fact_rows, dtype=np.float32),
    }
    dim = {
        "pk": np.arange(dim_rows, dtype=np.int32),
        "g": rng.integers(0, GROUPS, dim_rows).astype(np.int32),
    }
    return fact, dim


def headline_plan(fact, dim):
    from supersonic_jax import (AggSpec, Aggregation, Const, DataType, Filter,
                                GroupAggregate, GroupAggregateOptions,
                                HashJoin, JoinType, KeyUniqueness, Projector,
                                ScanTable, Sort, SortKey, Table, TupleSchema,
                                col)

    fact_t = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)), fact)
    dim_t = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)), dim)
    # SUM keeps the input type (FLOAT), matching the reference's default
    # output-type rule (aggregation_operators.h)
    return Sort(
        [SortKey("sv", ascending=False)],
        GroupAggregate(
            ["g"],
            [AggSpec(Aggregation.SUM, "v", "sv"),
             AggSpec(Aggregation.COUNT, None, "c")],
            HashJoin(JoinType.INNER, ["fk"], ["pk"],
                     Filter(col("v") > Const(0.5, DataType.FLOAT),
                            ScanTable(fact_t)),
                     ScanTable(dim_t), KeyUniqueness.UNIQUE,
                     lhs_projector=Projector.named("v"),
                     rhs_projector=Projector.named("g")),
            GroupAggregateOptions(estimated_result_row_count=GROUPS),
        ))


def headline_reference(fact, dim):
    """numpy float64 reference per group: (sum of v, sum of |v|, count)."""
    keep = fact["v"] > 0.5
    g = dim["g"][fact["fk"][keep]]  # pk is arange => direct index join
    v = fact["v"][keep].astype(np.float64)
    sums = np.bincount(g, weights=v, minlength=GROUPS)
    abs_sums = np.bincount(g, weights=np.abs(v), minlength=GROUPS)
    counts = np.bincount(g, minlength=GROUPS)
    return sums, abs_sums, counts


def main():
    import jax

    from supersonic_jax.bench.device import (card_line,
                                             configure_compile_cache,
                                             median_seconds, require_gpu)
    from supersonic_jax.ops.base import compile_plan

    configure_compile_cache()
    dev = require_gpu()
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    fact, dim = build_data()
    run, _bound, leaves = compile_plan(headline_plan(fact, dim))
    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(leaves).compile()
    print(f"compile: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    secs = median_seconds(compiled, leaves)
    print(f"pipeline: {secs * 1e3:.3f} ms  [{card}]", file=sys.stderr)
    print(json.dumps({
        "metric": "pipeline_rows_per_s",
        "value": FACT_ROWS / secs,
        "unit": "rows/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()

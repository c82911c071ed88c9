"""Memory-quota semantics for aggregation (reference: aggregate.h:160-205,
memory.h:465, aggregate_groups.cc:420-427).

memory_quota bytes map to an aggregated-result row budget at bind.  Strict
GroupAggregate raises ERROR_MEMORY_EXCEEDED-style when the result exceeds
the budget; BestEffortGroupAggregate degrades to a correct PARTIAL
aggregate (first budget-many keys fully aggregated, later rows passed
through as singleton groups) and emits a warning — the reference's
pregroup contract (aggregate.h:233-246).
"""
import warnings

import numpy as np
import pytest

from supersonic_jax import (AggSpec, Aggregation, BestEffortGroupAggregate,
                            DataType, GroupAggregate, GroupAggregateOptions,
                            ScanTable, Table, TupleSchema, execute)
from supersonic_jax.exprs.base import EvaluationError
from supersonic_jax.ops.aggregate import _quota_rows

SUM, MIN, MAX, COUNT = (Aggregation.SUM, Aggregation.MIN, Aggregation.MAX,
                        Aggregation.COUNT)


def make_table(n=100, keys=25, seed=3):
    rng = np.random.default_rng(seed)
    return Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"k": rng.integers(0, keys, n), "v": rng.integers(0, 50, n)})


def out_row_width():
    # k INT64 (8) + sv INT64 nullable (8 + 1 mask byte)
    return 17


def test_quota_rows_mapping():
    schema = TupleSchema.of(("k", DataType.INT64, False),
                            ("sv", DataType.INT64, True))
    assert _quota_rows(17 * 10, schema) == 10
    assert _quota_rows(5, schema) == 1  # floor of one row


def test_strict_quota_raises_memory_exceeded():
    t = make_table(n=100, keys=25)
    opts = GroupAggregateOptions(memory_quota=out_row_width() * 8)  # 8 rows
    plan = GroupAggregate(["k"], [AggSpec(SUM, "v", "sv")], ScanTable(t),
                          opts)
    with pytest.raises(EvaluationError, match="overflow"):
        execute(plan)


def test_strict_quota_fits_is_exact():
    t = make_table(n=100, keys=25)
    opts = GroupAggregateOptions(memory_quota=out_row_width() * 64)
    got = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "sv")],
                                 ScanTable(t), opts))
    want = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "sv")],
                                  ScanTable(t)))
    assert sorted(got.to_pylist()) == sorted(want.to_pylist())


def test_best_effort_quota_degrades_with_warning_and_stays_correct():
    t = make_table(n=120, keys=30)
    quota_rows = 10
    opts = GroupAggregateOptions(memory_quota=out_row_width() * quota_rows)
    spec = [AggSpec(SUM, "v", "sv"), AggSpec(COUNT, "v", "cv"),
            AggSpec(MIN, "v", "mv"), AggSpec(MAX, "v", "xv")]
    plan = BestEffortGroupAggregate(["k"], spec, ScanTable(t), opts)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        partial = execute(plan)
    assert any("best-effort" in str(w.message) for w in rec)

    # the partial result is NOT key-unique but IS a correct partial
    # aggregate: re-aggregating with the combine algebra reproduces the
    # exact answer (COUNT combines via SUM — aggregate_groups.cc:545-553)
    rows = partial.to_pylist()
    assert len(rows) > quota_rows  # degradation actually happened
    combined = {}
    for k, sv, cv, mv, xv in rows:
        if k not in combined:
            combined[k] = [0, 0, None, None]
        c = combined[k]
        c[0] += sv if sv is not None else 0
        c[1] += cv
        if mv is not None:
            c[2] = mv if c[2] is None else min(c[2], mv)
        if xv is not None:
            c[3] = xv if c[3] is None else max(c[3], xv)
    exact = execute(GroupAggregate(["k"], spec, ScanTable(t)))
    for k, sv, cv, mv, xv in exact.to_pylist():
        assert combined[k] == [sv, cv, mv, xv], f"key {k}"


def test_best_effort_without_quota_is_exact():
    t = make_table()
    spec = [AggSpec(SUM, "v", "sv")]
    got = execute(BestEffortGroupAggregate(["k"], spec, ScanTable(t)))
    want = execute(GroupAggregate(["k"], spec, ScanTable(t)))
    assert sorted(got.to_pylist()) == sorted(want.to_pylist())


def test_best_effort_enforce_quota_is_strict():
    t = make_table(n=100, keys=25)
    opts = GroupAggregateOptions(memory_quota=out_row_width() * 4,
                                 enforce_quota=True)
    plan = BestEffortGroupAggregate(["k"], [AggSpec(SUM, "v", "sv")],
                                    ScanTable(t), opts)
    with pytest.raises(EvaluationError, match="overflow"):
        execute(plan)


# --- HybridGroupAggregate: beyond-quota spill path (reference:
# aggregate_groups.cc:1146, design :491-534) ---------------------------------

from supersonic_jax import HybridGroupAggregate  # noqa: E402


def _as_sorted_rows(t):
    return sorted(t.to_pylist())


def test_hybrid_spills_beyond_quota_to_full_result(tmp_path):
    """Distinct-key set far exceeds the quota: the strict operator raises,
    Hybrid completes via chunked pregroup -> disk sort -> clustered
    combine (COUNT recombined via SUM, aggregate_groups.cc:545-590)."""
    t = make_table(n=900, keys=300)
    specs = [AggSpec(SUM, "v", "sv"), AggSpec(COUNT, "v", "c"),
             AggSpec(MIN, "v", "mn"), AggSpec(MAX, "v", "mx")]
    quota = out_row_width() * 40  # ~40 rows, 300 keys needed
    with pytest.raises(EvaluationError):
        execute(GroupAggregate(["k"], specs, ScanTable(t),
                               GroupAggregateOptions(memory_quota=quota)))
    got = execute(HybridGroupAggregate(
        ["k"], specs, ScanTable(t),
        GroupAggregateOptions(memory_quota=quota),
        temporary_directory_prefix=str(tmp_path)))
    want = execute(GroupAggregate(["k"], specs, ScanTable(t)))
    assert _as_sorted_rows(got) == _as_sorted_rows(want)


def test_hybrid_without_quota_is_plain_group_aggregate():
    t = make_table(n=300, keys=40)
    got = execute(HybridGroupAggregate(["k"], [AggSpec(SUM, "v", "sv")],
                                       ScanTable(t)))
    want = execute(GroupAggregate(["k"], [AggSpec(SUM, "v", "sv")],
                                  ScanTable(t)))
    assert got.to_pylist() == want.to_pylist()


def test_hybrid_distinct_rides_extended_key(tmp_path):
    """DISTINCT aggregates join the pregroup key (the reference's
    hybrid-group transform, hybrid_group_utils.h:20-66): COUNT DISTINCT /
    SUM DISTINCT stay exact through the spill."""
    rng = np.random.default_rng(11)
    n = 700
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("v", DataType.INT64, False)),
        {"k": rng.integers(0, 120, n), "v": rng.integers(0, 12, n)})
    specs = [AggSpec(COUNT, "v", "cd", distinct=True),
             AggSpec(Aggregation.SUM, "v", "sd", distinct=True),
             AggSpec(SUM, "v", "sv"),
             AggSpec(COUNT, "v", "c")]
    got = execute(HybridGroupAggregate(
        ["k"], specs, ScanTable(t),
        GroupAggregateOptions(memory_quota=out_row_width() * 40),
        temporary_directory_prefix=str(tmp_path)))
    want = execute(GroupAggregate(["k"], specs, ScanTable(t)))
    assert _as_sorted_rows(got) == _as_sorted_rows(want)


def test_hybrid_string_key_and_nullable_input(tmp_path):
    rng = np.random.default_rng(5)
    n = 500
    words = [f"key{i:03d}" for i in range(90)]
    vals = [None if rng.random() < 0.2 else int(rng.integers(0, 100))
            for _ in range(n)]
    t = Table.from_data(
        TupleSchema.of(("k", DataType.STRING, False),
                       ("v", DataType.INT64, True)),
        {"k": [words[i] for i in rng.integers(0, 90, n)], "v": vals})
    specs = [AggSpec(SUM, "v", "sv"), AggSpec(COUNT, "v", "c")]
    got = execute(HybridGroupAggregate(
        ["k"], specs, ScanTable(t),
        GroupAggregateOptions(memory_quota=30 * 20),
        temporary_directory_prefix=str(tmp_path)))
    want = execute(GroupAggregate(["k"], specs, ScanTable(t)))
    assert _as_sorted_rows(got) == _as_sorted_rows(want)


def test_hybrid_empty_input(tmp_path):
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("v", DataType.INT64, False)), {"k": [], "v": []})
    got = execute(HybridGroupAggregate(
        ["k"], [AggSpec(SUM, "v", "sv")], ScanTable(t),
        GroupAggregateOptions(memory_quota=64),
        temporary_directory_prefix=str(tmp_path)))
    assert got.to_pylist() == []


def test_hybrid_bind_is_pure():
    """Binding a spilling plan must NOT execute the spill (the
    reference's hybrid cursor makes CreateCursor cheap and drains its
    child at the first Next(), aggregate_groups.cc:332-431): the
    ExternalSorter runs only at execution (prepare_leaves) time."""
    import numpy as np

    import supersonic_jax.io.external as EXT
    from supersonic_jax import (AggSpec, Aggregation, DataType,
                                GroupAggregateOptions, HybridGroupAggregate,
                                ScanTable, Table, TupleSchema)
    from supersonic_jax.ops.base import compile_plan, prepare_leaves
    from supersonic_jax.ops.sort import SortWithTempDirPrefix

    calls = []
    orig = EXT.ExternalSorter.__init__

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    EXT.ExternalSorter.__init__ = counting
    try:
        rng = np.random.default_rng(0)
        n = 5000
        t = Table.from_data(
            TupleSchema.of(("k", DataType.INT32, False),
                           ("v", DataType.FLOAT, False)),
            {"k": rng.integers(0, 2000, n).astype(np.int32),
             "v": rng.random(n, dtype=np.float32)})
        plan = HybridGroupAggregate(
            ["k"], [AggSpec(Aggregation.SUM, "v", "sv")], ScanTable(t),
            GroupAggregateOptions(memory_quota=4096))
        run, bound, leaves = compile_plan(plan)
        assert not calls, "bind executed the spill"
        assert run.lazy, "spill plan registered no lazy leaf"
        resolved = prepare_leaves(leaves, run.lazy)
        assert calls, "prepare did not run the spill"
        out, _flags = run(resolved)
        got = sorted(out.to_pylist())
        want = {}
        ks = np.asarray(t.columns["k"].values)[:n]
        vs = np.asarray(t.columns["v"].values)[:n]
        for k in np.unique(ks):
            want[int(k)] = float(np.sum(vs[ks == k], dtype=np.float64))
        assert len(got) == len(want)
        for k, sv in got:
            assert abs(sv - want[k]) < 1e-2, (k, sv, want[k])

        # external sort: same contract
        calls.clear()
        plan2 = SortWithTempDirPrefix([("k", True)], ScanTable(t),
                                      memory_limit=4096)
        run2, bound2, leaves2 = compile_plan(plan2)
        assert not calls, "sort bind executed the spill"
        resolved2 = prepare_leaves(leaves2, run2.lazy)
        assert calls
        out2, _f2 = run2(resolved2)
        kk = [r[0] for r in out2.to_pylist()]
        assert kk == sorted(kk) and len(kk) == n
    finally:
        EXT.ExternalSorter.__init__ = orig

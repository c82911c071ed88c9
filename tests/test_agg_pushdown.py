"""Aggregate pushdown through UNIQUE INNER joins (round 5): the
star-schema rewrite pregroups the probe side by its join key and joins
the partials — SUM/MIN/MAX/COUNT recombination, insertion-order
preservation via MIN of first positions, and the negative cases that
must keep the direct path (reference contract for the pregroup:
aggregate.h:233-246; insertion order: RowHashSet append order,
row_hash_set.cc)."""
import numpy as np
import pytest

import supersonic_jax.ops.aggregate as AG
from supersonic_jax import (AggSpec, Aggregation, Const, DataType, Filter,
                            GroupAggregate, GroupAggregateOptions, HashJoin,
                            JoinType, KeyUniqueness, Projector, ScanTable,
                            Sort, SortKey, Table, TupleSchema, col, execute)


@pytest.fixture
def counted(monkeypatch):
    calls = []
    orig = AG.GroupAggregate._try_aggregate_pushdown

    def wrap(self, ctx, uo):
        r = orig(self, ctx, uo)
        if r is not None:
            calls.append(1)
        return r

    monkeypatch.setattr(AG.GroupAggregate, "_try_aggregate_pushdown", wrap)
    return calls


def _data(n=40000, m=3000, G=17, seed=5):
    rng = np.random.default_rng(seed)
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False),
                       ("iv", DataType.INT64, True)),
        {"fk": rng.integers(0, m, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32),
         "iv": [int(x) if c else None for x, c in
                zip(rng.integers(-50, 50, n), rng.random(n) < 0.9)]})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(m, dtype=np.int32),
         "g": rng.integers(0, G, m).astype(np.int32)})
    return fact, dim


def _plan(fact, dim, filtered=True):
    child = ScanTable(fact)
    if filtered:
        child = Filter(col("v") > Const(0.5, DataType.FLOAT), child)
    return GroupAggregate(
        ["g"],
        [AggSpec(Aggregation.SUM, "iv", "si"),
         AggSpec(Aggregation.COUNT, None, "c"),
         AggSpec(Aggregation.MIN, "v", "mn"),
         AggSpec(Aggregation.MAX, "iv", "mx")],
        HashJoin(JoinType.INNER, ["fk"], ["pk"], child,
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v", "iv"),
                 rhs_projector=Projector.named("g")),
        GroupAggregateOptions(estimated_result_row_count=64))


def _direct(monkeypatch, plan_fn):
    with monkeypatch.context() as mp:
        mp.setattr(AG.GroupAggregate, "_try_aggregate_pushdown",
                   lambda self, ctx, uo: None)
        return execute(plan_fn())


def _rows_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(x, float):
                assert y is not None and abs(x - y) <= 1e-5 * max(
                    1.0, abs(x)), (a, b)
            else:
                assert x == y, (a, b)


def test_pushdown_ordered_exact(counted, monkeypatch):
    """Insertion-order output (MIN of first positions) matches the direct
    path row for row, including the exact output schema (COUNT stays
    non-nullable UINT64)."""
    fact, dim = _data()
    got = execute(_plan(fact, dim))
    assert counted, "pushdown did not fire"
    want = _direct(monkeypatch, lambda: _plan(fact, dim))
    assert [(a.name, a.type, a.nullable) for a in got.schema] == \
           [(a.name, a.type, a.nullable) for a in want.schema]
    _rows_close(got.to_pylist(), want.to_pylist())


def test_pushdown_under_sort_unordered(counted, monkeypatch):
    fact, dim = _data(seed=11)

    def p():
        return Sort([SortKey("si", ascending=False)], _plan(fact, dim))

    got = execute(p())
    assert counted
    want = _direct(monkeypatch, p)
    _rows_close(got.to_pylist(), want.to_pylist())


def test_pushdown_count_as_sum_and_empty_groups(counted, monkeypatch):
    """Groups only exist for matched keys (INNER); COUNT counts non-null
    inputs per the reference (column_aggregator.cc:198-306)."""
    rng = np.random.default_rng(3)
    n, m = 9000, 500
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("x", DataType.INT32, True)),
        {"fk": rng.integers(0, 2 * m, n).astype(np.int32),  # half unmatched
         "x": [int(v) if c else None for v, c in
               zip(rng.integers(0, 9, n), rng.random(n) < 0.5)]})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(m, dtype=np.int32),
         "g": rng.integers(0, 7, m).astype(np.int32)})

    def p():
        return GroupAggregate(
            ["g"], [AggSpec(Aggregation.COUNT, "x", "cx"),
                    AggSpec(Aggregation.SUM, "x", "sx")],
            HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                     ScanTable(dim), KeyUniqueness.UNIQUE,
                     lhs_projector=Projector.named("x"),
                     rhs_projector=Projector.named("g")),
            GroupAggregateOptions(estimated_result_row_count=16))

    got = execute(p())
    assert counted
    want = _direct(monkeypatch, p)
    assert got.to_pylist() == want.to_pylist()


def test_pushdown_string_group_key(counted, monkeypatch):
    rng = np.random.default_rng(9)
    n, m = 20000, 2000
    words = ["aa", "bb", "cc", "dd", "ee"]
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"fk": rng.integers(0, m, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32)})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("s", DataType.STRING, False)),
        {"pk": np.arange(m, dtype=np.int32),
         "s": [words[i % 5] for i in range(m)]})

    def p():
        return GroupAggregate(
            ["s"], [AggSpec(Aggregation.SUM, "v", "sv")],
            HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                     ScanTable(dim), KeyUniqueness.UNIQUE,
                     lhs_projector=Projector.named("v"),
                     rhs_projector=Projector.named("s")),
            GroupAggregateOptions(estimated_result_row_count=16))

    got = execute(p())
    assert counted
    want = _direct(monkeypatch, p)
    _rows_close(got.to_pylist(), want.to_pylist())


def test_pushdown_declines_ineligible(counted):
    """No rewrite for: lhs-side group keys, rhs-side aggregate inputs,
    FIRST aggregation, DISTINCT, small probe sides (no shrink),
    quota/clamp options.  (NOT_UNIQUE is eligible since the pair-rank
    generalization — see test_pushdown_not_unique_under_sort.)"""
    fact, dim = _data(n=4000, m=3000)  # rng*4 > lcap -> not profitable
    execute(_plan(fact, dim))
    assert not counted

    fact, dim = _data()
    # group key from the probe side
    execute(GroupAggregate(
        ["fk2"], [AggSpec(Aggregation.SUM, "v", "sv")],
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector([("fk", "fk2"), ("v", None)]),
                 rhs_projector=Projector.named("g")),
        GroupAggregateOptions(estimated_result_row_count=4096)))
    assert not counted
    # aggregate over a build-side column
    execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.MAX, "pk2", "mp")],
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector([("pk", "pk2"), ("g", None)])),
        GroupAggregateOptions(estimated_result_row_count=64)))
    assert not counted
    # FIRST depends on encounter order: not decomposable
    execute(GroupAggregate(
        ["g"], [AggSpec(Aggregation.FIRST, "v", "fv")],
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                 ScanTable(dim), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("g")),
        GroupAggregateOptions(estimated_result_row_count=64)))
    assert not counted


def test_pushdown_not_unique_under_sort(counted, monkeypatch):
    """NOT_UNIQUE INNER joins decompose too (each (partial, build-row)
    pair contributes its partial once per duplicate, exactly like the
    direct join's row pairs).  The ordered case reproduces insertion
    order exactly via the packed pair-rank
    MIN(first_probe_pos * 2^32 + build_pos) — ties between groups first
    seen at the same probe row resolve by build-side match-list order,
    which is build original order."""
    rng = np.random.default_rng(5)
    n, m = 40000, 2000
    pk = np.repeat(np.arange(m // 4, dtype=np.int32), 4)
    rng.shuffle(pk)
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": pk, "g": rng.integers(0, 13, m).astype(np.int32)})
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False),
                       ("iv", DataType.INT64, True)),
        {"fk": rng.integers(0, m // 4 + 30, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32),
         "iv": [int(x) if c else None for x, c in
                zip(rng.integers(-50, 50, n), rng.random(n) < 0.9)]})

    def agg():
        return GroupAggregate(
            ["g"],
            [AggSpec(Aggregation.SUM, "iv", "si"),
             AggSpec(Aggregation.COUNT, None, "c"),
             AggSpec(Aggregation.MIN, "v", "mn")],
            HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                     ScanTable(dim), KeyUniqueness.NOT_UNIQUE,
                     lhs_projector=Projector.named("v", "iv"),
                     rhs_projector=Projector.named("g"),
                     out_capacity=5 * n),
            GroupAggregateOptions(estimated_result_row_count=32))

    def p():
        return Sort([SortKey("si", ascending=False)], agg())

    got = execute(p())
    assert counted, "NOT_UNIQUE pushdown did not fire under Sort"
    want = _direct(monkeypatch, p)
    _rows_close(got.to_pylist(), want.to_pylist())
    # ordered bare aggregate: pair-rank insertion order, row-exact
    counted.clear()
    got2 = execute(agg())
    assert counted, "ordered NOT_UNIQUE pushdown did not fire"
    want2 = _direct(monkeypatch, agg)
    _rows_close(got2.to_pylist(), want2.to_pylist())


@pytest.mark.parametrize("uniq", [KeyUniqueness.UNIQUE,
                                  KeyUniqueness.NOT_UNIQUE])
@pytest.mark.parametrize("ordered", [True, False])
def test_pushdown_left_outer(counted, monkeypatch, uniq, ordered):
    """LEFT_OUTER decomposes too: an unmatched probe row's partial emits
    one NULL-rhs row in the rewritten join exactly as its rows do in the
    direct join, so the NULL-key group receives the same partials; rank
    ties for the NULL row use build position 0 (it is its probe row's
    whole match list)."""
    rng = np.random.default_rng(5)
    n, m = 40000, 2000
    dup = 1 if uniq == KeyUniqueness.UNIQUE else 4
    if dup == 1:
        pk = np.arange(m, dtype=np.int32)
    else:
        pk = np.repeat(np.arange(m // dup, dtype=np.int32), dup)
        rng.shuffle(pk)
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": pk, "g": rng.integers(0, 13, m).astype(np.int32)})
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"fk": rng.integers(0, int((m // dup) * 1.4), n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32)})

    def agg():
        return GroupAggregate(
            ["g"], [AggSpec(Aggregation.SUM, "v", "sv"),
                    AggSpec(Aggregation.COUNT, None, "c")],
            HashJoin(JoinType.LEFT_OUTER, ["fk"], ["pk"], ScanTable(fact),
                     ScanTable(dim), uniq,
                     lhs_projector=Projector.named("v"),
                     rhs_projector=Projector.named("g"),
                     out_capacity=(dup + 1) * n),
            GroupAggregateOptions(estimated_result_row_count=32))

    p = agg if ordered else (lambda: Sort([SortKey("sv", False)], agg()))
    got = execute(p())
    assert counted, "LEFT_OUTER pushdown did not fire"
    want = _direct(monkeypatch, p)
    got_rows, want_rows = got.to_pylist(), want.to_pylist()
    assert len(got_rows) == len(want_rows)
    for a, b in zip(got_rows, want_rows):
        assert a[0] == b[0] and a[2] == b[2], (a, b)
        assert abs(a[1] - b[1]) <= 1e-2, (a, b)

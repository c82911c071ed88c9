"""Failure-model tests: bind-time schema errors and device error flags
(reference analogue: exception propagation via FailureOr +
ERROR_MEMORY_EXCEEDED-style capacity failures, SURVEY.md §5.3)."""
import pytest

from supersonic_jax import (INT64, AggSpec, Aggregation, EvaluationError,
                            Filter, GroupAggregate, GroupAggregateOptions,
                            HashJoin, JoinType, KeyUniqueness, Project,
                            Projector, ScanTable, SchemaError, Table,
                            TupleSchema, col, execute)


def make_table():
    return Table.from_data(TupleSchema.of(("k", INT64), ("v", INT64)),
                           {"k": [1, 2, 3, 4], "v": [1, 1, 1, 1]})


def test_missing_column_is_bind_error():
    with pytest.raises(SchemaError):
        execute(Project(Projector.named("zz"), ScanTable(make_table())))


def test_non_bool_filter_predicate():
    from supersonic_jax import TypeError_
    with pytest.raises(TypeError_):
        execute(Filter(col("k") + 1, ScanTable(make_table())))


def test_aggregate_capacity_overflow_flags():
    # 4 distinct keys, declared capacity 2, no clamp -> runtime error flag
    with pytest.raises(EvaluationError, match="aggregate result overflow"):
        execute(GroupAggregate(
            ["k"], [AggSpec(Aggregation.SUM, "v", "s")], ScanTable(make_table()),
            GroupAggregateOptions(estimated_result_row_count=2)))


def test_join_overflow_flags():
    lhs = Table.from_data(TupleSchema.of(("k", INT64),), {"k": [7, 7]})
    rhs = Table.from_data(TupleSchema.of(("k2", INT64),), {"k2": [7, 7, 7]})
    with pytest.raises(EvaluationError, match="join result overflow"):
        execute(HashJoin(JoinType.INNER, ["k"], ["k2"], ScanTable(lhs),
                         ScanTable(rhs), KeyUniqueness.NOT_UNIQUE,
                         out_capacity=4))


def test_cancellation_before_dispatch():
    """Cursor::Interrupt analogue (cursor.h:160-166): a pre-interrupted
    token fails the query at the first poll point."""
    from supersonic_jax import CancellationToken, Interrupted

    tok = CancellationToken()
    tok.interrupt()
    with pytest.raises(Interrupted):
        execute(Filter(col("v") > 0, ScanTable(make_table())), cancel=tok)


def test_cancellation_mid_spill(tmp_path):
    """Interrupting during the external sort's spill loop stops the
    query between chunks (the reference polls inside Next(), sort.cc's
    run loop; here the poll points are the host chunk boundaries)."""
    import numpy as np

    from supersonic_jax import (CancellationToken, Interrupted,
                                SortWithTempDirPrefix)

    class FlipAfter(CancellationToken):
        __slots__ = ("n",)

        def __init__(self, n):
            super().__init__()
            self.n = n

        def interrupted(self):
            self.n -= 1
            return self.n < 0

    t = Table.from_data(
        TupleSchema.of(("k", INT64, False)),
        {"k": np.arange(5000, dtype=np.int64)[::-1]})
    plan = SortWithTempDirPrefix(
        [("k", True)], ScanTable(t), memory_limit=4096,
        temporary_directory_prefix=str(tmp_path))
    with pytest.raises(Interrupted):
        execute(plan, cancel=FlipAfter(3))
    # an uninterrupted run of the same spilling plan still completes
    out = execute(SortWithTempDirPrefix(
        [("k", True)], ScanTable(t), memory_limit=4096,
        temporary_directory_prefix=str(tmp_path)))
    assert [r[0] for r in out.to_pylist()[:4]] == [0, 1, 2, 3]

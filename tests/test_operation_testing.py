"""Tests for the OperationTest sweep harness itself (reference:
operation_testing fixture usage patterns across cursor/core tests)."""
from supersonic_jax import (INT64, AggSpec, Aggregation, Filter,
                            GroupAggregate, Sort, TupleSchema, col)
from supersonic_jax.testing import OperationTest, check_operation


def test_filter_sweep():
    check_operation(
        lambda t: Filter(col("a") > 2, __import__("supersonic_jax").ScanTable(t)),
        [(TupleSchema.of(("a", INT64),), {"a": [1, 3, None, 5]})],
        [(3,), (5,)],
    )


def test_group_aggregate_sweep_fixture():
    t = OperationTest()
    t.add_input(TupleSchema.of(("k", INT64), ("v", INT64)),
                {"k": [1, 2, 1], "v": [10, 20, 30]})
    t.set_expected_result([(1, 40), (2, 20)])
    t.execute(lambda inp: GroupAggregate(
        ["k"], [AggSpec(Aggregation.SUM, "v", "s")], inp))


def test_sort_sweep_ignore_order_off():
    t = OperationTest()
    t.add_input(TupleSchema.of(("a", INT64),), {"a": [3, None, 1]})
    t.set_expected_result([(None,), (1,), (3,)])
    t.execute(lambda inp: Sort(["a"], inp))


def test_hash_join_sweep():
    from supersonic_jax import (HashJoin, JoinType, KeyUniqueness, ScanTable)
    check_operation(
        lambda lt, rt: HashJoin(
            JoinType.LEFT_OUTER, ["fk"], ["pk"],
            __import__("supersonic_jax").ScanTable(lt),
            __import__("supersonic_jax").ScanTable(rt),
            KeyUniqueness.UNIQUE),
        [(TupleSchema.of(("fk", INT64),), {"fk": [1, 9, 2]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64)),
          {"pk": [1, 2], "w": [10, 20]})],
        [(1, 1, 10), (9, None, None), (2, 2, 20)],
    )


def test_merge_union_sweep():
    from supersonic_jax import MergeUnionAll
    check_operation(
        lambda a, b: MergeUnionAll(
            ["k"], [__import__("supersonic_jax").ScanTable(a),
                    __import__("supersonic_jax").ScanTable(b)]),
        [(TupleSchema.of(("k", INT64),), {"k": [1, 5]}),
         (TupleSchema.of(("k", INT64),), {"k": [2, 3]})],
        [(1,), (2,), (3,), (5,)],
    )


def test_aggregate_clusters_sweep():
    from supersonic_jax import AggregateClusters, AggSpec, Aggregation
    check_operation(
        lambda t: AggregateClusters(
            ["k"], [AggSpec(Aggregation.MIN, "v", "mn"),
                    AggSpec(Aggregation.MAX, "v", "mx")],
            __import__("supersonic_jax").ScanTable(t)),
        [(TupleSchema.of(("k", INT64), ("v", INT64)),
          {"k": [1, 1, 2, 1], "v": [3, 1, 9, 4]})],
        [(1, 1, 3), (2, 9, 9), (1, 4, 4)],
    )


def test_masked_join_under_sort_sweep():
    # Sort over a UNIQUE join binds the join *masked* (uncompacted output
    # + keep mask fused into the sort's pad key); dense INT keys take the
    # fat-LUT path.  Sweep capacities to shake out padding bugs.
    from supersonic_jax import (HashJoin, JoinType, KeyUniqueness, ScanTable,
                                Sort)
    check_operation(
        lambda lt, rt: Sort(
            ["w", "fk"],
            HashJoin(JoinType.INNER, ["fk"], ["pk"],
                     ScanTable(lt), ScanTable(rt), KeyUniqueness.UNIQUE)),
        [(TupleSchema.of(("fk", INT64),), {"fk": [2, 9, 1, None, 2]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64, True)),
          {"pk": [1, 2, 3], "w": [10, 20, None]})],
        [(1, 1, 10), (2, 2, 20), (2, 2, 20)],
        ignore_row_order=False,
    )


def test_masked_left_outer_join_under_groupby_sweep():
    from supersonic_jax import (AggSpec, Aggregation, GroupAggregate,
                                HashJoin, JoinType, KeyUniqueness, ScanTable)
    check_operation(
        lambda lt, rt: GroupAggregate(
            ["w"], [AggSpec(Aggregation.COUNT, None, "n"),
                    AggSpec(Aggregation.SUM, "x", "sx")],
            HashJoin(JoinType.LEFT_OUTER, ["fk"], ["pk"],
                     ScanTable(lt), ScanTable(rt), KeyUniqueness.UNIQUE)),
        [(TupleSchema.of(("fk", INT64), ("x", INT64)),
          {"fk": [1, 9, 2, 1], "x": [5, 6, 7, 8]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64)),
          {"pk": [1, 2], "w": [10, 20]})],
        [(10, 2, 13), (None, 1, 6), (20, 1, 7)],
    )


def test_filtered_masked_join_under_sort_sweep():
    # Filter between Sort and the UNIQUE join: unwrap_filters folds the
    # predicate into the join's keep mask.
    from supersonic_jax import (Filter, HashJoin, JoinType, KeyUniqueness,
                                ScanTable, Sort, col)
    check_operation(
        lambda lt, rt: Sort(
            ["x"],
            Filter(col("x") > 5,
                   HashJoin(JoinType.INNER, ["fk"], ["pk"],
                            ScanTable(lt), ScanTable(rt),
                            KeyUniqueness.UNIQUE))),
        [(TupleSchema.of(("fk", INT64), ("x", INT64)),
          {"fk": [1, 2, 1, 2], "x": [4, 6, 8, 3]}),
         (TupleSchema.of(("pk", INT64), ("w", INT64)),
          {"pk": [2, 1], "w": [20, 10]})],
        [(2, 6, 2, 20), (1, 8, 1, 10)],
        ignore_row_order=False,
    )

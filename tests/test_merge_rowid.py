"""MergeUnionAll / RowidMergeJoin / ForeignFilter tests (reference:
merge_union_all_test.cc, rowid_merge_join_test.cc, foreign_filter_test.cc)."""
import pytest

from supersonic_jax import (INT64, STRING, EvaluationError, ForeignFilter,
                            MergeUnionAll, Projector, RowidMergeJoin,
                            ScanTable, Sort, Table, TupleSchema, execute)


def test_merge_union_all():
    s = TupleSchema.of(("k", INT64), ("v", INT64))
    a = Table.from_data(s, {"k": [1, 3, 5], "v": [10, 30, 50]})
    b = Table.from_data(s, {"k": [2, 3, 4], "v": [20, 31, 40]})
    out = execute(MergeUnionAll(["k"], [ScanTable(a), ScanTable(b)]))
    assert out.to_pylist() == [
        (1, 10), (2, 20), (3, 30), (3, 31), (4, 40), (5, 50)]


def test_merge_union_all_tie_break_by_child():
    s = TupleSchema.of(("k", INT64), ("v", INT64))
    a = Table.from_data(s, {"k": [1, 1], "v": [1, 2]})
    b = Table.from_data(s, {"k": [1], "v": [3]})
    out = execute(MergeUnionAll(["k"], [ScanTable(a), ScanTable(b)]))
    # child 0's rows first (queue order), in child row order
    assert [r[1] for r in out.to_pylist()] == [1, 2, 3]


def test_merge_union_all_strings():
    s = TupleSchema.of(("s", STRING),)
    a = Table.from_data(s, {"s": ["a", "c"]})
    b = Table.from_data(s, {"s": ["b", "d"]})
    out = execute(MergeUnionAll(["s"], [ScanTable(a), ScanTable(b)]))
    assert [r[0] for r in out.to_pylist()] == ["a", "b", "c", "d"]


def test_rowid_merge_join():
    ls = TupleSchema.of(("fk", INT64, False), ("lv", INT64))
    rs = TupleSchema.of(("rv", STRING),)
    lhs = Table.from_data(ls, {"fk": [0, 0, 2], "lv": [1, 2, 3]})
    rhs = Table.from_data(rs, {"rv": ["a", "b", "c"]})
    out = execute(RowidMergeJoin("fk", ScanTable(lhs), ScanTable(rhs),
                                 lhs_projector=Projector.named("lv")))
    assert out.to_pylist() == [(1, "a"), (2, "a"), (3, "c")]


def test_rowid_merge_join_integrity_violation():
    ls = TupleSchema.of(("fk", INT64, False),)
    rs = TupleSchema.of(("rv", INT64),)
    lhs = Table.from_data(ls, {"fk": [5]})
    rhs = Table.from_data(rs, {"rv": [1, 2]})
    with pytest.raises(EvaluationError):
        execute(RowidMergeJoin("fk", ScanTable(lhs), ScanTable(rhs)))


def test_foreign_filter():
    ls = TupleSchema.of(("fk", INT64, False), ("lv", INT64))
    rs = TupleSchema.of(("key", INT64, False),)
    lhs = Table.from_data(ls, {"fk": [2, 5, 7, 9], "lv": [1, 2, 3, 4]})
    rhs = Table.from_data(rs, {"key": [2, 7, 8]})
    out = execute(ForeignFilter("fk", "key", ScanTable(lhs), ScanTable(rhs)))
    # fk remapped to rhs row ids: 2 -> 0, 7 -> 1
    assert out.to_pylist() == [(0, 1), (1, 3)]

"""Sort operator tests (reference analogue: cursor/core/sort_test.cc).
NULL ordering contract: NULL == NULL, NULL < non-NULL ascending
(sort.cc:44-47); DESC reverses the whole comparator (NULLs last)."""
import pytest

from supersonic_jax import (DOUBLE, INT64, STRING, ExtendedSort, ScanTable,
                            Sort, SortKey, Table, TupleSchema, execute)


def make_table():
    schema = TupleSchema.of(("a", INT64), ("b", DOUBLE), ("s", STRING))
    return Table.from_data(schema, {
        "a": [3, 1, None, 2, 1],
        "b": [1.0, -2.5, 3.0, None, 0.0],
        "s": ["beta", "alpha", "delta", None, "alpha"],
    })


def test_single_key_asc_nulls_first():
    out = execute(Sort(["a"], ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [None, 1, 1, 2, 3]


def test_single_key_desc_nulls_last():
    out = execute(Sort([SortKey("a", ascending=False)],
                       ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [3, 2, 1, 1, None]


def test_two_keys():
    out = execute(Sort([("a", True), ("b", False)], ScanTable(make_table())))
    rows = out.to_pylist()
    assert [(r[0], r[1]) for r in rows] == [
        (None, 3.0), (1, 0.0), (1, -2.5), (2, None), (3, 1.0)]


def test_stability():
    schema = TupleSchema.of(("k", INT64), ("v", INT64))
    t = Table.from_data(schema, {"k": [1, 1, 1, 0], "v": [10, 20, 30, 40]})
    out = execute(Sort(["k"], ScanTable(t)))
    assert [r[1] for r in out.to_pylist()] == [40, 10, 20, 30]


def test_string_sort():
    out = execute(Sort(["s"], ScanTable(make_table())))
    assert [r[2] for r in out.to_pylist()] == [
        None, "alpha", "alpha", "beta", "delta"]


def test_float_negatives_and_zero():
    schema = TupleSchema.of(("x", DOUBLE),)
    t = Table.from_data(schema, {"x": [0.0, -0.0, -1.5, 2.0, -3.0]})
    out = execute(Sort(["x"], ScanTable(t)))
    vals = [r[0] for r in out.to_pylist()]
    assert vals[:2] == [-3.0, -1.5]
    assert set(vals[2:4]) == {0.0, -0.0} or vals[2:4] == [0.0, 0.0]
    assert vals[4] == 2.0


def test_extended_sort_limit():
    out = execute(ExtendedSort(["a"], ScanTable(make_table()), limit=2))
    assert [r[0] for r in out.to_pylist()] == [None, 1]


def test_extended_sort_case_insensitive():
    schema = TupleSchema.of(("s", STRING),)
    t = Table.from_data(schema, {"s": ["b", "A", "a", "B"]})
    out = execute(ExtendedSort(
        [SortKey("s", case_sensitive=False)], ScanTable(t)))
    got = [r[0] for r in out.to_pylist()]
    assert [g.lower() for g in got] == ["a", "a", "b", "b"]
    # stability within fold group: input order preserved
    assert got == ["A", "a", "b", "B"]


@pytest.mark.parametrize("capacity", [None, 16])
def test_sort_with_padding(capacity):
    schema = TupleSchema.of(("a", INT64),)
    t = Table.from_data(schema, {"a": [5, 2, 9]}, capacity=capacity)
    out = execute(Sort([("a", True)], ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == [2, 5, 9]


def test_sort_result_projector():
    from supersonic_jax import Projector
    out = execute(Sort(["a"], ScanTable(make_table()),
                       result_projector=Projector([("b", "bb")])))
    assert out.schema.names() == ("bb",)
    assert [r[0] for r in out.to_pylist()] == [3.0, -2.5, 0.0, None, 1.0]


def test_extended_sort_limit_topk_path():
    # limit << capacity takes the top-K (perm-sort + small gather) path;
    # results must match the full sort, including NULL ordering and ties
    import numpy as np
    from supersonic_jax import (DataType, ExtendedSort, ScanTable, SortKey,
                                Table, TupleSchema, execute)
    rng = np.random.default_rng(13)
    n = 300
    vals = [None if rng.random() < 0.15 else int(v)
            for v in rng.integers(0, 40, n)]
    t = Table.from_data(
        TupleSchema.of(("a", DataType.INT64, True), ("tag", DataType.INT64)),
        {"a": vals, "tag": list(range(n))})
    got = execute(ExtendedSort([SortKey("a", ascending=False)], ScanTable(t),
                               limit=7)).to_pylist()
    full = execute(ExtendedSort([SortKey("a", ascending=False)],
                                ScanTable(t))).to_pylist()
    assert got == full[:7]

"""Filter / Project / Compute / Limit / Coalesce / Generate operator tests
(reference analogue: cursor/core/*_test.cc via OperationTest)."""
import pytest

from supersonic_jax import (BOOL, DOUBLE, INT64, STRING, Coalesce, Compute,
                            Const, Filter, Generate, Limit, Project, Projector,
                            RandInt32, ScanTable, Sequence, Table, TupleSchema,
                            col, execute)


def make_table(capacity=None):
    schema = TupleSchema.of(("a", INT64), ("b", DOUBLE), ("s", STRING))
    return Table.from_data(
        schema,
        {"a": [1, 2, None, 4, 5], "b": [10.0, 20.0, 30.0, None, 50.0],
         "s": ["p", "q", "r", "s", "t"]},
        capacity=capacity,
    )


@pytest.mark.parametrize("capacity", [None, 8, 64])
def test_filter(capacity):
    t = make_table(capacity)
    out = execute(Filter(col("a") > Const(1), ScanTable(t)))
    assert out.to_pylist() == [(2, 20.0, "q"), (4, None, "s"), (5, 50.0, "t")]


def test_filter_null_is_false():
    t = make_table()
    out = execute(Filter(col("b") < Const(100.0), ScanTable(t)))
    # row with b=NULL dropped (reference: filter.cc:169-198)
    assert [r[0] for r in out.to_pylist()] == [1, 2, None, 5]


def test_project_rename_reorder():
    t = make_table()
    out = execute(Project(Projector([("b", "bb"), ("a", None)]), ScanTable(t)))
    assert out.schema.names() == ("bb", "a")
    assert out.to_pylist()[0] == (10.0, 1)


def test_project_all():
    t = make_table()
    out = execute(Project(Projector.all(), ScanTable(t)))
    assert out.to_pylist() == t.to_pylist()


def test_compute_pipeline():
    t = make_table()
    plan = Compute([(col("a") * 10).as_("a10"), col("s")],
                   Filter(col("a") > Const(1), ScanTable(t)))
    out = execute(plan)
    assert out.to_pylist() == [(20, "q"), (40, "s"), (50, "t")]


def test_limit_offset():
    t = make_table()
    out = execute(Limit(1, 2, ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == [2, None]


def test_limit_past_end():
    t = make_table()
    out = execute(Limit(4, 10, ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == [5]


def test_generate_sequence():
    plan = Compute([Sequence().as_("seq"), RandInt32().as_("r")], Generate(5))
    out = execute(plan)
    rows = out.to_pylist()
    assert [r[0] for r in rows] == [0, 1, 2, 3, 4]
    assert all(0 <= r[1] < 2**31 for r in rows)


def test_coalesce():
    s1 = TupleSchema.of(("a", INT64),)
    s2 = TupleSchema.of(("b", INT64),)
    t1 = Table.from_data(s1, {"a": [1, 2, 3]})
    t2 = Table.from_data(s2, {"b": [10, 20, 30]})
    out = execute(Coalesce(ScanTable(t1), ScanTable(t2)))
    assert out.to_pylist() == [(1, 10), (2, 20), (3, 30)]


def test_empty_input():
    schema = TupleSchema.of(("a", INT64),)
    t = Table.from_data(schema, {"a": []})
    out = execute(Filter(col("a") > Const(0), ScanTable(t)))
    assert out.to_pylist() == []


def test_scan_with_selection():
    from supersonic_jax import ScanTableWithSelection
    t = make_table()
    out = execute(ScanTableWithSelection(t, [4, 0, 2]))
    assert [r[0] for r in out.to_pylist()] == [5, 1, None]


def test_filter_tiled_compaction_path():
    # a capacity past every power-of-two tile size: the scatter
    # compaction must keep the survivors stable at any length
    import numpy as np
    from supersonic_jax import (DataType, Filter, ScanTable, Table,
                                TupleSchema, col, execute)
    n = 4 * 32768 + 12345
    rng = np.random.default_rng(3)
    v = rng.integers(0, 100, n).astype(np.int32)
    x = rng.random(n).astype(np.float32)
    t = Table.from_data(
        TupleSchema.of(("v", DataType.INT32, False),
                       ("x", DataType.FLOAT, False)),
        {"v": v, "x": x})
    out = execute(Filter(col("v") < 7, ScanTable(t)))
    keep = v < 7
    got = out.to_numpy()
    assert int(out.num_rows) == int(keep.sum())
    assert (got["v"] == v[keep]).all()
    assert (got["x"] == x[keep]).all()

"""Data-model tests (reference analogue: base/infrastructure block/schema
tests)."""
import numpy as np
import pytest

from supersonic_jax import (DOUBLE, INT64, STRING, Attribute, SchemaError,
                            Table, TupleSchema, concat_tables)


def make_table(capacity=None):
    schema = TupleSchema.of(("a", INT64), ("b", DOUBLE), ("s", STRING))
    return Table.from_data(
        schema,
        {"a": [1, 2, None, 4], "b": [1.5, None, 3.5, 4.5],
         "s": ["x", "y", None, "x"]},
        capacity=capacity,
    )


def test_roundtrip():
    t = make_table()
    assert t.to_pylist() == [
        (1, 1.5, "x"), (2, None, "y"), (None, 3.5, None), (4, 4.5, "x")]


def test_capacity_padding():
    t = make_table(capacity=16)
    assert t.capacity == 16
    assert int(t.num_rows) == 4
    assert t.to_pylist()[-1] == (4, 4.5, "x")


def test_dictionary_order_preserving():
    t = make_table()
    d = t.dicts["s"]
    assert list(d.values) == ["x", "y"]
    assert d.is_sorted()


def test_duplicate_names_rejected():
    with pytest.raises(SchemaError):
        TupleSchema.of(("a", INT64), ("a", DOUBLE))


def test_non_nullable_rejects_null():
    schema = TupleSchema.of(("a", INT64, False))
    with pytest.raises(SchemaError):
        Table.from_data(schema, {"a": [1, None]})


def test_schema_lookup():
    schema = TupleSchema.of(("a", INT64), ("b", DOUBLE))
    assert schema.lookup("b").type == DOUBLE
    with pytest.raises(SchemaError):
        schema.lookup("zz")


def test_concat_tables_merges_dicts():
    s = TupleSchema.of(("s", STRING),)
    t1 = Table.from_data(s, {"s": ["b", "a"]})
    t2 = Table.from_data(s, {"s": ["c", "a", None]})
    out = concat_tables([t1, t2])
    assert out.to_pylist() == [("b",), ("a",), ("c",), ("a",), (None,)]
    assert list(out.dicts["s"].values) == ["a", "b", "c"]


def test_pytree_roundtrip():
    import jax
    t = make_table(capacity=8)
    leaves, treedef = jax.tree_util.tree_flatten(t)
    t2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert t2.to_pylist() == t.to_pylist()
    assert t2.schema == t.schema


def test_enum_column():
    from supersonic_jax import EnumDefinition, DataType, ScanTable, Filter, col, Const, execute
    from supersonic_jax.types import DataType as DT
    colors = EnumDefinition(("red", "green", "blue"))
    schema = TupleSchema.of(Attribute("c", DT.ENUM, True, colors),
                            ("v", INT64))
    t = Table.from_data(schema, {"c": ["blue", "red", None, "green"],
                                 "v": [1, 2, 3, 4]})
    assert t.to_pylist() == [("blue", 1), ("red", 2), (None, 3), ("green", 4)]
    out = execute(Filter(col("c").eq(Const(colors.code_of("red"),
                                           DT.INT32)), ScanTable(t)))
    assert out.to_pylist() == [("red", 2)]


def test_gather_arrays_packs_dtype_groups():
    # packed gather must be value-identical to per-array takes across
    # 32-bit bitcast groups, 64-bit exact-dtype groups, and bools
    import numpy as np
    import jax.numpy as jnp
    from supersonic_jax.batch import gather_arrays
    rng = np.random.default_rng(4)
    n = 257
    idx = jnp.asarray(rng.integers(0, n, 100).astype(np.int32))
    arrays = [
        jnp.asarray(rng.integers(-9, 9, n).astype(np.int32)),
        jnp.asarray(rng.random(n).astype(np.float32)),
        jnp.asarray(rng.integers(0, 9, n).astype(np.uint32)),
        jnp.asarray(rng.integers(-9, 9, n).astype(np.int64)),
        jnp.asarray(rng.random(n)),            # f64
        jnp.asarray(rng.random(n) < 0.5),      # bool
        jnp.asarray(rng.random(n) < 0.5),      # bool (packs with above)
    ]
    got = gather_arrays(arrays, idx)
    for a, g in zip(arrays, got):
        assert g.dtype == a.dtype
        assert (np.asarray(g) == np.asarray(a)[np.asarray(idx)]).all()

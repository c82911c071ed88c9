"""file_io round-trip, expression serialization, benchmark harness tests
(reference analogues: file_io test, build_expression_from_proto_test,
benchmark/{dot,infrastructure,manager} tests)."""
import io

import pytest

from supersonic_jax import (DOUBLE, INT64, STRING, Compute, Filter,
                            GroupAggregate, AggSpec, Aggregation, ScanTable,
                            Table, TupleSchema, col, execute)
from supersonic_jax.io import (build_expression, read_table, write_table)
from supersonic_jax.bench import benchmark_plan, format_stats, to_dot


def make_table():
    schema = TupleSchema.of(("a", INT64), ("b", DOUBLE), ("s", STRING))
    return Table.from_data(schema, {
        "a": [1, None, 3], "b": [1.5, 2.5, None], "s": ["x", None, "yy"]})


def test_file_roundtrip():
    t = make_table()
    buf = io.BytesIO()
    write_table(buf, t)
    buf.seek(0)
    t2 = read_table(buf)
    assert t2.to_pylist() == t.to_pylist()
    assert t2.schema == t.schema


def test_file_roundtrip_large_chunked():
    import numpy as np
    schema = TupleSchema.of(("a", INT64, False),)
    t = Table.from_data(schema, {"a": np.arange(20000)})
    buf = io.BytesIO()
    write_table(buf, t)
    buf.seek(0)
    t2 = read_table(buf)
    assert int(t2.num_rows) == 20000
    assert t2.to_pylist()[19999] == (19999,)


def test_build_expression():
    desc = {"operation": {"id": "ADD", "args": [
        {"variable": "a"},
        {"constant": {"type": "INT64", "value": 10}}]}}
    expr = build_expression(desc)
    t = make_table()
    out = execute(Compute(expr, ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == [11, None, 13]


def test_build_expression_nested():
    desc = {"operation": {"id": "IF", "args": [
        {"operation": {"id": "LESS", "args": [
            {"variable": "a"}, {"constant": {"type": "INT64", "value": 2}}]}},
        {"constant": {"type": "STRING", "value": "low"}},
        {"constant": {"type": "STRING", "value": "high"}}]}}
    out = execute(Compute(build_expression(desc), ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == ["low", "high", "high"]


def test_build_expression_cast():
    desc = {"operation": {"id": "CAST", "to_type": "DOUBLE",
                          "args": [{"variable": "a"}]}}
    out = execute(Compute(build_expression(desc), ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [1.0, None, 3.0]


def test_benchmark_harness():
    t = make_table()
    plan = GroupAggregate(["s"], [AggSpec(Aggregation.SUM, "a", "sa")],
                          Filter(col("a") > 0, ScanTable(t)))
    stats = benchmark_plan(plan, iters=1)
    assert stats.name == "GroupAggregate"
    assert stats.children[0].name == "Filter"
    assert stats.children[0].children[0].name == "ScanTable"
    assert stats.rows_processed == 2  # groups: "x", "yy"
    table = format_stats(stats)
    assert "GroupAggregate" in table and "rows/µs" in table
    dot = to_dot(stats)
    assert dot.startswith("digraph") and "Filter" in dot


def test_build_sort_order_and_aggregation():
    from supersonic_jax import Sort, GroupAggregate, STRING
    from supersonic_jax.io import build_aggregation, build_sort_order
    t = make_table()
    order = build_sort_order([{"column": "a", "ascending": False}])
    out = execute(Sort(order, ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == [3, 1, None]
    spec = build_aggregation([
        {"aggregation": "SUM", "input": "a", "output": "sa"},
        {"aggregation": "COUNT", "output": "c"}])
    out2 = execute(GroupAggregate(["s"], spec, ScanTable(t)))
    assert sorted(out2.to_pylist(), key=str) == sorted(
        [("x", 1, 1), (None, None, 1), ("yy", 3, 1)], key=str)


def test_to_string_host():
    from supersonic_jax import DataType, TupleSchema as TS
    from supersonic_jax.ops.host import to_string
    t = Table.from_data(
        TS.of(("d", DataType.DATE), ("n", INT64)),
        {"d": [0, 365, None], "n": [5, None, 7]})
    out = to_string(t, "d", "ds")
    # reference default DATE print format "%Y/%m/%d"
    # (types_infrastructure.cc:39)
    assert [r[2] for r in out.to_pylist()] == ["1970/01/01", "1971/01/01",
                                               None]
    out2 = to_string(t, "n", "ns")
    assert [r[2] for r in out2.to_pylist()] == ["5", None, "7"]


def test_file_io_enum_roundtrip(tmp_path):
    # ENUM names + nulls survive the file format (enum map stored in the
    # schema header; reference keeps schemas out of band)
    from supersonic_jax.schema import Attribute, EnumDefinition, TupleSchema
    from supersonic_jax import DataType, Table
    from supersonic_jax.io.file_io import load, save

    e = EnumDefinition(("RED", "GREEN", "BLUE"))
    schema = TupleSchema([Attribute("c", DataType.ENUM, True, e),
                          Attribute("n", DataType.INT32, False)])
    t = Table.from_data(schema, {"c": ["BLUE", None, "RED"], "n": [1, 2, 3]})
    p = str(tmp_path / "enum.sst")
    save(p, t)
    out = load(p)
    assert out.to_pylist() == [("BLUE", 1), (None, 2), ("RED", 3)]


def test_file_io_binary_roundtrip(tmp_path):
    from supersonic_jax import DataType, Table, TupleSchema
    from supersonic_jax.io.file_io import load, save

    schema = TupleSchema.of(("b", DataType.BINARY, True))
    t = Table.from_data(schema, {"b": [b"\x00\xff", None, b"", b"abc"]})
    p = str(tmp_path / "bin.sst")
    save(p, t)
    out = load(p)
    assert out.to_pylist() == [(b"\x00\xff",), (None,), (b"",), (b"abc",)]


def test_from_arrays_constructor():
    import numpy as np
    from supersonic_jax import DataType, Table, TupleSchema

    schema = TupleSchema.of(("x", DataType.INT64, True),
                            ("y", DataType.DOUBLE, False))
    t = Table.from_arrays(
        schema,
        {"x": np.array([1, 2, 3]), "y": np.array([0.5, 1.5, 2.5])},
        {"x": np.array([True, False, True]), "y": None},
        3, capacity=8)
    assert t.capacity == 8
    assert t.to_pylist() == [(1, 0.5), (None, 1.5), (3, 2.5)]


def test_file_io_large_fast_path(tmp_path):
    # 200k rows with strings: exercises the native gather/encode paths and
    # keeps write+read comfortably fast (was minutes with per-row loops)
    import time

    import numpy as np
    from supersonic_jax import DataType, Table, TupleSchema
    from supersonic_jax.io.file_io import load, save

    n = 200_000
    rng = np.random.default_rng(7)
    schema = TupleSchema.of(("k", DataType.INT64, False),
                            ("s", DataType.STRING, True),
                            ("v", DataType.DOUBLE, True))
    svals = [f"key_{i % 997}" if i % 11 else None for i in range(n)]
    t = Table.from_data(schema, {
        "k": np.arange(n, dtype=np.int64),
        "s": svals,
        "v": rng.random(n),
    })
    p = str(tmp_path / "big.sst")
    t0 = time.perf_counter()
    save(p, t)
    out = load(p)
    elapsed = time.perf_counter() - t0
    assert elapsed < 20.0
    assert int(out.num_rows) == n
    got = out.to_numpy()
    assert list(got["s"][:22]) == svals[:22]
    assert np.array_equal(got["k"], np.arange(n, dtype=np.int64))


def test_describe_plan():
    from supersonic_jax import (AggSpec, Aggregation, DataType, Filter,
                                GroupAggregate, ScanTable, Sort, SortKey,
                                Table, TupleSchema, col)
    from supersonic_jax.bench import describe_plan

    t = Table.from_data(
        TupleSchema.of(("g", DataType.INT32), ("v", DataType.DOUBLE)),
        {"g": [1, 2, 1], "v": [1.0, 2.0, None]})
    plan = Sort([SortKey("sv", ascending=False)],
                GroupAggregate(["g"], [AggSpec(Aggregation.SUM, "v", "sv")],
                               Filter(col("v") > 0.5, ScanTable(t))))
    txt = describe_plan(plan)
    assert "Sort" in txt and "GroupAggregate" in txt and "Filter" in txt
    assert "sv DESC" in txt and "sv: DOUBLE?" in txt
    lines = txt.splitlines()
    assert lines[3].startswith("      ScanTable")


# ---------------------------------------------------------------------------
# protobuf wire format (reference: utils/proto/expressions.proto +
# build_expression_from_proto.cc)
# ---------------------------------------------------------------------------

def _pb():
    from supersonic_jax.io import expressions_pb2
    return expressions_pb2


def _var(name):
    pb = _pb()
    d = pb.ExpressionDescription(type=pb.VARIABLE)
    d.variable.name = name
    return d


def _const_i64(v):
    pb = _pb()
    d = pb.ExpressionDescription(type=pb.CONSTANT)
    d.constant.type = pb.INT64
    d.constant.int64_value = v
    return d


def _op(op_type, *args):
    pb = _pb()
    d = pb.ExpressionDescription(type=pb.OPERATION)
    d.operation.type = op_type
    for a in args:
        d.operation.argument.add().CopyFrom(a)
    return d


def test_proto_expression_roundtrip_wire_bytes():
    # build (a + 5) * a as a proto, serialize, rebuild from BYTES — the
    # reference's wire contract end to end
    pb = _pb()
    from supersonic_jax.io import build_expression_from_proto_bytes
    desc = _op(pb.MULTIPLY, _op(pb.ADD, _var("a"), _const_i64(5)), _var("a"))
    expr = build_expression_from_proto_bytes(desc.SerializeToString())
    out = execute(Compute(expr, ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [6, None, 24]


def test_proto_expression_cast_and_null():
    pb = _pb()
    from supersonic_jax.io import build_expression_from_proto
    # CAST(DOUBLE, a): leading DATA_TYPE constant argument
    tc = pb.ExpressionDescription(type=pb.CONSTANT)
    tc.constant.type = pb.DATA_TYPE
    tc.constant.data_type_value = pb.DOUBLE
    desc = _op(pb.CAST, tc, _var("a"))
    expr = build_expression_from_proto(desc)
    out = execute(Compute(expr, ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [1.0, None, 3.0]
    # typed NULL: constant with no value field set
    nd = pb.ExpressionDescription(type=pb.CONSTANT)
    nd.constant.type = pb.INT64
    nexpr = build_expression_from_proto(nd)
    out2 = execute(Compute(nexpr, ScanTable(make_table())))
    assert [r[0] for r in out2.to_pylist()] == [None, None, None]


def test_proto_expression_case_if_in():
    pb = _pb()
    from supersonic_jax.io import build_expression_from_proto
    # CASE a WHEN 1 THEN 10 ELSE 99  (proto arg order: sel, else, when, then)
    desc = _op(pb.CASE, _var("a"), _const_i64(99), _const_i64(1),
               _const_i64(10))
    out = execute(Compute(build_expression_from_proto(desc),
                          ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [10, 99, 99]
    # a IN (1, 3)
    desc2 = _op(pb.IN, _var("a"), _const_i64(1), _const_i64(3))
    out2 = execute(Compute(build_expression_from_proto(desc2),
                           ScanTable(make_table())))
    assert [r[0] for r in out2.to_pylist()] == [True, None, True]


def test_proto_expression_regexp_and_tuple():
    pb = _pb()
    from supersonic_jax.io import build_expression_from_proto
    pat = pb.ExpressionDescription(type=pb.CONSTANT)
    pat.constant.type = pb.STRING
    pat.constant.string_value = "y+"
    desc = _op(pb.REGEXP_PARTIAL, _var("s"), pat)
    out = execute(Compute(build_expression_from_proto(desc),
                          ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [False, None, True]
    # TUPLE of two aliased expressions -> list for Compute
    td = pb.ExpressionDescription(type=pb.TUPLE)
    e1 = td.tuple.expression.add()
    e1.expression.CopyFrom(_op(pb.ADD, _var("a"), _const_i64(1)))
    e1.alias.append("a1")
    e2 = td.tuple.expression.add()
    e2.expression.CopyFrom(_var("s"))
    e2.alias.append("s2")
    exprs = build_expression_from_proto(td)
    out2 = execute(Compute(exprs, ScanTable(make_table())))
    assert list(out2.schema.names()) == ["a1", "s2"]
    assert out2.to_pylist() == [(2, "x"), (None, None), (4, "yy")]


def test_proto_expression_errors_and_custom_function():
    pb = _pb()
    import pytest as _pytest
    from supersonic_jax.io import (SerializationError,
                                   build_expression_from_proto,
                                   register_function)
    with _pytest.raises(SerializationError):  # unimplemented in ref too
        build_expression_from_proto(_op(pb.DATEDIFF, _var("a"), _var("a")))
    # TOSTRING deserializes to the device ToString (STRING input ->
    # identity; unbounded numerics raise at BIND, not here)
    assert build_expression_from_proto(
        _op(pb.TOSTRING, _var("a"))) is not None
    with _pytest.raises(SerializationError):  # host-side divergence
        build_expression_from_proto(_op(pb.DATE_FORMAT_UTC, _var("a")))
    fd = pb.ExpressionDescription(type=pb.CUSTOM_FUNCTION_CALL)
    fd.function_call.function_name = "double_it"
    fd.function_call.argument.add().CopyFrom(_var("a"))
    with _pytest.raises(SerializationError):
        build_expression_from_proto(fd)
    from supersonic_jax import exprs as E
    register_function("double_it", lambda e: E.Multiply(e, E.ConstInt64(2)))
    out = execute(Compute(build_expression_from_proto(fd),
                          ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [2, None, 6]


def test_proto_path_and_pi():
    pb = _pb()
    from supersonic_jax.io import build_expression_from_proto
    d = pb.ExpressionDescription(type=pb.PATH)
    d.path.node.append("b")
    out = execute(Compute(build_expression_from_proto(d),
                          ScanTable(make_table())))
    assert [r[0] for r in out.to_pylist()] == [1.5, 2.5, None]
    pi = _op(pb.PI)
    out2 = execute(Compute(build_expression_from_proto(pi),
                           ScanTable(make_table())))
    assert abs(out2.to_pylist()[0][0] - 3.141592653589793) < 1e-12


def test_benchmark_join_phase_split():
    """HashJoin nodes report index_set_up_time vs matching_time
    (reference: cursor_statistics.h:153-167, benchmark.proto:40-47)."""
    import numpy as np
    from supersonic_jax import (HashJoin, JoinType, KeyUniqueness,
                                TupleSchema, DataType, Table)

    rng = np.random.default_rng(5)
    n, m = 5000, 500
    fact = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False)),
        {"fk": rng.integers(0, m, n)})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False),
                       ("w", DataType.INT64, False)),
        {"pk": np.arange(m), "w": np.arange(m) * 3})
    join = HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(fact),
                    ScanTable(dim), KeyUniqueness.UNIQUE)
    stats = benchmark_plan(join, iters=1)
    assert stats.index_set_up_time_us is not None
    assert stats.matching_time_us is not None
    assert stats.index_set_up_time_us + stats.matching_time_us \
        <= stats.processing_time_us + 1e-6
    assert "index_set_up" in format_stats(stats)
    # non-join nodes carry no split
    assert stats.children[0].index_set_up_time_us is None

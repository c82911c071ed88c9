"""Expression engine tests, in the style of the reference's
expression_test_helper (SURVEY.md §4.3): evaluate over a literal block and
check values + NULL semantics."""
import math

import pytest

from supersonic_jax import (BOOL, DOUBLE, INT32, INT64, STRING, Case, CastTo,
                            Compute, Const, DataType, DivideNulling,
                            EvaluationError, If, IfNull, In, IsNull, Null,
                            ParseStringNulling, ScanTable, Sequence, Table,
                            TupleSchema, col, execute)


def eval_expr(expr, data=None, schema=None):
    schema = schema or TupleSchema.of(
        ("a", INT64), ("b", INT64), ("x", DOUBLE), ("p", BOOL), ("q", BOOL))
    data = data or {
        "a": [1, 2, None, 4],
        "b": [10, None, 30, 40],
        "x": [0.5, 1.5, 2.5, None],
        "p": [True, False, None, True],
        "q": [None, False, True, False],
    }
    t = Table.from_data(schema, data)
    out = execute(Compute(expr, ScanTable(t)))
    return [r[0] for r in out.to_pylist()]


def test_plus_nulls():
    assert eval_expr(col("a") + col("b")) == [11, None, None, 44]


def test_arith_promotion():
    vals = eval_expr(col("a") + col("x"))
    assert vals[0] == pytest.approx(1.5)
    assert vals[3] is None


def test_literal_sugar():
    assert eval_expr(col("a") * 2) == [2, 4, None, 8]


def test_divide_signaling_raises():
    with pytest.raises(EvaluationError):
        eval_expr(col("a") / (col("a") - col("a")))


def test_divide_nulling():
    assert eval_expr(DivideNulling(col("a"), Const(0))) == [None] * 4
    vals = eval_expr(DivideNulling(col("b"), Const(4)))
    assert vals == [2.5, None, 7.5, 10.0]


def test_comparisons():
    assert eval_expr(col("a") < col("b")) == [True, None, None, True]
    assert eval_expr(col("a").eq(Const(2))) == [False, True, None, False]


def test_ternary_and():
    # reference: F & NULL = F, T & NULL = NULL
    assert eval_expr(col("p") & col("q")) == [None, False, None, False]


def test_ternary_or():
    # T | NULL = T, F | NULL = NULL, NULL | T = T
    assert eval_expr(col("p") | col("q")) == [True, False, True, True]


def test_not():
    assert eval_expr(~col("p")) == [False, True, None, False]


def test_is_null_if_null():
    assert eval_expr(IsNull(col("a"))) == [False, False, True, False]
    assert eval_expr(IfNull(col("a"), Const(0))) == [1, 2, 0, 4]


def test_if():
    vals = eval_expr(If(col("p"), col("a"), col("b")))
    # NULL condition -> else branch
    assert vals == [1, None, 30, 4]


def test_case():
    expr = Case(col("a"), Const(-1), Const(1), Const(100), Const(2), Const(200))
    assert eval_expr(expr) == [100, 200, -1, -1]


def test_in():
    assert eval_expr(In(col("a"), Const(1), Const(4))) == [
        True, False, None, True]


def test_cast():
    vals = eval_expr(CastTo(DataType.DOUBLE, col("a")))
    assert vals == [1.0, 2.0, None, 4.0]


def test_sequence():
    schema = TupleSchema.of(("a", INT64),)
    vals = eval_expr(Sequence(), data={"a": [5, 6, 7]}, schema=schema)
    assert vals == [0, 1, 2]


def test_null_literal():
    assert eval_expr(Null(DataType.INT64)) == [None] * 4


def test_string_equal():
    schema = TupleSchema.of(("s", STRING),)
    vals = eval_expr(col("s").eq(Const("x")),
                     data={"s": ["x", "y", None, "x"]}, schema=schema)
    assert vals == [True, False, None, True]


def test_parse_string():
    schema = TupleSchema.of(("s", STRING),)
    vals = eval_expr(ParseStringNulling(DataType.INT64, col("s")),
                     data={"s": ["12", "oops", None, "-3"]}, schema=schema)
    assert vals == [12, None, None, -3]


def test_string_unify_if():
    schema = TupleSchema.of(("p", BOOL), ("s", STRING), ("t", STRING))
    vals = eval_expr(
        If(col("p"), col("s"), col("t")),
        data={"p": [True, False, True], "s": ["a", "b", "c"],
              "t": ["z", "y", "x"]},
        schema=schema)
    assert vals == ["a", "y", "c"]


def test_modulus():
    assert eval_expr(col("b") % Const(7)) == [3, None, 2, 5]
    # C++ truncation semantics: -7 % 3 == -1
    schema = TupleSchema.of(("a", INT64),)
    assert eval_expr(col("a") % Const(3), data={"a": [-7]}, schema=schema) == [-1]


def test_cpp_division_truncates_toward_zero():
    from supersonic_jax import CppDivide
    schema = TupleSchema.of(("a", INT64),)
    assert eval_expr(CppDivide(col("a"), Const(2)),
                     data={"a": [-3, 3, -4]}, schema=schema) == [-1, 1, -2]


def test_constant_subtrees_fold_in_compiled_hlo():
    """Constant-folding parity (reference: basic_bound_expression.h:44
    can_be_resolved — constant subtrees resolve before evaluation).  Under
    XLA the same guarantee holds at compile time: the optimized HLO of a
    plan containing Const(2) + Const(3) * Const(4) contains the folded
    constant and no multiply at all; the only add left is the one that
    touches the data column."""
    import re

    import jax

    from supersonic_jax import Compute, Const, ScanTable
    from supersonic_jax.ops.base import compile_plan

    t = Table.from_data(TupleSchema.of(("a", INT64)), {"a": [1, 2, 3]})
    plan = Compute((col("a") + (Const(2) + Const(3) * Const(4))).as_("o"),
                   ScanTable(t))
    run, _bound, leaves = compile_plan(plan)
    hlo = jax.jit(run).lower(leaves).compile().as_text()
    assert len(re.findall(r" multiply\(", hlo)) == 0
    assert len(re.findall(r" add\(", hlo)) == 1
    assert "14" in hlo  # the folded constant is embedded

    # a fully-constant expression leaves no arithmetic at all
    plan2 = Compute((Const(10) * Const(5) - Const(8)).as_("o"),
                    ScanTable(t))
    run2, _b2, leaves2 = compile_plan(plan2)
    hlo2 = jax.jit(run2).lower(leaves2).compile().as_text()
    assert len(re.findall(r" (multiply|subtract)\(", hlo2)) == 0
    assert "42" in hlo2

"""Math expressions (reference: expression/core/math_expressions.h,
math_evaluators.h): exp/log family, sqrt/pow, rounding family, abs,
float classification, trig/hyperbolic.

Error policies follow the reference naming: Signaling variants flag
domain errors (device error flag -> host exception), Nulling variants
yield NULL, Quiet variants yield whatever IEEE produces (nan/inf).
"""
from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from ..schema import Attribute
from ..types import DataType, TypeError_, is_floating, is_numeric, jnp_dtype
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   merge_valid, wrap)


def _unary_float(op_name: str, fn: Callable, domain=None, policy: str = "quiet",
                 out_type: DataType | None = None):
    """Factory for unary float-valued expressions.

    domain(x) -> bool array of *valid-domain* rows (None = total function).
    """

    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            if not is_numeric(cb.type):
                raise TypeError(f"{op_name} requires numeric input")
            rt = out_type or DataType.DOUBLE
            dt = jnp_dtype(rt)
            adds_null = policy == "nulling" and domain is not None
            nullable = cb.nullable or adds_null

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                x = v.values.astype(jnp_dtype(DataType.DOUBLE))
                ok = None
                if domain is not None:
                    ok = domain(x)
                    if policy == "signaling":
                        bad = ~ok if v.valid is None else (~ok & v.valid)
                        ctx.flag_error(f"{op_name} domain error", bad)
                        ok = None
                    elif policy == "quiet":
                        ok = None
                y = fn(x).astype(dt)
                return ExprValue(y, merge_valid(v.valid, ok))

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", rt, nullable), f)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


# exp / log family
Exp = _unary_float("EXP", jnp.exp)
Ln = _unary_float("LN", jnp.log, domain=lambda x: x > 0, policy="quiet")
LnNulling = _unary_float("LN_NULLING", jnp.log, domain=lambda x: x > 0,
                         policy="nulling")
LnSignaling = _unary_float("LN_SIGNALING", jnp.log, domain=lambda x: x > 0,
                           policy="signaling")
Log10 = _unary_float("LOG10", jnp.log10, domain=lambda x: x > 0)
Log10Nulling = _unary_float("LOG10_NULLING", jnp.log10,
                            domain=lambda x: x > 0, policy="nulling")
Log2 = _unary_float("LOG2", jnp.log2, domain=lambda x: x > 0)
Log2Nulling = _unary_float("LOG2_NULLING", jnp.log2,
                           domain=lambda x: x > 0, policy="nulling")
Sqrt = _unary_float("SQRT", jnp.sqrt, domain=lambda x: x >= 0)
SqrtNulling = _unary_float("SQRT_NULLING", jnp.sqrt,
                           domain=lambda x: x >= 0, policy="nulling")
SqrtSignaling = _unary_float("SQRT_SIGNALING", jnp.sqrt,
                             domain=lambda x: x >= 0, policy="signaling")

# trig
Sin = _unary_float("SIN", jnp.sin)
Cos = _unary_float("COS", jnp.cos)
Tan = _unary_float("TAN", jnp.tan)
Asin = _unary_float("ASIN", jnp.arcsin)
Acos = _unary_float("ACOS", jnp.arccos)
Atan = _unary_float("ATAN", jnp.arctan)
Sinh = _unary_float("SINH", jnp.sinh)
Cosh = _unary_float("COSH", jnp.cosh)
Tanh = _unary_float("TANH", jnp.tanh)
Asinh = _unary_float("ASINH", jnp.arcsinh)
Acosh = _unary_float("ACOSH", jnp.arccosh)
Atanh = _unary_float("ATANH", jnp.arctanh)


class Log(Expression):
    """LOG(base, x) (reference: math_expressions.h Log)."""

    def __init__(self, base, x):
        self.base = wrap(base)
        self.x = wrap(x)

    def do_bind(self, schema, dicts):
        bb = self.base.do_bind(schema, dicts)
        xb = self.x.do_bind(schema, dicts)

        def f(ctx):
            b = bb.evaluate(ctx)
            x = xb.evaluate(ctx)
            bd = b.values.astype(jnp.float64)
            xd = x.values.astype(jnp.float64)
            y = jnp.log(xd) / jnp.log(bd)
            return ExprValue(y, merge_valid(b.valid, x.valid))

        return BoundExpression(
            Attribute(f"LOG({bb.name}, {xb.name})", DataType.DOUBLE,
                      bb.nullable or xb.nullable), f)


def _pow_expr(policy: str):
    """POWER(base, exponent) with the reference's three failure policies
    (expression_traits.h:1329-1370): the domain violation is base < 0
    with a NON-INTEGER exponent — quiet keeps C pow's NaN, nulling turns
    the row NULL (FirstColumnNegativeAndSecondNonIntegerNuller),
    signaling fails the evaluation (...Failer)."""

    class _Pow(Expression):
        def __init__(self, base, exponent):
            self.base = wrap(base)
            self.exponent = wrap(exponent)

        def do_bind(self, schema, dicts):
            bb = self.base.do_bind(schema, dicts)
            eb = self.exponent.do_bind(schema, dicts)
            nullable = (bb.nullable or eb.nullable
                        or policy == "nulling")

            def f(ctx):
                b = bb.evaluate(ctx)
                e = eb.evaluate(ctx)
                bd = b.values.astype(jnp.float64)
                ed = e.values.astype(jnp.float64)
                y = jnp.power(bd, ed)
                valid = merge_valid(b.valid, e.valid)
                if policy != "quiet":
                    bad = (bd < 0) & (ed != jnp.floor(ed))
                    if policy == "nulling":
                        valid = merge_valid(valid, ~bad)
                    else:
                        live = (bad if valid is None else (bad & valid))
                        ctx.flag_error(
                            f"POW({bb.name}, {eb.name}): negative base "
                            "with non-integer exponent", live)
                return ExprValue(y, valid)

            return BoundExpression(
                Attribute(f"POW({bb.name}, {eb.name})", DataType.DOUBLE,
                          nullable), f)

    _Pow.__name__ = f"Pow{policy.title()}"
    return _Pow


PowQuiet = _pow_expr("quiet")
PowNulling = _pow_expr("nulling")
PowSignaling = _pow_expr("signaling")
Pow = PowQuiet


def _rounding(op_name: str, fn: Callable):
    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            # integers are already round (reference returns them unchanged)
            if not is_floating(cb.type):
                return cb

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                return ExprValue(fn(v.values), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", cb.type, cb.nullable), f)

    _Op.__name__ = op_name.title()
    return _Op


Round = _rounding("ROUND", lambda x: jnp.where(
    x - jnp.floor(x) == 0.5, jnp.where(x >= 0, jnp.floor(x) + 1, jnp.floor(x)),
    jnp.round(x)))  # C++ round(): halves away from zero... see below
Ceil = _rounding("CEIL", jnp.ceil)
Floor = _rounding("FLOOR", jnp.floor)
Trunc = _rounding("TRUNC", jnp.trunc)


class RoundToInt(Expression):
    """ROUND_TO_INT -> INT64 (reference: math_expressions.h RoundToInt),
    C++ lround semantics: halves away from zero."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            x = v.values.astype(jnp.float64)
            y = jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))
            return ExprValue(y.astype(jnp.int64), v.valid)

        return BoundExpression(
            Attribute(f"ROUND_TO_INT({cb.name})", DataType.INT64,
                      cb.nullable), f)


class RoundWithPrecision(Expression):
    def __init__(self, child, precision: int):
        self.child = wrap(child)
        self.precision = precision

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        scale = 10.0 ** self.precision

        def f(ctx):
            v = cb.evaluate(ctx)
            x = v.values.astype(jnp.float64) * scale
            y = jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))
            return ExprValue(y / scale, v.valid)

        return BoundExpression(
            Attribute(f"ROUND_WITH_PRECISION({cb.name})", DataType.DOUBLE,
                      cb.nullable), f)


class Abs(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        rt = cb.type
        if rt == DataType.INT32:
            rt = DataType.INT32
        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(jnp.abs(v.values), v.valid)

        return BoundExpression(Attribute(f"ABS({cb.name})", rt, cb.nullable), f)


def _classify(op_name: str, fn: Callable):
    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                x = v.values
                if not jnp.issubdtype(x.dtype, jnp.floating):
                    x = x.astype(jnp.float64)
                return ExprValue(fn(x), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", DataType.BOOL,
                          cb.nullable), f)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


IsNaN = _classify("IS_NAN", jnp.isnan)
IsInf = _classify("IS_INF", jnp.isinf)
IsFinite = _classify("IS_FINITE", jnp.isfinite)
# normal = finite, not zero, not subnormal (std::isnormal)
IsNormal = _classify(
    "IS_NORMAL",
    lambda x: jnp.isfinite(x) & (jnp.abs(x) >= jnp.finfo(x.dtype).tiny))


class Format(Expression):
    """FORMAT(number, precision) -> STRING: fixed-point decimal rendering,
    precision clamped at >= 0 (reference: math_expressions.h:115 Format,
    math_evaluators.h:39-59 snprintf "%.*f").

    Device encoding exists only when the number is constant (folds to a
    Const string) or dictionary-backed; an unbounded numeric column has no
    dense device string encoding, so bind fails pointing at the host
    materialization path (ops/host.py::format_number), mirroring ToString.
    """

    def __init__(self, number, precision):
        self.number = wrap(number)
        self.precision = wrap(precision)

    def do_bind(self, schema, dicts):
        from .terminal import Const

        nb = self.number.do_bind(schema, dicts)
        pb = self.precision.do_bind(schema, dicts)
        if not pb.is_constant or not isinstance(self.precision, Const):
            raise TypeError_(
                "FORMAT precision must be a constant (host-side rendering "
                "is bound per precision)")
        prec = max(int(self.precision.value), 0)
        if nb.is_constant and isinstance(self.number, Const):
            return Const(f"%.{prec}f" % float(self.number.value)).do_bind(
                schema, dicts)
        # non-constant column: deferred-dictionary rendering — device
        # column carries row-position codes, execute() renders "%.*f"
        # per row after the run (ops/host.py)
        from ..dictionary import DeferredDictionary
        from .base import defer_render

        d = DeferredDictionary()
        nm = f"FORMAT({nb.name}, {prec})"

        def g(ctx) -> "ExprValue":
            v = nb.evaluate(ctx)
            ok = ctx.table.row_mask() & v.valid_or_true()
            codes = defer_render(ctx, d, nm, "format", nb.type,
                                 v.values, ok, precision=prec)
            return ExprValue(codes, v.valid)

        return BoundExpression(
            Attribute(nm, DataType.STRING, nb.nullable), g, d)


FormatSignaling = Format  # reference: OPERATOR_FORMAT_SIGNALING


Cot = _unary_float("COT", lambda x: 1.0 / jnp.tan(x))


class Atan2(Expression):
    """ATAN2(x, y) -> atan2(x, y) (reference: math_expressions.h:63,
    math_evaluators.h:174)."""

    def __init__(self, x, y):
        self.x = wrap(x)
        self.y = wrap(y)

    def do_bind(self, schema, dicts):
        xb = self.x.do_bind(schema, dicts)
        yb = self.y.do_bind(schema, dicts)

        def f(ctx):
            xv = xb.evaluate(ctx)
            yv = yb.evaluate(ctx)
            out = jnp.arctan2(xv.values.astype(jnp.float64),
                              yv.values.astype(jnp.float64))
            return ExprValue(out, merge_valid(xv.valid, yv.valid))

        return BoundExpression(
            Attribute(f"ATAN2({xb.name}, {yb.name})", DataType.DOUBLE,
                      xb.nullable or yb.nullable), f)


def _to_int_expr(op_name: str, fn):
    """float -> INT64 rounding family (reference: math_evaluators.h:87-103
    CeilToInt/FloorToInt: C-style cast of ceil/floor)."""

    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)

            def f(ctx):
                v = cb.evaluate(ctx)
                x = v.values.astype(jnp.float64)
                return ExprValue(fn(x).astype(jnp.int64), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", DataType.INT64,
                          cb.nullable), f)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


CeilToInt = _to_int_expr("CEIL_TO_INT", jnp.ceil)
FloorToInt = _to_int_expr("FLOOR_TO_INT", jnp.floor)
TruncToInt = _to_int_expr("TRUNC_TO_INT", jnp.trunc)


class RoundWithMultiplier(Expression):
    """ROUND_WITH_MULTIPLIER(arg, mult) = round(arg*mult)/mult
    (reference: math_evaluators.h:117, OPERATOR_ROUND_WITH_MULTIPLIER)."""

    def __init__(self, child, multiplier):
        self.child = wrap(child)
        self.multiplier = wrap(multiplier)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        mb = self.multiplier.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            m = mb.evaluate(ctx)
            x = v.values.astype(jnp.float64)
            mm = m.values.astype(jnp.float64)
            # C round(): halves away from zero
            y = x * mm
            r = jnp.where(y >= 0, jnp.floor(y + 0.5), jnp.ceil(y - 0.5))
            return ExprValue(r / mm, merge_valid(v.valid, m.valid))

        return BoundExpression(
            Attribute(f"ROUND_WITH_MULTIPLIER({cb.name})", DataType.DOUBLE,
                      cb.nullable or mb.nullable), f)


# Log with an arbitrary base: policy variants (reference:
# math_expressions.h:49-52 LogNulling/LogQuiet; enum also reserves
# OPERATOR_LOG_SIGNALING).  Quiet == Log (IEEE nan/inf out of domain).
LogQuiet = Log


class LogNulling(Expression):
    """LOG(base, x) yielding NULL outside the domain (x>0, base>0,
    base!=1)."""

    def __init__(self, base, x):
        self.base = wrap(base)
        self.x = wrap(x)

    def do_bind(self, schema, dicts):
        bb = self.base.do_bind(schema, dicts)
        xb = self.x.do_bind(schema, dicts)

        def f(ctx):
            b = bb.evaluate(ctx)
            x = xb.evaluate(ctx)
            bd = b.values.astype(jnp.float64)
            xd = x.values.astype(jnp.float64)
            ok = (xd > 0) & (bd > 0) & (bd != 1.0)
            y = jnp.log(jnp.where(ok, xd, 1.0)) / jnp.log(
                jnp.where(ok, bd, 2.0))
            valid = merge_valid(b.valid, x.valid, ok)
            return ExprValue(y, valid)

        return BoundExpression(
            Attribute(f"LOG_NULLING({bb.name}, {xb.name})", DataType.DOUBLE,
                      True), f)


LnQuiet = Ln
Log10Quiet = Log10
Log2Quiet = Log2
Log10Signaling = _unary_float("LOG10_SIGNALING", jnp.log10,
                              domain=lambda x: x > 0, policy="signaling")
Log2Signaling = _unary_float("LOG2_SIGNALING", jnp.log2,
                             domain=lambda x: x > 0, policy="signaling")


SqrtQuiet = Sqrt  # reference: OPERATOR_SQRT_QUIET


def Pi():
    """DOUBLE constant pi (reference: math_expressions.h Pi)."""
    import math as _math

    from .terminal import Const

    return Const(_math.pi, DataType.DOUBLE)


# reference naming variants (math_expressions.h Power* == Pow*)
PowerSignaling = PowSignaling
PowerNulling = PowNulling
PowerQuiet = PowQuiet

ToDegrees = _unary_float("TO_DEGREES", lambda x: x * (180.0 / jnp.pi))
ToRadians = _unary_float("TO_RADIANS", lambda x: x * (jnp.pi / 180.0))


class RandomDouble(Expression):
    """Uniform [0, 1) DOUBLE per row (reference: math_expressions.h:128-130
    — declared there but never implemented; implemented here with the
    same contract as RandInt32: deterministic per (seed, row index))."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def do_bind(self, schema, dicts):
        import jax as _jax

        seed = self.seed

        def fn(ctx: EvalContext) -> ExprValue:
            cap = ctx.table.capacity
            key = _jax.random.PRNGKey(seed)
            vals = _jax.random.uniform(key, (cap,), dtype=jnp.float64)
            return ExprValue(vals, None)

        return BoundExpression(
            Attribute("RANDOM_DOUBLE", DataType.DOUBLE, False), fn)

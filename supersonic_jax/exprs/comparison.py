"""Comparison expressions (reference: expression/core/comparison_expressions.h).

Cross-signedness comparisons are made safe by promoting to a common type
(reference: operators.h safe signed/unsigned cross-compare).  Comparing
STRING columns compares dictionary codes, which is order-correct because
dictionaries are order-preserving — but only when both sides share one
dictionary; mixed-dictionary compares are re-encoded at bind time.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..dictionary import merge as dict_merge
from ..schema import Attribute
from ..types import DataType, common_numeric_type, is_numeric, jnp_dtype
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   expr_name, merge_valid, wrap)
from ..batch import take_clipped


def _comparable_pair(lb: BoundExpression, rb: BoundExpression):
    """Returns fn(ctx) -> (a, b, valid) with a, b directly comparable."""
    lt, rt = lb.type, rb.type
    if lt in (DataType.STRING, DataType.BINARY) or rt in (DataType.STRING, DataType.BINARY):
        if lt != rt:
            raise TypeError(f"cannot compare {lt} with {rt}")
        same = lb.dictionary is rb.dictionary and lb.dictionary is not None
        if same:
            def get(ctx):
                lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
                return lv.values, rv.values, merge_valid(lv.valid, rv.valid)
            return get
        # Different dictionaries: remap both into a merged one at bind time.
        da = lb.dictionary
        db = rb.dictionary
        if da is None or db is None:
            raise TypeError("string comparison requires bound dictionaries")
        _, ra, rbm = dict_merge(da, db)
        ra_j, rb_j = jnp.asarray(ra), jnp.asarray(rbm)

        def get(ctx):
            lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
            a = take_clipped(ra_j, lv.values)
            b = take_clipped(rb_j, rv.values)
            return a, b, merge_valid(lv.valid, rv.valid)
        return get
    # ENUM compares as its int32 code space (against ENUM or integers)
    def _as_num(t):
        return DataType.INT32 if t == DataType.ENUM else t
    lt, rt = _as_num(lt), _as_num(rt)
    if is_numeric(lt) and is_numeric(rt):
        common = common_numeric_type(lt, rt)
        dt = jnp_dtype(common)
    elif lt == rt:
        dt = jnp_dtype(lt)
    elif {lt, rt} == {DataType.DATE, DataType.DATETIME}:
        dt = jnp_dtype(DataType.DATETIME)
        # DATE days -> DATETIME microseconds for comparison
        def get(ctx):
            lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
            a = lv.values.astype(dt)
            b = rv.values.astype(dt)
            if lt == DataType.DATE:
                a = a * (86400_000_000)
            if rt == DataType.DATE:
                b = b * (86400_000_000)
            return a, b, merge_valid(lv.valid, rv.valid)
        return get
    else:
        raise TypeError(f"cannot compare {lt} with {rt}")

    def get(ctx):
        lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
        return lv.values.astype(dt), rv.values.astype(dt), merge_valid(lv.valid, rv.valid)
    return get


class _Comparison(Expression):
    op_name = "?"

    def __init__(self, left, right):
        self.left = wrap(left)
        self.right = wrap(right)

    @staticmethod
    def cmp(a, b):
        raise NotImplementedError

    def do_bind(self, schema, dicts):
        lb = self.left.do_bind(schema, dicts)
        rb = self.right.do_bind(schema, dicts)
        get = _comparable_pair(lb, rb)
        name = expr_name(self.op_name, [lb, rb])
        cmp = self.cmp

        def fn(ctx: EvalContext) -> ExprValue:
            a, b, valid = get(ctx)
            return ExprValue(cmp(a, b), valid)

        return BoundExpression(
            Attribute(name, DataType.BOOL, lb.nullable or rb.nullable), fn
        )


class Equal(_Comparison):
    op_name = "EQUAL"
    cmp = staticmethod(lambda a, b: a == b)

class NotEqual(_Comparison):
    op_name = "NOT_EQUAL"
    cmp = staticmethod(lambda a, b: a != b)

class Less(_Comparison):
    op_name = "LESS"
    cmp = staticmethod(lambda a, b: a < b)

class LessOrEqual(_Comparison):
    op_name = "LESS_OR_EQUAL"
    cmp = staticmethod(lambda a, b: a <= b)

class Greater(_Comparison):
    op_name = "GREATER"
    cmp = staticmethod(lambda a, b: a > b)

class GreaterOrEqual(_Comparison):
    op_name = "GREATER_OR_EQUAL"
    cmp = staticmethod(lambda a, b: a >= b)


class In(Expression):
    """needle IN (haystack exprs...) (reference: comparison_expressions.h:88).

    SQL semantics: TRUE if any candidate equals; NULL if no match but some
    candidate (or the needle) was NULL; FALSE otherwise.
    """

    def __init__(self, needle, *candidates):
        self.needle = wrap(needle)
        self.candidates = [wrap(c) for c in candidates]

    def do_bind(self, schema, dicts):
        nb = self.needle.do_bind(schema, dicts)
        cbs = [c.do_bind(schema, dicts) for c in self.candidates]
        getters = [_comparable_pair(nb, cb) for cb in cbs]
        nullable = nb.nullable or any(c.nullable for c in cbs)

        def fn(ctx: EvalContext) -> ExprValue:
            cap = ctx.table.capacity
            matched = jnp.zeros(cap, dtype=jnp.bool_)
            any_null_candidate = jnp.zeros(cap, dtype=jnp.bool_)
            needle_valid = None
            for get, cb in zip(getters, cbs):
                a, b, _ = get(ctx)
                nv = nb.evaluate(ctx)
                cv = cb.evaluate(ctx)
                needle_valid = nv.valid
                cand_valid = cv.valid_or_true() if cv.valid is not None else None
                eq = (a == b)
                if cand_valid is not None:
                    matched = matched | (eq & cand_valid)
                    any_null_candidate = any_null_candidate | ~cand_valid
                else:
                    matched = matched | eq
            if needle_valid is None and nb.nullable:
                needle_valid = nb.evaluate(ctx).valid
            valid = matched | ~any_null_candidate
            if needle_valid is not None:
                valid = valid & needle_valid
            if not nullable:
                valid = None
            return ExprValue(matched, valid)

        name = f"IN({nb.name})"
        return BoundExpression(Attribute(name, DataType.BOOL, nullable), fn)


class IsOdd(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def fn(ctx):
            v = cb.evaluate(ctx)
            return ExprValue((v.values % 2) != 0, v.valid)

        return BoundExpression(
            Attribute(f"IS_ODD({cb.name})", DataType.BOOL, cb.nullable), fn)


class IsEven(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def fn(ctx):
            v = cb.evaluate(ctx)
            return ExprValue((v.values % 2) == 0, v.valid)

        return BoundExpression(
            Attribute(f"IS_EVEN({cb.name})", DataType.BOOL, cb.nullable), fn)

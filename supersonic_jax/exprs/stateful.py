"""Stateful (cross-row, order-dependent) expressions.

Reference: expression/core/stateful_expressions.h:39-69 — Changed,
RunningSum, Smudge (copy last non-NULL down), RunningMinWithFlush,
SmudgeIf.  The reference threads state across views with a
DoubleBufferedBlock (sequential, one row at a time); on the device each becomes a
parallel cumulative op — ``cumsum`` or ``associative_scan`` with a
segmented-combine — over the whole column.  Live rows are a dense prefix,
so trailing padding never affects prefix state.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..schema import Attribute
from ..types import DataType, TypeError_
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   wrap)
from ..ops.keys import monotone_code


class Changed(Expression):
    """TRUE where the value differs from the previous row (first row TRUE);
    NULL == NULL counts as unchanged (reference: Changed)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            code = monotone_code(v.values, cb.type)
            valid = v.valid_or_true()
            prev_code = jnp.roll(code, 1)
            prev_valid = jnp.roll(valid, 1)
            same = (code == prev_code) & (valid == prev_valid)
            same = same | (~valid & ~prev_valid)  # NULL == NULL
            pos = jnp.arange(code.shape[0])
            changed = ~same | (pos == 0)
            return ExprValue(changed, None)

        return BoundExpression(
            Attribute(f"CHANGED({cb.name})", DataType.BOOL, False), f)


class RunningSum(Expression):
    """Cumulative sum: NULL inputs are ignored (treated as zero) and the
    output stays NULL only until the first non-NULL value appears
    (reference contract: stateful_expressions.h:41-45)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx: EvalContext) -> ExprValue:
            from ..ops.segscan import seg_cumsum
            v = cb.evaluate(ctx)
            valid = v.valid_or_true()
            contrib = jnp.where(valid, v.values, jnp.zeros_like(v.values))
            # blocked scan (ops/segscan.py), not a 64-bit jnp.cumsum
            no_reset = jnp.zeros(contrib.shape[0], dtype=jnp.bool_)
            sums = seg_cumsum(contrib, no_reset)
            out_valid = None
            if v.valid is not None:
                # NULL only before the first non-NULL value
                from ..ops.scan32 import cumsum_i32
                out_valid = cumsum_i32(valid) > 0
            return ExprValue(sums, out_valid)

        return BoundExpression(
            Attribute(f"RUNNING_SUM({cb.name})", cb.type, cb.nullable), f)


def _forward_fill(values: jnp.ndarray, valid: jnp.ndarray):
    """(value, valid) -> last-valid-so-far per row.

    The last-valid fill IS the segmented carry-first scan with the valid
    flag playing the reset role: value = valid_b ? v_b : carried.
    """
    from ..ops.segscan import _seg_scan

    filled = _seg_scan(values, valid, "first")
    from ..ops.scan32 import cumsum_i32
    seen = cumsum_i32(valid) > 0
    return filled, seen


class Smudge(Expression):
    """Copy the last non-NULL value down into NULL rows (reference:
    Smudge); leading NULLs stay NULL."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            valid = v.valid_or_true()
            filled, seen = _forward_fill(v.values, valid)
            return ExprValue(filled, seen if cb.nullable else None)

        return BoundExpression(
            Attribute(f"SMUDGE({cb.name})", cb.type, cb.nullable), f)


class SmudgeIf(Expression):
    """Where condition is TRUE, replace the value (and validity) with the
    previous not-smudged row's (reference: SmudgeIf)."""

    def __init__(self, child, condition):
        self.child = wrap(child)
        self.condition = wrap(condition)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        db = self.condition.do_bind(schema, dicts)
        if db.type != DataType.BOOL:
            raise TypeError_("SmudgeIf condition must be BOOL")

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            c = db.evaluate(ctx)
            keep = ~(c.values & c.valid_or_true())  # rows that keep their own
            filled_vals, any_kept = _forward_fill(v.values, keep)
            filled_valid, _ = _forward_fill(v.valid_or_true(), keep)
            out_vals = jnp.where(keep, v.values, filled_vals)
            out_valid = jnp.where(keep, v.valid_or_true(),
                                  filled_valid & any_kept)
            return ExprValue(out_vals, out_valid)

        return BoundExpression(
            Attribute(f"SMUDGE_IF({cb.name})", cb.type, True), f)


class RunningMinWithFlush(Expression):
    """Running minimum that resets after rows where flush is TRUE
    (reference: RunningMinWithFlush): output at each row is min of values
    since the last flush (inclusive of current row)."""

    def __init__(self, flush, child):
        self.flush = wrap(flush)
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        fb = self.flush.do_bind(schema, dicts)
        cb = self.child.do_bind(schema, dicts)
        if fb.type != DataType.BOOL:
            raise TypeError_("RunningMinWithFlush flush must be BOOL")
        from ..ops.aggregate import _min_identity

        def f(ctx: EvalContext) -> ExprValue:
            from ..ops.segscan import seg_cummax, seg_cummin
            v = cb.evaluate(ctx)
            fl = fb.evaluate(ctx)
            valid = v.valid_or_true()
            vals = jnp.where(valid, v.values, _min_identity(v.values.dtype))
            # segment restarts AFTER a flushed row: shift flush by one
            reset = jnp.roll(fl.values & fl.valid_or_true(), 1)
            reset = reset.at[0].set(True)
            m = seg_cummin(vals, reset)
            seen_valid = seg_cummax(valid.astype(jnp.int32), reset) > 0
            return ExprValue(m, seen_valid if cb.nullable else None)

        return BoundExpression(
            Attribute(f"RUNNING_MIN_WITH_FLUSH({cb.name})", cb.type,
                      cb.nullable), f)

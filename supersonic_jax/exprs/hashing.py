"""Row hashing / fingerprint expressions.

Reference: expression/ext/hashing/hashing_expressions.h:37-40 —
``Hash(expr)`` (per-value hash) and ``Fingerprint(exprs...)`` (combined
row fingerprint).  The reference uses std::hash / MurmurHash64; output
equivalence only requires a deterministic well-mixed hash, not the same
values (SURVEY.md §1.1), so this uses the engine's 32-bit mixers widened
to UINT64.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..schema import Attribute
from ..types import DataType
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   merge_valid, wrap)
from ..ops.keys import monotone_code
from ..parallel.hashing import _fold32, _mix32


def _hash_one(bound, ctx: EvalContext):
    v = bound.evaluate(ctx)
    code = monotone_code(v.values, bound.type)
    h = _mix32(_fold32(code))
    if v.valid is not None:
        h = jnp.where(v.valid, h, jnp.uint32(0xDEADBABE))
    return h, v.valid


class Hash(Expression):
    """Per-value hash -> UINT64; NULL hashes to a fixed sentinel
    (reference: types_infrastructure.h:440 NULL -> 0xdeadbabe)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def fn(ctx: EvalContext) -> ExprValue:
            h, _ = _hash_one(cb, ctx)
            return ExprValue(h.astype(jnp.uint64), None)

        return BoundExpression(
            Attribute(f"HASH({cb.name})", DataType.UINT64, False), fn)


class Fingerprint(Expression):
    """Combined row fingerprint over one or more expressions -> UINT64
    (reference: Fingerprint; combine h = h*29 + item,
    types_infrastructure.h:410-440)."""

    def __init__(self, *children):
        self.children = [wrap(c) for c in children]

    def do_bind(self, schema, dicts):
        bounds = [c.do_bind(schema, dicts) for c in self.children]
        name = f"FINGERPRINT({', '.join(b.name for b in bounds)})"

        def fn(ctx: EvalContext) -> ExprValue:
            h = None
            for b in bounds:
                hb, _ = _hash_one(b, ctx)
                h = hb if h is None else h * jnp.uint32(29) + hb
            return ExprValue(_mix32(h).astype(jnp.uint64), None)

        return BoundExpression(Attribute(name, DataType.UINT64, False), fn)


SupersonicFingerprint = Fingerprint  # reference: hashing_expressions.h:28
#   (the "Supersonic" prefix avoided a google3 util/hash name collision)


class SupersonicHash(Expression):
    """HASH(e, seed) -> UINT64 (reference: hashing_expressions.h:35-36,
    Hash64StringWithSeed-style seeded hash).  Hash VALUES intentionally
    differ from the reference (SURVEY §1.1: only the mixing contract
    matters); the seed is folded into the per-value mix."""

    def __init__(self, child, seed):
        self.child = wrap(child)
        self.seed = wrap(seed)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        sb = self.seed.do_bind(schema, dicts)

        def fn(ctx: EvalContext) -> ExprValue:
            h, _ = _hash_one(cb, ctx)
            s = sb.evaluate(ctx)
            sh = _mix32(_fold32(monotone_code(s.values, sb.type)))
            out = _mix32(h ^ sh)
            return ExprValue(out.astype(jnp.uint64), None)

        return BoundExpression(
            Attribute(f"HASH({cb.name}, {sb.name})", DataType.UINT64,
                      False), fn)

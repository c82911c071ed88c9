"""Limit / offset row windowing (reference: cursor/core/limit.cc:42)."""
from __future__ import annotations

import jax.numpy as jnp

from ..batch import Table, gather_table
from .base import BindContext, BoundOperation, Operation, RunContext


class Limit(Operation):
    def __init__(self, offset: int, limit: int, child):
        self.offset = offset
        self.limit = limit
        self.child = child

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        offset, limit = self.offset, self.limit
        out_cap = min(cb.capacity, max(limit, 1))

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            n = jnp.minimum(jnp.maximum(t.num_rows - offset, 0), limit)
            idx = jnp.arange(out_cap, dtype=jnp.int32) + offset
            idx = jnp.where(
                jnp.arange(out_cap, dtype=jnp.int32)
                < jnp.asarray(n, jnp.int32), idx, t.capacity)
            if len(cb.schema) == 0:
                return Table(cb.schema, {}, n, dict(t.dicts), cap_hint=out_cap)
            return gather_table(t, idx, n)

        return BoundOperation(cb.schema, cb.dicts, fn, out_cap,
                              stats=dict(cb.stats))

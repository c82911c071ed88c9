"""Filter: BOOL predicate -> compacted survivors.

Reference: cursor/core/filter.cc:65-230 — evaluate predicate (NULL counts
as false, filter.cc:169-198), build a selection row-id list, gather
surviving rows.  Device redesign: survivors move to a dense prefix by
stable compaction (``compact_by_mask``), with ``compaction_indices`` as
the selection-vector primitive for consumers that need explicit row
ids — no branchy row loop.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..batch import Column, Table
from ..exprs.base import Expression
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext


def compaction_indices(mask: jnp.ndarray, out_capacity: int):
    """Stable selection vector of True positions.

    Returns (indices[out_capacity] with out-of-range sentinel padding,
    count).  This is the reference's PrepareInputRowIds
    (filter.cc:169-198) as a data-parallel primitive.
    """
    cap = mask.shape[0]
    # int32 cumsum + scatter (jnp.nonzero's index cumsum is int64 under
    # x64)
    from .scan32 import cumsum_i32
    pos = cumsum_i32(mask) - 1
    iota = jnp.arange(cap, dtype=jnp.int32)
    scatter_idx = jnp.where(mask & (pos < out_capacity), pos, out_capacity)
    idx = jnp.full(out_capacity, cap, dtype=jnp.int32).at[scatter_idx].set(
        iota, mode="drop")
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32), dtype=jnp.int32), out_capacity)
    return idx, count


def compact_arrays(payload: list[jnp.ndarray], mask: jnp.ndarray,
                   out_cap: int) -> list[jnp.ndarray]:
    """Stable-compact rows where ``mask`` is True to a dense prefix of
    each payload array (raw-array engine behind ``compact_by_mask``).
    Survivor i moves to slot (count of survivors before it): one i32
    cumsum, then one scatter per payload whose indices are unique
    (dropped rows aim past the output, each at its own slot).  Entries
    past the survivor count are unspecified."""
    from .scan32 import cumsum_i32
    cap = mask.shape[0]
    pos = cumsum_i32(mask) - 1
    dest = jnp.where(mask & (pos < out_cap), pos,
                     out_cap + jnp.arange(cap, dtype=jnp.int32))
    return [jnp.zeros(out_cap, p.dtype).at[dest].set(
        p, mode="drop", unique_indices=True) for p in payload]


def compact_by_mask(table: Table, mask: jnp.ndarray,
                    out_capacity: int | None = None) -> Table:
    """Move rows where mask is True into a dense prefix (see
    ``compact_arrays``)."""
    out_cap = out_capacity or table.capacity
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32), dtype=jnp.int32), out_cap)
    if len(table.schema) == 0:
        return Table(table.schema, {}, count, dict(table.dicts),
                     cap_hint=out_cap)
    payload: list[jnp.ndarray] = []
    layout: list[tuple[str, bool]] = []  # (name, has_valid)
    for name in table.schema.names():
        c = table.columns[name]
        payload.append(c.values)
        if c.valid is not None:
            payload.append(c.valid)
            layout.append((name, True))
        else:
            layout.append((name, False))

    sorted_cols = compact_arrays(payload, mask, out_cap)
    cols: dict[str, Column] = {}
    i = 0
    for name, has_valid in layout:
        vals = sorted_cols[i]
        i += 1
        valid = None
        if has_valid:
            valid = sorted_cols[i]
            i += 1
        cols[name] = Column(vals, valid)
    return Table(table.schema, cols, count, dict(table.dicts),
                 cap_hint=out_cap)


def unwrap_filters(op):
    """Peel Filter wrappers off a plan node: (inner_child, [predicates]).

    Sort / GroupAggregate / HashJoin fuse a child Filter by folding the
    predicate into their own sort's pad key — the filtered rows sort last
    and are excluded by the valid-row count, so the compaction
    disappears entirely (reference analogue: Supersonic pipelines the
    filter per view; here the fusion is across operators).
    """
    preds = []
    while isinstance(op, Filter):
        preds.append(op.predicate)
        op = op.child
    return op, preds


def bind_predicates(preds, cb):
    from ..types import DataType as _DT, TypeError_
    bounds = []
    for p in preds:
        b = p.bind(cb.schema, cb.dicts)
        if b.type != _DT.BOOL:
            raise TypeError_(f"filter predicate must be BOOL, got {b.type}")
        bounds.append(b)
    return bounds


def keep_mask(bound_preds, rctx, t: Table) -> jnp.ndarray:
    """row_mask AND all predicates (NULL counts as false)."""
    keep = t.row_mask()
    ectx = rctx.eval_context(t)
    for b in bound_preds:
        v = b.evaluate(ectx)
        keep = keep & v.values & v.valid_or_true()
    return keep


class Filter(Operation):
    def __init__(self, predicate: Expression, child: Operation,
                 out_capacity: int | None = None):
        self.predicate = predicate
        self.child = child
        self.out_capacity = out_capacity

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        pred = self.predicate.bind(cb.schema, cb.dicts)
        if pred.type != DataType.BOOL:
            from ..types import TypeError_
            raise TypeError_(f"filter predicate must be BOOL, got {pred.type}")
        out_cap = self.out_capacity or cb.capacity

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            v = pred.evaluate(rctx.eval_context(t))
            keep = v.values & v.valid_or_true() & t.row_mask()
            return compact_by_mask(t, keep, out_cap)

        return BoundOperation(cb.schema, cb.dicts, fn, out_cap,
                              stats=dict(cb.stats))

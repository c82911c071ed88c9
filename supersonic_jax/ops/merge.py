"""MergeUnionAll: k-way merge of same-schema sorted inputs.

Reference: cursor/core/merge_union_all.cc:127 — a row-oriented priority
queue over child iterators, deterministic order (ties broken by child
index, then child row order).  Device redesign: a k-way merge of
already-sorted streams is exactly a stable sort of the concatenation by
(key tuple, child index) — one ``lax.sort`` whose comparator equals the
reference's queue order, fully parallel instead of row-at-a-time.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..batch import Column, Table, gather_table, take_clipped
from ..dictionary import merge as dict_merge
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext
from .keys import key_operands
from .sort import SortOrder


class MergeUnionAll(Operation):
    def __init__(self, order: SortOrder | Sequence, children: Sequence[Operation]):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.children = list(children)
        if not self.children:
            raise SchemaError("MergeUnionAll needs at least one input")

    def bind(self, ctx: BindContext) -> BoundOperation:
        cbs = [c.bind(ctx) for c in self.children]
        schema = cbs[0].schema
        for cb in cbs[1:]:
            if tuple((a.name, a.type) for a in cb.schema) != \
                    tuple((a.name, a.type) for a in schema):
                raise SchemaError("MergeUnionAll inputs must share schema")
        # output nullability: any input nullable
        attrs = [Attribute(a.name, a.type,
                           any(cb.schema.lookup(a.name).nullable
                               for cb in cbs), a.enum)
                 for a in schema]
        out_schema = TupleSchema(attrs)
        # merge string dictionaries across inputs (bind-time remaps)
        remaps: list[dict[str, jnp.ndarray]] = [dict() for _ in cbs]
        out_dicts = {}
        for a in schema:
            if a.type in (DataType.STRING, DataType.BINARY):
                merged = cbs[0].dicts[a.name]
                maps = [np.arange(max(len(merged), 1), dtype=np.int32)]
                for cb in cbs[1:]:
                    merged, ra, rb = dict_merge(merged, cb.dicts[a.name])
                    maps = [ra[m] if m.size else m for m in maps]
                    maps.append(rb)
                out_dicts[a.name] = merged
                for i, m in enumerate(maps):
                    remaps[i][a.name] = jnp.asarray(m)
        order = self.order
        out_cap = sum(cb.capacity for cb in cbs)
        n_children = len(cbs)

        def fn(rctx: RunContext) -> Table:
            tables = [cb.run(rctx) for cb in cbs]
            # remap string codes into the merged dictionaries
            patched = []
            for i, t in enumerate(tables):
                cols = dict(t.columns)
                for name, lut in remaps[i].items():
                    c = cols[name]
                    cols[name] = Column(take_clipped(lut, c.values),
                                        c.valid)
                patched.append(Table(out_schema, cols, t.num_rows,
                                     out_dicts, cap_hint=t.capacity))
            # concatenate columns + child index + local rowid
            num_rows = sum(t.num_rows for t in tables)
            cat_cols = {}
            for a in out_schema:
                vals = jnp.concatenate(
                    [p.columns[a.name].values for p in patched])
                valid = (jnp.concatenate(
                    [p.columns[a.name].valid_or_true() for p in patched])
                    if a.nullable else None)
                cat_cols[a.name] = Column(vals, valid)
            child_idx = jnp.concatenate(
                [jnp.full(t.capacity, i, dtype=jnp.int32)
                 for i, t in enumerate(tables)])
            live = jnp.concatenate([t.row_mask() for t in tables])
            cat = Table(out_schema, cat_cols, num_rows, out_dicts,
                        cap_hint=out_cap)
            # one stable sort = the reference's priority-queue order:
            # (pad, key tuple, child index); stability keeps child row order
            operands, nk = key_operands(cat, order.names(),
                                        order.ascendings())
            pad = jnp.where(live, 0, 1).astype(jnp.int32)
            operands[0] = pad  # key_operands' pad uses num_rows prefix;
            # concatenated liveness is interleaved, so override it
            rowid = jnp.arange(out_cap, dtype=jnp.int32)
            res = jax.lax.sort(operands + [child_idx, rowid],
                               num_keys=nk + 1, is_stable=True)
            perm = res[-1]
            return gather_table(cat, perm, num_rows)

        return BoundOperation(out_schema, out_dicts, fn, out_cap)

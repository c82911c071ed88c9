"""UnionAll: plain row concatenation of same-schema children.

The reference ships only the sorted k-way MergeUnionAll
(cursor/core/merge_union_all.cc) and reserves a PARALLEL_UNION cursor id
without implementing it (cursor/proto/cursors.proto:25); this operation
provides the plain concatenation those leave open — the FULL_OUTER join
rewrite (ops/hash_join.py) builds on it.

Device shape: each child's valid prefix is written into the output at its
traced row offset with one ``lax.dynamic_update_slice`` per column —
pure O(total capacity) data movement, no sort, no gather.  Output
capacity is the sum of child capacities; dictionaries merge at bind with
per-child code remaps (one small LUT gather each).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..batch import Column, Table
from ..dictionary import merge as dict_merge
from ..batch import take_clipped
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext


class UnionAll(Operation):
    def __init__(self, *children: Operation):
        if not children:
            raise SchemaError("UNION ALL needs at least one input")
        self.children = list(children)

    def bind(self, ctx: BindContext) -> BoundOperation:
        cbs = [c.bind(ctx) for c in self.children]
        first = cbs[0].schema
        for cb in cbs[1:]:
            if cb.schema.names() != first.names():
                raise SchemaError(
                    f"UNION ALL schema mismatch: {cb.schema.names()} vs "
                    f"{first.names()}")
            for a, b in zip(first, cb.schema):
                if a.type != b.type:
                    raise SchemaError(
                        f"UNION ALL column {a.name}: {a.type} vs {b.type}")
        attrs = []
        for i, a in enumerate(first):
            nullable = any(cb.schema.attribute(i).nullable for cb in cbs)
            attrs.append(Attribute(a.name, a.type, nullable, a.enum))
        schema = TupleSchema(attrs)
        # bind-time dictionary merge; remap LUT per (child, column)
        dicts: dict = {}
        remaps: list[dict] = [dict() for _ in cbs]
        for a in first:
            if a.type not in (DataType.STRING, DataType.BINARY):
                continue
            merged = cbs[0].dicts[a.name]
            maps = [np.arange(max(len(merged), 1), dtype=np.int32)]
            for cb in cbs[1:]:
                merged, ra, rb = dict_merge(merged, cb.dicts[a.name])
                maps = [ra[m] if len(m) else m for m in maps]
                maps.append(rb)
            dicts[a.name] = merged
            for j in range(len(cbs)):
                remaps[j][a.name] = jnp.asarray(maps[j])
        cap = sum(cb.capacity for cb in cbs)

        def fn(rctx: RunContext) -> Table:
            tables = [cb.run(rctx) for cb in cbs]
            total = tables[0].num_rows
            for t in tables[1:]:
                total = total + t.num_rows
            cols = {}
            for i, a in enumerate(schema):
                nullable = attrs[i].nullable
                vparts = None
                okparts = None
                offset = jnp.int32(0)
                for j, t in enumerate(tables):
                    c = t.columns[a.name]
                    v = c.values
                    if a.name in remaps[j]:
                        v = take_clipped(remaps[j][a.name],
                                       jnp.clip(v, 0, None))
                    if vparts is None:
                        vparts = jnp.zeros(cap, v.dtype)
                        if nullable:
                            okparts = jnp.zeros(cap, jnp.bool_)
                    vparts = jax.lax.dynamic_update_slice(
                        vparts, v, (offset,))
                    if nullable:
                        ok = c.valid_or_true() & t.row_mask()
                        okparts = jax.lax.dynamic_update_slice(
                            okparts, ok, (offset,))
                    offset = (offset + t.num_rows).astype(jnp.int32)
                cols[a.name] = Column(vparts, okparts if nullable else None)
            return Table(schema, cols, total, dicts, cap_hint=cap)

        return BoundOperation(schema, dicts, fn, cap)

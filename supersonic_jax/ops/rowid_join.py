"""RowidMergeJoin and ForeignFilter — the reference's streaming FK joins.

Reference: cursor/core/rowid_merge_join.cc:62 (inner join of a sorted
left FK column against the right side's *row ids*, enforcing referential
integrity) and cursor/core/foreign_filter.cc:55 (semi-join of an
ascending FK column against an ascending unique key column, remapping the
FK to the filter's row ids).  Both are streaming merge loops in the
reference; on the device they collapse to a dense gather / binary
search.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..batch import Column, Table, gather_table
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext
from .filter import compact_by_mask
from .project import Projector


class RowidMergeJoin(Operation):
    """Left ``fk`` column values ARE right row ids; output = projected left
    + right-at-fk columns.  Rows with fk outside [0, right rows) flag a
    referential-integrity error (the reference CHECK-fails)."""

    def __init__(self, fk_column: str, lhs: Operation, rhs: Operation,
                 lhs_projector=None, rhs_projector=None):
        self.fk_column = fk_column
        self.lhs = lhs
        self.rhs = rhs
        self.lhs_projector = lhs_projector or Projector.all()
        self.rhs_projector = rhs_projector or Projector.all()

    def bind(self, ctx: BindContext) -> BoundOperation:
        lb = self.lhs.bind(ctx)
        rb = self.rhs.bind(ctx)
        fk_attr = lb.schema.lookup(self.fk_column)
        if fk_attr.type not in (DataType.INT64, DataType.INT32,
                                DataType.UINT32, DataType.UINT64):
            raise SchemaError("RowidMergeJoin fk must be an integer column")
        lpairs = self.lhs_projector.resolve(lb.schema)
        rpairs = self.rhs_projector.resolve(rb.schema)
        attrs = [Attribute(d, lb.schema.lookup(s).type,
                           lb.schema.lookup(s).nullable,
                           lb.schema.lookup(s).enum) for s, d in lpairs]
        attrs += [Attribute(d, rb.schema.lookup(s).type,
                            rb.schema.lookup(s).nullable,
                            rb.schema.lookup(s).enum) for s, d in rpairs]
        out_schema = TupleSchema(attrs)
        out_dicts = {d: lb.dicts[s] for s, d in lpairs if s in lb.dicts}
        out_dicts.update({d: rb.dicts[s] for s, d in rpairs
                          if s in rb.dicts})
        fk_name = self.fk_column

        def fn(rctx: RunContext) -> Table:
            lt = lb.run(rctx)
            rt = rb.run(rctx)
            fk = lt.columns[fk_name].values.astype(jnp.int32)
            live = lt.row_mask()
            bad = live & ((fk < 0) | (fk >= rt.num_rows))
            rctx.error_flags.append(
                ("rowid join referential integrity", jnp.any(bad)))
            rgath = gather_table(rt, jnp.where(live, fk, rt.capacity),
                                 lt.num_rows)
            cols = {d: lt.columns[s] for s, d in lpairs}
            cols.update({d: rgath.columns[s] for s, d in rpairs})
            return Table(out_schema, cols, lt.num_rows, out_dicts,
                         cap_hint=lt.capacity)

        return BoundOperation(out_schema, out_dicts, fn, lb.capacity)


class ForeignFilter(Operation):
    """Keep lhs rows whose ``fk`` appears in the rhs ``key`` column
    (ascending unique), rewriting fk to the rhs *row id* of the match.

    reference: foreign_filter.h:21-40 — both inputs ascending; output
    schema = lhs with fk replaced by the remapped row id.
    """

    def __init__(self, fk_column: str, key_column: str,
                 lhs: Operation, rhs: Operation):
        self.fk_column = fk_column
        self.key_column = key_column
        self.lhs = lhs
        self.rhs = rhs

    def bind(self, ctx: BindContext) -> BoundOperation:
        lb = self.lhs.bind(ctx)
        rb = self.rhs.bind(ctx)
        lb.schema.lookup(self.fk_column)
        rb.schema.lookup(self.key_column)
        out_schema = lb.schema
        fk_name, key_name = self.fk_column, self.key_column

        def fn(rctx: RunContext) -> Table:
            lt = lb.run(rctx)
            rt = rb.run(rctx)
            fk = lt.columns[fk_name].values
            keys = rt.columns[key_name].values
            # padding rows would break the ascending precondition; replace
            # them with the dtype max sentinel before searching
            if jnp.issubdtype(keys.dtype, jnp.floating):
                sentinel = jnp.array(jnp.inf, keys.dtype)
            else:
                sentinel = jnp.array(jnp.iinfo(keys.dtype).max, keys.dtype)
            keys = jnp.where(rt.row_mask(), keys, sentinel)
            # gather-based lexicographic lower bound
            from .hash_join import _lex_lower_upper
            pos, _ = _lex_lower_upper(
                [keys], jnp.asarray(rt.num_rows).astype(jnp.int32), [fk])
            pos = jnp.clip(pos, 0, rt.capacity - 1)
            hit = (pos < rt.num_rows) & (jnp.take(keys, pos) == fk)
            keep = hit & lt.row_mask()
            cols = dict(lt.columns)
            cols[fk_name] = Column(
                pos.astype(lt.columns[fk_name].values.dtype),
                lt.columns[fk_name].valid)
            remapped = Table(out_schema, cols, lt.num_rows, dict(lt.dicts),
                             cap_hint=lt.capacity)
            return compact_by_mask(remapped, keep, lt.capacity)

        return BoundOperation(out_schema, dict(lb.dicts), fn, lb.capacity)

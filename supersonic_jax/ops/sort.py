"""Sort: multi-column ORDER BY with ASC/DESC and NULL ordering.

Reference: cursor/core/sort.cc — a column-wise refinement sort producing a
``Permutation`` (sort.cc:150-322), with external merge-sort spill for
memory-bounded inputs (sort.cc:324-399).  Device redesign (SURVEY.md §7.1):
one ``lax.sort`` over monotone key codes (ops/keys.py) with the row-id
permutation as payload; XLA lowers this to an on-chip vectorized sort.
There is no disk spill — HBM is the memory budget; cross-chip scale uses
the distributed sample-sort in parallel/ (SURVEY.md §7.2 step 7).

``ExtendedSort`` adds per-key case-insensitivity and a limit (reference:
ExtendedSortSpecification, proto/specification.proto).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from ..batch import Column, Table, gather_table
from ..schema import Attribute, TupleSchema
from ..dictionary import transform as dict_transform
from ..schema import SchemaError
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext
from .keys import descending_code, key_operands, monotone_code
from ..batch import take_clipped


@dataclass(frozen=True)
class SortKey:
    """One ORDER BY key (reference: SortOrder entry, ordering.h:24-60)."""

    name: str
    ascending: bool = True
    case_sensitive: bool = True  # ExtendedSort only


class SortOrder:
    def __init__(self, keys: Sequence[SortKey | tuple | str]):
        norm = []
        for k in keys:
            if isinstance(k, SortKey):
                norm.append(k)
            elif isinstance(k, str):
                norm.append(SortKey(k))
            else:
                norm.append(SortKey(*k))
        self.keys: list[SortKey] = norm

    def names(self) -> list[str]:
        return [k.name for k in self.keys]

    def ascendings(self) -> list[bool]:
        return [k.ascending for k in self.keys]


def sort_permutation(table: Table, order: SortOrder) -> jnp.ndarray:
    """Row-id permutation realizing the sort (reference: SortPermutation,
    sort.cc:781).  Stable: equal keys keep input order."""
    operands, num_keys = key_operands(table, order.names(), order.ascendings())
    rowids = jnp.arange(table.capacity, dtype=jnp.int32)
    out = jax.lax.sort(operands + [rowids], num_keys=num_keys, is_stable=True)
    return out[-1]


def _f32_code(v: jnp.ndarray) -> jnp.ndarray:
    """f32 -> SIGNED-ascending IEEE total-order i32 (bit-invertible)."""
    i = jax.lax.bitcast_convert_type(v, jnp.int32)
    return jnp.where(i >= 0, i, ~i ^ jnp.int32(-2147483648))


def _f32_code_inv(t: jnp.ndarray) -> jnp.ndarray:
    i = jnp.where(t >= 0, t, ~(t ^ jnp.int32(-2147483648)))
    return jax.lax.bitcast_convert_type(i, jnp.float32)


def _invertible_code(vals: jnp.ndarray, type_: DataType, asc: bool):
    """(code, inverse) for one sort key where the column values can be
    recovered bit-exactly from the sorted code operand — the KEY-PAYLOAD
    DEDUP that drops one sort operand per key column.
    Returns (None, None) when no bit-invertible code exists (DOUBLE,
    UINT64 — they ride the classic monotone_code + payload operand).

    f32 keys order by the signed IEEE total order instead of float
    compares: ±0 ties order -0 < +0 and NaN payloads order by bit
    pattern, where the reference's unstable std::sort leaves equal-key
    order unspecified anyway (sort.cc:150-161)."""
    dt = jnp.dtype(vals.dtype)
    if type_ in (DataType.FLOAT,) and dt == jnp.dtype(jnp.float32):
        code, inv = _f32_code(vals), _f32_code_inv
    elif dt == jnp.dtype(jnp.uint32):
        code, inv = vals.astype(jnp.int64), (
            lambda c: c.astype(jnp.uint32))
    elif dt == jnp.dtype(jnp.bool_):
        code, inv = vals.astype(jnp.int32), (
            lambda c: c.astype(jnp.bool_))
    elif dt in (jnp.dtype(jnp.int32), jnp.dtype(jnp.int64)):
        code, inv = vals, (lambda c: c)
    else:
        return None, None
    if not asc:
        base_inv = inv
        return ~code, (lambda c: base_inv(~c))
    return code, inv


def _code_bounds(table: Table, name: str, attr, stats) -> Optional[tuple]:
    """Known (lo, hi) VALUE bounds for an int-coded key column, with a
    flag for whether they are structural (dictionary/ENUM/BOOL — cannot
    be violated by well-formed data) or planner stats (bind-time leaf
    observations that need a runtime guard).  Returns
    (lo, hi, needs_guard) or None."""
    if name in table.dicts:
        return 0, max(len(table.dicts[name]) - 1, 0), False
    if attr.type == DataType.ENUM and attr.enum is not None:
        return 0, max(len(attr.enum.names) - 1, 0), False
    if attr.type == DataType.BOOL:
        return 0, 1, False
    if stats and name in stats:
        lo, hi = stats[name]
        try:
            return int(lo), int(hi), True
        except (TypeError, ValueError):
            return None
    return None


def sort_table(table: Table, order: SortOrder,
               key_override: Optional[dict[str, jnp.ndarray]] = None,
               pad_mask=None, num_rows=None, stats=None,
               rctx=None) -> Table:
    """Sort a whole Table in ONE stable multi-operand lax.sort.

    Every operand the sort moves costs a pass over the rows, so three
    packings drop operands:

      * key-payload dedup — a column that is also a sort key rides ONLY
        as its key code when the code is bit-invertible (ints identity,
        f32 via the signed IEEE total-order transform); the output column
        rebuilds from the sorted code.
      * pad packing — the pad operand folds into the first key's
        null-rank (nullable first key) or into a bounded first int key
        (planner stats / dictionary / ENUM / BOOL bounds) instead of
        being its own operand.
      * validity packing — up to 4 validity masks ride one i32 operand.

    ``key_override`` substitutes key arrays (e.g. case-folded codes for
    ExtendedSort) without changing the emitted columns (those keys keep
    their payload operands).  ``stats``: per-column (min, max) planner
    bounds from the bound child.
    """
    cap = table.capacity
    if pad_mask is None:
        pad_mask = (jnp.arange(cap, dtype=jnp.int32)
                    >= jnp.asarray(table.num_rows, jnp.int32))
    pad = pad_mask.astype(jnp.int32)
    shadow_cols = dict(table.columns)
    if key_override:
        for name, vals in key_override.items():
            shadow_cols[name] = shadow_cols[name]._replace(values=vals)

    # --- per-key operands: (null_rank or None, code, inv or None) -------
    from .keys import _check_keyable

    keys_built = []
    for k in order.keys:
        _check_keyable(table, k.name)
        attr = table.schema.lookup(k.name)
        colm = shadow_cols[k.name]
        overridden = bool(key_override) and k.name in key_override
        code, inv = _invertible_code(colm.values, attr.type, k.ascending)
        if code is None:
            code = monotone_code(colm.values, attr.type)
            if not k.ascending:
                code = descending_code(code)
            inv = None
        if overridden:
            inv = None  # output column keeps the UN-folded values
        nr = None
        if colm.valid is not None:
            if k.ascending:
                nr = jnp.where(colm.valid, 1, 0).astype(jnp.int32)
            else:
                nr = jnp.where(colm.valid, 0, 1).astype(jnp.int32)
            code = jnp.where(colm.valid, code, jnp.zeros_like(code))
        keys_built.append((k.name, nr, code, inv, attr, k.ascending))

    # --- pad packing ----------------------------------------------------
    operands: list[jnp.ndarray] = []
    pad_packed = False
    if keys_built:
        name0, nr0, code0, inv0, attr0, asc0 = keys_built[0]
        if nr0 is not None:
            # pads sort above both null (0/1) ranks
            keys_built[0] = (name0, pad * 2 + nr0, code0, inv0, attr0,
                             asc0)
            pad_packed = True
        elif jnp.dtype(code0.dtype) in (jnp.dtype(jnp.int32),
                                        jnp.dtype(jnp.int64)):
            b = _code_bounds(table, name0, attr0, stats)
            if (b is not None and name0 not in (key_override or {})
                    and (not b[2] or rctx is not None)):
                lo_v, hi_v, needs_guard = b
                # value bounds -> code bounds under the key transform
                # (asc: identity; desc: code = ~v reverses the interval)
                if asc0:
                    lo_c, hi_c = lo_v, hi_v
                else:
                    lo_c, hi_c = ~hi_v, ~lo_v
                span = hi_c - lo_c + 1
                is32 = jnp.dtype(code0.dtype) == jnp.dtype(jnp.int32)
                if span > 0 and ((not is32 and span < (1 << 62))
                                 or (is32 and span <= (1 << 30))):
                    cdt = code0.dtype
                    if needs_guard:
                        # planner stats are bind-time observations; a
                        # re-run with different leaf data must fail
                        # loudly, not sort wrongly
                        live = ~pad_mask
                        viol = live & ((code0 < jnp.asarray(lo_c, cdt))
                                       | (code0 > jnp.asarray(hi_c, cdt)))
                        rctx.error_flags.append(
                            ("sort key exceeds planner bounds "
                             f"({name0!r}; stale bind-time stats)",
                             jnp.any(viol)))
                    packed = ((code0 - jnp.asarray(lo_c, cdt))
                              + pad.astype(cdt) * jnp.asarray(span, cdt))
                    base_inv = inv0
                    inv_p = (None if base_inv is None else
                             (lambda c, _lo=lo_c, _dt=cdt, _bi=base_inv:
                              _bi(c + jnp.asarray(_lo, _dt))))
                    keys_built[0] = (name0, None, packed, inv_p, attr0,
                                     asc0)
                    pad_packed = True
    if not pad_packed:
        operands.append(pad)
    key_operand_index: dict[str, tuple[int, object]] = {}
    for name, nr, code, inv, _attr, _asc in keys_built:
        if nr is not None:
            operands.append(nr)
        idx = len(operands)
        operands.append(code)
        if name not in key_operand_index:
            key_operand_index[name] = (idx, inv)
    num_keys = len(operands)

    # --- payloads: dedup + validity packing -----------------------------
    payload: list[jnp.ndarray] = []
    layout: list[tuple] = []  # ("key", name, op_idx, inv) | ("pay", name, i)
    valid_names: list[str] = []
    for name in table.schema.names():
        c = table.columns[name]
        dedup = key_operand_index.get(name)
        if dedup is not None and dedup[1] is not None:
            layout.append(("key", name, dedup[0], dedup[1]))
        else:
            layout.append(("pay", name, len(payload)))
            payload.append(c.values)
        if c.valid is not None:
            valid_names.append(name)
    n_plain = len(payload)
    for gi in range(0, len(valid_names), 4):
        group = valid_names[gi:gi + 4]
        packedv = jnp.zeros(cap, jnp.int32)
        for bit, name in enumerate(group):
            packedv = packedv | (
                table.columns[name].valid.astype(jnp.int32) << bit)
        payload.append(packedv)

    res = jax.lax.sort(operands + payload, num_keys=num_keys,
                       is_stable=True)
    valid_sorted: dict[str, jnp.ndarray] = {}
    for gi in range(0, len(valid_names), 4):
        op = res[num_keys + n_plain + gi // 4]
        for bit, name in enumerate(valid_names[gi:gi + 4]):
            valid_sorted[name] = ((op >> bit) & 1) != 0
    cols: dict[str, Column] = {}
    for entry in layout:
        if entry[0] == "key":
            _, name, op_idx, inv = entry
            vals = inv(res[op_idx])
        else:
            _, name, pi = entry
            vals = res[num_keys + pi]
        cols[name] = Column(vals, valid_sorted.get(name))
    return Table(table.schema, cols,
                 table.num_rows if num_rows is None else num_rows,
                 dict(table.dicts), cap_hint=table.capacity)


class Sort(Operation):
    """reference: Sort(sort_order, result_projector, mem_limit, child)
    (sort.h) — ``result_projector`` optionally projects the sorted output
    (identity when None)."""

    def __init__(self, order: SortOrder | Sequence, child: Operation,
                 result_projector=None):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.child = child
        self.result_projector = result_projector

    def bind(self, ctx: BindContext) -> BoundOperation:
        from .aggregate import GroupAggregate
        from .filter import bind_predicates, keep_mask, unwrap_filters
        from .hash_join import HashJoin, KeyUniqueness
        inner, preds = unwrap_filters(self.child)
        # UNIQUE join child: bind masked and fold its keep mask into the
        # sort's pad key (same fusion as filters) — skips the join's
        # compaction; this sort moves the rows anyway.
        masked_join = (isinstance(inner, HashJoin)
                       and inner.uniqueness == KeyUniqueness.UNIQUE)
        if masked_join:
            cb = inner.bind(ctx, _masked=True)
        elif (isinstance(inner, GroupAggregate)
              and inner.options.max_unique_keys_in_result is None):
            # this sort re-orders the rows anyway: the aggregate may skip
            # its insertion-order re-rank (and the dense path's first_pos
            # kernel request).  Tie order among equal sort keys becomes
            # key-order instead of insertion-order — the reference makes
            # no tie promise either (sort.cc uses unstable std::sort).
            # (Not with max_unique_keys_in_result: WHICH keys clamp into
            # the overflow group is defined by first-encounter order,
            # aggregate.h:206-218 — that needs the re-rank.)
            cb = inner.bind(ctx, _unordered=True)
        else:
            cb = inner.bind(ctx)
        bound_preds = bind_predicates(preds, cb)
        for k in self.order.keys:
            cb.schema.lookup(k.name)
        order = self.order
        proj_pairs = (self.result_projector.resolve(cb.schema)
                      if self.result_projector else None)
        if proj_pairs is not None:
            from ..schema import Attribute as _Attr
            out_schema = TupleSchema([
                _Attr(dst, cb.schema.lookup(src).type,
                      cb.schema.lookup(src).nullable,
                      cb.schema.lookup(src).enum)
                for src, dst in proj_pairs])
            out_dicts = {dst: cb.dicts[src] for src, dst in proj_pairs
                         if src in cb.dicts}
        else:
            out_schema, out_dicts = cb.schema, cb.dicts

        def fn(rctx: RunContext) -> Table:
            if masked_join:
                t, keep = cb.run(rctx)
            else:
                t = cb.run(rctx)
                keep = None
            if bound_preds:
                # fused Filter: fold the predicate into the pad key
                pk = keep_mask(bound_preds, rctx, t)
                keep = pk if keep is None else (keep & pk)
            if keep is not None:
                sorted_t = sort_table(
                    t, order, pad_mask=~keep,
                    num_rows=jnp.sum(keep.astype(jnp.int32), dtype=jnp.int32),
                    stats=cb.stats, rctx=rctx)
            else:
                sorted_t = sort_table(t, order, stats=cb.stats, rctx=rctx)
            if proj_pairs is None:
                return sorted_t
            cols = {dst: sorted_t.columns[src] for src, dst in proj_pairs}
            return Table(out_schema, cols, sorted_t.num_rows, out_dicts,
                         cap_hint=sorted_t.capacity)

        if proj_pairs is not None:
            out_stats = {dst: cb.stats[src] for src, dst in proj_pairs
                         if src in cb.stats}
        else:
            out_stats = dict(cb.stats)
        return BoundOperation(out_schema, out_dicts, fn, cb.capacity,
                              stats=out_stats)


class ExtendedSort(Operation):
    """Sort with optional per-key case-insensitivity and a row limit
    (reference: ExtendedSort / specification_builder.cc — implemented by
    injecting a ToLower key transform, here a dictionary remap LUT)."""

    def __init__(self, order: SortOrder | Sequence, child: Operation,
                 limit: Optional[int] = None):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.child = child
        self.limit = limit

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        order = self.order
        # Build fold-to-lower LUTs for case-insensitive string keys.
        luts: dict[str, jnp.ndarray] = {}
        for k in order.keys:
            attr = cb.schema.lookup(k.name)
            if not k.case_sensitive:
                if attr.type not in (DataType.STRING, DataType.BINARY):
                    raise SchemaError(
                        f"case-insensitive sort key {k.name!r} must be STRING")
                d = cb.dicts[k.name]
                _, remap = dict_transform(
                    d, lambda v: v.lower() if isinstance(v, str) else v.lower())
                luts[k.name] = jnp.asarray(remap)
        limit = self.limit
        out_cap = min(cb.capacity, limit) if limit else cb.capacity

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            override = None
            if luts:
                override = {
                    name: take_clipped(lut, t.columns[name].values)
                    for name, lut in luts.items()}
            if (limit is not None and len(t.schema)
                    and out_cap * 4 <= cb.capacity):
                # top-K fast path: sort only (keys, rowid) and move the K
                # winning rows with one small packed gather — every other
                # payload row stays put (a full payload sort pays per
                # column operand)
                shadow = t
                if override:
                    cols = dict(t.columns)
                    for name, vals in override.items():
                        cols[name] = cols[name]._replace(values=vals)
                    shadow = Table(t.schema, cols, t.num_rows, t.dicts,
                                   cap_hint=t.capacity)
                operands, num_keys = key_operands(
                    shadow, order.names(), order.ascendings())
                rowids = jnp.arange(t.capacity, dtype=jnp.int32)
                res = jax.lax.sort(operands + [rowids],
                                   num_keys=num_keys, is_stable=True)
                perm = res[-1][:out_cap]
                return gather_table(t, perm, jnp.minimum(t.num_rows, limit))
            sorted_t = sort_table(t, order, key_override=override)
            n = t.num_rows
            if limit is not None:
                n = jnp.minimum(n, limit)
                cols = {
                    name: Column(
                        c.values[:out_cap],
                        None if c.valid is None else c.valid[:out_cap])
                    for name, c in sorted_t.columns.items()}
                return Table(t.schema, cols, n, dict(t.dicts),
                             cap_hint=out_cap)
            return sorted_t

        return BoundOperation(cb.schema, cb.dicts, fn, out_cap,
                              stats=dict(cb.stats))


def sort_working_set_bytes(schema: TupleSchema, capacity: int,
                           num_keys: int) -> int:
    """Device-memory estimate for sorting ``capacity`` rows of ``schema``:
    every column (plus a validity byte per nullable column) rides a
    multi-operand ``lax.sort`` both as input and output, and each sort key
    contributes a monotone key-code operand (ops/keys.py)."""
    from ..types import physical_dtype

    row = 0
    for a in schema:
        row += int(physical_dtype(a.type).itemsize)
        if a.nullable:
            row += 1
    row += 8 * max(num_keys, 1)  # key-code operands (<=u64 each)
    return 2 * capacity * row  # sort holds operands + results


class SortWithTempDirPrefix(Operation):
    """Sort honoring the reference's ``buffer_memory_limit`` contract
    (reference: sort.h:89-98 — inputs beyond the limit degrade to an
    external merge sort over disk-spilled runs, sort.cc:467-571).

    Device redesign: when the estimated device working set fits
    ``memory_limit`` (or no limit is given), this is exactly ``Sort`` —
    one in-HBM ``lax.sort``.  Otherwise the child plan is executed on its
    own, streamed through ``io/external.py::ExternalSorter`` (device-sorted
    runs of ``memory_limit`` bytes spilled under
    ``temporary_directory_prefix``, k-way merged on read-back), and the
    sorted result re-enters the plan as a leaf.  The limit is never
    silently ignored.
    """

    def __init__(self, order, child, result_projector=None,
                 memory_limit=None, temporary_directory_prefix=None):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.child = child
        self.result_projector = result_projector
        self.memory_limit = memory_limit
        self.temp_prefix = temporary_directory_prefix

    def bind(self, ctx: BindContext) -> BoundOperation:
        if self.memory_limit is None:
            return Sort(self.order, self.child,
                        self.result_projector).bind(ctx)
        # Probe the child's shape in a throwaway context (pure: only
        # schema/capacity are read) to pick the route.
        probe = self.child.bind(BindContext())
        need = sort_working_set_bytes(probe.schema, probe.capacity,
                                      len(self.order.keys))
        if need <= int(self.memory_limit):
            return Sort(self.order, self.child,
                        self.result_projector).bind(ctx)
        # Spill path: a host/disk boundary by definition (the reference's
        # external sort likewise materializes runs inside its cursor,
        # sort.cc:467-571).  Bind is side-effect-free:
        # the child binds once here; the spill runs at execution
        # time as a lazy-leaf producer, streaming raw numpy column
        # slices — no per-row Python boxing.
        import numpy as np

        from .base import materialize_bound
        from ..batch import Table
        from ..io.external import ExternalSorter

        cb = self.child.bind(ctx)
        row_bytes = max(1, need // max(2 * cb.capacity, 1) * 2)
        run_rows = max(1, int(self.memory_limit) // row_bytes)
        order = self.order
        temp_prefix = self.temp_prefix
        out_cap = cb.capacity
        schema = cb.schema
        # compiled child program, reused across re-binds of this
        # operation instance (execute() re-binds every run)
        prog_cache: dict = self.__dict__.setdefault(
            "_prog_caches", {}).setdefault(
                (cb.capacity,
                 tuple((a.name, a.type, a.nullable) for a in schema)), {})

        def producer(leaves, cancel) -> Table:
            src = materialize_bound(cb, leaves, cancel, cache=prog_cache)
            n = int(src.num_rows)
            host_cols = {}
            for attr in schema:
                c = src.columns[attr.name]
                vals = np.asarray(c.values)[:n]
                valid = (None if c.valid is None
                         else np.asarray(c.valid)[:n].astype(bool))
                host_cols[attr.name] = (vals, valid)
            with ExternalSorter(schema, order, run_rows,
                                temp_prefix) as sorter:
                for start in range(0, max(n, 1), run_rows):
                    if cancel is not None:
                        cancel.check()  # Cursor::Interrupt poll point
                    stop = min(start + run_rows, n)
                    if stop <= start:
                        break
                    sorter.write_arrays(
                        {name: (v[start:stop],
                                None if vld is None else vld[start:stop])
                         for name, (v, vld) in host_cols.items()},
                        dict(src.dicts), stop - start)
                sorted_host = sorter.result()
            m = int(sorted_host.num_rows)
            return Table.from_arrays(
                schema,
                {a.name: np.asarray(
                    sorted_host.columns[a.name].values)[:m]
                 for a in schema},
                {a.name: (None
                          if sorted_host.columns[a.name].valid is None
                          else np.asarray(
                              sorted_host.columns[a.name].valid)[:m])
                 for a in schema},
                m, dict(sorted_host.dicts), capacity=out_cap)

        placeholder = Table.empty(schema, out_cap)
        placeholder.dicts.update(cb.dicts)
        idx = ctx.register_lazy_leaf(placeholder, producer)
        proj_pairs = (None if self.result_projector is None
                      else self.result_projector.resolve(schema))

        def fn(rctx: RunContext) -> Table:
            t = rctx.leaf_tables[idx]
            if proj_pairs is None:
                return t
            from ..schema import TupleSchema as _TS
            attrs = []
            cols = {}
            dicts = {}
            for src_n, dst in proj_pairs:
                a = schema.lookup(src_n)
                attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
                cols[dst] = t.columns[src_n]
                if src_n in t.dicts:
                    dicts[dst] = t.dicts[src_n]
            return Table(_TS(attrs), cols, t.num_rows, dicts,
                         cap_hint=out_cap)

        out_schema = schema
        out_dicts = dict(cb.dicts)
        if proj_pairs is not None:
            attrs = []
            out_dicts = {}
            for src_n, dst in proj_pairs:
                a = schema.lookup(src_n)
                attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
                if src_n in cb.dicts:
                    out_dicts[dst] = cb.dicts[src_n]
            out_schema = TupleSchema(attrs)
        return BoundOperation(out_schema, out_dicts, fn, out_cap)

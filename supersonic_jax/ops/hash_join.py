"""Hash join (INNER, LEFT_OUTER; unique and multi-key rhs).

Reference: cursor/core/hash_join.cc — build materializes the entire rhs
into a RowHashSet keyed by the rhs key columns, skipping NULL keys
(hash_join.cc:67-76, 604-625); probe walks per-query match lists and
gathers both sides into the result (hash_join.cc:406-517, 759-806);
LEFT_OUTER emits a NULL rhs row for unmatched queries and forces rhs
output columns nullable (hash_join.cc:78-87, 582-584).

Device redesign (SURVEY.md §2.4): chained hash tables scatter randomly —
hostile to a data-parallel machine — so the build side is *sorted* by monotone
key codes (ops/keys.py) and the probe is a vectorized lexicographic
binary search (log2(build) dense gather rounds, all rows probed in
parallel).  Equal-key runs give multi-match ranges; expansion uses a
prefix-sum + searchsorted over output offsets.  Matches are emitted in
(lhs row, rhs original order) — the reference's per-query match-list
order; row order is deterministic.
"""
from __future__ import annotations

import enum
import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from ..batch import Column, Table, gather_arrays, gather_table
from ..schema import Attribute, SchemaError, TupleSchema
from .base import BindContext, BoundOperation, Operation, RunContext
from .keys import monotone_code
from .scan32 import cummax_i32, cumsum_i32
from .project import Projector
from ..batch import take_clipped


class JoinType(enum.Enum):
    """reference: proto/supersonic.proto:77-83.  The reference implements
    only INNER and LEFT_OUTER (hash_join.h:37 marks RIGHT_OUTER and
    FULL_OUTER "not supported yet"); this engine implements all four —
    RIGHT_OUTER as a mirrored LEFT_OUTER, FULL_OUTER as
    LEFT_OUTER ∪ NULL-padded anti-join rows (see HashJoin.bind)."""

    INNER = "INNER"
    LEFT_OUTER = "LEFT_OUTER"
    RIGHT_OUTER = "RIGHT_OUTER"
    FULL_OUTER = "FULL_OUTER"


class KeyUniqueness(enum.Enum):
    UNIQUE = "UNIQUE"
    NOT_UNIQUE = "NOT_UNIQUE"


def _key_codes(table: Table, names: list[str]):
    """(codes per key, any_null) — NULL keys never participate in matches."""
    codes = []
    any_null = jnp.zeros(table.capacity, dtype=jnp.bool_)
    for n in names:
        attr = table.schema.lookup(n)
        c = table.columns[n]
        codes.append(monotone_code(c.values, attr.type))
        if c.valid is not None:
            any_null = any_null | ~c.valid
    return codes, any_null


def _lex_lower_upper(build_codes: list[jnp.ndarray], build_n,
                     probe_codes: list[jnp.ndarray]):
    """Vectorized lexicographic lower/upper bound of each probe tuple in the
    sorted build arrays.  Returns (lower, upper), each int32[probe_cap]."""
    cap = build_codes[0].shape[0]
    steps = max(1, math.ceil(math.log2(max(cap, 2))) + 1)
    pshape = probe_codes[0].shape[0]

    def tuple_cmp(mid):
        safe = jnp.clip(mid, 0, cap - 1)
        lt = jnp.zeros(pshape, dtype=jnp.bool_)
        eq = jnp.ones(pshape, dtype=jnp.bool_)
        for bc, pc in zip(build_codes, probe_codes):
            bv = jnp.take(bc, safe)
            lt = lt | (eq & (bv < pc))
            eq = eq & (bv == pc)
        return lt, eq

    def search(le: bool):
        # derive lo from the (possibly device-varying) probe codes so the
        # fori_loop carry has consistent varying-axis type under shard_map
        lo = (probe_codes[0] * 0).astype(jnp.int32)
        hi = lo + build_n.astype(jnp.int32)

        def body(_, lohi):
            lo, hi = lohi
            mid = (lo + hi) // 2
            lt, eq = tuple_cmp(mid)
            go_right = (lt | eq) if le else lt
            in_range = mid < hi
            go_right = go_right & in_range
            lo = jnp.where(go_right, mid + 1, lo)
            hi = jnp.where(go_right | ~in_range, hi, mid)
            return lo, hi

        lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
        return lo

    return search(False), search(True)


_DENSE_KEY_TYPES = ("INT32", "INT64", "UINT32", "DATE", "DATETIME")
_DENSE_RANGE_MAX = 1 << 24  # 64MB int32 LUT ceiling


def _fat_lut_probe(rt: Table, srcs, scat, pslot, pin, rng: int,
                   nullable_out: bool):
    """Dense UNIQUE join via a *fat* LUT: a match flag plus every
    projected rhs column (and its validity) land in per-dtype-group
    lookup tables indexed by key slot, then each group probes with ONE
    gather.  The separate rhs row gather of the rowid-LUT design
    disappears: each probe index is resolved once for all lanes.

    LUT construction is sort-based, not a scatter: build rows (slot*2) and one domain marker per slot (slot*2+1) sort
    together on that single folded key; a marker's immediate
    predecessor is its slot's build row iff one exists, so a roll+
    compare carries the lanes onto the markers, and one
    compaction of the marker rows yields the dense [rng] tables in
    slot order.

    Returns ({src: Column at probe capacity}, matched).  Fetched values
    are arbitrary where ``matched`` is False; with ``nullable_out``
    (LEFT_OUTER) validity is already masked to matched.
    """
    from .filter import compact_arrays
    rcap = scat.shape[0]
    u32_tags: list = []
    u32_arrs: list = []
    other: dict = {}
    for src in dict.fromkeys(srcs):
        col = rt.columns[src]
        v = col.values
        if v.dtype in (jnp.int32, jnp.uint32, jnp.float32):
            u32_tags.append(("val", src))
            u32_arrs.append(jax.lax.bitcast_convert_type(v, jnp.uint32))
        elif v.dtype == jnp.bool_:
            u32_tags.append(("bval", src))
            u32_arrs.append(v.astype(jnp.uint32))
        else:
            tags, arrs = other.setdefault(str(v.dtype), ([], []))
            tags.append(("val", src))
            arrs.append(v)
        if col.valid is not None:
            u32_tags.append(("valid", src))
            u32_arrs.append(col.valid.astype(jnp.uint32))
    all_tags = list(u32_tags)
    all_arrs = list(u32_arrs)
    group_slices = [("u32", 0, len(u32_arrs))]
    for dt, (tags, arrs) in other.items():
        group_slices.append((dt, len(all_arrs), len(all_arrs) + len(arrs)))
        all_tags.extend(tags)
        all_arrs.extend(arrs)
    # folded stream key: build row for slot p -> 2p, marker -> 2p+1,
    # dead/out-of-range build rows -> 2*rng (sort after every marker)
    slot2 = jnp.concatenate([
        scat.astype(jnp.int32) * 2,
        jnp.arange(rng, dtype=jnp.int32) * 2 + 1])
    stream = [jnp.concatenate([a, jnp.zeros(rng, a.dtype)])
              for a in all_arrs]
    res = jax.lax.sort([slot2] + stream, num_keys=1, is_stable=True)
    s_slot2, s_lanes = res[0], list(res[1:])
    pos = jnp.arange(rcap + rng, dtype=jnp.int32)
    prev_slot2 = jnp.roll(s_slot2, 1)
    # marker's predecessor is its build row iff prev == slot2 - 1
    has_build = (prev_slot2 == s_slot2 - 1) & (pos > 0)
    is_marker = (s_slot2 % 2) == 1
    carried = [jnp.where(has_build, jnp.roll(lane, 1),
                         jnp.zeros_like(lane)) for lane in s_lanes]
    carried.append(has_build)  # match flag rides the compaction
    luts = compact_arrays(carried, is_marker, rng)
    matched_lut = luts[-1]
    fetched = {}
    for gname, lo, hi in group_slices:
        lanes = luts[lo:hi]
        if gname == "u32":
            lanes = lanes + [matched_lut.astype(jnp.uint32)]
        if not lanes:
            continue
        packed = jnp.stack(lanes, axis=1)
        g = jnp.take(packed, pslot, axis=0)
        for j, tag in enumerate(all_tags[lo:hi]):
            fetched[tag] = g[:, j]
        if gname == "u32":
            fetched[("flag", None)] = g[:, len(lanes) - 1]
    matched = pin & (fetched[("flag", None)] > 0)
    out = {}
    for src in dict.fromkeys(srcs):
        col = rt.columns[src]
        if ("bval", src) in fetched:
            vals = fetched[("bval", src)] > 0
        else:
            vals = fetched[("val", src)]
            if vals.dtype == jnp.uint32:
                vals = jax.lax.bitcast_convert_type(vals, col.values.dtype)
        valid = None
        if col.valid is not None:
            valid = fetched[("valid", src)] > 0
        if nullable_out:
            valid = matched if valid is None else (valid & matched)
        out[src] = Column(vals, valid)
    return out, matched


def _subset(t: Table, names) -> Table:
    """View of ``t`` restricted to ``names`` (no data movement).  Keeps
    row movement (gathers, compactions) from paying for
    columns the join never projects into its output."""
    names = list(dict.fromkeys(names))
    attrs = [t.schema.lookup(n) for n in names]
    return Table(TupleSchema(attrs), {n: t.columns[n] for n in names},
                 t.num_rows, {n: t.dicts[n] for n in names if n in t.dicts},
                 cap_hint=t.capacity)


class HashJoin(Operation):
    """reference: HashJoinOperation (hash_join.h:35)."""

    def __init__(self, join_type: JoinType,
                 lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                 lhs: Operation, rhs: Operation,
                 rhs_key_uniqueness: KeyUniqueness = KeyUniqueness.NOT_UNIQUE,
                 lhs_projector: Optional[Projector] = None,
                 rhs_projector: Optional[Projector] = None,
                 out_capacity: Optional[int] = None,
                 allow_dense_lookup: bool = True):
        if len(lhs_keys) != len(rhs_keys) or not lhs_keys:
            raise SchemaError("join key lists must be equal-length, non-empty")
        self.join_type = join_type
        self.lhs_keys = list(lhs_keys)
        self.rhs_keys = list(rhs_keys)
        self.lhs = lhs
        self.rhs = rhs
        self.uniqueness = rhs_key_uniqueness
        self.lhs_projector = lhs_projector or Projector.all()
        self.rhs_projector = rhs_projector or Projector.all()
        self.out_capacity = out_capacity
        self.allow_dense_lookup = allow_dense_lookup

    def bind(self, ctx: BindContext, _masked: bool = False) -> BoundOperation:
        # _masked (UNIQUE rhs only): produce the join output at lhs
        # capacity as (Table, keep_mask) WITHOUT compacting — consumers
        # that already reduce over masks (GroupAggregate, Sort) fold the
        # mask into their pad key, saving a full compaction
        # (the same fusion contract as unwrap_filters).
        if self.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            if _masked:
                raise SchemaError(
                    "masked join binding supports INNER/LEFT_OUTER only")
            return self._bind_outer_rewrite(ctx)
        if _masked and self.uniqueness != KeyUniqueness.UNIQUE:
            raise SchemaError("masked join binding requires a UNIQUE rhs")
        from .filter import bind_predicates, keep_mask, unwrap_filters
        lhs_inner, lhs_preds = unwrap_filters(self.lhs)
        lb = lhs_inner.bind(ctx)
        bound_preds = bind_predicates(lhs_preds, lb)
        rb = self.rhs.bind(ctx)
        lpairs = self.lhs_projector.resolve(lb.schema)
        rpairs = self.rhs_projector.resolve(rb.schema)
        left_outer = self.join_type == JoinType.LEFT_OUTER
        attrs = []
        for src, dst in lpairs:
            a = lb.schema.lookup(src)
            attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
        for src, dst in rpairs:
            a = rb.schema.lookup(src)
            # LEFT_OUTER forces rhs outputs nullable (hash_join.cc:78-87)
            attrs.append(Attribute(dst, a.type, a.nullable or left_outer,
                                   a.enum))
        out_schema = TupleSchema(attrs)
        out_dicts = {}
        for src, dst in lpairs:
            if src in lb.dicts:
                out_dicts[dst] = lb.dicts[src]
        for src, dst in rpairs:
            if src in rb.dicts:
                out_dicts[dst] = rb.dicts[src]
        # key comparability: string keys must share dictionary space
        for lk, rk in zip(self.lhs_keys, self.rhs_keys):
            la, ra = lb.schema.lookup(lk), rb.schema.lookup(rk)
            if (la.type != ra.type and not
                    (la.type.value in ("INT32", "INT64", "UINT32", "UINT64")
                     and ra.type.value in ("INT32", "INT64", "UINT32",
                                           "UINT64"))):
                raise SchemaError(f"join key type mismatch {la.type}/{ra.type}")
        lhs_keys, rhs_keys = self.lhs_keys, self.rhs_keys
        unique = self.uniqueness == KeyUniqueness.UNIQUE
        # UNIQUE rhs bounds output by the probe side; NOT_UNIQUE has no
        # static bound — default to lhs+rhs (overflow raises at execute).
        if _masked:
            out_cap = lb.capacity
        elif unique and left_outer:
            # zero-copy lhs fast path emits exactly the lhs rows
            out_cap = lb.capacity
        elif self.out_capacity:
            out_cap = self.out_capacity
        elif unique:
            out_cap = lb.capacity
        else:
            out_cap = lb.capacity + rb.capacity
        for rsv in ("__bpos", "__d", "__cnt", "__match"):
            if lb.schema.has(rsv):
                raise SchemaError(f"column name {rsv!r} is reserved")
        for nm in lb.schema.names():
            if nm.startswith("__r"):
                raise SchemaError("column names '__r*' are reserved")
        # string join keys with separate dictionaries: remap ONLY the
        # build side into the PROBE's dictionary space — build values
        # absent from the probe dictionary can match nothing, so they
        # map to -1 (below every probe code).  The former merged-
        # dictionary scheme remapped BOTH sides, costing a probe-scale
        # remap gather (~42 ms for 8M probes against a 1M-entry
        # dictionary); the probe side now pays nothing.
        remaps = []
        code_domains = []  # per-key dense code domain (STRING/BINARY)
        from ..types import DataType
        for i, (lk, rk) in enumerate(zip(lhs_keys, rhs_keys)):
            la = lb.schema.lookup(lk)
            if la.type in (DataType.STRING, DataType.BINARY):
                dl, dr = lb.dicts[lk], rb.dicts[rk]
                if dl is dr:
                    remaps.append(None)
                else:
                    import numpy as _np
                    bmap = _np.array([dl.lookup(v) for v in dr.values],
                                     dtype=_np.int32)
                    if bmap.size == 0:
                        bmap = _np.zeros(1, dtype=_np.int32)
                    remaps.append(jnp.asarray(bmap))
                code_domains.append(max(len(dl), 1))
            else:
                remaps.append(None)
                code_domains.append(None)

        # Dense-build fast path: keys whose composite value domain is
        # small — integer keys with tight planner statistics, and
        # STRING/BINARY/ENUM keys whose dictionary codes are dense by
        # construction (multi-key: product of per-key ranges).  UNIQUE
        # rhs -> a direct-address fat LUT holding the projected rhs
        # columns (one scatter to build + one packed gather to probe);
        # NOT_UNIQUE rhs -> a CSR layout (scatter-add counts + exclusive
        # prefix-sum offsets over a build-side-only sort), so each probe
        # reads its (lower, count) match range with one packed gather.
        # Either way the joint build+probe sort and the back sort of the
        # merge probe disappear.  A runtime range-guard error flag keeps
        # the compiled program safe when stats-driven ranges go stale on
        # re-run with different leaf data of the same shapes.
        def _dense_dims():
            """Per-key dense dimensions (kmin, range, use_codes) whose
            composite slot = sum_i (v_i - kmin_i) * stride_i addresses a
            LUT of size prod(range_i).  STRING/BINARY dictionary codes
            and ENUM value maps are dense by construction; integer keys
            need bind-time planner stats (runtime range-guarded)."""
            dims, total, guarded = [], 1, False
            for i, (lk, rk) in enumerate(zip(lhs_keys, rhs_keys)):
                la = lb.schema.lookup(lk)
                ra = rb.schema.lookup(rk)
                if la.type in (DataType.STRING, DataType.BINARY):
                    dims.append((0, code_domains[i], True))
                elif la.type == DataType.ENUM and ra.type == DataType.ENUM:
                    dom = max(len(la.enum.names), len(ra.enum.names), 1)
                    dims.append((0, dom, True))
                elif (remaps[i] is None
                        and la.type.value in _DENSE_KEY_TYPES
                        and ra.type.value in _DENSE_KEY_TYPES):
                    stats = rb.stats.get(rk)
                    if stats is None:
                        return None
                    kmin, kmax = stats
                    rng = kmax - kmin + 1
                    if rng <= 0:
                        return None
                    dims.append((kmin, rng, False))
                    guarded = True
                else:
                    return None
                total *= dims[-1][1]
                if total > _DENSE_RANGE_MAX:
                    return None
            if unique:
                # fat-LUT memory: one u32 lane per projected rhs column
                # (+flag +validity); cap total LUT bytes at ~256MB
                lanes = 1 + 2 * max(len(rpairs), 1)
                if total * lanes > 4 * _DENSE_RANGE_MAX:
                    return None
            if guarded:
                # stats-driven ranges can be sparse: cap LUT size at a
                # multiple of the build side
                budget = min(max(4 * rb.capacity, 1 << 20),
                             _DENSE_RANGE_MAX)
                if total > budget:
                    return None
            return dims, total, guarded

        dense_info = _dense_dims() if self.allow_dense_lookup else None

        # Rowid-direct probe: UNIQUE single-key join whose rhs key IS the
        # row position plus a constant (dense ascending primary key — the
        # reference's row-id join precondition, rowid_merge_join.h:24-40,
        # and the overwhelmingly common dimension-table shape).  The probe
        # indexes the rhs table directly: no LUT construction sort, no
        # scatter, no index at all — one packed gather.  Runtime-guarded
        # like every stats-driven choice.
        rowid_kmin = None
        rowid_stats = rb.stats.get(rhs_keys[0])
        if (self.allow_dense_lookup and unique and len(lhs_keys) == 1
                and remaps[0] is None
                and rhs_keys[0] in rb.rowid
                and rowid_stats is not None
                and lb.schema.lookup(lhs_keys[0]).type.value
                in _DENSE_KEY_TYPES
                and rb.schema.lookup(rhs_keys[0]).type.value
                in _DENSE_KEY_TYPES):
            rowid_kmin = rowid_stats[0]

        def fn(rctx: RunContext) -> Table:
            lt = lb.run(rctx)
            rt = rb.run(rctx)
            lkeep = keep_mask(bound_preds, rctx, lt) if bound_preds \
                else lt.row_mask()
            bcodes, bnull = _key_codes(rt, rhs_keys)
            pcodes, pnull = _key_codes(lt, lhs_keys)
            for i, rm in enumerate(remaps):
                if rm is not None:
                    bcodes[i] = take_clipped(rm, bcodes[i])
            rcap, lcap = rt.capacity, lt.capacity
            pinert = pnull | ~lkeep
            binert = bnull | ~rt.row_mask()
            rowid = jnp.arange(rcap, dtype=jnp.int32)
            rfetch = None

            def composite_slot(codes_list, table, key_names):
                """int64 composite LUT slot + in-range mask over all
                dense key dimensions (per-dim clip keeps the slot in
                [0, total) even for out-of-range values)."""
                dims, _total, _g = dense_info
                idx, inr = None, None
                for i, (kmin_i, rng_i, use_codes) in enumerate(dims):
                    v = codes_list[i] if use_codes \
                        else table.columns[key_names[i]].values
                    dlt = v.astype(jnp.int64) - kmin_i
                    ok = (dlt >= 0) & (dlt < rng_i)
                    dc = jnp.clip(dlt, 0, rng_i - 1)
                    idx = dc if idx is None else idx * rng_i + dc
                    inr = ok if inr is None else (inr & ok)
                return idx, inr

            if rowid_kmin is not None:
                # --- rowid-direct probe (rhs key == row position + kmin):
                # no index of any kind; one packed gather of the projected
                # rhs columns at (probe key - kmin) ---
                rk_col = rt.columns[rhs_keys[0]]
                expect = jnp.arange(rcap, dtype=jnp.int64) + rowid_kmin
                bad = rk_col.values.astype(jnp.int64) != expect
                if rk_col.valid is not None:
                    bad = bad | ~rk_col.valid
                rctx.error_flags.append((
                    "join rhs key is not the planned row-id sequence",
                    jnp.any(rt.row_mask() & bad)))
                pv = (lt.columns[lhs_keys[0]].values.astype(jnp.int64)
                      - rowid_kmin)
                matched = ~pinert & (pv >= 0) & (pv < rt.num_rows)
                # gather at the CLIPPED key index, not a matched-masked
                # one: the index then depends only on the probe keys (not
                # on filter predicates), so repeated executions over new
                # measure data reuse it — and validity is masked after
                pidx = jnp.clip(pv, 0, rcap - 1).astype(jnp.int32)
                rg = gather_table(_subset(rt, [s for s, _ in rpairs]),
                                  pidx, lt.num_rows)
                rfetch = {}
                for src in dict.fromkeys(s for s, _ in rpairs):
                    c = rg.columns[src]
                    valid = c.valid
                    if left_outer:
                        valid = matched if valid is None \
                            else (valid & matched)
                    rfetch[src] = Column(c.values, valid)
            elif dense_info is not None and not unique:
                # --- CSR probe (dense multi-match build keys) ---
                # The per-slot histogram comes from the same sort-based
                # marker stream as the fat LUT: build rows (slot*2) sort
                # against one marker per slot (slot*2+1) on the folded
                # key; a marker's stream position i_p = p + B(p) where
                # B(p) = live build rows with slot <= p, so compacting
                # the markers' (position - slot) yields the CSR end
                # offsets, and compacting the non-markers' rowids IS the
                # build-order permutation — one sort feeds both.
                from .filter import compact_arrays
                _dims, rng, guarded = dense_info
                bidx, binr = composite_slot(bcodes, rt, rhs_keys)
                inb = ~binert & binr
                if guarded:  # pure code domains can't miss
                    rctx.error_flags.append((
                        "join build keys exceed planned dense range",
                        jnp.any(~binert & ~binr)))
                # dead rows take slot rng -> 2*rng: after every marker
                bslot = jnp.where(inb, bidx, rng).astype(jnp.int32)
                slot2 = jnp.concatenate([
                    bslot * 2, jnp.arange(rng, dtype=jnp.int32) * 2 + 1])
                pay = jnp.concatenate([rowid,
                                       jnp.zeros(rng, jnp.int32)])
                sres = jax.lax.sort([slot2, pay], num_keys=1,
                                    is_stable=True)
                s_slot2, s_pay = sres
                is_marker = (s_slot2 % 2) == 1
                pos_s = jnp.arange(rcap + rng, dtype=jnp.int32)
                b_upto = pos_s - (s_slot2 // 2)   # B(p) at markers
                end_ = compact_arrays([b_upto], is_marker, rng)[0]
                start = jnp.where(jnp.arange(rng, dtype=jnp.int32) > 0,
                                  jnp.roll(end_, 1), 0)
                counts = end_ - start
                build_perm, bslot_s = compact_arrays(
                    [s_pay, s_slot2 // 2], ~is_marker, rcap)
                pidx, pinr = composite_slot(pcodes, lt, lhs_keys)
                pin = pinr & ~pinert
                pslot = pidx.astype(jnp.int32)
                # one packed gather for (count, start)
                g_cnt, g_start = gather_arrays([counts, start.astype(
                    jnp.int32)], pslot)
                count = jnp.where(pin, g_cnt, 0)
                lower = jnp.where(pin, g_start, 0)
            elif dense_info is not None:
                # --- direct-address probe (dense unique build keys) ---
                _dims, rng, guarded = dense_info
                bidx, binr = composite_slot(bcodes, rt, rhs_keys)
                inb = ~binert & binr
                if guarded:  # pure code domains can't miss
                    rctx.error_flags.append((
                        "join build keys exceed planned dense range",
                        jnp.any(~binert & ~binr)))
                scat = jnp.where(inb, bidx, rng).astype(jnp.int32)
                pidx, pinr = composite_slot(pcodes, lt, lhs_keys)
                pin = pinr & ~pinert
                pslot = pidx.astype(jnp.int32)
                rfetch, matched = _fat_lut_probe(
                    rt, [s for s, _ in rpairs], scat, pslot, pin, rng,
                    left_outer)
            else:
                # --- build: sort non-null rhs keys (NULL/pad rows sort
                # last and are excluded from the searched range) ---
                res = jax.lax.sort(
                    [binert.astype(jnp.int32)] + bcodes + [rowid],
                    num_keys=1 + len(bcodes), is_stable=True)
                build_perm = res[-1]
                # --- probe: merge-style ---
                # A vectorized binary search costs ~2*log2(build) serial
                # gather rounds over all probe rows.  Instead sort build+probe
                # keys TOGETHER (side as tiebreak key: build rows precede
                # probe rows within an equal-key run); then for a probe
                # row, upper = inclusive prefix-count of live build rows,
                # and lower = that count at its run's start — pure
                # cumsum/cummax work.  One more payload sort restores
                # probe row order.
                cat_codes = []
                for bc, pc in zip(bcodes, pcodes):
                    dt = jnp.promote_types(bc.dtype, pc.dtype)
                    cat_codes.append(jnp.concatenate(
                        [bc.astype(dt), pc.astype(dt)]))
                # 3-valued side key doubles as the is-build flag (0 = live
                # build < 1 = probe < 2 = dead build), saving one 9M-row
                # sort operand: within an equal-key run live build rows
                # precede probes and dead build rows trail harmlessly
                side = jnp.concatenate([
                    jnp.where(binert, 2, 0).astype(jnp.int32),
                    jnp.ones(lcap, jnp.int32)])
                rowid_cat = jnp.concatenate([
                    rowid, jnp.arange(lcap, dtype=jnp.int32)])
                # operand packing (one sort operand fewer): when both
                # row ids fit
                # 24 bits, (side, rowid) ride ONE i32 key side*2^24+rowid
                # — the explicit rowid ordering replaces sort stability,
                # so the packed sort runs unstable (cheaper) and one
                # operand shorter.
                packed_ids = max(rcap, lcap) <= (1 << 24)
                if packed_ids:
                    side_rowid = side * (1 << 24) + rowid_cat
                    jres = jax.lax.sort(cat_codes + [side_rowid],
                                        num_keys=len(cat_codes) + 1,
                                        is_stable=False)
                    s_codes = jres[:len(cat_codes)]
                    s_side = jres[-1] >> 24
                    s_rowid = jres[-1] & ((1 << 24) - 1)
                else:
                    jres = jax.lax.sort(cat_codes + [side, rowid_cat],
                                        num_keys=len(cat_codes) + 1,
                                        is_stable=True)
                    s_codes = jres[:len(cat_codes)]
                    s_side, s_rowid = jres[-2], jres[-1]
                s_isb = (s_side == 0).astype(jnp.int32)
                bprefix = cumsum_i32(s_isb)
                tot = rcap + lcap
                same_as_prev = jnp.ones(tot, dtype=jnp.bool_)
                for c in s_codes:
                    same_as_prev = same_as_prev & (c == jnp.roll(c, 1))
                boundary = ~same_as_prev | (
                    jnp.arange(tot, dtype=jnp.int32) == 0)
                # build-count before this run; values are
                # nondecreasing across runs so a plain cummax
                # forward-fills run starts
                run_start = cummax_i32(
                    jnp.where(boundary, bprefix - s_isb, 0))
                # back sort keyed on is-probe (side==1), not the
                # 3-valued side, so probe rows land in the static
                # [rcap:] slice
                is_probe = (s_side == 1).astype(jnp.int32)
                if packed_ids:
                    back = jax.lax.sort(
                        [is_probe * (1 << 24) + s_rowid,
                         run_start.astype(jnp.int32),
                         bprefix.astype(jnp.int32)],
                        num_keys=1, is_stable=False)
                    lower = back[1][rcap:]
                    upper = back[2][rcap:]
                else:
                    back = jax.lax.sort(
                        [is_probe, s_rowid,
                         run_start.astype(jnp.int32),
                         bprefix.astype(jnp.int32)],
                        num_keys=2, is_stable=True)
                    lower = back[2][rcap:]
                    upper = back[3][rcap:]
                count = jnp.where(pinert, 0, upper - lower)
            if unique:
                # fast path: <=1 match per probe row, so no expansion.
                # LEFT_OUTER keeps lhs columns zero-copy; INNER moves the
                # surviving rows with one compaction.
                if rfetch is None:
                    count = jnp.minimum(count, 1)
                    matched = (count > 0) & lkeep
                    # gather rhs rows through a build-order pre-sort of the
                    # (small) rhs table: one rcap-index gather up front
                    # replaces a build_perm resolution per probe row
                    rsrc = gather_table(
                        _subset(rt, [s for s, _ in rpairs]), build_perm,
                        rt.num_rows)
                    rpos_full = jnp.clip(lower, 0, rcap - 1)

                def rhs_at_probe():
                    """rhs output columns at lhs capacity (arbitrary values
                    where not matched; LEFT_OUTER validity pre-masked)."""
                    if rfetch is not None:
                        return dict(rfetch)
                    ridx_m = jnp.where(matched, rpos_full, -1)
                    rg = gather_table(rsrc, ridx_m, lt.num_rows,
                                      fill_invalid=left_outer)
                    out = {}
                    for src in dict.fromkeys(s for s, _ in rpairs):
                        c = rg.columns[src]
                        if left_outer and c.valid is None:
                            c = Column(c.values,
                                       jnp.ones(lcap, dtype=jnp.bool_))
                        out[src] = c
                    return out

                if _masked:
                    rcols = rhs_at_probe()
                    cols = {}
                    for src, dst in lpairs:
                        cols[dst] = lt.columns[src]
                    for src, dst in rpairs:
                        cols[dst] = rcols[src]
                    keep_out = lkeep if left_outer else matched
                    return Table(out_schema, cols, lt.num_rows, out_dicts,
                                 cap_hint=lcap), keep_out
                if left_outer and not bound_preds:
                    rcols = rhs_at_probe()
                    cols = {}
                    for src, dst in lpairs:
                        cols[dst] = lt.columns[src]
                    for src, dst in rpairs:
                        cols[dst] = rcols[src]
                    return Table(out_schema, cols, lt.num_rows, out_dicts,
                                 cap_hint=lcap)
                # compaction path: INNER keeps matched rows; fused
                # LEFT_OUTER keeps all filter-surviving rows.  With a fat
                # LUT the probed rhs columns ride the compaction payload
                # sort directly; otherwise the build position __bpos rides
                # it and the rhs rows are gathered after compaction.
                emit = lkeep if left_outer else matched
                aug_attrs = []
                lsub = _subset(lt, [s for s, _ in lpairs])
                aug_cols = dict(lsub.columns)
                rname = {}
                if rfetch is not None:
                    for i, src in enumerate(
                            dict.fromkeys(s for s, _ in rpairs)):
                        nm = f"__r{i}"
                        ra = rb.schema.lookup(src)
                        c = rfetch[src]
                        aug_attrs.append(Attribute(
                            nm, ra.type, c.valid is not None, ra.enum))
                        aug_cols[nm] = c
                        rname[src] = nm
                else:
                    aug_attrs.append(Attribute("__bpos", DataType.INT32,
                                               False))
                    aug_cols["__bpos"] = Column(
                        rpos_full.astype(jnp.int32), None)
                    if left_outer:
                        aug_attrs.append(
                            Attribute("__match", DataType.BOOL, False))
                        aug_cols["__match"] = Column(matched, None)
                aug_schema = lsub.schema.concat(TupleSchema(aug_attrs))
                aug = Table(aug_schema, aug_cols, lt.num_rows,
                            dict(lsub.dicts), cap_hint=lcap)
                from .filter import compact_by_mask
                if out_cap < lcap:
                    rctx.error_flags.append((
                        "join result overflow",
                        jnp.sum(emit.astype(jnp.int32), dtype=jnp.int32) > out_cap))
                lhs_out = compact_by_mask(aug, emit, out_cap)
                n_out = lhs_out.num_rows
                cols = {}
                for src, dst in lpairs:
                    cols[dst] = lhs_out.columns[src]
                if rfetch is not None:
                    for src, dst in rpairs:
                        cols[dst] = lhs_out.columns[rname[src]]
                    return Table(out_schema, cols, n_out, out_dicts)
                live_o = (jnp.arange(out_cap, dtype=jnp.int32)
                          < jnp.asarray(n_out, jnp.int32))
                hit_o = live_o
                if left_outer:
                    hit_o = live_o & lhs_out.columns["__match"].values
                ridx = jnp.where(
                    hit_o, lhs_out.columns["__bpos"].values, -1)
                rgath = gather_table(rsrc, ridx, n_out,
                                     fill_invalid=left_outer)
                for src, dst in rpairs:
                    c = rgath.columns[src]
                    if left_outer and c.valid is None:
                        c = Column(c.values,
                                   jnp.ones(c.values.shape[0],
                                            dtype=jnp.bool_))
                    cols[dst] = c
                return Table(out_schema, cols, n_out, out_dicts)
            if left_outer:
                eff = jnp.where(lkeep, jnp.maximum(count, 1), 0)
            else:
                eff = count
            # int32 cumsum: output capacities are int32-bounded anyway;
            # only the overflow *detector* itself could wrap on >2^31
            # total matches (accepted).
            offsets = cumsum_i32(eff)
            total = offsets[-1]
            rctx.error_flags.append(
                ("join result overflow", total > out_cap))
            # expansion: output j belongs to the lhs row whose output range
            # [base, base+eff) covers j.  Instead of a searchsorted
            # (~log2(rows) serial gather rounds), scatter each row index
            # at its base offset and forward-fill with a cummax — two
            # vectorized passes.
            out_pos = jnp.arange(out_cap, dtype=offsets.dtype)
            base = offsets - eff  # start offset per lhs row
            # scatter at base for ALL rows — an eff==0 row shares its base
            # with the next live row and has a smaller q, so .max still
            # picks the live row; the genuinely sorted index stream lets
            # XLA take its faster sorted-scatter path
            qrow = jnp.zeros(out_cap, dtype=jnp.int32).at[base].max(
                jnp.arange(lcap, dtype=jnp.int32), mode="drop",
                indices_are_sorted=True)
            qrow = cummax_i32(qrow)
            live_out = out_pos < jnp.minimum(total, out_cap)
            # output j of lhs row q maps to build slot lower[q] + (j -
            # base[q]); the fused difference (lower - base) — and, for
            # LEFT_OUTER, the match count — ride the packed lhs gather as
            # extra int32 lanes instead of separate gathers.
            n_out = jnp.minimum(total, out_cap)
            d = (lower - base.astype(jnp.int32)).astype(jnp.int32)
            qidx = jnp.where(live_out, qrow, lcap)
            from ..types import DataType as _DT
            lsub = _subset(lt, [s for s, _ in lpairs])
            aug_attrs = [Attribute("__d", _DT.INT32, False)]
            aug_cols = dict(lsub.columns)
            aug_cols["__d"] = Column(d, None)
            if left_outer:
                aug_attrs.append(Attribute("__cnt", _DT.INT32, False))
                aug_cols["__cnt"] = Column(count.astype(jnp.int32), None)
            aug = Table(lsub.schema.concat(TupleSchema(aug_attrs)), aug_cols,
                        lt.num_rows, dict(lsub.dicts), cap_hint=lcap)
            # --- gather + stitch ---
            lgath = gather_table(aug, qidx, n_out)
            bpos = out_pos.astype(jnp.int32) + lgath.columns["__d"].values
            if left_outer:
                # unmatched lhs rows (count==0, eff==1) emit a NULL rhs row
                has_match = lgath.columns["__cnt"].values > 0
            else:
                # INNER: eff == count, so every covered output position has
                # a real match
                has_match = live_out
            # rhs rows come from a build-order pre-sort of the (small) rhs
            # table: one rcap-index gather up front replaces the 8M-index
            # build_perm resolution per output row
            rsorted = gather_table(_subset(rt, [s for s, _ in rpairs]),
                                   build_perm, rt.num_rows)
            ridx = jnp.where(has_match & live_out, bpos, -1)
            rgath = gather_table(rsorted, ridx, n_out,
                                 fill_invalid=left_outer)
            cols = {}
            for src, dst in lpairs:
                cols[dst] = lgath.columns[src]
            for src, dst in rpairs:
                c = rgath.columns[src]
                a = rb.schema.lookup(src)
                if left_outer and c.valid is None:
                    c = Column(c.values, jnp.ones(out_cap, dtype=jnp.bool_))
                cols[dst] = c
            return Table(out_schema, cols, n_out, out_dicts)

        # planner stats: projected lhs/rhs columns keep their bounds
        # (gathers preserve the value set; LEFT_OUTER adds NULLs only)
        out_stats = {}
        return self._finish_bind(out_schema, out_dicts, fn, out_cap,
                                 out_stats, lpairs, rpairs, lb, rb)

    def _bind_outer_rewrite(self, ctx: BindContext) -> BoundOperation:
        """RIGHT_OUTER / FULL_OUTER by construction from the implemented
        join forms (the reference declares both in JoinType but never
        implements them — hash_join.h:37).

        RIGHT_OUTER(l, r) == mirror of LEFT_OUTER(r, l) with the output
        columns re-ordered to (lhs..., rhs...).  The mirrored build side
        (the original lhs) has unknown key multiplicity -> NOT_UNIQUE.

        FULL_OUTER(l, r) == LEFT_OUTER(l, r) ∪ the NULL-lhs-padded rhs
        rows with no live lhs key match; the anti mask comes from a
        LEFT_OUTER probe of rhs against the DISTINCT lhs keys carrying a
        non-null marker constant (unmatched rows surface a NULL marker).
        Pure operator composition: UnionAll's dynamic-update-slice
        concatenation and the existing join/group machinery do the work.
        """
        from .project import Project
        from ..types import DataType as _DT

        lsch = self.lhs.bind(ctx).schema
        rsch = self.rhs.bind(ctx).schema
        lpairs = self.lhs_projector.resolve(lsch)
        rpairs = self.rhs_projector.resolve(rsch)
        order = [dst for _, dst in lpairs] + [dst for _, dst in rpairs]
        if self.join_type == JoinType.RIGHT_OUTER:
            mirrored = HashJoin(
                JoinType.LEFT_OUTER, self.rhs_keys, self.lhs_keys,
                self.rhs, self.lhs, KeyUniqueness.NOT_UNIQUE,
                lhs_projector=self.rhs_projector,
                rhs_projector=self.lhs_projector,
                out_capacity=self.out_capacity,
                allow_dense_lookup=self.allow_dense_lookup)
            return Project(Projector.named(*order), mirrored).bind(ctx)
        # FULL_OUTER
        from .aggregate import GroupAggregate
        from .compute import Compute
        from .filter import Filter
        from .union import UnionAll
        from ..exprs import Const, IsNull, Null, col as _col

        marker = "__full_outer_m"
        if marker in rsch.names() or marker in lsch.names():
            raise SchemaError(f"column name {marker!r} is reserved")
        left_part = HashJoin(
            JoinType.LEFT_OUTER, self.lhs_keys, self.rhs_keys,
            self.lhs, self.rhs, self.uniqueness,
            lhs_projector=self.lhs_projector,
            rhs_projector=self.rhs_projector,
            out_capacity=self.out_capacity,
            allow_dense_lookup=self.allow_dense_lookup)
        distinct_keys = GroupAggregate(self.lhs_keys, [], self.lhs)
        build = Compute(
            [_col(k) for k in self.lhs_keys]
            + [Const(True).as_(marker)], distinct_keys)
        marker_join = HashJoin(
            JoinType.LEFT_OUTER, self.rhs_keys, self.lhs_keys,
            self.rhs, build, KeyUniqueness.UNIQUE,
            lhs_projector=self.rhs_projector,
            rhs_projector=Projector.named(marker),
            allow_dense_lookup=self.allow_dense_lookup)
        anti = Filter(IsNull(_col(marker)), marker_join)
        pad_exprs = []
        for src, dst in lpairs:
            a = lsch.lookup(src)
            pad_exprs.append(Null(a.type).as_(dst))
        for src, dst in rpairs:
            pad_exprs.append(_col(dst))
        padded = Compute(pad_exprs, anti)
        return UnionAll(left_part, padded).bind(ctx)

    def _finish_bind(self, out_schema, out_dicts, fn, out_cap, out_stats,
                     lpairs, rpairs, lb, rb) -> BoundOperation:
        for src, dst in lpairs:
            if src in lb.stats:
                out_stats[dst] = lb.stats[src]
        for src, dst in rpairs:
            if src in rb.stats:
                out_stats[dst] = rb.stats[src]
        return BoundOperation(out_schema, out_dicts, fn, out_cap,
                              stats=out_stats)

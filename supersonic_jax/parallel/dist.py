"""Distributed execution: hash-partitioned tables + all-to-all shuffle.

This is the layer the reference explicitly anticipates but does not have
(SURVEY.md §2.9, §5.8): Supersonic documents the pregroup -> shuffle ->
combine contract (aggregate.h:233-246) and ships disk-spill exchange; on
a multi-device host the exchange is ``lax.all_to_all`` inside
``shard_map`` on a 1-D device mesh (the devices are joined all to all,
so the mesh follows the algorithm alone).

Representation: a *distributed table* is an ordinary ``Table`` whose column
leaves carry a leading partition dim [P, cap] and whose ``num_rows`` is an
int32[P] vector, sharded P('x').  Inside ``shard_map`` each shard squeezes
its [1, cap] block into a plain local Table and reuses the single-chip
operators unchanged — one code path for 1..N chips.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..batch import Column, Table
from ..ops.aggregate import (AggregationSpecification, AggSpec, Aggregation,
                             BestEffortGroupAggregate, GroupAggregate,
                             GroupAggregateOptions)
from ..ops.base import RunContext, bind_plan
from ..ops.filter import compact_by_mask
from ..ops.hash_join import HashJoin, JoinType, KeyUniqueness
from ..ops.keys import group_code_columns, key_operands
from ..ops.scan import ScanTable
from ..ops.sort import Sort, SortOrder
from ..schema import TupleSchema
from .hashing import hash_of_pairs, partition_of

AXIS = "x"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()[: (n_devices or len(jax.devices()))]
    return Mesh(np.array(devs), (AXIS,))


# ---------------------------------------------------------------------------
# distributed-table construction (host side)
# ---------------------------------------------------------------------------

def distribute_table(table: Table, mesh: Mesh,
                     keys: Optional[Sequence[str]] = None,
                     cap_per_shard: Optional[int] = None) -> Table:
    """Split a host Table into P row partitions (round-robin, or by key
    hash when ``keys`` given) and shard it over the mesh."""
    P_ = mesh.devices.size
    n = int(table.num_rows)
    if keys:
        pairs = group_code_columns(table, list(keys))
        h = hash_of_pairs(pairs)
        dest = np.asarray(partition_of(h, P_))[:n]
    else:
        dest = np.arange(n, dtype=np.int32) % P_
    cap = cap_per_shard or max(1, -(-table.capacity // P_) * 2)
    counts = np.bincount(dest, minlength=P_)
    if counts.max(initial=0) > cap:
        cap = int(counts.max())
    cols = {}
    order = np.argsort(dest, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)])
    for name in table.schema.names():
        c = table.columns[name]
        vals = np.asarray(c.values)[:n]
        stacked = np.zeros((P_, cap), dtype=vals.dtype)
        for p in range(P_):
            sel = order[offs[p]:offs[p + 1]]
            stacked[p, : len(sel)] = vals[sel]
        valid = None
        if c.valid is not None:
            v = np.asarray(c.valid)[:n]
            sv = np.zeros((P_, cap), dtype=bool)
            for p in range(P_):
                sel = order[offs[p]:offs[p + 1]]
                sv[p, : len(sel)] = v[sel]
            valid = jax.device_put(
                sv, NamedSharding(mesh, P(AXIS, None)))
        cols[name] = Column(
            jax.device_put(stacked, NamedSharding(mesh, P(AXIS, None))),
            valid)
    num_rows = jax.device_put(counts.astype(np.int32),
                              NamedSharding(mesh, P(AXIS)))
    return Table(table.schema, cols, num_rows, dict(table.dicts),
                 cap_hint=cap)


def collect_table(dist: Table) -> Table:
    """Gather a distributed table back to one host Table (debug/test)."""
    from ..batch import concat_tables
    P_ = dist.columns[dist.schema.names()[0]].values.shape[0] \
        if len(dist.schema) else dist.num_rows.shape[0]
    parts = []
    counts = np.asarray(dist.num_rows)
    for p in range(P_):
        cols = {}
        for name in dist.schema.names():
            c = dist.columns[name]
            cols[name] = Column(
                jnp.asarray(np.asarray(c.values)[p]),
                None if c.valid is None
                else jnp.asarray(np.asarray(c.valid)[p]))
        parts.append(Table(dist.schema, cols, int(counts[p]),
                           dict(dist.dicts)))
    return concat_tables(parts)


# ---------------------------------------------------------------------------
# shard_map plumbing
# ---------------------------------------------------------------------------

def _local_view(dist: Table) -> Table:
    """Inside shard_map: [1, cap] leaves -> local [cap] Table."""
    cols = {n: Column(c.values[0],
                      None if c.valid is None else c.valid[0])
            for n, c in dist.columns.items()}
    return Table(dist.schema, cols, dist.num_rows[0], dict(dist.dicts),
                 cap_hint=dist._cap_hint)


def _stack_local(table: Table) -> Table:
    """Inside shard_map: local [cap] Table -> [1, cap] leaves."""
    cols = {n: Column(c.values[None],
                      None if c.valid is None else c.valid[None])
            for n, c in table.columns.items()}
    num = jnp.reshape(table.num_rows, (1,)).astype(jnp.int32)
    return Table(table.schema, cols, num, dict(table.dicts),
                 cap_hint=table.capacity)


def dist_map(mesh: Mesh, fn: Callable[..., Table], *dist_tables: Table) -> Table:
    """Apply a local-table function per shard (embarrassingly parallel ops:
    filter/project/compute/local pregroup)."""

    def wrapper(*blocks):
        locals_ = [_local_view(b) for b in blocks]
        return _stack_local(fn(*locals_))

    specs = P(AXIS)
    return jax.shard_map(
        wrapper, mesh=mesh,
        in_specs=tuple(P(AXIS) for _ in dist_tables),
        out_specs=P(AXIS), check_vma=False)(*dist_tables)


def run_local_plan(plan_builder: Callable[[Table], "object"],
                   table: Table) -> Table:
    """Build + run a single-chip plan against one local table (traced).

    Device error flags the plan raises (overflow, signaling expressions)
    are synced through a debug callback — a shard failing inside a
    distributed plan fails the run instead of returning wrong rows,
    matching ops/base.py::execute semantics."""
    plan = plan_builder(table)
    bound, leaves = bind_plan(plan)
    ctx = RunContext(leaves)
    out = bound.run(ctx)
    if ctx.deferred:
        from ..schema import SchemaError
        raise SchemaError(
            "deferred host materialization (CONCAT aggregation / "
            "unbounded ToString/Format/DateFormat rendering) cannot run "
            "inside a distributed plan shard; compute it locally after "
            "collect_table, or use the ops.host helpers")
    if ctx.error_flags:
        names = [n for n, _ in ctx.error_flags]
        flags = jnp.stack([f for _, f in ctx.error_flags])

        def chk(fl, names=names):
            import warnings

            from ..exprs.base import EvaluationError
            hit = [names[i] for i, f in enumerate(np.asarray(fl)) if f]
            errs = [n for n in hit if not n.startswith("warning:")]
            for w in hit:
                if w.startswith("warning:"):
                    warnings.warn(w, RuntimeWarning, stacklevel=2)
            if errs:
                raise EvaluationError(
                    f"evaluation failed on a shard: {', '.join(errs)}")

        jax.debug.callback(chk, flags)
    return out


# ---------------------------------------------------------------------------
# the exchange: per-destination compaction + all_to_all
# ---------------------------------------------------------------------------

def _shard_cap(dist: Table) -> int:
    """Per-shard row capacity of a distributed [P, cap] table."""
    for c in dist.columns.values():
        return int(c.values.shape[1])
    return int(dist._cap_hint or 1)


def _default_peer_cap(shard_cap: int, num_parts: int,
                      skew_factor: int = 2, floor: int = 128) -> int:
    """Per-peer exchange buffer size when the caller gives none: the
    uniform-hash share (shard_cap / P) times a skew safety factor,
    hard-capped at shard_cap (a source shard can never send more rows to
    one peer than it holds — so dist_sort's factor 2P degrades to the
    overflow-proof exact bound).  A shuffle that still overflows raises
    (ERROR_MEMORY_EXCEEDED semantics, reference: memory.h:465) rather
    than dropping rows — callers pass an explicit ``out_cap_per_peer``
    to size for known-skewed keys.  The receive buffer (and every
    downstream operator's padded capacity) is P x this value, so the
    factor trades skew headroom directly against downstream compute."""
    base = -(-int(shard_cap) // max(num_parts, 1))
    return max(floor, min(base * skew_factor, int(shard_cap)))


def _exchange_local(local: Table, dest: jnp.ndarray, num_parts: int,
                    out_cap_per_peer: int) -> tuple[Table, jnp.ndarray]:
    """Inside shard_map: route rows of the local table to destinations.

    Radix shuffle (SURVEY.md §5.8): rows are sorted by destination (one
    stable sort), sliced into per-destination send buffers with prefix-sum
    offsets, exchanged with ``all_to_all``, then compacted on the receive
    side.  Returns ``(received local table, dropped)`` where ``dropped``
    is the int32 count of rows this shard could NOT send because a
    per-peer buffer overflowed — the capacity-exhaustion condition the
    reference surfaces as ERROR_MEMORY_EXCEEDED (memory.h:465,
    aggregate_groups.cc:420-427).  Callers must propagate it to a host
    sync point; see ``shuffle``.
    """
    cap = local.capacity
    live = local.row_mask()
    dest = jnp.where(live, dest, num_parts)
    rowid = jnp.arange(cap, dtype=jnp.int32)
    sorted_dest, perm = jax.lax.sort([dest, rowid], num_keys=1,
                                     is_stable=True)
    counts = jnp.bincount(jnp.where(live, dest, num_parts),
                          length=num_parts + 1)[:num_parts].astype(jnp.int32)
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    k = jnp.arange(out_cap_per_peer, dtype=jnp.int32)
    send_pos = offsets[:, None] + k[None, :]              # [P, out_cap]
    send_valid = k[None, :] < counts[:, None]
    send_idx = jnp.take(perm, jnp.clip(send_pos, 0, cap - 1))
    sent_counts = jnp.minimum(counts, out_cap_per_peer)
    # int32 accumulator: under x64 jnp.sum would promote to s64, and an
    # s64 per-shard scalar flowing to the host-sync callback forces the
    # SPMD partitioner into involuntary full rematerialization copies
    dropped = jnp.sum(counts - sent_counts, dtype=jnp.int32)

    def a2a(x):
        return jax.lax.all_to_all(x, AXIS, split_axis=0, concat_axis=0,
                                  tiled=False)

    recv_counts = a2a(sent_counts.reshape(num_parts, 1)).reshape(num_parts)
    cols = {}
    recv_valid_mask = (k[None, :] < recv_counts[:, None]).reshape(-1)
    for name in local.schema.names():
        c = local.columns[name]
        send_vals = jnp.take(c.values, send_idx)          # [P, out_cap]
        rv = a2a(send_vals).reshape(-1)                   # [P*out_cap]
        valid = None
        if c.valid is not None:
            send_v = jnp.take(c.valid, send_idx) & send_valid
            valid = a2a(send_v).reshape(-1) & recv_valid_mask
        cols[name] = Column(rv, valid)
    total = jnp.sum(recv_counts)
    flat_cap = num_parts * out_cap_per_peer
    recv = Table(local.schema, cols, total, dict(local.dicts),
                 cap_hint=flat_cap)
    # compact interleaved per-source padding into a dense prefix;
    # sent_counts doubles as the measured exchange-row accounting
    return (compact_by_mask(recv, recv_valid_mask, flat_cap), dropped,
            sent_counts)


def _raise_overflow(lost: int) -> None:
    from ..exprs.base import EvaluationError
    raise EvaluationError(
        f"distributed exchange overflow: {lost} rows exceeded "
        "out_cap_per_peer (ERROR_MEMORY_EXCEEDED; raise "
        "out_cap_per_peer or repartition skewed keys)")


def check_exchange_overflow(dropped) -> None:
    """Host sync for the exchange's dropped-row counts: raise like the
    single-chip error-flag path (ops/base.py::execute) instead of
    returning silently-wrong results.  ``dropped`` is an int array of
    per-shard counts (any shape).  Eager: raises ``EvaluationError``
    immediately.  Under a jit trace: registers a debug callback that
    fails the run at execution time (surfaces as JaxRuntimeError)."""
    if isinstance(dropped, jax.core.Tracer):
        def chk(d):
            lost = int(np.sum(d))
            if lost:
                _raise_overflow(lost)
        jax.debug.callback(chk, dropped)
        return
    lost = int(np.sum(np.asarray(jax.device_get(dropped))))
    if lost:
        _raise_overflow(lost)


def table_row_bytes(schema: TupleSchema) -> int:
    """Wire bytes per exchanged row: physical value bytes plus one
    byte-bool validity lane per nullable column (the arrays all_to_all
    actually moves)."""
    from ..types import physical_dtype

    total = 0
    for a in schema:
        total += int(np.dtype(physical_dtype(a.type)).itemsize)
        if a.nullable:
            total += 1
    return total


def shuffle(mesh: Mesh, dist: Table, dest_fn: Callable[[Table], jnp.ndarray],
            out_cap_per_peer: Optional[int] = None,
            check: bool = True, stats_out: Optional[dict] = None) -> Table:
    """Distributed radix shuffle: dest_fn gives each local row a partition.

    Overflow-safe: per-peer buffer exhaustion raises ``EvaluationError``
    at the host sync (``check=True``, the default) rather than dropping
    rows.  With ``check=False`` returns ``(table, dropped)`` — a
    mesh-replicated int32 scalar (psum over shards) — so callers
    composing larger traced programs can defer the sync.

    ``stats_out``: pass a dict to receive MEASURED exchange accounting
    (the reference's metric discipline, benchmark/proto/benchmark.proto):
    ``sent_rows`` [P, P] (src -> dst live row counts), ``row_bytes``,
    ``total_bytes``, and ``offmesh_bytes`` (excluding the src == dst
    diagonal, the share that actually crosses between devices)."""
    num_parts = mesh.devices.size
    out_cap_per_peer = out_cap_per_peer or _default_peer_cap(
        _shard_cap(dist), num_parts)

    def wrapper(block):
        local = _local_view(block)
        dest = dest_fn(local)
        recv, dropped, sent = _exchange_local(local, dest, num_parts,
                                              out_cap_per_peer)
        # psum -> a mesh-replicated scalar: the host-sync callback then
        # reads a replicated value instead of per-shard copies (avoids
        # SPMD involuntary-rematerialization)
        return _stack_local(recv), jax.lax.psum(dropped, AXIS), sent

    out, dropped, sent = jax.shard_map(
        wrapper, mesh=mesh, in_specs=P(AXIS),
        out_specs=(P(AXIS), P(), P(AXIS)), check_vma=False)(dist)
    if stats_out is not None:
        m = np.asarray(jax.device_get(sent)).reshape(num_parts, num_parts)
        rb = table_row_bytes(dist.schema)
        stats_out["sent_rows"] = m
        stats_out["row_bytes"] = rb
        stats_out["total_bytes"] = int(m.sum()) * rb
        stats_out["offmesh_bytes"] = int(m.sum() - np.trace(m)) * rb
    if not check:
        return out, dropped
    check_exchange_overflow(dropped)
    return out


def _key_dest_fn(names: list[str], num_parts: int):
    def dest(local: Table) -> jnp.ndarray:
        pairs = group_code_columns(local, names)
        h = hash_of_pairs(pairs)
        return partition_of(h, num_parts)
    return dest


# ---------------------------------------------------------------------------
# distributed operators
# ---------------------------------------------------------------------------

def combine_specification(spec: AggregationSpecification,
                          ) -> AggregationSpecification:
    """Partial-aggregate merge algebra (reference: aggregate_groups.cc:
    545-553 — COUNT combines via SUM; MIN/MAX idempotent; SUM associative;
    FIRST/LAST partition-order-defined)."""
    out = AggregationSpecification()
    for s in spec.specs:
        agg = s.aggregation
        if agg == Aggregation.CONCAT:
            from ..schema import SchemaError
            raise SchemaError(
                "CONCAT partial aggregates cannot be combined across "
                "partitions (order-sensitive, variable-length); compute "
                "CONCAT after collecting, or via ops.host.group_concat")
        if agg == Aggregation.COUNT:
            out.add(AggSpec(Aggregation.SUM, s.output, s.output,
                            s.output_type or None))
        else:
            out.add(AggSpec(agg, s.output, s.output, s.output_type))
    return out


def dist_group_aggregate(mesh: Mesh, dist: Table, group_by: Sequence[str],
                         spec, options: GroupAggregateOptions | None = None,
                         out_cap_per_peer: Optional[int] = None) -> Table:
    """pregroup -> shuffle by key hash -> final combine
    (the BestEffortGroupAggregate distributed contract,
    aggregate.h:233-246)."""
    if not isinstance(spec, AggregationSpecification):
        spec = AggregationSpecification(spec)
    options = options or GroupAggregateOptions()
    num_parts = mesh.devices.size
    names = list(group_by)
    has_distinct = any(s.distinct for s in spec.specs)

    if has_distinct:
        # raw shuffle then exact local aggregate (distinct can't pre-merge)
        shuffled = shuffle(mesh, dist, _key_dest_fn(names, num_parts),
                           out_cap_per_peer)
        return dist_map(
            mesh,
            lambda t: run_local_plan(
                lambda tt: GroupAggregate(names, spec, ScanTable(tt), options),
                t),
            shuffled)

    # pregroup is genuinely best-effort: under a memory_quota it emits
    # partial (non-key-unique) groups instead of raising — the final
    # combine below re-aggregates them exactly (aggregate.h:233-246).
    # The pregroup's row order is erased by the shuffle, so it binds
    # _unordered: no insertion-order re-rank and no first-occurrence
    # row-id sort operand per shard (lax.sort is operand-linear).
    class _UnorderedBind:
        def __init__(self, inner):
            self.inner = inner

        def bind(self, ctx):
            return self.inner.bind(ctx, _unordered=True)

    pre = dist_map(
        mesh,
        lambda t: run_local_plan(
            lambda tt: _UnorderedBind(
                BestEffortGroupAggregate(names, spec, ScanTable(tt),
                                         options)),
            t),
        dist)
    shuffled = shuffle(mesh, pre, _key_dest_fn(names, num_parts),
                       out_cap_per_peer)
    final_spec = combine_specification(spec)
    # the quota bounds the per-shard pregroup table; the final combine
    # must hold every key of its partition exactly
    import dataclasses
    final_options = dataclasses.replace(options, memory_quota=None)
    return dist_map(
        mesh,
        lambda t: run_local_plan(
            lambda tt: GroupAggregate(names, final_spec, ScanTable(tt),
                                      final_options),
            t),
        shuffled)


def dist_hash_join(mesh: Mesh, join_type: JoinType,
                   lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                   lhs: Table, rhs: Table,
                   rhs_key_uniqueness=KeyUniqueness.NOT_UNIQUE,
                   out_cap_per_peer: Optional[int] = None,
                   **join_kwargs) -> Table:
    """Partition both sides by key hash across the mesh, then join
    locally (SURVEY.md §3.3)."""
    num_parts = mesh.devices.size
    lsh = shuffle(mesh, lhs, _key_dest_fn(list(lhs_keys), num_parts),
                  out_cap_per_peer)
    # build side: when it is ALREADY partitioned by the join key (the
    # common layout for a dimension table), every shard sends its whole
    # shard to ONE peer — the uniform (shard_cap/P x 2) default cap is
    # structurally wrong there, so the build exchange defaults to the
    # full shard capacity (build sides are the small side by design)
    rsh = shuffle(mesh, rhs, _key_dest_fn(list(rhs_keys), num_parts),
                  out_cap_per_peer if out_cap_per_peer is not None
                  else _shard_cap(rhs))

    def local_join(lt: Table, rt: Table) -> Table:
        plan = HashJoin(join_type, list(lhs_keys), list(rhs_keys),
                        ScanTable(lt), ScanTable(rt), rhs_key_uniqueness,
                        **join_kwargs)
        bound, leaves = bind_plan(plan)
        return bound.run(RunContext(leaves))

    return dist_map(mesh, local_join, lsh, rsh)


def dist_hash_join_ring(mesh: Mesh, join_type: JoinType,
                        lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                        lhs: Table, rhs: Table) -> Table:
    """Ring-pipelined join for a UNIQUE build side: probe rows stay put;
    the build partitions rotate around the device ring with ``ppermute``
    while each shard probes the currently-resident partition — the
    exchange of step k+1 overlaps the probe compute of step k (the
    BASELINE north-star "exchange overlapped with compute"; SURVEY.md
    §5.8 ppermute pipelining).

    Avoids repartitioning the (large) probe side entirely: total traffic
    is P rotations of the build side only.  Output is lhs-shaped per
    shard: INNER compacts matched rows, LEFT_OUTER keeps every probe row
    with NULL rhs columns where no partition matched.
    """
    num_parts = mesh.devices.size
    lkeys, rkeys = list(lhs_keys), list(rhs_keys)
    left_outer = join_type == JoinType.LEFT_OUTER
    perm = [(i, (i + 1) % num_parts) for i in range(num_parts)]

    from ..ops.base import BindContext

    def wrapper(lblock, rblock):
        lt = _local_view(lblock)
        rt0 = _local_view(rblock)
        lcap = lt.capacity

        def masked_join(rt_vals, rt_valids, rt_n):
            cols = {}
            for n in rt0.schema.names():
                cols[n] = Column(rt_vals[n], rt_valids.get(n))
            rt = Table(rt0.schema, cols, rt_n, dict(rt0.dicts),
                       cap_hint=rt0.capacity)
            plan = HashJoin(JoinType.INNER, lkeys, rkeys, ScanTable(lt),
                            ScanTable(rt), KeyUniqueness.UNIQUE)
            ctx = BindContext()
            bound = plan.bind(ctx, _masked=True)
            return bound.run(RunContext(ctx.leaves))

        rt_vals0 = {n: rt0.columns[n].values for n in rt0.schema.names()}
        rt_valids0 = {n: rt0.columns[n].valid for n in rt0.schema.names()
                      if rt0.columns[n].valid is not None}
        # accumulated rhs output columns (lhs-shaped) + match mask
        out0, keep0 = masked_join(rt_vals0, rt_valids0, rt0.num_rows)
        acc0 = {n: (out0.columns[n].values,
                    out0.columns[n].valid_or_true())
                for n in rt0.schema.names()}

        def step(carry, _):
            rt_vals, rt_valids, rt_n, matched, acc = carry
            # rotate the build partition one hop; XLA overlaps the
            # collective-permute with the next iteration's probe
            rt_vals = {n: jax.lax.ppermute(v, AXIS, perm)
                       for n, v in rt_vals.items()}
            rt_valids = {n: jax.lax.ppermute(v, AXIS, perm)
                         for n, v in rt_valids.items()}
            rt_n = jax.lax.ppermute(jnp.reshape(rt_n, (1,)), AXIS,
                                    perm)[0]
            out, keep = masked_join(rt_vals, rt_valids, rt_n)
            new = keep & ~matched
            acc = {n: (jnp.where(new, out.columns[n].values, acc[n][0]),
                       jnp.where(new, out.columns[n].valid_or_true(),
                                 acc[n][1]))
                   for n in acc}
            return (rt_vals, rt_valids, rt_n, matched | keep, acc), None

        carry = (rt_vals0, rt_valids0, rt0.num_rows, keep0, acc0)
        if num_parts > 1:
            carry, _ = jax.lax.scan(step, carry, None,
                                    length=num_parts - 1)
        _, _, _, matched, acc = carry

        attrs = list(lt.schema) + [
            type(a)(a.name, a.type, a.nullable or left_outer, a.enum)
            for a in rt0.schema]
        out_schema = TupleSchema(attrs)
        cols = dict(lt.columns)
        for a in rt0.schema:
            vals, valid = acc[a.name]
            if left_outer:
                cols[a.name] = Column(vals, valid & matched)
            else:
                cols[a.name] = Column(
                    vals, valid if a.nullable else None)
        dicts = {**lt.dicts, **rt0.dicts}
        if left_outer:
            keep_rows = lt.row_mask()
        else:
            keep_rows = matched
        out = Table(out_schema, cols,
                    jnp.sum(keep_rows.astype(jnp.int32)), dicts,
                    cap_hint=lcap)
        return _stack_local(compact_by_mask(out, keep_rows, lcap))

    return jax.shard_map(wrapper, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
                         out_specs=P(AXIS), check_vma=False)(lhs, rhs)


def _hot_key_hashes(local: Table, keys: list[str], num_parts: int,
                    top_h: int, min_count) -> jnp.ndarray:
    """Globally-agreed hot key hashes (uint32[top_h]; 0xFFFFFFFF = unused).

    Each shard finds its top-H most frequent key hashes by sorted run
    lengths, all-gathers the candidates, combines counts, and keeps keys
    whose global count exceeds ``min_count``.  Deterministic and identical
    on every shard (skew detection per BASELINE north star).
    """
    cap = local.capacity
    pairs = group_code_columns(local, keys)
    h = hash_of_pairs(pairs)
    live = local.row_mask()
    h = jnp.where(live, h, jnp.uint32(0xFFFFFFFF))
    hs = jax.lax.sort([h], num_keys=1, is_stable=False)[0]
    pos = jnp.arange(cap, dtype=jnp.int32)
    boundary = (hs != jnp.roll(hs, 1)) | (pos == 0)
    # run length at run end = pos - run_start + 1
    from ..ops.scan32 import cummax_i32
    run_start = cummax_i32(jnp.where(boundary, pos, 0))
    nxt = jnp.roll(boundary, -1) | (pos == cap - 1)
    length = jnp.where(nxt & (hs != jnp.uint32(0xFFFFFFFF)),
                       (pos - run_start + 1).astype(jnp.int32), 0)
    # top-H runs on this shard
    res = jax.lax.sort([-length, hs], num_keys=1, is_stable=False)
    cand_h = res[1][:top_h]
    cand_c = (-res[0][:top_h]).astype(jnp.int32)
    all_h = jax.lax.all_gather(cand_h, AXIS, tiled=True)   # [P*H]
    all_c = jax.lax.all_gather(cand_c, AXIS, tiled=True)
    # combine counts for identical hashes (tiny O((PH)^2) compare)
    eq = all_h[:, None] == all_h[None, :]
    totals = jnp.sum(jnp.where(eq, all_c[None, :], 0), axis=1)
    first = jnp.argmax(eq, axis=1) == jnp.arange(all_h.shape[0])
    totals = jnp.where(first & (all_h != jnp.uint32(0xFFFFFFFF)), totals, 0)
    sel = jax.lax.sort([-totals, all_h], num_keys=1, is_stable=False)
    hot = jnp.where((-sel[0][:top_h]) >= min_count, sel[1][:top_h],
                    jnp.uint32(0xFFFFFFFF))
    return hot


def dist_hash_join_skew(mesh: Mesh, join_type: JoinType,
                        lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                        lhs: Table, rhs: Table,
                        rhs_key_uniqueness=KeyUniqueness.NOT_UNIQUE,
                        out_cap_per_peer: Optional[int] = None,
                        hot_cap: int = 1024, top_h: int = 16,
                        min_frac: float = 0.01, **join_kwargs) -> Table:
    """Skew-aware repartition join (BASELINE north star): keys hot enough
    to overwhelm one shard are detected from per-shard histograms; their
    BUILD rows are broadcast to every shard and their PROBE rows stay
    local, while cold keys take the normal hash shuffle."""
    num_parts = mesh.devices.size
    lcap = out_cap_per_peer or _default_peer_cap(_shard_cap(lhs), num_parts)
    rcap = out_cap_per_peer or _default_peer_cap(_shard_cap(rhs), num_parts)
    lkeys, rkeys = list(lhs_keys), list(rhs_keys)
    total_rows = int(np.sum(np.asarray(jax.device_get(lhs.num_rows))))
    min_count = max(int(total_rows * min_frac), 2)

    def probe_shuffle(block):
        local = _local_view(block)
        hot = _hot_key_hashes(local, lkeys, num_parts, top_h, min_count)
        pairs = group_code_columns(local, lkeys)
        h = hash_of_pairs(pairs)
        is_hot = jnp.any(h[:, None] == hot[None, :], axis=1)
        me = jax.lax.axis_index(AXIS).astype(jnp.int32)
        dest = jnp.where(is_hot, me, partition_of(h, num_parts))
        recv, dropped, _sent = _exchange_local(local, dest, num_parts, lcap)
        return _stack_local(recv), hot, dropped

    def build_shuffle(block, hot):
        local = _local_view(block)
        pairs = group_code_columns(local, rkeys)
        h = hash_of_pairs(pairs)
        is_hot = jnp.any(h[:, None] == hot[None, :], axis=1) \
            & local.row_mask()
        # cold rows: normal hash shuffle (hot rows excluded from exchange
        # on purpose — they travel via the all_gather broadcast below)
        dest = jnp.where(is_hot, num_parts, partition_of(h, num_parts))
        cold, dropped, _sent = _exchange_local(local, dest, num_parts, rcap)
        # hot rows: compact locally then all_gather to every shard
        from ..ops.filter import compact_by_mask
        hot_local = compact_by_mask(local, is_hot, hot_cap)
        gathered_cols = {}
        counts = jax.lax.all_gather(
            jnp.reshape(hot_local.num_rows, (1,)).astype(jnp.int32),
            AXIS, tiled=True)                      # [P]
        for name in local.schema.names():
            c = hot_local.columns[name]
            gv = jax.lax.all_gather(c.values, AXIS, tiled=True)  # [P*cap]
            gvalid = (None if c.valid is None else
                      jax.lax.all_gather(c.valid, AXIS, tiled=True))
            gathered_cols[name] = Column(gv, gvalid)
        gcap = num_parts * hot_cap
        gpos = jnp.arange(gcap, dtype=jnp.int32)
        live_g = (gpos % hot_cap) < jnp.take(counts, gpos // hot_cap)
        hot_all = Table(local.schema, gathered_cols, jnp.sum(counts),
                        dict(local.dicts), cap_hint=gcap)
        hot_dense = compact_by_mask(hot_all, live_g, gcap)
        from ..batch import concat_tables
        merged = concat_tables([cold, hot_dense])
        # hot rows beyond hot_cap would be silently truncated by the
        # compaction above — count them as overflow too
        dropped = dropped + jnp.maximum(
            jnp.sum(is_hot.astype(jnp.int32)) - hot_cap, 0)
        return _stack_local(merged), dropped

    def wrapper(lblock, rblock):
        shuffled_l, hot, l_dropped = probe_shuffle(lblock)
        shuffled_r, r_dropped = build_shuffle(rblock, hot)
        lt = _local_view(shuffled_l)
        rt = _local_view(shuffled_r)
        plan = HashJoin(join_type, lkeys, rkeys, ScanTable(lt),
                        ScanTable(rt), rhs_key_uniqueness, **join_kwargs)
        bound, leaves = bind_plan(plan)
        return (_stack_local(bound.run(RunContext(leaves))),
                jax.lax.psum(l_dropped + r_dropped, AXIS))

    out, dropped = jax.shard_map(
        wrapper, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P()), check_vma=False)(lhs, rhs)
    check_exchange_overflow(dropped)
    return out


def dist_sort(mesh: Mesh, dist: Table, order, samples_per_shard: int = 64,
              out_cap_per_peer: Optional[int] = None) -> Table:
    """Distributed sample sort: sample keys -> all_gather -> splitters ->
    range shuffle -> local sort.  Result is globally sorted in shard-major
    order (shard p holds keys <= shard p+1's)."""
    order = order if isinstance(order, SortOrder) else SortOrder(order)
    num_parts = mesh.devices.size
    names, ascs = order.names(), order.ascendings()
    # range-partitioned rows concentrate by key range, not hash: size for
    # a whole shard's rows landing on one peer when keys are clustered
    peer_cap = out_cap_per_peer or _default_peer_cap(
        _shard_cap(dist), num_parts, skew_factor=2 * num_parts)

    def dest_fn(local: Table) -> jnp.ndarray:
        ops, nk = key_operands(local, names, ascs)
        cap = local.capacity
        # local sort of key tuples to draw evenly-spaced samples
        sorted_ops = jax.lax.sort(ops, num_keys=nk, is_stable=False)
        n = jnp.maximum(local.num_rows, 1)
        take_at = (jnp.arange(samples_per_shard) * n) // samples_per_shard
        take_at = jnp.clip(take_at, 0, cap - 1).astype(jnp.int32)
        samples = [jnp.take(o, take_at) for o in sorted_ops]
        gathered = [jax.lax.all_gather(s, AXIS, tiled=True) for s in samples]
        g_sorted = jax.lax.sort(gathered, num_keys=len(gathered),
                                is_stable=False)
        total = num_parts * samples_per_shard
        split_at = (jnp.arange(1, num_parts) * total) // num_parts
        splitters = [jnp.take(g, split_at) for g in g_sorted]
        # dest = number of splitters strictly less than the row's key tuple
        dest = jnp.zeros(cap, dtype=jnp.int32)
        for i in range(num_parts - 1):
            lt = jnp.zeros(cap, dtype=jnp.bool_)
            eq = jnp.ones(cap, dtype=jnp.bool_)
            for s, o in zip(splitters, ops):
                sv = s[i]
                lt = lt | (eq & (sv < o))
                eq = eq & (sv == o)
            dest = dest + lt.astype(jnp.int32)
        return dest

    shuffled = shuffle(mesh, dist, dest_fn, peer_cap)
    return dist_map(
        mesh,
        lambda t: run_local_plan(lambda tt: Sort(order, ScanTable(tt)), t),
        shuffled)

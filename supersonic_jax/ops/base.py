"""Operation layer: static compiled operator DAGs.

Reference contract: ``Operation::CreateCursor()`` builds a pull-pipeline of
``Cursor``s streaming ≤1024-row views (reference: cursor/base/operation.h:35,
cursor/base/cursor.h:131).  Device redesign (SURVEY.md §2.2): the pull protocol
disappears — ``bind()`` resolves schemas bottom-up (the reference's
CreateCursor phase) and yields a traced function over whole capacity-padded
Tables; ``execute()`` jit-compiles the entire DAG into one XLA program.
Dynamic row counts ride through as traced ``num_rows`` scalars; EOS/BOS and
WAITING_ON_BARRIER have no equivalent under a static schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..batch import Table
from ..dictionary import Dictionary
from ..exprs.base import EvalContext, EvaluationError
from ..schema import TupleSchema


class Interrupted(RuntimeError):
    """Raised when a query is cooperatively cancelled (reference:
    ``Cursor::Interrupt``, cursor/base/cursor.h:160-166, which resolves
    to an INTERRUPTED ResultView)."""


class CancellationToken:
    """Cooperative in-flight cancellation.

    The reference propagates ``Interrupt()`` down the cursor tree and
    cursors poll the flag inside their ``Next()`` loops.  Under the
    compiled-DAG design one XLA dispatch is atomic, so the poll points
    are the host boundaries instead: ``execute()`` entry, every chunk of
    the external (spill) sort and the hybrid aggregation's pregroup /
    combine loops, and each deferred host-materialization item.  Call
    ``interrupt()`` from any thread; the query raises ``Interrupted`` at
    its next poll point.
    """

    __slots__ = ("_interrupted",)

    def __init__(self):
        self._interrupted = False

    def interrupt(self) -> None:
        self._interrupted = True

    def interrupted(self) -> bool:
        return self._interrupted

    def check(self) -> None:
        if self.interrupted():
            raise Interrupted("query interrupted")


@dataclass
class RunContext:
    """Execution-time state threaded through the bound DAG (traced)."""

    leaf_tables: list  # Tables for each leaf, in bind order
    error_flags: list = field(default_factory=list)
    cancel: Optional[CancellationToken] = None
    # host-materialization work registered during the trace (CONCAT
    # aggregation string assembly): entries carry static metadata plus an
    # ``aux`` dict of traced arrays returned as extra program outputs;
    # ``execute()`` resolves them after the device run (ops/host.py)
    deferred: list = field(default_factory=list)

    def eval_context(self, table: Table) -> EvalContext:
        return EvalContext(table, self.error_flags, self.deferred)


@dataclass
class BoundOperation:
    """Result of binding: static schema/dicts + a traced table function.

    ``stats`` carries planner statistics — per-column (min, max) value
    bounds known at bind time (from concrete leaf tables, propagated
    through value-preserving operators).  Used to pick dense strategies
    (direct-address joins, dense-domain aggregation); consumers must add
    a runtime guard flag since re-running a compiled plan with different
    leaf data can violate the planned bounds.
    """

    schema: TupleSchema
    dicts: dict[str, Dictionary]
    fn: Callable[[RunContext], Table]
    capacity: int  # static output capacity
    stats: dict[str, tuple[int, int]] = field(default_factory=dict)
    # columns whose value IS the row position plus stats[name][0] (dense
    # ascending primary keys, the reference's row-id join precondition —
    # rowid_merge_join.h:24-40).  Joins against such a key skip index
    # construction and probe the table directly (runtime-guarded).
    rowid: set = field(default_factory=set)

    def run(self, ctx: RunContext) -> Table:
        out = self.fn(ctx)
        # masked binds return (Table, keep) — validate the table part
        if _DEBUG_CHECKS:
            _append_debug_checks(out[0] if isinstance(out, tuple) else out,
                                 ctx)
        return out


# --- debug validation layer (reference: pervasive DCHECKs — block.h:91-94,
# cursor.h:114-117, bit_pointers.h:55-60).  Off by default; when enabled,
# every BoundOperation output is validated on device and violations raise
# through the standard error-flag host sync.
_DEBUG_CHECKS = False


def set_debug_checks(enabled: bool) -> None:
    """Enable DCHECK-style invariant validation on every operator output
    (debug builds of the reference do this via DCHECK).  Costs extra
    device work per node; intended for tests and debugging."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = bool(enabled)


def _append_debug_checks(table: Table, ctx: RunContext) -> None:
    n = jnp.asarray(table.num_rows)
    cap = table.capacity
    ctx.error_flags.append(
        ("debug: num_rows out of [0, capacity]",
         (n < 0) | (n > cap)))
    live = table.row_mask()
    for name, d in table.dicts.items():
        if name not in table.columns:
            continue
        c = table.columns[name]
        codes = c.values
        ok = live if c.valid is None else (live & c.valid)
        bad = ok & ((codes < 0) | (codes >= max(len(d), 1)))
        ctx.error_flags.append(
            (f"debug: dictionary code out of range in {name!r}",
             jnp.any(bad)))


class BindContext:
    """Collects leaf inputs during bind so they become jit arguments."""

    def __init__(self, cancel: Optional[CancellationToken] = None):
        self.leaves: list[Table] = []
        # (leaf index, producer) pairs for host/disk-boundary operators
        # (external sort, hybrid spill aggregation): bind registers a
        # capacity-shaped placeholder and defers the heavy work to
        # ``prepare_leaves`` at execution time — the reference's hybrid
        # cursor likewise makes CreateCursor cheap and drains its child
        # at the first Next() (aggregate_groups.cc:332-431)
        self.lazy: list = []
        self.cancel = cancel

    def check_cancel(self) -> None:
        """Poll point for host/disk-boundary operators whose chunk loops
        run during bind (external sort spill, hybrid aggregation)."""
        if self.cancel is not None:
            self.cancel.check()

    def register_leaf(self, table: Table) -> int:
        self.leaves.append(table)
        return len(self.leaves) - 1

    def register_lazy_leaf(self, placeholder: Table, producer) -> int:
        """Register a host-produced leaf: ``placeholder`` fixes the
        schema/capacity at bind; ``producer(leaves, cancel) -> Table``
        runs at execution time (``prepare_leaves``) and must return a
        table of exactly the placeholder's capacity and column layout."""
        idx = self.register_leaf(placeholder)
        self.lazy.append((idx, producer))
        return idx


def prepare_leaves(leaves, lazy, cancel=None):
    """Resolve lazy (host/disk-boundary) leaves before the device run.
    Producers see the already-resolved prefix, so nested boundaries
    (a spill below a spill) resolve in bind order."""
    if not lazy:
        return list(leaves)
    leaves = list(leaves)
    for idx, producer in lazy:
        leaves[idx] = producer(leaves, cancel)
    return leaves


class Operation:
    """Symbolic operator-DAG node (reference: cursor/base/operation.h:35)."""

    def bind(self, ctx: BindContext) -> BoundOperation:
        raise NotImplementedError

    # -- fluent sugar ---------------------------------------------------------
    def execute(self, check_errors: bool = True, jit: bool = True,
                cancel: Optional[CancellationToken] = None) -> Table:
        return execute(self, check_errors=check_errors, jit=jit,
                       cancel=cancel)


def bind_plan(op: Operation,
              cancel: Optional[CancellationToken] = None
              ) -> tuple[BoundOperation, list[Table]]:
    ctx = BindContext(cancel=cancel)
    bound = op.bind(ctx)
    return bound, ctx.leaves


def compile_plan(op: Operation,
                 cancel: Optional[CancellationToken] = None):
    """Bind + wrap into a jittable fn(leaf_tables) -> (Table, error_flags).

    The returned callable is the whole query as one XLA program; leaf tables
    are traced arguments so the program is reusable across same-shape data.
    """
    bctx = BindContext(cancel=cancel)
    bound = op.bind(bctx)
    leaves = bctx.leaves

    def run(leaf_tables):
        ctx = RunContext(list(leaf_tables), cancel=cancel)
        out = bound.run(ctx)
        if ctx.error_flags:
            flags = jnp.stack([f for _, f in ctx.error_flags])
        else:
            flags = jnp.zeros(0, dtype=jnp.bool_)
        run.deferred = list(ctx.deferred)
        if ctx.deferred:
            # deferred host work (CONCAT assembly): aux arrays become
            # extra program outputs so execute() can read them back
            return out, flags, [d.aux for d in ctx.deferred]
        return out, flags

    run.deferred = []
    run.lazy = bctx.lazy
    return run, bound, leaves


def execute(op: Operation, check_errors: bool = True, jit: bool = True,
            cancel: Optional[CancellationToken] = None) -> Table:
    """Bind, compile, and run a plan; raises EvaluationError on signaling
    failures (the host sync point for device error flags).  Flags whose
    name starts with "warning:" are non-fatal degradation indicators
    (e.g. best-effort quota clamping) surfaced via ``warnings.warn``.
    ``cancel``: a CancellationToken polled at the host boundaries
    (reference: Cursor::Interrupt, cursor.h:160-166)."""
    if cancel is not None:
        cancel.check()
    run, bound, leaves = compile_plan(op, cancel=cancel)
    if cancel is not None:
        cancel.check()
    # host/disk-boundary leaves (spill sort, hybrid aggregation) resolve
    # here — the reference's "work at first Next()" contract; bind stays
    # side-effect-free
    leaves = prepare_leaves(leaves, run.lazy, cancel)
    runner = jax.jit(run) if jit else run
    res = runner(leaves)
    table, flags = res[0], res[1]
    if check_errors and flags.shape[0]:
        flags_host = jax.device_get(flags)
        if flags_host.any():
            # Re-bind to recover flag names (cheap, host-only).
            ctx = RunContext(list(leaves))
            bound.run(ctx)
            names = [n for (n, _) in ctx.error_flags]
            raised = [names[i] for i, f in enumerate(flags_host) if f]
            bad = [n for n in raised if not n.startswith("warning:")]
            for w in raised:
                if w.startswith("warning:"):
                    import warnings

                    warnings.warn(w, RuntimeWarning, stacklevel=2)
            if bad:
                raise EvaluationError(
                    f"evaluation failed: {', '.join(bad)}")
    if len(res) > 2:
        from .host import resolve_deferred

        resolve_deferred(run.deferred, res[2], cancel=cancel)
    return table


def materialize_bound(bound: BoundOperation, leaf_tables,
                      cancel: Optional[CancellationToken] = None,
                      jit: bool = True, cache: Optional[dict] = None) -> Table:
    """Run an ALREADY-BOUND subtree on resolved leaf tables — the
    producer-side replay used by host/disk-boundary operators
    (``register_lazy_leaf``).  The subtree bound exactly once in the
    real BindContext; this executes it with the concrete leaves at
    prepare time, checks its error flags, and resolves deferred host
    work.  ``cache``: optional dict shared across executions of the
    same bound plan — a fresh jax.jit per execute would re-pay the
    subtree's compile every run."""

    if cache is not None and "materialize_bound" in cache:
        runner, sub = cache["materialize_bound"]
    else:
        def sub(lt):
            rctx = RunContext(list(lt), cancel=cancel)
            out = bound.run(rctx)
            if rctx.error_flags:
                flags = jnp.stack([f for _, f in rctx.error_flags])
            else:
                flags = jnp.zeros(0, dtype=jnp.bool_)
            sub.deferred = list(rctx.deferred)
            if rctx.deferred:
                return out, flags, [d.aux for d in rctx.deferred]
            return out, flags

        sub.deferred = []
        runner = jax.jit(sub) if jit else sub
        if cache is not None:
            cache["materialize_bound"] = (runner, sub)
    res = runner(leaf_tables)
    table, flags = res[0], res[1]
    if flags.shape[0]:
        flags_host = jax.device_get(flags)
        if flags_host.any():
            rctx = RunContext(list(leaf_tables), cancel=cancel)
            bound.run(rctx)
            names = [n for (n, _) in rctx.error_flags]
            raised = [names[i] for i, f in enumerate(flags_host) if f]
            bad = [n for n in raised if not n.startswith("warning:")]
            if bad:
                raise EvaluationError(
                    f"evaluation failed: {', '.join(bad)}")
    if len(res) > 2:
        from .host import resolve_deferred

        resolve_deferred(sub.deferred, res[2], cancel=cancel)
    return table


def default_capacity(*caps: int) -> int:
    return max(caps) if caps else 1


def materialize_child(op: Operation, check_errors: bool = True,
                      jit: bool = True) -> Table:
    """Run a subtree to a concrete host-resident Table — the
    materialization boundary used by host/disk-boundary operators
    (external sort spill, hybrid aggregation).  The reference's cursor
    protocol has the same boundaries (HashJoin's build drains its whole
    rhs inside CreateCursor, hash_join.cc:604; the external sort spills
    whole runs, sort.cc:467).  Unlike ``execute(op)`` from inside another
    bind, this binds the subtree exactly ONCE (no throwaway probe
    context), so stateful children (Shared/Spy) see a single bind.
    ``jit=False`` runs the plan eagerly — for many small same-schema
    host batches of varying shape a jit would compile per shape."""
    run, bound, leaves = compile_plan(op)
    leaves = prepare_leaves(leaves, run.lazy, None)
    res = (jax.jit(run) if jit else run)(leaves)
    table, flags = res[0], res[1]
    if check_errors and flags.shape[0]:
        flags_host = jax.device_get(flags)
        if flags_host.any():
            ctx = RunContext(list(leaves))
            bound.run(ctx)
            names = [n for (n, _) in ctx.error_flags]
            raised = [names[i] for i, f in enumerate(flags_host) if f]
            bad = [n for n in raised if not n.startswith("warning:")]
            if bad:
                raise EvaluationError(
                    f"evaluation failed: {', '.join(bad)}")
    if len(res) > 2:
        from .host import resolve_deferred

        resolve_deferred(run.deferred, res[2])
    return table

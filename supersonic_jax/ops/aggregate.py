"""Aggregation: GroupAggregate / ScalarAggregate / AggregateClusters.

Reference: cursor/core/aggregate_groups.cc (hash group-by over a
RowHashSet, scatter-updating an Aggregator block), aggregate_scalar.cc,
aggregate_clusters.cc, column_aggregator.cc (per-column update kernels,
COUNT counts non-null, FIRST/LAST keep encounter order, DISTINCT dedups
per key).

Device redesign (SURVEY.md §2.4): the general group-by is built from
multi-operand ``lax.sort``, ``cumsum``/``cummax`` and elementwise ops,
with no scatter and no ``associative_scan``:

  1. Rows sort ONCE per "pass" with key codes as sort keys and every
     needed column as payload.  MIN/MAX/DISTINCT ride value-ordered
     passes ((key, value) sort, NULL values last; MAX uses the
     descending code) — the group min/max then sits at each run's first
     row, and DISTINCT duplicates are neighbor-comparable.
  2. SUM/COUNT are read off a single *global* cumsum: the group total is
     the difference of the cumsum at consecutive run-end rows.  Floats
     accumulate in f64 so the difference is exact at f32 scale.
  3. ONE compaction per extraction moves run-end (and run-start) rows'
     values into dense per-group arrays; diffs/finalization happen on
     those small arrays.
  4. A final small sort re-ranks groups by first-occurrence row id to
     match the reference's insertion-order output contract.

``AggregateClusters`` detects runs in raw input order (non-adjacent equal
keys stay separate, per the streaming contract) and sorts value passes by
run id, preserving encounter order without a re-rank.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..batch import Column, Table
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType, jnp_dtype, physical_dtype
from .base import BindContext, BoundOperation, Operation, RunContext
from .filter import compact_by_mask
from .scan32 import cumsum_i32
from .keys import descending_code, group_code_columns, monotone_code


class Aggregation(enum.Enum):
    """reference: proto/supersonic.proto:64-72."""

    SUM = "SUM"
    MIN = "MIN"
    MAX = "MAX"
    COUNT = "COUNT"
    CONCAT = "CONCAT"
    FIRST = "FIRST"
    LAST = "LAST"


SUM, MIN, MAX, COUNT = (Aggregation.SUM, Aggregation.MIN, Aggregation.MAX,
                        Aggregation.COUNT)
FIRST, LAST, CONCAT = Aggregation.FIRST, Aggregation.LAST, Aggregation.CONCAT


@dataclass(frozen=True)
class AggSpec:
    """One aggregation element (reference: AggregationSpecification,
    aggregate.h:47-158)."""

    aggregation: Aggregation
    input: Optional[str]       # None only for COUNT(*)
    output: str
    output_type: Optional[DataType] = None
    distinct: bool = False


class AggregationSpecification:
    def __init__(self, specs: Sequence[AggSpec | tuple] = ()):
        self.specs: list[AggSpec] = []
        for s in specs:
            self.add(s if isinstance(s, AggSpec) else AggSpec(*s))

    def add(self, spec: AggSpec) -> "AggregationSpecification":
        self.specs.append(spec)
        return self

    def add_aggregation(self, agg: Aggregation, input_: Optional[str],
                        output: str, **kw) -> "AggregationSpecification":
        return self.add(AggSpec(agg, input_, output, **kw))


@dataclass(frozen=True)
class GroupAggregateOptions:
    """reference: aggregate.h:160-205.  Memory quotas become static output
    capacities under XLA's static-shape model: ``memory_quota`` bytes map
    to an output-row budget at bind (quota // aggregated-row width).

    Strict GroupAggregate with a quota raises ERROR_MEMORY_EXCEEDED-style
    (``EvaluationError``) when the result exceeds the budget
    (aggregate_groups.cc:420-427).  BestEffortGroupAggregate instead
    degrades: it fully aggregates the first ``quota_rows`` distinct keys
    and passes the remaining rows through as singleton partial groups —
    output rows are no longer key-unique, exactly the reference's
    best-effort contract (aggregate.h:233-246) — and emits a warning
    flag.  ``enforce_quota=True`` makes even the best-effort operator
    strict (the reference's hard-quota allocator, memory.h:465)."""

    estimated_result_row_count: Optional[int] = None  # output capacity
    max_unique_keys_in_result: Optional[int] = None   # clamp; overflow rows
    # merge into the last kept group (aggregate_groups.cc:501-510)
    memory_quota: Optional[int] = None  # bytes for the aggregated result
    enforce_quota: bool = False         # hard quota even for best-effort


def _quota_rows(memory_quota: int, out_schema: TupleSchema) -> int:
    """memory_quota bytes -> aggregated-result row budget: quota divided
    by the output row width (physical value bytes + 1 byte per nullable
    validity mask, the byte-bool representation)."""
    width = 0
    for a in out_schema:
        width += np.dtype(physical_dtype(a.type)).itemsize
        if a.nullable:
            width += 1
    return max(1, int(memory_quota) // max(width, 1))


def _resolve_output_attr(spec: AggSpec, schema: TupleSchema) -> Attribute:
    if spec.aggregation == Aggregation.COUNT:
        t = spec.output_type or DataType.UINT64
        return Attribute(spec.output, t, nullable=False)
    if spec.input is None:
        raise SchemaError(f"{spec.aggregation} needs an input column")
    in_attr = schema.lookup(spec.input)
    if spec.aggregation == Aggregation.CONCAT:
        # CONCAT of any input type yields STRING (reference:
        # column_aggregator.cc:496-530 factory, AggregationOperator<CONCAT,
        # InputType, STRING> aggregation_operators.h:235)
        t = spec.output_type or DataType.STRING
        if t != DataType.STRING:
            raise SchemaError("CONCAT output type must be STRING")
        return Attribute(spec.output, t, nullable=True)
    t = spec.output_type or in_attr.type
    return Attribute(spec.output, t, nullable=True)


def _min_identity(dtype):
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf, dtype)
    return jnp.array(jnp.iinfo(dtype).max, dtype)


def _max_identity(dtype):
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(-jnp.inf, dtype)
    return jnp.array(jnp.iinfo(dtype).min, dtype)


def _normalize_spec(specification) -> AggregationSpecification:
    if isinstance(specification, AggregationSpecification):
        return specification
    return AggregationSpecification(specification)


_LIMB_BITS = 22
_LIMB_COUNT = 3  # 3 x 22 = 66 bits cover the 64-bit two's complement


_HIER_TILE = 512  # within-tile span; 22-bit limbs + log2(512) fit i32


def _hier_cumsum(x: jnp.ndarray, win_dtype) -> tuple[jnp.ndarray,
                                                     jnp.ndarray]:
    """Two-level cumsum: ``(win, carry)`` such that the f64-precision
    inclusive cumsum at row i is ``carry[i // _HIER_TILE] + win[i]``.

    ``win`` is the within-tile inclusive cumsum in a 32-bit dtype and
    ``carry`` an exclusive cumsum of the tile totals.  Exact for i32 limb inputs
    (values < 2^22 x 512 rows < 2^31); for f32 inputs the error is
    pairwise-summation class (per-tile rounding, independent of global
    magnitude) — tighter than the sequential f32 adds of the
    reference's accumulator loop.

    The carries ride an explicit log-shift Hillis-Steele scan in f64 —
    pure elementwise adds, no 64-bit reduce-window, exact for integer
    values below 2^53:
    integer tile totals directly (|total| <= cap * 2^22 < 2^53); f32
    totals through a fixed-point quantization q = round(ts * 2^(52 - e
    - log2(ntiles))) against the running maximum's exponent e —
    quantization error <= max|tile total| * ntiles * 2^-52, far inside
    the f32 win tiles' own pairwise rounding.  Non-finite tile totals
    clamp (groups touching them produce garbage, like the flat-scan
    path this replaces; the DOUBLE SUM path repairs inf/NaN per group
    separately).
    """
    n = x.shape[0]
    T = _HIER_TILE
    npad = -(-n // T) * T
    xp = (jnp.concatenate([x, jnp.zeros(npad - n, x.dtype)])
          if npad != n else x)
    win2 = jnp.cumsum(xp.astype(win_dtype).reshape(-1, T), axis=1)
    ts = win2[:, -1]
    ntiles = ts.shape[0]
    if jnp.issubdtype(jnp.dtype(win_dtype), jnp.integer):
        cs = _shift_scan_f64(ts.astype(jnp.float64))
    else:
        ts64 = ts.astype(jnp.float64)
        finite = jnp.isfinite(ts64)
        amax = jnp.max(jnp.where(finite, jnp.abs(ts), 0.0))
        e = jnp.ceil(jnp.log2(jnp.maximum(
            amax.astype(jnp.float64), 1e-30)))
        nb = math.ceil(math.log2(max(ntiles, 2)))
        scale = jnp.exp2(52.0 - e - nb)
        ts_q = jnp.where(finite, ts64, 2.0**53)  # NaN/inf -> clamp
        q = jnp.round(jnp.clip(ts_q * scale, -(2.0**52), 2.0**52))
        cs = _shift_scan_f64(q) / scale
    carry = jnp.concatenate([jnp.zeros(1, jnp.float64), cs[:-1]])
    return win2.reshape(-1)[:n], carry


def _shift_scan_f64(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive f64 prefix sum via log-shift adds (see _hier_cumsum).
    Exact while all prefix values are integers below 2^53."""
    n = x.shape[0]
    d = 1
    while d < n:
        x = x + jnp.concatenate([jnp.zeros(d, x.dtype), x[:-d]])
        d *= 2
    return x


def _carry_at(carry: jnp.ndarray, tid: jnp.ndarray) -> jnp.ndarray:
    """``carry[tid]`` (f64 LUT, one entry per tile)."""
    return jnp.take(carry, jnp.clip(tid, 0, carry.shape[0] - 1))


def _sum_limbs(vals: jnp.ndarray, weight: jnp.ndarray) -> list[tuple]:
    """Exact wrapping integer SUM, part 1: per-limb two-level cumsums.

    The reference accumulates SUM in the output type with C++ wrap
    (aggregation_operators.h:58+).  One f64 cumsum is only exact to
    2^53; instead each value splits into three 22-bit limbs
    whose limb-cumsums (hierarchical i32-within-tile + f64 tile carries,
    see ``_hier_cumsum``) stay exact up to 2^31 rows.  The wrapped
    64-bit total is rebuilt per group by ``_sum_limbs_combine`` with
    integer arithmetic on the small extracted arrays.
    Returns one ``(win, carry)`` pair per limb.
    """
    unsigned = vals.dtype == jnp.dtype(jnp.uint64)
    v64 = vals.astype(jnp.uint64 if unsigned else jnp.int64)
    # The 32-bit words come from a bitcast to u32 pairs, after which
    # everything is exact f64 arithmetic (words < 2^32 << 2^53).
    words = jax.lax.bitcast_convert_type(v64, jnp.uint32)
    lo_u = words[..., 0].astype(jnp.float64)   # low 32 bits
    hi_u = words[..., 1].astype(jnp.float64)   # high 32 bits
    limbs = [
        lo_u % float(1 << 22),                                # bits 0..21
        jnp.floor(lo_u / (1 << 22))
        + (hi_u % (1 << 12)) * float(1 << 10),                # bits 22..43
        jnp.floor(hi_u / (1 << 12)),                          # bits 44..63
    ]
    return [_hier_cumsum(
        jnp.where(weight, limb, 0.0).astype(jnp.int32), jnp.int32)
        for limb in limbs]


def _sum_limbs_combine(limb_diffs: list[jnp.ndarray], odt) -> jnp.ndarray:
    """Exact wrapping integer SUM, part 2: recombine per-group limb sums
    (exact f64 integers) mod 2^64, then truncate to the output width —
    modular arithmetic makes this equal to the reference's sequential
    wrap in the output type."""
    unsigned = jnp.dtype(odt) == jnp.dtype(jnp.uint64)
    idt = jnp.uint64 if unsigned else jnp.int64
    # optimization_barrier keeps the 64-bit recombination out of the
    # surrounding extraction fusion
    limb_diffs = jax.lax.optimization_barrier(tuple(limb_diffs))
    total = None
    for j, d in enumerate(limb_diffs):
        term = d.astype(idt) * idt(1 << (j * _LIMB_BITS))
        total = term if total is None else total + term
    return total.astype(odt)


def _sum_limbs_fixedpoint(vals: jnp.ndarray, weight: jnp.ndarray):
    """f64-accumulated SUM (DOUBLE inputs, float/64-bit outputs) without
    any per-row f64 scan (an f64 extraction operand would force the
    whole group extraction into the payload-sort path).

    Values quantize against the running maximum's exponent e into
    fixed-point units of 2^(e-B), B = 86 - ceil(log2 cap), and split
    into four 22-bit limbs (top limb signed, <= B-66 <= 20 bits, so
    every limb's 512-row tile sum stays inside i32); each limb rides
    the hierarchical i32/i64 cumsum machinery exactly.  Precision: the
    quantum is max|v| * 2^(ceil(log2 cap) - 86) <= max|v| * 2^-53 for
    any capacity below 2^33, so per-group error is sequential-f64
    class (<= group_rows * max|v| * 2^-53) — the same class as the
    reference's double accumulator loop (aggregation_operators.h:58).

    inf/NaN inputs cannot ride the quantization; they are excluded
    from the limbs and repaired per group from two i32 indicator scans:
    nf = count of non-finite addends, sg = (+inf count) - (-inf count).
    A group is NaN iff nf > |sg| (any NaN, or mixed-sign infinities),
    else +/-inf by sg's sign — exactly IEEE addition semantics.
    Returns ([(win, carry)] per limb, e, B, nf_cumsum, sgn_cumsum).
    """
    v = vals.astype(jnp.float64)
    finite = jnp.isfinite(v)
    use = weight & finite
    av = jnp.where(use, jnp.abs(v), 0.0)
    amax = jnp.max(av)
    e = jnp.ceil(jnp.log2(jnp.maximum(amax, 1e-300)))
    cap = v.shape[0]
    B = 86 - max(math.ceil(math.log2(max(cap, 2))), 1)
    # two-step power-of-two scaling keeps both factors in f64 range
    sh = jnp.float64(B) - e
    s1 = jnp.exp2(jnp.floor(sh / 2))
    s2 = jnp.exp2(sh - jnp.floor(sh / 2))
    w = jnp.round(jnp.where(use, v, 0.0) * s1 * s2)
    P = float(1 << 22)
    t1 = jnp.floor(w / P)
    l0 = w - t1 * P
    t2 = jnp.floor(t1 / P)
    l1 = t1 - t2 * P
    t3 = jnp.floor(t2 / P)
    l2 = t2 - t3 * P
    l3 = t3  # signed top limb, |l3| <= 2^(B-66) <= 2^20
    limb_pairs = [_hier_cumsum(l.astype(jnp.int32), jnp.int32)
                  for l in (l0, l1, l2, l3)]
    nonfin = weight & ~finite
    pinf = nonfin & (v > 0)  # NaN compares false on purpose
    ninf = nonfin & (v < 0)
    nf_cs = cumsum_i32(nonfin.astype(jnp.int32))
    sgn_cs = cumsum_i32(pinf.astype(jnp.int32) - ninf.astype(jnp.int32))
    return limb_pairs, e, B, nf_cs, sgn_cs


def _diff(x: jnp.ndarray) -> jnp.ndarray:
    """Per-group value from a global cumsum extracted at run ends:
    x[g] - x[g-1] (x[0] as is)."""
    prev = jnp.concatenate([jnp.zeros(1, x.dtype), x[:-1]])
    return x - prev


@dataclasses.dataclass
class DeferredConcat:
    """Host-materialization record for one CONCAT aggregate: static
    metadata + traced ``aux`` arrays (per input row in group-sorted
    order: group id, value, include-mask) that become extra program
    outputs.  ``execute()`` assembles the per-group strings from the
    realized aux and resolves ``dict_obj`` in place (reference:
    AggregationOperator<CONCAT> per-group byte assembly,
    aggregation_operators.h:235-283; "," separator, NULLs skipped,
    all-NULL group -> NULL)."""

    name: str
    dict_obj: "object"          # DeferredDictionary created at bind
    separator: str
    distinct: bool
    input_type: DataType
    input_dict: "object"        # input column Dictionary or None
    aux: dict                   # traced: gid, vals, valid, num_groups


def _pass_key(spec: AggSpec):
    """Which sorted pass a spec runs in: None = row-stable base pass;
    (col, 'asc'/'desc') = value-ordered pass."""
    if spec.aggregation == Aggregation.MIN:
        return (spec.input, "asc")
    if spec.aggregation == Aggregation.MAX:
        return (spec.input, "desc")
    if spec.distinct and spec.aggregation in (Aggregation.SUM,
                                              Aggregation.COUNT):
        return (spec.input, "asc")
    return None


_DENSE_DOMAIN_MAX = 2048  # kernels/segment_reduce.MAX_SEGMENTS

# approx_max_k ranks f32 scores: (cap - pos) is exactly representable only
# below 2^24; at or above, group extraction falls back to the general
# compaction (exact at any size).  tests/test_capacity_edges.py pins both
# sides.
_APPROX_TOPK_MAX_CAP = 1 << 24


def _dense_domain(cb, names, key_attrs, specs, schema_in, options):
    """(dims, K, stats_guarded) when the group keys have a statically
    bounded composite integer domain small enough for the dense
    segmented-reduce aggregation: per key ENUM (value map), STRING/BINARY (dictionary
    size), or integer columns with planner statistics; the composite slot
    is sum_i (v_i - kmin_i) * stride_i over prod(K_i) <= the kernel's
    segment budget.  None -> use the sort-based general path.
    ``dims`` is a list of (name, attr, kmin, K_i)."""
    if options.max_unique_keys_in_result:
        return None
    if any(s.distinct for s in specs):
        return None
    guarded = False
    dims = []
    K = 1
    for name, key_attr in zip(names, key_attrs):
        if key_attr.nullable:
            return None
        if key_attr.type == DataType.ENUM:
            dom = (0, max(len(key_attr.enum.names) - 1, 0))
        elif key_attr.type in (DataType.STRING, DataType.BINARY):
            d = cb.dicts.get(name)
            if d is None:
                return None
            dom = (0, max(len(d) - 1, 0))
        elif key_attr.type in (DataType.INT32, DataType.INT64,
                               DataType.UINT32, DataType.DATE,
                               DataType.DATETIME):
            dom = cb.stats.get(name)
            guarded = True  # leaf-derived bounds: re-runs need a check
            if dom is None:
                return None
        else:
            return None
        kmin, kmax = dom
        K_i = kmax - kmin + 1
        if K_i <= 0:
            return None
        dims.append((name, key_attr, kmin, K_i))
        K *= K_i
        if K > _DENSE_DOMAIN_MAX:
            return None
    i32_ok = (DataType.FLOAT, DataType.INT32, DataType.UINT32,
              DataType.DATE, DataType.ENUM, DataType.STRING,
              DataType.BINARY, DataType.BOOL)
    for s in specs:
        if s.aggregation == Aggregation.COUNT:
            continue
        if s.aggregation in (Aggregation.FIRST, Aggregation.LAST):
            continue  # any fixed-width type: one tiny gather at the end
        if s.aggregation == Aggregation.CONCAT:
            return None
        in_t = schema_in.lookup(s.input).type
        if in_t not in i32_ok:
            return None  # 64-bit values: kernel is f32/i32 only
        if s.aggregation == Aggregation.SUM:
            out_t = _resolve_output_attr(s, schema_in).type
            if jnp.dtype(jnp_dtype(out_t)).itemsize == 8:
                # SUM aggregates in the output type (reference
                # aggregation_operators.h): a 64-bit output needs the
                # exact limb path of the sort-based aggregate, not the
                # kernel's i32/f32 accumulators
                return None
    return dims, K, guarded


def _dense_grouped_aggregate(t: Table, dims, specs, schema_in,
                             out_dicts, out_schema, out_cap, K,
                             guarded, rctx: RunContext, keep=None,
                             ordered=True):
    """Dense-domain group-by: one fused segmented-reduce pass
    (kernels/segment_reduce.py) — no sort, no compaction; O(rows)
    streaming + O(K) finalization.  This is the shape of the reference's
    own headline benchmark (1M rows GROUP BY 50 string keys,
    benchmark/examples/operation_example.cc:24-40)."""
    from ..kernels.segment_reduce import segment_reduce_multi

    cap = t.capacity
    pos = jnp.arange(cap, dtype=jnp.int32)
    if keep is None:
        keep = t.row_mask()
    # composite slot over all key dimensions (per-dim clip keeps the
    # slot in [0, K) even for out-of-range values).  Per-dim offsets are
    # i32 (K <= 2048); 32-bit key columns stay in i32 end to end and
    # only 64-bit keys subtract in i64.
    gid64 = None
    in_domain = None
    for name, _attr, kmin, K_i in dims:
        col = t.columns[name].values
        if col.dtype == jnp.dtype(jnp.int32):
            v = col - jnp.int32(kmin)
            ok = (v >= 0) & (v < K_i)
            vc = jnp.clip(v, 0, K_i - 1)
        else:
            v = col.astype(jnp.int64) - kmin
            ok = (v >= 0) & (v < K_i)
            vc = jnp.clip(v, 0, K_i - 1).astype(jnp.int32)
        gid64 = vc if gid64 is None else gid64 * jnp.int32(K_i) + vc
        in_domain = ok if in_domain is None else (in_domain & ok)
    if guarded:
        rctx.error_flags.append((
            "aggregate key exceeds planned dense domain",
            jnp.any(keep & ~in_domain)))
    live = keep & in_domain
    ids = jnp.where(live, gid64, -1).astype(jnp.int32)

    # All segmented reductions go through ONE fused pass (requests are
    # deduplicated by key), so the rows are read once for every
    # aggregate.
    _reqs: list = []
    _memo: dict = {}

    def _ask(key, arr, mode):
        if key not in _memo:
            _memo[key] = len(_reqs)
            _reqs.append((arr, mode))
        return _memo[key]

    def _valid32_of(s):
        c = t.columns[s.input]
        if c.valid is None:
            # non-nullable input: its valid-count IS the live row count
            return live, _ask(("count_all",), live.astype(jnp.int32),
                              "count")
        valid = live & c.valid
        return valid, _ask(("valid", s.input),
                           valid.astype(jnp.int32), "count")

    _ask(("count_all",), live.astype(jnp.int32), "count")
    if ordered:
        # first-appearance rank reproduces the reference's insertion
        # order (RowHashSet appends unique keys in arrival order).  An
        # order-insensitive consumer (Sort) drops this request.
        _ask(("firstpos",), jnp.where(live, pos, jnp.int32(2**31 - 1)),
             "min")
    for s in specs:
        agg = s.aggregation
        if agg == Aggregation.COUNT and s.input is None:
            continue
        c = t.columns[s.input]
        if agg == Aggregation.COUNT:
            _valid32_of(s)
        elif agg == Aggregation.SUM:
            valid, _ = _valid32_of(s)
            acc_dt = (jnp.float32 if jnp.issubdtype(c.values.dtype,
                                                    jnp.floating)
                      else jnp.int32)
            v = jnp.where(valid, c.values,
                          jnp.zeros_like(c.values)).astype(acc_dt)
            _ask(("sum", s.input), v, "sum")
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            mode = "min" if agg == Aggregation.MIN else "max"
            valid, _ = _valid32_of(s)
            in_t = schema_in.lookup(s.input).type
            code = monotone_code(c.values, in_t)
            acc_dt = (jnp.float32 if jnp.issubdtype(code.dtype,
                                                    jnp.floating)
                      else jnp.int32)
            init = (jnp.inf if mode == "min" else -jnp.inf) \
                if acc_dt == jnp.float32 else \
                (2**31 - 1 if mode == "min" else -(2**31))
            v = jnp.where(valid, code.astype(acc_dt), acc_dt(init))
            _ask((mode, s.input), v, mode)
        elif agg == Aggregation.FIRST:
            # first live position: same request as the insertion-order
            # rank
            _ask(("firstpos",),
                 jnp.where(live, pos, jnp.int32(2**31 - 1)), "min")
        elif agg == Aggregation.LAST:
            _ask(("pos", "max"),
                 jnp.where(live, pos, jnp.int32(-(2**31))), "max")
    _results = segment_reduce_multi(_reqs, ids, K)

    def _got(key):
        return _results[_memo[key]]

    count_all = _got(("count_all",))
    first_pos = (_got(("firstpos",)) if ordered
                 else jnp.arange(K, dtype=jnp.int32))
    present = count_all > 0
    num_groups = jnp.sum(present.astype(jnp.int32), dtype=jnp.int32)
    rctx.error_flags.append(
        ("aggregate result overflow", num_groups > out_cap))

    cols_k: dict[str, Column] = {}
    # decode slot j back into each key dimension's value (mixed-radix)
    rem = jnp.arange(K, dtype=jnp.int64)
    for name, attr, kmin, K_i in reversed(dims):
        cols_k[name] = Column(
            ((rem % K_i) + kmin).astype(jnp_dtype(attr.type)), None)
        rem = rem // K_i

    for s in specs:
        a = _resolve_output_attr(s, schema_in)
        odt = jnp_dtype(a.type)
        agg = s.aggregation
        if agg == Aggregation.COUNT and s.input is None:
            cols_k[s.output] = Column(count_all.astype(odt), None)
            continue
        c = t.columns[s.input]
        vkey = ("count_all",) if c.valid is None else ("valid", s.input)
        in_t = schema_in.lookup(s.input).type
        if agg == Aggregation.COUNT:
            cols_k[s.output] = Column(_got(vkey).astype(odt), None)
        elif agg == Aggregation.SUM:
            # accumulate in the input's width like the reference
            # (aggregation_operators.h: SUM aggregates in the output type;
            # f32 rounding / i32 wrap match its sequential semantics up to
            # FP reduction order — documented divergence)
            sv = _got(("sum", s.input))
            wc = _got(vkey)
            cols_k[s.output] = Column(sv.astype(odt), wc > 0)
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            mode = "min" if agg == Aggregation.MIN else "max"
            mv = _got((mode, s.input))
            wc = _got(vkey)
            cols_k[s.output] = Column(mv.astype(odt), wc > 0)
        elif agg in (Aggregation.FIRST, Aggregation.LAST):
            p = _got(("firstpos",) if agg == Aggregation.FIRST
                     else ("pos", "max"))
            safe = jnp.clip(p, 0, cap - 1)
            vals = jnp.take(c.values, safe)
            fvalid = present & (jnp.take(c.valid, safe)
                                if c.valid is not None else present)
            cols_k[s.output] = Column(vals.astype(odt), fvalid)
        else:
            raise SchemaError(f"unsupported dense aggregation {agg}")

    # re-rank to insertion order: sort the K slots by first occurrence,
    # absent slots last; slice/pad to out_cap
    order_ops = [jnp.where(present, 0, 1).astype(jnp.int32), first_pos]
    payload: list[jnp.ndarray] = []
    layout = []
    for a in out_schema:
        c = cols_k[a.name]
        payload.append(c.values)
        if c.valid is not None:
            payload.append(c.valid)
            layout.append((a.name, True))
        else:
            layout.append((a.name, False))
    res = jax.lax.sort(order_ops + payload, num_keys=2, is_stable=True)
    pi = 2
    cols: dict[str, Column] = {}
    for n, has_valid in layout:
        vals = res[pi]
        pi += 1
        valid = None
        if has_valid:
            valid = res[pi]
            pi += 1
        cols[n] = Column(vals, valid)

    def fit(arr):
        if arr.shape[0] == out_cap:
            return arr
        if arr.shape[0] > out_cap:
            return arr[:out_cap]
        padv = jnp.zeros(out_cap - arr.shape[0], dtype=arr.dtype)
        return jnp.concatenate([arr, padv])

    cols = {n: Column(fit(c.values),
                      None if c.valid is None else fit(c.valid))
            for n, c in cols.items()}
    n_out = jnp.minimum(num_groups, out_cap)
    return Table(out_schema, cols, n_out, out_dicts, cap_hint=out_cap)


def _grouped_aggregate(t: Table, names, specs, schema_in, out_dicts,
                       out_schema, out_cap, max_keys, rctx: RunContext,
                       pre_sorted: bool, rerank: bool, keep=None,
                       live_count=None, soft_key_limit=None, stats=None):
    cap = t.capacity
    # i32 positions end to end (x64 mode would make a bare arange i64)
    pos = jnp.arange(cap, dtype=jnp.int32)
    if keep is None:
        keep = t.row_mask()
    if live_count is None:
        live_count = jnp.asarray(t.num_rows)
    live_count = jnp.asarray(live_count, jnp.int32)
    key_attrs = [schema_in.lookup(n) for n in names]
    pairs = group_code_columns(t, list(names))
    # flatten (null_rank?, code) pairs into sort operands; remember where
    # each key's operands landed so key values can be read back from them
    codes: list[jnp.ndarray] = []
    key_slots: list[tuple[Optional[int], int]] = []
    for nr, c in pairs:
        if nr is not None:
            key_slots.append((len(codes), len(codes) + 1))
            codes.extend([nr, c])
        else:
            key_slots.append((None, len(codes)))
            codes.append(c)
    pad = (~keep).astype(jnp.int32)

    # pad packing (mirrors ops/sort.py::sort_table): fold the pad
    # operand into the first key's null-rank, or into a bounds-shifted
    # first int code — one sort operand fewer in every pass.
    pad_packed = False
    code_shift = None  # added back to codes[key_slots[0][1]] on readback
    if not pre_sorted and names:
        nr0_i, c0_i = key_slots[0]
        attr0 = key_attrs[0]
        if nr0_i is not None:
            codes[nr0_i] = pad * 2 + codes[nr0_i]
            pad_packed = True
        elif attr0.type not in (DataType.FLOAT, DataType.DOUBLE,
                                DataType.UINT64):
            from .sort import _code_bounds
            b = _code_bounds(t, names[0], attr0, stats)
            if b is not None and (not b[2] or rctx is not None):
                lo_v, hi_v, needs_guard = b
                code0 = codes[c0_i]
                cdt = code0.dtype
                span = hi_v - lo_v + 1
                is32 = jnp.dtype(cdt) == jnp.dtype(jnp.int32)
                if span > 0 and ((not is32 and span < (1 << 62))
                                 or (is32 and span <= (1 << 30))):
                    if needs_guard:
                        viol = keep & ((code0 < jnp.asarray(lo_v, cdt))
                                       | (code0 > jnp.asarray(hi_v, cdt)))
                        rctx.error_flags.append(
                            ("group-by key exceeds planner bounds "
                             f"({names[0]!r}; stale bind-time stats)",
                             jnp.any(viol)))
                    codes[c0_i] = ((code0 - jnp.asarray(lo_v, cdt))
                                   + pad.astype(cdt)
                                   * jnp.asarray(span, cdt))
                    code_shift = lo_v
                    pad_packed = True

    if pre_sorted:
        # run identity comes from RAW adjacency (streaming contract)
        prev_same = jnp.ones(cap, dtype=jnp.bool_)
        for c in codes:
            prev_same = prev_same & (c == jnp.roll(c, 1))
        raw_boundary = keep & (~prev_same | (pos == 0))
        run_id = cumsum_i32(raw_boundary) - 1
        sort_keys_base = None  # base pass unsorted
    else:
        sort_keys_base = codes if pad_packed else [pad] + codes

    passes: dict = {}
    for s in specs:
        passes.setdefault(_pass_key(s), []).append(s)
    if None not in passes:
        passes[None] = []  # base pass always runs (keys + first_row)

    # Keys whose monotone code is value-preserving need no payload slot in
    # the base sort: the sorted key values ARE the sorted code operands
    # (and validity is the null-rank operand).  FLOAT/DOUBLE (-0.0
    # normalization) and UINT64 (signed-range shift) are not recoverable.
    key_from_code = {
        n: a.type not in (DataType.FLOAT, DataType.DOUBLE, DataType.UINT64)
        for n, a in zip(names, key_attrs)} if not pre_sorted else \
        {n: False for n in names}

    if soft_key_limit is not None:
        assert not pre_sorted and max_keys is None
    ext_cap = (cap if (max_keys is not None or soft_key_limit is not None)
               else out_cap)
    merged_cols: dict[str, Column] = {}
    first_row_col = None
    num_groups = None

    for pkey in sorted(passes.keys(), key=lambda k: (k is not None, str(k))):
        pass_specs = passes[pkey]
        is_base = pkey is None
        # ---- build sort operands + payloads for this pass ----
        # the pos payload exists only for the base pass's first-occurrence
        # row id (insertion-order re-rank / max_keys clamp); value passes
        # and unordered consumers never read it — one fewer sort operand
        need_rowid = is_base and (rerank or max_keys is not None)
        payload: list[jnp.ndarray] = (
            [pos.astype(jnp.int32)] if need_rowid else [])
        layout: list[tuple[str, bool]] = []
        needed = list(dict.fromkeys(
            ([n for n in names if not key_from_code[n]] if is_base else [])
            + [s.input for s in pass_specs if s.input is not None]))
        for n in needed:
            c = t.columns[n]
            payload.append(c.values)
            if c.valid is not None:
                payload.append(c.valid)
                layout.append((n, True))
            else:
                layout.append((n, False))

        if pre_sorted and is_base:
            s_rowid = pos.astype(jnp.int32)
            sorted_cols = {n: (t.columns[n].values, t.columns[n].valid)
                           for n in needed}
            boundary = raw_boundary
            live_s = keep
            # is_end: next row starts a new run or is dead
            nxt_b = jnp.roll(raw_boundary, -1).at[-1].set(True)
            nxt_dead = ~jnp.roll(keep, -1).at[-1].set(False)
            is_end = keep & (nxt_b | nxt_dead)
        else:
            if is_base:
                operands = list(sort_keys_base)
            else:
                col_name, direction = pkey
                cattr = schema_in.lookup(col_name)
                ccol = t.columns[col_name]
                vrank = jnp.where(ccol.valid_or_true(), 0, 1).astype(
                    jnp.int32)  # NULL values last within the run
                vcode = monotone_code(ccol.values, cattr.type)
                if direction == "desc":
                    vcode = descending_code(vcode)
                base_keys = (sort_keys_base if not pre_sorted
                             else [pad, run_id])
                operands = list(base_keys) + [vrank, vcode]
            res = jax.lax.sort(operands + payload,
                               num_keys=len(operands), is_stable=is_base)
            n_ops = len(operands)
            kb = 0 if (pad_packed and not pre_sorted) else 1
            if pre_sorted and not is_base:
                s_group = [res[1]]  # sorted run_id
            else:
                s_group = list(res[kb:kb + len(codes)])
            s_rowid = res[n_ops] if need_rowid else None
            pi = n_ops + (1 if need_rowid else 0)
            sorted_cols = {}
            for n, has_valid in layout:
                vals = res[pi]
                pi += 1
                valid = None
                if has_valid:
                    valid = res[pi]
                    pi += 1
                sorted_cols[n] = (vals, valid)
            prev_same = jnp.ones(cap, dtype=jnp.bool_)
            for c in s_group:
                prev_same = prev_same & (c == jnp.roll(c, 1))
            live_s = pos < live_count
            boundary = live_s & (~prev_same | (pos == 0))
            if soft_key_limit is not None:
                # best-effort quota degradation (aggregate.h:233-246):
                # the first soft_key_limit distinct keys aggregate fully;
                # every later row becomes its own singleton partial group
                # (a correct partial aggregate — each lane still covers
                # every input row exactly once per key)
                if is_base:
                    orig_groups = jnp.sum(boundary.astype(jnp.int32), dtype=jnp.int32)
                    rctx.error_flags.append(
                        ("warning: best-effort group-by exceeded "
                         "memory_quota; result is partially aggregated",
                         orig_groups > soft_key_limit))
                rank = cumsum_i32(boundary) - 1
                boundary = live_s & (boundary | (rank >= soft_key_limit))
            is_end = live_s & (jnp.roll(boundary, -1)
                               | (pos == live_count - 1))

        if num_groups is None:
            num_groups = jnp.sum(boundary.astype(jnp.int32), dtype=jnp.int32)
            if max_keys is None and soft_key_limit is None:
                rctx.error_flags.append(
                    ("aggregate result overflow", num_groups > out_cap))

        # ---- per-row arrays to extract ----
        end_cols: dict[str, Column] = {}
        start_cols: dict[str, Column] = {}
        finalize = []  # (fn(end_tab_cols, start_tab_cols) -> (name, Column))
        used_tid = False  # any hierarchical-cumsum spec needs __tid

        if is_base:
            for i, (n, a) in enumerate(zip(names, key_attrs)):
                if key_from_code[n]:
                    # sorted code operand IS the key value stream
                    nr_i, c_i = key_slots[i]
                    kvals = s_group[c_i]
                    if i == 0 and code_shift:
                        # un-shift the pad-packed first code (dead rows
                        # hold out-of-domain values; clamped by n_out)
                        kvals = kvals + jnp.asarray(code_shift,
                                                    kvals.dtype)
                    vals = kvals.astype(jnp_dtype(a.type))
                    # packed null-rank is pad*2+nr: live rows keep 0/1
                    valid = (s_group[nr_i] == 1) if nr_i is not None else None
                else:
                    vals, valid = sorted_cols[n]
                start_cols[f"k_{n}"] = Column(vals, None)
                if a.nullable:
                    start_cols[f"kv_{n}"] = Column(
                        (valid if valid is not None
                         else jnp.ones(cap, jnp.bool_)), None)
            if need_rowid:
                start_cols["__first"] = Column(s_rowid, None)

        for s in pass_specs:
            a = _resolve_output_attr(s, schema_in)
            odt = jnp_dtype(a.type)
            agg = s.aggregation
            oname = s.output
            if agg == Aggregation.COUNT and s.input is None:
                cs = cumsum_i32(live_s)
                end_cols[f"c_{oname}"] = Column(cs, None)
                finalize.append((oname, a, lambda e, st, o=oname,
                                 odt=odt: Column(
                                     _diff(e[f"c_{o}"].values).astype(odt),
                                     None)))
                continue
            vals, valid = sorted_cols[s.input]
            valid = ((jnp.ones(cap, jnp.bool_) if valid is None else valid)
                     & live_s)
            weight = valid
            if agg == Aggregation.CONCAT:
                # CONCAT rides the stable base pass (within-group rows in
                # input order = the reference's append order).  Device
                # work: per-group non-null counts (output validity) + the
                # aux arrays for the host byte assembly; the output
                # column is the group's run id — a code into a deferred
                # dictionary resolved by execute() (ops/host.py).
                if max_keys is not None:
                    raise SchemaError(
                        "CONCAT with max_unique_keys_in_result is not "
                        "supported (overflow-group append order is "
                        "undefined across the clamp)")
                wcs = cumsum_i32(weight)
                end_cols[f"w_{oname}"] = Column(wcs, None)
                gid = cumsum_i32(boundary) - 1
                rctx.deferred.append(DeferredConcat(
                    name=oname, dict_obj=out_dicts[oname], separator=",",
                    distinct=bool(s.distinct),
                    input_type=schema_in.lookup(s.input).type,
                    input_dict=t.dicts.get(s.input),
                    aux={"gid": gid, "vals": vals, "valid": weight,
                         "num_groups": num_groups}))

                def fin_concat(e, st, o=oname):
                    nv = _diff(e[f"w_{o}"].values)
                    return Column(jnp.arange(ext_cap, dtype=jnp.int32),
                                  nv > 0)

                finalize.append((oname, a, fin_concat))
                continue
            if s.distinct:
                vcode2 = monotone_code(vals, schema_in.lookup(s.input).type)
                same = ((~boundary) & (vcode2 == jnp.roll(vcode2, 1))
                        & (valid == jnp.roll(valid, 1)) & (pos > 0))
                weight = weight & ~same
            if agg in (Aggregation.SUM, Aggregation.COUNT):
                wcs = cumsum_i32(weight)
                end_cols[f"w_{oname}"] = Column(wcs, None)
                if agg == Aggregation.SUM:
                    if (jnp.issubdtype(vals.dtype, jnp.integer)
                            and jnp.issubdtype(jnp.dtype(odt), jnp.integer)):
                        # exact wrapping integer SUM via limb cumsums
                        limb_pairs = _sum_limbs(vals, weight)
                        for j, (win, _) in enumerate(limb_pairs):
                            end_cols[f"s{j}_{oname}"] = Column(win, None)
                        carries = [c for _, c in limb_pairs]
                        used_tid = True

                        def fin_sum_int(e, st, o=oname, odt=odt,
                                        carries=carries):
                            nv = _diff(e[f"w_{o}"].values)
                            tid_e = e["__tid"].values
                            sv = _sum_limbs_combine(
                                [_diff(_carry_at(c, tid_e)
                                       + e[f"s{j}_{o}"].values
                                       .astype(jnp.float64))
                                 for j, c in enumerate(carries)], odt)
                            return Column(sv, nv > 0)

                        finalize.append((oname, a, fin_sum_int))
                    elif vals.dtype == jnp.dtype(jnp.float32):
                        # f32 SUM: hierarchical cumsum (f64 precision
                        # without a per-row f64 scan)
                        win, carry = _hier_cumsum(
                            jnp.where(weight, vals,
                                      jnp.zeros_like(vals)), jnp.float32)
                        end_cols[f"s_{oname}"] = Column(win, None)
                        used_tid = True

                        def fin_sum_h(e, st, o=oname, odt=odt,
                                      carry=carry):
                            nv = _diff(e[f"w_{o}"].values)
                            cse = (_carry_at(carry, e["__tid"].values)
                                   + e[f"s_{o}"].values
                                   .astype(jnp.float64))
                            sv = _diff(cse).astype(odt)
                            return Column(sv, nv > 0)

                        finalize.append((oname, a, fin_sum_h))
                    else:
                        # f64-accumulated SUM (DOUBLE input / float
                        # output of a 64-bit input): fixed-point limb
                        # cumsums — see _sum_limbs_fixedpoint
                        limb_pairs, e_exp, fp_b, nf_cs, sgn_cs = \
                            _sum_limbs_fixedpoint(vals, weight)
                        for j, (win, _) in enumerate(limb_pairs):
                            end_cols[f"s{j}_{oname}"] = Column(win, None)
                        end_cols[f"nf_{oname}"] = Column(nf_cs, None)
                        end_cols[f"sg_{oname}"] = Column(sgn_cs, None)
                        carries = [c for _, c in limb_pairs]
                        used_tid = True

                        def fin_sum_fp(e, st, o=oname, odt=odt,
                                       carries=carries, e_exp=e_exp,
                                       fp_b=fp_b):
                            nv = _diff(e[f"w_{o}"].values)
                            tid_e = e["__tid"].values
                            limb_d = [
                                _diff(_carry_at(c, tid_e)
                                      + e[f"s{j}_{o}"].values
                                      .astype(jnp.float64))
                                for j, c in enumerate(carries)]
                            total = limb_d[0]
                            for j in range(1, len(limb_d)):
                                total = total + limb_d[j] * float(
                                    1 << (22 * j))
                            # de-scale by 2^(e-B), two-step for range
                            sh = e_exp - jnp.float64(fp_b)
                            d1 = jnp.exp2(jnp.floor(sh / 2))
                            d2 = jnp.exp2(sh - jnp.floor(sh / 2))
                            sv = (total * d1) * d2
                            nf = _diff(e[f"nf_{o}"].values)
                            sg = _diff(e[f"sg_{o}"].values)
                            sv = jnp.where(
                                nf > 0,
                                jnp.where(
                                    nf > jnp.abs(sg),
                                    jnp.float64(jnp.nan),
                                    jnp.where(sg > 0, jnp.float64(jnp.inf),
                                              jnp.float64(-jnp.inf))),
                                sv).astype(odt)
                            return Column(sv, nv > 0)

                        finalize.append((oname, a, fin_sum_fp))
                else:
                    finalize.append((oname, a, lambda e, st, o=oname,
                                     odt=odt: Column(
                                         _diff(e[f"w_{o}"].values)
                                         .astype(odt), None)))
            elif agg in (Aggregation.MIN, Aggregation.MAX):
                # value-ordered pass: group min/max = run-start value
                start_cols[f"m_{oname}"] = Column(vals, None)
                wcs = cumsum_i32(valid)
                end_cols[f"w_{oname}"] = Column(wcs, None)

                def fin_mm(e, st, o=oname, odt=odt):
                    nv = _diff(e[f"w_{o}"].values)
                    return Column(st[f"m_{o}"].values.astype(odt), nv > 0)

                finalize.append((oname, a, fin_mm))
            elif agg == Aggregation.FIRST:
                start_cols[f"f_{oname}"] = Column(vals, None)
                start_cols[f"fv_{oname}"] = Column(
                    (jnp.ones(cap, jnp.bool_)
                     if sorted_cols[s.input][1] is None
                     else sorted_cols[s.input][1]), None)
                finalize.append((oname, a, lambda e, st, o=oname,
                                 odt=odt: Column(
                                     st[f"f_{o}"].values.astype(odt),
                                     st[f"fv_{o}"].values)))
            elif agg == Aggregation.LAST:
                end_cols[f"l_{oname}"] = Column(vals, None)
                end_cols[f"lv_{oname}"] = Column(
                    (jnp.ones(cap, jnp.bool_)
                     if sorted_cols[s.input][1] is None
                     else sorted_cols[s.input][1]), None)
                finalize.append((oname, a, lambda e, st, o=oname,
                                 odt=odt: Column(
                                     e[f"l_{o}"].values.astype(odt),
                                     e[f"lv_{o}"].values)))
            else:
                raise SchemaError(f"unknown aggregation {agg}")

        if used_tid:
            # shared per-row tile id for the hierarchical-cumsum carries
            end_cols["__tid"] = Column(
                (pos // _HIER_TILE).astype(jnp.int32), None)

        # ---- extract run-end and run-start rows ----
        # Small-K fast path: when the group budget is small relative to the
        # input, one single-operand top_k finds the <=K marked positions,
        # followed by K-sized gathers of each needed column, instead of a
        # compaction that moves every row.  Capacities >= 2^24 take the
        # general compaction path: the f32 (cap - pos) ranking is no
        # longer exact there.
        small_k = (ext_cap <= min(cap // 4, 8192)
                   and cap < _APPROX_TOPK_MAX_CAP)

        def extract(cols: dict[str, Column], mask) -> dict[str, Column]:
            if not cols:
                return {}
            if small_k:
                # val = cap - pos for marked rows (descending in pos), so
                # top_k returns marked positions in ascending row order =
                # ascending group order; surplus slots (fewer than K marked
                # rows) land on arbitrary dead rows, clamped downstream by
                # num_groups.  approx_max_k at recall_target=1.0 is an
                # exact top-k; it needs floats, exact for integers < 2^24
                # (guarded above).
                val = jnp.where(mask, (cap - pos).astype(jnp.float32), 0.0)
                _, idx = jax.lax.approx_max_k(val, ext_cap,
                                              recall_target=1.0)
                return {
                    n: Column(
                        jnp.take(c.values, idx),
                        None if c.valid is None else jnp.take(c.valid, idx))
                    for n, c in cols.items()}
            # declared dtypes don't matter for compaction
            schema = TupleSchema([Attribute(n, DataType.INT64, False)
                                  for n in cols])
            tab = Table(schema, cols, live_count, {}, cap_hint=cap)
            compacted = compact_by_mask(tab, mask, ext_cap)
            return compacted.columns

        e_tab = extract(end_cols, is_end)
        s_tab = extract(start_cols, boundary)

        for oname, a, fn in finalize:
            merged_cols[oname] = fn(e_tab, s_tab)
        if is_base:
            keycols = {}
            for n, a in zip(names, key_attrs):
                kv = s_tab[f"k_{n}"].values
                kvalid = (s_tab[f"kv_{n}"].values if a.nullable else None)
                keycols[n] = Column(kv, kvalid)
            merged_cols.update(keycols)
            if need_rowid:
                first_row_col = s_tab["__first"].values

    # ---- re-rank to insertion order + clamp + slice ----
    cols = {a.name: merged_cols[a.name] for a in out_schema}
    n_out = jnp.minimum(num_groups, out_cap)
    if rerank:
        order_ops = [(jnp.arange(ext_cap, dtype=jnp.int32)
                      >= jnp.asarray(num_groups, jnp.int32))
                     .astype(jnp.int32),
                     first_row_col]
        payload2: list[jnp.ndarray] = []
        layout2 = []
        for a in out_schema:
            c = cols[a.name]
            payload2.append(c.values)
            if c.valid is not None:
                payload2.append(c.valid)
                layout2.append((a.name, True))
            else:
                layout2.append((a.name, False))
        res2 = jax.lax.sort(order_ops + payload2, num_keys=2,
                            is_stable=True)
        pi = 2
        cols = {}
        for n, has_valid in layout2:
            vals = res2[pi]
            pi += 1
            valid = None
            if has_valid:
                valid = res2[pi]
                pi += 1
            cols[n] = Column(vals, valid)

    if max_keys is not None:
        K = max_keys
        rank = jnp.arange(ext_cap, dtype=jnp.int32)
        overflow = ((rank >= K)
                    & (rank < jnp.asarray(num_groups, jnp.int32)))
        for s in specs:
            a = _resolve_output_attr(s, schema_in)
            c = cols[s.output]
            vals, valid = c.values, c.valid
            v_eff = vals if valid is None else jnp.where(
                valid, vals, jnp.zeros_like(vals))
            agg = s.aggregation
            if agg in (Aggregation.SUM, Aggregation.COUNT):
                extra = jnp.sum(jnp.where(overflow, v_eff,
                                          jnp.zeros_like(v_eff)))
                vals = vals.at[K - 1].add(extra)
            elif agg == Aggregation.MIN:
                ok = overflow if valid is None else (overflow & valid)
                tail = jnp.min(jnp.where(ok, vals,
                                         _min_identity(vals.dtype)))
                vals = vals.at[K - 1].set(jnp.minimum(vals[K - 1], tail))
            elif agg == Aggregation.MAX:
                ok = overflow if valid is None else (overflow & valid)
                tail = jnp.max(jnp.where(ok, vals,
                                         _max_identity(vals.dtype)))
                vals = vals.at[K - 1].set(jnp.maximum(vals[K - 1], tail))
            if valid is not None and agg in (Aggregation.SUM,
                                             Aggregation.MIN,
                                             Aggregation.MAX):
                any_tail = jnp.any(overflow & (valid if valid is not None
                                               else overflow))
                valid = valid.at[K - 1].set(valid[K - 1] | any_tail)
            cols[s.output] = Column(vals, valid)
        n_out = jnp.minimum(num_groups, K)

    if ext_cap != out_cap:
        cols = {n: Column(c.values[:out_cap],
                          None if c.valid is None else c.valid[:out_cap])
                for n, c in cols.items()}
    return Table(out_schema, cols, n_out, out_dicts, cap_hint=out_cap)


class GroupAggregate(Operation):
    """Hash group-by as payload sorts + cumsum-diff extraction.

    reference: GroupAggregate (aggregate_groups.cc:980); result ordering =
    key insertion order (RowHashSet append order), reproduced by re-ranking
    groups on first-occurrence row id.
    """

    best_effort = False

    def __init__(self, group_by: Sequence[str], specification, child,
                 options: GroupAggregateOptions | None = None):
        self.group_by = list(group_by)
        self.spec = _normalize_spec(specification)
        self.child = child
        self.options = options or GroupAggregateOptions()

    def bind(self, ctx: BindContext,
             _unordered: bool = False) -> BoundOperation:
        # _unordered: the consumer re-orders rows anyway (Sort binds its
        # GroupAggregate child with this), so the insertion-order
        # re-rank — and the dense path's first_pos kernel request — are
        # dropped; groups come out in key/slot order instead.
        from .filter import bind_predicates, keep_mask, unwrap_filters
        from .hash_join import HashJoin, KeyUniqueness
        _unordered = _unordered or getattr(self, "_always_unordered", False)
        if not getattr(self, "_pushdown_disabled", False):
            pushed = self._try_aggregate_pushdown(ctx, _unordered)
            if pushed is not None:
                return pushed
        inner, preds = unwrap_filters(self.child)
        # Fuse a UNIQUE join child: bind it masked (uncompacted output +
        # keep mask) and fold the mask into this aggregate's pad key —
        # saves the join's whole compaction.
        masked_join = (isinstance(inner, HashJoin)
                       and inner.uniqueness == KeyUniqueness.UNIQUE)
        cb = inner.bind(ctx, _masked=True) if masked_join else inner.bind(ctx)
        bound_preds = bind_predicates(preds, cb)
        names = self.group_by
        specs = self.spec.specs
        key_attrs = [cb.schema.lookup(n) for n in names]
        agg_attrs = [_resolve_output_attr(s, cb.schema) for s in specs]
        out_schema = TupleSchema(key_attrs + agg_attrs)
        out_dicts = {n: cb.dicts[n] for n in names if n in cb.dicts}
        # STRING/BINARY aggregation outputs (MIN/MAX/FIRST/LAST) carry the
        # input column's dictionary (codes pass through untransformed)
        for s_ in specs:
            if s_.input is not None and s_.input in cb.dicts:
                out_dicts[s_.output] = cb.dicts[s_.input]
        # CONCAT outputs get a deferred dictionary: codes are group run
        # ids; the strings exist only after the run (resolved by
        # execute() — reference: per-group byte assembly,
        # aggregation_operators.h:235-283)
        for s_ in specs:
            if s_.aggregation == Aggregation.CONCAT:
                from ..dictionary import DeferredDictionary

                out_dicts[s_.output] = DeferredDictionary()
        opts = self.options
        out_cap = opts.estimated_result_row_count or cb.capacity
        if opts.max_unique_keys_in_result:
            out_cap = min(out_cap, opts.max_unique_keys_in_result)
        max_keys = opts.max_unique_keys_in_result
        soft_limit = None
        if opts.memory_quota is not None:
            qrows = _quota_rows(opts.memory_quota, out_schema)
            if self.best_effort and not opts.enforce_quota:
                # degrade instead of raising (aggregate.h:233-246)
                if any(s.distinct for s in specs):
                    raise SchemaError(
                        "DISTINCT aggregates cannot be partially "
                        "aggregated under a best-effort memory_quota")
                if max_keys is not None:
                    raise SchemaError(
                        "max_unique_keys_in_result and a best-effort "
                        "memory_quota are mutually exclusive")
                soft_limit = qrows
                out_cap = cb.capacity  # tail rows pass through unaggregated
            else:
                # strict: overflow raises ERROR_MEMORY_EXCEEDED-style via
                # the result-overflow error flag
                out_cap = min(out_cap, qrows)
        schema_in = cb.schema

        dense = None
        if names and soft_limit is None:
            dense = _dense_domain(cb, names, key_attrs, specs,
                                  cb.schema, opts)

        def fn(rctx: RunContext) -> Table:
            if masked_join:
                t, keep = cb.run(rctx)
            else:
                t = cb.run(rctx)
                keep = None
            live_count = None
            if bound_preds:
                pk = keep_mask(bound_preds, rctx, t)
                keep = pk if keep is None else (keep & pk)
            if dense is not None:
                dims, K, guarded = dense
                return _dense_grouped_aggregate(
                    t, dims, specs, schema_in, out_dicts,
                    out_schema, out_cap, K, guarded, rctx, keep=keep,
                    ordered=not _unordered)
            if keep is not None:
                live_count = jnp.sum(keep.astype(jnp.int32), dtype=jnp.int32)
            return _grouped_aggregate(
                t, names, specs, schema_in, out_dicts, out_schema, out_cap,
                max_keys, rctx, pre_sorted=False, rerank=not _unordered,
                keep=keep,
                live_count=live_count, soft_key_limit=soft_limit,
                stats=cb.stats)

        # key column keeps its value bounds through grouping
        out_stats = {names[0]: cb.stats[names[0]]} \
            if names and names[0] in cb.stats else {}
        return BoundOperation(out_schema, out_dicts, fn, out_cap,
                              stats=out_stats)

    def _try_aggregate_pushdown(self, ctx: BindContext,
                                _unordered: bool) -> Optional[BoundOperation]:
        """Aggregate pushdown through a UNIQUE INNER join (star-schema
        rewrite, round 5): when the group keys come from the join's
        BUILD side and every aggregate reads only PROBE-side columns,
        pregroup the probe side by its join key first and join the (far
        fewer) partials — the probe-scale random rhs gather (~5-6
        ns/index, ~80% of the honest headline pipeline) shrinks to
        partial-count scale.  The reference designs exactly this hook:
        BestEffortGroupAggregate "can be used ... to distribute
        processing" by pregrouping before the expensive exchange
        (aggregate.h:233-246); here the join IS the exchange.

        Decompositions (column_aggregator.cc semantics preserved):
        SUM -> SUM of partial SUMs (partials aggregate in the same
        output type, so integer wrap composes modularly); COUNT -> SUM
        of partial COUNTs (counts non-null inputs; never NULL);
        MIN/MAX -> MIN/MAX of partials.  Insertion order (RowHashSet
        append order) is reproduced by MIN of per-partial first row
        positions; consumers that re-order anyway (_unordered) skip it.

        Applies only when both join children reduce statically to
        (Filter*)(ScanTable) — the planner needs the probe leaf's key
        range to bound the pregroup output — and when the key range is
        at most a quarter of the probe capacity (else the pregroup
        would not shrink the probe side enough to pay for itself).
        """
        from .compute import Compute
        from .filter import Filter, unwrap_filters
        from .hash_join import HashJoin, JoinType, KeyUniqueness
        from .project import Projector
        from .scan import ScanTable, table_stats
        from .sort import Sort, SortKey

        opts = self.options
        specs = self.spec.specs
        if (opts.memory_quota is not None
                or opts.max_unique_keys_in_result
                or self.best_effort or not self.group_by):
            return None
        inner, preds = unwrap_filters(self.child)
        if preds or not isinstance(inner, HashJoin):
            return None
        # INNER only; UNIQUE and NOT_UNIQUE both decompose exactly —
        # under NOT_UNIQUE every (probe-partial, build-row) pair of the
        # rewritten join contributes its partial once per duplicate,
        # exactly as the direct join's (probe-row, build-row) pairs do.
        # The NOT_UNIQUE rewrite also removes the output-scale expansion
        # entirely (a dup8-style aggregate never materializes its 64M
        # join rows).  Insertion order under duplicates: a group's rank
        # is the lexicographic minimum over its (probe-row, build-row)
        # pairs of (probe position, build original position) — the
        # probe-major order is the join's emission order and ties at the
        # same probe row resolve by match-list order == build original
        # order — which packs into one i64 MIN of
        # first_probe_pos * 2^32 + build_pos.
        # LEFT_OUTER decomposes too: an unmatched probe row emits one
        # NULL-rhs row in the direct join, and its partial emits one
        # NULL-rhs row in the rewritten join — the NULL-key group gets
        # the same partials (rank ties use build position 0: the NULL
        # row is its probe row's whole match list).
        if inner.join_type not in (JoinType.INNER, JoinType.LEFT_OUTER):
            return None
        left_outer = inner.join_type == JoinType.LEFT_OUTER
        for s in specs:
            if s.distinct or s.aggregation not in (
                    Aggregation.SUM, Aggregation.MIN, Aggregation.MAX,
                    Aggregation.COUNT):
                return None
        lleaf, _lp = unwrap_filters(inner.lhs)
        rleaf, _rp = unwrap_filters(inner.rhs)
        if not isinstance(lleaf, ScanTable) or not isinstance(rleaf,
                                                              ScanTable):
            return None
        lschema, rschema = lleaf.table.schema, rleaf.table.schema
        try:
            lpairs = inner.lhs_projector.resolve(lschema)
            rpairs = inner.rhs_projector.resolve(rschema)
        except SchemaError:
            return None
        ldst = {dst: src for src, dst in lpairs}
        rdst = {dst: src for src, dst in rpairs}
        if not all(k in rdst for k in self.group_by):
            return None
        for s in specs:
            if s.input is not None and s.input not in ldst:
                return None
        if any(n.startswith("__pre") or n == "__rank"
               for n in (list(ldst) + list(rdst) + list(lschema.names())
                         + list(rschema.names()))):
            return None
        # probe-side key-range statistics bound the pregroup output
        lstats = table_stats(lleaf.table)
        rng = 1
        for k in inner.lhs_keys:
            try:
                a = lschema.lookup(k)
            except SchemaError:
                return None
            if a.type in (DataType.STRING, DataType.BINARY):
                d = lleaf.table.dicts.get(k)
                if d is None:
                    return None
                rng *= max(len(d), 1)
            elif a.type in (DataType.INT32, DataType.INT64,
                            DataType.UINT32, DataType.DATE,
                            DataType.DATETIME, DataType.ENUM):
                if k not in lstats:
                    return None
                lo, hi = lstats[k]
                rng *= hi - lo + 1
            else:
                return None
            if rng > (1 << 24):
                return None
        lcap = lleaf.table.capacity
        if rng <= 0 or rng * 4 > lcap:
            return None

        # --- build the rewritten plan ---
        pre_specs: list[AggSpec] = []
        final_specs: list[AggSpec] = []
        for i, s in enumerate(specs):
            pname = f"__pre{i}"
            if s.aggregation == Aggregation.SUM:
                pre_specs.append(AggSpec(Aggregation.SUM, ldst[s.input],
                                         pname,
                                         output_type=s.output_type))
                final_specs.append(AggSpec(Aggregation.SUM, pname,
                                           s.output,
                                           output_type=s.output_type))
            elif s.aggregation == Aggregation.COUNT:
                # partial counts are bounded by the probe capacity, so
                # they ride an INT32 partial column (u32 fat-LUT lanes,
                # no 64-bit gather group) whenever that fits; the final
                # SUM still aggregates exactly in the 64-bit output type
                pt = (DataType.INT32 if lcap < 2**31 - 1
                      else DataType.INT64)
                pre_specs.append(AggSpec(
                    Aggregation.COUNT,
                    None if s.input is None else ldst[s.input], pname,
                    output_type=pt))
                final_specs.append(AggSpec(
                    Aggregation.SUM, pname, s.output,
                    output_type=s.output_type or DataType.UINT64))
            else:  # MIN / MAX decompose into themselves
                pre_specs.append(AggSpec(s.aggregation, ldst[s.input],
                                         pname))
                final_specs.append(AggSpec(s.aggregation, pname, s.output,
                                           output_type=s.output_type))
        pre_child = inner.lhs
        rhs_child = inner.rhs
        rhs_proj = inner.rhs_projector
        rank_over_pairs = (not _unordered
                           and inner.uniqueness != KeyUniqueness.UNIQUE)
        if not _unordered:
            # first-occurrence positions: Sequence() over the LEAF rows
            # (pre-filter positions are monotone w.r.t. the filtered
            # order, so MIN over kept rows ranks groups identically).
            # The Compute goes UNDER the probe-side Filters so the
            # pregroup's filter-into-pad-key fusion still applies.
            from ..exprs import Sequence, col as _col
            pre_child = Compute(
                [_col(n) for n in lschema.names()]
                + [Sequence().as_("__prepos")], lleaf)
            for p in _lp:
                pre_child = Filter(p, pre_child)
            pre_specs.append(AggSpec(Aggregation.MIN, "__prepos",
                                     "__prefp"))
            if rank_over_pairs:
                # NOT_UNIQUE: rank = lexicographic pair minimum of
                # (first probe position, build original position),
                # packed into one i64 (both < 2^32 by capacity)
                rhs_child = Compute(
                    [_col(n) for n in rschema.names()]
                    + [Sequence().as_("__prebpos")], rleaf)
                for p in _rp:
                    rhs_child = Filter(p, rhs_child)
                rhs_proj = Projector(list(rpairs)
                                     + [("__prebpos", None)])
                final_specs.append(AggSpec(Aggregation.MIN, "__rank",
                                           "__fp"))
            else:
                final_specs.append(AggSpec(Aggregation.MIN, "__prefp",
                                           "__fp"))
        pregroup = GroupAggregate(
            list(inner.lhs_keys), pre_specs, pre_child,
            GroupAggregateOptions(estimated_result_row_count=rng))
        pregroup._pushdown_disabled = True
        # partial order is irrelevant (the join re-orders anyway):
        # drop the pregroup's insertion-order re-rank machinery
        pregroup._always_unordered = True
        part_names = [s.output for s in pre_specs]
        # NOT_UNIQUE: every build row matches at most ONE partial (the
        # pregroup output is key-unique), so the rewritten join's output
        # is bounded by the build capacity (+ one row per unmatched
        # partial under LEFT_OUTER) — far below the direct join's
        # duplicated output
        join_cap = (None if inner.uniqueness == KeyUniqueness.UNIQUE
                    else rleaf.table.capacity
                    + (rng if left_outer else 0))
        new_join = HashJoin(
            inner.join_type, list(inner.lhs_keys),
            list(inner.rhs_keys), pregroup, rhs_child, inner.uniqueness,
            lhs_projector=Projector.named(*part_names),
            rhs_projector=rhs_proj,
            out_capacity=join_cap,
            allow_dense_lookup=inner.allow_dense_lookup)
        final_child: Operation = new_join
        if rank_over_pairs:
            from ..exprs import Const as _Const, IfNull, col as _col2
            keep = ([_col2(dst) for _, dst in rpairs]
                    + [_col2(p) for p in part_names if p != "__prefp"])
            # LEFT_OUTER NULL-rhs rows: build position 0 (the NULL row
            # is its probe row's whole match list)
            bpos = IfNull(_col2("__prebpos"), _Const(0, DataType.INT64))
            final_child = Compute(
                keep + [(_col2("__prefp")
                         * _Const(1 << 32, DataType.INT64)
                         + bpos).as_("__rank")], new_join)
        final = GroupAggregate(
            list(self.group_by), final_specs, final_child,
            GroupAggregateOptions(
                estimated_result_row_count=opts.estimated_result_row_count))
        final._pushdown_disabled = True
        plan: Operation = final
        if not _unordered:
            plan = Sort([SortKey("__fp", ascending=True)], final)
        bound = plan.bind(ctx)

        # --- schema fix-up: reproduce the direct path's output schema
        # (column order, COUNT non-nullable) and drop the __fp helper ---
        join_attrs = []
        for src, dst in lpairs:
            a = lschema.lookup(src)
            join_attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
        for src, dst in rpairs:
            a = rschema.lookup(src)
            # LEFT_OUTER forces rhs outputs nullable (hash_join.cc:78-87)
            join_attrs.append(Attribute(dst, a.type,
                                        a.nullable or left_outer, a.enum))
        join_schema = TupleSchema(join_attrs)
        key_attrs = [join_schema.lookup(n) for n in self.group_by]
        agg_attrs = [_resolve_output_attr(s, join_schema) for s in specs]
        out_schema = TupleSchema(key_attrs + agg_attrs)
        out_names = [a.name for a in out_schema]
        out_dicts = {n: d for n, d in bound.dicts.items()
                     if n in out_names}

        def fn(rctx: RunContext) -> Table:
            t = bound.run(rctx)
            cols = {}
            for a in out_schema:
                c = t.columns[a.name]
                if not a.nullable and c.valid is not None:
                    c = Column(c.values, None)
                cols[a.name] = c
            return Table(out_schema, cols, t.num_rows, out_dicts,
                         cap_hint=bound.capacity)

        out_stats = {}
        if self.group_by and self.group_by[0] in bound.stats:
            out_stats[self.group_by[0]] = bound.stats[self.group_by[0]]
        return BoundOperation(out_schema, out_dicts, fn, bound.capacity,
                              stats=out_stats)


class BestEffortGroupAggregate(GroupAggregate):
    """Best-effort pregroup (reference: aggregate_groups.cc:989,
    aggregate.h:233-246).  Without a ``memory_quota`` a full group-by
    always fits its declared capacity, so best-effort == exact.  With a
    quota (and ``enforce_quota=False``) it degrades instead of raising:
    the first quota-budget distinct keys aggregate fully and later rows
    pass through as singleton partial groups — output rows are correct
    partial aggregates but not key-unique, matching the reference's
    best-effort contract.  This is the memory-bounded pregroup for the
    distributed pregroup -> shuffle -> combine pipeline
    (parallel/dist.py::dist_group_aggregate)."""

    best_effort = True


class HybridGroupAggregate(GroupAggregate):
    """Disk-capable group-by (reference: HybridGroupAggregate,
    aggregate_groups.cc:1146; design comment :491-534): chunked pregroup
    -> external sort on the (extended) key -> clustered combine.

    Without a ``memory_quota`` the in-HBM GroupAggregate already handles
    arbitrary cardinality and multi-column DISTINCT, so Hybrid degrades to
    exactly that operator.  WITH a quota, inputs whose distinct-key
    working set exceeds the budget COMPLETE the aggregation (strict
    GroupAggregate raises; BestEffort emits partial groups):

      1. the input is pregrouped on device in quota-sized chunks (each
         chunk's distinct keys necessarily fit the chunk, so every device
         pass respects the quota) — the reference's best-effort pregroup
         (aggregate_groups.cc:989);
      2. DISTINCT aggregates add their input columns to the pregroup key
         (the reference's hybrid-group transform, hybrid_group_utils.h:
         20-66), so distinct values dedup through the sort;
      3. chunk results spill through ``io/external.ExternalSorter``
         (quota-bounded device-sorted runs, k-way merged on read-back —
         the reference's disk sort, aggregate_groups.cc:513-516);
      4. the sorted stream is combined in quota-sized batches (cluster
         boundaries held back) by ``AggregateClusters`` with the
         partial-aggregate algebra — COUNT recombines via SUM
         (aggregate_groups.cc:545-590).

    Output order is key-sorted (the reference's hybrid output follows its
    disk-sort order too, not insertion order).  CONCAT cannot be combined
    across partial groups and raises; FIRST/LAST mixed with DISTINCT
    aggregates would lose input order through the extended-key sort and
    raise.  ``temporary_directory_prefix``: reference aggregate.h:311.
    """

    def __init__(self, group_by: Sequence[str], specification, child,
                 options: GroupAggregateOptions | None = None,
                 temporary_directory_prefix=None):
        super().__init__(group_by, specification, child, options)
        self.temp_prefix = temporary_directory_prefix

    def bind(self, ctx: BindContext,
             _unordered: bool = False) -> BoundOperation:
        opts = self.options
        if opts.memory_quota is None:
            return super().bind(ctx, _unordered)
        import numpy as np

        from .base import compile_plan, materialize_bound
        from .scan import ScanTable
        from .sort import SortOrder
        from ..batch import Column, Table, concat_tables
        from ..io.external import ExternalSorter

        names = list(self.group_by)
        specs = self.spec.specs
        has_distinct = any(s.distinct for s in specs)
        for s in specs:
            if s.aggregation == Aggregation.CONCAT:
                raise SchemaError(
                    "CONCAT partial aggregates cannot be combined across "
                    "spilled chunks (order-sensitive, variable-length); "
                    "use GroupAggregate within memory or "
                    "ops.host.group_concat")
            if has_distinct and s.aggregation in (
                    Aggregation.FIRST, Aggregation.LAST):
                raise SchemaError(
                    "FIRST/LAST cannot be combined with DISTINCT "
                    "aggregates under a spilling HybridGroupAggregate "
                    "(the extended-key disk sort loses input order)")

        # bind is SIDE-EFFECT-FREE: the
        # child binds once here for schema/capacity; the spill pipeline
        # runs at execution time as a lazy-leaf producer — the
        # reference's hybrid cursor likewise makes CreateCursor cheap
        # and drains its child at the first Next()
        # (aggregate_groups.cc:332-431).
        cb = self.child.bind(ctx)

        # extended pregroup key: group key + DISTINCT input columns
        ext_names = list(names)
        for s in specs:
            if s.distinct and s.input not in ext_names:
                ext_names.append(s.input)
        pre_spec = AggregationSpecification(
            [s for s in specs if not s.distinct])
        key_attrs = [cb.schema.lookup(n) for n in ext_names]
        pre_agg_attrs = [_resolve_output_attr(s, cb.schema)
                         for s in pre_spec.specs]
        pre_schema = TupleSchema(key_attrs + pre_agg_attrs)
        chunk_rows = _quota_rows(opts.memory_quota, pre_schema)

        key_out = [cb.schema.lookup(n) for n in names]
        agg_out = [_resolve_output_attr(s, cb.schema) for s in specs]
        out_schema = TupleSchema(key_out + agg_out)
        out_cap = min(opts.estimated_result_row_count or cb.capacity,
                      cb.capacity)
        out_dicts = {n: cb.dicts[n] for n in names if n in cb.dicts}
        for s_ in specs:
            if s_.input is not None and s_.input in cb.dicts:
                out_dicts[s_.output] = cb.dicts[s_.input]

        need = list(dict.fromkeys(
            ext_names + [s.input for s in specs
                         if s.input is not None and not s.distinct]))
        sub_schema = TupleSchema([cb.schema.lookup(n) for n in need])

        final_specs = []
        for s in specs:
            if s.distinct:
                final_specs.append(s)
            elif s.aggregation == Aggregation.COUNT:
                final_specs.append(AggSpec(
                    Aggregation.SUM, s.output, s.output,
                    s.output_type or DataType.UINT64))
            else:
                final_specs.append(AggSpec(
                    s.aggregation, s.output, s.output, s.output_type))
        merge_specs = []
        for s in specs:
            if s.aggregation == Aggregation.COUNT:
                merge_specs.append(AggSpec(
                    Aggregation.SUM, s.output, s.output,
                    s.output_type or DataType.UINT64))
            else:
                # SUM/MIN/MAX (distinct batches saw disjoint values,
                # so plain re-aggregation is exact); FIRST/LAST keep
                # batch order == sorted order
                merge_specs.append(AggSpec(
                    s.aggregation, s.output, s.output, s.output_type))

        temp_prefix = self.temp_prefix
        # compiled-program cache shared across BINDS of this operation
        # instance (execute() re-binds every run): the pregroup/combine/
        # merge programs depend only on the bind shapes in the key, so
        # re-executing the plan must NOT re-pay their compile (a fresh
        # jax.jit per execute re-compiles the pregroup on every run)
        cache_key = (chunk_rows, cb.capacity,
                     tuple((a.name, a.type, a.nullable)
                           for a in pre_schema))
        prog_cache: dict = self.__dict__.setdefault(
            "_prog_caches", {}).setdefault(cache_key, {})

        def producer(leaves, cancel) -> Table:
            def poll():
                if cancel is not None:
                    cancel.check()  # Cursor::Interrupt poll point

            src = materialize_bound(cb, leaves, cancel, cache=prog_cache)
            sub_dicts = {n: src.dicts[n] for n in need if n in src.dicts}
            n_in = int(src.num_rows)
            # chunks slice the child's DEVICE arrays directly — the
            # child already resides in device memory as a plan input, so
            # feeding the pregroup costs no host round-trip; only the
            # pregroup OUTPUTS cross to the host, which is the spill
            # boundary by definition
            host_cols = {nm: (src.columns[nm].values,
                              src.columns[nm].valid)
                         for nm in need}

            def chunk_table(start: int, stop: int, cap: int) -> Table:
                rows = stop - start
                cols = {}
                for nm in need:
                    vals, valid = host_cols[nm]
                    v = vals[start:min(start + cap, vals.shape[0])]
                    if v.shape[0] < cap:
                        v = jnp.concatenate(
                            [v, jnp.zeros(cap - v.shape[0], v.dtype)])
                    w = None
                    if valid is not None:
                        w = valid[start:min(start + cap,
                                            valid.shape[0])]
                        if w.shape[0] < cap:
                            w = jnp.concatenate(
                                [w, jnp.zeros(cap - w.shape[0],
                                              jnp.bool_)])
                    # rows past `rows` are dead via num_rows regardless
                    cols[nm] = Column(v, w)
                return Table(sub_schema, cols, rows, sub_dicts,
                             cap_hint=cap)

            # one compiled pregroup program reused across same-shaped
            # chunks.  The compile leaf is a ZERO-ROW placeholder so no
            # bind-time planner statistics are recorded — a program
            # specialized to the first chunk's key range would clamp
            # later chunks' keys (stats-guarded paths; the guard flags
            # of inner programs are checked below, but the program must
            # be data-independent to be reusable at all)
            if "jpre" not in prog_cache:
                placeholder_pre = Table(
                    sub_schema,
                    {nm: Column(jnp.zeros(chunk_rows,
                                          host_cols[nm][0].dtype),
                                None if host_cols[nm][1] is None
                                else jnp.zeros(chunk_rows, jnp.bool_))
                     for nm in need},
                    0, sub_dicts, cap_hint=chunk_rows)
                pre_run, _b, _l = compile_plan(GroupAggregate(
                    ext_names, pre_spec, ScanTable(placeholder_pre),
                    GroupAggregateOptions(
                        estimated_result_row_count=chunk_rows)))
                prog_cache["jpre"] = jax.jit(pre_run)
            jpre = prog_cache["jpre"]

            def check(flags, what):
                if flags.shape[0] and bool(np.asarray(flags).any()):
                    from ..exprs.base import EvaluationError
                    raise EvaluationError(
                        f"evaluation failed: hybrid {what} raised "
                        "device error flags")

            with ExternalSorter(pre_schema, SortOrder(ext_names),
                                chunk_rows, temp_prefix) as sorter:
                for start in range(0, n_in, chunk_rows):
                    poll()
                    pre_t, pflags = jpre([chunk_table(
                        start, min(start + chunk_rows, n_in),
                        chunk_rows)])
                    check(pflags, "pregroup")
                    sorter.write(pre_t)
                merged = sorter.result()

            # ---- combine the sorted partials in FIXED-SHAPE batches
            # (one compiled AggregateClusters program reused —
            # the per-batch eager compile and the Python
            # row-walk boundary search are gone).  Batch ends snap BACK
            # to the last extended-key cluster start inside the window,
            # so a (key, distinct-value) group never splits and every
            # batch fits the static [batch_cap] capacity. ----
            m_rows = int(merged.num_rows)
            batch_cap = max(chunk_rows, 2)
            # vectorized cluster-boundary scan (NULL == NULL)
            same = np.ones(max(m_rows, 1), dtype=bool)
            same[0] = False
            for nm in ext_names:
                c = merged.columns[nm]
                v = np.asarray(c.values)[:m_rows]
                eq = v[1:] == v[:-1]
                if c.valid is not None:
                    vld = np.asarray(c.valid)[:m_rows]
                    eq = (eq & vld[1:] & vld[:-1]) | (~vld[1:] & ~vld[:-1])
                same[1:m_rows] &= eq
            starts_np = np.flatnonzero(~same[:m_rows])  # cluster starts
            m_cols = {nm: np.asarray(merged.columns[nm].values)[:m_rows]
                      for nm in pre_schema.names()}
            m_valid = {nm: (None if merged.columns[nm].valid is None
                            else np.asarray(
                                merged.columns[nm].valid)[:m_rows])
                       for nm in pre_schema.names()}

            jcomb = prog_cache.get("jcomb")
            outputs = []
            start = 0
            while start < m_rows:
                poll()
                if start + batch_cap >= m_rows:
                    stop = m_rows
                else:
                    inside = starts_np[(starts_np > start)
                                       & (starts_np <= start + batch_cap)]
                    stop = int(inside[-1]) if inside.size else start
                batch_rows = stop - start
                if 0 < batch_rows <= batch_cap:
                    batch = Table.from_arrays(
                        pre_schema,
                        {nm: m_cols[nm][start:stop]
                         for nm in pre_schema.names()},
                        {nm: (None if m_valid[nm] is None
                              else m_valid[nm][start:stop])
                         for nm in pre_schema.names()},
                        batch_rows, dict(merged.dicts),
                        capacity=batch_cap)
                    if jcomb is None:
                        # zero-row placeholder: no bind-time stats (see
                        # the pregroup placeholder note)
                        placeholder_cmb = Table(
                            pre_schema,
                            {a.name: Column(
                                jnp.zeros(batch_cap,
                                          physical_dtype(a.type)),
                                None if merged.columns[a.name].valid
                                is None
                                else jnp.zeros(batch_cap, jnp.bool_))
                             for a in pre_schema},
                            0, dict(merged.dicts), cap_hint=batch_cap)
                        comb_run, _cb2, _cl2 = compile_plan(
                            AggregateClusters(names, final_specs,
                                              ScanTable(placeholder_cmb)))
                        jcomb = jax.jit(comb_run)
                        prog_cache["jcomb"] = jcomb
                    out_t, cflags = jcomb([batch])
                    check(cflags, "combine")
                else:
                    # a single extended-key cluster wider than a batch
                    # (pathological: needs more spill runs than quota
                    # rows) — run that one cluster eagerly
                    nxt = starts_np[starts_np > start]
                    stop = int(nxt[0]) if nxt.size else m_rows
                    batch_rows = stop - start
                    batch = Table.from_arrays(
                        pre_schema,
                        {nm: m_cols[nm][start:stop]
                         for nm in pre_schema.names()},
                        {nm: (None if m_valid[nm] is None
                              else m_valid[nm][start:stop])
                         for nm in pre_schema.names()},
                        batch_rows, dict(merged.dicts))
                    from .base import materialize_child
                    out_t = materialize_child(AggregateClusters(
                        names, final_specs, ScanTable(batch)), jit=False)
                outputs.append(out_t)
                start = stop

            if not outputs:
                final = Table.empty(out_schema)
            elif len(outputs) == 1:
                final = outputs[0]
            else:
                # batch boundaries can split a group-key cluster; one
                # more clustered pass with the batch-combine algebra
                # (DISTINCT batches saw disjoint value sets, so COUNT
                # DISTINCT recombines via SUM).  Jitted + shape-cached:
                # an eager run dispatches every op separately
                cat = concat_tables(outputs)
                mkey = ("jmerge", cat.capacity)
                if mkey not in prog_cache:
                    merge_ph = Table(cat.schema, cat.columns, 0,
                                     dict(cat.dicts))
                    mrun, _mb, _ml = compile_plan(AggregateClusters(
                        names, merge_specs, ScanTable(merge_ph)))
                    prog_cache[mkey] = jax.jit(mrun)
                final, mflags = prog_cache[mkey]([cat])
                check(mflags, "merge")
            n_out = int(final.num_rows)
            if n_out > out_cap:
                from ..exprs.base import EvaluationError
                raise EvaluationError(
                    "evaluation failed: hybrid aggregate result exceeds "
                    f"the declared capacity ({n_out} > {out_cap} rows; "
                    "raise estimated_result_row_count)")
            # re-code dictionary columns into the bind-declared
            # dictionaries (concat/merge may have rebuilt equal-content
            # objects; downstream operators hold the declared ones)
            fvals, fvalid = {}, {}
            for a in out_schema:
                c = final.columns[a.name]
                v = np.asarray(c.values)[:n_out]
                if a.name in out_dicts and a.name in final.dicts \
                        and final.dicts[a.name] is not out_dicts[a.name]:
                    d1, d0 = final.dicts[a.name], out_dicts[a.name]
                    remap = np.array(
                        [d0.lookup(x) for x in
                         d1.decode(np.arange(len(d1)))], dtype=v.dtype)
                    v = remap[np.clip(v, 0, max(len(d1) - 1, 0))]
                fvals[a.name] = v
                fvalid[a.name] = (None if c.valid is None
                                  else np.asarray(c.valid)[:n_out])
            return Table.from_arrays(out_schema, fvals, fvalid, n_out,
                                     out_dicts, capacity=out_cap)

        placeholder = Table.empty(out_schema, out_cap)
        placeholder.dicts.update(out_dicts)
        idx = ctx.register_lazy_leaf(placeholder, producer)

        def fn(rctx: RunContext) -> Table:
            return rctx.leaf_tables[idx]

        return BoundOperation(out_schema, out_dicts, fn, out_cap)


class ScalarAggregate(Operation):
    """Aggregate the whole input to exactly one row — even when empty
    (reference: aggregate_scalar.cc:17-58)."""

    def __init__(self, specification, child):
        self.spec = _normalize_spec(specification)
        self.child = child

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        specs = self.spec.specs
        out_schema = TupleSchema([_resolve_output_attr(s, cb.schema)
                                  for s in specs])
        schema_in = cb.schema

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            live = t.row_mask()
            cols = {}
            for s in specs:
                a = _resolve_output_attr(s, schema_in)
                odt = jnp_dtype(a.type)
                agg = s.aggregation
                if agg == Aggregation.COUNT and s.input is None:
                    v = jnp.sum(live.astype(jnp.int64)).astype(odt)
                    cols[s.output] = Column(v[None], None)
                    continue
                c = t.columns[s.input]
                valid = c.valid_or_true() & live
                vals = c.values
                weight = valid
                if s.distinct and agg in (Aggregation.SUM,
                                          Aggregation.COUNT):
                    code = monotone_code(vals,
                                         schema_in.lookup(s.input).type)
                    ops_ = [jnp.where(valid, 0, 1).astype(jnp.int32), code,
                            valid.astype(jnp.int32)]
                    sc = jax.lax.sort(ops_ + [vals], num_keys=3,
                                      is_stable=True)
                    svals, scode = sc[-1], sc[1]
                    svalid = sc[2] > 0
                    dup = ((scode == jnp.roll(scode, 1))
                           & (jnp.arange(t.capacity,
                                         dtype=jnp.int32) > 0))
                    weight = svalid & ~dup
                    vals = svals
                    valid = svalid
                if agg == Aggregation.SUM:
                    v = jnp.sum(jnp.where(weight, vals,
                                          jnp.zeros_like(vals))).astype(odt)
                    ok = jnp.any(weight)
                    cols[s.output] = Column(v[None], ok[None])
                elif agg == Aggregation.COUNT:
                    v = jnp.sum(weight.astype(jnp.int64)).astype(odt)
                    cols[s.output] = Column(v[None], None)
                elif agg == Aggregation.MIN:
                    v = jnp.min(jnp.where(weight, vals,
                                          _min_identity(vals.dtype)))
                    cols[s.output] = Column(v.astype(odt)[None],
                                            jnp.any(weight)[None])
                elif agg == Aggregation.MAX:
                    v = jnp.max(jnp.where(weight, vals,
                                          _max_identity(vals.dtype)))
                    cols[s.output] = Column(v.astype(odt)[None],
                                            jnp.any(weight)[None])
                elif agg in (Aggregation.FIRST, Aggregation.LAST):
                    c2 = t.columns[s.input]
                    n = jnp.asarray(t.num_rows)
                    if agg == Aggregation.FIRST:
                        idx = jnp.int32(0)
                    else:
                        idx = jnp.maximum(n - 1, 0).astype(jnp.int32)
                    v = jnp.take(c2.values, idx)
                    ok = jnp.take(c2.valid_or_true(), idx) & (n > 0)
                    cols[s.output] = Column(v.astype(odt)[None], ok[None])
                elif agg == Aggregation.CONCAT:
                    # one group = the whole input, rows in input order
                    # (reference: aggregate_scalar.cc result_index_map
                    # all zeros); byte assembly deferred to execute()
                    rctx.deferred.append(DeferredConcat(
                        name=s.output, dict_obj=out_dicts[s.output],
                        separator=",", distinct=bool(s.distinct),
                        input_type=schema_in.lookup(s.input).type,
                        input_dict=t.dicts.get(s.input),
                        aux={"gid": jnp.zeros(t.capacity, jnp.int32),
                             "vals": c.values, "valid": valid,
                             "num_groups": jnp.int32(1)}))
                    cols[s.output] = Column(jnp.zeros(1, jnp.int32),
                                            jnp.any(valid)[None])
                else:
                    raise NotImplementedError(f"scalar {agg}")
            return Table(out_schema, cols, 1, out_dicts)

        out_dicts = {s_.output: cb.dicts[s_.input] for s_ in specs
                     if s_.input is not None and s_.input in cb.dicts}
        for s_ in specs:
            if s_.aggregation == Aggregation.CONCAT:
                from ..dictionary import DeferredDictionary

                out_dicts[s_.output] = DeferredDictionary()
        return BoundOperation(out_schema, out_dicts, fn, 1)


class AggregateClusters(Operation):
    """Streaming aggregate over key-clustered input (reference:
    aggregate_clusters.cc:338-646): group boundaries detected by comparing
    consecutive rows; output in input cluster order."""

    def __init__(self, group_by: Sequence[str], specification, child,
                 out_capacity: Optional[int] = None):
        self.group_by = list(group_by)
        self.spec = _normalize_spec(specification)
        self.child = child
        self.out_capacity = out_capacity

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        names = self.group_by
        specs = self.spec.specs
        key_attrs = [cb.schema.lookup(n) for n in names]
        agg_attrs = [_resolve_output_attr(s, cb.schema) for s in specs]
        out_schema = TupleSchema(key_attrs + agg_attrs)
        out_dicts = {n: cb.dicts[n] for n in names if n in cb.dicts}
        # STRING/BINARY aggregation outputs (MIN/MAX/FIRST/LAST) carry the
        # input column's dictionary (codes pass through untransformed)
        for s_ in specs:
            if s_.input is not None and s_.input in cb.dicts:
                out_dicts[s_.output] = cb.dicts[s_.input]
        # CONCAT outputs get a deferred dictionary: codes are group run
        # ids; the strings exist only after the run (resolved by
        # execute() — reference: per-group byte assembly,
        # aggregation_operators.h:235-283)
        for s_ in specs:
            if s_.aggregation == Aggregation.CONCAT:
                from ..dictionary import DeferredDictionary

                out_dicts[s_.output] = DeferredDictionary()
        out_cap = self.out_capacity or cb.capacity
        schema_in = cb.schema

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            return _grouped_aggregate(
                t, names, specs, schema_in, out_dicts, out_schema, out_cap,
                None, rctx, pre_sorted=True, rerank=False)

        return BoundOperation(out_schema, out_dicts, fn, out_cap)


def AggregateClustersWithSpecifiedOutputBlockSize(
        group_by, specification, block_size, child):
    """reference: aggregate.h AggregateClustersWithSpecifiedOutputBlockSize
    — the block size caps per-view output; here it is the static output
    capacity."""
    return AggregateClusters(group_by, specification, child,
                             out_capacity=int(block_size))

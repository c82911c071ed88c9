"""Fused segmented reductions into a small number of segments.

This is the dense group-by's hot loop (reference: the scatter-update
inner loop of ColumnAggregator, column_aggregator.cc:78-196): one pass
over (segment ids, values...) computes several segmented reductions at
once.  Out-of-range segment ids (negative, or >= ``num_segments``) are
dropped.

Implementations (``implementation`` picks one from the platform and the
segment count):

* ``"triton"`` — a Pallas kernel through Triton.  A program owns a
  contiguous run of rows and a chunk of ``KC`` segments; it walks its
  rows ``BLOCK`` at a time, builds the ``id == k`` match for its chunk
  in registers once per block, and every request reads that one match.
  Each program writes its partial result to row ``p`` of a
  ``[programs, K]`` array, and a second pass in plain jnp reduces the
  partials in a fixed order.  No atomics (results are the same on every
  run) and no dot products (no TF32 rounding of f32 sums).
  Its work grows with rows x segments, so it serves small segment
  counts only.
* ``"segment"`` — ``jax.ops.segment_*``: one scatter per request (XLA
  emits atomic adds, min and max on the GPU).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_SEGMENTS = 2048
MODES = ("sum", "min", "max", "count")
IMPLS = ("triton", "segment")

# Kernel shape: rows per block step, segments per program, warps, and
# the grid size aimed at (enough programs in flight to fill the card's
# SMs).  Chosen from a sweep on an H100 at 8M rows, K in 64..1024.
BLOCK = 256
KC = 64
NUM_WARPS = 8
TARGET_PROGRAMS = 1024
# Largest segment count the kernel serves.  Its time grows with rows x
# segments; on an H100 it was no slower than the scatter form up to 512
# segments and 3x slower at 1024 (8M rows, 2 and 8 fused requests).
KERNEL_MAX_SEGMENTS = 512


def implementation(platform: str, num_segments: int) -> str:
    """The implementation ``segment_reduce_multi`` uses on ``platform``
    (``jax.devices()[0].platform``) for ``num_segments`` segments."""
    if platform == "gpu" and num_segments <= KERNEL_MAX_SEGMENTS:
        return "triton"
    return "segment"


def _init(mode: str, dtype):
    """Identity element of ``mode`` as a static Python scalar."""
    floating = jnp.issubdtype(dtype, jnp.floating)
    if mode in ("sum", "count"):
        return 0.0 if floating else 0
    if mode == "min":
        return float("inf") if floating else int(jnp.iinfo(dtype).max)
    return float("-inf") if floating else int(jnp.iinfo(dtype).min)


def _combine(mode: str, a, b):
    if mode in ("sum", "count"):
        return a + b
    if mode == "min":
        return jnp.minimum(a, b)
    return jnp.maximum(a, b)


def _reduce(mode: str, x, axis: int):
    if mode in ("sum", "count"):
        return jnp.sum(x, axis=axis, dtype=x.dtype)
    if mode == "min":
        return jnp.min(x, axis=axis)
    return jnp.max(x, axis=axis)


def _check(requests):
    for values, mode in requests:
        assert mode in MODES, mode
        dt = jnp.dtype(values.dtype)
        assert dt in (jnp.dtype(jnp.float32), jnp.dtype(jnp.int32)), dt
        if mode == "count":
            assert dt == jnp.dtype(jnp.int32), (mode, dt)


def segment_reduce_multi(requests, segment_ids, num_segments: int, *,
                         impl: str | None = None, interpret: bool = False):
    """Fused segmented reductions.

    ``requests`` is a list of ``(values, mode)``; values are f32 or i32
    arrays as long as ``segment_ids``.  Modes: ``sum`` (i32 sums wrap),
    ``min``, ``max`` and ``count`` (values are 0/1 i32 indicators,
    summed).  Returns one ``[num_segments]`` array per request, in the
    request's dtype; a segment no row reaches holds the mode's identity.

    ``impl`` overrides ``implementation(platform)``; ``interpret`` runs
    the Triton kernel in Pallas interpret mode (tests on the CPU).
    """
    _check(requests)
    assert 1 <= num_segments <= MAX_SEGMENTS, num_segments
    impl = impl or implementation(jax.default_backend(), num_segments)
    ids = segment_ids.astype(jnp.int32)
    if ids.shape[0] == 0:
        return [jnp.full(num_segments, _init(mode, v.dtype), v.dtype)
                for v, mode in requests]
    if impl == "triton":
        return _triton(requests, ids, num_segments, interpret)
    if impl == "segment":
        return [_segment(v, mode, ids, num_segments) for v, mode in requests]
    raise ValueError(f"unknown segment_reduce implementation {impl!r}")


def _segment(values, mode, ids, k):
    fn = {"sum": jax.ops.segment_sum, "count": jax.ops.segment_sum,
          "min": jax.ops.segment_min,
          "max": jax.ops.segment_max}[mode]
    return fn(values, ids, num_segments=k)


def _kernel(ids_ref, *refs, n: int, steps: int, modes, inits):
    nreq = len(modes)
    v_refs, o_refs = refs[:nreq], refs[nreq:]
    k = pl.program_id(1) * KC + jnp.arange(KC, dtype=jnp.int32)
    first = pl.program_id(0) * (steps * BLOCK)

    def body(i, accs):
        rows = first + i * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
        live = rows < n
        g = plgpu.load(ids_ref.at[rows], mask=live, other=-1)
        match = g[:, None] == k[None, :]
        new = []
        for v_ref, mode, init, acc in zip(v_refs, modes, inits, accs):
            v = plgpu.load(v_ref.at[rows], mask=live, other=init)
            sel = jnp.where(match, v[:, None], jnp.asarray(init, v.dtype))
            new.append(_combine(mode, acc, _reduce(mode, sel, 0)))
        return tuple(new)

    accs = tuple(jnp.full((KC,), init, o.dtype)
                 for init, o in zip(inits, o_refs))
    accs = jax.lax.fori_loop(0, steps, body, accs)
    for o_ref, acc in zip(o_refs, accs):
        o_ref[...] = acc


def _grid(n: int, k: int):
    """(row programs, block steps per program, segment chunks)."""
    chunks = -(-k // KC)
    blocks = max(-(-n // BLOCK), 1)
    programs = max(1, min(blocks, TARGET_PROGRAMS // chunks))
    steps = -(-blocks // programs)
    programs = -(-blocks // steps)
    return programs, steps, chunks


def _triton(requests, ids, k, interpret):
    n = ids.shape[0]
    programs, steps, chunks = _grid(n, k)
    modes = tuple(mode for _, mode in requests)
    inits = tuple(_init(mode, v.dtype) for v, mode in requests)
    dtypes = [v.dtype for v, _ in requests]
    # trace with x64 off: every operand is 32-bit, and the kernel's index
    # arithmetic must stay i32
    with jax.enable_x64(False):
        partials = pl.pallas_call(
            functools.partial(_kernel, n=n, steps=steps, modes=modes,
                              inits=inits),
            grid=(programs, chunks),
            out_specs=[pl.BlockSpec((None, KC), lambda p, c: (p, c))
                       for _ in requests],
            out_shape=[jax.ShapeDtypeStruct((programs, chunks * KC), dt)
                       for dt in dtypes],
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=2),
            backend="triton",
            interpret=interpret,
            name="segment_reduce",
        )(ids, *[v for v, _ in requests])
    return [_reduce(mode, part, 0)[:k]
            for part, (_, mode) in zip(partials, requests)]

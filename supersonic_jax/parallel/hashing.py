"""Device-side row hashing for partitioning.

The reference hash-partitions nothing itself (single machine) but documents
the pregroup->shuffle contract (aggregate.h:233-246) and uses per-type
hashers combined as ``h = h*29 + item`` with NULL -> 0xdeadbabe
(types_infrastructure.h:410-440).  We only need *some* deterministic
well-mixed hash — output equivalence does not require mirroring the
reference's hash values (SURVEY.md §1.1) — so we use 32-bit murmur-style
finalizers in 32-bit integer width.
"""
from __future__ import annotations

import jax.numpy as jnp


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 fmix32 over uint32."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _fold32(code: jnp.ndarray) -> jnp.ndarray:
    """Fold a key code (int or float) to uint32 deterministically."""
    import jax

    if jnp.issubdtype(code.dtype, jnp.floating):
        # No 64-bit bitcasts: split f64 into an f32 head + residual
        # (double-double style); equal doubles give equal words, and the
        # words capture the full mantissa for mixing.
        hi = code.astype(jnp.float32)
        if code.dtype == jnp.float64:
            lo = (code - hi.astype(jnp.float64)).astype(jnp.float32)
        else:
            lo = jnp.zeros_like(hi)
        hw = jax.lax.bitcast_convert_type(hi, jnp.int32).astype(jnp.uint32)
        lw = jax.lax.bitcast_convert_type(lo, jnp.int32).astype(jnp.uint32)
        return hw * jnp.uint32(31) + lw
    if code.dtype in (jnp.int64, jnp.uint64):
        u = code.astype(jnp.uint64)
        return (u ^ (u >> 32)).astype(jnp.uint32)
    return code.astype(jnp.uint32)


def combine_hash(codes: list[jnp.ndarray],
                 null_ranks: list[jnp.ndarray] | None = None) -> jnp.ndarray:
    """uint32 row hash over multiple key-code columns (NULL-aware).
    ``null_ranks`` entries may be None for non-nullable columns."""
    h = jnp.zeros(codes[0].shape[0], dtype=jnp.uint32)
    for i, c in enumerate(codes):
        term = _mix32(_fold32(c))
        if null_ranks is not None and null_ranks[i] is not None:
            # NULL contributes a fixed sentinel (reference: 0xdeadbabe)
            is_null = null_ranks[i] == 0  # ascending null-rank: 0 == NULL
            term = jnp.where(is_null, jnp.uint32(0xDEADBABE), term)
        h = h * jnp.uint32(29) + term
    return _mix32(h)


def hash_of_pairs(pairs) -> jnp.ndarray:
    """Row hash from group_code_columns' (null_rank_or_None, code) pairs."""
    return combine_hash([c for _, c in pairs], [nr for nr, _ in pairs])


def partition_of(h: jnp.ndarray, num_partitions: int) -> jnp.ndarray:
    return (h % jnp.uint32(num_partitions)).astype(jnp.int32)

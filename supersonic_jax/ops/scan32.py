"""Native-32-bit prefix scans.

Under the engine's global x64 mode ``jnp.cumsum`` silently promotes i32
operands to int64.  These helpers pin the dtype and, for large inputs,
run the scan as a within-tile lane scan plus a tile-total carry scan plus one broadcast add — the
same two-level structure as ``ops/aggregate._hier_cumsum`` but fully
materialized (exact in i32 whenever the true prefix values fit i32,
which holds for every count/indicator/offset scan in the engine).

Reference analogue: the selection-vector prefix counts and hash-table
offset arrays the C++ engine builds serially per view
(view_copier.cc, hash_join.cc) — here they are the glue between
vectorized operators and must not dominate them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_TILE = 512
_MIN_TWO_LEVEL = 1 << 16


def cumsum_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive i32 prefix sum of a 1-D array (values and all prefix
    sums must fit i32 — counts, indicators, bounded offsets)."""
    x = x.astype(jnp.int32)
    n = x.shape[0]
    if n < _MIN_TWO_LEVEL:
        return jnp.cumsum(x, dtype=jnp.int32)
    T = _TILE
    npad = -(-n // T) * T
    xp = jnp.concatenate([x, jnp.zeros(npad - n, jnp.int32)]) \
        if npad != n else x
    win = jnp.cumsum(xp.reshape(-1, T), axis=1, dtype=jnp.int32)
    ts = win[:, -1]
    carry = jnp.cumsum(ts, dtype=jnp.int32) - ts  # exclusive
    return (win + carry[:, None]).reshape(-1)[:n]


def cummax_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive i32 prefix max of a 1-D array."""
    x = x.astype(jnp.int32)
    n = x.shape[0]
    if n < _MIN_TWO_LEVEL:
        return jax.lax.cummax(x)
    T = _TILE
    npad = -(-n // T) * T
    if npad != n:
        xp = jnp.concatenate(
            [x, jnp.full(npad - n, jnp.iinfo(jnp.int32).min, jnp.int32)])
    else:
        xp = x
    win = jax.lax.cummax(xp.reshape(-1, T), axis=1)
    ts = win[:, -1]
    inc = jax.lax.cummax(ts)
    carry = jnp.concatenate(
        [jnp.full(1, jnp.iinfo(jnp.int32).min, jnp.int32), inc[:-1]])
    return jnp.maximum(win, carry[:, None]).reshape(-1)[:n]

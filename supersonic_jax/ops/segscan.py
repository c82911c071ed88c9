"""Segmented prefix scans over key-sorted rows.

The sort-based substitute for scatter-based segmented reduction: rows
sorted by group key form contiguous runs, so every per-group aggregate is
a segmented inclusive scan read off at each run's last row.

Implementation note: ``jax.lax.associative_scan`` produces log(n) levels
of odd/even slicing at irregular shapes.  Instead the scans here are a two-level
blocked Hillis-Steele over a fixed [B, T] layout: ~log2(T) vectorized
shift+combine passes within tiles, a tiny scan over the B tile carries,
and one broadcast combine — uniform shapes, plain pad/slice/where ops,
compiles in seconds and runs bandwidth-bound.

The segmented-monoid combine is the standard one:
  value[i] = r[i] ? value[i] : op(value[i-d], value[i])
  r[i]     = r[i] | r[i-d]
which is associative for op in {+, min, max, keep-left}.
"""
from __future__ import annotations

import jax.numpy as jnp

TILE = 2048


def _op(mode: str, a, b):
    if mode == "sum":
        return a + b
    if mode == "min":
        return jnp.minimum(a, b)
    if mode == "max":
        return jnp.maximum(a, b)
    if mode == "first":
        return a  # keep the left (earlier) value
    raise ValueError(mode)


def _identity(mode: str, dtype):
    if mode == "sum":
        return jnp.zeros((), dtype)
    if mode == "min":
        if jnp.issubdtype(dtype, jnp.floating):
            return jnp.array(jnp.inf, dtype)
        if dtype == jnp.bool_:
            return jnp.array(True, dtype)
        return jnp.array(jnp.iinfo(dtype).max, dtype)
    if mode == "max":
        if jnp.issubdtype(dtype, jnp.floating):
            return jnp.array(-jnp.inf, dtype)
        if dtype == jnp.bool_:
            return jnp.array(False, dtype)
        return jnp.array(jnp.iinfo(dtype).min, dtype)
    if mode == "first":
        return jnp.zeros((), dtype)  # never used (left side wins)
    raise ValueError(mode)


def _seg_scan(vals: jnp.ndarray, reset: jnp.ndarray, mode: str) -> jnp.ndarray:
    n = vals.shape[0]
    dtype = vals.dtype
    ident = _identity(mode, dtype)
    # the first element always starts a segment; this also makes the
    # identity-padded shifts safe for the 'first' (keep-left) monoid,
    # which has no left identity
    reset = reset.at[0].set(True) if n else reset
    T = min(TILE, max(1, n))
    n_pad = -(-n // T) * T
    if n_pad != n:
        vals = jnp.concatenate(
            [vals, jnp.full(n_pad - n, ident, dtype)])
        reset = jnp.concatenate(
            [reset, jnp.ones(n_pad - n, dtype=jnp.bool_)])
    B = n_pad // T
    v = vals.reshape(B, T)
    r = reset.reshape(B, T)
    # within-tile Hillis-Steele
    # Pads are identity elements: (ident, r=False). The 'first' monoid has
    # no left identity, but the forced reset[0]=True makes every position
    # whose shift window crosses the array/tile start already reset-
    # accumulated (tile prefixes are repaired by the carry combine below).
    d = 1
    while d < T:
        pv = jnp.pad(v, ((0, 0), (d, 0)), constant_values=ident)[:, :T]
        pr = jnp.pad(r, ((0, 0), (d, 0)), constant_values=False)[:, :T]
        v = jnp.where(r, v, _op(mode, pv, v))
        r = r | pr
        d *= 2
    # scan over tile carries (tiny: B elements)
    cv, cr = v[:, -1], r[:, -1]
    d = 1
    while d < B:
        pcv = jnp.concatenate([jnp.full(d, ident, dtype), cv[:-d]])
        pcr = jnp.concatenate([jnp.zeros(d, dtype=jnp.bool_), cr[:-d]])
        cv = jnp.where(cr, cv, _op(mode, pcv, cv))
        cr = cr | pcr
        d *= 2
    # exclusive carry into each tile (tile 0 gets identity)
    carry = jnp.concatenate([jnp.full(1, ident, dtype), cv[:-1]])
    out = jnp.where(r, v, _op(mode, carry[:, None], v))
    return out.reshape(n_pad)[:n]


def seg_cumsum(vals: jnp.ndarray, reset: jnp.ndarray) -> jnp.ndarray:
    """Inclusive segmented cumsum; segments restart where reset is True."""
    return _seg_scan(vals, reset, "sum")


def seg_cummin(vals: jnp.ndarray, reset: jnp.ndarray) -> jnp.ndarray:
    return _seg_scan(vals, reset, "min")


def seg_cummax(vals: jnp.ndarray, reset: jnp.ndarray) -> jnp.ndarray:
    return _seg_scan(vals, reset, "max")


def seg_carry_first(vals: jnp.ndarray, reset: jnp.ndarray) -> jnp.ndarray:
    """Forward-carry each segment's first value to every row of the run."""
    return _seg_scan(vals, reset, "first")

"""Blocked segmented-scan primitive tests (multi-tile sizes)."""
import numpy as np

from supersonic_jax.ops.segscan import (seg_carry_first, seg_cummax,
                                        seg_cummin, seg_cumsum)


def golden(vv, rr, op, init_from_first=True):
    out = []
    acc = None
    for i in range(len(vv)):
        if rr[i] or acc is None:
            acc = vv[i]
        else:
            acc = op(acc, vv[i])
        out.append(acc)
    return out


def make(n=10000, seed=0):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    v = rng.random(n)
    r = rng.random(n) < 0.002
    return jnp.asarray(v), jnp.asarray(r), v, r


def test_seg_cumsum_multi_tile():
    v, r, vv, rr = make()
    got = np.asarray(seg_cumsum(v, r))
    exp = golden(vv, rr, lambda a, b: a + b)
    assert np.allclose(got, exp)


def test_seg_cummin_cummax():
    v, r, vv, rr = make(seed=1)
    assert np.allclose(np.asarray(seg_cummin(v, r)),
                       golden(vv, rr, min))
    assert np.allclose(np.asarray(seg_cummax(v, r)),
                       golden(vv, rr, max))


def test_seg_carry_first():
    v, r, vv, rr = make(seed=2)
    got = np.asarray(seg_carry_first(v, r))
    exp = golden(vv, rr, lambda a, b: a)
    assert np.allclose(got, exp)


def test_tiny_and_exact_tile_sizes():
    import jax.numpy as jnp
    for n in (1, 5, 2048, 2049, 4096):
        v = jnp.asarray(np.arange(n, dtype=np.float64))
        r = jnp.asarray(np.zeros(n, dtype=bool))
        got = np.asarray(seg_cumsum(v, r))
        assert np.allclose(got, np.cumsum(np.arange(n)))

"""Compiled GPU kernels against their plain versions, on the card.

Marked ``gpu``: they skip without a GPU.  Run on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supersonic_jax.kernels import segment_reduce as sr

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("k", [1, 64, sr.KERNEL_MAX_SEGMENTS])
def test_triton_segment_reduce_matches_scatter(gpu, k):
    rng = np.random.default_rng(k)
    n = 1_000_003
    ids = jnp.asarray(rng.integers(-1, k + 1, n).astype(np.int32))
    vf = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    vi = jnp.asarray(rng.integers(-2**30, 2**30, n).astype(np.int32))
    reqs = [(vf, "sum"), (vi, "sum"), ((ids >= 0).astype(jnp.int32), "count"),
            (vf, "min"), (vf, "max"), (vi, "min"), (vi, "max")]
    assert sr.implementation(gpu.platform, k) == "triton"
    got = jax.jit(lambda: sr.segment_reduce_multi(reqs, ids, k))()
    want = sr.segment_reduce_multi(reqs, ids, k, impl="segment")
    bound = 1e-5 * np.asarray(sr.segment_reduce_multi(
        [(jnp.abs(vf), "sum")], ids, k, impl="segment")[0]) + 1e-30
    for (v, mode), g, w in zip(reqs, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if mode == "sum" and v.dtype == jnp.float32:
            assert np.all(np.abs(g.astype(np.float64) - w) <= bound)
        else:
            np.testing.assert_array_equal(g, w)


def test_triton_segment_reduce_is_deterministic(gpu):
    rng = np.random.default_rng(5)
    n = 2_000_000
    ids = jnp.asarray(rng.integers(0, 64, n).astype(np.int32))
    v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    f = jax.jit(lambda: sr.segment_reduce_multi([(v, "sum")], ids, 64)[0])
    first = np.asarray(f())
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(f()), first)

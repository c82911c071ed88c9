"""kernels/segment_reduce.py: the fused segmented-reduce contract against
numpy, the choice of implementation, and the dense group-by built on it."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supersonic_jax.kernels import segment_reduce as sr

MODES = [("sum", np.float32), ("sum", np.int32), ("min", np.float32),
         ("min", np.int32), ("max", np.float32), ("max", np.int32),
         ("count", np.int32)]


def np_reduce(values, mode, ids, k):
    """Row-at-a-time reference; sums in float64 / wrapped int32."""
    if values.dtype == np.float32:
        ident = {"sum": 0.0, "count": 0.0, "min": np.inf,
                 "max": -np.inf}[mode]
        out = np.full(k, ident, np.float64)
    else:
        ident = {"sum": 0, "count": 0, "min": np.iinfo(np.int32).max,
                 "max": np.iinfo(np.int32).min}[mode]
        out = np.full(k, ident, np.int64)
    for i, v in zip(ids.tolist(), values.tolist()):
        if 0 <= i < k:
            if mode in ("sum", "count"):
                out[i] += v
            elif mode == "min":
                out[i] = min(out[i], v)
            else:
                out[i] = max(out[i], v)
    if values.dtype == np.int32:
        out = (out + 2**31) % 2**32 - 2**31
    return out


def make_values(rng, mode, dtype, n):
    if mode == "count":
        return rng.integers(0, 2, n).astype(np.int32)
    if dtype == np.float32:
        v = rng.standard_normal(n).astype(np.float32)
        v[rng.random(n) < 0.1] = -0.0
        return v
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def assert_matches(got, want, values, mode, ids, k):
    got = np.asarray(got)
    assert got.shape == (k,) and got.dtype == values.dtype
    if mode == "sum" and values.dtype == np.float32:
        # f32 sums accumulate in another order than the reference
        bound = 1e-5 * np_reduce(np.abs(values), "sum", ids, k) + 1e-30
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    else:
        np.testing.assert_array_equal(got, want.astype(values.dtype))


@pytest.mark.parametrize("impl", [None, "triton"],
                         ids=["default", "triton_interpret"])
@pytest.mark.parametrize("n", [1, sr.BLOCK - 1, 3 * sr.BLOCK + 7])
@pytest.mark.parametrize("k", [1, 64, 1000, 2048])
@pytest.mark.parametrize("mode,dtype", MODES)
def test_contract_against_numpy(mode, dtype, k, n, impl):
    rng = np.random.default_rng(k * 7919 + n)
    ids = rng.integers(-2, k + 2, n).astype(np.int32)  # some out of range
    values = make_values(rng, mode, dtype, n)
    (got,) = jax.jit(lambda v, i: sr.segment_reduce_multi(
        [(v, mode)], i, k, impl=impl, interpret=True))(
            jnp.asarray(values), jnp.asarray(ids))
    assert_matches(got, np_reduce(values, mode, ids, k), values, mode, ids,
                   k)


@pytest.mark.parametrize("impl", sr.IMPLS)
@pytest.mark.parametrize("k", [3, 130])
def test_fused_requests_every_impl(impl, k):
    """All modes in one fused call; the Triton kernel in interpret mode."""
    rng = np.random.default_rng(k)
    n = 2 * sr.BLOCK + 5
    ids = rng.integers(-1, k + 1, n).astype(np.int32)
    reqs = [(make_values(rng, m, dt, n), m) for m, dt in MODES]
    outs = sr.segment_reduce_multi(
        [(jnp.asarray(v), m) for v, m in reqs], jnp.asarray(ids), k,
        impl=impl, interpret=True)
    assert len(outs) == len(reqs)
    for (v, m), got in zip(reqs, outs):
        assert_matches(got, np_reduce(v, m, ids, k), v, m, ids, k)


def test_empty_input_gives_identities():
    ids = jnp.zeros(0, jnp.int32)
    outs = sr.segment_reduce_multi(
        [(jnp.zeros(0, jnp.float32), "min"), (jnp.zeros(0, jnp.int32), "sum")],
        ids, 5)
    assert np.all(np.asarray(outs[0]) == np.inf)
    assert np.asarray(outs[1]).tolist() == [0] * 5


@pytest.mark.parametrize("k", [1, 64, sr.KERNEL_MAX_SEGMENTS])
def test_gpu_small_domains_take_the_kernel(k):
    assert sr.implementation("gpu", k) == "triton"


@pytest.mark.parametrize("platform,k", [
    ("gpu", sr.KERNEL_MAX_SEGMENTS + 1), ("gpu", sr.MAX_SEGMENTS),
    ("cpu", 1), ("cpu", 64), ("rocm", 64)])
def test_other_cases_take_the_scatter_form(platform, k):
    assert sr.implementation(platform, k) == "segment"


def test_default_impl_follows_backend(monkeypatch):
    seen = []
    monkeypatch.setattr(sr, "implementation",
                        lambda platform, k: seen.append((platform, k))
                        or "segment")
    sr.segment_reduce_multi([(jnp.ones(4, jnp.int32), "count")],
                            jnp.zeros(4, jnp.int32), 2)
    assert seen == [(jax.default_backend(), 2)]


def test_rejects_unsupported_requests():
    ids = jnp.zeros(4, jnp.int32)
    with pytest.raises(AssertionError):
        sr.segment_reduce_multi([(jnp.ones(4, jnp.float64), "sum")], ids, 2)
    with pytest.raises(AssertionError):
        sr.segment_reduce_multi([(jnp.ones(4, jnp.int32), "mean")], ids, 2)
    with pytest.raises(AssertionError):
        sr.segment_reduce_multi([(jnp.ones(4, jnp.int32), "count")], ids,
                                sr.MAX_SEGMENTS + 1)
    with pytest.raises(ValueError):
        sr.segment_reduce_multi([(jnp.ones(4, jnp.int32), "count")], ids, 2,
                                impl="bogus")


@pytest.mark.parametrize("n,k", [(1, 1), (sr.BLOCK, 1), (10**6, 64),
                                 (10**6, 2048), (8 * 10**6, 2048)])
def test_kernel_grid_covers_rows(n, k):
    programs, steps, chunks = sr._grid(n, k)
    assert chunks * sr.KC >= k
    assert programs * steps * sr.BLOCK >= n
    assert (programs - 1) * steps * sr.BLOCK < max(n, 1)

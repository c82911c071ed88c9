"""ops/scan32: pinned-i32 two-level prefix scans (x64 mode would
promote a plain jnp.cumsum of i32 to int64)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from supersonic_jax.ops.scan32 import cummax_i32, cumsum_i32


@pytest.mark.parametrize("n", [0, 1, 7, 511, 512, 513, 1 << 16,
                               (1 << 16) + 300, (1 << 17) + 511])
def test_cumsum_matches_numpy(n):
    rng = np.random.default_rng(n or 1)
    x = rng.integers(-5, 9, n).astype(np.int32)
    got = np.asarray(cumsum_i32(jnp.asarray(x)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.int64)
                                  .astype(np.int32))


@pytest.mark.parametrize("n", [1, 513, 1 << 16, (1 << 16) + 77])
def test_cummax_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-(10**9), 10**9, n).astype(np.int32)
    got = np.asarray(cummax_i32(jnp.asarray(x)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))


def test_bool_and_i64_inputs_cast():
    m = jnp.asarray(np.array([True, False, True, True]))
    np.testing.assert_array_equal(np.asarray(cumsum_i32(m)), [1, 1, 2, 3])
    big = jnp.asarray(np.arange(5, dtype=np.int64))
    np.testing.assert_array_equal(np.asarray(cumsum_i32(big)),
                                  [0, 1, 3, 6, 10])

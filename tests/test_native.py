"""Native C++ fastcol kernels (dictionary encoder) vs python fallback."""
import numpy as np
import pytest

from supersonic_jax import native
from supersonic_jax.dictionary import Dictionary, encode


def test_native_builds():
    assert native.available(), "g++ build of libfastcol.so failed"


def test_native_encode_matches_python():
    rng = np.random.default_rng(0)
    vocab = [f"word{i:04d}" for i in range(300)]
    values = [vocab[i] if i % 17 else None
              for i in rng.integers(0, 300, 10000)]
    codes, valid, d = encode(values)  # >= 4096 -> native path
    # pure-python reference
    present = sorted({v for v in values if v is not None})
    assert list(d.values) == present
    index = {v: i for i, v in enumerate(present)}
    for i, v in enumerate(values):
        if v is None:
            assert not valid[i]
        else:
            assert codes[i] == index[v]


def test_native_encode_bytes():
    values = [b"b", b"a", None, b"b"] * 2000
    codes, valid, d = encode(values)
    assert list(d.values) == [b"a", b"b"]
    assert codes[0] == 1 and codes[1] == 0 and not valid[2]

"""bench/device.py: compile-cache location, the GPU requirement and the
timing helper."""
from __future__ import annotations

import jax
import pytest

from supersonic_jax.bench import device


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.configure_compile_cache()
    assert path == str(device.CHECKOUT / ".jax_cache")
    assert (device.CHECKOUT / "supersonic_jax").is_dir()
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_follows_environment(monkeypatch, cache_config, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_path_is_stable(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.configure_compile_cache() == \
        device.configure_compile_cache()


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_median_seconds_runs_warm_calls():
    calls = []

    def fn(x):
        calls.append(x)
        return jax.numpy.asarray(x)

    secs = device.median_seconds(fn, 3, reps=5)
    assert secs >= 0
    assert len(calls) == 6

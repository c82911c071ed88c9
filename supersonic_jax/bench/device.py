"""Device, compile-cache and timing helpers shared by the GPU scripts
(``chip_smoke.py``, ``bench.py``, ``bench_ops.py``, ``bench_dist.py``).

A measurement path that finds no GPU fails; it never falls back to the
CPU.  Every number a script prints is labelled with the card it ran on
(``card_line``).
"""
from __future__ import annotations

import os
import pathlib
import statistics
import subprocess
import time

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def configure_compile_cache() -> str:
    """Persistent XLA compile cache: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it itself and nothing else is configured here), else
    ``<checkout>/.jax_cache``.  The path is fixed, because it is part of
    the cache key.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first device, or SystemExit(2) when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_seconds(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``reps`` warm calls of ``fn(*args)``, each
    ended by ``block_until_ready`` (one untimed call first)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)

"""Test configuration: CPU backend with 8 virtual devices.

Mirrors the reference's test-without-cluster strategy (SURVEY.md §4.6):
shard_map/collective tests run on an emulated multi-device CPU mesh.
Must set env vars BEFORE jax import.  ``JAX_PLATFORMS=cuda`` selects the
GPU instead, for the tests marked ``gpu`` (see the ``gpu`` fixture).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Deterministic *Local date semantics: the engine binds them against the
# TZ env var (exprs/tz.py); tests that want another zone set it
# explicitly via set_local_timezone.
os.environ["TZ"] = "UTC"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first device when it is a GPU; the test skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu)")
    return dev

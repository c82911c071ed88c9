"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusal to
run without a GPU."""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

TINY = dict(
    kernel_rows=3000, kernel_segments=(64, 130),
    fact=20_000, dim=3000,
    route_rows=5000, join_probe=3000, join_keys=500, join_dup=4,
    merge_child=4000, string_rows=3000,
    scale_probe=30_000, scale_build=2000,
    dist_fact=8192, dist_dim=1024,
)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_rejects_other_chip_counts():
    r = _run([str(ROOT / "chip_smoke.py"), "--chips", "2"], ROOT)
    assert r.returncode != 0


def test_phase_kernels_interpret(smoke):
    smoke.phase_kernels(TINY, np.random.default_rng(0), interpret=True)


def test_phase_headline(smoke):
    smoke.phase_headline(TINY, np.random.default_rng(0))


@pytest.mark.parametrize("route", ["route_filter", "route_joins",
                                   "route_merge", "route_strings"])
def test_phase_routes(smoke, route):
    getattr(smoke, route)(TINY, np.random.default_rng(0))


def test_phase_scale(smoke):
    smoke.phase_scale(TINY, np.random.default_rng(0))


def test_phase_distributed_on_four_devices(smoke):
    smoke.phase_distributed(TINY, 4)


def test_np_segment_reduce_identities(smoke):
    ids = np.array([0, 0, 2, -1, 5], np.int32)
    vals = np.array([3, 1, 7, 9, 9], np.int32)
    assert smoke.np_segment_reduce(vals, "min", ids, 3).tolist() == \
        [1, np.iinfo(np.int32).max, 7]
    assert smoke.np_segment_reduce(vals, "sum", ids, 3).tolist() == [4, 0, 7]


def test_np_join_order(smoke):
    li, ri = smoke._np_join(np.array([2, 9, 2], np.int32),
                            np.array([2, 5, 2], np.int32), left_outer=True)
    assert li.tolist() == [0, 0, 1, 2, 2]
    assert ri.tolist() == [0, 2, -1, 0, 2]


def test_last_line_contract(smoke, monkeypatch, capsys):
    """main() ends with the one JSON object; the phases are stubbed."""
    import jax

    class Dev:
        platform, device_kind = "gpu", "stub"

    from supersonic_jax.bench import device
    monkeypatch.setattr(device, "require_gpu", lambda: Dev())
    monkeypatch.setattr(device, "configure_compile_cache", lambda: "x")
    for name in ("phase_device", "phase_golden"):
        monkeypatch.setattr(smoke, name, lambda *a: None)
    for name in ("phase_kernels", "phase_headline", "phase_routes",
                 "phase_scale"):
        monkeypatch.setattr(smoke, name, lambda *a, **k: None)
    assert smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "stub", "count": len(jax.devices())}}

"""Execute the multi-host layer for real: two OS processes join via
``jax.distributed.initialize`` over localhost (CPU backend, 4 virtual
devices each) and run a distributed group-aggregate over the resulting
8-device global mesh (multihost.py is exercised, not just imported).

Reference analogue: none (the reference is single-process); this tests
the new framework's own deployment contract (parallel/multihost.py).
"""
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_aggregate():
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # worker sets platform itself
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=os.path.dirname(HERE))
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=540)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-host workers timed out")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
    if any("MULTIHOST_UNSUPPORTED" in out for _, out, _ in outs):
        pytest.skip("multi-process jax runtime unsupported here: "
                    + outs[0][1].strip())
    oks = [line for _, out, _ in outs for line in out.splitlines()
           if line.startswith("MULTIHOST_OK")]
    assert len(oks) == 2, outs
    # both processes computed the same replicated checksum
    assert oks[0] == oks[1]

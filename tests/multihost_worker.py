"""Worker for the 2-process multi-host test (run by test_multihost.py).

Usage: python multihost_worker.py <coordinator_port> <process_id>

Each process drives supersonic_jax.parallel.multihost end-to-end on the
CPU backend: ``initialize`` (jax.distributed handshake over localhost) ->
``global_mesh`` spanning both processes' virtual devices ->
``dist_group_aggregate`` over a table distributed across the global mesh.
Prints "MULTIHOST_OK <checksum>" on success; prints "MULTIHOST_UNSUPPORTED
<reason>" when the backend cannot form the multi-process runtime (the
test skips in that case).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

port, pid = sys.argv[1], int(sys.argv[2])
# 4 virtual devices per process (drop any inherited device-count flag,
# e.g. the test conftest's 8 — last occurrence would win)
_inherited = [f for f in os.environ.get("XLA_FLAGS", "").split()
              if "xla_force_host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    _inherited + ["--xla_force_host_platform_device_count=4"])

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

try:
    from supersonic_jax.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=2, process_id=pid)
except Exception as e:  # pragma: no cover - environment-dependent
    print(f"MULTIHOST_UNSUPPORTED initialize: {e!r}")
    sys.exit(0)

if not multihost.is_multihost() or len(jax.devices()) != 8:
    print(f"MULTIHOST_UNSUPPORTED devices={len(jax.devices())} "
          f"processes={jax.process_count()}")
    sys.exit(0)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supersonic_jax import (AggSpec, Aggregation, DataType, Table,  # noqa: E402
                            TupleSchema)
from supersonic_jax.parallel import (dist_group_aggregate,  # noqa: E402
                                     distribute_table)

mesh = multihost.global_mesh()
assert mesh.devices.size == 8

rng = np.random.default_rng(0)  # same data in every process
n = 256
g = rng.integers(0, 10, n)
v = rng.integers(0, 100, n)
fact = Table.from_data(
    TupleSchema.of(("g", DataType.INT64, False),
                   ("v", DataType.INT64, False)),
    {"g": g, "v": v})

dist = distribute_table(fact, mesh)


@jax.jit
def step(d: Table):
    t = dist_group_aggregate(mesh, d, ["g"],
                             [AggSpec(Aggregation.SUM, "v", "sv")])
    # distributed layout: leaves are [P, cap], num_rows is int32[P]
    sv_all = t.columns["sv"].values
    g_all = t.columns["g"].values
    cap = sv_all.shape[1]
    mask = jnp.arange(cap, dtype=jnp.int32)[None, :] < t.num_rows[:, None]
    # order-insensitive over groups: sum of g*sv across live rows
    sv = jnp.where(mask, sv_all, 0)
    gg = jnp.where(mask, g_all, 0)
    return jnp.sum(gg * sv), jnp.sum(t.num_rows)


got_cs, got_groups = jax.device_get(step(dist))

want = {}
for gi, vi in zip(g, v):
    want[int(gi)] = want.get(int(gi), 0) + int(vi)
want_cs = sum(k * s for k, s in want.items())

assert int(got_groups) == len(want), (got_groups, len(want))
assert int(got_cs) == want_cs, (got_cs, want_cs)
print(f"MULTIHOST_OK {int(got_cs)}")

"""Multi-host runtime initialization (production deployment).

The single-controller path (`make_mesh`) covers one host with N chips.
On a multi-host cluster each host runs this module's ``initialize``
first (jax.distributed handshake over DCN), after which ``jax.devices()``
spans the whole cluster and every ``parallel/`` primitive — distributed
tables, all_to_all shuffle, dist_* operators — works unchanged: XLA
routes the collectives between the hosts (SURVEY.md §5.8).
"""
from __future__ import annotations

from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-host runtime.  Pass the coordinator address,
    process count and this process's id; a cluster without
    auto-detection needs all three."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multihost() -> bool:
    return jax.process_count() > 1


def global_mesh(n_devices: Optional[int] = None):
    """Mesh over every chip in the slice (call after initialize())."""
    from .dist import make_mesh

    return make_mesh(n_devices)

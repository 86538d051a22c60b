"""Multi-host initialization + serving-mesh helpers.

Across hosts each process runs the same program;
``jax.distributed.initialize()`` wires them together and ``jax.devices()``
then spans every host's cards. The search programs in
`vaq_tpu.parallel.sharded` are already global-SPMD (shard_map over named
axes), so multi-host is a mesh-construction concern only:

* ``"db"`` (database rows) spans the cards of one host — they are joined all
  to all by NVLink, which carries the k-row top-k merge all_gather;
* ``"q"`` (query data parallelism) maps to the host dimension — query
  ingest/result egress is per-host, and no hot-path collective crosses hosts.

Single-process runs exercise the identical code via
``xla_force_host_platform_device_count`` virtual meshes (tests/conftest.py)
and ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX.

    With a ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` are required and any failure raises: a process that was
    told to join a cluster must not serve alone. Without one, JAX's own
    cluster detection is tried, and a plain single-process run (nothing
    detected) stays a no-op.
    """
    if jax.process_count() > 1:
        return  # already initialized
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError):
        # no cluster environment detected: single-process run
        pass


def pod_mesh(q_hosts: bool = True) -> Tuple[Mesh, Optional[str]]:
    """Build the serving mesh for the current topology.

    With q_hosts=True across hosts: ("q", "db") with q = host count, db =
    devices per host. Otherwise a flat ("db",) mesh over all global
    devices.
    Returns (mesh, q_axis) suitable for ``VAQIndex.shard``.
    """
    devs = jax.devices()
    nproc = jax.process_count()
    if q_hosts and nproc > 1 and len(devs) % nproc == 0:
        arr = np.asarray(devs).reshape(nproc, len(devs) // nproc)
        return Mesh(arr, ("q", "db")), "q"
    return Mesh(np.asarray(devs), ("db",)), None

"""Device-mesh construction helpers.

Axis convention:
  * ``"db"`` — database rows (the scale axis of this workload: encoded code
    rows are sharded along it; the per-shard top-k merge collective rides it).
  * ``"q"``  — query batch (data parallel): optional second axis for
    multi-host serving where each host takes a slice of the query stream.

The cards of one host are joined all to all by NVLink, so any device order
serves equally: the mesh shape follows the algorithm alone. Across hosts,
``jax.distributed.initialize()`` runs first on each host and the mesh spans
all global devices (see ``multihost.pod_mesh``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("db",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the available devices.

    With no arguments, all devices go to a 1-D "db" mesh. Pass
    ``shape=(q, db)`` + ``axis_names=("q", "db")`` for 2-D query×database
    sharding.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    devs = np.asarray(devices)[: int(np.prod(shape))].reshape(shape)
    return Mesh(devs, axis_names=tuple(axis_names))

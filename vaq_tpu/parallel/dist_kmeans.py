"""Distributed k-means: Lloyd iterations over row-sharded data.

The multi-device training step of the framework. Training data rows are
sharded over the "db" mesh axis; each Lloyd iteration computes local
per-cluster sums/counts (matmuls) and reduces them with a single
``psum`` over the axis — the collective counterpart of the reference's
OpenMP private-accumulate + ordered-merge k-means (``KMeans.hpp:562-595``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P


@functools.partial(jax.jit, static_argnames=("iters", "mesh", "db_axis"))
def lloyd_sharded(
    x: jnp.ndarray,
    init_centroids: jnp.ndarray,
    n_total: jnp.ndarray,
    iters: int,
    mesh: Mesh,
    db_axis: str = "db",
) -> jnp.ndarray:
    """Run Lloyd iterations with rows sharded P(db_axis, None).

    Args:
      x: (n_pad, d) sharded training rows (pad rows past n_total ignored).
      init_centroids: (k, d) replicated initial centroids.
      n_total: scalar true row count.
    Returns: (k, d) centroids (replicated).
    """
    n_pad = x.shape[0]
    shard_rows = n_pad // mesh.shape[db_axis]
    k = init_centroids.shape[0]

    def local(x_l, c0, n_total_l):
        sidx = jax.lax.axis_index(db_axis)
        base = sidx * shard_rows
        valid = (base + jnp.arange(shard_rows)) < n_total_l

        def step(c, _):
            xn = jnp.sum(x_l * x_l, axis=1, keepdims=True)
            cn = jnp.sum(c * c, axis=1)
            d2 = xn - 2.0 * jnp.dot(x_l, c.T,
                                    preferred_element_type=jnp.float32) + cn
            assign = jnp.argmin(d2, axis=1)
            onehot = jax.nn.one_hot(assign, k, dtype=x_l.dtype) * valid[:, None]
            sums = jnp.dot(onehot.T, x_l, preferred_element_type=jnp.float32)
            counts = jnp.sum(onehot, axis=0)
            # The one collective per iteration: global reduce of (k, d) + (k,).
            sums = jax.lax.psum(sums, db_axis)
            counts = jax.lax.psum(counts, db_axis)
            new_c = sums / jnp.maximum(counts[:, None], 1.0)
            return jnp.where(counts[:, None] > 0, new_c, c), None

        final, _ = jax.lax.scan(step, c0, None, length=iters)
        return final

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(db_axis, None), P(None, None), P()),
        out_specs=P(None, None),
        check_vma=False,
    )(x, init_centroids, n_total)


def shard_rows_for(mesh: Mesh, x: jnp.ndarray, db_axis: str = "db") -> jnp.ndarray:
    """Pad + place rows sharded over the db axis."""
    n = x.shape[0]
    nshards = mesh.shape[db_axis]
    pad = (-n) % nshards
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return jax.device_put(x, NamedSharding(mesh, P(db_axis, None)))

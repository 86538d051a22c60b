"""K-means as batched Lloyd iterations of matmuls.

Replaces the reference's k-means family (``bitvecengine/KMeans.hpp:42-857``,
10 OpenMP/Eigen variants, plus the Armadillo ``arma::kmeans`` calls inside
``VAQ::train``, VAQ.cpp:526-661). This design collapses them into one
Lloyd iteration expressed as:

    assignment:  argmin_c ( ||x||² − 2·x·Cᵀ + ||c||² )      — one matmul
    update:      C ← (onehot(assign)ᵀ · X) / counts          — one matmul

run under ``lax.scan`` for a fixed iteration count (the reference uses 25,
VAQ.cpp:556/618). Inits:

* ``"subset"``  — k distinct random rows (arma's ``static_subset``).
* ``"kmeans++"`` — D² sampling (KMeans.hpp:303-328).

Empty clusters keep their previous centroid (arma behavior). A chunked
assignment path (``lax.map`` over row blocks) bounds the n×k distance matrix
for large n·k, and a mini-batch variant covers the reference's fastFit
(KMeans.hpp:194-287).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _pairwise_sq_dists(x: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """(n, d) × (k, d) → (n, k) squared L2 distances via the matmul identity."""
    xn = jnp.sum(x * x, axis=1, keepdims=True)
    cn = jnp.sum(c * c, axis=1)
    return xn - 2.0 * jnp.dot(x, c.T, preferred_element_type=jnp.float32) + cn[None, :]


def assign_clusters(x: jnp.ndarray, centroids: jnp.ndarray,
                    block_rows: int = 65536) -> jnp.ndarray:
    """argmin assignment, chunked over rows to bound the (n, k) matrix."""
    n = x.shape[0]
    block_rows = max(256, min(block_rows,
                              (1 << 24) // max(centroids.shape[0], 1)))
    if n <= block_rows:
        return jnp.argmin(_pairwise_sq_dists(x, centroids), axis=1)
    pad = (-n) % block_rows
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    blocks = xp.reshape(-1, block_rows, x.shape[1])
    out = jax.lax.map(
        lambda b: jnp.argmin(_pairwise_sq_dists(b, centroids), axis=1), blocks
    )
    return out.reshape(-1)[:n]


def _lloyd_step(x: jnp.ndarray, centroids: jnp.ndarray) -> jnp.ndarray:
    k = centroids.shape[0]
    assign = jnp.argmin(_pairwise_sq_dists(x, centroids), axis=1)
    onehot = jax.nn.one_hot(assign, k, dtype=x.dtype)          # (n, k)
    sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32)
    counts = jnp.sum(onehot, axis=0)[:, None]
    new_c = sums / jnp.maximum(counts, 1.0)
    # Empty clusters keep the previous centroid.
    return jnp.where(counts > 0, new_c, centroids)


def _lloyd_step_chunked(x: jnp.ndarray, centroids: jnp.ndarray,
                        block_rows: int) -> jnp.ndarray:
    """Lloyd step with blocked accumulation of per-cluster sums/counts."""
    k, d = centroids.shape
    n = x.shape[0]
    pad = (-n) % block_rows
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    valid = jnp.arange(n + pad) < n
    blocks = xp.reshape(-1, block_rows, d)
    vblocks = valid.reshape(-1, block_rows)

    def body(carry, blk):
        sums, counts = carry
        xb, vb = blk
        assign = jnp.argmin(_pairwise_sq_dists(xb, centroids), axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=xb.dtype) * vb[:, None]
        sums = sums + jnp.dot(onehot.T, xb, preferred_element_type=jnp.float32)
        counts = counts + jnp.sum(onehot, axis=0)
        return (sums, counts), None

    init = (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32))
    (sums, counts), _ = jax.lax.scan(body, init, (blocks, vblocks))
    new_c = sums / jnp.maximum(counts[:, None], 1.0)
    return jnp.where(counts[:, None] > 0, new_c, centroids)


@functools.partial(jax.jit, static_argnames=("iters", "block_rows"))
def lloyd(x: jnp.ndarray, init_centroids: jnp.ndarray, iters: int = 25,
          block_rows: int = 65536) -> jnp.ndarray:
    """Run `iters` Lloyd iterations from the given initial centroids."""
    n = x.shape[0]
    k = init_centroids.shape[0]
    small = n * k <= (1 << 24)
    # Bound the (block, k) distance matrix to ~2^24 elements (64 MB f32) so
    # large-k codebooks (13-bit subspaces → k=8192) stay in memory budget.
    block_rows = max(256, min(block_rows, (1 << 24) // max(k, 1)))

    def body(c, _):
        if small:
            return _lloyd_step(x, c), None
        return _lloyd_step_chunked(x, c, block_rows), None

    final, _ = jax.lax.scan(body, init_centroids, None, length=iters)
    return final


@functools.partial(jax.jit, static_argnames=("iters",))
def _lloyd_many(xs: jnp.ndarray, c0: jnp.ndarray, iters: int) -> jnp.ndarray:
    """vmapped Lloyd over a leading group axis: (G, n, d) × (G, k, d)."""

    def one(x, c_init):
        def body(c, _):
            return _lloyd_step(x, c), None

        final, _ = jax.lax.scan(body, c_init, None, length=iters)
        return final

    return jax.vmap(one)(xs, c0)


def fit_many(xs, k: int, iters: int = 25, seed: int = 13517106,
             ) -> np.ndarray:
    """Fit G independent k-means problems of identical shape in ONE device
    program: xs (G, n, d) → centroids (G, k, d).

    This is the batched trainer for per-subspace codebooks (VAQ trains one
    k-means per subspace, VAQ.cpp:526-661) — a single dispatch instead of a
    host loop, which matters when dispatch latency is non-trivial.
    """
    xs = jnp.asarray(xs, dtype=jnp.float32)
    g, n, d = xs.shape
    rng = np.random.default_rng(seed)
    init_idx = np.stack([
        rng.choice(n, size=k, replace=False) if n >= k
        else rng.choice(n, size=k, replace=True)
        for _ in range(g)
    ]).astype(np.int32)
    c0 = jax.vmap(lambda x, idx: x[idx])(xs, jnp.asarray(init_idx))
    return np.asarray(_lloyd_many(xs, c0, iters))


def init_subset(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k distinct random rows (arma static_subset)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    if n >= k:
        idx = rng.choice(n, size=k, replace=False)
    else:
        idx = rng.choice(n, size=k, replace=True)
    return np.asarray(x)[idx].astype(np.float32)


def init_kmeanspp(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k-means++ D² seeding (reference KMeans.hpp:303-328)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    centroids = np.empty((k, x.shape[1]), dtype=np.float32)
    centroids[0] = x[rng.integers(n)]
    d2 = np.sum((x - centroids[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-30)
        centroids[i] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((x - centroids[i]) ** 2, axis=1))
    return centroids


def fit(x, k: int, iters: int = 25, init: str = "subset",
        seed: int = 13517106, block_rows: int = 65536) -> Tuple[np.ndarray, np.ndarray]:
    """Train k-means; returns (centroids (k,d) f32, assignments (n,) i32).

    The one entry point covering the reference's fit/fitParallel/staticFit*
    family — parallelism comes from XLA, not thread variants.
    """
    x = np.asarray(x, dtype=np.float32)
    if init == "kmeans++":
        c0 = init_kmeanspp(x, k, seed)
    else:
        c0 = init_subset(x, k, seed)
    xd = jnp.asarray(x)
    centroids = lloyd(xd, jnp.asarray(c0), iters=iters, block_rows=block_rows)
    assignments = assign_clusters(xd, centroids, block_rows=block_rows)
    return np.asarray(centroids), np.asarray(assignments)


def fit_minibatch(x, k: int, iters: int = 25, batch_size: int = 4096,
                  seed: int = 13517106) -> Tuple[np.ndarray, np.ndarray]:
    """Mini-batch k-means (reference fastFit/staticFastFit, KMeans.hpp:194/654):
    per batch, assign then move centroids toward batch means with a per-center
    learning rate 1/count."""
    x = np.asarray(x, dtype=np.float32)
    rng = np.random.default_rng(seed)
    centroids = jnp.asarray(init_subset(x, k, seed))
    counts = jnp.zeros((k,), jnp.float32)

    @jax.jit
    def step(centroids, counts, batch):
        assign = jnp.argmin(_pairwise_sq_dists(batch, centroids), axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=batch.dtype)
        bcounts = jnp.sum(onehot, axis=0)
        counts = counts + bcounts
        lr = jnp.where(counts > 0, 1.0 / jnp.maximum(counts, 1.0), 0.0)
        bsums = jnp.dot(onehot.T, batch, preferred_element_type=jnp.float32)
        bmean = bsums / jnp.maximum(bcounts[:, None], 1.0)
        delta = (bmean - centroids) * (bcounts[:, None] > 0) * lr[:, None] * bcounts[:, None]
        return centroids + delta, counts

    for _ in range(iters):
        idx = rng.integers(0, x.shape[0], size=batch_size)
        centroids, counts = step(centroids, counts, jnp.asarray(x[idx]))
    assignments = assign_clusters(jnp.asarray(x), centroids)
    return np.asarray(centroids), np.asarray(assignments)


def hierarchical_fit(x, bits: int, iters: int = 25, seed: int = 13517106,
                     coarse_bits: int = 7) -> np.ndarray:
    """Two-level k-means for >8-bit codebooks (reference VAQ.cpp:546-607):
    2^coarse_bits coarse clusters, then a sub-k-means of 2^(bits-coarse_bits)
    centroids inside each coarse member set."""
    x = np.asarray(x, dtype=np.float32)
    k_coarse = 1 << coarse_bits
    k_sub = 1 << (bits - coarse_bits)
    coarse, assign = fit(x, k_coarse, iters=iters, seed=seed)
    out = np.empty((k_coarse * k_sub, x.shape[1]), dtype=np.float32)
    # One STATIC sub-fit shape: member sets are sampled (or resampled with
    # repetition) to exactly S rows, so the jitted Lloyd program compiles
    # ONCE instead of once per coarse cluster (2^coarse_bits distinct
    # member shapes would each compile). Repeated rows merely re-weight
    # points; 256·k_sub follows the sampling rule of VAQ.cpp:535-544.
    s_fit = int(min(x.shape[0], 256 * k_sub))
    rng = np.random.default_rng(seed)
    for i in range(k_coarse):
        members = x[assign == i]
        if members.shape[0] == 0:
            # Degenerate coarse cluster: reuse the coarse centroid.
            out[i * k_sub:(i + 1) * k_sub] = coarse[i]
            continue
        if members.shape[0] <= k_sub:
            reps = np.resize(members, (k_sub, x.shape[1]))
            out[i * k_sub:(i + 1) * k_sub] = reps
            continue
        if members.shape[0] > s_fit:
            members = members[rng.choice(members.shape[0], s_fit,
                                         replace=False)]
        elif members.shape[0] < s_fit:
            members = members[rng.integers(0, members.shape[0], s_fit)]
        sub, _ = fit(members, k_sub, iters=iters, seed=seed + i + 1)
        out[i * k_sub:(i + 1) * k_sub] = sub
    return out


def binary_split_fit(x, bits: int, iters: int = 25, seed: int = 13517106) -> np.ndarray:
    """Recursive 2-way splits to depth = bits, with flat-k-means fallback when
    a side is too small (reference hierarchicalBinKmeans, VAQ.cpp:1311-1371)."""
    x = np.asarray(x, dtype=np.float32)

    def rec(data, depth_left, seed):
        k_total = 1 << depth_left
        if depth_left == 0:
            return data.mean(axis=0, keepdims=True).astype(np.float32)
        if data.shape[0] < max(2, k_total // 2):
            reps = np.resize(data, (k_total, data.shape[1]))
            return reps.astype(np.float32)
        two, assign = fit(data, 2, iters=iters, seed=seed)
        left = data[assign == 0]
        right = data[assign == 1]
        if left.shape[0] < (k_total // 2) // 2 + 1 or right.shape[0] < (k_total // 2) // 2 + 1:
            c, _ = fit(data, k_total, iters=iters, seed=seed)
            return c
        return np.concatenate(
            [rec(left, depth_left - 1, seed * 2 + 1),
             rec(right, depth_left - 1, seed * 2 + 2)], axis=0
        )

    return rec(x, bits, seed)

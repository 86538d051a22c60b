"""Synthetic datasets + groundtruth generation.

The reference ships siftsmall queries/groundtruth but its base/learn fvecs are
missing large blobs (`.MISSING_LARGE_BLOBS`), and its own fallback is to
regenerate groundtruth by brute force (``demo_vaq_paramsearch.cpp:144-155``,
``demo_bitvecengine.cpp:335-355``). We do the same: synthetic SIFT-like data
with anisotropic variance (so the variance-aware bit allocation has signal)
plus an exact-search groundtruth generator on the device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vaq_tpu.ops.distances import compute_groundtruth


def make_anisotropic_gaussian(
    n: int,
    d: int,
    n_queries: int,
    seed: int = 0,
    n_clusters: int = 64,
    decay: float = 0.95,
) -> Tuple[np.ndarray, np.ndarray]:
    """Clustered data with geometrically decaying per-dim variance.

    The decay gives a skewed PCA spectrum like real SIFT/GIST descriptors, so
    VAQ's non-uniform bit allocation behaves as it does on the paper datasets.
    Queries are perturbed database points (realistic NN structure).
    """
    rng = np.random.default_rng(seed)
    scales = decay ** np.arange(d)
    mix = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)

    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + (
        rng.standard_normal((n, d)).astype(np.float32) * scales[None, :]
    )
    base = base @ mix  # rotate so variance structure isn't axis-aligned

    q_src = rng.integers(0, n, size=n_queries)
    queries = base[q_src] + 0.05 * rng.standard_normal((n_queries, d)).astype(
        np.float32
    )
    return base.astype(np.float32), queries.astype(np.float32)


def make_sift_like(n: int = 10000, n_queries: int = 100, d: int = 128,
                   seed: int = 42) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(base, queries, groundtruth@100) — the siftsmall-shaped fixture."""
    base, queries = make_anisotropic_gaussian(n, d, n_queries, seed)
    gt = compute_groundtruth(queries, base, k=100)
    return base, queries, gt


@functools.partial(jax.jit, static_argnames=("rows", "d"))
def _gen_chunk_device(key, i, rows: int, d: int, centers, scales, mix):
    """One deterministic (rows, d) f32 chunk of the DEEP-like mixture,
    computed entirely on device (same model as make_anisotropic_gaussian:
    cluster center + anisotropic noise, then a dense rotation)."""
    key = jax.random.fold_in(key, i)
    k1, k2 = jax.random.split(key)
    assign = jax.random.randint(k1, (rows,), 0, centers.shape[0])
    noise = jax.random.normal(k2, (rows, d), dtype=jnp.float32)
    return jnp.dot(centers[assign] + noise * scales[None, :], mix,
                   preferred_element_type=jnp.float32)


class DeviceChunkSource:
    """Chunked DEEP-like dataset generated directly on device.

    At 100M rows the raw dataset is ~38 GB; generating or streaming it
    through host RAM is infeasible in this environment (host memory moves at
    O(10 MB/s)), and irrelevant to what the capacity experiment measures.
    Chunk ``i`` is a pure function of ``(seed, i)``, so any chunk can be
    regenerated at any time — the device-side analog of re-reading a chunk
    from disk in the reference's disk-resident scan
    (``BitVecEngine.cpp:1441-1624``). Used by ``scripts/capacity_100m.py``
    for streamed encode, exact groundtruth, and exact refine, all with
    O(chunk) device transients.
    """

    def __init__(self, n: int, d: int, chunk_rows: int = 2_000_000,
                 seed: int = 42, n_clusters: int = 64, decay: float = 0.95):
        self.n = n
        self.d = d
        self.chunk_rows = min(chunk_rows, n)
        self.seed = seed
        self.n_chunks = -(-n // self.chunk_rows)
        host = np.random.default_rng(seed)
        scales = (decay ** np.arange(d)).astype(np.float32)
        mix = host.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)
        centers = (host.standard_normal((n_clusters, d)) * 2.0).astype(
            np.float32)
        self._centers = jnp.asarray(centers)
        self._scales = jnp.asarray(scales)
        self._mix = jnp.asarray(mix)
        self._key = jax.random.PRNGKey(seed)

    def chunk(self, i: int) -> jnp.ndarray:
        """(rows_i, d) f32 device chunk; the last chunk may be short."""
        if not 0 <= i < self.n_chunks:
            raise IndexError(f"chunk {i} out of {self.n_chunks}")
        rows = min(self.chunk_rows, self.n - i * self.chunk_rows)
        full = _gen_chunk_device(self._key, i, self.chunk_rows, self.d,
                                 self._centers, self._scales, self._mix)
        return full[:rows] if rows != self.chunk_rows else full

    def chunks(self):
        for i in range(self.n_chunks):
            yield self.chunk(i)

    def queries(self, n_queries: int, noise: float = 0.05) -> np.ndarray:
        """Perturbed rows of chunk 0 (realistic NN structure), as host f32."""
        c0 = self.chunk(0)
        kq = jax.random.fold_in(self._key, 1_000_003)
        k1, k2 = jax.random.split(kq)
        idx = jax.random.randint(k1, (n_queries,), 0, c0.shape[0])
        q = c0[idx] + noise * jax.random.normal(k2, (n_queries, self.d),
                                                dtype=jnp.float32)
        return np.asarray(q, dtype=np.float32)

    def host_sample(self, n_sample: int, seed: int = 0) -> np.ndarray:
        """A host-side row sample for train(): rows drawn uniformly across
        chunks (one device gather per touched chunk, tiny fetch)."""
        rng = np.random.default_rng(self.seed + seed)
        take = np.sort(rng.choice(self.n, size=min(n_sample, self.n),
                                  replace=False))
        parts = []
        for i in range(self.n_chunks):
            lo, hi = i * self.chunk_rows, i * self.chunk_rows + self.chunk_rows
            sel = take[(take >= lo) & (take < hi)] - lo
            if sel.size:
                parts.append(np.asarray(self.chunk(i)[jnp.asarray(sel)]))
        return np.concatenate(parts, axis=0)

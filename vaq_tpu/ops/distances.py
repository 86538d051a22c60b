"""Distance kernels as batched matmuls.

Replaces the reference's scalar/SIMD distance suite
(``utils/DistanceFunctions.hpp:17-263``, ``utils/Math.hpp:8-171`` —
``fvec_L2sqr_ny``, ``euclideanDist*``, early-abandon variants): every L2
computation is the matmul identity ``‖q−x‖² = ‖q‖² − 2·q·xᵀ + ‖x‖²`` so
matmuls do the work; early-abandon variants have no batched counterpart
(SURVEY §2.3 S2 — the exhaustive scan is the fast path).

Also hosts the brute-force exact top-k search (the reference's queryNaive*
family, ``BitVecEngine.cpp:574-720``), which doubles as the groundtruth
generator (``demo_vaq_paramsearch.cpp:144-155``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pairwise_sq_dists(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """(nq, d) × (n, d) → (nq, n) squared L2."""
    qn = jnp.sum(q * q, axis=1, keepdims=True)
    xn = jnp.sum(x * x, axis=1)
    d2 = qn - 2.0 * jnp.dot(q, x.T, preferred_element_type=jnp.float32) + xn[None, :]
    return jnp.maximum(d2, 0.0)


@functools.partial(jax.jit, static_argnames=("k", "block_rows"))
def exact_search(queries: jnp.ndarray, db: jnp.ndarray, k: int,
                 block_rows: int = 131072) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact L2 top-k: blocked matmul + streaming top-k merge.

    Returns (sq_dists (nq, k), labels (nq, k)).
    """
    n, d = db.shape
    nq = queries.shape[0]
    block_rows = min(block_rows, max(k, n))
    pad = (-n) % block_rows
    dbp = jnp.pad(db, ((0, pad), (0, 0)))
    nblocks = dbp.shape[0] // block_rows
    blocks = dbp.reshape(nblocks, block_rows, d)

    qn = jnp.sum(queries * queries, axis=1, keepdims=True)

    def body(carry, blk_and_idx):
        best_d, best_i = carry
        blk, bidx = blk_and_idx
        xn = jnp.sum(blk * blk, axis=1)
        d2 = qn - 2.0 * jnp.dot(queries, blk.T,
                                preferred_element_type=jnp.float32) + xn[None, :]
        ids = bidx * block_rows + jnp.arange(block_rows)
        d2 = jnp.where(ids[None, :] < n, d2, jnp.inf)
        cand_d = jnp.concatenate([best_d, d2], axis=1)
        cand_i = jnp.concatenate([best_i, jnp.broadcast_to(ids, (nq, block_rows))],
                                 axis=1)
        neg_top, top_pos = jax.lax.top_k(-cand_d, k)
        new_i = jnp.take_along_axis(cand_i, top_pos, axis=1)
        return (-neg_top, new_i), None

    init = (jnp.full((nq, k), jnp.inf), jnp.full((nq, k), -1, dtype=jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        body, init, (blocks, jnp.arange(nblocks)))
    return jnp.maximum(best_d, 0.0), best_i


def compute_groundtruth(queries, db, k: int) -> np.ndarray:
    """Brute-force groundtruth labels (host convenience wrapper)."""
    _, labels = exact_search(jnp.asarray(queries, jnp.float32),
                             jnp.asarray(db, jnp.float32), k)
    return np.asarray(labels)


def jaccard_dists(q_packed: jnp.ndarray, db_packed: jnp.ndarray) -> jnp.ndarray:
    """Jaccard distance between packed bit-vectors
    (reference ``jaccardDist``, DistanceFunctions.hpp:218-230):

        1 − popcount(a & b) / popcount(a | b),   0 when the union is empty.

    q_packed: (nq, W) uint32; db_packed: (n, W) uint32 → (nq, n) f32.
    """
    inter = jnp.sum(jax.lax.population_count(
        jnp.bitwise_and(q_packed[:, None, :], db_packed[None, :, :])), axis=2)
    union = jnp.sum(jax.lax.population_count(
        jnp.bitwise_or(q_packed[:, None, :], db_packed[None, :, :])), axis=2)
    frac = inter.astype(jnp.float32) / jnp.maximum(
        union.astype(jnp.float32), 1.0)
    return jnp.where(union == 0, 0.0, 1.0 - frac)


@functools.partial(jax.jit, static_argnames=("k", "block_rows"))
def jaccard_topk(db_packed: jnp.ndarray, q_packed: jnp.ndarray, k: int,
                 block_rows: int = 65536) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blocked Jaccard top-k over packed bit-vectors (ascending distance)."""
    n, w = db_packed.shape
    nq = q_packed.shape[0]
    block_rows = min(block_rows, n)
    pad = (-n) % block_rows
    dbp = jnp.pad(db_packed, ((0, pad), (0, 0)))
    blocks = dbp.reshape(-1, block_rows, w)

    def body(carry, blk_and_idx):
        best_d, best_i = carry
        blk, bidx = blk_and_idx
        d = jaccard_dists(q_packed, blk)
        ids = bidx * block_rows + jnp.arange(block_rows, dtype=jnp.int32)
        d = jnp.where(ids[None, :] < n, d, jnp.inf)
        cd = jnp.concatenate([best_d, d], axis=1)
        ci = jnp.concatenate(
            [best_i, jnp.broadcast_to(ids, (nq, block_rows))], axis=1)
        neg, pos = jax.lax.top_k(-cd, k)
        return (-neg, jnp.take_along_axis(ci, pos, axis=1)), None

    init = (jnp.full((nq, k), jnp.inf),
            jnp.full((nq, k), -1, dtype=jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        body, init, (blocks, jnp.arange(blocks.shape[0], dtype=jnp.int32)))
    return best_d, best_i


def manhattan_dists(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """(nq, d) × (n, d) → (nq, n) L1 distances (reference ``manhattanDist``,
    DistanceFunctions.hpp:254-263). No matmul identity exists for L1, so
    this is a broadcasted |q − x| reduction (VPU work; block at scale)."""
    return jnp.sum(jnp.abs(q[:, None, :] - x[None, :, :]), axis=2)


@functools.partial(jax.jit, static_argnames=("k", "block_rows"))
def manhattan_topk(queries: jnp.ndarray, db: jnp.ndarray, k: int,
                   block_rows: int = 8192) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blocked L1 top-k (the Manhattan analog of :func:`exact_search`)."""
    n, d = db.shape
    nq = queries.shape[0]
    block_rows = min(block_rows, n)
    pad = (-n) % block_rows
    dbp = jnp.pad(db, ((0, pad), (0, 0)))
    blocks = dbp.reshape(-1, block_rows, d)

    def body(carry, blk_and_idx):
        best_d, best_i = carry
        blk, bidx = blk_and_idx
        d1 = manhattan_dists(queries, blk)
        ids = bidx * block_rows + jnp.arange(block_rows, dtype=jnp.int32)
        d1 = jnp.where(ids[None, :] < n, d1, jnp.inf)
        cd = jnp.concatenate([best_d, d1], axis=1)
        ci = jnp.concatenate(
            [best_i, jnp.broadcast_to(ids, (nq, block_rows))], axis=1)
        neg, pos = jax.lax.top_k(-cd, k)
        return (-neg, jnp.take_along_axis(ci, pos, axis=1)), None

    init = (jnp.full((nq, k), jnp.inf),
            jnp.full((nq, k), -1, dtype=jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        body, init, (blocks, jnp.arange(blocks.shape[0], dtype=jnp.int32)))
    return best_d, best_i


def exact_search_chunked(queries, chunk_fn, n: int, chunk_rows: int, k: int):
    """Exact top-k over an arbitrary chunk source (streamed merge).

    ``chunk_fn(i)`` returns chunk ``i`` as (rows_i, d) f32, device or host —
    a memmap slice, a ``data.DeviceChunkSource`` chunk, etc. Per-chunk top-k
    on device, tiny (nq, k) merge on host: the reference's disk-resident
    pattern (``BitVecEngine.cpp:1441-1624``, merge 1599-1611) with the chunk
    read generalized. Device memory stays O(chunk).
    """
    queries_d = jnp.asarray(np.asarray(queries, np.float32))
    nq = queries_d.shape[0]
    best_d = np.full((nq, k), np.inf, dtype=np.float32)
    best_i = np.full((nq, k), -1, dtype=np.int32)
    for i, start in enumerate(range(0, n, chunk_rows)):
        chunk = jnp.asarray(chunk_fn(i))
        kk = min(k, chunk.shape[0])
        d, lab = exact_search(queries_d, chunk, kk)
        d = np.asarray(d)
        lab = (np.asarray(lab) + start).astype(np.int32)
        cd = np.concatenate([best_d, d], axis=1)
        ci = np.concatenate([best_i, lab], axis=1)
        order = np.argsort(cd, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cd, order, axis=1)
        best_i = np.take_along_axis(ci, order, axis=1)
    return best_d, best_i


def exact_search_host_stream(queries, base_np: np.ndarray, k: int,
                             chunk_rows: int = 4_000_000):
    """Exact top-k streaming host chunks to the device.

    For databases whose f32 form doesn't fit HBM alongside an index
    (exact_search's pad+reshape also transiently duplicates the array on
    device). Device memory stays O(chunk).
    """

    def chunk_fn(i):
        return np.asarray(base_np[i * chunk_rows:(i + 1) * chunk_rows],
                          np.float32)

    return exact_search_chunked(queries, chunk_fn, base_np.shape[0],
                                chunk_rows, k)


@functools.partial(jax.jit, static_argnames=())
def _rescore_chunk(queries, rows, cand, start, prev):
    """Exact sq-dists for the candidates that fall inside [start, start+rows):
    gather their rows, compute ‖q − x‖² against each candidate's own query,
    keep previous values elsewhere."""
    nq, r = cand.shape
    local = cand - start
    valid = (local >= 0) & (local < rows.shape[0])
    safe = jnp.clip(local, 0, rows.shape[0] - 1).reshape(-1)
    g = rows[safe].reshape(nq, r, -1)
    d2 = jnp.sum((queries[:, None, :] - g) ** 2, axis=2)
    return jnp.where(valid, d2, prev)


def exact_rescore_chunked(queries, cand: np.ndarray, chunk_fn, n: int,
                          chunk_rows: int, k: int):
    """Exact rerank of candidate ids against a chunked source (V17 analog
    for databases with no host-resident original vectors: regenerate/re-read
    each chunk, gather the candidates that live in it, rescore).

    Returns (sq_dists (nq, k), labels (nq, k)) sorted ascending.
    """
    queries_d = jnp.asarray(np.asarray(queries, np.float32))
    cand_d = jnp.asarray(np.asarray(cand, np.int32))
    d2 = jnp.full(cand_d.shape, jnp.inf, dtype=jnp.float32)
    for i, start in enumerate(range(0, n, chunk_rows)):
        d2 = _rescore_chunk(queries_d, jnp.asarray(chunk_fn(i)), cand_d,
                            start, d2)
    order = jnp.argsort(d2, axis=1)[:, :k]
    return (np.asarray(jnp.take_along_axis(d2, order, axis=1)),
            np.asarray(jnp.take_along_axis(cand_d, order, axis=1)))

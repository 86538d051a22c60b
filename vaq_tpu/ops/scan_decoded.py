"""Decoded-database scan backend: ADC distances as one matmul.

Because the subspaces partition the projected dimensions, the ADC distance is
algebraically exact in decoded form:

    Σ_s ‖q_s − C_s[code_s]‖²  =  ‖q − decode(x)‖²

so scanning the *decoded* database with the matmul identity reproduces the
reference scan family's results (searchSort/searchHeap, VAQ.cpp:1729-1776)
as matmuls instead of per-row LUT gathers. The decoded rows are stored in
bfloat16 (½ the device-memory traffic of f32; codebook quantization error
dwarfs bf16 rounding) with f32 row norms precomputed.

Top-k strategy: the scan maximizes the monotone score ``2·q·x̂ − ‖x̂‖²``
(the per-query ‖q‖² term cannot change the ranking), selects 2k candidates
with ``jax.lax.approx_max_k`` (on the GPU and the CPU XLA lowers it to an
exact selection over the materialised (nq, n) score matrix), then **exactly
rescores** the candidates in f32 and sorts them — distances are exact; only
membership of the top-k set can be approximate, with recall set by
``recall_target`` (misses are recovered by the refine stage exactly as the
reference's refine recovers ADC misses, VAQ.cpp:849-876).

Trade-off vs the codes-resident scans (`scan_codes`, `scan_jax`):
  * decoded bf16 row = 2·d bytes vs Σbits/8 bytes of codes (d=128, 256-bit
    budget: 256 B vs 32 B — 8× more device memory per row), so
  * decoded is the throughput backend while the database fits device
    memory; the codes tier is the capacity backend.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

# Above this row count, gather-based exact winner rescore is replaced by
# score-derived distances (the gather forces a full relayout copy of the
# transposed int8 matrix — see decoded8_scan_topk).
_RESCORE_GATHER_MAX = 16_000_000


@functools.partial(jax.jit, static_argnames=("block_rows",))
def decode_db(codes_t: jnp.ndarray, centroids: jnp.ndarray,
              block_rows: int = 65536) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Materialize decoded rows (bf16) + f32 squared norms.

    codes_t: (M, n) ints (the index's transposed storage); centroids:
    (M, C, L) f32 → returns (decoded (n, M*L) bf16, norms (n,) f32).
    """
    m, n = codes_t.shape
    _, c, l = centroids.shape
    pad = (-n) % block_rows
    codes_p = jnp.pad(codes_t, ((0, 0), (0, pad)))
    nblocks = codes_p.shape[1] // block_rows

    def dec(i):
        # per-subspace gather of (C, L) by (nb,) — one-time cost at build.
        # (int32 widening happens per block: a whole-array cast would
        # transiently cost 4 B/code.)
        blk = jax.lax.dynamic_slice_in_dim(
            codes_p, i * block_rows, block_rows, axis=1).astype(jnp.int32)
        g = jax.vmap(lambda cent_s, code_s: cent_s[code_s],
                     in_axes=(0, 0))(centroids, blk)     # (M, nb, L)
        rows = jnp.transpose(g, (1, 0, 2)).reshape(block_rows, m * l)
        norms = jnp.sum(rows * rows, axis=1)
        return rows.astype(jnp.bfloat16), norms

    dec_rows, norms = jax.lax.map(dec, jnp.arange(nblocks))
    return (dec_rows.reshape(-1, m * l)[:n], norms.reshape(-1)[:n])


@functools.partial(jax.jit, static_argnames=("block_rows",))
def decode_db_int8(
    codes_t: jnp.ndarray, centroids: jnp.ndarray, block_rows: int = 65536,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Int8 variant of :func:`decode_db` — the capacity tier.

    Rows are stored as int8 with one per-dimension scale (folded into the
    query at search time), half the device memory of bf16. Storage is
    TRANSPOSED (D, n). This is the matmul answer to the reference's u8-LUT
    fast scan (V14-V16): *quantize the reconstruction, not the lookup
    table*.

    The output is written block-by-block into one carried buffer (in-place
    dynamic updates inside fori_loop), so transients stay O(block). Pass a
    ``block_rows`` that divides n at large scale — the final unpad slice
    otherwise copies the whole buffer.

    Returns (decoded8 (D, n) int8, dim_scales (D,) f32 with
    x ≈ decoded8 / dim_scales, norms (n,) f32 exact).
    """
    m, n = codes_t.shape
    _, c, l = centroids.shape
    # int8 range per dim from the centroid extrema (padding sentinels are
    # masked out by taking per-subspace valid maxima via finite check).
    finite = jnp.where(jnp.abs(centroids) < 1e17, jnp.abs(centroids), 0.0)
    dim_max = jnp.max(finite, axis=1).reshape(m * l)      # (D,)
    dim_scales = 127.0 / jnp.maximum(dim_max, 1e-30)

    pad = (-n) % block_rows
    codes_p = jnp.pad(codes_t, ((0, 0), (0, pad)))
    npad = codes_p.shape[1]

    def body(i, carry):
        buf, nbuf = carry
        # per-block int32 widening (see decode_db) — keeps the transient
        # device footprint O(block) instead of O(n).
        blk = jax.lax.dynamic_slice_in_dim(
            codes_p, i * block_rows, block_rows, axis=1).astype(jnp.int32)
        g = jax.vmap(lambda cent_s, code_s: cent_s[code_s],
                     in_axes=(0, 0))(centroids, blk)      # (M, nb, L)
        rows = jnp.transpose(g, (1, 0, 2)).reshape(block_rows, m * l)
        norms = jnp.sum(rows * rows, axis=1)
        q8 = jnp.clip(jnp.round(rows * dim_scales[None, :]), -127, 127)
        buf = jax.lax.dynamic_update_slice(
            buf, q8.astype(jnp.int8).T, (0, i * block_rows))
        nbuf = jax.lax.dynamic_update_slice(nbuf, norms, (i * block_rows,))
        return buf, nbuf

    buf = jnp.zeros((m * l, npad), jnp.int8)
    nbuf = jnp.zeros((npad,), jnp.float32)
    buf, nbuf = jax.lax.fori_loop(0, npad // block_rows, body, (buf, nbuf))
    return buf[:, :n], dim_scales, nbuf[:n]


@functools.partial(jax.jit, static_argnames=("k", "exact", "recall_target"))
def decoded8_scan_topk(
    decoded8: jnp.ndarray,
    dim_scales: jnp.ndarray,
    norms: jnp.ndarray,
    decoded_rescore: jnp.ndarray,
    queries_proj: jnp.ndarray,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    exact: bool = False,
    recall_target: float = 0.99,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Int8 scan: fold per-dim scales into the query, run the matmul on
    int8 rows widened to bf16, approx-top-k, exact rescore.

    decoded_rescore: rows used for the exact rescore — pass the (D, n) int8
    matrix itself (dequantized on the fly).
    """
    n = decoded8.shape[1]                                 # (D, n) transposed
    if n_valid is not None:
        col = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
        norms = jnp.where(col < n_valid, norms, jnp.inf)

    # Fold the per-dim scales into the query and let XLA fuse the int8→bf16
    # convert into the matmul: device-memory traffic stays int8 (the point
    # of this tier). int8 values are exact in bf16; only the query side
    # carries bf16 rounding, and the winners are rescored exactly below.
    # The (D, n) storage is already the matmul's rhs orientation.
    q_folded = (queries_proj / dim_scales[None, :]).astype(jnp.bfloat16)
    inner = jnp.dot(q_folded, decoded8.astype(jnp.bfloat16),
                    precision=jax.lax.Precision.DEFAULT,
                    preferred_element_type=jnp.float32)   # ≈ q·x̂
    score = 2.0 * inner - norms[None, :]
    # Over-fetch 2k candidates; the exact f32 rescore below repairs
    # ordering among the fetched set.
    kk = min(max(2 * k, k + 16), n)
    if exact:
        vals, idx = jax.lax.top_k(score, kk)
    else:
        vals, idx = jax.lax.approx_max_k(score, kk,
                                         recall_target=recall_target)
    # masked rows (past n_valid / tombstoned) carry -inf scores; never let
    # the exact rescore resurrect them
    idx = jnp.where(jnp.isfinite(vals), idx, -1)
    if kk < k:
        idx = jnp.pad(idx, ((0, 0), (0, k - kk)), constant_values=-1)
        vals = jnp.pad(vals, ((0, 0), (0, k - kk)),
                       constant_values=-jnp.inf)
    if n > _RESCORE_GATHER_MAX:
        # At capacity scale, skip the column gather of the winners from the
        # (D, n) int8 matrix (it can make XLA copy the whole array) and
        # return distances derived from the already-f32 scores instead:
        # d² = ‖q‖² − score, exact up to the scan's own bf16·int8 rounding;
        # membership is protected by the 2k over-fetch, and exact distances
        # come from the refine stage (exact_rescore_chunked), as in the
        # reference's Fig. 11 pipeline.
        qn = jnp.sum(queries_proj * queries_proj, axis=1, keepdims=True)
        d2 = jnp.maximum(qn - vals, 0.0)
        d2 = jnp.where(idx >= 0, d2, jnp.inf)
        neg, pos = jax.lax.top_k(-d2, k)
        return -neg, jnp.take_along_axis(idx, pos, axis=1)
    safe = jnp.maximum(idx, 0)
    rows = jnp.transpose(decoded_rescore[:, safe],
                         (1, 2, 0)).astype(jnp.float32)   # (nq, kk, D)
    if decoded_rescore.dtype == jnp.int8:
        rows = rows / dim_scales[None, None, :]
    diff = queries_proj[:, None, :] - rows
    d2 = jnp.sum(diff * diff, axis=2)
    d2 = jnp.where(idx >= 0, d2, jnp.inf)
    neg, pos = jax.lax.top_k(-d2, k)
    return jnp.maximum(-neg, 0.0), jnp.take_along_axis(idx, pos, axis=1)


def _rescore_exact(qp: jnp.ndarray, decoded: jnp.ndarray, idx: jnp.ndarray,
                   k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact f32 distances for the selected candidates + ascending sort."""
    safe = jnp.maximum(idx, 0)
    rows = decoded[safe].astype(jnp.float32)              # (nq, k', D)
    diff = qp[:, None, :] - rows
    d2 = jnp.sum(diff * diff, axis=2)
    d2 = jnp.where(idx >= 0, d2, jnp.inf)
    neg, pos = jax.lax.top_k(-d2, k)
    return jnp.maximum(-neg, 0.0), jnp.take_along_axis(idx, pos, axis=1)


@functools.partial(jax.jit,
                   static_argnames=("k", "exact", "recall_target"))
def decoded_scan_topk(
    decoded: jnp.ndarray,
    norms: jnp.ndarray,
    queries_proj: jnp.ndarray,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    exact: bool = False,
    recall_target: float = 0.99,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused scan + top-k over the decoded database.

    decoded: (n, D) bf16; norms: (n,) f32; queries_proj: (nq, D) f32.
    Returns (sq_dists (nq, k) f32 exact, labels (nq, k) i32), ascending.
    ``exact=True`` uses a true top_k (for parity tests).
    """
    n = decoded.shape[0]
    if n_valid is not None:
        col = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
        norms = jnp.where(col < n_valid, norms, jnp.inf)

    qx = jnp.dot(queries_proj.astype(jnp.bfloat16), decoded.T,
                 precision=jax.lax.Precision.DEFAULT,
                 preferred_element_type=jnp.float32)      # (nq, n)
    score = 2.0 * qx - norms[None, :]                     # = ‖q‖² − d², monotone
    # Over-fetch 2k then rescore exactly — recovers rows that bf16 score
    # rounding (or an approximate selection) shuffled just outside the
    # top-k (quantified in test_approx_miss_rate).
    kk = min(max(2 * k, k + 16), n)
    if exact:
        vals, idx = jax.lax.top_k(score, kk)
    else:
        vals, idx = jax.lax.approx_max_k(score, kk,
                                         recall_target=recall_target)
    # masked rows (past n_valid / tombstoned) carry -inf scores; never let
    # the exact rescore resurrect them
    idx = jnp.where(jnp.isfinite(vals), idx, -1)
    if kk < k:
        idx = jnp.pad(idx, ((0, 0), (0, k - kk)), constant_values=-1)
    return _rescore_exact(queries_proj, decoded, idx, k)


@functools.partial(jax.jit,
                   static_argnames=("k", "exact", "recall_target"))
def decoded_search_e2e(
    queries: jnp.ndarray,
    eigvecs_td: jnp.ndarray,
    decoded: jnp.ndarray,
    norms: jnp.ndarray,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    exact: bool = False,
    recall_target: float = 0.99,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One fused dispatch: project queries → decoded scan → top-k.

    The serving hot path (reference VAQ::search does project-then-scan per
    query, VAQ.cpp:776-847; here it is a single XLA program per batch).
    queries: (nq, d) raw; eigvecs_td: (d, total_dim) rotation slice.
    """
    qp = jnp.dot(queries, eigvecs_td, preferred_element_type=jnp.float32)
    return decoded_scan_topk(decoded, norms, qp, k, n_valid=n_valid,
                             exact=exact, recall_target=recall_target)

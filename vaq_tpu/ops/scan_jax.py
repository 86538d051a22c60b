"""ADC lookup-table build + code scan with fused streaming top-k (XLA path).

This is the batched re-design of the reference's per-query scan family
(``searchSort``/``searchHeap``/``searchEarlyAbandon``/``searchFast*``,
``VAQ.cpp:1694-2046``). Instead of a per-query loop with per-row gathers and
a hand-rolled heap, the whole query batch is processed at once:

* LUT build (= ``VAQ::CreateLUT``, VAQ.hpp:127-180): one batched einsum
  ``lut[q,s,c] = ‖q_s − C_{s,c}‖²`` — matmul work, replaces the AVX2 FMA
  loops.
* Scan (= the ``dist += lut[code]`` inner hot loop, VAQ.cpp:1741-1748): codes
  are streamed in row blocks; per block a vmapped per-subspace gather from the
  LUT accumulates distances for all queries, then a top-k merge
  folds the block into the running best-k (the Faiss-style heap of
  ``utils/Heap.hpp`` becomes ``jax.lax.top_k``, SURVEY §2.3 S5).

Early-abandon (V12) is intentionally absent: per-row data-dependent exits
don't vectorize; the exhaustive blocked scan IS the fast path, and the
cluster-probe module (`vaq_tpu.ivf`) provides the pruning knob (SURVEY §2.1
V12/V13).

The u8-quantized-LUT path (reference FAST/Bolt-style shuffle scan, V14-V16)
is supported by dequantized LUTs (the accuracy of the quantization) or by
:func:`fast_scan_topk` (its winner-selection semantics).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def build_luts(queries_proj: jnp.ndarray, centroids: jnp.ndarray) -> jnp.ndarray:
    """lut[q, s, c] = ‖q_s − C_{s,c}‖² for the whole query batch.

    Args:
      queries_proj: (nq, M*L) PCA-projected queries (kept subspaces only).
      centroids: (M, C, L) padded per-subspace codebooks; padded rows should
        hold large sentinel values so they are never competitive.

    Returns:
      (nq, M, C) float32 LUT.
    """
    nq = queries_proj.shape[0]
    m, c, l = centroids.shape
    q = queries_proj.reshape(nq, m, l)
    # ‖q‖² − 2·q·cᵀ + ‖c‖²  per subspace, as one batched einsum
    qc = jnp.einsum("qml,mcl->qmc", q, centroids,
                    preferred_element_type=jnp.float32)
    q2 = jnp.sum(q * q, axis=2)[:, :, None]
    c2 = jnp.sum(centroids * centroids, axis=2)[None, :, :]
    return q2 - 2.0 * qc + c2


def quantize_luts(luts: jnp.ndarray, offsets: jnp.ndarray,
                  scales: jnp.ndarray) -> jnp.ndarray:
    """u8-quantize a LUT batch with learned per-subspace offset/scale
    (reference smallQuantize, utils/Math.hpp:215-224)."""
    q = (luts - offsets[None, :, None]) * scales[None, :, None]
    q = jnp.clip(jnp.floor(q), 0.0, 255.0)
    return q.astype(jnp.uint8)


def _gather_block(lut_t: jnp.ndarray, codes_blk: jnp.ndarray) -> jnp.ndarray:
    """Accumulate Σ_s lut[s, codes[n,s], q] for one code block.

    lut_t: (M, C, nq); codes_blk: (nb, M) int32 → (nq, nb) distances.
    """
    # vmap over subspaces: (C, nq)[codes_s] → (nb, nq)
    gathered = jax.vmap(lambda lut_s, codes_s: lut_s[codes_s], in_axes=(0, 1))(
        lut_t, codes_blk
    )  # (M, nb, nq)
    return jnp.sum(gathered, axis=0).T


@functools.partial(jax.jit, static_argnames=("k", "block_rows"))
def adc_scan_topk(
    codes: jnp.ndarray,
    luts: jnp.ndarray,
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    block_rows: int = 32768,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scan all code rows against per-query LUTs, return top-k per query.

    Args:
      codes: (n, M) integer codes (any int dtype).
      luts: (nq, M, C) float32 (or dequantizable) lookup tables.
      k: neighbors to keep.
      n_valid: optional scalar count of valid rows (rows ≥ n_valid are padding
        and get +inf distance).
      block_rows: rows per scan block (bounds the (nq, block) live matrix).

    Returns:
      (sq_dists (nq, k) f32, labels (nq, k) i32) sorted ascending by distance,
      matching the reference's reordered-heap output ABI (Heap.hpp:433).
    """
    n, m = codes.shape
    nq = luts.shape[0]
    codes = codes.astype(jnp.int32)
    if n_valid is None:
        n_valid = jnp.int32(n)
    block_rows = min(block_rows, n)
    pad = (-n) % block_rows
    codes_p = jnp.pad(codes, ((0, pad), (0, 0)))
    nblocks = codes_p.shape[0] // block_rows
    blocks = codes_p.reshape(nblocks, block_rows, m)

    lut_t = luts.astype(jnp.float32).transpose(1, 2, 0)  # (M, C, nq)

    def body(carry, blk_and_idx):
        best_d, best_i = carry
        blk, bidx = blk_and_idx
        d = _gather_block(lut_t, blk)                      # (nq, nb)
        ids = bidx * block_rows + jnp.arange(block_rows, dtype=jnp.int32)
        d = jnp.where(ids[None, :] < n_valid, d, jnp.inf)
        cand_d = jnp.concatenate([best_d, d], axis=1)
        cand_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(ids, (nq, block_rows))], axis=1)
        neg_top, pos = jax.lax.top_k(-cand_d, k)
        return (-neg_top, jnp.take_along_axis(cand_i, pos, axis=1)), None

    init = (jnp.full((nq, k), jnp.inf),
            jnp.full((nq, k), -1, dtype=jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        body, init, (blocks, jnp.arange(nblocks, dtype=jnp.int32)))
    return best_d, best_i


@functools.partial(jax.jit, static_argnames=("k", "block_rows"))
def fast_scan_topk(
    codes: jnp.ndarray,
    luts: jnp.ndarray,
    luts8: Optional[jnp.ndarray],
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    block_rows: int = 32768,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's FAST semantics (VAQ.cpp:1778-1836): winners are the
    k rows with the smallest sums of raw u8 table entries ``luts8``
    (nq, M, C), then the winners' distances are recomputed exactly from the
    f32 ``luts``. Returned ascending by the exact distance.

    The u8 sums run through :func:`adc_scan_topk` in f32, which is exact
    integer arithmetic (every partial sum < 255·M ≤ 2²⁴), so equal sums tie
    and ``top_k`` keeps the lower row id. Without ``luts8`` (no learned
    quantization) this is the exact f32 scan."""
    _, ids = adc_scan_topk(codes, luts if luts8 is None else luts8, k,
                           n_valid=n_valid, block_rows=block_rows)
    cand = codes[jnp.maximum(ids, 0)].astype(jnp.int32)      # (nq, k, M)
    d2 = jnp.sum(jnp.take_along_axis(luts, cand.transpose(0, 2, 1), axis=2),
                 axis=1)                                     # (nq, k)
    d2 = jnp.where(ids >= 0, d2, jnp.inf)
    neg, pos = jax.lax.top_k(-d2, k)
    return -neg, jnp.take_along_axis(ids, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def refine_topk(
    queries: jnp.ndarray,
    db_candidates: jnp.ndarray,
    cand_labels: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact rerank of R candidates per query (reference VAQ::refine,
    VAQ.cpp:849-876): gather the candidate rows, recompute exact squared L2,
    keep top-k.

    Args:
      queries: (nq, d) original-space queries.
      db_candidates: (nq, R, d) gathered candidate vectors.
      cand_labels: (nq, R) their global ids (-1 marks padding).
    """
    diff = queries[:, None, :] - db_candidates
    d2 = jnp.sum(diff * diff, axis=2)
    d2 = jnp.where(cand_labels >= 0, d2, jnp.inf)
    neg_top, pos = jax.lax.top_k(-d2, k)
    return -neg_top, jnp.take_along_axis(cand_labels, pos, axis=1)

"""Codes-resident scan — the counterpart of the reference's FAST scan family
(``searchFast``/``Fast2``/``Fast3``, VAQ.cpp:1778-2046): search directly
over the packed codes so device memory holds M bytes/row instead of the
decoded tiers' d·{1,2} bytes/row.

**Decode-then-dot.** Rows are reconstructed from their codes block by block
and scored with the matmul identity

    Σ_s ‖q_s − c_{s,code}‖² = ‖q − x̂‖² = ‖q‖² − 2·q·x̂ + ‖x̂‖²,

so the arithmetic is d multiply-adds per (row, query), independent of the
codebook size C. The scan keeps ONE candidate per (query, window of
``block_rows`` rows): the window's minimum distance and its row. The caller
takes the best 2k windows and rescores their winners exactly in f32
(:func:`decode_scan_topk`), so the bf16 decode only decides membership.

Two implementations of the window scan, one contract:

* :func:`window_scan_xla` — plain XLA: decode a chunk of rows with a
  per-subspace gather, one bf16 matmul against all queries, window
  min/argmin. It runs everywhere and is the reference the kernel is tested
  against. Its (queries × chunk) f32 score block makes a round trip through
  device memory.
* :func:`window_scan_triton` — a Pallas kernel for the GPU through Triton:
  each program owns a (query tile, window) pair, gathers the window's codes
  and centroid rows itself (the C×d bf16 table stays in L1/L2), runs the
  bf16 dot on the tensor cores with f32 accumulation and keeps the
  window-min in registers, so only one packed int32 per (query, window)
  reaches device memory. Nothing is carried between programs.

:func:`vaq_tpu.ops.platform.choose` picks one per platform.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from vaq_tpu.ops import platform

_DEFAULT = jax.lax.Precision.DEFAULT    # bf16 operands: exact products

#: target f32 score-block bytes per chunk of the XLA scan
_XLA_CHUNK_BYTES = 1 << 28


def build_decode_tables(centroids) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(M, C, L) f32 padded centroids → (bf16 table (C, d_pad), f32 rows
    (C, d)).

    Row c holds ``centroids[s, c, j]`` at column s·L+j, so the
    reconstruction of a row with codes ``code[s]`` reads column s·L+j from
    row ``code[s]``. The bf16 table feeds the scans; its columns are zero
    padded to a power of two (Triton block shapes). The f32 rows feed the
    exact rescore. Sentinel (+huge) padding centroids are zeroed — codes
    never address them.
    """
    cents = np.asarray(centroids, dtype=np.float32)
    m, c, l = cents.shape
    cents = np.where(np.abs(cents) < 1e30, cents, 0.0)
    rows = cents.transpose(1, 0, 2).reshape(c, m * l)
    d_pad = 1 << max(4, (m * l - 1).bit_length())
    table = np.pad(rows, ((0, 0), (0, d_pad - m * l)))
    return jnp.asarray(table, dtype=jnp.bfloat16), jnp.asarray(rows)


@functools.partial(jax.jit, static_argnames=("block_rows",))
def window_scan_xla(
    codes_t: jnp.ndarray,    # (M, n) ints < C, n % block_rows == 0
    table: jnp.ndarray,      # (C, d_pad) bf16 from build_decode_tables
    qp: jnp.ndarray,         # (nq, d) f32 projected queries
    block_rows: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-(query, window) best candidate in plain XLA.

    Returns (scores (nq, n/block_rows) f32 window-min squared distances,
    row_ids (nq, n/block_rows) i32 global ids)."""
    m, n = codes_t.shape
    nq, d = qp.shape
    assert n % block_rows == 0, (n, block_rows)
    l = d // m
    cents = table[:, :d].reshape(-1, m, l).transpose(1, 0, 2)   # (M, C, L)
    nwin = n // block_rows
    # windows per chunk: the (nq, chunk) f32 score block stays bounded
    wpc = max(1, min(nwin, _XLA_CHUNK_BYTES // (4 * nq * block_rows)))
    nchunks = -(-nwin // wpc)
    rows = wpc * block_rows
    codes_t = jnp.pad(codes_t, ((0, 0), (0, nchunks * rows - n)))
    q_bf = qp.astype(jnp.bfloat16)
    qn = jnp.sum(qp * qp, axis=1)

    def chunk(i):
        blk = jax.lax.dynamic_slice_in_dim(codes_t, i * rows, rows,
                                           axis=1).astype(jnp.int32)
        g = jax.vmap(lambda c_s, k_s: c_s[k_s])(cents, blk)  # (M, rows, L)
        dec = jnp.transpose(g, (1, 0, 2)).reshape(rows, d)   # bf16
        decf = dec.astype(jnp.float32)
        xn = jnp.sum(decf * decf, axis=1)
        dot = jnp.dot(q_bf, dec.T, precision=_DEFAULT,
                      preferred_element_type=jnp.float32)    # (nq, rows)
        dist = jnp.maximum(xn[None, :] - 2.0 * dot + qn[:, None], 0.0)
        dist = dist.reshape(nq, wpc, block_rows)
        return jnp.min(dist, axis=2), jnp.argmin(dist, axis=2)

    mins, arg = jax.lax.map(chunk, jnp.arange(nchunks))   # (nchunks, nq, wpc)
    scores = jnp.transpose(mins, (1, 0, 2)).reshape(nq, -1)[:, :nwin]
    local = jnp.transpose(arg, (1, 0, 2)).reshape(nq, -1)[:, :nwin]
    base = jnp.arange(nwin, dtype=jnp.int32) * block_rows
    return scores, local.astype(jnp.int32) + base[None, :]


def _window_kernel(codes_ref, table_ref, q_ref, qn_ref, out_ref, *,
                   m, l, block_rows, sub_rows):
    """One program: ``q_tile`` queries × one window of ``block_rows`` rows.

    codes_ref (M, n) u8 and table_ref (C, d_pad) bf16 are whole arrays in
    device memory; q_ref (q_tile, d_pad) bf16 and qn_ref (q_tile,) f32 are
    this program's query tile; out_ref (q_tile,) i32 receives the packed
    (score, window-local row) minimum.
    """
    w = pl.program_id(1)
    d_pad = table_ref.shape[1]
    q = q_ref[...]
    qn = qn_ref[...]
    col = jnp.arange(d_pad, dtype=jnp.int32)
    sub = jnp.minimum(col // l, m - 1)      # padded columns read a real code
    idx_bits = max(1, (block_rows - 1).bit_length())
    idx_mask = (1 << idx_bits) - 1

    def body(t, best):
        r0 = w * block_rows + t * sub_rows
        rows = r0 + jnp.arange(sub_rows, dtype=jnp.int32)
        codes = codes_ref[sub[None, :], rows[:, None]]        # (sub, d_pad)
        dec = table_ref[codes.astype(jnp.int32), col[None, :]]
        decf = dec.astype(jnp.float32)
        xn = jnp.sum(decf * decf, axis=1)                     # (sub,)
        dot = pl.dot(q, dec, trans_b=True, precision=_DEFAULT)
        dist = jnp.maximum(xn[None, :] - 2.0 * dot + qn[:, None], 0.0)
        # non-negative f32 bit patterns order like their values, so the
        # window-local row rides in the low mantissa bits of one int32 min
        local = t * sub_rows + jnp.arange(sub_rows, dtype=jnp.int32)
        packed = ((jax.lax.bitcast_convert_type(dist, jnp.int32) & ~idx_mask)
                  | local[None, :])
        return jnp.minimum(best, jnp.min(packed, axis=1))

    best = jnp.full((q.shape[0],), jnp.iinfo(jnp.int32).max, jnp.int32)
    out_ref[...] = jax.lax.fori_loop(0, block_rows // sub_rows, body, best)


@functools.partial(jax.jit, static_argnames=(
    "block_rows", "q_tile", "sub_rows", "num_warps", "num_stages",
    "interpret"))
def window_scan_triton(
    codes_t: jnp.ndarray,    # (M, n) ints < C, n % block_rows == 0
    table: jnp.ndarray,      # (C, d_pad) bf16 from build_decode_tables
    qp: jnp.ndarray,         # (nq, d) f32 projected queries
    block_rows: int,
    q_tile: int = 256,
    sub_rows: int = 32,
    num_warps: int = 8,
    num_stages: int = 2,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`window_scan_xla`'s contract through the fused Triton kernel.

    ``q_tile`` queries share one program, so each window's codes are
    gathered and decoded once per tile; smaller batches shrink the tile to
    the next power of two (≥ 16, the dot's minimum). ``sub_rows`` rows are
    scored per step of the window loop. The returned scores carry the
    window-local row in their low mantissa bits (cleared); only their order
    matters — the caller rescores the winners exactly. ``interpret`` is for
    tests on the CPU."""
    m, n = codes_t.shape
    nq, d = qp.shape
    d_pad = table.shape[1]
    assert n % block_rows == 0, (n, block_rows)
    assert block_rows & (block_rows - 1) == 0 and block_rows >= 16, block_rows
    sub_rows = min(sub_rows, block_rows)
    nwin = n // block_rows
    q_tile = max(16, min(q_tile, 1 << (max(nq, 1) - 1).bit_length()))
    nq_p = -(-nq // q_tile) * q_tile
    qp_p = jnp.pad(qp, ((0, nq_p - nq), (0, d_pad - d)))
    qn = jnp.sum(qp_p * qp_p, axis=1)
    if codes_t.dtype != jnp.uint8:
        codes_t = codes_t.astype(jnp.uint8)
    kernel = functools.partial(_window_kernel, m=m, l=d // m,
                               block_rows=block_rows, sub_rows=sub_rows)
    packed = pl.pallas_call(
        kernel,
        grid=(nq_p // q_tile, nwin),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec((q_tile, d_pad), lambda i, w: (i, 0)),
            pl.BlockSpec((q_tile,), lambda i, w: (i,)),
        ],
        out_specs=pl.BlockSpec((None, q_tile), lambda i, w: (w, i)),
        out_shape=jax.ShapeDtypeStruct((nwin, nq_p), jnp.int32),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="codes_window_scan",
    )(codes_t, table, qp_p.astype(jnp.bfloat16), qn)
    packed = packed.T[:nq]                                   # (nq, nwin)
    idx_mask = (1 << max(1, (block_rows - 1).bit_length())) - 1
    scores = jax.lax.bitcast_convert_type(packed & ~idx_mask, jnp.float32)
    base = jnp.arange(nwin, dtype=jnp.int32) * block_rows
    return scores, (packed & idx_mask) + base[None, :]


def rescore_codes(cand_codes: jnp.ndarray, rows_f32: jnp.ndarray,
                  qp: jnp.ndarray) -> jnp.ndarray:
    """Exact ‖q − x̂‖² in f32 for candidate codes (nq, kk, M) against their
    queries (nq, d); rows_f32 is the (C, d) table of build_decode_tables."""
    nq, kk, m = cand_codes.shape
    d = rows_f32.shape[1]
    sub = jnp.arange(d) // (d // m)
    codes_rep = cand_codes.astype(jnp.int32)[:, :, sub]      # (nq, kk, d)
    xhat = rows_f32[codes_rep, jnp.arange(d)]                # (nq, kk, d)
    diff = qp[:, None, :] - xhat
    return jnp.sum(diff * diff, axis=2)


@functools.partial(jax.jit, static_argnames=("k", "block_rows", "impl"))
def decode_scan_topk(
    codes_t: jnp.ndarray,    # (M, n) — the index's transposed storage
    table: jnp.ndarray,      # (C, d_pad) bf16 from build_decode_tables
    rows_f32: jnp.ndarray,   # (C, d) f32 from build_decode_tables
    qp: jnp.ndarray,         # (nq, d) f32 projected queries
    k: int,
    n_valid: Optional[jnp.ndarray] = None,
    block_rows: int = 512,
    impl: Optional[str] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Codes-resident search: window scan → best 2k windows → exact f32
    rescore of their winners. Returns (sq_dists (nq, k), ids (nq, k))
    ascending; distances are exact ADC sums for the returned ids, −1/inf
    pad missing results. ``impl`` ("xla" | "triton") defaults to the
    platform's choice."""
    impl = impl or platform.choose("codes_window_scan")
    m, n = codes_t.shape
    nq = qp.shape[0]
    pad = (-n) % block_rows
    codes_p = jnp.pad(codes_t, ((0, 0), (0, pad)))
    if impl == "triton":
        scores, ids = window_scan_triton(codes_p, table, qp, block_rows)
    else:
        scores, ids = window_scan_xla(codes_p, table, qp, block_rows)
    if n_valid is None:
        n_valid = jnp.int32(n)
    invalid = ids >= n_valid
    scores = jnp.where(invalid, jnp.inf, scores)

    # 2k-window over-fetch: two near rows that share a window leave one
    # behind; the exact rescore below orders what was fetched
    kk = min(2 * k, scores.shape[1])
    neg, pos = jax.lax.top_k(-scores, kk)
    top_ids = jnp.take_along_axis(ids, pos, axis=1)          # (nq, kk)
    top_ids = jnp.where(jnp.isfinite(neg), top_ids, -1)
    cand = jnp.transpose(codes_p[:, jnp.maximum(top_ids, 0)], (1, 2, 0))
    d2 = rescore_codes(cand, rows_f32, qp)
    d2 = jnp.where(top_ids >= 0, d2, jnp.inf)
    if kk < k:
        d2 = jnp.pad(d2, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        top_ids = jnp.pad(top_ids, ((0, 0), (0, k - kk)), constant_values=-1)
    neg2, pos2 = jax.lax.top_k(-d2, k)
    out_ids = jnp.take_along_axis(top_ids, pos2, axis=1)
    return -neg2, jnp.where(jnp.isfinite(neg2), out_ids, -1)

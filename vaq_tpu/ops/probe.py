"""Cluster-probe dispatch and scoring — the core shared by the VAQ TI/IVF
path and the binary engine's cluster-pruned Hamming queries.

The reference visits clusters per query in a data-dependent loop
(``searchTriangleInequality`` VAQ.cpp:1540-1692, ``queryWithClusterInfo``
BitVecEngine.cpp:204-449). Here that becomes a static-shape, batched,
MoE-style dispatch:

1. **probe selection** (`dynamic_probe`): per-query cluster distances →
   top-``p_max`` nearest clusters, then the reference's dynamic
   *visit-until-≥k-members* rule (VAQ.cpp:1548-1551, BitVecEngine.cpp:213-
   230): each query activates ``max(p_visit, smallest prefix holding ≥ k
   members)`` clusters, the rest of its probe slots are masked;
2. **capacity dispatch** (`dispatch_table`): the (query, cluster) pairs are
   ranked within each cluster and scattered into a static ``(ncl, qcap)``
   table of query ids — exactly the expert-capacity dispatch of MoE layers;
   overflow beyond ``qcap`` is dropped (callers size qcap with slack);
3. the caller scores each cluster's bucket against its ≤ qcap queries with
   one batched matmul / XOR-popcount and merges per-query candidates back
   through `gather_merge_topk` — a gather, not a scatter, because every
   (query, slot) pair knows its (cluster, rank) position.

For the VAQ probe the scoring reduces each ``gs``-row group (window) of a
bucket to its minimum distance (`groupmin_window_scan`), the merge keeps the
best windows per query, and `window_rescore` scores those windows' rows
again from the buckets (see ``vaq_tpu.ivf.probe_scan``).

All shapes static; the only approximations are the probe fraction itself
and qcap overflow (both measured in tests).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

#: distances at or above this are treated as "definitely not a candidate";
#: bf16 sentinel rows produce ~1e32 > this, live rows are far below it
SENTINEL_DIST = 1e30

#: f32 score bytes the group-min scan materialises per step
_GROUPMIN_STEP_BYTES = 1 << 28


def cluster_sq_dists(qseg: jnp.ndarray, centroids: jnp.ndarray) -> jnp.ndarray:
    """(nq, s) × (ncl, s) → (nq, ncl) squared L2 (the query→centroid setup,
    VAQ.cpp:799-827 — the reference sqrt's these; order is unchanged)."""
    qn = jnp.sum(qseg * qseg, axis=1, keepdims=True)
    cn = jnp.sum(centroids * centroids, axis=1)
    return qn - 2.0 * jnp.dot(qseg, centroids.T,
                              preferred_element_type=jnp.float32) + cn[None, :]


def dynamic_probe(
    cd: jnp.ndarray,        # (nq, ncl) query→cluster distances
    sizes: jnp.ndarray,     # (ncl,) live member counts
    k: int,
    p_visit: int,
    p_max: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Select each query's probe list and activity mask.

    Returns (probe (nq, p_max) i32 cluster ids sorted by distance,
    active (nq, p_max) bool). A query activates its nearest
    ``max(p_visit, smallest prefix with ≥ k members)`` clusters — the
    reference's visit-until-≥k rule with the visit-fraction floor.
    """
    _, probe = jax.lax.top_k(-cd, p_max)
    members = sizes[probe]                                 # (nq, p_max)
    cum = jnp.cumsum(members, axis=1)
    need = 1 + jnp.sum(cum < k, axis=1)                    # prefix with ≥ k
    p_q = jnp.clip(jnp.maximum(p_visit, need), 1, p_max)
    slot = jax.lax.broadcasted_iota(jnp.int32, probe.shape, 1)
    return probe.astype(jnp.int32), slot < p_q[:, None]


def dispatch_table(
    probe: jnp.ndarray,     # (nq, p_max) i32
    active: jnp.ndarray,    # (nq, p_max) bool
    ncl: int,
    qcap: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build the (ncl, qcap) table of query ids per cluster.

    Sort- and scatter-free formulation: a (nq, ncl) membership mask is
    built by a fused one-hot
    reduction, per-cluster ranks are its exclusive column cumsum, and the
    table itself is one batched per-cluster sort of query ids (occupied
    slots sort ahead of the ``nq`` sentinel).

    Returns (table (ncl, qcap) i32 with nq = empty slot,
             ok (nq·p_max,) bool — entry dispatched,
             ent_c (nq·p_max,) i32 — entry's cluster,
             ent_r (nq·p_max,) i32 — entry's rank within the cluster).
    """
    nq, p_max = probe.shape
    oh = jax.nn.one_hot(jnp.where(active, probe, ncl), ncl + 1,
                        dtype=jnp.bfloat16)            # fused into the sum
    mask = jnp.einsum("qpc->qc", oh)[:, :ncl] > 0.5    # (nq, ncl)
    mask_i = mask.astype(jnp.int32)
    rank_excl = jnp.cumsum(mask_i, axis=0) - mask_i
    ent_r = jnp.take_along_axis(rank_excl, probe, axis=1)  # (nq, p_max)
    ok = active & (ent_r < qcap)
    colq = jnp.where(mask, jax.lax.broadcasted_iota(jnp.int32, mask.shape, 0),
                     nq).T                             # (ncl, nq)
    table = jax.lax.sort(colq, dimension=1)[:, :qcap]
    return (table, ok.reshape(-1), jnp.where(ok, probe, 0).reshape(-1),
            jnp.where(ok, ent_r, 0).reshape(-1))


def gather_merge_topk(
    vals: jnp.ndarray,      # (ncl, qcap, kk) per-(cluster, slot) top scores
    ids: jnp.ndarray,       # (ncl, qcap, kk) their global row ids
    ok: jnp.ndarray,        # (nq·p_max,) dispatched mask
    ent_c: jnp.ndarray,
    ent_r: jnp.ndarray,
    nq: int,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-query merge: gather each entry's per-cluster candidates and take
    the final top-k by score (descending score = ascending distance).

    The candidate gathers use flat 1-D row indices (``c·qcap + r``), a
    plain row gather, rather than the 2-D fancy-index form
    ``vals[ent_c, ent_r]``.
    """
    ncl, qcap, kk = vals.shape
    flat_idx = ent_c * qcap + ent_r
    cand_v = jnp.where(ok[:, None], vals.reshape(ncl * qcap, kk)[flat_idx],
                       -jnp.inf)
    cand_i = jnp.where(ok[:, None], ids.reshape(ncl * qcap, kk)[flat_idx],
                       -1)
    cand_v = cand_v.reshape(nq, -1)
    cand_i = cand_i.reshape(nq, -1)
    kk_out = min(k, cand_v.shape[1])
    top_v, pos = jax.lax.top_k(cand_v, kk_out)
    top_i = jnp.take_along_axis(cand_i, pos, axis=1)
    if kk_out < k:
        top_v = jnp.pad(top_v, ((0, 0), (0, k - kk_out)),
                        constant_values=-jnp.inf)
        top_i = jnp.pad(top_i, ((0, 0), (0, k - kk_out)),
                        constant_values=-1)
    return top_v, top_i


def pick_qcap(nq: int, p_max: int, ncl: int, slack: float = 2.0) -> int:
    """Static per-cluster query capacity: ~slack× the mean demand, rounded
    up to a multiple of 8, capped at nq (no drops possible there)."""
    mean = nq * p_max / max(ncl, 1)
    cap = int(-(-slack * mean // 8)) * 8 + 8
    return max(8, min(nq, cap))


def blocked_cluster_topk(
    score_fn,
    n_blocks: int,
    kk: int,
    exact: bool = True,
):
    """Helper: run ``score_fn(block_index) -> (CB, qcap, cap) scores`` over
    ``n_blocks`` cluster blocks under lax.map, taking per-(cluster, slot)
    top-kk as it goes. Returns (vals (ncl, qcap, kk), pos (ncl, qcap, kk))."""

    def one(b):
        s = score_fn(b)                                    # (CB, qcap, cap)
        cb, qcap, cap = s.shape
        flat = s.reshape(cb * qcap, cap)
        kkk = min(kk, cap)
        if exact:
            v, p = jax.lax.top_k(flat, kkk)
        else:
            v, p = jax.lax.approx_max_k(flat, kkk, recall_target=0.95)
            p = p.astype(jnp.int32)
        if kkk < kk:
            v = jnp.pad(v, ((0, 0), (0, kk - kkk)), constant_values=-jnp.inf)
            p = jnp.pad(p, ((0, 0), (0, kk - kkk)), constant_values=0)
        return v.reshape(cb, qcap, kk), p.reshape(cb, qcap, kk)

    vals, pos = jax.lax.map(one, jnp.arange(n_blocks))
    # (n_blocks, CB, qcap, kk) → (ncl, qcap, kk)
    return (vals.reshape(-1, vals.shape[2], kk),
            pos.reshape(-1, pos.shape[2], kk))


def poison_pattern(d: int) -> np.ndarray:
    """The int8 padding/deleted-slot row: alternating ±127.

    Its reconstruction has the maximum possible norm B = Σ_d max_d², and
    the alternating signs keep |q·x̂_pad| small for natural queries, so its
    distance ranks at/above every live row. (Ranking guard only — the
    rescore masks poisoned slots exactly via bucket_ids == -1.)
    """
    pat = np.full((d,), 127, dtype=np.int8)
    pat[1::2] = -127
    return pat


def pick_gs(cap: int, target_ng: int = 240, gs_max: int = 256) -> int:
    """Window (group) size for a bucket capacity: grow while each bucket
    keeps more than ``target_ng`` windows, up to ``gs_max``. gs trades the
    group-min output and merge traffic (ncl·cap/gs·qcap values) against the
    window rescore (2k·gs rows per query); correctness does not depend on
    it. ``cap`` is a multiple of 512, so every gs ≤ 256 divides it."""
    gs = 8
    while gs < gs_max and cap // gs > target_ng:
        gs *= 2
    return gs


def _row_norms(rows_f32: jnp.ndarray, dim_w: jnp.ndarray,
               transposed: bool) -> jnp.ndarray:
    """‖x̂‖² = Σ_d rows²·w (w = 1/scales² for int8 rows, ones for bf16);
    exact in f32 for int8 integers and bf16 values."""
    axis = 0 if transposed else 1
    w = dim_w[:, None] if transposed else dim_w[None, :]
    return jnp.sum(rows_f32 * rows_f32 * w, axis=axis)


@functools.partial(jax.jit, static_argnames=("gs", "transposed"))
def groupmin_window_scan(
    qsl: jnp.ndarray,          # (ncl, qcap, d) bf16 query slabs, −2-scaled
    bucket_rows: jnp.ndarray,  # (ncl, cap, d) int8|bf16 — (ncl, d, cap)
    #                            when transposed
    dim_w: jnp.ndarray,        # (d,) f32 norm weights (1/scales² | ones)
    gs: int,
    transposed: bool = False,
) -> jnp.ndarray:
    """Per-(cluster, gs-row group, query slot) minimum squared distance.

    ``dist = −2q·x̂ + ‖x̂‖² + ‖q‖²`` with the −2 folded into the bf16 query
    slab (and the int8 per-dim scales, when the rows are int8), bf16
    products accumulated in f32. Clusters are scored in steps under
    ``lax.map`` so the (clusters, cap, qcap) f32 score block is bounded.
    Returns (ncl, cap // gs, qcap) f32 window-ranking values; exact
    distances come from the caller's rescore."""
    ncl, qcap, d = qsl.shape
    cap = bucket_rows.shape[2] if transposed else bucket_rows.shape[1]
    assert cap % gs == 0, (cap, gs)
    step = max(1, min(ncl, _GROUPMIN_STEP_BYTES // (4 * cap * qcap)))

    def one(args):
        q, rows = args
        rb = rows.astype(jnp.bfloat16)
        spec = "dr,qd->rq" if transposed else "rd,qd->rq"
        dot = jnp.einsum(spec, rb, q, precision=jax.lax.Precision.DEFAULT,
                         preferred_element_type=jnp.float32)  # (cap, qcap)
        xn = _row_norms(rb.astype(jnp.float32), dim_w, transposed)
        qf = q.astype(jnp.float32)
        qn = 0.25 * jnp.sum(qf * qf, axis=1)
        dist = dot + xn[:, None] + qn[None, :]
        return jnp.min(dist.reshape(cap // gs, gs, qcap), axis=1)

    return jax.lax.map(one, (qsl, bucket_rows), batch_size=step)


def window_rescore(
    q_eff: jnp.ndarray,        # (nq, d) f32 folded queries (q / scales)
    dim_w: jnp.ndarray,        # (d,) f32 norm weights
    bucket_rows: jnp.ndarray,  # (ncl, cap, d) — or (ncl, d, cap) transposed
    wblk: jnp.ndarray,         # (nq, m) i32 window ids (cluster·ng + group)
    gs: int,
    transposed: bool = False,
) -> jnp.ndarray:
    """Scores (nq, m, gs) f32: 2·q·x̂ − ‖x̂‖² for every row of every listed
    window, gathered as contiguous gs-row slabs. The caller masks dead slots
    (bucket_ids == −1) and merges."""
    d = q_eff.shape[1]
    rows_std = (jnp.swapaxes(bucket_rows, 1, 2) if transposed
                else bucket_rows)
    blk = rows_std.reshape(-1, gs, d)[wblk]                  # (nq, m, gs, d)
    inner = jnp.einsum("qd,qmgd->qmg", q_eff.astype(jnp.bfloat16),
                       blk.astype(jnp.bfloat16),
                       precision=jax.lax.Precision.DEFAULT,
                       preferred_element_type=jnp.float32)
    blk_f = blk.astype(jnp.float32)
    return 2.0 * inner - jnp.sum(blk_f * blk_f * dim_w, axis=3)

"""Sharded search: per-shard top-k → all-gather → global top-k.

Device-mesh re-design of the reference's disk-resident chunked scan
(``BitVecEngine.cpp:1441-1624``): there, file chunks are scanned with
per-chunk top-k and merged into global answers by concatenate+sort+resize
(merge at cpp:1599-1611), with ids offset by the chunk base (cpp:1488). Here
the "chunks" are mesh shards of the encoded code rows, the per-chunk top-k is
the on-device blocked scan, and the merge is a k-row ``all_gather`` over the
"db" mesh axis followed by a final ``top_k`` — the only cross-device data in
the hot path is k·(dist,id) per shard, so scaling is near-linear (SURVEY §5).

Queries can additionally be sharded over a "q" axis (data parallel over the
query stream); results come back sharded the same way.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from vaq_tpu.ops import scan_decoded, scan_jax
from vaq_tpu.ops.distances import pairwise_sq_dists


def shard_codes(codes: jnp.ndarray, mesh: Mesh, axis: str = "db") -> jnp.ndarray:
    """Place code rows row-sharded over the mesh's db axis (zero-pads to a
    multiple of the axis size)."""
    n = codes.shape[0]
    nshards = mesh.shape[axis]
    pad = (-n) % nshards
    if pad:
        codes = jnp.pad(codes, ((0, pad), (0, 0)))
    spec = P(axis, *([None] * (codes.ndim - 1)))
    return jax.device_put(codes, NamedSharding(mesh, spec))


def _local_topk_merge(local_d, local_i, k, db_axis):
    """All-gather each shard's top-k and reduce to the global top-k."""
    gat_d = jax.lax.all_gather(local_d, db_axis, axis=1, tiled=True)
    gat_i = jax.lax.all_gather(local_i, db_axis, axis=1, tiled=True)
    neg_top, pos = jax.lax.top_k(-gat_d, k)
    return -neg_top, jnp.take_along_axis(gat_i, pos, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "mesh", "block_rows", "q_axis", "db_axis"),
)
def sharded_adc_search(
    codes: jnp.ndarray,
    luts: jnp.ndarray,
    k: int,
    n_total: jnp.ndarray,
    mesh: Mesh,
    block_rows: int = 32768,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ADC scan over row-sharded codes with replicated (or q-sharded) LUTs.

    Args:
      codes: (n_pad, M) sharded P(db_axis, None); n_pad divisible by #shards.
      luts: (nq, M, C) float32; replicated, or sharded P(q_axis, ...) when
        q_axis is given.
      k: neighbors per query.
      n_total: scalar — true row count (padding rows past it are masked).
      mesh: the device mesh.

    Returns:
      (sq_dists, labels) of shape (nq, k); global ids. Replicated over the db
      axis, sharded over q_axis if given.
    """
    n_pad = codes.shape[0]
    nshards = mesh.shape[db_axis]
    shard_rows = n_pad // nshards

    lut_spec = P(q_axis, None, None) if q_axis else P(None, None, None)
    out_spec = (P(q_axis, None) if q_axis else P(None, None),) * 2

    def local(codes_l, luts_l, n_total_l):
        sidx = jax.lax.axis_index(db_axis)
        base = sidx * shard_rows
        n_valid_local = jnp.clip(n_total_l - base, 0, shard_rows)
        d, i = scan_jax.adc_scan_topk(
            codes_l, luts_l, k, n_valid=n_valid_local.astype(jnp.int32),
            block_rows=min(block_rows, shard_rows),
        )
        gi = jnp.where(i >= 0, i + base, -1)
        return _local_topk_merge(d, gi, k, db_axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(db_axis, None), lut_spec, P()),
        out_specs=out_spec,
        check_vma=False,
    )(codes, luts, n_total)


@functools.partial(
    jax.jit,
    static_argnames=("k", "mesh", "exact", "recall_target", "q_axis",
                     "db_axis"),
)
def sharded_decoded_search(
    decoded: jnp.ndarray,
    norms: jnp.ndarray,
    luts_or_qp: jnp.ndarray,
    k: int,
    n_total: jnp.ndarray,
    mesh: Mesh,
    exact: bool = False,
    recall_target: float = 0.99,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sharded version of the decoded fast path: bf16 rows row-sharded over
    the db axis, projected queries replicated (or q-sharded); per-shard fused
    matmul + approx-top-k + exact rescore, then the k-row all_gather merge.

    luts_or_qp: (nq, D) *projected* queries (named for API symmetry with
    sharded_adc_search).
    """
    n_pad = decoded.shape[0]
    nshards = mesh.shape[db_axis]
    shard_rows = n_pad // nshards
    qp = luts_or_qp

    q_spec = P(q_axis, None) if q_axis else P(None, None)
    out_spec = (P(q_axis, None) if q_axis else P(None, None),) * 2

    def local(dec_l, norms_l, qp_l, n_total_l):
        sidx = jax.lax.axis_index(db_axis)
        base = sidx * shard_rows
        n_valid_local = jnp.clip(n_total_l - base, 0, shard_rows)
        d, i = scan_decoded.decoded_scan_topk(
            dec_l, norms_l, qp_l, k,
            n_valid=n_valid_local.astype(jnp.int32),
            exact=exact, recall_target=recall_target)
        gi = jnp.where(i >= 0, i + base, -1)
        d = jnp.where(i >= 0, d, jnp.inf)
        return _local_topk_merge(d, gi, k, db_axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(db_axis, None), P(db_axis), q_spec, P()),
        out_specs=out_spec,
        check_vma=False,
    )(decoded, norms, qp, n_total)


@functools.partial(
    jax.jit,
    static_argnames=("k", "mesh", "exact", "recall_target", "q_axis",
                     "db_axis"),
)
def sharded_decoded8_search(
    decoded8: jnp.ndarray,
    dim_scales: jnp.ndarray,
    norms: jnp.ndarray,
    qp: jnp.ndarray,
    k: int,
    n_total: jnp.ndarray,
    mesh: Mesh,
    exact: bool = False,
    recall_target: float = 0.99,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sharded int8 capacity tier: the (D, n) transposed int8 rows are
    column-sharded over the db axis (the row axis of the database), per-dim
    scales and queries replicated (or q-sharded), per-shard
    ``decoded8_scan_topk`` + the k-row all_gather merge. Sharding extends
    the tier's capacity linearly (the disk-resident blueprint,
    BitVecEngine.cpp:1441-1624, with chunks = shards)."""
    n_pad = decoded8.shape[1]
    nshards = mesh.shape[db_axis]
    shard_rows = n_pad // nshards

    q_spec = P(q_axis, None) if q_axis else P(None, None)
    out_spec = (P(q_axis, None) if q_axis else P(None, None),) * 2

    def local(d8_l, scales_l, norms_l, qp_l, n_total_l):
        sidx = jax.lax.axis_index(db_axis)
        base = sidx * shard_rows
        n_valid_local = jnp.clip(n_total_l - base, 0, shard_rows)
        d, i = scan_decoded.decoded8_scan_topk(
            d8_l, scales_l, norms_l, d8_l, qp_l, k,
            n_valid=n_valid_local.astype(jnp.int32),
            exact=exact, recall_target=recall_target)
        gi = jnp.where(i >= 0, i + base, -1)
        d = jnp.where(i >= 0, d, jnp.inf)
        return _local_topk_merge(d, gi, k, db_axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, db_axis), P(None), P(db_axis), q_spec, P()),
        out_specs=out_spec,
        check_vma=False,
    )(decoded8, dim_scales, norms, qp, n_total)


@functools.partial(
    jax.jit,
    static_argnames=("k", "mesh", "block_rows", "q_axis", "db_axis"),
)
def sharded_codes_search(
    codes_t: jnp.ndarray,
    dec_table: jnp.ndarray,
    rows_f32: jnp.ndarray,
    qp: jnp.ndarray,
    k: int,
    n_total: jnp.ndarray,
    mesh: Mesh,
    block_rows: int = 512,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sharded codes-resident tier: the (M, n) transposed u8 codes are
    column-sharded over the db axis, the decode tables replicated (tiny —
    C rows of d values), per-shard decode-then-dot window scan + the k-row
    all_gather merge. At M bytes/row this is the tier that holds the most
    rows per device."""
    n_pad = codes_t.shape[1]
    nshards = mesh.shape[db_axis]
    shard_rows = n_pad // nshards

    from vaq_tpu.ops import scan_codes

    q_spec = P(q_axis, None) if q_axis else P(None, None)
    out_spec = (P(q_axis, None) if q_axis else P(None, None),) * 2

    def local(codes_l, table_l, rows_l, qp_l, n_total_l):
        sidx = jax.lax.axis_index(db_axis)
        base = sidx * shard_rows
        n_valid_local = jnp.clip(n_total_l - base, 0, shard_rows)
        d, i = scan_codes.decode_scan_topk(
            codes_l, table_l, rows_l, qp_l, k,
            n_valid=n_valid_local.astype(jnp.int32),
            block_rows=block_rows)
        gi = jnp.where(i >= 0, i + base, -1)
        d = jnp.where(i >= 0, d, jnp.inf)
        return _local_topk_merge(d, gi, k, db_axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, db_axis), P(None, None), P(None, None), q_spec,
                  P()),
        out_specs=out_spec,
        check_vma=False,
    )(codes_t, dec_table, rows_f32, qp, n_total)


@functools.partial(
    jax.jit,
    static_argnames=("k", "mesh", "p_visit", "p_max", "qcap", "gs",
                     "exact", "transposed", "q_axis", "db_axis"),
)
def sharded_ivf_search(
    centroids: jnp.ndarray,     # (ncl_pad, seg_dims) cluster-sharded
    bucket_rows: jnp.ndarray,   # (ncl_pad, cap, D) int8|bf16 —
    #                             (ncl_pad, D, cap) when transposed
    bucket_ids: jnp.ndarray,    # (ncl_pad, cap) i32 — GLOBAL row ids
    sizes: jnp.ndarray,         # (ncl_pad,) i32
    dim_scales,                 # (D,) f32 or None (int8 rows only)
    qp: jnp.ndarray,            # (nq, D) projected queries
    k: int,
    mesh: Mesh,
    p_visit: int,               # per-shard visit budget (local clusters)
    p_max: int,
    qcap: int,
    gs: int,
    exact: bool = False,
    transposed: bool = False,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
    rescore_rows: Optional[jnp.ndarray] = None,   # (n_pad, D) P(db, None)
    rescore_norms: Optional[jnp.ndarray] = None,  # (n_pad,) P(db), +inf dead
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sharded IVF/TI cluster probe: buckets sharded over the CLUSTER axis,
    each shard probing its local clusters with the same visit fraction,
    per-shard ``ivf.probe_scan`` + the k-row all_gather merge. This is the
    device-mesh re-design of the reference's disk-resident *cluster* scan (``BitVecEngine.cpp:1024-1139``): its chunks hold whole
    clusters and merge per-chunk answers — here the chunks are mesh shards.

    Semantics note: each query visits its nearest ``p_visit`` clusters *per
    shard* (total fraction = the configured ``visit``), rather than the
    global nearest ``visit·ncl`` — the same candidate-budget contract, with
    composition differing per shard exactly as the reference's per-chunk
    cluster visiting does. Bucket ids are global, so no offset is needed.
    Padded clusters carry far centroids, zero sizes, sentinel/poison rows
    and all-(-1) bucket_ids; they rank last in the probe and their windows
    are masked out of the rescore by the ids contract.

    Second-stage exact rescore: with ``rescore_rows`` /
    ``rescore_norms`` (the ROW-sharded bf16 decoded tier + its +inf-masked
    norms), each shard returns its stage-1 top-2k, the all_gather merge
    selects the global 2k candidates, and the final metric is computed
    distributed: each shard scores the candidates whose rows it owns and a
    ``psum`` assembles the exact scores (the reference's chunk merge also
    returns final-metric distances, BitVecEngine.cpp:1599-1611). Without
    it, the sharded int8 probe serves stage-1 int8-metric selection.
    """
    from vaq_tpu import ivf as ivf_mod

    q_spec = P(q_axis, None) if q_axis else P(None, None)
    out_spec = (P(q_axis, None) if q_axis else P(None, None),) * 2
    scales_spec = (P(None),) if dim_scales is not None else ()
    scales_arg = (dim_scales,) if dim_scales is not None else ()
    with_rescore = rescore_rows is not None
    if with_rescore and rescore_norms is None:
        raise ValueError("rescore_rows requires rescore_norms")
    res_spec = (P(db_axis, None), P(db_axis)) if with_rescore else ()
    res_arg = (rescore_rows, rescore_norms) if with_rescore else ()
    if with_rescore:
        shard_rows = rescore_rows.shape[0] // mesh.shape[db_axis]
    # stage-1 over-fetch for the rescore; probe_scan pads short results
    k1 = 2 * k if with_rescore else k

    def local(cents_l, rows_l, ids_l, sizes_l, *rest):
        rest = list(rest)
        scales_l = rest.pop(0) if dim_scales is not None else None
        if with_rescore:
            dec_l, norms_l = rest.pop(0), rest.pop(0)
        qp_l = rest.pop(0)
        d, i = ivf_mod.probe_scan(
            qp_l, cents_l, rows_l, ids_l, sizes_l, k1,
            p_visit, p_max, qcap, dim_scales=scales_l, exact=exact,
            gs=gs, transposed=transposed)
        d, cand = _local_topk_merge(d, i, k1, db_axis)
        if not with_rescore:
            return d, cand
        # distributed exact rescore: exactly one shard owns each candidate
        # row; it contributes 2·q·x − ‖x‖² (−inf for tombstones via the
        # +inf norms), the psum assembles the full scores.
        base = jax.lax.axis_index(db_axis) * shard_rows
        lid = cand - base
        owned = (lid >= 0) & (lid < shard_rows) & (cand >= 0)
        lid_safe = jnp.clip(lid, 0, shard_rows - 1)
        rr = dec_l[lid_safe]                             # (nq, k1, D)
        inner = jnp.einsum("qd,qkd->qk", qp_l.astype(jnp.bfloat16),
                           rr.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
        contrib = jnp.where(owned, 2.0 * inner - norms_l[lid_safe], 0.0)
        score2 = jax.lax.psum(contrib, db_axis)
        score2 = jnp.where((cand >= 0) & jnp.isfinite(d), score2, -jnp.inf)
        top_s, pos = jax.lax.top_k(score2, k)
        top_i = jnp.take_along_axis(cand, pos, axis=1)
        qn = jnp.sum(qp_l * qp_l, axis=1)
        d2 = jnp.maximum(qn[:, None] - top_s, 0.0)
        fin = jnp.isfinite(top_s)
        return jnp.where(fin, d2, jnp.inf), jnp.where(fin, top_i, -1)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(db_axis, None), P(db_axis, None, None),
                  P(db_axis, None), P(db_axis),
                  *scales_spec, *res_spec, q_spec),
        out_specs=out_spec,
        check_vma=False,
    )(centroids, bucket_rows, bucket_ids, sizes,
      *scales_arg, *res_arg, qp)


@functools.partial(
    jax.jit,
    static_argnames=("k", "mesh", "block_rows", "q_axis", "db_axis"),
)
def sharded_exact_search(
    db: jnp.ndarray,
    queries: jnp.ndarray,
    k: int,
    n_total: jnp.ndarray,
    mesh: Mesh,
    block_rows: int = 131072,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Brute-force L2 top-k over row-sharded original vectors — the sharded
    groundtruth generator / rerank backend (reference queryNaiveParallel
    with the disk-resident merge, BitVecEngine.cpp:1441-1624)."""
    n_pad = db.shape[0]
    nshards = mesh.shape[db_axis]
    shard_rows = n_pad // nshards

    q_spec = P(q_axis, None) if q_axis else P(None, None)
    out_spec = (P(q_axis, None) if q_axis else P(None, None),) * 2

    def local(db_l, q_l, n_total_l):
        sidx = jax.lax.axis_index(db_axis)
        base = sidx * shard_rows
        d2 = pairwise_sq_dists(q_l, db_l)
        ids = base + jnp.arange(shard_rows, dtype=jnp.int32)
        d2 = jnp.where(ids[None, :] < n_total_l, d2, jnp.inf)
        kk = min(k, shard_rows)
        neg_top, pos = jax.lax.top_k(-d2, kk)
        local_d, local_i = -neg_top, ids[pos]
        if kk < k:  # pad so the gather shape is k per shard
            padw = k - kk
            local_d = jnp.pad(local_d, ((0, 0), (0, padw)),
                              constant_values=jnp.inf)
            local_i = jnp.pad(local_i, ((0, 0), (0, padw)),
                              constant_values=-1)
        return _local_topk_merge(local_d, local_i, k, db_axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(db_axis, None), q_spec, P()),
        out_specs=out_spec,
        check_vma=False,
    )(db, queries, n_total)

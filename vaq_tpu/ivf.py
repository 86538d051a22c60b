"""IVF-style cluster probing — the batched analog of triangle-inequality
pruning.

The reference's TI path (``VAQ::clusterTI`` VAQ.cpp:878-999 +
``searchTriangleInequality`` VAQ.cpp:1540-1692) builds k-means clusters in
*reconstructed code space* over the first ``ti_segment_num`` subspaces,
sorts each cluster's members by distance-to-centroid, and at query time
visits nearest clusters — at least the ``visit`` fraction, and at least
until ≥ k members have been seen (VAQ.cpp:1548-1551) — breaking out of a
cluster when the triangle inequality proves the rest can't win.

Per-row branchy exits don't vectorize, so everything else runs as ONE
batched device program via the MoE-style dispatch in ``vaq_tpu.ops.probe``:

  cluster distances (matmul) → dynamic visit-until-≥k probe masks →
  per-cluster query lists (static capacity) → one blocked batched matmul
  scoring every probed (cluster × its queries) pair, reduced to one minimum
  per gs-row window → per-query window merge → exact rescore of the winner
  windows' rows.

The `visit` knob trades recall for scanned rows exactly as in the
reference; the TI per-row break is replaced by not scanning unprobed
clusters at all. The exhaustive decoded scan is one large matmul, so
probing pays only where it cuts real work: int8 bucket rows halve the bytes
streamed, and the database must dwarf the query batch. Window minima stay
f32: bf16 minima round away the gaps between windows (see
tests/test_probe_groupmin.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vaq_tpu import kmeans
from vaq_tpu.errors import ConfigError
from vaq_tpu.ops import probe as probe_ops


@dataclasses.dataclass
class IVFState:
    """Bucketed decoded database grouped by cluster (static shapes)."""

    centroids: np.ndarray        # (ncl, seg_dims) f32 cluster centroids
    seg_dims: int                # prefix dims used for cluster distances
    cap: int                     # rows per bucket (padded)
    # Device arrays:
    bucket_rows: jnp.ndarray     # (ncl, cap, D) decoded rows — int8 (the
    #                              default: per-dim scaled, half the bytes
    #                              of bf16) or bf16; padding and deleted
    #                              slots hold sentinels.
    #                              (ncl, D, cap) when ``transposed``.
    bucket_ids: jnp.ndarray      # (ncl, cap) i32 (-1 padding/deleted)
    sizes: jnp.ndarray           # (ncl,) i32 live member counts
    dim_scales: Optional[jnp.ndarray] = None  # (D,) f32 for int8 rows:
    #                              x̂ = bucket_rows / dim_scales
    # NOTE: no norms array — the scan and rescore derive exact norms from
    # the rows themselves (see probe_scan)
    transposed: bool = False     # (ncl, D, cap) storage, chosen when
    #                              D % 128 != 0 (see build_ivf)

    @property
    def ncl(self) -> int:
        return self.centroids.shape[0]

    @property
    def d_full(self) -> int:
        return (self.bucket_rows.shape[1] if self.transposed
                else self.bucket_rows.shape[2])


def resolve_seg_num(cfg, cum_var_per_subs, highest_subs: int) -> int:
    """ti_variance < 1 → #subspaces with cumvar ≤ ti_variance (min 1);
    ti_segment_num == -1 → all kept subspaces (VAQ.cpp:879-893)."""
    if cfg.ti_variance < 1.0:
        seg = int(np.sum(np.asarray(cum_var_per_subs) <= cfg.ti_variance))
        return max(seg, 1)
    if cfg.ti_segment_num == -1:
        return highest_subs
    return int(cfg.ti_segment_num)


def build_ivf(index, verbose: bool = False,
              balance_cap_factor: float = 1.5,
              ti_cluster_num: Optional[int] = None,
              ti_segment_num: Optional[int] = None,
              rows_dtype: str = "int8") -> IVFState:
    """Cluster the decoded database and group rows into padded buckets.

    Mirrors clusterTI(useKMeans=True): k-means in decoded (reconstructed)
    space over the prefix subspaces, assignment by nearest centroid, rows
    regrouped by cluster. Two adaptations for batched probing: (a) the
    member sort by
    distance-to-centroid (which powers the reference's per-row break) is
    unnecessary; (b) clusters larger than ``balance_cap_factor ×`` the mean
    are capacity-bounded — overflow rows move to their next-nearest cluster
    with space — so the static bucket capacity (and with it the batched
    scan's wasted work) stays bounded under k-means imbalance.

    ``rows_dtype`` selects the bucket storage tier: "int8" (default —
    per-dim scales as in the decoded8 tier, scan_decoded.decode_db_int8;
    half the bytes of bf16 for the probe scan to stream) or "bf16" (the
    reconstruction the decoded tier scans). Norms are always the exact f32 norms of the STORED rows, so
    window ranking and the block rescore are exact for the chosen tier.

    ``ti_cluster_num``/``ti_segment_num`` override the config's TI fields
    when given, so benchmark/serving callers never have to mutate
    ``index.config`` to attach probe state.
    """
    if rows_dtype not in ("int8", "bf16"):
        raise ConfigError(f"rows_dtype must be int8|bf16, got {rows_dtype}")
    cfg = index.config
    if ti_cluster_num is not None or ti_segment_num is not None:
        cfg = dataclasses.replace(
            cfg,
            ti_cluster_num=(cfg.ti_cluster_num if ti_cluster_num is None
                            else ti_cluster_num),
            ti_segment_num=(cfg.ti_segment_num if ti_segment_num is None
                            else ti_segment_num))
    index._ensure_decoded()
    dec_dev = index.decoded                     # (n, D) bf16, device
    norms_dev = jnp.asarray(index.decoded_norms)
    n, d_full = dec_dev.shape
    seg_subs = resolve_seg_num(cfg, index.cum_var_per_subs, index.highest_subs)
    seg_subs = min(seg_subs, index.highest_subs)
    seg_dims = seg_subs * index.subs_len
    ncl = int(cfg.ti_cluster_num)
    if ncl <= 0:
        raise ConfigError("ti_cluster_num must be set for the TI/IVF method")

    # Everything data-proportional stays on device: no host round trip of
    # the decoded database.
    prefix = dec_dev[:, :seg_dims].astype(jnp.float32)
    rng = np.random.default_rng(cfg.seed)
    init_idx = (rng.choice(n, size=ncl, replace=False) if n >= ncl
                else rng.choice(n, size=ncl, replace=True))
    c0 = prefix[jnp.asarray(init_idx.astype(np.int32))]
    cents_dev = kmeans.lloyd(prefix, c0, iters=cfg.kmeans_iters)
    assign = np.asarray(kmeans.assign_clusters(prefix, cents_dev),
                        dtype=np.int64)
    cents = np.asarray(cents_dev)

    # Capacity-bounded reassignment: pick the S nearest clusters per row,
    # fill clusters first-choice-first with a hard cap.
    cap = max(1, int(math.ceil(balance_cap_factor * n / ncl)))
    if np.bincount(assign, minlength=ncl).max() > cap:
        s_cand = min(8, ncl)

        # top-S candidate clusters per row, computed in row blocks so the
        # (n, ncl) distance matrix is never materialized (40 GB at 10M×1k)
        @jax.jit
        def _topS(block):
            d2b = probe_ops.cluster_sq_dists(block, cents_dev)
            _, idx = jax.lax.top_k(-d2b, s_cand)
            return idx

        cand = np.empty((n, s_cand), dtype=np.int64)
        blk = 1 << 20
        for start in range(0, n, blk):
            cand[start:start + blk] = np.asarray(
                _topS(prefix[start:start + blk]))
        assign = _fill_capacity(cand, ncl, cap)
    sizes = np.bincount(assign, minlength=ncl)
    # padding slots carry sentinel/poison rows — never winners
    cap = _round_cap(int(max(cap, sizes.max())))
    if verbose:
        print(f"== ivf: {ncl} clusters, seg_dims={seg_dims}, cap={cap}, "
              f"sizes min/mean/max = {sizes.min()}/{sizes.mean():.0f}/"
              f"{sizes.max()}")

    # bucket membership table on host (one vectorized scatter, no per-cluster
    # loop), then ONE device gather materializes the padded buckets from the
    # already-resident decoded DB
    del prefix  # free the f32 projection before materializing buckets
    bids, _ = _bucket_slots(assign, ncl, cap)

    bids_dev = jnp.asarray(bids)
    safe = jnp.maximum(bids_dev, 0).reshape(-1)
    # rows deleted before the build carry +inf norms; exclude them from the
    # live member counts the visit rule uses, and poison their bucket norms
    # so the group-min scan and block rescore can never select them
    live = (bids_dev >= 0) & jnp.isfinite(norms_dev[safe].reshape(ncl, cap))
    dim_scales = None
    if rows_dtype == "int8":
        # Per-dim int8 quantization with the same centroid-extrema scales as
        # the decoded8 tier (scan_decoded.decode_db_int8): the flat (n, D)
        # int8 staging array makes the bucket fill a plain row gather (a
        # column gather from the transposed tiers forces a whole-array
        # relayout copy — the decoded8 rescore hit exactly that).
        cents_fin = np.where(np.abs(index.centroids) < 1e17,
                             np.abs(index.centroids), 0.0)
        dmax = cents_fin.max(axis=1).reshape(-1)[:d_full]    # (D,)
        dim_scales = jnp.asarray(127.0 / np.maximum(dmax, 1e-30),
                                 dtype=np.float32)
        poison = jnp.asarray(probe_ops.poison_pattern(d_full))

        # (norms are NOT computed here — the probe derives exact norms from
        # the rows it scores)
        @jax.jit
        def _quant_block(rows):
            q8 = jnp.clip(jnp.round(rows.astype(jnp.float32)
                                    * dim_scales[None, :]), -127, 127)
            return q8.astype(jnp.int8)

        blk = 1 << 21
        flat8 = jnp.zeros((n, d_full), jnp.int8)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def _write(buf, q8, start):
            return jax.lax.dynamic_update_slice(buf, q8, (start, 0))

        for start in range(0, n, blk):
            flat8 = _write(flat8, _quant_block(dec_dev[start:start + blk]),
                           start)
        # padding/deleted slots hold the max-norm POISON pattern (ranking
        # guard; the rescore masks them exactly via bucket_ids == -1)
        rows_dev = jnp.where(live[:, :, None],
                             flat8[safe].reshape(ncl, cap, d_full),
                             poison[None, None, :])
        del flat8
    else:
        rows_dev = jnp.where(
            live[:, :, None], dec_dev[safe].reshape(ncl, cap, d_full),
            jnp.asarray(1e15, dec_dev.dtype))
    # ids mark dead slots (padding AND pre-build tombstones) with -1 — the
    # rescore's exactness contract
    bids_dev = jnp.where(live, bids_dev, -1)
    live = live.sum(axis=1).astype(jnp.int32)

    transposed = d_full % 128 != 0
    if transposed:
        # (ncl, D, cap): physical = logical for D % 128 != 0 (see IVFState)
        rows_dev = jax.block_until_ready(jnp.swapaxes(rows_dev, 1, 2))
    return IVFState(
        centroids=cents,
        seg_dims=seg_dims,
        cap=cap,
        bucket_rows=rows_dev,
        bucket_ids=bids_dev,
        sizes=live,
        dim_scales=dim_scales,
        transposed=transposed,
    )


def _fill_capacity(cand: np.ndarray, ncl: int, cap: int) -> np.ndarray:
    """Round-based greedy capacity fill: in round j, unplaced rows claim
    their j-th nearest cluster; each cluster admits claimants up to its
    remaining space in row order. Returns assign (n,) with every row placed
    (pathological leftovers go to any cluster with space)."""
    n, s_cand = cand.shape
    fill = np.zeros(ncl, dtype=np.int64)
    assign = np.full(n, -1, dtype=np.int64)
    for j in range(s_cand):
        un = np.flatnonzero(assign < 0)
        if un.size == 0:
            break
        choice = cand[un, j].astype(np.int64)
        order = np.argsort(choice, kind="stable")
        sorted_choice = choice[order]
        seg_start = np.searchsorted(sorted_choice, sorted_choice,
                                    side="left")
        rank = np.arange(un.size) - seg_start
        take = rank < (cap - fill)[sorted_choice]
        assign[un[order[take]]] = sorted_choice[take]
        fill += np.bincount(sorted_choice[take], minlength=ncl)
    spill = np.flatnonzero(assign < 0)
    if spill.size:  # extremely skewed data: fill remaining space
        space = np.maximum(cap - fill, 0)
        slots = np.repeat(np.arange(ncl), space)
        assign[spill] = slots[: spill.size]
    return assign


def _bucket_slots(assign: np.ndarray, ncl: int, cap: int):
    """(bids (ncl, cap) row-id table, dest (n,) flat slot per row)."""
    n = assign.shape[0]
    bids = np.full((ncl, cap), -1, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    seg_start = np.searchsorted(sorted_assign, sorted_assign, side="left")
    rank = np.arange(n) - seg_start
    bids[sorted_assign, rank] = order.astype(np.int32)
    dest = np.empty(n, dtype=np.int64)
    dest[order] = sorted_assign * cap + rank
    return bids, dest


def _round_cap(cap: int) -> int:
    """Round the bucket capacity up to a multiple of 512, so every window
    size of ``probe_ops.pick_gs`` divides it."""
    return -(-cap // 512) * 512


def build_ivf_streamed(index, n_chunks_fn=None, verbose: bool = False,
                       balance_cap_factor: float = 1.05,
                       ti_cluster_num: Optional[int] = None,
                       ti_segment_num: Optional[int] = None,
                       sample_n: int = 2_000_000,
                       chunk_rows: int = 2_000_000,
                       free_codes_before_upload: bool = False,
                       stage_cache: Optional[str] = None) -> IVFState:
    """Capacity-scale int8 bucket build: stream-decode from the resident
    codes, stage buckets on HOST, upload once.

    The standard :func:`build_ivf` decodes the whole database to bf16 on
    device (2·d bytes per row). This variant keeps device transients
    O(chunk):

    1. k-means centroids on a streamed decoded-prefix sample;
    2. per-chunk top-S cluster candidates → host capacity-bounded fill
       (``balance_cap_factor`` defaults tighter here — padded slots are
       pure HBM at this scale);
    3. per-chunk int8 quantization on device, fetched and scattered into a
       host (ncl, cap, D) staging buffer (D bytes per row of host RAM);
    4. one upload of buckets/norms/ids. With ``free_codes_before_upload``
       the codes are dropped from the device first (the capacity flow:
       after this the index serves ONLY the probe tier).

    Matches the reference's disk-resident cluster build + scan
    (BitVecEngine.cpp:1024-1139) where cluster data also lives out-of-core
    until visited.
    """
    cfg = index.config
    if ti_cluster_num is not None or ti_segment_num is not None:
        cfg = dataclasses.replace(
            cfg,
            ti_cluster_num=(cfg.ti_cluster_num if ti_cluster_num is None
                            else ti_cluster_num),
            ti_segment_num=(cfg.ti_segment_num if ti_segment_num is None
                            else ti_segment_num))
    from vaq_tpu.ops import scan_decoded

    d_full = index.total_dim
    ncl = int(cfg.ti_cluster_num)
    if ncl <= 0:
        raise ConfigError("ti_cluster_num must be set for the TI/IVF method")

    # Optional staging cache: a cached (buf, bids, sizes, centroids) bundle
    # lets a retry jump straight to the upload. The cached path never
    # touches the codes — callers may even have set index.codes = None to
    # keep the device empty for the big allocation.
    if stage_cache and os.path.exists(stage_cache):
        z = np.load(stage_cache)
        buf, bids = z["buf"], z["bids"]
        sizes, cl_cents_np = z["sizes"], z["cents"]
        cap = int(z["cap"][0])
        seg_dims = int(z["seg_dims"][0])
        dim_scales = jnp.asarray(z["dim_scales"])
        if verbose:
            print(f"== ivf-streamed: staging loaded from {stage_cache}")
        if free_codes_before_upload:
            index.codes = None
        return _upload_ivf_state(index, buf, bids, sizes, cl_cents_np, cap,
                                 seg_dims, dim_scales, ncl, d_full,
                                 False, verbose)

    codes = index.codes                          # (M, n) device
    m, n = codes.shape
    l = index.subs_len
    seg_subs = resolve_seg_num(cfg, index.cum_var_per_subs,
                               index.highest_subs)
    seg_dims = min(seg_subs, index.highest_subs) * l
    cents_dev = jnp.asarray(index.centroids)
    n_chunks = -(-n // chunk_rows)

    # int8 quantization scales from the centroid extrema (as build_ivf)
    cents_fin = np.where(np.abs(index.centroids) < 1e17,
                         np.abs(index.centroids), 0.0)
    dmax = cents_fin.max(axis=1).reshape(-1)[:d_full]
    dim_scales = jnp.asarray(127.0 / np.maximum(dmax, 1e-30), np.float32)

    # codes/centroids/scales are ARGUMENTS, not closures: a jitted closure
    # over the codes array would embed it in the program as a constant
    @functools.partial(jax.jit, static_argnames=("rows", "prefix_only"))
    def decode_chunk_fn(codes_a, cents_a, scales_a, start, rows,
                        prefix_only=False):
        blk = jax.lax.dynamic_slice_in_dim(codes_a, start, rows, axis=1)
        # keep decode_db's internal 64k blocking: its per-subspace gather
        # intermediate grows with the block
        dec, _ = scan_decoded.decode_db(blk, cents_a,
                                        block_rows=min(65536, rows))
        if prefix_only:
            return dec[:, :seg_dims].astype(jnp.float32)
        q8 = jnp.clip(jnp.round(dec.astype(jnp.float32)
                                * scales_a[None, :]), -127, 127)
        return q8.astype(jnp.int8)

    def decode_chunk(start, rows, prefix_only=False):
        return decode_chunk_fn(codes, cents_dev, dim_scales, start, rows,
                               prefix_only=prefix_only)

    # ---- pass 1: sampled prefix → k-means centroids ----
    t0 = time.perf_counter()
    spc = max(1, min(sample_n // n_chunks, chunk_rows))
    sample = []
    for i in range(n_chunks):
        rows = min(chunk_rows, n - i * chunk_rows)
        pre = decode_chunk(jnp.int32(i * chunk_rows), rows,
                           prefix_only=True)
        sample.append(pre[: min(spc, rows)])
    sample = jnp.concatenate(sample, axis=0)
    rng = np.random.default_rng(cfg.seed)
    ns = sample.shape[0]
    init_idx = rng.choice(ns, size=min(ncl, ns), replace=ncl > ns)
    cl_cents = kmeans.lloyd(sample, sample[jnp.asarray(
        init_idx.astype(np.int32))], iters=cfg.kmeans_iters)
    del sample
    if verbose:
        print(f"== ivf-streamed: centroids {time.perf_counter() - t0:.0f}s")

    # ---- pass 2: per-chunk top-S candidates → capacity fill ----
    t0 = time.perf_counter()
    s_cand = min(4, ncl)

    @jax.jit
    def _topS(pre):
        d2b = probe_ops.cluster_sq_dists(pre, cl_cents)
        _, idx2 = jax.lax.top_k(-d2b, s_cand)
        return idx2.astype(jnp.int32)

    cand = np.empty((n, s_cand), dtype=np.int32)
    for i in range(n_chunks):
        rows = min(chunk_rows, n - i * chunk_rows)
        pre = decode_chunk(jnp.int32(i * chunk_rows), rows,
                           prefix_only=True)
        cand[i * chunk_rows:i * chunk_rows + rows] = np.asarray(_topS(pre))
    del pre  # the last chunk's device array must not outlive the pass
    cap = _round_cap(max(1, int(math.ceil(balance_cap_factor * n / ncl))))
    assign = _fill_capacity(cand, ncl, cap)
    del cand
    bids, dest = _bucket_slots(assign, ncl, cap)
    sizes = np.bincount(assign, minlength=ncl).astype(np.int32)
    # Tombstones: rows deleted before the build must not
    # be served — build_ivf drops them via the decoded norms, but this path
    # never materializes norms, so mask their slots dead (ids −1 is the
    # rescore's exactness contract) and keep them out of the live counts
    # the visit rule uses. Their staged rows are poisoned below.
    deleted = getattr(index, "deleted_ids", None)
    dd = (np.asarray(deleted, dtype=np.int64)
          if deleted is not None and len(deleted) else None)
    if dd is not None:
        bids.reshape(-1)[dest[dd]] = -1
        sizes = sizes - np.bincount(
            assign[dd], minlength=ncl).astype(np.int32)
    if verbose:
        print(f"== ivf-streamed: assignment {time.perf_counter() - t0:.0f}s"
              f" (cap={cap}, sizes min/max={sizes.min()}/{sizes.max()})")

    # ---- pass 3: host staging buffers filled chunk-by-chunk ----
    t0 = time.perf_counter()
    poison = probe_ops.poison_pattern(d_full)
    buf = np.broadcast_to(poison, (ncl * cap, d_full)).copy()
    for i in range(n_chunks):
        rows = min(chunk_rows, n - i * chunk_rows)
        q8 = decode_chunk(jnp.int32(i * chunk_rows), rows)
        sl = dest[i * chunk_rows:i * chunk_rows + rows]
        buf[sl] = np.asarray(q8)
    del q8  # as above
    if dd is not None:
        buf[dest[dd]] = poison  # deleted rows: ranking guard (ids already -1)
    if verbose:
        print(f"== ivf-streamed: staging {time.perf_counter() - t0:.0f}s")

    cents_np = np.asarray(cl_cents)
    del cl_cents
    if stage_cache:
        np.savez(stage_cache, buf=buf, bids=bids, sizes=sizes,
                 cents=cents_np, cap=np.array([cap]),
                 seg_dims=np.array([seg_dims]),
                 dim_scales=np.asarray(dim_scales))
        if verbose:
            print(f"== ivf-streamed: staging cached to {stage_cache}")
    if free_codes_before_upload:
        index.codes = None
        del codes
    return _upload_ivf_state(index, buf, bids, sizes, cents_np, cap,
                             seg_dims, dim_scales, ncl, d_full,
                             False, verbose)


def _upload_ivf_state(index, buf, bids, sizes, cents_np, cap, seg_dims,
                      dim_scales, ncl, d_full, free_codes, verbose):
    """Pass 4 of the streamed build: upload the staged buckets.

    The small arrays (ids / sizes / scales) go up FIRST, while the
    allocator is empty; the rows go up as one whole-buffer transfer (or,
    for the transposed layout, cluster chunks transposed on device).
    """
    t0 = time.perf_counter()
    if free_codes:
        index.codes = None
    import gc
    gc.collect()
    if verbose:
        live = sum(a.nbytes for a in jax.live_arrays()) / 1e9
        print(f"== ivf-streamed: live device bytes before upload: "
              f"{live:.2f} GB (logical)")

    # small arrays first — nothing big is in flight yet
    bids_dev = jnp.asarray(bids)
    sizes_dev = jnp.asarray(sizes)
    scales_dev = jnp.asarray(dim_scales)
    float(jnp.sum(sizes_dev))  # drain

    transposed = d_full % 128 != 0
    if not transposed:
        rows_dev = jax.block_until_ready(
            jnp.asarray(buf)).reshape(ncl, cap, d_full)
    else:
        # transposed (ncl, d, cap) layout: upload cluster chunks, transpose
        # on device, and write into the destination; the transient is one
        # chunk
        rows_dev = jnp.zeros((ncl, d_full, cap), buf.dtype)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def _wr(dst, chunk, c0):
            ck = chunk.shape[0] // cap
            t = jnp.swapaxes(chunk.reshape(ck, cap, d_full), 1, 2)
            return jax.lax.dynamic_update_slice(dst, t, (c0, 0, 0))

        ck = max(1, (1 << 28) // (cap * d_full))
        pending = []
        for i, c0 in enumerate(range(0, ncl, ck)):
            cn = min(ck, ncl - c0)
            h = jnp.asarray(buf[c0 * cap:(c0 + cn) * cap])
            rows_dev = _wr(rows_dev, h, jnp.int32(c0))
            pending.append(h)
            if len(pending) >= 4:
                # drain, then retire the consumed staging chunks eagerly
                # (deleting only after the drain — an in-flight execution
                # may still read them before it)
                float(rows_dev[0, 0, 0])
                for p in pending:
                    p.delete()
                pending.clear()
        float(rows_dev[0, 0, 0])
        for p in pending:
            p.delete()
        rows_dev = jax.block_until_ready(rows_dev)
    del buf
    state = IVFState(
        centroids=cents_np,
        seg_dims=seg_dims,
        cap=cap,
        bucket_rows=rows_dev,
        bucket_ids=bids_dev,
        sizes=sizes_dev,
        dim_scales=scales_dev,
        transposed=transposed,
    )
    if verbose:
        print(f"== ivf-streamed: upload {time.perf_counter() - t0:.0f}s")
    return state


@functools.partial(jax.jit, static_argnames=(
    "k", "p_visit", "p_max", "qcap", "exact", "gs", "transposed"))
def probe_scan(
    qp: jnp.ndarray,           # (nq, D) projected queries
    centroids: jnp.ndarray,    # (ncl, seg_dims)
    bucket_rows: jnp.ndarray,  # (ncl, cap, D) int8|bf16 (sentinel-padded);
    #                            (ncl, D, cap) when transposed
    bucket_ids: jnp.ndarray,    # (ncl, cap) i32 (-1 padding/deleted)
    sizes: jnp.ndarray,         # (ncl,) live member counts
    k: int,
    p_visit: int,
    p_max: int,
    qcap: int,
    dim_scales: Optional[jnp.ndarray] = None,  # (D,) f32 for int8 rows
    exact: bool = True,
    gs: int = 16,
    transposed: bool = False,
    rescore_rows: Optional[jnp.ndarray] = None,   # (n, D) bf16 flat DB
    rescore_norms: Optional[jnp.ndarray] = None,  # (n,) f32 (+inf deleted)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One fused dispatch: probe → MoE dispatch → group-min scan →
    per-query window merge → block rescore of the winner windows.

    The scan (``probe_ops.groupmin_window_scan``) reduces every gs-row
    group to one f32 min distance; the merge gathers each query's probed
    group minima as flat rows and takes the best m = 2k windows; the
    rescore reads those windows' full gs-row blocks back from the
    bucket-resident arrays — contiguous slabs, not a scattered single-row
    gather from the flat DB. Int8 bucket rows fold their per-dim scales
    into the query side exactly as the decoded8 tier does
    (scan_decoded.decoded8_scan_topk).

    Window-rescore correctness: a gs-row group containing any true top-k row
    has group-min ≤ d_k, and at most k groups can have group-min ≤ d_k (any
    such group's argmin is itself a top-k row) — so the top m = 2k windows
    provably contain every group holding a top-k row, and rescoring their
    full blocks recovers neighbors that are DENSE within one bucket (the
    common IVF case a one-candidate-per-group reduction loses). Remaining
    approximation: bf16/int8 scoring ties and the visit budget itself — the
    same contract as the reference's TI break (VAQ.cpp:1548-1551). Deleted
    and padding slots carry bucket_ids = −1 and are masked to −inf in the
    rescore, so they are filtered exactly (BitVecEngine.cpp:1626-1636
    semantics). Row norms are DERIVED from the rows themselves — exact for
    both tiers (int8 integers and bf16 values square exactly in f32) — so
    no (ncl, cap) norms array exists at all.
    """
    nq, d_full = qp.shape
    ncl, cap = bucket_ids.shape
    ng = cap // gs
    if ng * gs != cap:
        raise ValueError(f"cap {cap} not divisible by gs={gs}")
    qcap = min(qcap, nq)
    if (bucket_rows.dtype == jnp.int8) != (dim_scales is not None):
        raise ValueError("int8 bucket rows require dim_scales (and only "
                         "they do)")

    cd = probe_ops.cluster_sq_dists(qp[:, : centroids.shape[1]], centroids)
    probe, active = probe_ops.dynamic_probe(cd, sizes, k, p_visit, p_max)
    table, ok, ent_c, ent_r = probe_ops.dispatch_table(probe, active, ncl,
                                                       qcap)
    # Fold the int8 per-dim scales into the query BEFORE the dispatch
    # gather, so dot(rows_i8, q_folded) = q·(rows/scales) = q·x̂.
    q_eff = qp if dim_scales is None else qp / dim_scales[None, :]
    qp_pad = jnp.concatenate(
        [q_eff, jnp.zeros((1, d_full), qp.dtype)], axis=0)
    # −2 pre-scale folded into the query slab (see groupmin_window_scan)
    qsl = (-2.0 * qp_pad)[table].astype(jnp.bfloat16)      # (ncl, qcap, D)

    # per-dim norm weights: ‖x̂‖² = Σ rows²·w (w = 1/scales² for int8 rows,
    # ones for bf16)
    dim_w = (jnp.ones((d_full,), jnp.float32) if dim_scales is None
             else 1.0 / (dim_scales * dim_scales))
    mins = probe_ops.groupmin_window_scan(
        qsl, bucket_rows, dim_w, gs=gs,
        transposed=transposed)                             # (ncl, ng, qcap)

    # per-query window merge: flat row gather of each dispatched entry's
    # group minima, then top-m windows
    flat = mins.transpose(0, 2, 1).reshape(ncl * qcap, ng)
    cand = jnp.where(ok[:, None], flat[ent_c * qcap + ent_r], jnp.inf)
    cand = cand.reshape(nq, p_max * ng)
    m = min(max(2 * k, 16), p_max * ng)
    if exact or p_max * ng < 1024:
        wd, pos = jax.lax.top_k(-cand, m)
    else:
        wd, pos = jax.lax.approx_max_k(-cand, m, recall_target=0.95)
        pos = pos.astype(jnp.int32)
    w_ok = jnp.isfinite(wd)                                # dispatched + live
    p_slot = pos // ng
    g_idx = pos % ng
    clus = jnp.take_along_axis(probe, p_slot, axis=1)
    wblk = clus * ng + g_idx                               # (nq, m) block ids

    # block rescore: score the winner windows' full gs-row slabs from the
    # bucket-resident arrays
    blk_ids = bucket_ids.reshape(ncl * ng, gs)[wblk]       # (nq, m, gs)
    raw = probe_ops.window_rescore(q_eff, dim_w, bucket_rows, wblk, gs,
                                   transposed=transposed)
    # dead slots (ids −1) mask to −inf
    score = jnp.where(w_ok[:, :, None] & (blk_ids >= 0), raw, -jnp.inf)
    score = score.reshape(nq, m * gs)
    rows = blk_ids.reshape(nq, m * gs)
    qn = jnp.sum(qp * qp, axis=1)
    kk = min(k if rescore_rows is None else 2 * k, m * gs)
    top_s, post = jax.lax.top_k(score, kk)                 # k ≤ 2k·gs = m·gs
    top_i = jnp.take_along_axis(rows, post, axis=1)
    if rescore_rows is not None:
        # Second-stage EXACT rescore (int8 buckets only): the stage-1
        # selection is in the int8-reconstruction metric, whose per-row
        # noise costs recall. Re-scoring the top 2k candidates against the
        # flat bf16 decoded DB (a tiny k-row gather — the DB is resident
        # whenever the decoded tier is) recovers it and makes the returned
        # distances identical in kind to the decoded backend's.
        safe = jnp.maximum(top_i, 0)
        rr = rescore_rows[safe]                            # (nq, kk, D)
        inner2 = jnp.einsum("qd,qkd->qk", qp.astype(jnp.bfloat16),
                            rr.astype(jnp.bfloat16),
                            precision=jax.lax.Precision.DEFAULT,
                            preferred_element_type=jnp.float32)
        score2 = 2.0 * inner2 - rescore_norms[safe]
        top_s0 = top_s
        kk2 = min(k, kk)
        top_s, post2 = jax.lax.top_k(
            jnp.where(jnp.isfinite(top_s0) & (top_i >= 0), score2,
                      -jnp.inf), kk2)
        top_i = jnp.take_along_axis(top_i, post2, axis=1)
        kk = kk2
    if kk < k:
        top_s = jnp.pad(top_s, ((0, 0), (0, k - kk)),
                        constant_values=-jnp.inf)
        top_i = jnp.pad(top_i, ((0, 0), (0, k - kk)), constant_values=-1)
    d2 = jnp.maximum(qn[:, None] - top_s, 0.0)
    fin = jnp.isfinite(top_s)
    return jnp.where(fin, d2, jnp.inf), jnp.where(fin, top_i, -1)


class IVFSearcher:
    """Adapter giving `VAQIndex.search` its TI/IVF path (index.ivf)."""

    def __init__(self, state: IVFState, visit: float):
        self.state = state
        self.visit = float(visit)

    def _sizes_np(self) -> np.ndarray:
        return np.asarray(self.state.sizes)

    def params(self, k: int, nq: int) -> Tuple[int, int, int, int]:
        """(p_visit, p_max, qcap, gs) — static shapes for this (k, nq)."""
        st = self.state
        ncl = st.ncl
        p_visit = max(1, int(np.ceil(self.visit * ncl)))
        # worst case over probe sets: smallest clusters first
        sizes = self._sizes_np()
        cum = np.cumsum(np.sort(sizes))
        p_floor = int(np.searchsorted(cum, k) + 1)
        p_max = min(ncl, max(p_visit, p_floor))
        # Small batches get strict capacity (qcap = nq: no entry can ever
        # drop); large throughput batches use ~2× mean-demand slack, where
        # drops require pathologically correlated queries (documented in
        # ops/probe.py).
        qcap = nq if nq <= 256 else probe_ops.pick_qcap(nq, p_max, ncl)
        return p_visit, p_max, qcap, probe_ops.pick_gs(st.cap)

    def probes(self, k: int) -> int:
        """Static probe count (legacy accessor used by tests/tools)."""
        return self.params(k, 1)[1]

    def search(self, index, qp: jnp.ndarray, luts, k: int,
               exact: bool = True):
        st = self.state
        qp = jnp.asarray(qp)
        p_visit, p_max, qcap, gs = self.params(k, qp.shape[0])
        # second-stage exact rescore against the flat decoded DB — only
        # worthwhile for int8 buckets (bf16 buckets ARE the decoded rows),
        # and only when the decoded tier is already resident (never force
        # _ensure_decoded: at 100M it cannot exist)
        r_rows = r_norms = None
        if st.dim_scales is not None and index is not None and \
                getattr(index, "decoded", None) is not None:
            r_rows, r_norms = index.decoded, index.decoded_norms
        return probe_scan(qp, jnp.asarray(st.centroids), st.bucket_rows,
                          st.bucket_ids, st.sizes,
                          k, p_visit, p_max, qcap,
                          dim_scales=st.dim_scales, exact=exact, gs=gs,
                          transposed=st.transposed,
                          rescore_rows=r_rows, rescore_norms=r_norms)


class ShardedIVF:
    """Mesh-sharded probe state + search.

    Shards every bucket array over the CLUSTER axis of a mesh's "db" axis
    (each shard owns ncl/nshards clusters — whole clusters, like the
    reference's disk-resident cluster chunks, BitVecEngine.cpp:1024-1139)
    and serves queries via ``parallel.sharded_ivf_search``: per-shard local
    probe + group-min scan + window rescore, merged by the k-row
    all_gather. Bucket ids are already global, so the merge needs no
    offsets. The visit fraction applies per shard (same total budget).

    ``rescore_rows``/``rescore_norms`` (the ROW-sharded decoded tier, e.g.
    ``VAQIndex._sharded_decoded``) enable the exact second-stage rescore:
    stage-1 top-2k in the int8 metric, distributed exact scoring of the
    merged candidates (see sharded_ivf_search). Without them the int8 tier
    serves stage-1 selection, whose int8 noise costs recall.
    """

    def __init__(self, state: IVFState, visit: float, mesh, q_axis=None,
                 rescore_rows=None, rescore_norms=None):
        self.rescore_rows = rescore_rows
        self.rescore_norms = rescore_norms
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        self.visit = float(visit)
        self.mesh = mesh
        self.q_axis = q_axis
        self.cap = state.cap
        self.seg_dims = state.seg_dims
        nshards = mesh.shape["db"]
        ncl = state.ncl
        ncl_pad = -(-ncl // nshards) * nshards
        padc = ncl_pad - ncl
        self.ncl_local = ncl_pad // nshards

        cents = np.pad(state.centroids, ((0, padc), (0, 0)),
                       constant_values=1e9)          # far: ranked last
        sizes_np = np.pad(np.asarray(state.sizes), (0, padc))
        # worst-shard probe floor: each shard must be able to reach >= k
        # members from its own (smallest-first) clusters
        self.local_sizes = sizes_np.reshape(nshards, self.ncl_local)

        def put(arr, spec):
            return jax.device_put(arr, NamedSharding(mesh, spec))

        self.transposed = state.transposed
        self.d_full = state.d_full
        if state.bucket_rows.dtype == jnp.int8:
            def pad_row(s, d):
                pat = jnp.asarray(probe_ops.poison_pattern(self.d_full))
                shape = ((1, self.d_full, 1) if state.transposed
                         else (1, 1, self.d_full))  # pattern along D
                return jnp.broadcast_to(pat.reshape(shape), s)
        else:
            def pad_row(s, d):
                return jnp.full(s, 1e15, d)
        pad_shape = ((padc, self.d_full, state.cap) if state.transposed
                     else (padc, state.cap, self.d_full))
        rows = jnp.concatenate(
            [state.bucket_rows,
             pad_row(pad_shape, state.bucket_rows.dtype)]) if padc else \
            state.bucket_rows
        ids = jnp.pad(state.bucket_ids, ((0, padc), (0, 0)),
                      constant_values=-1)
        self.rows = put(rows, P("db", None, None))
        self.ids = put(ids, P("db", None))
        self.sizes = put(jnp.asarray(sizes_np.astype(np.int32)), P("db"))
        self.centroids = put(jnp.asarray(cents), P("db", None))
        self.dim_scales = (None if state.dim_scales is None
                           else put(state.dim_scales, P(None)))

    def params(self, k: int, nq: int):
        """Per-shard static params (same rules as IVFSearcher.params, with
        the worst shard setting the >= k probe floor)."""
        ncl_l = self.ncl_local
        p_visit = max(1, int(np.ceil(self.visit * ncl_l)))
        p_floor = 1
        for srt in np.sort(self.local_sizes, axis=1):
            cum = np.cumsum(srt)
            p_floor = max(p_floor, int(np.searchsorted(cum, k) + 1))
        p_max = min(ncl_l, max(p_visit, p_floor))
        qcap = nq if nq <= 256 else probe_ops.pick_qcap(nq, p_max, ncl_l)
        return p_visit, p_max, qcap, probe_ops.pick_gs(self.cap)

    def search(self, qp: jnp.ndarray, k: int, exact: bool = False):
        from vaq_tpu.parallel import sharded_ivf_search

        qp = jnp.asarray(qp)
        p_visit, p_max, qcap, gs = self.params(k, qp.shape[0])
        # exact second-stage rescore only pays for int8 buckets (bf16
        # buckets already ARE the decoded rows)
        r_rows = r_norms = None
        if self.dim_scales is not None and self.rescore_rows is not None:
            r_rows, r_norms = self.rescore_rows, self.rescore_norms
        return sharded_ivf_search(
            self.centroids, self.rows, self.ids, self.sizes,
            self.dim_scales, qp, k, self.mesh, p_visit, p_max, qcap, gs,
            exact=exact, transposed=self.transposed, q_axis=self.q_axis,
            rescore_rows=r_rows, rescore_norms=r_norms)


def attach_ivf(index, verbose: bool = False,
               ti_cluster_num: Optional[int] = None,
               ti_segment_num: Optional[int] = None,
               visit: Optional[float] = None,
               rows_dtype: str = "int8"):
    """Build + attach the cluster-probe state (the clusterTI call site,
    demo_vaq.cpp:127). Explicit overrides avoid config mutation."""
    state = build_ivf(index, verbose=verbose, ti_cluster_num=ti_cluster_num,
                      ti_segment_num=ti_segment_num, rows_dtype=rows_dtype)
    index.ivf = IVFSearcher(
        state, index.config.visit if visit is None else visit)
    return index

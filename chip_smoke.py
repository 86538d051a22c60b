"""Drive the engine once on the GPU at the reference's headline deployment
and check every result against a plain reference.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded phases only

The index is SIFT1M-shaped (1,000,000 × 128 f32 rows generated from
``--seed``) under ``VAQ256m32min7max8var1,HEAP`` (the reference's
ExperimentsParameters.txt:51-55). Phases, one line each (name, checks with
their thresholds, ``compiled.memory_analysis()`` of the phase's step and
the device's peak bytes in use):

  groundtruth  exact_search on 100k rows against float64 NumPy (the f32
               matmuls must run at full precision, not TF32)
  main         build → search/search_device at k=10 and k=100 → refine →
               save/load, against the exact LUT scan on the same index
  serve        SearchServer answers single queries and small groups exactly
               as search_device answers the same padded batch
  codes        the codes tier (Triton window kernel) against the XLA scan
               and the exact LUT scan
  fast4        a FAST index: winners by u8 LUT sums against NumPy integers
  decoded8     the int8 tier against the exact LUT scan
  ivf          1000-cluster probe at visit 0.1 and 1.0; group-min scan
               against float64 NumPy
  hamming      BinaryIndex(bit_budget=256) against NumPy XOR+popcount
  gpu_tests    the repository's `gpu`-marked tests, in this process

The script needs the GPU: it stops with a non-zero exit code, printing no
result, when JAX's first device is not a GPU or a phase fails. Its last
line is one JSON object naming the device. Sizes can be cut with the
options below to rehearse on the CPU (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = "VAQ256m32min7max8var1,HEAP"
FAST_CONFIG = "VAQ256m64min1max4var1,FAST"

# Overlap thresholds: mean |ids ∩ reference ids| / k per query against the
# exact f32 LUT scan on the same index, below 1 only through each tier's
# documented approximation. Calibrated by running these phases on the CPU
# at 100k rows (512 queries, 256 compared; measured value in brackets) and
# set with room for the denser 1M index; a broken kernel reads near 0.
MIN_OVERLAP = {
    # bf16 scoring + 2k over-fetch [k=10: 0.977, k=100: 0.990]
    "decoded": 0.90,
    # one candidate per window + 2k-window over-fetch [0.995]
    "codes": 0.90,
    # int8 rows: per-dim rounding of the reconstruction [0.835; 0.755 at
    # 1M on the card]
    "decoded8": 0.65,
    # int8 buckets select 2k, rescored against the bf16 rows [0.833]
    "ivf_visit1": 0.70,
}
#: relative slack of f32 arithmetic on top of each derived bound
F32_SLACK = 1e-4


def card_line() -> str:
    """`nvidia-smi`'s name and power limit, from a child that never touches
    JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or f"unavailable ({out.stderr.strip()})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e!r})"


def memory_summary(jitted, *args, **static) -> dict:
    """compiled.memory_analysis() of one jitted step, in bytes."""
    m = jitted.lower(*args, **static).compile().memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, k + "_size_in_bytes"))
            for k in ("argument", "output", "temp", "generated_code")}


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", -1))


class Checks:
    """Named checks of one phase: value, threshold, comparison, verdict."""

    def __init__(self):
        self.items = {}

    def at_least(self, name, value, threshold):
        self.items[name] = {"value": float(value), "min": threshold,
                            "ok": bool(value >= threshold)}

    def at_most(self, name, value, threshold):
        self.items[name] = {"value": float(value), "max": threshold,
                            "ok": bool(value <= threshold)}

    def info(self, name, value):
        self.items[name] = {"value": value}

    @property
    def ok(self):
        return all(v.get("ok", True) for v in self.items.values())


# ----------------------------------------------------------------------
# shared references
# ----------------------------------------------------------------------

def overlap(ids, ref_ids):
    import numpy as np
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    k = ref_ids.shape[1]
    return float(np.mean([len(set(ids[q]) & set(ref_ids[q])) / k
                          for q in range(ref_ids.shape[0])]))


def lut_reference(idx, qp_ref, k):
    """The plain reference of every ADC tier: an exact top-k over f32 LUT
    gather-sums on the same index (scan_jax.adc_scan_topk), plus the LUTs
    and host codes for distance checks."""
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu.ops import scan_jax
    luts = scan_jax.build_luts(qp_ref, jnp.asarray(idx.centroids))
    _, ids = scan_jax.adc_scan_topk(idx.codes.T, luts, k,
                                    n_valid=jnp.int32(idx.n_rows),
                                    block_rows=8192)
    return np.asarray(ids), np.asarray(luts, np.float64), idx.codes_rowmajor()


def lut_sums(luts, codes, ids):
    """f32 LUT sums (evaluated in float64) of ids (nq, k)."""
    import numpy as np
    c = codes[np.maximum(ids, 0)].astype(np.int64)          # (nq, k, M)
    q = np.arange(ids.shape[0])[:, None, None]
    s = np.arange(codes.shape[1])[None, None, :]
    return luts[q, s, c].sum(axis=2)


def check_distances(checks, name, d_got, ids, qp_ref, idx, luts, codes,
                    err_per_dim=None):
    """Returned distances against the f32 LUT sums of the same ids.

    Exact-rescore tiers (codes, fast4) agree to F32_SLACK. Tiers that
    rescore a rounded reconstruction b of x̂ (bf16: |b−x̂| ≤ 2⁻⁸|x̂|; int8:
    |b−x̂| ≤ 0.5/scale) differ by Σ_j |b_j−x̂_j|·|2q_j−x̂_j−b_j| at most;
    ``err_per_dim(x̂)`` gives |b−x̂|'s bound."""
    import numpy as np
    ids = np.asarray(ids)
    d_got = np.asarray(d_got, np.float64)
    d_ref = lut_sums(luts, codes, ids)
    bound = F32_SLACK * np.abs(d_ref) + 1e-3
    if err_per_dim is not None:
        xhat = idx.reconstruct(np.maximum(ids, 0).reshape(-1)).reshape(
            ids.shape + (-1,)).astype(np.float64)
        e = err_per_dim(xhat)
        q = np.asarray(qp_ref, np.float64)[:, None, :]
        bound = bound + np.sum(e * (2.0 * np.abs(q - xhat) + e), axis=2)
    excess = np.abs(d_got - d_ref) / bound
    checks.at_most(f"{name}_dist_err_over_bound", float(excess.max()), 1.0)


def bf16_err(xhat):
    import numpy as np
    return np.abs(xhat) * 2.0 ** -8


def f32_dist_tol(queries, base):
    """Per-query bound on the f32 error of ‖q‖² − 2q·x + ‖x‖² over d terms
    (an n-term f32 sum is off by at most n·2⁻²⁴·Σ|terms|); two ids whose
    float64 distances differ by less than twice this may swap places."""
    import numpy as np
    d = base.shape[1]
    qn = (queries.astype(np.float64) ** 2).sum(1)
    xmax = float((base.astype(np.float64) ** 2).sum(1).max())
    qx = np.sqrt(qn) * np.sqrt(xmax)
    return (d + 2) * 2.0 ** -24 * (qn + 2.0 * qx + xmax)


def f64_dists(queries, base, ids):
    import numpy as np
    diff = (queries.astype(np.float64)[:, None, :]
            - base[np.maximum(ids, 0)].astype(np.float64))
    return (diff ** 2).sum(axis=2)


def same_up_to_ties(queries, base, ids, ref_ids):
    """Fraction of queries whose k ids equal the reference's, counting a
    query as equal when every differing id sits within the f32 tie band of
    the reference's k-th distance (float64)."""
    import numpy as np
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    tol = f32_dist_tol(queries, base)
    kth = f64_dists(queries, base, ref_ids).max(axis=1)
    got = f64_dists(queries, base, ids)
    ok = 0
    for q in range(ids.shape[0]):
        extra = [j for j in range(ids.shape[1])
                 if ids[q, j] not in set(ref_ids[q])]
        ok += all(abs(got[q, j] - kth[q]) <= 2.0 * tol[q] for j in extra)
    return ok / ids.shape[0]


# ----------------------------------------------------------------------
# phases (one card)
# ----------------------------------------------------------------------

def phase_groundtruth(ctx):
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu.ops.distances import exact_search
    base = ctx["base"][: ctx["gt_n"]]
    queries = ctx["queries"]
    k = 10
    ck = Checks()
    _, ids = exact_search(jnp.asarray(queries), jnp.asarray(base), k)
    ids = np.asarray(ids)
    b64 = base.astype(np.float64)
    bn = (b64 ** 2).sum(1)
    ref = np.empty_like(ids)
    for s in range(0, queries.shape[0], 128):
        q64 = queries[s:s + 128].astype(np.float64)
        d2 = (q64 ** 2).sum(1)[:, None] - 2.0 * q64 @ b64.T + bn[None, :]
        ref[s:s + 128] = np.argsort(d2, axis=1)[:, :k]
    exact = float(np.mean([set(ids[q]) == set(ref[q])
                           for q in range(ids.shape[0])]))
    ck.info("top10_sets_identical_frac", exact)
    # TF32 (≈2⁻¹¹ per product) would break this by orders of magnitude
    ck.at_least("top10_sets_identical_up_to_f32_ties_frac",
                same_up_to_ties(queries, base, ids, ref), 1.0)
    mem = memory_summary(exact_search, jnp.asarray(queries),
                         jnp.asarray(base), k=k)
    return ck, mem


def phase_main(ctx):
    import jax.numpy as jnp
    import numpy as np

    import vaq_tpu
    from vaq_tpu import metrics, pca
    from vaq_tpu.ops import scan_decoded
    from vaq_tpu.ops.distances import exact_search

    base, queries = ctx["base"], ctx["queries"]
    nq = queries.shape[0]
    ck = Checks()
    t0 = time.perf_counter()
    idx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(CONFIG)).build(base)
    ck.info("build_s", round(time.perf_counter() - t0, 3))
    ctx["idx"] = idx
    q_dev = jnp.asarray(queries)
    _, gt = exact_search(q_dev, jnp.asarray(base), 100)
    ctx["gt"] = gt = np.asarray(gt)

    res = {}
    for k in (10, 100):
        d_h, i_h = idx.search(queries, k, query_batch=nq)
        d_d, i_d = idx.search_device(q_dev, k)
        ck.at_least(f"k{k}_search_eq_search_device_frac",
                    np.mean(np.asarray(i_d) == i_h), 1.0)
        res[k] = (d_h, i_h)
    ck.info("recall_at_10", metrics.avg_recall(res[10][1], gt, 10))
    ck.info("recall_at_100", metrics.avg_recall(res[100][1], gt, 100))
    _, refined = idx.refine(queries, res[100][1], base, 10)
    rec_ref = metrics.avg_recall(refined, gt, 10)
    ck.info("refined_recall_at_10", rec_ref)
    ck.at_least("refined_minus_adc_recall_at_10",
                rec_ref - metrics.avg_recall(res[10][1], gt, 10), 0.0)

    nr = ctx["ref_nq"]
    qp_ref = pca.project(queries[:nr], idx.eigvecs, idx.total_dim)
    for k in (10, 100):
        ref_ids, luts, codes = lut_reference(idx, qp_ref, k)
        ck.at_least(f"k{k}_overlap_vs_lut_scan",
                    overlap(res[k][1][:nr], ref_ids), MIN_OVERLAP["decoded"])
        check_distances(ck, f"k{k}", res[k][0][:nr], res[k][1][:nr],
                        qp_ref, idx, luts, codes, err_per_dim=bf16_err)
        if k == 10:
            ctx["lut_ref"] = (qp_ref, ref_ids, luts, codes)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        idx.save(path)
        idx2 = vaq_tpu.VAQIndex.load(path)
        _, i2 = idx2.search_device(q_dev, 10)
        ck.at_least("save_load_same_ids_frac",
                    np.mean(np.asarray(i2) == res[10][1]), 1.0)
    mem = memory_summary(scan_decoded.decoded_search_e2e, q_dev,
                         idx._eigvecs_device(), idx.decoded,
                         idx.decoded_norms, k=10)
    return ck, mem


def phase_serve(ctx):
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu.serving import SearchServer
    idx, queries = ctx["idx"], ctx["queries"]
    k, max_batch = 10, 256
    ck = Checks()
    singles = [queries[i] for i in range(64)]
    groups = [queries[64 + 8 * g: 64 + 8 * g + 2 + g] for g in range(8)]
    srv = SearchServer(idx, k=k, max_batch=max_batch, backend="decoded")
    try:
        srv.search(queries[0], timeout=300)     # compile outside the stats
        srv.stats.reset()
        futs = [srv.submit(q) for q in singles] + \
            [srv.submit(g) for g in groups]
        got = [f.result(timeout=300) for f in futs]
        lat = srv.stats.summary()
    finally:
        srv.close()
    asked = np.concatenate([np.atleast_2d(q) for q in singles] + groups)
    got_d = np.concatenate([d for d, _ in got])
    got_i = np.concatenate([i for _, i in got])
    # the reference: search_device on the same padded max_batch shape
    ref_d, ref_i = [], []
    for s in range(0, asked.shape[0], max_batch):
        blk = asked[s:s + max_batch]
        pad = np.pad(blk, ((0, max_batch - blk.shape[0]), (0, 0)))
        d, i = idx.search_device(jnp.asarray(pad), k)
        ref_d.append(np.asarray(d)[: blk.shape[0]])
        ref_i.append(np.asarray(i)[: blk.shape[0]])
    ref_d, ref_i = np.concatenate(ref_d), np.concatenate(ref_i)
    ck.info("requests", len(futs))
    ck.at_least("served_ids_equal_frac", np.mean(got_i == ref_i), 1.0)
    ck.at_most("served_dist_max_rel_diff",
               float(np.max(np.abs(got_d - ref_d)
                            / np.maximum(np.abs(ref_d), 1e-6))), 1e-6)
    ck.info("p50_ms", round(lat.get("p50_ms", float("nan")), 3))
    from vaq_tpu.ops import scan_decoded
    mem = memory_summary(scan_decoded.decoded_search_e2e,
                         jnp.zeros((max_batch, queries.shape[1]), jnp.float32),
                         idx._eigvecs_device(), idx.decoded,
                         idx.decoded_norms, k=k)
    return ck, mem


def phase_codes(ctx):
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu.ops import platform, scan_codes
    idx, queries = ctx["idx"], ctx["queries"]
    qp_ref, ref_ids, luts, codes = ctx["lut_ref"]
    nr = qp_ref.shape[0]
    k = 10
    ck = Checks()
    ck.info("impl", platform.choose("codes_window_scan"))
    d, i = idx.search_device(jnp.asarray(queries), k, backend="codes")
    d, i = np.asarray(d)[:nr], np.asarray(i)[:nr]
    ck.at_least("overlap_vs_lut_scan", overlap(i, ref_ids),
                MIN_OVERLAP["codes"])
    # exact f32 rescore from the f32 centroids
    check_distances(ck, "codes", d, i, qp_ref, idx, luts, codes)

    # the compiled window kernel against the XLA scan, same inputs
    table, rows = idx._codes_tier()
    br = idx._codes_block_rows(k)
    codes_p = jnp.pad(idx.codes, ((0, 0), (0, (-idx.n_rows) % br)))
    qp = jnp.asarray(qp_ref)
    s_x, w_x = scan_codes.window_scan_xla(codes_p, table, qp, br)
    if platform.choose("codes_window_scan") == "triton":
        s_t, w_t = scan_codes.window_scan_triton(codes_p, table, qp, br)
        # the packed window-local row clears log2(br) mantissa bits
        rtol = 2.0 ** ((br - 1).bit_length() - 23) + 1e-5
        rel = np.abs(np.asarray(s_t) - np.asarray(s_x)) / np.maximum(
            np.abs(np.asarray(s_x)), 1e-3)
        ck.at_most("kernel_vs_xla_max_rel", float(rel.max()), rtol)
        ck.at_least("kernel_vs_xla_window_row_agree",
                    float(np.mean(np.asarray(w_t) == np.asarray(w_x))), 0.99)
    mem = memory_summary(scan_codes.decode_scan_topk, idx.codes, table, rows,
                         pca_all(idx, queries), k=k,
                         n_valid=jnp.int32(idx.n_rows), block_rows=br)
    return ck, mem


def pca_all(idx, queries):
    from vaq_tpu import pca
    return pca.project(queries, idx.eigvecs, idx.total_dim)


def phase_fast4(ctx):
    import jax.numpy as jnp
    import numpy as np

    import vaq_tpu
    from vaq_tpu import pca
    from vaq_tpu.ops import scan_jax
    base, queries = ctx["base"], ctx["queries"]
    nr = ctx["fast_nq"]
    k = 10
    ck = Checks()
    t0 = time.perf_counter()
    fidx = vaq_tpu.VAQIndex(
        vaq_tpu.parse_method_string(FAST_CONFIG)).build(base)
    fidx.learn_quantization(base, sample_ratio=0.1)
    ck.info("build_s", round(time.perf_counter() - t0, 3))
    d, i = fidx.search(queries[:nr], k, backend="fast4", query_batch=nr)
    qp = pca.project(queries[:nr], fidx.eigvecs, fidx.total_dim)
    luts = scan_jax.build_luts(qp, jnp.asarray(fidx.centroids))
    lut8 = np.asarray(scan_jax.quantize_luts(
        luts, jnp.asarray(fidx.lut_offsets), jnp.asarray(fidx.lut_scales)))
    codes = fidx.codes_rowmajor()
    sums = np.zeros((nr, codes.shape[0]), np.int64)
    for s in range(codes.shape[1]):
        sums += lut8[:, s, :][:, codes[:, s]].astype(np.int64)
    kth = np.sort(sums, axis=1)[:, :k]
    got = np.sort(np.take_along_axis(sums, i, axis=1), axis=1)
    # integer sums: the winners are the k smallest, up to equal sums
    ck.at_least("winner_sums_equal_frac", np.mean(got == kth), 1.0)
    luts64 = np.asarray(luts, np.float64)
    check_distances(ck, "fast4", d, i, qp, fidx, luts64, codes)
    rel = np.abs(np.asarray(d) - lut_sums(luts64, codes, i)) / np.maximum(
        lut_sums(luts64, codes, i), 1e-6)
    ck.at_most("dist_max_rel", float(rel.max()), 1e-5)
    mem = memory_summary(scan_jax.fast_scan_topk, fidx.codes.T, luts,
                         jnp.asarray(lut8), k=k,
                         n_valid=jnp.int32(fidx.n_rows))
    return ck, mem


def phase_decoded8(ctx):
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu.ops import scan_decoded
    idx, queries = ctx["idx"], ctx["queries"]
    qp_ref, ref_ids, luts, codes = ctx["lut_ref"]
    nr = qp_ref.shape[0]
    ck = Checks()
    d, i = idx.search_device(jnp.asarray(queries), 10, backend="decoded8")
    d, i = np.asarray(d)[:nr], np.asarray(i)[:nr]
    ck.at_least("overlap_vs_lut_scan", overlap(i, ref_ids),
                MIN_OVERLAP["decoded8"])
    half_step = 0.5 / np.asarray(idx.decoded8_scales, np.float64)
    check_distances(ck, "decoded8", d, i, qp_ref, idx, luts, codes,
                    err_per_dim=lambda x: np.broadcast_to(half_step, x.shape)
                    + 2.0 ** -20 * np.abs(x))
    qp = pca_all(idx, queries)
    mem = memory_summary(scan_decoded.decoded8_scan_topk, idx.decoded8,
                         idx.decoded8_scales, idx.decoded8_norms,
                         idx.decoded8, qp, k=10)
    # the int8 tier is not used again; free it for the IVF buckets
    idx.decoded8 = idx.decoded8_scales = idx.decoded8_norms = None
    return ck, mem


def groupmin_reference(qsl, rows, dim_w, gs):
    """float64 group minima and the f32 evaluation's error bound (see
    tests/test_probe_groupmin.py)."""
    import jax.numpy as jnp
    import numpy as np
    q = np.asarray(jnp.asarray(qsl).astype(jnp.float32), np.float64)
    r = np.asarray(jnp.asarray(rows).astype(jnp.float32), np.float64)
    w = np.asarray(dim_w, np.float64)
    dot = np.einsum("cqd,crd->crq", q, r)
    xn = np.sum(r * r * w, axis=2)
    qn = 0.25 * np.sum(q * q, axis=2)
    dist = dot + xn[:, :, None] + qn[:, None, :]
    mag = (np.einsum("cqd,crd->crq", np.abs(q), np.abs(r))
           + xn[:, :, None] + qn[:, None, :])
    ncl, cap, qcap = dist.shape
    ref = dist.reshape(ncl, cap // gs, gs, qcap).min(axis=2)
    bound = (r.shape[2] + 2) * 2.0 ** -24 * mag.reshape(
        ncl, cap // gs, gs, qcap).max(axis=2)
    return ref, bound


def phase_ivf(ctx):
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu import metrics
    from vaq_tpu.ivf import IVFSearcher, build_ivf, probe_scan
    from vaq_tpu.ops import probe
    idx, queries, gt = ctx["idx"], ctx["queries"], ctx["gt"]
    qp_ref, ref_ids, _, _ = ctx["lut_ref"]
    nr = qp_ref.shape[0]
    ck = Checks()
    t0 = time.perf_counter()
    state = build_ivf(idx, ti_cluster_num=ctx["clusters"], ti_segment_num=16)
    ck.info("build_s", round(time.perf_counter() - t0, 3))
    qp = pca_all(idx, queries)
    for visit in (0.1, 1.0):
        _, lab = IVFSearcher(state, visit).search(idx, qp, None, 10,
                                                  exact=False)
        lab = np.asarray(lab)
        ck.info(f"visit{visit}_recall_at_10",
                metrics.avg_recall(lab, gt, 10))
    ck.at_least("visit1_overlap_vs_lut_scan", overlap(lab[:nr], ref_ids),
                MIN_OVERLAP["ivf_visit1"])

    # the group-min scan on one block of clusters against float64 NumPy
    ncl_blk = min(4, state.ncl)
    rows = state.bucket_rows[:ncl_blk]
    rows_std = jnp.swapaxes(rows, 1, 2) if state.transposed else rows
    q_eff = np.asarray(qp[:64]) / np.asarray(state.dim_scales)[None, :]
    qsl = jnp.asarray(np.broadcast_to(-2.0 * q_eff, (ncl_blk,) + q_eff.shape)
                      ).astype(jnp.bfloat16)
    dim_w = 1.0 / (state.dim_scales * state.dim_scales)
    gs = probe.pick_gs(state.cap)
    out = np.asarray(probe.groupmin_window_scan(
        qsl, rows, dim_w, gs=gs, transposed=state.transposed), np.float64)
    ref, bound = groupmin_reference(qsl, rows_std, dim_w, gs)
    live = ref < probe.SENTINEL_DIST
    # 2× the bound: the f32 store of the result rounds once more
    excess = np.abs(out - ref)[live] / (2.0 * bound[live] + 1e-6)
    ck.at_most("groupmin_err_over_bound", float(excess.max()), 1.0)
    searcher = IVFSearcher(state, 0.1)
    p_visit, p_max, qcap, gs = searcher.params(10, qp.shape[0])
    mem = memory_summary(
        probe_scan, qp, jnp.asarray(state.centroids), state.bucket_rows,
        state.bucket_ids, state.sizes, k=10, p_visit=p_visit, p_max=p_max,
        qcap=qcap, dim_scales=state.dim_scales, exact=False, gs=gs,
        transposed=state.transposed, rescore_rows=idx.decoded,
        rescore_norms=idx.decoded_norms)
    return ck, mem


def phase_hamming(ctx):
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu.binary import BinaryIndex, hamming_topk_matmul, unpack_bits_01
    base, queries = ctx["base"], ctx["queries"]
    nr = ctx["fast_nq"]
    k = 10
    ck = Checks()
    bidx = BinaryIndex(bit_budget=256).train(base[:200_000]).encode(base)
    d, i = bidx.query(queries[:nr], k, backend="matmul")
    packed = np.asarray(bidx.packed)
    qpk = bidx.encode_queries(queries[:nr])
    popcnt8 = np.array([bin(v).count("1") for v in range(256)], np.int64)
    dist = np.stack([popcnt8[(packed ^ qpk[q][None, :]).view(np.uint8)]
                     .sum(axis=1) for q in range(nr)])        # (nr, n)
    ref_sorted = np.sort(dist, axis=1)[:, :k]
    ck.at_least("dists_equal_frac",
                np.mean(np.sort(np.asarray(d), axis=1) == ref_sorted), 1.0)
    got = np.take_along_axis(dist, np.asarray(i), axis=1)
    # ids: every returned id has the distance reported for it
    ck.at_least("ids_carry_their_distance_frac",
                np.mean(got == np.asarray(d)), 1.0)
    q01 = jnp.asarray(unpack_bits_01(qpk, bidx.total_bits))
    mem = memory_summary(hamming_topk_matmul, bidx.db01, bidx.db_pop, q01,
                         k=k)
    return ck, mem


class _PassCount:
    """pytest plugin: counts the tests that passed."""

    def __init__(self):
        self.passed = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1


def phase_gpu_tests(ctx):
    import pytest
    ck = Checks()
    count = _PassCount()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")], plugins=[count])
    ck.at_most("pytest_exit_code", int(rc), 0)
    # on the card the gpu tests run; none of them may skip
    ck.at_least("passed", count.passed, 1)
    return ck, {}


PHASES = [("groundtruth", phase_groundtruth), ("main", phase_main),
          ("serve", phase_serve), ("codes", phase_codes),
          ("decoded8", phase_decoded8), ("ivf", phase_ivf),
          ("fast4", phase_fast4), ("hamming", phase_hamming),
          ("gpu_tests", phase_gpu_tests)]


# ----------------------------------------------------------------------
# phases (four cards)
# ----------------------------------------------------------------------

def phase_lloyd_sharded(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vaq_tpu import kmeans
    from vaq_tpu.parallel import make_mesh
    from vaq_tpu.parallel.dist_kmeans import lloyd_sharded, shard_rows_for
    ck = Checks()
    x = ctx["base"][:, :16]
    c0 = jnp.asarray(kmeans.init_subset(x, 256, seed=ctx["seed"]))
    one = np.asarray(kmeans.lloyd(jnp.asarray(x), c0, iters=3))
    mesh = make_mesh((4,), ("db",), jax.devices()[:4])
    x_sh = shard_rows_for(mesh, jnp.asarray(x))
    sh = np.asarray(lloyd_sharded(x_sh, c0, jnp.int32(x.shape[0]), 3, mesh))
    # per-shard f32 partial sums reduce in another order; a rounding-level
    # tie can move one row to another centroid, shifting it by ≤ the
    # data's spread over the cluster's count
    rel = np.abs(sh - one).max() / np.abs(one).max()
    ck.at_most("centroid_max_rel_diff", float(rel), 1e-3)
    mem = memory_summary(lloyd_sharded, x_sh, c0, jnp.int32(x.shape[0]),
                         iters=3, mesh=mesh)
    return ck, mem


def phase_sharded_search(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import vaq_tpu
    from vaq_tpu import metrics
    from vaq_tpu.ivf import IVFSearcher, build_ivf
    from vaq_tpu.ops.distances import exact_search
    from vaq_tpu.parallel import make_mesh, sharded_exact_search
    from vaq_tpu.parallel.dist_kmeans import shard_rows_for
    base, queries = ctx["base"], ctx["queries"]
    k = 10
    ck = Checks()
    q_dev = jnp.asarray(queries)
    gt_d, gt = exact_search(q_dev, jnp.asarray(base), k)
    gt_d, gt = np.asarray(gt_d), np.asarray(gt)
    idx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(CONFIG)).build(base)
    idx.ivf = IVFSearcher(build_ivf(idx, ti_cluster_num=ctx["clusters"],
                                    ti_segment_num=16), 0.1)

    def run():
        out = {}
        for tier in ("decoded", "decoded8"):
            d, i = idx.search_device(q_dev, k, backend=tier, exact=True)
            out[tier] = (np.asarray(d), np.asarray(i))
        out["codes"] = (None, np.asarray(
            idx.search_device(q_dev, k, backend="codes")[1]))
        out["ivf"] = (None, idx.search(queries, k, backend="ivf",
                                       query_batch=queries.shape[0])[1])
        return out

    single = run()
    devs = jax.devices()[:4]
    mem = {}
    for tag, mesh, q_axis in (
            ("db4", make_mesh((4,), ("db",), devs), None),
            ("q2db2", make_mesh((2, 2), ("q", "db"), devs), "q")):
        # exact selection: the sharded brute-force search returns the
        # single-device groundtruth's ids (f32 distance ties aside)
        d_x, i_x = sharded_exact_search(shard_rows_for(mesh, jnp.asarray(base)),
                                        q_dev, k, jnp.int32(base.shape[0]),
                                        mesh, q_axis=q_axis)
        ck.at_least(f"{tag}_exact_same_ids_up_to_f32_ties_frac",
                    same_up_to_ties(queries, base, np.asarray(i_x), gt), 1.0)
        tol = f32_dist_tol(queries, base)[:, None]
        ck.at_most(f"{tag}_exact_dist_err_over_bound", float(np.max(
            np.abs(np.asarray(d_x) - gt_d) / (2.0 * tol))), 1.0)
        idx.shard(mesh, q_axis=q_axis,
                  tiers=("decoded", "decoded8", "codes", "ivf"))
        sharded = run()
        if not mem:
            from vaq_tpu.parallel import sharded_decoded_search
            mem = memory_summary(
                sharded_decoded_search, idx._sharded_decoded,
                idx._sharded_norms, pca_all(idx, queries), k=k,
                n_total=jnp.int32(idx.n_rows), mesh=mesh, exact=True)
        for tier in ("decoded", "decoded8"):
            # every shard keeps its own top-2k by scan score, so the sharded
            # candidate pool holds the single-device one and its rescored
            # distances are never worse at any rank (f32 slack aside)
            d_s, d_1 = sharded[tier][0], single[tier][0]
            worse = np.max((d_s - d_1) / np.maximum(np.abs(d_1), 1e-6))
            ck.at_most(f"{tag}_{tier}_dist_worse_rel", float(worse), 1e-5)
            loss = (metrics.avg_recall(single[tier][1], gt, k)
                    - metrics.avg_recall(sharded[tier][1], gt, k))
            ck.at_most(f"{tag}_{tier}_recall_loss", loss, 0.002)
        for tier, bound in (("codes", 0.01), ("ivf", 0.03)):
            # approximate selection formed per shard: windows (codes) and
            # the visit budget (ivf: each shard visits the fraction of its
            # own clusters) — measured ≤ 0.0002 and ≤ 0.011 on 4 virtual
            # CPU devices at 100k rows
            diff = abs(metrics.avg_recall(sharded[tier][1], gt, k)
                       - metrics.avg_recall(single[tier][1], gt, k))
            ck.at_most(f"{tag}_{tier}_recall_diff", diff, bound)
    return ck, mem


FOUR_PHASES = [("lloyd_sharded", phase_lloyd_sharded),
               ("sharded_search", phase_sharded_search)]


# ----------------------------------------------------------------------

def run_phase(name, fn, ctx) -> bool:
    t0 = time.perf_counter()
    try:
        checks, mem = fn(ctx)
    except Exception:  # noqa: BLE001 — report the phase as failed, go on
        traceback.print_exc()
        print(f"phase={name} ok=false error=exception "
              f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
        return False
    print(f"phase={name} ok={str(checks.ok).lower()} "
          f"checks={json.dumps(checks.items, sort_keys=True, default=float)} "
          f"memory={json.dumps(mem)} peak_bytes_in_use={peak_bytes()} "
          f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return checks.ok


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded phases, on four cards")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--gt-n", type=int, default=100_000)
    p.add_argument("--ref-queries", type=int, default=256,
                   help="queries compared with the plain references")
    p.add_argument("--fast-queries", type=int, default=16,
                   help="queries checked against NumPy integer sums "
                        "(fast4, hamming)")
    p.add_argument("--clusters", type=int, default=1000)
    p.add_argument("--phases", default="",
                   help="comma-separated subset of phases (rehearsals)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for line in card_line().splitlines() or [""]:
        print(f"card: {line}", flush=True)
    import jax
    devices = jax.devices()
    platform = devices[0].platform
    need = 4 if args.four else 1
    if platform != "gpu":
        print(f"chip_smoke: JAX's first device is {platform!r}, not a GPU; "
              "stopping.", file=sys.stderr, flush=True)
        return 2
    if len(devices) < need:
        print(f"chip_smoke: {need} GPUs needed, {len(devices)} found.",
              file=sys.stderr, flush=True)
        return 2
    return run(args, devices)


def run(args, devices) -> int:
    """Every selected phase; 0 only when all of them pass."""
    import vaq_tpu  # noqa: F401  (package precision setting)
    from vaq_tpu.data import make_anisotropic_gaussian

    t0 = time.perf_counter()
    base, queries = make_anisotropic_gaussian(args.n, args.d, args.queries,
                                              seed=args.seed)
    ctx = {"base": base, "queries": queries, "seed": args.seed,
           "gt_n": min(args.gt_n, args.n),
           "ref_nq": min(args.ref_queries, args.queries),
           "fast_nq": min(args.fast_queries, args.queries),
           "clusters": args.clusters}
    print(f"data: {args.n} x {args.d} rows, {args.queries} queries, "
          f"seed {args.seed} ({time.perf_counter() - t0:.1f}s)", flush=True)
    phases = FOUR_PHASES if args.four else PHASES
    if args.phases:
        keep = set(args.phases.split(","))
        phases = [p for p in phases if p[0] in keep]
    failed = [name for name, fn in phases if not run_phase(name, fn, ctx)]
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr, flush=True)
        return 1
    d0 = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}),
        flush=True)
    return 0


def _use_compile_cache() -> None:
    """JAX_COMPILATION_CACHE_DIR when set; otherwise one fixed directory in
    the checkout (listed in .gitignore)."""
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          os.path.join(HERE, ".jax_cache"))


if __name__ == "__main__":
    _use_compile_cache()
    sys.exit(main())

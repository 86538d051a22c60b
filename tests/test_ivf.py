"""Cluster-probe (TI analog) tests: recall approaches exhaustive scan as the
visit fraction grows (the reference's mVisit knob semantics)."""

import dataclasses

import numpy as np
import pytest

from vaq_tpu import metrics
from vaq_tpu.config import parse_method_string
from vaq_tpu.ivf import attach_ivf, resolve_seg_num
from vaq_tpu.vaq import VAQIndex


@pytest.fixture(scope="module")
def ti_index(sift_like):
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,TI32m16")
    idx = VAQIndex(cfg).train(base).encode(base)
    attach_ivf(idx)
    return idx, base, queries, gt


def test_ivf_state_shapes(ti_index):
    idx, base, _, _ = ti_index
    st = idx.ivf.state
    assert st.centroids.shape[0] == 32
    assert st.bucket_ids.shape == (32, st.cap)
    ids = np.asarray(st.bucket_ids)
    valid = ids[ids >= 0]
    # every row appears exactly once
    assert len(valid) == base.shape[0]
    assert len(np.unique(valid)) == base.shape[0]
    # capacity bounding keeps bucket padding waste controlled (cap is
    # rounded up to a multiple of 512, so every window size divides it)
    cap_bound = max(np.asarray(st.sizes).max(),
                    int(np.ceil(1.5 * base.shape[0] / 32)))
    assert st.cap <= -(-cap_bound // 512) * 512
    assert st.cap % 512 == 0
    np.testing.assert_array_equal(np.asarray(st.sizes),
                                  (ids >= 0).sum(axis=1))


def test_ivf_full_visit_matches_exhaustive(ti_index):
    idx, _, queries, gt = ti_index
    idx.ivf.visit = 1.0
    _, l_ivf = idx.search(queries, 50)
    _, l_full = idx.search(
        queries, 50, backend="decoded")  # TI branch skipped? no — method has TI
    # Compare recalls instead of exact ids (bf16 tie order can differ).
    r1 = metrics.avg_recall(l_ivf, gt, 50)
    idx2_methods = parse_method_string("VAQ128m16min7max8var1,SORT").methods
    cfg_plain = dataclasses.replace(idx.config, methods=idx2_methods)
    idx_plain = VAQIndex(cfg_plain)
    for f in ("eigvecs", "eigvals", "var_per_subs", "cum_var_per_subs",
              "subs_len", "highest_subs", "orig_dim", "bits", "centroids",
              "centroid_counts", "codes", "n_rows"):
        setattr(idx_plain, f, getattr(idx, f))
    _, l2 = idx_plain.search(queries, 50)
    r2 = metrics.avg_recall(l2, gt, 50)
    assert abs(r1 - r2) < 0.02, (r1, r2)


def test_ivf_visit_knob_monotone(ti_index):
    idx, _, queries, gt = ti_index
    recalls = []
    for visit in (0.1, 0.5, 1.0):
        idx.ivf.visit = visit
        _, labels = idx.search(queries, 20)
        recalls.append(metrics.avg_recall(labels, gt, 20))
    assert recalls[0] <= recalls[1] + 0.02
    assert recalls[1] <= recalls[2] + 0.02
    assert recalls[2] > 0.6  # ADC-only recall@20 ceiling for this config
    # partial visit must still be useful (queries are near their sources)
    assert recalls[0] > 0.3


def test_resolve_seg_num():
    cfg = parse_method_string("VAQ128m16min7max8var1,TI32m4")
    assert resolve_seg_num(cfg, np.linspace(0.1, 1.0, 16), 16) == 4
    cfg_var = parse_method_string("VAQ128m16min7max8var1,TI32var0.5")
    assert resolve_seg_num(cfg_var, np.linspace(0.1, 1.0, 16), 16) == \
        int(np.sum(np.linspace(0.1, 1.0, 16) <= 0.5))
    cfg_all = parse_method_string("VAQ128m16min7max8var1,TI32")
    assert resolve_seg_num(cfg_all, np.linspace(0.1, 1.0, 16), 16) == 16


def test_ivf_no_padding_ids_returned(ti_index):
    idx, base, queries, _ = ti_index
    idx.ivf.visit = 0.2
    _, labels = idx.search(queries, 10)
    assert labels.min() >= 0
    assert labels.max() < base.shape[0]


def test_ivf_visit_until_k_rule(ti_index):
    """The dynamic rule (VAQ.cpp:1548-1551): even with a tiny visit fraction
    every query must still see ≥ k candidate members, so k results with
    finite distances come back."""
    idx, base, queries, _ = ti_index
    idx.ivf.visit = 1e-9   # floor: 1 cluster — but rule must extend to ≥ k
    k = 150                # larger than any single bucket is likely to hold
    d, labels = idx.search(queries[:8], k)
    assert (labels >= 0).all()
    assert np.isfinite(d).all()
    idx.ivf.visit = idx.config.visit


def test_ivf_qcap_overflow_bounded(ti_index):
    """With heavily correlated queries (all probing the same clusters) the
    capacity dispatch must still return full result sets (qcap == nq when
    demand could reach it)."""
    idx, base, queries, gt = ti_index
    idx.ivf.visit = 0.25
    q_same = np.repeat(queries[:1], 64, axis=0)
    d, labels = idx.search(q_same, 10)
    # identical queries → identical results, no dropped slots
    assert (labels >= 0).all()
    np.testing.assert_array_equal(labels, np.repeat(labels[:1], 64, axis=0))
    idx.ivf.visit = idx.config.visit


def test_streamed_build_matches_standard(ti_index):
    """build_ivf_streamed (the 100M host-staged path) must produce probe
    state equivalent to build_ivf: every row bucketed exactly once, and
    search recall within tolerance of the standard build at the same
    visit fraction."""
    from vaq_tpu.ivf import IVFSearcher, build_ivf_streamed

    idx, base, queries, gt = ti_index
    st = build_ivf_streamed(idx, chunk_rows=1000, sample_n=2000,
                            verbose=False)
    ids = np.asarray(st.bucket_ids)
    valid = ids[ids >= 0]
    assert len(valid) == base.shape[0]
    assert len(np.unique(valid)) == base.shape[0]
    assert st.bucket_rows.dtype.name == "int8"
    assert st.cap % 512 == 0

    searcher = IVFSearcher(st, visit=0.5)
    import jax.numpy as jnp
    from vaq_tpu import pca
    qp = pca.project(queries, idx.eigvecs, idx.total_dim)
    _, lab_s = searcher.search(idx, jnp.asarray(qp), None, 20)
    from vaq_tpu import metrics
    idx.ivf.visit = 0.5
    _, lab_r = idx.search(queries, 20)
    r_s = metrics.avg_recall(np.asarray(lab_s), gt, 20)
    r_r = metrics.avg_recall(np.asarray(lab_r), gt, 20)
    assert abs(r_s - r_r) < 0.05, (r_s, r_r)


def test_transposed_buckets_d96(sift_like):
    """d % 128 != 0 databases (the Fig.-11 DEEP d=96 class) must build the
    TRANSPOSED (ncl, D, cap) bucket layout and probe with recall matching
    the row-major path's quality on equivalent data."""
    import numpy as np

    from vaq_tpu import metrics
    from vaq_tpu.ops.distances import exact_search

    rng = np.random.default_rng(5)
    base = (rng.standard_normal((4096, 96)) *
            np.linspace(3.0, 0.3, 96)[None, :]).astype(np.float32)
    queries = base[rng.choice(4096, 64, replace=False)] + \
        0.05 * rng.standard_normal((64, 96)).astype(np.float32)
    import jax.numpy as jnp
    _, gt = exact_search(jnp.asarray(queries), jnp.asarray(base), 10)
    gt = np.asarray(gt)

    cfg = parse_method_string("VAQ192m24min7max8var1,TI16m24")
    idx = VAQIndex(cfg).train(base).encode(base)
    attach_ivf(idx, visit=1.0)
    st = idx.ivf.state
    assert st.transposed
    assert st.bucket_rows.shape == (16, 96, st.cap)
    assert st.d_full == 96

    _, lab = idx.search(queries, 10)
    rec = metrics.avg_recall(lab, gt, 10)
    # full visit must sit at the exhaustive ADC ceiling (±int8 noise)
    _, lab_x = idx.search(queries, 10, backend="decoded")
    rec_x = metrics.avg_recall(lab_x, gt, 10)
    assert abs(rec - rec_x) < 0.02, (rec, rec_x)

    # streamed build takes the same transposed layout
    from vaq_tpu.ivf import IVFSearcher, build_ivf_streamed
    st2 = build_ivf_streamed(idx, chunk_rows=1000, sample_n=2000)
    assert st2.transposed and st2.bucket_rows.shape[1] == 96
    from vaq_tpu import pca
    qp = pca.project(queries, idx.eigvecs, idx.total_dim)
    _, lab2 = IVFSearcher(st2, 1.0).search(idx, jnp.asarray(qp), None, 10)
    rec2 = metrics.avg_recall(np.asarray(lab2), gt, 10)
    assert abs(rec2 - rec) < 0.05, (rec2, rec)

    # tombstones respected through the transposed delete path
    victim = int(lab[0, 0])
    idx.delete(victim)
    _, lab3 = idx.search(queries[:4], 10)
    assert victim not in lab3[0]


def test_streamed_build_respects_tombstones(sift_like):
    """build_ivf_streamed on an index with prior deletions
    must not serve the deleted rows (VAQIndex.search skips the tombstone
    post-filter on the TI path, so the probe state itself must mask them —
    the bucket_ids == -1 contract)."""
    from vaq_tpu.ivf import IVFSearcher, build_ivf_streamed

    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,TI32m16")
    idx = VAQIndex(cfg).train(base).encode(base)
    # delete every groundtruth top-1 of the first 16 queries: without
    # masking, these rows WILL come back as neighbors
    dead = np.unique(gt[:16, 0])
    idx.delete(dead)

    st = build_ivf_streamed(idx, chunk_rows=1000, sample_n=2000)
    ids = np.asarray(st.bucket_ids)
    assert not np.isin(ids[ids >= 0], dead).any()
    # live counts exclude tombstones
    assert np.asarray(st.sizes).sum() == base.shape[0] - dead.size

    import jax.numpy as jnp

    from vaq_tpu import pca
    searcher = IVFSearcher(st, visit=1.0)
    qp = pca.project(queries[:16], idx.eigvecs, idx.total_dim)
    d, lab = searcher.search(idx, jnp.asarray(qp), None, 10)
    lab = np.asarray(lab)
    assert not np.isin(lab[lab >= 0], dead).any()

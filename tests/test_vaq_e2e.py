"""End-to-end VAQ pipeline: train → encode → search → refine with recall
acceptance gates (the reference validates VAQ only this way, SURVEY §4)."""

import numpy as np
import pytest

from vaq_tpu import metrics
from vaq_tpu.config import parse_method_string
from vaq_tpu.vaq import VAQIndex


@pytest.fixture(scope="module")
def trained(sift_like):
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,HEAP")
    idx = VAQIndex(cfg).train(base).encode(base)
    return idx, base, queries, gt


def test_train_state_shapes(trained):
    idx, base, _, _ = trained
    assert idx.bits.sum() == 128
    assert idx.highest_subs == 16
    assert idx.subs_len == 8
    assert idx.centroids.shape == (16, 256, 8)
    assert idx.codes.shape == (16, base.shape[0])  # transposed storage
    assert idx.codes.dtype == np.uint8


def test_codes_in_range(trained):
    idx, _, _, _ = trained
    codes = idx.codes_rowmajor()
    for s in range(idx.highest_subs):
        assert codes[:, s].max() < idx.centroid_counts[s]


def test_recall_vs_groundtruth(trained):
    idx, _, queries, gt = trained
    k = 100
    d, labels = idx.search(queries, k)
    rec = metrics.avg_recall(labels, gt, k)
    # Pinned golden ± 1.5 pt. Measured on the fixed-seed fixture, CPU harness,
    # round 2: decoded recall@100 = 0.88125.
    assert abs(rec - 0.881) < 0.015, f"recall@100 drifted: {rec}"
    # distances must be non-decreasing per row
    dd = np.asarray(d)
    assert np.all(np.diff(dd, axis=1) >= -1e-4)


def test_recall_goldens_at_10(trained):
    """Pinned recall@10 goldens for the decoded and codes+LUT paths
    (measured round 2: decoded 0.628125, lut_gather 0.625, refined 1.0)."""
    idx, base, queries, gt = trained
    _, l10 = idx.search(queries, 10)
    rec_dec = metrics.avg_recall(np.asarray(l10), gt, 10)
    assert abs(rec_dec - 0.628) < 0.015, rec_dec
    _, g10 = idx.search(queries, 10, backend="lut_gather")
    rec_lut = metrics.avg_recall(np.asarray(g10), gt, 10)
    assert abs(rec_lut - 0.625) < 0.015, rec_lut
    _, l100 = idx.search(queries, 100)
    _, r10 = idx.refine(queries, l100, base, 10)
    assert metrics.avg_recall(np.asarray(r10), gt, 10) >= 0.99


def test_codes_backend_small_n_parity(trained):
    """backend='codes' must not lose recall when the database is small
    (r2 regression: a 256-row block_rows floor left only n/256 windows —
    with one candidate per window, recall was capped at windows/k). n below
    512·k routes to the decoded fallback (the identical ADC quantity
    ‖q − x̂‖²); mid-range n shrinks the window toward the 16-row minimum."""
    idx, _, queries, gt = trained
    rec_dec = metrics.avg_recall(
        np.asarray(idx.search(queries, 100)[1]), gt, 100)
    rec_codes = metrics.avg_recall(
        np.asarray(idx.search(queries, 100, backend="codes")[1]), gt, 100)
    assert rec_codes >= rec_dec - 0.005, (rec_codes, rec_dec)
    # k=4 at n=4000 wants 15-row windows, under the 16-row floor: the
    # decoded fallback, within a point of decoded.
    rec_dec4 = metrics.avg_recall(
        np.asarray(idx.search(queries, 4)[1]), gt, 4)
    rec_codes4 = metrics.avg_recall(
        np.asarray(idx.search(queries, 4, backend="codes")[1]), gt, 4)
    assert rec_codes4 >= rec_dec4 - 0.015, (rec_codes4, rec_dec4)


def test_refine_improves_recall(trained):
    idx, base, queries, gt = trained
    k = 10
    _, cand = idx.search(queries, 100)
    _, refined = idx.refine(queries, cand, base, k)
    rec_plain = metrics.avg_recall(
        np.asarray(idx.search(queries, k)[1]), gt, k)
    rec_refined = metrics.avg_recall(np.asarray(refined), gt, k)
    assert rec_refined >= rec_plain - 0.02
    assert rec_refined > 0.9


def test_search_query_batch_invariance(trained):
    idx, _, queries, _ = trained
    _, l1 = idx.search(queries, 10, query_batch=7)
    _, l2 = idx.search(queries, 10, query_batch=64)
    np.testing.assert_array_equal(l1, l2)


def test_save_load_roundtrip(tmp_path, trained):
    idx, _, queries, _ = trained
    p = str(tmp_path / "index.npz")
    idx.save(p)
    idx2 = VAQIndex.load(p)
    _, l1 = idx.search(queries[:8], 5)
    _, l2 = idx2.search(queries[:8], 5)
    np.testing.assert_array_equal(l1, l2)


def test_variance_truncation():
    """var<1 keeps only the leading subspaces (V4)."""
    from vaq_tpu.data import make_anisotropic_gaussian
    base, queries = make_anisotropic_gaussian(2000, 64, 16, seed=1, decay=0.85)
    cfg = parse_method_string("VAQ16m8min2max8var0.9,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    # Strong decay: only the leading subspaces survive the 0.9 cumvar cut.
    assert idx.highest_subs < 8
    assert idx.bits.sum() == 16
    d, labels = idx.search(queries, 10)
    assert np.asarray(labels).shape == (16, 10)


def test_quantized_lut_search(sift_like):
    """FAST-style u8-quantized-LUT search keeps recall close to f32 (V14/V16)."""
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m32min1max4var1,FAST")
    idx = VAQIndex(cfg).train(base).encode(base)
    idx.learn_quantization(base, sample_ratio=0.05)
    assert idx.lut_offsets is not None
    _, labels = idx.search(queries, 100)
    rec = metrics.avg_recall(np.asarray(labels), gt, 100)
    # 4-bit subspaces: lower ceiling than 8-bit, but must be functional.
    assert rec > 0.5, rec

    # f32 path (no quantization) should be within a few points.
    idx2 = VAQIndex(cfg.with_methods(
        parse_method_string("VAQ128m32min1max4var1,SORT").methods)).train(
        base).encode(base)
    _, labels2 = idx2.search(queries, 100)
    rec2 = metrics.avg_recall(np.asarray(labels2), gt, 100)
    assert abs(rec - rec2) < 0.05


def test_hardcoded_bit_allocation(sift_like):
    base, queries, _ = sift_like
    import dataclasses
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    cfg = dataclasses.replace(cfg, hardcoded_bits=(8,) * 16)
    idx = VAQIndex(cfg).train(base)
    assert list(idx.bits) == [8] * 16


def test_reference_artifact_roundtrip(tmp_path, trained):
    """Export to the C++ binary formats and rebuild an index from them.

    The re-imported index retrains its rotation from the same data
    (the reference persists no eigenvectors), which is deterministic — so
    the round trip must reproduce the rotation, codes, and search results
    exactly, not merely to a recall tolerance."""
    idx, base, queries, gt = trained
    cp = str(tmp_path / "cent.bin")
    kp = str(tmp_path / "codes.bin")
    idx.export_reference_artifacts(cp, kp)
    idx2 = VAQIndex.from_reference_artifacts(idx.config, cp, kp, base)
    np.testing.assert_allclose(idx2.eigvecs, idx.eigvecs, atol=1e-5)
    np.testing.assert_array_equal(
        idx2.codes_rowmajor(), idx.codes_rowmajor()[:, : idx2.highest_subs])
    d1, l1 = idx.search(queries[:16], 10)
    d2, l2 = idx2.search(queries[:16], 10)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


def test_fast3_hybrid_split(sift_like):
    """FAST3: only ≤4-bit subspaces see LUT quantization error (V15)."""
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ96m16min2max8var1,FAST3")
    idx = VAQIndex(cfg).train(base).encode(base)
    idx.learn_quantization(base, sample_ratio=0.05)
    assert idx.bits.max() > 4 and idx.bits.min() <= 4, list(idx.bits)
    _, labels = idx.search(queries, 50)
    rec = metrics.avg_recall(labels, gt, 50)
    cfg_s = parse_method_string("VAQ96m16min2max8var1,SORT")
    idx2 = VAQIndex(cfg_s).train(base).encode(base)
    _, labels2 = idx2.search(queries, 50)
    rec2 = metrics.avg_recall(labels2, gt, 50)
    assert abs(rec - rec2) < 0.05, (rec, rec2)


def test_hierarchical_kmeans_high_bits():
    """>8-bit subspaces route through the two-level k-means (V7)."""
    import dataclasses
    from vaq_tpu.data import make_anisotropic_gaussian
    base, queries = make_anisotropic_gaussian(3000, 32, 16, seed=3)
    cfg = parse_method_string("VAQ40m4min8max10var1,SORT")
    cfg = dataclasses.replace(cfg, hierarchical_kmeans=True, kmeans_iters=4)
    idx = VAQIndex(cfg).train(base).encode(base)
    assert idx.bits.max() > 8
    _, labels = idx.search(queries, 10)
    from vaq_tpu.ops.distances import compute_groundtruth
    gt = compute_groundtruth(queries, base, 10)
    rec = metrics.avg_recall(np.asarray(labels), gt, 10)
    assert rec > 0.5, rec


def test_crud_add(sift_like):
    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base[:3000]).encode(base[:3000])
    idx._ensure_decoded()
    new_ids = idx.add(base[3000:3100])
    assert list(new_ids) == list(range(3000, 3100))
    assert idx.n_rows == 3100
    # an added row must be findable as its own nearest neighbor
    _, labels = idx.search(base[3050:3051], 1)
    assert labels[0, 0] == 3050


def test_crud_delete(sift_like):
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    _, l0 = idx.search(queries[:8], 5)
    victim = int(l0[0, 0])
    idx.delete(victim)
    _, l1 = idx.search(queries[:8], 5, backend="decoded")
    assert victim not in l1[0]
    _, l2 = idx.search(queries[:8], 5, backend="lut")
    assert victim not in l2[0]


def test_crud_reconstruct(sift_like):
    base, _, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    rec = idx.reconstruct([0, 5])
    assert rec.shape == (2, idx.total_dim)
    # reconstruction error should be modest relative to vector norm
    xp = np.asarray(
        base[[0, 5]] @ idx.eigvecs[:, : idx.total_dim])
    rel = np.linalg.norm(rec - xp) / np.linalg.norm(xp)
    assert rel < 0.5, rel


def test_build_equals_train_encode(sift_like):
    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    i1 = VAQIndex(cfg).build(base)
    i2 = VAQIndex(cfg).train(base).encode(base)
    np.testing.assert_array_equal(np.asarray(i1.codes), np.asarray(i2.codes))
    _, l1 = i1.search(queries[:8], 5)
    _, l2 = i2.search(queries[:8], 5)
    np.testing.assert_array_equal(l1, l2)


def test_high_dim_gist_like():
    """960-d (GIST1M-shaped) config: L=30 subspaces, uneven structure."""
    from vaq_tpu.data import make_anisotropic_gaussian
    from vaq_tpu.ops.distances import compute_groundtruth
    base, queries = make_anisotropic_gaussian(2000, 960, 16, seed=5,
                                              decay=0.99)
    cfg = parse_method_string("VAQ256m32min2max8var1,SORT")
    idx = VAQIndex(cfg).build(base)
    assert idx.subs_len == 30
    gt = compute_groundtruth(queries, base, 10)
    _, labels = idx.search(queries, 10)
    rec = metrics.avg_recall(np.asarray(labels), gt, 10)
    assert rec > 0.5, rec


def test_encode_chunk_invariance(sift_like):
    base, _, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base)
    c1 = np.asarray(idx.encode(base, chunk_rows=700).codes)
    c2 = np.asarray(idx.encode(base, chunk_rows=10**6).codes)
    np.testing.assert_array_equal(c1, c2)


def test_delete_before_decoded_materialization(sift_like):
    """delete() before the decoded cache exists must still
    exclude the victim once _ensure_decoded/_ensure_decoded8 rebuild norms."""
    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    # find the top hit via the codes-only path so decoded stays unbuilt
    _, l0 = idx.search(queries[:4], 3, backend="lut")
    victim = int(l0[0, 0])
    assert idx.decoded is None and idx.decoded8 is None
    idx.delete(victim)
    _, l1 = idx.search(queries[:4], 3, backend="decoded")
    assert victim not in l1[0]
    _, l2 = idx.search(queries[:4], 3, backend="decoded8")
    assert victim not in l2[0]


def test_delete_persists_through_save_load(tmp_path, sift_like):
    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    _, l0 = idx.search(queries[:2], 2)
    victim = int(l0[0, 0])
    idx.delete(victim)
    p = str(tmp_path / "idx.npz")
    idx.save(p)
    idx2 = VAQIndex.load(p)
    _, l1 = idx2.search(queries[:2], 2, backend="decoded")
    assert victim not in l1[0]
    _, l2 = idx2.search(queries[:2], 2, backend="lut")
    assert victim not in l2[0]


def test_delete_with_ivf_attached(sift_like):
    """Rows deleted after attach_ivf must not be returned
    by the TI/IVF path (bucket norms/ids are tombstoned in place)."""
    from vaq_tpu.ivf import attach_ivf
    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,TI16var1")
    idx = VAQIndex(cfg).train(base).encode(base)
    attach_ivf(idx)
    _, l0 = idx.search(queries[:4], 5)
    victim = int(l0[0, 0])
    idx.delete(victim)
    _, l1 = idx.search(queries[:4], 5)
    assert victim not in l1[0]


def test_fast4_low_bits_returns_results(sift_like):
    """FAST with max_bits < 4 (LUTs narrower than 16 entries) must return
    real neighbors: an earlier kernel padded the LUT with +inf and poisoned
    every window score with NaN (0·inf)."""
    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ48m16min1max3var1,FAST")
    idx = VAQIndex(cfg).train(base).encode(base)
    idx.learn_quantization(base, sample_ratio=0.05)
    d4, l4 = idx.search(queries[:8], 5, backend="fast4")
    assert (l4 >= 0).all(), "fast4 lost all results for max_bits<4"
    assert np.isfinite(d4).all()
    # and the winners overlap the gather scan on the same LUTs (fast4 ranks
    # rows by the quantized u8 sums — the reference's FAST semantics — so
    # at 3-bit tables the sets differ noticeably; the regression guarded
    # here is the old all -1 NaN poisoning)
    _, lg = idx.search(queries[:8], 5, backend="lut_gather")
    overlap = np.mean([len(set(l4[q]) & set(lg[q])) / 5 for q in range(8)])
    assert overlap >= 0.3, overlap


def test_delete_codes_device_path(sift_like):
    """search_device(backend="codes") — the serving entry
    point SearchServer(backend="codes") dispatches to — must exclude
    tombstoned rows (it over-fetches k + #deleted and post-filters on
    device; the reference compacts instead, BitVecEngine.cpp:1626-1636)."""
    import jax.numpy as jnp

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    _, l0 = idx.search_device(jnp.asarray(queries[:4]), 5, backend="codes")
    l0 = np.asarray(l0)
    victims = [int(l0[0, 0]), int(l0[1, 0])]
    idx.delete(victims)
    d1, l1 = idx.search_device(jnp.asarray(queries[:4]), 5, backend="codes")
    l1 = np.asarray(l1)
    assert not np.isin(l1, victims).any()
    assert (l1 >= 0).all() and np.isfinite(np.asarray(d1)).all()


def test_serving_codes_backend_excludes_deleted(sift_like):
    """End-to-end: a SearchServer(backend='codes') never serves deleted rows."""
    from vaq_tpu.serving import SearchServer

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    srv = SearchServer(idx, k=5, max_batch=16, backend="codes")
    try:
        _, i0 = srv.search(queries[0])
        victim = int(i0[0, 0])
        idx.delete(victim)
        _, i1 = srv.search(queries[0])
        assert victim not in i1[0]
    finally:
        srv.close()


def test_explicit_backend_overrides_ivf(sift_like):
    """A concrete backend argument must win over the
    TI flag + attached probe state; backend='ivf' forces the probe path;
    backend='ivf' without state fails loudly."""
    from vaq_tpu.errors import NotReadyError
    from vaq_tpu.ivf import attach_ivf

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,TI16var1")
    idx = VAQIndex(cfg).train(base).encode(base)
    with pytest.raises(NotReadyError):
        idx.search(queries[:2], 3, backend="ivf")
    attach_ivf(idx)
    calls = []
    orig = idx.ivf.search

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    idx.ivf.search = spy
    idx.search(queries[:4], 5)                      # auto + TI → probe path
    assert calls
    calls.clear()
    _, ld = idx.search(queries[:4], 5, backend="decoded")
    assert not calls, "explicit backend must skip the probe path"
    idx.search(queries[:4], 5, backend="ivf")
    assert calls


def test_add_releases_sharded_buffers(sift_like):
    """add() must release the sharded device buffers,
    not just the mesh handle."""
    base, _, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base[:2000]).encode(base[:2000])
    idx.shard()
    assert idx._sharded_decoded is not None
    idx.add(base[2000:2050])
    assert idx._mesh is None
    assert idx._sharded_decoded is None and idx._sharded_norms is None


def test_learn_quantization_matches_host_reference(sift_like):
    """The on-device α-grid must reproduce the host-numpy
    quantile/loss computation it replaced (same α picked, same offsets and
    scales to f32 tolerance)."""
    import jax.numpy as jnp
    from vaq_tpu import pca
    from vaq_tpu.ops import scan_jax
    from vaq_tpu.rng import sample_rows
    from vaq_tpu import io as io_mod

    base, _, _ = sift_like
    cfg = parse_method_string("VAQ128m32min1max4var1,FAST")
    idx = VAQIndex(cfg).train(base).encode(base)
    idx.learn_quantization(base, sample_ratio=0.05)

    # host-numpy reference (the pre-r4 implementation)
    x = io_mod.pad_dims(np.asarray(base, np.float32), cfg.subspace_num)
    sample_n = min(max(1, int(0.05 * x.shape[0])), 65536)
    qs = sample_rows(x, sample_n, cfg.seed)
    qp = np.asarray(pca.project(qs, idx.eigvecs, idx.total_dim))
    luts = np.asarray(scan_jax.build_luts(jnp.asarray(qp),
                                          jnp.asarray(idx.centroids)))
    m = idx.highest_subs
    valid = (np.arange(idx.max_centroids)[None, :]
             < idx.centroid_counts[:, None])
    best_loss, best = np.inf, None
    for alpha in (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1):
        offsets = np.empty(m, np.float32)
        ceils = np.empty(m, np.float32)
        for s in range(m):
            col = luts[:, s, valid[s]].reshape(-1)
            offsets[s] = np.quantile(col, alpha)
            ceils[s] = np.quantile(np.maximum(col - offsets[s], 0.0),
                                   1.0 - alpha)
        scales = 255.0 / np.maximum(ceils, 1e-30)
        luts_m = np.where(valid[None], luts, 0.0)
        off_l = np.maximum(luts_m - offsets[None, :, None], 0.0)
        q8 = np.minimum(np.floor(off_l * scales[None, :, None]), 255.0)
        err = (off_l * scales[None, :, None] - q8) * valid[None]
        loss = float(np.sum(err * err))
        if loss <= best_loss:
            best_loss, best = loss, (offsets, scales)

    np.testing.assert_allclose(idx.lut_offsets, best[0], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(idx.lut_scales, best[1], rtol=2e-3)

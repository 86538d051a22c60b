"""Shard-count invariance: N-device results must equal single-device results
(the device-mesh analog of the reference's parallel-equivalence test,
test-bitvecengine.cpp:103-113; SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vaq_tpu.ops import scan_jax
from vaq_tpu.ops.distances import exact_search
from vaq_tpu.parallel import (make_mesh, shard_codes, sharded_adc_search,
                              sharded_exact_search)
from vaq_tpu.parallel.dist_kmeans import lloyd_sharded, shard_rows_for
from vaq_tpu import kmeans


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh()


@pytest.fixture(scope="module")
def mesh_2x4():
    return make_mesh((2, 4), ("q", "db"))


def test_sharded_adc_matches_single(mesh8):
    rng = np.random.default_rng(0)
    n, m, c, nq, k = 1000, 8, 16, 6, 10
    codes = jnp.asarray(rng.integers(0, c, size=(n, m)).astype(np.int32))
    luts = jnp.asarray(rng.random((nq, m, c)).astype(np.float32))

    d_ref, i_ref = scan_jax.adc_scan_topk(codes, luts, k)

    codes_sh = shard_codes(codes, mesh8)
    d, i = sharded_adc_search(codes_sh, luts, k, jnp.int32(n), mesh8,
                              block_rows=64)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-6)
    # ids may differ only on exact distance ties
    ref_full = np.zeros((nq, n))
    for q in range(nq):
        for s in range(m):
            ref_full[q] += np.asarray(luts)[q, s][np.asarray(codes)[:, s]]
    got = np.take_along_axis(ref_full, np.asarray(i), axis=1)
    np.testing.assert_allclose(got, np.asarray(d), rtol=1e-5)


def test_sharded_adc_q_and_db_axes(mesh_2x4):
    rng = np.random.default_rng(1)
    n, m, c, nq, k = 512, 4, 8, 8, 5
    codes = jnp.asarray(rng.integers(0, c, size=(n, m)).astype(np.int32))
    luts = jnp.asarray(rng.random((nq, m, c)).astype(np.float32))

    d_ref, _ = scan_jax.adc_scan_topk(codes, luts, k)
    codes_sh = shard_codes(codes, mesh_2x4)
    d, i = sharded_adc_search(codes_sh, luts, k, jnp.int32(n), mesh_2x4,
                              block_rows=32, q_axis="q")
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-6)


def test_sharded_adc_unpadded_rows(mesh8):
    """n not divisible by shard count: padding rows must never appear."""
    rng = np.random.default_rng(2)
    n, m, c, nq, k = 997, 4, 8, 3, 20
    codes = jnp.asarray(rng.integers(0, c, size=(n, m)).astype(np.int32))
    luts = jnp.asarray(rng.random((nq, m, c)).astype(np.float32))
    d_ref, _ = scan_jax.adc_scan_topk(codes, luts, k)
    codes_sh = shard_codes(codes, mesh8)
    d, i = sharded_adc_search(codes_sh, luts, k, jnp.int32(n), mesh8,
                              block_rows=32)
    assert np.asarray(i).max() < n
    assert np.asarray(i).min() >= 0
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-6)


def test_sharded_exact_matches_single(mesh8):
    rng = np.random.default_rng(3)
    db = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    d_ref, i_ref = exact_search(jnp.asarray(q), jnp.asarray(db), 7)
    db_sh = shard_rows_for(mesh8, jnp.asarray(db))
    d, i = sharded_exact_search(db_sh, jnp.asarray(q), 7, jnp.int32(500), mesh8)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


def test_sharded_kmeans_matches_single_device(mesh8):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((640, 8)).astype(np.float32)
    c0 = kmeans.init_subset(x, 16, seed=5)

    ref = np.asarray(kmeans.lloyd(jnp.asarray(x), jnp.asarray(c0), iters=5))
    x_sh = shard_rows_for(mesh8, jnp.asarray(x))
    got = np.asarray(lloyd_sharded(x_sh, jnp.asarray(c0), jnp.int32(640),
                                   5, mesh8))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_sharded_decoded_matches_single(mesh8):
    from vaq_tpu.ops import scan_decoded
    from vaq_tpu.parallel import sharded_decoded_search
    rng = np.random.default_rng(5)
    n, d, nq, k = 1000, 32, 6, 10
    dec = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32)).astype(
        jnp.bfloat16)
    norms = jnp.sum(dec.astype(jnp.float32) ** 2, axis=1)
    qp = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))

    d_ref, i_ref = scan_decoded.decoded_scan_topk(dec, norms, qp, k,
                                                  exact=True)
    pad = (-n) % 8
    dec_sh = shard_rows_for(mesh8, dec)
    norms_p = jnp.pad(norms, (0, pad))
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    norms_sh = jax.device_put(norms_p, NamedSharding(mesh8, P("db")))
    d, i = sharded_decoded_search(dec_sh, norms_sh, qp, k, jnp.int32(n),
                                  mesh8, exact=True)
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))


def test_index_shard_method(mesh8, sift_like):
    """VAQIndex.shard(): sharded serving equals single-device results."""
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.vaq import VAQIndex
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    d_ref, l_ref = idx.search_device(jnp.asarray(queries[:16]), 10,
                                     exact=True)
    idx.shard(mesh8)
    d_sh, l_sh = idx.search_device(jnp.asarray(queries[:16]), 10, exact=True)
    # The sharded path rescores 8·k candidates exactly vs k on one device,
    # so tail entries can legitimately differ where the bf16 scan score
    # disagrees with the exact distance near the k boundary. Top-1 must
    # match; distances must be near-identical; recall must be equal-or-
    # better for the sharded merge.
    dr, ds = np.asarray(d_ref), np.asarray(d_sh)
    lr, ls = np.asarray(l_ref), np.asarray(l_sh)
    np.testing.assert_array_equal(lr[:, 0], ls[:, 0])
    # Set-equality modulo the k-boundary: the sharded pool (8 shards × 2k
    # candidates) is a superset of the single-device pool (2k), so after the
    # shared exact rescore at most the last slot can differ, and only when
    # the bf16 scan score disagreed with exact distance right at the
    # boundary.
    for q in range(lr.shape[0]):
        inter = set(lr[q]) & set(ls[q])
        assert len(inter) >= 9, (q, lr[q], ls[q])
    # distances: exact rescore both sides → the common sorted prefix agrees
    # to f32 tolerance, and sharded is never worse at any rank
    k_common = min(9, dr.shape[1])
    np.testing.assert_allclose(ds[:, :k_common], dr[:, :k_common],
                               rtol=1e-4, atol=1e-4)
    assert np.all(ds <= dr + 1e-3)
    from vaq_tpu import metrics
    r_ref = metrics.avg_recall(lr, gt[:16], 10)
    r_sh = metrics.avg_recall(ls, gt[:16], 10)
    assert r_sh >= r_ref - 1e-9, (r_sh, r_ref)


def test_pod_mesh_single_process():
    from vaq_tpu.parallel.multihost import pod_mesh
    mesh, q_axis = pod_mesh()
    assert q_axis is None
    assert mesh.shape["db"] == 8


def test_delete_after_shard(sift_like):
    """Tombstones created after .shard() must reach the
    sharded norms (no stale _sharded_norms)."""
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.vaq import VAQIndex

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    idx.shard(make_mesh())
    _, l0 = idx.search(queries[:4], 3)
    victim = int(l0[0, 0])
    idx.delete(victim)
    _, l1 = idx.search(queries[:4], 3)
    assert victim not in l1[0]


def test_sharded_decoded8_matches_single(mesh8, sift_like):
    """The int8 capacity tier has a sharded path whose
    results match the single-device decoded8 scan (set-equality modulo the
    k-boundary, as for the bf16 tier)."""
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.vaq import VAQIndex

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    d_ref, l_ref = idx.search_device(jnp.asarray(queries[:16]), 10,
                                     backend="decoded8", exact=True)
    idx.shard(mesh8, tiers=("decoded8",))
    assert idx._sharded_decoded is None  # only the requested tier sharded
    d_sh, l_sh = idx.search_device(jnp.asarray(queries[:16]), 10,
                                   backend="decoded8", exact=True)
    lr, ls = np.asarray(l_ref), np.asarray(l_sh)
    np.testing.assert_array_equal(lr[:, 0], ls[:, 0])
    # The sharded pool rescores 8·2k candidates vs 2k on one device, and the
    # int8 tier's rescore itself is over dequantized rows, so up to two
    # boundary slots can legitimately swap; the sharded merge can only
    # improve the (int8-metric) distances.
    for q in range(lr.shape[0]):
        assert len(set(lr[q]) & set(ls[q])) >= 8, (q, lr[q], ls[q])
    dr, ds = np.asarray(d_ref), np.asarray(d_sh)
    np.testing.assert_allclose(ds[:, :5], dr[:, :5], rtol=1e-4, atol=1e-4)
    assert np.all(ds <= dr + 1e-3)


def test_sharded_codes_matches_single(mesh8, sift_like):
    """The codes-resident (decode-then-dot) tier has a
    sharded path; per-shard windows are smaller, so compare top-1 and
    overlap rather than exact sets (window-candidate semantics)."""
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.vaq import VAQIndex

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    d_ref, l_ref = idx.search_device(jnp.asarray(queries[:8]), 5,
                                     backend="codes")
    idx.shard(mesh8, tiers=("codes",))
    d_sh, l_sh = idx.search_device(jnp.asarray(queries[:8]), 5,
                                   backend="codes")
    lr, ls = np.asarray(l_ref), np.asarray(l_sh)
    assert (ls >= 0).all() and (ls < idx.n_rows).all()
    np.testing.assert_array_equal(lr[:, 0], ls[:, 0])
    overlap = np.mean([len(set(lr[q]) & set(ls[q])) / 5
                       for q in range(lr.shape[0])])
    assert overlap >= 0.8, overlap


def test_sharded_codes_tombstones(mesh8, sift_like):
    """Deletes must be honored by the sharded codes tier (on-device id
    post-filter after the merge)."""
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.vaq import VAQIndex

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    idx.shard(mesh8, tiers=("codes",))
    _, l0 = idx.search(queries[:4], 5, backend="codes")
    victim = int(l0[0, 0])
    idx_resharded = idx.delete(victim) or idx
    # delete() keeps the sharded codes (ids filtered at query time)
    _, l1 = idx.search(queries[:4], 5, backend="codes")
    assert victim not in l1[0]


def test_sharded_missing_tier_raises(mesh8, sift_like):
    """A sharded index must fail loudly for a backend whose tier was not
    sharded."""
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.errors import ConfigError
    from vaq_tpu.vaq import VAQIndex

    base, queries, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    idx.shard(mesh8)  # decoded only
    with pytest.raises(ConfigError):
        idx.search_device(jnp.asarray(queries[:4]), 5, backend="decoded8")
    with pytest.raises(ConfigError):
        idx.search_device(jnp.asarray(queries[:4]), 5, backend="codes")


def test_sharded_ivf_matches_unsharded(mesh8, sift_like):
    """Cluster-sharded probe results must track the unsharded probe at the
    same visit fraction (per-shard visiting reorders candidate composition
    slightly, so compare recall overlap, not exact ids) — and the mesh+TI
    trap must raise when the ivf tier was not sharded."""
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.errors import ConfigError
    from vaq_tpu.ivf import attach_ivf
    from vaq_tpu.vaq import VAQIndex

    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,TI32m16")
    idx = VAQIndex(cfg).train(base).encode(base)
    attach_ivf(idx, visit=0.5)
    _, l_ref = idx.search(queries, 10)          # unsharded probe

    # trap: sharded index + TI path without the ivf tier must fail loudly
    idx.shard(mesh8, tiers=("decoded",))
    with pytest.raises(ConfigError):
        idx.search(queries[:4], 10)

    idx.shard(mesh8, tiers=("decoded", "ivf"))
    _, l_sh = idx.search(queries, 10)
    assert (l_sh >= 0).all() and (l_sh < idx.n_rows).all()
    overlap = np.mean([len(set(l_ref[q]) & set(l_sh[q])) / 10
                       for q in range(l_ref.shape[0])])
    assert overlap >= 0.7, overlap

    # tombstones propagate into the sharded bucket copy
    victim = int(l_sh[0, 0])
    idx.delete(victim)
    _, l_del = idx.search(queries[:4], 10)
    assert victim not in l_del[0]


def test_sharded_ivf_rescore_matches_unsharded(mesh8, sift_like):
    """The sharded int8 probe must apply the same exact
    second-stage rescore as the unsharded path (commit 0ebb99c) — at
    visit=1.0 both select the identical global stage-1 candidate set, so
    with the distributed rescore their recall must be equal (int8-metric
    ties aside), not ~1 pt apart."""
    from vaq_tpu import metrics
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.ivf import attach_ivf
    from vaq_tpu.vaq import VAQIndex

    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,TI32m16")
    idx = VAQIndex(cfg).train(base).encode(base)
    attach_ivf(idx, visit=1.0)
    _, l_ref = idx.search(queries, 10)          # unsharded, with rescore

    idx.shard(mesh8, tiers=("decoded", "ivf"))
    assert idx._sharded_ivf.rescore_rows is not None
    _, l_sh = idx.search(queries, 10)
    r_ref = metrics.avg_recall(l_ref, gt, 10)
    r_sh = metrics.avg_recall(l_sh, gt, 10)
    assert abs(r_sh - r_ref) < 0.01, (r_sh, r_ref)

    # rescored distances are in the decoded metric: the top-1 candidate
    # sets should now agree almost everywhere
    agree = np.mean(l_sh[:, 0] == l_ref[:, 0])
    assert agree > 0.95, agree

    # tombstones stay excluded through the rescore path
    victim = int(l_sh[0, 0])
    idx.delete(victim)
    _, l_del = idx.search(queries[:4], 10)
    assert victim not in l_del[0]


def test_sharded_ivf_transposed_d96(mesh8):
    """Cluster-sharded probe over the TRANSPOSED (ncl, D, cap) bucket
    layout (d % 128 != 0 — the 100M DEEP-96 class) with the distributed
    rescore: recall must match the unsharded transposed probe."""
    from vaq_tpu import metrics
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.ivf import attach_ivf
    from vaq_tpu.ops.distances import exact_search
    from vaq_tpu.vaq import VAQIndex

    rng = np.random.default_rng(6)
    base = (rng.standard_normal((4096, 96)) *
            np.linspace(3.0, 0.3, 96)[None, :]).astype(np.float32)
    queries = base[rng.choice(4096, 48, replace=False)] + \
        0.05 * rng.standard_normal((48, 96)).astype(np.float32)
    _, gt = exact_search(jnp.asarray(queries), jnp.asarray(base), 10)
    gt = np.asarray(gt)

    cfg = parse_method_string("VAQ192m24min7max8var1,TI32m24")
    idx = VAQIndex(cfg).train(base).encode(base)
    attach_ivf(idx, visit=1.0)
    assert idx.ivf.state.transposed
    _, l_ref = idx.search(queries, 10)
    idx.shard(mesh8, tiers=("decoded", "ivf"))
    assert idx._sharded_ivf.transposed
    _, l_sh = idx.search(queries, 10)
    r_ref = metrics.avg_recall(l_ref, gt, 10)
    r_sh = metrics.avg_recall(l_sh, gt, 10)
    assert abs(r_sh - r_ref) < 0.02, (r_sh, r_ref)


def test_sharded_ivf_requires_attach(mesh8, sift_like):
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.errors import ConfigError
    from vaq_tpu.vaq import VAQIndex

    base, _, _ = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    with pytest.raises(ConfigError):
        idx.shard(mesh8, tiers=("ivf",))

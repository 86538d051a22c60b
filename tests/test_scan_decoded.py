"""Decoded-matmul scan backend: must agree with the LUT gather scan
(identical math: Σ_s ‖q_s − C_s[code]‖² = ‖q − decode(x)‖²)."""

import jax.numpy as jnp
import numpy as np

from vaq_tpu.ops import scan_decoded, scan_jax
from vaq_tpu import metrics


def _setup(seed=0, n=2000, m=8, c=16, l=4, nq=6):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = rng.integers(0, c, size=(n, m)).astype(np.int32)
    q = rng.standard_normal((nq, m * l)).astype(np.float32)
    return cent, codes, q


def test_decode_db_reconstruction():
    cent, codes, _ = _setup()
    dec, norms = scan_decoded.decode_db(jnp.asarray(codes.T), jnp.asarray(cent),
                                        block_rows=256)
    n, m = codes.shape
    l = cent.shape[2]
    ref = np.concatenate([cent[s][codes[:, s]] for s in range(m)], axis=1)
    np.testing.assert_allclose(np.asarray(dec, dtype=np.float32), ref,
                               rtol=1e-2, atol=1e-2)  # bf16 storage
    np.testing.assert_allclose(np.asarray(norms), (ref * ref).sum(1),
                               rtol=1e-4)


def test_decoded_matches_lut_scan():
    cent, codes, q = _setup()
    k = 20
    luts = scan_jax.build_luts(jnp.asarray(q), jnp.asarray(cent))
    d_lut, i_lut = scan_jax.adc_scan_topk(jnp.asarray(codes), luts, k)
    dec, norms = scan_decoded.decode_db(jnp.asarray(codes.T), jnp.asarray(cent))
    d_dec, i_dec = scan_decoded.decoded_scan_topk(dec, norms, jnp.asarray(q),
                                                  k, exact=True)
    # bf16 rounding perturbs distances slightly; top-k sets should overlap
    # almost entirely and distances agree loosely.
    for qi in range(q.shape[0]):
        inter = len(set(np.asarray(i_lut)[qi]) & set(np.asarray(i_dec)[qi]))
        assert inter >= k - 2, (qi, inter)
    np.testing.assert_allclose(np.asarray(d_dec), np.asarray(d_lut),
                               rtol=0.05, atol=0.05)


def test_decoded_exact_vs_approx():
    """approx candidate selection + exact rescore ≈ exact top-k (high overlap,
    identical distances on the common prefix)."""
    cent, codes, q = _setup(seed=1)
    dec, norms = scan_decoded.decode_db(jnp.asarray(codes.T), jnp.asarray(cent))
    d1, i1 = scan_decoded.decoded_scan_topk(dec, norms, jnp.asarray(q), 10,
                                            exact=True)
    d2, i2 = scan_decoded.decoded_scan_topk(dec, norms, jnp.asarray(q), 10,
                                            exact=False, recall_target=0.99)
    for qi in range(q.shape[0]):
        inter = len(set(np.asarray(i1)[qi]) & set(np.asarray(i2)[qi]))
        assert inter >= 9, (qi, inter)
    # distances ascending in both
    assert np.all(np.diff(np.asarray(d2), axis=1) >= -1e-5)


def test_decoded_n_valid():
    cent, codes, q = _setup(seed=2)
    dec, norms = scan_decoded.decode_db(jnp.asarray(codes.T), jnp.asarray(cent))
    _, i = scan_decoded.decoded_scan_topk(dec, norms, jnp.asarray(q), 10,
                                          n_valid=jnp.int32(17))
    assert np.asarray(i).max() < 17


def test_index_backend_equivalence(sift_like):
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.vaq import VAQIndex
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    _, l_dec = idx.search(queries, 50, backend="decoded")
    _, l_lut = idx.search(queries, 50, backend="lut")
    r_dec = metrics.avg_recall(l_dec, gt, 50)
    r_lut = metrics.avg_recall(l_lut, gt, 50)
    assert abs(r_dec - r_lut) < 0.01, (r_dec, r_lut)


def test_int8_tier_matches_bf16(sift_like):
    from vaq_tpu.config import parse_method_string
    from vaq_tpu.vaq import VAQIndex
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    _, l16 = idx.search(queries, 50, backend="decoded")
    _, l8 = idx.search(queries, 50, backend="decoded8")
    r16 = metrics.avg_recall(l16, gt, 50)
    r8 = metrics.avg_recall(l8, gt, 50)
    assert abs(r16 - r8) < 0.02, (r16, r8)


def test_decode_db_int8_reconstruction():
    import jax.numpy as jnp
    from vaq_tpu.ops import scan_decoded
    cent, codes, _ = _setup()
    d8, scales, norms = scan_decoded.decode_db_int8(
        jnp.asarray(codes.T), jnp.asarray(cent), block_rows=256)
    m, l = cent.shape[0], cent.shape[2]
    ref = np.concatenate([cent[s][codes[:, s]] for s in range(m)], axis=1)
    rec = np.asarray(d8, dtype=np.float32).T / np.asarray(scales)[None, :]
    # int8 quantization error bounded by step size per dim
    step = 1.0 / np.asarray(scales)
    assert np.all(np.abs(rec - ref) <= step[None, :] * 0.51 + 1e-6)
    np.testing.assert_allclose(np.asarray(norms), (ref * ref).sum(1), rtol=1e-4)


def test_approx_miss_rate():
    """Quantifies the bf16 + approx-top-k miss rate of the decoded scan vs
    exact=True. With the 2k over-fetch + exact rescore, top-k membership
    must agree with the exact scan to ≥ 99% at realistic code-quantized
    data. (Where approx_max_k is truly approximate it can miss more,
    depending on recall_target.)"""
    rng = np.random.default_rng(21)
    n, d, nq, k = 60000, 64, 32, 10
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    dec = jnp.asarray(db).astype(jnp.bfloat16)
    norms = jnp.sum(jnp.asarray(db) * jnp.asarray(db), axis=1)
    d_a, i_a = scan_decoded.decoded_scan_topk(dec, norms, jnp.asarray(q), k)
    d_e, i_e = scan_decoded.decoded_scan_topk(dec, norms, jnp.asarray(q), k,
                                              exact=True)
    agree = np.mean([len(set(np.asarray(i_a)[t]) & set(np.asarray(i_e)[t]))
                     / k for t in range(nq)])
    assert agree >= 0.99, agree
    # distances of the agreed ids are identical (exact rescore both sides)
    np.testing.assert_allclose(np.asarray(d_a)[:, 0], np.asarray(d_e)[:, 0],
                               rtol=1e-5)

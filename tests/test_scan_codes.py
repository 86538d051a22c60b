"""Codes-tier scans: the XLA window scan and the FAST (u8-sum) scan against
NumPy references, and the Triton window kernel (in interpret mode) against
the XLA scan. The compiled kernel is compared with its reference on the card
by chip_smoke.py and the `gpu`-marked test below."""

import jax.numpy as jnp
import numpy as np
import pytest

from vaq_tpu.ops import scan_codes, scan_jax


def _setup(seed=0, n=2048, m=8, nq=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, size=(n, m)).astype(np.int32)
    luts = rng.random((nq, m, 16)).astype(np.float32)
    return codes, luts


def _numpy_adc(codes, luts):
    nq, m, c = luts.shape
    out = np.zeros((nq, codes.shape[0]))
    for q in range(nq):
        for s in range(m):
            out[q] += luts[q, s][codes[:, s]]
    return out


def _codes_index(seed, m, c, l, n, nq):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = rng.integers(0, c, (n, m)).astype(np.uint8)
    qp = rng.standard_normal((nq, m * l)).astype(np.float32)
    table, rows = scan_codes.build_decode_tables(cents)
    return cents, codes, qp, table, rows


def _bf16_window_ref(cents, codes, qp, br):
    """Window minima of ‖q − bf16(x̂)‖² in float64, and their rows."""
    m = cents.shape[0]
    xhat = cents[np.arange(m)[None, :], codes].reshape(codes.shape[0], -1)
    xb = np.asarray(jnp.asarray(xhat).astype(jnp.bfloat16), np.float64)
    qb = np.asarray(jnp.asarray(qp).astype(jnp.bfloat16), np.float64)
    q64 = qp.astype(np.float64)
    dist = ((xb ** 2).sum(1)[None, :] - 2.0 * qb @ xb.T
            + (q64 ** 2).sum(1)[:, None])
    w = dist.reshape(qp.shape[0], -1, br)
    return w.min(axis=2), w.argmin(axis=2)


def test_window_scan_matches_numpy():
    cents, codes, qp, table, _ = _codes_index(0, 8, 16, 4, 2048, 4)
    scores, ids = scan_codes.window_scan_xla(
        jnp.asarray(codes.T.copy()), table, jnp.asarray(qp), 256)
    ref_min, ref_arg = _bf16_window_ref(cents, codes, qp, 256)
    np.testing.assert_allclose(np.asarray(scores), ref_min, rtol=1e-4,
                               atol=1e-3)
    base = np.arange(2048 // 256) * 256
    agree = np.mean(np.asarray(ids) == ref_arg + base[None, :])
    assert agree >= 0.95, agree          # ties within f32 rounding only


def test_fast4_topk_high_recall_vs_exact():
    codes, luts = _setup(seed=1, n=4096, m=6, nq=5)
    k = 8
    d_ref, i_ref = scan_jax.adc_scan_topk(jnp.asarray(codes),
                                          jnp.asarray(luts), k)
    d, i = scan_jax.fast_scan_topk(jnp.asarray(codes), jnp.asarray(luts),
                                   None, k, block_rows=64)
    # without quantized tables the FAST scan is the exact scan
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref), rtol=1e-6)
    assert np.all(np.diff(np.asarray(d), axis=1) >= -1e-5)


def test_fast4_topk_n_valid():
    codes, luts = _setup(seed=2, n=512, m=4, nq=3)
    _, i = scan_jax.fast_scan_topk(jnp.asarray(codes), jnp.asarray(luts),
                                   None, 5, n_valid=jnp.int32(40),
                                   block_rows=32)
    ids = np.asarray(i)
    assert ids.max() < 40
    assert np.all((ids >= 0) | (ids == -1))


def test_fast4_unpadded_rows():
    codes, luts = _setup(seed=3, n=1000, m=4, nq=2)
    d, i = scan_jax.fast_scan_topk(jnp.asarray(codes), jnp.asarray(luts),
                                   None, 5, block_rows=128)
    assert np.asarray(i).max() < 1000
    assert np.all(np.isfinite(np.asarray(d)))


def test_int8_kernel_matches_quantized_reference():
    """With u8 tables the FAST scan's winners are the k smallest sums of raw
    u8 entries (the reference FAST semantics, VAQ.cpp:1800-1830) — equal up
    to ties at the k-th sum — and the returned distances are exact f32 ADC
    sums from the unquantized LUTs."""
    rng = np.random.default_rng(17)
    n, m, nq, k = 4096, 16, 4, 5
    codes = rng.integers(0, 16, (n, m), dtype=np.int8)
    luts = rng.random((nq, m, 16), dtype=np.float32) * 4.0
    lut8 = np.clip(np.floor(luts * 63.0), 0, 255).astype(np.uint8)
    d, i = scan_jax.fast_scan_topk(jnp.asarray(codes), jnp.asarray(luts),
                                   jnp.asarray(lut8), k, block_rows=128)
    got_d, got_i = np.asarray(d), np.asarray(i)
    sums = np.zeros((nq, n), dtype=np.int64)
    for q in range(nq):
        for s in range(m):
            sums[q] += lut8[q, s][codes[:, s]].astype(np.int64)
    full = _numpy_adc(codes, luts)
    for q in range(nq):
        np.testing.assert_array_equal(np.sort(sums[q][got_i[q]]),
                                      np.sort(sums[q])[:k])
        np.testing.assert_allclose(got_d[q], full[q][got_i[q]], rtol=1e-5)


def test_general_c_window_scan():
    """Several (M, C, L) geometries, including a d that needs column padding
    in the decode table (d = 48 → 64)."""
    for seed, (m, c, l, n, br) in enumerate(((4, 256, 4, 1024, 64),
                                             (8, 32, 4, 1024, 64),
                                             (16, 4, 3, 512, 32))):
        cents, codes, qp, table, _ = _codes_index(seed, m, c, l, n, 3)
        assert table.shape[1] >= m * l and table.shape[1] & (
            table.shape[1] - 1) == 0
        scores, ids = scan_codes.window_scan_xla(
            jnp.asarray(codes.T.copy()), table, jnp.asarray(qp), br)
        ref_min, _ = _bf16_window_ref(cents, codes, qp, br)
        np.testing.assert_allclose(np.asarray(scores), ref_min, rtol=1e-4,
                                   atol=1e-3)
        assert np.asarray(ids).shape == (3, n // br)


def test_decode_scan_topk_exact_vs_bruteforce():
    """Returned distances are exact ADC sums (f32 reconstruction) and the
    true top-1 row wins at several (C, L) geometries."""
    for m, c, l, n, br in ((8, 16, 4, 1024, 16), (32, 256, 4, 4096, 64),
                           (16, 4, 8, 1024, 16)):
        cents, codes, qp, table, rows = _codes_index(31, m, c, l, n, 4)
        dk, ik = scan_codes.decode_scan_topk(
            jnp.asarray(codes.T.copy()), table, rows, jnp.asarray(qp), 10,
            block_rows=br, impl="xla")
        dk, ik = np.asarray(dk), np.asarray(ik)
        xhat = cents[np.arange(m)[None, :], codes].reshape(n, m * l)
        full = ((qp[:, None, :] - xhat[None, :, :]) ** 2).sum(2)
        for q in range(4):
            np.testing.assert_allclose(dk[q], full[q][ik[q]], rtol=1e-5)
            assert ik[q][0] == np.argmin(full[q]), (m, c, q)


def test_decode_rescore_exact():
    """rescore_codes returns exact f32 per-pair distances."""
    rng = np.random.default_rng(32)
    m, c, l, nq, kk = 8, 64, 4, 5, 20
    d = m * l
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    cand = rng.integers(0, c, (nq, kk, m)).astype(np.uint8)
    qp = rng.standard_normal((nq, d)).astype(np.float32)
    _, rows = scan_codes.build_decode_tables(cents)
    d2 = np.asarray(scan_codes.rescore_codes(jnp.asarray(cand), rows,
                                             jnp.asarray(qp)))
    xhat = cents[np.arange(m)[None, None, :], cand].reshape(nq, kk, d)
    ref = ((qp[:, None, :] - xhat) ** 2).sum(2)
    np.testing.assert_allclose(d2, ref, rtol=1e-5)


def test_codes_backend_matches_decoded():
    """VAQIndex backend='codes' returns the decoded backend's neighbors on a
    small index (both rescore exactly; window-best candidates suffice when
    n/block_rows >> k)."""
    import vaq_tpu
    from vaq_tpu.data import make_sift_like
    # n ≥ 64·k·16 keeps the codes path eligible (16-row window floor; below
    # it the backend falls back to the decoded scan whose bf16 distances
    # would fail the exactness check here)
    base, queries, gt = make_sift_like(n=8000, n_queries=8, d=64, seed=3)
    cfg = vaq_tpu.parse_method_string("VAQ128m16min7max8var1,HEAP")
    idx = vaq_tpu.VAQIndex(cfg).train(base).encode(base)
    d_dec, i_dec = idx.search(queries, 5, backend="decoded")
    d_cod, i_cod = idx.search(queries, 5, backend="codes")
    assert (i_dec[:, 0] == i_cod[:, 0]).mean() >= 0.9
    from vaq_tpu import pca as _pca
    qp = np.asarray(_pca.project(queries, idx.eigvecs, idx.total_dim))
    xhat = idx.reconstruct(i_cod.reshape(-1)).reshape(8, 5, -1)
    ref = ((qp[:, None, :] - xhat) ** 2).sum(2)
    np.testing.assert_allclose(d_cod, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,c,l,n,br,nq,q_tile,sub_rows", [
    (8, 16, 4, 512, 64, 5, 16, 32),      # nq not a tile multiple
    (32, 256, 4, 2048, 256, 20, 32, 32),  # the headline geometry, scaled
    (16, 4, 3, 256, 16, 3, 16, 16),       # d = 48 → padded table columns
    (4, 64, 8, 1024, 512, 40, 64, 64),    # q tile larger than the batch
])
def test_triton_window_kernel_matches_xla(m, c, l, n, br, nq, q_tile,
                                          sub_rows):
    """The Triton kernel (interpret mode) computes the XLA scan's window
    minima: only the packed low mantissa bits and the f32 accumulation
    order differ, and the window's row differs only on such near-ties."""
    _, codes, qp, table, _ = _codes_index(7, m, c, l, n, nq)
    codes_t = jnp.asarray(codes.T.copy())
    s_x, i_x = scan_codes.window_scan_xla(codes_t, table, jnp.asarray(qp),
                                          br)
    s_t, i_t = scan_codes.window_scan_triton(
        codes_t, table, jnp.asarray(qp), br, q_tile=q_tile,
        sub_rows=sub_rows, num_warps=4, interpret=True)
    s_x, s_t = np.asarray(s_x), np.asarray(s_t)
    assert s_t.shape == s_x.shape == (nq, n // br)
    idx_bits = (br - 1).bit_length()
    # packing clears idx_bits of a 24-bit mantissa
    rtol = 2.0 ** (idx_bits - 23) + 1e-5
    np.testing.assert_allclose(s_t, s_x, rtol=rtol, atol=1e-4)
    assert np.mean(np.asarray(i_t) == np.asarray(i_x)) >= 0.95


def test_triton_decode_scan_topk_matches_xla(monkeypatch):
    """End to end through decode_scan_topk's Triton route (the kernel in
    interpret mode): both implementations return the same exact distances
    for the same neighbours."""
    import functools
    cents, codes, qp, table, rows = _codes_index(9, 16, 64, 4, 4000, 6)
    codes_t = jnp.asarray(codes.T.copy())
    d_x, i_x = scan_codes.decode_scan_topk(codes_t, table, rows,
                                           jnp.asarray(qp), 5,
                                           block_rows=32, impl="xla")
    monkeypatch.setattr(scan_codes, "window_scan_triton", functools.partial(
        scan_codes.window_scan_triton, q_tile=16, num_warps=4,
        interpret=True))
    d_t, i_t = scan_codes.decode_scan_topk(codes_t, table, rows,
                                           jnp.asarray(qp), 5,
                                           block_rows=32, impl="triton")
    np.testing.assert_array_equal(np.asarray(i_t), np.asarray(i_x))
    np.testing.assert_allclose(np.asarray(d_t), np.asarray(d_x), rtol=1e-6)


@pytest.mark.gpu
def test_compiled_window_kernel_on_card(gpu):
    """On the card: the compiled Triton kernel against the XLA scan at the
    headline geometry (M=32, C=256, d=128, 512-row windows)."""
    _, codes, qp, table, _ = _codes_index(11, 32, 256, 4, 1 << 16, 256)
    codes_t = jnp.asarray(codes.T.copy())
    s_x, i_x = scan_codes.window_scan_xla(codes_t, table, jnp.asarray(qp),
                                          512)
    s_t, i_t = scan_codes.window_scan_triton(codes_t, table,
                                             jnp.asarray(qp), 512)
    rtol = 2.0 ** (9 - 23) + 1e-5
    np.testing.assert_allclose(np.asarray(s_t), np.asarray(s_x), rtol=rtol,
                               atol=1e-3)
    assert np.mean(np.asarray(i_t) == np.asarray(i_x)) >= 0.99

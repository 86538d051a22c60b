"""The IVF probe's window rescore (``ops.probe.window_rescore``) against a
float64 NumPy reference: both row dtypes, both bucket layouts, duplicate
and boundary windows."""

import jax.numpy as jnp
import numpy as np
import pytest

from vaq_tpu.ops import probe


def _numpy_reference(q_eff, dim_w, rows, wblk, gs):
    """2·q·x̂ − ‖x̂‖² per row of each listed window, float64 on the bf16
    query and the stored row values."""
    d = q_eff.shape[1]
    qb = np.asarray(jnp.asarray(q_eff).astype(jnp.bfloat16), np.float64)
    r = np.asarray(jnp.asarray(rows).astype(jnp.float32), np.float64)
    blk = r.reshape(-1, gs, d)[np.asarray(wblk)]            # (nq, m, gs, d)
    inner = np.einsum("qd,qmgd->qmg", qb, blk)
    norms = np.einsum("qmgd,d->qmg", blk * blk,
                      np.asarray(dim_w, np.float64))
    return 2.0 * inner - norms


def _make(nq, m, gs, d, nblk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((nblk * gs, d)).astype(np.float32)
    if dtype == "int8":
        rows = jnp.asarray(np.clip(np.round(rows * 32.0), -127,
                                   127).astype(np.int8))
        dim_w = jnp.full((d,), 1.0 / (32.0 * 32.0), jnp.float32)
    else:
        rows = jnp.asarray(rows).astype(jnp.bfloat16)
        dim_w = jnp.ones((d,), jnp.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    wblk = rng.integers(0, nblk, size=(nq, m)).astype(np.int32)
    return jnp.asarray(q), dim_w, rows, jnp.asarray(wblk)


def _check(out, ref):
    o = np.asarray(out, np.float64)
    # bf16 products are exact in f32; only the accumulation order differs
    denom = np.maximum(np.abs(ref), 1.0)
    assert np.max(np.abs(o - ref) / denom) < 2e-5


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("nq,m,gs,d,nblk", [
    (16, 20, 16, 128, 64),     # a 1M-shaped probe (m = 2k windows)
    (8, 20, 64, 128, 32),      # larger windows
    (5, 6, 8, 128, 16),        # small windows, odd batch
    (32, 4, 256, 96, 8),       # the largest window size, d = 96
])
def test_gather_rescore_matches_xla(dtype, nq, m, gs, d, nblk):
    q, w, rows, wblk = _make(nq, m, gs, d, nblk, dtype)
    # one "cluster" per 2 windows: (ncl, cap, d) buckets
    buckets = rows.reshape(nblk // 2, 2 * gs, d)
    out = probe.window_rescore(q, w, buckets, wblk, gs)
    assert out.shape == (nq, m, gs)
    _check(out, _numpy_reference(q, w, rows, wblk, gs))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("nq,m,gs,d,nblk", [
    (8, 6, 64, 96, 20),        # transposed (d % 128 != 0) layout
    (5, 5, 16, 64, 12),        # small/unaligned everything
])
def test_gather_rescore_transposed_matches_xla(dtype, nq, m, gs, d, nblk):
    q, w, rows, wblk = _make(nq, m, gs, d, nblk, dtype, seed=11)
    ref = _numpy_reference(q, w, rows, wblk, gs)
    # one cluster holding every window, stored (ncl, d, cap)
    buckets_t = jnp.swapaxes(rows.reshape(1, nblk * gs, d), 1, 2)
    out = probe.window_rescore(q, w, buckets_t, wblk, gs, transposed=True)
    _check(out, ref)


def test_gather_rescore_duplicate_and_boundary_windows():
    """Duplicate window ids (several queries share a hot cluster) and ids at
    both ends of the window range gather correctly."""
    q, w, rows, _ = _make(9, 5, 16, 128, 10, "int8", seed=3)
    wblk = jnp.asarray(np.array([[0, 0, 9, 9, 0]] * 9, dtype=np.int32))
    out = probe.window_rescore(q, w, rows.reshape(5, 32, 128), wblk, 16)
    _check(out, _numpy_reference(q, w, rows, wblk, 16))
    np.testing.assert_array_equal(np.asarray(out[:, 0]),
                                  np.asarray(out[:, 1]))

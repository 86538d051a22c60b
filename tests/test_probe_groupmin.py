"""The IVF probe's group-min scan (``ops.probe.groupmin_window_scan``)
against a float64 NumPy reference: both row dtypes, both bucket layouts,
qcap below and above the step bounds, padding slots, and the window-size
rule."""

import jax.numpy as jnp
import numpy as np
import pytest

from vaq_tpu.ops import probe


def _reference_groupmin(qsl, rows, dim_w, gs):
    """dist = −2q·x̂ + ‖x̂‖² + ‖q‖² in float64 on the bf16-cast operands
    (qsl carries the −2), min over each gs-row group; and the bound on the
    f32 evaluation's error. bf16 products are exact in f32, so only the
    order of the f32 sums is free: an n-term f32 sum differs from the exact
    one by at most (n−1)·2⁻²⁴·Σ|terms|, and a min moves no further than its
    operands."""
    q = np.asarray(jnp.asarray(qsl).astype(jnp.float32), np.float64)
    r = np.asarray(jnp.asarray(rows).astype(jnp.bfloat16).astype(
        jnp.float32), np.float64)                            # (ncl, cap, d)
    w = np.asarray(dim_w, np.float64)
    d = r.shape[2]
    dot = np.einsum("cqd,crd->crq", q, r)
    xn = np.sum(r * r * w, axis=2)
    qn = 0.25 * np.sum(q * q, axis=2)
    dist = dot + xn[:, :, None] + qn[:, None, :]
    mag = (np.einsum("cqd,crd->crq", np.abs(q), np.abs(r))
           + xn[:, :, None] + qn[:, None, :])
    ncl, cap, qcap = dist.shape
    ref = dist.reshape(ncl, cap // gs, gs, qcap).min(axis=2)
    bound = (d + 2) * 2.0 ** -24 * mag.reshape(
        ncl, cap // gs, gs, qcap).max(axis=2)
    return ref, bound


def _make_inputs(ncl, cap, qcap, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((ncl, cap, d)).astype(np.float32)
    if dtype == "int8":
        rows = np.clip(np.round(rows * 32.0), -127, 127).astype(np.int8)
        # poison a few trailing slots per cluster, as build_ivf does
        rows[:, -3:] = probe.poison_pattern(d)[None, None, :]
        dim_w = jnp.full((d,), 1.0 / (32.0 * 32.0), jnp.float32)
        rows = jnp.asarray(rows)
    else:
        rows[:, -3:] = 1e15
        rows = jnp.asarray(rows).astype(jnp.bfloat16)
        dim_w = jnp.ones((d,), jnp.float32)
    q = rng.standard_normal((ncl, qcap, d)).astype(np.float32)
    qsl = jnp.asarray((-2.0 * q)).astype(jnp.bfloat16)
    return qsl, rows, dim_w


def _check_close(out, ref_and_bound):
    ref, bound = ref_and_bound
    o = np.asarray(out, dtype=np.float64)
    fin = ref < probe.SENTINEL_DIST
    # 2× the bound: the f32 store of the result rounds once more
    assert (np.abs(o[fin] - ref[fin]) <= 2.0 * bound[fin] + 1e-6).all()
    assert (o[~fin] >= probe.SENTINEL_DIST).all()


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("ncl,cap,gs,qcap", [
    (3, 512, 8, 128),      # one step holds every cluster
    (2, 1024, 16, 128),    # larger windows
    (2, 512, 8, 64),       # qcap < 128 (small strict batches)
    (1, 1536, 8, 128),     # a 1M-shaped bucket (scaled down)
])
def test_groupmin_matches_reference(dtype, ncl, cap, gs, qcap):
    qsl, rows, dim_w = _make_inputs(ncl, cap, qcap, 128, dtype)
    out = probe.groupmin_window_scan(qsl, rows, dim_w, gs=gs)
    assert out.shape == (ncl, cap // gs, qcap)
    assert out.dtype == jnp.float32
    _check_close(out, _reference_groupmin(qsl, rows, dim_w, gs))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("d", [96, 64])
def test_groupmin_transposed_matches_rowmajor(dtype, d):
    """The (ncl, d, cap) layout scores identically to the row-major one:
    same bf16 products, only the reduction order may differ."""
    ncl, cap, gs, qcap = 3, 1024, 16, 128
    qsl, rows, dim_w = _make_inputs(ncl, cap, qcap, d, dtype)
    out_std = probe.groupmin_window_scan(qsl, rows, dim_w, gs=gs)
    rows_t = jnp.swapaxes(rows, 1, 2)
    out_t = probe.groupmin_window_scan(qsl, rows_t, dim_w, gs=gs,
                                       transposed=True)
    o, r = (np.asarray(a, dtype=np.float32) for a in (out_t, out_std))
    fin = r < probe.SENTINEL_DIST
    denom = np.maximum(np.abs(r[fin]), 1.0)
    assert np.max(np.abs(o[fin] - r[fin]) / denom) < 2e-5
    _check_close(out_t, _reference_groupmin(qsl, rows, dim_w, gs))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_groupmin_padding_ranks_last(dtype):
    """Padding slots (bf16 sentinel / int8 poison) must rank at or above
    every live row: a window of pure padding never beats a live window."""
    ncl, cap, gs, qcap = 2, 512, 8, 128
    qsl, rows, dim_w = _make_inputs(ncl, cap, qcap, 128, dtype)
    pad_val = (probe.poison_pattern(128) if dtype == "int8"
               else np.full(128, 1e15, np.float32))
    rows = np.array(rows.astype(jnp.float32))
    rows[1, 64:64 + gs] = pad_val
    rows = jnp.asarray(rows).astype(jnp.int8 if dtype == "int8"
                                    else jnp.bfloat16)
    out = np.asarray(probe.groupmin_window_scan(qsl, rows, dim_w, gs=gs))
    pad_win = out[1, 64 // gs]        # (qcap,) all-padding window
    live_min = out[1].min(axis=0)     # best window per slot
    assert (pad_win >= live_min).all()
    if dtype == "bf16":
        assert (pad_win >= probe.SENTINEL_DIST).all()


def test_window_minima_must_stay_f32():
    """Window minima carry a large per-query constant (for int8 buckets qn
    is ‖q/s‖², scale-inflated to ~10⁴), so bf16's 8 mantissa bits would
    quantize away the O(1) gaps between windows and the top-m window
    selection would collapse. This reproduces that candidate-set loss, and
    pins that the scan emits f32."""
    rng = np.random.default_rng(7)
    ng, gs, k = 4096, 16, 10
    d = (1e4 + 50.0 * rng.gamma(2.0, 2.0, size=(ng * gs,))).astype(
        np.float32)
    true_top = np.argsort(d)[:k]
    true_windows = set(true_top // gs)
    mins_f32 = d.reshape(ng, gs).min(axis=1)
    m = 2 * k

    def window_recall(mins):
        top_w = set(np.argsort(mins, kind="stable")[:m].tolist())
        return len(true_windows & top_w) / len(true_windows)

    assert window_recall(mins_f32) == 1.0
    mins_bf16 = np.asarray(
        jnp.asarray(mins_f32).astype(jnp.bfloat16).astype(jnp.float32))
    assert window_recall(mins_bf16) < 0.8
    qsl, rows, dim_w = _make_inputs(2, 512, 128, 128, "int8")
    out = probe.groupmin_window_scan(qsl, rows, dim_w, gs=8)
    assert out.dtype == jnp.float32


def test_groupmin_step_size_invariance(monkeypatch):
    """Scoring the clusters one per step or all at once gives the same
    minima (the step only bounds the score block)."""
    qsl, rows, dim_w = _make_inputs(5, 512, 64, 128, "int8", seed=3)
    whole = np.asarray(probe.groupmin_window_scan(qsl, rows, dim_w, gs=16))
    monkeypatch.setattr(probe, "_GROUPMIN_STEP_BYTES", 1)
    probe.groupmin_window_scan.clear_cache()
    one = np.asarray(probe.groupmin_window_scan(qsl, rows, dim_w, gs=16))
    probe.groupmin_window_scan.clear_cache()
    np.testing.assert_array_equal(one, whole)


@pytest.mark.parametrize("cap", [512, 1536, 15360, 104960, 1 << 17])
def test_pick_gs_divides_cap_and_bounds_windows(cap):
    gs = probe.pick_gs(cap)
    assert cap % gs == 0 and 8 <= gs <= 256 and gs & (gs - 1) == 0
    # grow only while more than the target window count would remain
    assert gs == 8 or cap // (gs // 2) > 240
    assert gs == 256 or cap // gs <= 240


def test_pick_gs_grows_with_cap():
    caps = [512, 2048, 8192, 32768, 131072]
    sizes = [probe.pick_gs(c) for c in caps]
    assert sizes == sorted(sizes)
    assert sizes[0] == 8 and sizes[-1] == 256

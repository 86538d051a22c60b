"""Parity gates against the NumPy reference-pipeline oracle (oracle_ref.py).

Three tiers:
1. train parity — rotation columns (up to sign), truncation, and the exact
   bit allocation objective must agree between the engine and the oracle's
   independent branch-and-bound;
2. scan/encode exactness — with the *same* trained model injected, the
   oracle's encode + searchSort must reproduce the engine's codes+LUT scan;
3. e2e recall parity — full oracle pipeline vs full engine pipeline on the
   same fixture, Δ(avg recall) ≤ 0.5 % (BASELINE.json north-star gate).

Plus golden bit allocations for the paper configs
(ExperimentsParameters.txt:46-136) on pinned synthetic spectra.
"""

import numpy as np
import pytest

from vaq_tpu import bitalloc, metrics
from vaq_tpu.config import parse_method_string
from vaq_tpu.vaq import VAQIndex

from oracle_ref import OracleVAQ, allocate_bits_bnb


# ---------------------------------------------------------------------------
# 1. train parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(sift_like):
    base, queries, gt = sift_like
    cfg = parse_method_string("VAQ128m16min7max8var1,SORT")
    idx = VAQIndex(cfg).train(base).encode(base)
    orc = OracleVAQ(128, 16, 7, 8, var=1.0, seed=0).train(base)
    return idx, orc, base, queries, gt


def test_train_rotation_parity(pair):
    idx, orc, *_ = pair
    assert orc.highest_subs == idx.highest_subs
    assert orc.subs_len == idx.subs_len
    # eigencolumns agree up to sign (general solver vs eigh; same spectrum)
    ev_e = idx.eigvecs[:, : idx.total_dim]
    ev_o = orc.eigvecs[:, : orc.total_dim]
    dots = np.abs(np.sum(ev_e * ev_o, axis=0))  # |cos| per column
    assert (dots > 0.99).mean() > 0.95, dots.min()
    np.testing.assert_allclose(
        orc.var_per_subs, idx.var_per_subs, rtol=2e-3, atol=1e-6)


def test_bit_allocation_parity(pair):
    """The engine's DP and the oracle's branch-and-bound must reach the same
    optimum (identical objective; allocations may differ only at exact
    variance ties)."""
    idx, orc, *_ = pair
    obj_engine = float(np.sum(
        idx.var_per_subs[: idx.highest_subs] * idx.bits))
    assert obj_engine == pytest.approx(orc.ilp_objective, rel=1e-6)
    np.testing.assert_array_equal(idx.bits, orc.bits)


# ---------------------------------------------------------------------------
# 2. scan/encode exactness with an injected common model
# ---------------------------------------------------------------------------

def _inject(idx: VAQIndex) -> OracleVAQ:
    orc = OracleVAQ(idx.config.bit_budget, idx.config.subspace_num,
                    idx.config.min_bits, idx.config.max_bits)
    orc.subs_len = idx.subs_len
    orc.highest_subs = idx.highest_subs
    orc.total_dim = idx.total_dim
    orc.eigvecs = idx.eigvecs
    orc.bits = idx.bits
    orc.centroids = [idx.centroids[s, : int(idx.centroid_counts[s])]
                     for s in range(idx.highest_subs)]
    return orc


def test_encode_exactness_vs_oracle(pair):
    idx, _, base, *_ = pair
    orc = _inject(idx)
    orc.encode(base)
    agree = (orc.codes == idx.codes_rowmajor().astype(np.int64)).mean()
    # identical argmins modulo f32 summation-order ties
    assert agree > 0.995, agree


def test_scan_exactness_vs_oracle(pair):
    """searchSort (oracle) == the engine's codes+LUT scan on the same model:
    distances match to f32 tolerance, labels match modulo distance ties."""
    idx, _, base, queries, _ = pair
    orc = _inject(idx)
    orc.codes = idx.codes_rowmajor().astype(np.int64)
    k = 10
    d_o, l_o = orc.search(queries[:16], k)
    d_e, l_e = idx.search(queries[:16], k, backend="lut_gather")
    np.testing.assert_allclose(np.sqrt(d_e), d_o, rtol=2e-3, atol=1e-3)
    for q in range(16):
        same = set(l_o[q]) & set(l_e[q].tolist())
        assert len(same) >= k - 1, (q, l_o[q], l_e[q])


# ---------------------------------------------------------------------------
# 3. e2e recall parity
# ---------------------------------------------------------------------------

def test_e2e_recall_parity(pair):
    idx, orc, base, queries, gt = pair
    k = 10
    orc.encode(base)
    _, l_o = orc.search(queries, k)
    # lut_gather is the searchSort-equivalent path (exact f32 LUT scan);
    # the decoded backend's approx-top-k miss rate is gated separately in
    # test_scan_decoded.py.
    _, l_e = idx.search(queries, k, backend="lut_gather")
    r_o = metrics.avg_recall(l_o, gt, k)
    r_e = metrics.avg_recall(np.asarray(l_e), gt, k)
    # Δrecall ≤ 0.5 % between a faithful reference transliteration and the
    # engine, same data, same budget (BASELINE.json north star).
    # Measured: oracle {0.628, 0.617, 0.625} over seeds, engine 0.625.
    assert abs(r_o - r_e) <= 0.005 + 1e-9, (r_o, r_e)


# ---------------------------------------------------------------------------
# Golden allocations for the paper configs (pinned synthetic spectra)
# ---------------------------------------------------------------------------

def _spectrum(m, alpha, seed=0):
    """Power-law explained-variance spectrum, normalized (a SIFT-like decay;
    deterministic so the goldens below are stable)."""
    v = (np.arange(1, m + 1, dtype=np.float64)) ** (-alpha)
    return v / v.sum()


PAPER_CONFIGS = [
    # (name, budget, m, min, max, alpha) — ExperimentsParameters.txt lines
    ("sift1m_fig5", 256, 32, 2, 13, 1.0),   # :51-55
    ("fig6_ablation", 256, 32, 7, 10, 1.0),  # :77-81
    ("fastscan_fig7", 256, 64, 1, 8, 1.0),  # :84-91
    ("deep100m_fig11a", 256, 32, 5, 12, 0.7),  # :114-124
    ("sald100m_fig11b", 256, 32, 4, 15, 0.5),  # :126-136
]


@pytest.mark.parametrize("name,budget,m,lo,hi,alpha", PAPER_CONFIGS)
def test_paper_config_allocations_optimal(name, budget, m, lo, hi, alpha):
    """On each paper config's spectrum, the engine DP and the oracle B&B
    agree on the optimal objective, and the DP result satisfies every ILP
    constraint (budget equality, bounds, smoothness chain)."""
    var = _spectrum(m, alpha)
    cum = np.cumsum(var)
    bits = bitalloc.allocate_bits(var, budget, lo, hi, cum_var=cum,
                                  percent_var_explained=1.0)
    _, obj_bnb = allocate_bits_bnb(var, budget, lo, hi, cum_var=cum,
                                   percent_var=1.0)
    assert float(np.sum(var * bits)) == pytest.approx(obj_bnb, rel=1e-9)
    assert bits.sum() == budget
    assert bits.min() >= lo and bits.max() <= hi
    ks = bitalloc.smoothness_bounds(var)
    assert np.all(bits[:-1] - bits[1:] <= ks)


def test_golden_allocation_sift1m_fig5():
    """Pinned golden for the SIFT1M Fig.5 config (256b, m32, min2, max13) on
    the pinned power-law spectrum — any solver change that shifts the
    allocation (beyond re-tie-breaking with equal objective) fails here."""
    var = _spectrum(32, 1.0)
    bits = bitalloc.allocate_bits(var, 256, 2, 13, cum_var=np.cumsum(var),
                                  percent_var_explained=1.0)
    np.testing.assert_array_equal(bits, GOLDEN_SIFT1M_FIG5)


# computed once from the pinned spectrum; re-derive with
#   allocate_bits(_spectrum(32, 1.0), 256, 2, 13)
GOLDEN_SIFT1M_FIG5 = [13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13,
                      12, 11, 10, 9, 8, 7, 7, 6, 5, 4, 3, 2,
                      2, 2, 2, 2, 2, 2, 2, 2]

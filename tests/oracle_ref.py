"""NumPy transliteration of the reference VAQ pipeline — the parity oracle.

This module re-implements, as literally as NumPy allows, the reference's
train → encode → searchSort path (``bitvecengine/VAQ.cpp``):

* train: uncentered covariance ``XᵀX`` over ≤1000·d sampled rows
  (VAQ.cpp:16-59), the *general* eigensolver ``np.linalg.eig`` (the reference
  uses ``Eigen::EigenSolver``, VAQ.cpp:61 — not a symmetric solver), sort by
  (Re λ desc, Im λ desc) (VAQ.cpp:80-100), the partial variance-balancing
  swap loop with undo-and-break (VAQ.cpp:262-280), variance normalization +
  1e-12 clamp + subspace truncation (VAQ.cpp:301-336), the bit-allocation
  ILP solved by an independent bounded-variable branch-and-bound (the engine
  uses a DP in ``vaq_tpu.bitalloc`` — deliberately a different algorithm so
  the two cross-check), and per-subspace Lloyd k-means with random-subset
  init (arma::kmeans static_subset, 25 iters, VAQ.cpp:618-651). The
  reference's sampled-branch uninitialized-read bug (VAQ.cpp:538-544) is
  *not* reproduced: the oracle samples properly, as the engine does.
* encode: per-subspace exhaustive argmin (encodeImpl, VAQ.cpp:728-748).
* search: per-query LUT (CreateLUT, VAQ.hpp:127-180) + searchSort scan with
  the reference's sqrt (VAQ.cpp:1760-1776) + ascending top-k.

It is deliberately slow, loop-heavy, and engine-independent; tests use it to
pin Δrecall and exact scan/encode agreement.
"""

from __future__ import annotations

import math

import numpy as np


def next_pow2(x: float) -> int:
    """utils/Math.hpp:183-188."""
    if x == 0 or not math.isfinite(x):
        return 0
    return int(2.0 ** math.floor(math.log2(abs(x))))


# ---------------------------------------------------------------------------
# Independent exact ILP: branch-and-bound over x_0..x_{m-1}
# ---------------------------------------------------------------------------

def allocate_bits_bnb(var, budget, min_bits, max_bits, cum_var=None,
                      percent_var=1.0):
    """maximize Σ var_i·x_i  s.t.  Σx_i = budget, lb_i ≤ x_i ≤ ub,
    x_i − x_{i+1} ≤ nextPow2(var_i/var_{i+1})  (VAQ.cpp:345-456).

    Depth-first search with memoized upper bounds — an intentionally
    different algorithm from the engine's DP, returning (bits, objective).
    """
    var = np.asarray(var, dtype=np.float64)
    m = len(var)
    if cum_var is None:
        cum_var = np.cumsum(var)
    lbs = [int(min_bits) if cum_var[i] <= percent_var else 0 for i in range(m)]
    ub = int(max_bits)
    ks = []
    for i in range(m - 1):
        ratio = var[i] / var[i + 1] if var[i + 1] != 0 else math.inf
        k = next_pow2(ratio)
        if not math.isfinite(ratio) or k <= 0:
            k = 0
        ks.append(k)

    # memo[(i, prev_x, rem)] = best objective of the suffix, or None
    memo = {}

    def suffix_best(i, prev_x, rem):
        if i == m:
            return 0.0 if rem == 0 else None
        key = (i, prev_x, rem)
        if key in memo:
            return memo[key]
        lo = lbs[i]
        hi = ub
        if i > 0:
            lo = max(lo, prev_x - ks[i - 1])  # x_{i-1} − x_i ≤ k
        best = None
        for x in range(hi, lo - 1, -1):
            if x > rem:
                continue
            sub = suffix_best(i + 1, x, rem - x)
            if sub is None:
                continue
            val = var[i] * x + sub
            if best is None or val > best:
                best = val
        memo[key] = best
        return best

    total = suffix_best(0, 0, int(budget))
    if total is None:
        raise ValueError("oracle ILP infeasible")

    # reconstruct one optimal solution
    bits = []
    rem = int(budget)
    prev_x = 0
    for i in range(m):
        lo = lbs[i]
        if i > 0:
            lo = max(lo, prev_x - ks[i - 1])
        for x in range(ub, lo - 1, -1):
            if x > rem:
                continue
            sub = suffix_best(i + 1, x, rem - x)
            if sub is None:
                continue
            target = suffix_best(i, prev_x, rem)
            if math.isclose(var[i] * x + sub, target, rel_tol=1e-12,
                            abs_tol=1e-12):
                bits.append(x)
                rem -= x
                prev_x = x
                break
        else:
            raise RuntimeError("oracle backtrack failed")
    return np.asarray(bits, dtype=np.int64), total


# ---------------------------------------------------------------------------
# Lloyd k-means (arma::kmeans static_subset analog)
# ---------------------------------------------------------------------------

def kmeans_lloyd(x, k, iters=25, seed=0):
    """Plain Lloyd with random-subset init; empty clusters keep their old
    centroid (arma behaviour: dead means are left in place)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    cents = x[rng.permutation(n)[:k]].astype(np.float64).copy()
    for _ in range(iters):
        d2 = ((x[:, None, :] - cents[None, :, :]) ** 2).sum(2)
        assign = d2.argmin(1)
        for c in range(k):
            members = x[assign == c]
            if len(members):
                cents[c] = members.mean(0)
    return cents.astype(np.float32)


# ---------------------------------------------------------------------------
# The oracle pipeline
# ---------------------------------------------------------------------------

class OracleVAQ:
    """Reference-pipeline oracle with the same public stages as VAQIndex."""

    def __init__(self, bit_budget, m, min_bits, max_bits, var=1.0, seed=0):
        self.budget = bit_budget
        self.m = m
        self.min_bits = min_bits
        self.max_bits = max_bits
        self.percent_var = var
        self.seed = seed

    # -- train ----------------------------------------------------------
    def train(self, x):
        x = np.asarray(x, dtype=np.float32)
        n, d = x.shape
        assert d % self.m == 0, "pre-pad dims to a multiple of m"
        self.subs_len = L = d // self.m

        # sampled uncentered covariance (VAQ.cpp:16-59)
        samp = 1000 * d
        if samp < n:
            perm = np.random.default_rng(self.seed).permutation(n)[:samp]
            xs = x[perm]
        else:
            xs = x
        cov = (xs.astype(np.float64).T @ xs.astype(np.float64))

        # general eigensolver + (Re desc, Im desc) sort (VAQ.cpp:61-100)
        evals, evecs = np.linalg.eig(cov)
        order = sorted(range(d),
                       key=lambda i: (-evals[i].real, -evals[i].imag))
        evals = evals[order].real
        evecs = evecs[:, order].real

        # partial balancing swaps (VAQ.cpp:262-280)
        M = self.m
        vals = evals.copy()
        cols = evecs.copy()
        for i in range(1, min(L, M)):
            j = i * L + (L - 1)
            vals[[i, j]] = vals[[j, i]]
            per_subs = vals[: M * L].reshape(M, L).sum(1)
            if not all(per_subs[t] >= per_subs[t + 1] for t in range(M - 1)):
                vals[[i, j]] = vals[[j, i]]
                break
            cols[:, [i, j]] = cols[:, [j, i]]
        self.eigvals = vals.astype(np.float32)
        self.eigvecs = cols.astype(np.float32)

        # variance, clamp, truncation (VAQ.cpp:301-336)
        var_dim = vals / vals.sum()
        var_dim = np.where(var_dim < 1e-12, 1e-12, var_dim)
        self.var_per_subs = var_dim.reshape(M, L).sum(1)
        self.cum_var = np.cumsum(self.var_per_subs)
        if self.percent_var < 1.0:
            hi = 0
            for i in range(M):
                if self.cum_var[i] <= self.percent_var:
                    hi = i
            self.highest_subs = hi + 1
        else:
            self.highest_subs = M
        self.total_dim = self.highest_subs * L

        # ILP (VAQ.cpp:345-456)
        self.bits, self.ilp_objective = allocate_bits_bnb(
            self.var_per_subs[: self.highest_subs], self.budget,
            self.min_bits, self.max_bits,
            cum_var=self.cum_var[: self.highest_subs],
            percent_var=self.percent_var)

        # per-subspace codebooks (VAQ.cpp:526-661, sampling fixed)
        xp = x @ self.eigvecs[:, : self.total_dim]
        self.centroids = []
        for s in range(self.highest_subs):
            kcent = 1 << int(self.bits[s])
            samp = max(256 * kcent, 256 * (1 << (self.budget // self.m)))
            samp = min(samp, n)
            rows = np.random.default_rng(self.seed + s).permutation(n)[:samp]
            sub = xp[rows, s * L:(s + 1) * L]
            self.centroids.append(
                kmeans_lloyd(sub, kcent, iters=25, seed=self.seed + s))
        return self

    # -- encode ---------------------------------------------------------
    def encode(self, x):
        x = np.asarray(x, dtype=np.float32)
        xp = x @ self.eigvecs[:, : self.total_dim]
        L = self.subs_len
        n = x.shape[0]
        self.codes = np.zeros((n, self.highest_subs), dtype=np.int64)
        for s in range(self.highest_subs):
            sub = xp[:, s * L:(s + 1) * L]
            d2 = ((sub[:, None, :] - self.centroids[s][None, :, :]) ** 2).sum(2)
            self.codes[:, s] = d2.argmin(1)
        return self

    # -- search (searchSort) -------------------------------------------
    def search(self, queries, k):
        """Returns (dists (nq,k) — sqrt'ed like searchSort — and labels)."""
        q = np.asarray(queries, dtype=np.float32)
        qp = q @ self.eigvecs[:, : self.total_dim]
        L = self.subs_len
        nq = q.shape[0]
        n = self.codes.shape[0]
        out_d = np.zeros((nq, k), dtype=np.float32)
        out_i = np.zeros((nq, k), dtype=np.int64)
        for qi in range(nq):
            dist = np.zeros(n, dtype=np.float32)
            for s in range(self.highest_subs):
                lut = (((qp[qi, s * L:(s + 1) * L][None, :]
                         - self.centroids[s]) ** 2).sum(1)).astype(np.float32)
                dist += lut[self.codes[:, s]]
            dist = np.sqrt(dist)
            order = np.argsort(dist, kind="stable")[:k]
            out_d[qi] = dist[order]
            out_i[qi] = order
        return out_d, out_i

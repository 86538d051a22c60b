"""Binary/Hamming bit-vector engine — the BitVecEngine counterpart.

Re-designs the reference's ``bitvecengine/BitVecEngine.{hpp,cpp}`` +
``BitVector.hpp`` for an accelerator:

* **Representation** (B1): packed bits in uint32 lanes (the native int
  width) instead of ``vector<uint64_t>``; bit j of the budget lives in word
  j//32 at MSB-first offset, preserving the reference's MSB-first layout
  semantics (``encodeToBinary``, BitVecEngine.hpp:564-588).
* **Scalar quantizer** (B3): PCA (uncentered XᵀX, no balancing swap here —
  hpp:278-299) → per-*dimension* bit allocation by the same ILP family as
  VAQ but with ub 8, lb 1 while cumvar ≤ 0.99 · uniform-allocation variance,
  and the ratio cap k>10→0 (hpp:339-507; solved exactly by
  `vaq_tpu.bitalloc`, replacing the GLPK simplex + trunc/round-up) →
  matlab-style quantile bucket boundaries (hpp:509-561) → bucket index
  packed into the bitstring.
* **Hamming search** (B5): two backends mirroring the VAQ engine's split:
  - packed: XOR + ``lax.population_count`` + lane-sum (the
    ``hammingDist`` scan, DistanceFunctions.hpp:164-182);
  - matmul: codes unpacked once to an int8 0/1 matrix; then
    ``hamming(q,x) = pop(q) + pop(x) − 2·(q01 · x01ᵀ)`` runs as a matmul —
    the throughput path (same decoded-vs-packed trade as scan_decoded).
* **Rerank** (B7): binary top-(factor·k) then exact L2 (`refineAnswer`).
* **Cluster probing** (B6) reuses `vaq_tpu.ivf`-style probing; progressive
  sub-vector filtering (B10) is provided in its Sort variant.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vaq_tpu import bitalloc, io
from vaq_tpu.ops.distances import exact_search
from vaq_tpu.ops.scan_jax import refine_topk
from vaq_tpu.rng import DEFAULT_SEED

WORD = 32


# ---------------------------------------------------------------------------
# Bit packing (B1)
# ---------------------------------------------------------------------------

def pack_codes(buckets: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Pack per-dim bucket indices into uint32 words, MSB-first.

    buckets: (n, d) ints with buckets[:, j] < 2^bits[j]; bits: (d,).
    Returns (n, ceil(sum(bits)/32)) uint32.
    """
    bits = np.asarray(bits, dtype=np.int64)
    from vaq_tpu import native
    packed = native.pack_codes(buckets, bits)
    if packed is not None:
        return packed
    total = int(bits.sum())
    nwords = (total + WORD - 1) // WORD
    n = buckets.shape[0]
    out = np.zeros((n, nwords), dtype=np.uint64)  # u64 scratch avoids UB
    pos = np.concatenate([[0], np.cumsum(bits)])
    for j in range(buckets.shape[1]):
        b = int(bits[j])
        if b == 0:
            continue
        start = int(pos[j])
        val = buckets[:, j].astype(np.uint64)
        w0, w1 = start // WORD, (start + b - 1) // WORD
        if w0 == w1:
            shift = WORD - (start % WORD) - b
            out[:, w0] |= val << np.uint64(shift)
        else:  # straddles a word boundary (hpp:573-578)
            right = b - ((w0 + 1) * WORD - start)
            out[:, w0] |= val >> np.uint64(right)
            out[:, w1] |= (val & np.uint64((1 << right) - 1)) << np.uint64(
                WORD - right)
        out[:, w0] &= np.uint64(0xFFFFFFFF)
        if w1 < nwords:
            out[:, w1] &= np.uint64(0xFFFFFFFF)
    return out.astype(np.uint32)


def unpack_bits_01(packed: np.ndarray, total_bits: int) -> np.ndarray:
    """(n, W) uint32 → (n, total_bits) int8 0/1 matrix (MSB-first order)."""
    n, w = packed.shape
    shifts = np.arange(WORD - 1, -1, -1, dtype=np.uint32)
    bits = ((packed[:, :, None] >> shifts[None, None, :]) & 1).astype(np.int8)
    return bits.reshape(n, w * WORD)[:, :total_bits]


# ---------------------------------------------------------------------------
# Hamming scans (B5)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "exact", "block_rows"))
def hamming_topk_packed(
    db: jnp.ndarray,        # (n, W) uint32
    queries: jnp.ndarray,   # (nq, W) uint32
    k: int,
    exact: bool = True,
    block_rows: int = 65536,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """XOR + popcount + lane-sum + top-k (reference query_sort/query_heap,
    BitVecEngine.cpp:61-197 — all four method variants produce the same set;
    EA has no batched counterpart). Streamed in row blocks so the (nq, block, W)
    XOR intermediate stays bounded."""
    n, w = db.shape
    nq = queries.shape[0]
    block_rows = min(block_rows, n)
    pad = (-n) % block_rows
    db_p = jnp.pad(db, ((0, pad), (0, 0)))
    blocks = db_p.reshape(-1, block_rows, w)

    def body(carry, blk_and_idx):
        best_d, best_i = carry
        blk, bidx = blk_and_idx
        x = jnp.bitwise_xor(queries[:, None, :], blk[None, :, :])
        dist = jnp.sum(jax.lax.population_count(x), axis=2).astype(jnp.int32)
        ids = bidx * block_rows + jnp.arange(block_rows, dtype=jnp.int32)
        dist = jnp.where(ids[None, :] < n, dist, jnp.int32(2 ** 30))
        cd = jnp.concatenate([best_d, dist], axis=1)
        ci = jnp.concatenate(
            [best_i, jnp.broadcast_to(ids, (nq, block_rows))], axis=1)
        kk = min(k, cd.shape[1])
        if exact:
            neg, pos = jax.lax.top_k(-cd, kk)
        else:
            neg, pos = jax.lax.approx_max_k(-cd.astype(jnp.float32), kk,
                                            recall_target=0.99)
            neg = neg.astype(jnp.int32)
            pos = pos.astype(jnp.int32)
        return (-neg, jnp.take_along_axis(ci, pos, axis=1)), None

    init = (jnp.full((nq, k), 2 ** 30, dtype=jnp.int32),
            jnp.full((nq, k), -1, dtype=jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        body, init, (blocks, jnp.arange(blocks.shape[0], dtype=jnp.int32)))
    return best_d, best_i


@functools.partial(jax.jit, static_argnames=("k", "exact"))
def hamming_topk_matmul(
    db01: jnp.ndarray,       # (n, B) int8 0/1
    db_pop: jnp.ndarray,     # (n,) i32 popcounts
    q01: jnp.ndarray,        # (nq, B) int8 0/1
    k: int,
    exact: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """hamming = pop(q) + pop(x) − 2·(q01·x01ᵀ) — the matmul path."""
    inner = jnp.dot(q01.astype(jnp.bfloat16), db01.astype(jnp.bfloat16).T,
                    preferred_element_type=jnp.float32)
    q_pop = jnp.sum(q01.astype(jnp.int32), axis=1)
    dist = q_pop[:, None].astype(jnp.float32) + db_pop[None, :].astype(
        jnp.float32) - 2.0 * inner
    if exact:
        neg, idx = jax.lax.top_k(-dist, k)
    else:
        neg, idx = jax.lax.approx_max_k(-dist, k, recall_target=0.99)
    return (-neg).astype(jnp.int32), idx


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BinaryIndex:
    """Scalar-quantized binary index (binaryEncoding pipeline)."""

    bit_budget: int
    seed: int = DEFAULT_SEED

    eigvecs: Optional[np.ndarray] = None      # (d, d) f32
    bits: Optional[np.ndarray] = None         # (d,) per-dim bit allocation
    boundaries: Optional[np.ndarray] = None   # (256, d) quantile boundaries
    total_bits: int = 0
    orig_dim: int = 0

    packed: Optional[jnp.ndarray] = None      # (n, W) uint32
    n_rows: int = 0
    # matmul backend state
    db01: Optional[jnp.ndarray] = None        # (n, B) int8
    db_pop: Optional[jnp.ndarray] = None

    # ------------------------------------------------------------------
    def train_simple(self, x_train: np.ndarray) -> "BinaryIndex":
        """Sign-bit encoder (binaryEncodingSimple, BitVecEngine.hpp:190-274):
        PCA-project, 1 bit per leading dimension (sign), no bit allocation."""
        x_train = np.asarray(x_train, dtype=np.float32)
        self.orig_dim = d = x_train.shape[1]
        cov = x_train.T @ x_train
        evals, evecs = np.linalg.eigh(cov.astype(np.float64))
        order = np.argsort(-evals, kind="stable")
        self.eigvecs = evecs[:, order].astype(np.float32)
        nbits = min(self.bit_budget, d)
        self.bits = np.zeros(d, dtype=np.int64)
        self.bits[:nbits] = 1
        # boundary 0 per used dim → bucket = sign bit
        self.boundaries = np.full((256, d), np.finfo(np.float32).max,
                                  dtype=np.float32)
        self.boundaries[0, :nbits] = 0.0
        self.total_bits = nbits
        return self

    def train(self, x_train: np.ndarray, verbose: bool = False) -> "BinaryIndex":
        x_train = np.asarray(x_train, dtype=np.float32)
        self.orig_dim = d = x_train.shape[1]

        cov = x_train.T @ x_train
        evals, evecs = np.linalg.eigh(cov.astype(np.float64))
        order = np.argsort(-evals, kind="stable")
        evals, evecs = evals[order], evecs[:, order]
        self.eigvecs = evecs.astype(np.float32)

        var = evals / evals.sum()
        # clamp rule of hpp:333-337: tiny variances get an even tinier floor
        var = np.where(var < 1e-11, 1e-17, var)

        b = self.bit_budget
        cum = np.cumsum(var)
        uniform_var = cum[min(b, d) - 1]
        thresh = 0.99 * uniform_var
        lb = np.zeros(d, dtype=np.int64)
        lb[: min(b, d)] = (thresh >= cum[: min(b, d)]).astype(np.int64)
        # Per-dim ILP: same family as VAQ's but ub=8, lb as above, ratio cap
        # k>10→0 (hpp:404-420 analog at hpp:413-420).
        self.bits = bitalloc.allocate_bits_per_dim(var, b, lb)
        if verbose:
            nz = self.bits[self.bits > 0]
            print(f"== binary bit alloc: {len(nz)} dims used, "
                  f"max {nz.max() if len(nz) else 0} bits")

        xp = self._project(x_train)
        self.boundaries = _quantile_boundaries(xp, self.bits)
        self.total_bits = int(self.bits.sum())
        return self

    def _project(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32) @ self.eigvecs

    def _bucketize(self, xp: np.ndarray) -> np.ndarray:
        """bucket = first boundary ≥ value (encodeToBinary, hpp:564-588)."""
        d = xp.shape[1]
        buckets = np.zeros(xp.shape, dtype=np.int64)
        for j in range(d):
            bj = int(self.bits[j])
            if bj == 0:
                continue
            nb = (1 << bj) - 1
            buckets[:, j] = np.searchsorted(self.boundaries[:nb, j], xp[:, j],
                                            side="left")
        return buckets

    def encode(self, x: np.ndarray, verbose: bool = False) -> "BinaryIndex":
        xp = self._project(x)
        buckets = self._bucketize(xp)
        packed_np = pack_codes(buckets, self.bits)
        self.packed = jnp.asarray(packed_np)
        self.n_rows = x.shape[0]
        db01_np = unpack_bits_01(packed_np, self.total_bits)
        self.db01 = jnp.asarray(db01_np)
        self.db_pop = jnp.asarray(db01_np.sum(axis=1).astype(np.int32))
        return self

    def encode_queries(self, queries: np.ndarray) -> np.ndarray:
        qp = self._project(queries)
        return pack_codes(self._bucketize(qp), self.bits)

    # ------------------------------------------------------------------
    def query(self, queries: np.ndarray, k: int, backend: str = "auto",
              metric: str = "hamming") -> Tuple[np.ndarray, np.ndarray]:
        """Bit-space top-k (the reference's query(), BitVecEngine.cpp:509-519;
        Sort/Heap/EA variants collapse into one scan).

        metric: "hamming" (default) or "jaccard" (reference jaccardDist,
        DistanceFunctions.hpp:218 — packed backend only).
        """
        qpacked = self.encode_queries(queries)
        if metric == "jaccard":
            from vaq_tpu.ops.distances import jaccard_topk
            d, i = jaccard_topk(self.packed, jnp.asarray(qpacked), k)
            return np.asarray(d), np.asarray(i)
        if backend == "auto":
            backend = "matmul" if self.db01 is not None else "packed"
        if backend == "matmul":
            q01 = unpack_bits_01(qpacked, self.total_bits)
            d, i = hamming_topk_matmul(self.db01, self.db_pop,
                                       jnp.asarray(q01), k)
        else:
            d, i = hamming_topk_packed(self.packed, jnp.asarray(qpacked), k)
        return np.asarray(d), np.asarray(i)

    def query_rerank(self, queries: np.ndarray, x_original: np.ndarray,
                     k: int, factor: int = 10,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Binary top-(factor·k) then exact L2 rerank
        (queryRerank, BitVecEngine.cpp:521-535)."""
        kr = min(factor * k, self.n_rows)
        _, cand = self.query(queries, kr)
        x_original = np.asarray(x_original, dtype=np.float32)
        gathered = jnp.asarray(x_original[np.maximum(cand, 0)])
        d, i = refine_topk(jnp.asarray(np.asarray(queries, np.float32)),
                           gathered, jnp.asarray(cand.astype(np.int32)), k)
        return np.asarray(d), np.asarray(i)

    def query_naive(self, queries: np.ndarray, x_original: np.ndarray,
                    k: int, metric: str = "l2",
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan over originals (queryNaive, BitVecEngine.cpp:574-720) —
        doubles as the groundtruth generator. metric: "l2" (squared) or
        "manhattan" (reference manhattanDist, DistanceFunctions.hpp:254)."""
        q = jnp.asarray(np.asarray(queries, np.float32))
        x = jnp.asarray(np.asarray(x_original, np.float32))
        if metric == "manhattan":
            from vaq_tpu.ops.distances import manhattan_topk
            d, i = manhattan_topk(q, x, k)
        else:
            d, i = exact_search(q, x, k)
        return np.asarray(d), np.asarray(i)

    def query_filtering(self, queries: np.ndarray, k: int, n_subvectors: int,
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Progressive sub-vector filtering, Sort variant
        (queryFiltering_Sort, BitVecEngine.cpp:1145-1208).

        Reference semantics: accumulate Hamming distance one sub-vector at a
        time; after each round keep only the rows whose accumulated distance
        is still 0 (``pairs.resize(filterCounter)`` after the ascending sort
        keeps exactly the zero-distance rows); stop at the first round where
        ≤ k such rows remain (or after the last sub-vector) and answer with
        the top-k by the accumulated-so-far distance *among the rows that
        survived every earlier round*. The batched version evaluates all rounds'
        cumulative distances with static shapes, selects each query's
        stopping round, and masks rows whose cumulative distance was nonzero
        entering that round — identical answers, no data-dependent loop.
        """
        qpacked = jnp.asarray(self.encode_queries(queries))
        w = self.packed.shape[1]
        s = max(1, min(n_subvectors, w))
        sub_w = w // s

        @functools.partial(jax.jit, static_argnames=())
        def stages(db, qs):
            outs = []
            for j in range(s):
                lo = j * sub_w
                hi = (j + 1) * sub_w if j < s - 1 else w
                x = jnp.bitwise_xor(qs[:, None, lo:hi], db[None, :, lo:hi])
                outs.append(jnp.sum(jax.lax.population_count(x), axis=2))
            return jnp.cumsum(jnp.stack(outs), axis=0)  # (S, nq, n)

        cum = stages(self.packed, qpacked)
        counts = jnp.sum(cum == 0, axis=2)              # (S, nq)
        stop_ok = (counts <= k) | (jnp.arange(s)[:, None] == s - 1)
        stop = jnp.argmax(stop_ok, axis=0)              # first true (S, nq)→(nq,)
        sel = jnp.take_along_axis(
            cum, stop[None, :, None], axis=0)[0]        # (nq, n)
        # Only rows that survived every earlier round (cumulative distance 0
        # entering the stopping round) are candidates; round 0 admits all.
        prev = jnp.take_along_axis(
            cum, jnp.maximum(stop - 1, 0)[None, :, None], axis=0)[0]
        alive = (stop[:, None] == 0) | (prev == 0)
        sel = jnp.where(alive, sel.astype(jnp.int32), jnp.int32(2 ** 30))
        neg, idx = jax.lax.top_k(-sel, k)
        return np.asarray(-neg), np.asarray(idx)

    def query_filtering_heap(self, queries: np.ndarray, k: int,
                             n_subvectors: int,
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Progressive filtering, Heap variant (queryFiltering_Heap,
        BitVecEngine.cpp:1210-1259).

        The reference's lazy heap comparator materializes per-subvector
        Hamming distances on demand, which amounts to ranking rows
        **lexicographically** by their per-subvector distance vector
        (d_0, d_1, …) — a different order from the Sort variant's
        cumulative-distance answer. Batched split: the per-subvector
        distance stack is one batched XOR+popcount dispatch; the
        lexicographic top-k runs on host (``np.lexsort``), since a
        multi-word sort key has no matmul mapping and this path exists for
        behavior parity, not throughput (SURVEY B10 marks it CPU-idiom).

        Returns (sub_dists (nq, k, S) int32 — the reference's
        ``IdxSubDistPair.dist`` vectors — and ids (nq, k)).
        """
        qpacked = jnp.asarray(self.encode_queries(queries))
        w = self.packed.shape[1]
        s = max(1, min(n_subvectors, w))
        sub_w = w // s

        @jax.jit
        def stage_dists(db, qs):
            outs = []
            for j in range(s):
                lo = j * sub_w
                hi = (j + 1) * sub_w if j < s - 1 else w
                x = jnp.bitwise_xor(qs[:, None, lo:hi], db[None, :, lo:hi])
                outs.append(jnp.sum(jax.lax.population_count(x), axis=2))
            return jnp.stack(outs)                      # (S, nq, n)

        d = np.asarray(stage_dists(self.packed, qpacked))
        nq = d.shape[1]
        ids = np.empty((nq, k), np.int32)
        sub = np.empty((nq, k, s), np.int32)
        for qi in range(nq):                            # host lexicographic
            order = np.lexsort(d[::-1, qi, :])[:k]      # primary key last
            ids[qi] = order
            sub[qi] = d[:, qi, order].T
        return sub, ids

    # ------------------------------------------------------------------
    # CRUD (reference get/append/deleteBitV, BitVecEngine.cpp:1626-1636)
    # ------------------------------------------------------------------
    def get_bitv(self, ids) -> np.ndarray:
        """Packed bitvector rows."""
        return np.asarray(self.packed)[np.atleast_1d(ids)]

    def append(self, x_new: np.ndarray) -> np.ndarray:
        """Encode + append rows; returns new global ids."""
        packed_new = self.encode_queries(x_new)
        start = self.n_rows
        self.packed = jnp.concatenate([self.packed,
                                       jnp.asarray(packed_new)], axis=0)
        self.n_rows += packed_new.shape[0]
        new01 = unpack_bits_01(packed_new, self.total_bits)
        self.db01 = jnp.concatenate([self.db01, jnp.asarray(new01)], axis=0)
        self.db_pop = jnp.concatenate(
            [self.db_pop, jnp.asarray(new01.sum(1).astype(np.int32))])
        return np.arange(start, self.n_rows)

    def delete(self, ids) -> None:
        """Remove rows by id (compacting — ids above shift down, like the
        reference's vector erase)."""
        ids = np.atleast_1d(np.asarray(ids))
        keep = np.setdiff1d(np.arange(self.n_rows), ids)
        self.packed = jnp.asarray(np.asarray(self.packed)[keep])
        self.db01 = jnp.asarray(np.asarray(self.db01)[keep])
        self.db_pop = jnp.asarray(np.asarray(self.db_pop)[keep])
        self.n_rows = len(keep)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        arrays = {
            "eigvecs": self.eigvecs,
            "bits": self.bits,
            "boundaries": self.boundaries,
        }
        if self.packed is not None:
            arrays["packed"] = np.asarray(self.packed)
        meta = {"bit_budget": self.bit_budget, "seed": self.seed,
                "total_bits": self.total_bits, "orig_dim": self.orig_dim,
                "n_rows": self.n_rows}
        io.save_index_npz(path, arrays, meta)

    @classmethod
    def load(cls, path: str) -> "BinaryIndex":
        arrays, meta = io.load_index_npz(path)
        idx = cls(bit_budget=meta["bit_budget"], seed=meta["seed"])
        idx.eigvecs = arrays["eigvecs"]
        idx.bits = arrays["bits"]
        idx.boundaries = arrays["boundaries"]
        idx.total_bits = meta["total_bits"]
        idx.orig_dim = meta["orig_dim"]
        idx.n_rows = meta["n_rows"]
        if "packed" in arrays:
            packed_np = arrays["packed"]
            idx.packed = jnp.asarray(packed_np)
            db01_np = unpack_bits_01(packed_np, idx.total_bits)
            idx.db01 = jnp.asarray(db01_np)
            idx.db_pop = jnp.asarray(db01_np.sum(axis=1).astype(np.int32))
        return idx


def _quantile_boundaries(xp: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Matlab-style quantile boundaries per dim (hpp:509-561): for b bits,
    N = 2^b − 1 boundaries at p = (i+1)/(N+1); boundary N-1..255 padded with
    +max so searchsorted never exceeds 2^b − 1."""
    n, d = xp.shape
    q = np.full((256, d), np.finfo(np.float32).max, dtype=np.float32)
    for j in range(d):
        b = int(bits[j])
        if b == 0:
            continue
        nb = (1 << b) - 1
        z = np.sort(xp[:, j])
        for i in range(nb):
            p = (i + 1) / (nb + 1)
            poi = (1 - p) * (-0.5) + p * (n - 0.5)
            left = max(int(np.floor(poi)), 0)
            right = min(int(np.ceil(poi)), n - 1)
            q[i, j] = (1 - (poi - left)) * z[left] + (poi - left) * z[right]
    return q


# ---------------------------------------------------------------------------
# Scalar-quantized LUT index (B4 binaryEncodingLUT + B11 queryLUT)
# ---------------------------------------------------------------------------

class ScalarLUTIndex:
    """Per-dimension scalar quantizer with ADC LUT search.

    The reference's ``binaryEncodingLUT`` (BitVecEngine.hpp:594-935) +
    ``queryLUT`` (hpp:1222-1343): PCA, per-dim bit allocation (same program
    as :class:`BinaryIndex`), per-dim centroids = in-bucket means between
    matlab-style quantile boundaries (``centroidsQuantile``, hpp:811-840;
    empty buckets fall back to the boundary midpoint), u8 codes per kept
    dim, and ADC search over per-dim LUTs — which here is simply the VAQ
    machinery with L=1 subspaces, so encode/search/refine are delegated to
    a :class:`vaq_tpu.vaq.VAQIndex` built over the per-dim codebooks.
    """

    def __init__(self, bit_budget: int, seed: int = DEFAULT_SEED):
        self.bit_budget = bit_budget
        self.seed = seed
        self._vaq = None

    def train(self, x_train: np.ndarray, verbose: bool = False):
        from vaq_tpu.config import SearchMethod, VAQConfig
        from vaq_tpu.vaq import PAD_SENTINEL, VAQIndex

        x_train = np.asarray(x_train, dtype=np.float32)
        d = x_train.shape[1]

        cov = x_train.T @ x_train
        evals, evecs = np.linalg.eigh(cov.astype(np.float64))
        order = np.argsort(-evals, kind="stable")
        evals, evecs = evals[order], evecs[:, order]
        var = evals / evals.sum()
        var = np.where(var < 1e-11, 1e-17, var)

        b = self.bit_budget
        cum = np.cumsum(var)
        thresh = 0.99 * cum[min(b, d) - 1]
        lb = np.zeros(d, dtype=np.int64)
        lb[: min(b, d)] = (thresh >= cum[: min(b, d)]).astype(np.int64)
        bits = bitalloc.allocate_bits_per_dim(var, b, lb)

        # kept dims = leading run of non-zero allocations (hpp:843-849)
        kept = 0
        while kept < d and bits[kept] > 0:
            kept += 1
        kept = max(kept, 1)

        xp = x_train @ evecs.astype(np.float32)
        cmax = 256
        centroids = np.full((kept, cmax, 1), PAD_SENTINEL, dtype=np.float32)
        for j in range(kept):
            nb = 1 << int(bits[j])
            z = np.sort(xp[:, j])
            # quantile boundaries incl. extremes (hpp:812-824)
            qs = np.empty(nb + 1, dtype=np.float64)
            qs[0], qs[-1] = z[0], z[-1]
            n = len(z)
            for i in range(nb - 1):
                p = (i + 1) / nb
                poi = (1 - p) * (-0.5) + p * (n - 0.5)
                left = max(int(np.floor(poi)), 0)
                right = min(int(np.ceil(poi)), n - 1)
                qs[i + 1] = (1 - (poi - left)) * z[left] + (poi - left) * z[right]
            # in-bucket means; empty bucket → boundary midpoint
            hi = np.searchsorted(z, qs[1:], side="right")
            lo = np.concatenate([[0], hi[:-1]])
            for i in range(nb):
                if hi[i] > lo[i]:
                    centroids[j, i, 0] = z[lo[i]:hi[i]].mean()
                else:
                    centroids[j, i, 0] = (qs[i] + qs[i + 1]) / 2.0

        cfg = VAQConfig(bit_budget=int(bits[:kept].sum()), subspace_num=d,
                        min_bits=0, max_bits=8,
                        methods=SearchMethod.SORT, seed=self.seed)
        vaq = VAQIndex(cfg)
        vaq.eigvecs = evecs.astype(np.float32)
        vaq.eigvals = evals.astype(np.float32)
        vaq.var_per_subs = var.astype(np.float32)
        vaq.cum_var_per_subs = cum
        vaq.subs_len = 1
        vaq.highest_subs = kept
        vaq.orig_dim = d
        vaq.bits = bits[:kept]
        vaq.centroid_counts = (1 << bits[:kept]).astype(np.int64)
        vaq.centroids = centroids
        self._vaq = vaq
        if verbose:
            print(f"== scalar LUT: {kept}/{d} dims kept, "
                  f"bits sum={bits[:kept].sum()}")
        return self

    def encode(self, x: np.ndarray, verbose: bool = False):
        self._vaq.encode(x, verbose=verbose)
        return self

    def query(self, queries: np.ndarray, k: int, **kw):
        return self._vaq.search(queries, k, **kw)

    def query_refine(self, queries: np.ndarray, x_original: np.ndarray,
                     k: int, factor: int = 10):
        """queryLUT's built-in exact refine (refineAnswer, hpp:1345-1387)."""
        _, cand = self._vaq.search(queries, min(factor * k, self._vaq.n_rows))
        return self._vaq.refine(queries, cand, x_original, k)

    def save(self, path: str) -> None:
        self._vaq.save(path)

    @classmethod
    def load(cls, path: str) -> "ScalarLUTIndex":
        from vaq_tpu.vaq import VAQIndex
        obj = cls(bit_budget=0)
        obj._vaq = VAQIndex.load(path)
        obj.bit_budget = obj._vaq.config.bit_budget
        return obj


# ---------------------------------------------------------------------------
# Disk-resident streaming scan (B9)
# ---------------------------------------------------------------------------

def query_naive_streaming(path: str, dim: int, queries: np.ndarray, k: int,
                          batch_rows: int = 262144,
                          dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Exact L2 top-k over a dataset streamed from disk in row chunks.

    The reference's disk-resident scan (queryNaiveParallelDiskResident,
    BitVecEngine.cpp:1441-1624): fread `batch` rows, per-chunk top-k with
    ids offset by the chunk base (cpp:1488), merge into the global answers
    (cpp:1599-1611). Here each chunk is one device batch; the merge is a
    top-k over the concatenated candidates. Works for datasets larger than
    HBM (or host RAM, via memmap).
    """
    import jax
    import jax.numpy as jnp

    from vaq_tpu.ops.distances import exact_search

    queries = np.asarray(queries, dtype=np.float32)
    nq = queries.shape[0]
    q_dev = jnp.asarray(queries)
    mm = np.memmap(path, dtype=dtype, mode="r")
    n = mm.shape[0] // dim
    best_d = np.full((nq, k), np.inf, dtype=np.float32)
    best_i = np.full((nq, k), -1, dtype=np.int32)
    for start in range(0, n, batch_rows):
        rows = np.asarray(mm[start * dim:(start + min(batch_rows, n - start))
                             * dim], dtype=np.float32).reshape(-1, dim)
        kk = min(k, rows.shape[0])
        d, i = exact_search(q_dev, jnp.asarray(rows), kk)
        d, i = np.asarray(d), (np.asarray(i) + start).astype(np.int32)
        from vaq_tpu import native
        if not native.merge_topk(best_d, best_i, d, i):
            cd = np.concatenate([best_d, d], axis=1)
            ci = np.concatenate([best_i, i], axis=1)
            order = np.argsort(cd, axis=1, kind="stable")[:, :k]
            best_d = np.take_along_axis(cd, order, axis=1)
            best_i = np.take_along_axis(ci, order, axis=1)
    return best_d, best_i


# ---------------------------------------------------------------------------
# Cluster-pruned Hamming queries (B6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HammingClusterState:
    """Bucketed packed bitvectors grouped by (L2) cluster of the originals."""

    centroids: np.ndarray      # (ncl, d) f32 cluster centroids
    cap: int
    bucket_words: jnp.ndarray  # (ncl, cap, W) uint32
    bucket_ids: jnp.ndarray    # (ncl, cap) i32, -1 padding
    sizes: jnp.ndarray         # (ncl,) i32 member counts


def build_hamming_clusters(index: BinaryIndex, x_original: np.ndarray,
                           n_clusters: int, iters: int = 25,
                           seed: int = DEFAULT_SEED) -> HammingClusterState:
    """k-means over the original vectors; bitvectors grouped into padded
    buckets (the loadCentroids/loadClusterInfo + queryWithClusterInfo build,
    BitVecEngine.cpp:204-449)."""
    from vaq_tpu import kmeans

    x_original = np.asarray(x_original, dtype=np.float32)
    cents, assign = kmeans.fit(x_original, n_clusters, iters=iters, seed=seed)
    packed = np.asarray(index.packed)
    sizes = np.bincount(assign, minlength=n_clusters)
    cap = int(sizes.max())
    w = packed.shape[1]
    words = np.zeros((n_clusters, cap, w), dtype=np.uint32)
    ids = np.full((n_clusters, cap), -1, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    start = 0
    for c in range(n_clusters):
        members = order[start:start + sizes[c]]
        start += sizes[c]
        words[c, : len(members)] = packed[members]
        ids[c, : len(members)] = members

    return HammingClusterState(centroids=cents, cap=cap,
                               bucket_words=jnp.asarray(words),
                               bucket_ids=jnp.asarray(ids),
                               sizes=jnp.asarray(sizes.astype(np.int32)))


@functools.partial(jax.jit, static_argnames=(
    "k", "p_visit", "p_max", "qcap", "cb"))
def _hamming_probe_scan(qp_f32, qwords, bucket_words, bucket_ids, centroids,
                        sizes, k, p_visit, p_max, qcap, cb=8):
    """One fused dispatch mirroring ivf.probe_scan for Hamming buckets:
    probe by L2 over originals → MoE dispatch → blocked XOR+popcount scoring
    → per-cluster top-k → per-query merge."""
    from vaq_tpu.ops import probe as probe_ops

    nq = qp_f32.shape[0]
    ncl, cap, w = bucket_words.shape

    cd = probe_ops.cluster_sq_dists(qp_f32, jnp.asarray(centroids))
    probe, active = probe_ops.dynamic_probe(cd, sizes, k, p_visit, p_max)
    table, ok, ent_c, ent_r = probe_ops.dispatch_table(probe, active, ncl,
                                                       qcap)
    qw_pad = jnp.concatenate(
        [qwords, jnp.zeros((1, w), qwords.dtype)], axis=0)
    qsl = qw_pad[table]                                    # (ncl, qcap, W)

    padc = (-ncl) % cb
    words_p = jnp.pad(bucket_words, ((0, padc), (0, 0), (0, 0)))
    ids_p = jnp.pad(bucket_ids, ((0, padc), (0, 0)), constant_values=-1)
    qsl_p = jnp.pad(qsl, ((0, padc), (0, 0), (0, 0)))
    nb = (ncl + padc) // cb
    kk = min(k, cap)

    def score_fn(b):
        words_b = jax.lax.dynamic_slice_in_dim(words_p, b * cb, cb, 0)
        ids_b = jax.lax.dynamic_slice_in_dim(ids_p, b * cb, cb, 0)
        q_b = jax.lax.dynamic_slice_in_dim(qsl_p, b * cb, cb, 0)
        x = jnp.bitwise_xor(q_b[:, :, None, :], words_b[:, None, :, :])
        dist = jnp.sum(jax.lax.population_count(x), axis=3).astype(jnp.int32)
        # negative distance = descending-is-better score; padding → -inf
        return jnp.where(ids_b[:, None, :] >= 0, -dist.astype(jnp.float32),
                         -jnp.inf)

    vals, pos = probe_ops.blocked_cluster_topk(score_fn, nb, kk)
    vals, pos = vals[:ncl], pos[:ncl]
    # resolve ids cluster-major with a per-row gather — no (ncl, qcap, cap)
    # broadcast materialization (1.3 GB at 1M rows)
    ids_k = jnp.take_along_axis(bucket_ids, pos.reshape(ncl, qcap * kk),
                                axis=1).reshape(ncl, qcap, kk)
    top_s, top_i = probe_ops.gather_merge_topk(vals, ids_k, ok, ent_c, ent_r,
                                               nq, k)
    dist = jnp.where(jnp.isfinite(top_s), -top_s, jnp.float32(2 ** 30))
    return dist.astype(jnp.int32), top_i


def query_hamming_clusters(index: BinaryIndex, state: HammingClusterState,
                           queries: np.ndarray, k: int,
                           n_probe: int) -> Tuple[np.ndarray, np.ndarray]:
    """Visit each query's nearest clusters — at least ``n_probe``, and at
    least until ≥ k members have been seen (the reference's dynamic rule,
    queryWithClusterInfo BitVecEngine.cpp:204-449/537-551) — and
    Hamming-scan only their buckets, in ONE batched device dispatch
    (a batched redesign of the reference's per-query loop)."""
    from vaq_tpu.ops import probe as probe_ops

    queries = np.asarray(queries, dtype=np.float32)
    nq = queries.shape[0]
    qwords = jnp.asarray(index.encode_queries(queries))
    ncl = state.centroids.shape[0]
    p_visit = max(1, min(int(n_probe), ncl))
    cum = np.cumsum(np.sort(np.asarray(state.sizes)))
    p_floor = int(np.searchsorted(cum, k) + 1)
    p_max = min(ncl, max(p_visit, p_floor))
    qcap = nq if nq <= 256 else probe_ops.pick_qcap(nq, p_max, ncl)
    cb = min(ncl, max(1, (1 << 23) // max(qcap * state.cap, 1)))
    d, i = _hamming_probe_scan(
        jnp.asarray(queries), qwords, state.bucket_words, state.bucket_ids,
        state.centroids, state.sizes, k, p_visit, p_max, qcap, cb=cb)
    return np.asarray(d), np.asarray(i)

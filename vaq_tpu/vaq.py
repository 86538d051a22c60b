"""The VAQ index: train → encode → search → refine, on an accelerator.

This is the counterpart of the reference's ``VAQ`` class
(``bitvecengine/VAQ.{hpp,cpp}``), re-architected for XLA:

* arrays, not objects: the trained index is a handful of numpy/JAX arrays
  (rotation, padded codebooks, codes) with static shapes;
* batches, not per-query loops: ``search`` processes a whole query batch in
  one jitted program (project → LUT einsum → blocked scan + top-k), where the
  reference loops queries and rows (VAQ.cpp:786-846);
* ragged subspaces (different 2^bits_i per subspace) are padded to 2^max_bits
  with large sentinel centroids so argmin/LUT never select them — the
  static-shape answer to the reference's per-subspace matrices.

Stage mapping (reference file:line):
  train               VAQ::train          VAQ.cpp:11-661
  encode              VAQ::encode         VAQ.cpp:663-748
  learn_quantization  VAQ::learnQuantization VAQ.cpp:1118-1187
  search              VAQ::search         VAQ.cpp:776-847
  refine              VAQ::refine         VAQ.cpp:849-876
  cluster_ti          VAQ::clusterTI      VAQ.cpp:878-999 (see vaq_tpu.ivf)
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vaq_tpu import bitalloc, io, kmeans, pca
from vaq_tpu.config import SearchMethod, VAQConfig
from vaq_tpu.errors import ConfigError, NotReadyError, ShapeError
from vaq_tpu.ops import platform, scan_codes, scan_decoded, scan_jax
from vaq_tpu.rng import sample_rows

# Sentinel for padded codebook rows: large enough to never win an argmin,
# small enough that its square stays finite in f32.
PAD_SENTINEL = 1e18


@functools.partial(jax.jit, static_argnames=("block_rows",))
def _encode_blocked(xp: jnp.ndarray, centroids: jnp.ndarray,
                    block_rows: int = 8192) -> jnp.ndarray:
    """Nearest-centroid codes for all rows, per subspace (V8).

    xp: (n, M*L) projected rows; centroids: (M, C, L) padded.
    Returns (n, M) int32 codes. The reference's triple loop with OpenMP
    (encodeImpl, VAQ.cpp:728-748) becomes a blocked einsum + argmin.
    """
    n = xp.shape[0]
    m, c, l = centroids.shape
    pad = (-n) % block_rows
    xpp = jnp.pad(xp, ((0, pad), (0, 0)))
    blocks = xpp.reshape(-1, block_rows, m, l)
    c2 = jnp.sum(centroids * centroids, axis=2)  # (M, C); sentinel rows ~1e36

    def enc(blk):
        # (nb, M, C) = ‖x‖² − 2x·c + ‖c‖²; ‖x‖² constant in argmin, dropped.
        xc = jnp.einsum("nml,mcl->nmc", blk, centroids,
                        preferred_element_type=jnp.float32)
        return jnp.argmin(c2[None] - 2.0 * xc, axis=2).astype(jnp.int32)

    codes = jax.lax.map(enc, blocks)
    return codes.reshape(-1, m)[:n]


@jax.jit
def _learn_quantization_device(luts, valid, counts, alphas):
    """α-grid LUT-quantization search, fully on device (V16).

    luts (S, M, C) f32 sampled LUTs; valid (M, C) padded-entry mask;
    counts (M,) live centroids per subspace; alphas (A,).
    Returns (offsets (A, M), scales (A, M), losses (A,)). Quantiles use
    numpy's linear interpolation on one per-subspace sort; losses are
    accumulated in S-blocks so transients stay O(block)·A.
    """
    s_n, m, c = luts.shape
    flat = jnp.where(valid[None], luts, jnp.inf)
    srt = jnp.sort(flat.transpose(1, 0, 2).reshape(m, s_n * c), axis=1)
    nval = (counts * s_n).astype(jnp.float32)              # (M,)

    def gather(idx):                                       # idx (A, M) i32
        return jnp.take_along_axis(srt, idx.T, axis=1).T   # (A, M)

    def interp(pos):
        lo = jnp.floor(pos).astype(jnp.int32)
        hi = jnp.minimum(lo + 1, (nval[None, :] - 1).astype(jnp.int32))
        w = pos - lo
        return gather(lo), gather(hi), w

    pos_o = alphas[:, None] * (nval[None, :] - 1.0)
    vlo, vhi, w = interp(pos_o)
    off = vlo * (1.0 - w) + vhi * w                        # (A, M)
    # ceil = quantile(max(col − off, 0), 1−α): max(·−off, 0) is monotone,
    # so the transformed quantile reads from the SAME sorted array
    pos_c = (1.0 - alphas)[:, None] * (nval[None, :] - 1.0)
    vlo, vhi, w = interp(pos_c)
    ceil = (jnp.maximum(vlo - off, 0.0) * (1.0 - w)
            + jnp.maximum(vhi - off, 0.0) * w)
    scales = 255.0 / jnp.maximum(ceil, 1e-30)

    blk = 1024
    pad = (-s_n) % blk
    luts_p = jnp.pad(jnp.where(valid[None], luts, 0.0),
                     ((0, pad), (0, 0), (0, 0)))           # zero rows: 0 err
    blocks = luts_p.reshape(-1, blk, m, c)

    def body(carry, lm):                                   # lm (B, M, C)
        off_l = jnp.maximum(lm[None] - off[:, None, :, None], 0.0)
        scaled = off_l * scales[:, None, :, None]
        q8 = jnp.minimum(jnp.floor(scaled), 255.0)
        err = (scaled - q8) * valid[None, None]
        return carry + jnp.sum(err * err, axis=(1, 2, 3)), 0

    losses, _ = jax.lax.scan(body, jnp.zeros_like(alphas), blocks)
    return off, scales, losses


@dataclasses.dataclass
class VAQIndex:
    """A trained (or in-training) VAQ index."""

    config: VAQConfig

    # Rotation / truncation state (train).
    eigvecs: Optional[np.ndarray] = None        # (d, d) f32
    eigvals: Optional[np.ndarray] = None        # (d,) f32
    var_per_subs: Optional[np.ndarray] = None   # (M,) f32
    cum_var_per_subs: Optional[np.ndarray] = None
    subs_len: int = 0                           # L
    highest_subs: int = 0                       # M' = kept subspaces
    orig_dim: int = 0                           # pre-padding feature dim

    # Quantizer state.
    bits: Optional[np.ndarray] = None           # (M,) int
    centroids: Optional[np.ndarray] = None      # (M', Cmax, L) f32, padded
    centroid_counts: Optional[np.ndarray] = None  # (M',) = 2^bits_i

    # Encoded database — TRANSPOSED device storage (M', n), one byte per
    # code for <= 8-bit configs. Host-facing APIs (save/get_codes/oracles)
    # stay row-major via codes_rowmajor().
    codes: Optional[jnp.ndarray] = None         # (M', n) int on device
    n_rows: int = 0

    # Decoded-scan backend state (bf16 reconstruction + exact f32 norms);
    # derived from codes, rebuilt lazily after load. See ops/scan_decoded.py.
    decoded: Optional[jnp.ndarray] = None       # (n, M'*L) bf16
    decoded_norms: Optional[jnp.ndarray] = None  # (n,) f32
    # Int8 capacity tier (half the device bytes of bf16). Also transposed.
    decoded8: Optional[jnp.ndarray] = None      # (M'*L, n) int8
    decoded8_scales: Optional[jnp.ndarray] = None  # (M'*L,) f32
    decoded8_norms: Optional[jnp.ndarray] = None   # (n,) f32

    # LUT u8 quantization (V16).
    lut_offsets: Optional[np.ndarray] = None    # (M',) f32
    lut_scales: Optional[np.ndarray] = None     # (M',) f32

    # Cluster-probe (TI analog) state, managed by vaq_tpu.ivf.
    ivf: Optional[object] = None

    # Tombstoned row ids (see delete()).
    deleted_ids: Optional[np.ndarray] = None

    # Device-side caches (not persisted).
    _ev_dev: Optional[jnp.ndarray] = None
    _deleted_dev: Optional[jnp.ndarray] = None

    # Multi-device serving state (set by .shard()).
    _mesh: Optional[object] = None
    _q_axis: Optional[str] = None
    _sharded_decoded: Optional[jnp.ndarray] = None
    _sharded_norms: Optional[jnp.ndarray] = None
    _sharded_decoded8: Optional[jnp.ndarray] = None       # (D, n_pad) int8
    _sharded_d8_norms: Optional[jnp.ndarray] = None
    _sharded_codes: Optional[jnp.ndarray] = None          # (M, n_pad) u8
    _sharded_ivf: Optional[object] = None                 # ivf.ShardedIVF

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------
    @property
    def total_dim(self) -> int:
        """Dims actually used for ADC = M' · L (VAQ.cpp:336)."""
        return self.highest_subs * self.subs_len

    @property
    def padded_dim(self) -> int:
        return self.config.subspace_num * self.subs_len

    @property
    def max_centroids(self) -> int:
        return 1 << self.config.max_bits

    # ------------------------------------------------------------------
    # Train
    # ------------------------------------------------------------------
    def train(self, x_train: np.ndarray, verbose: bool = False) -> "VAQIndex":
        """PCA rotation + variance balancing + bit allocation + codebooks."""
        cfg = self.config
        x_train = np.asarray(x_train, dtype=np.float32)
        self.orig_dim = x_train.shape[1]
        x_train = io.pad_dims(x_train, cfg.subspace_num)

        t0 = time.perf_counter()
        rot = pca.train_rotation(
            x_train, cfg.subspace_num, cfg.percent_var_explained, cfg.seed
        )
        self.eigvecs = rot.eigvecs
        self.eigvals = rot.eigvals
        self.var_per_subs = rot.var_per_subs
        self.cum_var_per_subs = rot.cum_var_per_subs
        self.subs_len = rot.subs_len
        self.highest_subs = rot.highest_subs
        if verbose:
            print(f"== PCA+rotation: {time.perf_counter() - t0:.3f}s "
                  f"(kept {self.highest_subs}/{cfg.subspace_num} subspaces)")

        # Bit allocation (V5) — exact ILP over the kept subspaces.
        t0 = time.perf_counter()
        if cfg.hardcoded_bits is not None:
            bits = np.zeros(self.highest_subs, dtype=np.int64)
            hc = np.asarray(cfg.hardcoded_bits[: self.highest_subs])
            bits[: hc.shape[0]] = hc
            bits = bitalloc.fixup_under_budget(bits, cfg.bit_budget, cfg.max_bits)
        else:
            bits = bitalloc.allocate_bits(
                self.var_per_subs[: self.highest_subs],
                cfg.bit_budget,
                cfg.min_bits,
                cfg.max_bits,
                cum_var=self.cum_var_per_subs[: self.highest_subs],
                percent_var_explained=cfg.percent_var_explained,
            )
        self.bits = bits
        self.centroid_counts = (1 << bits).astype(np.int64)
        if verbose:
            print(f"== bit allocation: {list(bits)} "
                  f"(sum={bits.sum()}, {time.perf_counter() - t0:.3f}s)")

        # Per-subspace codebooks (V6/V7). Only *sampled* rows ever reach the
        # device (≤ 256·2^bits per subspace — the full projection is never
        # materialized, so build memory is O(sample), not O(n)). Subspaces
        # with identical (centroid count, sample size) — the common
        # uniform-bits case — train as ONE vmapped device program.
        t0 = time.perf_counter()
        m, l = self.highest_subs, self.subs_len
        cmax = self.max_centroids
        centroids = np.full((m, cmax, l), PAD_SENTINEL, dtype=np.float32)
        standard_bits = 8
        n_train = x_train.shape[0]
        ev_dev = jnp.asarray(self.eigvecs[:, : self.total_dim])

        def samp_of(s):
            k = int(self.centroid_counts[s])
            samp = max(k * 256,
                       256 * (1 << (cfg.bit_budget // cfg.subspace_num)))
            return min(samp, n_train)

        def project_sample(s, samp):
            """Project only subspace s's sampled raw rows (host gather →
            device matmul against the L relevant rotation columns)."""
            perm = np.random.default_rng(cfg.seed + s).permutation(
                n_train)[:samp]
            rows = jnp.asarray(x_train[perm])
            return jnp.dot(rows, ev_dev[:, s * l:(s + 1) * l],
                           preferred_element_type=jnp.float32)

        groups: dict = {}
        special = []
        for s in range(m):
            if (cfg.hierarchical_kmeans or cfg.binary_kmeans) and \
                    bits[s] > standard_bits:
                special.append(s)
            else:
                key = (int(self.centroid_counts[s]), samp_of(s))
                groups.setdefault(key, []).append(s)

        for (k, samp), subs in groups.items():
            # device budget: (G, samp, k) distance matrices live at once
            if len(subs) * samp * k > (1 << 29):
                special.extend(subs)
                continue
            xs = jnp.stack([project_sample(s, samp) for s in subs])
            cents = kmeans.fit_many(xs, k, iters=cfg.kmeans_iters,
                                    seed=cfg.seed)
            for gi, s in enumerate(subs):
                centroids[s, :k] = cents[gi]

        for s in special:
            k = int(self.centroid_counts[s])
            sub_s = np.asarray(project_sample(s, samp_of(s)))
            if cfg.hierarchical_kmeans and bits[s] > standard_bits:
                c = kmeans.hierarchical_fit(sub_s, int(bits[s]),
                                            iters=cfg.kmeans_iters,
                                            seed=cfg.seed + s)
            elif cfg.binary_kmeans and bits[s] > standard_bits:
                c = kmeans.binary_split_fit(sub_s, int(bits[s]),
                                            iters=cfg.kmeans_iters,
                                            seed=cfg.seed + s)
            else:
                c, _ = kmeans.fit(sub_s, k, iters=cfg.kmeans_iters,
                                  seed=cfg.seed + s)
            centroids[s, :k] = c
        self.centroids = centroids
        self._ev_dev = None
        if verbose:
            print(f"== codebooks: {time.perf_counter() - t0:.3f}s")
        return self

    def build(self, x: np.ndarray, verbose: bool = False) -> "VAQIndex":
        """train + encode (encode streams row chunks — see encode())."""
        self.train(x, verbose=verbose)
        return self.encode(x, verbose=verbose)

    # ------------------------------------------------------------------
    # Encode — streams host row chunks so device memory stays O(chunk) +
    # O(codes): the f32 projection of the full dataset is never resident
    # (a 20M×128d build would otherwise need ~20 GB transiently).
    # ------------------------------------------------------------------
    def encode(self, x: np.ndarray, verbose: bool = False,
               chunk_rows: int = 2_000_000) -> "VAQIndex":
        x = io.pad_dims(np.asarray(x, dtype=np.float32), self.config.subspace_num)
        n = x.shape[0]

        def chunk_fn(i):
            return jnp.asarray(x[i * chunk_rows:(i + 1) * chunk_rows])

        return self.encode_chunks(chunk_fn, n, chunk_rows, verbose=verbose)

    def encode_chunks(self, chunk_fn, n: int, chunk_rows: int = 2_000_000,
                      verbose: bool = False) -> "VAQIndex":
        """Encode from an arbitrary device-chunk source.

        ``chunk_fn(i)`` returns chunk ``i`` as a (rows_i, d) f32 device (or
        host) array — a memmap slice, a ``data.DeviceChunkSource`` chunk, etc.
        Codes are written into one pre-allocated narrow buffer with donated
        in-place updates, so device memory stays O(chunk) + O(codes) even at
        100M rows (the reference's streaming analog: disk-resident batch
        scan, BitVecEngine.cpp:1441-1624)."""
        if self.centroids is None:
            raise NotReadyError("encode() requires train() first")
        t0 = time.perf_counter()
        cent_dev = jnp.asarray(self.centroids)
        ev_dev = jnp.asarray(self.eigvecs[:, : self.total_dim])
        max_bits = int(self.bits.max())
        # Narrow dtype: u8 when every subspace fits (saves HBM + bandwidth).
        dtype = (jnp.uint8 if max_bits <= 8
                 else jnp.uint16 if max_bits <= 16 else jnp.int32)
        buf = jnp.zeros((self.highest_subs, n), dtype=dtype)  # transposed

        @functools.partial(jax.jit, donate_argnums=(0,))
        def write(b, c, start):
            return jax.lax.dynamic_update_slice(b, c, (0, start))

        d_in = ev_dev.shape[0]
        for i, start in enumerate(range(0, n, chunk_rows)):
            rows = chunk_fn(i)
            if rows.shape[1] < d_in:  # same zero-pad as io.pad_dims, on device
                rows = jnp.pad(rows, ((0, 0), (0, d_in - rows.shape[1])))
            xp = jnp.dot(rows, ev_dev, preferred_element_type=jnp.float32)
            buf = write(buf, _encode_blocked(xp, cent_dev).T.astype(dtype),
                        start)
        self.codes = jax.block_until_ready(buf)
        self.n_rows = n
        self.decoded = None
        self.decoded_norms = None
        if verbose:
            print(f"== encode {n} rows: {time.perf_counter() - t0:.3f}s")
        return self

    def _tombstone_norms(self, norms: jnp.ndarray) -> jnp.ndarray:
        """Re-apply tombstones to freshly (re)built row norms: deleted rows
        get +inf so every norms-based scan excludes them exactly."""
        if self.deleted_ids is not None and len(self.deleted_ids):
            norms = norms.at[jnp.asarray(self.deleted_ids)].set(jnp.inf)
        return norms

    def _ensure_decoded(self) -> None:
        """Materialize the decoded bf16 database for the matmul scan backend."""
        if self.decoded is None:
            dec, norms = scan_decoded.decode_db(
                self.codes, jnp.asarray(self.centroids))
            self.decoded = jax.block_until_ready(dec)
            self.decoded_norms = self._tombstone_norms(norms)

    def _ensure_decoded8(self, block_rows: int = 65536) -> None:
        # At 100M rows pick a block_rows dividing n: decode_db_int8's
        # unpad slice otherwise copies the whole int8 DB (9.6 GB extra).
        if self.decoded8 is None:
            d8, scales, norms = scan_decoded.decode_db_int8(
                self.codes, jnp.asarray(self.centroids),
                block_rows=block_rows)
            self.decoded8 = jax.block_until_ready(d8)
            self.decoded8_scales = scales
            self.decoded8_norms = self._tombstone_norms(norms)

    def _eigvecs_device(self) -> jnp.ndarray:
        if self._ev_dev is None:
            self._ev_dev = jnp.asarray(self.eigvecs[:, : self.total_dim])
        return self._ev_dev

    def _deleted_device(self) -> jnp.ndarray:
        """Device cache of the tombstoned ids (for on-device post-filters)."""
        if self._deleted_dev is None or \
                self._deleted_dev.shape[0] != len(self.deleted_ids):
            self._deleted_dev = jnp.asarray(
                self.deleted_ids.astype(np.int32))
        return self._deleted_dev

    def search_device(self, queries_dev: jnp.ndarray, k: int,
                      exact: bool = False, recall_target: float = 0.99,
                      backend: str = "decoded"):
        """Device-resident fused search step: one dispatch, results stay on
        device. This is the serving hot path; `search` wraps it with host
        conversion. ``exact`` switches the candidate selection from
        ``approx_max_k`` to a true top_k (parity tests). ``backend``:
        "decoded" (bf16), "decoded8" (int8 capacity tier) or "codes" (codes
        resident). When the index was `.shard()`-ed, the mesh-sharded scan
        is used automatically."""
        if self._mesh is not None and backend in ("decoded", "decoded8",
                                                  "codes"):
            sharded_tier = {"decoded": self._sharded_decoded,
                            "decoded8": self._sharded_decoded8,
                            "codes": self._sharded_codes}[backend]
            if sharded_tier is None:
                raise ConfigError(
                    f"index is sharded but tier {backend!r} was not "
                    "included in shard(tiers=...) — serving it unsharded "
                    "would silently ignore the mesh; re-shard with tiers "
                    "including it")
            return self._search_device_sharded(queries_dev, k, exact,
                                               recall_target,
                                               backend=backend)
        if backend == "codes":
            self._require_codes_bits()
            br = self._codes_block_rows(k)
            if br is None:
                # Too few windows for k even at the 8-row minimum: the
                # decoded bf16 scan computes the identical ADC quantity
                # (‖q − x̂‖²) and the decoded db is tiny at such n.
                backend = "decoded"
            else:
                # Codes-resident capacity tier: decode-then-dot window scan
                # (device memory holds only the codes, M B/row; see
                # ops/scan_codes.py). Tombstones: the codes tier has no norms
                # array to poison, so over-fetch k + #deleted and post-filter
                # by id ON DEVICE (the reference compacts on delete,
                # BitVecEngine.cpp:1626-1636, so it has no such hole).
                dec_table, dec_rows = self._codes_tier()
                qp = pca.project(queries_dev, self._eigvecs_device(),
                                 self.total_dim)
                n_del = (0 if self.deleted_ids is None
                         else len(self.deleted_ids))
                k_fetch = min(k + n_del, self.n_rows)
                d, i = scan_codes.decode_scan_topk(
                    self.codes, dec_table, dec_rows, qp, k_fetch,
                    n_valid=jnp.int32(self.n_rows), block_rows=br)
                if n_del == 0:
                    return (d, i) if k_fetch == k else (d[:, :k], i[:, :k])
                dead = jnp.any(
                    i[:, :, None] == self._deleted_device()[None, None, :],
                    axis=2)
                d = jnp.where(dead, jnp.inf, d)
                i = jnp.where(dead, -1, i)
                neg, pos = jax.lax.top_k(-d, k)
                i = jnp.take_along_axis(i, pos, axis=1)
                return -neg, jnp.where(jnp.isfinite(-neg), i, -1)
        if backend == "decoded8":
            self._ensure_decoded8()
            qp = jnp.dot(queries_dev, self._eigvecs_device(),
                         preferred_element_type=jnp.float32)
            return scan_decoded.decoded8_scan_topk(
                self.decoded8, self.decoded8_scales, self.decoded8_norms,
                self.decoded8, qp, k, exact=exact,
                recall_target=recall_target)
        self._ensure_decoded()
        return scan_decoded.decoded_search_e2e(
            queries_dev, self._eigvecs_device(), self.decoded,
            self.decoded_norms, k, exact=exact, recall_target=recall_target)

    def _require_codes_bits(self) -> None:
        """The codes tier reads codes as u8, so it only serves <= 8-bit
        subspaces; explicit backend="codes" on a wider index must fail loudly
        rather than truncate codes."""
        if int(self.bits.max()) > 8:
            raise ConfigError(
                "backend='codes' (decode-then-dot codes tier) supports "
                "<= 8-bit subspaces (codes must fit u8). This index "
                "allocates "
                f"up to {int(self.bits.max())} bits — use "
                "backend='decoded8' (128 B/row) or cap the config at "
                "max8 (the reference's own FAST family caps at 4, "
                "VAQ.cpp:1263-1266).")

    def _codes_block_rows(self, k: int) -> Optional[int]:
        """Window size for the decode-then-dot codes tier.

        The window scan keeps ONE candidate per (query, window), so recall
        needs windows ≫ k: with ≥ 64 windows per requested neighbor the
        expected window-collision loss is ≤ k/128 rows (< 1% of k). Aim for
        that, as a power of two between 16 rows (the fused kernel's dot
        needs ≥ 16 rows per tile) and 512.

        Returns None when even 16-row windows cannot provide 64·k windows —
        the caller should serve from the decoded scan instead (identical ADC
        quantity, and at n < 1024·k rows the decoded db is tiny) — unless
        the decoded db would exceed ~1 GB, where the degraded-recall
        windowed scan still beats the memory blow-up."""
        br = self.n_rows // (64 * k)
        if br < 16:
            if self.n_rows * self.total_dim * 2 > (1 << 30):
                return 16
            return None
        return 1 << (min(br, 512).bit_length() - 1)

    def _codes_tier(self):
        """Lazily built (bf16 decode table, f32 decode rows) for the
        codes-resident tier; depends only on the centroids, so CRUD on codes
        never invalidates it."""
        if getattr(self, "_dec_table", None) is None:
            self._dec_table, self._dec_rows = \
                scan_codes.build_decode_tables(self.centroids)
        return self._dec_table, self._dec_rows

    # ------------------------------------------------------------------
    # LUT quantization (V16)
    # ------------------------------------------------------------------
    def learn_quantization(self, x_train: np.ndarray,
                           sample_ratio: float = 0.1) -> "VAQIndex":
        """Learn per-subspace u8 LUT offset/scale by α-grid search
        (reference VAQ.cpp:1118-1187).

        The whole search runs ON DEVICE: one sort per subspace gives every
        α's floor/ceil quantile by interpolated gather (``max(col − off, 0)``
        preserves order, so the offset LUT's quantile reads from the same
        sorted array), and the 7 α losses are accumulated with one blocked
        pass over the sampled LUTs.
        """
        x_train = io.pad_dims(np.asarray(x_train, dtype=np.float32),
                              self.config.subspace_num)
        n = x_train.shape[0]
        # Cap the sample (the reference uses the raw ratio, VAQ.cpp:1124):
        # the α-grid picks one (offset, scale) pair per subspace from column
        # quantiles, which saturate long before 64k sampled queries — an
        # uncapped 0.1·n at 100M rows would materialize a ~300 GB LUT array.
        sample_n = min(max(1, int(sample_ratio * n)), 65536)
        qs = sample_rows(x_train, sample_n, self.config.seed)
        qp = pca.project(qs, self.eigvecs, self.total_dim)
        luts = scan_jax.build_luts(jnp.asarray(qp),
                                   jnp.asarray(self.centroids))
        # Mask padded centroid entries out of the statistics (the reference
        # instead reads uninitialized LUT rows there — we fix that).
        valid = jnp.asarray(
            np.arange(self.max_centroids)[None, :]
            < self.centroid_counts[:, None])               # (M', Cmax)
        alphas = jnp.asarray((0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1),
                             dtype=jnp.float32)
        offs, scales, losses = _learn_quantization_device(
            luts, valid, jnp.asarray(self.centroid_counts.astype(np.int32)),
            alphas)
        # reference tie-breaking: last α with loss <= best wins
        losses = np.asarray(losses)
        best = int(np.flatnonzero(losses <= losses.min() + 0.0)[-1])
        self.lut_offsets = np.asarray(offs[best])
        self.lut_scales = np.asarray(scales[best])
        return self

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        k: int,
        query_batch: int = 512,
        block_rows: int = 32768,
        backend: str = "auto",
        verbose: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ADC top-k search for a query batch.

        Returns (sq_dists (nq, k), labels (nq, k)). The scan strategy flags
        (SORT/HEAP/EA) all map to the same exhaustive blocked scan; TI maps
        to the IVF cluster-probe when built.

        backend: "decoded" (bf16 reconstruction matmul — fastest while the
        decoded DB fits device memory), "decoded8" (int8 tier), "codes"
        (decode-then-dot window scan over the raw codes — the capacity
        tier, M B/row resident; needs max_bits ≤ 8), "lut" (codes + LUT
        scan; ``platform.choose("lut_scan")`` routes it to "codes" where
        that is faster and eligible), "fast4" (the reference's FAST
        semantics: winners by the u8-quantized LUT sums, VAQ.cpp:1778-1836,
        then exact f32 distances), "lut_gather" (force the exact gather
        scan), or "auto".
        """
        cfg = self.config
        if self.eigvecs is None:
            raise NotReadyError("search() requires train() first")
        if self.codes is None:
            raise NotReadyError("search() requires encode() first")
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ShapeError(f"queries must be (nq, d), got {queries.shape}")
        if queries.shape[1] > self.eigvecs.shape[0] or \
                (self.orig_dim and queries.shape[1] != self.orig_dim):
            raise ShapeError(
                f"query dim {queries.shape[1]} does not match index dim "
                f"{self.orig_dim}")
        queries = io.pad_dims(queries, cfg.subspace_num)
        nq = queries.shape[0]
        use_quant = bool(cfg.methods & (SearchMethod.FAST | SearchMethod.FAST2
                                        | SearchMethod.FAST3)) and \
            self.lut_offsets is not None
        # IVF/TI routing is explicit: backend="ivf" forces it,
        # backend="auto" takes it when the config asks for TI; any concrete
        # backend string wins.
        if backend == "ivf" and self.ivf is None:
            raise NotReadyError(
                "backend='ivf' requires cluster_ti()/attach_ivf() first")
        ti_path = self.ivf is not None and (
            backend == "ivf"
            or (backend == "auto" and bool(cfg.methods & SearchMethod.TI)))
        if backend == "auto":
            # Quantized-LUT semantics only exist on the LUT path; otherwise
            # the decoded matmul backend is the fast one until device memory
            # runs out (then pass backend="decoded8"/"codes" or shard).
            backend = "lut" if use_quant else "decoded"
        if ti_path:
            # Probe path gathers/scans its own buckets. On a sharded index
            # the TI tier must itself be sharded — silently serving the
            # unsharded buckets would ignore the mesh.
            if self._mesh is not None and self._sharded_ivf is None:
                raise ConfigError(
                    "index is sharded but the TI/IVF tier was not included "
                    "in shard(tiers=...) — serving the unsharded probe "
                    "state would silently ignore the mesh; re-shard with "
                    "tiers including 'ivf'")
        elif backend == "decoded":
            self._ensure_decoded()
        elif backend == "decoded8":
            self._ensure_decoded8()

        # Tombstones: the norms-based paths (decoded/decoded8) exclude them
        # exactly via +inf norms, and the IVF probe via bucket_ids == -1;
        # only the codes+LUT path needs the over-fetch + post-filter
        # (conditioned on the path actually taken, not the backend string).
        k_out = k
        n_deleted = 0 if self.deleted_ids is None else len(self.deleted_ids)
        # A sharded codes tier is served via search_device, which applies the
        # on-device tombstone post-filter itself.
        codes_sharded = (self._mesh is not None
                         and self._sharded_codes is not None)
        needs_filter = bool(n_deleted) and not ti_path and \
            backend not in ("decoded", "decoded8") and \
            not (backend == "codes" and codes_sharded)
        if needs_filter:
            k = min(k + n_deleted, self.n_rows)
        all_d = np.empty((nq, k), dtype=np.float32)
        all_i = np.empty((nq, k), dtype=np.int32)

        t0 = time.perf_counter()
        for start in range(0, nq, query_batch):
            qb = queries[start:start + query_batch]
            if ti_path:
                qp = pca.project(qb, self.eigvecs, self.total_dim)
                if self._sharded_ivf is not None:
                    d, i = self._sharded_ivf.search(qp, k)
                else:
                    luts = scan_jax.build_luts(qp,
                                               jnp.asarray(self.centroids))
                    d, i = self.ivf.search(self, qp, luts, k)
            elif backend in ("decoded", "decoded8") or \
                    (backend == "codes" and codes_sharded):
                d, i = self.search_device(jnp.asarray(qb), k, backend=backend)
            else:
                qp = pca.project(qb, self.eigvecs, self.total_dim)
                max_b = int(self.bits.max())
                # The decode-then-dot codes tier serves ≤8-bit codes when
                # enough windows per k can be formed; for backend="lut" the
                # platform decides whether it beats the exact gather scan.
                if backend == "codes":
                    self._require_codes_bits()
                br = self._codes_block_rows(k)
                use_codes = br is not None and (
                    backend == "codes" or (
                        backend == "lut" and max_b <= 8
                        and platform.choose("lut_scan") == "codes"))
                if backend == "codes" and br is None:
                    # decoded fallback: same ADC quantity, enough windows
                    # cannot be formed at this n (see _codes_block_rows)
                    d, i = self.search_device(jnp.asarray(qb), k,
                                              backend="decoded")
                    all_d[start:start + qb.shape[0]] = np.asarray(d)
                    all_i[start:start + qb.shape[0]] = np.asarray(i)
                    continue
                if use_codes:
                    dec_table, dec_rows = self._codes_tier()
                    d, i = scan_codes.decode_scan_topk(
                        self.codes, dec_table, dec_rows, qp, k,
                        n_valid=jnp.int32(self.n_rows), block_rows=br)
                    all_d[start:start + qb.shape[0]] = np.asarray(d)
                    all_i[start:start + qb.shape[0]] = np.asarray(i)
                    continue
                luts = scan_jax.build_luts(qp, jnp.asarray(self.centroids))
                scan_luts, lut8 = luts, None
                if use_quant:
                    # Reproduce the FAST-path accuracy: quantize to u8 then
                    # dequantize, injecting the same rounding error as the
                    # reference's shuffle scan (VAQ.cpp:1778-1836, 1973-2043).
                    lut8 = scan_jax.quantize_luts(
                        luts, jnp.asarray(self.lut_offsets),
                        jnp.asarray(self.lut_scales))
                    deq = (lut8.astype(jnp.float32)
                           / jnp.asarray(self.lut_scales)[None, :, None]
                           + jnp.asarray(self.lut_offsets)[None, :, None])
                    if cfg.methods & SearchMethod.FAST3:
                        # FAST3 hybrid split (VAQ.cpp:676-683, 1927-2046):
                        # only the ≤4-bit subspaces go through the quantized
                        # table; >4-bit ones keep the f32 gather path.
                        shuf = jnp.asarray(self.bits <= 4)[None, :, None]
                        scan_luts = jnp.where(shuf, deq, luts)
                    else:
                        scan_luts = deq
                if backend == "fast4":
                    if max_b > 4:
                        raise ConfigError(
                            "fast4 backend requires max_bits <= 4 "
                            "(reference constraint, VAQ.cpp:1263-1266)")
                    d, i = scan_jax.fast_scan_topk(
                        self.codes.T, luts, lut8, k,
                        n_valid=jnp.int32(self.n_rows),
                        block_rows=block_rows)
                else:
                    d, i = scan_jax.adc_scan_topk(
                        self.codes.T, scan_luts, k,
                        n_valid=jnp.int32(self.n_rows),
                        block_rows=block_rows)
            all_d[start:start + qb.shape[0]] = np.asarray(d)
            all_i[start:start + qb.shape[0]] = np.asarray(i)
        if verbose:
            dt = time.perf_counter() - t0
            print(f"== search {nq} queries: {dt:.3f}s ({nq / dt:.1f} QPS)")

        if needs_filter and k_out < k:
            # Strip tombstoned ids, keep the first k_out survivors per row —
            # vectorized: a stable argsort on the dead mask compacts live
            # entries to the front without reordering them.
            dead_mask = np.isin(all_i, self.deleted_ids)
            order = np.argsort(dead_mask, axis=1, kind="stable")
            d_s = np.take_along_axis(all_d, order, axis=1)[:, :k_out]
            i_s = np.take_along_axis(all_i, order, axis=1)[:, :k_out]
            n_live = k - dead_mask.sum(axis=1)
            valid = np.arange(k_out)[None, :] < n_live[:, None]
            return (np.where(valid, d_s, np.inf).astype(np.float32),
                    np.where(valid, i_s, -1).astype(np.int32))
        return all_d, all_i

    # ------------------------------------------------------------------
    # CRUD (reference get/append/deleteBitV, BitVecEngine.cpp:1626-1636)
    # ------------------------------------------------------------------
    def add(self, x_new: np.ndarray) -> np.ndarray:
        """Encode + append rows; returns their new global ids."""
        x_new = io.pad_dims(np.asarray(x_new, dtype=np.float32),
                            self.config.subspace_num)
        xp = pca.project(x_new, self.eigvecs, self.total_dim)
        new_codes = _encode_blocked(xp, jnp.asarray(self.centroids),
                                    block_rows=max(8, x_new.shape[0]))
        new_codes_t = new_codes.T.astype(self.codes.dtype)
        start = self.n_rows
        self.codes = jnp.concatenate([self.codes, new_codes_t], axis=1)
        self.n_rows += x_new.shape[0]
        if self.decoded is not None:
            dec, norms = scan_decoded.decode_db(
                new_codes_t, jnp.asarray(self.centroids),
                block_rows=max(8, x_new.shape[0]))
            self.decoded = jnp.concatenate([self.decoded, dec], axis=0)
            self.decoded_norms = jnp.concatenate(
                [self.decoded_norms, norms])
        self.decoded8 = None  # rebuilt lazily
        # Re-shard explicitly after bulk updates — and actually release the
        # sharded device buffers, not just the mesh handle.
        self._mesh = None
        self._q_axis = None
        self._sharded_decoded = None
        self._sharded_norms = None
        self._sharded_decoded8 = None
        self._sharded_d8_norms = None
        self._sharded_codes = None
        self._sharded_ivf = None
        return np.arange(start, self.n_rows)

    def delete(self, ids) -> None:
        """Tombstone rows: they stop appearing in results. Norms-based scans
        (decoded/decoded8/sharded) exclude them exactly via +inf norms —
        applied here to every materialized cache and re-applied on any
        rebuild (_ensure_decoded*); the IVF probe excludes them exactly via
        ``bucket_ids == -1`` (the rescore's masking contract); the
        codes+LUT path over-fetches and post-filters in search()."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if self.deleted_ids is None:
            self.deleted_ids = np.unique(ids)
        else:
            self.deleted_ids = np.unique(
                np.concatenate([self.deleted_ids, ids]))
        self._deleted_dev = None  # re-uploaded lazily by _deleted_device
        dev_ids = jnp.asarray(ids)
        if self.decoded is not None:
            self.decoded_norms = self.decoded_norms.at[dev_ids].set(jnp.inf)
        if self.decoded8 is not None:
            self.decoded8_norms = self.decoded8_norms.at[dev_ids].set(jnp.inf)
        if self._sharded_norms is not None:
            self._sharded_norms = self._sharded_norms.at[dev_ids].set(jnp.inf)
            if self._sharded_ivf is not None and \
                    getattr(self._sharded_ivf, "rescore_norms", None) \
                    is not None:
                # the sharded probe's rescore source aliases this array;
                # rebinding above would otherwise strand it on the old copy
                self._sharded_ivf.rescore_norms = self._sharded_norms
        if self._sharded_d8_norms is not None:
            self._sharded_d8_norms = \
                self._sharded_d8_norms.at[dev_ids].set(jnp.inf)
        if self.ivf is not None:
            st = self.ivf.state
            flat = np.flatnonzero(np.isin(np.asarray(st.bucket_ids), ids))
            if flat.size:
                r, c = np.divmod(flat, st.bucket_ids.shape[1])
                r_d, c_d = jnp.asarray(r), jnp.asarray(c)
                st.bucket_ids = st.bucket_ids.at[r_d, c_d].set(-1)
                # poison the row values too: the group-min scan ranks by
                # values (norms are derived from the rows), so a deleted row
                # left in place would keep promoting its window. Exactness
                # never depends on this — the rescore masks slots whose
                # bucket_ids are -1 (set above).
                from vaq_tpu.ops.probe import poison_pattern
                if st.bucket_rows.dtype == jnp.int8:
                    poison_row = jnp.asarray(poison_pattern(st.d_full))
                else:
                    poison_row = jnp.full((st.d_full,), 1e15,
                                          st.bucket_rows.dtype)
                if st.transposed:   # (ncl, D, cap): slots are columns
                    st.bucket_rows = st.bucket_rows.at[r_d, :, c_d].set(
                        poison_row)
                else:
                    st.bucket_rows = st.bucket_rows.at[r_d, c_d].set(
                        poison_row)
                dec = np.bincount(r, minlength=st.ncl).astype(np.int32)
                st.sizes = st.sizes - jnp.asarray(dec)
                if self._sharded_ivf is not None:
                    # keep the cluster-sharded copy consistent (same slot
                    # coordinates — padding clusters are appended after ncl)
                    siv = self._sharded_ivf
                    siv.ids = siv.ids.at[r_d, c_d].set(-1)
                    if siv.transposed:
                        siv.rows = siv.rows.at[r_d, :, c_d].set(poison_row)
                    else:
                        siv.rows = siv.rows.at[r_d, c_d].set(poison_row)
                    dec_p = np.pad(dec, (0, siv.sizes.shape[0] - st.ncl))
                    siv.sizes = siv.sizes - jnp.asarray(dec_p)
                    siv.local_sizes = (siv.local_sizes
                                       - dec_p.reshape(siv.local_sizes.shape))

    def codes_rowmajor(self) -> np.ndarray:
        """Host copy of the codes in row-major (n, M') order (the storage is
        transposed on device — see the field comment)."""
        return np.ascontiguousarray(np.asarray(self.codes).T)

    def get_codes(self, ids) -> np.ndarray:
        """Raw codes of rows (the getBitV analog)."""
        return np.asarray(self.codes[:, jnp.asarray(np.atleast_1d(ids))]).T

    def reconstruct(self, ids) -> np.ndarray:
        """Decoded (reconstructed) vectors of rows."""
        codes = self.get_codes(ids).astype(np.int64)
        out = np.empty((codes.shape[0], self.total_dim), dtype=np.float32)
        l = self.subs_len
        for s in range(self.highest_subs):
            out[:, s * l:(s + 1) * l] = self.centroids[s][codes[:, s]]
        return out

    # ------------------------------------------------------------------
    # Multi-device serving: shard the decoded DB over a mesh (§2.5)
    # ------------------------------------------------------------------
    def shard(self, mesh=None, q_axis: Optional[str] = None,
              tiers: Tuple[str, ...] = ("decoded",)) -> "VAQIndex":
        """Row-shard database tiers over the mesh's "db" axis.

        ``tiers`` selects which storage tiers get a sharded path: "decoded"
        (bf16, 2·D B/row — the throughput tier), "decoded8" (int8, D B/row),
        "codes" (raw codes, M B/row — the capacity tiers) and/or "ivf" (the
        cluster-probe buckets, sharded over whole clusters — requires
        attach_ivf first). After this, `search_device`/`search` with a
        matching backend run the sharded scan with the per-shard top-k
        merged by one k-row all_gather (the device-mesh form of the
        reference's disk-resident chunk merge, BitVecEngine.cpp:1599); a
        backend whose tier was NOT sharded raises instead of silently
        serving unsharded.
        Pass q_axis="q" on a 2-D (q, db) mesh for query data parallelism.
        """
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from vaq_tpu.parallel import make_mesh

        unknown = set(tiers) - {"decoded", "decoded8", "codes", "ivf"}
        if unknown:
            raise ConfigError(f"unknown shard tiers: {sorted(unknown)}")
        mesh = mesh if mesh is not None else make_mesh()
        nshards = mesh.shape["db"]
        pad = (-self.n_rows) % nshards
        if "decoded" in tiers:
            self._ensure_decoded()
            dec = jnp.pad(self.decoded, ((0, pad), (0, 0)))
            norms = jnp.pad(self.decoded_norms, (0, pad),
                            constant_values=np.inf)
            self._sharded_decoded = jax.device_put(
                dec, NamedSharding(mesh, P("db", None)))
            self._sharded_norms = jax.device_put(
                norms, NamedSharding(mesh, P("db")))
        if "ivf" in tiers:
            if self.ivf is None:
                raise ConfigError(
                    "shard tier 'ivf' requires cluster_ti()/attach_ivf() "
                    "first (the probe state to shard)")
            from vaq_tpu.ivf import ShardedIVF
            # the row-sharded decoded tier (just built above when present)
            # doubles as the exact second-stage rescore source for int8
            # buckets
            self._sharded_ivf = ShardedIVF(
                self.ivf.state, self.ivf.visit, mesh, q_axis,
                rescore_rows=self._sharded_decoded,
                rescore_norms=self._sharded_norms)
        if "decoded8" in tiers:
            self._ensure_decoded8()
            d8 = jnp.pad(self.decoded8, ((0, 0), (0, pad)))
            norms8 = jnp.pad(self.decoded8_norms, (0, pad),
                             constant_values=np.inf)
            self._sharded_decoded8 = jax.device_put(
                d8, NamedSharding(mesh, P(None, "db")))
            self._sharded_d8_norms = jax.device_put(
                norms8, NamedSharding(mesh, P("db")))
        if "codes" in tiers:
            self._require_codes_bits()
            self._codes_tier()  # build the (tiny, replicated) decode tables
            codes_p = jnp.pad(self.codes.astype(jnp.uint8),
                              ((0, 0), (0, pad)))
            self._sharded_codes = jax.device_put(
                codes_p, NamedSharding(mesh, P(None, "db")))
        self._mesh = mesh
        self._q_axis = q_axis
        return self

    def _search_device_sharded(self, queries_dev, k, exact, recall_target,
                               backend="decoded"):
        from vaq_tpu.parallel import (sharded_codes_search,
                                      sharded_decoded8_search,
                                      sharded_decoded_search)

        qp = jnp.dot(queries_dev, self._eigvecs_device(),
                     preferred_element_type=jnp.float32)
        if backend == "decoded":
            return sharded_decoded_search(
                self._sharded_decoded, self._sharded_norms, qp, k,
                jnp.int32(self.n_rows), self._mesh, exact=exact,
                recall_target=recall_target, q_axis=self._q_axis)
        if backend == "decoded8":
            return sharded_decoded8_search(
                self._sharded_decoded8, self.decoded8_scales,
                self._sharded_d8_norms, qp, k, jnp.int32(self.n_rows),
                self._mesh, exact=exact, recall_target=recall_target,
                q_axis=self._q_axis)
        # codes tier: per-shard window count sets the block size; tombstones
        # are post-filtered by id exactly as on the unsharded codes path
        shard_rows = self._sharded_codes.shape[1] // self._mesh.shape["db"]
        br = max(16, min(512, shard_rows // (64 * k)))  # see _codes_block_rows
        br = 1 << (br.bit_length() - 1)
        n_del = 0 if self.deleted_ids is None else len(self.deleted_ids)
        k_fetch = min(k + n_del, self.n_rows)
        dec_table, dec_rows = self._codes_tier()
        d, i = sharded_codes_search(
            self._sharded_codes, dec_table, dec_rows, qp, k_fetch,
            jnp.int32(self.n_rows), self._mesh, block_rows=br,
            q_axis=self._q_axis)
        if n_del:
            dead = jnp.any(
                i[:, :, None] == self._deleted_device()[None, None, :],
                axis=2)
            d = jnp.where(dead, jnp.inf, d)
            i = jnp.where(dead, -1, i)
        if k_fetch > k or n_del:
            neg, pos = jax.lax.top_k(-d, k)
            i = jnp.take_along_axis(i, pos, axis=1)
            d = -neg
            i = jnp.where(jnp.isfinite(d), i, -1)
        return d, i

    # ------------------------------------------------------------------
    # Refine (V17)
    # ------------------------------------------------------------------
    def refine(self, queries: np.ndarray, labels: np.ndarray,
               x_original: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact rerank of the R candidates per query against the original
        vectors (reference VAQ::refine, VAQ.cpp:849-876)."""
        queries = np.asarray(queries, dtype=np.float32)
        x_original = np.asarray(x_original, dtype=np.float32)
        labels = np.asarray(labels)
        safe = np.maximum(labels, 0)
        cands = jnp.asarray(x_original[safe])               # (nq, R, d)
        d, i = scan_jax.refine_topk(
            jnp.asarray(queries[:, : x_original.shape[1]]), cands,
            jnp.asarray(labels.astype(np.int32)), k)
        return np.asarray(d), np.asarray(i)

    # ------------------------------------------------------------------
    # Persistence — full state (fixes the reference's eigvec gap, SURVEY §5)
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        arrays = {
            "eigvecs": self.eigvecs,
            "eigvals": self.eigvals,
            "var_per_subs": self.var_per_subs,
            "cum_var_per_subs": self.cum_var_per_subs,
            "bits": self.bits,
            "centroids": self.centroids,
            "centroid_counts": self.centroid_counts,
        }
        if self.codes is not None:
            # artifact format stays row-major (n, M') for interop stability
            arrays["codes"] = self.codes_rowmajor()
        if self.lut_offsets is not None:
            arrays["lut_offsets"] = self.lut_offsets
            arrays["lut_scales"] = self.lut_scales
        if self.deleted_ids is not None and len(self.deleted_ids):
            arrays["deleted_ids"] = self.deleted_ids
        meta = {
            "config": {
                **{k: v for k, v in dataclasses.asdict(self.config).items()
                   if k != "methods" and k != "hardcoded_bits"},
                "methods": int(self.config.methods),
                "hardcoded_bits": list(self.config.hardcoded_bits)
                if self.config.hardcoded_bits else None,
            },
            "subs_len": self.subs_len,
            "highest_subs": self.highest_subs,
            "orig_dim": self.orig_dim,
            "n_rows": self.n_rows,
        }
        io.save_index_npz(path, arrays, meta)

    def export_reference_artifacts(self, centroids_path: str,
                                   codes_path: str) -> None:
        """Write centroids/codes in the C++ reference's binary formats
        (saveCentroids/saveCodebook) for interop."""
        cents = [self.centroids[s, : int(self.centroid_counts[s])]
                 for s in range(self.highest_subs)]
        io.save_centroids_ref(centroids_path, cents)
        io.save_codebook_ref(codes_path, self.codes_rowmajor())

    @classmethod
    def from_reference_artifacts(cls, config: VAQConfig, centroids_path: str,
                                 codes_path: str,
                                 x_train: np.ndarray) -> "VAQIndex":
        """Build an index from the C++ engine's saved centroids + codebook.

        The reference does NOT persist the eigenvectors (SURVEY §5), so the
        rotation must be retrained from the same training data; centroids and
        codes are then adopted as-is.
        """
        idx = cls(config)
        x_train = np.asarray(x_train, dtype=np.float32)
        idx.orig_dim = x_train.shape[1]
        x_train = io.pad_dims(x_train, config.subspace_num)
        rot = pca.train_rotation(x_train, config.subspace_num,
                                 config.percent_var_explained, config.seed)
        idx.eigvecs, idx.eigvals = rot.eigvecs, rot.eigvals
        idx.var_per_subs = rot.var_per_subs
        idx.cum_var_per_subs = rot.cum_var_per_subs
        idx.subs_len, idx.highest_subs = rot.subs_len, rot.highest_subs

        cents = io.load_centroids_ref(centroids_path)
        idx.highest_subs = min(idx.highest_subs, len(cents))
        counts = np.array([c.shape[0] for c in cents[: idx.highest_subs]],
                          dtype=np.int64)
        idx.bits = np.round(np.log2(counts)).astype(np.int64)
        idx.centroid_counts = counts
        cmax = 1 << int(idx.bits.max())
        full = np.full((idx.highest_subs, cmax, idx.subs_len), PAD_SENTINEL,
                       dtype=np.float32)
        for s, c in enumerate(cents[: idx.highest_subs]):
            full[s, : c.shape[0]] = c
        idx.centroids = full

        codes = io.load_codebook_ref(codes_path)
        idx.codes = jnp.asarray(codes[:, : idx.highest_subs].astype(
            np.uint16 if idx.bits.max() > 8 else np.uint8).T.copy())
        idx.n_rows = codes.shape[0]
        return idx

    @classmethod
    def load(cls, path: str, with_codes: bool = True) -> "VAQIndex":
        """``with_codes=False`` skips the device upload of the codes — for
        flows that serve a different tier (e.g. a probe-only deployment,
        where device memory is needed for the bucket arrays)."""
        arrays, meta = io.load_index_npz(path)
        if not with_codes:
            arrays.pop("codes", None)
        cfg_d = dict(meta["config"])
        cfg_d["methods"] = SearchMethod(cfg_d["methods"])
        if cfg_d.get("hardcoded_bits"):
            cfg_d["hardcoded_bits"] = tuple(cfg_d["hardcoded_bits"])
        idx = cls(config=VAQConfig(**cfg_d))
        idx.eigvecs = arrays["eigvecs"]
        idx.eigvals = arrays["eigvals"]
        idx.var_per_subs = arrays["var_per_subs"]
        idx.cum_var_per_subs = arrays["cum_var_per_subs"]
        idx.bits = arrays["bits"]
        idx.centroids = arrays["centroids"]
        idx.centroid_counts = arrays["centroid_counts"]
        idx.subs_len = meta["subs_len"]
        idx.highest_subs = meta["highest_subs"]
        idx.orig_dim = meta["orig_dim"]
        idx.n_rows = meta["n_rows"]
        if "codes" in arrays:
            # artifact is row-major (n, M'); device storage is transposed
            idx.codes = jnp.asarray(arrays["codes"].T.copy())
        if "lut_offsets" in arrays:
            idx.lut_offsets = arrays["lut_offsets"]
            idx.lut_scales = arrays["lut_scales"]
        if "deleted_ids" in arrays:
            idx.deleted_ids = arrays["deleted_ids"]
        return idx

"""Dataset and artifact IO.

Replaces the reference reader/writer suite (``bitvecengine/utils/IO.hpp``):
fvecs / bvecs / ivecs / headerless-bin / ascii readers (``IO.hpp:91-334``),
sampled readers (``IO.hpp:431-518``), KNN-result CSV writer (``IO.hpp:706``),
and the centroid/codebook artifact persistence (``IO.hpp:522-772``).

This build reads with numpy (memory-mapped where possible) and persists the
*full* index state as a single ``.npz`` — fixing the reference's gap of not
saving the eigenvectors alongside the centroids (SURVEY §5: saved centroids
alone cannot serve fresh queries there).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vaq_tpu.errors import FormatError


# ---------------------------------------------------------------------------
# Texmex-style vector file formats: each record is [int32 dim][dim elements].
# ---------------------------------------------------------------------------

def _read_vecs(path: str, elem_dtype, max_rows: Optional[int] = None) -> np.ndarray:
    """Read a {f,b,i}vecs file into an (n, d) array.

    Mirrors readFVecsFromExternal / readBVecsFromExternal / readIVecsFromExternal
    (IO.hpp:126/198/334) without the fixed-size preallocation.
    """
    elem_dtype = np.dtype(elem_dtype)
    from vaq_tpu import native
    fast = native.read_vecs(path, elem_dtype, max_rows)
    if fast is not None:
        return fast
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=elem_dtype)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    if dim <= 0:
        raise FormatError(f"{path}: bad leading dimension {dim}")
    record_bytes = 4 + dim * elem_dtype.itemsize
    if raw.size % record_bytes != 0:
        raise FormatError(
            f"{path}: size {raw.size} not a multiple of record size {record_bytes}"
        )
    n = raw.size // record_bytes
    if max_rows is not None:
        n = min(n, max_rows)
        raw = raw[: n * record_bytes]
    rec = raw.reshape(n, record_bytes)
    # Sanity-check every record's dim header matches.
    dims = rec[:, :4].copy().view(np.int32).reshape(-1)
    if not np.all(dims == dim):
        raise FormatError(f"{path}: inconsistent record dimensions")
    body = rec[:, 4:].copy().view(elem_dtype)
    return body.reshape(n, dim)


def read_fvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    return _read_vecs(path, np.float32, max_rows)


def read_bvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    return _read_vecs(path, np.uint8, max_rows)


def read_ivecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    return _read_vecs(path, np.int32, max_rows)


def write_fvecs(path: str, x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    out = np.empty((n, 1 + d), dtype=np.float32)
    out[:, 0] = np.frombuffer(
        np.full(n, d, dtype=np.int32).tobytes(), dtype=np.float32
    )
    out[:, 1:] = x
    out.tofile(path)


def write_ivecs(path: str, x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, dtype=np.int32)
    n, d = x.shape
    out = np.empty((n, 1 + d), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x
    out.tofile(path)


# ---------------------------------------------------------------------------
# Headerless binary / ascii (IO.hpp:235-289, 23-88)
# ---------------------------------------------------------------------------

def read_vecs_sampled(path: str, elem_dtype, n_sample: int,
                      seed: int = 13517106) -> np.ndarray:
    """Sample ``n_sample`` rows from a {f,b,i}vecs file WITHOUT loading it
    (reference readBVecsFromExternalSample, IO.hpp:431-480).

    The reference streams 1M-row batches and takes ``rand() % batch`` rows
    with replacement from each; here the file is memory-mapped and a seeded
    global sample of distinct row indices is gathered (sorted, so access is
    sequential) — same O(sample) memory, better statistics (no duplicates,
    no batch stratification artifacts).
    """
    elem_dtype = np.dtype(elem_dtype)
    size = os.path.getsize(path)
    if size < 4:
        return np.zeros((0, 0), dtype=elem_dtype)
    with open(path, "rb") as f:
        dim = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
    rec = 4 + dim * elem_dtype.itemsize
    total = size // rec
    rng = np.random.default_rng(seed)
    take = min(n_sample, total)
    idx = np.sort(rng.choice(total, size=take, replace=False))
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = np.empty((take, dim), dtype=elem_dtype)
    for o, r in enumerate(idx):
        start = r * rec + 4
        out[o] = np.frombuffer(
            mm[start:start + dim * elem_dtype.itemsize], dtype=elem_dtype)
    return out


def read_fvecs_sampled(path: str, n_sample: int,
                       seed: int = 13517106) -> np.ndarray:
    return read_vecs_sampled(path, np.float32, n_sample, seed)


def read_bvecs_sampled(path: str, n_sample: int,
                       seed: int = 13517106) -> np.ndarray:
    return read_vecs_sampled(path, np.uint8, n_sample, seed).astype(
        np.float32)


def read_bin_sampled(path: str, dim: int, n_sample: int, dtype=np.float32,
                     seed: int = 13517106) -> np.ndarray:
    """Sampled reads of a headerless binary file (reference
    readFromExternalBinSample, IO.hpp:482-518) via memmap row gather —
    works for files far larger than RAM."""
    dtype = np.dtype(dtype)
    total = os.path.getsize(path) // (dim * dtype.itemsize)
    rng = np.random.default_rng(seed)
    take = min(n_sample, total)
    idx = np.sort(rng.choice(total, size=take, replace=False))
    mm = np.memmap(path, dtype=dtype, mode="r", shape=(total, dim))
    return np.asarray(mm[idx], dtype=dtype)


def read_bin(path: str, dim: int, dtype=np.float32,
             max_rows: Optional[int] = None) -> np.ndarray:
    """Read a headerless binary file of `dim`-wide rows (IO.hpp:261)."""
    dtype = np.dtype(dtype)
    count = -1 if max_rows is None else max_rows * dim
    arr = np.fromfile(path, dtype=dtype, count=count)
    n = arr.size // dim
    return arr[: n * dim].reshape(n, dim)


def read_ascii(path: str, delimiter: Optional[str] = None,
               max_rows: Optional[int] = None) -> np.ndarray:
    """Read whitespace/CSV ascii vectors (IO.hpp:23-88)."""
    arr = np.loadtxt(path, dtype=np.float32, delimiter=delimiter,
                     max_rows=max_rows)
    if arr.ndim == 1:
        arr = arr[None, :]
    return arr


def read_dataset(path: str, dim: Optional[int] = None,
                 max_rows: Optional[int] = None) -> np.ndarray:
    """Dispatch on extension, as the demos do with their --ori-format flags."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".fvecs":
        return read_fvecs(path, max_rows)
    if ext == ".bvecs":
        return read_bvecs(path, max_rows).astype(np.float32)
    if ext == ".ivecs":
        return read_ivecs(path, max_rows)
    if ext in (".bin", ".fbin"):
        if dim is None:
            raise FormatError("dim required for headerless .bin files")
        return read_bin(path, dim, max_rows=max_rows)
    if ext in (".txt", ".csv", ".ascii"):
        return read_ascii(path, "," if ext == ".csv" else None, max_rows)
    raise FormatError(f"unknown dataset extension: {path}")


def pad_dims(x: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad feature dims to a multiple (demo_vaq.cpp:66-72 does the same
    so that d divides evenly into subspaces)."""
    d = x.shape[1]
    target = ((d + multiple - 1) // multiple) * multiple
    if target == d:
        return x
    out = np.zeros((x.shape[0], target), dtype=x.dtype)
    out[:, :d] = x
    return out


# ---------------------------------------------------------------------------
# Results + artifacts
# ---------------------------------------------------------------------------

def write_knn_results(path: str, labels: np.ndarray,
                      distances: Optional[np.ndarray] = None) -> None:
    """CSV answers, one query per line (IO.hpp:706-734)."""
    with open(path, "w") as f:
        for q in range(labels.shape[0]):
            f.write(",".join(str(int(v)) for v in labels[q]))
            f.write("\n")
    if distances is not None:
        base, ext = os.path.splitext(path)
        with open(base + "_dists" + ext, "w") as f:
            for q in range(distances.shape[0]):
                f.write(",".join(f"{float(v):.6f}" for v in distances[q]))
                f.write("\n")


def save_index_npz(path: str, arrays: dict, meta: dict) -> None:
    """Persist full index state (supersedes saveCentroids/saveCodebook,
    IO.hpp:736-772, and adds the eigenvectors the reference forgets)."""
    import json

    payload = dict(arrays)
    payload["__meta_json__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    np.savez(path, **payload)


def load_index_npz(path: str):
    import json

    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta_json__"}
        meta = json.loads(bytes(z["__meta_json__"].tobytes()).decode("utf-8"))
    return arrays, meta


# ---------------------------------------------------------------------------
# Reference-binary-format interop (migration from the C++ engine)
# ---------------------------------------------------------------------------

def save_centroids_ref(path: str, centroids_per_subs) -> None:
    """Write per-subspace centroid matrices in the reference's binary layout
    (saveCentroids, IO.hpp:736-754): u64 count; per subspace u64 rows, u64
    cols, rows*cols float32 row-major."""
    with open(path, "wb") as f:
        f.write(np.uint64(len(centroids_per_subs)).tobytes())
        for c in centroids_per_subs:
            c = np.ascontiguousarray(c, dtype=np.float32)
            f.write(np.uint64(c.shape[0]).tobytes())
            f.write(np.uint64(c.shape[1]).tobytes())
            f.write(c.tobytes())


def load_centroids_ref(path: str):
    """Read the reference's centroid artifact (loadCentroids, IO.hpp:522-549).
    Returns a list of (rows_i, cols) float32 arrays (ragged per subspace)."""
    out = []
    with open(path, "rb") as f:
        dim = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
        for _ in range(dim):
            r = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
            c = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
            data = np.frombuffer(f.read(4 * r * c), dtype=np.float32)
            out.append(data.reshape(r, c).copy())
    return out


def save_codebook_ref(path: str, codes: np.ndarray) -> None:
    """Write encoded codes in the reference's layout (saveCodebook,
    IO.hpp:756-772): u64 rows, u64 cols, rows*cols uint16 row-major."""
    codes = np.ascontiguousarray(codes, dtype=np.uint16)
    with open(path, "wb") as f:
        f.write(np.uint64(codes.shape[0]).tobytes())
        f.write(np.uint64(codes.shape[1]).tobytes())
        f.write(codes.tobytes())


def load_codebook_ref(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        r = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
        c = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
        return np.frombuffer(f.read(2 * r * c), dtype=np.uint16).reshape(r, c).copy()


def write_centroids_bolt(path: str, centroids_per_subs) -> None:
    """Bolt-interop CSV export (writeCentroidsExternalBolt, IO.hpp:574-591):
    one centroid per line, comma-separated, subspaces concatenated."""
    with open(path, "w") as f:
        for c in centroids_per_subs:
            for row in np.asarray(c, dtype=np.float32):
                f.write(",".join(f"{v:g}" for v in row))
                f.write("\n")

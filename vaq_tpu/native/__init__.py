"""Native host-runtime components with transparent numpy fallback.

Builds ``vaq_native.cpp`` (CPython C API + OpenMP) on first import via
setuptools and caches the shared object next to this file. The device compute
path never goes through here — these are the host-side pieces that are C++
in the reference too (dataset parsing, bit packing, streamed top-k merge).
If no compiler is available the numpy implementations in `vaq_tpu.binary` /
`vaq_tpu.io` are used instead; everything stays functional.
"""

from __future__ import annotations

import os
import sys
import sysconfig
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_mod = None
_tried = False


def _build() -> Optional[object]:
    """Compile + load the extension, caching the .so next to the source."""
    import importlib.util
    import subprocess

    src = os.path.join(_HERE, "vaq_native.cpp")
    so_path = os.path.join(_HERE, "vaq_native.so")
    if (not os.path.exists(so_path)
            or os.path.getmtime(so_path) < os.path.getmtime(src)):
        include = sysconfig.get_paths()["include"]
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
            "-std=c++17", f"-I{include}", src, "-o", so_path,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    spec = importlib.util.spec_from_file_location("vaq_native", so_path)
    if spec is None or spec.loader is None:
        return None
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception:
        return None
    return mod


def get() -> Optional[object]:
    """The loaded extension module, or None when unavailable."""
    global _mod, _tried
    if not _tried:
        _tried = True
        if os.environ.get("VAQ_TPU_NO_NATIVE"):
            _mod = None
        else:
            _mod = _build()
    return _mod


# ---------------------------------------------------------------------------
# numpy-signature wrappers
# ---------------------------------------------------------------------------

def pack_codes(buckets: np.ndarray, bits: np.ndarray) -> Optional[np.ndarray]:
    """Native MSB-first packer; None → caller uses the numpy path."""
    mod = get()
    if mod is None:
        return None
    buckets = np.ascontiguousarray(buckets, dtype=np.int64)
    bits = np.ascontiguousarray(bits, dtype=np.int64)
    n, d = buckets.shape
    total = int(bits.sum())
    nwords = (total + 31) // 32
    raw = mod.pack_codes(buckets.tobytes(), bits.tobytes(), n, d)
    return np.frombuffer(raw, dtype=np.uint32).reshape(n, nwords).copy()


def read_vecs(path: str, elem_dtype, max_rows=None) -> Optional[np.ndarray]:
    mod = get()
    if mod is None:
        return None
    elem_dtype = np.dtype(elem_dtype)
    try:
        body, n, dim = mod.read_vecs(path, int(elem_dtype.itemsize),
                                     -1 if max_rows is None else int(max_rows))
    except ValueError as e:
        # the C parser raises plain ValueError; re-type to the library's
        # failure surface so callers can catch FormatError uniformly
        from vaq_tpu.errors import FormatError

        raise FormatError(str(e)) from None
    return np.frombuffer(body, dtype=elem_dtype).reshape(n, dim).copy()


def merge_topk(best_d: np.ndarray, best_i: np.ndarray, new_d: np.ndarray,
               new_i: np.ndarray) -> bool:
    """In-place top-k merge; False → caller uses the numpy path."""
    mod = get()
    if mod is None:
        return False
    nq, k = best_d.shape
    m = new_d.shape[1]
    mod.merge_topk(best_d, best_i,
                   np.ascontiguousarray(new_d, np.float32).tobytes(),
                   np.ascontiguousarray(new_i, np.int32).tobytes(),
                   nq, k, m)
    return True

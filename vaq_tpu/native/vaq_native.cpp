// vaq_native — host-side native runtime components.
//
// The device compute path is JAX/XLA/Pallas; these are the *host* pieces that
// the reference implements in C++ and that stay on the CPU in any
// deployment: dataset parsing (utils/IO.hpp readers), the MSB-first
// bit-string packer of the binary engine (BitVecEngine.hpp:564-588), and the
// streaming top-k merge of the disk-resident scan (BitVecEngine.cpp:1599).
// Python falls back to numpy implementations when this extension is absent
// (vaq_tpu/native/__init__.py), so the library works without a compiler.
//
// Exposed via the CPython C API (no pybind11 in this image); all hot loops
// are OpenMP-parallel.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// pack_codes(buckets: bytes/int64 buffer (n, d), bits: int64 buffer (d,))
//   -> bytes of uint32 words (n, nwords), MSB-first layout
// ---------------------------------------------------------------------------
PyObject* pack_codes(PyObject*, PyObject* args) {
  Py_buffer buckets_buf, bits_buf;
  Py_ssize_t n, d;
  if (!PyArg_ParseTuple(args, "y*y*nn", &buckets_buf, &bits_buf, &n, &d)) {
    return nullptr;
  }
  const int64_t* buckets = static_cast<const int64_t*>(buckets_buf.buf);
  const int64_t* bits = static_cast<const int64_t*>(bits_buf.buf);

  int64_t total = 0;
  std::vector<int64_t> pos(d + 1, 0);
  for (Py_ssize_t j = 0; j < d; ++j) {
    pos[j + 1] = pos[j] + bits[j];
  }
  total = pos[d];
  const int64_t nwords = (total + 31) / 32;

  PyObject* out = PyBytes_FromStringAndSize(nullptr, n * nwords * 4);
  if (!out) {
    PyBuffer_Release(&buckets_buf);
    PyBuffer_Release(&bits_buf);
    return nullptr;
  }
  uint32_t* words = reinterpret_cast<uint32_t*>(PyBytes_AS_STRING(out));
  std::memset(words, 0, n * nwords * 4);

  Py_BEGIN_ALLOW_THREADS
#pragma omp parallel for schedule(static)
  for (Py_ssize_t i = 0; i < n; ++i) {
    uint32_t* row = words + i * nwords;
    for (Py_ssize_t j = 0; j < d; ++j) {
      const int b = static_cast<int>(bits[j]);
      if (b == 0) continue;
      const uint64_t val = static_cast<uint64_t>(buckets[i * d + j]);
      const int64_t start = pos[j];
      const int64_t w0 = start / 32, w1 = (start + b - 1) / 32;
      if (w0 == w1) {
        const int shift = 32 - static_cast<int>(start % 32) - b;
        row[w0] |= static_cast<uint32_t>(val << shift);
      } else {  // straddles a word boundary
        const int right = b - static_cast<int>((w0 + 1) * 32 - start);
        row[w0] |= static_cast<uint32_t>(val >> right);
        row[w1] |= static_cast<uint32_t>((val & ((1ull << right) - 1))
                                         << (32 - right));
      }
    }
  }
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&buckets_buf);
  PyBuffer_Release(&bits_buf);
  return out;
}

// ---------------------------------------------------------------------------
// read_vecs(path, elem_size: 4|1, max_rows: -1 for all)
//   -> (bytes body without per-record dim headers, n, dim)
// Texmex {f,b,i}vecs: each record is [int32 dim][dim * elem] (IO.hpp:91-230).
// ---------------------------------------------------------------------------
PyObject* read_vecs(PyObject*, PyObject* args) {
  const char* path;
  Py_ssize_t elem_size, max_rows;
  if (!PyArg_ParseTuple(args, "snn", &path, &elem_size, &max_rows)) {
    return nullptr;
  }
  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
    return nullptr;
  }
  int32_t dim = 0;
  if (fread(&dim, sizeof(int32_t), 1, f) != 1 || dim <= 0) {
    fclose(f);
    PyErr_Format(PyExc_ValueError, "%s: bad leading dimension", path);
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  const long fsize = ftell(f);
  const long rec = 4 + dim * elem_size;
  if (fsize % rec != 0) {
    fclose(f);
    PyErr_Format(PyExc_ValueError, "%s: size not a record multiple", path);
    return nullptr;
  }
  long n = fsize / rec;
  if (max_rows >= 0 && max_rows < n) n = max_rows;

  PyObject* out = PyBytes_FromStringAndSize(nullptr, n * dim * elem_size);
  if (!out) {
    fclose(f);
    return nullptr;
  }
  char* dst = PyBytes_AS_STRING(out);
  bool ok = true;

  Py_BEGIN_ALLOW_THREADS
  fseek(f, 0, SEEK_SET);
  std::vector<char> recbuf(rec);
  for (long i = 0; i < n && ok; ++i) {
    ok = fread(recbuf.data(), 1, rec, f) == static_cast<size_t>(rec);
    if (ok) {
      int32_t rdim;
      std::memcpy(&rdim, recbuf.data(), 4);
      ok = (rdim == dim);
      std::memcpy(dst + i * dim * elem_size, recbuf.data() + 4,
                  dim * elem_size);
    }
  }
  fclose(f);
  Py_END_ALLOW_THREADS

  if (!ok) {
    Py_DECREF(out);
    PyErr_Format(PyExc_ValueError, "%s: inconsistent records", path);
    return nullptr;
  }
  return Py_BuildValue("(Nll)", out, n, (long)dim);
}

// ---------------------------------------------------------------------------
// merge_topk(best_d, best_i, new_d, new_i, nq, k, m) in-place merge:
// keeps the k smallest of each row's (k best + m new) — the disk-resident
// chunk merge (concatenate+sort+resize, BitVecEngine.cpp:1599-1611).
// best_d/best_i are writable f32/i32 buffers (nq, k); new_* are (nq, m).
// ---------------------------------------------------------------------------
PyObject* merge_topk(PyObject*, PyObject* args) {
  Py_buffer bd, bi, nd, ni;
  Py_ssize_t nq, k, m;
  if (!PyArg_ParseTuple(args, "w*w*y*y*nnn", &bd, &bi, &nd, &ni, &nq, &k,
                        &m)) {
    return nullptr;
  }
  float* best_d = static_cast<float*>(bd.buf);
  int32_t* best_i = static_cast<int32_t*>(bi.buf);
  const float* new_d = static_cast<const float*>(nd.buf);
  const int32_t* new_i = static_cast<const int32_t*>(ni.buf);

  Py_BEGIN_ALLOW_THREADS
#pragma omp parallel for schedule(static)
  for (Py_ssize_t q = 0; q < nq; ++q) {
    std::vector<std::pair<float, int32_t>> cand;
    cand.reserve(k + m);
    for (Py_ssize_t j = 0; j < k; ++j)
      cand.emplace_back(best_d[q * k + j], best_i[q * k + j]);
    for (Py_ssize_t j = 0; j < m; ++j)
      cand.emplace_back(new_d[q * m + j], new_i[q * m + j]);
    std::partial_sort(cand.begin(), cand.begin() + k, cand.end());
    for (Py_ssize_t j = 0; j < k; ++j) {
      best_d[q * k + j] = cand[j].first;
      best_i[q * k + j] = cand[j].second;
    }
  }
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&bd);
  PyBuffer_Release(&bi);
  PyBuffer_Release(&nd);
  PyBuffer_Release(&ni);
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"pack_codes", pack_codes, METH_VARARGS,
     "MSB-first bit-string packing (n,d int64 buckets; d int64 bits)"},
    {"read_vecs", read_vecs, METH_VARARGS,
     "parse a texmex .{f,b,i}vecs file -> (body bytes, n, dim)"},
    {"merge_topk", merge_topk, METH_VARARGS,
     "in-place per-row top-k merge of streamed chunk results"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "vaq_native",
                      "native host runtime for vaq_tpu", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_vaq_native(void) { return PyModule_Create(&module); }

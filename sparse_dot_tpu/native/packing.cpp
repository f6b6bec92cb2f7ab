// Host-side packing runtime for sparse_dot_tpu.
//
// The device compute path is JAX/XLA; this library is the native
// host runtime around it — the role MKL's C layer plays for the
// reference (/root/reference/sparse_dot_mkl uses MKL for *all* native
// work; here the host-side data movement is first-party C++):
//
//   * csr_shard_rows:   row-partition a CSR matrix into S uniform
//                       padded COO shards (the ShardedCSR layout) in
//                       one pass, no per-shard scipy slicing.
//
// Built as a plain shared library (no pybind11 in the image); bound via
// ctypes in native/__init__.py with a NumPy fallback when the .so is
// missing.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Row-partition CSR (indptr/indices/data) into n_shards blocks of
// m_local rows, each padded to nnz_pad entries.  Outputs are
// preallocated (n_shards * nnz_pad).  Pad entries get row id m_local
// (dropped by the device scatter) and zero value/col.
void csr_shard_rows_f64(
    const int64_t* indptr, const int32_t* indices, const double* data,
    int64_t m, int64_t m_local, int64_t n_shards, int64_t nnz_pad,
    int32_t* out_rows, int32_t* out_cols, double* out_vals) {
  for (int64_t s = 0; s < n_shards; ++s) {
    const int64_t row_lo = s * m_local;
    const int64_t row_hi = std::min(row_lo + m_local, m);
    int64_t w = s * nnz_pad;
    for (int64_t r = row_lo; r < row_hi; ++r) {
      const int64_t lo = indptr[r], hi = indptr[r + 1];
      for (int64_t p = lo; p < hi; ++p, ++w) {
        out_rows[w] = static_cast<int32_t>(r - row_lo);
        out_cols[w] = indices[p];
        out_vals[w] = data[p];
      }
    }
    const int64_t end = (s + 1) * nnz_pad;
    for (; w < end; ++w) {
      out_rows[w] = static_cast<int32_t>(m_local);
      out_cols[w] = 0;
      out_vals[w] = 0.0;
    }
  }
}

// Max nnz over row blocks (the shard pad size).
int64_t csr_shard_nnz_pad(
    const int64_t* indptr, int64_t m, int64_t m_local, int64_t n_shards) {
  int64_t pad = 1;
  for (int64_t s = 0; s < n_shards; ++s) {
    const int64_t row_lo = std::min(s * m_local, m);
    const int64_t row_hi = std::min(row_lo + m_local, m);
    pad = std::max(pad, indptr[row_hi] - indptr[row_lo]);
  }
  return pad;
}

}  // extern "C"

"""Native host-runtime bindings (ctypes over ``packing.cpp``).

The shared library is built from ``packing.cpp`` with g++ on first use,
into ``libsdtpacking-<hash>.so`` beside the source (ignored by git).
The name carries a hash of the source, so an edited source builds a new
library and a stale one is never loaded, whatever the files' times.
Every entry point has a NumPy fallback so the package works without a
toolchain.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "packing.cpp")

_lib = None


def library_path():
    """Path of the library built from the current ``packing.cpp``."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, f"libsdtpacking-{digest}.so")


def _build(so_path):
    # Build under a temporary name and rename into place, so concurrent
    # first uses (test workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
             "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so_path = library_path()
    try:
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
    except (OSError, subprocess.CalledProcessError):
        _lib = False
        return False

    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C")

    lib.csr_shard_rows_f64.argtypes = [
        p_i64, p_i32, p_f64, i64, i64, i64, i64, p_i32, p_i32, p_f64
    ]
    lib.csr_shard_rows_f64.restype = None
    lib.csr_shard_nnz_pad.argtypes = [p_i64, i64, i64, i64]
    lib.csr_shard_nnz_pad.restype = i64

    _lib = lib
    return lib


def available():
    return bool(_load())


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def csr_shard_rows(indptr, indices, data, m, m_local, n_shards):
    """Partition CSR arrays into padded COO shards.

    Returns (rows, cols, vals) each (n_shards, nnz_pad); float64 path
    uses the native library, other dtypes fall back to NumPy.
    """
    lib = _load()
    indptr = _as_i64(indptr)
    if lib and data.dtype == np.float64:
        indices32 = _as_i32(indices)
        data = np.ascontiguousarray(data)
        nnz_pad = int(lib.csr_shard_nnz_pad(indptr, m, m_local, n_shards))
        rows = np.empty((n_shards, nnz_pad), np.int32)
        cols = np.empty((n_shards, nnz_pad), np.int32)
        vals = np.empty((n_shards, nnz_pad), np.float64)
        lib.csr_shard_rows_f64(
            indptr, indices32, data, m, m_local, n_shards, nnz_pad,
            rows, cols, vals,
        )
        return rows, cols, vals

    # NumPy fallback
    row_of = np.repeat(
        np.arange(m, dtype=np.int64), np.diff(indptr)
    )
    nnz_pad = 1
    pieces = []
    for s in range(n_shards):
        lo, hi = s * m_local, min((s + 1) * m_local, m)
        plo, phi = indptr[lo], indptr[hi] if hi <= m else indptr[-1]
        pieces.append(
            (row_of[plo:phi] - lo, indices[plo:phi], data[plo:phi])
        )
        nnz_pad = max(nnz_pad, phi - plo)
    rows = np.full((n_shards, nnz_pad), m_local, np.int32)
    cols = np.zeros((n_shards, nnz_pad), np.int32)
    vals = np.zeros((n_shards, nnz_pad), data.dtype)
    for s, (r, c, v) in enumerate(pieces):
        rows[s, : r.size] = r
        cols[s, : c.size] = c
        vals[s, : v.size] = v
    return rows, cols, vals



"""Native host-packing library: built from ``packing.cpp`` on first use,
keyed on the source's hash, and equal to the NumPy fallback."""

import hashlib
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sps

from sparse_dot_tpu import native


@pytest.fixture
def csr():
    return sps.random(103, 57, density=0.1, format="csr", dtype=np.float64,
                      random_state=0)


def test_library_builds_from_source():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    assert native.available()
    path = native.library_path()
    assert os.path.exists(path)
    with open(os.path.join(os.path.dirname(native.__file__),
                           "packing.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.basename(path) == f"libsdtpacking-{digest}.so"


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_native_matches_numpy_fallback(csr, n_shards, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    m = csr.shape[0]
    m_local = -(-m // n_shards)
    got = native.csr_shard_rows(csr.indptr, csr.indices, csr.data, m,
                                m_local, n_shards)
    monkeypatch.setattr(native, "_lib", False)  # force the fallback
    ref = native.csr_shard_rows(csr.indptr, csr.indices, csr.data, m,
                                m_local, n_shards)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_shards_reassemble(csr):
    m = csr.shape[0]
    rows, cols, vals = native.csr_shard_rows(csr.indptr, csr.indices,
                                             csr.data, m, 26, 4)
    dense = np.zeros(csr.shape)
    for s in range(4):
        live = rows[s] < 26
        np.add.at(dense, (rows[s][live] + 26 * s, cols[s][live]),
                  vals[s][live])
    np.testing.assert_allclose(dense, csr.toarray())

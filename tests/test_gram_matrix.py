"""Gram matrix (syrk) behavior — upper-triangular output, ``dense=``,
``out`` accumulation, the CSC-needs-cast rule, and complex rejection.

Covers the same contract as the reference gram suite
(``/root/reference/sparse_dot_mkl/_gram_matrix.py:252-335``) as a
parametrized matrix over dtype x transpose x input kind instead of one
class per axis.  Oracle: ``np.triu(op(A) @ op(A)^T-or-T)``.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps

from sparse_dot_tpu import gram_matrix

from .common import MATRIX_1, np_almost_equal

DENSE_1 = MATRIX_1.toarray()


def _oracle(transpose, dtype):
    d = DENSE_1.astype(dtype)
    full = d @ d.T if transpose else d.T @ d
    return np.triu(full)


def _decimal(dtype):
    return 5 if np.dtype(dtype) == np.float32 else 6


DTYPES = [np.float64, np.float32]
SPARSE_CLASSES = [sps.csr_matrix]
if hasattr(sps, "csr_array"):
    SPARSE_CLASSES.append(sps.csr_array)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("transpose", [False, True], ids=["ata", "aat"])
@pytest.mark.parametrize(
    "klass", SPARSE_CLASSES, ids=[c.__name__ for c in SPARSE_CLASSES]
)
def test_sparse_in_sparse_out(dtype, transpose, klass):
    A = klass(MATRIX_1.astype(dtype))
    got = gram_matrix(A, transpose=transpose)
    assert sps.issparse(got)
    np_almost_equal(got.toarray(), _oracle(transpose, dtype),
                    decimal=_decimal(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("transpose", [False, True], ids=["ata", "aat"])
def test_sparse_in_dense_out(dtype, transpose):
    A = MATRIX_1.astype(dtype)
    got = gram_matrix(A, transpose=transpose, dense=True)
    np_almost_equal(got, _oracle(transpose, dtype),
                    decimal=_decimal(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_sparse_dense_out_accumulate(dtype):
    """dense=True with out: syrkd accumulates the FULL product into out
    (the reference zeroes the lower triangle only on the out=None
    path, ``_gram_matrix.py:164-169``)."""
    A = MATRIX_1.astype(dtype)
    n = A.shape[1]
    out = np.zeros((n, n), dtype=dtype)
    got = gram_matrix(A, dense=True, out=out, out_scalar=1.0)
    assert got is out
    got = got.copy()
    got[np.tril_indices(n, k=-1)] = 0.0
    np_almost_equal(got, _oracle(False, dtype), decimal=_decimal(dtype))


def test_out_wrong_dtype_raises():
    A = MATRIX_1.astype(np.float32)
    with pytest.raises(ValueError):
        gram_matrix(
            A, dense=True,
            out=np.zeros((A.shape[1], A.shape[1]), dtype=np.float64),
            out_scalar=1.0,
        )


def test_sparse_output_rejects_out():
    with pytest.raises(ValueError):
        gram_matrix(
            MATRIX_1,
            out=np.zeros((MATRIX_1.shape[0], MATRIX_1.shape[0])),
        )


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_csc_requires_cast(dense):
    csc = MATRIX_1.tocsc()
    with pytest.raises(ValueError):
        gram_matrix(csc, dense=dense)
    got = gram_matrix(csc, dense=dense, cast=True)
    got = got.toarray() if sps.issparse(got) else got
    np_almost_equal(got, _oracle(False, np.float64))
    # the input must not have been mutated
    np_almost_equal(csc.toarray(), DENSE_1)


def test_complex_rejected():
    with pytest.raises(ValueError):
        gram_matrix(MATRIX_1.astype(np.complex128))


def test_bsr_rejected():
    with pytest.raises(ValueError):
        gram_matrix(MATRIX_1.tobsr(blocksize=(10, 10)))


# -- dense input (cblas_?syrk analog) ---------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("transpose", [False, True], ids=["ata", "aat"])
def test_dense_input(dtype, order, transpose):
    d = np.asarray(DENSE_1.astype(dtype), order=order)
    got = gram_matrix(d, dense=True, transpose=transpose)
    np_almost_equal(got, _oracle(transpose, dtype),
                    decimal=_decimal(dtype))


@pytest.mark.parametrize("order", ["C", "F"])
def test_dense_input_out_accumulate(order):
    d = np.asarray(DENSE_1, order=order)
    n = d.shape[1]
    out = np.zeros((n, n), order=order)
    got = gram_matrix(d, dense=True, out=out, out_scalar=1.0)
    assert got is out
    np_almost_equal(got, _oracle(False, np.float64))


def test_empty_input_shape_rule():
    # The reference's empty path uses the transposed selector for the
    # output shape (``_gram_matrix.py:269-274``) — preserved quirk.
    empty = sps.csr_matrix((200, 300), dtype=np.float64)
    got = gram_matrix(empty)
    assert got.shape == (200, 200)
    got_t = gram_matrix(empty, transpose=True)
    assert got_t.shape == (300, 300)


# -- SYPR triple product (working version of the reference's dead
#    ``_sparse_sypr.py`` driver) --------------------------------------------


class TestSypr:
    def setup_method(self):
        self.A = MATRIX_1.copy()
        m = self.A.shape[0]
        B = sps.random(m, m, density=0.1, format="csr", random_state=7)
        self.B = (B + B.T).tocsr()

    def test_sypr_atba(self):
        from sparse_dot_tpu import sypr

        got = sypr(self.A, self.B)
        ref = DENSE_1.T @ self.B.toarray() @ DENSE_1
        np_almost_equal(got.toarray(), np.triu(ref))

    def test_sypr_abat(self):
        from sparse_dot_tpu import sypr

        k = self.A.shape[1]
        B = sps.random(k, k, density=0.1, format="csr", random_state=8)
        B = (B + B.T).tocsr()
        got = sypr(self.A, B, transpose=True, dense=True)
        ref = DENSE_1 @ B.toarray() @ DENSE_1.T
        np_almost_equal(got, np.triu(ref))

    def test_sypr_bsr_operands(self):
        """BSR A/B run through the CSR chain (review r5: BSR A crashed
        on the device container's missing transpose view)."""
        from sparse_dot_tpu import sypr

        A = self.A.tobsr(blocksize=(2, 2))
        B = self.B.tobsr(blocksize=(2, 2))
        got = sypr(A, B)
        ref = DENSE_1.T @ self.B.toarray() @ DENSE_1
        np_almost_equal(got.toarray(), np.triu(ref))

    def test_sypr_guards(self):
        from sparse_dot_tpu import sypr

        with pytest.raises(ValueError):
            sypr(self.A.tocoo(), self.B)
        with pytest.raises(ValueError):
            sypr(self.A, self.B, transpose=True)  # shape mismatch

    def test_sypr_structural_explicit_zeros(self):
        """Exactly-cancelled entries stay as explicit zeros — sypr
        honors the same structural-pattern contract as every other
        SpGEMM path."""
        from sparse_dot_tpu import sypr

        A = sps.csr_matrix(np.array([[1.0], [1.0]]))  # 2 x 1
        B = sps.csr_matrix(np.array([[1.0, -1.0], [-1.0, 1.0]]))
        got = sypr(A, B)  # A^T B A = [[0.0]] with a structural entry
        assert got.shape == (1, 1)
        assert got.nnz == 1
        np.testing.assert_array_equal(got.data, [0.0])

    def test_sypr_50k_rows_no_dense_intermediate(self):
        """A 50k-row triple product must not materialize any dense
        m x k or m x m intermediate (20 GB each) — the chained
        sparse-output driver routes blocked/ESC above the budget."""
        from sparse_dot_tpu import sypr

        m = 50_000
        rng = np.random.default_rng(42)
        nnz = 60_000
        A = sps.csr_matrix(
            (rng.standard_normal(nnz),
             (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
            shape=(m, m),
        )
        A.sum_duplicates()
        # COO-from-integers, NOT sps.random: scipy's no-replacement
        # sampling over the 2.5e9-cell index space takes minutes.
        nnzb = 50_000
        B = sps.csr_matrix(
            (rng.standard_normal(nnzb),
             (rng.integers(0, m, nnzb), rng.integers(0, m, nnzb))),
            shape=(m, m),
        )
        B.sum_duplicates()
        B = (B + B.T).tocsr()
        got = sypr(A, B)
        oracle = sps.triu(A.T @ B @ A, format="csr")
        assert got.shape == (m, m)
        diff = np.abs((got - oracle)).max() if got.nnz + oracle.nnz else 0.0
        assert diff < 1e-9


class TestGramComplexExtension:
    """``allow_complex=True`` — an extension: the reference rejects
    complex only to paper over an MKL syrk bug
    (``_gram_matrix.py:296-299``); the planar path here has no such
    bug.  Default behavior (reject) is reference parity and covered
    elsewhere."""

    def setup_method(self):
        X = sps.random(90, 140, density=0.08, format="csr",
                       random_state=31)
        self.A = (X + 0.5j * X).astype(np.complex128).tocsr()

    def test_sparse_output(self):
        from sparse_dot_tpu import gram_matrix

        G = gram_matrix(self.A, allow_complex=True)
        np_almost_equal(
            G.toarray(), np.triu((self.A.T @ self.A).toarray())
        )

    def test_transpose_dense_output(self):
        from sparse_dot_tpu import gram_matrix

        G = gram_matrix(self.A, transpose=True, dense=True,
                        allow_complex=True)
        np_almost_equal(G, np.triu((self.A @ self.A.T).toarray()))

    def test_default_still_rejects(self):
        from sparse_dot_tpu import gram_matrix

        with pytest.raises(ValueError):
            gram_matrix(self.A)

    def test_dense_complex_input(self):
        """Dense complex operands run the planar unconjugated product
        too (review r5: the raw complex upload crashed on backends
        without native complex)."""
        from sparse_dot_tpu import gram_matrix

        X = np.asarray(self.A.todense())
        G = gram_matrix(X, allow_complex=True)
        np_almost_equal(G, np.triu(X.T @ X))
        G2 = gram_matrix(X, transpose=True, allow_complex=True)
        np_almost_equal(G2, np.triu(X @ X.T))


def test_empty_device_container_returns_sparse():
    """The empty-output path must keep the sparse result type for
    device containers, like their scipy counterparts (review r5: they
    fell through to dense np.zeros)."""
    from sparse_dot_tpu import gram_matrix
    from sparse_dot_tpu import formats

    C = formats.to_device(sps.csr_matrix((5, 3), dtype=np.float64))
    res = gram_matrix(C)
    assert sps.issparse(res)
    assert res.nnz == 0

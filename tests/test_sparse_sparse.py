"""sparse @ sparse (SpGEMM) suite — models the reference's
``tests/test_sparse_sparse.py`` inheritance matrix: a CSR/float64 base
class with CSC/BSR, float32, complex, and scipy-array-class axes."""

import unittest

import numpy as np
import scipy.sparse as sps

from sparse_dot_tpu import dot_product_mkl

from .common import MATRIX_1, MATRIX_2, make_matrixes, np_almost_equal


class TestMultiplicationCSR(unittest.TestCase):
    sparse_func = sps.csr_matrix
    sparse_args = {}
    output_format = "csr"

    double_dtype = np.float64
    single_dtype = np.float32

    @classmethod
    def setUpClass(cls):
        cls.MATRIX_1, cls.MATRIX_2 = MATRIX_1.copy(), MATRIX_2.copy()

    def setUp(self):
        self.mat1 = self.sparse_func(self.MATRIX_1, **self.sparse_args).copy()
        self.mat2 = self.sparse_func(self.MATRIX_2, **self.sparse_args).copy()

    def test_dot_product(self):
        mat3 = dot_product_mkl(self.mat1, self.mat2)
        self.assertEqual(mat3.format, self.output_format)
        np_almost_equal(mat3, self.mat1.dot(self.mat2))
        np_almost_equal(
            np.dot(self.mat1.toarray(), self.mat2.toarray()), mat3
        )

    def test_dot_product_reorder(self):
        mat3 = dot_product_mkl(self.mat1, self.mat2, reorder_output=True)
        np_almost_equal(mat3, self.mat1.dot(self.mat2))

    def test_error_bad_dims(self):
        with self.assertRaises(ValueError):
            dot_product_mkl(self.mat1.transpose(), self.mat2)

    def test_all_zeros(self):
        zero_mat_1 = self.sparse_func((50, 100))
        zero_mat_2 = self.sparse_func((100, 20))
        zm_sp = zero_mat_1.dot(zero_mat_2)
        zm = dot_product_mkl(zero_mat_1, zero_mat_2)
        self.assertTupleEqual(zm_sp.shape, zm.shape)
        self.assertEqual(len(zm.data), 0)

    def test_highly_sparse(self):
        hsp1, hsp2 = make_matrixes(
            2000, 1000, 3000, 0.0005, dtype=self.double_dtype
        )
        hsp1 = self.sparse_func(hsp1, **self.sparse_args)
        hsp2 = self.sparse_func(hsp2, **self.sparse_args)
        np_almost_equal(dot_product_mkl(hsp1, hsp2), hsp1.dot(hsp2))

    def test_dense_input_matrices(self):
        d1, d2 = make_matrixes(10, 20, 50, 1, dtype=self.double_dtype)
        d1 = self.sparse_func(d1, **self.sparse_args)
        d2 = self.sparse_func(d2, **self.sparse_args)
        hsp3 = dot_product_mkl(d1, d2)
        np_almost_equal(hsp3, d1.dot(d2))
        self.assertEqual(hsp3.dtype, self.double_dtype)

    def test_mixed_format_csc_right(self):
        d1, d2 = self.mat1, sps.csc_matrix(self.mat2)
        hsp3 = dot_product_mkl(d1, d2)
        np_almost_equal(hsp3, d1.dot(d2))
        self.assertEqual(hsp3.dtype, self.double_dtype)

    def test_COO_rejected(self):
        with self.assertRaises(ValueError):
            dot_product_mkl(self.mat1, sps.coo_matrix(self.mat2))

    def test_mixed_cast(self):
        d1 = self.mat1.astype(self.single_dtype)
        hsp3 = dot_product_mkl(d1, self.mat2, cast=True)
        np_almost_equal(hsp3, d1.dot(self.mat2), decimal=5)
        self.assertEqual(hsp3.dtype, self.double_dtype)

    def test_mixed_nocast(self):
        with self.assertRaises(ValueError):
            dot_product_mkl(
                self.mat1, self.mat2.astype(self.single_dtype), cast=False
            )

    def test_float32(self):
        d1 = self.mat1.astype(self.single_dtype)
        d2 = self.mat2.astype(self.single_dtype)
        hsp3 = dot_product_mkl(d1, d2)
        np_almost_equal(hsp3, d1.dot(d2), decimal=5)
        self.assertEqual(hsp3.dtype, self.single_dtype)

    def test_dense_output(self):
        mat3 = dot_product_mkl(self.mat1, self.mat2, dense=True)
        self.assertIsInstance(mat3, np.ndarray)
        np_almost_equal(mat3, self.mat1.dot(self.mat2))

    def test_dense_output_out(self):
        ref = np.dot(self.mat1.toarray(), self.mat2.toarray()).astype(
            self.double_dtype
        )
        out_arr = np.empty_like(ref)
        mat3 = dot_product_mkl(self.mat1, self.mat2, dense=True, out=out_arr)
        np_almost_equal(ref, out_arr)
        self.assertEqual(id(mat3), id(out_arr))

    def test_out_without_dense_raises(self):
        with self.assertRaises(ValueError):
            dot_product_mkl(
                self.mat1, self.mat2,
                out=np.zeros((200, 100), dtype=self.double_dtype),
            )

    def test_bad_outs(self):
        ref = np.dot(self.mat1.toarray(), self.mat2.toarray())
        with self.assertRaises(ValueError):
            dot_product_mkl(
                self.mat1, self.mat2, dense=True,
                out=np.empty_like(ref, dtype=np.float32)
                if self.double_dtype == np.float64
                else np.empty_like(ref, dtype=np.float64),
            )
        with self.assertRaises(ValueError):
            dot_product_mkl(
                self.mat1, self.mat2, dense=True,
                out=np.empty_like(ref, order="F"),
            )
        with self.assertRaises(ValueError):
            dot_product_mkl(
                self.mat1, self.mat2, dense=True,
                out=np.empty((1, 1), dtype=self.double_dtype),
            )


class TestMultiplicationCSC(TestMultiplicationCSR):
    sparse_func = sps.csc_matrix
    output_format = "csc"


class TestMultiplicationBSR(TestMultiplicationCSR):
    sparse_func = sps.bsr_matrix
    sparse_args = {"blocksize": (10, 10)}
    output_format = "bsr"


class _ComplexMixin:
    double_dtype = np.cdouble
    single_dtype = np.csingle

    @classmethod
    def setUpClass(cls):
        cls.MATRIX_1, cls.MATRIX_2 = make_matrixes(
            200, 100, 300, 0.05, dtype=np.cdouble
        )


class TestMultiplicationCSRComplex(_ComplexMixin, TestMultiplicationCSR):
    pass


class TestMultiplicationCSCComplex(_ComplexMixin, TestMultiplicationCSC):
    pass


try:
    from scipy.sparse import csr_array

    class TestMultiplicationCSRArray(TestMultiplicationCSR):
        sparse_func = csr_array

        def test_output_class_matches(self):
            mat3 = dot_product_mkl(
                self.sparse_func(self.mat1), self.sparse_func(self.mat2)
            )
            self.assertIsInstance(mat3, csr_array)

except ImportError:
    pass



# Planar-storage reruns: the decomposition every complex op uses without
# native complex
# (see tests.common.ForcePlanarMixin).
from .common import ForcePlanarMixin


class TestMultiplicationCSRComplexPlanar(
    ForcePlanarMixin, TestMultiplicationCSRComplex
):
    pass


class TestMultiplicationCSCComplexPlanar(
    ForcePlanarMixin, TestMultiplicationCSCComplex
):
    pass


if __name__ == "__main__":
    unittest.main()


class TestBlockedSpGEMM(unittest.TestCase):
    """Row-blocked numeric phase for products too large for one dense
    intermediate — forced small thresholds to exercise the path."""

    def test_blocked_matches_direct(self):
        from sparse_dot_tpu.ops import host as hops

        old_block, old_thresh = (
            hops._SPGEMM_ROW_BLOCK, hops._BLOCKED_SPGEMM_BYTES
        )
        hops._SPGEMM_ROW_BLOCK = 64
        hops._BLOCKED_SPGEMM_BYTES = 1024
        try:
            m1, m2 = MATRIX_1.copy(), MATRIX_2.copy()
            res = dot_product_mkl(m1, m2)
            np_almost_equal(res, m1 @ m2)

            # triangular (gram) through the blocked path
            from sparse_dot_tpu import gram_matrix_mkl

            g = gram_matrix_mkl(m1)
            ref = (m1.T @ m1).toarray()
            ref[np.tril_indices(ref.shape[0], k=-1)] = 0
            np_almost_equal(g.toarray(), ref)
        finally:
            hops._SPGEMM_ROW_BLOCK = old_block
            hops._BLOCKED_SPGEMM_BYTES = old_thresh

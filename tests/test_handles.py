"""Handle-layer parity suite — create/export round trips, conversion,
ordering, destruction errors; models the reference's ``TestHandles`` and
handle failure tests (``tests/test_mkl.py:103-268``)."""

import unittest

import numpy as np
import numpy.testing as npt
import scipy.sparse as sps

from sparse_dot_tpu.interface import (
    create_sparse_handle,
    export_sparse_handle,
    convert_to_csr,
    order_sparse_handle,
    destroy_sparse_handle,
    matmul_handles,
    sparse_handle_t,
)

from .common import MATRIX_1, MATRIX_2, np_almost_equal


class TestHandles(unittest.TestCase):
    def setUp(self):
        self.mat1 = MATRIX_1.copy()
        self.mat2 = MATRIX_2.copy()

    def test_create_export_csr(self):
        handle, dbl, cplx = create_sparse_handle(self.mat1)
        self.assertTrue(dbl)
        self.assertFalse(cplx)
        cycle = export_sparse_handle(handle, dbl, output_type="csr_matrix")
        npt.assert_array_almost_equal(cycle.data, self.mat1.data)
        npt.assert_array_equal(cycle.indices, self.mat1.indices)
        npt.assert_array_equal(cycle.indptr, self.mat1.indptr)

    def test_create_export_csc(self):
        m = self.mat1.tocsc()
        handle, dbl, cplx = create_sparse_handle(m)
        cycle = export_sparse_handle(handle, dbl, output_type="csc_matrix")
        np_almost_equal(cycle, self.mat1)

    def test_create_export_f32(self):
        m = self.mat1.astype(np.float32)
        handle, dbl, cplx = create_sparse_handle(m)
        self.assertFalse(dbl)
        cycle = export_sparse_handle(handle, dbl)
        np_almost_equal(cycle, m)

    def test_create_export_bsr(self):
        m = self.mat1.tobsr(blocksize=(2, 2))
        handle, dbl, cplx = create_sparse_handle(m)
        cycle = export_sparse_handle(handle, dbl, output_type="bsr_matrix")
        np_almost_equal(cycle, self.mat1)
        npt.assert_array_equal(m.data, cycle.data)

    def test_convert_bsr_to_csr(self):
        m = self.mat1.tobsr(blocksize=(2, 2))
        handle, dbl, cplx = create_sparse_handle(m)
        csr_handle = convert_to_csr(handle)
        cycle = export_sparse_handle(csr_handle, dbl,
                                     output_type="csr_matrix")
        np_almost_equal(cycle, self.mat1)

    def test_convert_csc_to_csr(self):
        m = self.mat1.tocsc()
        handle, dbl, cplx = create_sparse_handle(m)
        csr_handle = convert_to_csr(handle)
        cycle = export_sparse_handle(csr_handle, dbl,
                                     output_type="csr_matrix")
        np_almost_equal(cycle, self.mat1)

    def test_order(self):
        shuffled = self.mat1.copy()
        # Reverse the column order within each row to unsort indices.
        for i in range(shuffled.shape[0]):
            s, e = shuffled.indptr[i], shuffled.indptr[i + 1]
            shuffled.indices[s:e] = shuffled.indices[s:e][::-1]
            shuffled.data[s:e] = shuffled.data[s:e][::-1]
        handle, dbl, _ = create_sparse_handle(shuffled)
        order_sparse_handle(handle)
        cycle = export_sparse_handle(handle, dbl)
        np_almost_equal(cycle, self.mat1)
        self.assertTrue(
            all(
                np.all(np.diff(cycle.indices[cycle.indptr[i]:
                                             cycle.indptr[i + 1]]) > 0)
                for i in range(cycle.shape[0])
            )
        )

    def test_export_bad_type(self):
        handle, dbl, cplx = create_sparse_handle(self.mat1)
        with self.assertRaises(ValueError):
            export_sparse_handle(handle, dbl, output_type="coo")
        destroy_sparse_handle(handle)

    def test_empty_handle_errors(self):
        empty = sparse_handle_t()
        with self.assertRaises(ValueError):
            export_sparse_handle(empty, True, output_type="csr_matrix")
        with self.assertRaises(ValueError):
            convert_to_csr(empty)
        with self.assertRaises(ValueError):
            order_sparse_handle(empty)
        with self.assertRaises(ValueError):
            destroy_sparse_handle(empty)

    def test_create_bad_type(self):
        with self.assertRaises(ValueError):
            create_sparse_handle(self.mat1.tocoo())
        with self.assertRaises(ValueError):
            create_sparse_handle(self.mat1.astype(np.int64))

    def test_matmul_handles(self):
        h1, _, _ = create_sparse_handle(self.mat1)
        h2, _, _ = create_sparse_handle(self.mat2)
        h3 = matmul_handles(h1, h2)
        out = export_sparse_handle(h3, True)
        np_almost_equal(out, self.mat1 @ self.mat2)

    def test_matmul_handles_bad_dims(self):
        h1, _, _ = create_sparse_handle(
            sps.csr_matrix(self.mat1.T)
        )
        h2, _, _ = create_sparse_handle(self.mat2)
        with self.assertRaises(ValueError):
            matmul_handles(h1, h2)

    def test_matmul_handles_empty(self):
        with self.assertRaises(ValueError):
            matmul_handles(sparse_handle_t(), sparse_handle_t())


class TestHandlesPlanarComplex(unittest.TestCase):
    """Handle round-trips with planar complex storage forced (the
    representation without native complex): create/export and the
    device CSC->CSR conversion must preserve complex values
    bit-for-bit through the split."""

    def setUp(self):
        from sparse_dot_tpu.config import config
        from sparse_dot_tpu import formats

        self._prev = config.force_planar_complex
        config.force_planar_complex = True
        formats.clear_transfer_cache()
        self.mat = (MATRIX_1 + 1j * MATRIX_1.multiply(0.25)).tocsr()
        self.mat = self.mat.astype(np.complex128)

    def tearDown(self):
        from sparse_dot_tpu.config import config
        from sparse_dot_tpu import formats

        config.force_planar_complex = self._prev
        formats.clear_transfer_cache()

    def test_planar_create_export_roundtrip(self):
        handle, dbl, cplx = create_sparse_handle(self.mat)
        self.assertTrue(handle.container.planar)
        self.assertTrue(dbl and cplx)
        back = export_sparse_handle(handle, output_type="csr_matrix")
        npt.assert_array_equal(back.toarray(), self.mat.toarray())

    def test_planar_convert_csc_to_csr(self):
        handle, _, _ = create_sparse_handle(self.mat.tocsc())
        csr_handle = convert_to_csr(handle)
        self.assertTrue(csr_handle.container.planar)
        back = export_sparse_handle(csr_handle, output_type="csr_matrix")
        npt.assert_array_almost_equal(
            back.toarray(), self.mat.toarray(), decimal=12
        )


if __name__ == "__main__":
    unittest.main()

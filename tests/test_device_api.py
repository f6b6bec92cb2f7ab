"""Pure-device (jit-resident) API tests: containers as pytrees through
jit, ILP64 index width, transfer cache behavior, device format
conversion."""

import unittest

import numpy as np
import numpy.testing as npt
import scipy.sparse as sps

import jax
import jax.numpy as jnp

import sparse_dot_tpu as sdt
from sparse_dot_tpu import formats
from sparse_dot_tpu.config import config
from sparse_dot_tpu.ops import _xla
from sparse_dot_tpu.ops.host import coo_parts

from .common import MATRIX_1, np_almost_equal


class TestDeviceContainers(unittest.TestCase):
    def setUp(self):
        self.A = MATRIX_1.copy()

    def test_container_through_jit(self):
        A = formats.to_device(self.A)
        b = jnp.asarray(
            np.random.default_rng(0).random(self.A.shape[1])
        )

        @jax.jit
        def spmv(container, x):
            rows = container.row_indices()
            return _xla.coo_spmv(
                rows, container.indices, container.data, x,
                m=container.shape[0],
            )

        y = spmv(A, b)
        np_almost_equal(np.asarray(y), self.A.toarray() @ np.asarray(b))

    def test_container_transpose_view(self):
        A = formats.to_device(self.A)
        At = A.T
        self.assertIsInstance(At, formats.CSC)
        self.assertEqual(At.shape, (self.A.shape[1], self.A.shape[0]))
        back = At.T
        self.assertIsInstance(back, formats.CSR)

    def test_dot_product_accepts_device_container(self):
        A = formats.to_device(self.A)
        b = np.random.default_rng(1).random((self.A.shape[1], 8))
        res = sdt.dot_product(A, b)
        np_almost_equal(res, self.A.toarray() @ b)

    def test_tree_flatten_roundtrip(self):
        A = formats.to_device(self.A.tobsr(blocksize=(10, 10)))
        leaves, treedef = jax.tree_util.tree_flatten(A)
        A2 = jax.tree_util.tree_unflatten(treedef, leaves)
        self.assertEqual(A2.blocksize, (10, 10))
        self.assertEqual(A2.shape, A.shape)

    def test_device_csc_to_csr_conversion(self):
        csc = formats.to_device(self.A.tocsc())
        from sparse_dot_tpu.interface import convert_container_to_csr

        csr = convert_container_to_csr(csc)
        np_almost_equal(csr.to_scipy().toarray(), self.A.toarray())


class TestILP64(unittest.TestCase):
    def tearDown(self):
        sdt.set_interface_layer("LP64")
        formats.clear_transfer_cache()

    def test_int64_indices(self):
        sdt.set_interface_layer("ILP64")
        formats.clear_transfer_cache()
        A = formats.to_device(MATRIX_1.copy())
        self.assertEqual(A.indices.dtype, jnp.int64)
        b = np.random.default_rng(0).random((MATRIX_1.shape[1], 4))
        res = sdt.dot_product(MATRIX_1.copy(), b)
        np_almost_equal(res, MATRIX_1.toarray() @ b)

    def test_full_product_matrix_under_ilp64(self):
        sdt.set_interface_layer("ILP64")
        formats.clear_transfer_cache()
        m2 = sps.random(300, 40, density=0.1, format="csr",
                        random_state=3)
        res = sdt.dot_product(MATRIX_1.copy(), m2)
        np_almost_equal(res, (MATRIX_1 @ m2))


class TestTransferCache(unittest.TestCase):
    def test_cache_hit_same_object(self):
        A = MATRIX_1.copy()
        c1 = formats.to_device(A)
        c2 = formats.to_device(A)
        self.assertIs(c1, c2)

    def test_cache_invalidated_on_mutation(self):
        A = MATRIX_1.copy()
        c1 = formats.to_device(A)
        A.data[: 10] += 1.0
        c2 = formats.to_device(A)
        self.assertIsNot(c1, c2)
        npt.assert_allclose(np.asarray(c2.data)[:10], A.data[:10])

    def test_cache_disabled(self):
        config.device_transfer_cache = False
        try:
            A = MATRIX_1.copy()
            c1 = formats.to_device(A)
            c2 = formats.to_device(A)
            self.assertIsNot(c1, c2)
        finally:
            config.device_transfer_cache = True


class TestBSRBatchedProduct(unittest.TestCase):
    """The batched block product (``_xla.bsr_spmm``) that every BSR SpMM
    takes, at the 128x128 f32 blocks of the BSR benchmark shape."""

    @staticmethod
    def _case(bs=128, nbr=4, nbc=3, density=0.5, n=130, seed=0):
        rng = np.random.default_rng(seed)
        pat = sps.random(nbr, nbc, density=density, format="csr",
                         random_state=seed + 1)
        pat.sort_indices()
        data = rng.standard_normal((pat.nnz, bs, bs)).astype(np.float32)
        A = sps.bsr_matrix((data, pat.indices, pat.indptr),
                           shape=(nbr * bs, nbc * bs))
        b = rng.standard_normal((nbc * bs, n)).astype(np.float32)
        rows = np.repeat(np.arange(nbr), np.diff(pat.indptr))
        return A, b, data, rows, pat.indices

    def test_bsr_spmm_bs128_f32(self):
        A, b, data, rows, cols = self._case()
        out = _xla.bsr_spmm(jnp.asarray(data), jnp.asarray(rows),
                            jnp.asarray(cols), jnp.asarray(b),
                            m=A.shape[0])
        ref = A.astype(np.float64) @ b.astype(np.float64)
        self.assertEqual(out.dtype, jnp.float32)
        npt.assert_allclose(np.asarray(out), ref, rtol=1e-5,
                            atol=1e-5 * np.abs(ref).max())

    def test_bsr_spmm_bs128_f32_accumulate(self):
        A, b, data, rows, cols = self._case(seed=3)
        c0 = np.random.default_rng(4).standard_normal(
            (A.shape[0], b.shape[1])).astype(np.float32)
        out = _xla.bsr_spmm(jnp.asarray(data), jnp.asarray(rows),
                            jnp.asarray(cols), jnp.asarray(b),
                            m=A.shape[0], alpha=2.0, beta=0.5,
                            c0=jnp.asarray(c0))
        ref = (2.0 * (A.astype(np.float64) @ b.astype(np.float64))
               + 0.5 * c0.astype(np.float64))
        npt.assert_allclose(np.asarray(out), ref, rtol=1e-5,
                            atol=1e-5 * np.abs(ref).max())

    def test_bsr_spmm_empty_block_rows(self):
        bs = 128
        # only block (1, 2) stored; block rows 0, 2, 3 are empty
        data = np.ones((1, bs, bs), np.float32)
        b = np.ones((4 * bs, 64), np.float32)
        out = np.asarray(
            _xla.bsr_spmm(jnp.asarray(data), jnp.asarray([1]),
                          jnp.asarray([2]), jnp.asarray(b), m=4 * bs)
        )
        npt.assert_allclose(out[:bs], 0.0)
        npt.assert_allclose(out[bs:2 * bs], float(bs))
        npt.assert_allclose(out[2 * bs:], 0.0)

    def test_dot_product_bsr_bs128_f32_out(self):
        """Public path: 128x128 f32 BSR with out=/out_scalar= takes the
        batched product (the only BSR SpMM route)."""
        A, b, _, _, _ = self._case(seed=5)
        out = np.random.default_rng(6).standard_normal(
            (A.shape[0], b.shape[1])).astype(np.float32)
        ref = (A.astype(np.float64) @ b.astype(np.float64)
               + 2.0 * out.astype(np.float64))
        calls = []
        orig = _xla.bsr_spmm

        def spy(*args, **kwargs):
            calls.append(1)
            return orig(*args, **kwargs)

        _xla.bsr_spmm = spy
        try:
            res = sdt.dot_product(A, b, out=out, out_scalar=2.0)
        finally:
            _xla.bsr_spmm = orig
        self.assertIs(res, out)
        self.assertEqual(len(calls), 1)
        npt.assert_allclose(res, ref, rtol=1e-5,
                            atol=1e-5 * np.abs(ref).max())


if __name__ == "__main__":
    unittest.main()

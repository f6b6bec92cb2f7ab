"""Per-row padded (ELL) SpMM/SpMV path: the scatter-free kernel
layout.  Forced on with ``config.ell_spmm_enabled = "always"`` so the
path runs on the CPU test backend; results checked against the scipy
oracle like every other op suite (reference strategy,
``/root/reference/tests/test_sparse_dense.py``)."""

import unittest

import numpy as np
import scipy.sparse as sps

from sparse_dot_tpu import dot_product
from sparse_dot_tpu import formats
from sparse_dot_tpu.config import config
from sparse_dot_tpu.ops import _xla, host as hops


class _ForceEll(unittest.TestCase):
    def setUp(self):
        self._saved = config.ell_spmm_enabled
        config.ell_spmm_enabled = "always"

    def tearDown(self):
        config.ell_spmm_enabled = self._saved


class TestEllLayout(_ForceEll):
    def test_repack_shapes_and_padding(self):
        X = sps.random(100, 50, density=0.1, format="csr",
                       dtype=np.float64, random_state=3)
        A = formats.to_device(X)
        cols_ell, vals_ell = A.ell_parts()
        self.assertEqual(cols_ell.shape[0] % 256, 0)
        self.assertEqual(cols_ell.shape, vals_ell.shape)
        rmax = int(np.diff(X.indptr).max())
        self.assertEqual(cols_ell.shape[1], rmax)
        # padded slots carry zero values
        dense = np.zeros((cols_ell.shape[0], 50))
        ce, ve = np.asarray(cols_ell), np.asarray(vals_ell)
        for r in range(100):
            for s in range(rmax):
                dense[r, ce[r, s]] += ve[r, s]
        np.testing.assert_allclose(dense[:100], X.toarray(), atol=1e-14)

    def test_pattern_cache_reused_across_data(self):
        X = sps.random(64, 64, density=0.1, format="csr",
                       dtype=np.float64, random_state=4)
        A = formats.to_device(X)
        c1, v1 = A.ell_parts()
        c2, v2 = A.ell_parts(data=A.data * 2.0)
        self.assertIs(c1, c2)
        np.testing.assert_allclose(
            np.asarray(v2), 2.0 * np.asarray(v1), atol=1e-14
        )

    def test_skewed_rows_fall_back(self):
        # one dense row among empties: pad ratio explodes -> None
        X = sps.lil_matrix((100, 200))
        X[0, :] = 1.0
        X[50, 7] = 2.0
        A = formats.to_device(X.tocsr())
        self.assertIsNone(A.ell_parts())


class TestEllSpMM(_ForceEll):
    def _check(self, m, k, n, dtype, density=0.02, seed=9):
        X = sps.random(m, k, density=density, format="csr",
                       dtype=dtype, random_state=seed)
        B = np.random.default_rng(seed).standard_normal((k, n)).astype(
            dtype
        )
        res = dot_product(X, B)
        decimal = 5 if dtype == np.float32 else 9
        np.testing.assert_array_almost_equal(
            res, X @ B, decimal=decimal
        )
        self.assertEqual(res.shape, (m, n))

    def test_f64(self):
        self._check(200, 300, 17, np.float64)

    def test_f32(self):
        self._check(200, 300, 17, np.float32)

    def test_unpadded_m_multiple_of_256(self):
        self._check(256, 128, 8, np.float64)

    def test_chunked(self):
        X = sps.random(512, 300, density=0.05, format="csr",
                       dtype=np.float64, random_state=11)
        A = formats.to_device(X)
        cols_ell, vals_ell = A.ell_parts()
        import jax.numpy as jnp

        B = jnp.asarray(
            np.random.default_rng(0).standard_normal((300, 16))
        )
        c1 = _xla.ell_spmm(cols_ell, vals_ell, B, nchunks=1)
        c4 = _xla.ell_spmm(cols_ell, vals_ell, B, nchunks=4)
        np.testing.assert_allclose(
            np.asarray(c1), np.asarray(c4), atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(c1)[:512], X @ np.asarray(B), atol=1e-9
        )

    def test_spmv(self):
        X = sps.random(200, 300, density=0.02, format="csr",
                       dtype=np.float64, random_state=12)
        x = np.random.default_rng(1).standard_normal(300)
        res = dot_product(X, x)
        np.testing.assert_array_almost_equal(res, X @ x, decimal=9)
        self.assertEqual(res.shape, (200,))

    def test_alpha_out_accumulate(self):
        X = sps.random(100, 80, density=0.05, format="csr",
                       dtype=np.float64, random_state=13)
        B = np.random.default_rng(2).standard_normal((80, 12))
        out = np.ones((100, 12))
        res = dot_product(X, B, out=out, out_scalar=3.0)
        self.assertIs(res, out)
        np.testing.assert_array_almost_equal(
            res, (X @ B) + 3.0, decimal=9
        )

    def test_scalar_and_out_together_device_epilogue(self):
        """alpha AND beta*out in one pass — the accumulate runs as a
        device epilogue since round 4; results must
        match the reference contract alpha*A@B + out_scalar*out."""
        for dt, dec in ((np.float64, 9), (np.float32, 4)):
            X = sps.random(300, 200, density=0.03, format="csr",
                           dtype=dt, random_state=17)
            B = np.random.default_rng(3).standard_normal(
                (200, 16)).astype(dt)
            base = np.random.default_rng(4).standard_normal(
                (300, 16)).astype(dt)
            out = base.copy()
            res = hops.spmm(
                formats.to_device(X), B, dt, alpha=2.5, out=out,
                out_scalar=-0.5,
            )
            np.testing.assert_array_almost_equal(
                res, 2.5 * (X @ B) - 0.5 * base, decimal=dec
            )

    def test_spmv_out_accumulate_device_epilogue(self):
        X = sps.random(150, 90, density=0.04, format="csr",
                       dtype=np.float64, random_state=19)
        x = np.random.default_rng(5).standard_normal(90)
        base = np.random.default_rng(6).standard_normal(150)
        out = base.copy()
        res = hops.spmv(
            formats.to_device(X), x, np.float64, alpha=1.5, out=out,
            out_scalar=2.0,
        )
        np.testing.assert_array_almost_equal(
            res, 1.5 * (X @ x) + 2.0 * base, decimal=9
        )


class TestDeviceAccumulateBSR(unittest.TestCase):
    """BSR out/out_scalar accumulate (BASELINE config 3) through the
    batched-matmul kernel's fused epilogue."""

    def test_bsr_out_accumulate(self):
        A = sps.random(256, 256, density=0.05, format="csr",
                       dtype=np.float32, random_state=23
                       ).tobsr(blocksize=(16, 16))
        B = np.random.default_rng(7).standard_normal(
            (256, 32)).astype(np.float32)
        base = np.random.default_rng(8).standard_normal(
            (256, 32)).astype(np.float32)
        out = base.copy()
        res = dot_product(A, B, out=out, out_scalar=0.75)
        self.assertIs(res, out)
        np.testing.assert_array_almost_equal(
            res, (A @ B) + 0.75 * base, decimal=4
        )


if __name__ == "__main__":
    unittest.main()

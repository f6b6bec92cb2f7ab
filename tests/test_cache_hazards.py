"""Regression tests for the round-2 id()-reuse cache hazards: a freed
array's id() can be recycled by a new allocation, so caches keyed by
bare id() could silently serve a previous matrix's values.  Round 3
replaced those keys with held references (compared by identity — a
held object's id can never be recycled) and never-reused monotone
structure tokens.
"""

import gc
import unittest

import numpy as np
import scipy.sparse as sps

import jax.numpy as jnp

from sparse_dot_tpu import dot_product, formats
from sparse_dot_tpu.config import config
from sparse_dot_tpu.ops import host as hops


class TestEllCacheIdentity(unittest.TestCase):
    """ELL padded-value caches must refresh when a DIFFERENT data
    array arrives, even across free/reallocate churn."""

    def setUp(self):
        self.A = sps.random(
            512, 400, density=0.05, format="csr", dtype=np.float64,
            random_state=3,
        )
        self.Ad = formats.to_device(self.A)

    def _ell_product(self, container, data):
        ell = container.ell_parts(data=data)
        self.assertIsNotNone(ell)
        cols_ell, vals_ell = ell
        return float(jnp.sum(vals_ell))

    def test_ell_values_refresh_across_reallocation(self):
        # Churn: build, use, free, rebuild scaled data arrays.  Any
        # id()-keyed cache would eventually alias a recycled id and
        # return a stale padded-values buffer.
        base = float(np.sum(self.A.data))
        for i in range(6):
            scale = float(i + 1)
            data = jnp.asarray(self.A.data * scale)
            got = self._ell_product(self.Ad, data)
            self.assertAlmostEqual(got, base * scale, places=6)
            del data
            gc.collect()

    def test_ell_cache_holds_its_key_object(self):
        # The cache entry must hold the data array it was built from
        # (identity-held key): holding it guarantees the key's id is
        # never recycled while the entry is alive.
        data = jnp.asarray(self.A.data * 2.0)
        self.Ad.ell_parts(data=data)
        entry = self.Ad._ell_cache[1]
        self.assertIs(entry[0], data)

    def test_ell_binned_values_refresh_across_reallocation(self):
        base = float(np.sum(self.A.data))
        for i in range(6):
            scale = float(i + 1)
            data = jnp.asarray(self.A.data * scale)
            binned = self.Ad.ell_parts_binned(data=data)
            self.assertIsNotNone(binned)
            _, _, vals_flat, _ = binned
            self.assertAlmostEqual(
                float(jnp.sum(vals_flat)), base * scale, places=6
            )
            del data
            gc.collect()


class TestStructureTokens(unittest.TestCase):
    """Speculative SpGEMM sizing keys by monotone per-container tokens
    that are never reused — unlike id()s."""

    def test_tokens_are_unique_and_stable(self):
        A = formats.to_device(sps.identity(8, format="csr"))
        B = formats.to_device(sps.identity(8, format="csr"))
        ta1 = hops._structure_token(A)
        tb = hops._structure_token(B)
        self.assertNotEqual(ta1, tb)
        self.assertEqual(hops._structure_token(A), ta1)

    def test_tokens_never_recycle_across_gc(self):
        # Distinct matrices (the host->device transfer cache folds
        # identical content into one container on purpose) must get
        # distinct tokens through free/reallocate churn.
        seen = set()
        for i in range(10):
            A = formats.to_device(
                sps.random(16, 16, density=0.3, format="csr",
                           dtype=np.float64, random_state=i)
            )
            tok = hops._structure_token(A)
            self.assertNotIn(tok, seen)
            seen.add(tok)
            del A
            gc.collect()

    def test_spgemm_sizing_fresh_after_container_churn(self):
        # Same shapes/density but different patterns through repeated
        # free/reallocate cycles: every product must size correctly.
        for seed in range(5):
            A = sps.random(64, 64, density=0.05, format="csr",
                           dtype=np.float64, random_state=seed)
            B = sps.random(64, 64, density=0.05, format="csr",
                           dtype=np.float64, random_state=100 + seed)
            C = dot_product(A, B)
            oracle = A @ B
            self.assertEqual(C.nnz, oracle.nnz)
            np.testing.assert_allclose(
                C.toarray(), oracle.toarray(), atol=1e-10
            )
            del A, B, C
            gc.collect()

    def test_transpose_view_memoized(self):
        # A.T must return the same container so structure-token caches
        # hit across repeated gram calls.
        A = formats.to_device(
            sps.random(32, 16, density=0.2, format="csr",
                       dtype=np.float64, random_state=1)
        )
        self.assertIs(A.T, A.T)


class TestSteadyStateValueRange(unittest.TestCase):
    """f64 SpGEMM steady state (plane + extraction-structure caches)
    must move values EXACTLY when the Ozaki gate is off (e.g. CPU):
    the hi|lo pair gather re-rounds at ~2^-49 and saturates outside
    f32 range, so the driver must pick the exact scatter (repeat calls
    once silently differed from the first on legal f64)."""

    def test_repeat_calls_exact_beyond_f32_range(self):
        rng = np.random.default_rng(41)
        A = sps.random(80, 120, density=0.1, format="csr",
                       dtype=np.float64, random_state=41)
        B = sps.random(120, 60, density=0.1, format="csr",
                       dtype=np.float64, random_state=42)
        A.data *= 1e200  # |values| far beyond f32 range
        B.data *= 1e50   # products ~1e250: legal f64, impossible f32
        oracle = (A @ B).toarray()
        first = dot_product(A, B).toarray()
        np.testing.assert_allclose(first, oracle, rtol=1e-14)
        for _ in range(3):  # steady state: plane + struct cache hits
            again = dot_product(A, B).toarray()
            self.assertTrue(np.isfinite(again).all())
            np.testing.assert_allclose(again, first, rtol=1e-14)

    def test_spmm_b_beyond_f32_range(self):
        # The SpMM kernels' hi|lo b split must be bypassed when b's
        # magnitudes are outside the f32 window.
        from sparse_dot_tpu import dot_product_mkl

        A = sps.random(300, 400, density=0.05, format="csr",
                       dtype=np.float64, random_state=43)
        b = np.random.default_rng(44).standard_normal((400, 8)) * 1e60
        got = dot_product_mkl(A, b)
        self.assertTrue(np.isfinite(got).all())
        np.testing.assert_allclose(got, A @ b, rtol=1e-13)

    def test_esc_sort_kernel_beyond_f32_range(self):
        # The ESC sort kernel must route to the scalar-gather form
        # (native-f64 values) when magnitudes exceed the packed
        # kernel's f32 channel window.
        from sparse_dot_tpu.ops.host import spgemm_esc_arrays

        A = sps.random(150, 200, density=0.05, format="csr",
                       dtype=np.float64, random_state=45)
        B = sps.random(200, 120, density=0.05, format="csr",
                       dtype=np.float64, random_state=46)
        A.data *= 1e200
        B.data *= 1e50
        old = config.spgemm_esc_force_sort
        config.spgemm_esc_force_sort = True
        try:
            for _ in range(2):  # cold + pattern-cached repeat
                data, indices, indptr = spgemm_esc_arrays(
                    formats.to_device(A), formats.to_device(B),
                    np.float64,
                )
                got = sps.csr_matrix(
                    (data, indices, indptr), shape=(150, 120)
                )
                d = abs(got - (A @ B).tocsr())
                self.assertTrue(np.isfinite(data).all())
                self.assertLess(
                    float(d.max()) if d.nnz else 0.0,
                    1e-14 * 1e250,
                )
        finally:
            config.spgemm_esc_force_sort = old

    def test_steady_state_product_range_gate(self):
        # In-range OPERANDS (1e25) with out-of-f32-range PRODUCTS
        # (1e50): the steady-state value gather hi|lo-encodes products,
        # so the product-range gate must route to exact movement even
        # with the Ozaki policy forced on (review r5 finding).
        old = config.ozaki
        config.ozaki = "1"
        try:
            A = sps.random(60, 80, density=0.15, format="csr",
                           dtype=np.float64, random_state=51)
            B = sps.random(80, 40, density=0.15, format="csr",
                           dtype=np.float64, random_state=52)
            A.data = np.abs(A.data) + 1.0
            B.data = np.abs(B.data) + 1.0
            A.data *= 1e25
            B.data *= 1e25
            oracle = (A @ B).toarray()
            first = dot_product(A, B).toarray()
            self.assertTrue(np.isfinite(first).all())
            for _ in range(3):  # steady state through the struct cache
                again = dot_product(A, B).toarray()
                self.assertTrue(np.isfinite(again).all())
                np.testing.assert_allclose(again, oracle, rtol=1e-9)
        finally:
            config.ozaki = old

    def test_planar_complex_b_beyond_f32_range(self):
        # Planar-complex SpMM passes b channels through the same range
        # gate as the native path (review r5 finding: the planar branch
        # used to split unconditionally).
        from sparse_dot_tpu import dot_product_mkl

        old_planar = config.force_planar_complex
        old_ell = config.ell_spmm_enabled
        config.force_planar_complex = True
        config.ell_spmm_enabled = "always"
        formats.clear_transfer_cache()
        try:
            A = sps.random(300, 400, density=0.05, format="csr",
                           dtype=np.float64, random_state=53)
            b = (np.random.default_rng(54).standard_normal((400, 4))
                 + 1j * np.random.default_rng(55).standard_normal(
                     (400, 4))) * 1e60
            got = dot_product_mkl(A, b, cast=True)
            self.assertTrue(np.isfinite(got).all())
            oracle = A @ b
            np.testing.assert_allclose(got, oracle, rtol=1e-12)
        finally:
            config.force_planar_complex = old_planar
            config.ell_spmm_enabled = old_ell
            formats.clear_transfer_cache()


if __name__ == "__main__":
    unittest.main()

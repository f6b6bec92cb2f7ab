"""ESC (expand-sort-compress) sparse-output SpGEMM.

The scaling path of ``mkl_sparse_spmm``'s any-size sparse output
(``/root/reference/sparse_dot_mkl/_sparse_sparse.py:21-44``): device
memory bounded by the expansion budget, never by m x n, and a
STRUCTURAL output pattern (cancelled entries kept, like MKL/scipy).
"""

import unittest

import numpy as np
import numpy.testing as npt
import scipy.sparse as sps

from sparse_dot_tpu import dot_product, formats, gram_matrix
from sparse_dot_tpu.config import config
from sparse_dot_tpu.ops import host as hops

from .common import make_matrixes, np_almost_equal


class TestESCKernel(unittest.TestCase):
    """Direct kernel-level checks across dtypes / blocks / triangles."""

    def setUp(self):
        self.A, self.B = make_matrixes(300, 250, 200, 0.05)
        self.Ad = formats.to_device(self.A)
        self.Bd = formats.to_device(self.B)
        self._budget = config.spgemm_esc_block_elements
        # Pin the expand-sort-compress kernel: these are kernel-level
        # checks, and the adaptive driver would route these sizes to
        # the dense row-blocked body.
        config.spgemm_esc_force_sort = True

    def tearDown(self):
        config.spgemm_esc_block_elements = self._budget
        config.spgemm_exact_pattern = False
        config.spgemm_esc_force_sort = False

    def _run(self, A, B, dtype, **kw):
        data, idx, indptr = hops.spgemm_esc_arrays(
            formats.to_device(A), formats.to_device(B), dtype, **kw
        )
        return sps.csr_matrix(
            (data, idx, indptr), shape=(A.shape[0], B.shape[1])
        )

    def test_f64_matches_scipy(self):
        C = self._run(self.A, self.B, np.float64)
        oracle = self.A @ self.B
        self.assertEqual(C.nnz, oracle.nnz)
        np_almost_equal(C, oracle)

    def test_f32(self):
        C = self._run(
            self.A.astype(np.float32), self.B.astype(np.float32),
            np.float32,
        )
        np_almost_equal(C, self.A @ self.B, decimal=5)

    def test_many_blocks_same_answer(self):
        config.spgemm_esc_block_elements = 1 << 9  # force ~dozens of blocks
        C = self._run(self.A, self.B, np.float64)
        np_almost_equal(C, self.A @ self.B)

    def test_triangular(self):
        C = self._run(self.A, self.A.T.tocsc().tocsr(), np.float64,
                      triangular=True)
        np_almost_equal(C, np.triu((self.A @ self.A.T).toarray()))

    def test_complex128(self):
        Ac = (self.A + 1j * self.A.multiply(0.3)).tocsr()
        Bc = (self.B - 2j * self.B).tocsr()
        C = self._run(Ac, Bc, np.complex128)
        np_almost_equal(C, Ac @ Bc)

    def test_csc_operands(self):
        C = self._run(self.A.tocsc(), self.B.tocsc(), np.float64)
        np_almost_equal(C, self.A @ self.B)

    def test_packed_and_scalar_kernels_agree(self):
        # The windowed-gather (packed) kernel and the scalar-gather
        # fallback must produce the identical structural product.
        C_packed = self._run(self.A, self.B, np.float64)
        config.spgemm_esc_packed = False
        try:
            C_scalar = self._run(self.A, self.B, np.float64)
        finally:
            config.spgemm_esc_packed = True
        self.assertEqual(C_packed.nnz, C_scalar.nnz)
        npt.assert_array_equal(C_packed.indices, C_scalar.indices)
        # The packed kernel carries f64 values as hi/lo f32 pairs
        # (~2^-48 relative, the same transport the Ozaki paths use);
        # structure is identical, values agree to that bound.
        npt.assert_allclose(C_packed.data, C_scalar.data, rtol=5e-15,
                            atol=1e-15)

    def test_sort_strategies_agree(self):
        # Pin perm-sort ((key, iota) sort + permutation gathers) for
        # one run and co-sort for the other — "auto" resolves to
        # co-sort here, so the perm_sort=True pin is what actually
        # exercises the permutation-gather compaction branch.  The
        # pattern cache is cleared between runs so the second call
        # exercises the PINNED sort kernel, not the sort-free
        # steady-state path.
        config.spgemm_esc_perm_sort = True
        try:
            C_perm = self._run(self.A, self.B, np.float64)
        finally:
            config.spgemm_esc_perm_sort = "auto"
        hops._esc_pattern_cache.clear()
        config.spgemm_esc_perm_sort = False
        try:
            C_cosort = self._run(self.A, self.B, np.float64)
        finally:
            config.spgemm_esc_perm_sort = "auto"
        self.assertEqual(C_perm.nnz, C_cosort.nnz)
        npt.assert_array_equal(C_perm.indices, C_cosort.indices)
        npt.assert_allclose(C_perm.data, C_cosort.data, rtol=0, atol=0)

    def test_sort_free_repeat_matches(self):
        # The steady-state sort-free kernel (cached sidx/head_src,
        # windowed value gathers) must reproduce the cold sorted
        # call's structure exactly and its values within the packed
        # hi|lo transport bound (~2^-48 relative, same contract as
        # test_packed_matches_scalar); repeats must be deterministic.
        hops._esc_pattern_cache.clear()
        C_cold = self._run(self.A, self.B, np.float64)
        C_warm = self._run(self.A, self.B, np.float64)
        self.assertTrue(
            hops.esc_last_profile.get("sort_free"),
            "sort-free steady state did not engage",
        )
        C_warm2 = self._run(self.A, self.B, np.float64)
        self.assertEqual(C_cold.nnz, C_warm.nnz)
        npt.assert_array_equal(C_cold.indices, C_warm.indices)
        npt.assert_allclose(C_cold.data, C_warm.data, rtol=5e-15,
                            atol=1e-15)
        npt.assert_allclose(C_warm.data, C_warm2.data, rtol=0, atol=0)

    def test_sort_free_kill_switch(self):
        hops._esc_pattern_cache.clear()
        old = getattr(config, "spgemm_esc_sort_free", True)
        config.spgemm_esc_sort_free = False
        try:
            self._run(self.A, self.B, np.float64)
            C = self._run(self.A, self.B, np.float64)
            self.assertFalse(hops.esc_last_profile.get("sort_free"))
            np_almost_equal(C, self.A @ self.B)
        finally:
            config.spgemm_esc_sort_free = old

    def test_duplicate_heavy_rows(self):
        # A dense-ish row multiplying a dense-ish B column exercises the
        # doubling-pass segment sums at high duplicate counts.
        A = sps.random(40, 60, density=0.6, format="csr",
                       dtype=np.float64, random_state=3)
        B = sps.random(60, 50, density=0.6, format="csr",
                       dtype=np.float64, random_state=4)
        C = self._run(A, B, np.float64)
        np_almost_equal(C, A @ B)

    def test_empty_product(self):
        # Patterns that never meet: A hits only even columns, B has
        # rows only at odd indices.
        A = sps.csr_matrix(
            (np.ones(3), np.array([0, 2, 4]), np.array([0, 1, 2, 3])),
            shape=(3, 6),
        )
        B_dense = np.zeros((6, 2))
        B_dense[1, 0] = 1.0
        B_dense[3, 1] = 1.0
        B = sps.csr_matrix(B_dense)
        C = self._run(A, B, np.float64)
        self.assertEqual(C.nnz, 0)
        np_almost_equal(C, A @ B)


class TestESCAdaptiveRouting(unittest.TestCase):
    """The any-size driver picks the right algorithm per workload: the
    dense row-blocked body when densified B fits, the sort kernel when it
    cannot — both structurally exact."""

    def test_routes_to_dense_ladder_when_b_fits(self):
        A, B = make_matrixes(300, 250, 200, 0.05)
        Ad, Bd = formats.to_device(A), formats.to_device(B)
        calls = []
        orig = hops._spgemm_routed
        hops._spgemm_routed = (
            lambda *a, **k: calls.append(1) or orig(*a, **k)
        )
        try:
            data, idx, indptr = hops.spgemm_esc_arrays(Ad, Bd, np.float64)
        finally:
            hops._spgemm_routed = orig
        self.assertEqual(len(calls), 1)
        C = sps.csr_matrix(
            (data, idx, indptr), shape=(A.shape[0], B.shape[1])
        )
        np_almost_equal(C, A @ B)

    def test_force_sort_pins_kernel(self):
        A, B = make_matrixes(300, 250, 200, 0.05)
        Ad, Bd = formats.to_device(A), formats.to_device(B)
        config.spgemm_esc_force_sort = True
        try:
            orig = hops._blocked_spgemm_arrays
            hops._blocked_spgemm_arrays = None  # would raise if routed
            try:
                data, idx, indptr = hops.spgemm_esc_arrays(
                    Ad, Bd, np.float64
                )
            finally:
                hops._blocked_spgemm_arrays = orig
        finally:
            config.spgemm_esc_force_sort = False
        C = sps.csr_matrix(
            (data, idx, indptr), shape=(A.shape[0], B.shape[1])
        )
        np_almost_equal(C, A @ B)

    def test_complex_stays_on_sort_kernel(self):
        # The blocked dense body is real-only; complex products keep the
        # sort kernel regardless of size.
        A, B = make_matrixes(60, 50, 40, 0.1)
        Ac = (A + 1j * A.multiply(0.5)).tocsr()
        Bc = (B - 2j * B).tocsr()
        data, idx, indptr = hops.spgemm_esc_arrays(
            formats.to_device(Ac), formats.to_device(Bc), np.complex128
        )
        C = sps.csr_matrix(
            (data, idx, indptr), shape=(Ac.shape[0], Bc.shape[1])
        )
        np_almost_equal(C, Ac @ Bc)

    def test_blocked_mxu_body_with_ozaki(self):
        # The row-blocked dense body's Ozaki branch (hi/lo block densify
        # + matmul_hilo) — forced on, since the CPU auto-gate would
        # pick the plain dot.
        old_block = hops._SPGEMM_ROW_BLOCK
        hops._SPGEMM_ROW_BLOCK = 64
        config.ozaki = "always"
        try:
            A = sps.random(200, 120, density=0.08, format="csr",
                           dtype=np.float64, random_state=17)
            B = sps.random(120, 90, density=0.08, format="csr",
                           dtype=np.float64, random_state=18)
            data, idx, indptr = hops._blocked_spgemm_arrays(
                formats.to_device(A), formats.to_device(B),
                np.float64, triangular=False,
            )
            C = sps.csr_matrix((data, idx, indptr), shape=(200, 90))
            np_almost_equal(C, A @ B)
        finally:
            hops._SPGEMM_ROW_BLOCK = old_block
            config.ozaki = "auto"

    def test_blocked_triangular_offset(self):
        # Several blocks with a global triangle: the in-kernel mask must
        # use the block's global row offset.
        old_block = hops._SPGEMM_ROW_BLOCK
        hops._SPGEMM_ROW_BLOCK = 64
        try:
            A = sps.random(200, 150, density=0.08, format="csr",
                           dtype=np.float64, random_state=11)
            B = A.T.tocsr()
            data, idx, indptr = hops.spgemm_esc_arrays(
                formats.to_device(A), formats.to_device(B), np.float64,
                triangular=True,
            )
            C = sps.csr_matrix((data, idx, indptr), shape=(200, 200))
            np_almost_equal(C, np.triu((A @ A.T).toarray()))
        finally:
            hops._SPGEMM_ROW_BLOCK = old_block


class TestMaskPacking(unittest.TestCase):
    """The single-readback small path's numeric mask packing."""

    def test_roundtrip(self):
        import jax.numpy as jnp
        from sparse_dot_tpu.ops import _xla

        rng = np.random.default_rng(5)
        for n in (1, 7, 8, 9, 255, 4096, 10_001):
            for dtype in (np.float32, np.float64):
                mask = rng.random(n) < 0.3
                packed = np.asarray(
                    _xla._pack_mask_bits(jnp.asarray(mask), dtype)
                )
                self.assertEqual(packed.dtype, np.dtype(dtype))
                out = _xla.unpack_mask_bits(packed, n)
                npt.assert_array_equal(out, mask)


class TestStructuralPattern(unittest.TestCase):
    """Exact cancellation keeps a structural (explicit-zero) entry —
    MKL/scipy behavior the densify fast path cannot represent."""

    def tearDown(self):
        config.spgemm_exact_pattern = False

    def _cancelling_pair(self):
        # Row 0 of A is [1, -1]; column 0 of B is [1; 1] -> C[0,0] == 0
        # exactly, but structurally present.
        A = sps.csr_matrix(np.array([[1.0, -1.0], [2.0, 0.0]]))
        B = sps.csr_matrix(np.array([[1.0, 3.0], [1.0, 0.0]]))
        return A, B

    def test_esc_pattern_is_structural(self):
        # MKL's spmm output is structural: C[0,0] is an explicit zero.
        # (scipy prunes it, so the oracle here is the dense product plus
        # the structural-count check.)
        A, B = self._cancelling_pair()
        config.spgemm_exact_pattern = True
        C = dot_product(A, B)
        self.assertEqual(C.nnz, 4)  # 3 values + 1 cancelled entry
        self.assertEqual(C[0, 0], 0.0)
        self.assertEqual(C.indptr[1] - C.indptr[0], 2)  # row 0 holds 2
        np_almost_equal(C, A.toarray() @ B.toarray())

    def test_default_path_keeps_cancelled_entry(self):
        # Round 3: the DEFAULT path is structural too — the fused
        # pattern matmul (``_xla.spgemm_structural_sorted``) makes the
        # densify fast path emit MKL's structural pattern, so the
        # explicit zero survives without opting into the ESC kernel.
        A, B = self._cancelling_pair()
        C = dot_product(A, B)
        self.assertEqual(C.nnz, 4)
        self.assertEqual(C[0, 0], 0.0)
        self.assertEqual(C.indptr[1] - C.indptr[0], 2)
        np_almost_equal(C, A.toarray() @ B.toarray())

    def test_device_resident_structural(self):
        # The device-resident product (no host transfer) is structural
        # as well, and its speculative sizing cache keys by structure
        # tokens — repeat calls with changed values reuse the size.
        A, B = self._cancelling_pair()
        Ad, Bd = formats.to_device(A), formats.to_device(B)
        C = hops.spgemm_device(Ad, Bd, out_dtype=np.float64)
        self.assertEqual(int(C.indptr[-1]), 4)
        C2 = hops.spgemm_device(Ad, Bd, out_dtype=np.float64,
                                sync_check=False)
        hops.validate_speculation()
        self.assertEqual(int(C2.indptr[-1]), 4)

    def test_blocked_path_structural(self):
        # Force the row-blocked route (dense m x n over the budget, but
        # densified B inside it) and check it keeps the explicit zeros
        # (per-block pattern matmul).
        old_blocked = hops._BLOCKED_SPGEMM_BYTES
        old_block = hops._SPGEMM_ROW_BLOCK
        hops._BLOCKED_SPGEMM_BYTES = 64
        hops._SPGEMM_ROW_BLOCK = 3
        try:
            A = sps.csr_matrix(np.tile([[1.0, -1.0]], (8, 1)))
            B = sps.csr_matrix(np.array([[1.0, 3.0], [1.0, 0.0]]))
            C = dot_product(A, B)  # every row: [0 (explicit), 3]
            self.assertEqual(C.nnz, 16)
            np_almost_equal(C, A.toarray() @ B.toarray())
        finally:
            hops._BLOCKED_SPGEMM_BYTES = old_blocked
            hops._SPGEMM_ROW_BLOCK = old_block


class TestHugeRouting(unittest.TestCase):
    """Products whose dense intermediate could never materialize."""

    def test_million_square_spgemm(self):
        # 1M x 1M: the dense intermediate would be 8 TB; the ESC path
        # computes the true sparse product in bounded memory.
        m = 1_000_000
        rng = np.random.default_rng(7)
        nnz = 2_000_000
        A = sps.csr_matrix(
            (
                rng.standard_normal(nnz),
                (
                    rng.integers(0, m, nnz),
                    rng.integers(0, m, nnz),
                ),
            ),
            shape=(m, m),
        )
        A.sum_duplicates()
        A.sort_indices()
        C = dot_product(A, A)
        oracle = A @ A
        oracle.sort_indices()  # scipy's spgemm emits unsorted columns
        self.assertEqual(C.nnz, oracle.nnz)
        npt.assert_array_equal(C.indptr, oracle.indptr)
        npt.assert_array_equal(C.indices, oracle.indices)
        npt.assert_allclose(C.data, oracle.data, rtol=1e-12, atol=1e-12)

    def test_wide_output_no_dense_block(self):
        # Wide n with a big m*n: the old row-blocked path allocated
        # 4096 x n dense blocks; force the routing thresholds down and
        # check the ESC route answers correctly through the public API.
        old_blocked = hops._BLOCKED_SPGEMM_BYTES
        old_host = hops._HOST_EXTRACT_BYTES
        hops._BLOCKED_SPGEMM_BYTES = 1 << 18
        hops._HOST_EXTRACT_BYTES = 1 << 14
        try:
            A = sps.random(500, 300, density=0.02, format="csr",
                           dtype=np.float64, random_state=8)
            B = sps.random(300, 4000, density=0.02, format="csr",
                           dtype=np.float64, random_state=9)
            C = dot_product(A, B)
            np_almost_equal(C, A @ B)
        finally:
            hops._BLOCKED_SPGEMM_BYTES = old_blocked
            hops._HOST_EXTRACT_BYTES = old_host

    def test_key64_blocks_device_counts_layout(self):
        # n > 32768 forces int64 keys (row_cap would drop below 2^16),
        # which selects the [row-histogram | cols] device readback
        # layout; narrow-n blocks ship raw i32 keys.  Both must agree
        # with scipy through the public API.
        config.spgemm_esc_force_sort = True
        try:
            A = sps.random(150, 300, density=0.05, format="csr",
                           dtype=np.float64, random_state=21)
            B = sps.random(300, 40_000, density=0.003, format="csr",
                           dtype=np.float64, random_state=22)
            C = dot_product(A, B)
            oracle = A @ B
            oracle.sort_indices()
            self.assertEqual(C.nnz, oracle.nnz)
            npt.assert_array_equal(C.indptr, oracle.indptr)
            npt.assert_array_equal(C.indices, oracle.indices)
            npt.assert_allclose(C.data, oracle.data, rtol=1e-12,
                                atol=1e-12)
        finally:
            config.spgemm_esc_force_sort = False

    def test_gram_huge_routes_esc(self):
        old_blocked = hops._BLOCKED_SPGEMM_BYTES
        old_host = hops._HOST_EXTRACT_BYTES
        hops._BLOCKED_SPGEMM_BYTES = 1 << 18
        hops._HOST_EXTRACT_BYTES = 1 << 14
        try:
            A = sps.random(300, 2000, density=0.02, format="csr",
                           dtype=np.float64, random_state=10)
            G = gram_matrix(A)
            np_almost_equal(G, np.triu((A.T @ A).toarray()))
        finally:
            hops._BLOCKED_SPGEMM_BYTES = old_blocked
            hops._HOST_EXTRACT_BYTES = old_host


if __name__ == "__main__":
    unittest.main()

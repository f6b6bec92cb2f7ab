"""Mesh-sharded op suite on the 8-virtual-device CPU mesh — validates
the SPMD layouts (row-shard, k-shard + psum, distributed gram/CG)
against dense oracles."""

import unittest

import numpy as np
import numpy.testing as npt
import scipy.sparse as sps

import jax

from sparse_dot_tpu.parallel import (
    make_mesh,
    shard_csr_rows,
    sharded_spmm,
    sharded_spmv,
    sharded_gram,
    sharded_cg,
    sharded_spmm_2d,
)
from sparse_dot_tpu.parallel.ops import shard_csr_cols

from .common import MATRIX_1, np_almost_equal


class TestShardedOps(unittest.TestCase):
    @classmethod
    def setUpClass(cls):
        cls.n_dev = jax.device_count()
        cls.mesh = make_mesh((cls.n_dev, 1), ("rows", "cols"))
        cls.A = MATRIX_1.copy().tocsr()
        rng = np.random.default_rng(9)
        cls.B = rng.random((cls.A.shape[1], 40))

    def test_multiple_devices_available(self):
        self.assertGreaterEqual(self.n_dev, 2)

    def test_row_sharded_spmm(self):
        A_sh = shard_csr_rows(self.A, self.n_dev, self.mesh)
        C = sharded_spmm(self.mesh, A_sh, self.B)
        np_almost_equal(np.asarray(C), self.A.toarray() @ self.B)

    def test_row_sharded_spmv(self):
        A_sh = shard_csr_rows(self.A, self.n_dev, self.mesh)
        x = self.B[:, 0]
        y = sharded_spmv(self.mesh, A_sh, x)
        np_almost_equal(np.asarray(y), self.A.toarray() @ x)

    def test_k_sharded_spmm_psum(self):
        mesh = make_mesh((1, self.n_dev), ("rows", "cols"))
        A_sh = shard_csr_cols(self.A, self.n_dev, mesh)
        C = sharded_spmm_2d(mesh, A_sh, self.B)
        np_almost_equal(np.asarray(C), self.A.toarray() @ self.B)

    def test_row_sharded_spmm_f32(self):
        A32 = self.A.astype(np.float32)
        A_sh = shard_csr_rows(A32, self.n_dev, self.mesh)
        self.assertEqual(A_sh.dtype, np.float32)
        C = sharded_spmm(self.mesh, A_sh, self.B.astype(np.float32))
        np_almost_equal(np.asarray(C),
                        A32.toarray() @ self.B.astype(np.float32),
                        decimal=4)

    def test_row_sharded_spmm_complex(self):
        """Planar channels through shard_csr_rows: complex A x complex
        b as 4 real SPMD products in one program."""
        Ac = (self.A + 0.5j * self.A).tocsr().astype(np.complex128)
        bc = self.B + 1j * self.B[:, ::-1]
        A_sh = shard_csr_rows(Ac, self.n_dev, self.mesh)
        self.assertTrue(A_sh.planar)
        self.assertEqual(A_sh.dtype, np.complex128)
        C = sharded_spmm(self.mesh, A_sh, bc)
        np_almost_equal(np.asarray(C), Ac.toarray() @ bc)

    def test_row_sharded_spmm_complex_real_b(self):
        Ac = (self.A - 2j * self.A).tocsr().astype(np.complex128)
        A_sh = shard_csr_rows(Ac, self.n_dev, self.mesh)
        C = sharded_spmm(self.mesh, A_sh, self.B)
        np_almost_equal(np.asarray(C), Ac.toarray() @ self.B)

    def test_row_sharded_spmm_real_a_complex_b(self):
        A_sh = shard_csr_rows(self.A, self.n_dev, self.mesh)
        bc = self.B + 1j * self.B[:, ::-1]
        C = sharded_spmm(self.mesh, A_sh, bc)
        np_almost_equal(np.asarray(C), self.A.toarray() @ bc)

    def test_row_sharded_spmv_complex(self):
        Ac = (self.A + 1j * self.A.multiply(0.25)).tocsr().astype(
            np.complex128
        )
        A_sh = shard_csr_rows(Ac, self.n_dev, self.mesh)
        xc = self.B[:, 0] + 1j * self.B[:, 1]
        y = sharded_spmv(self.mesh, A_sh, xc)
        np_almost_equal(np.asarray(y), Ac.toarray() @ xc)

    def test_ring_spmm_complex(self):
        from sparse_dot_tpu.parallel import (
            shard_csr_grid, sharded_spmm_ring,
        )

        Ac = (self.A + 0.5j * self.A).tocsr().astype(np.complex128)
        bc = self.B + 1j * self.B[:, ::-1]
        A_grid = shard_csr_grid(Ac, self.n_dev, self.mesh)
        self.assertTrue(A_grid.planar)
        C = sharded_spmm_ring(self.mesh, A_grid, bc)
        np_almost_equal(np.asarray(C), Ac.toarray() @ bc)

    def test_ring_spmm_complex64(self):
        from sparse_dot_tpu.parallel import (
            shard_csr_grid, sharded_spmm_ring,
        )

        Ac = (self.A + 0.5j * self.A).astype(np.complex64).tocsr()
        bc = (self.B + 1j * self.B[:, ::-1]).astype(np.complex64)
        A_grid = shard_csr_grid(Ac, self.n_dev, self.mesh)
        C = sharded_spmm_ring(self.mesh, A_grid, bc)
        self.assertEqual(C.dtype, np.complex64)
        np_almost_equal(np.asarray(C),
                        (Ac.toarray() @ bc).astype(np.complex64),
                        decimal=3)

    def test_sharded_gram(self):
        A_sh = shard_csr_rows(self.A, self.n_dev, self.mesh)
        G = sharded_gram(self.mesh, A_sh)
        np_almost_equal(
            np.asarray(G), self.A.toarray().T @ self.A.toarray()
        )

    def test_sharded_cg(self):
        n = 64
        M = sps.random(n, n, density=0.2, random_state=4, format="csr")
        A = (M @ M.T + n * sps.identity(n)).tocsr()
        b = np.random.default_rng(5).random(n)
        A_sh = shard_csr_rows(A, self.n_dev, self.mesh)
        x, res, iters = sharded_cg(self.mesh, A_sh, b, tol=1e-12)
        npt.assert_array_almost_equal(x, np.linalg.solve(A.toarray(), b))
        self.assertLess(res, 1e-10)




class TestRingSpMM(unittest.TestCase):
    """Ring SpMM: B sharded along k and rotated with ppermute — nothing
    replicated."""

    @classmethod
    def setUpClass(cls):
        cls.n_dev = jax.device_count()
        cls.mesh = make_mesh((cls.n_dev, 1), ("rows", "cols"))
        cls.A = MATRIX_1.copy().tocsr()
        rng = np.random.default_rng(10)
        cls.B = rng.random((cls.A.shape[1], 24))

    def test_ring_spmm_matches_dense(self):
        from sparse_dot_tpu.parallel import shard_csr_grid, \
            sharded_spmm_ring

        A_grid = shard_csr_grid(self.A, self.n_dev, self.mesh)
        C = sharded_spmm_ring(self.mesh, A_grid, self.B)
        np_almost_equal(np.asarray(C), self.A.toarray() @ self.B)

    def test_ring_spmm_uneven_dims(self):
        from sparse_dot_tpu.parallel import shard_csr_grid, \
            sharded_spmm_ring

        A = self.A[:197, :299]  # not divisible by the shard count
        A_grid = shard_csr_grid(A, self.n_dev, self.mesh)
        C = sharded_spmm_ring(self.mesh, A_grid, self.B[:299])
        np_almost_equal(np.asarray(C), A.toarray() @ self.B[:299])

    def test_ring_double_buffered_schedule(self):
        """Structural proof of the double-buffered ring (round 4,
        SURVEY §7:497-499): in the OPTIMIZED HLO the ring-step body
        issues its collective-permute BEFORE the scatter-add that
        consumes the current shard (transfer overlaps compute on real
        ICI), and the final wasted rotation is peeled off (the loop
        runs S-1 rotations).  Wall-clock overlap needs real multi-chip
        hardware; this pins the schedule shape."""
        from sparse_dot_tpu.parallel import shard_csr_grid
        from sparse_dot_tpu.parallel.ops import sharded_spmm_ring

        A_grid = shard_csr_grid(self.A, self.n_dev, self.mesh)
        lowered = sharded_spmm_ring(
            self.mesh, A_grid, self.B, _inspect=True
        )
        txt = lowered.compile().as_text()
        # Scan only the loop-body computation that holds the ring
        # schedule (the full text also contains fusion computation
        # DEFINITIONS, whose order is meaningless).
        lines = txt.splitlines()
        perm_line = next(
            i for i, ln in enumerate(lines) if "collective-permute" in ln
        )
        start = max(
            i for i in range(perm_line + 1)
            if lines[i].rstrip().endswith("{")
        )
        end = next(
            i for i in range(perm_line, len(lines))
            if lines[i].startswith("}")
        )
        body = "\n".join(lines[start:end])
        first_perm = body.find("collective-permute")
        first_scatter = body.find("scatter")
        self.assertGreater(first_scatter, 0)
        self.assertLess(
            first_perm, first_scatter,
            "permute must be issued before the consuming scatter-add",
        )
        # Peeled tail: the module has the loop permute only; the final
        # compute-only step contributes a scatter with NO following
        # permute (total collective-permute op count is 1 loop form).
        n_perm_module = (txt.count("collective-permute")
                         - txt.count("collective-permute-done"))
        self.assertEqual(n_perm_module, 1)

    def test_dot_product_routes_sharded(self):
        """The public dot_product dispatches ShardedCSR operands to the
        mesh kernels automatically."""
        from sparse_dot_tpu import dot_product
        from sparse_dot_tpu.parallel import shard_csr_grid

        A_rows = shard_csr_rows(self.A, self.n_dev, self.mesh)
        C = dot_product(A_rows, self.B)
        np_almost_equal(C, self.A.toarray() @ self.B)

        v = self.B[:, 0].copy()
        y = dot_product(A_rows, v)
        np_almost_equal(y, self.A.toarray() @ v)

        A_grid = shard_csr_grid(self.A, self.n_dev, self.mesh)
        C2 = dot_product(A_grid, self.B)
        np_almost_equal(C2, self.A.toarray() @ self.B)

    def test_dot_product_sharded_guards(self):
        from sparse_dot_tpu import dot_product

        A_nomesh = shard_csr_rows(self.A, self.n_dev, mesh=None)
        with self.assertRaises(ValueError):
            dot_product(A_nomesh, self.B)
        A_rows = shard_csr_rows(self.A, self.n_dev, self.mesh)
        with self.assertRaises(ValueError):
            dot_product(self.B, A_rows)

    def test_dot_product_sharded_kwargs(self):
        """The single-chip keyword contract holds on the sharded route
        (review r5: out/out_scalar/cast used to be silently dropped)."""
        from sparse_dot_tpu import dot_product

        A_rows = shard_csr_rows(self.A, self.n_dev, self.mesh)
        ref = self.A.toarray() @ self.B

        # out/out_scalar accumulate into the caller's buffer.
        out = np.full(ref.shape, 2.0, dtype=ref.dtype)
        got = dot_product(A_rows, self.B, out=out, out_scalar=3.0)
        self.assertIs(got, out)
        np_almost_equal(out, ref + 3.0 * 2.0)

        # Shape-mismatched out raises like the single-chip path.
        bad = np.zeros((ref.shape[0] + 1, ref.shape[1]), dtype=ref.dtype)
        with self.assertRaises(ValueError):
            dot_product(A_rows, self.B, out=bad)

        # dtype mismatch follows the cast contract.
        b32 = self.B.astype(np.float32)
        with self.assertRaises(ValueError):
            dot_product(A_rows, b32)
        np_almost_equal(dot_product(A_rows, b32, cast=True),
                        self.A.toarray() @ b32.astype(np.float64))


class TestShardedSpGEMM(unittest.TestCase):
    """2-D partitioned sparse x sparse: A row+column blocked, sparse B
    k-sharded, shards rotating over the ring."""

    @classmethod
    def setUpClass(cls):
        cls.n_dev = jax.device_count()
        cls.mesh = make_mesh((cls.n_dev, 1), ("rows", "cols"))
        cls.A = MATRIX_1.copy().tocsr()
        cls.B = sps.random(
            cls.A.shape[1], 120, density=0.05, format="csr",
            dtype=np.float64, random_state=11,
        )

    def test_sharded_spgemm_matches_scipy(self):
        from sparse_dot_tpu.parallel import (
            shard_csr_grid,
            shard_csr_krows,
            sharded_spgemm,
        )

        A_grid = shard_csr_grid(self.A, self.n_dev, self.mesh)
        B_k = shard_csr_krows(self.B, self.n_dev, self.mesh)
        C = sharded_spgemm(self.mesh, A_grid, B_k)
        np_almost_equal(C.toarray(), (self.A @ self.B).toarray())

    def test_dot_product_routes_sharded_spgemm(self):
        from sparse_dot_tpu import dot_product
        from sparse_dot_tpu.parallel import shard_csr_grid, \
            shard_csr_krows

        A_grid = shard_csr_grid(self.A, self.n_dev, self.mesh)
        B_k = shard_csr_krows(self.B, self.n_dev, self.mesh)
        C = dot_product(A_grid, B_k)
        np_almost_equal(C.toarray(), (self.A @ self.B).toarray())

    def test_sharded_spgemm_kwarg_guards(self):
        """out= without dense and dense=True follow the reference rules
        instead of being silently dropped (review r5)."""
        from sparse_dot_tpu import dot_product
        from sparse_dot_tpu.parallel import shard_csr_grid, \
            shard_csr_krows

        A_grid = shard_csr_grid(self.A, self.n_dev, self.mesh)
        B_k = shard_csr_krows(self.B, self.n_dev, self.mesh)
        with self.assertRaises(ValueError):
            dot_product(A_grid, B_k, out=np.zeros(
                (self.A.shape[0], self.B.shape[1])
            ))
        with self.assertRaises(NotImplementedError):
            dot_product(A_grid, B_k, dense=True)
        # reorder_output is honored (sorted indices on the result).
        C = dot_product(A_grid, B_k, reorder_output=True)
        self.assertTrue(C.has_sorted_indices)

    def test_sharded_spgemm_requires_grid(self):
        from sparse_dot_tpu import dot_product
        from sparse_dot_tpu.parallel import shard_csr_krows

        A_rows = shard_csr_rows(self.A, self.n_dev, self.mesh)
        B_k = shard_csr_krows(self.B, self.n_dev, self.mesh)
        with self.assertRaises(ValueError):
            dot_product(A_rows, B_k)

    def test_sharded_spgemm_f32(self):
        from sparse_dot_tpu.parallel import (
            shard_csr_grid,
            shard_csr_krows,
            sharded_spgemm,
        )

        A32 = self.A.astype(np.float32)
        B32 = self.B.astype(np.float32)
        A_grid = shard_csr_grid(A32, self.n_dev, self.mesh)
        B_k = shard_csr_krows(B32, self.n_dev, self.mesh)
        C = sharded_spgemm(self.mesh, A_grid, B_k)
        self.assertEqual(C.dtype, np.float32)
        np_almost_equal(C.toarray(), (A32 @ B32).toarray(), decimal=4)

    def test_sharded_spgemm_structural_pattern(self):
        """On-device compaction keeps MKL's structural pattern: an
        exactly-cancelled output entry stays as an explicit zero."""
        from sparse_dot_tpu.parallel import (
            shard_csr_grid,
            shard_csr_krows,
            sharded_spgemm,
        )

        A = sps.csr_matrix(np.tile([[1.0, -1.0]], (8, 1)))
        B = sps.csr_matrix(np.array([[1.0, 3.0], [1.0, 0.0]]))
        A_grid = shard_csr_grid(A, self.n_dev, self.mesh)
        B_k = shard_csr_krows(B, self.n_dev, self.mesh)
        C = sharded_spgemm(self.mesh, A_grid, B_k)
        self.assertEqual(C.nnz, 16)  # 8 explicit zeros + 8 values
        np_almost_equal(C.toarray(), A.toarray() @ B.toarray())


class TestShardedCGLS(unittest.TestCase):
    def test_sharded_least_squares(self):
        from sparse_dot_tpu.parallel import make_mesh, shard_csr_rows, \
            sharded_cgls

        n_dev = jax.device_count()
        mesh = make_mesh((n_dev, 1), ("rows", "cols"))
        A = MATRIX_1.copy().tocsr()[:, :50]
        b = np.random.default_rng(2).random(A.shape[0])
        A_sh = shard_csr_rows(A, n_dev, mesh)
        x, res, iters = sharded_cgls(mesh, A_sh, b, tol=1e-12)
        expect = np.linalg.lstsq(A.toarray(), b, rcond=None)[0]
        npt.assert_array_almost_equal(x, expect)

    def test_sharded_ill_conditioned(self):
        # Column scales spanning 1e6 (cond >= 1e6): the Jacobi-
        # preconditioned distributed loop must converge accurately in
        # bounded iterations, matching the single-chip CGLS route.
        from sparse_dot_tpu.parallel import make_mesh, shard_csr_rows, \
            sharded_cgls

        n_dev = jax.device_count()
        mesh = make_mesh((n_dev, 1), ("rows", "cols"))
        rng = np.random.default_rng(9)
        m, k = 4000, 60
        A0 = sps.random(m, k, density=0.02, format="csr",
                        dtype=np.float64, random_state=9)
        tail = sps.csr_matrix(
            (np.ones(k), (np.arange(m - k, m), np.arange(k))),
            shape=(m, k),
        )
        A = ((A0 + tail) @ sps.diags(np.logspace(0, -6, k))).tocsr()
        x_true = rng.standard_normal(k)
        b = A @ x_true
        A_sh = shard_csr_rows(A, n_dev, mesh)
        x, res, iters = sharded_cgls(mesh, A_sh, b, tol=1e-12,
                                     maxiter=500)
        rel = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
        self.assertLess(rel, 1e-8)
        self.assertLessEqual(iters, 300)


class TestHaloSpMV(unittest.TestCase):
    """Nearest-neighbor halo-exchange SpMV (SURVEY §7's halo/remote-
    segment exchange): banded matrices communicate 2*halo ring segments
    instead of all-gathering the vector."""

    @classmethod
    def setUpClass(cls):
        cls.n_dev = jax.device_count()
        cls.mesh = make_mesh((cls.n_dev, 1), ("rows", "cols"))

    def _banded(self, n, bw, dtype=np.float64):
        rng = np.random.default_rng(7)
        diags = [rng.random(n - abs(o)) for o in range(-bw, bw + 1)]
        return sps.diags(
            diags, range(-bw, bw + 1), format="csr", dtype=dtype
        ).tocsr()

    def test_matches_dense_oracle(self):
        from sparse_dot_tpu.parallel import sharded_spmv_halo

        n = 64 * self.n_dev
        A = self._banded(n, 3)
        x = np.random.default_rng(8).random(n)
        A_sh = shard_csr_rows(A, self.n_dev, self.mesh)
        y = sharded_spmv_halo(self.mesh, A_sh, x, halo=1)
        npt.assert_allclose(y, A @ x, atol=1e-12)

    def test_wider_halo(self):
        from sparse_dot_tpu.parallel import sharded_spmv_halo

        n = 16 * self.n_dev
        A = self._banded(n, 20)  # bandwidth > k_local: needs halo=2
        x = np.random.default_rng(9).random(n)
        A_sh = shard_csr_rows(A, self.n_dev, self.mesh)
        y = sharded_spmv_halo(self.mesh, A_sh, x, halo=2)
        npt.assert_allclose(y, A @ x, atol=1e-12)

    def test_bandwidth_violation_raises(self):
        from sparse_dot_tpu.parallel import sharded_spmv_halo

        n = 32 * self.n_dev
        A = sps.random(n, n, density=0.2, format="csr",
                       dtype=np.float64, random_state=10)
        A_sh = shard_csr_rows(A, self.n_dev, self.mesh)
        with self.assertRaises(ValueError):
            sharded_spmv_halo(
                self.mesh, A_sh,
                np.random.default_rng(11).random(n), halo=1,
            )


if __name__ == "__main__":
    unittest.main()


class TestShardingGuards(unittest.TestCase):
    """Review r5 findings: mesh/shard mismatches and pytree round-trips
    must be errors or lossless, never silent wrong answers."""

    def setUp(self):
        self.n_dev = jax.device_count()
        self.mesh = make_mesh((self.n_dev, 1), ("rows", "cols"))
        self.A = MATRIX_1.copy().tocsr()[:, :50]

    def test_mismatched_n_shards_raises(self):
        from sparse_dot_tpu.parallel import shard_csr_rows

        with self.assertRaises(ValueError):
            shard_csr_rows(self.A, self.n_dev * 2, self.mesh)

    def test_mismatched_op_mesh_raises(self):
        from sparse_dot_tpu.parallel import (
            make_mesh, shard_csr_rows, sharded_gram,
        )

        A_sh = shard_csr_rows(self.A, self.n_dev, self.mesh)
        if self.n_dev < 2:
            self.skipTest("needs >= 2 devices")
        half = make_mesh((self.n_dev // 2, 1), ("rows", "cols"),
                         devices=jax.devices()[: self.n_dev // 2])
        with self.assertRaises(ValueError):
            sharded_gram(half, A_sh)

    def test_pytree_roundtrip_preserves_routing_state(self):
        from sparse_dot_tpu.parallel import shard_csr_cols
        from sparse_dot_tpu.parallel.ops import ShardedCSR

        mesh_c = make_mesh((1, self.n_dev), ("rows", "cols"))
        A_sh = shard_csr_cols(self.A, self.n_dev, mesh_c)
        leaves, treedef = jax.tree_util.tree_flatten(A_sh)
        back = jax.tree_util.tree_unflatten(treedef, leaves)
        self.assertEqual(back.k_local, A_sh.k_local)
        self.assertIs(back.mesh, A_sh.mesh)
        self.assertEqual(back.axis, A_sh.axis)

    def test_cols_accepts_device_container(self):
        from sparse_dot_tpu import formats
        from sparse_dot_tpu.parallel import shard_csr_cols, \
            sharded_spmm_2d

        mesh_c = make_mesh((1, self.n_dev), ("rows", "cols"))
        A_sh = shard_csr_cols(
            formats.to_device(self.A), self.n_dev, mesh_c
        )
        b = np.random.default_rng(5).random((50, 3))
        got = np.asarray(sharded_spmm_2d(mesh_c, A_sh, b))
        npt.assert_allclose(got, self.A.toarray() @ b, atol=1e-10)

    def test_complex_sharded_solvers_raise_cleanly(self):
        from sparse_dot_tpu.parallel import (
            shard_csr_rows, sharded_cg, sharded_cgls, sharded_gram,
        )

        Ac = (self.A[:50, :50] + 1j * self.A[:50, :50]).tocsr()
        A_sh = shard_csr_rows(Ac, self.n_dev, self.mesh)
        b = np.ones(50)
        for fn in (
            lambda: sharded_cg(self.mesh, A_sh, b),
            lambda: sharded_cgls(self.mesh, A_sh, b),
            lambda: sharded_gram(self.mesh, A_sh),
        ):
            with self.assertRaises(NotImplementedError):
                fn()

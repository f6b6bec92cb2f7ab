"""Iterative solver suite (CG / FGMRES) — the reference's RCI protocol
tests (``tests/test_iss.py``) plus real convergence cases on SPD and
nonsymmetric systems against direct oracles."""

import unittest
import warnings

import numpy as np
import numpy.testing as npt
import scipy.sparse as sps

from sparse_dot_tpu.interface import (
    SPARSE_FILL_MODE_UPPER,
    SPARSE_DIAG_NON_UNIT,
    SPARSE_MATRIX_TYPE_SYMMETRIC,
)
from sparse_dot_tpu.solvers import (
    CGIterativeSparseSolver,
    FGMRESIterativeSparseSolver,
    ConvergenceWarning,
    cg,
    fgmres,
)

# The reference's hand-coded 8-row system (1-based indices as written,
# so scipy sees an 8x9 matrix) with a zero RHS
# (``tests/test_iss.py:18-42``).
test_rhs = np.zeros(8, dtype=float)
test_matrix_indptr = np.array([0, 1, 5, 8, 10, 12, 15, 17, 18], dtype=int)
test_matrix_index = np.array(
    [1, 3, 6, 7, 2, 3, 5, 3, 8, 4, 7, 5, 6, 7, 6, 8, 7, 8], dtype=int
)
test_matrix_data = np.array(
    [7.0, 1.0, 2.0, 7.0, -4.0, 8.0, 2.0, 1.0, 5.0, 7.0, 9.0, 5.0, 1.0,
     5.0, -1.0, 5.0, 11.0, 5.0],
    dtype=float,
)
test_matrix = sps.csr_matrix(
    (test_matrix_data, test_matrix_index, test_matrix_indptr)
)
test_x0 = np.array([1, 0, 1, 0, 1, 0, 1, 0, 0], dtype=float)


def _spd_system(n=50, seed=5):
    rng = np.random.default_rng(seed)
    M = sps.random(n, n, density=0.2, random_state=seed, format="csr")
    A = (M @ M.T + n * sps.identity(n)).tocsr()
    b = rng.random(n)
    return A, b


class TestSparseSolverCG(unittest.TestCase):
    def setUp(self):
        self.mat1 = test_matrix.copy()
        self.mat2 = test_rhs.copy()
        self.x0 = test_x0.copy()

    def test_cg_solver_square_perfect(self):
        mat3 = np.linalg.lstsq(
            self.mat1.toarray(), test_rhs, rcond=None
        )[0]
        with CGIterativeSparseSolver(
            self.mat1, self.mat2, x=self.x0, verbose=False
        ) as solver:
            solver.set_sparse_matrix_descr(
                SPARSE_MATRIX_TYPE_SYMMETRIC,
                SPARSE_FILL_MODE_UPPER,
                SPARSE_DIAG_NON_UNIT,
            )
            x = solver.solve()
        npt.assert_array_equal(test_matrix.toarray(), self.mat1.toarray())
        npt.assert_array_equal(test_rhs, self.mat2)
        npt.assert_array_almost_equal(x, mat3)

    def test_cg_wrapper_square_perfect(self):
        mat3 = np.linalg.lstsq(
            self.mat1.toarray(), test_rhs, rcond=None
        )[0]
        x, code = cg(self.mat1, self.mat2)
        self.assertEqual(code, 0)
        npt.assert_array_almost_equal(x, mat3)

    def test_cg_spd_real_system(self):
        A, b = _spd_system()
        expect = np.linalg.solve(A.toarray(), b)
        x, code = cg(A, b, tol=1e-10)
        self.assertEqual(code, 0)
        npt.assert_array_almost_equal(x, expect)

    def test_cg_iterator_protocol(self):
        A, b = _spd_system()
        with CGIterativeSparseSolver(A, b, r_tol=1e-10) as solver:
            for status in solver:
                self.assertEqual(status, 1)
        npt.assert_array_almost_equal(
            solver.x, np.linalg.solve(A.toarray(), b)
        )
        self.assertEqual(solver.final_code, 0)

    def test_cg_max_iter_warns(self):
        A, b = _spd_system()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with CGIterativeSparseSolver(A, b, max_iter=1,
                                         r_tol=1e-14) as solver:
                solver.solve()
            self.assertTrue(
                any(issubclass(x.category, ConvergenceWarning) for x in w)
            )

    def test_cg_fused_matches_stepwise(self):
        """solve() runs one compiled device loop; it must produce the
        same iterate and the same iteration count as driving the
        stepwise __next__ protocol by hand."""
        A, b = _spd_system()
        with CGIterativeSparseSolver(A, b, r_tol=1e-10) as fused:
            x_fused = fused.solve()
            fused_iters = fused.current_iter
        with CGIterativeSparseSolver(A, b, r_tol=1e-10) as stepwise:
            for _ in stepwise:
                pass
            x_step = stepwise.x
            step_iters = stepwise.current_iter
        self.assertEqual(fused.final_code, 0)
        self.assertEqual(fused_iters, step_iters)
        npt.assert_array_almost_equal(x_fused, x_step, decimal=10)

    def test_cg_update_tmp_protocol(self):
        """update_tmp applies the operator to the RCI work buffer
        (tmp[1] = A @ tmp[0]), not to x."""
        A, b = _spd_system()
        with CGIterativeSparseSolver(A, b) as solver:
            self.assertIsNone(solver.tmp)
            solver.update_tmp()
            self.assertEqual(solver.tmp.shape, (4, A.shape[0]))
            solver.tmp[0] = b
            out = solver.update_tmp()
            npt.assert_array_almost_equal(out, A @ b)
            npt.assert_array_almost_equal(solver.tmp[1], A @ b)

    def test_cg_guards(self):
        A, b = _spd_system()
        with self.assertRaises(ValueError):
            CGIterativeSparseSolver(A.astype(np.float32), b)
        with self.assertRaises(ValueError):
            CGIterativeSparseSolver(A.tocsc(), b)
        with self.assertRaises(NotImplementedError):
            cg(A, b, M="precond")
        with self.assertRaises(NotImplementedError):
            cg(A, b, callback=lambda x: None)


class TestSparseSolverFGMRES(unittest.TestCase):
    def setUp(self):
        self.mat1 = test_matrix.copy()
        self.mat2 = test_rhs.copy()
        self.x0 = test_x0.copy()

    def test_fgmres_solver_square_perfect(self):
        mat3 = np.linalg.lstsq(
            self.mat1.toarray(), test_rhs, rcond=None
        )[0]
        with FGMRESIterativeSparseSolver(
            self.mat1, self.mat2, x=self.x0, verbose=False
        ) as solver:
            solver.set_sparse_matrix_descr(
                SPARSE_MATRIX_TYPE_SYMMETRIC,
                SPARSE_FILL_MODE_UPPER,
                SPARSE_DIAG_NON_UNIT,
            )
            x = solver.solve()
        npt.assert_array_almost_equal(x, mat3)

    def test_fgmres_wrapper_square_perfect(self):
        mat3 = np.linalg.lstsq(
            self.mat1.toarray(), test_rhs, rcond=None
        )[0]
        x, code = fgmres(self.mat1, self.mat2)
        self.assertEqual(code, 0)
        npt.assert_array_almost_equal(x, mat3)

    def test_fgmres_nonsymmetric_system(self):
        n = 40
        rng = np.random.default_rng(11)
        A = sps.random(n, n, density=0.3, random_state=12, format="csr")
        A = (A + n * sps.identity(n)).tocsr()
        b = rng.random(n)
        expect = np.linalg.solve(A.toarray(), b)
        x, code = fgmres(A, b, tol=1e-12)
        self.assertEqual(code, 0)
        npt.assert_array_almost_equal(x, expect)

    def test_fgmres_is_first_party(self):
        """The FGMRES implementation is the in-repo Arnoldi/Givens
        device loop, not a wrapper over jax.scipy's gmres."""
        import inspect
        from sparse_dot_tpu.solvers import iterative as it_mod

        src = inspect.getsource(it_mod)
        self.assertNotIn("jax.scipy.sparse.linalg", src)
        self.assertIn("_fgmres_cycle", src)

    def test_fgmres_fused_matches_stepwise(self):
        """solve() (one compiled loop) must produce the same iterate
        and the same honest cycle / inner-iteration counts as the
        stepwise __next__ protocol — both share _fgmres_cycle."""
        n = 40
        rng = np.random.default_rng(21)
        A = sps.random(n, n, density=0.3, random_state=22, format="csr")
        A = (A + n * sps.identity(n)).tocsr()
        b = rng.random(n)
        with FGMRESIterativeSparseSolver(A, b, r_tol=1e-10) as fused:
            x_fused = fused.solve()
            fused_cycles = fused.current_iter
            fused_inner = fused.total_inner_iterations
        with FGMRESIterativeSparseSolver(A, b, r_tol=1e-10) as stepwise:
            for _ in stepwise:
                pass
            x_step = stepwise.x
            step_cycles = stepwise.current_iter
            step_inner = stepwise.total_inner_iterations
        self.assertEqual(fused.final_code, 0)
        self.assertEqual(fused_cycles, step_cycles)
        self.assertEqual(fused_inner, step_inner)
        npt.assert_array_almost_equal(x_fused, x_step, decimal=10)

    def test_fgmres_iteration_counts_honest(self):
        """current_iter reflects the cycles actually run (a well-
        conditioned small system converges in its first cycle), and
        total_inner_iterations counts the Arnoldi steps the
        convergence test needed — not max_iter fiction."""
        n = 30
        rng = np.random.default_rng(31)
        A = (sps.identity(n) * 4.0).tocsr()
        b = rng.random(n)
        with FGMRESIterativeSparseSolver(
            A, b, r_tol=1e-10, max_iter=50
        ) as solver:
            solver.solve()
            self.assertEqual(solver.final_code, 0)
            self.assertEqual(solver.current_iter, 1)
            self.assertLess(solver.total_inner_iterations, 5)
            self.assertGreater(solver.total_inner_iterations, 0)

    def test_fgmres_max_iter_warns(self):
        n = 40
        rng = np.random.default_rng(41)
        A = sps.random(n, n, density=0.3, random_state=42, format="csr")
        A = (A + n * sps.identity(n)).tocsr()
        b = rng.random(n)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with FGMRESIterativeSparseSolver(
                A, b, max_iter=1, r_tol=1e-30
            ) as solver:
                solver.restart = 2
                solver.solve()
            self.assertEqual(solver.final_code, -1)
            self.assertEqual(solver.current_iter, 1)
            self.assertTrue(
                any(issubclass(x.category, ConvergenceWarning)
                    for x in w)
            )

    def test_fgmres_restart_semantics(self):
        """A small restart forces multiple cycles; the solver still
        converges and counts every cycle."""
        n = 40
        rng = np.random.default_rng(51)
        A = sps.random(n, n, density=0.3, random_state=52, format="csr")
        A = (A + n * sps.identity(n)).tocsr()
        b = rng.random(n)
        expect = np.linalg.solve(A.toarray(), b)
        x, code = fgmres(A, b, tol=1e-12, restart=4)
        self.assertEqual(code, 0)
        npt.assert_array_almost_equal(x, expect)




class TestCGMultiRHS(unittest.TestCase):
    """cg_mrhs — the working analog of MKL's dcgmrhs family, which the
    reference binds but never wraps (``_cfunctions.py:154-168``)."""

    def setUp(self):
        n = 48
        rng = np.random.default_rng(33)
        M = sps.random(n, n, density=0.2, random_state=34, format="csr")
        self.A = (M @ M.T + n * sps.identity(n)).tocsr()
        self.B = rng.random((n, 5))
        self.n = n

    def test_matches_single_rhs(self):
        from sparse_dot_tpu import cg, cg_mrhs

        X, codes = cg_mrhs(self.A, self.B, tol=1e-10)
        np.testing.assert_array_equal(codes, 0)
        oracle = np.linalg.solve(self.A.toarray(), self.B)
        np.testing.assert_allclose(X, oracle, atol=1e-7)
        # column 0 must agree with the single-RHS solver
        x0, code0 = cg(self.A, self.B[:, 0], tol=1e-10)
        self.assertEqual(code0, 0)
        np.testing.assert_allclose(X[:, 0], x0, atol=1e-9)

    def test_shape_guards(self):
        from sparse_dot_tpu import cg_mrhs

        with self.assertRaises(ValueError):
            cg_mrhs(self.A, self.B[:, 0])  # 1-D B
        with self.assertRaises(ValueError):
            cg_mrhs(self.A, self.B[:-1])  # wrong n
        with self.assertRaises(ValueError):
            cg_mrhs(self.A, self.B, X0=np.zeros((self.n, 2)))

    def test_nonconvergence_codes(self):
        from sparse_dot_tpu import cg_mrhs
        from sparse_dot_tpu.solvers.iterative import ConvergenceWarning

        with warnings.catch_warnings():
            warnings.simplefilter("error", ConvergenceWarning)
            with self.assertRaises(ConvergenceWarning):
                cg_mrhs(self.A, self.B, tol=1e-14, maxiter=1)




class TestEllSolverLoops(unittest.TestCase):
    """Non-degenerate binned-ELL layouts so the gather-form solver
    loops (round 4) actually run on the CPU suite — the 8x8 protocol
    fixtures degenerate to the COO fallback (pad-ratio gate), which is
    how a missing-argument bug in the ELL FGMRES path once slipped past
    the suite."""

    def setUp(self):
        n = 2000
        rng = np.random.default_rng(17)
        nnz = 40_000
        M = sps.csr_matrix(
            (rng.standard_normal(nnz),
             (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
            shape=(n, n),
        )
        M.sum_duplicates()
        self.A = (0.05 * (M + M.T) + 20.0 * sps.identity(n)).tocsr()
        self.n = n
        self.x_true = rng.standard_normal(n)
        self.b = self.A @ self.x_true

    def test_layout_engages(self):
        from sparse_dot_tpu import formats

        Ad = formats.CSR.from_scipy(self.A)
        self.assertIsNotNone(Ad.ell_parts_binned())

    def test_cg_ell(self):
        from sparse_dot_tpu import cg

        x, code = cg(self.A, self.b, tol=1e-12)
        self.assertEqual(code, 0)
        npt.assert_allclose(x, self.x_true, atol=1e-8)

    def test_fgmres_ell(self):
        from sparse_dot_tpu import fgmres

        x, code = fgmres(self.A, self.b, tol=1e-12)
        self.assertEqual(code, 0)
        npt.assert_allclose(x, self.x_true, atol=1e-7)

    def test_fgmres_stepwise_matches_fused_ell(self):
        x_f = None
        with FGMRESIterativeSparseSolver(
            self.A, self.b, r_tol=1e-10
        ) as fused:
            x_f = fused.solve()
            cycles = fused.current_iter
        with FGMRESIterativeSparseSolver(
            self.A, self.b, r_tol=1e-10
        ) as stepwise:
            for _ in stepwise:
                pass
            x_s = stepwise.x
            s_cycles = stepwise.current_iter
        self.assertEqual(cycles, s_cycles)
        npt.assert_array_almost_equal(x_f, x_s, decimal=10)

    def test_qr_cgls_ell(self):
        from sparse_dot_tpu import sparse_qr_solve_mkl
        from sparse_dot_tpu.solvers import qr as _qr

        old = _qr._QR_DENSIFY_BUDGET
        _qr._QR_DENSIFY_BUDGET = 1  # force the CGLS route
        try:
            m, k = 3000, 500
            rng = np.random.default_rng(23)
            nnz = 30_000
            A = sps.csr_matrix(
                (rng.standard_normal(nnz),
                 (rng.integers(0, m, nnz), rng.integers(0, k, nnz))),
                shape=(m, k),
            )
            A = A + sps.vstack(
                [4.0 * sps.identity(k), sps.csr_matrix((m - k, k))]
            ).tocsr()
            A.sum_duplicates()
            xt = rng.standard_normal(k)
            b = A @ xt
            x = sparse_qr_solve_mkl(A.tocsr(), b)
            npt.assert_allclose(x, xt, atol=1e-8)
        finally:
            _qr._QR_DENSIFY_BUDGET = old




class TestEllKillSwitch(unittest.TestCase):
    """config.ell_binned = False must force the COO fallback in the
    solver loops (the same escape hatch the SpMM path honors)."""

    def test_cg_coo_fallback(self):
        from sparse_dot_tpu import cg
        from sparse_dot_tpu.config import config

        n = 1500
        rng = np.random.default_rng(19)
        nnz = 30_000
        M = sps.csr_matrix(
            (rng.standard_normal(nnz),
             (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
            shape=(n, n),
        )
        M.sum_duplicates()
        A = (0.05 * (M + M.T) + 20.0 * sps.identity(n)).tocsr()
        xt = rng.standard_normal(n)
        b = A @ xt
        config.ell_binned = False
        try:
            x, code = cg(A, b, tol=1e-12)
        finally:
            config.ell_binned = True
        self.assertEqual(code, 0)
        npt.assert_allclose(x, xt, atol=1e-8)


if __name__ == "__main__":
    unittest.main()


class TestEllHiloRangeGate(unittest.TestCase):
    """The binned-ELL loops split f64 iterates into hi|lo f32 pairs —
    exact inside f32's range, but |x| beyond ~3.4e38 saturates to inf.
    b outside that range must route to the exact-f64 gather
    (``_hilo_safe`` gate) and still solve correctly."""

    def _system(self):
        n = 2000
        rng = np.random.default_rng(29)
        nnz = 40_000
        M = sps.csr_matrix(
            (rng.standard_normal(nnz),
             (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
            shape=(n, n),
        )
        M.sum_duplicates()
        A = (0.05 * (M + M.T) + 20.0 * sps.identity(n)).tocsr()
        x_true = rng.standard_normal(n) * 1e60  # far beyond f32 range
        return A, x_true, A @ x_true

    def test_cg_huge_scale(self):
        from sparse_dot_tpu import cg

        A, x_true, b = self._system()
        x, code = cg(A, b, tol=1e-12)
        self.assertEqual(code, 0)
        self.assertTrue(np.isfinite(x).all())
        npt.assert_allclose(x, x_true, rtol=1e-8)

    def test_fgmres_huge_scale(self):
        from sparse_dot_tpu import fgmres

        A, x_true, b = self._system()
        x, code = fgmres(A, b, tol=1e-12)
        self.assertEqual(code, 0)
        self.assertTrue(np.isfinite(x).all())
        npt.assert_allclose(x, x_true, rtol=1e-7)

    def test_cg_mrhs_huge_scale(self):
        from sparse_dot_tpu.solvers import cg_mrhs

        A, x_true, b = self._system()
        B = np.stack([b, 2.0 * b], axis=1)
        X, codes = cg_mrhs(A, B, tol=1e-12)
        self.assertTrue((codes == 0).all())
        self.assertTrue(np.isfinite(X).all())
        npt.assert_allclose(X[:, 0], x_true, rtol=1e-8)



    def test_cg_tiny_scale(self):
        # Nonzero magnitudes below the f32 subnormal-flush floor must
        # route to the exact-f64 matvec (review r5 finding: the gate
        # only checked the overflow side).
        from sparse_dot_tpu import cg

        A, x_true, b = self._system()
        scale = 1e-45
        x, code = cg(A, b * scale, tol=1e-12)
        self.assertEqual(code, 0)
        npt.assert_allclose(x, x_true * scale, rtol=1e-8)

    def test_stepwise_matvec_gates_per_call(self):
        # The RCI protocol applies the operator to arbitrary work
        # vectors; the hi|lo decision must be made per call, not baked
        # from b (review r5 finding).
        A, x_true, b = self._system()
        with CGIterativeSparseSolver(A, np.ones(A.shape[0])) as solver:
            if solver.tmp is None:
                solver.tmp = np.zeros((4, solver.n), dtype=np.float64)
            v = np.random.default_rng(3).standard_normal(solver.n)
            v *= 1e60  # far beyond f32 range
            solver.tmp[0] = v
            out = solver.update_tmp()
            self.assertTrue(np.isfinite(out).all())
            npt.assert_allclose(out, A @ v, rtol=1e-10)

    def test_qr_cgls_huge_scale(self):
        from sparse_dot_tpu import sparse_qr_solve_mkl
        from sparse_dot_tpu.solvers import qr as _qr

        old = _qr._QR_DENSIFY_BUDGET
        _qr._QR_DENSIFY_BUDGET = 1  # force the CGLS route
        try:
            m, k = 3000, 400
            rng = np.random.default_rng(31)
            nnz = 30_000
            A = sps.csr_matrix(
                (rng.standard_normal(nnz),
                 (rng.integers(0, m, nnz), rng.integers(0, k, nnz))),
                shape=(m, k),
            )
            A = A + sps.vstack(
                [4.0 * sps.identity(k), sps.csr_matrix((m - k, k))]
            ).tocsr()
            A.sum_duplicates()
            xt = rng.standard_normal(k) * 1e60
            b = A @ xt
            x = sparse_qr_solve_mkl(A.tocsr(), b)
            self.assertTrue(np.isfinite(x).all())
            npt.assert_allclose(x, xt, rtol=1e-8)
        finally:
            _qr._QR_DENSIFY_BUDGET = old


class TestCGMrhsDtypeGuard(unittest.TestCase):
    def test_complex_rejected(self):
        # Same dtype contract as cg() — complex A must raise, not
        # silently solve against Re(A) (review r5 finding).
        from sparse_dot_tpu.solvers import cg_mrhs

        n = 20
        M = sps.random(n, n, density=0.3, random_state=7, format="csr")
        Ac = (M + M.T + n * sps.identity(n)).astype(np.complex128).tocsr()
        with self.assertRaises(ValueError):
            cg_mrhs(Ac, np.ones((n, 2)))

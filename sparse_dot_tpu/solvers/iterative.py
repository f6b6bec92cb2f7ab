"""Iterative sparse solvers (CG / FGMRES) as device-resident loops.

The reference drives MKL's reverse-communication interface: every
iteration crosses the FFI boundary for one ``dcg``/``dfgmres`` step plus
an SpMV (``/root/reference/sparse_dot_mkl/solvers/_iss.py:207-220``,
``_cg.py:162-173``, ``_fgmres.py:360-373``).  Owning the matvec inverts
that control: the whole solve is a ``lax.while_loop``-style loop over the
device SpMV kernel with no per-iteration host round-trip.

API parity: the solver classes keep the reference's protocol — context
manager, iterator (one step per ``__next__``), ``solve()``,
``set_sparse_matrix_descr`` with the symmetric/fill-mode descriptor, an
``ipar``/``dpar`` parameter block — and the scipy-like ``cg()`` /
``fgmres()`` convenience wrappers return ``(x, code)``.
"""

import warnings
from functools import partial

import numpy as np
import scipy.sparse as _sps

import jax
import jax.numpy as jnp

from .. import formats
from ..config import config
from ..interface import (
    sparse_handle_t,
    SPARSE_MATRIX_TYPE_GENERAL,
    SPARSE_MATRIX_TYPE_SYMMETRIC,
    SPARSE_FILL_MODE_FULL,
    SPARSE_DIAG_NON_UNIT,
)
from ..ops import _xla
from ..ops.host import coo_parts

# Every product in the solver loops asks for full precision: a float32
# product at DEFAULT may run in TF32 on a GPU (~1e-3 relative).
_HIGHEST = jax.lax.Precision.HIGHEST

DEFAULT_ATOL = 0.0
DEFAULT_RTOL = 1e-6
DEFAULT_MAX_ITER = 1000

_HILO_ABS_MAX = 3.0e38  # just under f32 max
# Floor = min_normal_f32 * 2^25 ~ 4e-31: the LO limb of a hi|lo split
# carries ~|v| * 2^-25 and must stay a NORMAL f32 for the split to be
# exact (review r5 finding; matches ops.host._HILO_ABS_MIN).
_HILO_ABS_MIN = 4.0e-31


def _hilo_safe(*arrays):
    """True when every magnitude is inside the f32-representable
    window, so the ELL loops' hi|lo iterate split can neither saturate
    (|x| > ~3.4e38 -> inf) nor flush (nonzero |x| below the f32
    subnormal floor -> 0; the split is exact to ~2^-49 INSIDE the
    window).  Gated on b/x0 — the anchors that set the solve's scale —
    before choosing the split form of the binned-ELL matvec."""
    for a in arrays:
        if a is None:
            continue
        a = np.abs(np.asarray(a).reshape(-1))
        if a.size == 0:
            continue
        m = float(a.max())
        if not np.isfinite(m) or m > _HILO_ABS_MAX:
            return False
        nz = a[a > 0]
        if nz.size and float(nz.min()) < _HILO_ABS_MIN:
            return False
    return True


class ConvergenceWarning(UserWarning):
    pass


def _as_container(A):
    if isinstance(A, sparse_handle_t):
        return A._live()
    if formats.is_device_sparse(A):
        return A
    if _sps.issparse(A) and A.format == "csr":
        return formats.CSR.from_scipy(A)
    return None


def _cg_loop_body(mv, b, x0, threshold, maxiter):
    """Shared CG state machine (see :func:`_cg_device_loop` for the
    step-order/convergence contract); ``mv`` supplies the matvec —
    COO or binned-ELL."""
    r0 = b - mv(x0)
    rs0 = jnp.vdot(r0, r0, precision=_HIGHEST)

    def cond(state):
        _, _, _, rs, it, done = state
        return jnp.logical_and(~done, it < maxiter)

    def body(state):
        x, r, p, rs, it, _ = state
        sp = mv(p)
        denom = jnp.vdot(p, sp, precision=_HIGHEST)
        alpha = jnp.where(denom != 0, rs / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * sp
        rs_new = jnp.vdot(r, r, precision=_HIGHEST)
        beta = jnp.where(rs != 0, rs_new / rs, 0.0)
        p = r + beta * p
        done = jnp.sqrt(rs_new) <= threshold
        return (x, r, p, rs_new, it + 1, done)

    state = (x0, r0, r0, rs0, jnp.asarray(0, jnp.int32),
             jnp.asarray(False))
    x, _, _, rs, it, _ = jax.lax.while_loop(cond, body, state)
    return x, rs, it


@partial(jax.jit, static_argnames=("segs", "split"))
def _cg_ell_device_loop(cols_flat, vals_flat, invpos, b, x0, threshold,
                        maxiter, segs, split=True):
    """:func:`_cg_device_loop` with the matvec on the binned-ELL
    windowed-gather kernel instead of the COO scatter-add (f64
    scatter-adds plus 1-wide gathers).  Identical step order and
    convergence test.  ``split=False`` (callers pass
    ``_hilo_safe(...)``) keeps the iterate gather exact f64 when the
    problem scale is outside the hi|lo split's f32 range."""
    split = split and vals_flat.dtype == jnp.float64

    def mv(v):
        return _xla.ell_spmm_binned(
            cols_flat, vals_flat, v[:, None], invpos, segs=segs,
            split_b=split,
        )[:, 0]

    return _cg_loop_body(mv, b, x0, threshold, maxiter)


@partial(jax.jit, static_argnames=("segs", "split"))
def _cg_mrhs_ell_loop(cols_flat, vals_flat, invpos, B, X0, thresholds,
                      maxiter, segs, split=True):
    """Multi-RHS CG on ONE binned-ELL product per step: all columns
    advance together with per-column scalars; a converged column is
    frozen (zero-length steps, search direction untouched), so each
    column's iterates match its single-RHS solve exactly.  Returns
    (X, final squared residual norms)."""
    split = split and vals_flat.dtype == jnp.float64

    def mv(V):
        return _xla.ell_spmm_binned(
            cols_flat, vals_flat, V, invpos, segs=segs, split_b=split,
        )

    R0 = B - mv(X0)
    rs0 = jnp.sum(R0 * R0, axis=0)
    thr2 = thresholds * thresholds

    def cond(state):
        _, _, _, rs, it = state
        return jnp.logical_and(jnp.any(rs > thr2), it < maxiter)

    def body(state):
        X, R, P, rs, it = state
        active = rs > thr2
        SP = mv(P)
        denom = jnp.sum(P * SP, axis=0)
        alpha = jnp.where(active & (denom != 0), rs / denom, 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * SP
        rs_new = jnp.sum(R * R, axis=0)
        beta = jnp.where(active & (rs != 0), rs_new / rs, 0.0)
        P = jnp.where(active[None, :], R + beta[None, :] * P, P)
        rs = jnp.where(active, rs_new, rs)
        return (X, R, P, rs, it + 1)

    state = (X0, R0, R0, rs0, jnp.asarray(0, jnp.int32))
    X, _, _, rs, _ = jax.lax.while_loop(cond, body, state)
    return X, rs


@partial(jax.jit, static_argnames=("n",))
def _cg_device_loop(rows, cols, vals, b, x0, threshold, maxiter, n):
    """Whole CG solve as one compiled ``lax.while_loop`` — zero host
    round-trips per iteration (the inversion of the reference's RCI,
    which crosses the FFI boundary every step,
    ``/root/reference/sparse_dot_mkl/solvers/_iss.py:207-220``).

    Returns (x, rs, it): the iterate, the squared residual norm, and
    the number of CG steps taken.  Step order and convergence test
    (``sqrt(rs_new) <= threshold`` after the update) match the
    stepwise :class:`CGIterativeSparseSolver` exactly, so iteration
    counts agree.
    """

    def mv(v):
        return _xla.coo_spmv(rows, cols, vals, v, m=n)

    return _cg_loop_body(mv, b, x0, threshold, maxiter)


class IterativeSparseSolver:
    """Base solver: operator construction, protocol plumbing.

    Subclasses implement ``solve_iteration`` (one step, returns True when
    converged) and may override ``solve`` with a fused device loop.
    """

    solver_name = "iterative"

    def __init__(self, A, b, x=None, ipar=None, dpar=None, tmp=None,
                 max_iter=DEFAULT_MAX_ITER, a_tol=DEFAULT_ATOL,
                 r_tol=DEFAULT_RTOL, verbose=False, n=None):

        self.current_iter, self.max_iter = 0, max_iter
        self.a_tol = DEFAULT_ATOL if a_tol is None else a_tol
        self.r_tol = DEFAULT_RTOL if r_tol is None else r_tol
        self.verbose = verbose
        self.final_code = None

        is_handle = isinstance(A, (sparse_handle_t,)) or (
            formats.is_device_sparse(A)
        )
        if is_handle and n is None:
            raise ValueError(
                "If A is a sparse handle, n must be passed as well"
            )

        container = _as_container(A)
        if container is None:
            raise ValueError(
                "Matrix A must be a double-precision scipy CSR matrix "
                "or a sparse handle"
            )
        if not is_handle:
            if np.dtype(container.dtype) != np.dtype(np.float64):
                raise ValueError(
                    "Matrix A must be a double-precision scipy CSR matrix "
                    "or a sparse handle"
                )
            if n is not None and A.shape[1] != n:
                raise ValueError(
                    f"n = {n} does not align with matrix A ({A.shape})"
                )
            if n is None:
                n = A.shape[1]

        self.A = container
        self.n = int(n)

        # RHS: flatten; tolerate short RHS by zero-padding to n (the
        # reference's RCI reads n entries regardless).
        b = np.asarray(b, dtype=np.float64).ravel()
        if b.shape[0] < self.n:
            b = np.concatenate([b, np.zeros(self.n - b.shape[0])])
        self.b = b

        if x is None:
            self.x = np.zeros(self.n, dtype=np.float64)
        else:
            self.x = np.asarray(x, dtype=np.float64).flatten()
            if self.x.shape[0] != self.n:
                raise ValueError(
                    f"x ({self.x.shape}) does not align with n = {self.n}"
                )

        # Parameter blocks kept for protocol parity with the RCI API.
        self.ipar = np.zeros(128, dtype=np.int64) if ipar is None else ipar
        self.dpar = np.zeros(128, dtype=np.float64) if dpar is None else dpar
        self.tmp = tmp

        self.set_sparse_matrix_descr()
        self.set_initial_parameters()

        self._op_cache = None

    # -- descriptor / operator ---------------------------------------------

    def set_sparse_matrix_descr(self,
                                matrix_type=SPARSE_MATRIX_TYPE_GENERAL,
                                fill_mode=SPARSE_FILL_MODE_FULL,
                                diag=SPARSE_DIAG_NON_UNIT):
        self.matrix_A_descr = (matrix_type, fill_mode, diag)
        self._op_cache = None

    def set_initial_parameters(self):
        self.ipar[4] = self.max_iter
        self.dpar[0] = self.r_tol
        self.dpar[1] = self.a_tol

    def _operator_coo(self):
        """Expanded-COO arrays of the effective operator, honoring the
        descriptor.  Symmetric descriptors symmetrize the stored
        triangle S = T + T^T - diag(T) by concatenating the transposed
        entries and a negated diagonal (pad entries carry row id ``n``
        and are dropped by the scatter) — one triple feeds both the
        stepwise matvec and the fused device loop."""
        rows, cols, vals, m, k = coo_parts(self.A)
        n = self.n
        if self.matrix_A_descr[0] == SPARSE_MATRIX_TYPE_SYMMETRIC:
            diag_mask = rows == cols
            d_rows = jnp.where(diag_mask, rows, n).astype(rows.dtype)
            d_vals = jnp.where(diag_mask, -vals, 0.0)
            rows, cols, vals = (
                jnp.concatenate([rows, cols, d_rows]),
                jnp.concatenate([cols, rows, d_rows]),
                jnp.concatenate([vals, vals, d_vals]),
            )
        return rows, cols, vals

    def _operator_ell_binned(self):
        """Binned-ELL layout of the operator for the gather-form device
        loops, or None (symmetric descriptor — the symmetrized operator
        is COO-only — or non-CSR container, a degenerate layout, or the
        ``config.ell_binned`` kill-switch, which must disable the
        binned kernel here just like on the SpMM path)."""
        if not getattr(config, "ell_binned", True):
            return None
        if self.matrix_A_descr[0] == SPARSE_MATRIX_TYPE_SYMMETRIC:
            return None
        if not isinstance(self.A, formats.CSR):
            return None
        return self.A.ell_parts_binned()

    def _operator(self):
        """Build the (n -> n) matvec closure from the stored matrix and
        the descriptor.  Uses the binned-ELL gather kernel when the
        layout admits it — the same kernel the fused CG loop uses, so
        stepwise and fused iterates share one summation order.

        The closure takes the hi|lo ``split`` flag PER CALL (static jit
        arg): the stepwise RCI protocol applies the operator to
        arbitrary user-written work vectors, so the range decision
        cannot be baked in from ``b`` alone (review r5 finding)."""
        if self._op_cache is not None:
            return self._op_cache

        n = self.n
        binned = self._operator_ell_binned()
        if binned is not None:
            segs, cols_flat, vals_flat, invpos = binned
            vals64 = vals_flat.astype(jnp.float64)

            @partial(jax.jit, static_argnames=("split",))
            def op(v, split=True):
                return _xla.ell_spmm_binned(
                    cols_flat, vals64, v[:, None], invpos, segs=segs,
                    split_b=split,
                )[:, 0]
        else:
            rows, cols, vals = self._operator_coo()

            @jax.jit
            def _op_coo(v):
                return _xla.coo_spmv(rows, cols, vals, v, m=n)

            def op(v, split=True):
                return _op_coo(v)

        self._op_cache = op
        return op

    def _apply_operator(self, v_np):
        """Apply the matvec to a host vector with the per-call hi|lo
        range gate."""
        return self._operator()(
            jnp.asarray(v_np), split=_hilo_safe(v_np)
        )

    def update_tmp(self):
        """Protocol-parity hook: the RCI matvec ``tmp[1] = A @ tmp[0]``
        (reference ``_cg.py:288-297`` updates the flat work buffer, not
        ``x``).  Allocates the work block lazily like the reference's
        ``_iss.py:232-278``."""
        if self.tmp is None:
            self.tmp = np.zeros((4, self.n), dtype=np.float64)
        self.tmp[1] = np.asarray(self._apply_operator(self.tmp[0]))
        return self.tmp[1]

    # -- convergence --------------------------------------------------------

    def _threshold(self):
        b_norm = float(np.linalg.norm(self.b))
        return max(self.r_tol * b_norm, self.a_tol, 0.0)

    def _converged(self, r_norm):
        thr = self._threshold()
        if thr == 0.0:
            thr = 1e-12
        return r_norm <= thr

    # -- context manager / iterator ----------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.A = None
        self._op_cache = None
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self.current_iter >= self.max_iter:
            raise StopIteration
        converged = self.solve_iteration()
        self.current_iter += 1
        if converged:
            self.final_code = 0
            raise StopIteration
        return 1

    def solve_iteration(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def solve(self):
        if np.linalg.norm(self.b) == 0.0:
            # Trivial RHS: the least-squares solution is x = 0.
            self.x = np.zeros(self.n, dtype=np.float64)
            self.final_code = 0
            return self.x

        for _ in self:
            pass

        if self.final_code != 0:
            warnings.warn(
                f"{self.solver_name} did not converge within "
                f"{self.max_iter} iterations",
                ConvergenceWarning,
            )
            self.final_code = -1 if self.final_code is None else (
                self.final_code
            )
        return self.x


class CGIterativeSparseSolver(IterativeSparseSolver):
    """Conjugate gradient.  One CG step per ``__next__``; the math runs
    on device, the loop control on host (the fused-loop fast path lives
    in the :func:`cg` wrapper)."""

    solver_name = "cg"

    def _ensure_state(self):
        if getattr(self, "_r", None) is None:
            # CG iterates scale with (b, x0): one range decision for
            # the whole stepwise solve, matching the fused loop's gate.
            self._split = _hilo_safe(self.b, self.x)
            op = self._operator()
            x = jnp.asarray(self.x)
            r = jnp.asarray(self.b) - op(x, split=self._split)
            self._r = r
            self._p = r
            self._rs = jnp.vdot(r, r, precision=_HIGHEST)

    def solve_iteration(self):
        self._ensure_state()
        op = self._operator()
        p = self._p
        sp = op(p, split=self._split)
        denom = jnp.vdot(p, sp, precision=_HIGHEST)
        alpha = jnp.where(denom != 0, self._rs / denom, 0.0)
        x = jnp.asarray(self.x) + alpha * p
        r = self._r - alpha * sp
        rs_new = jnp.vdot(r, r, precision=_HIGHEST)
        beta = jnp.where(self._rs != 0, rs_new / self._rs, 0.0)
        self._p = r + beta * p
        self._r = r
        self._rs = rs_new
        self.x = np.asarray(x)
        return self._converged(float(jnp.sqrt(rs_new)))

    def solve(self):
        """Full solve as ONE compiled device loop (O(1) host syncs,
        versus the reference's per-iteration FFI crossing).  The
        stepwise iterator protocol (``__next__``) remains available and
        produces identical iterates/iteration counts."""
        if np.linalg.norm(self.b) == 0.0:
            self.x = np.zeros(self.n, dtype=np.float64)
            self.final_code = 0
            return self.x

        thr = self._threshold()
        if thr == 0.0:
            thr = 1e-12
        binned = self._operator_ell_binned()
        if binned is not None:
            segs, cols_flat, vals_flat, invpos = binned
            x, rs, it = _cg_ell_device_loop(
                cols_flat, vals_flat.astype(jnp.float64), invpos,
                jnp.asarray(self.b), jnp.asarray(self.x),
                jnp.asarray(thr, jnp.float64),
                jnp.asarray(self.max_iter, jnp.int32),
                segs=segs, split=_hilo_safe(self.b, self.x),
            )
        else:
            rows, cols, vals = self._operator_coo()
            x, rs, it = _cg_device_loop(
                rows, cols, vals,
                jnp.asarray(self.b), jnp.asarray(self.x),
                jnp.asarray(thr, jnp.float64),
                jnp.asarray(self.max_iter, jnp.int32),
                n=self.n,
            )
        # One readback for the result, the residual, and the count.
        x_np = np.asarray(x)
        self.x = x_np
        self.current_iter = int(it)
        if float(np.sqrt(rs)) <= thr:
            self.final_code = 0
        else:
            warnings.warn(
                f"{self.solver_name} did not converge within "
                f"{self.max_iter} iterations",
                ConvergenceWarning,
            )
            self.final_code = -1
        return self.x


def _fgmres_cycle_body(mv, b, x, threshold, n, restart):
    """One restarted-FGMRES (Arnoldi + Givens) cycle, fully on device.

    First-party replacement for the reference's MKL RCI FGMRES
    (``/root/reference/sparse_dot_mkl/solvers/_fgmres.py:360-430``):
    the fixed (restart+1, n) Krylov workspace plays the role of the
    reference's flat tmp buffer with its ipar[21]/[22] matvec offsets —
    here the matvec is inlined, so no offsets cross any boundary.

    Orthogonalization is CGS2 (classical Gram-Schmidt, two passes) —
    numerically equivalent to modified GS for Arnoldi while mapping to
    two (restart+1, n) matvecs instead of a serial per-vector loop.
    The Hessenberg column is rotated by the stored Givens pairs, a new
    rotation annihilates the subdiagonal, and |g[j+1]| tracks the
    residual norm exactly (no extra matvec per cycle).

    Returns (x_new, resid, inner_used): the updated iterate, the final
    residual-norm estimate, and the number of Arnoldi steps the
    convergence test actually needed (<= restart) — the honest inner
    iteration count.
    """

    r = b - mv(x)
    beta = jnp.linalg.norm(r)
    safe_beta = jnp.where(beta == 0, 1.0, beta)

    V = jnp.zeros((restart + 1, n), x.dtype).at[0].set(r / safe_beta)
    R = jnp.zeros((restart + 1, restart), x.dtype)  # rotated Hessenberg
    cs = jnp.zeros((restart,), x.dtype)
    sn = jnp.zeros((restart,), x.dtype)
    g = jnp.zeros((restart + 1,), x.dtype).at[0].set(beta)
    ju0 = jnp.asarray(restart, jnp.int32)
    ju0 = jnp.where(beta <= threshold, 0, ju0)

    def body(j, carry):
        V, R, cs, sn, g, ju = carry
        w = mv(V[j])
        # CGS2: two projection passes against V[0..j] (masked matmuls).
        row_mask = (
            jnp.arange(restart + 1) <= j
        ).astype(x.dtype)
        h1 = jnp.dot(V, w, precision=_HIGHEST) * row_mask
        w = w - jnp.dot(V.T, h1, precision=_HIGHEST)
        h2 = jnp.dot(V, w, precision=_HIGHEST) * row_mask
        w = w - jnp.dot(V.T, h2, precision=_HIGHEST)
        hcol = h1 + h2
        hj1 = jnp.linalg.norm(w)
        hcol = hcol.at[j + 1].set(hj1)
        V = V.at[j + 1].set(w / jnp.where(hj1 == 0, 1.0, hj1))

        # Apply the stored Givens rotations to the new column.
        def rot(i, hc):
            pred = i < j
            h_i = cs[i] * hc[i] + sn[i] * hc[i + 1]
            h_i1 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
            hc = hc.at[i].set(jnp.where(pred, h_i, hc[i]))
            return hc.at[i + 1].set(jnp.where(pred, h_i1, hc[i + 1]))

        hcol = jax.lax.fori_loop(0, restart, rot, hcol)

        # New rotation annihilating the subdiagonal entry.
        denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        c_new = jnp.where(denom == 0, 1.0, hcol[j] / denom)
        s_new = jnp.where(denom == 0, 0.0, hcol[j + 1] / denom)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        hcol = hcol.at[j].set(c_new * hcol[j] + s_new * hcol[j + 1])
        hcol = hcol.at[j + 1].set(0.0)
        g_j = g[j]
        g = g.at[j].set(c_new * g_j)
        g = g.at[j + 1].set(-s_new * g_j)

        R = R.at[:, j].set(hcol)
        # First step whose rotated residual |g[j+1]| clears the
        # threshold: the honest inner iteration count.
        hit = (jnp.abs(g[j + 1]) <= threshold) & (ju == restart)
        ju = jnp.where(hit, j + 1, ju)
        return (V, R, cs, sn, g, ju)

    V, R, cs, sn, g, ju = jax.lax.fori_loop(
        0, restart, body, (V, R, cs, sn, g, ju0)
    )

    # Back-substitution on the leading ju x ju triangle (columns past
    # ju masked to zero so the converged-early solution is exact).
    def back(idx, y):
        i = restart - 1 - idx
        valid = i < ju
        num = g[i] - jnp.dot(R[i, :restart], y, precision=_HIGHEST)
        den = jnp.where(R[i, i] == 0, 1.0, R[i, i])
        return y.at[i].set(jnp.where(valid, num / den, 0.0))

    y = jax.lax.fori_loop(
        0, restart, back, jnp.zeros((restart,), x.dtype)
    )
    x_new = x + jnp.dot(V[:restart].T, y, precision=_HIGHEST)
    resid = jnp.abs(g[jnp.minimum(ju, restart)])
    resid = jnp.where(ju == 0, beta, resid)
    return x_new, resid, ju


@partial(jax.jit, static_argnames=("n", "restart"))
def _fgmres_cycle(rows, cols, vals, b, x, threshold, n, restart):
    """COO-matvec wrapper of :func:`_fgmres_cycle_body`."""

    def mv(v):
        return _xla.coo_spmv(rows, cols, vals, v, m=n)

    return _fgmres_cycle_body(mv, b, x, threshold, n, restart)


@partial(jax.jit, static_argnames=("n", "restart", "segs", "split"))
def _fgmres_cycle_ell(cols_flat, vals_flat, invpos, b, x, threshold, n,
                      restart, segs, split=True):
    """Binned-ELL (windowed gather) matvec wrapper of
    :func:`_fgmres_cycle_body` — see :func:`_cg_ell_device_loop` for
    why the gather form beats COO by ~20x at millions of nonzeros and
    for the ``split`` range gate."""

    def mv(v):
        return _xla.ell_spmm_binned(
            cols_flat, vals_flat, v[:, None], invpos, segs=segs,
            split_b=split,
        )[:, 0]

    return _fgmres_cycle_body(mv, b, x, threshold, n, restart)


def _fgmres_loop_body(mv_cycle, mv, b, x0, threshold, maxiter):
    def cond(state):
        _, resid, it, _, done = state
        return jnp.logical_and(~done, it < maxiter)

    def body(state):
        x, _, it, inner, _ = state
        x, resid, ju = mv_cycle(b, x, threshold)
        done = resid <= threshold
        return (x, resid, it + 1, inner + ju, done)

    r0 = b - mv(x0)
    beta0 = jnp.linalg.norm(r0)
    state = (x0, beta0, jnp.asarray(0, jnp.int32),
             jnp.asarray(0, jnp.int32), beta0 <= threshold)
    x, resid, it, inner, _ = jax.lax.while_loop(cond, body, state)
    return x, resid, it, inner


@partial(jax.jit, static_argnames=("n", "restart"))
def _fgmres_device_loop(rows, cols, vals, b, x0, threshold, maxiter, n,
                        restart):
    """Whole restarted-FGMRES solve as one compiled loop: cycles run
    inside ``lax.while_loop`` with zero host round-trips (vs the
    reference's per-iteration RCI crossing).  Returns
    (x, resid, cycles, inner_total)."""

    def mv(v):
        return _xla.coo_spmv(rows, cols, vals, v, m=n)

    def mv_cycle(b_, x_, thr_):
        return _fgmres_cycle_body(mv, b_, x_, thr_, n, restart)

    return _fgmres_loop_body(mv_cycle, mv, b, x0, threshold, maxiter)


@partial(jax.jit, static_argnames=("n", "restart", "segs", "split"))
def _fgmres_ell_device_loop(cols_flat, vals_flat, invpos, b, x0,
                            threshold, maxiter, n, restart, segs,
                            split=True):
    """:func:`_fgmres_device_loop` with binned-ELL gather matvecs."""

    def mv(v):
        return _xla.ell_spmm_binned(
            cols_flat, vals_flat, v[:, None], invpos, segs=segs,
            split_b=split,
        )[:, 0]

    def mv_cycle(b_, x_, thr_):
        return _fgmres_cycle_body(mv, b_, x_, thr_, n, restart)

    return _fgmres_loop_body(mv_cycle, mv, b, x0, threshold, maxiter)


class FGMRESIterativeSparseSolver(IterativeSparseSolver):
    """Flexible GMRES via first-party restarted Arnoldi cycles on
    device (:func:`_fgmres_cycle`).  Each ``__next__`` runs one restart
    cycle; ``solve()`` fuses all cycles into one compiled loop.  Both
    paths share the same cycle program, so iterates and iteration
    counts agree exactly.

    ``current_iter`` counts restart CYCLES (one per ``__next__``, like
    the stepwise protocol); ``total_inner_iterations`` counts Arnoldi
    steps (matvecs) the convergence test needed — the reference RCI's
    ipar iteration counter analog.
    """

    solver_name = "fgmres"
    restart = 20
    total_inner_iterations = 0

    def _threshold_value(self):
        thr = self._threshold()
        return 1e-12 if thr == 0.0 else thr

    def solve_iteration(self):
        # Same matvec form as solve() (ELL when the layout admits it)
        # so stepwise and fused iterates share one summation order.
        binned = self._operator_ell_binned()
        if binned is not None:
            segs, cols_flat, vals_flat, invpos = binned
            x, resid, ju = _fgmres_cycle_ell(
                cols_flat, vals_flat.astype(jnp.float64), invpos,
                jnp.asarray(self.b), jnp.asarray(self.x),
                jnp.asarray(self._threshold_value(), jnp.float64),
                n=self.n, restart=min(self.restart, self.n), segs=segs,
                split=_hilo_safe(self.b, self.x),
            )
        else:
            rows, cols, vals = self._operator_coo()
            x, resid, ju = _fgmres_cycle(
                rows, cols, vals,
                jnp.asarray(self.b), jnp.asarray(self.x),
                jnp.asarray(self._threshold_value(), jnp.float64),
                n=self.n, restart=min(self.restart, self.n),
            )
        self.x = np.asarray(x)
        self.total_inner_iterations += int(ju)
        return float(resid) <= self._threshold_value()

    def solve(self):
        """Full solve as ONE compiled device loop (O(1) host syncs);
        honest cycle/inner-iteration counts read back with the
        result."""
        if np.linalg.norm(self.b) == 0.0:
            self.x = np.zeros(self.n, dtype=np.float64)
            self.final_code = 0
            return self.x

        thr = self._threshold_value()
        binned = self._operator_ell_binned()
        if binned is not None:
            segs, cols_flat, vals_flat, invpos = binned
            x, resid, cycles, inner = _fgmres_ell_device_loop(
                cols_flat, vals_flat.astype(jnp.float64), invpos,
                jnp.asarray(self.b), jnp.asarray(self.x),
                jnp.asarray(thr, jnp.float64),
                jnp.asarray(self.max_iter, jnp.int32),
                n=self.n, restart=min(self.restart, self.n), segs=segs,
                split=_hilo_safe(self.b, self.x),
            )
        else:
            rows, cols, vals = self._operator_coo()
            x, resid, cycles, inner = _fgmres_device_loop(
                rows, cols, vals,
                jnp.asarray(self.b), jnp.asarray(self.x),
                jnp.asarray(thr, jnp.float64),
                jnp.asarray(self.max_iter, jnp.int32),
                n=self.n, restart=min(self.restart, self.n),
            )
        self.x = np.asarray(x)
        self.current_iter = int(cycles)
        self.total_inner_iterations = int(inner)
        if float(resid) <= thr:
            self.final_code = 0
        else:
            warnings.warn(
                f"{self.solver_name} did not converge within "
                f"{self.max_iter} iterations",
                ConvergenceWarning,
            )
            self.final_code = -1
        return self.x


def _wrapper_guards(M, callback, callback_type=None):
    if M is not None:
        raise NotImplementedError("Preconditioner M not supported")
    if callback is not None or callback_type is not None:
        raise NotImplementedError("callback is not supported")


def cg(A, b, x0=None, tol=1e-05, maxiter=DEFAULT_MAX_ITER, M=None,
       callback=None, atol=None):
    """Conjugate-gradient convenience wrapper -> (x, code); mirrors the
    reference ``cg`` (``solvers/_cg.py:300-353``)."""
    _wrapper_guards(M, callback)

    with CGIterativeSparseSolver(
        A, b, x=x0, verbose=False, max_iter=maxiter, a_tol=atol, r_tol=tol
    ) as solver:
        try:
            x = solver.solve()
        except RuntimeError:
            return solver.x, solver.final_code
        return x, solver.final_code


def cg_mrhs(A, B, X0=None, tol=1e-05, maxiter=DEFAULT_MAX_ITER, M=None,
            callback=None, atol=None):
    """Multi-RHS conjugate gradient: solve ``A X = B`` for B ``(n, k)``.

    The WORKING analog of MKL's ``dcgmrhs`` RCI family, which the
    reference binds but never wires up (``_cfunctions.py:154-168``;
    argtypes never set, no Python wrapper — SURVEY §2b).  All k
    column solves run in ONE compiled program: the single-RHS device
    loop is vmapped over columns, so the batched ``while_loop``
    advances every column until each has converged (per-column
    thresholds ``max(tol * ||b_col||, atol)``).

    Returns ``(X (n, k), codes (k,))`` with code 0 = converged,
    -1 = hit ``maxiter`` (matching :func:`cg`'s convention per
    column).
    """
    _wrapper_guards(M, callback)
    Ac = _as_container(A)
    if Ac is None:
        raise ValueError(
            "cg_mrhs requires a scipy CSR matrix, a device container, "
            f"or a sparse handle; got {type(A)}"
        )
    if np.dtype(Ac.dtype) != np.dtype(np.float64):
        # Same dtype contract as cg()/CGIterativeSparseSolver — the
        # f64 loop would otherwise silently discard imaginary parts
        # (review r5 finding).
        raise ValueError(
            "Matrix A must be a double-precision scipy CSR matrix "
            "or a sparse handle"
        )
    n = Ac.shape[0]
    B_np = np.asarray(B, dtype=np.float64)
    if B_np.ndim != 2 or B_np.shape[0] != n:
        raise ValueError(
            f"B must be a dense (n, k) array with n == {n}; got shape "
            f"{B_np.shape}"
        )
    k = B_np.shape[1]
    if X0 is None:
        X0_np = np.zeros((n, k), dtype=np.float64)
    else:
        X0_np = np.asarray(X0, dtype=np.float64)
        if X0_np.shape != (n, k):
            raise ValueError(f"X0 must have shape {(n, k)}")

    a_tol = DEFAULT_ATOL if atol is None else atol
    thresholds = np.maximum(
        tol * np.linalg.norm(B_np, axis=0), max(a_tol, 0.0)
    )
    thresholds = np.where(thresholds == 0.0, 1e-12, thresholds)

    binned = (
        Ac.ell_parts_binned()
        if getattr(config, "ell_binned", True)
        and isinstance(Ac, formats.CSR)
        else None
    )
    if binned is not None:
        segs, cols_flat, vals_flat, invpos = binned
        X, rs = _cg_mrhs_ell_loop(
            cols_flat, vals_flat.astype(jnp.float64), invpos,
            jnp.asarray(B_np), jnp.asarray(X0_np),
            jnp.asarray(thresholds, jnp.float64),
            jnp.asarray(maxiter, jnp.int32), segs=segs,
            split=_hilo_safe(B_np, X0_np),
        )
    else:
        rows, cols, vals = _coo_of_container(Ac)
        batched = jax.vmap(
            lambda r, c, v, b, x0, thr, mi: _cg_device_loop(
                r, c, v, b, x0, thr, mi, n=n
            ),
            in_axes=(None, None, None, 1, 1, 0, None),
            out_axes=(1, 0, 0),
        )
        X, rs, _its = batched(
            rows, cols, vals, jnp.asarray(B_np), jnp.asarray(X0_np),
            jnp.asarray(thresholds, jnp.float64),
            jnp.asarray(maxiter, jnp.int32),
        )
    X_np = np.asarray(X)
    res = np.sqrt(np.asarray(rs))
    codes = np.where(res <= thresholds, 0, -1).astype(np.int32)
    if (codes != 0).any():
        warnings.warn(
            f"cg did not converge within {maxiter} iterations for "
            f"{int((codes != 0).sum())} of {k} right-hand sides",
            ConvergenceWarning,
        )
    return X_np, codes


def _coo_of_container(Ac):
    """(rows, cols, vals) expanded COO of a CSR/CSC/BSR device
    container (review r5: the CSR-only form crashed on device CSC/BSR
    operands the guards admit)."""
    from ..ops.host import coo_parts

    return coo_parts(Ac)[:3]


def fgmres(A, b, x0=None, tol=1e-05, restart=None, maxiter=DEFAULT_MAX_ITER,
           M=None, callback=None, atol=None, callback_type=None):
    """FGMRES convenience wrapper -> (x, code); mirrors the reference
    ``fgmres`` (``solvers/_fgmres.py:375-430``)."""
    _wrapper_guards(M, callback, callback_type)

    with FGMRESIterativeSparseSolver(
        A, b, x=x0, max_iter=maxiter, a_tol=atol, r_tol=tol
    ) as solver:
        if restart is not None:
            solver.restart = restart
        try:
            x = solver.solve()
        except RuntimeError:
            return solver.x, solver.final_code
        return x, solver.final_code

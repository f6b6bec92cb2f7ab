"""PARDISO-compatible direct solver interface.

Reproduces the reference's thin passthrough of the classic 64-slot
``pt``/``iparm`` state-machine API
(``/root/reference/sparse_dot_mkl/solvers/_pardiso.py``): ``pardisoinit``
fills the flag block (zero-based indexing ``iparm[34]``, single-precision
``iparm[27]``), and ``pardiso`` runs phases — 11 analysis, 22 numeric
factorization, 33 solve, 13 all, negative to release — mutating ``pt``
as the opaque factorization handle.

The backing factorization is a dense LU on the device (``lu_factor`` /
``lu_solve``): sparse direct factorization's pointer-chasing elimination
tree maps poorly to dense matrix units, while a densified LU at the
sizes this API is used for is bandwidth-cheap and numerically
identical.  Complex systems on backends without native complex support
use the real 2n×2n embedding [[Re, -Im], [Im, Re]].

Phase semantics asserted by the reference tests
(``tests/test_pardiso.py``): phase 11 leaves X zero but mutates ``pt``;
phase 13 solves; ``perm`` is returned untouched (zeros) unless supplied.
"""

import itertools
import warnings
from functools import partial

import numpy as np
import scipy.sparse as _sps

import jax
import jax.numpy as jnp

from .. import formats
from ..config import config
from ..ops import _xla
from ..ops.host import coo_parts
from .. import backend as _backend

PARDISO_ERRORS = {
    0: None,
    -1: "input inconsistent",
    -2: "not enough memory",
    -3: "reordering problem",
    -4: "Zero pivot, numerical factorization or iterative refinement "
        "problem",
    -5: "unclassified (internal) error",
    -6: "reordering failed (matrix types 11 and 13 only)",
    -7: "diagonal matrix is singular",
    -8: "32-bit integer overflow problem",
    -9: "not enough memory for OOC",
    -10: "error opening OOC files",
    -11: "read/write error with OOC files",
    -12: "pardiso_64 called from 32-bit library",
    -13: "interrupted by the (user-defined) progress function",
    -15: "internal error",
}

_REAL_MTYPES = (1, 2, -2, 11)
_COMPLEX_MTYPES = (3, 4, -4, 6, 13)

# iparm slots this implementation honors or deliberately accepts.
# Honored: iparm[7] (max iterative-refinement steps, output count in
# iparm[6]), iparm[11] (transpose / conjugate-transpose solve),
# iparm[17]/iparm[18] (<0 on entry requests the factor-nnz / MFLOP
# reports, written on output), iparm[27] (single precision),
# iparm[34] (zero-based indexing — the only supported value is 1,
# scipy CSR is zero-based).  Accepted-but-moot (they select behaviors
# of MKL's sparse elimination that a dense-LU / Krylov backing has no
# analog of, without changing the answer): iparm[0] (user-supplied
# flag), iparm[1] (ordering), iparm[9] (pivot perturbation),
# iparm[10] (scaling), iparm[12] (matching).  Any OTHER nonzero slot
# warns instead of being silently ignored
# (reference forwards all 64 slots to MKL, ``_pardiso.py:139-147``).
_IPARM_ACCEPTED = frozenset({0, 1, 6, 7, 9, 10, 11, 12, 17, 18, 27,
                             34})


def _check_iparm(iparm, quiet):
    """Warn on nonzero iparm slots outside the honored/accepted set."""
    if iparm is None:
        return
    ip = np.asarray(iparm)
    unsupported = [
        int(i) for i in np.nonzero(ip)[0] if int(i) not in _IPARM_ACCEPTED
    ]
    if unsupported and not quiet:
        warnings.warn(
            f"iparm slots {unsupported} are nonzero but not honored by "
            "sparse_dot_tpu's pardiso (dense-LU / Krylov backing); "
            "results may differ from MKL for those options",
            RuntimeWarning,
        )
    if ip.shape[0] > 34 and int(ip[34]) == 0 and not quiet:
        warnings.warn(
            "iparm[34] == 0 selects one-based (Fortran) indexing, which "
            "scipy CSR inputs cannot carry; indices are interpreted as "
            "zero-based (set iparm[34] = 1, as pardisoinit does)",
            RuntimeWarning,
        )

# Factorization store: pt[0] holds a key into this registry (the opaque
# "pointer" role pt plays in MKL).
_factor_store = {}
_next_key = itertools.count(1)


def _needs_iterative(A_container, n):
    """True when the dense-LU backing store would blow the device
    budget (a_dense f64 + f32 LU ~ 12 bytes/element on the mixed
    path) and the solve must go matrix-free instead."""
    budget = int(getattr(config, "pardiso_dense_budget_bytes", 2 << 30))
    n_eff = 2 * n if (
        np.dtype(A_container.dtype).kind == "c"
        and not _backend.has_native_complex()
    ) else n
    return n_eff * n_eff * 12 > budget


@jax.jit
def _lu_factor(a_dense):
    return jax.scipy.linalg.lu_factor(a_dense)


@partial(jax.jit, static_argnames=("trans",))
def _lu_solve(lu, piv, b, trans=0):
    return jax.scipy.linalg.lu_solve((lu, piv), b, trans=trans)


@partial(jax.jit, static_argnames=("trans",))
def _lu_solve_refined(lu32, piv, a_dense64, b64, max_steps, trans=0):
    """Mixed-precision direct solve: f32 LU + f64 iterative refinement.

    On a backend without an f64 LU (``backend.has_f64_lu``) the
    factor is computed in f32 and each refinement step recovers ~7
    digits: x += LU^-1 (b - op(A) x) with the residual in exact f64.
    The loop runs on device (no host syncs) until the residual stalls
    or ``max_steps`` (iparm[7]) is reached.  ``trans`` (scipy
    convention: 1 = op(A) = A^T) selects the transpose solve
    (iparm[11]).  Returns (x, steps_taken) — the count feeds the
    iparm[6] output report."""

    def solve32(r):
        return jax.scipy.linalg.lu_solve(
            (lu32, piv), r.astype(jnp.float32), trans=trans
        ).astype(jnp.float64)

    a_op = a_dense64.T if trans else a_dense64

    b_norm = jnp.linalg.norm(b64)
    tol = 1e-13 * jnp.maximum(b_norm, 1e-300)

    def resid(x):
        return b64 - jnp.dot(a_op, x, precision=jax.lax.Precision.HIGHEST)

    x0 = solve32(b64)

    def cond(state):
        _, r, it = state
        return jnp.logical_and(jnp.linalg.norm(r) > tol, it < max_steps)

    def body(state):
        x, r, it = state
        x = x + solve32(r)
        return (x, resid(x), it + 1)

    state = (x0, resid(x0), jnp.asarray(0, jnp.int32))
    x, _, it = jax.lax.while_loop(cond, body, state)
    return x, it


def _densify_real_embedding(A_container, n):
    """Device dense matrix for the system; complex planar storage maps to
    the real 2n x 2n embedding [[Re, -Im], [Im, Re]]."""
    if A_container.planar:
        re_c = A_container.real_view()
        im_c = A_container.imag_view()
        rows, cols, vr, m, k = coo_parts(re_c)
        _, _, vi, _, _ = coo_parts(im_c)
        re = _xla.densify(rows, cols, vr, (n, n))
        im = _xla.densify(rows, cols, vi, (n, n))
        top = jnp.concatenate([re, -im], axis=1)
        bot = jnp.concatenate([im, re], axis=1)
        return jnp.concatenate([top, bot], axis=0), True
    rows, cols, vals, m, k = coo_parts(A_container)
    return _xla.densify(rows, cols, vals, (n, n)), False


def pardisoinit(mtype, iparm=None, single_precision=False):
    """Initialize ``pt`` and ``iparm`` blocks for the given matrix type;
    mirrors the reference ``pardisoinit`` (``_pardiso.py:158-223``)."""
    if mtype not in _REAL_MTYPES + _COMPLEX_MTYPES:
        raise ValueError(f"mtype {mtype} is not a valid PARDISO mtype")

    pt = np.zeros(64, dtype=np.int64)

    if iparm is None:
        iparm = np.zeros(64, dtype=np.int32)
        iparm[0] = 1    # user-supplied iparm values
        iparm[1] = 2    # fill-reducing ordering (nested dissection analog)
        iparm[9] = 13   # pivot perturbation 1e-13
        iparm[10] = 1   # scaling
        iparm[12] = 1   # matching
        iparm[17] = -1  # report nnz in factors
        iparm[18] = -1  # report factorization flops
        iparm[34] = 1   # zero-based indexing

    if single_precision:
        iparm[27] = 1

    return pt, iparm


def pardiso(A, B, pt, mtype, iparm, phase=13, maxfct=1, mnum=1, perm=None,
            msglvl=0, X=None, quiet=False):
    """Direct solve AX = B through the PARDISO phase protocol.

    Returns (X, pt, perm, error); mirrors the reference signature and
    phase behavior (``_pardiso.py:32-156``).
    """
    if not formats.is_csr(A):
        raise ValueError(f"A must be a CSR matrix; {type(A)} passed")
    if _sps.issparse(B):
        raise ValueError(f"B must be a dense array; {type(B)} passed")
    if A.shape[0] != B.shape[0]:
        raise ValueError(
            f"Bad matrix shapes for AX=B solver: A {A.shape} & B {B.shape}"
        )
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(
            f"PARDISO requires a square matrix; A is {A.shape}"
        )

    if B.ndim > 2:
        raise ValueError("B must be 1- or 2-d")

    if perm is None:
        perm = np.zeros(n, dtype=config.index_dtype)

    is_complex_mtype = mtype in _COMPLEX_MTYPES
    if mtype not in _REAL_MTYPES + _COMPLEX_MTYPES:
        return _fail(B, pt, perm, -1, quiet)

    _check_iparm(iparm, quiet)
    # iparm[11]: 0 = solve A X = B, 1 = conjugate-transpose A^H X = B,
    # 2 = transpose A^T X = B (MKL slot semantics; the reference
    # forwards the whole block, ``_pardiso.py:139-147``).
    tmode = 0
    max_refine = 60  # residual-stall bound of the mixed-precision loop
    if iparm is not None:
        ip = np.asarray(iparm)
        if ip.shape[0] > 11:
            tmode = int(ip[11])
            if tmode not in (0, 1, 2):
                return _fail(B, pt, perm, -1, quiet)
        if ip.shape[0] > 7 and int(ip[7]) > 0:
            max_refine = int(ip[7])

    if X is None:
        X = np.zeros_like(np.asarray(B))

    phase = int(phase)

    # Release phases
    if phase < 0:
        key = int(pt[0])
        _factor_store.pop(key, None)
        pt[:] = 0
        return X, pt, perm, 0

    # Solve-only calls (phase 33 — the factor-once / solve-many loop)
    # read nothing but the stored factor: skip the triangle expansion
    # and the device upload of A entirely (review r5 finding — every
    # solve used to pay an O(nnz) host pass plus a full transfer the
    # solve never consumed).
    need_A = phase in (11, 12, 13, 22, 23)
    A_container = None
    if need_A:
        # Symmetric / Hermitian mtypes: MKL reads ONLY the upper
        # triangle of the supplied matrix and expands it to the full
        # operator (triangle-stored input is the documented convention;
        # a full symmetric matrix reconstructs identically).  Without
        # this, a triangle-stored system solved as if the triangle were
        # the whole matrix — silently wrong X with error 0 (review r5
        # finding).
        if mtype in (2, -2, 4, -4, 6):
            A_s = (A.to_scipy().tocsr()
                   if formats.is_device_sparse(A) else A)
            U = _sps.triu(A_s, format="csr")
            strict = _sps.triu(A_s, k=1, format="csr")
            if mtype in (4, -4):  # Hermitian: conjugate the mirror
                A = (U + strict.conj().T).tocsr()
            else:  # real symmetric / complex symmetric
                A = (U + strict.T).tocsr()

        try:
            A_container = formats.to_device(A)
        except ValueError:
            return _fail(B, pt, perm, -1, quiet)

    key = int(pt[0])
    state = _factor_store.get(key)
    if state is None:
        key = next(_next_key)
        state = {}
        _factor_store[key] = state
        # pt is the opaque handle: nonzero after analysis, as the
        # reference tests assert.
        pt[0] = key
        pt[1] = n

    do_analysis = phase in (11, 12, 13)
    do_factor = phase in (12, 13, 22, 23)
    do_solve = phase in (13, 23, 33)

    if do_analysis:
        state["n"] = n
        state["structure_nnz"] = A_container.nnz

    if do_factor and _needs_iterative(A_container, n):
        # Beyond the dense-LU budget the O(n^2) factorization cannot
        # materialize on one chip; fall back to a matrix-free Krylov
        # solve at phase 33 — the matrix itself is the
        # "factorization".  MKL would OOC-spill here (iparm[59]);
        # warning once keeps the divergence visible.  The Krylov
        # route is real-only: fail complex HERE instead of promising
        # a solve the solve phase rejects (review r5 finding).
        if np.dtype(A_container.dtype).kind == "c":
            warnings.warn(
                f"sparse_dot_tpu pardiso: n={n} exceeds the dense-LU "
                "budget and the matrix-free fallback supports real "
                "mtypes only; raise config.pardiso_dense_budget_bytes "
                "or use the iterative solvers directly",
                RuntimeWarning,
            )
            return _fail(B, pt, perm, -1, quiet)
        warnings.warn(
            f"sparse_dot_tpu pardiso: n={n} exceeds the dense-LU "
            "budget; phases 22/33 will run a matrix-free Krylov solve "
            "(CG for the SPD mtype 2, FGMRES otherwise) instead of a "
            "direct factorization",
            RuntimeWarning,
        )
        state["iterative"] = True
        state["container"] = A_container
        # CG requires positive definiteness: only mtype 2 (real
        # symmetric POSITIVE DEFINITE) qualifies; -2 (indefinite) runs
        # FGMRES like the unsymmetric mtypes (review r5 finding — CG
        # stalls on saddle-point systems MKL factors via LDL^T).
        state["mtype_sym"] = mtype == 2
        state["dtype"] = A_container.dtype
        state["embedded"] = False
        state["lu"] = None
        # Reports (iparm[17]/[18], <0 on entry requests them): the
        # matrix-free route's "factorization" is the matrix itself.
        if iparm is not None:
            if len(iparm) > 17 and int(iparm[17]) < 0:
                iparm[17] = min(
                    int(A_container.nnz), np.iinfo(np.int32).max
                )
            if len(iparm) > 18 and int(iparm[18]) < 0:
                iparm[18] = 0

    elif do_factor:
        a_dense, embedded = _densify_real_embedding(A_container, n)
        mixed = (
            a_dense.dtype == jnp.float64
            and not _backend.has_f64_lu()
        )
        if mixed:
            # No f64 LU on this backend: factor in f32, keep dense A
            # for f64 iterative refinement at solve.
            lu, piv = _lu_factor(a_dense.astype(jnp.float32))
            state["a_dense"] = a_dense
        else:
            lu, piv = _lu_factor(a_dense)
            state["a_dense"] = None
        # Zero U-pivots mean an exactly singular system: LU of e.g.
        # diag(1, 0) is fully FINITE, so an isnan check alone returned
        # inf/NaN X with error 0 where MKL reports -4/-7 (review r5
        # finding).  One fused device read covers both.
        bad = jnp.any(~jnp.isfinite(lu)) | jnp.any(
            jnp.diagonal(lu) == 0
        )
        if bool(bad):
            return _fail(B, pt, perm, -4, quiet)
        state["lu"] = (lu, piv)
        state["mixed"] = mixed
        state["embedded"] = embedded
        state["dtype"] = A_container.dtype
        # A prior over-budget factorization on this pt left the Krylov
        # route armed; a successful direct factor must disarm it or
        # phase 33 solves against the STALE container (review r5).
        state["iterative"] = False
        state.pop("container", None)
        # Post-factorization reports (MKL fills these after phase 22
        # when <0 on entry): the backing factor is a dense LU, so nnz
        # in factors is n_eff^2 and the flop count is (2/3) n_eff^3,
        # reported in MFLOP like iparm[18].
        if iparm is not None:
            n_eff = int(lu.shape[0])
            i32max = np.iinfo(np.int32).max
            if len(iparm) > 17 and int(iparm[17]) < 0:
                iparm[17] = min(n_eff * n_eff, i32max)
            if len(iparm) > 18 and int(iparm[18]) < 0:
                iparm[18] = min(int(2 * n_eff**3 / 3 / 1e6), i32max)

    if do_solve and state.get("iterative"):
        from .iterative import _cg_device_loop, _fgmres_device_loop
        from ..ops.host import coo_parts as _coo_parts

        container = state["container"]
        if np.dtype(container.dtype).kind == "c":
            return _fail(B, pt, perm, -1, quiet)  # complex: LU only
        rows, cols, vals = _coo_parts(container)[:3]
        if tmode in (1, 2):
            # Real transpose solve (iparm[11]): swap the COO roles.
            rows, cols = cols, rows
        b_np = np.asarray(B, dtype=np.float64)
        b_2d = b_np.reshape(-1, 1) if b_np.ndim == 1 else b_np
        xs = []
        for j in range(b_2d.shape[1]):
            b_col = jnp.asarray(np.ascontiguousarray(b_2d[:, j]))
            thr = jnp.asarray(
                1e-10 * max(float(np.linalg.norm(b_2d[:, j])), 1e-300),
                jnp.float64,
            )
            x0 = jnp.zeros((n,), jnp.float64)
            if state.get("mtype_sym"):
                x, rs, _ = _cg_device_loop(
                    rows, cols, vals, b_col, x0, thr,
                    jnp.asarray(5000, jnp.int32), n=n,
                )
                resid = float(jnp.sqrt(rs))
            else:
                x, resid_d, _, _ = _fgmres_device_loop(
                    rows, cols, vals, b_col, x0, thr,
                    jnp.asarray(200, jnp.int32), n=n, restart=40,
                )
                resid = float(resid_d)
            if not np.isfinite(resid) or resid > float(thr) * 1e3:
                return _fail(B, pt, perm, -4, quiet)
            xs.append(np.asarray(x))
        x = np.stack(xs, axis=1).reshape(b_np.shape)
        X[...] = x.astype(np.asarray(B).dtype, copy=False)
        return X, pt, perm, 0

    if do_solve:
        if state.get("lu") is None:
            return _fail(B, pt, perm, -1, quiet)
        lu, piv = state["lu"]
        mixed = state.get("mixed", False)
        refine_steps = 0

        def _solve(b_dev, trans=0):
            nonlocal refine_steps
            if mixed:
                if jnp.iscomplexobj(b_dev):
                    # Complex RHS over a REAL mixed-precision factor
                    # (a backend without f64 LU): solve the real and
                    # imaginary parts separately — the old
                    # .astype(float64) cast silently dropped Im(B)
                    # (review r5 finding).
                    # scipy trans 1 (A^T) and 2 (A^H) coincide on a
                    # real operator.
                    xr = _solve(jnp.real(b_dev), trans=min(trans, 1))
                    xi = _solve(jnp.imag(b_dev), trans=min(trans, 1))
                    return xr + 1j * xi
                x, steps = _lu_solve_refined(
                    lu, piv, state["a_dense"],
                    b_dev.astype(jnp.float64),
                    jnp.asarray(max_refine, jnp.int32), trans=trans,
                )
                refine_steps = max(refine_steps, int(steps))
                return x
            return _lu_solve(lu, piv, b_dev, trans=trans)

        b_np = np.asarray(B)
        b_2d = b_np.reshape(-1, 1) if b_np.ndim == 1 else b_np
        # Branch on the FACTOR's complexity, not B's (review r5
        # finding: a complex B over a real factor used to be cast to
        # real before the solve on mixed-precision backends, and a
        # native-complex factor with a real-dtyped B took the real
        # path — wrong conjugation under iparm[11] and Im(X) dropped).
        factor_complex = (
            state["embedded"] or np.dtype(lu.dtype).kind == "c"
        )
        if state["embedded"]:
            # Transpose solves through the real 2n embedding E(A) =
            # [[Re,-Im],[Im,Re]]: E(A)^T = E(A^H), so the conjugate
            # transpose (tmode 1) is a plain trans=1 solve, and the
            # non-conjugate transpose (tmode 2) uses
            # A^T x = b  <=>  A^H conj(x) = conj(b).
            # Match the embedding's real width (c64 factors are f32):
            # the cast only matters for a REAL-dtyped B, which has no
            # imaginary part to lose.
            ctype = (
                np.complex64
                if (not mixed and lu.dtype == jnp.float32)
                else np.complex128
            )
            b_c = b_2d.astype(ctype, copy=False)
            b_eff = b_c.conj() if tmode == 2 else b_c
            e_trans = 1 if tmode in (1, 2) else 0
            b_stack = np.concatenate([b_eff.real, b_eff.imag], axis=0)
            x_stack = np.asarray(_solve(jnp.asarray(b_stack), e_trans))
            x = x_stack[:n] + 1j * x_stack[n:]
            if tmode == 2:
                x = x.conj()
        elif factor_complex:
            # scipy trans codes: 1 = A^T, 2 = A^H (iparm[11] is the
            # reverse: 1 = conjugate transpose, 2 = transpose).
            c_trans = {0: 0, 1: 2, 2: 1}[tmode]
            x = np.asarray(
                _solve(jnp.asarray(b_2d.astype(lu.dtype)), c_trans)
            )
        elif np.iscomplexobj(b_np):
            # Real factor, complex B: solve the parts separately
            # (trans 1/2 coincide on a real operator).
            r_trans = 1 if tmode in (1, 2) else 0
            target = np.float64 if mixed else lu.dtype
            xr = np.asarray(_solve(jnp.asarray(
                np.ascontiguousarray(b_2d.real).astype(target)
            ), r_trans))
            xi = np.asarray(_solve(jnp.asarray(
                np.ascontiguousarray(b_2d.imag).astype(target)
            ), r_trans))
            x = xr + 1j * xi
        else:
            r_trans = 1 if tmode in (1, 2) else 0
            target = jnp.float64 if mixed else lu.dtype
            x = np.asarray(
                _solve(jnp.asarray(b_2d.astype(target)), r_trans)
            )
        x = x.reshape(b_np.shape)
        if np.iscomplexobj(x) and not np.iscomplexobj(b_np):
            # X carries B's dtype (reference contract: the caller's
            # buffer): a complex solution over a real-dtyped B cannot
            # be represented — warn instead of discarding silently.
            scale = max(float(np.abs(x).max()), 1e-300)
            if float(np.abs(x.imag).max()) > 1e-9 * scale:
                warnings.warn(
                    "sparse_dot_tpu pardiso: complex-factor solve "
                    "with a real-dtyped B produced a solution with a "
                    "nonzero imaginary part, which B's dtype cannot "
                    "represent; pass a complex B to receive it",
                    RuntimeWarning,
                )
            x = np.ascontiguousarray(x.real)
        X[...] = x.astype(b_np.dtype, copy=False)
        # iparm[6] output report: refinement steps performed.
        if iparm is not None and len(iparm) > 6:
            iparm[6] = refine_steps

    return X, pt, perm, 0


def export_factorization(pt):
    """Serialize the factorization behind ``pt`` to a plain dict of
    numpy arrays (picklable).

    The reference's nearest analog is PARDISO's long-lived ``pt`` handle
    (factor once, re-solve many times, ``_pardiso.py:32-45``) — but MKL
    handles die with the process.  Here the factor state is a pytree of
    device arrays, so it exports losslessly: pickle the returned dict,
    reload with :func:`import_factorization`, and phase-33 solves
    continue from the stored factor.
    """
    key = int(np.asarray(pt)[0])
    state = _factor_store.get(key)
    if state is None or state.get("lu") is None:
        raise ValueError(
            "pt does not reference a live factorization (run phase "
            "12/13/22/23 first)"
        )
    lu, piv = state["lu"]
    return {
        "version": 1,
        "lu": np.asarray(lu),
        "piv": np.asarray(piv),
        "embedded": bool(state["embedded"]),
        "mixed": bool(state.get("mixed", False)),
        "a_dense": (
            np.asarray(state["a_dense"])
            if state.get("a_dense") is not None else None
        ),
        "dtype": np.dtype(state["dtype"]).str,
        "n": int(state.get("n", np.asarray(lu).shape[0])),
        "structure_nnz": int(state.get("structure_nnz", 0)),
    }


def import_factorization(blob):
    """Restore a factorization exported by :func:`export_factorization`;
    returns a fresh ``pt`` block referencing it (solve with phase 33)."""
    if not isinstance(blob, dict) or "lu" not in blob or "piv" not in blob:
        raise ValueError("not a sparse_dot_tpu factorization export")
    key = next(_next_key)
    _factor_store[key] = {
        "lu": (jnp.asarray(blob["lu"]), jnp.asarray(blob["piv"])),
        "embedded": bool(blob["embedded"]),
        "mixed": bool(blob.get("mixed", False)),
        "a_dense": (
            jnp.asarray(blob["a_dense"])
            if blob.get("a_dense") is not None else None
        ),
        "dtype": np.dtype(blob["dtype"]),
        "n": int(blob["n"]),
        "structure_nnz": int(blob.get("structure_nnz", 0)),
    }
    pt = np.zeros(64, dtype=np.int64)
    pt[0] = key
    pt[1] = int(blob["n"])
    return pt


def _fail(B, pt, perm, error, quiet):
    if not quiet and PARDISO_ERRORS.get(error):
        warnings.warn(
            f"PARDISO returned error {error}: {PARDISO_ERRORS[error]}",
            RuntimeWarning,
        )
    return np.zeros_like(np.asarray(B)), pt, perm, error

"""PARDISO phase-protocol behavior.

Contract (``/root/reference/sparse_dot_mkl/solvers/_pardiso.py:32-223``):
``pardisoinit`` fills the flag block; phase 11 mutates ``pt`` but leaves
X zero; 12/22 factorize; 13 solves; 33 re-solves from a stored factor;
negative phases release.  Oracles: ``np.linalg.solve`` and the package's
own QR solver.  One parametrized fixture covers the real/complex x
single/double grid the reference spells out as four classes.
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps

from sparse_dot_tpu import sparse_qr_solve
from sparse_dot_tpu.solvers import pardiso, pardisoinit

from .common import make_matrixes

_A, _B = make_matrixes(50, 10, 50, 0.2)
_A.sort_indices()
_B = _B.toarray()

GRID = [
    (np.float32, 11, True, False),
    (np.float64, 11, False, False),
    (np.complex64, 13, True, False),
    (np.complex128, 13, False, False),
    # Planar storage: the path complex systems take without native
    # complex (real 2n x 2n
    # embedding behind the planar container).
    (np.complex64, 13, True, True),
    (np.complex128, 13, False, True),
]
GRID_IDS = ["f32", "f64", "c64", "c128", "c64-planar", "c128-planar"]


@pytest.fixture(params=GRID, ids=GRID_IDS)
def case(request):
    from sparse_dot_tpu import formats
    from sparse_dot_tpu.config import config

    dtype, mtype, single, planar = request.param
    prev = config.force_planar_complex
    config.force_planar_complex = planar
    formats.clear_transfer_cache()
    pt, iparm = pardisoinit(mtype, single_precision=single)
    yield {
        "A": _A.astype(dtype),
        "b": _B[:, 0].astype(dtype),
        "B": _B.astype(dtype),
        "pt": pt,
        "iparm": iparm,
        "mtype": mtype,
        "single": single,
        "dtype": dtype,
    }
    config.force_planar_complex = prev
    formats.clear_transfer_cache()


def _dense_oracle(case):
    work = np.complex128 if np.iscomplexobj(case["b"]) else np.float64
    return np.linalg.solve(
        case["A"].toarray().astype(work), case["b"].astype(work)
    )


def test_init_flags(case):
    assert not case["pt"].any()
    ip = case["iparm"]
    assert ip[0] == 1 and ip[1] == 2 and ip[9] == 13
    assert ip[10] == 1 and ip[12] == 1
    assert ip[17] == -1 and ip[18] == -1
    assert ip[34] == 1  # zero-based indexing
    assert ip[27] == (1 if case["single"] else 0)


def test_phase11_mutates_pt_only(case):
    X, pt, perm, err = pardiso(
        case["A"], case["b"], case["pt"], case["mtype"], case["iparm"], 11
    )
    assert err == 0
    assert pt.any()                      # analysis stored a handle
    assert not X.any()                   # ... but no solve happened
    assert not perm.any()                # perm untouched


def test_phase13_solves(case):
    X, pt, _, err = pardiso(
        case["A"], case["b"], case["pt"], case["mtype"], case["iparm"], 13
    )
    assert err == 0
    assert X.any() and pt.any()
    npt.assert_array_almost_equal(X, _dense_oracle(case), decimal=3)


def test_phase13_cross_checks_qr(case):
    X, _, _, err = pardiso(
        case["A"], case["b"], case["pt"], case["mtype"], case["iparm"], 13
    )
    assert err == 0
    if case["mtype"] == 11:
        qr = sparse_qr_solve(case["A"], case["b"])
    else:
        rb = np.ascontiguousarray(case["b"].real)
        qr = np.zeros_like(X)
        qr.real = sparse_qr_solve(case["A"].real.tocsr().astype(rb.dtype),
                                  rb)
    npt.assert_array_almost_equal(X.real, qr.real, decimal=3)


def test_multiple_rhs(case):
    X, pt, _, err = pardiso(
        case["A"], case["B"], case["pt"], case["mtype"], case["iparm"], 13
    )
    assert err == 0 and X.shape == case["B"].shape and X.any()


def test_factor_then_resolve(case):
    _, pt, _, err = pardiso(
        case["A"], case["b"], case["pt"], case["mtype"], case["iparm"], 12
    )
    assert err == 0
    X, pt, _, err = pardiso(
        case["A"], case["b"], pt, case["mtype"], case["iparm"], 33
    )
    assert err == 0
    npt.assert_array_almost_equal(X, _dense_oracle(case), decimal=3)


def test_solve_only_skips_device_upload(case, monkeypatch):
    """Phase 33 reads nothing but the stored factor: no triangle
    expansion, no A re-upload (review r5 — every solve in a
    factor-once/solve-many loop paid an O(nnz) host pass plus a full
    transfer the solve never consumed)."""
    import importlib

    _pardiso_mod = importlib.import_module(
        "sparse_dot_tpu.solvers.pardiso"
    )

    _, pt, _, err = pardiso(
        case["A"], case["b"], case["pt"], case["mtype"], case["iparm"], 12
    )
    assert err == 0

    def _boom(*a, **k):
        raise AssertionError("phase 33 must not upload A")

    monkeypatch.setattr(_pardiso_mod.formats, "to_device", _boom)
    try:
        X, pt, _, err = pardiso(
            case["A"], case["b"], pt, case["mtype"], case["iparm"], 33
        )
    finally:
        monkeypatch.undo()
    assert err == 0
    npt.assert_array_almost_equal(X, _dense_oracle(case), decimal=3)


def test_release_clears_pt(case):
    _, pt, _, _ = pardiso(
        case["A"], case["b"], case["pt"], case["mtype"], case["iparm"], 13
    )
    _, pt, _, err = pardiso(
        case["A"], case["b"], pt, case["mtype"], case["iparm"], -1
    )
    assert err == 0
    assert not pt.any()


def test_guards():
    pt, iparm = pardisoinit(11)
    with pytest.raises(ValueError):
        pardiso(_A.tocoo(), _B, pt, 11, iparm, 13)
    with pytest.raises(ValueError):
        pardiso(_A, _A, pt, 11, iparm, 13)  # sparse B rejected


def test_factorization_roundtrips_through_pickle(case):
    """The factor store serializes: factor once, export, reload in a
    'fresh process' (cleared store), and phase-33 solves still match —
    the persistence analog of MKL's long-lived pt handles."""
    from sparse_dot_tpu.solvers import (
        export_factorization,
        import_factorization,
    )

    _, pt, _, err = pardiso(
        case["A"], case["b"], case["pt"], case["mtype"], case["iparm"], 12
    )
    assert err == 0
    blob = pickle.dumps(export_factorization(pt))

    pt2 = import_factorization(pickle.loads(blob))
    X, _, _, err = pardiso(
        case["A"], case["b"], pt2, case["mtype"], case["iparm"], 33
    )
    assert err == 0
    npt.assert_array_almost_equal(X, _dense_oracle(case), decimal=3)


def test_large_system_routes_to_krylov():
    """Systems beyond the dense-LU budget solve matrix-free (CG for
    symmetric mtype, FGMRES general) with a RuntimeWarning instead of
    OOMing on an O(n^2) densify."""
    import warnings as _warnings
    from sparse_dot_tpu.config import config as _cfg

    old = _cfg.pardiso_dense_budget_bytes
    _cfg.pardiso_dense_budget_bytes = 1 << 10  # force the fallback
    try:
        n = 120
        rng = np.random.default_rng(17)
        M = sps.random(n, n, density=0.1, random_state=18,
                       format="csr")
        A = (M @ M.T + n * sps.identity(n)).tocsr()
        b = rng.random(n)

        # symmetric mtype -> CG
        pt, iparm = pardisoinit(2)
        with _warnings.catch_warnings(record=True) as w:
            _warnings.simplefilter("always")
            X, pt, _, err = pardiso(A, b, pt, 2, iparm, 13)
            assert any(issubclass(x.category, RuntimeWarning)
                       for x in w)
        assert err == 0
        npt.assert_array_almost_equal(
            X, np.linalg.solve(A.toarray(), b), decimal=6
        )

        # general mtype -> FGMRES
        G = (sps.random(n, n, density=0.1, random_state=19,
                        format="csr") + n * sps.identity(n)).tocsr()
        pt2, iparm2 = pardisoinit(11)
        with _warnings.catch_warnings(record=True):
            _warnings.simplefilter("always")
            X2, pt2, _, err2 = pardiso(G, b, pt2, 11, iparm2, 13)
        assert err2 == 0
        npt.assert_array_almost_equal(
            X2, np.linalg.solve(G.toarray(), b), decimal=6
        )

        # multiple RHS through the same factor state
        B2 = rng.random((n, 3))
        with _warnings.catch_warnings(record=True):
            _warnings.simplefilter("always")
            X3, _, _, err3 = pardiso(G, B2, pt2, 11, iparm2, 33)
        assert err3 == 0
        npt.assert_array_almost_equal(
            X3, np.linalg.solve(G.toarray(), B2), decimal=6
        )
    finally:
        _cfg.pardiso_dense_budget_bytes = old


# ---------------------------------------------------------------------------
# iparm semantics (round 5): transpose solve, refinement cap, reports,
# unsupported-slot warnings.  Reference forwards the whole 64-slot block
# to MKL (``_pardiso.py:139-147``); these are the slots with real
# behavior this implementation honors.
# ---------------------------------------------------------------------------


def test_iparm11_transpose_solve_real():
    """iparm[11] = 2 solves A^T X = B (real)."""
    pt, iparm = pardisoinit(11)
    iparm[11] = 2
    A = _A.astype(np.float64)
    b = _B[:, 0].astype(np.float64)
    X, _, _, err = pardiso(A, b, pt, 11, iparm, 13)
    assert err == 0
    npt.assert_array_almost_equal(
        X, np.linalg.solve(A.toarray().T, b), decimal=6
    )


@pytest.mark.parametrize("planar", [False, True],
                         ids=["native", "planar"])
@pytest.mark.parametrize("tmode", [1, 2], ids=["conjT", "T"])
def test_iparm11_transpose_solve_complex(tmode, planar):
    """iparm[11] = 1 solves A^H X = B, = 2 solves A^T X = B (complex,
    both the native-complex and the planar/embedded route)."""
    from sparse_dot_tpu import formats
    from sparse_dot_tpu.config import config

    prev = config.force_planar_complex
    config.force_planar_complex = planar
    formats.clear_transfer_cache()
    try:
        pt, iparm = pardisoinit(13)
        iparm[11] = tmode
        A = _A.astype(np.complex128)
        A = (A + 1j * sps.random(
            *A.shape, density=0.1, random_state=5, format="csr"
        )).tocsr()
        b = (_B[:, 0] + 0.5j * _B[:, 1]).astype(np.complex128)
        X, _, _, err = pardiso(A, b, pt, 13, iparm, 13)
        assert err == 0
        op = A.toarray().conj().T if tmode == 1 else A.toarray().T
        npt.assert_array_almost_equal(
            X, np.linalg.solve(op, b), decimal=6
        )
    finally:
        config.force_planar_complex = prev
        formats.clear_transfer_cache()


def test_iparm11_transpose_solve_krylov():
    """The matrix-free (over-budget) route honors iparm[11] too."""
    from sparse_dot_tpu.config import config as _cfg

    old = _cfg.pardiso_dense_budget_bytes
    _cfg.pardiso_dense_budget_bytes = 1 << 10
    try:
        n = 100
        rng = np.random.default_rng(23)
        G = (sps.random(n, n, density=0.1, random_state=24,
                        format="csr") + n * sps.identity(n)).tocsr()
        b = rng.random(n)
        pt, iparm = pardisoinit(11)
        iparm[11] = 2
        with pytest.warns(RuntimeWarning):
            X, _, _, err = pardiso(G, b, pt, 11, iparm, 13)
        assert err == 0
        npt.assert_array_almost_equal(
            X, np.linalg.solve(G.toarray().T, b), decimal=6
        )
    finally:
        _cfg.pardiso_dense_budget_bytes = old


def test_iparm11_invalid_value_fails():
    pt, iparm = pardisoinit(11)
    iparm[11] = 7
    with pytest.warns(RuntimeWarning):
        _, _, _, err = pardiso(
            _A.astype(np.float64), _B[:, 0].astype(np.float64),
            pt, 11, iparm, 13,
        )
    assert err == -1


def test_iparm_factor_reports():
    """iparm[17]/iparm[18] (< 0 on entry) are filled after
    factorization: nnz in factors and MFLOP count; iparm[6] reports
    the refinement steps the solve performed."""
    pt, iparm = pardisoinit(11)
    assert iparm[17] == -1 and iparm[18] == -1
    A = _A.astype(np.float64)
    b = _B[:, 0].astype(np.float64)
    X, _, _, err = pardiso(A, b, pt, 11, iparm, 13)
    assert err == 0
    n = A.shape[0]
    assert iparm[17] == n * n           # dense LU factors
    assert iparm[18] == int(2 * n**3 / 3 / 1e6)
    assert iparm[6] >= 0                # refinement count report


def test_iparm7_caps_refinement():
    """iparm[7] > 0 bounds the mixed-precision refinement loop; the
    iparm[6] output must respect the cap."""
    pt, iparm = pardisoinit(11)
    iparm[7] = 1
    A = _A.astype(np.float64)
    b = _B[:, 0].astype(np.float64)
    X, _, _, err = pardiso(A, b, pt, 11, iparm, 13)
    assert err == 0
    assert 0 <= iparm[6] <= 1


def test_iparm_unsupported_slot_warns():
    """A nonzero slot outside the honored/accepted set warns instead of
    being silently ignored."""
    pt, iparm = pardisoinit(11)
    iparm[59] = 2  # MKL: out-of-core mode — no analog here
    with pytest.warns(RuntimeWarning, match="iparm slots"):
        _, _, _, err = pardiso(
            _A.astype(np.float64), _B[:, 0].astype(np.float64),
            pt, 11, iparm, 13,
        )
    assert err == 0


def test_iparm_one_based_indexing_warns():
    pt, iparm = pardisoinit(11)
    iparm[34] = 0
    with pytest.warns(RuntimeWarning, match="one-based"):
        pardiso(
            _A.astype(np.float64), _B[:, 0].astype(np.float64),
            pt, 11, iparm, 13,
        )


def test_symmetric_mtype_expands_upper_triangle():
    """MKL reads only the UPPER triangle for symmetric mtypes and
    expands it; triangle-stored input must therefore solve the full
    symmetric operator (review r5 finding: the triangle used to be
    solved as if it were the whole matrix)."""
    n = 40
    rng = np.random.default_rng(33)
    M = sps.random(n, n, density=0.2, random_state=33, format="csr")
    A_full = (M @ M.T + n * sps.identity(n)).tocsr()
    A_upper = sps.triu(A_full).tocsr()  # triangle-stored input
    b = rng.random(n)
    pt, iparm = pardisoinit(2)
    X, _, _, err = pardiso(A_upper, b, pt, 2, iparm, 13)
    assert err == 0
    npt.assert_array_almost_equal(
        X, np.linalg.solve(A_full.toarray(), b), decimal=6
    )


def test_hermitian_mtype_expands_conjugate():
    n = 30
    rng = np.random.default_rng(35)
    M = sps.random(n, n, density=0.2, random_state=35,
                   format="csr").astype(np.complex128)
    M = M + 1j * sps.random(n, n, density=0.2, random_state=36,
                            format="csr")
    A_full = (M @ M.conj().T + n * sps.identity(n)).tocsr()
    A_upper = sps.triu(A_full).tocsr()
    b = rng.random(n) + 1j * rng.random(n)
    pt, iparm = pardisoinit(4)
    X, _, _, err = pardiso(A_upper, b, pt, 4, iparm, 13)
    assert err == 0
    npt.assert_array_almost_equal(
        X, np.linalg.solve(A_full.toarray(), b), decimal=6
    )


def test_export_factorization_iterative_route_raises_cleanly():
    """The matrix-free route stores no dense factor; export must raise
    the documented ValueError, not a TypeError unpack crash."""
    from sparse_dot_tpu.config import config as _cfg
    from sparse_dot_tpu.solvers import export_factorization

    old = _cfg.pardiso_dense_budget_bytes
    _cfg.pardiso_dense_budget_bytes = 1 << 10
    try:
        n = 80
        M = sps.random(n, n, density=0.1, random_state=40, format="csr")
        A = (M @ M.T + n * sps.identity(n)).tocsr()
        b = np.random.default_rng(41).random(n)
        pt, iparm = pardisoinit(2)
        import warnings as _w
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            _, pt, _, err = pardiso(A, b, pt, 2, iparm, 13)
        assert err == 0
        with pytest.raises(ValueError):
            export_factorization(pt)
    finally:
        _cfg.pardiso_dense_budget_bytes = old


# -- review-r5 solve-path and fallback semantics ---------------------------


def test_complex_rhs_over_real_factor():
    """Real A (mtype 11) with a complex B: the solve must split the
    parts, not cast B to real (review r5 — Im(B) was dropped on every
    backend where the pre-solve astype ran)."""
    rng = np.random.default_rng(50)
    A = _A.astype(np.float64)
    b = _B[:, 0] + 1j * rng.random(_B.shape[0])
    pt, iparm = pardisoinit(11)
    X, _, _, err = pardiso(A, b, pt, 11, iparm, 13)
    assert err == 0
    assert np.iscomplexobj(X)
    npt.assert_array_almost_equal(
        X, np.linalg.solve(A.toarray(), b), decimal=6
    )


def test_complex_factor_real_rhs_warns_on_lost_imag():
    """Complex A with a real-dtyped B: X is complex but B's dtype
    cannot carry it — the solve must warn, not silently drop Im(X)."""
    n = 20
    M = sps.random(n, n, density=0.3, random_state=51, format="csr")
    A = (M + 1j * sps.random(n, n, density=0.3, random_state=52)
         + n * sps.identity(n)).tocsr().astype(np.complex128)
    b = np.random.default_rng(53).random(n)  # real dtype
    pt, iparm = pardisoinit(13)
    with pytest.warns(RuntimeWarning, match="imaginary part"):
        X, _, _, err = pardiso(A, b, pt, 13, iparm, 13)
    assert err == 0
    npt.assert_array_almost_equal(
        X, np.linalg.solve(A.toarray(), b).real, decimal=6
    )


def test_singular_matrix_reports_error():
    """LU of an exactly singular matrix is FINITE with a zero pivot;
    the factor phase must report -4 like MKL, not solve to inf/NaN
    with error 0 (review r5)."""
    A = sps.csr_matrix(np.diag([1.0, 0.0, 2.0]))
    b = np.ones(3)
    pt, iparm = pardisoinit(11)
    X, _, _, err = pardiso(A, b, pt, 11, iparm, 13, quiet=True)
    assert err == -4
    assert not X.any()


def test_indefinite_mtype_krylov_uses_fgmres():
    """mtype -2 (symmetric INDEFINITE) beyond the dense budget must
    not run CG (unsound for indefinite operators); the FGMRES route
    solves a saddle-point system CG stalls on (review r5)."""
    from sparse_dot_tpu.config import config as _cfg

    rng = np.random.default_rng(54)
    n = 60
    M = sps.random(n, n, density=0.15, random_state=54, format="csr")
    S = (M + M.T).tocsr()
    # shift to make it clearly indefinite but well conditioned
    A = (S + sps.diags(np.where(np.arange(n) % 2 == 0, 8.0, -8.0))
         ).tocsr()
    b = rng.random(n)
    old = _cfg.pardiso_dense_budget_bytes
    _cfg.pardiso_dense_budget_bytes = 1 << 10
    try:
        pt, iparm = pardisoinit(-2)
        with pytest.warns(RuntimeWarning, match="matrix-free"):
            X, _, _, err = pardiso(A, b, pt, -2, iparm, 13)
        assert err == 0
        npt.assert_array_almost_equal(
            X, np.linalg.solve(A.toarray(), b), decimal=5
        )
    finally:
        _cfg.pardiso_dense_budget_bytes = old


def test_complex_over_budget_fails_at_factor():
    """The Krylov fallback is real-only: a complex system beyond the
    budget must fail AT FACTOR TIME with a clear warning instead of
    promising a solve phase 33 then rejects (review r5)."""
    from sparse_dot_tpu.config import config as _cfg

    n = 40
    M = sps.random(n, n, density=0.2, random_state=55, format="csr")
    A = (M + 1j * M + n * sps.identity(n)).tocsr().astype(np.complex128)
    b = np.ones(n, np.complex128)
    old = _cfg.pardiso_dense_budget_bytes
    _cfg.pardiso_dense_budget_bytes = 1 << 8
    try:
        pt, iparm = pardisoinit(13)
        with pytest.warns(RuntimeWarning, match="real mtypes only"):
            X, _, _, err = pardiso(A, b, pt, 13, iparm, 13, quiet=True)
        assert err == -1
    finally:
        _cfg.pardiso_dense_budget_bytes = old


def test_refactor_after_budget_raise_disarms_krylov():
    """Factor over-budget (Krylov armed), raise the budget, refactor
    on the SAME pt: the direct LU must disarm the stale iterative
    route or phase 33 solves against the old container (review r5)."""
    from sparse_dot_tpu.config import config as _cfg

    rng = np.random.default_rng(56)
    n = 50
    M = sps.random(n, n, density=0.2, random_state=56, format="csr")
    A1 = (M @ M.T + n * sps.identity(n)).tocsr()
    A2 = (A1 * 3.0).tocsr()  # different matrix, same structure
    b = rng.random(n)
    old = _cfg.pardiso_dense_budget_bytes
    try:
        _cfg.pardiso_dense_budget_bytes = 1 << 10
        pt, iparm = pardisoinit(2)
        import warnings as _w
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            _, pt, _, err = pardiso(A1, b, pt, 2, iparm, 12)
        assert err == 0
        _cfg.pardiso_dense_budget_bytes = old
        _, pt, _, err = pardiso(A2, b, pt, 2, iparm, 22)
        assert err == 0
        X, _, _, err = pardiso(A2, b, pt, 2, iparm, 33)
        assert err == 0
        npt.assert_array_almost_equal(
            X, np.linalg.solve(A2.toarray(), b), decimal=6
        )
    finally:
        _cfg.pardiso_dense_budget_bytes = old

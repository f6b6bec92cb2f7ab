"""On-card tests: the capability gates and routes as they are on the GPU.

The CPU suite forces each gate both ways; these tests check what the
gates choose on the card itself, and that each route they pick is
numerically right there: native f64 and native complex, f64 LU and QR,
the measured SpMM crossovers, the batched BSR product, and the
structural SpGEMM paths.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps

import jax.numpy as jnp

import sparse_dot_tpu as sdt
from sparse_dot_tpu import backend, formats
from sparse_dot_tpu.config import config
from sparse_dot_tpu.ops import host as hops
from sparse_dot_tpu.ops import _xla

pytestmark = pytest.mark.chip


def test_capabilities_on_gpu():
    assert backend.has_native_f64()
    assert backend.has_native_complex()
    assert backend.has_f64_lu()
    assert backend.has_f64_qr()
    assert backend.spmm_crossovers() is backend._SPMM_CROSSOVERS["gpu"]


def test_bsr_batched_product_runs():
    """128x128 f32 blocks take the batched XLA block product on the
    card, at FP32 accuracy (no TF32)."""
    A = sps.random(
        1024, 1024, density=0.05, format="csr", dtype=np.float32,
        random_state=0,
    ).tobsr(blocksize=(128, 128))
    b = np.random.default_rng(1).random((1024, 130)).astype(np.float32)
    Ad = formats.to_device(A)
    got = np.asarray(hops._real_spmm(Ad, Ad.data, jnp.asarray(b), False))
    ref = A.toarray().astype(np.float64) @ b.astype(np.float64)
    npt.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_ell_gate_matches_crossover():
    """Low-density CSR f64 with moderate n takes the ELL path exactly
    when its density is under the card's measured crossover."""
    A = sps.random(
        20000, 20000, density=0.0005, format="csr", dtype=np.float64,
        random_state=2,
    )
    Ad = formats.to_device(A)
    expect = 0.0005 <= backend.spmm_crossovers()["ell_below"]
    assert hops._prefer_ell(
        Ad, Ad.data, 20000, 20000, 128, A.nnz, False
    ) == expect
    b = np.random.default_rng(3).random((20000, 16))
    got = sdt.dot_product(A, b)
    npt.assert_allclose(got, A @ b, rtol=1e-10, atol=1e-10)


def test_native_f64_gemm_chosen():
    """A large f64 GEMM takes one native f64 product on the card (the
    Ozaki gate stays off under ``auto``) and is f64-accurate."""
    from sparse_dot_tpu.ops import ozaki

    assert config.ozaki == "auto"
    assert not ozaki.enabled(np.float64, 512, 512 * 512 * 512)
    rng = np.random.default_rng(4)
    a = rng.random((512, 512))
    b = rng.random((512, 512))
    got = sdt.dot_product(a, b)
    npt.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-10)


def test_densify_crossover_high_density():
    """Above the card's measured crossover the densify route is chosen,
    and it keeps FP32 accuracy."""
    density = 0.3
    assert _xla._prefer_densify(2000, 2000, 128, int(2000 * 2000 * density),
                                np.float32)
    A = sps.random(2000, 2000, density=density, format="csr",
                   dtype=np.float32, random_state=5)
    b = np.random.default_rng(6).random((2000, 64)).astype(np.float32)
    got = sdt.dot_product(A, b)
    ref = A.astype(np.float64) @ b.astype(np.float64)
    npt.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_native_complex_spmm():
    A = sps.random(300, 400, density=0.05, format="csr",
                   dtype=np.float64, random_state=7)
    Ac = (A + 0.5j * A).astype(np.complex128).tocsr()
    Ad = formats.to_device(Ac)
    assert not Ad.planar
    bc = (
        np.random.default_rng(8).random((400, 8))
        + 1j * np.random.default_rng(9).random((400, 8))
    )
    got = sdt.dot_product(Ac, bc)
    npt.assert_allclose(got, Ac @ bc, rtol=1e-12, atol=1e-12)


def test_pardiso_factors_in_f64():
    """f64 direct solve factors in f64 on the card (no f32 factor and
    refinement)."""
    import importlib

    from sparse_dot_tpu.solvers import pardiso, pardisoinit

    pardiso_mod = importlib.import_module("sparse_dot_tpu.solvers.pardiso")

    n = 120
    M = sps.random(n, n, density=0.2, random_state=10, format="csr")
    A = (M + n * sps.identity(n)).tocsr()
    b = np.random.default_rng(11).random(n)
    pt, iparm = pardisoinit(11)
    X, pt, _, err = pardiso(A, b, pt, 11, iparm, 13)
    assert err == 0
    assert pardiso_mod._factor_store[int(pt[0])]["mixed"] is False
    npt.assert_allclose(X, np.linalg.solve(A.toarray(), b),
                        rtol=1e-12, atol=1e-12)


def test_small_lstsq_takes_qr():
    import importlib

    qr_mod = importlib.import_module("sparse_dot_tpu.solvers.qr")

    A = sps.random(400, 60, density=0.1, format="csr", random_state=12)
    A = (A + sps.eye(400, 60, format="csr")).tocsr()
    b = np.random.default_rng(13).random(400)
    x = sdt.sparse_qr_solve(A, b)
    assert qr_mod._last_cgls_iters is None
    npt.assert_allclose(x, np.linalg.lstsq(A.toarray(), b, rcond=None)[0],
                        rtol=1e-10, atol=1e-10)


def test_esc_spgemm_on_card():
    config_prev = config.spgemm_exact_pattern
    config.spgemm_exact_pattern = True
    try:
        A = sps.random(800, 700, density=0.02, format="csr",
                       dtype=np.float64, random_state=12)
        B = sps.random(700, 900, density=0.02, format="csr",
                       dtype=np.float64, random_state=13)
        C = sdt.dot_product(A, B)
        O = A @ B
        O.sort_indices()
        assert C.nnz == O.nnz
        npt.assert_allclose(C.data, O.data, rtol=1e-12, atol=1e-13)
    finally:
        config.spgemm_exact_pattern = config_prev


def test_structural_pattern_on_card():
    """The default sparse-output path keeps exactly-cancelled entries
    as explicit zeros (pattern matmul) on the card — both the
    host-extract small path and the fused device-resident path."""
    A = sps.csr_matrix(np.array([[1.0, -1.0], [2.0, 0.0]]))
    B = sps.csr_matrix(np.array([[1.0, 3.0], [1.0, 0.0]]))
    C = sdt.dot_product(A, B)
    assert C.nnz == 4 and C[0, 0] == 0.0
    npt.assert_allclose(C.toarray(), A.toarray() @ B.toarray())

    Ad, Bd = formats.to_device(A), formats.to_device(B)
    Cd = hops.spgemm_device(Ad, Bd, out_dtype=np.float64)
    assert int(Cd.indptr[-1]) == 4
    # steady state: fused single-dispatch extraction with cached size
    Cd2 = hops.spgemm_device(Ad, Bd, out_dtype=np.float64,
                             sync_check=False)
    hops.validate_speculation()
    assert int(Cd2.indptr[-1]) == 4


def test_structural_matches_scipy_on_card():
    """Medium product through the fused structural program vs the
    scipy oracle (pattern AND values) on the card."""
    A = sps.random(300, 400, density=0.05, format="csr",
                   dtype=np.float64, random_state=11)
    B = sps.random(400, 350, density=0.05, format="csr",
                   dtype=np.float64, random_state=12)
    C = sdt.dot_product(A, B)
    oracle = A @ B
    oracle.sort_indices()
    assert C.nnz == oracle.nnz
    npt.assert_array_equal(C.indptr, oracle.indptr)
    npt.assert_array_equal(C.indices, oracle.indices)
    npt.assert_allclose(C.data, oracle.data, atol=1e-10)


def test_fgmres_on_card():
    """First-party FGMRES device loop converges on the card."""
    from sparse_dot_tpu.solvers import fgmres

    n = 48
    rng = np.random.default_rng(21)
    A = (sps.random(n, n, density=0.25, random_state=22, format="csr")
         + n * sps.identity(n)).tocsr()
    b = rng.random(n)
    x, code = fgmres(A, b, tol=1e-12)
    assert code == 0
    npt.assert_allclose(x, np.linalg.solve(A.toarray(), b), atol=1e-8)

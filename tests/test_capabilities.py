"""Capability predicates and the route gates that read them.

The suite runs on the CPU backend; these tests patch the active platform
to ``"gpu"`` (and to a platform without native f64) and check what each
gate then chooses, so the card's routes are covered without a card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps

import jax.numpy as jnp

from sparse_dot_tpu import backend, formats
from sparse_dot_tpu.config import config
from sparse_dot_tpu.ops import _xla, ozaki
from sparse_dot_tpu.ops import host as hops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(backend, "default_platform", lambda: "gpu")


@pytest.fixture
def on_emulated_f64(monkeypatch):
    """A device without native f64 or complex (none is supported; the
    predicates must still route it to the emulation paths)."""
    monkeypatch.setattr(backend, "default_platform", lambda: "other")


@pytest.mark.parametrize("pred", ["has_native_f64", "has_native_complex",
                                  "has_f64_lu", "has_f64_qr"])
def test_gpu_capabilities(on_gpu, pred):
    assert getattr(backend, pred)() is True


@pytest.mark.parametrize("pred", ["has_native_f64", "has_native_complex",
                                  "has_f64_lu", "has_f64_qr"])
def test_emulated_f64_capabilities(on_emulated_f64, pred):
    assert getattr(backend, pred)() is False


def test_ozaki_auto_off_on_gpu(on_gpu):
    assert config.ozaki == "auto"
    # the reference demo's X @ X.T contraction (500 x 5000 x 500)
    assert not ozaki.enabled(np.float64, 5000, 500 * 5000 * 500)


def test_ozaki_auto_on_without_native_f64(on_emulated_f64):
    assert ozaki.enabled(np.float64, 5000, 500 * 5000 * 500)
    assert not ozaki.enabled(np.float64, 64, 64 ** 3)  # too small
    assert not ozaki.enabled(np.float32, 5000, 500 * 5000 * 500)


def test_ozaki_forced_everywhere(on_gpu, monkeypatch):
    monkeypatch.setattr(config, "ozaki", "1")
    assert ozaki.enabled(np.float64, 5000, 64)
    monkeypatch.setattr(config, "ozaki", "0")
    assert not ozaki.enabled(np.float64, 5000, 500 * 5000 * 500)


def test_crossovers_unknown_platform_raise(on_emulated_f64):
    with pytest.raises(NotImplementedError):
        backend.spmm_crossovers()


def test_crossovers_gpu_table(on_gpu):
    assert backend.spmm_crossovers() is backend._SPMM_CROSSOVERS["gpu"]


# The two shapes the GPU crossovers were measured at (PERF.md): BASELINE
# config 1 (10k x 10k at 1%, n=128) and the reference demo's operand
# (500 x 5000 at 21.2%).  Expected routes: GPU_ROUTES.
SHAPES = {
    "spmm_1pct": (10000, 10000, 0.01),
    "demo_21pct": (500, 5000, 0.212),
}
GPU_ROUTES = {"spmm_1pct": "ell", "demo_21pct": "densify"}


def _route(m, k, density, n=128):
    A = sps.random(m, k, density=density, format="csr", dtype=np.float64,
                   random_state=0)
    Ad = formats.to_device(A)
    if hops._prefer_ell(Ad, Ad.data, m, k, n, A.nnz, False):
        return "ell"
    if _xla._prefer_densify(m, k, n, A.nnz, np.float64):
        return "densify"
    return "scatter"


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gpu_spmm_route_at_measured_shapes(on_gpu, shape):
    assert _route(*SHAPES[shape]) == GPU_ROUTES[shape]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cpu_spmm_route_at_measured_shapes(shape):
    # CPU: ELL off, densify only above 25%.
    assert _route(*SHAPES[shape]) == "scatter"


def test_densify_refused_when_dense_operand_too_big(on_gpu):
    assert not _xla._prefer_densify(100_000, 100_000, 128,
                                    100_000 * 100_000 // 2, np.float64)


def test_no_pallas_route_for_aligned_f32_bsr(on_gpu, monkeypatch):
    """128x128 f32 BSR on the card takes the batched XLA product: the
    Pallas block kernel is gone."""
    A = sps.random(512, 512, density=0.1, format="csr", dtype=np.float32,
                   random_state=1).tobsr(blocksize=(128, 128))
    Ad = formats.to_device(A)
    b = np.random.default_rng(2).random((512, 128)).astype(np.float32)
    calls = []
    orig = _xla.bsr_spmm

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(_xla, "bsr_spmm", spy)
    got = np.asarray(hops._real_spmm(Ad, Ad.data, jnp.asarray(b), False))
    assert calls == [1]
    ref = A.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ImportError):
        import sparse_dot_tpu.ops.pallas_bsr  # noqa: F401


def test_f64_blocked_budget_is_full(on_gpu, monkeypatch):
    """An f64 product whose dense intermediate is between a quarter and
    all of the budget runs the one-shot fused route on the card (no f64
    budget cut), not the row-blocked one."""
    monkeypatch.setattr(hops, "_BLOCKED_SPGEMM_BYTES", 4 << 20)
    A = sps.random(400, 300, density=0.05, format="csr", dtype=np.float64,
                   random_state=3)
    B = sps.random(300, 400, density=0.05, format="csr", dtype=np.float64,
                   random_state=4)
    # 400 * 400 * 8 = 1.28 MB: over a quarter of 4 MB, under all of it
    blocked = []
    orig = hops._blocked_spgemm_arrays

    def spy(*args, **kwargs):
        blocked.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(hops, "_blocked_spgemm_arrays", spy)
    Ad, Bd = formats.to_device(A), formats.to_device(B)
    data, indices, indptr = hops.spgemm_sparse_arrays(Ad, Bd, np.float64)
    assert blocked == []
    got = sps.csr_matrix((data, indices, indptr), shape=(400, 400))
    np.testing.assert_allclose(got.toarray(), (A @ B).toarray(),
                               rtol=1e-12, atol=1e-12)


def test_pardiso_mixed_only_without_f64_lu(on_emulated_f64):
    import importlib

    from sparse_dot_tpu.solvers import pardiso, pardisoinit

    pardiso_mod = importlib.import_module("sparse_dot_tpu.solvers.pardiso")
    n = 60
    M = sps.random(n, n, density=0.2, random_state=5, format="csr")
    A = (M + n * sps.identity(n)).tocsr()
    b = np.random.default_rng(6).random(n)
    pt, iparm = pardisoinit(11)
    X, pt, _, err = pardiso(A, b, pt, 11, iparm, 13)
    assert err == 0
    assert pardiso_mod._factor_store[int(pt[0])]["mixed"] is True
    np.testing.assert_allclose(X, np.linalg.solve(A.toarray(), b),
                               rtol=1e-10, atol=1e-10)


def _cache_dir_after_import(env):
    code = ("import jax, sparse_dot_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **env}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_dir_env_left_alone(tmp_path):
    target = str(tmp_path / "cache")
    assert _cache_dir_after_import(
        {"JAX_COMPILATION_CACHE_DIR": target}) == target


def test_compile_cache_default_in_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    code = ("import jax, sparse_dot_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**env, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == os.path.join(
        REPO, ".jax_cache")

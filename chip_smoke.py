"""Drive the public sparse_dot path once on the GPU and check it against
scipy/numpy.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded path only

Each phase goes through the public API at the sizes the library's users
run (``BASELINE.md`` configs 1-5, the reference demo, the README's 1M x 1M
product, a 100^3 27-point stencil), with data made from a seed.  It prints
one line per phase: shape, dtype, the device kernels the call reached,
the first-call time (compilation included), the warm-call time, and the
largest error against the oracle beside its tolerance.  Errors are
normwise: max |ours - oracle| / max |oracle|.  Any phase that fails stops
the run with a nonzero exit.  The last line of standard output is one
JSON object naming the device.

There is no fallback: without a GPU the script exits nonzero before any
phase, and every kernel runs as compiled for the card.
"""

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla

SEED = 20240601


def card_lines():
    """The cards' name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Route spy: records which device kernels of the op layer a call reaches.
# ---------------------------------------------------------------------------


class RouteSpy:
    """Wraps the public kernel functions of ``ops._xla`` and ``ops.ozaki``
    and records, in call order, the names reached while active.  Jitted
    callers only re-enter their callees while tracing, so a route is read
    from a phase's first call."""

    def __init__(self, *modules):
        self._modules = modules
        self._saved = []
        self.calls = []

    # Policy helpers, not kernels.
    _SKIP = ("enabled", "supported", "plan")

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def spy(*args, **kwargs):
            if name not in self.calls:
                self.calls.append(name)
            return fn(*args, **kwargs)

        return spy

    def __enter__(self):
        self.calls = []
        for mod in self._modules:
            for name, fn in list(vars(mod).items()):
                if (name.startswith("_") or name in self._SKIP
                        or not callable(fn)):
                    continue
                if isinstance(fn, type) or getattr(
                        fn, "__module__", None) != mod.__name__:
                    continue
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []
        return False


def normwise_err(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        raise AssertionError(f"shape {got.shape} != oracle {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError("non-finite values in the result")
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    diff = float(np.abs(got - ref).max()) if ref.size else 0.0
    return diff / scale if scale > 0 else diff


def sparse_err(got, ref):
    """Pattern must be equal (indptr, indices); returns the values'
    normwise error."""
    got = sps.csr_matrix(got)
    ref = sps.csr_matrix(ref)
    got.sort_indices()
    ref.sort_indices()
    if got.shape != ref.shape:
        raise AssertionError(f"shape {got.shape} != oracle {ref.shape}")
    if not (np.array_equal(got.indptr, ref.indptr)
            and np.array_equal(got.indices, ref.indices)):
        raise AssertionError(
            f"pattern differs from scipy (nnz {got.nnz} vs {ref.nnz})"
        )
    return normwise_err(got.data, ref.data)


class Runner:
    def __init__(self, spy):
        self.spy = spy

    def phase(self, name, shape, dtype, fn, check, tol=None, route=None):
        """Run ``fn`` three times (the first call compiles; the second
        may compile the steady-state variants the inspector-executor
        caches enable; the third is warm), check the warm result, print
        one line, and raise when it is out of tolerance.
        ``check`` returns an error to compare with ``tol``, or a dict
        {label: (error, tolerance)} when a phase has several oracles."""
        with self.spy:
            t0 = time.perf_counter()
            out = fn()
            first = time.perf_counter() - t0
        reached = "+".join(self.spy.calls) or "-"
        if route is not None:
            reached = f"{route(out)}; kernels={reached}"
        fn()
        t0 = time.perf_counter()
        out = fn()
        warm = time.perf_counter() - t0
        res = check(out)
        crit = res if isinstance(res, dict) else {"err": (res, tol)}
        ok = all(bool(e <= t) for e, t in crit.values())
        errs = " ".join(
            f"{k}={e:.3e} tol={t:.1e}" for k, (e, t) in crit.items()
        )
        line = (
            f"[{'ok' if ok else 'FAIL'}] {name}: shape={shape} "
            f"dtype={dtype} route={reached} first={first:.3f}s "
            f"warm={warm:.3f}s {errs}"
        )
        print(line, flush=True)
        if not ok:
            raise AssertionError(line)
        return out


# ---------------------------------------------------------------------------
# Data (all from SEED)
# ---------------------------------------------------------------------------


def demo_matrix(dtype=np.float64):
    return sps.random(500, 5000, density=0.212, format="csr", dtype=dtype,
                      random_state=SEED)


def stencil27(g):
    """27-point 3D Poisson operator on a g^3 grid (HPCG's matrix:
    26 on the diagonal, -1 for each neighbour)."""
    one = sps.diags([np.ones(g - 1), np.ones(g), np.ones(g - 1)],
                    [-1, 0, 1], format="csr")
    k = sps.kron(sps.kron(one, one, format="csr"), one, format="csr")
    n = g ** 3
    A = (27.0 * sps.identity(n, format="csr") - k).tocsr()
    A.sort_indices()
    return A


def lsq_config5(m=1_200_000, k=50_000, seed=SEED):
    """BASELINE config 5: k well-conditioned diagonal rows plus
    (m - k) rows of 4 random entries; b = A @ x_true."""
    rng = np.random.default_rng(seed)
    ri = np.repeat(np.arange(k, m), 4)
    ci = rng.integers(0, k, 4 * (m - k))
    vi = rng.standard_normal(4 * (m - k)) * 0.5
    A = sps.csr_matrix(
        (np.concatenate([np.full(k, 2.0), vi]),
         (np.concatenate([np.arange(k), ri]),
          np.concatenate([np.arange(k), ci]))),
        shape=(m, k),
    )
    A.sum_duplicates()
    x_true = rng.standard_normal(k)
    return A, x_true, A @ x_true


def hypersparse(m=1_000_000, nnz=2_000_000, seed=SEED):
    rng = np.random.default_rng(seed)
    A = sps.csr_matrix(
        (rng.standard_normal(nnz),
         (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
        shape=(m, m),
    )
    A.sum_duplicates()
    A.sort_indices()
    return A


def fem_bsr(g=30, dtype=np.float64, seed=SEED):
    """3D linear-elasticity-shaped BSR: 3x3 blocks (3 dofs per node),
    27-point node connectivity on a g^3 node grid."""
    pattern = stencil27(g)
    nb = pattern.nnz
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((nb, 3, 3)).astype(dtype)
    n = 3 * g ** 3
    return sps.bsr_matrix((data, pattern.indices, pattern.indptr),
                          shape=(n, n))


def block_bsr(nbr=128, bs=128, density=0.02, dtype=np.float32, seed=SEED):
    pattern = sps.random(nbr, nbr, density=density, format="csr",
                         random_state=seed)
    pattern.sort_indices()
    rng = np.random.default_rng(seed + 1)
    data = rng.standard_normal((pattern.nnz, bs, bs)).astype(dtype)
    return sps.bsr_matrix((data, pattern.indices, pattern.indptr),
                          shape=(nbr * bs, nbr * bs))


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------


def run_one_card(run):
    import importlib

    import sparse_dot_tpu as sdt
    from sparse_dot_tpu import backend

    pardiso_mod = importlib.import_module("sparse_dot_tpu.solvers.pardiso")
    qr_mod = importlib.import_module("sparse_dot_tpu.solvers.qr")

    rng = np.random.default_rng(SEED)

    # -- demo: the reference's X @ X.T and its syrk analog --------------
    X = demo_matrix()
    XT = X.T.tocsc()
    ref = (X @ XT).tocsr()
    run.phase("demo X@X.T", X.shape, "float64",
              lambda: sdt.dot_product(X, XT),
              lambda out: sparse_err(out, ref), 1e-10)
    ref_g = np.triu((X @ X.T).toarray())
    run.phase("demo gram_matrix_mkl(X, transpose=True, dense=True)",
              X.shape, "float64",
              lambda: sdt.gram_matrix_mkl(X, transpose=True, dense=True),
              lambda out: normwise_err(out, ref_g), 1e-10)

    # -- spmm: BASELINE config 1 with out=/out_scalar= -------------------
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 1e-5)):
        A = sps.random(10_000, 10_000, density=0.01, format="csr",
                       dtype=dtype, random_state=SEED + 1)
        B = rng.standard_normal((10_000, 128)).astype(dtype)
        out0 = rng.standard_normal((10_000, 128)).astype(dtype)
        ref_s = (A.astype(np.float64) @ B.astype(np.float64)
                 + 2.0 * out0.astype(np.float64))

        def spmm(A=A, B=B, out0=out0):
            out = out0.copy()
            res = sdt.dot_product(A, B, out=out, out_scalar=2.0)
            assert res is out
            return res

        run.phase("spmm config1 out=/out_scalar=", (A.shape, B.shape),
                  np.dtype(dtype).name, spmm,
                  lambda out, ref_s=ref_s: normwise_err(out, ref_s), tol)

    # -- spgemm: BASELINE config 2 and the 1M x 1M product ---------------
    for dtype, tol in ((np.float32, 1e-5), (np.float64, 1e-10)):
        A = sps.random(20_000, 20_000, density=0.001, format="csr",
                       dtype=dtype, random_state=SEED + 2)
        ref_a = (A.astype(np.float64) @ A.astype(np.float64)).tocsr()
        run.phase("spgemm config2 reorder_output", A.shape,
                  np.dtype(dtype).name,
                  lambda A=A: sdt.dot_product(A, A, reorder_output=True),
                  lambda out, ref_a=ref_a: sparse_err(out, ref_a), tol)
    H = hypersparse()
    ref_h = (H @ H).tocsr()
    run.phase("spgemm 1Mx1M A@A (any-size ESC driver)", H.shape,
              "float64", lambda: sdt.dot_product(H, H),
              lambda out: sparse_err(out, ref_h), 1e-10)
    del H, ref_h

    # -- bsr: BASELINE config 3, BSR x dense with accumulate -------------
    for Ab, n, tol in ((fem_bsr(), 128, 1e-10),
                       (block_bsr(), 128, 1e-5)):
        dtype = Ab.dtype
        B = rng.standard_normal((Ab.shape[1], n)).astype(dtype)
        out0 = rng.standard_normal((Ab.shape[0], n)).astype(dtype)
        ref_b = (Ab.astype(np.float64) @ B.astype(np.float64)
                 + 0.5 * out0.astype(np.float64))

        def bsr(Ab=Ab, B=B, out0=out0):
            out = out0.copy()
            res = sdt.dot_product(Ab, B, out=out, out_scalar=0.5)
            assert res is out
            return res

        run.phase(f"bsr config3 blocks={Ab.blocksize} accumulate",
                  (Ab.shape, B.shape), dtype.name, bsr,
                  lambda out, ref_b=ref_b: normwise_err(out, ref_b), tol)

    # -- gram_c128: BASELINE config 4, native complex ---------------------
    G = sps.random(20_000, 2_000, density=0.01, format="csr",
                   random_state=SEED + 3)
    Gc = (G + 0.5j * sps.random(20_000, 2_000, density=0.01,
                                format="csr", random_state=SEED + 4)
          ).astype(np.complex128).tocsr()
    ref_c = np.triu((Gc.T @ Gc).toarray())
    run.phase("gram_c128 config4 A^T A", Gc.shape, "complex128",
              lambda: sdt.gram_matrix(Gc, allow_complex=True),
              lambda out: normwise_err(out.toarray(), ref_c), 1e-10,
              route=lambda out: (
                  "native-complex" if backend.has_native_complex()
                  else "planar"))
    del G, Gc, ref_c

    # -- solvers ----------------------------------------------------------
    S = stencil27(100)
    bS = rng.standard_normal(S.shape[0])
    cg_tol = 1e-8

    def cg():
        x, code = sdt.cg(S, bS, tol=cg_tol, maxiter=5000)
        assert code == 0, f"cg returned {code}"
        return x

    run.phase("cg 27-point stencil 100^3", S.shape, "float64", cg,
              lambda x: (np.linalg.norm(bS - S @ x)
                         / np.linalg.norm(bS)), cg_tol)
    del S, bS

    A5, x5, b5 = lsq_config5()
    run.phase("sparse_qr_solve config5 (CGLS)", A5.shape, "float64",
              lambda: sdt.sparse_qr_solve(A5, b5),
              lambda x: normwise_err(x, x5), 1e-6,
              route=lambda x: (
                  "cgls" if qr_mod._last_cgls_iters is not None
                  else "householder-qr"))
    del A5, x5, b5

    Aq = sps.random(5_000, 300, density=0.02, format="csr",
                    random_state=SEED + 5)
    Aq = (Aq + sps.eye(5_000, 300, format="csr")).tocsr()
    bq = rng.standard_normal(5_000)
    ref_q = np.linalg.lstsq(Aq.toarray(), bq, rcond=None)[0]

    def qr_route(x):
        route = ("cgls" if qr_mod._last_cgls_iters is not None
                 else "householder-qr")
        assert route == "householder-qr" or not backend.has_f64_qr(), (
            "f64 QR available but the solve took CGLS"
        )
        return route

    run.phase("sparse_qr_solve small (f64 Householder QR)", Aq.shape,
              "float64", lambda: sdt.sparse_qr_solve(Aq, bq),
              lambda x: normwise_err(x, ref_q), 1e-8, route=qr_route)

    n_f = 10_000
    M = sps.random(n_f, n_f, density=10.0 / n_f, format="csr",
                   random_state=SEED + 6)
    M = M - sps.random(n_f, n_f, density=5.0 / n_f, format="csr",
                       random_state=SEED + 7)
    Af = (M + sps.diags(np.asarray(abs(M).sum(axis=1)).ravel() + 1.0)
          ).tocsr()
    bf = rng.standard_normal(n_f)
    ref_f = spla.spsolve(Af.tocsc(), bf)

    def fgmres():
        x, code = sdt.fgmres(Af, bf, tol=1e-12, maxiter=2000)
        assert code == 0, f"fgmres returned {code}"
        return x

    run.phase("fgmres nonsymmetric", Af.shape, "float64", fgmres,
              lambda x: normwise_err(x, ref_f), 1e-8)

    n_p = 4_000
    Mp = sps.random(n_p, n_p, density=0.002, format="csr",
                    random_state=SEED + 8)
    Ap = (Mp + sps.diags(np.asarray(abs(Mp).sum(axis=1)).ravel() + 1.0)
          ).tocsr()
    bp = rng.standard_normal(n_p)
    ref_p = spla.spsolve(Ap.tocsc(), bp)

    def pardiso():
        pt, iparm = sdt.pardisoinit(11)
        x, pt, _, err = sdt.pardiso(Ap, bp, pt, 11, iparm, 13)
        assert err == 0, f"pardiso error {err}"
        state = pardiso_mod._factor_store[int(pt[0])]
        return x, state["mixed"]

    def pardiso_route(out):
        _, mixed = out
        assert not mixed or not backend.has_f64_lu(), (
            "f64 LU available but PARDISO factored in f32"
        )
        return "f32-lu+refine" if mixed else "f64-lu"

    run.phase("pardiso phase 13", Ap.shape, "float64", pardiso,
              lambda out: normwise_err(out[0], ref_p), 1e-8,
              route=pardiso_route)

    # -- chip tests, in this process --------------------------------------
    import pytest

    t0 = time.perf_counter()
    rc = int(pytest.main(["-q", "-p", "no:cacheprovider", "chip_tests"]))
    line = (f"[{'ok' if rc == 0 else 'FAIL'}] chip_tests: pytest exit "
            f"code {rc} in {time.perf_counter() - t0:.1f}s")
    print(line, flush=True)
    if rc != 0:
        raise AssertionError(line)


# ---------------------------------------------------------------------------
# Four cards: the sharded path, against one card and scipy
# ---------------------------------------------------------------------------


def run_four_cards(run):
    import jax

    import sparse_dot_tpu as sdt
    from sparse_dot_tpu import parallel

    devs = jax.devices()[:4]
    mesh = parallel.make_mesh((4, 1), ("rows", "cols"), devices=devs)
    rng = np.random.default_rng(SEED)

    def on_four(arrs):
        for a in arrs:
            if len(a.sharding.device_set) != 4:
                raise AssertionError(
                    f"array spans {len(a.sharding.device_set)} cards"
                )

    A = sps.random(10_000, 10_000, density=0.01, format="csr",
                   dtype=np.float64, random_state=SEED + 1)
    B = rng.standard_normal((10_000, 128))
    ref = A @ B
    one = sdt.dot_product(A, B)
    print(f"one-card spmm vs scipy: err={normwise_err(one, ref):.3e}")
    A_rows = parallel.shard_csr_rows(A, 4, mesh)
    on_four([A_rows.rows, A_rows.cols, A_rows.vals])
    run.phase("sharded_spmm rows x4", (A.shape, B.shape), "float64",
              lambda: np.asarray(parallel.sharded_spmm(mesh, A_rows, B)),
              lambda out: {"vs_scipy": (normwise_err(out, ref), 1e-10),
                           "vs_one_card": (normwise_err(out, one), 1e-10)})
    A_grid = parallel.shard_csr_grid(A, 4, mesh)
    on_four([A_grid.rows, A_grid.cols, A_grid.vals])
    run.phase("sharded_spmm_ring x4", (A.shape, B.shape), "float64",
              lambda: np.asarray(parallel.sharded_spmm_ring(mesh, A_grid,
                                                            B)),
              lambda out: {"vs_scipy": (normwise_err(out, ref), 1e-10),
                           "vs_one_card": (normwise_err(out, one), 1e-10)})

    S = stencil27(100)
    xs = rng.standard_normal(S.shape[0])
    ref_y = S @ xs
    S_rows = parallel.shard_csr_rows(S, 4, mesh)
    on_four([S_rows.rows, S_rows.cols, S_rows.vals])
    one_y = sdt.dot_product(S, xs)
    run.phase("sharded_spmv_halo 27-point 100^3 x4", S.shape, "float64",
              lambda: parallel.sharded_spmv_halo(mesh, S_rows, xs, halo=1),
              lambda y: {"vs_scipy": (normwise_err(y, ref_y), 1e-12),
                         "vs_one_card": (normwise_err(y, one_y), 1e-12)})

    bS = rng.standard_normal(S.shape[0])
    cg_tol = 1e-10
    x_one, code = sdt.cg(S, bS, tol=cg_tol, maxiter=5000)
    assert code == 0, f"one-card cg returned {code}"

    run.phase("sharded_cg 27-point 100^3 x4", S.shape, "float64",
              lambda: parallel.sharded_cg(
                  mesh, S_rows, bS, tol=cg_tol * np.linalg.norm(bS),
                  maxiter=5000)[0],
              lambda x: {
                  "resid": (np.linalg.norm(bS - S @ x)
                            / np.linalg.norm(bS), cg_tol),
                  "vs_one_card": (normwise_err(x, x_one), 1e-6),
              })
    del S, S_rows

    A5, x5, b5 = lsq_config5()
    A5_rows = parallel.shard_csr_rows(A5, 4, mesh)
    on_four([A5_rows.rows, A5_rows.cols, A5_rows.vals])
    x5_one = sdt.sparse_qr_solve(A5, b5)
    run.phase("sharded_cgls config5 x4", A5.shape, "float64",
              lambda: parallel.sharded_cgls(mesh, A5_rows, b5, tol=1e-10,
                                            maxiter=2000)[0],
              lambda x: {"vs_x_true": (normwise_err(x, x5), 1e-6),
                         "vs_one_card": (normwise_err(x, x5_one), 1e-6)})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded path on four cards, and nothing "
                         "else")
    args = ap.parse_args(argv)
    need = 4 if args.four else 1

    import jax

    import sparse_dot_tpu  # noqa: F401  (enables x64 before any array)
    from sparse_dot_tpu.ops import _xla, ozaki

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r}); nothing was run",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} cards, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    print(card_lines(), flush=True)
    run = Runner(RouteSpy(_xla, ozaki))
    t0 = time.perf_counter()
    if args.four:
        run_four_cards(run)
    else:
        run_one_card(run)
    print(f"all phases passed in {time.perf_counter() - t0:.1f}s",
          flush=True)
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

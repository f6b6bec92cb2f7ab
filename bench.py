"""Benchmark driver.

Headline: the reference's only published measurement — the demo
notebook's SpGEMM ``X @ X.T`` with X = 500x5000 scipy CSR at 21.2%
density, float64 (``/root/reference/demo.ipynb`` cell 6):

    scipy (single-threaded):   204 ms
    dot_product_mkl (MKL):    52.5 ms   <- baseline
    gram_matrix_mkl (syrk):   28.1 ms

The headline value is the full sparse-output SpGEMM with operands
staged on device (transfer cache warm) and the result returned as a
device CSR container.  Extras time the scipy-in / scipy-out call, the
gram path and the ``BASELINE.md`` configs.  Every device time is the
median host-clock time of calls that end in ``jax.block_until_ready``
(or return host arrays), after warm-up calls that compile.

Prints ONE JSON line naming the device it ran on:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N,
   "device": {...}, "extras": {...}}
A run that finds no GPU exits nonzero and prints no result.
"""

import json
import sys
import time

import numpy as np
import scipy.sparse as sps

MKL_SPGEMM_MS = 52.5
MKL_SYRK_MS = 28.1
SCIPY_SPGEMM_MS = 204.0


def _median_ms(fn, reps=10, warmup=2):
    """Median wall time of ``fn()``; device results are waited for with
    ``block_until_ready`` (host results are complete on return)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _r(x, nd=3):
    return None if x is None else round(x, nd)


def _lsq_config5(m=1_200_000, k=50_000, seed=11):
    """BASELINE config 5: k diagonal rows plus 4-nnz random rows;
    b = A @ x_true so the x error is checkable."""
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


def main():
    import jax
    import jax.numpy as jnp

    import sparse_dot_tpu as sdt
    from sparse_dot_tpu import formats
    from sparse_dot_tpu.ops import host as hops
    from sparse_dot_tpu.solvers import qr as qr_mod

    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX backend is {jax.default_backend()!r})",
              file=sys.stderr)
        return 2

    X = sps.random(
        500, 5000, density=0.212, format="csr", dtype=np.float64,
        random_state=100,
    )
    XT = X.T.tocsc()

    # Correctness gate at the reference's own tolerance before timing.
    ours = sdt.dot_product(X, XT)
    oracle = (X @ XT).toarray()
    err = float(np.abs(ours.toarray() - oracle).max())
    assert err < 1.5e-6, f"SpGEMM accuracy gate failed: {err}"

    A = formats.to_device(X)
    B = formats.to_device(XT)

    # --- headline: full SpGEMM, sparse output, device-resident --------
    spgemm_ms = _median_ms(lambda: hops.spgemm_device(A, B))
    gram_ms = _median_ms(lambda: hops.spgemm_device(A, B, triangular=True))
    e2e_ms = _median_ms(lambda: sdt.dot_product(X, XT), reps=5)
    gram_dense_ms = _median_ms(
        lambda: sdt.gram_matrix_mkl(X, transpose=True, dense=True), reps=5
    )

    # f32 SpGEMM on the headline workload
    Xf = X.astype(np.float32)
    Af32 = formats.to_device(Xf)
    Bf32 = formats.to_device(Xf.T.tocsc())
    spgemm32_ms = _median_ms(lambda: hops.spgemm_device(Af32, Bf32))

    # --- BASELINE config 1: CSR SpMM 10k x 10k @ 1%, n=128 ------------
    rng = np.random.default_rng(0)
    Asp = sps.random(
        10000, 10000, density=0.01, format="csr", dtype=np.float64,
        random_state=101,
    )
    Ad = formats.to_device(Asp)
    bdev = jnp.asarray(rng.random((10000, 128)))
    spmm_ms = _median_ms(lambda: hops._real_spmm(Ad, Ad.data, bdev, False))
    Af = formats.to_device(Asp.astype(np.float32))
    bf = bdev.astype(jnp.float32)
    spmm32_ms = _median_ms(lambda: hops._real_spmm(Af, Af.data, bf, False))

    # --- BASELINE config 2: CSR x CSR SpGEMM, sparse output -----------
    A2 = sps.random(20000, 20000, density=0.001, format="csr",
                    dtype=np.float64, random_state=102)
    spgemm2_ms = _median_ms(
        lambda: sdt.dot_product(A2, A2, reorder_output=True), reps=3
    )

    # --- BASELINE config 3: BSR x dense with out/out_scalar -----------
    Absr = sps.random(
        4096, 4096, density=0.02, format="csr", dtype=np.float32,
        random_state=7,
    ).tobsr(blocksize=(128, 128))
    Abd = formats.to_device(Absr)
    bf32 = jnp.asarray(
        np.random.default_rng(3).random((4096, 128)).astype(np.float32)
    )
    bsr_ms = _median_ms(lambda: hops._real_spmm(Abd, Abd.data, bf32, False))
    out_acc = np.ones((4096, 128), dtype=np.float32)
    bsr_acc_ms = _median_ms(
        lambda: sdt.dot_product(Absr, np.asarray(bf32), out=out_acc,
                                out_scalar=0.5),
        reps=5,
    )

    # --- BASELINE config 4: complex128 gram ----------------------------
    Xc = (X + 0.5j * X).astype(np.complex128).tocsr()
    Ac128 = formats.to_device(Xc)
    gram_c128_ms = _median_ms(
        lambda: hops.gram_sparse(Ac128, np.complex128, aat=True)[0], reps=3
    )

    # --- ESC in its own regime: hypersparse 1M x 1M --------------------
    m1 = 1_000_000
    rng1 = np.random.default_rng(7)
    nnz1 = 2_000_000
    A1m = sps.csr_matrix(
        (rng1.standard_normal(nnz1),
         (rng1.integers(0, m1, nnz1), rng1.integers(0, m1, nnz1))),
        shape=(m1, m1),
    )
    A1m.sum_duplicates()
    A1m.sort_indices()
    esc_1m_ms = _median_ms(lambda: sdt.dot_product(A1m, A1m), reps=3,
                           warmup=1)
    esc_1m_phases = {
        kk: (round(vv, 1) if isinstance(vv, float) else vv)
        for kk, vv in hops.esc_last_profile.items()
    }

    # --- BASELINE config 5, one card: 1.2M-row least squares ----------
    A5, x5_true, b5 = _lsq_config5()
    t0 = time.perf_counter()
    x5 = sdt.sparse_qr_solve_mkl(A5, b5)
    qr_1m_first_s = time.perf_counter() - t0
    qr_1m_xerr = float(np.abs(x5 - x5_true).max())
    t0 = time.perf_counter()
    sdt.sparse_qr_solve_mkl(A5, b5)
    qr_1m_warm_s = time.perf_counter() - t0
    qr_1m_iters = qr_mod._last_cgls_iters

    dev = jax.devices()[0]
    result = {
        "metric": "spgemm_xxt_500x5000_f64",
        "value": _r(spgemm_ms),
        "unit": "ms",
        "vs_baseline": _r(MKL_SPGEMM_MS / spgemm_ms),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": {
            "spgemm_e2e_warm_ms": _r(e2e_ms),
            "gram_sparse_ms": _r(gram_ms),
            "gram_dense_e2e_ms": _r(gram_dense_ms),
            "gram_vs_mkl_syrk": _r(MKL_SYRK_MS / gram_ms),
            "vs_scipy_spgemm": _r(SCIPY_SPGEMM_MS / spgemm_ms),
            "spgemm_xxt_f32_ms": _r(spgemm32_ms),
            "spmm_10k_1pct_f64_n128_ms": _r(spmm_ms),
            "spmm_10k_1pct_f32_n128_ms": _r(spmm32_ms),
            "spgemm_20k_0p1pct_f64_e2e_ms": _r(spgemm2_ms),
            "bsr_spmm_f32_ms": _r(bsr_ms),
            "bsr_accumulate_e2e_ms": _r(bsr_acc_ms),
            "gram_c128_ms": _r(gram_c128_ms),
            "spgemm_esc_1m_ms": _r(esc_1m_ms, 1),
            "spgemm_esc_1m_phases_ms": esc_1m_phases,
            "qr_1m_first_s": _r(qr_1m_first_s, 2),
            "qr_1m_warm_s": _r(qr_1m_warm_s, 2),
            "qr_1m_xerr": qr_1m_xerr,
            "qr_1m_iters": qr_1m_iters,
            "max_abs_err": err,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Demo mirroring the reference's ``demo.ipynb``: the SpGEMM
``X @ X.T`` workload (500x5000 CSR, 21.2% dense, float64) timed against
scipy, plus the gram-matrix path — and the extras (device
containers, sharded execution).

Run: ``python examples/demo.py``
"""

import os
import sys
import time

import numpy as np
import scipy.sparse as sps

# Runnable without installation: python examples/demo.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import sparse_dot_tpu as sdt  # noqa: E402


def timeit(name, fn, reps=5):
    fn()  # warm (compile + transfer cache)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    print(f"{name}: {(time.perf_counter() - t0) / reps * 1e3:.2f} ms")


def main():
    print(sdt.get_version_string())

    X = sps.random(
        500, 5000, density=0.212, format="csr", dtype=np.float64,
        random_state=50,
    )
    XT = X.T.tocsc()

    # scipy single-threaded oracle
    timeit("scipy X @ X.T", lambda: X @ XT)

    # framework SpGEMM (same call shape as dot_product_mkl)
    timeit("dot_product(X, X.T)", lambda: sdt.dot_product(X, XT))

    # gram matrix (upper-triangular A A^T, syrk analog)
    timeit(
        "gram_matrix(X, transpose=True, dense=True)",
        lambda: sdt.gram_matrix(X, transpose=True, dense=True),
    )

    # correctness vs scipy
    err = np.abs(
        sdt.dot_product(X, XT).toarray() - (X @ XT).toarray()
    ).max()
    print(f"max |err| vs scipy: {err:.2e}")

    # device containers for jit-resident pipelines
    A = sdt.to_device(X)
    print("device container:", A)

    # sharded execution over every local device
    import jax

    if jax.device_count() > 1:
        from sparse_dot_tpu.parallel import (
            make_mesh, shard_csr_rows, sharded_spmm,
        )

        mesh = make_mesh()
        A_sh = shard_csr_rows(X, jax.device_count(), mesh)
        b = np.random.default_rng(0).random((5000, 64))
        C = sharded_spmm(mesh, A_sh, b)
        print("sharded SpMM result:", C.shape)


if __name__ == "__main__":
    main()

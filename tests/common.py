"""Shared fixtures for the suite — the scipy/numpy-oracle strategy of the
reference (``/root/reference/sparse_dot_mkl/tests/test_mkl.py:27-67``):
seeded random CSR operands and densified ``assert_array_almost_equal``
comparisons against in-process scipy/numpy ground truth."""

import numpy as np
import numpy.testing as npt
import scipy.sparse as sps

SEED = 86


def make_matrixes(a, b, n, density, dtype=np.float64):
    m1 = sps.random(
        a, n, density=density, format="csr", dtype=dtype, random_state=SEED
    )
    m2 = sps.random(
        n, b, density=density, format="csr", dtype=dtype,
        random_state=SEED + 1
    )
    return m1, m2


def make_vector(n, complex=False):
    rng = np.random.default_rng(SEED + 2)
    if not complex:
        return rng.random(n).astype(np.float64)
    return rng.random(n) + rng.random(n) * 1j


MATRIX_1, MATRIX_2 = make_matrixes(200, 100, 300, 0.05)
MATRIX_1_EMPTY = sps.csr_matrix((200, 300), dtype=np.float64)
VECTOR = make_vector(300)


class ForcePlanarMixin:
    """Re-run a complex test class with planar complex storage forced.

    On a backend without native complex every complex op executes the
    planar 4-product decomposition
    (``formats._use_planar``); the CPU test backend has native complex,
    so without this mixin the planar branches would never run under
    coverage.  Mix in FIRST so setUp flips the switch before fixtures
    build device containers.
    """

    def setUp(self):
        from sparse_dot_tpu import formats as _formats
        from sparse_dot_tpu.config import config as _config

        self._planar_prev = _config.force_planar_complex
        _config.force_planar_complex = True
        _formats.clear_transfer_cache()  # cached containers are native
        super().setUp()

    def tearDown(self):
        from sparse_dot_tpu import formats as _formats
        from sparse_dot_tpu.config import config as _config

        _config.force_planar_complex = self._planar_prev
        _formats.clear_transfer_cache()
        super().tearDown()


def np_almost_equal(a, b, decimal=6):
    if sps.issparse(a):
        a = a.toarray()
    if sps.issparse(b):
        b = b.toarray()
    return npt.assert_array_almost_equal(
        np.asarray(a), np.asarray(b), decimal=decimal
    )

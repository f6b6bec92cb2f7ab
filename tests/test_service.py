"""Service / introspection functions.

The backend analogs of MKL's service family
(``/root/reference/sparse_dot_mkl/_mkl_interface/_cfunctions.py:729-782``):
version introspection, thread-width hints, the LP64/ILP64 interface
selector, and the debug-mode flag.
"""

import numpy as np
import pytest

import sparse_dot_tpu as sdt


def test_version_tuple_shape():
    """The mkl_get_version alias returns the 7-slot tuple layout the
    reference's tests rely on: three ints then four strings."""
    v = sdt.mkl_get_version()
    assert len(v) == 7
    assert all(isinstance(x, int) for x in v[:3])
    assert all(isinstance(x, str) for x in v[3:])


def test_version_string_and_dict():
    s = sdt.mkl_get_version_string()
    assert isinstance(s, str) and "sparse_dot_tpu" in s
    d = sdt.get_version()
    for key in ("framework_version", "platform", "num_devices"):
        assert key in d


def test_thread_hint_roundtrip():
    prev = sdt.mkl_set_num_threads_local(1)
    try:
        assert sdt.mkl_get_max_threads() == 1
        sdt.mkl_set_num_threads(3)
        assert sdt.mkl_get_max_threads() == 3
        with pytest.raises(ValueError):
            sdt.mkl_set_num_threads(0)
    finally:
        sdt.mkl_set_num_threads_local(prev)


def test_default_thread_width_positive():
    sdt.mkl_set_num_threads_local(0)  # reset to default
    assert sdt.mkl_get_max_threads() >= 1
    assert isinstance(sdt.mkl_get_max_threads(), int)


@pytest.mark.parametrize(
    "selector,want",
    [(0, np.int32), (1, np.int64), ("LP64", np.int32), ("ILP64", np.int64)],
    ids=["0", "1", "LP64", "ILP64"],
)
def test_interface_layer_selection(selector, want):
    try:
        sdt.mkl_set_interface_layer(selector)
        assert sdt.mkl_interface_integer_dtype() == want
    finally:
        sdt.mkl_set_interface_layer("LP64")


def test_interface_layer_rejects_unknown():
    with pytest.raises(ValueError):
        sdt.mkl_set_interface_layer("MKL")


def test_device_count():
    assert sdt.get_device_count() >= 1


def test_debug_mode_flag():
    sdt.set_debug_mode(True)
    try:
        sdt.set_debug_mode(False)
    finally:
        pass
    with pytest.raises(ValueError):
        sdt.set_debug_mode("yes")


def test_full_f64_range_capability_and_no_warning_on_cpu():
    """CPU backends represent full f64; the range warning must NOT
    fire there, and the capability predicate must say so.  (A backend
    emulating f64 with f32 pairs caps the exponent range at f32's; the
    op layer warns there.)"""
    import warnings

    import numpy as np
    import scipy.sparse as sps

    from sparse_dot_tpu import backend, dot_product

    assert backend.has_native_f64() is True
    A = sps.random(40, 50, density=0.2, format="csr",
                   dtype=np.float64, random_state=3)
    A.data *= 1e200
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = dot_product(A, A.T.tocsc())
    assert not any("representable f64 range" in str(x.message)
                   for x in w)
    oracle = (A @ A.T).toarray()
    np.testing.assert_allclose(got.toarray(), oracle,
                               rtol=1e-12, atol=0)

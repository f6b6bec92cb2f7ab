"""Backend capability probing and service introspection.

The reference's init layer locates ``libmkl_rt`` and probes the usable
integer width at import (``_mkl_interface/_load_library.py:31-96``,
``__init__.py:62-125``).  The analog here describes the XLA backend:
which platform is active, the capabilities the op layer routes on
(native f64 and complex, f64 LU/QR, measured SpMM crossovers), and basic
device topology.

Also hosts the service-function analogs of MKL's
``MKL_Get_Version(_String)`` / ``MKL_Get_Max_Threads`` /
``MKL_Set_Num_Threads`` family (``_mkl_interface/_cfunctions.py:729-771``).
"""

import functools
import os

from .config import __version__

# x64 must be enabled so float64/complex128 semantics match the reference
# (scipy/NumPy default to float64).  This must happen before the first JAX
# array is created.
import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  A directory named by the standard
# JAX_COMPILATION_CACHE_DIR is JAX's own setting and is left alone;
# otherwise the cache lives at a fixed path in the checkout, so that
# every process of one checkout shares it (the path is part of the
# cache key, so a directory that moves never hits).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )
    os.makedirs(_cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@functools.lru_cache(maxsize=None)
def default_platform():
    return jax.default_backend()


# ---------------------------------------------------------------------------
# Capability predicates.  Every route choice that depends on the device
# asks one of these; no other module compares platform strings.
# ---------------------------------------------------------------------------

# Backends whose XLA compiles float64 and complex arithmetic natively,
# including f64 LU (getrf: LAPACK / cuSOLVER) and Householder QR
# (geqrf).  A device outside this set is treated as one that has
# neither: complex runs planar, f64 matmuls take the Ozaki bf16-slice
# scheme and the direct solver factors in f32 and refines.
_NATIVE_F64_PLATFORMS = ("cpu", "gpu")


def has_native_f64():
    """True when the backend runs float64 (and its full exponent range)
    natively."""
    return default_platform() in _NATIVE_F64_PLATFORMS


def has_native_complex():
    """True when the backend compiles complex dtypes; otherwise complex
    ops run as four real products (planar decomposition)."""
    return default_platform() in _NATIVE_F64_PLATFORMS


def has_f64_lu():
    """True when the backend has an f64 LU factorization; otherwise the
    direct solver factors in f32 and refines in f64."""
    return has_native_f64()


def has_f64_qr():
    """True when the backend has an f64 Householder QR; otherwise f64
    least squares always takes the CGLS device loop."""
    return has_native_f64()


# SpMM route crossovers, by platform (see ``ops.host._prefer_ell`` and
# ``ops._xla._prefer_densify``).  ``densify_above``: densify the sparse
# operand and run one dense product above this nnz density.
# ``ell_below``: take the padded-row (ELL) gather kernel at or below this
# density (0 disables it); it is asked first.
#
# CPU: XLA:CPU scatters are cheap and dense flops are not, so only very
# dense operands densify and ELL stays off.
#
# GPU: measured on an NVIDIA H100 80GB HBM3 (700 W power limit), CSR
# 10k x 10k times a dense 10k x 128 panel, device time per call in ms
# (ELL / densify / COO scatter), f64 then f32:
#   density 0.1%:  0.42 / 1.87 / 0.46     0.31 / 1.01 / 0.26
#   density 1%:    0.90 / 2.10 / 4.68     0.73 / 1.16 / 2.33
#   density 5%:    3.03 / 2.22 / 20.5     1.81 / 1.20 / 5.24
#   density 21%:   28.3 / 2.61 / 207      13.9 / 1.38 / 31.1
# and the reference demo's 500 x 5000 operand at 21.2%: 0.83 / 0.32 / 3.90
# (f64), 0.53 / 0.46 / 0.79 (f32).  ELL beats densify below ~2-3%;
# without ELL, densify beats the scatter above ~0.5%.
_SPMM_CROSSOVERS = {
    "cpu": {"densify_above": 0.25, "ell_below": 0.0},
    "gpu": {"densify_above": 0.005, "ell_below": 0.02},
}


def spmm_crossovers():
    """The active backend's SpMM route crossovers.  A backend without
    measured crossovers is an error, not a default."""
    try:
        return _SPMM_CROSSOVERS[default_platform()]
    except KeyError:
        raise NotImplementedError(
            f"no measured SpMM route crossovers for platform "
            f"{default_platform()!r}"
        ) from None


# ---------------------------------------------------------------------------
# Service functions (MKL service-family analogs)
# ---------------------------------------------------------------------------


def get_version():
    """Return a dict describing the backend, analogous to ``MKLVersion``
    (``_mkl_interface/_structs.py:66-76``)."""
    return {
        "framework_version": __version__,
        "jax_version": jax.__version__,
        "platform": default_platform(),
        "device_kind": jax.devices()[0].device_kind if jax.devices() else "none",
        "num_devices": jax.device_count(),
    }


def get_version_string():
    """Analog of ``mkl_get_version_string``
    (``_mkl_interface/_cfunctions.py:753-768``)."""
    v = get_version()
    return (
        f"sparse_dot_tpu {v['framework_version']} on JAX {v['jax_version']} "
        f"[{v['platform']}: {v['device_kind']} x{v['num_devices']}]"
    )


_num_threads_hint = [None]


def get_max_threads():
    """Analog of ``mkl_get_max_threads`` (``_cfunctions.py:738``): the
    parallel width of the backend.  Returns the explicit hint if one was
    set (so set/get round-trip like MKL's); otherwise the local device
    count on accelerators or the host CPU count on CPU."""
    if _num_threads_hint[0] is not None:
        return _num_threads_hint[0]
    platform = default_platform()
    if platform == "cpu":
        return os.cpu_count() or 1
    return jax.local_device_count()


def get_device_count():
    return jax.device_count()


def set_num_threads(n):
    """Accepted for API compatibility with ``mkl_set_num_threads``
    (``_cfunctions.py:742-747``).  XLA owns its own scheduling, so this
    records a hint rather than reconfiguring a thread pool."""
    if n < 1:
        raise ValueError("Number of threads must be a positive integer")
    _num_threads_hint[0] = int(n)


def set_num_threads_local(n):
    """Analog of ``mkl_set_num_threads_local`` (``_cfunctions.py:745``):
    returns the previous setting; 0 resets to the global default."""
    previous = _num_threads_hint[0] or 0
    if n == 0:
        _num_threads_hint[0] = None
        return previous
    set_num_threads(n)
    return previous


def free_buffers():
    """Analog of ``mkl_free_buffers`` (``_cfunctions.py:747``): release
    cached backend memory where possible."""
    jax.clear_caches()

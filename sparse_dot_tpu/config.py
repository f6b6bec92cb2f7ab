"""Global configuration for the sparse framework.

This module plays the role the reference's import-time interface selection
plays (``/root/reference/sparse_dot_mkl/_mkl_interface/__init__.py:108-163``):
it decides the index integer width ("LP64" int32 vs "ILP64" int64 analog),
holds the debug flag (``_common.py:97-105``), and exposes env-var driven
knobs.  Unlike the reference there is no shared library to locate — the
"backend" is JAX/XLA and is imported lazily.

Environment variables
---------------------
SPARSE_DOT_INTERFACE : "LP64" (default, int32 indices) or "ILP64" (int64).
    Analog of the reference's ``MKL_INTERFACE_LAYER``.
SPARSE_DOT_DEBUG : truthy to enable debug printing at import.
"""

import os

import numpy as np

__version__ = "0.5.0"

# ---------------------------------------------------------------------------
# Index width policy (the LP64 / ILP64 analog)
# ---------------------------------------------------------------------------

_VALID_INTERFACES = ("LP64", "ILP64")


def _interface_from_env():
    val = os.environ.get("SPARSE_DOT_INTERFACE", "LP64").upper()
    if val not in _VALID_INTERFACES:
        raise ValueError(
            f"SPARSE_DOT_INTERFACE must be one of {_VALID_INTERFACES}; "
            f"got {val!r}"
        )
    return val


class _Config:
    """Singleton-ish config state."""

    def __init__(self):
        self.interface = _interface_from_env()
        self.debug = bool(os.environ.get("SPARSE_DOT_DEBUG", ""))
        # When True, complex inputs are decomposed into planar real/imag
        # compute even on backends with native complex support (test hook).
        self.force_planar_complex = False
        # Density threshold above which sparse x dense multiplies densify the
        # sparse operand and run one dense product instead of
        # gather/scatter.
        self.densify_threshold = 0.05
        # Max number of gathered elements materialized at once by the
        # chunked scatter-add SpMM path (controls memory high-water mark).
        self.spmm_chunk_elements = 1 << 24
        # Cache host->device transfers keyed by object identity +
        # content fingerprint (see formats.py).
        self.device_transfer_cache = True
        # Scatter-free padded row-block (ELL) SpMM: gather B rows per
        # 16-row CSR block and contract with a segment-indicator
        # matmul.  Taken below the backend's measured density
        # crossover (``backend.spmm_crossovers``); disable to force the
        # densify/scatter paths.
        self.ell_spmm_enabled = True
        # Row-BINNED ELL layout (power-of-two width bins with per-bin
        # segments) under the ELL SpMM path and the solver matvec
        # loops (CG/CGLS/FGMRES/cg_mrhs).  False pins the single-width
        # ELL repack / COO solver loops — the kill-switch those
        # callers read via ``getattr(config, "ell_binned", True)``.
        self.ell_binned = True
        # Inspector-executor plane cache: containers cache their dense
        # numeric planes + bf16 structural indicator per data buffer so
        # steady-state SpGEMM skips the densify scatters.  The byte
        # budget bounds the per-container dense footprint; above it the
        # scatter-per-call path runs as before.
        self.spgemm_plane_cache = True
        self.spgemm_plane_cache_bytes = 1 << 28
        # Deepest inspector layer: cached pre-extracted Ozaki bf16
        # slices (D x dense-size x 2 bytes) so steady-state f64
        # products skip slice extraction too.
        self.ozaki_slice_cache_bytes = 1 << 28
        # Expansion budget (scalar products per row block) of the ESC
        # sparse-output SpGEMM — bounds its device memory high-water
        # mark (~40 bytes/slot transient).
        self.spgemm_esc_block_elements = 1 << 22
        # Route every sparse-output SpGEMM through the any-size ESC
        # driver (test hook).  Since round 3 every DEFAULT path is
        # already structurally exact (the fused bf16 pattern matmul
        # keeps cancelled entries as explicit zeros, like MKL/scipy),
        # and the ESC driver itself adaptively routes dense-fitting
        # workloads back to the shared ladder — so to pin the actual
        # expand-sort-compress KERNEL, set spgemm_esc_force_sort too.
        self.spgemm_exact_pattern = False
        # Pin the expand-sort-compress kernel inside the any-size
        # sparse-output driver (tests / benchmarking the truly-sparse
        # regime).  Default False: the driver routes to the dense
        # row-blocked body whenever densified B fits the device budget,
        # which is algorithmically far faster on dense-ish operands.
        self.spgemm_esc_force_sort = False
        # ESC sort-payload strategy: "auto" co-sorts narrow payloads
        # and switches to (key, iota) sort + permutation gathers for
        # wide ones (f64 / planar complex); True/False pin it.
        self.spgemm_esc_perm_sort = "auto"
        # Windowed-gather ESC expansion (packed f32 rows, two gathers
        # instead of seven).  False pins the
        # scalar-gather kernel (tests; also auto-selected for widths
        # beyond f32's exact-integer range).  NOTE: the packed kernel
        # transports f64 values as hi/lo f32 pairs; each PRODUCT
        # re-rounds at ~2^-48 relative (~4 low mantissa bits) versus
        # the exact-f64 scalar-gather kernel.  That is far inside the
        # library's decimal=6 contract; set False for bit-exact f64
        # sparse-sparse products.
        self.spgemm_esc_packed = True
        # Sort-free steady-state ESC: cache the sorted-order
        # permutation + head-compaction gather per output pattern so
        # repeats skip the block sort entirely (value movement only).
        # Same hi|lo product transport (and so the same ~2^-48
        # re-rounding contract) as the packed kernel; the driver
        # additionally range-gates PRODUCTS, not just operands.  False
        # pins every call to the sorting kernels.
        self.spgemm_esc_sort_free = True
        # Device-byte budget for the cached sort-free structures
        # (sidx + head_src per block).
        self.spgemm_esc_struct_cache_bytes = 1 << 28
        # Ozaki-scheme f64 matmul (exact bf16 slice products in place
        # of an emulated f64 product): "auto" enables it for large
        # matmuls on a backend without native f64 (never on CPU or
        # GPU), "1"/"always" forces it everywhere (tests), "0"/"never"
        # disables.
        self.ozaki = os.environ.get("SPARSE_DOT_OZAKI", "auto")
        # PARDISO dense-LU backing-store budget: systems whose dense
        # factorization would exceed this fall back to a matrix-free
        # Krylov solve (CG / FGMRES) with a RuntimeWarning.
        self.pardiso_dense_budget_bytes = 2 << 30

    @property
    def index_dtype(self):
        """NumPy dtype used for sparse index arrays (int32 or int64)."""
        return np.int64 if self.interface == "ILP64" else np.int32

    def set_interface(self, interface):
        interface = interface.upper()
        if interface not in _VALID_INTERFACES:
            raise ValueError(
                f"interface must be one of {_VALID_INTERFACES}; "
                f"got {interface!r}"
            )
        self.interface = interface


config = _Config()


def interface_integer_dtype():
    """Return the active index integer dtype (int32 for LP64, int64 for
    ILP64).  Analog of the reference's
    ``mkl_interface_integer_dtype`` (``_mkl_interface/__init__.py:58``)."""
    return config.index_dtype


def set_interface_layer(interface):
    """Select LP64 (int32) or ILP64 (int64) index width.

    Analog of ``MKL_Set_Interface_Layer``
    (``_mkl_interface/_cfunctions.py:774-782``).  Unlike MKL this can be
    changed at any time; device containers remember the width they were
    built with.
    """
    config.set_interface(interface)
    return config.interface


ILP64_HINT = (
    "Try changing the index interface to int64 with the environment "
    "variable SPARSE_DOT_INTERFACE=ILP64"
)

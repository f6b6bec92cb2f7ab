"""sparse_dot_tpu — a JAX/XLA sparse linear-algebra framework.

A from-scratch re-implementation of the capabilities of
``sparse_dot_mkl`` (flatironinstitute/sparse_dot, reference mounted at
``/root/reference``) on JAX/XLA: the polymorphic ``dot_product``
(SpGEMM / SpMM / SpMV / GEMM over scipy CSR/CSC/BSR and numpy dense in
float32/float64/complex64/complex128), ``gram_matrix`` (syrk),
``sparse_qr_solve``, a PARDISO-style direct solver, and CG/FGMRES
iterative solvers — plus device-resident containers, pure-jit ops, and
mesh-sharded multi-chip execution the reference never had.

Drop-in aliases with the reference's ``*_mkl`` names are exported so
reference users can switch imports without code changes.
"""

from .config import (
    __version__,
    interface_integer_dtype,
    set_interface_layer,
)
from . import backend
from .backend import (
    get_version,
    get_version_string,
    get_max_threads,
    get_device_count,
    set_num_threads,
    set_num_threads_local,
    free_buffers,
)
from .utils.debug import set_debug_mode, debug_print, debug_timer
from .formats import (
    CSR,
    CSC,
    BSR,
    is_csr,
    is_csc,
    is_bsr,
    issparse,
    to_device,
)
from .dispatch import dot_product, gram_matrix, sparse_qr_solve
from .ops.sypr import sypr
from .solvers import (
    cg,
    cg_mrhs,
    fgmres,
    pardiso,
    pardisoinit,
    CGIterativeSparseSolver,
    FGMRESIterativeSparseSolver,
    ConvergenceWarning,
)

# ---------------------------------------------------------------------------
# Drop-in compatibility aliases (the reference's public names,
# /root/reference/sparse_dot_mkl/__init__.py:4-29)
# ---------------------------------------------------------------------------

dot_product_mkl = dot_product
gram_matrix_mkl = gram_matrix
dot_product_transpose_mkl = gram_matrix
sparse_qr_solve_mkl = sparse_qr_solve


def mkl_get_version():
    """7-tuple version info shaped like the reference's
    ``mkl_get_version`` (major, minor, update, product status, build,
    processor, platform)."""
    import jax

    parts = (jax.__version__.split(".") + ["0", "0"])[:3]
    v = get_version()
    return (
        int(parts[0]),
        int(parts[1]),
        int("".join(c for c in parts[2] if c.isdigit()) or 0),
        "sparse_dot_tpu",
        v["framework_version"],
        v["device_kind"],
        v["platform"],
    )


def mkl_set_interface_layer(layer_code):
    """Accepts the reference's interface-layer codes (ints) or the
    LP64/ILP64 strings; raises ValueError otherwise."""
    if isinstance(layer_code, int):
        # MKL codes: 0/2 -> LP64 variants, 1/3 -> ILP64 variants.
        return set_interface_layer("ILP64" if layer_code % 2 else "LP64")
    return set_interface_layer(layer_code)


mkl_get_version_string = get_version_string
mkl_get_max_threads = get_max_threads
mkl_set_num_threads = set_num_threads
mkl_set_num_threads_local = set_num_threads_local
mkl_interface_integer_dtype = interface_integer_dtype
mkl_free_buffers = free_buffers

get_version_string = get_version_string  # canonical name

__all__ = [
    "__version__",
    # canonical API
    "dot_product",
    "gram_matrix",
    "sypr",
    "sparse_qr_solve",
    "cg",
    "cg_mrhs",
    "fgmres",
    "pardiso",
    "pardisoinit",
    "CGIterativeSparseSolver",
    "FGMRESIterativeSparseSolver",
    "ConvergenceWarning",
    "set_debug_mode",
    "set_interface_layer",
    "interface_integer_dtype",
    "get_version",
    "get_version_string",
    "get_max_threads",
    "get_device_count",
    "set_num_threads",
    "set_num_threads_local",
    "free_buffers",
    # containers
    "CSR",
    "CSC",
    "BSR",
    "is_csr",
    "is_csc",
    "is_bsr",
    "issparse",
    "to_device",
    # reference-compatible aliases
    "dot_product_mkl",
    "gram_matrix_mkl",
    "dot_product_transpose_mkl",
    "sparse_qr_solve_mkl",
    "mkl_get_version",
    "mkl_get_version_string",
    "mkl_get_max_threads",
    "mkl_set_num_threads",
    "mkl_set_num_threads_local",
    "mkl_set_interface_layer",
    "mkl_interface_integer_dtype",
    "mkl_free_buffers",
]

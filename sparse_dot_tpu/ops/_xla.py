"""Pure-device sparse kernels in XLA (jit-compatible, all real dtypes the
backend supports, plus native complex on CPU/GPU backends).

These are the JAX/XLA replacements for the MKL symbol families bound in
``/root/reference/sparse_dot_mkl/_mkl_interface/_cfunctions.py``:

* ``mkl_sparse_?_mv``   -> :func:`coo_spmv`            (SpMV)
* ``mkl_sparse_?_mm``   -> :func:`coo_spmm` / :func:`bsr_spmm`  (SpMM)
* ``cblas_?gemm``       -> :func:`gemm`                 (dense GEMM)
* ``mkl_sparse_spmm``/``spmmd`` -> ``ops.host.spgemm_dense`` + host compaction
* ``mkl_sparse_syrk``/``syrkd``/``cblas_?syrk`` -> :func:`syrk_dense`
* ``mkl_sparse_convert_csr`` / ``mkl_sparse_order`` ->
  :func:`coo_to_csr_arrays` / :func:`sort_csr`

Everything here works on plain arrays (not containers) so it can be used
inside ``jit`` / ``shard_map`` without pytree overhead.  The sparse
operand is in expanded-COO form (``rows``, ``cols``, ``vals``) — CSR/CSC
both lower to it via ``formats._expand_indptr`` — except the BSR kernel,
which consumes block arrays directly as one batched matmul.

Design notes:
* Irregular access is expressed as gather + scatter-add; the dense paths
  (BSR, densified SpMM, GEMM) use ``dot_general``.
* A density-adaptive path densifies the sparse operand and runs one
  dense product when the extra FLOPs are cheaper than the gather/scatter
  traffic; the crossover density is measured per backend
  (``backend.spmm_crossovers``).
* Large-nnz gathers are chunked with ``lax.scan`` to bound the memory
  high-water mark.
"""

import functools
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import ozaki as _ozaki

HIGHEST = lax.Precision.HIGHEST


def _prec(dtype, precision):
    """Effective matmul precision: callers pass ``precision=None`` to get
    the per-dtype default — HIGHEST for float32 (3-pass bf16, needed for
    the reference's decimal=5 tolerance: at DEFAULT a GPU may run a
    float32 product in TF32, ~1e-3 relative), plain default for float64
    (exact at any setting) and everything else."""
    if precision is not None:
        return precision
    if jnp.dtype(dtype) == jnp.float32:
        return HIGHEST
    return None


# ---------------------------------------------------------------------------
# Dense GEMM / SYRK
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("precision", "use_ozaki"))
def _gemm_jit(a, b, alpha=1.0, beta=0.0, c0=None, precision=None,
              use_ozaki=False):
    if use_ozaki:
        out = _ozaki.matmul_f64(a, b)
    else:
        out = jnp.dot(a, b, precision=_prec(a.dtype, precision))
    out = out * jnp.asarray(alpha, out.dtype)
    if c0 is not None:
        out = out + jnp.asarray(beta, out.dtype) * c0
    return out


def gemm(a, b, alpha=1.0, beta=0.0, c0=None, precision=None,
         allow_hilo=True):
    """alpha * (a @ b) + beta * c0 (cblas_?gemm analog).  f64 takes the
    Ozaki bf16-slice matmul where ``ozaki.enabled`` says so.
    ``allow_hilo=False`` (callers pass a host range check of the
    operands) pins the exact f64 lowering — the Ozaki split assumes the
    f32 exponent window (review r5 finding: dense paths must gate like
    every sparse hi|lo transport)."""
    m, k = a.shape[0], a.shape[1]
    n = b.shape[1] if b.ndim > 1 else 1
    return _gemm_jit(
        a, b, alpha=alpha, beta=beta, c0=c0, precision=precision,
        use_ozaki=allow_hilo and _ozaki.enabled(a.dtype, k, m * k * n),
    )


@partial(jax.jit, static_argnames=("aat", "conj", "precision", "use_ozaki"))
def _syrk_dense_jit(a, aat=False, conj=False, alpha=1.0, beta=0.0, c0=None,
                    precision=None, use_ozaki=False):
    at = jnp.conj(a.T) if conj else a.T
    precision = _prec(a.dtype, precision)
    if use_ozaki and not conj:
        full = _ozaki.syrk_f64(a, contract=1 if aat else 0)
    elif aat:
        full = jnp.dot(a, at, precision=precision)
    else:
        full = jnp.dot(at, a, precision=precision)
    full = full * jnp.asarray(alpha, full.dtype)
    upper = jnp.triu(full)
    if c0 is not None:
        return upper + jnp.asarray(beta, full.dtype) * c0
    return upper


def syrk_dense(a, aat=False, conj=False, alpha=1.0, beta=0.0, c0=None,
               precision=None, allow_hilo=True):
    """Upper-triangular gram matrix: triu(alpha * op(a) + beta * c0) with
    op(a) = a @ a^H (aat=True) or a^H @ a.  The strict lower triangle is
    beta * c0 (untouched input), matching cblas_?syrk semantics.  f64
    takes the Ozaki bf16-slice matmul where ``ozaki.enabled`` says so
    unless
    ``allow_hilo=False`` (host range gate — see :func:`gemm`)."""
    m = a.shape[0] if aat else a.shape[1]
    k = a.shape[1] if aat else a.shape[0]
    return _syrk_dense_jit(
        a, aat=aat, conj=conj, alpha=alpha, beta=beta, c0=c0,
        precision=precision,
        use_ozaki=(
            allow_hilo and not conj and _ozaki.enabled(a.dtype, k, m * k * m)
        ),
    )


# ---------------------------------------------------------------------------
# COO-expanded SpMV / SpMM
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("m",))
def coo_spmv(rows, cols, vals, x, m, alpha=1.0, beta=0.0, y0=None):
    """y = alpha * A @ x (+ beta * y0); A given as expanded COO."""
    prods = vals * x[cols]
    y = jnp.zeros((m,), dtype=prods.dtype).at[rows].add(prods, mode="drop")
    y = y * jnp.asarray(alpha, y.dtype)
    if y0 is not None:
        y = y + jnp.asarray(beta, y.dtype) * y0
    return y


def _spmm_scatter_oneshot(rows, cols, vals, b, m):
    gathered = vals[:, None] * b[cols, :]
    return jnp.zeros((m, b.shape[1]), dtype=gathered.dtype).at[rows].add(
        gathered, mode="drop"
    )


@partial(jax.jit, static_argnames=("m", "nchunks"))
def _spmm_scatter_chunked(rows, cols, vals, b, m, nchunks):
    """Scan over nnz chunks to bound memory: each step gathers a chunk of
    B rows, scales, and scatter-adds into the dense accumulator.
    Jitted wrapper of :func:`_chunked_body` (one shared body — keeping
    two copies in sync by hand is how chunking bugs are born)."""
    return _chunked_body(rows, cols, vals, b, m, nchunks)


def _pad_coo_chunks(rows, cols, vals, m, nnz, n, chunk_elements):
    """(rows, cols, vals, nchunks) padded so nnz divides the chunk
    count; padded entries scatter to row m, which ``mode="drop"``
    discards.  Shared by every chunked-scatter entry point."""
    nchunks = max(1, (nnz * n) // chunk_elements)
    chunk = -(-nnz // nchunks)
    pad = nchunks * chunk - nnz
    if pad:
        rows = jnp.concatenate([rows, jnp.full((pad,), m, rows.dtype)])
        cols = jnp.concatenate([cols, jnp.zeros((pad,), cols.dtype)])
        vals = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])
    return rows, cols, vals, nchunks


def coo_spmm_raw(rows, cols, vals, b, m, chunk_elements=1 << 24):
    """A @ b with A as expanded COO; picks one-shot vs chunked scatter.

    Not jitted at this level (the branches are); callers inside jit should
    use the underlying jitted functions directly.
    """
    nnz = int(rows.shape[0])
    n = int(b.shape[1])
    if nnz == 0:
        return jnp.zeros((m, n), dtype=jnp.result_type(vals.dtype, b.dtype))
    if nnz * n <= chunk_elements:
        return jax.jit(_spmm_scatter_oneshot, static_argnames=("m",))(
            rows, cols, vals, b, m=m
        )
    rows, cols, vals, nchunks = _pad_coo_chunks(
        rows, cols, vals, m, nnz, n, chunk_elements
    )
    return _spmm_scatter_chunked(rows, cols, vals, b, m=m, nchunks=nchunks)


@partial(jax.jit, static_argnames=("shape",))
def densify(rows, cols, vals, shape):
    """Expanded COO -> dense (duplicates sum, like scipy)."""
    return jnp.zeros(shape, dtype=vals.dtype).at[rows, cols].add(
        vals, mode="drop"
    )


# ---------------------------------------------------------------------------
# Sorted-unique scatter machinery (the densify fast path)
#
# For *set* scatters (densify, compaction) we split each f64 value
# arithmetically into hi/lo float32 halves — exact to ~2^-49 relative,
# orders of magnitude inside the library's float64 contract — scatter
# both at f32 speed with sorted/unique index hints, and recombine.
# ---------------------------------------------------------------------------


def _sorted_set_scatter_one(dest, vals, size):
    return jnp.zeros((size,), vals.dtype).at[dest].set(
        vals, mode="drop", unique_indices=True, indices_are_sorted=True
    )


def sorted_set_scatter(dest, vals, size):
    """out[dest] = vals with sorted, unique ``dest``; out-of-range
    destinations dropped.

    f64 uses the hi/lo split — WHEN the values allow it.  The split is
    exact to ~2^-49 only inside f32's range: |x| > ~3.4e38 saturates
    to inf (then inf + -inf = NaN on recombine) and |x| below the f32
    subnormal floor flushes to zero.  Those are legal f64 inputs the
    library's MKL-parity contract must handle, so the program checks
    the range ON DEVICE (two cheap reductions) and ``lax.cond``s to a
    plain f64 scatter (correctness first) when
    the fast form would corrupt.  NaN/inf inputs also take the exact
    branch, propagating faithfully."""
    if vals.dtype == jnp.float64:
        if vals.size == 0:
            return _sorted_set_scatter_one(dest, vals, size)
        a = jnp.abs(vals)
        mx = jnp.max(a)
        nz_min = jnp.min(jnp.where(a == 0, jnp.inf, a))
        # Floor 4e-31 = min_normal_f32 * 2^25: the LO limb carries
        # ~|v| * 2^-25 and must stay a NORMAL f32 for the split to be
        # exact (matches ops.host._HILO_ABS_MIN).
        ok = (mx <= 3e38) & (nz_min >= 4e-31)  # False for NaN mx

        def fast(v):
            hi, lo = _ozaki.hilo(v)
            hib = _sorted_set_scatter_one(dest, hi, size)
            lob = _sorted_set_scatter_one(dest, lo, size)
            return hib.astype(jnp.float64) + lob.astype(jnp.float64)

        def exact(v):
            return _sorted_set_scatter_one(dest, v, size)

        return lax.cond(ok, fast, exact, vals)
    return _sorted_set_scatter_one(dest, vals, size)


def densify_sorted_hilo(flat, vals, shape):
    """f64 sorted-flat densify, keeping the exact double-f32 (hi, lo)
    pair separate — feeds the Ozaki matmul without ever materializing a
    dense f64 array."""
    m, n = shape
    hi, lo = _ozaki.hilo(vals)
    hib = _sorted_set_scatter_one(flat, hi, m * n).reshape(m, n)
    lob = _sorted_set_scatter_one(flat, lo, m * n).reshape(m, n)
    return hib, lob


@partial(jax.jit, static_argnames=("shape",))
def densify_sorted(flat, vals, shape):
    """Sorted unique flat indices + values -> dense of ``shape``."""
    m, n = shape
    return sorted_set_scatter(flat, vals, m * n).reshape(m, n)


def segment_ids_from_offsets(offsets, size, clip_max):
    """j[t] = i for t in [offsets[i], offsets[i+1)) — the inverse of a
    prefix/indptr array, as a small scatter-add of segment-start marks
    plus one prefix sum (``jnp.searchsorted`` would run one binary
    search per slot).  Out-of-range segment starts
    (empty tail segments pinned at ``size``) drop out; counts per slot
    may exceed 1 (empty segments)."""
    marks = jnp.zeros((size,), jnp.int32).at[offsets[1:]].add(
        1, mode="drop"
    )
    nseg = offsets.shape[0] - 1
    if nseg >= (1 << 24):
        # prefix_sum's f32 chunk arithmetic is exact below 2^24 only.
        ids = jnp.cumsum(marks)
    else:
        ids = prefix_sum(marks)
    return jnp.clip(ids, 0, clip_max)


def prefix_sum(mask):
    """Int32 prefix sum of a boolean mask via 128-wide triangular
    matmuls (XLA's cumsum lowering is log-pass; this is one matmul plus
    a tiny cumsum over chunk sums).  The f32 chunk arithmetic is exact
    below 2^24; larger masks fall back to plain cumsum."""
    n = mask.shape[0]
    if n >= (1 << 24):
        return jnp.cumsum(mask.astype(jnp.int32))
    npad = -(-n // 128) * 128
    x = mask.astype(jnp.float32)
    if npad != n:
        x = jnp.concatenate([x, jnp.zeros((npad - n,), jnp.float32)])
    x = x.reshape(-1, 128)
    tri = jnp.tril(jnp.ones((128, 128), jnp.float32))
    # 0/1 operands are exact at any input precision (TF32 included) and
    # the sums accumulate in f32, so the fastest precision is exact.
    within = lax.dot_general(x, tri, (((1,), (1,)), ((), ())),
                             precision=lax.Precision.DEFAULT)
    sums = within[:, -1]
    offsets = jnp.cumsum(sums) - sums
    return (
        (within + offsets[:, None]).reshape(-1)[:n].astype(jnp.int32)
    )


@partial(
    jax.jit,
    static_argnames=("m", "k", "n", "a_cm", "b_cm", "syrk", "with_count",
                     "precision", "use_ozaki", "triangular"),
)
def spgemm_numeric_sorted(a_flat, a_vals, b_flat, b_vals, m, k, n,
                          a_cm=False, b_cm=False, syrk=False,
                          precision=None, with_count=False,
                          use_ozaki=False, triangular=False):
    """One-dispatch SpGEMM numeric phase over sorted-flat operands.

    ``a_cm``/``b_cm`` say the flat index is column-major (the natural
    sorted order of a CSC operand): the operand is densified
    *transposed* and the contraction dimensions absorb the transpose —
    no data movement.  ``syrk=True`` computes A @ A^T from a single
    densify (the X @ X.T / gram fast path).  ``use_ozaki=True`` (f64)
    runs the matmul as exact bf16 slice products.  ``triangular=True``
    keeps the
    upper triangle (fused into the same program so the gram path pays
    no extra dispatch).
    """
    a_dim = 0 if a_cm else 1
    b_dim = 1 if b_cm else 0
    if use_ozaki:
        a_hi, a_lo = densify_sorted_hilo(
            a_flat, a_vals, (k, m) if a_cm else (m, k)
        )
        if syrk:
            c = _ozaki.syrk_hilo(a_hi, a_lo, contract=a_dim)
        else:
            b_hi, b_lo = densify_sorted_hilo(
                b_flat, b_vals, (n, k) if b_cm else (k, n)
            )
            c = _ozaki.matmul_hilo(
                a_hi, a_lo, b_hi, b_lo,
                a_contract=a_dim, b_contract=b_dim,
            )
    else:
        a_dense = densify_sorted(a_flat, a_vals, (k, m) if a_cm else (m, k))
        if syrk:
            c = lax.dot_general(
                a_dense, a_dense, (((a_dim,), (a_dim,)), ((), ())),
                precision=_prec(a_vals.dtype, precision),
            )
        else:
            b_dense = densify_sorted(
                b_flat, b_vals, (n, k) if b_cm else (k, n)
            )
            c = lax.dot_general(
                a_dense, b_dense, (((a_dim,), (b_dim,)), ((), ())),
                precision=_prec(a_vals.dtype, precision),
            )
    if triangular:
        c = jnp.triu(c)
    if with_count:
        return c, jnp.count_nonzero(c)
    return c


@jax.jit
def axpby(c, alpha=None, beta=None, c0=None):
    """Device-side accumulate epilogue: ``alpha*c + beta*c0``.

    Used by kernels without native alpha/beta plumbing so the
    ``out``/``out_scalar`` contract (C := alpha*A*B + beta*C,
    ``/root/reference/sparse_dot_mkl/_sparse_dense.py:111-123``) is
    applied on device instead of a numpy post-pass with a second
    host<->device round trip."""
    if alpha is not None:
        c = c * jnp.asarray(alpha, c.dtype)
    if c0 is not None:
        c = c + jnp.asarray(beta, c.dtype) * c0
    return c


@partial(jax.jit, static_argnames=("a_cm", "precision"))
def spmm_planes(a_num, b, a_cm=False, precision=None, alpha=None,
                beta=None, c0=None):
    """SpMM from cached dense planes (inspector-executor steady state):
    pure matmul + accumulate epilogue, no densify scatters.  With
    cached Ozaki slices for A (f64), only B's slices are extracted
    per call."""
    a_dim = 0 if a_cm else 1
    if _is_slices(a_num):
        b_sl, b_e = _side_slices(_ozaki.hilo(b), 0)
        c = _ozaki.matmul_from_slices(
            a_num[0], a_num[1], b_sl, b_e, a_contract=a_dim,
            b_contract=0,
        )
    elif len(a_num) == 2:
        b_hi, b_lo = _ozaki.hilo(b)
        c = _ozaki.matmul_hilo(
            a_num[0], a_num[1], b_hi, b_lo, a_contract=a_dim,
            b_contract=0,
        )
    else:
        c = lax.dot_general(
            a_num[0], b, (((a_dim,), (0,)), ((), ())),
            precision=_prec(a_num[0].dtype, precision),
        )
    return axpby(c, alpha, beta, c0)


@partial(jax.jit,
         static_argnames=("m", "k", "a_cm", "precision", "use_ozaki"))
def spmm_densified_sorted(flat, vals, b, m, k, a_cm=False, precision=None,
                          use_ozaki=False, alpha=None, beta=None, c0=None):
    """SpMM fast path: sorted-flat densify (hi/lo split for f64) + dense
    matmul; ``a_cm`` densifies the transpose and contracts dim 0.
    ``use_ozaki`` runs the f64 matmul as exact bf16 slice products."""
    a_dim = 0 if a_cm else 1
    if use_ozaki:
        a_hi, a_lo = densify_sorted_hilo(
            flat, vals, (k, m) if a_cm else (m, k)
        )
        b_hi, b_lo = _ozaki.hilo(b)
        c = _ozaki.matmul_hilo(
            a_hi, a_lo, b_hi, b_lo, a_contract=a_dim, b_contract=0
        )
    else:
        a_dense = densify_sorted(flat, vals, (k, m) if a_cm else (m, k))
        c = lax.dot_general(
            a_dense, b, (((a_dim,), (0,)), ((), ())),
            precision=_prec(vals.dtype, precision),
        )
    return axpby(c, alpha, beta, c0)


@partial(jax.jit, static_argnames=("m", "use_mxu", "nchunks", "precision",
                                   "use_ozaki"))
def _spmm_fused(rows, cols, vals, b, m, use_mxu, nchunks=1,
                precision=None, alpha=None, beta=None, c0=None,
                use_ozaki=False):
    """One-dispatch SpMM: path + alpha/beta accumulate fused into a
    single XLA program."""
    if use_mxu:
        a_dense = jnp.zeros((m, b.shape[0]), dtype=vals.dtype).at[
            rows, cols
        ].add(vals, mode="drop")
        if use_ozaki:
            ah, al = _ozaki.hilo(a_dense)
            bh, bl = _ozaki.hilo(b)
            c = _ozaki.matmul_hilo(ah, al, bh, bl)
        else:
            c = jnp.dot(a_dense, b, precision=_prec(vals.dtype, precision))
    elif nchunks <= 1:
        c = _spmm_scatter_oneshot(rows, cols, vals, b, m)
    else:
        c = _chunked_body(rows, cols, vals, b, m, nchunks)
    if alpha is not None:
        c = c * jnp.asarray(alpha, c.dtype)
    if c0 is not None:
        c = c + jnp.asarray(beta, c.dtype) * c0
    return c


def _chunked_body(rows, cols, vals, b, m, nchunks):
    n = b.shape[1]
    chunk = rows.shape[0] // nchunks
    rows_c = rows.reshape(nchunks, chunk)
    cols_c = cols.reshape(nchunks, chunk)
    vals_c = vals.reshape(nchunks, chunk)

    def step(c, args):
        r, k, v = args
        g = v[:, None] * b[k, :]
        return c.at[r].add(g, mode="drop"), None

    c0 = jnp.zeros((m, n), dtype=vals.dtype)
    c, _ = lax.scan(step, c0, (rows_c, cols_c, vals_c))
    return c


def coo_spmm(rows, cols, vals, b, m, k, alpha=1.0, beta=0.0, c0=None,
             densify_ok=True, density=None, chunk_elements=1 << 24,
             precision=None):
    """Full SpMM with alpha/beta accumulate and adaptive path selection,
    compiled as one XLA program."""
    nnz = int(vals.shape[-1])
    n = int(b.shape[1])

    if nnz == 0:
        c = jnp.zeros((m, n), dtype=jnp.result_type(vals.dtype, b.dtype))
        if c0 is not None:
            c = c + jnp.asarray(beta, c.dtype) * c0
        return c

    use_mxu = (
        densify_ok
        and not jnp.iscomplexobj(vals)
        and _prefer_densify(m, k, n, nnz, vals.dtype)
    )
    nchunks = 1
    if not use_mxu and nnz * n > chunk_elements:
        rows, cols, vals, nchunks = _pad_coo_chunks(
            rows, cols, vals, m, nnz, n, chunk_elements
        )

    trivial_alpha = isinstance(alpha, (int, float)) and alpha == 1.0
    return _spmm_fused(
        rows, cols, vals, b, m=m, use_mxu=use_mxu, nchunks=nchunks,
        precision=precision,
        alpha=None if trivial_alpha else alpha,
        beta=beta if c0 is not None else None,
        c0=c0,
        use_ozaki=use_mxu and _ozaki.enabled(vals.dtype, k, m * k * n),
    )


def _prefer_densify(m, k, n, nnz, dtype):
    """Densify-vs-scatter SpMM crossover: densify the sparse operand and
    run one dense product when its density is above the backend's
    measured crossover (``backend.spmm_crossovers``) and the dense
    operand fits comfortably in device memory."""
    from ..backend import spmm_crossovers

    if m * k * jnp.dtype(dtype).itemsize > 4e9:
        return False
    return nnz / max(m * k, 1) > spmm_crossovers()["densify_above"]


# ---------------------------------------------------------------------------
# ELL row-padded SpMM (scatter-free gather + multiply-reduce path)
#
# Pad CSR rows (or power-of-two row bins) to their max nnz (ELL/SELL
# layout, one-time, cached on the container), GATHER the needed B rows
# and reduce over the padded axis: no scatter at all.  This is the
# analog of ``mkl_sparse_?_mm``'s inspector-executor model (the padded
# layout is the "optimized handle").  f64 stays exact (elementwise
# products).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("m", "rmax"))
def ell_repack(rows, cols, vals, indptr, m, rmax):
    """One-time CSR -> per-row padded (ELL) layout.

    Returns (cols_ell, vals_ell), each (m, rmax); padded slots have
    col 0 and value 0 (a zero value kills the contribution, so the
    column sentinel is harmless).
    """
    nnz = rows.shape[0]
    slot = (
        jnp.arange(nnz, dtype=jnp.int32)
        - indptr[rows].astype(jnp.int32)
    )
    # Flat 1-D destinations are sorted (rows ascending, slots ascending
    # within a row), so the scatter can take the sorted/unique hints.
    dest = rows.astype(jnp.int32) * rmax + slot
    size = m * rmax
    cols_ell = (
        jnp.zeros((size,), jnp.int32).at[dest].set(
            cols.astype(jnp.int32), mode="drop", unique_indices=True,
            indices_are_sorted=True,
        ).reshape(m, rmax)
    )
    if vals.dtype == jnp.float64:
        vals_flat = sorted_set_scatter(dest, vals, size)
    else:
        vals_flat = _sorted_set_scatter_one(dest, vals, size)
    return cols_ell, vals_flat.reshape(m, rmax)


@jax.jit
def ell_row_max(indptr):
    """Max nnz over rows (host reads the scalar once; cached)."""
    return jnp.max(indptr[1:] - indptr[:-1])


@partial(jax.jit, static_argnames=("flat_size", "m_pad"))
def ell_binned_repack(indptr, cols, vals, perm_pad, row_off, nnz_sorted,
                      flat_size, m_pad):
    """One-time CSR -> row-binned padded flat layout, gather-formulated.

    For flat slot s: p = its sorted-row id (inverse of the ``row_off``
    prefix via marks+prefix-sum), q = s - row_off[p] the slot within
    the row, source t = indptr[perm_pad[p]] + q, valid while
    q < nnz_sorted[p].  Gathers instead of the scatter formulation —
    the permuted destinations would make an unsorted scatter.
    """
    p = segment_ids_from_offsets(row_off, flat_size, m_pad - 1)
    q = jnp.arange(flat_size, dtype=jnp.int32) - row_off[p]
    orig = perm_pad[p]
    valid = q < nnz_sorted[p]
    t = jnp.clip(
        indptr[orig].astype(jnp.int32) + q, 0, cols.shape[0] - 1
    )
    cols_flat = jnp.where(valid, cols[t].astype(jnp.int32), 0)
    vals_flat = jnp.where(valid, vals[t], jnp.zeros((), vals.dtype))
    return cols_flat, vals_flat


def _seg_chunk_rows(rows, rmax, n, itemsize, budget=1 << 31):
    """Rows per lax.map step keeping the gathered (rows, rmax, n)
    intermediate under ~2 GB; multiples of 256."""
    per_row = max(rmax, 1) * max(n, 1) * itemsize
    chunk = max(budget // per_row, 256)
    chunk = (chunk // 256) * 256
    return min(chunk, rows)


@partial(jax.jit, static_argnames=("segs", "split_b"))
def ell_spmm_binned(cols_flat, vals_flat, b, invpos, segs,
                    split_b=False, alpha=None, beta=None, c0=None):
    """C = A @ b over the row-binned padded layout (one program).

    ``segs`` is the static ((rmax, rows), ...) structure from
    :meth:`formats.CSR.ell_parts_binned`; rows are processed in sorted
    order and the output un-permutes with one row gather.  For f64 b,
    ``split_b=True`` gathers ONE concatenated (k, 2n) f32 plane
    holding hi|lo halves per row (half the gather ops of two separate
    f32 plane gathers for the same bytes) and recombines
    to f64 before the exact f64 multiply-reduce (split exact to ~2^-49
    relative, same as every hi/lo path here).
    """
    n = b.shape[1]
    if split_b:
        b_hi, b_lo = _ozaki.hilo(b)
        b_cat = jnp.concatenate([b_hi, b_lo], axis=1)  # (k, 2n) f32

    outs = []
    off = 0
    for rmax, rows in segs:
        if rmax == 0:
            outs.append(jnp.zeros((rows, n), vals_flat.dtype))
            continue
        cnt = rows * rmax
        cp = lax.slice(cols_flat, (off,), (off + cnt,)).reshape(
            rows, rmax
        )
        vp = lax.slice(vals_flat, (off,), (off + cnt,)).reshape(
            rows, rmax
        )
        off += cnt

        def one(args):
            cpc, vpc = args
            mc = cpc.shape[0]
            if split_b:
                # Reshape the gathered (cnt, 2n) plane to 3-D FIRST and
                # slice hi|lo on the LAST axis; recombining on the flat
                # 2-D array and reshaping after defeats XLA's loop
                # fusion and round-trips the intermediate through
                # device memory.
                g = b_cat[cpc.reshape(-1)].reshape(mc, rmax, 2 * n)
                bg = (
                    g[:, :, :n].astype(jnp.float64)
                    + g[:, :, n:].astype(jnp.float64)
                )
            else:
                bg = b[cpc.reshape(-1)].reshape(mc, rmax, n)
            return jnp.sum(vpc[:, :, None] * bg, axis=1)

        itemsize = jnp.dtype(vals_flat.dtype).itemsize
        chunk = _seg_chunk_rows(rows, rmax, n, itemsize)
        if chunk >= rows:
            outs.append(one((cp, vp)))
        else:
            nchunks = -(-rows // chunk)
            pad_rows = nchunks * chunk - rows
            if pad_rows:
                cp = jnp.concatenate(
                    [cp, jnp.zeros((pad_rows, rmax), cp.dtype)]
                )
                vp = jnp.concatenate(
                    [vp, jnp.zeros((pad_rows, rmax), vp.dtype)]
                )
            c = lax.map(
                one,
                (cp.reshape(nchunks, chunk, rmax),
                 vp.reshape(nchunks, chunk, rmax)),
            ).reshape(-1, n)
            outs.append(c[:rows])

    c_sorted = jnp.concatenate(outs) if len(outs) > 1 else outs[0]
    c = c_sorted[invpos]
    if alpha is not None:
        c = c * jnp.asarray(alpha, c.dtype)
    if c0 is not None:
        c = c + jnp.asarray(beta, c.dtype) * c0
    return c


@partial(jax.jit, static_argnames=("nchunks", "precision"))
def ell_spmm(cols_ell, vals_ell, b, nchunks=1, precision=None,
             alpha=None, beta=None, c0=None):
    """C = A @ b with A in per-row padded (ELL) layout; one program.

    Per row: gather the B rows its nonzeros address and reduce over
    the padded-nnz axis — pure gather + multiply-reduce, no scatter and
    no matmul, and f64 stays exact.  ``nchunks`` bounds the
    gathered-intermediate memory by scanning over row blocks.
    """
    m, rmax = cols_ell.shape
    n = b.shape[1]

    def one(cp, vp):
        mc = cp.shape[0]
        # 1-D row gather
        bg = b[cp.reshape(-1)].reshape(mc, rmax, n)
        return jnp.sum(vp[:, :, None] * bg, axis=1)

    if nchunks <= 1:
        c = one(cols_ell, vals_ell)
    else:
        mc = m // nchunks  # caller pads m to a multiple
        cs = cols_ell.reshape(nchunks, mc, rmax)
        vs = vals_ell.reshape(nchunks, mc, rmax)
        c = lax.map(lambda ab: one(*ab), (cs, vs)).reshape(m, n)

    if alpha is not None:
        c = c * jnp.asarray(alpha, c.dtype)
    if c0 is not None:
        c = c + jnp.asarray(beta, c.dtype) * c0
    return c


@partial(jax.jit, static_argnames=("nchunks",))
def ell_spmv(cols_ell, vals_ell, x, nchunks=1, alpha=None, beta=None,
             y0=None):
    """y = A @ x in ELL layout: gather + row reduction (no scatter)."""
    m, rmax = cols_ell.shape

    def one(cp, vp):
        mc = cp.shape[0]
        return jnp.sum(vp * x[cp.reshape(-1)].reshape(mc, rmax), axis=1)

    if nchunks <= 1:
        y = one(cols_ell, vals_ell)
    else:
        mc = m // nchunks
        cs = cols_ell.reshape(nchunks, mc, rmax)
        vs = vals_ell.reshape(nchunks, mc, rmax)
        y = lax.map(lambda ab: one(*ab), (cs, vs)).reshape(m)

    if alpha is not None:
        y = y * jnp.asarray(alpha, y.dtype)
    if y0 is not None:
        y = y + jnp.asarray(beta, y.dtype) * y0
    return y


# ---------------------------------------------------------------------------
# BSR SpMM (batched-matmul path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("m", "precision"))
def bsr_spmm(block_data, block_rows, block_cols, b, m, precision=None,
             alpha=None, beta=None, c0=None):
    """C = A @ b for BSR A.

    block_data : (nb, R, C); block_rows/block_cols: (nb,) block coords.
    Gathers B block-panels and contracts them with one batched matmul,
    then scatter-adds block rows.
    """
    nb, R, C = block_data.shape
    k, n = b.shape
    b_blocked = b.reshape(k // C, C, n)
    gathered = b_blocked[block_cols]  # (nb, C, n)
    prods = lax.dot_general(
        block_data,
        gathered,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        precision=_prec(block_data.dtype, precision),
    )  # (nb, R, n)
    c_blocked = jnp.zeros((m // R, R, n), dtype=prods.dtype).at[
        block_rows
    ].add(prods, mode="drop")
    return axpby(c_blocked.reshape(m, n), alpha, beta, c0)


# ---------------------------------------------------------------------------
# Format conversion / index ordering
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_compressed",))
def coo_to_csr_arrays(rows, cols, vals, n_compressed):
    """Sort expanded COO by (row, col) and build CSR arrays on device.

    Returns (data, indices, indptr) with sorted column indices per row —
    the device-native ``mkl_sparse_convert_csr`` + ``mkl_sparse_order``.
    """
    key = rows.astype(jnp.int64) * (jnp.max(cols, initial=0).astype(jnp.int64) + 1) + cols.astype(jnp.int64)
    order = jnp.argsort(key)
    r_s, c_s, v_s = rows[order], cols[order], vals[order]
    counts = jnp.zeros((n_compressed,), dtype=rows.dtype).at[r_s].add(
        jnp.ones_like(r_s), mode="drop"
    )
    indptr = jnp.concatenate(
        [jnp.zeros((1,), rows.dtype), jnp.cumsum(counts).astype(rows.dtype)]
    )
    return v_s, c_s, indptr


@jax.jit
def sort_csr_indices(indptr_rows, cols, vals, ncols):
    """Order column indices within each row (``mkl_sparse_order`` analog).

    ``indptr_rows`` is the expanded per-nnz row id; a single stable sort of
    the combined (row * ncols + col) key orders every row at once.
    """
    key = (
        indptr_rows.astype(jnp.int64) * jnp.asarray(ncols, jnp.int64)
        + cols.astype(jnp.int64)
    )
    order = jnp.argsort(key)
    return cols[order], vals[order]


# ---------------------------------------------------------------------------
# Structural SpGEMM (pattern matmul)
#
# The reference's ``mkl_sparse_spmm`` output pattern is STRUCTURAL:
# entry (i, j) exists iff some k has a stored A[i,k] and B[k,j], even
# when the numeric sum cancels to zero exactly
# (``/root/reference/sparse_dot_mkl/_sparse_sparse.py:21-44``; scipy
# behaves the same).  A dense numeric product cannot represent that —
# but the pattern is itself a matmul: P = 1[A] @ 1[B] over indicator
# matrices, whose terms are all >= 0, so no cancellation is possible
# and P > 0 is exactly the structural pattern.  One extra bf16 matmul
# pass buys MKL/scipy-exact structure on the fast densify path wherever
# the dense intermediate fits; the ESC kernel remains for the regime
# where it does not.
# ---------------------------------------------------------------------------


def _indicator_sorted(flat, size):
    """Structural indicator (1.0 at every STORED position — stored
    zeros included, matching MKL/scipy structural semantics) as bf16
    for the pattern matmul."""
    return jnp.zeros((size,), jnp.bfloat16).at[flat].set(
        1.0, mode="drop", unique_indices=True, indices_are_sorted=True
    )


def _pattern_matmul(a_flat, b_flat, m, k, n, a_cm, b_cm, syrk):
    """P[i, j] = number of structural contributions to C[i, j], exact
    while < 2^24 (bf16 ones, f32 accumulation — all terms
    non-negative, so P > 0 iff (i, j) is structurally present)."""
    a_dim = 0 if a_cm else 1
    ind_a = _indicator_sorted(a_flat, m * k).reshape(
        (k, m) if a_cm else (m, k)
    )
    if syrk:
        return lax.dot_general(
            ind_a, ind_a, (((a_dim,), (a_dim,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    b_dim = 1 if b_cm else 0
    ind_b = _indicator_sorted(b_flat, k * n).reshape(
        (n, k) if b_cm else (k, n)
    )
    return lax.dot_general(
        ind_a, ind_b, (((a_dim,), (b_dim,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


@partial(
    jax.jit,
    static_argnames=("m", "k", "n", "a_cm", "b_cm", "syrk", "precision",
                     "use_ozaki", "triangular"),
)
def spgemm_structural_sorted(a_flat, a_vals, b_flat, b_vals, m, k, n,
                             a_cm=False, b_cm=False, syrk=False,
                             precision=None, use_ozaki=False,
                             triangular=False):
    """Numeric phase + structural pattern + count, fused in ONE program.

    Returns (c_dense, mask_flat, count): the dense numeric product, the
    flattened structural mask, and the structural nonzero count.
    """
    c = spgemm_numeric_sorted(
        a_flat, a_vals, b_flat, b_vals, m=m, k=k, n=n, a_cm=a_cm,
        b_cm=b_cm, syrk=syrk, precision=precision, use_ozaki=use_ozaki,
        triangular=triangular,
    )
    p = _pattern_matmul(a_flat, b_flat, m, k, n, a_cm, b_cm, syrk)
    if triangular:
        p = jnp.triu(p)
    mask_flat = (p > 0).reshape(-1)
    count = jnp.sum(mask_flat.astype(jnp.int32))
    return c, mask_flat, count


@partial(
    jax.jit,
    static_argnames=("m", "k", "n", "a_cm", "b_cm", "syrk", "precision",
                     "use_ozaki", "triangular"),
)
def spgemm_structural_planar(a_flat, ar_vals, ai_vals, b_flat, br_vals,
                             bi_vals, m, k, n, a_cm=False, b_cm=False,
                             syrk=False, precision=None, use_ozaki=False,
                             triangular=False):
    """Planar-complex SpGEMM numeric + structural pattern + count in
    ONE program: (Re, Im) = (Ar + iAi)(Br + iBi) with both operand
    channels densified from the SAME flat index (the planar channels
    share one sparsity pattern), Ozaki slice extractions shared across
    the four pair products (f64), and the bf16 pattern matmul fused in.
    Replaces the four separate real dispatches + host combine the
    planar driver paid through round 2.

    Returns (re_dense, im_dense, mask_flat, count).
    """
    a_dim = 0 if a_cm else 1
    b_dim = 1 if b_cm else 0
    a_shape = (k, m) if a_cm else (m, k)
    b_shape = (n, k) if b_cm else (k, n)
    if use_ozaki:
        arh, arl = densify_sorted_hilo(a_flat, ar_vals, a_shape)
        aih, ail = densify_sorted_hilo(a_flat, ai_vals, a_shape)
        if syrk:
            re, im = _ozaki.matmul_hilo_planar(
                arh, arl, aih, ail, None, None, None, None,
                a_contract=a_dim, syrk=True,
            )
        else:
            brh, brl = densify_sorted_hilo(b_flat, br_vals, b_shape)
            bih, bil = densify_sorted_hilo(b_flat, bi_vals, b_shape)
            re, im = _ozaki.matmul_hilo_planar(
                arh, arl, aih, ail, brh, brl, bih, bil,
                a_contract=a_dim, b_contract=b_dim,
            )
    else:
        prec = _prec(ar_vals.dtype, precision)
        ar = densify_sorted(a_flat, ar_vals, a_shape)
        ai = densify_sorted(a_flat, ai_vals, a_shape)
        if syrk:
            dims = (((a_dim,), (a_dim,)), ((), ()))
            rr = lax.dot_general(ar, ar, dims, precision=prec)
            ii = lax.dot_general(ai, ai, dims, precision=prec)
            ri = lax.dot_general(ar, ai, dims, precision=prec)
            re, im = rr - ii, ri + ri.T
        else:
            dims = (((a_dim,), (b_dim,)), ((), ()))
            br = densify_sorted(b_flat, br_vals, b_shape)
            bi = densify_sorted(b_flat, bi_vals, b_shape)
            re = (lax.dot_general(ar, br, dims, precision=prec)
                  - lax.dot_general(ai, bi, dims, precision=prec))
            im = (lax.dot_general(ar, bi, dims, precision=prec)
                  + lax.dot_general(ai, br, dims, precision=prec))
    p = _pattern_matmul(a_flat, b_flat, m, k, n, a_cm, b_cm, syrk)
    if triangular:
        # Only the mask needs the triangle — unmasked values are never
        # extracted.
        p = jnp.triu(p)
    mask_flat = (p > 0).reshape(-1)
    count = jnp.sum(mask_flat.astype(jnp.int32))
    return re, im, mask_flat, count


def _pack_mask_bits(mask_flat, dtype):
    """Pack a boolean mask 8-bits-per-float NUMERICALLY (values 0..255,
    exact in f32/f64) so a (dense, mask) pair travels to the host as
    ONE buffer read.  Pure float arithmetic, no integer shifts or
    bitcasts.  Host inverse:
    :func:`unpack_mask_bits`."""
    n = mask_flat.shape[0]
    npad = -(-n // 8) * 8
    padded = jnp.concatenate(
        [mask_flat, jnp.zeros((npad - n,), jnp.bool_)]
    )
    weights = jnp.asarray([1.0, 2, 4, 8, 16, 32, 64, 128], dtype)
    # Elementwise multiply + reduce (NOT a dot: keeps the arithmetic
    # trivially exact on every lowering path).
    return jnp.sum(padded.reshape(-1, 8).astype(dtype) * weights,
                   axis=1)


def unpack_mask_bits(packed_np, n):
    """Host-side inverse of :func:`_pack_mask_bits` (numpy)."""
    bytes_ = np.asarray(packed_np).astype(np.uint8)
    return np.unpackbits(bytes_, bitorder="little")[:n].astype(bool)


@partial(
    jax.jit,
    static_argnames=("m", "k", "n", "a_cm", "b_cm", "syrk", "precision",
                     "use_ozaki", "triangular"),
)
def spgemm_structural_packed(a_flat, a_vals, b_flat, b_vals, m, k, n,
                             a_cm=False, b_cm=False, syrk=False,
                             precision=None, use_ozaki=False,
                             triangular=False):
    """Small-product fast path: numeric + pattern fused, returned as a
    SINGLE flat buffer ``[dense_flat | packed mask bits]`` so the host
    pays exactly one readback (one round-trip) for the whole product."""
    c, mask_flat, _count = spgemm_structural_sorted(
        a_flat, a_vals, b_flat, b_vals, m=m, k=k, n=n, a_cm=a_cm,
        b_cm=b_cm, syrk=syrk, precision=precision, use_ozaki=use_ozaki,
        triangular=triangular,
    )
    packed = _pack_mask_bits(mask_flat, c.dtype)
    return jnp.concatenate([c.reshape(-1), packed])


# ---------------------------------------------------------------------------
# Planes-cached structural SpGEMM (inspector-executor steady state)
#
# The densify scatters recompute bit-identical results every call
# while the operand is unchanged.  MKL's
# inspector-executor model (``mkl_sparse_optimize``) legitimizes
# caching derived layouts on the handle; here the containers cache the
# dense numeric planes + the bf16 structural indicator per data buffer
# (``formats.dense_planes``) and these program variants consume them
# directly.
# ---------------------------------------------------------------------------


def _is_slices(num):
    """Distinguish the pre-extracted Ozaki form ``(slices (D, *, *),
    exponents)`` from the hi/lo pair ``(hi, lo)`` by the leading
    operand's rank."""
    return len(num) == 2 and num[0].ndim == 3


def _side_slices(num, dim):
    """Normalize a hilo pair to slices (inline extraction; exact and
    bit-identical to the cached form)."""
    if _is_slices(num):
        return num
    k = num[0].shape[dim]
    t, D, dj = _ozaki.plan(k)
    return _ozaki._extract_slices(num[0], num[1], dim, t, D, dj)


def _numeric_from_planes(a_num, b_num, a_dim, b_dim, syrk, precision,
                         triangular):
    """Numeric matmul from pre-densified operands: ``a_num``/``b_num``
    are ``(dense,)``, the exact f64 ``(hi, lo)`` f32 pair, or the
    pre-extracted Ozaki ``(slices, exponents)`` form (deepest cache
    level — see ``formats.ozaki_slices``)."""
    if len(a_num) == 2 and (
        _is_slices(a_num) or (b_num is not None and _is_slices(b_num))
    ):
        a_sl, a_e = _side_slices(a_num, a_dim)
        if syrk:
            c = _ozaki.syrk_from_slices(a_sl, a_e, contract=a_dim)
        else:
            b_sl, b_e = _side_slices(b_num, b_dim)
            c = _ozaki.matmul_from_slices(
                a_sl, a_e, b_sl, b_e, a_contract=a_dim,
                b_contract=b_dim,
            )
    elif len(a_num) == 2:
        if syrk:
            c = _ozaki.syrk_hilo(a_num[0], a_num[1], contract=a_dim)
        else:
            c = _ozaki.matmul_hilo(
                a_num[0], a_num[1], b_num[0], b_num[1],
                a_contract=a_dim, b_contract=b_dim,
            )
    else:
        a_dense = a_num[0]
        if syrk:
            c = lax.dot_general(
                a_dense, a_dense, (((a_dim,), (a_dim,)), ((), ())),
                precision=_prec(a_dense.dtype, precision),
            )
        else:
            c = lax.dot_general(
                a_dense, b_num[0], (((a_dim,), (b_dim,)), ((), ())),
                precision=_prec(a_dense.dtype, precision),
            )
    if triangular:
        c = jnp.triu(c)
    return c


def _pattern_from_ind(ind_a, ind_b, a_dim, b_dim, syrk, triangular):
    if syrk:
        p = lax.dot_general(
            ind_a, ind_a, (((a_dim,), (a_dim,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    else:
        p = lax.dot_general(
            ind_a, ind_b, (((a_dim,), (b_dim,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    if triangular:
        p = jnp.triu(p)
    mask_flat = (p > 0).reshape(-1)
    return mask_flat, jnp.sum(mask_flat.astype(jnp.int32))


@partial(jax.jit, static_argnames=("shape", "hilo", "with_ind"))
def dense_planes_prep(flat, vals, shape, hilo, with_ind=True):
    """One-time prep for the plane cache: dense numeric operand ((hi,
    lo) f32 pair when ``hilo``) + optional bf16 structural indicator
    (skipped for SpMM consumers, which never read it)."""
    if hilo:
        num = densify_sorted_hilo(flat, vals, shape)
    else:
        num = (densify_sorted(flat, vals, shape),)
    if not with_ind:
        return num
    ind = _indicator_sorted(flat, shape[0] * shape[1]).reshape(shape)
    return num + (ind,)


@partial(jax.jit, static_argnames=("shape", "hilo"))
def dense_planes_planar_prep(flat, ch_r, ch_i, shape, hilo):
    """Planar-complex plane-cache prep: both value channels densified
    from the SHARED flat index + one bf16 indicator."""
    if hilo:
        a = densify_sorted_hilo(flat, ch_r, shape)
        b = densify_sorted_hilo(flat, ch_i, shape)
    else:
        a = (densify_sorted(flat, ch_r, shape),)
        b = (densify_sorted(flat, ch_i, shape),)
    ind = _indicator_sorted(flat, shape[0] * shape[1]).reshape(shape)
    return a, b, ind


@partial(
    jax.jit,
    static_argnames=("a_cm", "b_cm", "syrk", "precision", "use_ozaki",
                     "triangular"),
)
def spgemm_structural_planar_planes(a_ch, ind_a, b_ch, ind_b,
                                    a_cm=False, b_cm=False, syrk=False,
                                    precision=None, use_ozaki=False,
                                    triangular=False):
    """Planar-complex structural SpGEMM from cached channel planes —
    the :func:`spgemm_structural_planar` math minus the densify
    scatters.  ``a_ch``/``b_ch`` = ((re planes), (im planes)) where
    each channel is ``(dense,)`` or the f64 ``(hi, lo)`` pair.

    Returns (re_dense, im_dense, mask_flat, count)."""
    a_dim = 0 if a_cm else 1
    b_dim = 1 if b_cm else 0
    if use_ozaki:
        # Channels arrive as (hi, lo) pairs or pre-extracted
        # (slices, exponents) — normalize to slices (exact either way).
        ar = _side_slices(a_ch[0], a_dim)
        ai = _side_slices(a_ch[1], a_dim)
        if syrk:
            re, im = _ozaki.planar_from_slices(
                ar, ai, None, None, a_contract=a_dim, syrk=True,
            )
        else:
            br = _side_slices(b_ch[0], b_dim)
            bi = _side_slices(b_ch[1], b_dim)
            re, im = _ozaki.planar_from_slices(
                ar, ai, br, bi, a_contract=a_dim, b_contract=b_dim,
            )
    else:
        (ar,), (ai,) = a_ch
        prec = _prec(ar.dtype, precision)
        if syrk:
            dims = (((a_dim,), (a_dim,)), ((), ()))
            rr = lax.dot_general(ar, ar, dims, precision=prec)
            ii = lax.dot_general(ai, ai, dims, precision=prec)
            ri = lax.dot_general(ar, ai, dims, precision=prec)
            re, im = rr - ii, ri + ri.T
        else:
            dims = (((a_dim,), (b_dim,)), ((), ()))
            (br,), (bi,) = b_ch
            re = (lax.dot_general(ar, br, dims, precision=prec)
                  - lax.dot_general(ai, bi, dims, precision=prec))
            im = (lax.dot_general(ar, bi, dims, precision=prec)
                  + lax.dot_general(ai, br, dims, precision=prec))
    mask_flat, count = _pattern_from_ind(ind_a, ind_b, a_dim, b_dim,
                                         syrk, triangular)
    return re, im, mask_flat, count


@partial(
    jax.jit,
    static_argnames=("a_cm", "b_cm", "syrk", "precision", "triangular",
                     "with_count"),
)
def spgemm_numeric_planes(a_num, b_num, a_cm=False, b_cm=False,
                          syrk=False, precision=None, triangular=False,
                          with_count=False):
    """Numeric-only (spmmd) phase from cached planes."""
    a_dim = 0 if a_cm else 1
    b_dim = 1 if b_cm else 0
    c = _numeric_from_planes(a_num, b_num, a_dim, b_dim, syrk,
                             precision, triangular)
    if with_count:
        return c, jnp.count_nonzero(c)
    return c


@partial(
    jax.jit,
    static_argnames=("a_cm", "b_cm", "syrk", "precision", "triangular"),
)
def spgemm_structural_planes(a_num, ind_a, b_num, ind_b, a_cm=False,
                             b_cm=False, syrk=False, precision=None,
                             triangular=False):
    """Numeric + pattern + count from cached planes, one dispatch.
    Returns (c_dense, mask_flat, count)."""
    a_dim = 0 if a_cm else 1
    b_dim = 1 if b_cm else 0
    c = _numeric_from_planes(a_num, b_num, a_dim, b_dim, syrk,
                             precision, triangular)
    mask_flat, count = _pattern_from_ind(ind_a, ind_b, a_dim, b_dim,
                                         syrk, triangular)
    return c, mask_flat, count


@partial(
    jax.jit,
    static_argnames=("a_cm", "b_cm", "syrk", "precision", "triangular"),
)
def spgemm_structural_packed_planes(a_num, ind_a, b_num, ind_b,
                                    a_cm=False, b_cm=False, syrk=False,
                                    precision=None, triangular=False):
    """Small-product fast path from cached planes: one flat
    ``[dense | packed mask bits]`` buffer (single readback)."""
    c, mask_flat, _ = spgemm_structural_planes(
        a_num, ind_a, b_num, ind_b, a_cm=a_cm, b_cm=b_cm, syrk=syrk,
        precision=precision, triangular=triangular,
    )
    packed = _pack_mask_bits(mask_flat, c.dtype)
    return jnp.concatenate([c.reshape(-1), packed])


@partial(
    jax.jit,
    static_argnames=("a_cm", "b_cm", "syrk", "precision", "triangular",
                     "nnz"),
)
def spgemm_structural_extract_planes(a_num, ind_a, b_num, ind_b,
                                     prev_bad, a_cm=False, b_cm=False,
                                     syrk=False, precision=None,
                                     triangular=False, nnz=0):
    """The whole structural SpGEMM in ONE dispatch from cached planes.
    Returns (vals, cols, indptr, count, bad)."""
    c, mask_flat, count = spgemm_structural_planes(
        a_num, ind_a, b_num, ind_b, a_cm=a_cm, b_cm=b_cm, syrk=syrk,
        precision=precision, triangular=triangular,
    )
    vals, cols, indptr = extract_sparse_masked(c, mask_flat, nnz)
    bad = prev_bad | (count != jnp.asarray(nnz, count.dtype))
    return vals, cols, indptr, count, bad


@partial(jax.jit, static_argnames=("m", "n", "nnz"))
def extract_structure(mask_flat, m, n, nnz):
    """One-time extraction STRUCTURE from a structural mask: the
    row-major source positions of the stored entries (``src``), their
    inverse scatter destinations (``dest``), and the CSR cols/indptr.
    All of it depends only on the operand patterns, so the driver
    caches it per structure-token pair and steady-state extraction
    reduces to pure value movement.

    Note ``src`` is used by the f64 hi|lo pair gather and ``dest`` by
    the exact sorted set-scatter; the host driver keeps only the one
    its chosen movement path needs (ops/host.py spgemm structural
    cache)."""
    pos = prefix_sum(mask_flat) - 1
    dest = jnp.where(mask_flat, pos, nnz)
    iota_flat = jnp.arange(m * n, dtype=jnp.int32)
    src = jnp.zeros((nnz,), jnp.int32).at[dest].set(
        iota_flat, mode="drop", unique_indices=True,
        indices_are_sorted=True,
    )
    col_of = jax.lax.broadcasted_iota(jnp.int32, (m, n), 1).reshape(-1)
    cols = jnp.zeros((nnz,), jnp.int32).at[dest].set(
        col_of, mode="drop", unique_indices=True,
        indices_are_sorted=True,
    )
    row_counts = jnp.sum(
        mask_flat.reshape(m, n).astype(jnp.int32), axis=1
    )
    indptr = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(row_counts).astype(jnp.int32)]
    )
    return src, dest, cols, indptr


@partial(
    jax.jit,
    static_argnames=("a_cm", "b_cm", "syrk", "precision", "triangular",
                     "nnz", "gather"),
)
def spgemm_structural_vals_planes(a_num, ind_a, b_num, ind_b, src_dest,
                                  prev_bad, a_cm=False, b_cm=False,
                                  syrk=False, precision=None,
                                  triangular=False, nnz=0,
                                  gather=True):
    """Steady-state structural SpGEMM with CACHED extraction
    structure: numeric + pattern count + value movement only (cols and
    indptr come from the driver's structure cache).  ``gather=True``
    moves f64 values with a windowed hi|lo pair gather;
    ``gather=False`` uses one
    cached-dest sorted set-scatter (the f32 form — a 1-wide f32 gather
    is the slowest primitive, the single scatter is cheaper — and the
    scatter moves values EXACTLY in their native dtype).

    RANGE CONTRACT of ``gather=True``: the hi|lo pair is a plain f32
    split, so product values with |x| > ~3.4e38 saturate to inf,
    |x| below the f32 subnormal floor flush to 0, and everything
    re-rounds at ~2^-49 relative.  The host driver therefore only
    selects ``gather=True`` when the Ozaki policy gate is on (same
    f32-range assumption on the inputs); otherwise it uses the exact
    scatter.

    Returns (vals, count, bad)."""
    c, mask_flat, count = spgemm_structural_planes(
        a_num, ind_a, b_num, ind_b, a_cm=a_cm, b_cm=b_cm, syrk=syrk,
        precision=precision, triangular=triangular,
    )
    del mask_flat
    flat = c.reshape(-1)
    if gather:
        hi, lo = _ozaki.hilo(flat)
        packed = jnp.stack([hi, lo], axis=1)  # (m*n, 2) f32
        g = packed[src_dest]
        vals = (g[:, 0].astype(jnp.float64)
                + g[:, 1].astype(jnp.float64))
    else:
        vals = sorted_set_scatter(src_dest, flat, nnz)
    bad = prev_bad | (count != jnp.asarray(nnz, count.dtype))
    return vals, count, bad


@partial(
    jax.jit,
    static_argnames=("m", "k", "n", "a_cm", "b_cm", "syrk", "triangular"),
)
def pattern_mask_sorted(a_flat, b_flat, m, k, n, a_cm=False, b_cm=False,
                        syrk=False, triangular=False):
    """Structural pattern alone: (mask_flat, count).  Used by the
    planar-complex driver, where the numeric phase runs as separate
    real passes but the pattern is shared by all channels."""
    p = _pattern_matmul(a_flat, b_flat, m, k, n, a_cm, b_cm, syrk)
    if triangular:
        p = jnp.triu(p)
    mask_flat = (p > 0).reshape(-1)
    return mask_flat, jnp.sum(mask_flat.astype(jnp.int32))


@partial(jax.jit, static_argnames=("mb", "k", "use_ozaki", "precision",
                                   "triangular"))
def spgemm_block_structural_mxu(a_flat, a_vals, b_num, b_ind, row_offset,
                                mb, k, use_ozaki=False, precision=None,
                                triangular=False):
    """One row block of the blocked structural SpGEMM, dense body.

    Unlike :func:`spmm_block_structural` (scatter numeric phase), this
    densifies the block's A rows with the sorted-set fast scatter
    (local flat index ``row_local * k + col`` is ascending for CSR row
    slices) and runs the numeric phase as one ``dot_general`` — Ozaki
    bf16 slices where enabled — the same formulation as the one-shot
    ``spgemm_structural_sorted`` path.

    ``b_num`` is ``(b_dense,)`` or the f64 hi/lo pair ``(b_hi, b_lo)``;
    ``b_ind`` the bf16 structural indicator of B.  ``row_offset`` (device
    scalar) places the block for the global-triangle mask.

    Returns (c_block, mask_block, count).
    """
    if use_ozaki:
        a_hi, a_lo = densify_sorted_hilo(a_flat, a_vals, (mb, k))
        b_hi, b_lo = b_num
        c = _ozaki.matmul_hilo(a_hi, a_lo, b_hi, b_lo)
    else:
        a_dense = densify_sorted(a_flat, a_vals, (mb, k))
        c = lax.dot_general(
            a_dense, b_num[0], (((1,), (0,)), ((), ())),
            precision=_prec(a_vals.dtype, precision),
        )
    ind_a = _indicator_sorted(a_flat, mb * k).reshape(mb, k)
    p = lax.dot_general(
        ind_a, b_ind, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    mask = p > 0
    n = b_ind.shape[1]
    if triangular:
        col_ids = lax.broadcasted_iota(jnp.int32, (mb, n), 1)
        row_ids = lax.broadcasted_iota(jnp.int32, (mb, n), 0) + row_offset
        mask = mask & (col_ids >= row_ids)
    count = jnp.sum(mask.astype(jnp.int32))
    return c, mask, count


@partial(jax.jit, static_argnames=("shape", "hilo"))
def densify_with_indicator(rows, cols, vals, shape, hilo=False):
    """One dispatch for the blocked-SpGEMM B prep: dense numeric
    operand (hi/lo f32 pair when ``hilo``) + bf16 structural
    indicator."""
    dense = jnp.zeros(shape, dtype=vals.dtype).at[rows, cols].add(
        vals, mode="drop"
    )
    ind = jnp.zeros(shape, jnp.bfloat16).at[rows, cols].set(
        1.0, mode="drop"
    )
    if hilo:
        return _ozaki.hilo(dense) + (ind,)
    return (dense, ind)


@partial(jax.jit, static_argnames=("nnz",))
def extract_sparse_masked(c_dense, mask_flat, nnz):
    """Dense + structural mask -> CSR arrays with exactly ``nnz``
    stored entries (``nnz`` = the mask's popcount; explicitly-zero
    values are kept, matching MKL/scipy structural output).

    On the sortedness hints: ``dest`` is ascending over the LIVE slots
    with the out-of-range ``nnz`` sentinel interleaved at masked-off
    positions.  Unlike the rank-compaction pattern `_esc_sort_compress`
    documents as hint-unsafe (live destinations JUMPING between
    dropped slots), this monotone-live/constant-sentinel shape is
    hint-safe: the destinations really are sorted and unique."""
    m, n = c_dense.shape
    flat = c_dense.reshape(-1)
    pos = prefix_sum(mask_flat) - 1
    dest = jnp.where(mask_flat, pos, nnz)
    vals = sorted_set_scatter(dest, flat, nnz)
    col_of = jax.lax.broadcasted_iota(jnp.int32, (m, n), 1).reshape(-1)
    cols = jnp.zeros((nnz,), jnp.int32).at[dest].set(
        col_of, mode="drop", unique_indices=True, indices_are_sorted=True
    )
    row_counts = jnp.sum(mask_flat.reshape(m, n).astype(jnp.int32), axis=1)
    indptr = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(row_counts).astype(jnp.int32)]
    )
    return vals, cols, indptr


@partial(
    jax.jit,
    static_argnames=("m", "k", "n", "a_cm", "b_cm", "syrk", "use_ozaki",
                     "triangular", "nnz"),
)
def spgemm_structural_extract(a_flat, a_vals, b_flat, b_vals, prev_bad,
                              m, k, n, a_cm=False, b_cm=False,
                              syrk=False, use_ozaki=False,
                              triangular=False, nnz=0):
    """The whole structural SpGEMM in ONE dispatch: numeric + pattern
    + count + masked extraction at the (speculative) static ``nnz``,
    with the sizing-validation flag merged in-program.  Steady-state
    products with a cached size therefore cost exactly one program
    launch and never materialize dense/mask round-trips through
    dispatch boundaries.

    Returns (vals, cols, indptr, count, bad).
    """
    c, mask_flat, count = spgemm_structural_sorted(
        a_flat, a_vals, b_flat, b_vals, m=m, k=k, n=n, a_cm=a_cm,
        b_cm=b_cm, syrk=syrk, use_ozaki=use_ozaki, triangular=triangular,
    )
    vals, cols, indptr = extract_sparse_masked(c, mask_flat, nnz)
    bad = prev_bad | (count != jnp.asarray(nnz, count.dtype))
    return vals, cols, indptr, count, bad


# ---------------------------------------------------------------------------
# ESC SpGEMM (expand - sort - compress): true sparse-output kernel
#
# The reference's `mkl_sparse_spmm` allocates a sparse result of any
# size inside MKL (``_sparse_sparse.py:21-44``).  XLA needs static
# shapes, so the answer here is a row-blocked ESC pipeline whose
# intermediate is the *expansion* (one slot per scalar product
# a_ik * b_kj), never an m x n dense array:
#
#   1. expand: for every A-nonzero, gather the B-row it multiplies
#      (pure gathers steered by a host-computed offset table),
#   2. sort the (row * n + col) keys with the value payload co-sorted
#      (one ``lax.sort``),
#   3. compress: segment-sum duplicates with log2(max-duplicates)
#      exact elementwise doubling passes (no f64 scatter-add), then
#      compact heads with
#      sorted-unique set scatters (hi/lo split for f64).
#
# The output pattern is STRUCTURAL — numerically cancelled entries stay,
# matching MKL/scipy — unlike the densify+extract fast path, which
# cannot represent an explicit zero.
# ---------------------------------------------------------------------------


def _esc_sort_compress(key, chans, e_pad, mb, n, kdt, dup_passes,
                       perm_sort):
    """Shared back half of the ESC block: sort by key, exact
    doubling-pass duplicate sums, head compaction.  Returns
    (key_i32, vals..., count) for i32-key blocks, or
    ([row_counts | cols] i32, vals..., count) for i64-key blocks —
    see the readback-encoding comment in the body.  Values stay full
    f64 — on the wire an f64 array is
    already two 4-byte planes, so a hi|lo f32 re-encoding moves the
    same bytes and was rejected."""
    if perm_sort:
        # Sort (key, iota32) and gather the value channels through the
        # permutation — kept behind config: MEASURED SLOWER than
        # co-sorting on this toolchain (random 1-wide gathers are the
        # slowest primitive there is; see host._esc_perm_sort).
        iota = jnp.arange(e_pad, dtype=jnp.int32)
        skey, sidx = lax.sort((key, iota), dimension=0, num_keys=1)
        svals = [c[sidx] for c in chans]
    else:
        sorted_ops = lax.sort((key,) + tuple(chans), dimension=0,
                              num_keys=1)
        skey, svals = sorted_ops[0], list(sorted_ops[1:])

    svalid = skey < jnp.asarray(mb, kdt) * n
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), skey[1:] != skey[:-1]]
    ) & svalid

    # Exact in-segment suffix sums by doubling: after pass p, v[i] holds
    # the sum of up to 2^(p+1) same-key elements starting at i.
    for p in range(dup_passes):
        sh = 1 << p
        same = jnp.concatenate(
            [skey[sh:] == skey[:-sh], jnp.zeros((sh,), jnp.bool_)]
        )
        for c in range(len(svals)):
            shifted = jnp.concatenate(
                [svals[c][sh:], jnp.zeros((sh,), svals[c].dtype)]
            )
            svals[c] = svals[c] + jnp.where(same, shifted, 0)

    seg = prefix_sum(head) - 1  # segment id per element (heads define)
    count = seg[-1] + 1

    # Compaction by a second sort on the destination rank: heads carry
    # their output position, everything else sinks to the tail (rank
    # e_pad).  Slots past ``count`` are garbage; callers slice [:count].
    # NOT a set-scatter: where(head, seg, e_pad) interleaves dropped
    # slots between the sorted live destinations, so the
    # indices_are_sorted/unique_indices hints would be lies, and a
    # backend that trusts them may return wrong values (CPU ignores the
    # hints, so the CPU suite cannot show it).
    rank = jnp.where(head, seg, e_pad)
    if perm_sort:
        iota = jnp.arange(e_pad, dtype=jnp.int32)
        _, cidx = lax.sort((rank, iota), dimension=0, num_keys=1)
        ck = skey[cidx]
        cvals = tuple(v[cidx] for v in svals)
    else:
        compacted = lax.sort((rank, skey) + tuple(svals), dimension=0,
                             num_keys=1)
        ck = compacted[1]
        cvals = tuple(compacted[2:])

    # Readback encoding:
    # * i32 keys (the common case): ship the raw compacted key — 4
    #   bytes/entry, HALF the round-3 i64 keys, zero extra device work;
    #   the host splits rows/cols and bincounts over just ``count``
    #   live entries.
    # * i64 keys (hypersparse giants, mb*n >= 2^31): shipping rows+cols
    #   would be 8 bytes/entry again, so split on DEVICE into int32
    #   columns plus a per-row histogram via searchsorted at the row
    #   boundaries (cheaper than the 16 MB of extra readback it saves
    #   on the 1M x 1M product).  Both travel as ONE i32 buffer
    #   ([counts | cols]) so the host reads a single slice.
    if kdt != jnp.int64:
        return (ck.astype(jnp.int32),) + cvals + (
            count.astype(jnp.int32),
        )
    pos = jnp.arange(e_pad, dtype=jnp.int32)
    sentinel = jnp.asarray(mb, kdt) * n
    ck_live = jnp.where(pos < count, ck, sentinel)
    bounds = (jnp.arange(mb, dtype=kdt) + 1) * n
    ends = jnp.searchsorted(ck_live, bounds, side="left")
    row_counts = jnp.diff(
        jnp.concatenate([jnp.zeros((1,), ends.dtype), ends])
    ).astype(jnp.int32)
    cols = (ck_live - (ck_live // n) * n).astype(jnp.int32)
    colcnt = jnp.concatenate([row_counts, cols])
    return (colcnt,) + cvals + (count.astype(jnp.int32),)


@partial(jax.jit, static_argnames=("chan64",))
def esc_pack_a(rows, bstart, offs, chans, chan64):
    """Build the per-A-nonzero packed rows for the windowed-gather ESC
    kernel: [local_row, bstart, offset, value channels] as f32 (hi/lo
    pair per channel when ``chan64``)."""
    cols_ = [rows.astype(jnp.float32), bstart.astype(jnp.float32),
             offs.astype(jnp.float32)]
    for c in chans:
        if chan64:
            h, l = _ozaki.hilo(c)
            cols_ += [h, l]
        else:
            cols_ += [c.astype(jnp.float32)]
    return jnp.stack(cols_, axis=1)


@partial(jax.jit, static_argnames=("chan64",))
def esc_pack_a_vals(chans, chan64):
    """Value-only columns of the packed-A rows: (nnz_pad, nchan*cw)
    f32.  The structure columns ([local_row, bstart, offset]) are
    built once per block structure and cached on the host plan; each
    call only re-packs the values and concatenates — so the steady
    state uploads NO per-block planning arrays (the round-4 1M x 1M
    profile lost ~0.5 s/call re-uploading perm/offsets/bstart)."""
    cols_ = []
    for c in chans:
        if chan64:
            h, l = _ozaki.hilo(c)
            cols_ += [h, l]
        else:
            cols_ += [c.astype(jnp.float32)]
    return jnp.stack(cols_, axis=1)


@partial(jax.jit, static_argnames=("chan64",))
def esc_pack_b(b_indices, b_chans, chan64):
    """Per-B-nonzero packed rows: [column, value channels] as f32."""
    cols_ = [b_indices.astype(jnp.float32)]
    for i in range(b_chans.shape[0]):
        c = b_chans[i]
        if chan64:
            h, l = _ozaki.hilo(c)
            cols_ += [h, l]
        else:
            cols_ += [c.astype(jnp.float32)]
    return jnp.stack(cols_, axis=1)


@partial(
    jax.jit,
    static_argnames=("e_pad", "mb", "n", "nchan", "chan64", "key64",
                     "dup_passes", "triangular", "perm_sort"),
)
def esc_spgemm_block_packed(a_pack, offsets, e_total, b_pack,
                            row_offset, e_pad, mb, n, nchan, chan64,
                            key64, dup_passes, triangular=False,
                            perm_sort=False):
    """ESC block with WINDOWED expansion gathers.

    The round-2/3 kernel issued seven 1-wide gathers per expansion slot
    family (rows, cols, offsets, values by j; b_indptr, b_indices,
    b_data by bpos) — measured at ~90 ms per 4M-element gather, 93% of
    the block body.  A 4-wide windowed gather of the same indices runs
    15x faster (one serialized pass per INDEX, not per element), so the
    per-nonzero fields are packed into one f32 row per A-nonzero /
    B-nonzero and the whole expansion becomes TWO gathers.

    a_pack : (nnz_pad, 3 + nchan*cw) f32 — [local_row, bstart (B's
        indptr at this nonzero's column), expansion offset, value
        channels]; cw = 2 (hi/lo) when ``chan64`` else 1.  All integer
        fields must be < 2^24 (exact in f32) — the driver gates on it.
    b_pack : (b_nnz, 1 + nchan*cw) f32 — [column, value channels].

    First-return encoding matches :func:`esc_spgemm_block` and depends
    on ``key64``: raw compacted ``row * n + col`` i32 keys when
    ``key64=False`` (the common case), or ``[row_counts | cols]`` i32
    when ``key64=True``.  The host flush decodes by its ``bkey64``
    flag — see :func:`_esc_sort_compress`.
    """
    kdt = jnp.int64 if key64 else jnp.int32
    row, col, valid, chans = _esc_expand_packed(
        a_pack, offsets, e_total, b_pack, row_offset,
        e_pad=e_pad, nchan=nchan, chan64=chan64, triangular=triangular,
    )
    row_k = jnp.where(valid, row.astype(kdt), mb)
    key = row_k * n + jnp.where(valid, col.astype(kdt), 0)
    return _esc_sort_compress(key, chans, e_pad, mb, n, kdt,
                              dup_passes, perm_sort)


def _esc_expand_packed(a_pack, offsets, e_total, b_pack, row_offset,
                       e_pad, nchan, chan64, triangular):
    """Shared expansion front half of the packed ESC kernels: returns
    (row i32, col i32, valid, chans) per expansion slot — two windowed
    gathers total (see :func:`esc_spgemm_block_packed`)."""
    nnz_pad = a_pack.shape[0]
    t = jnp.arange(e_pad, dtype=offsets.dtype)
    j = segment_ids_from_offsets(offsets, e_pad, nnz_pad - 1)
    ga = a_pack[j]  # (e_pad, wa) — windowed gather #1
    valid = t < e_total
    pos = t.astype(jnp.int32) - ga[:, 2].astype(jnp.int32)
    bpos = jnp.clip(
        ga[:, 1].astype(jnp.int32) + pos, 0, b_pack.shape[0] - 1
    )
    gb = b_pack[bpos]  # (e_pad, wb) — windowed gather #2
    row = ga[:, 0].astype(jnp.int32)
    col = gb[:, 0].astype(jnp.int32)
    if triangular:
        valid = valid & (col >= row + row_offset)

    cw = 2 if chan64 else 1

    def chan(arr, base):
        if chan64:
            return (arr[:, base].astype(jnp.float64)
                    + arr[:, base + 1].astype(jnp.float64))
        return arr[:, base]

    a_c = [chan(ga, 3 + c * cw) for c in range(nchan)]
    b_c = [chan(gb, 1 + c * cw) for c in range(nchan)]
    if nchan == 1:
        chans = (jnp.where(valid, a_c[0] * b_c[0], 0),)
    else:
        ar, ai = a_c
        br, bi = b_c
        chans = (
            jnp.where(valid, ar * br - ai * bi, 0),
            jnp.where(valid, ar * bi + ai * br, 0),
        )
    return row, col, valid, chans


@partial(
    jax.jit,
    static_argnames=("e_pad", "mb", "n", "nchan", "chan64", "key64",
                     "triangular"),
)
def esc_extract_structure_packed(a_pack, offsets, e_total, b_pack,
                                 row_offset, e_pad, mb, n, nchan,
                                 chan64, key64, triangular=False):
    """One-time STRUCTURE extraction for the sort-free steady-state
    ESC kernel: the expansion-slot -> sorted-position permutation
    (``sidx``) and the sorted positions of the unique-key heads
    (``head_src``, compacted to the front; tail garbage, callers slice
    [:count]).  Both depend only on the operand structures, so the
    driver caches them per pattern and steady-state repeats replace
    the 4M-slot i64 sort — the dominant kernel phase on the 1M x 1M
    workload — with windowed gathers
    (:func:`esc_spgemm_block_cached`).

    Returns (sidx i32 (e_pad,), head_src i32 (e_pad,), count)."""
    kdt = jnp.int64 if key64 else jnp.int32
    row, col, valid, _ = _esc_expand_packed(
        a_pack, offsets, e_total, b_pack, row_offset,
        e_pad=e_pad, nchan=nchan, chan64=chan64, triangular=triangular,
    )
    row_k = jnp.where(valid, row.astype(kdt), mb)
    key = row_k * n + jnp.where(valid, col.astype(kdt), 0)
    iota = jnp.arange(e_pad, dtype=jnp.int32)
    # Stable: duplicate keys keep expansion order, making sidx (and so
    # every steady-state summation order) deterministic.
    skey, sidx = lax.sort((key, iota), dimension=0, num_keys=1,
                          is_stable=True)
    svalid = skey < jnp.asarray(mb, kdt) * n
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), skey[1:] != skey[:-1]]
    ) & svalid
    count = jnp.sum(head.astype(jnp.int32))
    # Head positions compacted to the front by a rank sort (a hinted
    # set-scatter would lie about sortedness — see _esc_sort_compress).
    pos = prefix_sum(head) - 1
    rank = jnp.where(head, pos, e_pad)
    _, head_src = lax.sort((rank, iota), dimension=0, num_keys=1)
    return sidx, head_src, count


@partial(
    jax.jit,
    static_argnames=("e_pad", "mb", "n", "nchan", "chan64",
                     "dup_passes", "triangular"),
)
def esc_spgemm_block_cached(a_pack, offsets, e_total, b_pack,
                            row_offset, sidx, head_src, e_pad, mb, n,
                            nchan, chan64, dup_passes,
                            triangular=False):
    """Sort-free steady-state ESC block from a CACHED structure.

    With the output pattern known (count-validated by the driver), the
    per-call work is value movement only: expand (two windowed
    gathers), permute into sorted order through ``sidx`` (ONE windowed
    gather of a packed [row, col, value-channels] f32 plane — rows and
    cols ride along to drive the duplicate masks and the in-band count
    check), exact f64 doubling-pass duplicate sums, and one
    ``head_src`` windowed gather to compact.  No sort, no searchsorted:
    the 1M x 1M block's ~1.2 s i64 sort becomes ~100 ms of gathers.

    The f64 channels move as hi|lo f32 pairs (exact to ~2^-49 INSIDE
    the f32 range — the driver gates this path on the same range check
    as the packed kernel; the duplicate SUMS run in full f64).

    ``head_src`` arrives host-sliced to the count bucket, so the
    output value buffers are (cnt_pad,).  Slots past the live count
    are garbage; callers slice [:count].

    Returns (vals... (cnt_pad,), count i32)."""
    row, col, valid, chans = _esc_expand_packed(
        a_pack, offsets, e_total, b_pack, row_offset,
        e_pad=e_pad, nchan=nchan, chan64=chan64, triangular=triangular,
    )
    # Packed sorted-order plane: [row, col, value channels] — rows and
    # cols are < 2^24 (driver-gated), exact in f32.
    row_m = jnp.where(valid, row, mb).astype(jnp.float32)
    col_m = jnp.where(valid, col, 0).astype(jnp.float32)
    cols_ = [row_m, col_m]
    for c in chans:
        if chan64:
            h, l = _ozaki.hilo(c)
            cols_ += [h, l]
        else:
            cols_ += [c]
    S = jnp.stack(cols_, axis=1)[sidx]  # the sort, as ONE gather
    rows_s = S[:, 0]
    cols_s = S[:, 1]
    cw = 2 if chan64 else 1

    def sval(cidx):
        base = 2 + cidx * cw
        if chan64:
            return (S[:, base].astype(jnp.float64)
                    + S[:, base + 1].astype(jnp.float64))
        return S[:, base]

    svals = [sval(c) for c in range(nchan)]
    svalid = rows_s < mb
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         (rows_s[1:] != rows_s[:-1]) | (cols_s[1:] != cols_s[:-1])]
    ) & svalid
    count = jnp.sum(head.astype(jnp.int32))

    # Exact in-segment suffix sums by doubling (same scheme as
    # _esc_sort_compress, with the same-key mask from the row|col
    # planes instead of the integer key).
    for p in range(dup_passes):
        sh = 1 << p
        same = jnp.concatenate(
            [(rows_s[sh:] == rows_s[:-sh])
             & (cols_s[sh:] == cols_s[:-sh]),
             jnp.zeros((sh,), jnp.bool_)]
        )
        for c in range(len(svals)):
            shifted = jnp.concatenate(
                [svals[c][sh:], jnp.zeros((sh,), svals[c].dtype)]
            )
            svals[c] = svals[c] + jnp.where(same, shifted, 0)

    # Compact: one windowed gather of the packed summed channels.
    comp_cols = []
    for v in svals:
        if chan64:
            h, l = _ozaki.hilo(v)
            comp_cols += [h, l]
        else:
            comp_cols += [v]
    C = jnp.stack(comp_cols, axis=1)[head_src]

    def cval(cidx):
        base = cidx * cw
        if chan64:
            return (C[:, base].astype(jnp.float64)
                    + C[:, base + 1].astype(jnp.float64))
        return C[:, base]

    return tuple(cval(c) for c in range(nchan)) + (count,)


@partial(
    jax.jit,
    static_argnames=("e_pad", "mb", "n", "nchan", "key64", "dup_passes",
                     "triangular", "perm_sort"),
)
def esc_spgemm_block(a_rows, a_cols, a_vals, offsets, e_total,
                     b_indptr, b_indices, b_data, row_offset,
                     e_pad, mb, n, nchan, key64, dup_passes,
                     triangular=False, perm_sort=False):
    """One row-block of the ESC SpGEMM; everything static-shaped.

    a_rows/a_cols : (nnz_pad,) LOCAL row ids (pad rows = mb) / col ids.
    a_vals, b_data : (nchan, nnz) value channels (2 for planar complex).
    offsets : (nnz_pad + 1,) expansion prefix (offsets[j] = first slot of
        A-nonzero j; padded tail pinned at e_total so no slot maps there).
    e_total : scalar — live expansion slots (<= e_pad).
    row_offset : scalar — global row of local row 0 (triangular masking).
    dup_passes : ceil(log2(max duplicates of one key)) — host-known
        bound: the max nnz of any A row in the block.

    Returns (keybuf i32, vals..., count).  The first buffer's encoding
    depends on ``key64`` (the host flush decodes by its ``bkey64``
    flag): with ``key64=False`` (the common case) it is the raw
    compacted ``row * n + col`` i32 keys in sorted order; with
    ``key64=True`` it is ``[row_counts | cols]`` — the per-local-row
    entry histogram (mb slots) followed by the per-entry columns in
    (row, col) sorted order.  ``vals...`` are the per-channel summed
    values and ``count`` the live entry count.  See
    :func:`_esc_sort_compress` for the why.
    """
    kdt = jnp.int64 if key64 else jnp.int32
    nnz_pad = a_rows.shape[0]
    t = jnp.arange(e_pad, dtype=offsets.dtype)
    j = segment_ids_from_offsets(offsets, e_pad, nnz_pad - 1)
    valid = t < e_total
    pos = (t - offsets[j]).astype(jnp.int32)
    bpos = jnp.clip(
        b_indptr[a_cols[j]].astype(jnp.int32) + pos,
        0, b_indices.shape[0] - 1,
    )
    row = a_rows[j].astype(kdt)
    col = b_indices[bpos].astype(kdt)
    if triangular:
        # Upper triangle of the GLOBAL product (gram/syrk fusion).
        valid = valid & (col >= row + row_offset)
    row = jnp.where(valid, row, mb)
    key = row * n + jnp.where(valid, col, 0)

    if nchan == 1:
        v = a_vals[0][j] * b_data[0][bpos]
        chans = (jnp.where(valid, v, 0),)
    else:
        ar, ai = a_vals[0][j], a_vals[1][j]
        br, bi = b_data[0][bpos], b_data[1][bpos]
        chans = (
            jnp.where(valid, ar * br - ai * bi, 0),
            jnp.where(valid, ar * bi + ai * br, 0),
        )

    return _esc_sort_compress(key, chans, e_pad, mb, n, kdt,
                              dup_passes, perm_sort)

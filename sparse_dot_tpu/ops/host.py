"""Eager host-boundary wrappers around the device kernels.

These are what the scipy-facing dispatch drivers call.  Responsibilities:

* scipy/numpy <-> device conversion (including planar complex splitting
  on backends without native complex — see ``formats``),
* lowering CSR/CSC/BSR containers to the expanded-COO arrays the device
  kernels consume (with transpose handled by swapping row/col roles),
* complex products as four real products when the backend needs planar
  storage (C = (ArBr - AiBi) + i(ArBi + AiBr) — the products share one
  sparsity pattern so index arrays are reused),
* alpha / beta(out_scalar) accumulate semantics (device-side for real
  dtypes, host-side for planar complex),
* density-adaptive kernel choice (scatter vs ELL vs densified product vs
  BSR batch).

Reference behavior being reproduced: the op drivers in
``/root/reference/sparse_dot_mkl/_sparse_dense.py``, ``_sparse_vector.py``,
``_sparse_sparse.py``, ``_dense_dense.py``, ``_gram_matrix.py`` — minus
all handle lifecycle, which does not exist here.
"""

import time

import numpy as np

import jax.numpy as jnp

from .. import formats
from ..config import config
from . import _xla


# ---------------------------------------------------------------------------
# f32-range policy for the hi|lo fast paths
# ---------------------------------------------------------------------------

_HILO_ABS_MAX = 3.0e38  # just under f32 max
# The LO limb of a hi|lo split carries ~|v| * 2^-25; it must stay a
# NORMAL f32 (>= ~1.2e-38) for the split to be exact to ~2^-49, so the
# floor is min_normal_f32 * 2^25 ~ 4e-31 — not the f32 subnormal
# boundary itself (review r5 finding: a 1e-37 floor left a six-decade
# band where the split silently degraded to ~f32 accuracy).
_HILO_ABS_MIN = 4.0e-31


def _hilo_range_ok(arr_np):
    """Host-side check that a numpy operand's magnitudes fit the f32
    hi|lo window (the split saturates above ~3.4e38 and flushes below
    the f32 subnormal floor — see ``_xla.sorted_set_scatter``)."""
    a = np.abs(np.asarray(arr_np).reshape(-1))
    if a.size == 0:
        return True
    mx = float(a.max())
    if not np.isfinite(mx) or mx > _HILO_ABS_MAX:
        return False
    nz = a[a > 0]
    return nz.size == 0 or float(nz.min()) >= _HILO_ABS_MIN


def _container_range(M):
    """(max_abs, min_nonzero_abs) of a device container's values,
    computed ONCE per data buffer with a device reduction and a single
    two-scalar read, then cached on the container.  Empty data ->
    (0.0, inf)."""
    cached = getattr(M, "_range_cache", None)
    if cached is not None and cached[0] is M.data:
        return cached[1]
    mx_all, nzmin_all = 0.0, np.inf
    parts = [M.data]
    if getattr(M, "planar", False):
        try:
            parts.append(M.imag_view().data)
        except Exception:
            pass
    for d in parts:
        flat = d.reshape(-1)
        if flat.size == 0:
            continue
        a = jnp.abs(flat)
        pair = np.asarray(jnp.stack([
            jnp.max(a),
            jnp.min(jnp.where(a == 0, jnp.inf, a)),
        ]))
        mx, nzmin = float(pair[0]), float(pair[1])
        mx_all = max(mx_all, mx) if np.isfinite(mx) else np.inf
        nzmin_all = min(nzmin_all, nzmin)
    out = (mx_all, nzmin_all)
    try:
        M._range_cache = (M.data, out)
    except Exception:
        pass
    return out


def _container_hilo_ok(M):
    """True when the container's value magnitudes fit the f32 hi|lo
    window (see :func:`_hilo_range_ok`).  Gates the Ozaki / packed
    paths whose hi|lo encoding assumes the f32 range."""
    mx, nzmin = _container_range(M)
    if not np.isfinite(mx) or mx > _HILO_ABS_MAX:
        return False
    return not np.isfinite(nzmin) or nzmin >= _HILO_ABS_MIN


def _container_max_row_nnz(M):
    """Max nnz over the container's compressed-axis rows, cached per
    index structure (one small indptr read).  Bounds the number of
    terms summed into any single product entry — the duplicate factor
    of the product-range gates."""
    cached = getattr(M, "_max_row_nnz_cache", None)
    if cached is not None and cached[0] is M.indptr:
        return cached[1]
    ip = np.asarray(M.indptr)
    mx = int(np.diff(ip).max()) if ip.size > 1 else 0
    try:
        M._max_row_nnz_cache = (M.indptr, mx)
    except Exception:
        pass
    return mx


def _product_range_ok(A, B, max_dup, nchan=1):
    """True when every PRODUCT value (and every partial sum of up to
    ``max_dup`` of them) stays inside the f32 hi|lo window.  Operand
    gating alone allows products up to ~(3.4e38)^2; every path that
    hi|lo-encodes product values must use THIS gate.  ``nchan=2``
    (planar complex) doubles the bound for the cross terms
    (ar*br - ai*bi)."""
    mxA, mnA = _container_range(A)
    mxB, mnB = _container_range(B)
    if not (np.isfinite(mxA) and np.isfinite(mxB)):
        return False
    factor = max(max_dup, 1) * (2 if nchan == 2 else 1)
    if mxA * mxB * factor > _HILO_ABS_MAX:
        return False
    mn = mnA * mnB
    # NOTE no ``mn == 0.0`` escape: a host-double underflow to zero
    # means the true min product is BELOW the flush floor.
    return not np.isfinite(mn) or mn >= _HILO_ABS_MIN


# ---------------------------------------------------------------------------
# container lowering
# ---------------------------------------------------------------------------


def _bsr_element_coo(A, data):
    """Expand BSR blocks to element COO on device."""
    R, C = A.blocksize
    nb = A.nblocks
    br = A.block_row_indices()
    bc = A.indices
    i = jnp.arange(R, dtype=br.dtype)
    j = jnp.arange(C, dtype=br.dtype)
    # Broadcast against element grids to (nb, R, C) then flatten.
    rows = jnp.broadcast_to(
        (br[:, None, None] * R + i[None, :, None]), (nb, R, C)
    ).reshape(-1)
    cols = jnp.broadcast_to(
        (bc[:, None, None] * C + j[None, None, :]), (nb, R, C)
    ).reshape(-1)
    return rows, cols, data.reshape(-1)


def coo_parts(A, data=None, transpose=False):
    """Lower a container to (rows, cols, vals, m, k) expanded COO.

    ``data`` overrides the container's data (used for planar real/imag
    passes).  ``transpose`` swaps the row/col roles, giving A^T for free.
    """
    data = A.data if data is None else data
    if isinstance(A, formats.CSR):
        rows, cols = A.row_indices(), A.indices
        vals = data
    elif isinstance(A, formats.CSC):
        rows, cols = A.indices, A.col_indices()
        vals = data
    elif isinstance(A, formats.BSR):
        rows, cols, vals = _bsr_element_coo(A, data)
    else:
        raise ValueError(f"Unsupported container {type(A)}")
    m, k = A.shape
    if transpose:
        rows, cols = cols, rows
        m, k = k, m
    return rows, cols, vals, m, k


def _a_parts(A):
    """(real_container_data, imag_container_data|None) for planar A."""
    if A.planar:
        return A.data[0], A.data[1]
    return A.data, None


def _dense_parts(b_np):
    """Host dense -> (device_real, device_imag|None, was_planar)."""
    dev, planar = formats.dense_to_device(b_np)
    if planar:
        return dev[0], dev[1], True
    return dev, None, False


def _combine_planar(re_np, im_np, dtype):
    return (re_np + 1j * im_np).astype(dtype)


# ---------------------------------------------------------------------------
# SpMM / SpMV
# ---------------------------------------------------------------------------


def _real_spmm(A, a_data, b_dev, transpose, alpha=None, beta=None,
               c0=None, split_ok=True):
    """One real SpMM pass: returns a device (m, n) array holding
    ``alpha * op(A) @ b + beta * c0`` (each epilogue term optional).

    ``split_ok=False`` (callers pass a host range check of b) disables
    the hi|lo b split and the Ozaki route, keeping f64 exact when the
    operand magnitudes are outside the f32 window.

    Path choice: the batched block product for BSR; otherwise the
    backend's measured crossovers pick the padded-row (ELL) gather
    kernel, the sorted-flat densify + dense product, or the COO
    gather/scatter kernel.  The accumulate epilogue runs on device —
    fused into the kernel program where the kernel supports it, as a
    follow-on device op otherwise (never a numpy post-pass; ref contract
    ``_sparse_dense.py:111-123``).
    """
    if (
        isinstance(A, formats.BSR)
        and not transpose
        and A.shape[0] % A.blocksize[0] == 0
    ):
        return _xla.bsr_spmm(
            a_data, A.block_row_indices(), A.indices, b_dev, m=A.shape[0],
            alpha=alpha, beta=beta, c0=c0,
        )

    m, k = A.shape
    if transpose:
        m, k = k, m
    n = int(b_dev.shape[1])
    nnz = int(a_data.reshape(-1).shape[0])

    if _prefer_ell(A, a_data, m, k, n, nnz, transpose):
        if getattr(config, "ell_binned", True):
            binned = A.ell_parts_binned(data=a_data)
            if binned is not None:
                segs, cols_flat, vals_flat, invpos = binned
                return _xla.ell_spmm_binned(
                    cols_flat, vals_flat, b_dev, invpos, segs=segs,
                    split_b=split_ok and b_dev.dtype == jnp.float64,
                    alpha=alpha, beta=beta, c0=c0,
                )
        ell = A.ell_parts(data=a_data)
        if ell is not None:
            cols_ell, vals_ell = ell
            nchunks = _ell_chunks(cols_ell.shape, n, a_data.dtype)
            c = _xla.ell_spmm(cols_ell, vals_ell, b_dev, nchunks=nchunks)
            c = c[:m] if c.shape[0] != m else c
            return _xla.axpby(c, alpha, beta, c0)

    if not jnp.iscomplexobj(a_data) and _xla._prefer_densify(
        m, k, n, nnz, a_data.dtype
    ):
        use_oz = (
            _xla._ozaki.enabled(a_data.dtype, k, m * k * n)
            and split_ok and _container_hilo_ok(A)
        )
        planes = (
            A.dense_planes(a_data, hilo=use_oz, with_indicator=False)
            if _seen_before(A) else None
        )
        if planes is not None:
            a_num, _ind, cm = planes
            # transpose flips which orientation the planes address
            a_cm_eff = bool(cm) != bool(transpose)
            if use_oz:
                sl = A.ozaki_slices(a_data, contract=0 if a_cm_eff else 1)
                if sl is not None:
                    a_num = sl
            return _xla.spmm_planes(
                a_num, b_dev, a_cm=a_cm_eff,
                alpha=alpha, beta=beta, c0=c0,
            )
        flat, vals, cm = A.sorted_flat_parts(a_data)
        a_cm = bool(cm) != bool(transpose)
        return _xla.spmm_densified_sorted(
            flat, vals, b_dev, m=m, k=k, a_cm=a_cm,
            use_ozaki=use_oz,
            alpha=alpha, beta=beta, c0=c0,
        )

    rows, cols, vals, m, k = coo_parts(A, data=a_data, transpose=transpose)
    return _xla.coo_spmm(
        rows, cols, vals, b_dev, m, k,
        chunk_elements=config.spmm_chunk_elements,
        densify_ok=False,
        alpha=1.0 if alpha is None else alpha,
        beta=0.0 if beta is None else beta,
        c0=c0,
    )


def _prefer_ell(A, a_data, m, k, n, nnz, transpose):
    """Gate the per-row padded (ELL) SpMM: CSR only (rows must be
    sorted), real dtypes, low density (gather traffic beats the dense
    operand's scatter+matmul), moderate n.  f64 stays EXACT on this
    path (elementwise f64, no emulated dot).  Forced on/off with
    config.ell_spmm_enabled = "always"/False (tests)."""
    from ..backend import spmm_crossovers

    mode = config.ell_spmm_enabled
    if not mode:
        return False
    if transpose or not isinstance(A, formats.CSR) or A.planar:
        return False
    if jnp.iscomplexobj(a_data):
        return False
    if mode == "always":
        return True
    if nnz == 0 or n > 512:
        return False
    density = nnz / max(m * k, 1)
    return (density <= spmm_crossovers()["ell_below"]
            and nnz >= (1 << 14))


def _ell_chunks(ell_shape, n, dtype, budget=1 << 31):
    """Row-chunk count keeping the gathered (m, rmax, n) intermediate
    under ~2 GB; chunk counts are powers of two dividing m_pad (a
    multiple of 256)."""
    m_pad, rmax = ell_shape
    bytes_total = m_pad * rmax * max(n, 1) * jnp.dtype(dtype).itemsize
    nchunks = 1
    while bytes_total // nchunks > budget and nchunks < 256:
        nchunks *= 2
    return nchunks


def _real_spmv(A, a_data, x_dev, transpose, alpha=None, beta=None,
               c0=None, split_ok=True):
    # split_ok accepted for signature parity with _real_spmm; both
    # SpMV kernels (per-row ELL gather, COO scatter) keep f64 exact.
    m, k = A.shape
    nnz = int(a_data.reshape(-1).shape[0])
    if _prefer_ell(A, a_data, m, k, 1, nnz, transpose):
        ell = A.ell_parts(data=a_data)
        if ell is not None:
            cols_ell, vals_ell = ell
            nchunks = _ell_chunks(cols_ell.shape, 1, a_data.dtype)
            y = _xla.ell_spmv(cols_ell, vals_ell, x_dev, nchunks=nchunks)
            y = y[:m] if y.shape[0] != m else y
            return _xla.axpby(y, alpha, beta, c0)
    rows, cols, vals, m, k = coo_parts(A, data=a_data, transpose=transpose)
    return _xla.coo_spmv(
        rows, cols, vals, x_dev, m=m,
        alpha=1.0 if alpha is None else alpha,
        beta=0.0 if beta is None else beta,
        y0=c0,
    )


def _bilinear_host(A, b_np, one_pass, out_dtype, alpha=1.0,
                   out=None, out_scalar=None, transpose=False):
    """Run a bilinear sparse-dense op with complex decomposition and
    accumulate semantics; returns a host numpy array (row-major)."""
    beta = 1.0 if out_scalar is None else out_scalar
    ar, ai = _a_parts(A)
    br, bi, b_planar = _dense_parts(np.asarray(b_np))
    is_complex_out = np.dtype(out_dtype).kind == "c"

    if not A.planar and not b_planar:
        # Native path (real everywhere, or backend with native complex).
        # alpha scaling and the out/out_scalar accumulate run ON DEVICE,
        # fused into the kernel program where supported — the result
        # makes exactly one device->host trip (ref contract
        # C := alpha*A*B + beta*C, ``_sparse_dense.py:111-123``).
        a_trivial = isinstance(alpha, (int, float)) and alpha == 1.0
        c0 = jnp.asarray(np.asarray(out)) if out is not None else None
        # Host-side range gate for the kernels' hi|lo b split (f64
        # only; trivially ok otherwise) — out-of-window magnitudes
        # route to the exact-f64 forms.
        split_ok = (
            np.dtype(np.asarray(b_np).dtype) != np.float64
            or _hilo_range_ok(b_np)
        )
        if not split_ok:
            formats._warn_f64_range(np.asarray(b_np))
        # br IS the (transfer-cache-validated) device upload of b from
        # _dense_parts above — a second bare jnp.asarray here was an
        # uncached duplicate transfer on every call (review r5
        # finding).
        res = one_pass(
            A, ar, br, transpose,
            alpha=None if a_trivial else alpha,
            beta=beta if c0 is not None else None,
            c0=c0, split_ok=split_ok,
        )
        return np.asarray(res).astype(out_dtype, copy=False)
    else:
        # Planar complex: four (or fewer) real passes.  The same b
        # range gate as the native path applies per CHANNEL (review r5
        # finding: this branch used to take the hi|lo split
        # unconditionally, saturating out-of-window complex planes).
        # Checked on the HOST operand (br/bi are device uploads).
        b_host = np.asarray(b_np)
        # Only DOUBLE-precision channels (f64 real / complex128) use
        # the hi|lo split; f32/complex64 planes ride natively and need
        # neither the scan nor the warning (review r5 finding: the
        # itemsize test misclassified complex64, itemsize 8).
        b_double = np.dtype(b_host.dtype) in (
            np.dtype(np.float64), np.dtype(np.complex128)
        )
        split_ok = (
            not b_double
            or _hilo_range_ok(b_host.real)
            and _hilo_range_ok(b_host.imag)
        )
        if not split_ok:
            formats._warn_f64_range(b_host)

        def one_pass(A_, d_, b_, t_, _op=one_pass, _ok=split_ok):
            return _op(A_, d_, b_, t_, split_ok=_ok)

        rr = one_pass(A, ar, br, transpose)
        re = rr
        im = None
        if ai is not None and bi is not None:
            re = rr - one_pass(A, ai, bi, transpose)
            im = one_pass(A, ar, bi, transpose) + one_pass(A, ai, br, transpose)
        elif ai is not None:
            im = one_pass(A, ai, br, transpose)
        elif bi is not None:
            im = one_pass(A, ar, bi, transpose)
        re_np = np.asarray(re) * alpha
        im_np = (np.asarray(im) * alpha) if im is not None else np.zeros_like(re_np)
        res = _combine_planar(re_np, im_np, out_dtype)

    if out is not None:
        res = res + np.asarray(beta, dtype=out_dtype) * np.asarray(out)
    return res


def spmm(A, b_np, out_dtype, alpha=1.0, out=None, out_scalar=None,
         transpose=False):
    """alpha * op(A) @ b + out_scalar * out -> host numpy (row-major)."""
    return _bilinear_host(
        A, b_np, _real_spmm, out_dtype, alpha=alpha, out=out,
        out_scalar=out_scalar, transpose=transpose,
    )


def spmv(A, x_np, out_dtype, alpha=1.0, out=None, out_scalar=None,
         transpose=False):
    return _bilinear_host(
        A, x_np, _real_spmv, out_dtype, alpha=alpha, out=out,
        out_scalar=out_scalar, transpose=transpose,
    )


# ---------------------------------------------------------------------------
# Dense GEMM
# ---------------------------------------------------------------------------


def _dense_hilo_ok(arr_np):
    """Host range check gating the Ozaki hi|lo route for dense f64
    operands (review r5 finding — every sparse hi|lo transport gates on
    the f32 window; the dense GEMM/SYRK paths must too)."""
    a = np.asarray(arr_np)
    if a.dtype == np.float64:
        return _hilo_range_ok(a)
    if np.iscomplexobj(a) and np.real(a).dtype == np.float64:
        return _hilo_range_ok(a.real) and _hilo_range_ok(a.imag)
    return True


def gemm(a_np, b_np, out_dtype, alpha=1.0, out=None, out_scalar=None):
    beta = 1.0 if out_scalar is None else out_scalar
    a_np, b_np = np.asarray(a_np), np.asarray(b_np)
    # Same representability warning the sparse paths emit: on a backend
    # without native f64, magnitudes outside the f32 exponent window
    # corrupt at the device boundary regardless of kernel.
    formats._warn_f64_range(a_np)
    formats._warn_f64_range(b_np)
    ar, ai, a_planar = _dense_parts(a_np)
    br, bi, b_planar = _dense_parts(b_np)
    hilo_ok = _dense_hilo_ok(a_np) and _dense_hilo_ok(b_np)

    if not a_planar and not b_planar:
        # alpha/beta/out accumulate fused into the device GEMM program
        # (cblas semantics C := alpha*AB + beta*C, ``_dense_dense.py``).
        # ar/br ARE the cached device uploads from _dense_parts; bare
        # jnp.asarray here was a duplicate uncached transfer per call.
        c0 = jnp.asarray(np.asarray(out)) if out is not None else None
        return np.asarray(
            _xla.gemm(ar, br, alpha=alpha,
                      beta=beta if c0 is not None else 0.0, c0=c0,
                      allow_hilo=hilo_ok)
        ).astype(out_dtype, copy=False)
    else:
        rr = _xla.gemm(ar, br, allow_hilo=hilo_ok)
        re, im = rr, None
        if ai is not None and bi is not None:
            re = rr - _xla.gemm(ai, bi, allow_hilo=hilo_ok)
            im = (_xla.gemm(ar, bi, allow_hilo=hilo_ok)
                  + _xla.gemm(ai, br, allow_hilo=hilo_ok))
        elif ai is not None:
            im = _xla.gemm(ai, br, allow_hilo=hilo_ok)
        elif bi is not None:
            im = _xla.gemm(ar, bi, allow_hilo=hilo_ok)
        re_np = np.asarray(re) * alpha
        im_np = (np.asarray(im) * alpha) if im is not None else np.zeros_like(re_np)
        res = _combine_planar(re_np, im_np, out_dtype)

    if out is not None:
        res = res + np.asarray(beta, dtype=out_dtype) * np.asarray(out)
    return res


# ---------------------------------------------------------------------------
# SpGEMM (sparse x sparse)
# ---------------------------------------------------------------------------


def _is_syrk_pair(A, B, a_data, b_data):
    """True when B is the zero-cost transpose view of A (same device
    buffers, transposed shape, CSR<->CSC): C = A @ A^T needs only one
    densify — the X @ X.T / gram fast path."""
    return (
        b_data is a_data
        and B.indices is A.indices
        and B.indptr is A.indptr
        and B.shape == (A.shape[1], A.shape[0])
        and not isinstance(A, formats.BSR)
        and type(B) is not type(A)
    )


def _seen_before(M):
    """Pre-increment use counter: False on a container's FIRST pass
    through a plane-cache gate, True after.  One-shot calls therefore
    run the transient (round-3) kernels — no dense copy is pinned on
    the container for a matrix that is never reused — and the
    inspector-executor caches engage from the second use on."""
    c = getattr(M, "_plane_uses", 0)
    M._plane_uses = c + 1
    return c > 0


def _planes_for(A, a_data, B, b_data, use_oz):
    """Cached-plane operands for the structural programs, or None.

    Returns (a_num, ind_a, a_cm, b_num, ind_b, b_cm, syrk) — the
    inspector-executor steady-state inputs (``formats.dense_planes``) —
    when every needed operand is on its second-or-later use AND fits
    the plane-cache budget; all-or-nothing so each program has exactly
    one compiled form per shape."""
    syrk = _is_syrk_pair(A, B, a_data, b_data)
    seen_a = _seen_before(A)
    seen_b = True if syrk else _seen_before(B)
    if not (seen_a and seen_b):
        return None
    pa = A.dense_planes(a_data, hilo=use_oz)
    if pa is None:
        return None
    a_num, ind_a, a_cm = pa
    if use_oz:
        sl = A.ozaki_slices(a_data, contract=0 if a_cm else 1)
        if sl is not None:
            a_num = sl  # deepest cache level: pre-extracted slices
    if syrk:
        return a_num, ind_a, a_cm, None, None, False, True
    pb = B.dense_planes(b_data, hilo=use_oz)
    if pb is None:
        return None
    b_num, ind_b, b_cm = pb
    if use_oz:
        sl = B.ozaki_slices(b_data, contract=1 if b_cm else 0)
        if sl is not None:
            b_num = sl
    return a_num, ind_a, a_cm, b_num, ind_b, b_cm, False


def _planar_planes(M, use_oz, role_a=True):
    """Cached channel planes for the planar-complex structural path:
    ((re planes), (im planes), indicator, col_major) per data buffer,
    or None (budget / cache off).  Same inspector-executor rationale as
    ``formats.dense_planes``; both channels share one flat index and
    one indicator.

    ``role_a`` picks the contraction axis the cached Ozaki slices are
    extracted for: the LHS contracts axis (0 if cm else 1), the RHS
    axis (1 if cm else 0) — the slice exponents live on the
    non-contract axis, so the roles are NOT interchangeable (a wrong
    axis produced mismatched exponent shapes)."""
    if not getattr(config, "spgemm_plane_cache", True):
        return None
    m, n = M.shape
    ch_bytes = 8 if use_oz else np.dtype(
        np.float32 if np.dtype(M.dtype) == np.complex64 else np.float64
    ).itemsize
    if m * n * (2 * ch_bytes + 2) > getattr(
        config, "spgemm_plane_cache_bytes", 1 << 28
    ):
        return None
    cache = getattr(M, "_planar_plane_cache", None)
    if cache is None or cache[0] is not M.data:
        cache = (M.data, {})  # per-role entries (a container can be
        M._planar_plane_cache = cache  # LHS in one product, RHS in another)
    entry = cache[1].get((use_oz, role_a))
    if entry is not None:
        return entry
    ch_r, ch_i = _value_channels(M, 2)
    flat, ch_r_s, cm = M.sorted_flat_parts(ch_r)
    _, ch_i_s, _ = M.sorted_flat_parts(ch_i)
    shape = (n, m) if cm else (m, n)
    a, b, ind = _xla.dense_planes_planar_prep(
        flat, ch_r_s, ch_i_s, shape=shape, hilo=use_oz
    )
    if use_oz:
        # Deepest layer: cache each channel's pre-extracted Ozaki
        # slices when they fit the slice budget (exact — slices are a
        # lossless representation with per-row exponents).
        contract = (0 if cm else 1) if role_a else (1 if cm else 0)
        t, D, _dj = _xla._ozaki.plan(shape[contract])
        if (
            t >= 1
            and 2 * D * m * n * 2 <= getattr(
                config, "ozaki_slice_cache_bytes", 1 << 28
            )
        ):
            a = _xla._ozaki.extract_slices_jit(
                a[0], a[1], shape=shape, contract=contract
            )
            b = _xla._ozaki.extract_slices_jit(
                b[0], b[1], shape=shape, contract=contract
            )
    out = ((a, b), ind, cm)
    cache[1][(use_oz, role_a)] = out
    return out


def _spgemm_dense_real(A, a_data, B, b_data, with_count=False,
                       triangular=False):
    m, k = A.shape
    n = B.shape[1]
    use_oz = (
        _xla._ozaki.enabled(a_data.dtype, k, m * k * n)
        and _container_hilo_ok(A) and _container_hilo_ok(B)
    )
    planes = _planes_for(A, a_data, B, b_data, use_oz)
    if planes is not None:
        a_num, _, a_cm, b_num, _, b_cm, syrk = planes
        return _xla.spgemm_numeric_planes(
            a_num, b_num, a_cm=a_cm, b_cm=b_cm, syrk=syrk,
            with_count=with_count, triangular=triangular,
        )
    a_flat, a_vals, a_cm = A.sorted_flat_parts(a_data)
    if _is_syrk_pair(A, B, a_data, b_data):
        return _xla.spgemm_numeric_sorted(
            a_flat, a_vals, None, None, m=m, k=k, n=n,
            a_cm=a_cm, syrk=True, with_count=with_count,
            use_ozaki=use_oz, triangular=triangular,
        )
    b_flat, b_vals, b_cm = B.sorted_flat_parts(b_data)
    return _xla.spgemm_numeric_sorted(
        a_flat, a_vals, b_flat, b_vals, m=m, k=k, n=n,
        a_cm=a_cm, b_cm=b_cm, with_count=with_count,
        use_ozaki=use_oz, triangular=triangular,
    )


def spgemm_dense(A, B, out_dtype, out=None, out_scalar=None):
    """A @ B -> dense host numpy (spmmd analog)."""
    beta = 1.0 if out_scalar is None else out_scalar
    ar, ai = _a_parts(A)
    br, bi = _a_parts(B)

    if not A.planar and not B.planar:
        res = np.asarray(_spgemm_dense_real(A, ar, B, br)).astype(
            out_dtype, copy=False
        )
    else:
        rr = _spgemm_dense_real(A, ar, B, br)
        re, im = rr, None
        if ai is not None and bi is not None:
            re = rr - _spgemm_dense_real(A, ai, B, bi)
            im = _spgemm_dense_real(A, ar, B, bi) + _spgemm_dense_real(
                A, ai, B, br
            )
        elif ai is not None:
            im = _spgemm_dense_real(A, ai, B, br)
        elif bi is not None:
            im = _spgemm_dense_real(A, ar, B, bi)
        re_np = np.asarray(re)
        im_np = np.asarray(im) if im is not None else np.zeros_like(re_np)
        res = _combine_planar(re_np, im_np, out_dtype)

    if out is not None:
        res = res + np.asarray(beta, dtype=out_dtype) * np.asarray(out)
    return res


def _host_extract(dense_np, out_dtype, triangular, mask=None):
    """Numpy compaction of a (small) dense product — cheaper than extra
    device dispatches when the dense result fits a single transfer.

    ``mask`` (the structural pattern from :func:`_xla._pattern_matmul`)
    selects the stored entries; without it the numeric-nonzero pattern
    is used (which drops exactly-cancelled entries)."""
    if mask is None:
        mask = dense_np != 0
    if triangular:
        mask = np.triu(mask)
    counts = mask.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(
        config.index_dtype
    )
    rows, cols = np.nonzero(mask)
    return (
        np.ascontiguousarray(dense_np[rows, cols]).astype(
            out_dtype, copy=False
        ),
        cols.astype(config.index_dtype),
        indptr,
    )


# Dense products at or below this byte size are pulled to the host in one
# transfer and compacted with numpy; larger products compact on device.
_HOST_EXTRACT_BYTES = 16 << 20

# Above this dense-intermediate size the numeric phase runs in row
# blocks of A so the O(m*n) buffer never materializes at full height.
_BLOCKED_SPGEMM_BYTES = 2 << 30
_SPGEMM_ROW_BLOCK = 4096


def _blocked_spgemm_arrays(A, B, out_dtype, triangular):
    """Row-blocked structural SpGEMM: for each block of A's rows, run
    the fused numeric-plus-pattern phase against (densified) B and
    compact, concatenating CSR arrays on the host.  Bounds device
    memory at row_block x n per block; output pattern is structural.

    The block body is the dense formulation
    (:func:`_xla.spgemm_block_structural_mxu`): sorted-set densify of
    the A row block + one ``dot_general`` (Ozaki bf16 slices for f64)
    + bf16 pattern matmul — the same shape as the one-shot structural
    path, which measured ~5x faster than the scatter body this route
    used through round 2."""
    A = A if isinstance(A, formats.CSR) else _to_csr(A)
    m, k = A.shape
    n = B.shape[1]
    indptr_np = np.asarray(A.indptr)

    use_oz = (
        _xla._ozaki.enabled(
            A.data.dtype, k, min(m, _SPGEMM_ROW_BLOCK) * k * n
        )
        and _container_hilo_ok(A) and _container_hilo_ok(B)
    )
    # One dispatch for the whole B prep (numeric densify, hi/lo split
    # for the Ozaki path, bf16 indicator) — cached per B data buffer
    # (round 4 inspector-executor; the blocked path re-ran these
    # scatters for every huge product on the same operand).
    bcache = getattr(B, "_blocked_bprep_cache", None)
    if bcache is not None and bcache[0] is B.data and bcache[1] == use_oz:
        b_num, b_ind = bcache[2]
    else:
        b_rows, b_cols, b_vals, _, _ = coo_parts(B)
        *b_num, b_ind = _xla.densify_with_indicator(
            b_rows, b_cols, b_vals, (k, n), hilo=use_oz
        )
        b_num = tuple(b_num)
        prep_bytes = k * n * ((8 if use_oz else
                               np.dtype(B.dtype).itemsize) + 2)
        if (
            getattr(config, "spgemm_plane_cache", True)
            and prep_bytes <= getattr(
                config, "spgemm_plane_cache_bytes", 1 << 28
            )
        ):
            B._blocked_bprep_cache = (B.data, use_oz, (b_num, b_ind))

    block = _SPGEMM_ROW_BLOCK
    nblocks = -(-m // block)
    # Pad per-block nnz to the max so every block compiles to one shape.
    nnz_pad = 1
    for i in range(nblocks):
        lo, hi = i * block, min((i + 1) * block, m)
        nnz_pad = max(nnz_pad, int(indptr_np[hi] - indptr_np[lo]))

    all_vals, all_cols, all_counts = [], [], []
    rows_full = A.row_indices()
    fdt = jnp.int64 if block * k >= (1 << 31) else jnp.int32
    pending = []

    def _drain():
        # Deferred readbacks: blocks in a wave dispatch back-to-back on
        # device and are only pulled afterwards, hiding the round-trip.
        for lo, hi, dense_blk, mask_blk in pending:
            dense_np = np.asarray(dense_blk)[: hi - lo]
            mask = np.asarray(mask_blk)[: hi - lo]
            r, c = np.nonzero(mask)
            all_vals.append(dense_np[r, c])
            all_cols.append(c)
            all_counts.append(mask.sum(axis=1))
        pending.clear()

    for i in range(nblocks):
        lo, hi = i * block, min((i + 1) * block, m)
        plo, phi = int(indptr_np[lo]), int(indptr_np[hi])
        # Local flat index (ascending for a CSR row slice) feeds the
        # sorted-set densify.
        flat_blk = (
            (rows_full[plo:phi] - lo).astype(fdt) * k
            + A.indices[plo:phi].astype(fdt)
        )
        vals_blk = A.data[plo:phi]
        pad = nnz_pad - (phi - plo)
        if pad:
            flat_blk = jnp.concatenate(
                [flat_blk, jnp.full((pad,), block * k, fdt)]
            )
            vals_blk = jnp.concatenate(
                [vals_blk, jnp.zeros((pad,), vals_blk.dtype)]
            )
        dense_blk, mask_blk, _cnt = _xla.spgemm_block_structural_mxu(
            flat_blk, vals_blk, b_num, b_ind,
            jnp.asarray(lo, jnp.int32),
            mb=block, k=k, use_ozaki=use_oz, triangular=triangular,
        )
        pending.append((lo, hi, dense_blk, mask_blk))
        if len(pending) >= 4:  # bound device memory to 4 row panels
            _drain()
    _drain()

    vals = np.concatenate(all_vals).astype(out_dtype, copy=False)
    cols = np.concatenate(all_cols).astype(config.index_dtype)
    counts = np.concatenate(all_counts)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(
        config.index_dtype
    )
    return vals, cols, indptr


def _to_csr(container):
    from ..interface import convert_container_to_csr

    return convert_container_to_csr(container)


# ---------------------------------------------------------------------------
# ESC SpGEMM driver (true sparse output, bounded memory)
# ---------------------------------------------------------------------------


def _value_channels(container, nchan):
    """Container data -> tuple of real device channels.

    nchan=1: (data,).  nchan=2: (re, im) — planar storage splits are
    free; native complex splits on device; a real operand gets a zero
    imaginary channel.
    """
    if nchan == 1:
        return (container.data,)
    if container.planar:
        return (container.data[0], container.data[1])
    if np.dtype(container.dtype).kind == "c":
        return (jnp.real(container.data), jnp.imag(container.data))
    return (container.data, jnp.zeros_like(container.data))


def _esc_perm_sort(real_dtype, nchan):
    """Sort (key, iota) + per-channel gathers instead of co-sorting
    wide payloads.  ``auto`` resolves to co-sort (random multi-million
    element gathers cost more than the extra sort operands); the config
    hook pins either form."""
    mode = getattr(config, "spgemm_esc_perm_sort", "auto")
    if mode in (True, "always", "1"):
        return True
    return False


def _pow2_bucket(x, lo=1 << 12):
    b = lo
    while b < x:
        b <<= 1
    return b


class _EscPatternStale(Exception):
    """Raised when an ESC pattern-cache hit fails its in-band count
    validation; the caller re-runs with the entry dropped."""


def spgemm_esc_arrays(A, B, out_dtype, triangular=False):
    """Count-validated wrapper of :func:`_spgemm_esc_arrays_impl` —
    a stale structural-pattern entry (cannot happen under the
    monotone-token keying, but validated in-band anyway) triggers one
    cold re-run."""
    try:
        return _spgemm_esc_arrays_impl(A, B, out_dtype, triangular)
    except _EscPatternStale:
        return _spgemm_esc_arrays_impl(A, B, out_dtype, triangular)


def _spgemm_esc_arrays_impl(A, B, out_dtype, triangular=False):
    """A @ B -> (data, indices, indptr) host CSR via the row-blocked
    expand-sort-compress kernel (:func:`_xla.esc_spgemm_block`).

    This is the scaling path of ``mkl_sparse_spmm``'s any-size sparse
    output (``/root/reference/sparse_dot_mkl/_sparse_sparse.py:21-44``):
    device memory is bounded by the per-block expansion budget, never by
    m x n, and the output pattern is structural (cancelled entries are
    kept as explicit zeros, like MKL/scipy).

    Adaptive (round 3): when densified B fits the device budget the
    expand-sort-compress machinery is the WRONG algorithm — a block's
    expansion (one slot per scalar product) can exceed its output a
    hundredfold on dense-ish operands, and the headline workload
    measured 116x slower than MKL through it in round 2.  Real-dtype
    products whose row-panel and densified-B both fit route to the
    dense row-blocked body instead (same structural output, same memory
    bound per block); ``config.spgemm_esc_force_sort`` pins the sort
    kernel (tests / the truly-sparse regime's benchmark).
    """
    A = A if isinstance(A, formats.CSR) else _to_csr(A)
    B = B if isinstance(B, formats.CSR) else _to_csr(B)
    m, k = A.shape
    n = B.shape[1]
    nchan = 2 if np.dtype(out_dtype).kind == "c" else 1

    if not getattr(config, "spgemm_esc_force_sort", False) and nchan == 1:
        itemsize = np.dtype(out_dtype).itemsize
        dense_ok = (
            k * n * itemsize <= _BLOCKED_SPGEMM_BYTES
            and m * k * itemsize <= _BLOCKED_SPGEMM_BYTES
            and n * _SPGEMM_ROW_BLOCK * itemsize <= (512 << 20)
            and k * _SPGEMM_ROW_BLOCK * itemsize <= (512 << 20)
        )
        if dense_ok:
            # Same ladder as the default path: small products fuse
            # numeric+pattern+count into ONE dispatch, medium ones
            # extract on device, huge ones run row-blocked — all
            # structurally exact, all far faster than expanding
            # dense-ish operands through the sort kernel.
            return _spgemm_routed(A, B, out_dtype, triangular)
    real_dtype = np.dtype(out_dtype) if nchan == 1 else (
        np.float32 if np.dtype(out_dtype) == np.complex64 else np.float64
    )

    budget = int(getattr(config, "spgemm_esc_block_elements", 1 << 22))
    # Keys are local_row * n + col; int32 keys sort fastest, but when n
    # is so wide that int32 would cap blocks at a few thousand rows
    # (hundreds of extra dispatches), pay for int64 keys instead.
    max_rows_i32 = max(1, ((1 << 31) - 1) // max(n, 1) - 1)
    if max_rows_i32 >= (1 << 16):
        row_cap, use_key64 = max_rows_i32, False
    else:
        row_cap, use_key64 = (1 << 22), True

    # Host-side planning (expansion lengths, block boundaries, per-block
    # column-sort permutations) depends only on the operand STRUCTURES
    # and the budget — cached per structure-token pair (the 1M x 1M
    # profile spent ~1.3 s/call re-planning in Python).
    plan_key = (_structure_token(A), _structure_token(B), budget,
                row_cap)
    plan = _esc_plan_cache.get(plan_key)
    _t_plan = time.perf_counter()
    if plan is None:
        a_indptr_np = np.asarray(A.indptr).astype(np.int64)
        a_cols_np = np.asarray(A.indices).astype(np.int64)
        b_indptr_np = np.asarray(B.indptr).astype(np.int64)
        bstart = b_indptr_np[a_cols_np]
        ext = b_indptr_np[a_cols_np + 1] - bstart
        ext_cum = np.concatenate([[0], np.cumsum(ext)])
        row_ext_cum = ext_cum[a_indptr_np]  # (m+1,) cumulative per row
        row_nnz = a_indptr_np[1:] - a_indptr_np[:-1]
        # Vectorized block boundaries: one searchsorted per block (the
        # per-row Python grow-loop cost 467 ms alone at 1M rows).
        # NOTE a pipelined multi-block flush (read block i while block
        # i+1 computes) was tried for the 1M x 1M workload and made it
        # WORSE (2.7 -> 4.6 s): the value-read slice programs enqueue
        # behind the next kernel on the in-order device queue, so reads
        # serialize on kernels instead of overlapping.  The winning
        # lever is the structural pattern cache below (steady state
        # reads values only).
        blocks = []
        lo = 0
        while lo < m:
            target = row_ext_cum[lo] + budget
            hi = int(np.searchsorted(row_ext_cum, target,
                                     side="right")) - 1
            hi = min(max(hi, lo + 1), m, lo + row_cap)
            blocks.append((lo, hi))
            lo = hi
        perms = {}
        for lo, hi in blocks:
            plo, phi = int(a_indptr_np[lo]), int(a_indptr_np[hi])
            if phi > plo:
                perms[lo] = np.argsort(
                    a_cols_np[plo:phi], kind="stable"
                ).astype(np.int32)
        # The trailing dict caches per-block STRUCTURE-ONLY device
        # arrays (perm, padded rows/cols, offsets, packed-A static
        # columns) so steady-state calls upload nothing but values.
        plan = (a_indptr_np, a_cols_np, b_indptr_np, bstart, ext,
                row_ext_cum, row_nnz, blocks, perms, {})
        if len(_esc_plan_cache) > 4:
            _esc_plan_cache.clear()
        _esc_plan_cache[plan_key] = plan
    (a_indptr_np, a_cols_np, b_indptr_np, bstart, ext, row_ext_cum,
     row_nnz, blocks, perms, dev_cache) = plan

    rows_full = A.row_indices()
    a_chans = _value_channels(A, nchan)
    b_chans = jnp.stack(_value_channels(B, nchan))
    b_indptr_dev = jnp.asarray(b_indptr_np.astype(np.int32)
                               if B.indices.size < (1 << 31)
                               else b_indptr_np)
    b_indices_dev = B.indices

    # Windowed-gather kernel (r3): per-nonzero fields packed into one
    # f32 row so the expansion is TWO gathers instead of seven — a
    # measured 15x per-gather win.  Integer fields must be f32-exact
    # (< 2^24); wider workloads keep the scalar-gather kernel.
    chan64 = np.dtype(real_dtype).itemsize == 8
    packed_ok = (
        getattr(config, "spgemm_esc_packed", True)
        and n < (1 << 24)
        and B.indices.size < (1 << 24)
        # The packed kernel's f64 channels travel as hi|lo f32 pairs:
        # magnitudes outside the f32 window route to the scalar-gather
        # kernel, which keeps values in native f64 (exact).
        and (
            not chan64
            or (_container_hilo_ok(A) and _container_hilo_ok(B))
        )
    )
    b_pack = (
        _xla.esc_pack_b(b_indices_dev, b_chans, chan64=chan64)
        if packed_ok else None
    )

    all_vals, all_cols = [], []
    counts = np.zeros(m, dtype=np.int64)
    prof = {"plan_ms": (time.perf_counter() - _t_plan) * 1e3,
            "prep_dispatch_ms": 0.0,
            "kernel_wait_ms": 0.0, "readback_ms": 0.0,
            "assembly_ms": 0.0, "readback_bytes": 0, "blocks": 0,
            "pattern_cached": False}

    # Structural pattern cache: the output pattern (per-block counts,
    # final indices/indptr) depends ONLY on the operand structures, so
    # steady-state repeats skip the key readback entirely and read
    # VALUES only — 32 MB instead of 54 MB on the 1M x 1M product.
    # Every hit is
    # validated in-band by the per-block count read; a mismatch (cache
    # poisoning — "cannot happen" by the monotone-token argument, same
    # as _spgemm_nnz_cache) drops the entry and re-runs cold.
    pat_key = (plan_key, triangular, nchan)
    pat = _esc_pattern_cache.get(pat_key)
    use_pat = pat is not None
    new_cnts = {}
    prof["pattern_cached"] = bool(use_pat)

    # Sort-free steady state (round 5): per-block sidx/head_src device
    # structures let repeats replace the block sort — the dominant
    # kernel phase at 1M x 1M — with windowed gathers
    # (``_xla.esc_spgemm_block_cached``).  The cached kernel moves f64
    # PRODUCTS as hi|lo pairs, so it additionally gates on the product
    # range (operand gating alone allows products up to ~(3.4e38)^2).
    pat_dev = pat.get("dev") if use_pat else None
    new_dev = {}
    sort_free_on = bool(getattr(config, "spgemm_esc_sort_free", True))
    if packed_ok and sort_free_on and chan64:
        _dup = int(row_nnz.max()) if row_nnz.size else 1
        cached_k_ok = _product_range_ok(A, B, _dup, nchan=nchan)
    else:
        cached_k_ok = packed_ok and sort_free_on
    # A-priori gates so the cold extraction dispatch is never wasted
    # (review r5 finding): skip it when the output can only exceed the
    # pattern-store cap (e_total bounds the output nnz) or the
    # structure budget; the running byte estimate gates per block.
    e_total_bound = int(row_ext_cum[-1]) if len(row_ext_cum) else 0
    if cached_k_ok and e_total_bound * 8 > (256 << 20):
        cached_k_ok = False
    _struct_budget = int(getattr(
        config, "spgemm_esc_struct_cache_bytes", 1 << 28
    ))
    _est_dev_bytes = [0]
    prof["sort_free"] = bool(use_pat and pat_dev and cached_k_ok)

    # Deferred-sync machinery: block kernels are dispatched in waves of
    # ``_ESC_WAVE`` and their counts read back TOGETHER (one stacked
    # scalar transfer per wave instead of one 25 ms round-trip per
    # block — the round-2 profile's single biggest ESC cost).
    _ESC_WAVE = 8
    wave = []

    def _flush_wave():
        if not wave:
            return
        # The stacked count read is the wave's sync point: its wall
        # time is (remaining) kernel execution, and everything after
        # is link transfer + host assembly (esc_last_profile).
        t0 = time.perf_counter()
        wave_counts = np.asarray(jnp.stack([w[-1] for w in wave]))
        prof["kernel_wait_ms"] += (time.perf_counter() - t0) * 1e3
        batch = list(wave)
        wave.clear()
        for (blo, bhi, bmb, be_pad, bkey64, obuf, ovals, _), cnt in zip(
            batch, wave_counts
        ):
            cnt = int(cnt)
            new_cnts[blo] = cnt
            if use_pat and pat["cnts"].get(blo, 0) != cnt:
                _esc_pattern_cache.pop(pat_key, None)
                raise _EscPatternStale()  # re-run cold
            if not cnt:
                continue
            take = min(be_pad, _pow2_bucket(cnt, lo=1 << 14))
            if use_pat:
                # Pattern-cache hit (count-validated): VALUES ONLY —
                # the keys/cols/indptr come from the cache.
                t0 = time.perf_counter()
                vraw = np.asarray(ovals[0][:take])
                viraw = (np.asarray(ovals[1][:take])
                         if nchan == 2 else None)
                prof["readback_ms"] += (time.perf_counter() - t0) * 1e3
                prof["readback_bytes"] += vraw.nbytes + (
                    viraw.nbytes if viraw is not None else 0
                )
                vals_np = (vraw[:cnt] if nchan == 1
                           else vraw[:cnt] + 1j * viraw[:cnt])
                all_vals.append(vals_np.astype(out_dtype, copy=False))
                continue
            # ONE i32 read either way (layout doc at
            # _xla._esc_sort_compress):
            # * key32 blocks: raw i32 keys — host splits rows/cols and
            #   bincounts over the live entries (half the r3 key bytes).
            # * key64 blocks: [per-row histogram (mb) | columns].
            t0 = time.perf_counter()
            if bkey64:
                buf_np = np.asarray(obuf[: bmb + take])
            else:
                buf_np = np.asarray(obuf[:take])
            if nchan == 1:
                vraw = np.asarray(ovals[0][:take])
                viraw = None
            else:
                vraw = np.asarray(ovals[0][:take])
                viraw = np.asarray(ovals[1][:take])
            prof["readback_ms"] += (time.perf_counter() - t0) * 1e3
            prof["readback_bytes"] += buf_np.nbytes + vraw.nbytes + (
                viraw.nbytes if viraw is not None else 0
            )
            t0 = time.perf_counter()
            if bkey64:
                cols_np = buf_np[bmb: bmb + cnt]
                counts[blo:bhi] = buf_np[: bhi - blo]
            else:
                keys_np = buf_np[:cnt].astype(np.int64)
                rows_np = keys_np // n
                cols_np = keys_np - rows_np * n
                counts[blo:bhi] = np.bincount(
                    rows_np, minlength=bmb
                )[: bhi - blo]
            if nchan == 1:
                vals_np = vraw[:cnt]
            else:
                vals_np = vraw[:cnt] + 1j * viraw[:cnt]
            all_vals.append(vals_np.astype(out_dtype, copy=False))
            all_cols.append(cols_np)
            prof["assembly_ms"] += (time.perf_counter() - t0) * 1e3

    for lo, hi in blocks:
        e_blk = int(row_ext_cum[hi] - row_ext_cum[lo])
        mb = hi - lo
        plo, phi = int(a_indptr_np[lo]), int(a_indptr_np[hi])
        nnz_blk = phi - plo

        if e_blk == 0 or nnz_blk == 0:
            continue
        prof["blocks"] += 1
        t_prep = time.perf_counter()

        mb_bucket = _pow2_bucket(mb, lo=256)
        e_pad = _pow2_bucket(e_blk)
        nnz_pad = _pow2_bucket(nnz_blk, lo=1 << 10)
        key64 = use_key64 or (mb_bucket + 1) * n >= (1 << 31)
        max_dup = int(row_nnz[lo:hi].max())
        dup_passes = max(0, int(np.ceil(np.log2(max(max_dup, 1)))))
        blk_packed = (
            packed_ok and mb_bucket < (1 << 24) and e_pad < (1 << 24)
        )
        pad = nnz_pad - nnz_blk

        # Structure-only device arrays, built ONCE per cached plan:
        # column-sort permutation (see the locality note below), padded
        # local rows/cols, expansion offsets, and the packed-A static
        # columns.  Steady-state calls upload NOTHING per block.
        dev_blk = dev_cache.get(lo)
        if dev_blk is not None and dev_blk[0] != blk_packed:
            dev_blk = None  # config flipped the packed route: rebuild
        if dev_blk is None:
            # Column-sorted A-nonzeros (cached host argsort): the
            # expansion then walks B's index/value arrays in ASCENDING
            # address order (contiguous runs per B row, runs themselves
            # sorted), so the 4M-element b_indices/b_data gathers — the
            # block body's dominant HBM cost — hit quasi-sequentially
            # instead of jumping rows per A-nonzero.  The kernel's sort
            # is order-agnostic, so this is free correctness-wise.
            perm_np = perms[lo]
            perm = jnp.asarray(perm_np)
            rows_blk = (rows_full[plo:phi].astype(jnp.int32) - lo)[perm]
            if pad:
                rows_blk = jnp.concatenate(
                    [rows_blk, jnp.full((pad,), mb_bucket, jnp.int32)]
                )
            ext_blk = ext[plo:phi][perm_np]
            offsets_np = np.concatenate(
                [[0], np.cumsum(ext_blk),
                 np.full(nnz_pad - nnz_blk, e_blk, np.int64)]
            ).astype(np.int32)
            offsets_dev = jnp.asarray(offsets_np)
            if blk_packed:
                bstart_blk = np.zeros(nnz_pad, np.int32)
                bstart_blk[:nnz_blk] = bstart[plo:phi][perm_np]
                # Static [local_row, bstart, offset] columns of the
                # packed-A rows (esc_pack_a with no value channels).
                apack_static = _xla.esc_pack_a(
                    rows_blk, jnp.asarray(bstart_blk),
                    offsets_dev[:nnz_pad], (), chan64=chan64,
                )
                cols_blk = None
            else:
                apack_static = None
                cols_blk = A.indices[plo:phi].astype(jnp.int32)[perm]
                if pad:
                    cols_blk = jnp.concatenate(
                        [cols_blk, jnp.zeros((pad,), jnp.int32)]
                    )
            dev_blk = (blk_packed, perm, rows_blk, offsets_dev,
                       apack_static, cols_blk)
            dev_cache[lo] = dev_blk
        (_, perm, rows_blk, offsets_dev, apack_static,
         cols_blk) = dev_blk

        # Value channels: the only per-call device prep.
        chans_blk = [c[plo:phi][perm] for c in a_chans]
        if pad:
            chans_blk = [
                jnp.concatenate([c, jnp.zeros((pad,), c.dtype)])
                for c in chans_blk
            ]

        if blk_packed:
            vals_pack = _xla.esc_pack_a_vals(
                tuple(chans_blk), chan64=chan64
            )
            a_pack = jnp.concatenate([apack_static, vals_pack], axis=1)
            prof["prep_dispatch_ms"] += (
                (time.perf_counter() - t_prep) * 1e3
            )
            t_prep = time.perf_counter()
            struct = (
                pat_dev.get(lo)
                if (pat_dev is not None and cached_k_ok) else None
            )
            if struct is not None:
                # Sort-free steady state: value movement only, from
                # the cached sorted-order permutation + head gather.
                sidx_d, hs_d = struct
                out = (None,) + _xla.esc_spgemm_block_cached(
                    a_pack, offsets_dev,
                    jnp.asarray(e_blk, jnp.int32), b_pack,
                    jnp.asarray(lo, jnp.int32), sidx_d, hs_d,
                    e_pad=e_pad, mb=mb_bucket, n=n, nchan=nchan,
                    chan64=chan64, dup_passes=dup_passes,
                    triangular=triangular,
                )
            else:
                out = _xla.esc_spgemm_block_packed(
                    a_pack, offsets_dev,
                    jnp.asarray(e_blk, jnp.int32), b_pack,
                    jnp.asarray(lo, jnp.int32),
                    e_pad=e_pad, mb=mb_bucket, n=n, nchan=nchan,
                    chan64=chan64, key64=key64, dup_passes=dup_passes,
                    triangular=triangular,
                    perm_sort=_esc_perm_sort(real_dtype, nchan),
                )
                if (
                    not use_pat and cached_k_ok
                    and _est_dev_bytes[0] + e_pad * 8 <= _struct_budget
                ):
                    _est_dev_bytes[0] += e_pad * 8
                    # One-time structure extraction for future
                    # sort-free repeats (stored with the pattern).
                    sidx_d, hs_full, _c = (
                        _xla.esc_extract_structure_packed(
                            a_pack, offsets_dev,
                            jnp.asarray(e_blk, jnp.int32), b_pack,
                            jnp.asarray(lo, jnp.int32),
                            e_pad=e_pad, mb=mb_bucket, n=n,
                            nchan=nchan, chan64=chan64, key64=key64,
                            triangular=triangular,
                        )
                    )
                    new_dev[lo] = (sidx_d, hs_full)
        else:
            a_vals_blk = jnp.stack(chans_blk)
            prof["prep_dispatch_ms"] += (
                (time.perf_counter() - t_prep) * 1e3
            )
            t_prep = time.perf_counter()
            out = _xla.esc_spgemm_block(
                rows_blk, cols_blk, a_vals_blk, offsets_dev,
                jnp.asarray(e_blk, jnp.int32),
                b_indptr_dev, b_indices_dev, b_chans,
                jnp.asarray(lo, jnp.int32),
                e_pad=e_pad, mb=mb_bucket, n=n, nchan=nchan,
                key64=key64, dup_passes=dup_passes,
                triangular=triangular,
                perm_sort=_esc_perm_sort(real_dtype, nchan),
            )
        prof["prep_dispatch_ms"] += (time.perf_counter() - t_prep) * 1e3
        obuf, ovals, count = out[0], out[1:-1], out[-1]
        wave.append((lo, hi, mb_bucket, e_pad, key64, obuf, ovals,
                     count))
        if len(wave) >= _ESC_WAVE:
            _flush_wave()
    _flush_wave()

    t0 = time.perf_counter()
    if not all_vals:
        esc_last_profile.clear()
        esc_last_profile.update(prof)
        return (
            np.zeros(0, dtype=out_dtype),
            np.zeros(0, dtype=config.index_dtype),
            np.zeros(m + 1, dtype=config.index_dtype),
        )
    data = np.concatenate(all_vals)
    if use_pat:
        # Copies, not references: callers hand these to scipy
        # containers whose in-place ops (sort_indices, etc.) would
        # otherwise mutate the cache.
        indices = pat["indices"].copy()
        indptr = pat["indptr"].copy()
    else:
        indices = np.concatenate(all_cols).astype(config.index_dtype)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(
            config.index_dtype
        )
        if indices.nbytes + indptr.nbytes <= (256 << 20):
            if len(_esc_pattern_cache) > 2:
                _esc_pattern_cache.clear()
            # Sort-free structures: slice each block's head gather to
            # its (now known) count bucket so the steady-state output
            # buffers match the flush's read size; budget-gated in
            # device bytes.
            dev_store = {}
            dev_bytes = 0
            for blo2, (sidx_d, hs_full) in new_dev.items():
                cnt2 = int(new_cnts.get(blo2, 0))
                if cnt2 <= 0:
                    continue
                take2 = min(
                    int(hs_full.shape[0]),
                    _pow2_bucket(cnt2, lo=1 << 14),
                )
                dev_store[blo2] = (sidx_d, hs_full[:take2])
                dev_bytes += (int(sidx_d.shape[0]) + take2) * 4
            entry = {
                "cnts": dict(new_cnts),
                "indices": indices.copy(),
                "indptr": indptr.copy(),
            }
            if dev_store and dev_bytes <= int(getattr(
                config, "spgemm_esc_struct_cache_bytes", 1 << 28
            )):
                entry["dev"] = dev_store
            _esc_pattern_cache[pat_key] = entry
    prof["assembly_ms"] += (time.perf_counter() - t0) * 1e3
    esc_last_profile.clear()
    esc_last_profile.update(prof)
    return data, indices, indptr


# Phase decomposition of the most recent spgemm_esc_arrays call:
# prep_dispatch (host planning lookups + value
# packing dispatches), kernel_wait (wall time of the wave count reads —
# remaining kernel execution at the sync point), readback (link
# transfer of keys/values), assembly (host-side numpy).  Overlap makes
# the phases sum to <= e2e, not ==.
esc_last_profile = {}


# Speculative output-size cache for the device-compaction path.  With
# the structural pattern (round 3) the count depends ONLY on the operand
# index structures, so entries keyed by structure tokens can never go
# numerically stale; the in-band count still validates on the sync path.
# Keys are monotone per-container tokens (never-reused ints attached to
# the container instance) — NOT id()s, whose values recycle after GC and
# could silently alias a new matrix to an old entry.
_spgemm_nnz_cache = {}

# Extraction-structure cache (round 4): keyed like the nnz cache, holds
# (src, dest, cols, indptr) device arrays — pattern-only data, so the
# same monotone-token safety argument applies; the in-band count check
# still validates every hit.
_spgemm_struct_cache = {}

# ESC structural-pattern cache (round 5): keyed by (plan_key,
# triangular, nchan); holds per-block counts + final indices/indptr so
# steady-state repeats read ONLY values over the link.  Count-validated
# in-band on every hit (see _flush_wave / _EscPatternStale).
_esc_pattern_cache = {}

# ESC host-planning cache (see spgemm_esc_arrays): keyed by structure
# tokens + budget, holds the numpy planning arrays and per-block
# column-sort permutations.
_esc_plan_cache = {}

_struct_token_counter = __import__("itertools").count()


def _structure_token(X):
    tok = getattr(X, "_structure_token", None)
    if tok is None:
        tok = next(_struct_token_counter)
        X._structure_token = tok
    return tok


def _pattern_key(A, B, triangular):
    return (
        _structure_token(A), _structure_token(B), bool(triangular),
    )


def _structural_mask_count(A, B, triangular):
    """(mask_flat, count) device arrays of the structural pattern of
    A @ B (shared by every value channel of a planar-complex product)."""
    m, k = A.shape
    n = B.shape[1]
    a_dat = A.data[0] if A.planar else A.data
    a_flat, _, a_cm = A.sorted_flat_parts(a_dat)
    if _is_syrk_pair_pattern(A, B):
        return _xla.pattern_mask_sorted(
            a_flat, None, m=m, k=k, n=n, a_cm=a_cm, syrk=True,
            triangular=triangular,
        )
    b_dat = B.data[0] if B.planar else B.data
    b_flat, _, b_cm = B.sorted_flat_parts(b_dat)
    return _xla.pattern_mask_sorted(
        a_flat, b_flat, m=m, k=k, n=n, a_cm=a_cm, b_cm=b_cm,
        triangular=triangular,
    )


def _is_syrk_pair_pattern(A, B):
    """Structural version of :func:`_is_syrk_pair` (data identity not
    required — only the index structure matters for the pattern)."""
    return (
        B.indices is A.indices
        and B.indptr is A.indptr
        and B.shape == (A.shape[1], A.shape[0])
        and not isinstance(A, formats.BSR)
        and type(B) is not type(A)
    )


def spgemm_sparse_arrays(A, B, out_dtype, triangular=False):
    """A @ B -> (data, indices, indptr) host CSR arrays with the
    MKL/scipy STRUCTURAL output pattern (exactly-cancelled entries kept
    as explicit zeros — ``/root/reference/sparse_dot_mkl/
    _sparse_sparse.py:21-44``).

    Path choice:

    * ``config.spgemm_exact_pattern`` -> force the ESC kernel (test
      hook; every default path below is already structurally exact).
    * small/medium products -> ONE fused device program: numeric phase
      (dense product) + bf16 indicator pattern matmul + count,
      then numpy (small) or device (medium) masked compaction.
    * huge products (dense intermediate over ``_BLOCKED_SPGEMM_BYTES``)
      -> row-blocked numeric+pattern when a row block AND densified B
      both fit comfortably, otherwise the ESC kernel, whose memory is
      bounded by the expansion budget, never by m x n.
    """
    if getattr(config, "spgemm_exact_pattern", False):
        return spgemm_esc_arrays(A, B, out_dtype, triangular=triangular)
    return _spgemm_routed(A, B, out_dtype, triangular)


def _spgemm_routed(A, B, out_dtype, triangular):
    """The structural-output routing ladder (shared by the default path
    and the any-size driver's adaptive branch)."""
    m, n = A.shape[0], B.shape[1]
    k = A.shape[1]
    itemsize = np.dtype(out_dtype).itemsize

    small = m * n * itemsize <= _HOST_EXTRACT_BYTES
    is_complex = (
        A.planar or B.planar or np.dtype(out_dtype).kind == "c"
    )

    if m * n * itemsize > _BLOCKED_SPGEMM_BYTES:
        blocked_ok = (
            not is_complex
            and k * n * itemsize <= _BLOCKED_SPGEMM_BYTES  # B fits
            and n * _SPGEMM_ROW_BLOCK * itemsize <= (512 << 20)
            and k * _SPGEMM_ROW_BLOCK * itemsize <= (512 << 20)  # A panel
        )
        if blocked_ok:
            return _blocked_spgemm_arrays(A, B, out_dtype, triangular)
        return spgemm_esc_arrays(A, B, out_dtype, triangular=triangular)

    if is_complex:
        # ONE fused program: planar numeric (channels share the flat
        # index; Ozaki slice extractions shared across the four pair
        # products) + bf16 pattern + count.  Replaces the round-2
        # four-dispatch planar detour.  Cached channel planes (round 4)
        # skip the 4 densify scatters in steady state.
        ar, ai = _value_channels(A, 2)
        use_oz = (
            _xla._ozaki.enabled(ar.dtype, k, m * k * n)
            and _container_hilo_ok(A) and _container_hilo_ok(B)
        )
        syrk = _is_syrk_pair_pattern(A, B)
        seen_a = _seen_before(A)
        seen_b = True if syrk else _seen_before(B)
        pa = _planar_planes(A, use_oz) if (seen_a and seen_b) else None
        pb = (None if syrk or pa is None
              else _planar_planes(B, use_oz, role_a=False))
        if pa is not None and (syrk or pb is not None):
            a_ch, ind_a, a_cm = pa
            b_ch, ind_b, b_cm = (None, None, False) if syrk else pb
            re, im, mask_flat, _ = (
                _xla.spgemm_structural_planar_planes(
                    a_ch, ind_a, b_ch, ind_b, a_cm=a_cm, b_cm=b_cm,
                    syrk=syrk, use_ozaki=use_oz, triangular=triangular,
                )
            )
        elif syrk:
            a_flat, ar_s, a_cm = A.sorted_flat_parts(ar)
            _, ai_s, _ = A.sorted_flat_parts(ai)
            re, im, mask_flat, _ = _xla.spgemm_structural_planar(
                a_flat, ar_s, ai_s, None, None, None, m=m, k=k, n=n,
                a_cm=a_cm, syrk=True, use_ozaki=use_oz,
                triangular=triangular,
            )
        else:
            a_flat, ar_s, a_cm = A.sorted_flat_parts(ar)
            _, ai_s, _ = A.sorted_flat_parts(ai)
            br, bi = _value_channels(B, 2)
            b_flat, br_s, b_cm = B.sorted_flat_parts(br)
            _, bi_s, _ = B.sorted_flat_parts(bi)
            re, im, mask_flat, _ = _xla.spgemm_structural_planar(
                a_flat, ar_s, ai_s, b_flat, br_s, bi_s, m=m, k=k,
                n=n, a_cm=a_cm, b_cm=b_cm, use_ozaki=use_oz,
                triangular=triangular,
            )
        dense = (np.asarray(re) + 1j * np.asarray(im)).astype(
            out_dtype, copy=False
        )
        mask_np = np.asarray(mask_flat).reshape(m, n)
        return _host_extract(dense, out_dtype, triangular=False,
                             mask=mask_np)

    if small:
        # Real small products: ONE dispatch for numeric + pattern and
        # ONE readback (dense | packed mask bits in a single buffer),
        # then numpy
        # compaction.  Cached planes skip the densify scatters.
        use_oz = (
            _xla._ozaki.enabled(A.data.dtype, k, m * k * n)
            and _container_hilo_ok(A) and _container_hilo_ok(B)
        )
        planes = _planes_for(A, A.data, B, B.data, use_oz)
        if planes is not None:
            a_num, ind_a, a_cm, b_num, ind_b, b_cm, syrk = planes
            buf = _xla.spgemm_structural_packed_planes(
                a_num, ind_a, b_num, ind_b, a_cm=a_cm, b_cm=b_cm,
                syrk=syrk, triangular=triangular,
            )
        elif _is_syrk_pair(A, B, A.data, B.data):
            a_flat, a_vals, a_cm = A.sorted_flat_parts(A.data)
            buf = _xla.spgemm_structural_packed(
                a_flat, a_vals, None, None, m=m, k=k, n=n, a_cm=a_cm,
                syrk=True, use_ozaki=use_oz, triangular=triangular,
            )
        else:
            a_flat, a_vals, a_cm = A.sorted_flat_parts(A.data)
            b_flat, b_vals, b_cm = B.sorted_flat_parts(B.data)
            buf = _xla.spgemm_structural_packed(
                a_flat, a_vals, b_flat, b_vals, m=m, k=k, n=n,
                a_cm=a_cm, b_cm=b_cm, use_ozaki=use_oz,
                triangular=triangular,
            )
        buf_np = np.asarray(buf)
        dense_np = buf_np[: m * n].reshape(m, n)
        mask_np = _xla.unpack_mask_bits(buf_np[m * n:], m * n).reshape(
            m, n
        )
        return _host_extract(dense_np, out_dtype, triangular=False,
                             mask=mask_np)

    dev = spgemm_device(A, B, out_dtype=out_dtype, triangular=triangular)
    return (
        np.asarray(dev.data).astype(out_dtype, copy=False),
        np.asarray(dev.indices).astype(config.index_dtype),
        np.asarray(dev.indptr).astype(config.index_dtype),
    )


# Deferred speculation checks (async-error semantics, like CUDA): the
# mismatch predicate of every deferred op is OR-merged into a single
# device-resident flag inside the extraction program, so steady-state
# pipelines carry zero per-op host syncs; the flag is read back once
# every ``_CHECK_EVERY`` ops (or via :func:`validate_speculation`) and a
# sizing miss surfaces as a RuntimeError there.  The scipy-facing path
# always validates synchronously before returning.

_CHECK_EVERY = 32
_check_state = {"bad": None, "ops": 0}


def validate_speculation():
    """Read back the merged deferred-sizing flag; raises if any deferred
    device-resident product used a stale speculative size (its result
    was wrong — clear caches and re-run with ``sync_check=True``)."""
    bad = _check_state["bad"]
    _check_state["bad"] = None
    _check_state["ops"] = 0
    if bad is not None and bool(bad):
        _spgemm_nnz_cache.clear()
        _spgemm_struct_cache.clear()
        raise RuntimeError(
            "sparse_dot_tpu: a deferred speculative SpGEMM sizing check "
            "failed — a device-resident product in the last "
            f"{_CHECK_EVERY} ops used a stale size; the sizing cache was "
            "cleared, re-run those products (or use sync_check=True)."
        )


def _spgemm_structural_real(A, a_data, B, b_data, triangular=False):
    """One fused dispatch: numeric dense + structural mask + count."""
    m, k = A.shape
    n = B.shape[1]
    use_oz = (
        _xla._ozaki.enabled(a_data.dtype, k, m * k * n)
        and _container_hilo_ok(A) and _container_hilo_ok(B)
    )
    planes = _planes_for(A, a_data, B, b_data, use_oz)
    if planes is not None:
        a_num, ind_a, a_cm, b_num, ind_b, b_cm, syrk = planes
        return _xla.spgemm_structural_planes(
            a_num, ind_a, b_num, ind_b, a_cm=a_cm, b_cm=b_cm,
            syrk=syrk, triangular=triangular,
        )
    a_flat, a_vals, a_cm = A.sorted_flat_parts(a_data)
    if _is_syrk_pair(A, B, a_data, b_data):
        return _xla.spgemm_structural_sorted(
            a_flat, a_vals, None, None, m=m, k=k, n=n,
            a_cm=a_cm, syrk=True, use_ozaki=use_oz,
            triangular=triangular,
        )
    b_flat, b_vals, b_cm = B.sorted_flat_parts(b_data)
    return _xla.spgemm_structural_sorted(
        a_flat, a_vals, b_flat, b_vals, m=m, k=k, n=n,
        a_cm=a_cm, b_cm=b_cm, use_ozaki=use_oz, triangular=triangular,
    )


def spgemm_device(A, B, out_dtype=None, triangular=False,
                  sync_check=True):
    """A @ B -> device-resident CSR container (no host transfer), with
    the MKL/scipy structural output pattern.

    Output sizing is speculative (structure-token cache).  Because the
    count comes from the pattern matmul it depends only on the operand
    index structures, so a cached size for the same containers is
    always exact; the in-band count still validates.  With
    ``sync_check=True`` (default, and always on the scipy path) the
    count validates before returning.  ``sync_check=False`` defers
    validation to a later call, keeping steady-state pipelines free of
    host round-trips — a sizing miss then raises on a later op.
    """
    from ..policy import output_dtype as _odt

    m, k = A.shape
    n = B.shape[1]
    if out_dtype is None:
        out_dtype = _odt(A, B)
    real_dtype = A.data.dtype

    def _empty():
        return formats.CSR(
            jnp.zeros((0,), dtype=real_dtype),
            jnp.zeros((0,), jnp.int32),
            jnp.zeros((m + 1,), jnp.int32),
            (m, n),
            dtype=out_dtype,
        )

    key = _pattern_key(A, B, triangular)
    nnz = _spgemm_nnz_cache.get(key)

    if nnz is None:
        # Sizing miss: two dispatches (structural program, then the
        # extraction at the freshly learned exact size).  The
        # extraction STRUCTURE (src/dest/cols/indptr — pattern-only
        # data) is cached alongside so steady-state repeats reduce to
        # pure value movement.
        dense_dev, mask_flat, count = _spgemm_structural_real(
            A, A.data, B, B.data, triangular=triangular
        )
        nnz = int(count)  # the one sizing sync for this structure
        _spgemm_nnz_cache[key] = nnz
        if nnz == 0:
            return _empty()
        src, dest, cols, indptr = _xla.extract_structure(
            mask_flat, m, n, nnz=nnz
        )
        # Cache the extraction structure, budget-gated (the f32 path's
        # dest is m*n int32 — the dominant term) and keeping only the
        # array the dtype's value-movement actually uses: src (gather)
        # for f64-under-Ozaki, dest (set-scatter) otherwise.  The hi|lo
        # pair gather re-rounds f64 values at ~2^-49 and saturates
        # outside f32 range, so it is only used where Ozaki's input
        # range contract already holds; exact-f64 movement elsewhere.
        use_gather = (
            np.dtype(real_dtype) == np.float64
            and _xla._ozaki.enabled(real_dtype, k, m * k * n)
            # The gather hi|lo-encodes PRODUCT values, so it gates on
            # the product range (operand gating alone allows products
            # up to ~(3.4e38)^2 — review r5 finding; same bound as the
            # ESC sort-free gate).
            and _product_range_ok(A, B, _container_max_row_nnz(A))
        )
        vkey = src if use_gather else dest
        struct_bytes = int(vkey.size) * 4 + (nnz + m + 1) * 8
        if struct_bytes <= getattr(
            config, "spgemm_plane_cache_bytes", 1 << 28
        ):
            _spgemm_struct_cache[key] = (vkey, cols, indptr, use_gather)
        vals = dense_dev.reshape(-1)[src]  # one-time value gather
    else:
        if nnz == 0:
            return _empty()
        # Steady state: the WHOLE product is one fused dispatch
        # (numeric + pattern + extraction + in-band validation), from
        # cached dense planes when the operands fit the plane-cache
        # budget (headline 17.8 -> 6.1 ms).  The pattern count depends
        # only on the operand structures, so a token-cache hit can only
        # mismatch if the cache was poisoned — the in-band check still
        # guards it.
        use_oz = (
            _xla._ozaki.enabled(real_dtype, k, m * k * n)
            and _container_hilo_ok(A) and _container_hilo_ok(B)
        )
        prev_bad = _check_state["bad"]
        if prev_bad is None:
            prev_bad = jnp.zeros((), jnp.bool_)
        planes = _planes_for(A, A.data, B, B.data, use_oz)
        struct = _spgemm_struct_cache.get(key)
        if planes is not None and struct is not None:
            # Fully-cached steady state: planes + extraction structure;
            # the program does numeric + pattern-count + value movement
            # only.  cols/indptr come straight from the cache.
            a_num, ind_a, a_cm, b_num, ind_b, b_cm, syrk = planes
            # The cached flag records which value-movement array was
            # kept (src for the hi|lo gather, dest for the exact
            # scatter) — it must be honored, not recomputed, or a
            # config flip between calls would misread the cache.  A
            # gather entry is ADDITIONALLY revalidated against the
            # CURRENT data's product range (same structure, new values
            # can leave the f32 window); when it no longer holds, the
            # full in-program extraction runs instead — slower, exact.
            vkey, cols, indptr, use_gather = struct
            if use_gather and not _product_range_ok(
                A, B, _container_max_row_nnz(A)
            ):
                out = _xla.spgemm_structural_extract_planes(
                    a_num, ind_a, b_num, ind_b, prev_bad, a_cm=a_cm,
                    b_cm=b_cm, syrk=syrk, triangular=triangular,
                    nnz=nnz,
                )
            else:
                vals, count, bad = _xla.spgemm_structural_vals_planes(
                    a_num, ind_a, b_num, ind_b, vkey, prev_bad,
                    a_cm=a_cm, b_cm=b_cm, syrk=syrk,
                    triangular=triangular, nnz=nnz,
                    gather=use_gather,
                )
                out = (vals, cols, indptr, count, bad)
        elif planes is not None:
            a_num, ind_a, a_cm, b_num, ind_b, b_cm, syrk = planes
            out = _xla.spgemm_structural_extract_planes(
                a_num, ind_a, b_num, ind_b, prev_bad, a_cm=a_cm,
                b_cm=b_cm, syrk=syrk, triangular=triangular, nnz=nnz,
            )
        elif _is_syrk_pair(A, B, A.data, B.data):
            a_flat, a_vals, a_cm = A.sorted_flat_parts(A.data)
            out = _xla.spgemm_structural_extract(
                a_flat, a_vals, None, None, prev_bad, m=m, k=k, n=n,
                a_cm=a_cm, syrk=True, use_ozaki=use_oz,
                triangular=triangular, nnz=nnz,
            )
        else:
            a_flat, a_vals, a_cm = A.sorted_flat_parts(A.data)
            b_flat, b_vals, b_cm = B.sorted_flat_parts(B.data)
            out = _xla.spgemm_structural_extract(
                a_flat, a_vals, b_flat, b_vals, prev_bad, m=m, k=k,
                n=n, a_cm=a_cm, b_cm=b_cm, use_ozaki=use_oz,
                triangular=triangular, nnz=nnz,
            )
        vals, cols, indptr, count, bad = out
        if sync_check:
            true_nnz = int(count)
            if true_nnz != nnz:
                # Structure changed under a reused token (shouldn't
                # happen) — fall back to the exact-size path.
                _spgemm_nnz_cache[key] = true_nnz
                _spgemm_struct_cache.pop(key, None)
                _check_state["bad"] = None
                if true_nnz == 0:
                    return _empty()
                dense_dev, mask_flat, _ = _spgemm_structural_real(
                    A, A.data, B, B.data, triangular=triangular
                )
                vals, cols, indptr = _xla.extract_sparse_masked(
                    dense_dev, mask_flat, nnz=true_nnz
                )
        else:
            _check_state["bad"] = bad
            _check_state["ops"] += 1
            if _check_state["ops"] >= _CHECK_EVERY:
                validate_speculation()

    if len(_spgemm_nnz_cache) > 256:
        _spgemm_nnz_cache.clear()
        _spgemm_struct_cache.clear()
    return formats.CSR(vals, cols, indptr, (m, n), dtype=out_dtype)


# ---------------------------------------------------------------------------
# Gram (syrk) paths
# ---------------------------------------------------------------------------


def gram_dense_from_dense(a_np, out_dtype, aat=False, out=None,
                          out_scalar=None):
    """triu(op(a)) from a dense operand (cblas_?syrk analog): the strict
    lower triangle of the result is out_scalar * out (or zero).

    Complex input runs the UNCONJUGATED product like the sparse
    ``allow_complex`` extension; on backends without native complex it
    decomposes planar: re = triu(op(ar) - op(ai)) and, since
    ``X Yᵀ + Y Xᵀ`` is symmetric, im = triu(M + Mᵀ) from ONE cross
    GEMM M."""
    beta = 1.0 if out_scalar is None else out_scalar
    a_np = np.asarray(a_np)
    formats._warn_f64_range(a_np)
    ar, ai, planar = _dense_parts(a_np)
    hilo_ok = _dense_hilo_ok(a_np)
    if ai is None:
        res = np.asarray(
            _xla.syrk_dense(ar, aat=aat, allow_hilo=hilo_ok)
        ).astype(out_dtype, copy=False)
    else:
        re = (_xla.syrk_dense(ar, aat=aat, allow_hilo=hilo_ok)
              - _xla.syrk_dense(ai, aat=aat, allow_hilo=hilo_ok))
        M = (_xla.gemm(ar, ai.T, allow_hilo=hilo_ok) if aat
             else _xla.gemm(ar.T, ai, allow_hilo=hilo_ok))
        im = jnp.triu(M + M.T)
        res = _combine_planar(np.asarray(re), np.asarray(im), out_dtype)
    if out is not None:
        res = res + np.asarray(beta, dtype=out_dtype) * np.asarray(out)
    return res


def gram_dense_from_sparse(A, out_dtype, aat=False, out=None,
                           out_scalar=None, full=False):
    """Gram of a sparse operand with dense output (syrkd analog).

    ``full=True`` reproduces the reference's syrkd full-matrix behavior
    before its lower-triangle cleanup (``_gram_matrix.py:164-169``).
    """
    beta = 1.0 if out_scalar is None else out_scalar
    At = A.T
    first, second = (A, At) if aat else (At, A)
    res = spgemm_dense(first, second, out_dtype)
    if not full:
        res = np.triu(res)
    if out is not None:
        res = res + np.asarray(beta, dtype=out_dtype) * np.asarray(out)
    return res


def gram_sparse(A, out_dtype, aat=False):
    """Gram of a sparse operand with sparse (upper-triangular) output."""
    At = A.T
    first, second = (A, At) if aat else (At, A)
    return spgemm_sparse_arrays(A=first, B=second, out_dtype=out_dtype,
                                triangular=True)

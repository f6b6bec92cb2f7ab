"""Device-resident sparse matrix containers (CSR / CSC / BSR).

The reference wraps scipy buffers in opaque MKL handles
(``/root/reference/sparse_dot_mkl/_mkl_interface/_common.py:245-384``) and
exports them back by copying C pointers (``:387-609``).  Under JAX there is
no handle lifecycle: a sparse matrix is an immutable pytree of device
arrays (``data``, ``indices``, ``indptr``) plus static shape metadata, and
"export" is just reading the arrays back.  These containers are therefore
both the handle-layer analog *and* first-class inputs to every op — they
can be passed through ``jit``, ``shard_map``, ``vmap`` etc.

Complex support: on a backend without native complex dtypes (see
``backend.has_native_complex``; CPU and GPU have them) complex matrices
are stored *planar* — ``data`` has a leading axis of length 2 holding
(real, imag) — and the op layer computes complex
products as four real products sharing one sparsity pattern.  On CPU/GPU
complex data is stored natively.

Validation semantics mirror the reference's ``_create_mkl_sparse``:
only float32/float64/complex64/complex128 data (``_common.py:245-293``),
COO rejected (``:238-242``), BSR blocks must be square and divide the
matrix dims (``:341-356``), and index widths follow the LP64/ILP64 policy
with an overflow error carrying the ILP64 hint (``:166-178``).
"""

import numpy as np
import scipy.sparse as _sps

import jax
import jax.numpy as jnp

from .config import config, ILP64_HINT
from . import backend as _backend

VALID_DTYPES = (np.float32, np.float64, np.complex64, np.complex128)
REAL_DTYPES = (np.float32, np.float64)
COMPLEX_DTYPES = (np.complex64, np.complex128)

_COMPLEX_TO_REAL = {
    np.dtype(np.complex64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.float64),
}
_REAL_TO_COMPLEX = {v: k for k, v in _COMPLEX_TO_REAL.items()}


def _validate_dtype(dtype):
    if np.dtype(dtype) not in [np.dtype(d) for d in VALID_DTYPES]:
        raise ValueError(
            "Matrix data type must be float32, float64, complex64, or "
            f"complex128; {np.dtype(dtype)} provided"
        )


def _check_index_bounds(nnz, shape):
    int_max = np.iinfo(config.index_dtype).max
    if nnz > int_max or max(shape) > int_max:
        raise ValueError(
            f"Index interface is {np.dtype(config.index_dtype)} and cannot "
            f"hold a matrix with shape {shape} / nnz {nnz}; {ILP64_HINT}"
        )


def _use_planar(dtype):
    dtype = np.dtype(dtype)
    if dtype not in _COMPLEX_TO_REAL:
        return False
    if config.force_planar_complex:
        return True
    return not _backend.has_native_complex()


def _split_complex(arr):
    """numpy complex array -> stacked (2, ...) real array."""
    real_dtype = _COMPLEX_TO_REAL[np.dtype(arr.dtype)]
    return np.stack(
        [np.ascontiguousarray(arr.real), np.ascontiguousarray(arr.imag)]
    ).astype(real_dtype)


class SparseDeviceMatrix:
    """Base class for device sparse containers.

    Attributes
    ----------
    data : jnp.ndarray
        Nonzero values.  For planar-complex storage the leading axis has
        length 2 (real, imag) and ``dtype`` still reports the complex type.
    indices, indptr : jnp.ndarray
        Compressed-sparse index arrays in the active index dtype.
    shape : tuple of int (static)
    """

    format = None  # "csr" | "csc" | "bsr"

    def __init__(self, data, indices, indptr, shape, dtype=None, planar=False):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(int(s) for s in shape)
        self.planar = bool(planar)
        if dtype is not None:
            self._dtype = np.dtype(dtype)
        elif planar:
            self._dtype = _REAL_TO_COMPLEX[np.dtype(data.dtype)]
        else:
            self._dtype = np.dtype(data.dtype)

    # -- basic properties ---------------------------------------------------

    @property
    def dtype(self):
        return self._dtype

    @property
    def ndim(self):
        return 2

    @property
    def nnz(self):
        # CSR/CSC data is (nnz,) or planar (2, nnz); BSR overrides.
        return int(self.data.shape[-1])

    @property
    def density(self):
        size = self.shape[0] * self.shape[1]
        return self.nnz / size if size else 0.0

    @property
    def iscomplex(self):
        return self._dtype in _COMPLEX_TO_REAL

    def real_view(self):
        """Return a real-dtyped container sharing this pattern (planar)."""
        if not self.planar:
            raise ValueError("real_view only valid for planar storage")
        return type(self)._rebuild(self, self.data[0])

    def imag_view(self):
        if not self.planar:
            raise ValueError("imag_view only valid for planar storage")
        return type(self)._rebuild(self, self.data[1])

    @classmethod
    def _rebuild(cls, template, new_data, planar=False, dtype=None):
        out = cls.__new__(cls)
        out.data = new_data
        out.indices = template.indices
        out.indptr = template.indptr
        out.shape = template.shape
        out.planar = planar
        if dtype is not None:
            out._dtype = np.dtype(dtype)
        elif planar:
            out._dtype = _REAL_TO_COMPLEX[np.dtype(new_data.dtype)]
        else:
            out._dtype = np.dtype(new_data.dtype)
        if isinstance(template, BSR):
            out.blocksize = template.blocksize
        return out

    def with_data(self, new_data, planar=None, dtype=None):
        planar = self.planar if planar is None else planar
        return type(self)._rebuild(self, new_data, planar=planar, dtype=dtype)

    def astype(self, dtype):
        """Container with values cast to ``dtype`` (index structure
        shared; the SAME object when the dtype already matches — the
        identity semantics the cast policy relies on, mirroring the
        reference's return-by-reference ``_type_check``).  Needed so
        device containers are first-class ``cast=True`` operands
        (review r5 finding: ``policy._cast_to`` calls ``astype``)."""
        dtype = np.dtype(dtype)
        if dtype == self._dtype:
            return self
        tgt_complex = dtype.kind == "c"
        if self.iscomplex and not tgt_complex:
            raise ValueError(
                f"cannot cast complex container to real dtype {dtype}"
            )
        if self.planar:
            real_t = _COMPLEX_TO_REAL[dtype]
            return self.with_data(
                self.data.astype(jnp.dtype(real_t)), planar=True,
                dtype=dtype,
            )
        if self.iscomplex:  # native complex -> wider native complex
            return self.with_data(
                self.data.astype(jnp.dtype(dtype)), dtype=dtype
            )
        if tgt_complex:
            # real -> complex: follow the backend's complex storage
            # policy (planar without native complex).
            from . import backend as _backend
            from .config import config as _cfg

            real_t = _COMPLEX_TO_REAL[dtype]
            if (_backend.has_native_complex()
                    and not _cfg.force_planar_complex):
                return self.with_data(
                    self.data.astype(jnp.dtype(dtype)), dtype=dtype
                )
            re = self.data.astype(jnp.dtype(real_t))
            return self.with_data(
                jnp.stack([re, jnp.zeros_like(re)]), planar=True,
                dtype=dtype,
            )
        return self.with_data(
            self.data.astype(jnp.dtype(dtype)), dtype=dtype
        )

    # -- pytree protocol ----------------------------------------------------

    def tree_flatten(self):
        children = (self.data, self.indices, self.indptr)
        aux = (self.shape, self._dtype, self.planar, getattr(self, "blocksize", None))
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, dtype, planar, blocksize = aux
        obj = cls.__new__(cls)
        obj.data, obj.indices, obj.indptr = children
        obj.shape = shape
        obj._dtype = dtype
        obj.planar = planar
        if blocksize is not None:
            obj.blocksize = blocksize
        return obj

    def __repr__(self):
        return (
            f"<{type(self).__name__} shape={self.shape} nnz={self.nnz} "
            f"dtype={self.dtype}{' planar' if self.planar else ''}>"
        )

    # -- sorted-flat lowering (densify fast path) ---------------------------

    def _flat_dtype(self):
        return (
            jnp.int32
            if self.shape[0] * self.shape[1] < (1 << 31)
            else jnp.int64
        )

    def _build_flat(self):
        """(flat_indices, col_major, known_sorted) in this format's
        natural iteration order."""
        raise NotImplementedError

    def sorted_flat_parts(self, data=None):
        """Return (flat_sorted, vals_sorted, col_major) for the
        sorted-unique scatter densify path.

        ``col_major=True`` means the flat index addresses the transposed
        dense array in row-major order (the natural sorted order of a
        CSC operand); the consumer absorbs the transpose in its
        contraction dims.  Unsorted layouts (BSR, unsorted-index CSR)
        sort once on device and cache the permutation.
        """
        data = self.data if data is None else data
        cache = getattr(self, "_sorted_flat_cache", None)
        if cache is None:
            flat, col_major, known_sorted = self._build_flat()
            if known_sorted:
                order = None
            else:
                order = jnp.argsort(flat)
                flat = flat[order]
            cache = (flat, order, col_major)
            self._sorted_flat_cache = cache
        flat, order, col_major = cache
        vals = data.reshape(-1) if data.ndim > 1 else data
        if order is not None:
            vals = vals[order]
        return flat, vals, col_major

    def dense_planes(self, data=None, hilo=False, with_indicator=True):
        """Cached dense numeric planes (+ bf16 structural indicator)
        for the plane-cached SpGEMM/SpMM programs (``_xla.*_planes``).

        This is the framework's ``mkl_sparse_optimize`` analog: the
        densify scatters dominate the fused structural programs and
        recompute bit-identical results while the operand is unchanged,
        so the container caches them per data buffer (the indicator is
        data-independent and survives value updates).  Returns
        (num_parts_tuple, indicator_or_None, col_major) or None when
        the dense footprint exceeds
        ``config.spgemm_plane_cache_bytes`` (or the cache is disabled).

        ``hilo=True`` stores the exact f64 (hi, lo) f32 pair the Ozaki
        matmul consumes; the cache keys on it.  ``with_indicator=False``
        skips the indicator scatter (SpMM never reads it); a later
        with-indicator request upgrades the cache entry in place.
        """
        from .config import config as _cfg
        from .ops import _xla

        if not getattr(_cfg, "spgemm_plane_cache", True) or self.planar:
            return None
        data = self.data if data is None else data
        m, n = self.shape
        num_bytes = m * n * (8 if hilo else np.dtype(self.dtype).itemsize)
        if num_bytes + m * n * 2 > getattr(
            _cfg, "spgemm_plane_cache_bytes", 1 << 28
        ):
            return None
        cache = getattr(self, "_plane_cache", None)
        if cache is not None and cache[0] is data and cache[1] == hilo:
            num, ind, col_major = cache[2]
            if ind is not None or not with_indicator:
                return cache[2]
            # upgrade: indicator now needed — fall through and rebuild.
        flat, vals, col_major = self.sorted_flat_parts(data)
        shape = (n, m) if col_major else (m, n)
        parts = _xla.dense_planes_prep(
            flat, vals, shape=shape, hilo=hilo,
            with_ind=with_indicator,
        )
        if with_indicator:
            out = (tuple(parts[:-1]), parts[-1], col_major)
        else:
            out = (tuple(parts), None, col_major)
        self._plane_cache = (data, hilo, out)
        return out

    def ozaki_slices(self, data=None, contract=1):
        """Cached pre-extracted Ozaki bf16 slices + exponents for the
        f64 matmul — the deepest inspector-executor layer: with
        both the planes AND the slices cached, a steady-state f64
        product is pure pair-product matmuls.  Keyed per
        (data buffer, contraction axis); returns (slices, exponents)
        or None (budget / unsupported contraction length / cache
        off)."""
        from .config import config as _cfg
        from .ops import ozaki as _oz

        planes = self.dense_planes(data, hilo=True,
                                   with_indicator=False)
        if planes is None:
            return None
        (hi, lo), _ind, _cm = planes
        t, D, _dj = _oz.plan(hi.shape[contract])
        if t < 1:
            return None
        if D * hi.size * 2 > getattr(
            _cfg, "ozaki_slice_cache_bytes", 1 << 28
        ):
            return None
        data = self.data if data is None else data
        cache = getattr(self, "_oz_slice_cache", None)
        if cache is not None and cache[0] is data and cache[1] == contract:
            return cache[2]
        from .ops import _xla

        out = _xla._ozaki.extract_slices_jit(
            hi, lo, shape=hi.shape, contract=contract
        )
        self._oz_slice_cache = (data, contract, out)
        return out


def _to_device_indices(arr):
    return jnp.asarray(np.asarray(arr, dtype=config.index_dtype))


def _data_to_device(data_np):
    """Host values -> device array, planar-splitting complex if needed."""
    _validate_dtype(data_np.dtype)
    if np.iscomplexobj(data_np) and _use_planar(data_np.dtype):
        return jnp.asarray(_split_complex(data_np)), True
    return jnp.asarray(data_np), False


@jax.tree_util.register_pytree_node_class
class CSR(SparseDeviceMatrix):
    format = "csr"

    @classmethod
    def from_scipy(cls, mat):
        if not _sps.issparse(mat) or mat.format != "csr":
            raise ValueError(f"Expected scipy CSR matrix, got {type(mat)}")
        _check_index_bounds(mat.nnz, mat.shape)
        if not mat.has_canonical_format:
            # The sorted-set densify path assumes unique entries.
            mat = mat.copy()
            mat.sum_duplicates()
        data, planar = _data_to_device(mat.data)
        out = cls(
            data,
            _to_device_indices(mat.indices),
            _to_device_indices(mat.indptr),
            mat.shape,
            dtype=mat.dtype,
            planar=planar,
        )
        out.indices_sorted = bool(mat.has_sorted_indices)
        return out

    def _build_flat(self):
        dt = self._flat_dtype()
        flat = (
            self.row_indices().astype(dt) * self.shape[1]
            + self.indices.astype(dt)
        )
        return flat, False, getattr(self, "indices_sorted", False)

    def to_scipy(self, container=_sps.csr_matrix):
        data = _host_data(self)
        return container(
            (data, np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def row_indices(self):
        """Expand indptr to one row id per nonzero (device op, cached)."""
        cached = getattr(self, "_row_indices", None)
        if cached is None:
            cached = _expand_indptr(self.indptr, self.nnz)
            self._row_indices = cached
        return cached

    def ell_parts(self, data=None, max_pad_ratio=3.0):
        """Per-row padded (ELL) layout for the scatter-free SpMM path.

        Returns (cols_ell, vals_ell), both (m_pad, rmax) with m_pad a
        multiple of 256, or None when padding would blow up the layout
        (row lengths skewed beyond ``max_pad_ratio``).  The one-time
        repack — this framework's analog of MKL's inspector-executor
        "optimize" step — is cached on the container; the padded
        values are cached per data buffer.
        """
        from .ops import _xla

        data = self.data if data is None else data
        m = self.shape[0]
        m_pad = -(-m // 256) * 256
        cache = getattr(self, "_ell_cache", None)
        if cache is not None and cache[0] is None and cache[2] <= (
            max_pad_ratio
        ):
            # A stricter earlier caller rejected the layout, but THIS
            # caller's ratio admits it — rebuild (the cached decision
            # must key on the argument, review r5 finding).
            cache = None
        if cache is None:
            rmax = max(int(_xla.ell_row_max(self.indptr)), 1)
            pad_ratio = m * rmax / max(self.nnz, 1)
            if pad_ratio > max_pad_ratio:
                cache = (None, None, pad_ratio)
            else:
                cols_ell, vals_ell = _xla.ell_repack(
                    self.row_indices(), self.indices, data, self.indptr,
                    m=m_pad, rmax=rmax,
                )
                cache = (cols_ell, (data, vals_ell), pad_ratio)
            self._ell_cache = cache
        cols_ell, vals_entry, pad_ratio = cache
        if cols_ell is None or pad_ratio > max_pad_ratio:
            return None
        if vals_entry[0] is not data:
            _, vals_ell = _xla.ell_repack(
                self.row_indices(), self.indices, data, self.indptr,
                m=m_pad, rmax=cols_ell.shape[1],
            )
            vals_entry = (data, vals_ell)
            self._ell_cache = (cols_ell, vals_entry, pad_ratio)
        return cols_ell, vals_entry[1]

    def ell_parts_binned(self, data=None, max_pad_ratio=3.0,
                         chunk_rows=256):
        """Row-binned (SELL-style) padded layout for the gather SpMM.

        Rows are sorted by nnz and padded per 256-row chunk to the
        CHUNK's max nnz (multiple of 8) instead of the global max —
        on typical matrices this cuts the ~1.5x ELL padding to ~1.05x,
        which is pure HBM traffic saved in the gather kernel.  Chunks
        with equal padded width merge into segments so the compiled
        program has one gather+reduce per distinct width.

        Returns (segs, cols_flat, vals_flat, invpos) where segs is a
        static tuple of (rmax, rows) per segment (rows a multiple of
        256, concatenated in sorted-row order), the flat arrays hold
        the per-row slots back to back, and invpos maps natural row ->
        sorted position for the output un-permute.  None when the
        layout degenerates (pad ratio above ``max_pad_ratio`` or flat
        size overflows int32).
        """
        from .ops import _xla

        data = self.data if data is None else data
        m = self.shape[0]
        cache = getattr(self, "_ell_binned_cache", None)
        if cache is not None and cache[0] is None and cache[-1] <= (
            max_pad_ratio
        ):
            cache = None  # stricter caller rejected; this one admits
        if cache is None:
            indptr_np = np.asarray(self.indptr).astype(np.int64)
            row_nnz = indptr_np[1:] - indptr_np[:-1]
            m_pad = -(-m // chunk_rows) * chunk_rows
            perm = np.argsort(-row_nnz, kind="stable").astype(np.int32)
            nnz_sorted = np.zeros(m_pad, np.int64)
            nnz_sorted[:m] = row_nnz[perm]
            # per-chunk padded width, aligned to 8 sublanes
            chunk_max = nnz_sorted.reshape(-1, chunk_rows).max(axis=1)
            rmax_c = (-(-chunk_max // 8) * 8).astype(np.int64)
            per_row_rmax = np.repeat(rmax_c, chunk_rows)
            row_off = np.concatenate(
                [[0], np.cumsum(per_row_rmax)]
            ).astype(np.int64)
            flat_size = int(row_off[-1])
            pad_ratio = flat_size / max(self.nnz, 1)
            if flat_size == 0 or flat_size >= (1 << 31):
                # Threshold-independent rejection (empty / i32
                # overflow): record inf so NO caller's max_pad_ratio
                # re-admits it — keying on pad_ratio alone re-ran the
                # O(m log m) layout build on every call (review r5).
                self._ell_binned_cache = (None,) * 5 + (np.inf,)
                return None
            if pad_ratio > max_pad_ratio:
                self._ell_binned_cache = (None,) * 5 + (pad_ratio,)
                return None
            # equal-width chunks -> segments (sorted order makes them
            # consecutive)
            segs = []
            for w in rmax_c:
                w = int(w)
                if segs and segs[-1][0] == w:
                    segs[-1][1] += chunk_rows
                else:
                    segs.append([w, chunk_rows])
            segs = tuple((w, r) for w, r in segs)

            perm_pad = np.zeros(m_pad, np.int32)
            perm_pad[:m] = perm
            invpos = np.zeros(m, np.int32)
            invpos[perm] = np.arange(m, dtype=np.int32)

            cols_flat, vals_flat = _xla.ell_binned_repack(
                self.indptr, self.indices, data,
                jnp.asarray(perm_pad),
                jnp.asarray(row_off.astype(np.int32)),
                jnp.asarray(nnz_sorted.astype(np.int32)),
                flat_size=flat_size,
                m_pad=m_pad,
            )
            cache = (
                segs, cols_flat, (data, vals_flat),
                jnp.asarray(invpos),
                (jnp.asarray(perm_pad),
                 jnp.asarray(row_off.astype(np.int32)),
                 jnp.asarray(nnz_sorted.astype(np.int32)),
                 flat_size, m_pad),
                pad_ratio,
            )
            self._ell_binned_cache = cache
        if cache[0] is None or cache[-1] > max_pad_ratio:
            return None
        segs, cols_flat, vals_entry, invpos, aux, _ = cache
        if vals_entry[0] is not data:
            perm_pad, row_off, nnz_sorted, flat_size, m_pad = aux
            _, vals_flat = _xla.ell_binned_repack(
                self.indptr, self.indices, data, perm_pad, row_off,
                nnz_sorted, flat_size=flat_size, m_pad=m_pad,
            )
            vals_entry = (data, vals_flat)
            self._ell_binned_cache = (
                segs, cols_flat, vals_entry, invpos, aux, cache[5]
            )
        return segs, cols_flat, vals_entry[1], invpos

    @property
    def T(self):
        """Zero-cost transpose: a CSR's buffers reread as CSC.

        Memoized on the instance so repeated ``A.T`` return the SAME
        container — downstream structure-token caches (speculative
        SpGEMM sizing, sorted-flat layouts) then hit across calls."""
        out = getattr(self, "_T_view", None)
        if out is not None:
            return out
        out = CSC.__new__(CSC)
        out.data = self.data
        out.indices = self.indices
        out.indptr = self.indptr
        out.shape = (self.shape[1], self.shape[0])
        out.planar = self.planar
        out._dtype = self._dtype
        out.indices_sorted = getattr(self, "indices_sorted", False)
        self._T_view = out
        return out


@jax.tree_util.register_pytree_node_class
class CSC(SparseDeviceMatrix):
    format = "csc"

    @classmethod
    def from_scipy(cls, mat):
        if not _sps.issparse(mat) or mat.format != "csc":
            raise ValueError(f"Expected scipy CSC matrix, got {type(mat)}")
        _check_index_bounds(mat.nnz, mat.shape)
        if not mat.has_canonical_format:
            mat = mat.copy()
            mat.sum_duplicates()
        data, planar = _data_to_device(mat.data)
        out = cls(
            data,
            _to_device_indices(mat.indices),
            _to_device_indices(mat.indptr),
            mat.shape,
            dtype=mat.dtype,
            planar=planar,
        )
        out.indices_sorted = bool(mat.has_sorted_indices)
        return out

    def _build_flat(self):
        # Column-major flat = row-major flat of the transposed dense.
        dt = self._flat_dtype()
        flat = (
            self.col_indices().astype(dt) * self.shape[0]
            + self.indices.astype(dt)
        )
        return flat, True, getattr(self, "indices_sorted", False)

    def to_scipy(self, container=_sps.csc_matrix):
        data = _host_data(self)
        return container(
            (data, np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def col_indices(self):
        cached = getattr(self, "_col_indices", None)
        if cached is None:
            cached = _expand_indptr(self.indptr, self.nnz)
            self._col_indices = cached
        return cached

    @property
    def T(self):
        out = getattr(self, "_T_view", None)
        if out is not None:
            return out
        out = CSR.__new__(CSR)
        out.data = self.data
        out.indices = self.indices
        out.indptr = self.indptr
        out.shape = (self.shape[1], self.shape[0])
        out.planar = self.planar
        out._dtype = self._dtype
        out.indices_sorted = getattr(self, "indices_sorted", False)
        self._T_view = out
        return out


@jax.tree_util.register_pytree_node_class
class BSR(SparseDeviceMatrix):
    """Block CSR with square blocks — dense blocks for batched matmuls.

    ``data`` is (nblocks, bs, bs) (or (2, nblocks, bs, bs) planar);
    ``indices`` holds block-column ids; ``indptr`` compresses block rows.
    """

    format = "bsr"

    def __init__(self, data, indices, indptr, shape, blocksize,
                 dtype=None, planar=False):
        super().__init__(data, indices, indptr, shape, dtype=dtype,
                         planar=planar)
        self.blocksize = (int(blocksize[0]), int(blocksize[1]))

    @classmethod
    def from_scipy(cls, mat):
        if not _sps.issparse(mat) or mat.format != "bsr":
            raise ValueError(f"Expected scipy BSR matrix, got {type(mat)}")
        R, C = mat.blocksize
        if R != C:
            raise ValueError(
                f"BSR blocks must be square; blocksize {mat.blocksize} "
                "provided"
            )
        if mat.shape[0] % R or mat.shape[1] % C:
            raise ValueError(
                f"BSR matrix dims {mat.shape} must be divisible by the "
                f"blocksize {mat.blocksize}"
            )
        _check_index_bounds(mat.nnz, mat.shape)
        data, planar = _data_to_device(mat.data)
        return cls(
            data,
            _to_device_indices(mat.indices),
            _to_device_indices(mat.indptr),
            mat.shape,
            (R, C),
            dtype=mat.dtype,
            planar=planar,
        )

    def to_scipy(self, container=_sps.bsr_matrix):
        data = _host_data(self)
        return container(
            (data, np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
            blocksize=self.blocksize,
        )

    @property
    def nnz(self):
        nblocks = (
            self.data.shape[1] if self.planar else self.data.shape[0]
        )
        return int(nblocks) * self.blocksize[0] * self.blocksize[1]

    @property
    def nblocks(self):
        return int(self.data.shape[1] if self.planar else self.data.shape[0])

    def block_row_indices(self):
        cached = getattr(self, "_block_row_indices", None)
        if cached is None:
            cached = _expand_indptr(self.indptr, self.nblocks)
            self._block_row_indices = cached
        return cached

    def _build_flat(self):
        dt = self._flat_dtype()
        R, C = self.blocksize
        nb = self.nblocks
        br = self.block_row_indices().astype(dt)
        bc = self.indices.astype(dt)
        i = jnp.arange(R, dtype=dt)
        j = jnp.arange(C, dtype=dt)
        rows = jnp.broadcast_to(
            (br[:, None, None] * R + i[None, :, None]), (nb, R, C)
        ).reshape(-1)
        cols = jnp.broadcast_to(
            (bc[:, None, None] * C + j[None, None, :]), (nb, R, C)
        ).reshape(-1)
        return rows * self.shape[1] + cols, False, False


def _host_data(mat):
    """Device data back to a host numpy array, rejoining planar complex."""
    if mat.planar:
        d = np.asarray(mat.data)
        return (d[0] + 1j * d[1]).astype(mat.dtype)
    return np.asarray(mat.data)


def _expand_indptr(indptr, nnz):
    """indptr -> per-nonzero segment ids, on device (empty segments
    included).  Uses marks+prefix-sum, not ``jnp.searchsorted`` (one
    binary search per nonzero)."""
    if nnz == 0:
        return jnp.zeros((0,), dtype=indptr.dtype)
    from .ops import _xla

    nseg = indptr.shape[0] - 1
    return _xla.segment_ids_from_offsets(indptr, nnz, nseg - 1).astype(
        indptr.dtype
    )


# ---------------------------------------------------------------------------
# scipy-facing format helpers (reference: _common.py:216-242)
# ---------------------------------------------------------------------------

try:
    _scipy_output_types = {
        "csr_matrix": _sps.csr_matrix,
        "csr_array": _sps.csr_array,
        "csc_matrix": _sps.csc_matrix,
        "csc_array": _sps.csc_array,
        "bsr_matrix": _sps.bsr_matrix,
        "bsr_array": _sps.bsr_array,
    }
    _scipy_format_classes = {
        "csr": (_sps.csr_matrix, _sps.csr_array),
        "csc": (_sps.csc_matrix, _sps.csc_array),
        "bsr": (_sps.bsr_matrix, _sps.bsr_array),
    }
except AttributeError:  # very old scipy without *_array classes
    _scipy_output_types = {
        "csr_matrix": _sps.csr_matrix,
        "csc_matrix": _sps.csc_matrix,
        "bsr_matrix": _sps.bsr_matrix,
    }
    _scipy_format_classes = {
        "csr": (_sps.csr_matrix,),
        "csc": (_sps.csc_matrix,),
        "bsr": (_sps.bsr_matrix,),
    }


def is_csr(x):
    return isinstance(x, _scipy_format_classes["csr"]) or isinstance(x, CSR)


def is_csc(x):
    return isinstance(x, _scipy_format_classes["csc"]) or isinstance(x, CSC)


def is_bsr(x):
    return isinstance(x, _scipy_format_classes["bsr"]) or isinstance(x, BSR)


def is_device_sparse(x):
    return isinstance(x, SparseDeviceMatrix)


def issparse(x):
    return _sps.issparse(x) or is_device_sparse(x)


def sparse_output_type(x):
    """Return (constructor, type-name) matching the input's class, so the
    product of a ``csr_array`` is a ``csr_array`` etc.
    (reference ``sparse_output_type``, ``_common.py:228-242``)."""
    for name, constructor in _scipy_output_types.items():
        if isinstance(x, constructor):
            return constructor, name
    if isinstance(x, CSR):
        return _sps.csr_matrix, "csr_matrix"
    if isinstance(x, CSC):
        return _sps.csc_matrix, "csc_matrix"
    if isinstance(x, BSR):
        return _sps.bsr_matrix, "bsr_matrix"
    raise ValueError(
        "Input matrices must be CSR, CSC, or BSR; COO is not supported"
    )


_DEVICE_CLASSES = {"csr": CSR, "csc": CSC, "bsr": BSR}

# f32's representable window: the dynamic range of f64 on a backend
# that emulates f64 as f32 pairs (one without native f64).
_F64_RANGE_MAX = 3.4e38
_F64_RANGE_MIN = 1e-38
_warned_f64_range = [False]


def _warn_f64_range(data_np):
    """Warn ONCE when f64 host values exceed the active backend's
    representable f64 window (f32-pair emulation: |x| > ~3.4e38
    transfers as inf, tiny magnitudes flush to 0 — measured at the
    device boundary, before any kernel).  MKL computes such inputs
    exactly, so silence here would be a silent wrong answer; CPU
    backends represent full f64 and never warn.

    Ordering matters for the hot path: the lru-cached backend
    capability check runs BEFORE the O(nnz) data scan, so full-range
    (CPU) backends and already-warned sessions pay nothing."""
    if _warned_f64_range[0]:
        return
    d = np.asarray(data_np)
    if d.dtype not in (np.float64, np.complex128) or d.size == 0:
        return
    from . import backend as _backend

    if _backend.has_native_f64():
        return
    # Only FINITE magnitudes outside the window warn: NaN/inf inputs
    # transfer faithfully on the pair backend and are the user's own
    # data, not a representability problem (review r5 finding — the
    # old isfinite(max) test fired on any NaN).
    a = np.abs(d.reshape(-1))
    a = a[np.isfinite(a)]
    if a.size == 0:
        return
    if float(a.max()) <= _F64_RANGE_MAX:
        nz = a[a > 0]
        if nz.size == 0 or float(nz.min()) >= _F64_RANGE_MIN:
            return
    _warned_f64_range[0] = True
    import warnings

    warnings.warn(
        "sparse_dot_tpu: float64 operand magnitudes exceed this "
        "backend's representable f64 range (this backend emulates "
        "f64 with f32-pair arithmetic: |x| > ~3.4e38 transfers as inf, "
        "|x| < ~1e-38 flushes toward zero).  Results will saturate; "
        "run on a CPU backend for full-range f64.",
        RuntimeWarning,
    )


# ---------------------------------------------------------------------------
# Host->device transfer cache
# ---------------------------------------------------------------------------
# Repeated eager calls with the same scipy matrix / numpy array should not
# re-upload the buffers (MKL pays no transfer; an accelerator library must
# amortize it).  Entries are keyed by object id and validated with a
# content fingerprint (buffer pointers + sampled checksums), so in-place
# mutation of the host data is detected in all but adversarial cases.
# Disable with ``config.device_transfer_cache = False``.

import collections as _collections
import zlib as _zlib

_transfer_cache = _collections.OrderedDict()
_TRANSFER_CACHE_MAX = 128


def _array_fingerprint(arr):
    """Content fingerprint: full CRC32 of the raw buffer.

    A full checksum (~GB/s) is still orders of magnitude cheaper than a
    host->device transfer, and unlike a sampled checksum it cannot miss
    an in-place mutation of the host data (a silent wrong-answer class
    on a default-on cache)."""
    if arr.size == 0:
        return (arr.shape, arr.dtype.str, 0, 0)
    buf = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
    crc = _zlib.crc32(memoryview(buf).cast("B"))
    return (arr.shape, arr.dtype.str, arr.ctypes.data, crc)


def _cache_get(key, fingerprint):
    hit = _transfer_cache.get(key)
    if hit is not None and hit[0] == fingerprint:
        _transfer_cache.move_to_end(key)
        return hit[1]
    return None


def _cache_put(key, fingerprint, value):
    _transfer_cache[key] = (fingerprint, value)
    _transfer_cache.move_to_end(key)
    while len(_transfer_cache) > _TRANSFER_CACHE_MAX:
        _transfer_cache.popitem(last=False)


def clear_transfer_cache():
    _transfer_cache.clear()


def _cache_enabled():
    return getattr(config, "device_transfer_cache", True)


def to_device(mat):
    """scipy sparse (CSR/CSC/BSR) or device container -> device container.

    Transfers are cached (see above): converting the same unmodified
    scipy matrix twice reuses the device arrays.
    """
    if is_device_sparse(mat):
        return mat
    if not _sps.issparse(mat):
        raise ValueError(f"Expected a sparse matrix, got {type(mat)}")
    if mat.format not in _DEVICE_CLASSES:
        raise ValueError(
            "Input matrices must be CSR, CSC, or BSR; "
            f"{mat.format.upper()} is not supported"
        )
    if not _cache_enabled():
        _warn_f64_range(mat.data)
        return _DEVICE_CLASSES[mat.format].from_scipy(mat)

    key = ("sparse", id(mat), np.dtype(config.index_dtype).str)
    fp = (
        mat.format,
        _array_fingerprint(mat.data),
        _array_fingerprint(mat.indices),
        _array_fingerprint(mat.indptr),
        mat.shape,
    )
    cached = _cache_get(key, fp)
    if cached is not None:
        return cached
    # Range warning only on cache misses (new/changed buffers): a hit
    # means this exact content was already checked at upload time.
    _warn_f64_range(mat.data)

    # Buffer-alias dedup: a scipy transpose view (X.T / X.T.tocsc())
    # shares X's arrays; reuse the already-transferred container's
    # zero-cost .T view so e.g. X @ X.T costs one upload and the op
    # layer can detect the syrk pair.
    if mat.format in ("csr", "csc"):
        alias_key = (
            "bufs",
            mat.data.ctypes.data,
            mat.indices.ctypes.data,
            mat.indptr.ctypes.data,
            mat.data.dtype.str,
            int(mat.nnz),
            np.dtype(config.index_dtype).str,
        )
        # The alias entry can be hit through a different scipy object
        # sharing the same buffers, so its validity must cover every
        # buffer's content, not just the values.  Reuses the main
        # key's already-computed fingerprints: recomputing them here
        # doubled the full-CRC pass over every buffer per upload
        # (review r5 finding).
        alias_fp = (fp[1], fp[2], fp[3])
        hit = _cache_get(alias_key, alias_fp)
        if hit is not None:
            h_container, h_format, h_shape = hit
            if h_format != mat.format and h_shape == mat.shape[::-1]:
                container = h_container.T
                _cache_put(key, fp, container)
                return container
            if h_format == mat.format and h_shape == mat.shape:
                _cache_put(key, fp, h_container)
                return h_container

    container = _DEVICE_CLASSES[mat.format].from_scipy(mat)
    _cache_put(key, fp, container)
    if mat.format in ("csr", "csc"):
        _cache_put(alias_key, alias_fp,
                   (container, mat.format, mat.shape))
    return container


def dense_to_device(arr):
    """Host dense array -> device array (planar pair for complex on
    backends without native complex support).  Cached like
    :func:`to_device`."""
    arr = np.asarray(arr)

    def _build():
        if np.iscomplexobj(arr) and _use_planar(arr.dtype):
            return jnp.asarray(_split_complex(arr)), True
        return jnp.asarray(np.ascontiguousarray(arr)), False

    if not _cache_enabled() or arr.size < 16384:
        return _build()

    key = ("dense", id(arr))
    fp = _array_fingerprint(arr)
    cached = _cache_get(key, fp)
    if cached is not None:
        return cached
    value = _build()
    _cache_put(key, fp, value)
    return value

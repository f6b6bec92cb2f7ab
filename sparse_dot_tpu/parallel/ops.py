"""Mesh-sharded sparse ops (SPMD over the device interconnect).

The scaling layer the reference never had (its parallelism was MKL's
OpenMP threading in one address space).  Layout strategy per
``SURVEY.md`` §5/§7:

* 1-D row partition (the SpMM/SpMV default): each device owns a
  contiguous block of A's rows in padded-COO form; B is replicated;
  outputs are row-sharded with no communication on the forward op.
* k-sharded SpMM (``sharded_spmm_2d``): A column-partitioned, B
  row-partitioned along the contraction axis; local partials are
  combined with ``psum`` over the mesh axis — the canonical
  collective-bearing layout.
* distributed CG: row-sharded matvec + ``all_gather`` to re-replicate,
  scalar reductions stay replicated.

Shards are padded to uniform nnz (SPMD needs identical shapes per
device); padded entries carry an out-of-range row id and are dropped by
the scatter (``mode="drop"``), costing nothing but the pad FLOPs.
"""

import functools

import numpy as np
import scipy.sparse as _sps

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .. import formats
from ..ops import _xla


# A float32 product at DEFAULT may run in TF32 on a GPU; every product
# here asks for full precision.
_HIGHEST = jax.lax.Precision.HIGHEST


def _ceil_div(a, b):
    return -(-a // b)


class ShardedCSR:
    """Row-partitioned CSR in padded expanded-COO form.

    Arrays have a leading shard axis of length S = mesh rows axis size:
    ``rows``/``cols``/``vals`` are (S, nnz_pad); ``rows`` holds
    LOCAL row ids with pad entries pointing at ``m_local`` (dropped).

    Complex matrices are stored PLANAR (the package's strategy for
    backends without native complex): ``vals`` gains a channel axis —
    (S, 2, nnz_pad) — holding the real/imaginary parts, ``planar`` is
    True, and the sharded kernels run the 4-real-product decomposition
    inside one SPMD program.

    ``mesh``/``axis`` (set by :func:`shard_csr_rows`) let the public
    ``dot_product`` dispatch route a sharded operand automatically.
    """

    ndim = 2

    def __init__(self, rows, cols, vals, shape, m_local, n_shards,
                 mesh=None, axis="rows", planar=False,
                 complex_dtype=None):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.shape = tuple(shape)
        self.m_local = int(m_local)
        self.n_shards = int(n_shards)
        self.mesh = mesh
        self.axis = axis
        self.planar = bool(planar)
        self.complex_dtype = complex_dtype

    @property
    def dtype(self):
        if self.planar and self.complex_dtype is not None:
            return self.complex_dtype
        return self.vals.dtype

    def tree_flatten(self):
        # aux must carry EVERYTHING __init__/constructors set (axis,
        # mesh, and the col-shard k_local), or a pytree round-trip
        # (jit / tree_map / device_put) silently strips routing state
        # (review r5 finding).
        return (self.rows, self.cols, self.vals), (
            self.shape, self.m_local, self.n_shards, self.planar,
            self.complex_dtype, self.axis, self.mesh,
            getattr(self, "k_local", None),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        rows, cols, vals = children
        shape, m_local, n_shards = aux[0], aux[1], aux[2]
        planar = aux[3] if len(aux) > 3 else False
        cdt = aux[4] if len(aux) > 4 else None
        axis = aux[5] if len(aux) > 5 else "rows"
        mesh = aux[6] if len(aux) > 6 else None
        k_local = aux[7] if len(aux) > 7 else None
        obj = cls(rows, cols, vals, shape, m_local, n_shards,
                  mesh=mesh, axis=axis, planar=planar,
                  complex_dtype=cdt)
        if k_local is not None:
            obj.k_local = k_local
        return obj


jax.tree_util.register_pytree_node(
    ShardedCSR,
    lambda s: s.tree_flatten(),
    ShardedCSR.tree_unflatten,
)


def _check_mesh_axis(mesh, axis, n_shards):
    """The sharded kernels map exactly one shard per device on the
    named mesh axis — a size mismatch silently DROPS shards (the
    shard_map bodies read ``rows[0]`` of each per-device block), so it
    must be an error, not a wrong answer (review r5 finding)."""
    if mesh is None:
        return
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    size = sizes.get(axis)
    if size is None:
        raise ValueError(
            f"mesh has no axis named {axis!r} (axes: {mesh.axis_names})"
        )
    if int(size) != int(n_shards):
        raise ValueError(
            f"n_shards={n_shards} must equal the mesh {axis!r} axis "
            f"size ({size}): the sharded kernels map one shard per "
            "device"
        )


def _check_contraction(A, b_rows, what="b"):
    """JAX clamps out-of-bounds gather indices under jit, so a dense
    operand whose row count mismatches A's contraction dim would give
    silently WRONG numbers, never an error (review r5 finding) —
    validate up front like ``sharded_spmv_halo`` always did."""
    if int(b_rows) != int(A.shape[1]):
        raise ValueError(
            f"Bad shapes for sharded multiply: A is {A.shape} but "
            f"{what} has {int(b_rows)} rows (need {A.shape[1]})"
        )


def shard_csr_rows(matrix, n_shards, mesh=None, axis="rows"):
    """scipy CSR (or convertible) -> ShardedCSR with device placement.

    Rows are split into ``n_shards`` contiguous blocks (padded to a
    uniform per-shard row count and nnz).
    """
    _check_mesh_axis(mesh, axis, n_shards)
    if formats.is_device_sparse(matrix):
        matrix = matrix.to_scipy().tocsr()
    elif _sps.issparse(matrix):
        matrix = matrix.tocsr()
    else:
        raise ValueError(f"Expected a sparse matrix, got {type(matrix)}")

    m, k = matrix.shape
    m_local = _ceil_div(m, n_shards)

    # One-pass native packing (C++), NumPy fallback inside.
    from .. import native

    planar = np.iscomplexobj(matrix.data)
    complex_dtype = matrix.data.dtype if planar else None
    if planar:
        # Planar split: identical index structure, two value channels.
        rows_np, cols_np, re_np = native.csr_shard_rows(
            matrix.indptr, matrix.indices,
            np.ascontiguousarray(matrix.data.real), m, m_local,
            n_shards,
        )
        _, _, im_np = native.csr_shard_rows(
            matrix.indptr, matrix.indices,
            np.ascontiguousarray(matrix.data.imag), m, m_local,
            n_shards,
        )
        vals_np = np.stack([re_np, im_np], axis=1)  # (S, 2, nnz_pad)
    else:
        rows_np, cols_np, vals_np = native.csr_shard_rows(
            matrix.indptr, matrix.indices, matrix.data, m, m_local,
            n_shards,
        )
    rows = jnp.asarray(rows_np)
    cols = jnp.asarray(cols_np)
    vals = jnp.asarray(vals_np)

    if mesh is not None:
        from .multihost import put_sharded

        rows = put_sharded(rows, mesh, P(axis))
        cols = put_sharded(cols, mesh, P(axis))
        vals = put_sharded(vals, mesh, P(axis))

    return ShardedCSR(rows, cols, vals, (m, k), m_local, n_shards,
                      mesh=mesh, axis=axis, planar=planar,
                      complex_dtype=complex_dtype)


# ---------------------------------------------------------------------------
# Row-sharded SpMM / SpMV (no collective on the forward op)
# ---------------------------------------------------------------------------


def _complex_planes(arr):
    """Host complex array -> (re, im) float device arrays (planar)."""
    a = np.asarray(arr)
    if np.iscomplexobj(a):
        real_dt = np.float32 if a.dtype == np.complex64 else np.float64
        return (jnp.asarray(np.ascontiguousarray(a.real, dtype=real_dt)),
                jnp.asarray(np.ascontiguousarray(a.imag, dtype=real_dt)))
    return jnp.asarray(a), None


def sharded_spmm(mesh, A, b, axis="rows"):
    """C = A @ b with row-sharded A and replicated b; C is row-sharded.

    Planar-complex A (and/or complex b) runs the 4-real-product
    decomposition inside ONE SPMD program, like the single-chip planar
    path (``ops/host.py``); the result combines to complex on the
    host.  Returns the full (padded rows trimmed) array.
    """
    _check_mesh_axis(mesh, axis, A.n_shards)
    _check_contraction(A, np.shape(b)[0])
    m_local = A.m_local

    if getattr(A, "planar", False) or np.iscomplexobj(np.asarray(b)):
        br, bi = _complex_planes(b)
        if bi is None:
            bi = jnp.zeros_like(br)

        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(), P()),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
        def _local_c(rows, cols, vals, br, bi):
            r, c = rows[0], cols[0]
            if getattr(A, "planar", False):
                ar, ai = vals[0, 0], vals[0, 1]
            else:
                ar, ai = vals[0], None
            rr = _xla._spmm_scatter_oneshot(r, c, ar, br, m_local)
            ri = _xla._spmm_scatter_oneshot(r, c, ar, bi, m_local)
            if ai is not None:
                ii = _xla._spmm_scatter_oneshot(r, c, ai, bi, m_local)
                ir = _xla._spmm_scatter_oneshot(r, c, ai, br, m_local)
                return (rr - ii)[None], (ri + ir)[None]
            return rr[None], ri[None]

        cr, ci = jax.jit(_local_c)(A.rows, A.cols, A.vals, br, bi)
        out_dtype = getattr(A, "complex_dtype", None) or (
            np.complex64 if br.dtype == jnp.float32 else np.complex128
        )
        res = (np.asarray(cr) + 1j * np.asarray(ci)).astype(out_dtype)
        return res.reshape(-1, res.shape[-1])[: A.shape[0]]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    def _local(rows, cols, vals, b_rep):
        return _xla._spmm_scatter_oneshot(
            rows[0], cols[0], vals[0], b_rep, m_local
        )[None]

    c = jax.jit(_local)(A.rows, A.cols, A.vals, jnp.asarray(b))
    return c.reshape(-1, c.shape[-1])[: A.shape[0]]


def sharded_spmv(mesh, A, x, axis="rows"):
    _check_mesh_axis(mesh, axis, A.n_shards)
    _check_contraction(A, np.shape(x)[0], what="x")
    m_local = A.m_local

    if getattr(A, "planar", False) or np.iscomplexobj(np.asarray(x)):
        res = sharded_spmm(
            mesh, A, np.asarray(x).reshape(-1, 1), axis=axis
        )
        return res.reshape(-1)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    def _local(rows, cols, vals, x_rep):
        return _xla.coo_spmv(rows[0], cols[0], vals[0], x_rep,
                             m=m_local)[None]

    y = jax.jit(_local)(A.rows, A.cols, A.vals, jnp.asarray(x))
    return y.reshape(-1)[: A.shape[0]]


def sharded_spmv_halo(mesh, A, x, halo=1, axis="rows"):
    """Nearest-neighbor (halo-exchange) SpMV for BANDED row-sharded A:
    y = A @ x with x row-sharded like A and each device receiving only
    the x segments of its ±``halo`` ring neighbors (2·halo ``ppermute``
    hops of k_local elements each) instead of an all-gather of the full
    vector — the neighbour-only pattern of SURVEY §7 (halo/remote-segment
    exchange).  Communication per device is ``2·halo·k_local`` elements
    versus ``S·k_local`` for the replicated/all-gather formulation.

    Every nonzero's column must lie inside its row-shard's halo window
    ``[(s-halo)·k_local, (s+halo+1)·k_local)`` — i.e. the matrix
    bandwidth must be below ``halo · ceil(k/S)``.  Violations are
    counted in-program (one scalar readback) and raise ``ValueError``;
    use :func:`sharded_spmv` for general matrices.
    """
    _check_mesh_axis(mesh, axis, A.n_shards)
    if getattr(A, "planar", False) or np.iscomplexobj(np.asarray(x)):
        raise NotImplementedError(
            "sharded_spmv_halo supports real dtypes; use sharded_spmv"
        )
    S = A.n_shards
    m_local = A.m_local
    k = A.shape[1]
    k_local = _ceil_div(k, S)
    k_pad = S * k_local
    x_np = np.asarray(x, dtype=A.vals.dtype).ravel()
    if x_np.shape[0] != k:
        raise ValueError(f"x must have length {k}; got {x_np.shape[0]}")
    x_pad = np.zeros(k_pad, x_np.dtype)
    x_pad[:k] = x_np
    win = (2 * halo + 1) * k_local

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    def _halo(rows, cols, vals, x_block):
        s = jax.lax.axis_index(axis)
        rows, cols, vals = rows[0], cols[0], vals[0]
        xb = x_block.reshape(k_local)
        # Pull halo segments: x_{s+h} arrives by rotating "down" the
        # ring h times, x_{s-h} by rotating "up".  Each hop is issued
        # before its successor so transfers pipeline.
        down = [(i, (i - 1) % S) for i in range(S)]  # recv from right
        up = [(i, (i + 1) % S) for i in range(S)]    # recv from left
        right_parts = []
        cur = xb
        for _ in range(halo):
            cur = jax.lax.ppermute(cur, axis, down)
            right_parts.append(cur)
        left_parts = []
        cur = xb
        for _ in range(halo):
            cur = jax.lax.ppermute(cur, axis, up)
            left_parts.append(cur)
        window = jnp.concatenate(
            list(reversed(left_parts)) + [xb] + right_parts
        )
        base = (s - halo) * k_local
        lc = cols.astype(jnp.int32) - base
        live = rows < m_local
        in_win = (lc >= 0) & (lc < win)
        valid = live & in_win
        prods = jnp.where(
            valid, vals * window[jnp.clip(lc, 0, win - 1)], 0
        )
        y = jnp.zeros((m_local + 1,), vals.dtype).at[
            jnp.where(valid, rows, m_local)
        ].add(prods, mode="drop")
        dropped = jnp.sum(
            (live & ~in_win & (vals != 0)).astype(jnp.int32)
        )
        return y[None, :m_local], jax.lax.psum(dropped, axis)

    y, dropped = jax.jit(_halo)(
        A.rows, A.cols, A.vals,
        jnp.asarray(x_pad).reshape(S, k_local),
    )
    if int(dropped) != 0:
        raise ValueError(
            f"sharded_spmv_halo: {int(dropped)} nonzeros fall outside "
            f"the halo={halo} window (bandwidth exceeds "
            f"halo * ceil(k / n_shards) = {halo * k_local}); widen "
            "halo or use sharded_spmv"
        )
    return np.asarray(y).reshape(-1)[: A.shape[0]]


# ---------------------------------------------------------------------------
# k-sharded SpMM with psum (the collective-bearing layout)
# ---------------------------------------------------------------------------


def shard_csr_cols(matrix, n_shards, mesh=None, axis="cols"):
    """Column-partition A along the contraction axis: shard s owns
    columns [s*k_local, (s+1)*k_local) with LOCAL column ids."""
    _check_mesh_axis(mesh, axis, n_shards)
    if formats.is_device_sparse(matrix):
        matrix = matrix.to_scipy().tocsc()
    elif _sps.issparse(matrix):
        matrix = matrix.tocsc()
    else:
        raise ValueError(f"Expected a sparse matrix, got {type(matrix)}")
    if np.iscomplexobj(matrix.data):
        raise NotImplementedError(
            "shard_csr_cols does not implement the planar-complex "
            "strategy; use shard_csr_rows / shard_csr_grid for "
            "complex operands"
        )
    m, k = matrix.shape
    k_local = _ceil_div(k, n_shards)

    chunks = []
    nnz_pad = 1
    for s in range(n_shards):
        lo, hi = s * k_local, min((s + 1) * k_local, k)
        coo = matrix[:, lo:hi].tocoo()
        chunks.append((coo.row, coo.col, coo.data))
        nnz_pad = max(nnz_pad, coo.nnz)

    idx_dt = np.int32
    rows, cols, vals = [], [], []
    for r, c, v in chunks:
        pad = nnz_pad - r.size
        rows.append(np.concatenate([r.astype(idx_dt),
                                    np.full(pad, m, idx_dt)]))
        cols.append(np.concatenate([c.astype(idx_dt),
                                    np.zeros(pad, idx_dt)]))
        vals.append(np.concatenate([v, np.zeros(pad, v.dtype)]))

    out = ShardedCSR(
        jnp.asarray(np.stack(rows)),
        jnp.asarray(np.stack(cols)),
        jnp.asarray(np.stack(vals)),
        (m, k),
        m,
        n_shards,
        mesh=mesh,
        axis=axis,
    )
    out.k_local = k_local
    if mesh is not None:
        from .multihost import put_sharded

        out.rows = put_sharded(out.rows, mesh, P(axis))
        out.cols = put_sharded(out.cols, mesh, P(axis))
        out.vals = put_sharded(out.vals, mesh, P(axis))
    return out


def sharded_spmm_2d(mesh, A_colsharded, b, axis="cols"):
    """C = A @ b with the contraction axis sharded: device s computes
    A[:, s-block] @ b[s-block, :] and partials are psum-reduced."""
    _check_mesh_axis(mesh, axis, A_colsharded.n_shards)
    _check_contraction(A_colsharded, np.shape(b)[0])
    m = A_colsharded.shape[0]
    k_local = A_colsharded.k_local

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def _local(rows, cols, vals, b_block):
        partial = _xla._spmm_scatter_oneshot(
            rows[0], cols[0], vals[0], b_block, m
        )
        return jax.lax.psum(partial, axis)

    # Pad b's leading dim to n_shards * k_local then shard it.
    b = jnp.asarray(b)
    k_pad = A_colsharded.n_shards * k_local
    if b.shape[0] < k_pad:
        b = jnp.concatenate(
            [b, jnp.zeros((k_pad - b.shape[0], b.shape[1]), b.dtype)]
        )
    return jax.jit(_local)(
        A_colsharded.rows, A_colsharded.cols, A_colsharded.vals, b
    )


# ---------------------------------------------------------------------------
# Ring SpMM: B sharded (never replicated), blocks rotate between devices
# ---------------------------------------------------------------------------


def shard_csr_grid(matrix, n_shards, mesh=None, axis="rows"):
    """Partition A for the ring algorithm: rows into S contiguous
    blocks, and each row block's columns into S blocks aligned with
    B's row shards.  Returns a ShardedCSR whose arrays are
    (S, S, nnz_pad): shard s, column-block c, padded COO with LOCAL row
    ids and block-LOCAL column ids."""
    _check_mesh_axis(mesh, axis, n_shards)
    if formats.is_device_sparse(matrix):
        matrix = matrix.to_scipy().tocsr()
    elif _sps.issparse(matrix):
        matrix = matrix.tocsr()
    else:
        raise ValueError(f"Expected a sparse matrix, got {type(matrix)}")

    m, k = matrix.shape
    m_local = _ceil_div(m, n_shards)
    k_local = _ceil_div(k, n_shards)

    idx_dt = np.int32
    chunks = {}
    nnz_pad = 1
    for s in range(n_shards):
        rlo, rhi = s * m_local, min((s + 1) * m_local, m)
        block_rows = matrix[rlo:rhi]
        for c in range(n_shards):
            clo, chi = c * k_local, min((c + 1) * k_local, k)
            coo = block_rows[:, clo:chi].tocoo()
            chunks[s, c] = (coo.row, coo.col, coo.data)
            nnz_pad = max(nnz_pad, coo.nnz)

    planar = np.iscomplexobj(matrix.data)
    complex_dtype = matrix.data.dtype if planar else None
    real_dt = (
        (np.float32 if complex_dtype == np.complex64 else np.float64)
        if planar else matrix.data.dtype
    )
    rows = np.full((n_shards, n_shards, nnz_pad), m_local, idx_dt)
    cols = np.zeros((n_shards, n_shards, nnz_pad), idx_dt)
    vshape = (
        (n_shards, n_shards, 2, nnz_pad) if planar
        else (n_shards, n_shards, nnz_pad)
    )
    vals = np.zeros(vshape, real_dt)
    for (s, c), (r, cc, v) in chunks.items():
        rows[s, c, : r.size] = r
        cols[s, c, : cc.size] = cc
        if planar:
            vals[s, c, 0, : v.size] = v.real
            vals[s, c, 1, : v.size] = v.imag
        else:
            vals[s, c, : v.size] = v

    out = ShardedCSR(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        (m, k), m_local, n_shards, mesh=mesh, axis=axis,
        planar=planar, complex_dtype=complex_dtype,
    )
    out.k_local = k_local
    if mesh is not None:
        from .multihost import put_sharded

        out.rows = put_sharded(out.rows, mesh, P(axis))
        out.cols = put_sharded(out.cols, mesh, P(axis))
        out.vals = put_sharded(out.vals, mesh, P(axis))
    return out


def sharded_spmm_ring(mesh, A_grid, b, axis="rows", _inspect=False):
    """C = A @ b with BOTH operands sharded: A row+column blocked
    (:func:`shard_csr_grid`), b row-sharded along k.  At step t device s
    multiplies its column block (s + t) mod S against the b shard it
    currently holds, then the b shards rotate one hop with ``ppermute``
    — the canonical ring: per-device memory is |A|/S + |b|/S and
    each step's transfer can overlap the next step's compute.  No
    operand is ever replicated."""
    _check_mesh_axis(mesh, axis, A_grid.n_shards)
    _check_contraction(A_grid, np.shape(b)[0])
    S = A_grid.n_shards
    m_local = A_grid.m_local
    k_local = A_grid.k_local

    planar_a = getattr(A_grid, "planar", False)
    complex_b = np.iscomplexobj(np.asarray(b))
    if planar_a or complex_b:
        # Planar ring: b's real/imag planes travel CONCATENATED as one
        # (k_local, 2n) block — one ppermute per step, same as real.
        br, bi = _complex_planes(b)
        if bi is None:
            bi = jnp.zeros_like(br)
        b = jnp.concatenate([br, bi], axis=1)
        n = br.shape[1]
        two_n = 2 * n
    else:
        b = jnp.asarray(b)
        n = b.shape[1]
        two_n = n
    k_pad = S * k_local
    if b.shape[0] < k_pad:
        b = jnp.concatenate(
            [b, jnp.zeros((k_pad - b.shape[0], two_n), b.dtype)]
        )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis) if not (planar_a or complex_b)
        else (P(axis), P(axis)),
        check_vma=False,
    )
    def _ring(rows, cols, vals, b_block):
        s = jax.lax.axis_index(axis)
        rows, cols, vals = rows[0], cols[0], vals[0]
        b_cur = b_block.reshape(k_local, two_n)
        perm = [(i, (i - 1) % S) for i in range(S)]

        # Double-buffered schedule (round 4, SURVEY §7:497-499): each
        # step's ppermute of the b shard is issued BEFORE the compute
        # that consumes the current shard — both depend only on b_cur,
        # so the transfer can run UNDER the gather/scatter work of
        # the same step (which is exactly the overlap the double-buffer
        # needs; cross-iteration overlap through the fori_loop barrier
        # is not required).  The final rotation, whose result nobody
        # reads, is peeled off as a compute-only tail step — S-1
        # permutes for S steps.  (A fully unrolled variant measured
        # 2.4x SLOWER on the virtual CPU mesh — per-op thunk overhead
        # without any link to overlap — and was reverted; structural
        # proof of the schedule lives in tests/test_parallel.py.)

        def _compute(t, b_now, accs):
            blk = (s + t) % S
            r = jax.lax.dynamic_index_in_dim(rows, blk, keepdims=False)
            c = jax.lax.dynamic_index_in_dim(cols, blk, keepdims=False)
            v = jax.lax.dynamic_index_in_dim(vals, blk, keepdims=False)
            if not (planar_a or complex_b):
                (c_acc,) = accs
                gathered = v[:, None] * b_now[c, :]
                return (c_acc.at[r].add(gathered, mode="drop"),)
            cr_acc, ci_acc = accs
            if planar_a:
                ar, ai = v[0], v[1]
            else:
                ar, ai = v, None
            g = b_now[c, :]
            gr, gi = g[:, :n], g[:, n:]
            rr = ar[:, None] * gr
            ri = ar[:, None] * gi
            if ai is not None:
                rr = rr - ai[:, None] * gi
                ri = ri + ai[:, None] * gr
            return (
                cr_acc.at[r].add(rr, mode="drop"),
                ci_acc.at[r].add(ri, mode="drop"),
            )

        if not (planar_a or complex_b):
            accs0 = (jnp.zeros((m_local + 1, two_n), vals.dtype),)
        else:
            z = jnp.zeros((m_local + 1, n), vals.dtype)
            accs0 = (z, z)

        def step(t, carry):
            accs, b_now = carry
            # Issue the rotation FIRST: b shards flow "down" the ring
            # (next held block is (s + t + 1)) while this step's
            # compute consumes b_now.
            b_next = jax.lax.ppermute(b_now, axis, perm)
            return (_compute(t, b_now, accs), b_next)

        accs, b_last = jax.lax.fori_loop(0, S - 1, step, (accs0, b_cur))
        accs = _compute(S - 1, b_last, accs)  # peeled: no rotation

        if not (planar_a or complex_b):
            return accs[0][None, :m_local]
        return accs[0][None, :m_local], accs[1][None, :m_local]

    # b starts with shard s holding block s (the t=0 operand).
    b_sharded = b.reshape(S, k_local, two_n)
    if _inspect:
        # Debug hook: return the lowered computation so tests can
        # assert the double-buffered schedule structurally (compute
        # between collective-permute start/done in the optimized HLO).
        return jax.jit(_ring).lower(
            A_grid.rows, A_grid.cols, A_grid.vals, b_sharded
        )
    out = jax.jit(_ring)(
        A_grid.rows, A_grid.cols, A_grid.vals, b_sharded
    )
    if planar_a or complex_b:
        cr, ci = out
        out_dtype = getattr(A_grid, "complex_dtype", None) or (
            np.complex64 if cr.dtype == jnp.float32 else np.complex128
        )
        res = (np.asarray(cr) + 1j * np.asarray(ci)).astype(out_dtype)
        return res.reshape(-1, n)[: A_grid.shape[0]]
    return out.reshape(-1, n)[: A_grid.shape[0]]


# ---------------------------------------------------------------------------
# Sharded SpGEMM: row-sharded A x k-sharded sparse B over the same ring
# ---------------------------------------------------------------------------


def shard_csr_krows(matrix, n_shards, mesh=None, axis="rows"):
    """Shard a sparse B along its ROW (contraction) axis for the ring
    SpGEMM: (S, nnz_pad) padded COO with block-LOCAL row ids."""
    _check_mesh_axis(mesh, axis, n_shards)
    if _sps.issparse(matrix):
        matrix = matrix.tocsr()
    elif formats.is_device_sparse(matrix):
        matrix = matrix.to_scipy().tocsr()
    k, n = matrix.shape
    k_local = _ceil_div(k, n_shards)

    idx_dt = np.int32
    chunks = []
    nnz_pad = 1
    for s in range(n_shards):
        lo, hi = s * k_local, min((s + 1) * k_local, k)
        coo = matrix[lo:hi].tocoo()
        chunks.append((coo.row, coo.col, coo.data))
        nnz_pad = max(nnz_pad, coo.nnz)

    rows = np.full((n_shards, nnz_pad), k_local, idx_dt)
    cols = np.zeros((n_shards, nnz_pad), idx_dt)
    vals = np.zeros((n_shards, nnz_pad), matrix.data.dtype)
    for s, (r, c, v) in enumerate(chunks):
        rows[s, : r.size] = r
        cols[s, : c.size] = c
        vals[s, : v.size] = v

    out = ShardedCSR(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        (k, n), k_local, n_shards, mesh=mesh, axis=axis,
    )
    if mesh is not None:
        from .multihost import put_sharded

        out.rows = put_sharded(out.rows, mesh, P(axis))
        out.cols = put_sharded(out.cols, mesh, P(axis))
        out.vals = put_sharded(out.vals, mesh, P(axis))
    return out


def sharded_spgemm(mesh, A_grid, B_krows, axis="rows"):
    """C = A @ B with sparse A row+column blocked and sparse B sharded
    along the contraction axis (2-D work partition).  B's COO shards
    rotate around the ring while each device accumulates its m_local x n
    dense value panel AND the structural pattern panel (indicator ones
    riding the same gathers, so the output pattern matches MKL/scipy —
    cancelled entries kept).  The panels then compact to CSR arrays ON
    DEVICE per shard (``_xla.extract_sparse_masked`` under shard_map),
    so the host only ever receives nnz-sized buffers plus S counts —
    never an m x n dense array (the round-2 scaling blocker).
    Returns scipy CSR of the full product (row panels concatenated).
    """
    _check_mesh_axis(mesh, axis, A_grid.n_shards)
    _check_contraction(A_grid, B_krows.shape[0], what="B")
    import scipy.sparse as sps

    S = A_grid.n_shards
    m_local = A_grid.m_local
    k_local = A_grid.k_local
    m = A_grid.shape[0]
    n = B_krows.shape[1]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def _ring(a_rows, a_cols, a_vals, b_rows, b_cols, b_vals):
        s = jax.lax.axis_index(axis)
        a_rows, a_cols, a_vals = a_rows[0], a_cols[0], a_vals[0]
        b_r, b_c, b_v = b_rows[0], b_cols[0], b_vals[0]
        perm = [(i, (i - 1) % S) for i in range(S)]

        def step(t, carry):
            c_acc, p_acc, b_r, b_c, b_v = carry
            blk = (s + t) % S
            ar = jax.lax.dynamic_index_in_dim(a_rows, blk, keepdims=False)
            ac = jax.lax.dynamic_index_in_dim(a_cols, blk, keepdims=False)
            av = jax.lax.dynamic_index_in_dim(a_vals, blk, keepdims=False)
            # densify the current B shard locally (k_local x n); pad
            # entries carry out-of-range ids on BOTH operands, so the
            # indicator panels see only stored entries.
            b_dense = jnp.zeros((k_local + 1, n), b_v.dtype).at[
                b_r, b_c
            ].add(b_v, mode="drop")
            b_ind = jnp.zeros((k_local + 1, n), jnp.float32).at[
                b_r, b_c
            ].set(1.0, mode="drop")
            gathered = av[:, None] * b_dense[ac, :]
            c_acc = c_acc.at[ar].add(gathered, mode="drop")
            p_acc = p_acc.at[ar].add(b_ind[ac, :], mode="drop")
            b_r = jax.lax.ppermute(b_r, axis, perm)
            b_c = jax.lax.ppermute(b_c, axis, perm)
            b_v = jax.lax.ppermute(b_v, axis, perm)
            return (c_acc, p_acc, b_r, b_c, b_v)

        c0 = jnp.zeros((m_local + 1, n), a_vals.dtype)
        p0 = jnp.zeros((m_local + 1, n), jnp.float32)
        c_acc, p_acc, _, _, _ = jax.lax.fori_loop(
            0, S, step, (c0, p0, b_r, b_c, b_v)
        )
        return c_acc[None, :m_local], p_acc[None, :m_local]

    panels, patterns = jax.jit(_ring)(
        A_grid.rows, A_grid.cols, A_grid.vals,
        B_krows.rows, B_krows.cols, B_krows.vals,
    )

    # Per-shard structural counts: an (S,)-sized transfer, the only
    # sizing sync.
    counts = np.asarray(
        jax.jit(lambda p: (p > 0).sum(axis=(1, 2), dtype=jnp.int32))(
            patterns
        )
    )
    nnz_cap = 1
    while nnz_cap < int(counts.max(initial=1)):
        nnz_cap <<= 1

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def _extract(c_panel, p_panel):
        vals, cols, indptr = _xla.extract_sparse_masked(
            c_panel[0], (p_panel[0] > 0).reshape(-1), nnz=nnz_cap
        )
        return vals[None], cols[None], indptr[None]

    vals_s, cols_s, indptr_s = jax.jit(_extract)(panels, patterns)
    vals_np = np.asarray(vals_s)
    cols_np = np.asarray(cols_s)
    indptr_np = np.asarray(indptr_s).astype(np.int64)

    # Host assembly from the compacted per-shard buffers.
    data_parts, idx_parts, count_parts = [], [], []
    for s in range(S):
        cnt = int(counts[s])
        rows_here = min(m_local, m - s * m_local)
        if rows_here <= 0:
            break
        data_parts.append(vals_np[s, :cnt])
        idx_parts.append(cols_np[s, :cnt])
        count_parts.append(np.diff(indptr_np[s, : rows_here + 1]))
    data = np.concatenate(data_parts) if data_parts else np.zeros(0)
    idx = np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int32)
    row_counts = (
        np.concatenate(count_parts) if count_parts
        else np.zeros(m, np.int64)
    )
    indptr = np.concatenate([[0], np.cumsum(row_counts)])
    return sps.csr_matrix((data, idx, indptr), shape=(m, n))


# ---------------------------------------------------------------------------
# Sharded gram and CG
# ---------------------------------------------------------------------------


def sharded_gram(mesh, A, axis="rows"):
    """AᵀA via row-sharded A: each device computes its rows' outer
    contribution (Aᵀ_s A_s) and the results are psum-reduced — the
    distributed syrk."""
    _check_mesh_axis(mesh, axis, A.n_shards)
    if getattr(A, "planar", False) or np.dtype(A.dtype).kind == "c":
        raise NotImplementedError(
            "sharded_gram supports real dtypes only"
        )
    m_local = A.m_local
    k = A.shape[1]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def _local(rows, cols, vals):
        a_local = jnp.zeros((m_local, k), vals.dtype).at[
            rows[0], cols[0]
        ].add(vals[0], mode="drop")
        partial = jnp.dot(
            a_local.T, a_local, precision=_HIGHEST
        )
        return jax.lax.psum(partial, axis)

    return jax.jit(_local)(A.rows, A.cols, A.vals)


def sharded_cg(mesh, A, b, tol=1e-10, maxiter=1000, axis="rows"):
    """Distributed CG on a row-sharded SPD matrix: the matvec runs
    sharded and re-replicates via all_gather inside the jitted
    while_loop; reductions stay replicated."""
    _check_mesh_axis(mesh, axis, A.n_shards)
    if getattr(A, "planar", False) or np.dtype(A.dtype).kind == "c":
        raise NotImplementedError(
            "sharded_cg supports real dtypes only"
        )
    m = A.shape[0]
    m_local = A.m_local
    n_pad = A.n_shards * m_local

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )
    def _matvec(rows, cols, vals, x):
        y_local = _xla.coo_spmv(rows[0], cols[0], vals[0], x, m=m_local)
        y = jax.lax.all_gather(y_local, axis)
        return y.reshape(-1)

    @jax.jit
    def _solve(rows, cols, vals, b_pad):
        def mv(x):
            return _matvec(rows, cols, vals, x)[:m].at[:].get()

        def mv_pad(x):
            y = mv(x[: m])
            return jnp.concatenate([y, jnp.zeros(n_pad - m, y.dtype)])

        x0 = jnp.zeros_like(b_pad)
        r0 = b_pad - mv_pad(x0)

        def cond(state):
            _, r, _, rs, it = state
            return jnp.logical_and(
                jnp.sqrt(rs) > tol, it < maxiter
            )

        def body(state):
            x, r, p, rs, it = state
            ap = mv_pad(p)
            alpha = rs / jnp.vdot(p, ap, precision=_HIGHEST)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.vdot(r, r, precision=_HIGHEST)
            p = r + (rs_new / rs) * p
            return (x, r, p, rs_new, it + 1)

        state = (x0, r0, r0, jnp.vdot(r0, r0, precision=_HIGHEST), 0)
        x, _, _, rs, it = jax.lax.while_loop(cond, body, state)
        return x, rs, it

    b = np.asarray(b).ravel()
    b_pad = jnp.concatenate(
        [jnp.asarray(b), jnp.zeros(n_pad - m, jnp.asarray(b).dtype)]
    )
    x, rs, it = _solve(A.rows, A.cols, A.vals, b_pad)
    return np.asarray(x)[:m], float(jnp.sqrt(rs)), int(it)


def sharded_cgls(mesh, A, b, tol=1e-12, maxiter=500, axis="rows"):
    """Distributed least squares min ||Ax - b|| via CGLS on a
    row-sharded A: the forward matvec re-replicates with ``all_gather``;
    the adjoint matvec psum-reduces per-shard partials.  This is the
    sharded analog of the reference's ``sparse_qr_solve_mkl`` for
    matrices too large for one chip (BASELINE.md config 5).
    """
    _check_mesh_axis(mesh, axis, A.n_shards)
    if getattr(A, "planar", False) or np.dtype(A.dtype).kind == "c":
        raise NotImplementedError(
            "sharded_cgls supports real dtypes only"
        )
    m, k = A.shape
    m_local = A.m_local
    m_pad = A.n_shards * m_local

    solve = _cgls_program(
        mesh, axis, int(A.n_shards), int(m_local), int(k),
        float(tol), int(maxiter),
    )

    b = np.asarray(b).ravel()
    b_pad = jnp.concatenate(
        [jnp.asarray(b), jnp.zeros(m_pad - m, jnp.asarray(b).dtype)]
    )
    # Column norms from the padded COO shards (pad slots carry zero
    # values, so they contribute nothing); one C-speed host pass,
    # memoized per value buffer (multi-RHS callers loop columns).
    dcache = getattr(A, "_cgls_dcache", None)
    if dcache is not None and dcache[0] is A.vals:
        d_np = dcache[1]
    else:
        vals_np = np.asarray(A.vals).reshape(-1).astype(np.float64)
        cols_np = np.asarray(A.cols).reshape(-1)
        sq = np.bincount(
            cols_np, weights=vals_np * vals_np, minlength=k
        )[:k]
        norms = np.sqrt(sq)
        d_np = np.where(norms > 0, 1.0 / np.maximum(norms, 1e-300), 1.0)
        try:
            A._cgls_dcache = (A.vals, d_np)
        except Exception:
            pass
    x, res, it = solve(
        A.rows, A.cols, A.vals, b_pad, jnp.asarray(d_np, b_pad.dtype)
    )
    return np.asarray(x), float(res), int(it)


@functools.lru_cache(maxsize=32)
def _cgls_program(mesh, axis, n_shards, m_local, k, tol, maxiter):
    """Compiled distributed-CGLS program, cached per (mesh, shapes,
    tol, maxiter).  Defining the jitted closure inside sharded_cgls
    recompiled the whole while_loop on EVERY call — a 20-column
    multi-RHS solve paid 20 identical XLA compiles (review r5
    finding)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )
    def _fwd(rows, cols, vals, x):
        y_local = _xla.coo_spmv(rows[0], cols[0], vals[0], x, m=m_local)
        return jax.lax.all_gather(y_local, axis).reshape(-1)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def _adj(rows, cols, vals, y_sharded):
        # swap row/col roles: A_s^T y_s, then sum over shards
        partial_ = _xla.coo_spmv(
            cols[0], rows[0], vals[0], y_sharded[0], m=k
        )
        return jax.lax.psum(partial_, axis)

    @jax.jit
    def _solve(rows, cols, vals, b_pad, d):
        # Jacobi right preconditioner (column equilibration): solve the
        # scaled system min ||(A diag(d)) y - b|| and return x = d*y —
        # bounds iteration growth on ill-conditioned systems, matching
        # the single-chip CGLS route (solvers/qr.py, round 5).
        def fwd(x):
            return _fwd(rows, cols, vals, d * x)

        def adj(y):
            return d * _adj(
                rows, cols, vals, y.reshape(n_shards, m_local)
            )

        x0 = jnp.zeros((k,), b_pad.dtype)
        r0 = b_pad - fwd(x0)
        s0 = adj(r0)

        def cond(state):
            x, r, p, s_norm2, it = state
            return jnp.logical_and(jnp.sqrt(s_norm2) > tol, it < maxiter)

        def body(state):
            x, r, p, s_norm2, it = state
            q = fwd(p)
            alpha = s_norm2 / jnp.vdot(q, q, precision=_HIGHEST)
            x = x + alpha * p
            r = r - alpha * q
            s = adj(r)
            s_norm2_new = jnp.vdot(s, s, precision=_HIGHEST)
            beta = s_norm2_new / s_norm2
            p = s + beta * p
            return (x, r, p, s_norm2_new, it + 1)

        state = (x0, r0, s0, jnp.vdot(s0, s0, precision=_HIGHEST), 0)
        x, r, _, s2, it = jax.lax.while_loop(cond, body, state)
        return d * x, jnp.linalg.norm(r), it

    return _solve

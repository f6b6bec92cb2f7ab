"""Ozaki-scheme float64 matmul from bf16 tensor-core passes.

A device without a native float64 unit emulates an f64 ``dot_general``
far below its bf16 matrix rate.  This module recovers near-f64 matmul
accuracy from bf16 passes with f32 accumulation using the Ozaki
splitting scheme:

1.  Each f64 operand is viewed as a double-float32 pair (``hi + lo``,
    exact to ~2^-49 relative — the same contract as the library's
    hi/lo-split densify, see ``_xla.sorted_set_scatter``).
2.  Per output-row (lhs) / output-column (rhs) the values are scaled by
    a power of two so every entry lies in (-1, 1), then split into ``D``
    bf16 slices of ``t`` mantissa bits each, aligned to a shared
    power-of-two grid.  Slice extraction uses the Dekker round-to-grid
    trick ``(rem + 1.5*2^p) - 1.5*2^p`` — every step is exact in f32.
3.  ``t`` is chosen so pairwise slice products accumulated over the
    contraction length K stay below 2^24: the f32 accumulation of
    bf16 products is then *exact* (integers on a common grid).
4.  The ~D(D+1)/2 significant pairwise products (i + j < D) are summed
    in f64 (cheap elementwise), and the power-of-two row/column scales
    are re-applied with ``ldexp``.

Accuracy: |error| <~ 2^-49 * rowmax(A) * colmax(B) * K — inside the
reference suite's decimal=6 tolerance by ~6 orders of magnitude (the
reference tests f64 at decimal=6, ``tests/test_mkl.py:53-67``).

This serves the f64 members of the MKL kernel families the framework
replaces (``/root/reference/sparse_dot_mkl/_mkl_interface/_cfunctions.py``):
``mkl_sparse_d_mm`` (SpMM via densified operand), ``mkl_sparse_spmm`` /
``mkl_sparse_d_spmmd`` (SpGEMM numeric phase), ``cblas_dgemm``, and
``mkl_sparse_syrk`` / ``cblas_dsyrk``.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


def plan(k):
    """(t, D, d_join) for contraction length ``k``.

    ``t``: slice width in bits such that K * 2^(2t) <= 2^24 (exact f32
    accumulation), capped at 8 (bf16 mantissa).  ``D``: slice count
    covering the double-f32 significand (~50 bits).  ``d_join``: slice
    round at which the ``lo`` word folds into the remainder (chosen so
    slice magnitudes stay within t bits: d_join * t <= 23).
    """
    kk = max(int(k), 2)
    t = (24 - int(np.ceil(np.log2(kk)))) // 2
    t = min(8, t)
    if t < 1:
        return 0, 0, 0  # contraction too long for exact f32 accumulation
    D = int(np.ceil(50.0 / t))
    d_join = min(23 // t, D - 1)
    return t, D, d_join


def supported(k):
    return plan(k)[0] >= 1


def enabled(dtype, k, mkn):
    """Policy gate, evaluated outside jit: Ozaki replaces an emulated
    f64 ``dot_general`` on a backend without native f64 when the matmul
    is big enough to amortize slice extraction.  A native-f64 backend
    (CPU, GPU) always takes the plain f64 product under ``auto``.
    ``SPARSE_DOT_OZAKI=0`` turns it off; ``=1`` forces it everywhere
    (used by the accuracy tests)."""
    from ..config import config

    mode = getattr(config, "ozaki", "auto")
    if mode in ("0", "never", False):
        return False
    if jnp.dtype(dtype) != jnp.float64:
        return False
    if not supported(k):
        return False
    if mode in ("1", "always", True):
        return True
    from ..backend import has_native_f64

    return not has_native_f64() and mkn >= (1 << 21)


# Clears the low 29 of f64's 52 mantissa bits: what remains has f32's
# 24-bit significand.
_HI_MASK = np.uint64(0xFFFFFFFFE0000000)


def hilo(x64):
    """f64 -> double-float32 (hi, lo) pair, hi + lo = x to ~2^-47.

    ``hi`` is ``x`` with its mantissa truncated to f32 width by a bit
    mask, so it converts to f32 exactly and ``x - hi`` is exact in f64.
    Not ``hi = f32(x); lo = f32(x - f64(hi))``: XLA may drop the
    f64 -> f32 -> f64 round trip as excess precision (XLA:GPU does by
    default), which leaves ``lo = 0`` and f32 accuracy."""
    bits = lax.bitcast_convert_type(x64, jnp.uint64)
    hi64 = lax.bitcast_convert_type(bits & _HI_MASK, jnp.float64)
    return hi64.astype(jnp.float32), (x64 - hi64).astype(jnp.float32)


def _require_supported(k):
    """Clear error at the public entry instead of a cryptic
    ``jnp.stack([])`` failure deep inside jit when the contraction is
    too long for exact bf16-slice accumulation (review r5 finding)."""
    if not supported(k):
        raise ValueError(
            f"Ozaki f64 matmul does not support contraction length "
            f"{k} (exact bf16-slice accumulation needs k <= 2^22); "
            "disable with SPARSE_DOT_OZAKI=0 or use the non-Ozaki path"
        )


def _extract_slices(hi, lo, contract_axis, t, D, d_join):
    """Split a (hi, lo) f32 pair into D bf16 slices plus per-row (or
    per-column) power-of-two exponents.

    Returns (slices (D, *x.shape) bf16, e int32 over the non-contract
    axis).  All arithmetic is exact: power-of-two scaling, Dekker
    round-to-grid, and Sterbenz subtraction.
    """
    maxabs = jnp.max(jnp.abs(hi), axis=contract_axis, keepdims=True)
    _, e = jnp.frexp(maxabs)  # maxabs = m * 2^e, m in [0.5, 1); e=0 at 0
    # Scale into (-1, 1) by 2^-e applied SEQUENTIALLY in two exact
    # power-of-two steps.  NOT as a single combined factor
    # ldexp(1,-e1)*ldexp(1,-e2): for |e| >= ~127 that product itself
    # overflows to inf (tiny operands) or goes subnormal (operands
    # near 1e38 — inside the library's 3e38 hi|lo gate), corrupting
    # every slice (review r5 finding, verified numerically).  Each
    # sequential half stays a normal f32, and each multiply is exact.
    e1 = e // 2
    e2 = e - e1
    one = jnp.ones_like(maxabs)
    s1 = jnp.ldexp(one, -e1)
    s2 = jnp.ldexp(one, -e2)
    rem = (hi * s1) * s2
    lo_n = (lo * s1) * s2
    slices = []
    for d in range(D):
        if d == d_join:
            rem = rem + lo_n
        # rem rounded to grid 2^(-(d+1)t): scale up by an exact power
        # of two, round to integer (|int| <= 2^t, exact in f32), scale
        # back.  NOT the classic (x + sigma) - sigma Dekker trick —
        # XLA's algebraic simplifier folds that to x inside a fused
        # program, collapsing every slice into slice 0; round() is a
        # real op the simplifier must preserve, and the whole loop
        # fuses into a single elementwise pass.
        up = jnp.float32(2.0 ** ((d + 1) * t))
        down = jnp.float32(2.0 ** (-(d + 1) * t))
        s = jnp.round(rem * up) * down
        if d + 1 < D:
            rem = rem - s
        slices.append(s.astype(jnp.bfloat16))
    return jnp.stack(slices), jnp.squeeze(e, axis=contract_axis)


def _pow2_f64(e):
    """2.0**e as f64 for an int32 array ``e`` (|e| <= ~490), built from
    four exact f32 ldexp quarters multiplied in f64 (no f64
    ``ldexp``/``frexp``, which a pair-emulated f64 may lack); the
    earlier two-half form overflowed f32 at |e| >= 255, which
    is reachable: both operands' row maxima near 3e38 (inside the
    hi|lo gate) give an exponent sum of 256 (review r5 finding)."""
    q = e // 4
    r = e - 3 * q
    one = jnp.ones(np.shape(e), jnp.float32)
    pq = jnp.ldexp(one, q).astype(jnp.float64)
    return pq * pq * pq * jnp.ldexp(one, r).astype(jnp.float64)


def _pair_products_sum(a_sl, a_contract, b_sl, b_contract, D):
    """sum_{i+j<D} A_i . B_j accumulated in f64.

    The rhs slices are concatenated along their non-contract axis so
    slice i of the lhs multiplies slices 0..D-1-i of the rhs in ONE
    matmul (reads A_i from device memory once); the per-j blocks of the
    product are then summed in f64 — their slice weights are already
    baked into the slice values, so the blocks just add.
    """
    nc_b = 1 - b_contract
    Db, p, q = b_sl.shape
    if nc_b == 0:
        b_cat = b_sl.reshape(Db * p, q)
        nb = p
    else:
        b_cat = jnp.moveaxis(b_sl, 0, 1).reshape(p, Db * q)
        nb = q
    c = None
    for i in range(D):
        w = (D - i) * nb
        rhs = b_cat[:w] if nc_b == 0 else b_cat[:, :w]
        p_i = lax.dot_general(
            a_sl[i], rhs,
            (((a_contract,), (b_contract,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        contrib = jnp.sum(
            p_i.reshape(p_i.shape[0], D - i, nb), axis=1,
            dtype=jnp.float64,
        )
        c = contrib if c is None else c + contrib
    return c


@partial(jax.jit, static_argnames=("a_contract", "b_contract"))
def matmul_hilo(a_hi, a_lo, b_hi, b_lo, a_contract=1, b_contract=0):
    """f64-accurate product of two double-f32 operands from bf16 passes.

    ``a_contract`` / ``b_contract`` name the contraction axis of each
    operand; output is (lhs non-contract, rhs non-contract) in f64.
    """
    k = a_hi.shape[a_contract]
    _require_supported(k)
    t, D, dj = plan(k)
    a_sl, a_e = _extract_slices(a_hi, a_lo, a_contract, t, D, dj)
    b_sl, b_e = _extract_slices(b_hi, b_lo, b_contract, t, D, dj)
    c = _pair_products_sum(a_sl, a_contract, b_sl, b_contract, D)
    return c * _pow2_f64(a_e[:, None] + b_e[None, :])


@partial(jax.jit, static_argnames=("contract",))
def syrk_hilo(a_hi, a_lo, contract=1):
    """A @ A^T (contracting ``contract`` on both sides) from a single
    slice extraction — the gram / X @ X.T fast path."""
    k = a_hi.shape[contract]
    _require_supported(k)
    t, D, dj = plan(k)
    a_sl, a_e = _extract_slices(a_hi, a_lo, contract, t, D, dj)
    c = _pair_products_sum(a_sl, contract, a_sl, contract, D)
    return c * _pow2_f64(a_e[:, None] + a_e[None, :])


def planar_from_slices(ar, ai, br, bi, a_contract=1, b_contract=0,
                       syrk=False):
    """(Re, Im) planar product from pre-extracted per-channel slices —
    each channel arg is a ``(slices, exponents)`` pair.  ``syrk=True``
    computes A @ A^T (Im = P + P^T from a single cross product: three
    pair-product sets instead of four).  Not jitted — callers fuse it
    into larger programs."""
    ar_s, ar_e = ar
    ai_s, ai_e = ai
    D = ar_s.shape[0]
    if syrk:
        rr = _pair_products_sum(ar_s, a_contract, ar_s, a_contract, D)
        rr = rr * _pow2_f64(ar_e[:, None] + ar_e[None, :])
        ii = _pair_products_sum(ai_s, a_contract, ai_s, a_contract, D)
        ii = ii * _pow2_f64(ai_e[:, None] + ai_e[None, :])
        ri = _pair_products_sum(ar_s, a_contract, ai_s, a_contract, D)
        ri = ri * _pow2_f64(ar_e[:, None] + ai_e[None, :])
        return rr - ii, ri + ri.T
    br_s, br_e = br
    bi_s, bi_e = bi

    def prod(a_s, a_e, b_s, b_e):
        c = _pair_products_sum(a_s, a_contract, b_s, b_contract, D)
        return c * _pow2_f64(a_e[:, None] + b_e[None, :])

    re = prod(ar_s, ar_e, br_s, br_e) - prod(ai_s, ai_e, bi_s, bi_e)
    im = prod(ar_s, ar_e, bi_s, bi_e) + prod(ai_s, ai_e, br_s, br_e)
    return re, im


def matmul_hilo_planar(ar_hi, ar_lo, ai_hi, ai_lo,
                       br_hi, br_lo, bi_hi, bi_lo,
                       a_contract=1, b_contract=0, syrk=False):
    """(Re, Im) of (Ar + iAi) @ (Br + iBi) with SHARED slice
    extractions: each planar channel is sliced once and reused across
    the pair products, where four separate ``matmul_hilo`` calls would
    slice eight times.  ``syrk=True`` computes A @ A^T (B is A's
    transpose view).

    Not jitted here — callers fuse it into larger programs.
    """
    k = ar_hi.shape[a_contract]
    t, D, dj = plan(k)
    ar = _extract_slices(ar_hi, ar_lo, a_contract, t, D, dj)
    ai = _extract_slices(ai_hi, ai_lo, a_contract, t, D, dj)
    if syrk:
        return planar_from_slices(ar, ai, None, None,
                                  a_contract=a_contract, syrk=True)
    br = _extract_slices(br_hi, br_lo, b_contract, t, D, dj)
    bi = _extract_slices(bi_hi, bi_lo, b_contract, t, D, dj)
    return planar_from_slices(ar, ai, br, bi, a_contract=a_contract,
                              b_contract=b_contract)


@partial(jax.jit, static_argnames=("shape", "contract"))
def extract_slices_jit(hi, lo, shape, contract):
    """Standalone slice extraction (the cacheable inspector step):
    (hi, lo) f32 planes of ``shape`` -> (slices (D, *shape) bf16,
    exponents over the non-contract axis).  Exact — computing from the
    cached slices is bit-identical to the inline extraction inside
    :func:`matmul_hilo`/:func:`syrk_hilo`."""
    t, D, dj = plan(shape[contract])
    return _extract_slices(hi, lo, contract, t, D, dj)


def matmul_from_slices(a_sl, a_e, b_sl, b_e, a_contract=1, b_contract=0):
    """Pair-product matmul from PRE-EXTRACTED slices (both sides
    share one ``plan`` since they share the contraction length).  Not
    jitted — callers fuse it into larger programs."""
    D = a_sl.shape[0]
    c = _pair_products_sum(a_sl, a_contract, b_sl, b_contract, D)
    return c * _pow2_f64(a_e[:, None] + b_e[None, :])


def syrk_from_slices(a_sl, a_e, contract=1):
    """A @ A^T from pre-extracted slices."""
    D = a_sl.shape[0]
    c = _pair_products_sum(a_sl, contract, a_sl, contract, D)
    return c * _pow2_f64(a_e[:, None] + a_e[None, :])


@partial(jax.jit, static_argnames=("a_contract", "b_contract"))
def matmul_f64(a, b, a_contract=1, b_contract=0):
    """Dense f64 x f64 matmul via the Ozaki scheme (cblas_dgemm analog
    for a device without native f64)."""
    ah, al = hilo(a)
    bh, bl = hilo(b)
    return matmul_hilo(ah, al, bh, bl, a_contract=a_contract,
                       b_contract=b_contract)


@partial(jax.jit, static_argnames=("contract",))
def syrk_f64(a, contract=1):
    ah, al = hilo(a)
    return syrk_hilo(ah, al, contract=contract)

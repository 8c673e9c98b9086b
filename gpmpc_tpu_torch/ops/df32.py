"""Double-float32 (df32) arithmetic in PyTorch: f64-grade accuracy from f32 ops.

Port of ``gpmpc_tpu/ops/df32.py``. A df number is an exact pair (hi, lo) of
float32 tensors whose value is hi + lo with |lo| <= ulp(hi)/2. Every f32 add
and multiply splits exactly into a rounded result and its rounding error
(Knuth two-sum, Dekker two-prod), so the cancellation-heavy moment-matching
reductions keep ~44 bits where plain f32 keeps 24.

Each eager PyTorch op is its own kernel, so no multiply is ever contracted
with an add into an FMA here (the failure ``_split12`` guards against on
backends that contract). The CUDA kernels share the same arithmetic through
``csrc/df32.cuh``, written with intrinsics that are never contracted.

Derivatives follow the JAX package: ``df_mul`` and ``df_exp`` are
``torch.autograd.Function``s whose tangent is (dv, 0) on the collapsed value,
so their backward reads the hi cotangent only and gives both input halves
the same gradient; everything else is differentiated by autograd through the
error-free transformations, whose lo channels carry zero tangent.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

DF = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a, b) -> DF:
    """Exact: a + b = s + e with s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> DF:
    """Exact when |a| >= |b|: a + b = s + e."""
    s = a + b
    e = b - (s - a)
    return s, e


# 0xFFFFF000 as an int32: keeps the sign, the exponent and the top 11 stored
# significand bits, so each half of the split carries <= 12 bits
_SPLIT_MASK = -4096


def _split12(a: torch.Tensor) -> DF:
    """Truncating 12-bit significand split by masking the mantissa. The hi
    half is detached: autograd then sees the tangent (0, da), as JAX does
    through its bitcast."""
    ah = (a.detach().view(torch.int32) & _SPLIT_MASK).view(torch.float32)
    return ah, a - ah


def _split12_const(c: float) -> Tuple[float, float]:
    """_split12 of an f32 constant, on the host."""
    ch = float((np.asarray(c, np.float32).view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32))
    return ch, float(np.float32(c) - np.float32(ch))


def two_prod(a: torch.Tensor, b: torch.Tensor) -> DF:
    """Exact product a * b = p + e. Every partial product has <= 24
    significant bits and is exact; the add-only two_sum chains catch every
    rounding error."""
    a, b = torch.broadcast_tensors(a, b)
    ah, al = _split12(a)
    bh, bl = _split12(b)
    return _two_prod_parts(ah, al, bh, bl)


def _two_prod_parts(ah, al, bh, bl) -> DF:
    hh = ah * bh
    m1 = ah * bl
    m2 = al * bh
    ll = al * bl
    s, e1 = two_sum(m1, m2)
    p, e2 = two_sum(hh, s)
    return fast_two_sum(p, (e1 + e2) + ll)


def df_add(xh, xl, yh, yl) -> DF:
    """(xh+xl) + (yh+yl) with relative error O(eps^2)."""
    sh, se = two_sum(xh, yh)
    se = se + (xl + yl)
    return fast_two_sum(sh, se)


def df_add_f32(xh, xl, y) -> DF:
    sh, se = two_sum(xh, y)
    se = se + xl
    return fast_two_sum(sh, se)


def _df_mul(xh, xl, yh, yl) -> DF:
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def _sum_to(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return g if g.shape == like.shape else g.sum_to_size(like.shape)


class _DfMul(torch.autograd.Function):
    """df_mul with the JAX custom JVP: tangent (dv, 0) with
    dv = (dxh+dxl)(yh+yl) + (dyh+dyl)(xh+xl)."""

    @staticmethod
    def forward(ctx, xh, xl, yh, yl):
        ctx.save_for_backward(xh, xl, yh, yl)
        return _df_mul(xh, xl, yh, yl)

    @staticmethod
    def backward(ctx, g_hi, g_lo):
        xh, xl, yh, yl = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gx = g_hi * (yh + yl)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            gy = g_hi * (xh + xl)
        return (None if gx is None else _sum_to(gx, xh), None if gx is None else _sum_to(gx, xl),
                None if gy is None else _sum_to(gy, yh), None if gy is None else _sum_to(gy, yl))


def df_mul(xh, xl, yh, yl) -> DF:
    """(xh+xl) * (yh+yl) with relative error O(eps^2)."""
    return _DfMul.apply(xh, xl, yh, yl)


def df_mul_f32(xh, xl, y) -> DF:
    """(xh+xl) * y for a plain-f32 y."""
    ph, pe = two_prod(xh, y)
    pe = pe + xl * y
    return fast_two_sum(ph, pe)


def df_neg(xh, xl) -> DF:
    return -xh, -xl


def df_div(xh, xl, yh, yl) -> DF:
    """(xh+xl) / (yh+yl): one Newton step on the f32 quotient."""
    q1 = xh / yh
    ph, pe = two_prod(q1, yh)
    rh, rl = df_add(xh, xl, -ph, -(pe + q1 * yl))
    q2 = (rh + rl) / yh
    return fast_two_sum(q1, q2)


def df_sqrt(xh, xl) -> DF:
    """sqrt(xh+xl): one Heron step on the f32 root."""
    s1 = torch.sqrt(xh)
    ph, pe = two_prod(s1, s1)
    rh, rl = df_add(xh, xl, -ph, -pe)
    s2 = (rh + rl) / (2.0 * s1)
    return fast_two_sum(s1, s2)


def df_sum(hi, lo, axis: int = -1) -> DF:
    """Compensated reduction along ``axis``: a pairwise-halving tree of
    df_add (odd tails zero-padded), pairs taken as ``0::2`` and ``1::2``."""
    hi = hi.movedim(axis, -1)
    lo = lo.movedim(axis, -1)
    n = hi.shape[-1]
    while n > 1:
        if n % 2 == 1:
            hi = torch.nn.functional.pad(hi, (0, 1))
            lo = torch.nn.functional.pad(lo, (0, 1))
            n += 1
        hi, lo = df_add(hi[..., 0::2], lo[..., 0::2], hi[..., 1::2], lo[..., 1::2])
        n //= 2
    return hi[..., 0], lo[..., 0]


def df_dot_f32(a, bh, bl, axis: int = -1) -> DF:
    """Compensated sum_k a[k] * (bh[k] + bl[k]) with a in plain f32."""
    ph, pe = two_prod(a, bh)
    pe = pe + a * bl
    return df_sum(ph, pe, axis=axis)


_LN2_64 = math.log(2.0)
_LN2_HI = float(np.float32(_LN2_64))
_LN2_LO = float(np.float32(_LN2_64 - _LN2_HI))
_LN2_HI_SPLIT = _split12_const(_LN2_HI)
_INV_LN2 = float(np.float32(1.0 / _LN2_64))
# 1/n! for the degree-12 Taylor of exp on |r| <= ln2/2 as f32 (hi, lo) pairs,
# highest degree first (Horner order)
_EXP_COEF = [
    (float(np.float32(c)), float(np.float32(c - float(np.float32(c)))))
    for c in [1.0 / math.factorial(n) for n in range(12, -1, -1)]
]


def _df_exp(xh, xl) -> DF:
    """Range reduction k = round(x / ln2) (half to even), r = x - k ln2 in df,
    a degree-12 df Horner of exp(r), then a scale by 2^k built bitwise as
    (k + 127) << 23, k < -126 flushed to 0 (no f32 exp2 approximation)."""
    k = torch.round(xh * _INV_LN2)
    kh, kl = _split12(k)
    ph, pe = _two_prod_parts(kh, kl, *_LN2_HI_SPLIT)
    pe = pe + k * _LN2_LO
    th, tl = fast_two_sum(ph, pe)
    rh, rl = df_add(xh, xl, -th, -tl)

    eh = torch.full_like(xh, _EXP_COEF[0][0])
    el = torch.full_like(xh, _EXP_COEF[0][1])
    for ch, cl in _EXP_COEF[1:]:
        eh, el = _df_mul(eh, el, rh, rl)
        eh, el = df_add(eh, el, ch, cl)

    ki = torch.clamp(k, -127.0, 127.0).to(torch.int32)
    scale = ((ki + 127) << 23).view(torch.float32)
    scale = torch.where(k < -126, torch.zeros((), dtype=scale.dtype, device=scale.device), scale)
    return eh * scale, el * scale


class _DfExp(torch.autograd.Function):
    """df_exp with the JAX custom JVP: tangent ((dxh+dxl)(eh+el), 0)."""

    @staticmethod
    def forward(ctx, xh, xl):
        eh, el = _df_exp(xh, xl)
        ctx.save_for_backward(eh, el)
        return eh, el

    @staticmethod
    def backward(ctx, g_hi, g_lo):
        eh, el = ctx.saved_tensors
        g = g_hi * (eh + el)
        return g, g


def df_exp(xh, xl) -> DF:
    """exp of a df number as a df, accurate to ~1e-13 relative."""
    return _DfExp.apply(xh, xl)


def split_f64(x: torch.Tensor) -> DF:
    """float64 -> f32 (hi, lo): hi = f32(x), lo = f32(x - hi)."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo

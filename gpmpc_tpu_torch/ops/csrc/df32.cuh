// Double-float32 (df32) device functions: f64-grade sums and products from
// f32 instructions. Port of gpmpc_tpu/ops/df32.py (two_sum, fast_two_sum, the
// 12-bit mask split, two_prod, df_add, df_add_f32, df_mul, df_mul_f32,
// df_div, df_sqrt, df_exp) with the same operation order, so a kernel built
// on them computes what the PyTorch twins in gpmpc_tpu_torch/ops/df32.py
// compute, bit for bit, before its reductions.
//
// Every add and multiply is written with __fadd_rn / __fsub_rn / __fmul_rn.
// nvcc contracts a*b + c into an FMA by default (--fmad=true), which would
// drop exactly the rounding steps the error-free transformations rely on;
// these intrinsics are never contracted, so the rest of the build keeps its
// default. df_exp never calls expf/exp2f: 2^k is assembled bitwise; df_div
// and df_sqrt use the correctly rounded __fdiv_rn and __fsqrt_rn, as the
// twins' IEEE division and square root are.

#pragma once

#include <cuda_runtime.h>

namespace gpmpc_df {

struct df {
  float h, l;  // value h + l, |l| <= ulp(h) / 2
};

__device__ __forceinline__ df two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

// exact when |a| >= |b|
__device__ __forceinline__ df fast_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

// the top 12 significand bits (sign and exponent kept): each half of the
// split carries <= 12 bits, so the partial products of two_prod are exact
__device__ __forceinline__ float split_hi(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xFFFFF000u);
}

__device__ __forceinline__ df two_prod(float a, float b) {
  const float ah = split_hi(a);
  const float al = __fsub_rn(a, ah);
  const float bh = split_hi(b);
  const float bl = __fsub_rn(b, bh);
  const float hh = __fmul_rn(ah, bh);
  const float m1 = __fmul_rn(ah, bl);
  const float m2 = __fmul_rn(al, bh);
  const float ll = __fmul_rn(al, bl);
  const df s = two_sum(m1, m2);
  const df p = two_sum(hh, s.h);
  return fast_two_sum(p.h, __fadd_rn(__fadd_rn(s.l, p.l), ll));
}

__device__ __forceinline__ df df_add(df x, df y) {
  const df s = two_sum(x.h, y.h);
  return fast_two_sum(s.h, __fadd_rn(s.l, __fadd_rn(x.l, y.l)));
}

// x + y for a plain f32 y
__device__ __forceinline__ df df_add_f32(df x, float y) {
  const df s = two_sum(x.h, y);
  return fast_two_sum(s.h, __fadd_rn(s.l, x.l));
}

__device__ __forceinline__ df df_mul(df x, df y) {
  const df p = two_prod(x.h, y.h);
  const float cross = __fadd_rn(__fmul_rn(x.h, y.l), __fmul_rn(x.l, y.h));
  return fast_two_sum(p.h, __fadd_rn(p.l, cross));
}

// x * y for a plain f32 y
__device__ __forceinline__ df df_mul_f32(df x, float y) {
  const df p = two_prod(x.h, y);
  return fast_two_sum(p.h, __fadd_rn(p.l, __fmul_rn(x.l, y)));
}

__device__ __forceinline__ df df_neg(df x) { return {-x.h, -x.l}; }

// x * s for a power of two s: exact
__device__ __forceinline__ df df_scale(df x, float s) { return {__fmul_rn(x.h, s), __fmul_rn(x.l, s)}; }

// the f32 value of a df number
__device__ __forceinline__ float df_collapse(df x) { return __fadd_rn(x.h, x.l); }

// x / y: one Newton step on the f32 quotient
__device__ __forceinline__ df df_div(df x, df y) {
  const float q1 = __fdiv_rn(x.h, y.h);
  const df p = two_prod(q1, y.h);
  const df r = df_add(x, {-p.h, -__fadd_rn(p.l, __fmul_rn(q1, y.l))});
  return fast_two_sum(q1, __fdiv_rn(df_collapse(r), y.h));
}

// sqrt(x): one Heron step on the f32 root
__device__ __forceinline__ df df_sqrt(df x) {
  const float s1 = __fsqrt_rn(x.h);
  const df p = two_prod(s1, s1);
  const df r = df_add(x, {-p.h, -p.l});
  return fast_two_sum(s1, __fdiv_rn(df_collapse(r), __fmul_rn(2.f, s1)));
}

// exp of a df number, ~1e-13 relative: k = round-half-even(x / ln2),
// r = x - k ln2 in df, a degree-12 df Horner of the Taylor series of exp(r),
// then a scale by 2^k built as the bit pattern (k + 127) << 23 (exact), with
// k < -126 flushed to 0. Constants: the f32 (hi, lo) pairs of ln2, 1/ln2 and
// 1/n! that gpmpc_tpu/ops/df32.py builds with numpy.
__device__ __forceinline__ df df_exp(df x) {
  const float kLn2Hi = 0x1.62e43p-1f;
  const float kLn2Lo = -0x1.05c61p-29f;
  const float kInvLn2 = 0x1.715476p+0f;
  const float kCoefH[13] = {
      0x1.1eed8ep-29f, 0x1.ae6456p-26f, 0x1.27e4fcp-22f, 0x1.71de3ap-19f, 0x1.a01a02p-16f,
      0x1.a01a02p-13f, 0x1.6c16c2p-10f, 0x1.111112p-7f,  0x1.555556p-5f,  0x1.555556p-3f,
      0x1p-1f,         0x1p+0f,         0x1p+0f};
  const float kCoefL[13] = {
      0x1.ff1b14p-54f,  0x1.fd5138p-52f,  -0x1.10ec14p-47f, 0x1.55b1ccp-45f, -0x1.7f97fap-42f,
      -0x1.7f97fap-39f, -0x1.27d27ep-35f, -0x1.dddddep-32f, -0x1.555556p-30f, -0x1.555556p-28f,
      0.f,              0.f,              0.f};
  const float k = rintf(__fmul_rn(x.h, kInvLn2));
  df t = two_prod(k, kLn2Hi);
  t = fast_two_sum(t.h, __fadd_rn(t.l, __fmul_rn(k, kLn2Lo)));
  const df r = df_add(x, {-t.h, -t.l});
  df e = {kCoefH[0], kCoefL[0]};
#pragma unroll
  for (int i = 1; i < 13; ++i) e = df_add(df_mul(e, r), {kCoefH[i], kCoefL[i]});
  const int ki = (int)fminf(fmaxf(k, -127.f), 127.f);
  const float scale = k < -126.f ? 0.f : __int_as_float((ki + 127) << 23);
  return {__fmul_rn(e.h, scale), __fmul_rn(e.l, scale)};
}

// the exponent a (+) c (+) sum_e U_e Xj_e of one element of the pairwise
// moment-matching matrix E (pallas_df_cov._e_slab_df, pallas_df_mm._pair_part),
// before the cap
template <int NS>
__device__ __forceinline__ df e_exponent(df a, const df* u, df c, const df* xj) {
  df e = two_sum(a.h, c.h);
  e = fast_two_sum(e.h, __fadd_rn(e.l, __fadd_rn(a.l, c.l)));
#pragma unroll
  for (int q = 0; q < NS; ++q) e = df_add(e, df_mul(u[q], xj[q]));
  return e;
}

// E = exp(min(exponent, 60)): the cap applies to the hi part
__device__ __forceinline__ df e_capped_exp(df e) { return df_exp({fminf(e.h, 60.f), e.l}); }

}  // namespace gpmpc_df

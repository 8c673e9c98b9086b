// The device code that the whole-step VJP (#9, df_mm_bwd.cu) and its split
// past N = 128 (#10 and #11, df_mm_split.cu) share: the cotangents, the warp
// sums in warp_df_sum's order (#9's stacked rows and #11's pair tiles sum
// alike), the mean path over 32 points (mean_item) and what the chain rule
// needs of a point. Each source compiles its own copy (the namespace is
// anonymous), so the two compile in parallel.

#pragma once

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "df_mm.cuh"
#include "pdl.cuh"

namespace {

// the hi cotangents of the outputs: g_M (NS), g_V (NS d), g_S_p (P), g_corr (NS)
struct Cot {
  const float *m, *v, *sp, *corr;
};

// batch element elem's four, each (batch, k) row major
__device__ __forceinline__ Cot cot_at(Cot ct, int ns, int d, int elem) {
  const size_t b = elem;
  return {ct.m + b * ns, ct.v + b * ns * d, ct.sp + b * (ns * (ns + 1) / 2), ct.corr + b * ns};
}

// ct: the cotangents.
// #11: row_part and col_part [2][P][1 + NS][nt][N] (part_at): for point n
// of pair p, G and G Xj_e summed over column tile t (the row side), or G
// and G U_e summed over row tile t (the column side); unit_part
// [2][2 P nt][d + NS NS] (a unit's contributions to the cotangents of inp
// and Q_p, unit u = (side P + p) nt + chunk; #9 too).
// mean_part [2][NS][nt][d + NS NS] (#9, #10: the mean path's contributions
// to the cotangent of inp, summed over its points and models later, and to
// B^-1)

__device__ __forceinline__ df shfl_xor(df v, int mask) {
  return {__shfl_xor_sync(0xffffffffu, v.h, mask), __shfl_xor_sync(0xffffffffu, v.l, mask)};
}

// The tile sums of up to four values x[0..3] over a warp, each value's in
// warp_df_sum's order (offsets 16, 8, 4, 2, 1), with the values spread over
// the lanes: at offset 16 lanes < 16 keep values 0 and 1 and the others 2
// and 3, at offset 8 one value each, so each lane adds 6 df pairs, not 20.
// df_add is commutative bit for bit (two_sum's error term is exact either
// way), so a lane that holds its partner's half adds in either order. Value
// v ends in lane 8 v.
__device__ __forceinline__ df rows_tile_sum(const df* x) {
  const int lane = threadIdx.x & 31;
  const bool up = lane & 16, odd = lane & 8;
  df k0 = up ? x[2] : x[0], k1 = up ? x[3] : x[1];
  const df s0 = up ? x[0] : x[2], s1 = up ? x[1] : x[3];
  k0 = df_add(k0, shfl_xor(s0, 16));
  k1 = df_add(k1, shfl_xor(s1, 16));
  df t = odd ? k1 : k0;
  t = df_add(t, shfl_xor(odd ? k0 : k1, 8));
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) t = df_add(t, shfl_xor(t, off));
  return t;
}

// The warp sums of C values x[0..C - 1] per lane from offset M down: at an
// offset a lane keeps half of its values (the upper half where its lane bit
// M is set) and adds its partner's copies of them; once one is left, the
// offsets add as warp_df_sum does.
template <int C, int M>
__device__ __forceinline__ df warp_sum_levels(df* x, int lane) {
  if constexpr (M == 0) {
    return x[0];
  } else if constexpr (C >= 2) {
    const bool up = lane & M;
#pragma unroll
    for (int k = 0; k < C / 2; ++k) {
      const df keep = up ? x[C / 2 + k] : x[k];
      x[k] = df_add(keep, shfl_xor(up ? x[k] : x[C / 2 + k], M));
    }
    return warp_sum_levels<C / 2, M / 2>(x, lane);
  } else {
    x[0] = df_add(x[0], shfl_xor(x[0], M));
    return warp_sum_levels<1, M / 2>(x, lane);
  }
}

// The warp sums of K values x[0..K - 1] (K a power of two, at most 32),
// each in warp_df_sum's order, a lane adding K - 1 df pairs where K
// warp_df_sum calls add 5 K: every node of each value's tree is the one
// warp_df_sum forms (df_add is commutative bit for bit). Value v ends in
// lane v (32 / K).
template <int K>
__device__ __forceinline__ df warp_df_sum_many(df* x) {
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K a power of two, at most 32");
  return warp_sum_levels<K, 16>(x, threadIdx.x & 31);
}

// A point's warp sums of `count` values x[0..count) (count <= K), each in
// warp_df_sum's order, stored as df at out[plane][base + idx(v)].
template <int K, typename Idx>
__device__ __forceinline__ void store_sums(df* x, int count, float* out, size_t plane, Idx idx) {
  const df tot = warp_df_sum_many<K>(x);
  const int lane = threadIdx.x & 31;
  if (lane % (32 / K) == 0 && lane / (32 / K) < count) st(out, plane, idx(lane / (32 / K)), tot);
}

template <int NS, int K>
__device__ __forceinline__ void store_point_sums_k(const df* g_in, df (*g_m)[NS], int d, float* out,
                                                   size_t plane, size_t base) {
  constexpr int Q = NS * NS;
  static_assert(Q < K, "the matrix's values fit");
  df x[K];
#pragma unroll
  for (int v = 0; v < K; ++v) x[v] = v < Q ? g_m[v / NS][v % NS] : df{0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kMaxD; ++e)
    if (Q + e < K && e < d) x[Q + e < K ? Q + e : 0] = g_in[e];
  store_sums<K>(x, Q + d, out, plane, [&](int v) { return v < Q ? base + d + v : base + (v - Q); });
}

// The warp sums of a point's contributions to the cotangents of inp (g_in,
// the first d live) and of an NS x NS matrix (g_m, row major), each in
// warp_df_sum's order, stored as df at base + e (inp) and base + d + k NS +
// j (the matrix) of out: spread over the lanes, 16 values when they fit,
// else 32.
template <int NS>
__device__ __forceinline__ void store_point_sums(const df* g_in, df (*g_m)[NS], int d, float* out,
                                                 size_t plane, size_t base) {
  if (NS * NS + d <= 16) store_point_sums_k<NS, 16>(g_in, g_m, d, out, plane, base);
  else store_point_sums_k<NS, 32>(g_in, g_m, d, out, plane, base);
}

// The mean path's VJP over the 32 stored points of tile rt of model m, a
// lane a point (b: B_m^-1, row major): its contributions to the cotangent
// of inp (d) and to B_m^-1 (NS NS), each summed over the tile in
// warp_df_sum's order (store_point_sums) into mean_part at (m, rt). #9's
// mean blocks and #10 run it.
template <int NS>
__device__ void mean_item(const Cache& c, const float* __restrict__ mu, const df* b, Cot ct,
                          float* __restrict__ mean_part, int m, int rt) {
  const int nt = (c.n + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  const int d = c.d;
  const int n = rt * kTile + lane;
  df g_inp[kMaxD], g_b[NS][NS];
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) g_inp[e] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < NS; ++j) g_b[k][j] = {0.f, 0.f};
  if (n < c.n) {
    MeanPoint<NS> mp;
    mean_point<NS>(c, mu, b, m, n, mp);
    float iN_c[kMaxD], t_c[kMaxD], ils_c[kMaxD];
    df g_t[kMaxD], g_iN[kMaxD];
    const float lb_c = df_collapse(mp.lb), q_c = df_collapse(mp.q);
    const float beta_c = df_collapse(ld(c.beth, c.betl, (size_t)m * c.n + n));
    df g_lb = {ct.m[m], 0.f};
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) {
      if (e >= d) break;
      const df ils = ld(c.ilsh, c.ilsl, (size_t)m * d + e);
      ils_c[e] = df_collapse(ils);
      iN_c[e] = df_collapse(mp.iN[e]);
      t_c[e] = df_collapse(mp.t[e]);
      const float gv = ct.v[m * d + e];
      g_lb = df_add(g_lb, two_prod(gv, df_collapse(df_mul(mp.t[e], ils))));
      g_t[e] = df_mul_f32(two_prod(gv, lb_c), ils_c[e]);
    }
    df g_ex = df_mul_f32(df_mul_f32(g_lb, beta_c), q_c);
    g_ex = mp.ex_h < 60.f ? df_scale(g_ex, -0.5f) : df{0.f, 0.f};
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) {
      if (e >= d) break;
      g_iN[e] = df_mul_f32(g_ex, t_c[e]);
      g_t[e] = df_add(g_t[e], df_mul_f32(g_ex, iN_c[e]));
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float b_c = df_collapse(b[k * NS + j]);
        g_iN[k] = df_add(g_iN[k], df_mul_f32(g_t[j], b_c));
        g_b[k][j] = df_mul_f32(g_t[j], iN_c[k]);
      }
#pragma unroll
    for (int e = NS; e < kMaxD; ++e) {
      if (e >= d) break;
      g_iN[e] = df_add(g_iN[e], g_t[e]);
    }
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) {
      if (e >= d) break;
      g_inp[e] = df_mul_f32(g_iN[e], ils_c[e]);
    }
  }
  const int nv = d + NS * NS;
  store_point_sums<NS>(g_inp, g_b, d, mean_part, (size_t)NS * nt * nv, ((size_t)m * nt + rt) * nv);
}

// what the chain rule needs of one stored point of model m: the collapsed
// Xi, Xq = Xi Q and iN (from model_point and qform), and the collapsed ils
// and ils2 of m
template <int NS>
struct PointTerms {
  float xi_c[NS], xq_c[NS], iN_c[kMaxD], ils_c[kMaxD], ils2_c[NS];
};

template <int NS>
__device__ void point_terms(const Cache& c, int m, const ModelPoint<NS>& mp, const df* xq, PointTerms<NS>& pt) {
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    pt.xi_c[e] = df_collapse(mp.xi[e]);
    pt.xq_c[e] = df_collapse(xq[e]);
    pt.ils2_c[e] = df_collapse(ld(c.ils2h, c.ils2l, (size_t)m * c.d + e));
  }
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    if (e >= c.d) break;
    pt.iN_c[e] = df_collapse(mp.iN[e]);
    pt.ils_c[e] = df_collapse(ld(c.ilsh, c.ilsl, (size_t)m * c.d + e));
  }
}

}  // namespace

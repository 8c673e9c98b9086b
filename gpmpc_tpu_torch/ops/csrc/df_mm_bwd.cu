// The whole-step VJP and its split. See df_mm_fwd.cu for the forward and
// df_mm.cuh for the shared device code. Replaces gpmpc_tpu/ops/pallas_df_mm.py:
//   df_mm_bwd_kernel + df_mm_bwd_sum_kernel
//       -> _build.bwd_all_kernel (#9): the VJP of stages 2-3 (wrapper df_mm_bwd)
//   df_mm_bwd_mean_kernel (one cluster)
//       -> _build.bwd_mean_kernel (#10): the mean path's VJP, with respect to
//          mu and B^-1 (wrapper df_mm_bwd_mean)
//   df_mm_bwd_pair_kernel + df_mm_bwd_pair_unit_kernel + df_mm_bwd_pair_sum_kernel
//       -> _build.make_bwd_pair_kernel (#11): the VJP of each covariance pair,
//          with respect to mu and Q_k (wrapper df_mm_bwd_pairs)
// The reference runs #10 and one #11 launch per pair when N > 128 and #9
// otherwise; here the pair is a grid axis of one #11 launch. All three share
// mean_item (the mean path over 32 points) and point_chain_rule (the chain
// rule at one point), so they compute the same df cotangents. Every
// cotangent stays df until the outputs: #10 and #11 return their
// contributions to the cotangent of mu as df halves; in the split route
// #11's last launch adds #10's and its own in df (mean path first, then the
// pairs in pair order, as combine_split does) before the collapse.
//
// #11 (the split route past N = 128) computes E once per element in 32 x 32
// pair tiles and writes each tile's row and column sums; a first design then
// summed them, applied the chain rule and summed again in one block of 16
// warps, 9 units in series per warp at N = 384: 180 of its 240 us (NVIDIA
// H100 80GB HBM3, 700 W, trace_split_bwd.py). Here the tile rows are summed
// by rows_tile_sum, then the chain rule runs on each unit (one side of one
// pair, 32 points) over the SMs (pair_plan), 1 + NS warps a unit: one long
// df chain per point is what bounds it, so each warp takes one residual and
// a share of the outputs. A third launch sums per pair. Each launch is a
// programmatic dependent of the one before. #10 is a latency-bound chain per
// point (one warp issues ~3,000 f32 instructions, its df exp ~400 in a
// dependent row): one cluster whose blocks take a (model, tile) item per
// warp and whose block 0 sums the items after the cluster barrier, so no
// second launch; it releases its dependent at once, and in the split route
// #11's pair tiles run beside it.
//
// #9 on stacked rows. Its work is the pairs' exponent cotangent G = E (gs bi
// bj (+) gco iK) at every element of the P (N, N) slabs, its row sums (G, G
// Xj_e) and column sums (G, G U_e), then a per-point chain rule to inp and
// Q. Each element costs ~1,000 f32 instructions (E's df exp alone ~600),
// none of which may fuse into an FMA: the kernel is bound by instructions.
// At N = 128, 100 points in the planning step, a first design of 32 x 32
// tiles filled 100 of the 132 SMs with 8 warps each and wrote per-tile row
// and column partials, which a one-block second launch summed per point,
// applied the chain rule to and summed again: 0.038 of its 0.060 ms ran on
// one SM. Here a unit (one side of one pair, 32 points) belongs to a
// cluster of two 512-thread blocks; each block computes the other side's N
// operands into shared memory, and each of its 16 warps owns one point (one
// stacked row) and walks all N: the row side's G and G Xj_e sums, or the
// column side's G and G U_e sums, end inside the warp. The warps write
// their sums into rank 0's shared memory (distributed shared memory, no
// global partials), where warp 0 applies the chain rule, a lane per point,
// and the warps sum the unit's contributions. E is computed once per side,
// so the arithmetic doubles; in exchange the grid fills 2 P nt clusters
// with 16 warps per SM, and the second launch only adds the units' and the
// mean blocks' sums per output in a fixed order.
//
// Summation order, the same as #11's: the row side adds each 32-column tile
// by warp_df_sum and the tiles in order; the column side adds each 32-row
// tile as #11's pair block does (rows m, m + 8, m + 16, m + 24 in order for
// each m < 8, then tree8) and the tiles in order; a unit adds its 32 points
// by warp_df_sum. So #9 and the split route compute the same unit sums, g_B
// and g_Q; g_mu adds the same df terms in another order (#9 the units, then
// the mean path; the split route the mean path, then per pair), which the
// collapse to f32 hid on every operand set measured (bit for bit at N =
// 192, 384 and 512, trace_split_bwd.py).

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

// the four from one block g_M, g_V, g_S_p, g_corr
Cot cot_block(const float* ct, int ns, int d) {
  return {ct, ct + ns, ct + ns + ns * d, ct + ns + ns * d + ns * (ns + 1) / 2};
}

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

__device__ __forceinline__ size_t part_at(int p, int v, int tile, int n, int nr, int nt, int nn) {
  return (((size_t)p * nr + v) * nt + tile) * nn + n;
}

__device__ __forceinline__ df shfl_xor(df v, int mask) {
  return {__shfl_xor_sync(0xffffffffu, v.h, mask), __shfl_xor_sync(0xffffffffu, v.l, mask)};
}

__device__ __forceinline__ df shfl_idx(df v, int src) {
  return {__shfl_sync(0xffffffffu, v.h, src), __shfl_sync(0xffffffffu, v.l, src)};
}

__device__ __forceinline__ df pick4(int k, df x0, df x1, df x2, df x3) {
  return k == 0 ? x0 : k == 1 ? x1 : k == 2 ? x2 : x3;
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

// #11's pair block b = (p nt + rt) nt + ct: the 32 x 32 tile (rt, ct) of
// pair p, E once per element. Warp w takes the tile's rows w + 8 r (r < 4),
// a lane a column. Each row's G and G Xj_e over the tile's columns are summed
// by rows_tile_sum (warp_df_sum's order); each column's G and G U_e over the
// tile's rows by rows m, m + 8, m + 16, m + 24 in order per warp m, then
// tree8 over the warps. A lane's iK entries are loaded before the tile's
// operands are computed.
template <int NS>
__device__ void bwd_pair_tile(const Cache& c, const float* __restrict__ mu, const float* __restrict__ qh,
                              const float* __restrict__ ql, Cot ct,
                              float* __restrict__ row_part, float* __restrict__ col_part, int b) {
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  static_assert(NR <= 4, "four values per tile sum");
  const int nt = (c.n + kTile - 1) / kTile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ df s_q[NS * NS];
  __shared__ TileOperands<NS> s;
  __shared__ df s_col[kWarps][NR][kTile];
  const int cti = b % nt, rt = (b / nt) % nt, p = b / (nt * nt);
  int i, j;
  pair_ij(p, NS, i, j);
  const int k = cti * kTile + lane;
  const bool col_ok = k < c.n;
  const float gs = ct.sp[p];
  const float gco = i == j ? ct.corr[i] : 0.f;
  df ik[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = rt * kTile + warp + kWarps * r;
    ik[r] = i == j && col_ok && n < c.n ? ld(c.ikh, c.ikl, ((size_t)i * c.n + n) * c.n + k) : df{0.f, 0.f};
  }
  if (t < NS * NS) s_q[t] = ld(qh, ql, (size_t)p * NS * NS + t);
  __syncthreads();
  load_tile<NS>(c, mu, s_q, i, j, rt, cti, s);
  __syncthreads();

  float xj_c[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) xj_c[e] = col_ok ? df_collapse(s.xj[lane][e]) : 0.f;
  df cacc[NR];
#pragma unroll
  for (int v = 0; v < NR; ++v) cacc[v] = {0.f, 0.f};
  const size_t plane = (size_t)P * NR * nt * c.n;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp + kWarps * r;
    const int n = rt * kTile + rr;
    if (n >= c.n) break;  // warp-uniform
    df racc[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (col_ok) {
      const df ex = e_exponent<NS>(s.a[rr], s.u[rr], s.c[lane], s.xj[lane]);
      df w = df_mul_f32(df_mul(s.bi[rr], s.bj[lane]), gs);
      if (i == j) w = df_add(w, df_mul_f32(ik[r], gco));
      const df g = ex.h < 60.f ? df_mul(e_capped_exp(ex), w) : df{0.f, 0.f};
      racc[0] = g;
      cacc[0] = df_add(cacc[0], g);
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        racc[1 + e] = df_mul_f32(g, xj_c[e]);
        cacc[1 + e] = df_add(cacc[1 + e], df_mul_f32(g, df_collapse(s.u[rr][e])));
      }
    }
    const df tot = rows_tile_sum(racc);
    if ((lane & 7) == 0 && (lane >> 3) < NR) st(row_part, plane, part_at(p, lane >> 3, cti, n, NR, nt, c.n), tot);
  }
#pragma unroll
  for (int v = 0; v < NR; ++v) s_col[warp][v][lane] = cacc[v];
  __syncthreads();
  if (t < NR * kTile) {
    const int v = t / kTile, cc = t % kTile;
    const int kk = cti * kTile + cc;
    if (kk < c.n) {
      df w8[kWarps];
#pragma unroll
      for (int m = 0; m < kWarps; ++m) w8[m] = s_col[m][v][cc];
      st(col_part, plane, part_at(p, v, rt, kk, NR, nt, c.n), tree8(w8));
    }
  }
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

// #9's mean block rt: warp m < NS takes model m
template <int NS>
__device__ void bwd_mean_tile(const Cache& c, const float* __restrict__ mu, const float* __restrict__ bh,
                              const float* __restrict__ bl, Cot ct, float* __restrict__ mean_part, int rt) {
  const int t = threadIdx.x, warp = t >> 5;
  __shared__ df s_b[NS][NS * NS];
  if (t < NS * NS * NS) s_b[t / (NS * NS)][t % (NS * NS)] = ld(bh, bl, t);
  __syncthreads();
  if (warp < NS) mean_item<NS>(c, mu, s_b[warp], ct, mean_part, warp, rt);
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

// The chain rule at one point of a unit of side `side` (0: the rows, whose a
// = klog + xs and U = 2 Xq; 1: the columns, whose c = klog + xs and Xj = Xi)
// from its residuals res (G and the G Xj_e or G U_e sums): its contributions
// to the cotangents of inp (d) and of Q_p (NS NS), in df.
template <int NS>
__device__ void point_chain_rule(int side, const df* res, const PointTerms<NS>& pt, const df* q, int d,
                                 df* acc_mu, df (*acc_q)[NS]) {
  df g_xq[NS], g_xi[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e)
    g_xq[e] = side == 0 ? df_add(df_scale(res[1 + e], 2.f), df_mul_f32(res[0], pt.xi_c[e]))
                        : df_mul_f32(res[0], pt.xi_c[e]);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    df a = df_mul_f32(res[0], pt.xq_c[k]);
    if (side == 1) a = df_add(a, res[1 + k]);
#pragma unroll
    for (int e = 0; e < NS; ++e) a = df_add(a, df_mul_f32(g_xq[e], df_collapse(q[k * NS + e])));
    g_xi[k] = a;
  }
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int e = 0; e < NS; ++e) acc_q[k][e] = df_mul_f32(g_xq[e], pt.xi_c[k]);
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    if (e >= d) break;
    df g = df_mul_f32(df_mul_f32(res[0], -pt.iN_c[e]), pt.ils_c[e]);
    if (e < NS) g = df_add(g, df_mul_f32(g_xi[e], pt.ils2_c[e]));
    acc_mu[e] = g;
  }
}

// ---------------------------------------------------------------------------
// #9: stacked rows. A unit u = (side P + p) nt + chunk is the 32 points of
// one side of pair p; a cluster of kUnitBlocks blocks owns it, each block
// kUnitPoints of its points, a warp one point (a stacked row) against all N
// points of the other side.
// ---------------------------------------------------------------------------

constexpr int kUnitBlocks = 2;
constexpr int kUnitPoints = kTile / kUnitBlocks;
constexpr int kUnitWarps = 16;
constexpr int kUnitThreads = 32 * kUnitWarps;
// the other side's points in dynamic shared memory: N <= 5,000 at ns = 3
constexpr size_t kMaxUnitDynSmem = 200 * 1024;

static_assert(kUnitPoints % kUnitWarps == 0, "each warp owns the same number of points");

// a unit's own points (all 32, in every block of its cluster): the operands
// of the walk and what the chain rule needs; res is filled through the
// cluster's shared memory, and only rank 0's copy is read
template <int NS>
struct UnitShared {
  df q[NS * NS];
  df ab[kTile], v[kTile][NS], b[kTile];
  PointTerms<NS> terms[kTile];
  df res[kTile][1 + NS];
  df acc[kTile][kMaxD + NS * NS];
};

// dynamic shared memory of a unit block: the other side's N points, ab (N),
// b (N) and v (N NS), df
template <int NS>
size_t unit_dyn_smem(int n) {
  return (size_t)n * (2 + NS) * sizeof(df);
}

// The same for the column side, in the order of #11's pair block: for each
// m < 8, (((0 + x_m) + x_{m+8}) + x_{m+16}) + x_{m+24}, then tree8 over m.
// Lanes 8 v .. 8 v + 7 sum value v; value v ends in lane 8 v.
__device__ __forceinline__ df cols_tile_sum(const df* x) {
  const int lane = threadIdx.x & 31, m = lane & 7, v = lane >> 3;
  df t = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int src = m + 8 * r;
    t = df_add(t, pick4(v, shfl_idx(x[0], src), shfl_idx(x[1], src), shfl_idx(x[2], src), shfl_idx(x[3], src)));
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) t = df_add(t, shfl_xor(t, off));
  return t;
}

// One stacked row: own point (a, U, bi) of the row side or (c, Xj, bj) of
// the column side, against the N points of the other side. The row side
// sums each 32-column tile as warp_df_sum would (rows_tile_sum); the column
// side sums each 32-row tile in the order of #11's pair block
// (cols_tile_sum); both add the tile sums in tile order. The result: value
// v (G, then its NS weighted sums) in lane 8 v.
template <int NS, int SIDE>
__device__ df unit_row(const Cache& c, int i, float gs, float gco, int own, df own_ab, const df* own_v, df own_b,
                       const df* o_ab, const df* o_b, const df* o_v) {
  static_assert(NS <= 3, "four values per tile sum");
  const int nt = (c.n + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  df res = {0.f, 0.f};
  for (int tt = 0; tt < nt; ++tt) {
    const int k = tt * kTile + lane;  // the other side's point of this lane
    df g[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (k < c.n) {
      df ov[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e) ov[e] = o_v[k * NS + e];
      const int row = SIDE == 0 ? own : k, col = SIDE == 0 ? k : own;
      const df ex = SIDE == 0 ? e_exponent<NS>(own_ab, own_v, o_ab[k], ov)
                              : e_exponent<NS>(o_ab[k], ov, own_ab, own_v);
      df w = df_mul_f32(SIDE == 0 ? df_mul(own_b, o_b[k]) : df_mul(o_b[k], own_b), gs);
      if (i >= 0) w = df_add(w, df_mul_f32(ld(c.ikh, c.ikl, ((size_t)i * c.n + row) * c.n + col), gco));
      g[0] = ex.h < 60.f ? df_mul(e_capped_exp(ex), w) : df{0.f, 0.f};
#pragma unroll
      for (int e = 0; e < NS; ++e) g[1 + e] = df_mul_f32(g[0], df_collapse(ov[e]));
    }
    res = df_add(res, SIDE == 0 ? rows_tile_sum(g) : cols_tile_sum(g));
  }
  return res;
}

// a block of #9's unit u (one of the kUnitBlocks of its cluster); the chain
// rule and the unit's sums run in rank 0 of the cluster
template <int NS>
__device__ void bwd_unit(const Cache& c, const float* __restrict__ mu, const float* __restrict__ qh,
                         const float* __restrict__ ql, Cot ct, float* __restrict__ unit_part,
                         int u, UnitShared<NS>& s, df* dyn) {
  namespace cg = cooperative_groups;
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  const int d = c.d;
  const int nt = (c.n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int side = u / (P * nt), p = (u / nt) % P, chunk = u % nt;
  int i, j;
  pair_ij(p, NS, i, j);
  const int m_own = side == 0 ? i : j, m_oth = side == 0 ? j : i;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  df* o_ab = dyn;
  df* o_b = dyn + c.n;
  df* o_v = dyn + 2 * c.n;
  if (t < NS * NS) s.q[t] = ld(qh, ql, (size_t)p * NS * NS + t);
  __syncthreads();

  // the unit's 32 points (threads 0..31) and the other side's N points: a or
  // c = klog + xs, U = 2 Xq (rows) or Xj = Xi (columns), beta, as #11's
  // load_tile computes them
  if (t < kTile) {
    const int n = chunk * kTile + t;
    if (n < c.n) {
      ModelPoint<NS> mp;
      model_point<NS>(c, mu, m_own, n, mp);
      df xq[NS];
      s.ab[t] = df_add(mp.klog, qform<NS>(mp.xi, s.q, xq));
      s.b[t] = ld(c.beth, c.betl, (size_t)m_own * c.n + n);
#pragma unroll
      for (int e = 0; e < NS; ++e) s.v[t][e] = side == 0 ? df_scale(xq[e], 2.f) : mp.xi[e];
      if (rank == 0) point_terms<NS>(c, m_own, mp, xq, s.terms[t]);
    }
  } else {
    for (int k = t - kTile; k < c.n; k += kUnitThreads - kTile) {
      ModelPoint<NS> mp;
      model_point<NS>(c, mu, m_oth, k, mp);
      df xq[NS];
      o_ab[k] = df_add(mp.klog, qform<NS>(mp.xi, s.q, xq));
      o_b[k] = ld(c.beth, c.betl, (size_t)m_oth * c.n + k);
#pragma unroll
      for (int e = 0; e < NS; ++e) o_v[k * NS + e] = side == 0 ? mp.xi[e] : df_scale(xq[e], 2.f);
    }
  }
  // the cluster barrier also makes sure that both blocks have started before
  // either writes into rank 0's shared memory
  cluster.sync();

  // the walk: a warp per point of this block
  UnitShared<NS>* s0 = cluster.map_shared_rank(&s, 0);
  const float gs = ct.sp[p];
  const float gco = i == j ? ct.corr[i] : 0.f;
  const int ik_model = i == j ? i : -1;
  for (int pl = (int)rank * kUnitPoints + warp; pl < ((int)rank + 1) * kUnitPoints; pl += kUnitWarps) {
    const int own = chunk * kTile + pl;
    if (own >= c.n) break;  // warp-uniform
    const df res = side == 0
                       ? unit_row<NS, 0>(c, ik_model, gs, gco, own, s.ab[pl], s.v[pl], s.b[pl], o_ab, o_b, o_v)
                       : unit_row<NS, 1>(c, ik_model, gs, gco, own, s.ab[pl], s.v[pl], s.b[pl], o_ab, o_b, o_v);
    if ((lane & 7) == 0 && (lane >> 3) < NR) s0->res[pl][lane >> 3] = res;
  }
  cluster.sync();
  if (rank != 0) return;

  // the chain rule, a lane per point, then the unit's sums over its points
  // by warp_df_sum, one output per warp
  if (warp == 0) {
    const int n = chunk * kTile + lane;
    df acc_mu[kMaxD], acc_q[NS][NS];
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) acc_mu[e] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int e = 0; e < NS; ++e) acc_q[k][e] = {0.f, 0.f};
    if (n < c.n) point_chain_rule<NS>(side, s.res[lane], s.terms[lane], s.q, d, acc_mu, acc_q);
#pragma unroll
    for (int e = 0; e < kMaxD; ++e)
      if (e < d) s.acc[lane][e] = acc_mu[e];
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int e = 0; e < NS; ++e) s.acc[lane][d + k * NS + e] = acc_q[k][e];
  }
  __syncthreads();
  const size_t uplane = (size_t)2 * P * nt * nv;
  for (int o = warp; o < nv; o += kUnitWarps) {
    const df tot = warp_df_sum(s.acc[lane][o]);
    if (lane == 0) st(unit_part, uplane, (size_t)u * nv + o, tot);
  }
}

// #9: kUnitBlocks blocks (a cluster) per unit, then nt mean blocks (padded
// to whole clusters; a padding block returns at once); with BATCHED, grid
// row y is the batch element (df_mm.cuh cache_of), whose operands,
// cotangents and partials follow the element before's (one element with
// its one cache launches the instance without, as #12 does)
template <int NS, bool BATCHED>
__global__ void __cluster_dims__(kUnitBlocks, 1, 1) __launch_bounds__(kUnitThreads, 1)
df_mm_bwd_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                 const float* __restrict__ bl, const float* __restrict__ qh, const float* __restrict__ ql,
                 Cot ct, float* __restrict__ mean_part, float* __restrict__ unit_part,
                 const int* __restrict__ cidx) {
  constexpr int P = NS * (NS + 1) / 2;
  gpmpc_pdl::release_dependents();
  __shared__ UnitShared<NS> s;
  extern __shared__ df dyn[];
  const int nt = (c.n + kTile - 1) / kTile;
  const int nub = kUnitBlocks * 2 * P * nt;
  if constexpr (BATCHED) {  // this block's batch element
    const int elem = blockIdx.y;
    const size_t nv = c.d + NS * NS;
    c = cache_of<NS>(c, cidx, elem);
    mu += (size_t)elem * c.d;
    bh += (size_t)elem * NS * NS * NS;
    bl += (size_t)elem * NS * NS * NS;
    qh += (size_t)elem * P * NS * NS;
    ql += (size_t)elem * P * NS * NS;
    ct = cot_at(ct, NS, c.d, elem);
    mean_part += (size_t)elem * 2 * NS * nt * nv;
    unit_part += (size_t)elem * 2 * 2 * P * nt * nv;
  }
  if ((int)blockIdx.x < nub)
    bwd_unit<NS>(c, mu, qh, ql, ct, unit_part, blockIdx.x / kUnitBlocks, s, dyn);
  else if ((int)blockIdx.x - nub < nt)
    bwd_mean_tile<NS>(c, mu, bh, bl, ct, mean_part, blockIdx.x - nub);
}

// ---------------------------------------------------------------------------
// #11: the pair tiles, then the chain rule on 1 + NS warps per unit, then
// the sums per pair, each launch a programmatic dependent of the one before.
// ---------------------------------------------------------------------------

// the most units of a unit block (pair_plan; 1 + NS warps each); the tile
// partials a lane loads at once
constexpr int kPairUnitMaxUnits = 2;
constexpr int kUnitLoadTiles = 8;

// #11's first launch, the P nt nt pair blocks. In the split route it is a
// programmatic dependent of #10: it reads nothing that #10 writes, so it may
// run beside it, and it waits for #10 before it exits, so that the launches
// after it (which read #10's output) find #10 done.
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_mm_bwd_pair_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                      const float* __restrict__ ql, Cot ct, float* __restrict__ row_part,
                      float* __restrict__ col_part) {
  gpmpc_pdl::release_dependents();
  bwd_pair_tile<NS>(c, mu, qh, ql, ct, row_part, col_part, blockIdx.x);
  gpmpc_pdl::wait_for_prerequisite();
}

// #11's second launch: unit u = (side P + p) nt + chunk (the 32 points of
// one side of pair p) owns NR = 1 + NS warps of a block (pair_plan's
// unit_warps units a block), a lane a point. Every warp of the unit computes
// the point's forward quantities (before the wait: they read only the
// inputs). Then warp v sums residual v over the tiles in tile order; warps
// v >= 1 form g_xi[v - 1] and row v - 1 of the unit's Q cotangent, warp 0
// the inp cotangent: #9's point_chain_rule, its outputs split over the
// warps with each one's df operations unchanged. Each warp sums its outputs
// over the unit's points in warp_df_sum's order into unit_part, as #9's are.
template <int NS>
__global__ void __launch_bounds__(32 * (1 + NS) * kPairUnitMaxUnits)
df_mm_bwd_pair_unit_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                           const float* __restrict__ ql, const float* __restrict__ row_part,
                           const float* __restrict__ col_part, float* __restrict__ unit_part) {
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  __shared__ df s_res[kPairUnitMaxUnits][NR][kTile];
  __shared__ df s_gxi[kPairUnitMaxUnits][NS][kTile];
  gpmpc_pdl::release_dependents();
  const int d = c.d;
  const int nt = (c.n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int units = 2 * P * nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / NR, v = warp % NR;
  const int u = blockIdx.x * (blockDim.x / (32 * NR)) + slot;
  const bool live = u < units;  // the barriers below need every warp
  const int uu = live ? u : 0;
  const int side = uu / (P * nt), p = (uu / nt) % P, chunk = uu % nt;
  int i, j;
  pair_ij(p, NS, i, j);
  const int m = side == 0 ? i : j;
  const int n = chunk * kTile + lane;
  const bool point = live && n < c.n;
  df q[NS * NS];
#pragma unroll
  for (int k = 0; k < NS * NS; ++k) q[k] = ld(qh, ql, (size_t)p * NS * NS + k);
  PointTerms<NS> pt = {};
  if (point) {
    ModelPoint<NS> mp;
    model_point<NS>(c, mu, m, n, mp);
    df xq[NS];
    qform<NS>(mp.xi, q, xq);
    point_terms<NS>(c, m, mp, xq, pt);
  }
  gpmpc_pdl::wait_for_prerequisite();

  // residual v: the tile partials kUnitLoadTiles at a time, all issued
  // before their additions (in tile order)
  df res = {0.f, 0.f};
  if (point) {
    const float* part = side == 0 ? row_part : col_part;
    const size_t plane = (size_t)P * NR * nt * c.n;
    for (int t0 = 0; t0 < nt; t0 += kUnitLoadTiles) {
      df buf[kUnitLoadTiles];
#pragma unroll
      for (int k = 0; k < kUnitLoadTiles; ++k)
        buf[k] = t0 + k < nt ? ld(part, part + plane, part_at(p, v, t0 + k, n, NR, nt, c.n)) : df{0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kUnitLoadTiles; ++k)
        if (t0 + k < nt) res = df_add(res, buf[k]);
    }
  }
  s_res[slot][v][lane] = res;
  __syncthreads();
  df r[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) r[k] = s_res[slot][k][lane];
  // point_chain_rule, split: g_xq on every warp
  df g_xq[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e)
    g_xq[e] = side == 0 ? df_add(df_scale(r[1 + e], 2.f), df_mul_f32(r[0], pt.xi_c[e])) : df_mul_f32(r[0], pt.xi_c[e]);
  const size_t uplane = (size_t)units * nv;
  const size_t base = (size_t)uu * nv;
  if (v >= 1) {  // g_xi[k] and row k of the Q cotangent
    const int k = v - 1;
    df a = df_mul_f32(r[0], pt.xq_c[k]);
    if (side == 1) a = df_add(a, r[1 + k]);
#pragma unroll
    for (int e = 0; e < NS; ++e) a = df_add(a, df_mul_f32(g_xq[e], df_collapse(q[k * NS + e])));
    s_gxi[slot][k][lane] = a;
    df x[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (point) {
#pragma unroll
      for (int e = 0; e < NS; ++e) x[e] = df_mul_f32(g_xq[e], pt.xi_c[k]);
    }
    if (live) store_sums<4>(x, NS, unit_part, uplane, [&](int e) { return base + d + k * NS + e; });
  }
  __syncthreads();
  if (v == 0 && live) {  // the inp cotangent
    df x[kMaxD];
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) {
      x[e] = {0.f, 0.f};
      if (!point || e >= d) continue;
      df g = df_mul_f32(df_mul_f32(r[0], -pt.iN_c[e]), pt.ils_c[e]);
      if (e < NS) g = df_add(g, df_mul_f32(s_gxi[slot][e][lane], pt.ils2_c[e]));
      x[e] = g;
    }
    if (d <= 4) store_sums<4>(x, d, unit_part, uplane, [&](int e) { return base + e; });
    else store_sums<8>(x, d, unit_part, uplane, [&](int e) { return base + e; });
  }
}

// #11's third launch, one block: per pair p its contribution to the
// cotangent of inp (df, its units summed in #9's order: side 0's chunks,
// then side 1's) and g_Q_p; given mean_inp (#10's g_inp hi, lo), also g_mu =
// -(mean (+) pair 0 (+) pair 1 ...), combine_split's df additions in its
// order. The units' sums are first copied into shared memory when they fit
// (smem_floats). out: g_inp hi (P, d), g_inp lo (P, d), g_Q (P NS^2), then
// g_mu (d), f32.
template <int NS>
__global__ void __launch_bounds__(kSumThreads)
df_mm_bwd_pair_sum_kernel(int n, int d, const float* __restrict__ unit_part, const float* __restrict__ mean_inp,
                          float* __restrict__ out, int smem_floats) {
  constexpr int P = NS * (NS + 1) / 2;
  extern __shared__ float sm[];
  __shared__ df s_pair[kMaxP][kMaxD];
  gpmpc_pdl::wait_for_prerequisite();
  const int nt = (n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const size_t uplane = (size_t)2 * P * nt * nv;
  const float* up = unit_part;
  if ((size_t)smem_floats >= 2 * uplane) {
    for (size_t k = threadIdx.x; k < 2 * uplane; k += blockDim.x) sm[k] = unit_part[k];
    __syncthreads();
    up = sm;
  }
  for (int o = threadIdx.x; o < P * nv; o += blockDim.x) {
    const int p = o / nv, v = o % nv;
    df acc = {0.f, 0.f};
    for (int side = 0; side < 2; ++side)
      for (int chunk = 0; chunk < nt; ++chunk) {
        const int uu = (side * P + p) * nt + chunk;
        acc = df_add(acc, ld(up, up + uplane, (size_t)uu * nv + v));
      }
    if (v < d) {
      out[p * d + v] = acc.h;
      out[P * d + p * d + v] = acc.l;
      s_pair[p][v] = acc;
    } else {
      out[2 * P * d + p * NS * NS + (v - d)] = df_collapse(acc);
    }
  }
  if (mean_inp == nullptr) return;
  __syncthreads();
  if ((int)threadIdx.x < d) {
    const int e = threadIdx.x;
    df acc = {mean_inp[e], mean_inp[d + e]};
    for (int p = 0; p < P; ++p) acc = df_add(acc, s_pair[p][e]);
    out[2 * P * d + P * NS * NS + e] = -df_collapse(acc);
  }
}

// ---------------------------------------------------------------------------
// #10: one cluster of mean_plan's blocks. Block r takes the tiles r, r + cl,
// ... of every model, a warp a (model, tile) item (mean_item, into
// mean_part); after the cluster barrier block 0 sums the items per output
// over models and tiles in #9's order.
// ---------------------------------------------------------------------------

// the most blocks of #10's cluster (H100's non-portable cluster size) and
// warps of each
constexpr int kMeanMaxCluster = 16;
constexpr int kMeanMaxWarps = 8;

template <int NS>
__global__ void __launch_bounds__(32 * kMeanMaxWarps)
df_mm_bwd_mean_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                      const float* __restrict__ bl, Cot ct, float* __restrict__ mean_part, float* __restrict__ out,
                      int smem_floats) {
  namespace cg = cooperative_groups;
  gpmpc_pdl::release_dependents();
  extern __shared__ float sm[];
  __shared__ df s_b[NS][NS * NS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cl = (int)cluster.num_blocks();
  const int nt = (c.n + kTile - 1) / kTile;
  const int t = threadIdx.x, warps = blockDim.x >> 5;
  if (t < NS * NS * NS) s_b[t / (NS * NS)][t % (NS * NS)] = ld(bh, bl, t);
  __syncthreads();
  const int items = NS * ((nt - rank + cl - 1) / cl);
  for (int it = t >> 5; it < items; it += warps)
    mean_item<NS>(c, mu, s_b[it % NS], ct, mean_part, it % NS, rank + cl * (it / NS));
  __threadfence();
  cluster.sync();
  if (rank != 0) return;

  const int d = c.d;
  const int nv = d + NS * NS;
  const size_t mplane = (size_t)NS * nt * nv;
  const float* mp = mean_part;
  if ((size_t)smem_floats >= 2 * mplane) {
    for (size_t k = t; k < 2 * mplane; k += blockDim.x) sm[k] = mean_part[k];
    __syncthreads();
    mp = sm;
  }
  for (int o = t; o < d + NS * NS * NS; o += blockDim.x) {
    df acc = {0.f, 0.f};
    if (o < d) {
      for (int mm = 0; mm < NS; ++mm)
        for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + o));
      out[o] = acc.h;
      out[d + o] = acc.l;
    } else {
      const int mm = (o - d) / (NS * NS), kj = (o - d) % (NS * NS);
      for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + d + kj));
      out[d + o] = df_collapse(acc);
    }
  }
}

// #9's second launch, one block per batch element (blockIdx.x; with
// BATCHED), a programmatic dependent of the first: each
// output a sequential df sum in a fixed order: g_mu = -(units + mean path),
// g_B = mean path, g_Q = units of its pair. The partials are first copied
// into shared memory (all threads, coalesced) when they fit (smem_floats),
// so that each sum's chain waits on no global load. out: g_mu (d), g_B
// (NS^3), g_Q (P NS^2), f32.
template <int NS, bool BATCHED>
__global__ void __launch_bounds__(kSumThreads)
df_mm_bwd_sum_kernel(int n, int d, const float* __restrict__ mean_part, const float* __restrict__ unit_part,
                     float* __restrict__ out, int smem_floats) {
  constexpr int P = NS * (NS + 1) / 2;
  extern __shared__ float sm[];
  gpmpc_pdl::wait_for_prerequisite();
  const int nt = (n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int units = 2 * P * nt;
  const size_t uplane = (size_t)units * nv;
  const size_t mplane = (size_t)NS * nt * nv;
  if constexpr (BATCHED) {
    const int elem = blockIdx.x;
    unit_part += (size_t)elem * 2 * uplane;
    mean_part += (size_t)elem * 2 * mplane;
    out += (size_t)elem * (d + NS * NS * NS + P * NS * NS);
  }
  const float* up = unit_part;
  const float* mp = mean_part;
  if ((size_t)smem_floats >= 2 * (uplane + mplane)) {
    for (size_t k = threadIdx.x; k < 2 * uplane; k += blockDim.x) sm[k] = unit_part[k];
    for (size_t k = threadIdx.x; k < 2 * mplane; k += blockDim.x) sm[2 * uplane + k] = mean_part[k];
    __syncthreads();
    up = sm;
    mp = sm + 2 * uplane;
  }
  const int n_out = d + NS * NS * NS + P * NS * NS;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    df acc = {0.f, 0.f};
    if (o < d) {
      for (int uu = 0; uu < units; ++uu) acc = df_add(acc, ld(up, up + uplane, (size_t)uu * nv + o));
      for (int mm = 0; mm < NS; ++mm)
        for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + o));
      out[o] = -df_collapse(acc);
    } else if (o < d + NS * NS * NS) {
      const int mm = (o - d) / (NS * NS), kj = (o - d) % (NS * NS);
      for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + d + kj));
      out[o] = df_collapse(acc);
    } else {
      const int p = (o - d - NS * NS * NS) / (NS * NS), ke = (o - d - NS * NS * NS) % (NS * NS);
      for (int side = 0; side < 2; ++side)
        for (int chunk = 0; chunk < nt; ++chunk) {
          const int uu = (side * P + p) * nt + chunk;
          acc = df_add(acc, ld(up, up + uplane, (size_t)uu * nv + d + ke));
        }
      out[o] = df_collapse(acc);
    }
  }
}

// #9's grid: kUnitBlocks blocks per unit, then the mean blocks, padded to
// whole clusters
template <int NS>
int bwd_grid(int n) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (n + kTile - 1) / kTile;
  return kUnitBlocks * 2 * P * nt + (nt + kUnitBlocks - 1) / kUnitBlocks * kUnitBlocks;
}

// past 48 KB of dynamic shared memory a kernel must be allowed it
template <int NS, bool BATCHED = false>
int allow_dyn_smem(size_t dyn) {
  if (dyn > kMaxUnitDynSmem) return (int)cudaErrorInvalidValue;
  if (dyn <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(df_mm_bwd_kernel<NS, BATCHED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)dyn);
}

// the grid of one element is the B = 1 launch's; batch rows of it
template <int NS, bool BATCHED>
int launch_bwd_as(const Cache& c, const float* mu, const float* bh, const float* bl, const float* qh,
                  const float* ql, Cot ct, float* mean_part, float* unit_part, float* out, const int* cidx,
                  int batch, cudaStream_t stream) {
  const size_t dyn = unit_dyn_smem<NS>(c.n);
  int rc = allow_dyn_smem<NS, BATCHED>(dyn);
  if (rc != 0) return rc;
  df_mm_bwd_kernel<NS, BATCHED><<<dim3(bwd_grid<NS>(c.n), batch), kUnitThreads, dyn, stream>>>(
      c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, cidx);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  const size_t parts = (size_t)2 * (2 * P * nt + NS * nt) * (c.d + NS * NS);  // floats of both
  const int smem_floats = parts * sizeof(float) <= 48 * 1024 ? (int)parts : 0;
  return gpmpc_pdl::launch_dependent(df_mm_bwd_sum_kernel<NS, BATCHED>, batch, kSumThreads,
                                     smem_floats * sizeof(float), stream, c.n, c.d, (const float*)mean_part,
                                     (const float*)unit_part, out, smem_floats);
}

template <int NS>
int launch_bwd(const Cache& c, const float* mu, const float* bh, const float* bl, const float* qh,
               const float* ql, Cot ct, float* mean_part, float* unit_part, float* out, const int* cidx,
               int batch, cudaStream_t stream) {
  if (batch == 1 && cidx == nullptr)
    return launch_bwd_as<NS, false>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, stream);
  return launch_bwd_as<NS, true>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, stream);
}

// #9's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (n, ns), for the smoke's report
template <int NS>
int bwd_info(int n, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_bwd_kernel<NS, false>);
  if (rc != 0) return rc;
  const size_t dyn = unit_dyn_smem<NS>(n);
  rc = allow_dyn_smem<NS>(dyn);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_bwd_kernel<NS, false>, kUnitThreads, dyn);
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[7] = {a.numRegs, (int)a.localSizeBytes, kUnitThreads, per_sm, bwd_grid<NS>(n), sms, (int)dyn};
  for (int k = 0; k < 7; ++k) info[k] = vals[k];
  return 0;
}

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// the f32s of a summing launch's partials, if they fit its shared memory
int smem_floats_for(size_t floats) { return floats * sizeof(float) <= 48 * 1024 ? (int)floats : 0; }

// #10's plan at N on a card of sms SMs (df_mm.mean_launch_plan): the blocks
// of its one cluster, and the warps of each, enough for the busiest block's
// items (NS per tile) up to kMeanMaxWarps
struct MeanPlan {
  int cluster, warps;
};

template <int NS>
MeanPlan mean_plan(int n, int sms) {
  const int nt = (n + kTile - 1) / kTile;
  const int cl = std::min(kMeanMaxCluster, std::min(nt, sms));
  return {cl, std::min(kMeanMaxWarps, NS * ((nt + cl - 1) / cl))};
}

// past 8 blocks a cluster must be allowed the non-portable size
template <int NS>
int allow_big_cluster() {
  return (int)cudaFuncSetAttribute(df_mm_bwd_mean_kernel<NS>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int NS>
int launch_bwd_mean(const Cache& c, const float* mu, const float* bh, const float* bl, Cot ct,
                    float* mean_part, float* out, cudaStream_t stream) {
  const MeanPlan plan = mean_plan<NS>(c.n, device_sms());
  const int nt = (c.n + kTile - 1) / kTile;
  const int smem_floats = smem_floats_for((size_t)2 * NS * nt * (c.d + NS * NS));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = plan.cluster;
  cfg.blockDim = 32 * plan.warps;
  cfg.dynamicSmemBytes = smem_floats * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int rc = allow_big_cluster<NS>();
  if (rc != 0) return rc;
  return (int)cudaLaunchKernelEx(&cfg, df_mm_bwd_mean_kernel<NS>, c, mu, bh, bl, ct, mean_part, out, smem_floats);
}

// #10's registers, spill bytes, threads, resident blocks per SM, grid (the
// cluster), SMs and dynamic shared memory at (n, ns, d)
template <int NS>
int mean_info(int n, int d, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_bwd_mean_kernel<NS>);
  if (rc != 0) return rc;
  const int sms = device_sms();
  const MeanPlan plan = mean_plan<NS>(n, sms);
  const int nt = (n + kTile - 1) / kTile;
  const int dyn = smem_floats_for((size_t)2 * NS * nt * (d + NS * NS)) * (int)sizeof(float);
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_bwd_mean_kernel<NS>, 32 * plan.warps, dyn);
  if (rc != 0) return rc;
  const int vals[7] = {a.numRegs, (int)a.localSizeBytes, 32 * plan.warps, per_sm, plan.cluster, sms, dyn};
  for (int k = 0; k < 7; ++k) info[k] = vals[k];
  return 0;
}

// #11's plan at N on a card of sms SMs (df_mm.pair_launch_plan): the pair
// blocks, the 2 P nt units and the units per block of the second launch
// (1 + NS warps each), spread over the SMs
struct PairPlan {
  int tile_blocks, units, unit_warps, unit_blocks;
};

template <int NS>
PairPlan pair_plan(int n, int sms) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (n + kTile - 1) / kTile;
  const int units = 2 * P * nt;
  const int per = std::min(kPairUnitMaxUnits, std::max(1, (units + sms - 1) / sms));
  return {P * nt * nt, units, per * (1 + NS), (units + per - 1) / per};
}

// mean_inp: #10's g_inp hi, lo (2 d) from the launch just before on the
// stream, whose sum with the pairs' is written as g_mu; or null
template <int NS>
int launch_bwd_pair(const Cache& c, const float* mu, const float* qh, const float* ql, Cot ct,
                    const float* mean_inp, float* row_part, float* col_part, float* unit_part, float* out,
                    cudaStream_t stream) {
  const PairPlan plan = pair_plan<NS>(c.n, device_sms());
  int rc;
  if (mean_inp != nullptr) {
    rc = gpmpc_pdl::launch_dependent(df_mm_bwd_pair_kernel<NS>, plan.tile_blocks, kThreads, 0, stream, c, mu, qh,
                                     ql, ct, row_part, col_part);
  } else {
    df_mm_bwd_pair_kernel<NS><<<plan.tile_blocks, kThreads, 0, stream>>>(c, mu, qh, ql, ct, row_part, col_part);
    rc = (int)cudaGetLastError();
  }
  if (rc != 0) return rc;
  rc = gpmpc_pdl::launch_dependent(df_mm_bwd_pair_unit_kernel<NS>, plan.unit_blocks, 32 * plan.unit_warps, 0,
                                   stream, c, mu, qh, ql, (const float*)row_part, (const float*)col_part, unit_part);
  if (rc != 0) return rc;
  const int smem_floats = smem_floats_for((size_t)2 * plan.units * (c.d + NS * NS));
  return gpmpc_pdl::launch_dependent(df_mm_bwd_pair_sum_kernel<NS>, 1, kSumThreads, smem_floats * sizeof(float),
                                     stream, c.n, c.d, (const float*)unit_part, mean_inp, out, smem_floats);
}

// #11's pair-block registers, spill bytes, threads, resident blocks per SM,
// grid, SMs and dynamic shared memory at (n, ns), then the unit launch's
// registers, warps per block and blocks
template <int NS>
int pair_info(int n, int* info) {
  cudaFuncAttributes a, au;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_bwd_pair_kernel<NS>);
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&au, df_mm_bwd_pair_unit_kernel<NS>);
  if (rc != 0) return rc;
  const int sms = device_sms();
  const PairPlan plan = pair_plan<NS>(n, sms);
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_bwd_pair_kernel<NS>, kThreads, 0);
  if (rc != 0) return rc;
  const int vals[10] = {a.numRegs, (int)a.localSizeBytes, kThreads, per_sm, plan.tile_blocks, sms, 0,
                        au.numRegs, plan.unit_warps, plan.unit_blocks};
  for (int k = 0; k < 10; ++k) info[k] = vals[k];
  return 0;
}

}  // namespace

extern "C" {

// batch elements, each its operands, cotangents, partials and out after the
// element before's; cidx (batch) the cache of each, or null for one shared
// cache
int gpmpc_df_mm_bwd_f32(const float* mu, const float* bh, const float* bl, const float* qh, const float* ql,
                        GPMPC_DF_MM_CACHE_ARGS, const float* g_m, const float* g_v, const float* g_sp,
                        const float* g_corr, float* mean_part, float* unit_part, float* out, int n, int ns, int d,
                        const int* cidx, int batch, void* stream) {
  if (!valid(n, ns, d) || !valid_batch(batch)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct{g_m, g_v, g_sp, g_corr};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd<1>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, s);
    case 2: return launch_bwd<2>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, s);
    default: return launch_bwd<3>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, s);
  }
}

// #9's launch report (bwd_info): info[7]
int gpmpc_df_mm_bwd_info(int n, int ns, int* info) {
  switch (ns) {
    case 1: return bwd_info<1>(n, info);
    case 2: return bwd_info<2>(n, info);
    default: return bwd_info<3>(n, info);
  }
}

// #10: out = g_inp hi (d), g_inp lo (d), g_B (ns^3)
int gpmpc_df_mm_bwd_mean_f32(const float* mu, const float* bh, const float* bl, GPMPC_DF_MM_CACHE_ARGS,
                             const float* ct_block, float* mean_part, float* out, int n, int ns, int d,
                             void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct = cot_block(ct_block, ns, d);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_mean<1>(c, mu, bh, bl, ct, mean_part, out, s);
    case 2: return launch_bwd_mean<2>(c, mu, bh, bl, ct, mean_part, out, s);
    default: return launch_bwd_mean<3>(c, mu, bh, bl, ct, mean_part, out, s);
  }
}

// #10's launch report (mean_info): info[7]
int gpmpc_df_mm_bwd_mean_info(int n, int ns, int d, int* info) {
  switch (ns) {
    case 1: return mean_info<1>(n, d, info);
    case 2: return mean_info<2>(n, d, info);
    default: return mean_info<3>(n, d, info);
  }
}

// #11: out = g_inp hi (P, d), g_inp lo (P, d), g_Q (P ns^2), g_mu (d); g_mu
// only given mean_inp, #10's out from the launch just before on the stream
// (its g_inp halves), else null
int gpmpc_df_mm_bwd_pair_f32(const float* mu, const float* qh, const float* ql, GPMPC_DF_MM_CACHE_ARGS,
                             const float* ct_block, const float* mean_inp, float* row_part, float* col_part,
                             float* unit_part, float* out, int n, int ns, int d, void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct = cot_block(ct_block, ns, d);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_pair<1>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, s);
    case 2: return launch_bwd_pair<2>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, s);
    default: return launch_bwd_pair<3>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, s);
  }
}

// #11's launch report (pair_info): info[10]
int gpmpc_df_mm_bwd_pair_info(int n, int ns, int* info) {
  switch (ns) {
    case 1: return pair_info<1>(n, info);
    case 2: return pair_info<2>(n, info);
    default: return pair_info<3>(n, info);
  }
}

}  // extern "C"

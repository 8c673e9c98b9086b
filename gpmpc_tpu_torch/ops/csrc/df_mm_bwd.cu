// The whole-step VJP and its split. See df_mm_fwd.cu for the forward and
// df_mm.cuh for the shared device code. Replaces gpmpc_tpu/ops/pallas_df_mm.py:
//   df_mm_bwd_kernel + df_mm_bwd_sum_kernel
//       -> _build.bwd_all_kernel (#9): the VJP of stages 2-3 (wrapper df_mm_bwd)
//   df_mm_bwd_mean_kernel + df_mm_bwd_mean_sum_kernel
//       -> _build.bwd_mean_kernel (#10): the mean path's VJP, with respect to
//          mu and B^-1 (wrapper df_mm_bwd_mean)
//   df_mm_bwd_pair_kernel + df_mm_bwd_pair_sum_kernel
//       -> _build.make_bwd_pair_kernel (#11): the VJP of each covariance pair,
//          with respect to mu and Q_k (wrapper df_mm_bwd_pairs)
// The reference runs #10 and one #11 launch per pair when N > 128 and #9
// otherwise; here the pair is a grid axis of one #11 launch. All three share
// bwd_mean_tile (a mean block) and point_chain_rule (the chain rule at one
// point), so they compute the same df cotangents. Every cotangent stays df
// until the outputs: #10 and #11 return their contributions to the cotangent
// of mu as df halves, which the wrapper adds in df (mean path first, then the
// pairs in pair order) before the collapse.
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
// by warp_df_sum. So #9 and the split route agree bit for bit.

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

// ct: the cotangents.
// #11: row_part [2][P][N][1 + NS][nt] (G and G Xj_e summed over a column
// tile), col_part [2][P][N][1 + NS][nt] (G and G U_e summed over a row tile),
// unit_part [2][2 P nt][d + NS NS] (a unit's contributions to the cotangents
// of inp and Q_p, unit u = (side P + p) nt + chunk; #9 too),
// mean_part [2][NS][nt][d + NS NS] (the mean path's contributions to the
// cotangent of inp, summed over its points and models later, and to B^-1)

// pair block b = (p nt + rt) nt + ct: the 32 x 32 tile (rt, ct) of pair p
template <int NS>
__device__ void bwd_pair_tile(const Cache& c, const float* __restrict__ mu, const float* __restrict__ qh,
                              const float* __restrict__ ql, Cot ct,
                              float* __restrict__ row_part, float* __restrict__ col_part, int b) {
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  const int nt = (c.n + kTile - 1) / kTile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int d = c.d;
  __shared__ df s_q[NS * NS];
  __shared__ TileOperands<NS> s;
  __shared__ df s_col[kWarps][NR][kTile];
  const int cti = b % nt, rt = (b / nt) % nt, p = b / (nt * nt);
  int i, j;
  pair_ij(p, NS, i, j);
  if (t < NS * NS) s_q[t] = ld(qh, ql, (size_t)p * NS * NS + t);
  __syncthreads();
  load_tile<NS>(c, mu, s_q, i, j, rt, cti, s);
  __syncthreads();

  const float gs = ct.sp[p];
  const float gco = i == j ? ct.corr[i] : 0.f;
  const int k = cti * kTile + lane;
  const bool col_ok = k < c.n;
  float xj_c[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) xj_c[e] = col_ok ? df_collapse(s.xj[lane][e]) : 0.f;
  df cacc[NR];
#pragma unroll
  for (int v = 0; v < NR; ++v) cacc[v] = {0.f, 0.f};
  const size_t rplane = (size_t)P * c.n * NR * nt;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp + kWarps * r;
    const int n = rt * kTile + rr;
    if (n >= c.n) break;  // warp-uniform
    df racc[NR];
#pragma unroll
    for (int v = 0; v < NR; ++v) racc[v] = {0.f, 0.f};
    if (col_ok) {
      const df ex = e_exponent<NS>(s.a[rr], s.u[rr], s.c[lane], s.xj[lane]);
      df w = df_mul_f32(df_mul(s.bi[rr], s.bj[lane]), gs);
      if (i == j) w = df_add(w, df_mul_f32(ld(c.ikh, c.ikl, ((size_t)i * c.n + n) * c.n + k), gco));
      const df g = ex.h < 60.f ? df_mul(e_capped_exp(ex), w) : df{0.f, 0.f};
      racc[0] = g;
      cacc[0] = df_add(cacc[0], g);
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        racc[1 + e] = df_mul_f32(g, xj_c[e]);
        cacc[1 + e] = df_add(cacc[1 + e], df_mul_f32(g, df_collapse(s.u[rr][e])));
      }
    }
#pragma unroll
    for (int v = 0; v < NR; ++v) {
      const df tot = warp_df_sum(racc[v]);
      if (lane == 0) st(row_part, rplane, (((size_t)p * c.n + n) * NR + v) * nt + cti, tot);
    }
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
      st(col_part, rplane, (((size_t)p * c.n + kk) * NR + v) * nt + rt, tree8(w8));
    }
  }
}

// mean block rt: warp m < NS takes model m, a lane per stored point of the
// 32 from rt kTile
template <int NS>
__device__ void bwd_mean_tile(const Cache& c, const float* __restrict__ mu, const float* __restrict__ bh,
                              const float* __restrict__ bl, Cot ct,
                              float* __restrict__ mean_part, int rt) {
  const int nt = (c.n + kTile - 1) / kTile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int d = c.d;
  __shared__ df s_b[NS][NS * NS];
  if (t < NS * NS * NS) s_b[t / (NS * NS)][t % (NS * NS)] = ld(bh, bl, t);
  __syncthreads();
  if (warp >= NS) return;
  const int m = warp, n = rt * kTile + lane;
  df g_inp[kMaxD], g_b[NS][NS];
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) g_inp[e] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < NS; ++j) g_b[k][j] = {0.f, 0.f};
  if (n < c.n) {
    MeanPoint<NS> mp;
    mean_point<NS>(c, mu, s_b[m], m, n, mp);
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
        const float b_c = df_collapse(s_b[m][k * NS + j]);
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
  const size_t plane = (size_t)NS * nt * nv;
  const size_t base = ((size_t)m * nt + rt) * nv;
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    if (e >= d) break;
    const df tot = warp_df_sum(g_inp[e]);
    if (lane == 0) st(mean_part, plane, base + e, tot);
  }
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const df tot = warp_df_sum(g_b[k][j]);
      if (lane == 0) st(mean_part, plane, base + d + k * NS + j, tot);
    }
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
// to whole clusters; a padding block returns at once)
template <int NS>
__global__ void __cluster_dims__(kUnitBlocks, 1, 1) __launch_bounds__(kUnitThreads, 1)
df_mm_bwd_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                 const float* __restrict__ bl, const float* __restrict__ qh, const float* __restrict__ ql,
                 Cot ct, float* __restrict__ mean_part, float* __restrict__ unit_part) {
  constexpr int P = NS * (NS + 1) / 2;
  gpmpc_pdl::release_dependents();
  __shared__ UnitShared<NS> s;
  extern __shared__ df dyn[];
  const int nt = (c.n + kTile - 1) / kTile;
  const int nub = kUnitBlocks * 2 * P * nt;
  if ((int)blockIdx.x < nub)
    bwd_unit<NS>(c, mu, qh, ql, ct, unit_part, blockIdx.x / kUnitBlocks, s, dyn);
  else if ((int)blockIdx.x - nub < nt)
    bwd_mean_tile<NS>(c, mu, bh, bl, ct, mean_part, blockIdx.x - nub);
}

// #11: the P nt nt pair blocks alone
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_mm_bwd_pair_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                      const float* __restrict__ ql, Cot ct, float* __restrict__ row_part,
                      float* __restrict__ col_part) {
  bwd_pair_tile<NS>(c, mu, qh, ql, ct, row_part, col_part, blockIdx.x);
}

// #10: the nt mean blocks alone
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_mm_bwd_mean_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                      const float* __restrict__ bl, Cot ct, float* __restrict__ mean_part) {
  bwd_mean_tile<NS>(c, mu, bh, bl, ct, mean_part, blockIdx.x);
}

// The chain rule per point, in one block of kSumThreads. A unit is (side,
// pair, 32 points): a warp sums each point's residual partials over the
// tiles, recomputes its forward quantities, applies the chain rule in df and
// sums the unit's contributions to the cotangents of inp (d) and Q_p (NS NS)
// into unit_part [2][2 P nt][d + NS NS] (unit u = (side P + p) nt + chunk).
template <int NS>
__device__ void bwd_units(const Cache& c, const float* __restrict__ mu, const float* __restrict__ qh,
                          const float* __restrict__ ql, const float* __restrict__ row_part,
                          const float* __restrict__ col_part, float* __restrict__ unit_part) {
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  const int d = c.d;
  const int nt = (c.n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int units = 2 * P * nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t rplane = (size_t)P * c.n * NR * nt, uplane = (size_t)units * nv;
  __shared__ df s_q[kMaxP * NS * NS];
  for (int k = threadIdx.x; k < P * NS * NS; k += blockDim.x) s_q[k] = ld(qh, ql, k);
  __syncthreads();

  for (int u = warp; u < units; u += kSumThreads / 32) {
    const int side = u / (P * nt), p = (u / nt) % P, chunk = u % nt;
    int i, j;
    pair_ij(p, NS, i, j);
    const int m = side == 0 ? i : j;
    const df* q = s_q + p * NS * NS;
    const float* part = side == 0 ? row_part : col_part;
    const int n = chunk * kTile + lane;
    df acc_mu[kMaxD], acc_q[NS][NS];
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) acc_mu[e] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int e = 0; e < NS; ++e) acc_q[k][e] = {0.f, 0.f};
    if (n < c.n) {
      df res[NR];
#pragma unroll
      for (int v = 0; v < NR; ++v) {
        df s = {0.f, 0.f};
        for (int tt = 0; tt < nt; ++tt)
          s = df_add(s, ld(part, part + rplane, (((size_t)p * c.n + n) * NR + v) * nt + tt));
        res[v] = s;
      }
      ModelPoint<NS> mp;
      model_point<NS>(c, mu, m, n, mp);
      df xq[NS];
      qform<NS>(mp.xi, q, xq);
      PointTerms<NS> pt;
      point_terms<NS>(c, m, mp, xq, pt);
      point_chain_rule<NS>(side, res, pt, q, d, acc_mu, acc_q);
    }
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) {
      if (e >= d) break;
      const df tot = warp_df_sum(acc_mu[e]);
      if (lane == 0) st(unit_part, uplane, (size_t)u * nv + e, tot);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const df tot = warp_df_sum(acc_q[k][e]);
        if (lane == 0) st(unit_part, uplane, (size_t)u * nv + d + k * NS + e, tot);
      }
  }
  __syncthreads();
}

// #9's second launch, one block, a programmatic dependent of the first: each
// output a sequential df sum in a fixed order: g_mu = -(units + mean path),
// g_B = mean path, g_Q = units of its pair. The partials are first copied
// into shared memory (all threads, coalesced) when they fit (smem_floats),
// so that each sum's chain waits on no global load. out: g_mu (d), g_B
// (NS^3), g_Q (P NS^2), f32.
template <int NS>
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

// #10's second launch, one block: the mean path's contribution to the
// cotangent of inp, a df sum over models and mean blocks (in #9's order), and
// g_B. out: g_inp hi (d), g_inp lo (d), g_B (NS^3) f32.
template <int NS>
__global__ void __launch_bounds__(kSumThreads)
df_mm_bwd_mean_sum_kernel(int n, int d, const float* __restrict__ mean_part, float* __restrict__ out) {
  const int nt = (n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const size_t mplane = (size_t)NS * nt * nv;
  for (int o = threadIdx.x; o < d + NS * NS * NS; o += blockDim.x) {
    df acc = {0.f, 0.f};
    if (o < d) {
      for (int mm = 0; mm < NS; ++mm)
        for (int rt = 0; rt < nt; ++rt)
          acc = df_add(acc, ld(mean_part, mean_part + mplane, ((size_t)mm * nt + rt) * nv + o));
      out[o] = acc.h;
      out[d + o] = acc.l;
    } else {
      const int mm = (o - d) / (NS * NS), kj = (o - d) % (NS * NS);
      for (int rt = 0; rt < nt; ++rt)
        acc = df_add(acc, ld(mean_part, mean_part + mplane, ((size_t)mm * nt + rt) * nv + d + kj));
      out[d + o] = df_collapse(acc);
    }
  }
}

// #11's second launch: bwd_units, then per pair p its contribution to the
// cotangent of inp (df, summed over its units in #9's order) and g_Q_p.
// out: g_inp hi (P, d), g_inp lo (P, d), g_Q (P NS^2) f32.
template <int NS>
__global__ void __launch_bounds__(kSumThreads)
df_mm_bwd_pair_sum_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                          const float* __restrict__ ql, const float* __restrict__ row_part,
                          const float* __restrict__ col_part, float* __restrict__ unit_part,
                          float* __restrict__ out) {
  constexpr int P = NS * (NS + 1) / 2;
  const int d = c.d;
  const int nt = (c.n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const size_t uplane = (size_t)2 * P * nt * nv;
  bwd_units<NS>(c, mu, qh, ql, row_part, col_part, unit_part);

  for (int o = threadIdx.x; o < P * nv; o += blockDim.x) {
    const int p = o / nv, v = o % nv;
    df acc = {0.f, 0.f};
    for (int side = 0; side < 2; ++side)
      for (int chunk = 0; chunk < nt; ++chunk) {
        const int uu = (side * P + p) * nt + chunk;
        acc = df_add(acc, ld(unit_part, unit_part + uplane, (size_t)uu * nv + v));
      }
    if (v < d) {
      out[p * d + v] = acc.h;
      out[P * d + p * d + v] = acc.l;
    } else {
      out[2 * P * d + p * NS * NS + (v - d)] = df_collapse(acc);
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
template <int NS>
int allow_dyn_smem(size_t dyn) {
  if (dyn > kMaxUnitDynSmem) return (int)cudaErrorInvalidValue;
  if (dyn <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(df_mm_bwd_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
}

template <int NS>
int launch_bwd(const Cache& c, const float* mu, const float* bh, const float* bl, const float* qh,
               const float* ql, Cot ct, float* mean_part, float* unit_part, float* out,
               cudaStream_t stream) {
  const size_t dyn = unit_dyn_smem<NS>(c.n);
  int rc = allow_dyn_smem<NS>(dyn);
  if (rc != 0) return rc;
  df_mm_bwd_kernel<NS><<<bwd_grid<NS>(c.n), kUnitThreads, dyn, stream>>>(c, mu, bh, bl, qh, ql, ct, mean_part,
                                                                         unit_part);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  const size_t parts = (size_t)2 * (2 * P * nt + NS * nt) * (c.d + NS * NS);  // floats of both
  const int smem_floats = parts * sizeof(float) <= 48 * 1024 ? (int)parts : 0;
  return gpmpc_pdl::launch_dependent(df_mm_bwd_sum_kernel<NS>, 1, kSumThreads, smem_floats * sizeof(float), stream,
                                     c.n, c.d, (const float*)mean_part, (const float*)unit_part, out, smem_floats);
}

// #9's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (n, ns), for the smoke's report
template <int NS>
int bwd_info(int n, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_bwd_kernel<NS>);
  if (rc != 0) return rc;
  const size_t dyn = unit_dyn_smem<NS>(n);
  rc = allow_dyn_smem<NS>(dyn);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_bwd_kernel<NS>, kUnitThreads, dyn);
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[7] = {a.numRegs, (int)a.localSizeBytes, kUnitThreads, per_sm, bwd_grid<NS>(n), sms, (int)dyn};
  for (int k = 0; k < 7; ++k) info[k] = vals[k];
  return 0;
}

template <int NS>
int launch_bwd_mean(const Cache& c, const float* mu, const float* bh, const float* bl, Cot ct,
                    float* mean_part, float* out, cudaStream_t stream) {
  const int nt = (c.n + kTile - 1) / kTile;
  df_mm_bwd_mean_kernel<NS><<<nt, kThreads, 0, stream>>>(c, mu, bh, bl, ct, mean_part);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  df_mm_bwd_mean_sum_kernel<NS><<<1, kSumThreads, 0, stream>>>(c.n, c.d, mean_part, out);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_bwd_pair(const Cache& c, const float* mu, const float* qh, const float* ql, Cot ct,
                    float* row_part, float* col_part, float* unit_part, float* out, cudaStream_t stream) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  df_mm_bwd_pair_kernel<NS><<<P * nt * nt, kThreads, 0, stream>>>(c, mu, qh, ql, ct, row_part, col_part);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  df_mm_bwd_pair_sum_kernel<NS><<<1, kSumThreads, 0, stream>>>(c, mu, qh, ql, row_part, col_part, unit_part,
                                                               out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gpmpc_df_mm_bwd_f32(const float* mu, const float* bh, const float* bl, const float* qh, const float* ql,
                        GPMPC_DF_MM_CACHE_ARGS, const float* g_m, const float* g_v, const float* g_sp,
                        const float* g_corr, float* mean_part, float* unit_part, float* out, int n, int ns, int d,
                        void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct{g_m, g_v, g_sp, g_corr};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd<1>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, s);
    case 2: return launch_bwd<2>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, s);
    default: return launch_bwd<3>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, s);
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

// #11: out = g_inp hi (P, d), g_inp lo (P, d), g_Q (P ns^2)
int gpmpc_df_mm_bwd_pair_f32(const float* mu, const float* qh, const float* ql, GPMPC_DF_MM_CACHE_ARGS,
                             const float* ct_block, float* row_part, float* col_part, float* unit_part,
                             float* out, int n, int ns, int d, void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct = cot_block(ct_block, ns, d);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_pair<1>(c, mu, qh, ql, ct, row_part, col_part, unit_part, out, s);
    case 2: return launch_bwd_pair<2>(c, mu, qh, ql, ct, row_part, col_part, unit_part, out, s);
    default: return launch_bwd_pair<3>(c, mu, qh, ql, ct, row_part, col_part, unit_part, out, s);
  }
}

}  // extern "C"

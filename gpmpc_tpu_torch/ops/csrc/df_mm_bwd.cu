// The whole-step VJP and its split. See df_mm_fwd.cu for the design and
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
// otherwise; here the pair is a grid axis of one #11 launch. #10 and #11 are
// built from #9's device code: bwd_mean_tile (a mean block), bwd_pair_tile (a
// pair block) and bwd_units (the chain rule per point), so the three compute
// the same df cotangents; they differ only in which outputs a launch sums.
// Every cotangent stays df until the outputs: #10 and #11 return their
// contributions to the cotangent of mu as df halves, which the wrapper adds
// in df (mean path first, then the pairs in pair order) before the collapse.

#include <cuda_runtime.h>

#include "df_mm.cuh"

namespace {

// ct: g_M (NS), g_V (NS d), g_S_p (P), g_corr (NS), hi cotangents.
// row_part [2][P][N][1 + NS][nt] (G and G Xj_e summed over a column tile),
// col_part [2][P][N][1 + NS][nt] (G and G U_e summed over a row tile),
// mean_part [2][NS][nt][d + NS NS] (the mean path's contributions to the
// cotangent of inp, summed over its points and models later, and to B^-1)

// pair block b = (p nt + rt) nt + ct: the 32 x 32 tile (rt, ct) of pair p
template <int NS>
__device__ void bwd_pair_tile(const Cache& c, const float* __restrict__ mu, const float* __restrict__ qh,
                              const float* __restrict__ ql, const float* __restrict__ ct,
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

  const float gs = ct[NS + NS * d + p];
  const float gco = i == j ? ct[NS + NS * d + P + i] : 0.f;
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
                              const float* __restrict__ bl, const float* __restrict__ ct,
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
    df g_lb = {ct[m], 0.f};
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) {
      if (e >= d) break;
      const df ils = ld(c.ilsh, c.ilsl, (size_t)m * d + e);
      ils_c[e] = df_collapse(ils);
      iN_c[e] = df_collapse(mp.iN[e]);
      t_c[e] = df_collapse(mp.t[e]);
      const float gv = ct[NS + m * d + e];
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

// #9: P nt nt pair blocks, then nt mean blocks
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_mm_bwd_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                 const float* __restrict__ bl, const float* __restrict__ qh, const float* __restrict__ ql,
                 const float* __restrict__ ct, float* __restrict__ row_part, float* __restrict__ col_part,
                 float* __restrict__ mean_part) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  const int npb = P * nt * nt;
  if (blockIdx.x < npb)
    bwd_pair_tile<NS>(c, mu, qh, ql, ct, row_part, col_part, blockIdx.x);
  else
    bwd_mean_tile<NS>(c, mu, bh, bl, ct, mean_part, blockIdx.x - npb);
}

// #11: the P nt nt pair blocks alone
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_mm_bwd_pair_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                      const float* __restrict__ ql, const float* __restrict__ ct, float* __restrict__ row_part,
                      float* __restrict__ col_part) {
  bwd_pair_tile<NS>(c, mu, qh, ql, ct, row_part, col_part, blockIdx.x);
}

// #10: the nt mean blocks alone
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_mm_bwd_mean_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                      const float* __restrict__ bl, const float* __restrict__ ct, float* __restrict__ mean_part) {
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
      float xi_c[NS], xq_c[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        xi_c[e] = df_collapse(mp.xi[e]);
        xq_c[e] = df_collapse(xq[e]);
      }
      df g_xq[NS], g_xi[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e)
        g_xq[e] = side == 0 ? df_add(df_scale(res[1 + e], 2.f), df_mul_f32(res[0], xi_c[e]))
                            : df_mul_f32(res[0], xi_c[e]);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        df a = df_mul_f32(res[0], xq_c[k]);
        if (side == 1) a = df_add(a, res[1 + k]);
#pragma unroll
        for (int e = 0; e < NS; ++e) a = df_add(a, df_mul_f32(g_xq[e], df_collapse(q[k * NS + e])));
        g_xi[k] = a;
      }
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int e = 0; e < NS; ++e) acc_q[k][e] = df_mul_f32(g_xq[e], xi_c[k]);
#pragma unroll
      for (int e = 0; e < kMaxD; ++e) {
        if (e >= d) break;
        const float ils_c = df_collapse(ld(c.ilsh, c.ilsl, (size_t)m * d + e));
        df g = df_mul_f32(df_mul_f32(res[0], -df_collapse(mp.iN[e])), ils_c);
        if (e < NS) g = df_add(g, df_mul_f32(g_xi[e], df_collapse(ld(c.ils2h, c.ils2l, (size_t)m * d + e))));
        acc_mu[e] = g;
      }
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

// #9's second launch: bwd_units, then each output a sequential df sum:
// g_mu = -(units + mean path), g_B = mean path, g_Q = units of its pair.
// out: g_mu (d), g_B (NS^3), g_Q (P NS^2), f32.
template <int NS>
__global__ void __launch_bounds__(kSumThreads)
df_mm_bwd_sum_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                     const float* __restrict__ ql, const float* __restrict__ row_part,
                     const float* __restrict__ col_part, const float* __restrict__ mean_part,
                     float* __restrict__ unit_part, float* __restrict__ out) {
  constexpr int P = NS * (NS + 1) / 2;
  const int d = c.d;
  const int nt = (c.n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int units = 2 * P * nt;
  const size_t uplane = (size_t)units * nv;
  bwd_units<NS>(c, mu, qh, ql, row_part, col_part, unit_part);

  const size_t mplane = (size_t)NS * nt * nv;
  const int n_out = d + NS * NS * NS + P * NS * NS;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    df acc = {0.f, 0.f};
    if (o < d) {
      for (int uu = 0; uu < units; ++uu) acc = df_add(acc, ld(unit_part, unit_part + uplane, (size_t)uu * nv + o));
      for (int mm = 0; mm < NS; ++mm)
        for (int rt = 0; rt < nt; ++rt)
          acc = df_add(acc, ld(mean_part, mean_part + mplane, ((size_t)mm * nt + rt) * nv + o));
      out[o] = -df_collapse(acc);
    } else if (o < d + NS * NS * NS) {
      const int mm = (o - d) / (NS * NS), kj = (o - d) % (NS * NS);
      for (int rt = 0; rt < nt; ++rt)
        acc = df_add(acc, ld(mean_part, mean_part + mplane, ((size_t)mm * nt + rt) * nv + d + kj));
      out[o] = df_collapse(acc);
    } else {
      const int p = (o - d - NS * NS * NS) / (NS * NS), ke = (o - d - NS * NS * NS) % (NS * NS);
      for (int side = 0; side < 2; ++side)
        for (int chunk = 0; chunk < nt; ++chunk) {
          const int uu = (side * P + p) * nt + chunk;
          acc = df_add(acc, ld(unit_part, unit_part + uplane, (size_t)uu * nv + d + ke));
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

template <int NS>
int launch_bwd(const Cache& c, const float* mu, const float* bh, const float* bl, const float* qh,
               const float* ql, const float* ct, float* row_part, float* col_part, float* mean_part,
               float* unit_part, float* out, cudaStream_t stream) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  df_mm_bwd_kernel<NS><<<P * nt * nt + nt, kThreads, 0, stream>>>(c, mu, bh, bl, qh, ql, ct, row_part,
                                                                 col_part, mean_part);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  df_mm_bwd_sum_kernel<NS><<<1, kSumThreads, 0, stream>>>(c, mu, qh, ql, row_part, col_part, mean_part,
                                                          unit_part, out);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_bwd_mean(const Cache& c, const float* mu, const float* bh, const float* bl, const float* ct,
                    float* mean_part, float* out, cudaStream_t stream) {
  const int nt = (c.n + kTile - 1) / kTile;
  df_mm_bwd_mean_kernel<NS><<<nt, kThreads, 0, stream>>>(c, mu, bh, bl, ct, mean_part);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  df_mm_bwd_mean_sum_kernel<NS><<<1, kSumThreads, 0, stream>>>(c.n, c.d, mean_part, out);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_bwd_pair(const Cache& c, const float* mu, const float* qh, const float* ql, const float* ct,
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
                        GPMPC_DF_MM_CACHE_ARGS, const float* ct, float* row_part, float* col_part,
                        float* mean_part, float* unit_part, float* out, int n, int ns, int d, void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd<1>(c, mu, bh, bl, qh, ql, ct, row_part, col_part, mean_part, unit_part, out, s);
    case 2: return launch_bwd<2>(c, mu, bh, bl, qh, ql, ct, row_part, col_part, mean_part, unit_part, out, s);
    default: return launch_bwd<3>(c, mu, bh, bl, qh, ql, ct, row_part, col_part, mean_part, unit_part, out, s);
  }
}

// #10: out = g_inp hi (d), g_inp lo (d), g_B (ns^3)
int gpmpc_df_mm_bwd_mean_f32(const float* mu, const float* bh, const float* bl, GPMPC_DF_MM_CACHE_ARGS,
                             const float* ct, float* mean_part, float* out, int n, int ns, int d, void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_mean<1>(c, mu, bh, bl, ct, mean_part, out, s);
    case 2: return launch_bwd_mean<2>(c, mu, bh, bl, ct, mean_part, out, s);
    default: return launch_bwd_mean<3>(c, mu, bh, bl, ct, mean_part, out, s);
  }
}

// #11: out = g_inp hi (P, d), g_inp lo (P, d), g_Q (P ns^2)
int gpmpc_df_mm_bwd_pair_f32(const float* mu, const float* qh, const float* ql, GPMPC_DF_MM_CACHE_ARGS,
                             const float* ct, float* row_part, float* col_part, float* unit_part, float* out,
                             int n, int ns, int d, void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_pair<1>(c, mu, qh, ql, ct, row_part, col_part, unit_part, out, s);
    case 2: return launch_bwd_pair<2>(c, mu, qh, ql, ct, row_part, col_part, unit_part, out, s);
    default: return launch_bwd_pair<3>(c, mu, qh, ql, ct, row_part, col_part, unit_part, out, s);
  }
}

}  // extern "C"

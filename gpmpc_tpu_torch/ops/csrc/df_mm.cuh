// Shared by df_mm_fwd.cu and df_mm_bwd.cu (each its own translation unit,
// compiled in parallel): constants, stage 1, the per-point quantities and a
// pair tile's operands. See df_mm_fwd.cu for what the kernels compute.

#pragma once

#include <cuda_runtime.h>

#include "df32.cuh"

namespace {

using namespace gpmpc_df;

constexpr int kTile = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kMaxD = 8;
constexpr int kMaxNs = 3;
constexpr int kMaxP = kMaxNs * (kMaxNs + 1) / 2;
constexpr int kSumThreads = 512;

static_assert(kWarps == 8, "tree8 sums one value per warp");

// the DFCache slabs, f32 halves, row major: x (N, d), ils and ils2 (ns, d),
// log outs (ns), beta (ns, N), iK (ns, N, N)
struct Cache {
  const float *xh, *xl, *ilsh, *ilsl, *ils2h, *ils2l, *logoh, *logol, *beth, *betl, *ikh, *ikl;
  int n, d;
};

__device__ __forceinline__ df ld(const float* h, const float* l, size_t i) { return {h[i], l[i]}; }

__device__ __forceinline__ void st(float* base, size_t plane, size_t i, df v) {
  base[i] = v.h;
  base[plane + i] = v.l;
}

// pair p -> (i, j), i <= j, in np.triu_indices order
__device__ __forceinline__ void pair_ij(int p, int ns, int& i, int& j) {
  i = 0;
  while (p >= ns - i) {
    p -= ns - i;
    ++i;
  }
  j = i + p;
}

__device__ __forceinline__ int diag_pair(int m, int ns) {
  int p = 0;
  for (int i = 0; i < m; ++i) p += ns - i;
  return p;
}

__device__ __forceinline__ df shfl_down(df v, int off) {
  return {__shfl_down_sync(0xffffffffu, v.h, off), __shfl_down_sync(0xffffffffu, v.l, off)};
}

// df sum over the warp; valid in lane 0
__device__ __forceinline__ df warp_df_sum(df v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = df_add(v, shfl_down(v, off));
  return v;
}

__device__ __forceinline__ df tree8(const df* w) {
  return df_add(df_add(df_add(w[0], w[1]), df_add(w[2], w[3])),
                df_add(df_add(w[4], w[5]), df_add(w[6], w[7])));
}

// ---------------------------------------------------------------------------
// stage 1 (ops/df_mm.py: spd_inv_det_df, df_stage1)
// ---------------------------------------------------------------------------

template <int K>
__device__ void spd_inv_det(const df (&M)[K][K], df (&Minv)[K][K], df& det) {
  df L[K][K], Li[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      df s = M[i][j];
#pragma unroll
      for (int p = 0; p < j; ++p) s = df_add(s, df_neg(df_mul(L[i][p], L[j][p])));
      if (i == j) {
        const float floor = __fadd_rn(__fmul_rn(1e-10f, fabsf(M[i][i].h)), 1e-30f);
        if (s.h < floor) s = {floor, 0.f};
        L[i][i] = df_sqrt(s);
      } else {
        L[i][j] = df_div(s, L[j][j]);
      }
    }
  det = df_mul(L[0][0], L[0][0]);
#pragma unroll
  for (int i = 1; i < K; ++i) det = df_mul(det, df_mul(L[i][i], L[i][i]));
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i == j) {
        Li[i][i] = df_div({1.f, 0.f}, L[i][i]);
      } else {
        df s = df_mul(L[i][j], Li[j][j]);
#pragma unroll
        for (int p = j + 1; p < i; ++p) s = df_add(s, df_mul(L[i][p], Li[p][j]));
        Li[i][j] = df_div(df_neg(s), L[i][i]);
      }
    }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int lo = i > j ? i : j;
      df s = df_mul(Li[lo][i], Li[lo][j]);
#pragma unroll
      for (int p = lo + 1; p < K; ++p) s = df_add(s, df_mul(Li[p][i], Li[p][j]));
      Minv[i][j] = s;
    }
}

// B^-1 of model m (row major [k][j]) and c_m = outs_m / sqrt det B
template <int NS>
__device__ void stage1_model(const Cache& c, const float* sv, const float* outs, int m, df* binv, float& cm) {
  df B[NS][NS], Bi[NS][NS], det;
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const df outer = df_mul(ld(c.ilsh, c.ilsl, (size_t)m * c.d + i), ld(c.ilsh, c.ilsl, (size_t)m * c.d + j));
      B[i][j] = df_add_f32(df_mul_f32(outer, sv[i * NS + j]), i == j ? 1.f : 0.f);
    }
  spd_inv_det<NS>(B, Bi, det);
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j) binv[i * NS + j] = Bi[i][j];
  cm = __fdiv_rn(outs[m], __fsqrt_rn(df_collapse(det)));
}

// Q of pair (i, j) (row major [k][e]) and sqrt det R
template <int NS>
__device__ void stage1_pair(const Cache& c, const float* sv, int i, int j, df* q, float& sdr) {
  df ss[NS], dinv[NS], A[NS][NS], Ai[NS][NS], det;
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    ss[e] = df_add(ld(c.ils2h, c.ils2l, (size_t)i * c.d + e), ld(c.ils2h, c.ils2l, (size_t)j * c.d + e));
    dinv[e] = df_div({1.f, 0.f}, ss[e]);
  }
#pragma unroll
  for (int a = 0; a < NS; ++a)
#pragma unroll
    for (int b = 0; b < NS; ++b)
      A[a][b] = a == b ? df_add_f32(dinv[a], sv[a * NS + a]) : df{sv[a * NS + b], 0.f};
  spd_inv_det<NS>(A, Ai, det);
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      df acc = df_mul_f32(Ai[k][0], sv[m]);
#pragma unroll
      for (int l = 1; l < NS; ++l) acc = df_add(acc, df_mul_f32(Ai[k][l], sv[l * NS + m]));
      q[k * NS + m] = df_scale(df_mul(dinv[k], acc), 0.5f);
    }
  float prod = df_collapse(ss[0]);
#pragma unroll
  for (int e = 1; e < NS; ++e) prod = __fmul_rn(prod, df_collapse(ss[e]));
  sdr = __fsqrt_rn(__fmul_rn(df_collapse(det), prod));
}

// ---------------------------------------------------------------------------
// per-point quantities (ops/df_mm.py: _model_rows, _qform, _mean_rows)
// ---------------------------------------------------------------------------

// inp = x_n - mu (exact), iN = inp ils_m, klog = log outs_m - |iN|^2 / 2,
// Xi = inp ils2_m on the state columns
template <int NS>
struct ModelPoint {
  df iN[kMaxD];
  df klog;
  df xi[NS];
};

template <int NS>
__device__ void model_point(const Cache& c, const float* mu, int m, int n, ModelPoint<NS>& r) {
  df inp[kMaxD];
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    if (e >= c.d) break;
    const size_t i = (size_t)n * c.d + e;
    inp[e] = df_add_f32({c.xh[i], c.xl[i]}, -mu[e]);
    r.iN[e] = df_mul(inp[e], ld(c.ilsh, c.ilsl, (size_t)m * c.d + e));
  }
  df k = df_mul(r.iN[0], r.iN[0]);
#pragma unroll
  for (int e = 1; e < kMaxD; ++e) {
    if (e >= c.d) break;
    k = df_add(k, df_mul(r.iN[e], r.iN[e]));
  }
  r.klog = df_add(df_scale(k, -0.5f), ld(c.logoh, c.logol, m));
#pragma unroll
  for (int e = 0; e < NS; ++e) r.xi[e] = df_mul(inp[e], ld(c.ils2h, c.ils2l, (size_t)m * c.d + e));
}

// xq = Xi Q and the returned xs = xq . Xi (q row major [k][j])
template <int NS>
__device__ __forceinline__ df qform(const df* xi, const df* q, df* xq) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    df acc = df_mul(xi[0], q[j]);
#pragma unroll
    for (int k = 1; k < NS; ++k) acc = df_add(acc, df_mul(xi[k], q[k * NS + j]));
    xq[j] = acc;
  }
  df xs = df_mul(xq[0], xi[0]);
#pragma unroll
  for (int j = 1; j < NS; ++j) xs = df_add(xs, df_mul(xq[j], xi[j]));
  return xs;
}

// the mean path at (m, n): iN, t, the exponent's hi before the cap, q, lb
template <int NS>
struct MeanPoint {
  df iN[kMaxD], t[kMaxD];
  float ex_h;
  df q, lb;
};

template <int NS>
__device__ void mean_point(const Cache& c, const float* mu, const df* b, int m, int n, MeanPoint<NS>& r) {
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    if (e >= c.d) break;
    const size_t i = (size_t)n * c.d + e;
    r.iN[e] = df_mul(df_add_f32({c.xh[i], c.xl[i]}, -mu[e]), ld(c.ilsh, c.ilsl, (size_t)m * c.d + e));
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    df acc = df_mul(r.iN[0], b[j]);
#pragma unroll
    for (int k = 1; k < NS; ++k) acc = df_add(acc, df_mul(r.iN[k], b[k * NS + j]));
    r.t[j] = acc;
  }
#pragma unroll
  for (int e = NS; e < kMaxD; ++e) r.t[e] = r.iN[e];
  df ex = df_mul(r.iN[0], r.t[0]);
#pragma unroll
  for (int e = 1; e < kMaxD; ++e) {
    if (e >= c.d) break;
    ex = df_add(ex, df_mul(r.iN[e], r.t[e]));
  }
  r.ex_h = __fmul_rn(-0.5f, ex.h);
  r.q = df_exp({fminf(r.ex_h, 60.f), __fmul_rn(-0.5f, ex.l)});
  r.lb = df_mul(r.q, ld(c.beth, c.betl, (size_t)m * c.n + n));
}

// ---------------------------------------------------------------------------
// a pair tile's operands in shared memory
// ---------------------------------------------------------------------------

template <int NS>
struct TileOperands {
  df a[kTile], u[kTile][NS], bi[kTile];  // rows (model i)
  df c[kTile], xj[kTile][NS], bj[kTile];  // columns (model j)
};

// threads 0..31 the tile's rows, 32..63 its columns; q is the pair's Q
template <int NS>
__device__ void load_tile(const Cache& c, const float* mu, const df* q, int i, int j, int rt, int ct,
                          TileOperands<NS>& s) {
  const int t = threadIdx.x;
  if (t >= 2 * kTile) return;
  const bool row = t < kTile;
  const int slot = t % kTile;
  const int idx = (row ? rt : ct) * kTile + slot;
  if (idx >= c.n) return;
  const int m = row ? i : j;
  ModelPoint<NS> mp;
  model_point<NS>(c, mu, m, idx, mp);
  df xq[NS];
  const df ab = df_add(mp.klog, qform<NS>(mp.xi, q, xq));
  const df beta = ld(c.beth, c.betl, (size_t)m * c.n + idx);
  if (row) {
    s.a[slot] = ab;
    s.bi[slot] = beta;
#pragma unroll
    for (int e = 0; e < NS; ++e) s.u[slot][e] = df_scale(xq[e], 2.f);
  } else {
    s.c[slot] = ab;
    s.bj[slot] = beta;
#pragma unroll
    for (int e = 0; e < NS; ++e) s.xj[slot][e] = mp.xi[e];
  }
}

bool valid(int n, int ns, int d) { return n >= 1 && ns >= 1 && ns <= kMaxNs && d >= ns && d <= kMaxD; }

}  // namespace

#define GPMPC_DF_MM_CACHE_ARGS                                                                          \
  const float *xh, const float *xl, const float *ilsh, const float *ilsl, const float *ils2h,         \
      const float *ils2l, const float *logoh, const float *logol, const float *beth, const float *betl, \
      const float *ikh, const float *ikl

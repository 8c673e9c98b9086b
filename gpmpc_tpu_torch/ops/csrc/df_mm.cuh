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

// The batch axis of #12, #8 and #9: block row blockIdx.y is element b of
// the launch, and element b reads cache cidx[b] of C caches stacked on a
// leading axis (cache 0 when cidx is null: one cache shared by every
// element, as the restarts of a plan share their GP). Each element's
// operands, partials and outputs lie after the element before it's; nothing
// is summed across elements, so an element's result does not depend on the
// others in the launch.
template <int NS>
__device__ __forceinline__ Cache cache_of(Cache c, const int* cidx, int b) {
  const size_t k = cidx == nullptr ? 0 : (size_t)cidx[b];
  const size_t nd = (size_t)c.n * c.d, md = (size_t)NS * c.d, mn = (size_t)NS * c.n;
  c.xh += k * nd;
  c.xl += k * nd;
  c.ilsh += k * md;
  c.ilsl += k * md;
  c.ils2h += k * md;
  c.ils2l += k * md;
  c.logoh += k * NS;
  c.logol += k * NS;
  c.beth += k * mn;
  c.betl += k * mn;
  c.ikh += k * mn * c.n;
  c.ikl += k * mn * c.n;
  return c;
}

__device__ __forceinline__ int cache_index(const int* cidx, int b) { return cidx == nullptr ? 0 : cidx[b]; }

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
// stage 1 (ops/df_mm.py: spd_inv_det_df, df_stage1), by one warp
// ---------------------------------------------------------------------------
// Each entry's df operations run in the order of the twin's serial loops;
// the entries that do not depend on each other run on separate lanes, one
// phase after another, so the warp's instruction stream is a few entries
// long, not the whole unrolled solve (stage 1 is a dependent chain of IEEE
// divisions and square roots, executed once per launch). Every lane of the
// warp calls these; the matrices are row-major K x K df arrays in shared
// memory.

// scratch of one warp's stage 1
template <int K>
struct Stage1Scratch {
  df m[K * K], l[K * K], li[K * K], inv[K * K];
  df ss[K], dinv[K];
  df det;
};

// Minv = M^-1 and det M of an SPD M by an unrolled Cholesky, with the twin's
// pivot guard (inactive on healthy inputs). Step j: L[j][j], then at once
// the rest of L's column j (lanes j + 1..K - 1) and row j of L^-1 (lanes
// 0..j; it needs L's row j and L^-1's rows above it), so the chain is two
// divisions or roots per step; then M^-1 = L^-T L^-1, an entry per lane,
// beside det M.
template <int K>
__device__ void spd_inv_det_warp(Stage1Scratch<K>& w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (lane == 0) {
      df s = w.m[j * K + j];
#pragma unroll
      for (int p = 0; p < j; ++p) s = df_add(s, df_neg(df_mul(w.l[j * K + p], w.l[j * K + p])));
      const float floor = __fadd_rn(__fmul_rn(1e-10f, fabsf(w.m[j * K + j].h)), 1e-30f);
      if (s.h < floor) s = {floor, 0.f};
      w.l[j * K + j] = df_sqrt(s);
    }
    __syncwarp();
    // each lane its numerator, then one division by L[j][j] on all of them
    df num = {1.f, 0.f};  // L^-1[j][j] (lane j)
    df* dst = &w.li[j * K + j];
    if (lane > j && lane < K) {  // L[lane][j]
      num = w.m[lane * K + j];
#pragma unroll
      for (int p = 0; p < j; ++p) num = df_add(num, df_neg(df_mul(w.l[lane * K + p], w.l[j * K + p])));
      dst = &w.l[lane * K + j];
    } else if (lane < j) {  // L^-1[j][lane]
      const int q = lane;
      num = df_mul(w.l[j * K + q], w.li[q * K + q]);
      for (int p = q + 1; p < j; ++p) num = df_add(num, df_mul(w.l[j * K + p], w.li[p * K + q]));
      num = df_neg(num);
      dst = &w.li[j * K + q];
    }
    if (lane < K) *dst = df_div(num, w.l[j * K + j]);
    __syncwarp();
  }
  if (lane < K * K) {
    const int i = lane / K, j = lane % K;
    const int lo = i > j ? i : j;
    df s = df_mul(w.li[lo * K + i], w.li[lo * K + j]);
    for (int p = lo + 1; p < K; ++p) s = df_add(s, df_mul(w.li[p * K + i], w.li[p * K + j]));
    w.inv[lane] = s;
  } else if (lane == K * K) {
    df det = df_mul(w.l[0], w.l[0]);
#pragma unroll
    for (int i = 1; i < K; ++i) det = df_mul(det, df_mul(w.l[i * K + i], w.l[i * K + i]));
    w.det = det;
  }
  __syncwarp();
}

// B^-1 of model m (w.inv, row major [k][j]) and c_m = outs_m / sqrt det B
// (returned in lane 0)
template <int NS>
__device__ float stage1_model_warp(const Cache& c, const float* sv, const float* outs, int m, Stage1Scratch<NS>& w) {
  const int lane = threadIdx.x & 31;
  if (lane < NS * NS) {
    const int i = lane / NS, j = lane % NS;
    const df outer = df_mul(ld(c.ilsh, c.ilsl, (size_t)m * c.d + i), ld(c.ilsh, c.ilsl, (size_t)m * c.d + j));
    w.m[lane] = df_add_f32(df_mul_f32(outer, sv[i * NS + j]), i == j ? 1.f : 0.f);
  }
  __syncwarp();
  spd_inv_det_warp<NS>(w);
  return lane == 0 ? __fdiv_rn(outs[m], __fsqrt_rn(df_collapse(w.det))) : 0.f;
}

// Q of pair (i, j) (q, row major [k][e]) and sqrt det R (returned in lane 0)
template <int NS>
__device__ float stage1_pair_warp(const Cache& c, const float* sv, int i, int j, df* q, Stage1Scratch<NS>& w) {
  const int lane = threadIdx.x & 31;
  // every global read of the step at once: lane (a, b) < NS NS its sv entry
  // and sv's column b (for Q's entry (a, b)), lane e < NS ils2 of both models
  float sv_ab = 0.f, sv_col[NS];
#pragma unroll
  for (int l = 0; l < NS; ++l) sv_col[l] = lane < NS * NS ? sv[l * NS + lane % NS] : 0.f;
  if (lane < NS * NS) sv_ab = sv[lane];
  if (lane < NS) {
    w.ss[lane] = df_add(ld(c.ils2h, c.ils2l, (size_t)i * c.d + lane), ld(c.ils2h, c.ils2l, (size_t)j * c.d + lane));
    w.dinv[lane] = df_div({1.f, 0.f}, w.ss[lane]);
  }
  __syncwarp();
  if (lane < NS * NS) {
    const int a = lane / NS, b = lane % NS;
    w.m[lane] = a == b ? df_add_f32(w.dinv[a], sv_ab) : df{sv_ab, 0.f};
  }
  __syncwarp();
  spd_inv_det_warp<NS>(w);
  if (lane < NS * NS) {
    const int k = lane / NS;
    df acc = df_mul_f32(w.inv[k * NS], sv_col[0]);
#pragma unroll
    for (int l = 1; l < NS; ++l) acc = df_add(acc, df_mul_f32(w.inv[k * NS + l], sv_col[l]));
    q[lane] = df_scale(df_mul(w.dinv[k], acc), 0.5f);
  }
  if (lane != 0) return 0.f;
  float prod = df_collapse(w.ss[0]);
#pragma unroll
  for (int e = 1; e < NS; ++e) prod = __fmul_rn(prod, df_collapse(w.ss[e]));
  return __fsqrt_rn(__fmul_rn(df_collapse(w.det), prod));
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

// a launch's batch: grid rows, at most the grid's y extent
bool valid_batch(int batch) { return batch >= 1 && batch <= 65535; }

}  // namespace

#define GPMPC_DF_MM_CACHE_ARGS                                                                          \
  const float *xh, const float *xl, const float *ilsh, const float *ilsl, const float *ils2h,         \
      const float *ils2l, const float *logoh, const float *logol, const float *beth, const float *betl, \
      const float *ikh, const float *ikl

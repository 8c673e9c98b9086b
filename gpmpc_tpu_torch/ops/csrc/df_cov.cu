// Moment-matching covariance core in double-float32: the lean forward, the
// forward with linearization residuals and the stacked backward.
//
// E[p, n, k] = exp(min(a[p, n] (+) c[p, k] (+) sum_e U[p, n, e] Xj[p, k, e], 60))
// lean forward:   S_p[p] = sum_{n,k} bi E bj,  corr[p] = sum_{n,k} iK_slot E
// with residuals: row side (over k)    A1 = sum bj E,  A2 = sum iK E,
//                                      B1_e = sum bj E Xj_e,  B2_e = sum iK E Xj_e
//                 column side (over n) C1 = sum bi E,  C2 = sum iK E,
//                                      D1_e = sum bi E U_e,  D2_e = sum iK E U_e
// stacked backward, for 2P stacked rows (rows 0..P-1 the row side, rows
// P..2P-1 the column side with the roles of (a, U, bi) and (c, Xj, bj)
// swapped), with w = gs bi bj (+) gco iK and gE = w E:
//                                      ga = sum_k gE,  gU_e = sum_k gE Xj_e
// every value and sum a df32 (hi, lo) pair (df32.cuh). The iK terms exist on
// the diagonal pairs only (the slot comes from diag_pos, as in cov_core.cu);
// elsewhere they are zero.
//
// Replaces gpmpc_tpu/ops/pallas_df_cov.py: _fwd_kernel (lean forward, body
// _fwd_cell), _fwdres_kernel (forward with residuals, body _fwdres_cell) and
// _bwd_kernel (stacked backward, body _bwd_cell, launched by _build_bwd with
// sides=2 on square slabs and sides=1, once per side, on rectangular ones;
// the reference's GPMPC_DF_COV_VJP=stacked scheme).
// The TPU kernels walk (pair, 128-row tile) grid steps over whole-N rows in
// VMEM; E never leaves registers here either.
//
// Both forwards run on row bands. A 32 x 64 tile design held each of them at
// 46 % of its bound at the flagship (P=6, N=384): its 432 blocks of 8 warps
// made 1.64 waves at 2 blocks per SM, each warp ran a df shuffle tree over 8
// values for every row after only 2 columns per lane, and an ordinary
// summing launch (and, for the lean forward, two index_selects in the
// wrapper) followed.
//
// The lean forward: a block owns a band of rows of one pair against all Nc
// columns, warp w the band's row w, its lanes the columns lane + 32 j, two
// at a time (two E chains in flight). Each lane sums S_p's and, on a
// diagonal pair, corr's terms in df over its columns in order; one warp tree
// per value and a fixed pairwise tree over the band's warps (shared memory)
// give one partial per band. The bands are planned by the wrapper from the
// card's SM count (df_cov.fwd_launch_plan) so that all blocks fit one wave
// of one block per SM and the busiest of a block's four warp schedulers
// (warp w runs on scheduler w % 4) has the least work, a diagonal pair's
// element costing more by its iK term: at the flagship 72 bands of 16 rows
// (diagonal pairs, 4 rows a scheduler) and 60 of 20 (5 a scheduler), 132
// blocks (18 and 19 rows, balanced by work alone, leave 5 rows of the
// costlier element on a scheduler, and ran slower). The forward
// is a programmatic dependent of the kernel before it (it waits before its
// first read); its summing launch, a programmatic dependent of the forward,
// adds each pair's bands in order and writes S_p (P,) and corr (n_diag,) in
// diag_pos order, so no PyTorch operation follows the kernels.
//
// The forward with residuals: a block owns a band of rows
// of one pair against all Nc columns, a warp one row, its lanes two columns
// at a time (two E chains in flight). Band sizes are chosen at launch from
// the card's SM count so that all blocks fit one wave of one block per SM
// and carry about the same work (a diagonal pair's element, with its iK
// terms, costs ~1.3 times another's): at the flagship 72 bands of 16 rows
// (diagonal pairs) and 60 of 20 rows, 132 blocks. A row's sums run within
// each lane over its Nc / 32 columns and end in one warp tree per row (no
// row partials, no row launch); a column's sums are added over the band's
// warps through shared memory (double-buffered, one barrier per 64 columns)
// and a second launch, a programmatic dependent, adds the bands in order.
// Off the diagonal pairs the iK-weighted values are zero and are neither
// computed nor reduced.
//
// The stacked backward gives each warp one whole stacked row: its lanes
// stride the N columns, each lane sums its columns sequentially in df, and a
// shuffle tree finishes the row. N = 384 columns is 12 per lane, so every
// sum ends inside its warp: one launch, no partials, no second pass. On
// square slabs the column side reads iK's row slab at its own row index, as
// the reference does: that is iK's column slab because iK is symmetric. On
// rectangular ones (the N-sharded core's row slabs) the reference's sides=1
// variant: one launch per side, the column side reading iK's transpose
// down the untransposed slab's columns.
//
// Bound: arithmetic. One E element is ~700 f32 add/multiply instructions, a
// row-side and column-side residual element another ~500 on a diagonal pair,
// and none may fuse into an FMA; the operands are ~4 MB (the df iK slab) at
// the flagship.
// The ns-contraction inside the exponent is elementwise df math, never a
// tensor-core product.

#include <cuda_runtime.h>

#include "df32.cuh"
#include "pdl.cuh"

namespace {

using gpmpc_df::df;
using gpmpc_df::df_add;
using gpmpc_df::df_exp;
using gpmpc_df::df_collapse;
using gpmpc_df::df_mul;
using gpmpc_df::df_mul_f32;
using gpmpc_df::fast_two_sum;
using gpmpc_df::two_sum;

constexpr int kWarps = 8;  // the stacked backward: rows of a block, a warp each
constexpr int kThreads = 32 * kWarps;

// the 14 operands, each an f32 half of a df pair; layouts (row major):
// a, bi (P, Nr); c, bj (P, Nc); U (P, Nr, ns); Xj (P, Nc, ns); iK (n_diag, Nr, Nc)
struct Operands {
  const float *ah, *al, *ch, *cl, *uh, *ul, *xjh, *xjl, *bih, *bil, *bjh, *bjl, *ikh, *ikl;
};

__device__ __forceinline__ int ik_slot(int p, const int* diag_pos, int n_diag) {
  for (int m = 0; m < n_diag; ++m)
    if (diag_pos[m] == p) return m;
  return -1;
}

// one df E element (pallas_df_cov._e_slab_df): the cap applies to the hi part
template <int NS>
__device__ __forceinline__ df e_elem(df a, const df* u, df c, const df* xj) {
  return gpmpc_df::e_capped_exp(gpmpc_df::e_exponent<NS>(a, u, c, xj));
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

// one row n: a, bi and U
template <int NS>
struct Row {
  df a, bi, u[NS];

  __device__ __forceinline__ void load(const Operands& o, int p, int nr, int n) {
    const size_t i = (size_t)p * nr + n;
    a = {o.ah[i], o.al[i]};
    bi = {o.bih[i], o.bil[i]};
#pragma unroll
    for (int e = 0; e < NS; ++e) u[e] = {o.uh[i * NS + e], o.ul[i * NS + e]};
  }
};

// The forward with residuals on row bands. A block owns a band of rows of
// one pair against all Nc columns, warp w the band's row w, its lanes the
// columns (lane + 32 j, kLaneCols per chunk of kChunkCols). Each E is
// computed once and feeds both sides. Values per side, in order: A1, A2,
// B1_0.., B2_0.. (row) and C1, C2, D1_0.., D2_0.. (column); IK: the pair is
// a diagonal one (the iK-weighted values; zero elsewhere).
// Row side: each lane sums its columns in order, then warp_df_sum; written
// to row_out [2][P][NV][Nr]. Column side, per chunk: the band's warps' values
// are staged in shared memory (double-buffered, one barrier per chunk) and
// added by a fixed pairwise tree over kMaxBandWarps slots (rows past the
// band's end are zero), written to col_part [2][P][max_bands][NV][Nc];
// df_fwdres_col_sum_kernel adds each pair's bands in order.
// Band sizes (fwdres_bands): an element of a diagonal pair costs about 1.3
// times an off-diagonal one's (the iK terms), so diagonal pairs get shorter
// bands, sized so that every block carries about the same work and all
// blocks fit one wave of one block per SM.
constexpr int kMaxBandWarps = 20;
constexpr int kLaneCols = 2;  // columns per lane per chunk
constexpr int kChunkCols = 32 * kLaneCols;

// f32 instructions per element (the counts of df32.cuh's operations that
// chip_smoke.df_instructions_per_element makes): off a diagonal pair, and
// the extra of the iK terms on one
constexpr int kDfAdd = 11, kDfMul = 32, kDfExp = 566;
constexpr int fwdres_elem_cost(int ns, bool ik) {
  return 12 + ns * (kDfMul + kDfAdd) + kDfExp + 2 * kDfMul + 2 * kDfAdd + 2 * ns * (kDfMul + kDfAdd) +
         (ik ? kDfMul + 2 * kDfAdd + 2 * ns * (kDfMul + kDfAdd) : 0);
}

// rows per band of a diagonal and of an off-diagonal pair, the grid and the
// most bands of a pair
struct Bands {
  int rows_d, rows_o, blocks, max_bands;
};

// the pairwise tree of df_sum over W values in x (pairs (0, 1), (2, 3), ...;
// an odd tail is carried, where df_sum adds an exact 0); the sum in x[0]
template <int W>
__device__ __forceinline__ void pairwise_tree(df* x) {
#pragma unroll
  for (int w = 0; w < W / 2; ++w) x[w] = df_add(x[2 * w], x[2 * w + 1]);
  if (W % 2) x[W / 2] = x[W - 1];
  if constexpr ((W + 1) / 2 > 1) pairwise_tree<(W + 1) / 2>(x);
}

template <int NS, bool IK>
__device__ void fwdres_band(const Operands& o, int slot, float* __restrict__ row_out,
                            float* __restrict__ col_part, df* stage, int nr, int nc, int band, int rows, int p,
                            int np, int n_bands) {
  constexpr int NV = 2 + 2 * NS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = band * rows + warp;
  const bool live = warp < rows && n < nr;  // warp-uniform
  Row<NS> row;
  row.load(o, p, nr, live ? n : 0);
  df racc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) racc[v] = {0.f, 0.f};

  const size_t col_plane = (size_t)np * n_bands * NV * nc;
  const int n_chunks = (nc + kChunkCols - 1) / kChunkCols;
  for (int cc = 0; cc < n_chunks; ++cc) {
    // a lane's columns k = cc kChunkCols + 32 j + lane, in order of j; both
    // elements without a branch, so that the compiler interleaves their E
    df col[kLaneCols][NV];
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j)
#pragma unroll
      for (int v = 0; v < NV; ++v) col[j][v] = {0.f, 0.f};
    if (live) {  // warp-uniform
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const int k = cc * kChunkCols + 32 * j + lane;
        const bool kv = k < nc;
        const size_t ci = (size_t)p * nc + (kv ? k : 0);
        const df c = {o.ch[ci], o.cl[ci]}, bj = {o.bjh[ci], o.bjl[ci]};
        df xj[NS];
#pragma unroll
        for (int e = 0; e < NS; ++e) xj[e] = {o.xjh[ci * NS + e], o.xjl[ci * NS + e]};
        // past the last column E is 0, so every sum adds an exact 0
        const df e_k = e_elem<NS>(row.a, row.u, c, xj);
        const df e = kv ? e_k : df{0.f, 0.f};
        const df wb = df_mul(e, bj);
        const df vb = df_mul(e, row.bi);
        racc[0] = df_add(racc[0], wb);
        col[j][0] = vb;
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          racc[2 + q] = df_add(racc[2 + q], df_mul(wb, xj[q]));
          col[j][2 + q] = df_mul(vb, row.u[q]);
        }
        if (IK) {
          const size_t i_k = ((size_t)slot * nr + n) * nc + (kv ? k : 0);
          const df qv = df_mul(e, {o.ikh[i_k], o.ikl[i_k]});
          racc[1] = df_add(racc[1], qv);
          col[j][1] = qv;
#pragma unroll
          for (int q = 0; q < NS; ++q) {
            racc[2 + NS + q] = df_add(racc[2 + NS + q], df_mul(qv, xj[q]));
            col[j][2 + NS + q] = df_mul(qv, row.u[q]);
          }
        }
      }
    }
    // the band's column sums of this chunk: warp w's values in stage[buf][w],
    // added once every warp has written
    df* buf = stage + (size_t)(cc & 1) * kMaxBandWarps * NV * kChunkCols;
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (IK || v == 0 || (v >= 2 && v < 2 + NS))
          buf[((size_t)warp * NV + v) * kChunkCols + 32 * j + lane] = col[j][v];
    __syncthreads();
    for (int t = threadIdx.x; t < NV * kChunkCols; t += blockDim.x) {
      const int v = t / kChunkCols, cl = t % kChunkCols;
      const int kk = cc * kChunkCols + cl;
      if (kk >= nc) continue;
      df tot = {0.f, 0.f};
      if (IK || v == 0 || (v >= 2 && v < 2 + NS)) {
        df x[kMaxBandWarps];
#pragma unroll
        for (int w = 0; w < kMaxBandWarps; ++w)
          x[w] = w < rows ? buf[((size_t)w * NV + v) * kChunkCols + cl] : df{0.f, 0.f};
        pairwise_tree<kMaxBandWarps>(x);
        tot = x[0];
      }
      const size_t idx = (((size_t)p * n_bands + band) * NV + v) * nc + kk;
      col_part[idx] = tot.h;
      col_part[col_plane + idx] = tot.l;
    }
  }

  // the row: one warp tree per value
  const size_t row_plane = (size_t)np * NV * nr;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const df tot = IK || v == 0 || (v >= 2 && v < 2 + NS) ? warp_df_sum(racc[v]) : df{0.f, 0.f};
    if (lane == 0 && live) {
      const size_t idx = ((size_t)p * NV + v) * nr + n;
      row_out[idx] = tot.h;
      row_out[row_plane + idx] = tot.l;
    }
  }
}

// grid: the bands of pair 0, then of pair 1, ...; block 32 max(rows_d,
// rows_o) threads; dynamic shared memory: the double-buffered column staging,
// 2 kMaxBandWarps NV kChunkCols df. The summing launch that follows is a
// programmatic dependent; it is not released early, since its blocks would
// wait on SMs that this launch fills.
template <int NS>
__global__ void __launch_bounds__(32 * kMaxBandWarps, 1)
df_fwdres_kernel(Operands o, const int* __restrict__ diag_pos, int n_diag, float* __restrict__ row_out,
                 float* __restrict__ col_part, int np, int nr, int nc, Bands bands) {
  extern __shared__ df stage[];
  int band = blockIdx.x, p = 0, slot = ik_slot(0, diag_pos, n_diag);
  int rows = slot >= 0 ? bands.rows_d : bands.rows_o;
  while (band >= (nr + rows - 1) / rows) {
    band -= (nr + rows - 1) / rows;
    slot = ik_slot(++p, diag_pos, n_diag);
    rows = slot >= 0 ? bands.rows_d : bands.rows_o;
  }
  if (slot >= 0)
    fwdres_band<NS, true>(o, slot, row_out, col_part, stage, nr, nc, band, rows, p, np, bands.max_bands);
  else
    fwdres_band<NS, false>(o, slot, row_out, col_part, stage, nr, nc, band, rows, p, np, bands.max_bands);
}

// col_out[p, i] = df sum over the bands t of pair p of col_part[p, t, i], in
// order of t. col_part: planes [2][P][max_bands][inner]; col_out: [2][P][inner]
__global__ void df_fwdres_col_sum_kernel(const float* __restrict__ col_part, float* __restrict__ col_out, int np,
                                         int inner, int nr, Bands bands, const int* __restrict__ diag_pos,
                                         int n_diag) {
  constexpr int kBatch = 8;  // the loads of a batch ahead of its adds
  gpmpc_pdl::wait_for_prerequisite();
  const size_t total = (size_t)np * inner;
  const size_t plane = total * bands.max_bands;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total; o += (size_t)gridDim.x * blockDim.x) {
    const int p = (int)(o / inner);
    const size_t ii = o % inner;
    const int rows = ik_slot(p, diag_pos, n_diag) >= 0 ? bands.rows_d : bands.rows_o;
    const int n_bands = (nr + rows - 1) / rows;
    df acc = {0.f, 0.f};
    for (int t0 = 0; t0 < n_bands; t0 += kBatch) {
      df v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const size_t idx = ((size_t)p * bands.max_bands + (t0 + b < n_bands ? t0 + b : t0)) * inner + ii;
        v[b] = {col_part[idx], col_part[plane + idx]};
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (t0 + b < n_bands) acc = df_add(acc, v[b]);
    }
    col_out[o] = acc.h;
    col_out[total + o] = acc.l;
  }
}

// The lean forward on row bands (df_cov.fwd_launch_plan plans them): the
// rows of a band of a diagonal and of an off-diagonal pair, and the most
// bands of a pair (the partial buffer's stride).
constexpr int kFwdMaxWarps = 20;  // rows of a band, a warp each
constexpr int kFwdLaneCols = 2;   // a lane's columns per chunk: E chains in flight
constexpr int kFwdChunkCols = 32 * kFwdLaneCols;
constexpr int kFwdSumThreads = 256;

struct FwdPlan {
  int rows_d, rows_o, max_bands;
};

// band `band` (rows band rows ..) of pair p: warp w the row band rows + w,
// its lanes the columns k0 + 32 j + lane of each chunk of kFwdChunkCols, in
// order. One partial of S_p and one of corr (zero off the diagonal pairs)
// per band into part [2 (hi, lo)][P][max_bands][2 (S_p, corr)].
template <int NS, bool IK>
__device__ __forceinline__ void fwd_band(const Operands& o, int slot, float* __restrict__ part, df (*red)[kFwdMaxWarps],
                                         int np, int nr, int nc, int band, int rows, int p, int max_bands) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = band * rows + warp;
  df s = {0.f, 0.f}, q = {0.f, 0.f};
  if (warp < rows && n < nr) {  // warp-uniform
    Row<NS> row;
    row.load(o, p, nr, n);
    const size_t ik_row = IK ? ((size_t)slot * nr + n) * nc : 0;
    for (int k0 = 0; k0 < nc; k0 += kFwdChunkCols) {
      // the chunk's elements without a branch, so that the compiler interleaves their E
#pragma unroll
      for (int j = 0; j < kFwdLaneCols; ++j) {
        const int k = k0 + 32 * j + lane;
        const bool kv = k < nc;
        const size_t ci = (size_t)p * nc + (kv ? k : 0);
        const df c = {o.ch[ci], o.cl[ci]}, bj = {o.bjh[ci], o.bjl[ci]};
        df xj[NS];
#pragma unroll
        for (int e = 0; e < NS; ++e) xj[e] = {o.xjh[ci * NS + e], o.xjl[ci * NS + e]};
        // past the last column E is 0, so every sum adds an exact 0
        const df e_k = e_elem<NS>(row.a, row.u, c, xj);
        const df e = kv ? e_k : df{0.f, 0.f};
        s = df_add(s, df_mul(df_mul(e, row.bi), bj));
        if (IK) {
          const size_t i_k = ik_row + (kv ? k : 0);
          q = df_add(q, df_mul(e, {o.ikh[i_k], o.ikl[i_k]}));
        }
      }
    }
  }
  s = warp_df_sum(s);
  if (IK) q = warp_df_sum(q);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x < 2) {  // the band's warps (zero past its rows) by a fixed pairwise tree
    const int nw = blockDim.x >> 5;
    df x[kFwdMaxWarps];
#pragma unroll
    for (int w = 0; w < kFwdMaxWarps; ++w) x[w] = w < nw ? red[threadIdx.x][w] : df{0.f, 0.f};
    pairwise_tree<kFwdMaxWarps>(x);
    const size_t idx = ((size_t)p * max_bands + band) * 2 + threadIdx.x;
    part[idx] = x[0].h;
    part[(size_t)np * max_bands * 2 + idx] = x[0].l;
  }
}

// grid: the bands of pair 0, then of pair 1, ...; block 32 max(rows_d,
// rows_o) threads.
template <int NS>
__global__ void __launch_bounds__(32 * kFwdMaxWarps, 1)
df_fwd_kernel(Operands o, const int* __restrict__ diag_pos, int n_diag, float* __restrict__ part, int np, int nr,
              int nc, FwdPlan plan) {
  gpmpc_pdl::release_dependents();     // the summing launch waits for this one to end
  gpmpc_pdl::wait_for_prerequisite();  // this launch is a programmatic dependent of the kernel before it
  __shared__ df red[2][kFwdMaxWarps];
  int band = blockIdx.x, p = 0, slot = ik_slot(0, diag_pos, n_diag);
  int rows = slot >= 0 ? plan.rows_d : plan.rows_o;
  while (band >= (nr + rows - 1) / rows) {
    band -= (nr + rows - 1) / rows;
    slot = ik_slot(++p, diag_pos, n_diag);
    rows = slot >= 0 ? plan.rows_d : plan.rows_o;
  }
  if (slot >= 0)
    fwd_band<NS, true>(o, slot, part, red, np, nr, nc, band, rows, p, plan.max_bands);
  else
    fwd_band<NS, false>(o, slot, part, red, np, nr, nc, band, rows, p, plan.max_bands);
}

// One block of kFwdSumThreads, a programmatic dependent of the forward: out
// planes [2 (hi, lo)][P + n_diag], S_p[p] for p < P, then corr[m] of pair
// diag_pos[m]. A warp per output: its lanes add the pair's bands t = lane +
// 32 i in order, then a warp tree; a fixed order.
__global__ void __launch_bounds__(kFwdSumThreads)
df_fwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int np, int nr, FwdPlan plan,
                  const int* __restrict__ diag_pos, int n_diag) {
  gpmpc_pdl::release_dependents();  // a programmatic dependent launch after this one may start
  gpmpc_pdl::wait_for_prerequisite();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_out = np + n_diag;
  const size_t plane = (size_t)np * plan.max_bands * 2;
  for (int o = warp; o < n_out; o += kFwdSumThreads / 32) {
    const bool corr = o >= np;
    const int p = corr ? diag_pos[o - np] : o;
    const int rows = ik_slot(p, diag_pos, n_diag) >= 0 ? plan.rows_d : plan.rows_o;
    const int n_bands = (nr + rows - 1) / rows;
    df acc = {0.f, 0.f};
    for (int t = lane; t < n_bands; t += 32) {
      const size_t idx = ((size_t)p * plan.max_bands + t) * 2 + corr;
      acc = df_add(acc, {part[idx], part[plane + idx]});
    }
    acc = warp_df_sum(acc);
    if (lane == 0) {
      out[o] = acc.h;
      out[n_out + o] = acc.l;
    }
  }
}

// One stacked row of the backward: row `row` of pair p of the operands s
// (the column side's with the roles swapped) against its m columns, n rows
// a side. Its iK entry k is ikh/ikl[ik_row + k ik_step] on a diagonal pair
// (slot >= 0). The lanes take the columns lane + 32 j, each summing its own
// in order in df; a warp tree finishes the row and lane 0 collapses ga[r]
// and gu[r][NS] to f32.
template <int NS>
__device__ __forceinline__ void bwd_row(const Operands& s, const float* __restrict__ ikh,
                                        const float* __restrict__ ikl, int slot, float g_s, float g_c, int p, int n,
                                        int m, int row, size_t ik_row, size_t ik_step, float* __restrict__ ga,
                                        float* __restrict__ gu, size_t r) {
  const int lane = threadIdx.x & 31;
  Row<NS> rw;
  rw.load(s, p, n, row);
  df sa = {0.f, 0.f}, su[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) su[e] = {0.f, 0.f};
  for (int k = lane; k < m; k += 32) {
    const size_t i = (size_t)p * m + k;
    const df c = {s.ch[i], s.cl[i]};
    df xj[NS];
#pragma unroll
    for (int e = 0; e < NS; ++e) xj[e] = {s.xjh[i * NS + e], s.xjl[i * NS + e]};
    df w = df_mul_f32(df_mul(rw.bi, {s.bjh[i], s.bjl[i]}), g_s);
    if (slot >= 0) {
      const size_t q = ik_row + k * ik_step;
      w = df_add(w, df_mul_f32({ikh[q], ikl[q]}, g_c));
    }
    const df ge = df_mul(w, e_elem<NS>(rw.a, rw.u, c, xj));
    sa = df_add(sa, ge);
#pragma unroll
    for (int e = 0; e < NS; ++e) su[e] = df_add(su[e], df_mul(ge, xj[e]));
  }
  sa = warp_df_sum(sa);
#pragma unroll
  for (int e = 0; e < NS; ++e) su[e] = warp_df_sum(su[e]);
  if (lane == 0) {
    ga[r] = df_collapse(sa);
#pragma unroll
    for (int e = 0; e < NS; ++e) gu[r * NS + e] = df_collapse(su[e]);
  }
}

// the column side's operands: (a, U, bi) and (c, Xj, bj) swapped
__device__ __forceinline__ Operands swap_sides(const Operands& o) {
  return Operands{o.ch, o.cl, o.ah, o.al, o.xjh, o.xjl, o.uh, o.ul, o.bjh, o.bjl, o.bih, o.bil, o.ikh, o.ikl};
}

// Square slabs, both sides in one launch. grid (ceil(N / kWarps), 2P),
// block kThreads. Warp w of block (x, b) owns stacked row n = x kWarps + w
// of stacked pair b: pair b on the row side (b < P), pair b - P with the
// roles swapped on the column side, which reads iK's row slab (iK is
// symmetric). gs and gco are (P,), gco zero off the diagonal pairs; ga
// (2P, N), gu (2P, N, NS).
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_bwd_kernel(Operands o, const float* __restrict__ gs, const float* __restrict__ gco,
              const int* __restrict__ diag_pos, int n_diag, float* __restrict__ ga,
              float* __restrict__ gu, int n) {
  const int np = gridDim.y / 2;
  const int b = blockIdx.y;
  const bool col_side = b >= np;
  const int p = col_side ? b - np : b;
  const int row_n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row_n >= n) return;  // warp-uniform; no block-wide sync follows
  const int slot = ik_slot(p, diag_pos, n_diag);
  const size_t ik_row = ((size_t)(slot < 0 ? 0 : slot) * n + row_n) * n;
  bwd_row<NS>(col_side ? swap_sides(o) : o, o.ikh, o.ikl, slot, gs[p], slot >= 0 ? gco[p] : 0.f, p, n, n, row_n,
              ik_row, 1, ga, gu, (size_t)b * n + row_n);
}

// Rectangular slabs (Nr rows against Nc columns, the N-sharded core's), one
// side per launch, the reference's sides=1 variant: grid (ceil(rows /
// kWarps), P), warp w of block (x, p) the side's row x kWarps + w of pair p.
// side 0: the Nr rows of (a, U, bi) against (c, Xj, bj), iK's rows. side 1:
// the Nc rows with the roles swapped, on iK's transpose, read down the
// columns of the untransposed slab at stride Nc (no transposed copy; a
// block's 8 warps read 8 consecutive entries of a column's sector). ga
// (P, rows), gu (P, rows, NS) of the side.
template <int NS>
__global__ void __launch_bounds__(kThreads)
df_bwd_side_kernel(Operands o, const float* __restrict__ gs, const float* __restrict__ gco,
                   const int* __restrict__ diag_pos, int n_diag, float* __restrict__ ga,
                   float* __restrict__ gu, int nr, int nc, int side) {
  const int p = blockIdx.y;
  const int n = side ? nc : nr, m = side ? nr : nc;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform; no block-wide sync follows
  const int slot = ik_slot(p, diag_pos, n_diag);
  const size_t slab = (size_t)(slot < 0 ? 0 : slot) * nr * nc;
  const size_t ik_row = side ? slab + row : slab + (size_t)row * nc;
  bwd_row<NS>(side ? swap_sides(o) : o, o.ikh, o.ikl, slot, gs[p], slot >= 0 ? gco[p] : 0.f, p, n, m, row, ik_row,
              side ? (size_t)nc : 1, ga, gu, (size_t)p * n + row);
}

int fwd_threads(const FwdPlan& plan) { return 32 * (plan.rows_d > plan.rows_o ? plan.rows_d : plan.rows_o); }

template <int NS>
int launch_fwd(const Operands& o, const int* diag_pos, int n_diag, float* part, float* out, int p, int nr, int nc,
               FwdPlan plan, int blocks, cudaStream_t stream) {
  const int rc = gpmpc_pdl::launch_dependent(df_fwd_kernel<NS>, blocks, fwd_threads(plan), 0, stream, o, diag_pos,
                                             n_diag, part, p, nr, nc, plan);
  if (rc != 0) return rc;
  return gpmpc_pdl::launch_dependent(df_fwd_sum_kernel, 1, kFwdSumThreads, 0, stream, (const float*)part, out, p, nr,
                                     plan, diag_pos, n_diag);
}

// #5's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory (none), then the rows of its bands, for the
// smoke's report: info[9]
template <int NS>
int fwd_info(FwdPlan plan, int blocks, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_fwd_kernel<NS>);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_fwd_kernel<NS>, fwd_threads(plan), 0);
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[9] = {a.numRegs, (int)a.localSizeBytes, fwd_threads(plan), per_sm, blocks, sms, 0, plan.rows_d,
                       plan.rows_o};
  for (int k = 0; k < 9; ++k) info[k] = vals[k];
  return 0;
}

bool valid_plan(const FwdPlan& plan, int blocks) {
  return plan.rows_d >= 1 && plan.rows_d <= kFwdMaxWarps && plan.rows_o >= 1 && plan.rows_o <= kFwdMaxWarps &&
         plan.max_bands >= 1 && blocks >= 1;
}

// The bands are planned for one batch element: a launch whose P pairs are
// `batch` elements of P / batch pairs each (models/gp.py folds a batched
// rollout so) gets each element's bands, and so its column sums in its own
// order, whatever the batch; the grid is every element's blocks.
Bands fwdres_bands(int p, int nr, int n_diag, int ns, int batch) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int pe = p / batch, de = n_diag / batch;
  const double cd = fwdres_elem_cost(ns, true), co = fwdres_elem_cost(ns, false);
  const double per_sm = (double)nr * (de * cd + (pe - de) * co) / (sms > 0 ? sms : 1);
  auto clamp_rows = [](double r) { return r < 1 ? 1 : r > kMaxBandWarps ? kMaxBandWarps : (int)r; };
  Bands b{};
  for (double work = per_sm;; work *= 1.01) {  // the least work per block that fits one wave
    b.rows_d = clamp_rows(work / cd);
    b.rows_o = clamp_rows(work / co);
    const int nb_d = (nr + b.rows_d - 1) / b.rows_d, nb_o = (nr + b.rows_o - 1) / b.rows_o;
    b.blocks = de * nb_d + (pe - de) * nb_o;
    b.max_bands = de > 0 && nb_d > nb_o ? nb_d : pe > de ? nb_o : nb_d;
    if (b.blocks <= sms || (b.rows_d == kMaxBandWarps && b.rows_o == kMaxBandWarps)) {
      b.blocks *= batch;
      return b;
    }
  }
}

bool valid_fold(int p, int n_diag, int batch) { return batch >= 1 && p % batch == 0 && n_diag % batch == 0; }

template <int NS>
size_t fwdres_smem() {
  return (size_t)2 * kMaxBandWarps * (2 + 2 * NS) * kChunkCols * sizeof(df);
}

template <int NS>
int launch_fwdres(const Operands& o, const int* diag_pos, int n_diag, float* col_part, float* row_out,
                  float* col_out, int p, int nr, int nc, int batch, cudaStream_t stream) {
  constexpr int NV = 2 + 2 * NS;
  const Bands b = fwdres_bands(p, nr, n_diag, NS, batch);
  const int threads = 32 * (b.rows_d > b.rows_o ? b.rows_d : b.rows_o);
  const size_t smem = fwdres_smem<NS>();
  int rc = (int)cudaFuncSetAttribute(df_fwdres_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  df_fwdres_kernel<NS><<<b.blocks, threads, smem, stream>>>(o, diag_pos, n_diag, row_out, col_part, p, nr, nc, b);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long total = (long long)p * NV * nc;
  const int blocks = (int)(total < 256LL * 1024 ? (total + 255) / 256 : 1024);
  return gpmpc_pdl::launch_dependent(df_fwdres_col_sum_kernel, blocks, 256, 0, stream, (const float*)col_part,
                                     col_out, p, NV * nc, nr, b, diag_pos, n_diag);
}

// #6's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (p, nr, n_diag), for the smoke's report
template <int NS>
int fwdres_info(int p, int nr, int n_diag, int batch, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_fwdres_kernel<NS>);
  if (rc != 0) return rc;
  const Bands b = fwdres_bands(p, nr, n_diag, NS, batch);
  const int threads = 32 * (b.rows_d > b.rows_o ? b.rows_d : b.rows_o);
  rc = (int)cudaFuncSetAttribute(df_fwdres_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)fwdres_smem<NS>());
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_fwdres_kernel<NS>, threads, fwdres_smem<NS>());
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[9] = {a.numRegs, (int)a.localSizeBytes, threads, per_sm, b.blocks, sms, (int)fwdres_smem<NS>(),
                       b.rows_d, b.rows_o};
  for (int k = 0; k < 9; ++k) info[k] = vals[k];
  return 0;
}

template <int NS>
int launch_bwd(const Operands& o, const float* gs, const float* gco, const int* diag_pos, int n_diag,
               float* ga, float* gu, int p, int n, cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, 2 * p);
  df_bwd_kernel<NS><<<grid, kThreads, 0, stream>>>(o, gs, gco, diag_pos, n_diag, ga, gu, n);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_bwd_side(const Operands& o, const float* gs, const float* gco, const int* diag_pos, int n_diag,
                    float* ga, float* gu, int p, int nr, int nc, int side, cudaStream_t stream) {
  const int rows = side ? nc : nr;
  const dim3 grid((rows + kWarps - 1) / kWarps, p);
  df_bwd_side_kernel<NS><<<grid, kThreads, 0, stream>>>(o, gs, gco, diag_pos, n_diag, ga, gu, nr, nc, side);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the lean forward on the bands the wrapper planned (df_cov.fwd_launch_plan:
// rows per band of a diagonal and of another pair, the most bands of a pair,
// the blocks); part [2][P][max_bands][2], out [2][P + n_diag]
int gpmpc_df_fwd_f32(const float* ah, const float* al, const float* ch, const float* cl,
                     const float* uh, const float* ul, const float* xjh, const float* xjl,
                     const float* bih, const float* bil, const float* bjh, const float* bjl,
                     const float* ikh, const float* ikl, const int* diag_pos, int n_diag,
                     float* part, float* out, int p, int nr, int nc, int ns, int rows_d, int rows_o,
                     int max_bands, int blocks, void* stream) {
  const FwdPlan plan{rows_d, rows_o, max_bands};
  if (p < 1 || nr < 1 || nc < 1 || !valid_plan(plan, blocks)) return (int)cudaErrorInvalidValue;
  const Operands o{ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_fwd<1>(o, diag_pos, n_diag, part, out, p, nr, nc, plan, blocks, s);
    case 2: return launch_fwd<2>(o, diag_pos, n_diag, part, out, p, nr, nc, plan, blocks, s);
    case 3: return launch_fwd<3>(o, diag_pos, n_diag, part, out, p, nr, nc, plan, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #5's launch report (fwd_info) for a planned launch: info[9]
int gpmpc_df_fwd_info(int ns, int rows_d, int rows_o, int max_bands, int blocks, int* info) {
  const FwdPlan plan{rows_d, rows_o, max_bands};
  if (!valid_plan(plan, blocks)) return (int)cudaErrorInvalidValue;
  switch (ns) {
    case 1: return fwd_info<1>(plan, blocks, info);
    case 2: return fwd_info<2>(plan, blocks, info);
    case 3: return fwd_info<3>(plan, blocks, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the most bands of a pair of df_fwdres on this card: the wrapper sizes
// col_part with it (batch: fwdres_bands)
int gpmpc_df_fwdres_max_bands(int p, int nr, int n_diag, int ns, int batch) {
  if (!valid_fold(p, n_diag, batch)) return -1;
  return fwdres_bands(p, nr, n_diag, ns, batch).max_bands;
}

// batch: the P pairs are that many batch elements of P / batch pairs, each
// with the same diagonal pairs, planned for one element (fwdres_bands)
int gpmpc_df_fwdres_f32(const float* ah, const float* al, const float* ch, const float* cl,
                        const float* uh, const float* ul, const float* xjh, const float* xjl,
                        const float* bih, const float* bil, const float* bjh, const float* bjl,
                        const float* ikh, const float* ikl, const int* diag_pos, int n_diag,
                        float* col_part, float* row_out, float* col_out, int p, int nr, int nc, int ns,
                        int batch, void* stream) {
  if (p < 1 || nr < 1 || nc < 1 || p > 65535 || !valid_fold(p, n_diag, batch)) return (int)cudaErrorInvalidValue;
  const Operands o{ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_fwdres<1>(o, diag_pos, n_diag, col_part, row_out, col_out, p, nr, nc, batch, s);
    case 2: return launch_fwdres<2>(o, diag_pos, n_diag, col_part, row_out, col_out, p, nr, nc, batch, s);
    case 3: return launch_fwdres<3>(o, diag_pos, n_diag, col_part, row_out, col_out, p, nr, nc, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #6's launch report (fwdres_info): info[9]
int gpmpc_df_fwdres_info(int p, int nr, int n_diag, int ns, int batch, int* info) {
  if (!valid_fold(p, n_diag, batch)) return (int)cudaErrorInvalidValue;
  switch (ns) {
    case 1: return fwdres_info<1>(p, nr, n_diag, batch, info);
    case 2: return fwdres_info<2>(p, nr, n_diag, batch, info);
    case 3: return fwdres_info<3>(p, nr, n_diag, batch, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

int gpmpc_df_bwd_f32(const float* ah, const float* al, const float* ch, const float* cl,
                     const float* uh, const float* ul, const float* xjh, const float* xjl,
                     const float* bih, const float* bil, const float* bjh, const float* bjl,
                     const float* ikh, const float* ikl, const float* gs, const float* gco,
                     const int* diag_pos, int n_diag, float* ga, float* gu, int p, int n, int ns,
                     void* stream) {
  if (p < 1 || n < 1 || 2 * p > 65535) return (int)cudaErrorInvalidValue;
  const Operands o{ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd<1>(o, gs, gco, diag_pos, n_diag, ga, gu, p, n, s);
    case 2: return launch_bwd<2>(o, gs, gco, diag_pos, n_diag, ga, gu, p, n, s);
    case 3: return launch_bwd<3>(o, gs, gco, diag_pos, n_diag, ga, gu, p, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// one side of the stacked backward on a rectangular slab (Nr rows against
// Nc columns; side 0 the row side, 1 the column side): ga (P, rows), gu
// (P, rows, ns) of that side
int gpmpc_df_bwd_side_f32(const float* ah, const float* al, const float* ch, const float* cl,
                          const float* uh, const float* ul, const float* xjh, const float* xjl,
                          const float* bih, const float* bil, const float* bjh, const float* bjl,
                          const float* ikh, const float* ikl, const float* gs, const float* gco,
                          const int* diag_pos, int n_diag, float* ga, float* gu, int p, int nr, int nc, int ns,
                          int side, void* stream) {
  if (p < 1 || nr < 1 || nc < 1 || p > 65535 || (side != 0 && side != 1)) return (int)cudaErrorInvalidValue;
  const Operands o{ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_side<1>(o, gs, gco, diag_pos, n_diag, ga, gu, p, nr, nc, side, s);
    case 2: return launch_bwd_side<2>(o, gs, gco, diag_pos, n_diag, ga, gu, p, nr, nc, side, s);
    case 3: return launch_bwd_side<3>(o, gs, gco, diag_pos, n_diag, ga, gu, p, nr, nc, side, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

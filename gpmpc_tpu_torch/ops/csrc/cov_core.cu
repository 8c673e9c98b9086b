// Moment-matching covariance core, f32: forward, backward of both sides and
// the iK gradient.
//
// E[p, n, k] = exp(min(a[p, n] + c[p, k] + U[p, n, :] . Xj[p, k, :], 60))
// S_p[p]     = sum_{n,k} bi[p, n] E[p, n, k] bj[p, k]
// corr[m]    = sum_{n,k} iK[m, n, k] E[diag_pos[m], n, k]
//
// Replaces gpmpc_tpu/ops/pallas_moment_cov.py: _cov_fwd_kernel (forward),
// _bwd_row_kernel (row-side backward, which the reference launches once per
// side with the roles of (a, c), (U, Xj) and (bi, bj) swapped; here one
// launch runs both sides on stacked rows) and
// _gik_kernel (the gradient with respect to iK: gK[m] = g_corr[m] E of the
// diagonal pair diag_pos[m]). The iK model slab of a pair is found from
// diag_pos inside the kernel, as _ik_slot does.
//
// Layouts (all contiguous, row major): a, bi (P, Nr); c, bj (P, Nc);
// U (P, Nr, ns); Xj (P, Nc, ns); iK and gK (n_diag, Nr, Nc).
//
// The forward and the backward read iK once (the only O(N^2) input) and
// compute E on the fly, never writing it. The iK gradient is the one kernel
// with an O(N^2) output: by bytes it is bound by writing gK (1.77 MB at the
// flagship, 0.53 us), in practice by its launch, its latency and its
// instructions per element (a launch that does nothing costs ~1.9 us of
// device time per call on an H100, ~1.0 us as a programmatic dependent). So
// it runs one wave of row bands in blocks of up to 1,024 threads, a thread
// loading its item's operands in 16-byte loads and writing 16 bytes a
// store, and launches as a programmatic dependent of the kernel before it
// (cov_gik_kernel). Every kernel computes E by cov_e, the same f32
// operations in the same order. The ns-contraction is ns scalar f32
// FMAs: no tensor cores, whose TF32 inputs would put a ~1e-3 error inside the
// exp. Each block writes its own partial, summed in a fixed order, so runs
// repeat bitwise.

#include <cstdint>

#include <cuda_runtime.h>

#include "pdl.cuh"

// Largest state dimension Ns (the cov core's inner contraction length) the
// kernels keep in registers. The wrappers refuse larger Ns.
#define GPMPC_MAX_NS 8

namespace {

__device__ __forceinline__ float gpmpc_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// one element of E: exp(min(a + c + sum_e u_e x_e, 60)), the FMAs in e order
__device__ __forceinline__ float cov_e(float an, float ck, const float* un, const float* xk, int ns) {
  float expo = an + ck;
#pragma unroll
  for (int e = 0; e < GPMPC_MAX_NS; ++e)
    if (e < ns) expo = fmaf(un[e], xk[e], expo);
  return expf(fminf(expo, 60.f));
}

constexpr int kFwdThreads = 1024;  // forward: most threads of a band block
constexpr int kFwdBatch = 16;      // forward: a thread's elements whose iK loads are in flight together
constexpr int kFwdMaxRows = 1024;  // forward: rows of a band (its row operands live in shared memory)
constexpr int kFwdSumThreads = 256;
constexpr int kBwdWarps = 8;       // backward: one warp per stacked row, 8 rows a block
constexpr int kBwdCols = 12;       // backward: a lane's columns per batch, unrolled
constexpr int kBwdBatch = 32 * kBwdCols;  // backward: columns staged in shared memory at a time

__device__ __forceinline__ int ik_slot(int p, const int* diag_pos, int n_diag) {
  for (int m = 0; m < n_diag; ++m)
    if (diag_pos[m] == p) return m;
  return -1;
}

// the forward's working threads at Nc columns: m = max(1, kFwdThreads / Nc)
// row groups of Nc threads, at most kFwdThreads; the block is that rounded
// up to whole warps
__host__ __device__ __forceinline__ int fwd_row_groups(int nc) { return nc < kFwdThreads ? kFwdThreads / nc : 1; }
__host__ __device__ __forceinline__ int fwd_threads(int nc) {
  return nc < kFwdThreads ? fwd_row_groups(nc) * nc : kFwdThreads;
}
__host__ __device__ __forceinline__ int fwd_block(int nc) { return (fwd_threads(nc) + 31) / 32 * 32; }

// The forward on row bands. Block b owns band t = b % bands of pair
// b / bands (rows t rows .. (t + 1) rows, the last band shorter) against
// all Nc columns, with fwd_threads(Nc) working threads: thread t the column
// t % Nc (and t + kFwdThreads, ... past kFwdThreads columns), its operands (c, bj,
// Xj) in registers, against the band's rows t / Nc, t / Nc + m, ... (m row
// groups). So every thread has the same number of elements to within one at
// Nc <= kFwdThreads, a warp reads 32 neighbouring iK entries of one row, and
// the band's row operands (a, bi, U), staged in dynamic shared memory, are
// read by a warp at one address (Nc >= 32). A thread's iK loads go out kFwdBatch at a
// time ahead of its exps. rows and bands come with the launch
// (moment_cov.fwd_launch_plan: the bands of all pairs in one wave of one
// block per SM where they fit). Writes one partial of S_p and, on a diagonal
// pair, of corr per block into part [2][P bands] (S_p, then corr); the
// summing launch, a programmatic dependent released when this one starts,
// adds them in a fixed order.
__global__ void __launch_bounds__(kFwdThreads)
cov_fwd_kernel(const float* __restrict__ a, const float* __restrict__ c,
               const float* __restrict__ u, const float* __restrict__ xj,
               const float* __restrict__ bi, const float* __restrict__ bj,
               const float* __restrict__ ik, const int* __restrict__ diag_pos,
               int n_diag, float* __restrict__ part, int nr, int nc, int ns,
               int rows) {
  gpmpc_pdl::release_dependents();  // the summing launch waits for this one to end
  gpmpc_pdl::wait_for_prerequisite();  // this launch is a programmatic dependent of the kernel before it
  extern __shared__ float s_rows[];  // a [rows], bi [rows], U [rows][ns]
  __shared__ float red[2][32];
  const int bands = (nr + rows - 1) / rows;
  const int p = blockIdx.x / bands;
  const int n0 = (blockIdx.x % bands) * rows;
  const int nrow = min(rows, nr - n0);
  const int slot = ik_slot(p, diag_pos, n_diag);
  const float* ik_band = slot >= 0 ? ik + ((size_t)slot * nr + n0) * nc : nullptr;
  const int m = fwd_row_groups(nc), work = fwd_threads(nc);
  const bool active = threadIdx.x < work;
  const int r_first = threadIdx.x / nc;
  int k = threadIdx.x % nc;

  // this thread's column operands and first iK batch, in flight while the
  // band's row operands are staged
  float ck = 0.f, bjk = 0.f, xk[GPMPC_MAX_NS], ikv[kFwdBatch];
  auto load_column = [&]() {
    const size_t ci = (size_t)p * nc + k;
    ck = c[ci];
    bjk = bj[ci];
#pragma unroll
    for (int f = 0; f < GPMPC_MAX_NS; ++f) xk[f] = f < ns ? xj[ci * ns + f] : 0.f;
  };
  auto load_ik = [&](int r0) {
#pragma unroll
    for (int q = 0; q < kFwdBatch; ++q) {
      const int r = r0 + q * m;
      ikv[q] = ik_band && r < nrow ? ik_band[(size_t)r * nc + k] : 0.f;
    }
  };
  if (active) {
    load_column();
    load_ik(r_first);
  }
  float* s_a = s_rows;
  float* s_bi = s_a + rows;
  float* s_u = s_bi + rows;
  for (int t = threadIdx.x; t < nrow; t += blockDim.x) {
    s_a[t] = a[(size_t)p * nr + n0 + t];
    s_bi[t] = bi[(size_t)p * nr + n0 + t];
  }
  for (int t = threadIdx.x; t < nrow * ns; t += blockDim.x)
    s_u[t] = u[((size_t)p * nr + n0) * ns + t];
  __syncthreads();

  float acc_s = 0.f;
  float acc_c = 0.f;
  while (active) {
    for (int r0 = r_first; r0 < nrow; r0 += kFwdBatch * m) {
      if (r0 != r_first) load_ik(r0);
#pragma unroll
      for (int q = 0; q < kFwdBatch; ++q) {
        const int r = r0 + q * m;
        if (r < nrow) {
          const float ev = cov_e(s_a[r], ck, s_u + r * ns, xk, ns);
          acc_s = fmaf(s_bi[r] * ev, bjk, acc_s);
          acc_c = fmaf(ikv[q], ev, acc_c);
        }
      }
    }
    k += work;  // past kFwdThreads columns: the thread's next column
    if (k >= nc) break;
    load_column();
    load_ik(r_first);
  }

  // both sums over the block at once: warps by shuffles, then warp 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc_s = gpmpc_warp_sum(acc_s);
  acc_c = gpmpc_warp_sum(acc_c);
  if (lane == 0) {
    red[0][warp] = acc_s;
    red[1][warp] = acc_c;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    acc_s = gpmpc_warp_sum(lane < nwarps ? red[0][lane] : 0.f);
    acc_c = gpmpc_warp_sum(lane < nwarps ? red[1][lane] : 0.f);
    if (lane == 0) {
      part[blockIdx.x] = acc_s;
      part[gridDim.x + blockIdx.x] = acc_c;
    }
  }
}

// One block of kFwdSumThreads, a programmatic dependent of the forward:
// S_p[p] (p < P) and corr[m] (the partials of pair diag_pos[m]) from part,
// one warp per output in a loop, each a warp's sum of its bands' partials (a
// lane its partials in order, then a shuffle tree): a fixed order.
__global__ void __launch_bounds__(kFwdSumThreads)
cov_fwd_sum_kernel(const float* __restrict__ part, const int* __restrict__ diag_pos, int n_diag,
                   float* __restrict__ out, int np, int bands) {
  gpmpc_pdl::release_dependents();  // a programmatic dependent launch after this one may start
  gpmpc_pdl::wait_for_prerequisite();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = warp; o < np + n_diag; o += kFwdSumThreads / 32) {
    const float* src = o < np ? part + (size_t)o * bands : part + (size_t)(np + diag_pos[o - np]) * bands;
    float v = 0.f;
    for (int b = lane; b < bands; b += 32) v += src[b];
    v = gpmpc_warp_sum(v);
    if (lane == 0) out[o] = v;
  }
}

// The backward of both sides in one launch, on 2P stacked rows: stacked
// pair s < P is the row side of pair s (its rows n against the columns k),
// s >= P the column side of pair s - P, with (a, U, wr) and (c, Xj, wc)
// swapped (its rows k against the columns n). With
// W = g[p] wr wc E + g_corr[slot] iK_slot E (g_corr, the corr cotangent in
// diag_pos order, read through the pair's slot on diagonal pairs only), each
// stacked row writes gA = sum W, gU = sum W Xj (the column operand's) and
// gw = g[p] sum E wc: the row side's Nr rows into [P][Nr](...), then the
// column side's Nc rows into [P][Nc](...). On square slabs the column side
// reads iK's row slab at its own row index (iK is symmetric); on rectangular
// ones (a row slab of Nr rows against all Nc columns, the N-sharded core's)
// it reads the untransposed slab down a column, at stride Nc: iK^T without
// a transposed copy. A block's 8 warps take 8 consecutive rows, so there the
// 8 reads of one column's entries share a 32-byte sector.
// grid (ceil(max(Nr, Nc) / kBwdWarps), 2P), block 32 kBwdWarps: warp w of
// block (x, s) owns the stacked row x kBwdWarps + w (past its side's rows it
// idles), its lanes the columns lane + 32 j, summed in that order. Per batch of kBwdBatch columns a lane's
// iK entries go out first, then the block stages the batch's column
// operands in shared memory, so no load waits on an E; the lane's columns
// are unrolled. The same f32 operations per element and the same order of
// sums as one launch per side.
// RECT: the rectangular instantiation; the square one (Nr = Nc) keeps the
// index arithmetic of a single N.
template <int NS, bool RECT>
__global__ void __launch_bounds__(32 * kBwdWarps)
cov_bwd_kernel(const float* __restrict__ g, const float* __restrict__ a, const float* __restrict__ c,
               const float* __restrict__ u, const float* __restrict__ xj, const float* __restrict__ wr,
               const float* __restrict__ wc, const float* __restrict__ ik, const float* __restrict__ g_corr,
               const int* __restrict__ diag_pos, int n_diag, float* __restrict__ ga, float* __restrict__ gu,
               float* __restrict__ gw, int np, int nr, int nc) {
  gpmpc_pdl::release_dependents();
  gpmpc_pdl::wait_for_prerequisite();  // this launch is a programmatic dependent of the kernel before it
  extern __shared__ float s_cols[];    // the batch's c [kBwdBatch], wc [kBwdBatch], Xj [NS][kBwdBatch]
  float* s_c = s_cols;
  float* s_wc = s_c + kBwdBatch;
  float* s_x = s_wc + kBwdBatch;
  const int s = blockIdx.y;
  const bool col_side = s >= np;
  const int p = col_side ? s - np : s;
  const float* r_a = col_side ? c : a;
  const float* r_u = col_side ? xj : u;
  const float* r_w = col_side ? wc : wr;
  const float* c_a = col_side ? a : c;
  const float* c_u = col_side ? u : xj;
  const float* c_w = col_side ? wr : wc;
  const int n = RECT && col_side ? nc : nr;  // this side's rows
  const int m = RECT && col_side ? nr : nc;  // and columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kBwdWarps + warp;
  const bool live = row < n;  // warp-uniform; every warp stays for the barriers

  const int slot = ik_slot(p, diag_pos, n_diag);
  const float gp = g[p];
  const float gcp = slot >= 0 ? g_corr[slot] : 0.f;
  // this row's iK entries: entry k at ik_row[k * ik_step]
  const bool down_column = RECT && col_side;
  const size_t ik_step = down_column ? (size_t)nc : 1;
  const float* ik_row = slot >= 0 && live
                            ? ik + (size_t)slot * nr * nc + (down_column ? (size_t)row : (size_t)row * m)
                            : nullptr;
  const size_t ri = (size_t)p * n + (live ? row : 0);
  const float an = r_a[ri];
  const float g_wr = gp * r_w[ri];
  float un[NS], s_gu[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    un[e] = r_u[ri * NS + e];
    s_gu[e] = 0.f;
  }

  float s_w = 0.f;
  float s_ewc = 0.f;
  for (int k0 = 0; k0 < m; k0 += kBwdBatch) {
    float ikv[kBwdCols];
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      const int k = k0 + lane + 32 * j;
      ikv[j] = ik_row && k < m ? ik_row[k * ik_step] : 0.f;
    }
    if (k0 > 0) __syncthreads();  // every warp is done with the batch before
    for (int t = threadIdx.x; t < kBwdBatch && k0 + t < m; t += blockDim.x) {
      const size_t ci = (size_t)p * m + k0 + t;
      s_c[t] = c_a[ci];
      s_wc[t] = c_w[ci];
#pragma unroll
      for (int e = 0; e < NS; ++e) s_x[e * kBwdBatch + t] = c_u[ci * NS + e];
    }
    __syncthreads();
    if (!live) continue;
    // every column without a branch, so that the compiler interleaves them;
    // past the last column the terms are an exact 0
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      const bool kv = k0 + lane + 32 * j < m;
      const int t = kv ? lane + 32 * j : 0;
      float xk[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e) xk[e] = s_x[e * kBwdBatch + t];
      const float ev = cov_e(an, s_c[t], un, xk, NS);
      const float ewc = kv ? ev * s_wc[t] : 0.f;
      float w = g_wr * ewc;
      if (ik_row && kv) w = fmaf(gcp * ikv[j], ev, w);
      s_w += w;
      s_ewc += ewc;
#pragma unroll
      for (int e = 0; e < NS; ++e) s_gu[e] = fmaf(w, xk[e], s_gu[e]);
    }
  }

  s_w = gpmpc_warp_sum(s_w);
  s_ewc = gpmpc_warp_sum(s_ewc);
#pragma unroll
  for (int e = 0; e < NS; ++e) s_gu[e] = gpmpc_warp_sum(s_gu[e]);
  if (live && lane == 0) {
    const size_t r = RECT ? (col_side ? (size_t)np * nr : 0) + ri : (size_t)s * n + row;
    ga[r] = s_w;
    gw[r] = gp * s_ewc;
#pragma unroll
    for (int e = 0; e < NS; ++e) gu[r * NS + e] = s_gu[e];
  }
}

// cov_bwd_kernel at each state width 1..GPMPC_MAX_NS, square [0] and rectangular [1]
using BwdKernel = decltype(&cov_bwd_kernel<1, false>);
const BwdKernel kBwdKernels[2][GPMPC_MAX_NS] = {
    {cov_bwd_kernel<1, false>, cov_bwd_kernel<2, false>, cov_bwd_kernel<3, false>, cov_bwd_kernel<4, false>,
     cov_bwd_kernel<5, false>, cov_bwd_kernel<6, false>, cov_bwd_kernel<7, false>, cov_bwd_kernel<8, false>},
    {cov_bwd_kernel<1, true>, cov_bwd_kernel<2, true>, cov_bwd_kernel<3, true>, cov_bwd_kernel<4, true>,
     cov_bwd_kernel<5, true>, cov_bwd_kernel<6, true>, cov_bwd_kernel<7, true>, cov_bwd_kernel<8, true>}};
static_assert(GPMPC_MAX_NS == 8, "one backward instantiation per state width");

// the backward's dynamic shared memory: a batch's column operands
size_t bwd_smem(int ns) { return (size_t)kBwdBatch * (2 + ns) * sizeof(float); }

constexpr int kGikThreads = 1024;  // most threads of a block (32 warps an SM to hide the latencies)

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// gK[m, n, k] = g_corr[m] E_p[n, k] for the diagonal pair p = diag_pos[m],
// on the grid the wrapper planned (moment_cov.gik_launch_plan): block (m, t)
// owns model m and the band of `rows` rows t; its thread (x, y) takes the
// band's rows y + blockDim.y i against the quads x + blockDim.x j of
// ceil(Nc / 4), quad q the columns 4 q .. 4 q + 3, so no index is found by
// an integer division (on an H100 a chain of them took a large share of the
// kernel's device time). Per item a thread loads what it needs itself: a
// and U of its row (one address for most of a warp), c and Xj of its 4
// columns as 1 + NS 16-byte loads where the pair's columns are 16-byte
// aligned and the quad is whole (scalar loads otherwise); then 4 E by
// cov_e (the f32 operations of the forward and the backward) and one
// 16-byte store (scalar stores where the item ends a ragged row or its row
// is not 16-byte aligned). No shared memory and no barrier: staging the
// operands in shared memory cost more instructions than it saved loads. A
// programmatic dependent:
// it waits for the launch before it (cov_bwd on CovCore.backward's path)
// before it reads anything, so its launch overlaps that kernel's tail.
template <int NS>
__global__ void __launch_bounds__(kGikThreads)
cov_gik_kernel(const float* __restrict__ g_corr, const float* __restrict__ a, const float* __restrict__ c,
               const float* __restrict__ u, const float* __restrict__ xj, const int* __restrict__ diag_pos,
               float* __restrict__ gk, int nr, int nc, int rows) {
  gpmpc_pdl::release_dependents();
  gpmpc_pdl::wait_for_prerequisite();
  const int m = blockIdx.x;
  const int n0 = blockIdx.y * rows;
  const int nrow = min(rows, nr - n0);
  const int quads = (nc + 3) / 4;
  const int p = diag_pos[m];
  const float g = g_corr[m];
  const size_t row0 = (size_t)p * nr, col0 = (size_t)p * nc;  // the pair's first row and first column
  const float* a_p = a + row0;
  const float* u_p = u + row0 * NS;
  const float* c_p = c + col0;
  const float* x_p = xj + col0 * NS;
  // the pair's c and Xj rows start 16-byte aligned: whole quads load as float4
  const bool vec = ((reinterpret_cast<uintptr_t>(c_p) | reinterpret_cast<uintptr_t>(x_p)) & 15) == 0;
  float* out_m = gk + (size_t)m * nr * nc;

  for (int r = threadIdx.y; r < nrow; r += blockDim.y)
  for (int jq = threadIdx.x; jq < quads; jq += blockDim.x) {
    const int k = 4 * jq, n = n0 + r;
    const float an = a_p[n];
    float un[NS], ck[4], xk[4][NS];
#pragma unroll
    for (int e = 0; e < NS; ++e) un[e] = u_p[(size_t)n * NS + e];
    if (vec && k + 4 <= nc) {
      const float4 c4 = *reinterpret_cast<const float4*>(c_p + k);
      float4 x4[NS];  // Xj of the 4 columns, [column][e] as in memory
#pragma unroll
      for (int q = 0; q < NS; ++q) x4[q] = reinterpret_cast<const float4*>(x_p + (size_t)k * NS)[q];
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        ck[col] = lane_of(c4, col);
#pragma unroll
        for (int e = 0; e < NS; ++e) xk[col][e] = lane_of(x4[(col * NS + e) / 4], (col * NS + e) % 4);
      }
    } else {
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        const bool kv = k + col < nc;
        ck[col] = kv ? c_p[k + col] : 0.f;
#pragma unroll
        for (int e = 0; e < NS; ++e) xk[col][e] = kv ? x_p[(size_t)(k + col) * NS + e] : 0.f;
      }
    }
    float v[4];
#pragma unroll
    for (int col = 0; col < 4; ++col) v[col] = g * cov_e(an, ck[col], un, xk[col], NS);
    float* o = out_m + (size_t)n * nc + k;
    if (k + 4 <= nc && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int col = 0; col < 4; ++col)
        if (k + col < nc) o[col] = v[col];
    }
  }
}

// cov_gik_kernel at each state width 1..GPMPC_MAX_NS
using GikKernel = decltype(&cov_gik_kernel<1>);
const GikKernel kGikKernels[GPMPC_MAX_NS] = {cov_gik_kernel<1>, cov_gik_kernel<2>, cov_gik_kernel<3>,
                                             cov_gik_kernel<4>, cov_gik_kernel<5>, cov_gik_kernel<6>,
                                             cov_gik_kernel<7>, cov_gik_kernel<8>};

// the forward's dynamic shared memory: a band's row operands
size_t fwd_smem(int rows, int ns) { return (size_t)rows * (2 + ns) * sizeof(float); }

}  // namespace

extern "C" {

int gpmpc_cov_fwd_f32(const float* a, const float* c, const float* u,
                      const float* xj, const float* bi, const float* bj,
                      const float* ik, const int* diag_pos, int n_diag,
                      float* part, float* out, int p, int nr, int nc,
                      int ns, int rows, int bands, void* stream) {
  if (p < 1 || nr < 1 || nc < 1 || ns < 1 || ns > GPMPC_MAX_NS || rows < 1 || rows > kFwdMaxRows ||
      bands != (nr + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = gpmpc_pdl::launch_dependent(cov_fwd_kernel, p * bands, fwd_block(nc), fwd_smem(rows, ns), s, a, c, u,
                                             xj, bi, bj, ik, diag_pos, n_diag, part, nr, nc, ns, rows);
  if (rc != 0) return rc;
  return gpmpc_pdl::launch_dependent(cov_fwd_sum_kernel, 1, kFwdSumThreads, 0, s, (const float*)part,
                                     diag_pos, n_diag, out, p, bands);
}

// #2's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (p, nr, ns, rows, bands), then rows, for the
// smoke's report: info[8]
int gpmpc_cov_fwd_info(int p, int nr, int ns, int rows, int bands, int* info) {
  if (rows < 1 || rows > kFwdMaxRows || ns < 1 || ns > GPMPC_MAX_NS) return (int)cudaErrorInvalidValue;
  const int threads = fwd_block(nr);  // square slabs: Nc = Nr
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, cov_fwd_kernel);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cov_fwd_kernel, threads, fwd_smem(rows, ns));
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[8] = {fa.numRegs, (int)fa.localSizeBytes, threads, per_sm, p * bands, sms,
                       (int)fwd_smem(rows, ns), rows};
  for (int k = 0; k < 8; ++k) info[k] = vals[k];
  return 0;
}

// both sides' backward on the grid the wrapper planned
// (moment_cov.bwd_launch_plan: row_blocks = ceil(max(Nr, Nc) / kBwdWarps)
// blocks of stacked rows per stacked pair); ga, gw [P Nr + P Nc] (the row
// side's [P][Nr], then the column side's [P][Nc]), gu the same with [ns]
int gpmpc_cov_bwd_f32(const float* g, const float* a, const float* c, const float* u, const float* xj,
                      const float* wr, const float* wc, const float* ik, const float* g_corr,
                      const int* diag_pos, int n_diag, float* ga, float* gu, float* gw, int p, int nr, int nc,
                      int ns, int row_blocks, void* stream) {
  const int n = nr > nc ? nr : nc;
  if (p < 1 || nr < 1 || nc < 1 || 2 * p > 65535 || ns < 1 || ns > GPMPC_MAX_NS ||
      row_blocks != (n + kBwdWarps - 1) / kBwdWarps)
    return (int)cudaErrorInvalidValue;
  return gpmpc_pdl::launch_dependent(kBwdKernels[nr != nc][ns - 1], dim3(row_blocks, 2 * p), 32 * kBwdWarps,
                                     bwd_smem(ns), (cudaStream_t)stream, g, a, c, u, xj, wr, wc, ik, g_corr, diag_pos,
                                     n_diag, ga, gu, gw, p, nr, nc);
}

// #3's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (p, n, ns), for the smoke's report: info[7]
int gpmpc_cov_bwd_info(int p, int n, int ns, int* info) {
  if (p < 1 || n < 1 || ns < 1 || ns > GPMPC_MAX_NS) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, kBwdKernels[0][ns - 1]);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kBwdKernels[0][ns - 1], 32 * kBwdWarps,
                                                          bwd_smem(ns));
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[7] = {fa.numRegs, (int)fa.localSizeBytes, 32 * kBwdWarps, per_sm,
                       2 * p * ((n + kBwdWarps - 1) / kBwdWarps), sms, (int)bwd_smem(ns)};
  for (int k = 0; k < 7; ++k) info[k] = vals[k];
  return 0;
}

// the iK gradient on the grid the wrapper planned (moment_cov.gik_launch_plan:
// n_diag bands of `rows` rows, blocks of tx x ty threads), a programmatic
// dependent of the launch before it
int gpmpc_cov_gik_f32(const float* g_corr, const float* a, const float* c, const float* u, const float* xj,
                      const int* diag_pos, int n_diag, float* gk, int nr, int nc, int ns, int rows, int tx, int ty,
                      void* stream) {
  if (n_diag < 1 || nr < 1 || nc < 1 || ns < 1 || ns > GPMPC_MAX_NS || rows < 1 || rows > nr || tx < 1 || ty < 1 ||
      tx * ty > kGikThreads)
    return (int)cudaErrorInvalidValue;
  const int bands = (nr + rows - 1) / rows;
  if (bands > 65535) return (int)cudaErrorInvalidValue;
  return gpmpc_pdl::launch_dependent(kGikKernels[ns - 1], dim3(n_diag, bands), dim3(tx, ty), 0, (cudaStream_t)stream,
                                     g_corr, a, c, u, xj, diag_pos, gk, nr, nc, rows);
}

// #4's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (n_diag, nr, ns, rows, tx, ty), then rows,
// for the smoke's report: info[8]
int gpmpc_cov_gik_info(int n_diag, int nr, int ns, int rows, int tx, int ty, int* info) {
  if (n_diag < 1 || nr < 1 || ns < 1 || ns > GPMPC_MAX_NS || rows < 1 || rows > nr || tx < 1 || ty < 1 ||
      tx * ty > kGikThreads)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, kGikKernels[ns - 1]);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kGikKernels[ns - 1], tx * ty, 0);
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[8] = {fa.numRegs, (int)fa.localSizeBytes, tx * ty, per_sm, n_diag * ((nr + rows - 1) / rows), sms, 0,
                       rows};
  for (int k = 0; k < 8; ++k) info[k] = vals[k];
  return 0;
}

}  // extern "C"

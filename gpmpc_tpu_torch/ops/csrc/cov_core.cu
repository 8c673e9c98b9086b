// Moment-matching covariance core, f32, forward and row-side backward.
//
// E[p, n, k] = exp(min(a[p, n] + c[p, k] + U[p, n, :] . Xj[p, k, :], 60))
// S_p[p]     = sum_{n,k} bi[p, n] E[p, n, k] bj[p, k]
// corr[m]    = sum_{n,k} iK[m, n, k] E[diag_pos[m], n, k]
//
// Replaces gpmpc_tpu/ops/pallas_moment_cov.py: _cov_fwd_kernel (forward),
// _bwd_row_kernel (row-side backward; the col side is the same kernel with the
// roles of (a, c), (U, Xj) and (bi, bj) swapped by the caller) and
// _gik_kernel (the gradient with respect to iK: gK[m] = g_corr[m] E of the
// diagonal pair diag_pos[m]). The iK model slab of a pair is found from
// diag_pos inside the kernel, as _ik_slot does.
//
// Layouts (all contiguous, row major): a, bi (P, Nr); c, bj (P, Nc);
// U (P, Nr, ns); Xj (P, Nc, ns); iK and gK (n_diag, Nr, Nc).
//
// The forward and the row backward read iK once (the only O(N^2) input) and
// compute E on the fly, never writing it. The iK gradient is the one kernel
// with an O(N^2) output: it is bound by writing gK (1.77 MB at the flagship),
// so each thread computes and stores one element at a time, a warp 32
// neighbouring columns of one row. Every kernel computes E by cov_e, the
// same f32 operations in the same order. The ns-contraction is ns scalar f32
// FMAs: no tensor cores, whose TF32 inputs would put a ~1e-3 error inside the
// exp. Each block writes its own partial, summed in a fixed order, so runs
// repeat bitwise.

#include <cuda_runtime.h>

// Largest state dimension Ns (the cov core's inner contraction length) the
// kernels keep in registers. The wrappers refuse larger Ns.
#define GPMPC_MAX_NS 8

namespace {

__device__ __forceinline__ float gpmpc_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block; the result is valid in thread 0 only. `red`
// holds one float per warp. The caller separates two calls with
// __syncthreads() so the second does not overwrite what the first reads.
__device__ __forceinline__ float gpmpc_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = gpmpc_warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? red[threadIdx.x] : 0.f;
  if (warp == 0) v = gpmpc_warp_sum(v);
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

constexpr int kFwdRows = 16;      // rows of E per forward block
constexpr int kFwdThreads = 256;  // threads stride the Nc columns
constexpr int kBwdWarps = 8;      // backward: one warp per row, 8 rows a block

__device__ __forceinline__ int ik_slot(int p, const int* diag_pos, int n_diag) {
  for (int m = 0; m < n_diag; ++m)
    if (diag_pos[m] == p) return m;
  return -1;
}

// grid (P, ceil(Nr / kFwdRows)), block kFwdThreads. Writes one partial of
// S_p and of corr per block into (P, gridDim.y) scratch; the caller sums them.
__global__ void __launch_bounds__(kFwdThreads)
cov_fwd_kernel(const float* __restrict__ a, const float* __restrict__ c,
               const float* __restrict__ u, const float* __restrict__ xj,
               const float* __restrict__ bi, const float* __restrict__ bj,
               const float* __restrict__ ik, const int* __restrict__ diag_pos,
               int n_diag, float* __restrict__ sp_part,
               float* __restrict__ co_part, int nr, int nc, int ns) {
  const int p = blockIdx.x;
  const int tile = blockIdx.y;
  const int n0 = tile * kFwdRows;
  const int rows = min(kFwdRows, nr - n0);

  __shared__ float s_a[kFwdRows];
  __shared__ float s_bi[kFwdRows];
  __shared__ float s_u[kFwdRows * GPMPC_MAX_NS];
  __shared__ float red[32];

  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    s_a[t] = a[(size_t)p * nr + n0 + t];
    s_bi[t] = bi[(size_t)p * nr + n0 + t];
  }
  for (int t = threadIdx.x; t < rows * ns; t += blockDim.x)
    s_u[t] = u[((size_t)p * nr + n0) * ns + t];
  __syncthreads();

  const int slot = ik_slot(p, diag_pos, n_diag);
  const float* ik_rows = slot >= 0 ? ik + ((size_t)slot * nr + n0) * nc : nullptr;

  float acc_s = 0.f;
  float acc_c = 0.f;
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    const float ck = c[(size_t)p * nc + k];
    float xk[GPMPC_MAX_NS];
#pragma unroll
    for (int e = 0; e < GPMPC_MAX_NS; ++e)
      xk[e] = e < ns ? xj[((size_t)p * nc + k) * ns + e] : 0.f;
    float col = 0.f;  // sum_n bi[n] E[n, k] over this block's rows
    for (int r = 0; r < rows; ++r) {
      const float ev = cov_e(s_a[r], ck, s_u + r * ns, xk, ns);
      col = fmaf(s_bi[r], ev, col);
      if (ik_rows) acc_c = fmaf(ik_rows[(size_t)r * nc + k], ev, acc_c);
    }
    acc_s = fmaf(col, bj[(size_t)p * nc + k], acc_s);
  }

  const float tot_s = gpmpc_block_sum(acc_s, red);
  __syncthreads();
  const float tot_c = gpmpc_block_sum(acc_c, red);
  if (threadIdx.x == 0) {
    sp_part[(size_t)p * gridDim.y + tile] = tot_s;
    co_part[(size_t)p * gridDim.y + tile] = slot >= 0 ? tot_c : 0.f;
  }
}

// grid (P, ceil(Nr / kBwdWarps)), block 32 * kBwdWarps. With
// W[n, k] = g[p] wr[n] wc[k] E[n, k] + gco[p] iK_slot[n, k] E[n, k]
// (gco is read only on diagonal pairs), writes for each row n:
// ga[n] = sum_k W, gU[n, :] = sum_k W Xj[k, :], gwr[n] = g[p] sum_k E wc[k].
__global__ void __launch_bounds__(32 * kBwdWarps)
cov_bwd_row_kernel(const float* __restrict__ g, const float* __restrict__ a,
                   const float* __restrict__ c, const float* __restrict__ u,
                   const float* __restrict__ xj, const float* __restrict__ wr,
                   const float* __restrict__ wc, const float* __restrict__ ik,
                   const float* __restrict__ gco, const int* __restrict__ diag_pos,
                   int n_diag, float* __restrict__ ga, float* __restrict__ gu,
                   float* __restrict__ gwr, int nr, int nc, int ns) {
  const int p = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.y * kBwdWarps + warp;
  if (n >= nr) return;  // the whole warp leaves; no block-wide sync follows

  const int slot = ik_slot(p, diag_pos, n_diag);
  const float gp = g[p];
  const float gcp = slot >= 0 ? gco[p] : 0.f;
  const float* ik_row = slot >= 0 ? ik + ((size_t)slot * nr + n) * nc : nullptr;
  const float an = a[(size_t)p * nr + n];
  const float g_wr = gp * wr[(size_t)p * nr + n];
  float un[GPMPC_MAX_NS];
  float s_gu[GPMPC_MAX_NS];
#pragma unroll
  for (int e = 0; e < GPMPC_MAX_NS; ++e) {
    un[e] = e < ns ? u[((size_t)p * nr + n) * ns + e] : 0.f;
    s_gu[e] = 0.f;
  }

  float s_w = 0.f;
  float s_ewc = 0.f;
  for (int k = lane; k < nc; k += 32) {
    float xk[GPMPC_MAX_NS];
#pragma unroll
    for (int e = 0; e < GPMPC_MAX_NS; ++e) xk[e] = e < ns ? xj[((size_t)p * nc + k) * ns + e] : 0.f;
    const float ev = cov_e(an, c[(size_t)p * nc + k], un, xk, ns);
    const float ewc = ev * wc[(size_t)p * nc + k];
    float w = g_wr * ewc;
    if (ik_row) w = fmaf(gcp * ik_row[k], ev, w);
    s_w += w;
    s_ewc += ewc;
#pragma unroll
    for (int e = 0; e < GPMPC_MAX_NS; ++e)
      if (e < ns) s_gu[e] = fmaf(w, xk[e], s_gu[e]);
  }

  s_w = gpmpc_warp_sum(s_w);
  s_ewc = gpmpc_warp_sum(s_ewc);
#pragma unroll
  for (int e = 0; e < GPMPC_MAX_NS; ++e) s_gu[e] = gpmpc_warp_sum(s_gu[e]);
  if (lane == 0) {
    ga[(size_t)p * nr + n] = s_w;
    gwr[(size_t)p * nr + n] = gp * s_ewc;
#pragma unroll
    for (int e = 0; e < GPMPC_MAX_NS; ++e)
      if (e < ns) gu[((size_t)p * nr + n) * ns + e] = s_gu[e];
  }
}

constexpr int kGikThreads = 128;  // iK gradient: threads stride the Nc columns of one row

// grid (n_diag, Nr), block kGikThreads: gK[m, n, k] = g_corr[m] E_p[n, k] for
// the diagonal pair p = diag_pos[m].
__global__ void __launch_bounds__(kGikThreads)
cov_gik_kernel(const float* __restrict__ g_corr, const float* __restrict__ a,
               const float* __restrict__ c, const float* __restrict__ u,
               const float* __restrict__ xj, const int* __restrict__ diag_pos,
               float* __restrict__ gk, int nr, int nc, int ns) {
  const int m = blockIdx.x;
  const int n = blockIdx.y;
  const int p = diag_pos[m];
  const float g = g_corr[m];
  const float an = a[(size_t)p * nr + n];
  float un[GPMPC_MAX_NS];
#pragma unroll
  for (int e = 0; e < GPMPC_MAX_NS; ++e) un[e] = e < ns ? u[((size_t)p * nr + n) * ns + e] : 0.f;
  float* out = gk + ((size_t)m * nr + n) * nc;
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    float xk[GPMPC_MAX_NS];
#pragma unroll
    for (int e = 0; e < GPMPC_MAX_NS; ++e) xk[e] = e < ns ? xj[((size_t)p * nc + k) * ns + e] : 0.f;
    out[k] = g * cov_e(an, c[(size_t)p * nc + k], un, xk, ns);
  }
}

}  // namespace

extern "C" {

// Rows of E per forward block: the wrapper sizes the partials with it.
int gpmpc_cov_fwd_rows() { return kFwdRows; }

int gpmpc_cov_fwd_f32(const float* a, const float* c, const float* u,
                      const float* xj, const float* bi, const float* bj,
                      const float* ik, const int* diag_pos, int n_diag,
                      float* sp_part, float* co_part, int p, int nr, int nc,
                      int ns, void* stream) {
  if (p < 1 || nr < 1 || nc < 1 || ns < 1 || ns > GPMPC_MAX_NS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p, (nr + kFwdRows - 1) / kFwdRows);
  cov_fwd_kernel<<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
      a, c, u, xj, bi, bj, ik, diag_pos, n_diag, sp_part, co_part, nr, nc, ns);
  return (int)cudaGetLastError();
}

int gpmpc_cov_bwd_row_f32(const float* g, const float* a, const float* c,
                          const float* u, const float* xj, const float* wr,
                          const float* wc, const float* ik, const float* gco,
                          const int* diag_pos, int n_diag, float* ga, float* gu,
                          float* gwr, int p, int nr, int nc, int ns,
                          void* stream) {
  if (p < 1 || nr < 1 || nc < 1 || ns < 1 || ns > GPMPC_MAX_NS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p, (nr + kBwdWarps - 1) / kBwdWarps);
  cov_bwd_row_kernel<<<grid, 32 * kBwdWarps, 0, (cudaStream_t)stream>>>(
      g, a, c, u, xj, wr, wc, ik, gco, diag_pos, n_diag, ga, gu, gwr, nr, nc, ns);
  return (int)cudaGetLastError();
}

int gpmpc_cov_gik_f32(const float* g_corr, const float* a, const float* c,
                      const float* u, const float* xj, const int* diag_pos,
                      int n_diag, float* gk, int nr, int nc, int ns, void* stream) {
  if (n_diag < 1 || nr < 1 || nc < 1 || ns < 1 || ns > GPMPC_MAX_NS || nr > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_diag, nr);
  cov_gik_kernel<<<grid, kGikThreads, 0, (cudaStream_t)stream>>>(
      g_corr, a, c, u, xj, diag_pos, gk, nr, nc, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Batched ARD-RBF Gram matrix, f32.
//
// K[m, i, j] = s[m] * exp(-0.5 * max(|xi|^2 + |xj|^2 - 2 xi.xj, 0)),
// xi = x[i, :] / ls[m, :]
//
// Replaces gpmpc_tpu/ops/pallas_gram.py: gram_ard_rbf_pallas. The same
// squared-norm expansion and max(., 0) clamp as gp.gram_ard_rbf, so both
// packages round alike.
//
// What bounds it on an H100: it writes Ns N^2 floats (1.77 MB at the
// flagship's 3 x 384 x 384, 0.53 us at 3.35 TB/s) and reads a few KB; a
// launch that does nothing already costs more device time than that write,
// so its launch and its own latency bound it in practice. The first design
// (one thread an entry in 16 x 16 blocks) divided x by ls twice per
// feature of every entry. Here block (m, t) of the grid owns model m and
// the band of `rows` rows t against all columns (ops/gram_rbf.py
// launch_plan: every band in one wave of one block per SM where they fit,
// blocks of up to 1,024 threads, so that each SM has up to 32 warps to hide
// its latencies). It stages the scaled points x / ls[m] of a chunk of
// 4 quads columns and of its rows in shared memory, kGramQ features at a
// time, a thread a point, so a block divides each point once. Thread (x, y)
// of its quads x rows threads takes row y against the 4 columns of quad x
// of each chunk, keeps its sums in registers across the feature stages, and
// writes them with one 16-byte store (scalar stores where the item ends a
// ragged row or its row is not 16-byte aligned). No index is found by an
// integer division, and a 0 dividend (the padding points) does not take
// the division's slow path: on an H100 each of those took a large share of
// the kernel's device time. It launches as a programmatic dependent,
// which takes ~1.0 us off a launch even after a plain PyTorch kernel, as
// precedes it on the refresh path (gpmpc_tpu_torch/trace_kernels.py), and it
// reads nothing before the kernel before it has ended.
// The batch axis (the seeds of an episode batch, each its own memory and
// parameters): grid z is the element, whose operands and K lie after the
// element before's; the plan is one memory's, so each element is its
// single launch bit for bit.
// Every entry is the first design's f32 operations in their order: the
// rounded quotients, the fmaf chains over the features in order, sq_i +
// sq_j - 2 cross, max(., 0), s * expf(-0.5 d2); so the bits are the same.

#include <cstdint>

#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kGramThreads = 1024;  // most threads of a block: a thread an item of each column chunk
constexpr int kGramQ = 4;           // features staged at a time
constexpr int kGramMaxQuads = 512;  // 4-column groups of a chunk (2,048 columns)

// dynamic shared memory: kGramQ features of a chunk's columns and of the band's rows
size_t gram_smem(int rows, int quads) { return (size_t)kGramQ * (4 * quads + rows) * sizeof(float); }

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const float* __restrict__ ls, const float* __restrict__ s, const float* __restrict__ x,
            float* __restrict__ out, int n, int d, int rows, int quads) {
  gpmpc_pdl::release_dependents();
  gpmpc_pdl::wait_for_prerequisite();  // a programmatic dependent of the kernel before it
  extern __shared__ float4 gram_smem4[];
  const int cw = 4 * quads;                             // columns of a chunk
  float* s_col = reinterpret_cast<float*>(gram_smem4);  // [kGramQ][cw] scaled column points
  float* s_row = s_col + kGramQ * cw;                   // [kGramQ][rows] scaled row points
  const int m = blockIdx.x;
  const int i0 = blockIdx.y * rows;
  const size_t elem = blockIdx.z;  // this block's batch element
  ls += elem * gridDim.x * d;
  s += elem * gridDim.x;
  x += elem * n * d;
  out += elem * gridDim.x * n * n;
  const int nrow = min(rows, n - i0);
  // this thread's item of every chunk: row threadIdx.y, quad threadIdx.x
  const int r = threadIdx.y, jq = threadIdx.x;
  const bool live = r < nrow;
  const int tid = r * quads + jq;
  const float* lsm = ls + (size_t)m * d;
  const float sm = s[m];
  float* out_m = out + (size_t)m * n * n;

  for (int c0 = 0; c0 < n; c0 += cw) {
    float sq_i = 0.f, sq_j[4] = {0.f, 0.f, 0.f, 0.f}, cross[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < d; q0 += kGramQ) {
      const int nq = min(kGramQ, d - q0);
      float lq[kGramQ];
      bool lfin[kGramQ];  // lq finite and not 0: there 0 / lq is 0 * lq, sign and all
#pragma unroll
      for (int q = 0; q < kGramQ; ++q) {
        lq[q] = q < nq ? lsm[q0 + q] : 1.f;
        lfin[q] = isfinite(lq[q]) && lq[q] != 0.f;
      }
      __syncthreads();  // every thread is done with the stage before
      // the stage: thread t takes point t of the chunk's columns, then of the
      // band's rows, and its features q0 .. q0 + nq (its loads go out
      // together, then their quotients are stored)
      for (int t = tid; t < cw + nrow; t += quads * rows) {
        const int point = t < cw ? c0 + t : i0 + t - cw;
        float v[kGramQ];
#pragma unroll
        for (int q = 0; q < kGramQ; ++q) v[q] = q < nq && point < n ? x[(size_t)point * d + q0 + q] : 0.f;
#pragma unroll
        for (int q = 0; q < kGramQ; ++q) {
          if (q < nq) {
            // a 0 dividend sends the division down its slow path (the
            // padding points are 0): its quotient is 0 * lq, bit for bit;
            // the empty asm keeps the compiler from dividing v[q] anyway
            const bool zero = v[q] == 0.f && lfin[q];
            float num = zero ? 1.f : v[q];
            asm("" : "+f"(num));
            const float quot = num / lq[q];
            const float xs = zero ? v[q] * lq[q] : quot;
            if (t < cw)
              s_col[q * cw + t] = xs;
            else
              s_row[q * rows + t - cw] = xs;
          }
        }
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int q = 0; q < kGramQ; ++q) {
          if (q < nq) {
            const float xi = s_row[q * rows + r];
            const float4 xj = reinterpret_cast<const float4*>(s_col + q * cw)[jq];
            sq_i = fmaf(xi, xi, sq_i);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float v = lane_of(xj, c);
              sq_j[c] = fmaf(v, v, sq_j[c]);
              cross[c] = fmaf(xi, v, cross[c]);
            }
          }
        }
      }
    }
    if (live) {
      const int j = c0 + 4 * jq;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float d2 = fmaxf(sq_i + sq_j[c] - 2.f * cross[c], 0.f);
        v[c] = sm * expf(-0.5f * d2);
      }
      float* o = out_m + (size_t)(i0 + r) * n + j;
      if (j + 4 <= n && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < n) o[c] = v[c];
      }
    }
  }
}

// the plan's (rows, quads) at n: what the kernel takes
bool gram_plan_ok(int n, int rows, int quads) {
  return rows >= 1 && rows <= n && quads >= 1 && quads <= kGramMaxQuads && rows * quads <= kGramThreads;
}

}  // namespace

extern "C" {

// K (batch, ns, n, n) on the grid the wrapper planned for one memory
// (gram_rbf.launch_plan): ns bands of `rows` rows, column chunks of 4 quads
// columns, per batch element (ls (batch, ns, d), s (batch, ns), x (batch, n,
// d)); a programmatic dependent of the launch before it
int gpmpc_gram_f32(const float* ls, const float* s, const float* x, float* out, int ns, int n, int d, int rows,
                   int quads, int batch, void* stream) {
  if (ns < 1 || n < 1 || d < 1 || !gram_plan_ok(n, rows, quads)) return (int)cudaErrorInvalidValue;
  const int bands = (n + rows - 1) / rows;
  if (bands > 65535 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  return gpmpc_pdl::launch_dependent(gram_kernel, dim3(ns, bands, batch), dim3(quads, rows), gram_smem(rows, quads),
                                     (cudaStream_t)stream, ls, s, x, out, n, d, rows, quads);
}

// #1's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (ns, n, rows, quads), then rows and quads,
// for the smoke's report: info[9]
int gpmpc_gram_info(int ns, int n, int rows, int quads, int* info) {
  if (ns < 1 || n < 1 || !gram_plan_ok(n, rows, quads)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, gram_kernel);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_kernel, quads * rows, gram_smem(rows, quads));
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[9] = {fa.numRegs, (int)fa.localSizeBytes, quads * rows, per_sm, ns * ((n + rows - 1) / rows), sms,
                       (int)gram_smem(rows, quads), rows, quads};
  for (int k = 0; k < 9; ++k) info[k] = vals[k];
  return 0;
}

}  // extern "C"

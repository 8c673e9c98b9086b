// Batched ARD-RBF Gram matrix, f32.
//
// K[m, i, j] = s[m] * exp(-0.5 * max(|xi|^2 + |xj|^2 - 2 xi.xj, 0)),
// xi = x[i, :] / ls[m, :]
//
// Replaces gpmpc_tpu/ops/pallas_gram.py: gram_ard_rbf_pallas. The same
// squared-norm expansion and max(., 0) clamp as gp.gram_ard_rbf, so both
// packages round alike. One thread per output entry; grid
// (ceil(N/16), ceil(N/16), Ns) of 16x16 blocks, the ragged edge masked.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

__global__ void gram_kernel(const float* __restrict__ ls, const float* __restrict__ s,
                            const float* __restrict__ x, float* __restrict__ out,
                            int n, int d) {
  const int m = blockIdx.z;
  const int i = blockIdx.y * kTile + threadIdx.y;
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (i >= n || j >= n) return;
  float sq_i = 0.f, sq_j = 0.f, cross = 0.f;
  for (int q = 0; q < d; ++q) {
    const float l = ls[m * d + q];
    const float xi = x[(size_t)i * d + q] / l;
    const float xj = x[(size_t)j * d + q] / l;
    sq_i = fmaf(xi, xi, sq_i);
    sq_j = fmaf(xj, xj, sq_j);
    cross = fmaf(xi, xj, cross);
  }
  const float d2 = fmaxf(sq_i + sq_j - 2.f * cross, 0.f);
  out[((size_t)m * n + i) * n + j] = s[m] * expf(-0.5f * d2);
}

}  // namespace

extern "C" int gpmpc_gram_f32(const float* ls, const float* s, const float* x,
                              float* out, int ns, int n, int d, void* stream) {
  if (ns < 1 || n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kTile);
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile, ns);
  gram_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(ls, s, x, out, n, d);
  return (int)cudaGetLastError();
}

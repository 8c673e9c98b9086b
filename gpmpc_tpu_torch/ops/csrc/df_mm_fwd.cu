// Whole-step double-float32 moment matching: one launch for the N-scaling
// work of a mixed-mode rollout step (plus a one-block launch that sums the
// blocks' partials in a fixed order and finishes).
//
// Replaces gpmpc_tpu/ops/pallas_df_mm.py:
//   df_mm_fwd_kernel<NS, true> + df_mm_fwd_sum_kernel<NS, true>
//       -> _build_full.fwd_kernel (#12): stage 1, the mean path, every pair
//          and the finish (wrapper df_mm_full)
//   df_mm_fwd_kernel<NS, false> + df_mm_fwd_sum_kernel<NS, false>
//       -> _build.fwd_kernel (#8): the raw df partials (wrapper df_mm_fwd)
//   df_mm_bwd_kernel + df_mm_bwd_sum_kernel (df_mm_bwd.cu)
//       -> _build.bwd_all_kernel (#9) (wrapper df_mm_bwd), and its split for
//          N > 128, #10 and #11 (df_mm_bwd.cu)
// The shared device code is in df_mm.cuh; the two files compile in parallel.
// The math and the operation order of every element are those of the plain
// twins in gpmpc_tpu_torch/ops/df_mm.py (see its docstring).
//
// Design. The TPU kernels run the whole step in one grid cell over (N,) and
// (N, N) vectors in VMEM. Here blocks run in no order: the grid is one block
// per 32 x 32 tile of each pair's (N, N) slab plus one block per 32 stored
// points for the mean path. A pair block computes its 32 rows' (a, U, bi)
// and 32 columns' (c, Xj, bj) into shared memory (in #12 after its pair's
// stage 1, computed by one thread from sv), then 8 warps walk 4 rows each,
// a lane per column; E never leaves registers. Per-block df partials go to
// scratch and the second launch sums them sequentially in df, so runs repeat
// bitwise. The ragged edge (N not a multiple of 32) is masked,
// so no padding is needed.
//
// #9 writes out the VJP (the TPU kernel runs jax.vjp in its body). A pair
// block forms G = E (gs bi bj + gco iK) in df per element and its row sums
// (over its 32 columns; G and G Xj) and column sums (G and G U); the second
// launch sums those over the tiles and applies the chain rule through a, c,
// U and Xj to inp = x - mu and Q per point, with df cotangents and the
// collapsed f32 values of the forward quantities as coefficients (the
// reference's derivative rules), and sums over N in df. The mean blocks
// write their points' VJP contributions (to mu and B^-1) directly.
//
// Bound: arithmetic. Every E element is ~780 f32 add/multiply/logic
// instructions (df_exp's 12 Horner steps) and none may fuse into an FMA;
// the whole step at N = 128 is ~80 M of them against ~1 MB of operands (the
// df iK slab). The ns-contraction inside the exponent is elementwise df
// math, never a tensor-core product.

#include <cuda_runtime.h>

#include "df_mm.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward (#12 with FULL, #8 without)
// ---------------------------------------------------------------------------

// grid: P * nt * nt pair tiles (b = (p * nt + rt) * nt + ct), then nt mean tiles.
// pair_part [2][P nt nt][2] (S_p, corr); mean_part [2][NS][1 + d][nt] (M, V_e);
// scale [NS + P] (c_m, then sqrt det R_p; FULL only)
template <int NS, bool FULL>
__global__ void __launch_bounds__(kThreads)
df_mm_fwd_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ sv,
                 const float* __restrict__ outs, const float* __restrict__ bh, const float* __restrict__ bl,
                 const float* __restrict__ qh, const float* __restrict__ ql, float* __restrict__ pair_part,
                 float* __restrict__ mean_part, float* __restrict__ scale) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  const int npb = P * nt * nt;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ df s_q[NS * NS];
  __shared__ df s_b[NS][NS * NS];
  __shared__ TileOperands<NS> s;
  __shared__ df red[2][kWarps];

  if (blockIdx.x < npb) {
    const int b = blockIdx.x;
    const int ct = b % nt, rt = (b / nt) % nt, p = b / (nt * nt);
    int i, j;
    pair_ij(p, NS, i, j);
    if (FULL) {
      if (t == 0) {
        df q[NS * NS];
        float sdr;
        stage1_pair<NS>(c, sv, i, j, q, sdr);
#pragma unroll
        for (int k = 0; k < NS * NS; ++k) s_q[k] = q[k];
        if (rt == 0 && ct == 0) scale[NS + p] = sdr;
      }
    } else if (t < NS * NS) {
      s_q[t] = ld(qh, ql, (size_t)p * NS * NS + t);
    }
    __syncthreads();
    load_tile<NS>(c, mu, s_q, i, j, rt, ct, s);
    __syncthreads();

    const int k = ct * kTile + lane;
    df sp = {0.f, 0.f}, co = {0.f, 0.f};
    if (k < c.n) {
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int rr = warp + kWarps * r;
        const int n = rt * kTile + rr;
        if (n >= c.n) break;  // warp-uniform
        const df e = e_capped_exp(e_exponent<NS>(s.a[rr], s.u[rr], s.c[lane], s.xj[lane]));
        sp = df_add(sp, df_mul(df_mul(e, s.bi[rr]), s.bj[lane]));
        if (i == j) co = df_add(co, df_mul(e, ld(c.ikh, c.ikl, ((size_t)i * c.n + n) * c.n + k)));
      }
    }
    sp = warp_df_sum(sp);
    co = warp_df_sum(co);
    if (lane == 0) {
      red[0][warp] = sp;
      red[1][warp] = co;
    }
    __syncthreads();
    if (t < 2) st(pair_part, (size_t)npb * 2, (size_t)b * 2 + t, tree8(red[t]));
    return;
  }

  // mean tile: warp m < NS takes model m, a lane per stored point
  const int rt = blockIdx.x - npb;
  if (FULL) {
    if (t < NS) {
      df b[NS * NS];
      float cm;
      stage1_model<NS>(c, sv, outs, t, b, cm);
#pragma unroll
      for (int k = 0; k < NS * NS; ++k) s_b[t][k] = b[k];
      if (rt == 0) scale[t] = cm;
    }
  } else if (t < NS * NS * NS) {
    s_b[t / (NS * NS)][t % (NS * NS)] = ld(bh, bl, t);
  }
  __syncthreads();
  if (warp >= NS) return;
  const int m = warp, n = rt * kTile + lane;
  df lb = {0.f, 0.f}, v[kMaxD];
  MeanPoint<NS> mp;
  if (n < c.n) {
    mean_point<NS>(c, mu, s_b[m], m, n, mp);
    lb = mp.lb;
  }
  const size_t plane = (size_t)NS * (1 + c.d) * nt;
  lb = warp_df_sum(lb);
  if (lane == 0) st(mean_part, plane, ((size_t)m * (1 + c.d)) * nt + rt, lb);
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    if (e >= c.d) break;
    v[e] = n < c.n ? df_mul(df_mul(mp.t[e], ld(c.ilsh, c.ilsl, (size_t)m * c.d + e)), mp.lb) : df{0.f, 0.f};
    v[e] = warp_df_sum(v[e]);
    if (lane == 0) st(mean_part, plane, ((size_t)m * (1 + c.d) + 1 + e) * nt + rt, v[e]);
  }
}

// One block. Raw outputs o: M (NS), V (NS d), S_p (P), corr (NS), each the
// sequential df sum of its partials. Without FULL, out [2][n_out] (hi, lo);
// with FULL, the finish: out = [c M, c V, (S_p (-) corr) / sqrt det R].
template <int NS, bool FULL>
__global__ void __launch_bounds__(kThreads)
df_mm_fwd_sum_kernel(const float* __restrict__ pair_part, const float* __restrict__ mean_part,
                     const float* __restrict__ scale, float* __restrict__ out, int n, int d) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (n + kTile - 1) / kTile;
  const int tiles = nt * nt;
  const int n_out = NS + NS * d + P + NS;
  const size_t mplane = (size_t)NS * (1 + d) * nt, pplane = (size_t)P * tiles * 2;
  __shared__ df raw[kMaxNs + kMaxNs * kMaxD + kMaxP + kMaxNs];
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    df acc = {0.f, 0.f};
    if (o < NS + NS * d) {
      const int m = o < NS ? o : (o - NS) / d;
      const int v = o < NS ? 0 : 1 + (o - NS) % d;
      for (int rt = 0; rt < nt; ++rt)
        acc = df_add(acc, ld(mean_part, mean_part + mplane, ((size_t)m * (1 + d) + v) * nt + rt));
    } else {
      const bool sp = o < NS + NS * d + P;
      const int p = sp ? o - NS - NS * d : diag_pair(o - NS - NS * d - P, NS);
      for (int b = 0; b < tiles; ++b)
        acc = df_add(acc, ld(pair_part, pair_part + pplane, ((size_t)p * tiles + b) * 2 + (sp ? 0 : 1)));
    }
    if (FULL) {
      raw[o] = acc;
    } else {
      out[o] = acc.h;
      out[n_out + o] = acc.l;
    }
  }
  if (!FULL) return;
  __syncthreads();
  for (int o = threadIdx.x; o < NS + NS * d + P; o += blockDim.x) {
    if (o < NS + NS * d) {
      const int m = o < NS ? o : (o - NS) / d;
      out[o] = __fmul_rn(scale[m], df_collapse(raw[o]));
    } else {
      const int p = o - NS - NS * d;
      int i, j;
      pair_ij(p, NS, i, j);
      df s = raw[o];
      if (i == j) s = df_add(s, df_neg(raw[NS + NS * d + P + i]));
      out[o] = __fdiv_rn(df_collapse(s), scale[NS + p]);
    }
  }
}

template <int NS, bool FULL>
int launch_fwd(const Cache& c, const float* mu, const float* sv, const float* outs, const float* bh,
               const float* bl, const float* qh, const float* ql, float* pair_part, float* mean_part,
               float* scale, float* out, cudaStream_t stream) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  df_mm_fwd_kernel<NS, FULL><<<P * nt * nt + nt, kThreads, 0, stream>>>(c, mu, sv, outs, bh, bl, qh, ql,
                                                                       pair_part, mean_part, scale);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  df_mm_fwd_sum_kernel<NS, FULL><<<1, kThreads, 0, stream>>>(pair_part, mean_part, scale, out, c.n, c.d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the tile extent: the wrappers size the partial buffers with it
int gpmpc_df_mm_tile() { return kTile; }

int gpmpc_df_mm_full_f32(const float* mu, const float* sv, GPMPC_DF_MM_CACHE_ARGS, const float* outs,
                         float* pair_part, float* mean_part, float* scale, float* out, int n, int ns, int d,
                         void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_fwd<1, true>(c, mu, sv, outs, nullptr, nullptr, nullptr, nullptr, pair_part, mean_part, scale, out, s);
    case 2: return launch_fwd<2, true>(c, mu, sv, outs, nullptr, nullptr, nullptr, nullptr, pair_part, mean_part, scale, out, s);
    default: return launch_fwd<3, true>(c, mu, sv, outs, nullptr, nullptr, nullptr, nullptr, pair_part, mean_part, scale, out, s);
  }
}

int gpmpc_df_mm_fwd_f32(const float* mu, const float* bh, const float* bl, const float* qh, const float* ql,
                        GPMPC_DF_MM_CACHE_ARGS, float* pair_part, float* mean_part, float* out, int n, int ns,
                        int d, void* stream) {
  if (!valid(n, ns, d)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_fwd<1, false>(c, mu, nullptr, nullptr, bh, bl, qh, ql, pair_part, mean_part, nullptr, out, s);
    case 2: return launch_fwd<2, false>(c, mu, nullptr, nullptr, bh, bl, qh, ql, pair_part, mean_part, nullptr, out, s);
    default: return launch_fwd<3, false>(c, mu, nullptr, nullptr, bh, bl, qh, ql, pair_part, mean_part, nullptr, out, s);
  }
}

}  // extern "C"

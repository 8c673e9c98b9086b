// Whole-step double-float32 moment matching: one launch for the N-scaling
// work of a mixed-mode rollout step, and a programmatic dependent launch that
// sums the blocks' partials in a fixed order and finishes.
//
// Replaces gpmpc_tpu/ops/pallas_df_mm.py:
//   df_mm_fwd_kernel<NS, true, *> + df_mm_fwd_sum_kernel<NS, true, *>
//       -> _build_full.fwd_kernel (#12): stage 1, the mean path, every pair
//          and the finish (wrapper df_mm_full)
//   df_mm_fwd_kernel<NS, false, *> + df_mm_fwd_sum_kernel<NS, false, *>
//       -> _build.fwd_kernel (#8): the raw df partials (wrapper df_mm_fwd)
//   df_mm_bwd_kernel + df_mm_bwd_sum_kernel (df_mm_bwd.cu)
//       -> _build.bwd_all_kernel (#9) (wrapper df_mm_bwd), and its split for
//          N > 128, #10 and #11 (df_mm_bwd.cu)
// The shared device code is in df_mm.cuh; the two files compile in parallel.
// The math and the operation order of every element are those of the plain
// twins in gpmpc_tpu_torch/ops/df_mm.py (see its docstring).
//
// The TPU kernels run the whole step in one grid cell over (N,) and (N, N)
// vectors in VMEM. Here blocks run in no order, and at the planning step's
// sizes (N = 32-128) the time is a few long dependent chains, not
// throughput: stage 1 (a df Ns x Ns Cholesky, its inverse and Q: a chain of
// IEEE divisions and square roots, each a dependent df step), then one E element per
// lane (~780 f32 instructions, df_exp's 12 Horner steps), then the sums; an
// idle launch alone costs ~2 us of the device timeline. A first design
// walked 32 x 32 tiles with 8 warps, 4 rows per warp one after the other,
// behind stage 1 run by one thread (its whole unrolled solve, ~10 us) while
// 255 waited, and summed in a cold one-block second launch: 0.027 ms at
// N = 128, the same at N = 32.
//
// Design. A pair block owns a tile of 8 rpw rows by 32 columns of one pair's
// (N, N) slab: warp w its rows w + 8 s (s < rpw), a lane a column, so each
// lane walks rpw E elements. rpw (1..4) comes with the launch
// (df_mm.fwd_launch_plan): the least waves of kBlocksPerSm resident blocks
// per SM times rpw, so at the planning step rpw = 1, one E per lane, and the
// grid is about one wave of 24 warps per SM. In #12 warp kStage1Warp of a
// pair block runs its pair's stage 1, the independent entries of each step
// on separate lanes (df_mm.cuh: stage1_pair_warp), while the tile's row and
// column threads compute the Q-independent part of their operands
// (model_point); then qform, and the walk, whose iK load goes out ahead of
// E. A mean block owns 32 stored points: in #12 warp m < NS runs model m's
// stage 1, then a lane per point, the 1 + d sums side by side. Per-block
// sums (lanes by warp_df_sum, warps by tree8) go to scratch; the summing
// launch, a programmatic dependent released when this launch starts, adds
// each output's partials over the lanes of one warp (a lane its partials in
// order, then warp_df_sum) and finishes, so every run repeats bitwise. The
// ragged edge (N not a multiple of the tile) is masked, so no padding is
// needed. #8 is the same launch with B^-1 and Q read, not computed.
//
// #9 writes out the VJP (the TPU kernel runs jax.vjp in its body); see
// df_mm_bwd.cu.
//
// Bound: arithmetic. Every E element is ~780 f32 add/multiply/logic
// instructions and none may fuse into an FMA; the whole step at N = 128 is
// ~80 M of them against ~1 MB of operands (the df iK slab). The
// ns-contraction inside the exponent is elementwise df math, never a
// tensor-core product.

#include <cuda_runtime.h>

#include "df_mm.cuh"
#include "pdl.cuh"

namespace {

// resident blocks per SM the forward is built for: its register cap
constexpr int kBlocksPerSm = 3;
// the warp that runs a pair block's stage 1 (whose first threads load its
// Q in #8): past the tile's operand threads (at most 2 kTile)
constexpr int kStage1Warp = 2 * kTile / 32;
// the summing launch: one warp per output group, in a loop
constexpr int kFwdSumThreads = 1024;

static_assert(kStage1Warp < kWarps && kMaxNs * kMaxNs <= 32, "stage 1 and the Q loads fit one warp of the block");

// ---------------------------------------------------------------------------
// forward (#12 with FULL, #8 without)
// ---------------------------------------------------------------------------

// grid: P rtiles ctiles pair blocks (b = (p rtiles + rt) ctiles + ct), then
// mtiles = ceil(N / 32) mean blocks; rtiles = ceil(N / (kWarps rpw)),
// ctiles = ceil(N / kTile); with BATCHED, grid row y is the batch element
// (df_mm.cuh cache_of), whose operands, partials and scale follow the
// element before's. One element with its one cache launches the instance
// without BATCHED, which holds every pointer where the launch put it (as
// kernel parameters, not registers): the batch costs that launch nothing.
// pair_part [2][P rtiles ctiles][2] (S_p, corr); mean_part [2][NS][1 + d][mtiles];
// scale [NS + P] (c_m, then sqrt det R_p; FULL only)
template <int NS, bool FULL, bool BATCHED>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
df_mm_fwd_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ sv,
                 const float* __restrict__ outs, const float* __restrict__ bh, const float* __restrict__ bl,
                 const float* __restrict__ qh, const float* __restrict__ ql, float* __restrict__ pair_part,
                 float* __restrict__ mean_part, float* __restrict__ scale, int rpw, const int* __restrict__ cidx) {
  constexpr int P = NS * (NS + 1) / 2;
  gpmpc_pdl::release_dependents();  // the summing launch waits for this one to end
  gpmpc_pdl::wait_for_prerequisite();  // this launch is a programmatic dependent of the kernel before it
  const int rows = kWarps * rpw;
  const int rtiles = (c.n + rows - 1) / rows, ctiles = (c.n + kTile - 1) / kTile;
  const int npb = P * rtiles * ctiles;
  if constexpr (BATCHED) {  // this block's batch element
    const int elem = blockIdx.y;
    if (FULL) outs += (size_t)cache_index(cidx, elem) * NS;
    c = cache_of<NS>(c, cidx, elem);
    mu += (size_t)elem * c.d;
    if (FULL) {
      sv += (size_t)elem * NS * NS;
      scale += (size_t)elem * (NS + P);
    } else {
      bh += (size_t)elem * NS * NS * NS;
      bl += (size_t)elem * NS * NS * NS;
      qh += (size_t)elem * P * NS * NS;
      ql += (size_t)elem * P * NS * NS;
    }
    pair_part += (size_t)elem * 4 * npb;
    mean_part += (size_t)elem * 2 * NS * (1 + c.d) * ctiles;
  }
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ df s_q[NS * NS];
  __shared__ df s_b[NS][NS * NS];
  __shared__ TileOperands<NS> s;
  __shared__ df red[2][kWarps];
  __shared__ Stage1Scratch<NS> s_s1[FULL ? NS : 1];

  if (blockIdx.x < npb) {
    const int b = blockIdx.x;
    const int ct = b % ctiles, rt = (b / ctiles) % rtiles, p = b / (rtiles * ctiles);
    int i, j;
    pair_ij(p, NS, i, j);
    if (FULL) {
      if (warp == kStage1Warp) {
        const float sdr = stage1_pair_warp<NS>(c, sv, i, j, s_q, s_s1[0]);
        if (lane == 0 && rt == 0 && ct == 0) scale[NS + p] = sdr;
      }
    } else if (warp == kStage1Warp && lane < NS * NS) {
      s_q[lane] = ld(qh, ql, (size_t)p * NS * NS + lane);
    }
    // the tile's operands: threads < rows its rows (model i), the next kTile
    // its columns (model j); the Q-independent part while stage 1 runs
    const bool row = t < rows;
    const int slot = row ? t : t - rows;
    const int idx = (row ? rt * rows : ct * kTile) + slot;
    const bool prep = t < rows + kTile && idx < c.n;
    const int m = row ? i : j;
    ModelPoint<NS> mp;
    df beta = {0.f, 0.f};
    if (prep) {
      model_point<NS>(c, mu, m, idx, mp);
      beta = ld(c.beth, c.betl, (size_t)m * c.n + idx);
    }
    // the walk's first iK entry, loaded while stage 1 runs
    const int k = ct * kTile + lane, n0 = rt * rows + warp;
    const df ik0 = i == j && k < c.n && n0 < c.n ? ld(c.ikh, c.ikl, ((size_t)i * c.n + n0) * c.n + k) : df{0.f, 0.f};
    __syncthreads();
    if (prep) {
      df xq[NS];
      const df ab = df_add(mp.klog, qform<NS>(mp.xi, s_q, xq));
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
    __syncthreads();

    df sp = {0.f, 0.f}, co = {0.f, 0.f};
    if (k < c.n) {
      for (int r = 0; r < rpw; ++r) {
        const int rr = warp + kWarps * r;
        const int n = rt * rows + rr;
        if (n >= c.n) break;  // warp-uniform
        // the iK entry's load goes out before E's long chain
        const df ikv = r == 0 ? ik0 : i == j ? ld(c.ikh, c.ikl, ((size_t)i * c.n + n) * c.n + k) : df{0.f, 0.f};
        const df e = e_capped_exp(e_exponent<NS>(s.a[rr], s.u[rr], s.c[lane], s.xj[lane]));
        sp = df_add(sp, df_mul(df_mul(e, s.bi[rr]), s.bj[lane]));
        if (i == j) co = df_add(co, df_mul(e, ikv));
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
  const int mtiles = (c.n + kTile - 1) / kTile;
  if (FULL) {
    if (warp < NS) {
      const float cm = stage1_model_warp<NS>(c, sv, outs, warp, s_s1[warp]);
      if (lane < NS * NS) s_b[warp][lane] = s_s1[warp].inv[lane];
      if (lane == 0 && rt == 0) scale[warp] = cm;
    }
  } else if (t < NS * NS * NS) {
    s_b[t / (NS * NS)][t % (NS * NS)] = ld(bh, bl, t);
  }
  __syncthreads();
  if (warp >= NS) return;
  const int m = warp, n = rt * kTile + lane;
  df v[1 + kMaxD];  // lb, then V's terms
  MeanPoint<NS> mpt;
  if (n < c.n) mean_point<NS>(c, mu, s_b[m], m, n, mpt);
  v[0] = n < c.n ? mpt.lb : df{0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kMaxD; ++e)
    v[1 + e] = n < c.n && e < c.d ? df_mul(df_mul(mpt.t[e], ld(c.ilsh, c.ilsl, (size_t)m * c.d + e)), mpt.lb)
                                  : df{0.f, 0.f};
  // the 1 + d warp sums side by side, each in warp_df_sum's order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int e = 0; e < 1 + kMaxD; ++e)
      if (e <= c.d) v[e] = df_add(v[e], shfl_down(v[e], off));  // warp-uniform
  const size_t plane = (size_t)NS * (1 + c.d) * mtiles;
  if (lane == 0)
    for (int e = 0; e <= c.d; ++e) st(mean_part, plane, ((size_t)m * (1 + c.d) + e) * mtiles + rt, v[e]);
}

// df sums of src[i] and, with TWO, src[i + 1] over the count entries i of
// stride stride (planes hi at src, lo at src + plane) by one warp: lane l
// adds its entries l, l + 32, ... in order, then the warp_df_sum tree, the
// two sums side by side; valid in lane 0
template <bool TWO>
__device__ __forceinline__ void warp_sum_parts(const float* src, size_t plane, int count, int stride, df& a, df& b) {
  a = {0.f, 0.f};
  b = {0.f, 0.f};
  for (int i = threadIdx.x & 31; i < count; i += 32) {
    a = df_add(a, ld(src, src + plane, (size_t)i * stride));
    if (TWO) b = df_add(b, ld(src, src + plane, (size_t)i * stride + 1));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = df_add(a, shfl_down(a, off));
    if (TWO) b = df_add(b, shfl_down(b, off));
  }
}

// One block of kFwdSumThreads per batch element (blockIdx.x; with BATCHED),
// a programmatic dependent of the forward.
// Output groups: pair p < P (its S_p and, on a diagonal pair (i, i), corr_i),
// then (model m, value v) for v = 0 (M_m) and 1 + e (V_m[e]); warp w takes
// groups w, w + 32, .... Without FULL, out [2][n_out] (hi, lo) with the raw
// outputs M (NS), V (NS d), S_p (P), corr (NS); with FULL, the finish:
// out = [c M, c V, (S_p (-) corr) / sqrt det R].
template <int NS, bool FULL, bool BATCHED>
__global__ void __launch_bounds__(kFwdSumThreads)
df_mm_fwd_sum_kernel(const float* __restrict__ pair_part, const float* __restrict__ mean_part,
                     const float* __restrict__ scale, float* __restrict__ out, int n, int d, int tiles) {
  constexpr int P = NS * (NS + 1) / 2;
  gpmpc_pdl::release_dependents();  // a programmatic dependent launch after this one may start
  gpmpc_pdl::wait_for_prerequisite();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mtiles = (n + kTile - 1) / kTile;
  const int n_out = NS + NS * d + P + NS;
  const size_t pplane = (size_t)P * tiles * 2, mplane = (size_t)NS * (1 + d) * mtiles;
  if constexpr (BATCHED) {
    const int elem = blockIdx.x;
    pair_part += (size_t)elem * 2 * pplane;
    mean_part += (size_t)elem * 2 * mplane;
    if (FULL) scale += (size_t)elem * (NS + P);
    out += (size_t)elem * (FULL ? NS + NS * d + P : 2 * n_out);
  }
  for (int g = warp; g < P + NS * (1 + d); g += kFwdSumThreads / 32) {
    if (g < P) {
      int i, j;
      pair_ij(g, NS, i, j);
      const float sdr = FULL ? scale[NS + g] : 0.f;
      const float* src = pair_part + (size_t)g * tiles * 2;
      df sp, co;
      if (i == j)  // warp-uniform
        warp_sum_parts<true>(src, pplane, tiles, 2, sp, co);
      else
        warp_sum_parts<false>(src, pplane, tiles, 2, sp, co);
      if (lane != 0) continue;
      if (FULL) {
        const df s = i == j ? df_add(sp, df_neg(co)) : sp;
        out[NS + NS * d + g] = __fdiv_rn(df_collapse(s), sdr);
      } else {
        out[NS + NS * d + g] = sp.h;
        out[n_out + NS + NS * d + g] = sp.l;
        if (i == j) {
          out[NS + NS * d + P + i] = co.h;
          out[n_out + NS + NS * d + P + i] = co.l;
        }
      }
    } else {
      const int m = (g - P) / (1 + d), v = (g - P) % (1 + d);
      const float cm = FULL ? scale[m] : 0.f;
      df acc, unused;
      warp_sum_parts<false>(mean_part + ((size_t)m * (1 + d) + v) * mtiles, mplane, mtiles, 1, acc, unused);
      if (lane != 0) continue;
      const int o = v == 0 ? m : NS + m * d + v - 1;  // M_m, or V_m[v - 1]
      if (FULL) {
        out[o] = __fmul_rn(cm, df_collapse(acc));
      } else {
        out[o] = acc.h;
        out[n_out + o] = acc.l;
      }
    }
  }
}

template <int NS>
int fwd_grid(int n, int rpw) {
  constexpr int P = NS * (NS + 1) / 2;
  const int rows = kWarps * rpw;
  return P * ((n + rows - 1) / rows) * ((n + kTile - 1) / kTile) + (n + kTile - 1) / kTile;
}

// the grid of one element is the B = 1 launch's (the plan does not see the
// batch, so an element sums in the same order at every B); batch rows of it
template <int NS, bool FULL, bool BATCHED>
int launch_fwd_as(const Cache& c, const float* mu, const float* sv, const float* outs, const float* bh,
                  const float* bl, const float* qh, const float* ql, float* pair_part, float* mean_part,
                  float* scale, float* out, int rpw, const int* cidx, int batch, cudaStream_t stream) {
  const int rc = gpmpc_pdl::launch_dependent(df_mm_fwd_kernel<NS, FULL, BATCHED>,
                                             dim3(fwd_grid<NS>(c.n, rpw), batch), kThreads, 0, stream, c, mu, sv,
                                             outs, bh, bl, qh, ql, pair_part, mean_part, scale, rpw, cidx);
  if (rc != 0) return rc;
  const int rows = kWarps * rpw;
  const int tiles = ((c.n + rows - 1) / rows) * ((c.n + kTile - 1) / kTile);
  return gpmpc_pdl::launch_dependent(df_mm_fwd_sum_kernel<NS, FULL, BATCHED>, batch, kFwdSumThreads, 0, stream,
                                     (const float*)pair_part, (const float*)mean_part, (const float*)scale, out,
                                     c.n, c.d, tiles);
}

template <int NS, bool FULL>
int launch_fwd(const Cache& c, const float* mu, const float* sv, const float* outs, const float* bh,
               const float* bl, const float* qh, const float* ql, float* pair_part, float* mean_part,
               float* scale, float* out, int rpw, const int* cidx, int batch, cudaStream_t stream) {
  if (batch == 1 && cidx == nullptr)
    return launch_fwd_as<NS, FULL, false>(c, mu, sv, outs, bh, bl, qh, ql, pair_part, mean_part, scale, out, rpw,
                                          cidx, batch, stream);
  return launch_fwd_as<NS, FULL, true>(c, mu, sv, outs, bh, bl, qh, ql, pair_part, mean_part, scale, out, rpw,
                                       cidx, batch, stream);
}

// #12's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory (none) at (n, rpw), then rpw, for the smoke's report
template <int NS>
int full_info(int n, int rpw, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_fwd_kernel<NS, true, false>);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_fwd_kernel<NS, true, false>, kThreads, 0);
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[8] = {a.numRegs, (int)a.localSizeBytes, kThreads, per_sm, fwd_grid<NS>(n, rpw), sms, 0, rpw};
  for (int k = 0; k < 8; ++k) info[k] = vals[k];
  return 0;
}

// a pair tile has at most kTile rows, kRowsPerWarp per warp (TileOperands)
bool valid_rpw(int rpw) { return rpw >= 1 && rpw <= kRowsPerWarp; }

}  // namespace

extern "C" {

// the tile extent: the wrappers size the partial buffers with it
int gpmpc_df_mm_tile() { return kTile; }

// batch elements, each its mu (d) and sv (ns, ns) and its partials, scale
// and out after the element before's; cidx (batch) the cache of each, or
// null for one shared cache
int gpmpc_df_mm_full_f32(const float* mu, const float* sv, GPMPC_DF_MM_CACHE_ARGS, const float* outs,
                         float* pair_part, float* mean_part, float* scale, float* out, int n, int ns, int d,
                         int rpw, const int* cidx, int batch, void* stream) {
  if (!valid(n, ns, d) || !valid_rpw(rpw) || !valid_batch(batch)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_fwd<1, true>(c, mu, sv, outs, nullptr, nullptr, nullptr, nullptr, pair_part, mean_part, scale, out, rpw, cidx, batch, s);
    case 2: return launch_fwd<2, true>(c, mu, sv, outs, nullptr, nullptr, nullptr, nullptr, pair_part, mean_part, scale, out, rpw, cidx, batch, s);
    default: return launch_fwd<3, true>(c, mu, sv, outs, nullptr, nullptr, nullptr, nullptr, pair_part, mean_part, scale, out, rpw, cidx, batch, s);
  }
}

// batched as gpmpc_df_mm_full_f32, each element its mu, B^-1 and Q halves
int gpmpc_df_mm_fwd_f32(const float* mu, const float* bh, const float* bl, const float* qh, const float* ql,
                        GPMPC_DF_MM_CACHE_ARGS, float* pair_part, float* mean_part, float* out, int n, int ns,
                        int d, int rpw, const int* cidx, int batch, void* stream) {
  if (!valid(n, ns, d) || !valid_rpw(rpw) || !valid_batch(batch)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_fwd<1, false>(c, mu, nullptr, nullptr, bh, bl, qh, ql, pair_part, mean_part, nullptr, out, rpw, cidx, batch, s);
    case 2: return launch_fwd<2, false>(c, mu, nullptr, nullptr, bh, bl, qh, ql, pair_part, mean_part, nullptr, out, rpw, cidx, batch, s);
    default: return launch_fwd<3, false>(c, mu, nullptr, nullptr, bh, bl, qh, ql, pair_part, mean_part, nullptr, out, rpw, cidx, batch, s);
  }
}

// #12's launch report (full_info): info[8]
int gpmpc_df_mm_full_info(int n, int ns, int rpw, int* info) {
  if (!valid_rpw(rpw)) return (int)cudaErrorInvalidValue;
  switch (ns) {
    case 1: return full_info<1>(n, rpw, info);
    case 2: return full_info<2>(n, rpw, info);
    default: return full_info<3>(n, rpw, info);
  }
}

}  // extern "C"

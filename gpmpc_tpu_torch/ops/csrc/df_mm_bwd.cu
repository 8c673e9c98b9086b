// The whole-step VJP (#9). See df_mm_fwd.cu for the forward, df_mm_split.cu
// for its split past N = 128 (#10 and #11), df_mm_bwd.cuh for the device
// code the two share and df_mm.cuh for that of all whole-step kernels.
// Replaces gpmpc_tpu/ops/pallas_df_mm.py:
//   df_mm_bwd_kernel + df_mm_bwd_sum_kernel
//       -> _build.bwd_all_kernel (#9): the VJP of stages 2-3 (wrapper df_mm_bwd)
// The reference runs #9 when N <= 128 and #10 and one #11 launch per pair
// otherwise. #9, #10 and #11 share mean_item (the mean path over 32 points)
// and the chain rule at one point, so they compute the same df cotangents.
// Every cotangent stays df until the outputs.
//
// #9 on stacked rows. Its work is the pairs' exponent cotangent G = E (gs bi
// bj (+) gco iK) at every element of the P (N, N) slabs, its row sums (G, G
// Xj_e) and column sums (G, G U_e), then a per-point chain rule to inp and
// Q. Each element costs ~1,000 f32 instructions (E's df exp alone ~600),
// none of which may fuse into an FMA: the kernel is bound by instructions.
// At N = 128, 100 points in the planning step, a first design of 32 x 32
// tiles filled 100 of the 132 SMs with 8 warps each and wrote per-tile row
// and column partials, which a one-block second launch summed per point,
// applied the chain rule to and summed again: 0.038 of its 0.060 ms ran on
// one SM. Here a unit (one side of one pair, 32 points) belongs to a
// cluster of two 512-thread blocks; each block computes the other side's N
// operands into shared memory, and each of its 16 warps owns one point (one
// stacked row) and walks all N: the row side's G and G Xj_e sums, or the
// column side's G and G U_e sums, end inside the warp. The warps write
// their sums into rank 0's shared memory (distributed shared memory, no
// global partials), where warp 0 applies the chain rule, a lane per point,
// and the warps sum the unit's contributions. E is computed once per side,
// so the arithmetic doubles; in exchange the grid fills 2 P nt clusters
// with 16 warps per SM, and the second launch only adds the units' and the
// mean blocks' sums per output in a fixed order.
//
// Summation order, the same as #11's: the row side adds each 32-column tile
// by warp_df_sum and the tiles in order; the column side adds each 32-row
// tile as #11's pair block does (rows m, m + 8, m + 16, m + 24 in order for
// each m < 8, then tree8) and the tiles in order; a unit adds its 32 points
// by warp_df_sum. So #9 and the split route compute the same unit sums, g_B
// and g_Q; g_mu adds the same df terms in another order (#9 the units, then
// the mean path; the split route the mean path, then per pair), which the
// collapse to f32 hid on every operand set measured (bit for bit at N =
// 192, 384 and 512, trace_split_bwd.py).
//
// The batch axis (a plan's restarts, an episode batch's seeds): with
// BATCHED, grid row y is a batch element (the summing launch a block per
// element), reading cache cidx[b] (df_mm.cuh cache_of) and its operands,
// cotangents, partials and outputs after the element before's; one element
// with its one cache launches the instance without.

#include "df_mm_bwd.cuh"

namespace {

__device__ __forceinline__ df shfl_idx(df v, int src) {
  return {__shfl_sync(0xffffffffu, v.h, src), __shfl_sync(0xffffffffu, v.l, src)};
}

__device__ __forceinline__ df pick4(int k, df x0, df x1, df x2, df x3) {
  return k == 0 ? x0 : k == 1 ? x1 : k == 2 ? x2 : x3;
}

// #9's mean block rt: warp m < NS takes model m
template <int NS>
__device__ void bwd_mean_tile(const Cache& c, const float* __restrict__ mu, const float* __restrict__ bh,
                              const float* __restrict__ bl, Cot ct, float* __restrict__ mean_part, int rt) {
  const int t = threadIdx.x, warp = t >> 5;
  __shared__ df s_b[NS][NS * NS];
  if (t < NS * NS * NS) s_b[t / (NS * NS)][t % (NS * NS)] = ld(bh, bl, t);
  __syncthreads();
  if (warp < NS) mean_item<NS>(c, mu, s_b[warp], ct, mean_part, warp, rt);
}

// The chain rule at one point of a unit of side `side` (0: the rows, whose a
// = klog + xs and U = 2 Xq; 1: the columns, whose c = klog + xs and Xj = Xi)
// from its residuals res (G and the G Xj_e or G U_e sums): its contributions
// to the cotangents of inp (d) and of Q_p (NS NS), in df.
template <int NS>
__device__ void point_chain_rule(int side, const df* res, const PointTerms<NS>& pt, const df* q, int d,
                                 df* acc_mu, df (*acc_q)[NS]) {
  df g_xq[NS], g_xi[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e)
    g_xq[e] = side == 0 ? df_add(df_scale(res[1 + e], 2.f), df_mul_f32(res[0], pt.xi_c[e]))
                        : df_mul_f32(res[0], pt.xi_c[e]);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    df a = df_mul_f32(res[0], pt.xq_c[k]);
    if (side == 1) a = df_add(a, res[1 + k]);
#pragma unroll
    for (int e = 0; e < NS; ++e) a = df_add(a, df_mul_f32(g_xq[e], df_collapse(q[k * NS + e])));
    g_xi[k] = a;
  }
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int e = 0; e < NS; ++e) acc_q[k][e] = df_mul_f32(g_xq[e], pt.xi_c[k]);
#pragma unroll
  for (int e = 0; e < kMaxD; ++e) {
    if (e >= d) break;
    df g = df_mul_f32(df_mul_f32(res[0], -pt.iN_c[e]), pt.ils_c[e]);
    if (e < NS) g = df_add(g, df_mul_f32(g_xi[e], pt.ils2_c[e]));
    acc_mu[e] = g;
  }
}

// ---------------------------------------------------------------------------
// #9: stacked rows. A unit u = (side P + p) nt + chunk is the 32 points of
// one side of pair p; a cluster of kUnitBlocks blocks owns it, each block
// kUnitPoints of its points, a warp one point (a stacked row) against all N
// points of the other side.
// ---------------------------------------------------------------------------

constexpr int kUnitBlocks = 2;
constexpr int kUnitPoints = kTile / kUnitBlocks;
constexpr int kUnitWarps = 16;
constexpr int kUnitThreads = 32 * kUnitWarps;
// the other side's points in dynamic shared memory: N <= 5,000 at ns = 3
constexpr size_t kMaxUnitDynSmem = 200 * 1024;

static_assert(kUnitPoints % kUnitWarps == 0, "each warp owns the same number of points");

// a unit's own points (all 32, in every block of its cluster): the operands
// of the walk and what the chain rule needs; res is filled through the
// cluster's shared memory, and only rank 0's copy is read
template <int NS>
struct UnitShared {
  df q[NS * NS];
  df ab[kTile], v[kTile][NS], b[kTile];
  PointTerms<NS> terms[kTile];
  df res[kTile][1 + NS];
  df acc[kTile][kMaxD + NS * NS];
};

// dynamic shared memory of a unit block: the other side's N points, ab (N),
// b (N) and v (N NS), df
template <int NS>
size_t unit_dyn_smem(int n) {
  return (size_t)n * (2 + NS) * sizeof(df);
}

// The same for the column side, in the order of #11's pair block: for each
// m < 8, (((0 + x_m) + x_{m+8}) + x_{m+16}) + x_{m+24}, then tree8 over m.
// Lanes 8 v .. 8 v + 7 sum value v; value v ends in lane 8 v.
__device__ __forceinline__ df cols_tile_sum(const df* x) {
  const int lane = threadIdx.x & 31, m = lane & 7, v = lane >> 3;
  df t = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int src = m + 8 * r;
    t = df_add(t, pick4(v, shfl_idx(x[0], src), shfl_idx(x[1], src), shfl_idx(x[2], src), shfl_idx(x[3], src)));
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) t = df_add(t, shfl_xor(t, off));
  return t;
}

// One stacked row: own point (a, U, bi) of the row side or (c, Xj, bj) of
// the column side, against the N points of the other side. The row side
// sums each 32-column tile as warp_df_sum would (rows_tile_sum); the column
// side sums each 32-row tile in the order of #11's pair block
// (cols_tile_sum); both add the tile sums in tile order. The result: value
// v (G, then its NS weighted sums) in lane 8 v.
template <int NS, int SIDE>
__device__ df unit_row(const Cache& c, int i, float gs, float gco, int own, df own_ab, const df* own_v, df own_b,
                       const df* o_ab, const df* o_b, const df* o_v) {
  static_assert(NS <= 3, "four values per tile sum");
  const int nt = (c.n + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  df res = {0.f, 0.f};
  for (int tt = 0; tt < nt; ++tt) {
    const int k = tt * kTile + lane;  // the other side's point of this lane
    df g[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (k < c.n) {
      df ov[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e) ov[e] = o_v[k * NS + e];
      const int row = SIDE == 0 ? own : k, col = SIDE == 0 ? k : own;
      const df ex = SIDE == 0 ? e_exponent<NS>(own_ab, own_v, o_ab[k], ov)
                              : e_exponent<NS>(o_ab[k], ov, own_ab, own_v);
      df w = df_mul_f32(SIDE == 0 ? df_mul(own_b, o_b[k]) : df_mul(o_b[k], own_b), gs);
      if (i >= 0) w = df_add(w, df_mul_f32(ld(c.ikh, c.ikl, ((size_t)i * c.n + row) * c.n + col), gco));
      g[0] = ex.h < 60.f ? df_mul(e_capped_exp(ex), w) : df{0.f, 0.f};
#pragma unroll
      for (int e = 0; e < NS; ++e) g[1 + e] = df_mul_f32(g[0], df_collapse(ov[e]));
    }
    res = df_add(res, SIDE == 0 ? rows_tile_sum(g) : cols_tile_sum(g));
  }
  return res;
}

// a block of #9's unit u (one of the kUnitBlocks of its cluster); the chain
// rule and the unit's sums run in rank 0 of the cluster
template <int NS>
__device__ void bwd_unit(const Cache& c, const float* __restrict__ mu, const float* __restrict__ qh,
                         const float* __restrict__ ql, Cot ct, float* __restrict__ unit_part,
                         int u, UnitShared<NS>& s, df* dyn) {
  namespace cg = cooperative_groups;
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  const int d = c.d;
  const int nt = (c.n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int side = u / (P * nt), p = (u / nt) % P, chunk = u % nt;
  int i, j;
  pair_ij(p, NS, i, j);
  const int m_own = side == 0 ? i : j, m_oth = side == 0 ? j : i;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  df* o_ab = dyn;
  df* o_b = dyn + c.n;
  df* o_v = dyn + 2 * c.n;
  if (t < NS * NS) s.q[t] = ld(qh, ql, (size_t)p * NS * NS + t);
  __syncthreads();

  // the unit's 32 points (threads 0..31) and the other side's N points: a or
  // c = klog + xs, U = 2 Xq (rows) or Xj = Xi (columns), beta, as #11's
  // load_tile computes them
  if (t < kTile) {
    const int n = chunk * kTile + t;
    if (n < c.n) {
      ModelPoint<NS> mp;
      model_point<NS>(c, mu, m_own, n, mp);
      df xq[NS];
      s.ab[t] = df_add(mp.klog, qform<NS>(mp.xi, s.q, xq));
      s.b[t] = ld(c.beth, c.betl, (size_t)m_own * c.n + n);
#pragma unroll
      for (int e = 0; e < NS; ++e) s.v[t][e] = side == 0 ? df_scale(xq[e], 2.f) : mp.xi[e];
      if (rank == 0) point_terms<NS>(c, m_own, mp, xq, s.terms[t]);
    }
  } else {
    for (int k = t - kTile; k < c.n; k += kUnitThreads - kTile) {
      ModelPoint<NS> mp;
      model_point<NS>(c, mu, m_oth, k, mp);
      df xq[NS];
      o_ab[k] = df_add(mp.klog, qform<NS>(mp.xi, s.q, xq));
      o_b[k] = ld(c.beth, c.betl, (size_t)m_oth * c.n + k);
#pragma unroll
      for (int e = 0; e < NS; ++e) o_v[k * NS + e] = side == 0 ? mp.xi[e] : df_scale(xq[e], 2.f);
    }
  }
  // the cluster barrier also makes sure that both blocks have started before
  // either writes into rank 0's shared memory
  cluster.sync();

  // the walk: a warp per point of this block
  UnitShared<NS>* s0 = cluster.map_shared_rank(&s, 0);
  const float gs = ct.sp[p];
  const float gco = i == j ? ct.corr[i] : 0.f;
  const int ik_model = i == j ? i : -1;
  for (int pl = (int)rank * kUnitPoints + warp; pl < ((int)rank + 1) * kUnitPoints; pl += kUnitWarps) {
    const int own = chunk * kTile + pl;
    if (own >= c.n) break;  // warp-uniform
    const df res = side == 0
                       ? unit_row<NS, 0>(c, ik_model, gs, gco, own, s.ab[pl], s.v[pl], s.b[pl], o_ab, o_b, o_v)
                       : unit_row<NS, 1>(c, ik_model, gs, gco, own, s.ab[pl], s.v[pl], s.b[pl], o_ab, o_b, o_v);
    if ((lane & 7) == 0 && (lane >> 3) < NR) s0->res[pl][lane >> 3] = res;
  }
  cluster.sync();
  if (rank != 0) return;

  // the chain rule, a lane per point, then the unit's sums over its points
  // by warp_df_sum, one output per warp
  if (warp == 0) {
    const int n = chunk * kTile + lane;
    df acc_mu[kMaxD], acc_q[NS][NS];
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) acc_mu[e] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int e = 0; e < NS; ++e) acc_q[k][e] = {0.f, 0.f};
    if (n < c.n) point_chain_rule<NS>(side, s.res[lane], s.terms[lane], s.q, d, acc_mu, acc_q);
#pragma unroll
    for (int e = 0; e < kMaxD; ++e)
      if (e < d) s.acc[lane][e] = acc_mu[e];
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int e = 0; e < NS; ++e) s.acc[lane][d + k * NS + e] = acc_q[k][e];
  }
  __syncthreads();
  const size_t uplane = (size_t)2 * P * nt * nv;
  for (int o = warp; o < nv; o += kUnitWarps) {
    const df tot = warp_df_sum(s.acc[lane][o]);
    if (lane == 0) st(unit_part, uplane, (size_t)u * nv + o, tot);
  }
}

// #9: kUnitBlocks blocks (a cluster) per unit, then nt mean blocks (padded
// to whole clusters; a padding block returns at once); with BATCHED, grid
// row y is the batch element (df_mm.cuh cache_of), whose operands,
// cotangents and partials follow the element before's (one element with
// its one cache launches the instance without, as #12 does)
template <int NS, bool BATCHED>
__global__ void __cluster_dims__(kUnitBlocks, 1, 1) __launch_bounds__(kUnitThreads, 1)
df_mm_bwd_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                 const float* __restrict__ bl, const float* __restrict__ qh, const float* __restrict__ ql,
                 Cot ct, float* __restrict__ mean_part, float* __restrict__ unit_part,
                 const int* __restrict__ cidx) {
  constexpr int P = NS * (NS + 1) / 2;
  gpmpc_pdl::release_dependents();
  __shared__ UnitShared<NS> s;
  extern __shared__ df dyn[];
  const int nt = (c.n + kTile - 1) / kTile;
  const int nub = kUnitBlocks * 2 * P * nt;
  if constexpr (BATCHED) {  // this block's batch element
    const int elem = blockIdx.y;
    const size_t nv = c.d + NS * NS;
    c = cache_of<NS>(c, cidx, elem);
    mu += (size_t)elem * c.d;
    bh += (size_t)elem * NS * NS * NS;
    bl += (size_t)elem * NS * NS * NS;
    qh += (size_t)elem * P * NS * NS;
    ql += (size_t)elem * P * NS * NS;
    ct = cot_at(ct, NS, c.d, elem);
    mean_part += (size_t)elem * 2 * NS * nt * nv;
    unit_part += (size_t)elem * 2 * 2 * P * nt * nv;
  }
  if ((int)blockIdx.x < nub)
    bwd_unit<NS>(c, mu, qh, ql, ct, unit_part, blockIdx.x / kUnitBlocks, s, dyn);
  else if ((int)blockIdx.x - nub < nt)
    bwd_mean_tile<NS>(c, mu, bh, bl, ct, mean_part, blockIdx.x - nub);
}

// #9's second launch, one block per batch element (blockIdx.x; with
// BATCHED), a programmatic dependent of the first: each
// output a sequential df sum in a fixed order: g_mu = -(units + mean path),
// g_B = mean path, g_Q = units of its pair. The partials are first copied
// into shared memory (all threads, coalesced) when they fit (smem_floats),
// so that each sum's chain waits on no global load. out: g_mu (d), g_B
// (NS^3), g_Q (P NS^2), f32.
template <int NS, bool BATCHED>
__global__ void __launch_bounds__(kSumThreads)
df_mm_bwd_sum_kernel(int n, int d, const float* __restrict__ mean_part, const float* __restrict__ unit_part,
                     float* __restrict__ out, int smem_floats) {
  constexpr int P = NS * (NS + 1) / 2;
  extern __shared__ float sm[];
  gpmpc_pdl::wait_for_prerequisite();
  const int nt = (n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int units = 2 * P * nt;
  const size_t uplane = (size_t)units * nv;
  const size_t mplane = (size_t)NS * nt * nv;
  if constexpr (BATCHED) {
    const int elem = blockIdx.x;
    unit_part += (size_t)elem * 2 * uplane;
    mean_part += (size_t)elem * 2 * mplane;
    out += (size_t)elem * (d + NS * NS * NS + P * NS * NS);
  }
  const float* up = unit_part;
  const float* mp = mean_part;
  if ((size_t)smem_floats >= 2 * (uplane + mplane)) {
    for (size_t k = threadIdx.x; k < 2 * uplane; k += blockDim.x) sm[k] = unit_part[k];
    for (size_t k = threadIdx.x; k < 2 * mplane; k += blockDim.x) sm[2 * uplane + k] = mean_part[k];
    __syncthreads();
    up = sm;
    mp = sm + 2 * uplane;
  }
  const int n_out = d + NS * NS * NS + P * NS * NS;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    df acc = {0.f, 0.f};
    if (o < d) {
      for (int uu = 0; uu < units; ++uu) acc = df_add(acc, ld(up, up + uplane, (size_t)uu * nv + o));
      for (int mm = 0; mm < NS; ++mm)
        for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + o));
      out[o] = -df_collapse(acc);
    } else if (o < d + NS * NS * NS) {
      const int mm = (o - d) / (NS * NS), kj = (o - d) % (NS * NS);
      for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + d + kj));
      out[o] = df_collapse(acc);
    } else {
      const int p = (o - d - NS * NS * NS) / (NS * NS), ke = (o - d - NS * NS * NS) % (NS * NS);
      for (int side = 0; side < 2; ++side)
        for (int chunk = 0; chunk < nt; ++chunk) {
          const int uu = (side * P + p) * nt + chunk;
          acc = df_add(acc, ld(up, up + uplane, (size_t)uu * nv + d + ke));
        }
      out[o] = df_collapse(acc);
    }
  }
}

// #9's grid: kUnitBlocks blocks per unit, then the mean blocks, padded to
// whole clusters
template <int NS>
int bwd_grid(int n) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (n + kTile - 1) / kTile;
  return kUnitBlocks * 2 * P * nt + (nt + kUnitBlocks - 1) / kUnitBlocks * kUnitBlocks;
}

// past 48 KB of dynamic shared memory a kernel must be allowed it
template <int NS, bool BATCHED = false>
int allow_dyn_smem(size_t dyn) {
  if (dyn > kMaxUnitDynSmem) return (int)cudaErrorInvalidValue;
  if (dyn <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(df_mm_bwd_kernel<NS, BATCHED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)dyn);
}

// the grid of one element is the B = 1 launch's; batch rows of it
template <int NS, bool BATCHED>
int launch_bwd_as(const Cache& c, const float* mu, const float* bh, const float* bl, const float* qh,
                  const float* ql, Cot ct, float* mean_part, float* unit_part, float* out, const int* cidx,
                  int batch, cudaStream_t stream) {
  const size_t dyn = unit_dyn_smem<NS>(c.n);
  int rc = allow_dyn_smem<NS, BATCHED>(dyn);
  if (rc != 0) return rc;
  df_mm_bwd_kernel<NS, BATCHED><<<dim3(bwd_grid<NS>(c.n), batch), kUnitThreads, dyn, stream>>>(
      c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, cidx);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (c.n + kTile - 1) / kTile;
  const size_t parts = (size_t)2 * (2 * P * nt + NS * nt) * (c.d + NS * NS);  // floats of both
  const int smem_floats = parts * sizeof(float) <= 48 * 1024 ? (int)parts : 0;
  return gpmpc_pdl::launch_dependent(df_mm_bwd_sum_kernel<NS, BATCHED>, batch, kSumThreads,
                                     smem_floats * sizeof(float), stream, c.n, c.d, (const float*)mean_part,
                                     (const float*)unit_part, out, smem_floats);
}

template <int NS>
int launch_bwd(const Cache& c, const float* mu, const float* bh, const float* bl, const float* qh,
               const float* ql, Cot ct, float* mean_part, float* unit_part, float* out, const int* cidx,
               int batch, cudaStream_t stream) {
  if (batch == 1 && cidx == nullptr)
    return launch_bwd_as<NS, false>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, stream);
  return launch_bwd_as<NS, true>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, stream);
}

// #9's registers, spill bytes, threads, resident blocks per SM, grid, SMs
// and dynamic shared memory at (n, ns), for the smoke's report
template <int NS>
int bwd_info(int n, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_bwd_kernel<NS, false>);
  if (rc != 0) return rc;
  const size_t dyn = unit_dyn_smem<NS>(n);
  rc = allow_dyn_smem<NS>(dyn);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_bwd_kernel<NS, false>, kUnitThreads, dyn);
  if (rc != 0) return rc;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vals[7] = {a.numRegs, (int)a.localSizeBytes, kUnitThreads, per_sm, bwd_grid<NS>(n), sms, (int)dyn};
  for (int k = 0; k < 7; ++k) info[k] = vals[k];
  return 0;
}

}  // namespace

extern "C" {

// batch elements, each its operands, cotangents, partials and out after the
// element before's; cidx (batch) the cache of each, or null for one shared
// cache
int gpmpc_df_mm_bwd_f32(const float* mu, const float* bh, const float* bl, const float* qh, const float* ql,
                        GPMPC_DF_MM_CACHE_ARGS, const float* g_m, const float* g_v, const float* g_sp,
                        const float* g_corr, float* mean_part, float* unit_part, float* out, int n, int ns, int d,
                        const int* cidx, int batch, void* stream) {
  if (!valid(n, ns, d) || !valid_batch(batch)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct{g_m, g_v, g_sp, g_corr};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd<1>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, s);
    case 2: return launch_bwd<2>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, s);
    default: return launch_bwd<3>(c, mu, bh, bl, qh, ql, ct, mean_part, unit_part, out, cidx, batch, s);
  }
}

// #9's launch report (bwd_info): info[7]
int gpmpc_df_mm_bwd_info(int n, int ns, int* info) {
  switch (ns) {
    case 1: return bwd_info<1>(n, info);
    case 2: return bwd_info<2>(n, info);
    default: return bwd_info<3>(n, info);
  }
}

}  // extern "C"

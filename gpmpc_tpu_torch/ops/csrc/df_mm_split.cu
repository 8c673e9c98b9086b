// The whole-step VJP split past N = 128, as the reference splits it. See
// df_mm_bwd.cu for the whole VJP (#9) and df_mm_bwd.cuh for the device code
// the two share. Replaces gpmpc_tpu/ops/pallas_df_mm.py:
//   df_mm_bwd_mean_kernel (one cluster)
//       -> _build.bwd_mean_kernel (#10): the mean path's VJP, with respect to
//          mu and B^-1 (wrapper df_mm_bwd_mean)
//   df_mm_bwd_pair_kernel + df_mm_bwd_pair_unit_kernel + df_mm_bwd_pair_sum_kernel
//       -> _build.make_bwd_pair_kernel (#11): the VJP of each covariance pair,
//          with respect to mu and Q_k (wrapper df_mm_bwd_pairs)
// The reference runs #10 and one #11 launch per pair when N > 128; here the
// pair is a grid axis of one #11 launch. #10 and #11 return their
// contributions to the cotangent of mu as df halves; in the split route
// #11's last launch adds #10's and its own in df (mean path first, then the
// pairs in pair order, as combine_split does) before the collapse.
//
// #11 (the split route past N = 128) computes E once per element in 32 x 32
// pair tiles and writes each tile's row and column sums; a first design then
// summed them, applied the chain rule and summed again in one block of 16
// warps, 9 units in series per warp at N = 384: 180 of its 240 us (NVIDIA
// H100 80GB HBM3, 700 W, trace_split_bwd.py). Here the tile rows are summed
// by rows_tile_sum, then the chain rule runs on each unit (one side of one
// pair, 32 points) over the SMs (pair_plan), 1 + NS warps a unit: one long
// df chain per point is what bounds it, so each warp takes one residual and
// a share of the outputs. A third launch sums per pair. Each launch is a
// programmatic dependent of the one before. #10 is a latency-bound chain per
// point (one warp issues ~3,000 f32 instructions, its df exp ~400 in a
// dependent row): one cluster whose blocks take a (model, tile) item per
// warp and whose block 0 sums the items after the cluster barrier, so no
// second launch; it releases its dependent at once, and in the split route
// #11's pair tiles run beside it.
//
// The batch axis (a plan's restarts, an episode batch's seeds), as #9's:
// with BATCHED a grid row is a batch element (#10's clusters and #11's first
// two launches in y, #11's summing launch in x), reading cache cidx[b]
// (df_mm.cuh cache_of) and its operands, cotangents, partials and outputs
// after the element before's. Each launch is planned for one element and
// nothing is summed across elements, so each element equals its single
// launch bit for bit; one element with its one cache launches the instance
// without.

#include "df_mm_bwd.cuh"

namespace {

// the four from one block g_M (batch, NS), g_V (batch, NS d), g_S_p (batch,
// P), g_corr (batch, NS)
Cot cot_block(const float* ct, int ns, int d, int batch) {
  const size_t b = batch;
  return {ct, ct + b * ns, ct + b * (ns + ns * d), ct + b * (ns + ns * d + ns * (ns + 1) / 2)};
}

__device__ __forceinline__ size_t part_at(int p, int v, int tile, int n, int nr, int nt, int nn) {
  return (((size_t)p * nr + v) * nt + tile) * nn + n;
}

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// the f32s of a summing launch's partials, if they fit its shared memory
int smem_floats_for(size_t floats) { return floats * sizeof(float) <= 48 * 1024 ? (int)floats : 0; }

// #11's pair block b = (p nt + rt) nt + ct: the 32 x 32 tile (rt, ct) of
// pair p, E once per element. Warp w takes the tile's rows w + 8 r (r < 4),
// a lane a column. Each row's G and G Xj_e over the tile's columns are summed
// by rows_tile_sum (warp_df_sum's order); each column's G and G U_e over the
// tile's rows by rows m, m + 8, m + 16, m + 24 in order per warp m, then
// tree8 over the warps. A lane's iK entries are loaded before the tile's
// operands are computed.
template <int NS>
__device__ void bwd_pair_tile(const Cache& c, const float* __restrict__ mu, const float* __restrict__ qh,
                              const float* __restrict__ ql, Cot ct,
                              float* __restrict__ row_part, float* __restrict__ col_part, int b) {
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  static_assert(NR <= 4, "four values per tile sum");
  const int nt = (c.n + kTile - 1) / kTile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ df s_q[NS * NS];
  __shared__ TileOperands<NS> s;
  __shared__ df s_col[kWarps][NR][kTile];
  const int cti = b % nt, rt = (b / nt) % nt, p = b / (nt * nt);
  int i, j;
  pair_ij(p, NS, i, j);
  const int k = cti * kTile + lane;
  const bool col_ok = k < c.n;
  const float gs = ct.sp[p];
  const float gco = i == j ? ct.corr[i] : 0.f;
  df ik[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = rt * kTile + warp + kWarps * r;
    ik[r] = i == j && col_ok && n < c.n ? ld(c.ikh, c.ikl, ((size_t)i * c.n + n) * c.n + k) : df{0.f, 0.f};
  }
  if (t < NS * NS) s_q[t] = ld(qh, ql, (size_t)p * NS * NS + t);
  __syncthreads();
  load_tile<NS>(c, mu, s_q, i, j, rt, cti, s);
  __syncthreads();

  float xj_c[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) xj_c[e] = col_ok ? df_collapse(s.xj[lane][e]) : 0.f;
  df cacc[NR];
#pragma unroll
  for (int v = 0; v < NR; ++v) cacc[v] = {0.f, 0.f};
  const size_t plane = (size_t)P * NR * nt * c.n;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = warp + kWarps * r;
    const int n = rt * kTile + rr;
    if (n >= c.n) break;  // warp-uniform
    df racc[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (col_ok) {
      const df ex = e_exponent<NS>(s.a[rr], s.u[rr], s.c[lane], s.xj[lane]);
      df w = df_mul_f32(df_mul(s.bi[rr], s.bj[lane]), gs);
      if (i == j) w = df_add(w, df_mul_f32(ik[r], gco));
      const df g = ex.h < 60.f ? df_mul(e_capped_exp(ex), w) : df{0.f, 0.f};
      racc[0] = g;
      cacc[0] = df_add(cacc[0], g);
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        racc[1 + e] = df_mul_f32(g, xj_c[e]);
        cacc[1 + e] = df_add(cacc[1 + e], df_mul_f32(g, df_collapse(s.u[rr][e])));
      }
    }
    const df tot = rows_tile_sum(racc);
    if ((lane & 7) == 0 && (lane >> 3) < NR) st(row_part, plane, part_at(p, lane >> 3, cti, n, NR, nt, c.n), tot);
  }
#pragma unroll
  for (int v = 0; v < NR; ++v) s_col[warp][v][lane] = cacc[v];
  __syncthreads();
  if (t < NR * kTile) {
    const int v = t / kTile, cc = t % kTile;
    const int kk = cti * kTile + cc;
    if (kk < c.n) {
      df w8[kWarps];
#pragma unroll
      for (int m = 0; m < kWarps; ++m) w8[m] = s_col[m][v][cc];
      st(col_part, plane, part_at(p, v, rt, kk, NR, nt, c.n), tree8(w8));
    }
  }
}

// ---------------------------------------------------------------------------
// #11: the pair tiles, then the chain rule on 1 + NS warps per unit, then
// the sums per pair, each launch a programmatic dependent of the one before.
// ---------------------------------------------------------------------------

// the most units of a unit block (pair_plan; 1 + NS warps each); the tile
// partials a lane loads at once
constexpr int kPairUnitMaxUnits = 2;
constexpr int kUnitLoadTiles = 8;

// f32s of one element's row (or column) partials of #11, both halves
template <int NS>
__device__ __forceinline__ size_t pair_parts_of(int n) {
  const int nt = (n + kTile - 1) / kTile;
  return (size_t)2 * (NS * (NS + 1) / 2) * (1 + NS) * nt * n;
}

// #11's first launch, the P nt nt pair blocks. In the split route it is a
// programmatic dependent of #10: it reads nothing that #10 writes, so it may
// run beside it, and it waits for #10 before it exits, so that the launches
// after it (which read #10's output) find #10 done.
template <int NS, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
df_mm_bwd_pair_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                      const float* __restrict__ ql, Cot ct, float* __restrict__ row_part,
                      float* __restrict__ col_part, const int* __restrict__ cidx) {
  gpmpc_pdl::release_dependents();
  if constexpr (BATCHED) {  // this block's batch element
    constexpr int P = NS * (NS + 1) / 2;
    const int elem = blockIdx.y;
    const size_t parts = pair_parts_of<NS>(c.n);
    c = cache_of<NS>(c, cidx, elem);
    mu += (size_t)elem * c.d;
    qh += (size_t)elem * P * NS * NS;
    ql += (size_t)elem * P * NS * NS;
    ct = cot_at(ct, NS, c.d, elem);
    row_part += elem * parts;
    col_part += elem * parts;
  }
  bwd_pair_tile<NS>(c, mu, qh, ql, ct, row_part, col_part, blockIdx.x);
  gpmpc_pdl::wait_for_prerequisite();
}

// #11's second launch: unit u = (side P + p) nt + chunk (the 32 points of
// one side of pair p) owns NR = 1 + NS warps of a block (pair_plan's
// unit_warps units a block), a lane a point. Every warp of the unit computes
// the point's forward quantities (before the wait: they read only the
// inputs). Then warp v sums residual v over the tiles in tile order; warps
// v >= 1 form g_xi[v - 1] and row v - 1 of the unit's Q cotangent, warp 0
// the inp cotangent: #9's point_chain_rule, its outputs split over the
// warps with each one's df operations unchanged. Each warp sums its outputs
// over the unit's points in warp_df_sum's order into unit_part, as #9's are.
template <int NS, bool BATCHED>
__global__ void __launch_bounds__(32 * (1 + NS) * kPairUnitMaxUnits)
df_mm_bwd_pair_unit_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ qh,
                           const float* __restrict__ ql, const float* __restrict__ row_part,
                           const float* __restrict__ col_part, float* __restrict__ unit_part,
                           const int* __restrict__ cidx) {
  constexpr int P = NS * (NS + 1) / 2;
  constexpr int NR = 1 + NS;
  __shared__ df s_res[kPairUnitMaxUnits][NR][kTile];
  __shared__ df s_gxi[kPairUnitMaxUnits][NS][kTile];
  gpmpc_pdl::release_dependents();
  const int d = c.d;
  const int nt = (c.n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const int units = 2 * P * nt;
  if constexpr (BATCHED) {  // this block's batch element
    const int elem = blockIdx.y;
    const size_t parts = pair_parts_of<NS>(c.n);
    c = cache_of<NS>(c, cidx, elem);
    mu += (size_t)elem * d;
    qh += (size_t)elem * P * NS * NS;
    ql += (size_t)elem * P * NS * NS;
    row_part += elem * parts;
    col_part += elem * parts;
    unit_part += (size_t)elem * 2 * units * nv;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / NR, v = warp % NR;
  const int u = blockIdx.x * (blockDim.x / (32 * NR)) + slot;
  const bool live = u < units;  // the barriers below need every warp
  const int uu = live ? u : 0;
  const int side = uu / (P * nt), p = (uu / nt) % P, chunk = uu % nt;
  int i, j;
  pair_ij(p, NS, i, j);
  const int m = side == 0 ? i : j;
  const int n = chunk * kTile + lane;
  const bool point = live && n < c.n;
  df q[NS * NS];
#pragma unroll
  for (int k = 0; k < NS * NS; ++k) q[k] = ld(qh, ql, (size_t)p * NS * NS + k);
  PointTerms<NS> pt = {};
  if (point) {
    ModelPoint<NS> mp;
    model_point<NS>(c, mu, m, n, mp);
    df xq[NS];
    qform<NS>(mp.xi, q, xq);
    point_terms<NS>(c, m, mp, xq, pt);
  }
  gpmpc_pdl::wait_for_prerequisite();

  // residual v: the tile partials kUnitLoadTiles at a time, all issued
  // before their additions (in tile order)
  df res = {0.f, 0.f};
  if (point) {
    const float* part = side == 0 ? row_part : col_part;
    const size_t plane = (size_t)P * NR * nt * c.n;
    for (int t0 = 0; t0 < nt; t0 += kUnitLoadTiles) {
      df buf[kUnitLoadTiles];
#pragma unroll
      for (int k = 0; k < kUnitLoadTiles; ++k)
        buf[k] = t0 + k < nt ? ld(part, part + plane, part_at(p, v, t0 + k, n, NR, nt, c.n)) : df{0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kUnitLoadTiles; ++k)
        if (t0 + k < nt) res = df_add(res, buf[k]);
    }
  }
  s_res[slot][v][lane] = res;
  __syncthreads();
  df r[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) r[k] = s_res[slot][k][lane];
  // point_chain_rule, split: g_xq on every warp
  df g_xq[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e)
    g_xq[e] = side == 0 ? df_add(df_scale(r[1 + e], 2.f), df_mul_f32(r[0], pt.xi_c[e])) : df_mul_f32(r[0], pt.xi_c[e]);
  const size_t uplane = (size_t)units * nv;
  const size_t base = (size_t)uu * nv;
  if (v >= 1) {  // g_xi[k] and row k of the Q cotangent
    const int k = v - 1;
    df a = df_mul_f32(r[0], pt.xq_c[k]);
    if (side == 1) a = df_add(a, r[1 + k]);
#pragma unroll
    for (int e = 0; e < NS; ++e) a = df_add(a, df_mul_f32(g_xq[e], df_collapse(q[k * NS + e])));
    s_gxi[slot][k][lane] = a;
    df x[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (point) {
#pragma unroll
      for (int e = 0; e < NS; ++e) x[e] = df_mul_f32(g_xq[e], pt.xi_c[k]);
    }
    if (live) store_sums<4>(x, NS, unit_part, uplane, [&](int e) { return base + d + k * NS + e; });
  }
  __syncthreads();
  if (v == 0 && live) {  // the inp cotangent
    df x[kMaxD];
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) {
      x[e] = {0.f, 0.f};
      if (!point || e >= d) continue;
      df g = df_mul_f32(df_mul_f32(r[0], -pt.iN_c[e]), pt.ils_c[e]);
      if (e < NS) g = df_add(g, df_mul_f32(s_gxi[slot][e][lane], pt.ils2_c[e]));
      x[e] = g;
    }
    if (d <= 4) store_sums<4>(x, d, unit_part, uplane, [&](int e) { return base + e; });
    else store_sums<8>(x, d, unit_part, uplane, [&](int e) { return base + e; });
  }
}

// #11's third launch, one block: per pair p its contribution to the
// cotangent of inp (df, its units summed in #9's order: side 0's chunks,
// then side 1's) and g_Q_p; given mean_inp (#10's g_inp hi, lo), also g_mu =
// -(mean (+) pair 0 (+) pair 1 ...), combine_split's df additions in its
// order. The units' sums are first copied into shared memory when they fit
// (smem_floats). out: g_inp hi (P, d), g_inp lo (P, d), g_Q (P NS^2), then
// g_mu (d), f32.
template <int NS, bool BATCHED>
__global__ void __launch_bounds__(kSumThreads)
df_mm_bwd_pair_sum_kernel(int n, int d, const float* __restrict__ unit_part, const float* __restrict__ mean_inp,
                          float* __restrict__ out, int smem_floats) {
  constexpr int P = NS * (NS + 1) / 2;
  extern __shared__ float sm[];
  __shared__ df s_pair[kMaxP][kMaxD];
  gpmpc_pdl::wait_for_prerequisite();
  const int nt = (n + kTile - 1) / kTile;
  const int nv = d + NS * NS;
  const size_t uplane = (size_t)2 * P * nt * nv;
  if constexpr (BATCHED) {  // one block per batch element
    const size_t elem = blockIdx.x;
    unit_part += elem * 2 * uplane;
    if (mean_inp != nullptr) mean_inp += elem * (2 * d + NS * NS * NS);
    out += elem * (2 * P * d + P * NS * NS + d);
  }
  const float* up = unit_part;
  if ((size_t)smem_floats >= 2 * uplane) {
    for (size_t k = threadIdx.x; k < 2 * uplane; k += blockDim.x) sm[k] = unit_part[k];
    __syncthreads();
    up = sm;
  }
  for (int o = threadIdx.x; o < P * nv; o += blockDim.x) {
    const int p = o / nv, v = o % nv;
    df acc = {0.f, 0.f};
    for (int side = 0; side < 2; ++side)
      for (int chunk = 0; chunk < nt; ++chunk) {
        const int uu = (side * P + p) * nt + chunk;
        acc = df_add(acc, ld(up, up + uplane, (size_t)uu * nv + v));
      }
    if (v < d) {
      out[p * d + v] = acc.h;
      out[P * d + p * d + v] = acc.l;
      s_pair[p][v] = acc;
    } else {
      out[2 * P * d + p * NS * NS + (v - d)] = df_collapse(acc);
    }
  }
  if (mean_inp == nullptr) return;
  __syncthreads();
  if ((int)threadIdx.x < d) {
    const int e = threadIdx.x;
    df acc = {mean_inp[e], mean_inp[d + e]};
    for (int p = 0; p < P; ++p) acc = df_add(acc, s_pair[p][e]);
    out[2 * P * d + P * NS * NS + e] = -df_collapse(acc);
  }
}

// ---------------------------------------------------------------------------
// #10: one cluster of mean_plan's blocks. Block r takes the tiles r, r + cl,
// ... of every model, a warp a (model, tile) item (mean_item, into
// mean_part); after the cluster barrier block 0 sums the items per output
// over models and tiles in #9's order.
// ---------------------------------------------------------------------------

// the most blocks of #10's cluster (H100's non-portable cluster size) and
// warps of each
constexpr int kMeanMaxCluster = 16;
constexpr int kMeanMaxWarps = 8;

template <int NS, bool BATCHED>
__global__ void __launch_bounds__(32 * kMeanMaxWarps)
df_mm_bwd_mean_kernel(Cache c, const float* __restrict__ mu, const float* __restrict__ bh,
                      const float* __restrict__ bl, Cot ct, float* __restrict__ mean_part, float* __restrict__ out,
                      int smem_floats, const int* __restrict__ cidx) {
  namespace cg = cooperative_groups;
  gpmpc_pdl::release_dependents();
  extern __shared__ float sm[];
  __shared__ df s_b[NS][NS * NS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cl = (int)cluster.num_blocks();
  const int nt = (c.n + kTile - 1) / kTile;
  if constexpr (BATCHED) {  // this cluster's batch element
    const int elem = blockIdx.y;
    c = cache_of<NS>(c, cidx, elem);
    mu += (size_t)elem * c.d;
    bh += (size_t)elem * NS * NS * NS;
    bl += (size_t)elem * NS * NS * NS;
    ct = cot_at(ct, NS, c.d, elem);
    mean_part += (size_t)elem * 2 * NS * nt * (c.d + NS * NS);
    out += (size_t)elem * (2 * c.d + NS * NS * NS);
  }
  const int t = threadIdx.x, warps = blockDim.x >> 5;
  if (t < NS * NS * NS) s_b[t / (NS * NS)][t % (NS * NS)] = ld(bh, bl, t);
  __syncthreads();
  const int items = NS * ((nt - rank + cl - 1) / cl);
  for (int it = t >> 5; it < items; it += warps)
    mean_item<NS>(c, mu, s_b[it % NS], ct, mean_part, it % NS, rank + cl * (it / NS));
  __threadfence();
  cluster.sync();
  if (rank != 0) return;

  const int d = c.d;
  const int nv = d + NS * NS;
  const size_t mplane = (size_t)NS * nt * nv;
  const float* mp = mean_part;
  if ((size_t)smem_floats >= 2 * mplane) {
    for (size_t k = t; k < 2 * mplane; k += blockDim.x) sm[k] = mean_part[k];
    __syncthreads();
    mp = sm;
  }
  for (int o = t; o < d + NS * NS * NS; o += blockDim.x) {
    df acc = {0.f, 0.f};
    if (o < d) {
      for (int mm = 0; mm < NS; ++mm)
        for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + o));
      out[o] = acc.h;
      out[d + o] = acc.l;
    } else {
      const int mm = (o - d) / (NS * NS), kj = (o - d) % (NS * NS);
      for (int rt = 0; rt < nt; ++rt) acc = df_add(acc, ld(mp, mp + mplane, ((size_t)mm * nt + rt) * nv + d + kj));
      out[d + o] = df_collapse(acc);
    }
  }
}

// #10's plan at N on a card of sms SMs (df_mm.mean_launch_plan): the blocks
// of its one cluster, and the warps of each, enough for the busiest block's
// items (NS per tile) up to kMeanMaxWarps
struct MeanPlan {
  int cluster, warps;
};

template <int NS>
MeanPlan mean_plan(int n, int sms) {
  const int nt = (n + kTile - 1) / kTile;
  const int cl = std::min(kMeanMaxCluster, std::min(nt, sms));
  return {cl, std::min(kMeanMaxWarps, NS * ((nt + cl - 1) / cl))};
}

// past 8 blocks a cluster must be allowed the non-portable size
template <int NS, bool BATCHED = false>
int allow_big_cluster() {
  return (int)cudaFuncSetAttribute(df_mm_bwd_mean_kernel<NS, BATCHED>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                   1);
}

// one cluster per batch element, grid row y the element
template <int NS, bool BATCHED>
int launch_bwd_mean_as(const Cache& c, const float* mu, const float* bh, const float* bl, Cot ct,
                       float* mean_part, float* out, const int* cidx, int batch, cudaStream_t stream) {
  const MeanPlan plan = mean_plan<NS>(c.n, device_sms());
  const int nt = (c.n + kTile - 1) / kTile;
  const int smem_floats = smem_floats_for((size_t)2 * NS * nt * (c.d + NS * NS));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cluster, batch);
  cfg.blockDim = 32 * plan.warps;
  cfg.dynamicSmemBytes = smem_floats * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int rc = allow_big_cluster<NS, BATCHED>();
  if (rc != 0) return rc;
  return (int)cudaLaunchKernelEx(&cfg, df_mm_bwd_mean_kernel<NS, BATCHED>, c, mu, bh, bl, ct, mean_part, out,
                                 smem_floats, cidx);
}

template <int NS>
int launch_bwd_mean(const Cache& c, const float* mu, const float* bh, const float* bl, Cot ct, float* mean_part,
                    float* out, const int* cidx, int batch, cudaStream_t stream) {
  if (batch == 1 && cidx == nullptr)
    return launch_bwd_mean_as<NS, false>(c, mu, bh, bl, ct, mean_part, out, cidx, batch, stream);
  return launch_bwd_mean_as<NS, true>(c, mu, bh, bl, ct, mean_part, out, cidx, batch, stream);
}

// #10's registers, spill bytes, threads, resident blocks per SM, grid (the
// cluster), SMs and dynamic shared memory at (n, ns, d)
template <int NS>
int mean_info(int n, int d, int* info) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_bwd_mean_kernel<NS, false>);
  if (rc != 0) return rc;
  const int sms = device_sms();
  const MeanPlan plan = mean_plan<NS>(n, sms);
  const int nt = (n + kTile - 1) / kTile;
  const int dyn = smem_floats_for((size_t)2 * NS * nt * (d + NS * NS)) * (int)sizeof(float);
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_bwd_mean_kernel<NS, false>, 32 * plan.warps,
                                                          dyn);
  if (rc != 0) return rc;
  const int vals[7] = {a.numRegs, (int)a.localSizeBytes, 32 * plan.warps, per_sm, plan.cluster, sms, dyn};
  for (int k = 0; k < 7; ++k) info[k] = vals[k];
  return 0;
}

// #11's plan at N on a card of sms SMs (df_mm.pair_launch_plan): the pair
// blocks, the 2 P nt units and the units per block of the second launch
// (1 + NS warps each), spread over the SMs
struct PairPlan {
  int tile_blocks, units, unit_warps, unit_blocks;
};

template <int NS>
PairPlan pair_plan(int n, int sms) {
  constexpr int P = NS * (NS + 1) / 2;
  const int nt = (n + kTile - 1) / kTile;
  const int units = 2 * P * nt;
  const int per = std::min(kPairUnitMaxUnits, std::max(1, (units + sms - 1) / sms));
  return {P * nt * nt, units, per * (1 + NS), (units + per - 1) / per};
}

// mean_inp: #10's out (g_inp hi, lo (2 d), g_B) of every element from the
// launch just before on the stream, whose g_inp and the pairs' are summed
// into g_mu; or null. The first two launches run the batch in grid rows y,
// the summing launch a block per element.
template <int NS, bool BATCHED>
int launch_bwd_pair_as(const Cache& c, const float* mu, const float* qh, const float* ql, Cot ct,
                       const float* mean_inp, float* row_part, float* col_part, float* unit_part, float* out,
                       const int* cidx, int batch, cudaStream_t stream) {
  const PairPlan plan = pair_plan<NS>(c.n, device_sms());
  int rc;
  if (mean_inp != nullptr) {
    rc = gpmpc_pdl::launch_dependent(df_mm_bwd_pair_kernel<NS, BATCHED>, dim3(plan.tile_blocks, batch), kThreads, 0,
                                     stream, c, mu, qh, ql, ct, row_part, col_part, cidx);
  } else {
    df_mm_bwd_pair_kernel<NS, BATCHED><<<dim3(plan.tile_blocks, batch), kThreads, 0, stream>>>(
        c, mu, qh, ql, ct, row_part, col_part, cidx);
    rc = (int)cudaGetLastError();
  }
  if (rc != 0) return rc;
  rc = gpmpc_pdl::launch_dependent(df_mm_bwd_pair_unit_kernel<NS, BATCHED>, dim3(plan.unit_blocks, batch),
                                   32 * plan.unit_warps, 0, stream, c, mu, qh, ql, (const float*)row_part,
                                   (const float*)col_part, unit_part, cidx);
  if (rc != 0) return rc;
  const int smem_floats = smem_floats_for((size_t)2 * plan.units * (c.d + NS * NS));
  return gpmpc_pdl::launch_dependent(df_mm_bwd_pair_sum_kernel<NS, BATCHED>, batch, kSumThreads,
                                     smem_floats * sizeof(float), stream, c.n, c.d, (const float*)unit_part, mean_inp,
                                     out, smem_floats);
}

template <int NS>
int launch_bwd_pair(const Cache& c, const float* mu, const float* qh, const float* ql, Cot ct,
                    const float* mean_inp, float* row_part, float* col_part, float* unit_part, float* out,
                    const int* cidx, int batch, cudaStream_t stream) {
  if (batch == 1 && cidx == nullptr)
    return launch_bwd_pair_as<NS, false>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, cidx,
                                         batch, stream);
  return launch_bwd_pair_as<NS, true>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, cidx, batch,
                                      stream);
}

// #11's pair-block registers, spill bytes, threads, resident blocks per SM,
// grid, SMs and dynamic shared memory at (n, ns), then the unit launch's
// registers, warps per block and blocks
template <int NS>
int pair_info(int n, int* info) {
  cudaFuncAttributes a, au;
  int rc = (int)cudaFuncGetAttributes(&a, df_mm_bwd_pair_kernel<NS, false>);
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&au, df_mm_bwd_pair_unit_kernel<NS, false>);
  if (rc != 0) return rc;
  const int sms = device_sms();
  const PairPlan plan = pair_plan<NS>(n, sms);
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, df_mm_bwd_pair_kernel<NS, false>, kThreads, 0);
  if (rc != 0) return rc;
  const int vals[10] = {a.numRegs, (int)a.localSizeBytes, kThreads, per_sm, plan.tile_blocks, sms, 0,
                        au.numRegs, plan.unit_warps, plan.unit_blocks};
  for (int k = 0; k < 10; ++k) info[k] = vals[k];
  return 0;
}

}  // namespace

extern "C" {

// #10, batch elements as gpmpc_df_mm_bwd_f32's (ct_block: cot_block's
// four, each (batch, k)): out = g_inp hi (d), g_inp lo (d), g_B (ns^3) per
// element
int gpmpc_df_mm_bwd_mean_f32(const float* mu, const float* bh, const float* bl, GPMPC_DF_MM_CACHE_ARGS,
                             const float* ct_block, float* mean_part, float* out, int n, int ns, int d,
                             const int* cidx, int batch, void* stream) {
  if (!valid(n, ns, d) || !valid_batch(batch)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct = cot_block(ct_block, ns, d, batch);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_mean<1>(c, mu, bh, bl, ct, mean_part, out, cidx, batch, s);
    case 2: return launch_bwd_mean<2>(c, mu, bh, bl, ct, mean_part, out, cidx, batch, s);
    default: return launch_bwd_mean<3>(c, mu, bh, bl, ct, mean_part, out, cidx, batch, s);
  }
}

// #10's launch report (mean_info): info[7]
int gpmpc_df_mm_bwd_mean_info(int n, int ns, int d, int* info) {
  switch (ns) {
    case 1: return mean_info<1>(n, d, info);
    case 2: return mean_info<2>(n, d, info);
    default: return mean_info<3>(n, d, info);
  }
}

// #11, batch elements as #10's: out = g_inp hi (P, d), g_inp lo (P, d), g_Q
// (P ns^2), g_mu (d) per element; g_mu only given mean_inp, #10's out from
// the launch just before on the stream (its g_inp halves), else null
int gpmpc_df_mm_bwd_pair_f32(const float* mu, const float* qh, const float* ql, GPMPC_DF_MM_CACHE_ARGS,
                             const float* ct_block, const float* mean_inp, float* row_part, float* col_part,
                             float* unit_part, float* out, int n, int ns, int d, const int* cidx, int batch,
                             void* stream) {
  if (!valid(n, ns, d) || !valid_batch(batch)) return (int)cudaErrorInvalidValue;
  const Cache c{xh, xl, ilsh, ilsl, ils2h, ils2l, logoh, logol, beth, betl, ikh, ikl, n, d};
  const Cot ct = cot_block(ct_block, ns, d, batch);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ns) {
    case 1: return launch_bwd_pair<1>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, cidx, batch, s);
    case 2: return launch_bwd_pair<2>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, cidx, batch, s);
    default:
      return launch_bwd_pair<3>(c, mu, qh, ql, ct, mean_inp, row_part, col_part, unit_part, out, cidx, batch, s);
  }
}

// #11's launch report (pair_info): info[10]
int gpmpc_df_mm_bwd_pair_info(int n, int ns, int* info) {
  switch (ns) {
    case 1: return pair_info<1>(n, info);
    case 2: return pair_info<2>(n, info);
    default: return pair_info<3>(n, info);
  }
}

}  // extern "C"

"""Whole-step double-float32 moment matching: CUDA kernels, their plain twins
and the autograd composites.

Port of ``gpmpc_tpu/ops/pallas_df_mm.py``. One moment-matching step of the
mixed-mode rollout (``models.gp.moment_match_df``) in df32, with its
N-scaling work in one kernel launch instead of thousands of small ones:

* stage 1 (``df_stage1``): the Ns x Ns df solves, B^-1 and c = outs /
  sqrt det B per model, Q and sqrt det R per pair;
* the mean path, per model m and stored point n: inp = x_n - mu, iN = inp
  ils_m, t = iN with its state block times B_m^-1, lb = exp(-iN . t / 2)
  beta_m[n]; the raw partials M_m = sum_n lb and V_m[e] = sum_n t_e ils_m[e] lb;
* the covariance pairs p = (i, j), i <= j: E[n, k] = exp(min(a_n + c_k +
  U_n . Xj_k, 60)) with a = klog_i + xs_i, c = klog_j + xs_j, U = 2 Xi_i Q_p,
  Xj = Xi_j (klog_m = log outs_m - |iN_m|^2 / 2, Xi_m = inp ils2_m on the
  state columns, xs = (Xi Q_p) . Xi); the raw partials S_p = sum bi E bj and,
  on the diagonal pairs, corr_i = sum iK_i E;
* the finish: M = c (M), V = c (V), S_p = (S_p (-) corr) / sqrt det R, the
  subtraction in df (both are ~1e3 and cancel to ~1e-2 at cond(K) ~ 1e6).

Kernels (``csrc/df_mm_fwd.cu``, ``csrc/df_mm_bwd.cu`` and ``csrc/df_mm_split.cu`` on ``csrc/df_mm.cuh``
and ``csrc/df32.cuh``), each replacing a Pallas TPU
kernel of ``gpmpc_tpu/ops/pallas_df_mm.py``:

* ``df_mm_full`` replaces ``_build_full.fwd_kernel`` (#12): stage 1, the
  mean path, every pair and the finish; final f32 M (ns), V (ns, d), S_p (P).
  It serves every forward-only evaluation. A pair block owns a tile of
  8 rpw rows by 32 columns of one pair's slab, a lane one column against
  the tile's rows (``fwd_launch_plan`` picks rpw from the SM count: one E
  per lane at the planning step's N), and one warp runs the pair's stage 1
  (its independent entries on separate lanes) while the tile's operands
  are computed; a programmatic dependent launch sums the blocks' partials
  in a fixed order and finishes (``full_launch_info`` reports the launch).
  The forward itself is a programmatic dependent of the kernel before it.
* ``df_mm_fwd`` replaces ``_build.fwd_kernel`` (#8): stages 2-3 from a given
  B^-1 and Q, the eight raw df partials; #12's launch with B^-1 and Q read.
* ``df_mm_bwd`` replaces ``_build.bwd_all_kernel`` (#9): the VJP of #8 with
  respect to mu, B^-1 and Q. The TPU kernel runs ``jax.vjp`` in its body;
  here the VJP is written out. Its derivative is the reference's (each df
  value carries one f32 tangent, ``df32``'s custom rules: a product's
  coefficients are the collapsed f32 values of its factors), but every
  cotangent is carried as a df number: per pair, the exponent's cotangent
  G = E (gs bi bj + gco iK) and its row and column sums (weighted by Xj and
  by U, the residual scheme of ``df_cov.DfCovCore``) stay df, and so do the
  chain rule through a, c, U and Xj to inp = x - mu and Q, the mean path's
  VJP and the sums over N. Only the outputs are collapsed to f32. The sums
  that cancel at cond(K) ~ 1e6 (fault C1 in ROADMAP) therefore cancel in df.
  The kernel runs on stacked rows: a cluster of two blocks owns 32 points of
  one side of one pair, a warp one point against all N, and the chain rule
  and the unit's sums run in the cluster's shared memory, so its second
  launch only adds the units' sums (``bwd_launch_info`` reports the launch).
  Its sums follow #11's order, so #9 and the split route agree bit for bit.
* ``df_mm_bwd_mean`` replaces ``_build.bwd_mean_kernel`` (#10) and
  ``df_mm_bwd_pair`` replaces ``_build.make_bwd_pair_kernel`` (#11): #9
  split into the mean path's VJP (to mu and B^-1) and every pair's (to mu
  and Q_k; the pair is a grid axis of one launch, where the reference
  launches once per pair), built from #9's device code. The reference's
  rule (``SINGLE_BWD_MAX_N``) runs them in place of #9 past N = 128. #10 is
  one thread-block cluster (``mean_launch_plan``): a warp per (model,
  32-point tile), then block 0 sums over models and tiles. #11 computes E
  once per element in 32 x 32 pair tiles, then applies the chain rule on
  (side, pair, 32 points) units, 1 + ns warps each, over the SMs
  (``pair_launch_plan``) and sums per pair, three launches each a
  programmatic dependent of the one before. In ``stage23_bwd`` #11 follows
  #10 on the stream, its tiles run beside it, and its last launch adds
  #10's df contribution to mu's cotangent and its own as ``combine_split``
  (the CPU path and the oracle) does, so the split route launches no
  PyTorch op after the cotangent block. ``mean_launch_info`` and
  ``pair_launch_info`` report the launches.

``FullStep`` is the differentiable whole step: forward #12, backward the
split path of ``_build_full`` (``df_stage1`` by autograd, then ``Stage23``:
forward #8, backward #9, then the finish), differentiated with respect to
(mu, sv), as the reference's ``core_bwd`` takes ``jax.vjp`` of
``_reference_path``. The cache slabs get no gradient (``core_bwd`` returns
zeros for them): they are constants while planning.

Every kernel takes any N (the ragged edge is masked; #9 up to N = 5,000 at
ns = 3, the other side's operands in shared memory) with 1 <= ns <= 3 and
ns <= d <= 8. The reference pads N to a power of two for Mosaic
(``_pad_cache_pow2``, exact); the port needs no padding, so the 96 bucket
runs at N = 96. Dispatch (``ops.use_df_fused``) keeps the reference's range,
``supported``: 32 <= N <= 128.

The plain twins are batched PyTorch on tensors, with each element's f32
operations in the kernels' order (so E and every operand agree bit for bit,
and a kernel differs from its twin only in the order of its df sums). They
are the CPU path and the kernels' oracle.

The batch axis. The JAX package runs these kernels under vmap (restarts,
seeds); here #12, #8 and #9 and their twins take a leading batch: mu (B, d),
sv (B, ns, ns), B^-1, Q and the cotangents with B in front, one launch for
the batch, grid row y the element (csrc/df_mm.cuh ``cache_of``). The cache
is one, shared by every element (a plan's restarts), or C caches stacked on
a leading axis with ``index`` (B,) int32, element b reading cache index[b]
(an episode batch's seeds, restarts inner; ``models.gp.with_index``). The
launch plan is one element's and no sum crosses elements, so each element
is its single launch bit for bit; the twins broadcast (``per_element``),
each element its own elementwise operations and df_sum trees, and equal the
unbatched call bit for bit. ``LAUNCHES`` counts one launch per batched call.
#10 and #11 (the split route past N = 128) take the batch the same way: #10
one cluster per element, #11's launches the element in a grid row, its last
launch adding each element's #10 and pair contributions into its g_mu.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import _build
from .df32 import df_add, df_add_f32, df_div, df_exp, df_mul, df_mul_f32, df_sqrt, df_sum, two_prod
from .df_cov import _e_exponent_df
from .df_cov import df_cov_abs_terms as _df_cov_abs

LAUNCHES = {"df_mm_full": 0, "df_mm_fwd": 0, "df_mm_bwd": 0, "df_mm_bwd_mean": 0, "df_mm_bwd_pair": 0}
MAX_NS, MAX_D = 3, 8
MAX_BATCH = 65535  # the grid's y extent (csrc/df_mm.cuh valid_batch)
# The reference's rule for the stages 2-3 backward (pallas_df_mm._build:
# ``single_bwd = n <= 128``): up to this N one whole VJP launch (#9), past it
# the mean path's VJP (#10) and the pairs' (#11). A TPU scoped-VMEM limit set
# it; whether #9 should serve every N on the H100 is a measured question for
# a later change (#9 is right at any N).
SINGLE_BWD_MAX_N = 128


def supported(n: int, ns: int, d: int) -> bool:
    """The reference's dispatch range of the whole-step path
    (pallas_df_mm.supported): buckets 32..128, where an online-learning
    episode spends its early steps, and the shapes its kernels take."""
    return 32 <= n <= 128 and ns <= MAX_NS and d <= MAX_D


@functools.lru_cache(maxsize=None)
def pair_indices(ns: int, device: torch.device):
    """Upper-triangle pair indices (ii, jj), the pair index of each (m, m) as
    a tensor and as a tuple. Made once per device: a fresh host-to-device
    index copy on every step would stall the stream."""
    ii, jj = np.triu_indices(ns)
    diag = np.where(ii == jj)[0]
    return (torch.as_tensor(ii, device=device), torch.as_tensor(jj, device=device),
            torch.as_tensor(diag, device=device), tuple(int(p) for p in diag))


# ---------------------------------------------------------------------------
# stage 1: the small df solves
# ---------------------------------------------------------------------------


def spd_inv_det_df(Mh, Ml):
    """(Mh + Ml) (..., k, k) SPD in df32 -> (Minv_h, Minv_l, det_h, det_l) by
    an unrolled Cholesky of elementwise df ops. A pivot guard clamps each
    pivot at a tiny fraction of its row diagonal: inactive on healthy inputs,
    it keeps a covariance that drifted indefinite from NaN-ing the rollout."""
    k = Mh.shape[-1]
    one = (torch.ones_like(Mh[..., 0, 0]), torch.zeros_like(Mh[..., 0, 0]))
    L = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = (Mh[..., i, j], Ml[..., i, j])
            for p in range(j):
                prod = df_mul(*L[i][p], *L[j][p])
                s = df_add(s[0], s[1], -prod[0], -prod[1])
            if i == j:
                floor = 1e-10 * torch.abs(Mh[..., i, i]) + 1e-30
                guard = s[0] < floor
                s = (torch.where(guard, floor, s[0]), torch.where(guard, torch.zeros_like(s[1]), s[1]))
                L[i][i] = df_sqrt(*s)
            else:
                L[i][j] = df_div(*s, *L[j][j])
    det = df_mul(*L[0][0], *L[0][0])
    for i in range(1, k):
        det = df_mul(*det, *df_mul(*L[i][i], *L[i][i]))
    Li = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            if i == j:
                Li[i][i] = df_div(*one, *L[i][i])
            else:
                s = df_mul(*L[i][j], *Li[j][j])
                for p in range(j + 1, i):
                    s = df_add(*s, *df_mul(*L[i][p], *Li[p][j]))
                Li[i][j] = df_div(-s[0], -s[1], *L[i][i])
    rows_h, rows_l = [], []
    for i in range(k):
        row_h, row_l = [], []
        for j in range(k):
            lo = max(i, j)
            s = df_mul(*Li[lo][i], *Li[lo][j])
            for p in range(lo + 1, k):
                s = df_add(*s, *df_mul(*Li[p][i], *Li[p][j]))
            row_h.append(s[0])
            row_l.append(s[1])
        rows_h.append(torch.stack(row_h, dim=-1))
        rows_l.append(torch.stack(row_l, dim=-1))
    return torch.stack(rows_h, dim=-2), torch.stack(rows_l, dim=-2), det[0], det[1]


def _diag_embed(v):
    """(..., D) -> (..., D, D) by multiplying with the identity (off-diagonal
    entries are v * 0), as the JAX package does."""
    return v[..., :, None] * torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)


def df_stage1(cache, sv32, ii, jj):
    """The small df32 matrices of one moment-matching step from a DFCache
    (its ils, ils2 and outs) and the f32 state covariance sv32 (..., ns, ns):
    B^-1 (..., ns, ns, ns) hi and lo, c (..., ns), Q (..., P, ns, ns) hi and
    lo and sqrt det R (..., P) (ii, jj: the pairs' index tensors). A leading
    batch of sv32 broadcasts against the cache's (``per_element``)."""
    ns = sv32.shape[-1]
    device = sv32.device
    cache = per_element(cache)

    # B = diag(ils) sv diag(ils) + I, per model (state block only)
    ils_s_h, ils_s_l = cache.ils_hi[..., :ns], cache.ils_lo[..., :ns]
    outer_h, outer_l = df_mul(ils_s_h[..., :, :, None], ils_s_l[..., :, :, None], ils_s_h[..., :, None, :],
                              ils_s_l[..., :, None, :])
    sv_m = sv32[..., None, :, :]
    B_h, B_l = df_mul_f32(outer_h, outer_l, sv_m)
    eye = torch.eye(ns, dtype=torch.float32, device=device)
    B_h, B_l = df_add_f32(B_h, B_l, eye)
    B_inv_h, B_inv_l, det_B_h, det_B_l = spd_inv_det_df(B_h, B_l)
    c32 = cache.outs / torch.sqrt(det_B_h + det_B_l)  # scales M and V: f32 is enough

    ils2_h, ils2_l = cache.ils2_hi[..., :ns], cache.ils2_lo[..., :ns]
    ss_h, ss_l = df_add(ils2_h[..., ii, :], ils2_l[..., ii, :], ils2_h[..., jj, :], ils2_l[..., jj, :])  # (P, ns)
    d_inv_h, d_inv_l = df_div(torch.ones_like(ss_h), torch.zeros_like(ss_h), ss_h, ss_l)
    # A = sv + diag(d_inv): diagonal entries fold sv_ii into the df pair exactly
    diag_h, diag_l = df_add_f32(_diag_embed(d_inv_h), _diag_embed(d_inv_l), sv_m * eye)
    A_h = torch.where(eye > 0, diag_h, sv_m)
    A_l = torch.where(eye > 0, diag_l, torch.zeros_like(diag_l))
    A_inv_h, A_inv_l, det_A_h, det_A_l = spd_inv_det_df(A_h, A_l)
    # AinvS = A^-1 sv (sv exact f32), unrolled df dots
    cols_h, cols_l = [], []
    for m in range(ns):
        ah, al = df_mul_f32(A_inv_h[..., 0], A_inv_l[..., 0], sv_m[..., 0, m, None])
        for l_ in range(1, ns):
            ph, pl = df_mul_f32(A_inv_h[..., l_], A_inv_l[..., l_], sv_m[..., l_, m, None])
            ah, al = df_add(ah, al, ph, pl)
        cols_h.append(ah)
        cols_l.append(al)
    AinvS_h = torch.stack(cols_h, dim=-1)  # (P, ns, ns)
    AinvS_l = torch.stack(cols_l, dim=-1)
    Qh, Ql = df_mul(d_inv_h[..., :, None], d_inv_l[..., :, None], AinvS_h, AinvS_l)
    Qh, Ql = 0.5 * Qh, 0.5 * Ql  # exact halving
    prod_ss = ss_h[..., 0] + ss_l[..., 0]
    for e in range(1, ns):
        prod_ss = prod_ss * (ss_h[..., e] + ss_l[..., e])
    sqrt_det_R32 = torch.sqrt((det_A_h + det_A_l) * prod_ss)  # divides S_p after the cancellation
    return B_inv_h, B_inv_l, c32, Qh, Ql, sqrt_det_R32


# ---------------------------------------------------------------------------
# the per-point operands (each element's operations in the kernels' order)
# ---------------------------------------------------------------------------


def _model_rows(mu, cache):
    """Per model m and point n: inp (..., N, d), iN (..., ns, N, d), klog
    (..., ns, N) and Xi (..., ns, N, ns), each a df (hi, lo); the sums over
    e run in order. ``cache``: per_element's view."""
    ns, d = cache.ils_hi.shape[-2:]
    inp = df_add_f32(cache.x_hi, cache.x_lo, -mu[..., None, :])
    iN = df_mul(inp[0][..., None, :, :], inp[1][..., None, :, :], cache.ils_hi[..., :, None, :],
                cache.ils_lo[..., :, None, :])
    kh, kl = df_mul(iN[0][..., 0], iN[1][..., 0], iN[0][..., 0], iN[1][..., 0])
    for e in range(1, d):
        kh, kl = df_add(kh, kl, *df_mul(iN[0][..., e], iN[1][..., e], iN[0][..., e], iN[1][..., e]))
    klog = df_add(-0.5 * kh, -0.5 * kl, cache.log_outs_hi[..., :, None].expand_as(kh),
                  cache.log_outs_lo[..., :, None].expand_as(kh))
    xi = df_mul(inp[0][..., None, :, :ns], inp[1][..., None, :, :ns], cache.ils2_hi[..., :, None, :ns],
                cache.ils2_lo[..., :, None, :ns])
    return inp, iN, klog, xi


def _qform(xi_h, xi_l, qh, ql):
    """xq = Xi Q (a list of ns df (..., P, N)) and xs = xq . Xi (df
    (..., P, N)) for Xi (..., P, N, ns) and Q (..., P, ns, ns)."""
    ns = xi_h.shape[-1]
    xq = []
    for j in range(ns):
        acc = df_mul(xi_h[..., 0], xi_l[..., 0], qh[..., :, None, 0, j], ql[..., :, None, 0, j])
        for k in range(1, ns):
            acc = df_add(*acc, *df_mul(xi_h[..., k], xi_l[..., k], qh[..., :, None, k, j], ql[..., :, None, k, j]))
        xq.append(acc)
    xs = df_mul(*xq[0], xi_h[..., 0], xi_l[..., 0])
    for j in range(1, ns):
        xs = df_add(*xs, *df_mul(*xq[j], xi_h[..., j], xi_l[..., j]))
    return xq, xs


def _pair_rows(mu, qh, ql, cache):
    """The E exponent's operands of every pair: a, c (..., P, N) and U, Xj
    (..., P, N, ns) as df, and what the VJP reuses (iN, Xi, xq of both
    sides)."""
    ns = cache.ils_hi.shape[-2]
    ii, jj, _, _ = pair_indices(ns, mu.device)
    inp, iN, klog, xi = _model_rows(mu, cache)
    xi_i = (xi[0][..., ii, :, :], xi[1][..., ii, :, :])
    xi_j = (xi[0][..., jj, :, :], xi[1][..., jj, :, :])
    xq_i, xs_i = _qform(*xi_i, qh, ql)
    xq_j, xs_j = _qform(*xi_j, qh, ql)
    a = df_add(klog[0][..., ii, :], klog[1][..., ii, :], *xs_i)
    c = df_add(klog[0][..., jj, :], klog[1][..., jj, :], *xs_j)
    u = (2.0 * torch.stack([h for h, _ in xq_i], dim=-1), 2.0 * torch.stack([l for _, l in xq_i], dim=-1))
    return dict(a=a, c=c, u=u, xj=xi_j, xi_i=xi_i, xq_i=xq_i, xq_j=xq_j, iN=iN)


def _mean_rows(mu, bh, bl, cache):
    """The mean path per model and point: iN (..., ns, N, d) and t (a list
    of d df (..., ns, N)), the exponent's hi before the cap, q and lb
    (..., ns, N)."""
    ns, d = cache.ils_hi.shape[-2:]
    _, iN, _, _ = _model_rows(mu, cache)
    t = []
    for j in range(ns):
        acc = df_mul(iN[0][..., 0], iN[1][..., 0], bh[..., :, None, 0, j], bl[..., :, None, 0, j])
        for k in range(1, ns):
            acc = df_add(*acc, *df_mul(iN[0][..., k], iN[1][..., k], bh[..., :, None, k, j],
                                       bl[..., :, None, k, j]))
        t.append(acc)
    t += [(iN[0][..., e], iN[1][..., e]) for e in range(ns, d)]
    ex = df_mul(iN[0][..., 0], iN[1][..., 0], *t[0])
    for e in range(1, d):
        ex = df_add(*ex, *df_mul(iN[0][..., e], iN[1][..., e], *t[e]))
    q = df_exp(torch.clamp(-0.5 * ex[0], max=60.0), -0.5 * ex[1])
    lb = df_mul(*q, cache.beta_hi, cache.beta_lo)
    return iN, t, -0.5 * ex[0], q, lb


# ---------------------------------------------------------------------------
# plain twins of the three kernels
# ---------------------------------------------------------------------------


def stage23_plain(mu, bh, bl, qh, ql, cache):
    """What ``df_mm_fwd`` computes (``_mean_part`` and ``_pair_part`` of the
    reference): the raw df partials (M_h, M_l (..., ns), V_h, V_l (..., ns,
    d), Sp_h, Sp_l (..., P), corr_h, corr_l (..., ns)) from mu (..., d),
    B^-1 (..., ns, ns, ns) and Q (..., P, ns, ns) as df. Each element of the
    leading batch is computed by elementwise operations and df_sum trees of
    its own, so it equals the unbatched call bit for bit."""
    cache = per_element(cache)
    ns, d = cache.ils_hi.shape[-2:]
    _, t, _, _, lb = _mean_rows(mu, bh, bl, cache)
    M = df_sum(*lb, axis=-1)
    v = [df_sum(*df_mul(*df_mul(*t[e], cache.ils_hi[..., :, e:e + 1], cache.ils_lo[..., :, e:e + 1]), *lb), axis=-1)
         for e in range(d)]
    V = (torch.stack([h for h, _ in v], dim=-1), torch.stack([l for _, l in v], dim=-1))

    r = _pair_rows(mu, qh, ql, cache)
    ex_h, ex_l = _e_exponent_df(*r["a"], *r["c"], *r["u"], *r["xj"])
    eh, el = df_exp(torch.clamp(ex_h, max=60.0), ex_l)
    ii, jj, dpos, _ = pair_indices(ns, mu.device)
    w = df_mul(eh, el, cache.beta_hi[..., ii, :, None], cache.beta_lo[..., ii, :, None])
    w = df_mul(*w, cache.beta_hi[..., jj, None, :], cache.beta_lo[..., jj, None, :])
    Sp = df_sum(w[0].flatten(-2), w[1].flatten(-2), axis=-1)
    co = df_mul(eh[..., dpos, :, :], el[..., dpos, :, :], cache.iK_hi, cache.iK_lo)
    corr = df_sum(co[0].flatten(-2), co[1].flatten(-2), axis=-1)
    return (*M, *V, *Sp, *corr)


def finish(raw, c32, sqrt_det_r):
    """M (..., ns), V (..., ns, d) and S_p (..., P) in f32 from the raw df
    partials: c scales M and V, corr is subtracted from the diagonal pairs'
    S_p in df, and S_p is divided by sqrt det R after the cancellation.
    Differentiable."""
    M_h, M_l, V_h, V_l, Sp_h, Sp_l, co_h, co_l = raw
    diag = pair_indices(M_h.shape[-1], M_h.device)[2]
    zeros = torch.zeros_like(Sp_h)
    sh, sl = df_add(Sp_h, Sp_l, -zeros.index_copy(-1, diag, co_h), -zeros.index_copy(-1, diag, co_l))
    return c32 * (M_h + M_l), c32[..., :, None] * (V_h + V_l), (sh + sl) / sqrt_det_r


def full_step_plain(mu, sv, cache):
    """What ``df_mm_full`` computes (``_full_step`` of the reference): stage 1,
    stages 2-3 and the finish; M (..., ns), V (..., ns, d) and S_p (..., P)
    in f32, for mu (..., d) and sv (..., ns, ns)."""
    ii, jj, _, _ = pair_indices(cache.ils_hi.shape[-2], mu.device)
    Bh, Bl, c32, Qh, Ql, sdr = df_stage1(cache, sv, ii, jj)
    return finish(stage23_plain(mu, Bh, Bl, Qh, Ql, cache), c32, sdr)


def _mf(x, coef):
    """A df cotangent times an f32 coefficient, as a df."""
    return df_mul_f32(*x, coef)


def _mean_vjp_terms(mu, bh, bl, cache, g_m, g_v):
    """The mean path's VJP at the hi cotangents g_m (..., ns) and g_v (...,
    ns, d): its contributions to the cotangent of inp[..., e], a df (...,
    ns, N) per e, and g_B (..., ns, ns, ns) in f32 (``_mean_part``'s VJP,
    every cotangent a df). ``cache``: per_element's view."""
    ns, d = cache.ils_hi.shape[-2:]
    ils_c = cache.ils_hi + cache.ils_lo
    iN, t, ex_hi, q, lb = _mean_rows(mu, bh, bl, cache)
    iN_c = [iN[0][..., e] + iN[1][..., e] for e in range(d)]
    t_c = [h + l for h, l in t]
    lb_c, q_c = lb[0] + lb[1], q[0] + q[1]
    beta_c = cache.beta_hi + cache.beta_lo
    b_c = bh + bl
    tiL_c = []
    for e in range(d):
        th, tl = df_mul(*t[e], cache.ils_hi[..., :, e:e + 1], cache.ils_lo[..., :, e:e + 1])
        tiL_c.append(th + tl)
    g_lb = (g_m[..., :, None].expand_as(lb_c), torch.zeros_like(lb_c))
    for e in range(d):
        g_lb = df_add(*g_lb, *two_prod(g_v[..., :, e:e + 1].expand_as(lb_c), tiL_c[e]))
    g_t = [_mf(two_prod(g_v[..., :, e:e + 1].expand_as(lb_c), lb_c), ils_c[..., :, e:e + 1]) for e in range(d)]
    g_ex = _mf(_mf(g_lb, beta_c), q_c)
    live = (ex_hi < 60.0).to(torch.float32)
    g_ex = (-0.5 * g_ex[0] * live, -0.5 * g_ex[1] * live)
    g_iN = [_mf(g_ex, t_c[e]) for e in range(d)]
    g_t = [df_add(*g_t[e], *_mf(g_ex, iN_c[e])) for e in range(d)]
    g_b = [[None] * ns for _ in range(ns)]
    for j in range(ns):
        for k in range(ns):
            g_iN[k] = df_add(*g_iN[k], *_mf(g_t[j], b_c[..., :, None, k, j]))
            g_b[k][j] = df_sum(*_mf(g_t[j], iN_c[k]), axis=-1)  # (..., ns)
    for e in range(ns, d):
        g_iN[e] = df_add(*g_iN[e], *g_t[e])
    g_inp = [_mf(g_iN[e], ils_c[..., :, e:e + 1]) for e in range(d)]
    g_B = torch.stack([torch.stack([g_b[k][j][0] + g_b[k][j][1] for j in range(ns)], dim=-1)
                       for k in range(ns)], dim=-2)
    return g_inp, g_B


def _pair_vjp_terms(mu, qh, ql, cache, g_sp, g_corr):
    """The pairs' VJP at the hi cotangents g_sp (..., P) and g_corr (...,
    ns): per e, the row- and column-side contributions to the cotangent of
    inp[..., e] (two df (..., P, N)), and g_Q (..., P, ns, ns) in f32
    (``_pair_part``'s VJP for every pair, every cotangent a df: the
    exponent's cotangent G = E (gs bi bj + gco iK) and its df residuals,
    then the chain rule). ``cache``: per_element's view."""
    ns, d = cache.ils_hi.shape[-2:]
    ils_c = cache.ils_hi + cache.ils_lo
    ils2_c = cache.ils2_hi + cache.ils2_lo
    g_inp = [[] for _ in range(d)]
    r = _pair_rows(mu, qh, ql, cache)
    ii, jj, dpos, _ = pair_indices(ns, mu.device)
    ex_h, ex_l = _e_exponent_df(*r["a"], *r["c"], *r["u"], *r["xj"])
    E = df_exp(torch.clamp(ex_h, max=60.0), ex_l)
    w = df_mul_f32(*df_mul(cache.beta_hi[..., ii, :, None], cache.beta_lo[..., ii, :, None],
                           cache.beta_hi[..., jj, None, :], cache.beta_lo[..., jj, None, :]),
                   g_sp[..., :, None, None])
    gco = torch.zeros_like(g_sp)
    gco[..., dpos] = g_corr
    ik_h = torch.zeros_like(w[0])
    ik_l = torch.zeros_like(w[0])
    ik_h[..., dpos, :, :], ik_l[..., dpos, :, :] = cache.iK_hi, cache.iK_lo
    w = df_add(*w, *df_mul_f32(ik_h, ik_l, gco[..., :, None, None]))
    G = df_mul(*E, *w)
    live = (ex_h < 60.0).to(torch.float32)
    G = (G[0] * live, G[1] * live)
    u_c = r["u"][0] + r["u"][1]
    xj_c = r["xj"][0] + r["xj"][1]
    ra = df_sum(*G, axis=-1)  # (P, N): rows, sums over k
    ru = [df_sum(*_mf(G, xj_c[..., :, None, :, e]), axis=-1) for e in range(ns)]
    cc = df_sum(*G, axis=-2)  # (P, N): columns, sums over n
    cx = [df_sum(*_mf(G, u_c[..., :, :, None, e]), axis=-2) for e in range(ns)]

    q_c = qh + ql
    g_q = [[[] for _ in range(ns)] for _ in range(ns)]
    iN_c = r["iN"][0] + r["iN"][1]  # (ns, N, d)
    for side, (res, res_x, models) in enumerate(((ra, ru, ii), (cc, cx, jj))):
        xi = (r["xi_i"] if side == 0 else r["xj"])
        xi_c = xi[0] + xi[1]  # (P, N, ns)
        xq = r["xq_i"] if side == 0 else r["xq_j"]
        xq_c = [h + l for h, l in xq]
        if side == 0:  # a = klog_i + xs_i, U = 2 xq_i
            g_xq = [df_add(2.0 * res_x[e][0], 2.0 * res_x[e][1], *_mf(res, xi_c[..., e])) for e in range(ns)]
        else:  # c = klog_j + xs_j
            g_xq = [_mf(res, xi_c[..., e]) for e in range(ns)]
        g_xi = []
        for k in range(ns):
            acc = _mf(res, xq_c[k])
            if side == 1:  # Xj = Xi_j
                acc = df_add(*acc, *res_x[k])
            for e in range(ns):
                acc = df_add(*acc, *_mf(g_xq[e], q_c[..., :, None, k, e]))
            g_xi.append(acc)
        for k in range(ns):
            for e in range(ns):
                g_q[k][e].append(_mf(g_xq[e], xi_c[..., k]))
        iN_s = iN_c[..., models, :, :]  # (P, N, d)
        ils_s, ils2_s = ils_c[..., models, :], ils2_c[..., models, :]
        for e in range(d):
            g = _mf(_mf(res, -iN_s[..., e]), ils_s[..., :, e:e + 1])
            if e < ns:
                g = df_add(*g, *_mf(g_xi[e], ils2_s[..., :, e:e + 1]))
            g_inp[e].append(g)
    g_Q = torch.stack([torch.stack([(lambda s: s[0] + s[1])(df_sum(*_cat_pair(g_q[k][e]), axis=-1))
                                    for e in range(ns)], dim=-1) for k in range(ns)], dim=-2)
    return g_inp, g_Q


def stage23_vjp_plain(mu, bh, bl, qh, ql, cache, g_m, g_v, g_sp, g_corr):
    """What ``df_mm_bwd`` computes: the VJP of ``stage23_plain`` at the hi
    cotangents g_m (..., ns), g_v (..., ns, d), g_sp (..., P) and g_corr
    (..., ns), under the reference's derivative rules, every cotangent
    carried as a df (see the module docstring). Returns (g_mu (..., d), g_B
    (..., ns, ns, ns), g_Q (..., P, ns, ns)) in f32: the gradient of each
    B^-1 and Q entry, the same for its hi and lo half."""
    cache = per_element(cache)
    d = cache.ils_hi.shape[-1]
    mean_inp, g_B = _mean_vjp_terms(mu, bh, bl, cache, g_m, g_v)
    pair_inp, g_Q = _pair_vjp_terms(mu, qh, ql, cache, g_sp, g_corr)

    def total(parts):
        h = torch.cat([t[0].flatten(-2) for t in parts], dim=-1)
        l = torch.cat([t[1].flatten(-2) for t in parts], dim=-1)
        return df_sum(h, l, axis=-1)

    g_mu = torch.stack([-(lambda s: s[0] + s[1])(total([mean_inp[e], *pair_inp[e]])) for e in range(d)], dim=-1)
    return g_mu, g_B, g_Q


def stage23_vjp_mean_plain(mu, bh, bl, cache, g_m, g_v):
    """What ``df_mm_bwd_mean`` computes (#10): the mean path's VJP at the hi
    cotangents g_m (ns,) and g_v (ns, d). Returns its contribution to the
    cotangent of inp = x - mu summed over the points, as a df ((d,), (d,)),
    and g_B (ns, ns, ns) in f32."""
    g_inp, g_B = _mean_vjp_terms(mu, bh, bl, per_element(cache), g_m, g_v)
    sums = [df_sum(h.flatten(-2), l.flatten(-2), axis=-1) for h, l in g_inp]
    return (torch.stack([h for h, _ in sums], dim=-1), torch.stack([l for _, l in sums], dim=-1)), g_B


def stage23_vjp_pairs_plain(mu, qh, ql, cache, g_sp, g_corr):
    """What ``df_mm_bwd_pair`` computes (#11, every pair): the VJP of each
    pair k at the hi cotangents g_sp[k] and, on the diagonal pairs,
    g_corr[i]. Returns each pair's contribution to the cotangent of inp
    summed over the points, as a df ((P, d), (P, d)), and g_Q (P, ns, ns)
    in f32."""
    g_inp, g_Q = _pair_vjp_terms(mu, qh, ql, per_element(cache), g_sp, g_corr)
    sums = [df_sum(*_cat_pair(parts), axis=-1) for parts in g_inp]  # per e, (P,)
    return (torch.stack([h for h, _ in sums], dim=-1), torch.stack([l for _, l in sums], dim=-1)), g_Q


def combine_split(mean_inp, pairs_inp):
    """g_mu (d,) from the df contributions of #10 and #11 to the cotangent of
    inp, as the reference's ``core_bwd`` combines them (the mean part, then
    the pairs in pair order), but added in df and collapsed once."""
    h, l = mean_inp
    for k in range(pairs_inp[0].shape[-2]):
        h, l = df_add(h, l, pairs_inp[0][..., k, :], pairs_inp[1][..., k, :])
    return -(h + l)


def _cat_pair(parts):
    """Row- and column-side (..., P, N) df contributions -> (..., P, 2N)."""
    return torch.cat([t[0] for t in parts], dim=-1), torch.cat([t[1] for t in parts], dim=-1)


def abs_terms(mu, bh, bl, qh, ql, cache):
    """The sum of the absolute values of the terms of each raw output of
    ``stage23_plain``, in f64 from the collapsed operands: M (ns,), V (ns, d),
    S_p (P,) and corr (ns,). A compensated sum's error is bounded by a small
    multiple of eps32^2 times this, whatever the order of summation."""
    ns, d = cache.ils_hi.shape
    f64 = torch.float64

    def v(x):
        return x[0].to(f64) + x[1].to(f64)

    _, t, _, _, lb = _mean_rows(mu, bh, bl, cache)
    ils = cache.ils_hi.to(f64) + cache.ils_lo.to(f64)
    lb64 = v(lb).abs()
    m_abs = lb64.sum(-1)
    v_abs = torch.stack([(v(t[e]) * ils[:, e:e + 1]).abs().mul(lb64).sum(-1) for e in range(d)], dim=-1)
    r = _pair_rows(mu, qh, ql, cache)
    ii, jj, _, diag = pair_indices(ns, mu.device)
    (sp_abs, co_abs), _ = _df_cov_abs(*r["a"], *r["c"], *r["u"], *r["xj"], cache.beta_hi[ii], cache.beta_lo[ii],
                                      cache.beta_hi[jj], cache.beta_lo[jj], cache.iK_hi, cache.iK_lo, diag)
    return m_abs, v_abs, sp_abs, co_abs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_CACHE_FIELDS = ("x_hi", "x_lo", "ils_hi", "ils_lo", "ils2_hi", "ils2_lo", "log_outs_hi", "log_outs_lo",
                 "beta_hi", "beta_lo", "iK_hi", "iK_lo")


class _PerElement:
    """The fields of caches stacked on a leading axis, each gathered by the
    cache's ``index`` when first read: element b's row is cache index[b]'s.
    An object with no index, as a cache shared by every element."""

    index = None

    def __init__(self, cache):
        self._cache = cache
        self._idx = cache.index.long()

    def __getattr__(self, name):
        value = getattr(self._cache, name)[self._idx]
        setattr(self, name, value)
        return value


def per_element(cache):
    """The view of a DFCache that the plain twins broadcast against: the
    cache itself when it has no ``index`` (one cache shared by every element
    of a batch, its fields without a batch axis), else its fields gathered
    per element (``_PerElement``)."""
    return cache if getattr(cache, "index", None) is None else _PerElement(cache)


def _check(name: str, cache, batch: int, **tensors) -> Tuple[int, int, int, int]:
    """Device, dtype, contiguity and shapes of the operands, each per-element
    one with a leading batch axis and the cache's fields with one of C
    caches when it has an index (batch,) of int32; (N, ns, d, the index's
    pointer or None)."""
    index = getattr(cache, "index", None)
    lead = () if index is None else tuple(cache.x_hi.shape[:1])
    n, d = cache.x_hi.shape[-2:]
    ns = cache.ils_hi.shape[-2]
    p = ns * (ns + 1) // 2
    shapes = dict(x_hi=(n, d), x_lo=(n, d), ils_hi=(ns, d), ils_lo=(ns, d), ils2_hi=(ns, d), ils2_lo=(ns, d),
                  log_outs_hi=(ns,), log_outs_lo=(ns,), outs=(ns,), beta_hi=(ns, n), beta_lo=(ns, n),
                  iK_hi=(ns, n, n), iK_lo=(ns, n, n))
    shapes = {k: lead + v for k, v in shapes.items()}
    shapes.update({k: (batch,) + v for k, v in dict(
        mu=(d,), sv=(ns, ns), bh=(ns, ns, ns), bl=(ns, ns, ns), qh=(p, ns, ns), ql=(p, ns, ns), g_m=(ns,),
        g_v=(ns, d), g_sp=(p,), g_corr=(ns,)).items()})
    named = {f: getattr(cache, f) for f in _CACHE_FIELDS + ("outs",)}
    named.update(tensors)
    device = tensors["mu"].device
    for arg, t in named.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes float32 (hi, lo) halves only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shapes[arg]}")
    if not (1 <= ns <= MAX_NS and ns <= d <= MAX_D and n >= 1):
        raise NotImplementedError(f"{name}: the kernels take 1 <= ns <= {MAX_NS} and ns <= d <= {MAX_D}, "
                                  f"got ns={ns}, d={d}, N={n}")
    if not 1 <= batch <= MAX_BATCH:
        raise NotImplementedError(f"{name}: the kernels take a batch of 1 to {MAX_BATCH}, got {batch}")
    if index is None:
        return n, ns, d, None
    if index.device != device or index.dtype != torch.int32 or tuple(index.shape) != (batch,):
        raise ValueError(f"{name}: the cache index is {index.dtype} {tuple(index.shape)} on {index.device}, "
                         f"expected int32 ({batch},) on {device}")
    return n, ns, d, index.contiguous().data_ptr()


def _batched(x, k: int):
    """x (..., *trailing) with k trailing dims as (B, *trailing), contiguous."""
    return x.reshape((-1,) + tuple(x.shape[x.dim() - k:])).contiguous()


def _cache_ptrs(cache):
    return [getattr(cache, f).data_ptr() for f in _CACHE_FIELDS]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# the grid of the whole-step forward (csrc/df_mm_fwd.cu): warps of a pair
# block (kWarps), the tile's columns (kTile), resident blocks per SM it is
# built for (kBlocksPerSm, its launch bounds) and the most rows per warp
FWD_WARPS, FWD_COLS, FWD_BLOCKS_PER_SM, FWD_MAX_ROWS_PER_WARP = 8, 32, 3, 4


def fwd_launch_plan(n: int, ns: int, sms: int) -> dict:
    """The grid of #12 and #8 at N on a card with ``sms`` SMs. A pair block
    owns a tile of FWD_WARPS rpw rows by FWD_COLS columns of one pair's (N, N)
    slab (block b: pair b // (row_tiles col_tiles), row tile
    (b // col_tiles) % row_tiles, column tile b % col_tiles; warp w the
    tile's rows w + FWD_WARPS s, s < rpw, a lane a column); then a mean block
    per FWD_COLS stored points (warp m model m, a lane a point). rpw is the
    one of 1..FWD_MAX_ROWS_PER_WARP with the least waves (of
    FWD_BLOCKS_PER_SM blocks per SM) times rpw, the larger on a tie (fewer
    partials to sum)."""
    p = ns * (ns + 1) // 2
    col_tiles = -(-n // FWD_COLS)
    best = None
    for rpw in range(1, FWD_MAX_ROWS_PER_WARP + 1):
        row_tiles = -(-n // (FWD_WARPS * rpw))
        pair_blocks = p * row_tiles * col_tiles
        cost = -(-(pair_blocks + col_tiles) // (sms * FWD_BLOCKS_PER_SM)) * rpw
        if best is None or cost <= best[0]:
            best = (cost, dict(rows_per_warp=rpw, row_tiles=row_tiles, col_tiles=col_tiles,
                               pair_blocks=pair_blocks, mean_blocks=col_tiles))
    return best[1]


def fwd_buffer_shapes(n: int, ns: int, d: int, batch: int, sms: int) -> dict:
    """The buffers of #12 and #8 on a card with ``sms`` SMs, each with the
    batch axis in front (the kernels place element b's after element b -
    1's, csrc/df_mm_fwd.cu): the blocks' partials, pair [2][P tiles][2] (S_p,
    corr) and mean [2][ns][1 + d][mean blocks], #12's scale (c_m, sqrt det
    R_p) and out (M, V, S_p), #8's out [2][M, V, S_p, corr]. The plan is one
    element's, whatever the batch."""
    plan = fwd_launch_plan(n, ns, sms)
    p = ns * (ns + 1) // 2
    return dict(rows_per_warp=plan["rows_per_warp"], pair_part=(batch, 2, plan["pair_blocks"], 2),
                mean_part=(batch, 2, ns, 1 + d, plan["mean_blocks"]), scale=(batch, ns + p),
                full_out=(batch, ns + ns * d + p), fwd_out=(batch, 2, ns + ns * d + p + ns))


def bwd_buffer_shapes(n: int, ns: int, d: int, batch: int) -> dict:
    """#9's buffers, each with the batch axis in front as ``fwd_buffer_shapes``:
    the mean path's partials [2][ns][tiles][d + ns^2], the units' [2][2 P
    tiles][d + ns^2] and out (g_mu, g_B, g_Q)."""
    nt, p = -(-n // BWD_TILE), ns * (ns + 1) // 2
    return dict(mean_part=(batch, 2, ns, nt, d + ns * ns), unit_part=(batch, 2, 2 * p * nt, d + ns * ns),
                out=(batch, d + ns ** 3 + p * ns * ns))


def _fwd_scratch(n, ns, d, batch, device):
    """#12's and #8's rows per warp and the blocks' partial buffers."""
    shapes = fwd_buffer_shapes(n, ns, d, batch, _build.sm_count(device))
    pair_part = torch.empty(shapes["pair_part"], dtype=torch.float32, device=device)
    mean_part = torch.empty(shapes["mean_part"], dtype=torch.float32, device=device)
    return shapes["rows_per_warp"], pair_part, mean_part


def full_launch_info(n: int, ns: int) -> dict:
    """#12's launch at N on the current card (``_build.launch_info``), with
    the rows per warp of its tiles."""
    rpw = fwd_launch_plan(n, ns, _build.sm_count(torch.device("cuda")))["rows_per_warp"]
    return _build.launch_info("gpmpc_df_mm_full_info", n, ns, rpw, extra=("rows_per_warp",))


def full_step_fwd(mu, sv, cache):
    """M (..., ns), V (..., ns, d), S_p (..., P) of one moment-matching step
    (#12) for mu (..., d) and sv (..., ns, ns): one launch for every element
    of the leading batch, against the cache's index (``per_element``). A CPU
    tensor takes the plain twin; a CUDA tensor launches the kernel or raises."""
    if mu.device.type == "cpu":
        return full_step_plain(mu, sv, cache)
    lead = mu.shape[:-1]
    mu, sv = _batched(mu, 1), _batched(sv, 2)
    batch = mu.shape[0]
    n, ns, d, cidx = _check("df_mm_full", cache, batch, mu=mu, sv=sv)
    lib = _build.load()
    p = ns * (ns + 1) // 2
    rpw, pair_part, mean_part = _fwd_scratch(n, ns, d, batch, mu.device)
    scale = torch.empty((batch, ns + p), dtype=torch.float32, device=mu.device)
    out = torch.empty((batch, ns + ns * d + p), dtype=torch.float32, device=mu.device)
    rc = lib.gpmpc_df_mm_full_f32(mu.data_ptr(), sv.data_ptr(), *_cache_ptrs(cache), cache.outs.data_ptr(),
                                  pair_part.data_ptr(), mean_part.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                  n, ns, d, rpw, cidx, batch, _stream(mu))
    _build.check(rc, "df_mm_full")
    LAUNCHES["df_mm_full"] += 1
    return (out[:, :ns].reshape(lead + (ns,)), out[:, ns:ns + ns * d].reshape(lead + (ns, d)),
            out[:, ns + ns * d:].reshape(lead + (p,)))


def stage23_fwd(mu, bh, bl, qh, ql, cache):
    """The raw df partials of ``stage23_plain`` (#8), one launch for the
    leading batch. A CPU tensor takes the plain twin; a CUDA tensor launches
    the kernel or raises."""
    if mu.device.type == "cpu":
        return stage23_plain(mu, bh, bl, qh, ql, cache)
    lead = mu.shape[:-1]
    mu, bh, bl, qh, ql = _batched(mu, 1), *(_batched(t, 3) for t in (bh, bl, qh, ql))
    batch = mu.shape[0]
    n, ns, d, cidx = _check("df_mm_fwd", cache, batch, mu=mu, bh=bh, bl=bl, qh=qh, ql=ql)
    lib = _build.load()
    p = ns * (ns + 1) // 2
    rpw, pair_part, mean_part = _fwd_scratch(n, ns, d, batch, mu.device)
    out = torch.empty((batch, 2, ns + ns * d + p + ns), dtype=torch.float32, device=mu.device)
    rc = lib.gpmpc_df_mm_fwd_f32(mu.data_ptr(), bh.data_ptr(), bl.data_ptr(), qh.data_ptr(), ql.data_ptr(),
                                 *_cache_ptrs(cache), pair_part.data_ptr(), mean_part.data_ptr(), out.data_ptr(),
                                 n, ns, d, rpw, cidx, batch, _stream(mu))
    _build.check(rc, "df_mm_fwd")
    LAUNCHES["df_mm_fwd"] += 1
    o = [0, ns, ns + ns * d, ns + ns * d + p, ns + ns * d + p + ns]
    M, V, Sp, corr = (out[:, :, o[i]:o[i + 1]] for i in range(4))
    return (M[:, 0].reshape(lead + (ns,)), M[:, 1].reshape(lead + (ns,)), V[:, 0].reshape(lead + (ns, d)),
            V[:, 1].reshape(lead + (ns, d)), Sp[:, 0].reshape(lead + (p,)), Sp[:, 1].reshape(lead + (p,)),
            corr[:, 0].reshape(lead + (ns,)), corr[:, 1].reshape(lead + (ns,)))


def stage23_bwd(mu, bh, bl, qh, ql, cache, g_m, g_v, g_sp, g_corr):
    """(g_mu (..., d), g_B (..., ns, ns, ns), g_Q (..., P, ns, ns)): the VJP
    of stages 2-3 at the hi cotangents, by the reference's rule
    (``SINGLE_BWD_MAX_N``): up to N = 128 one #9 launch
    (``stage23_bwd_all``); past it #10 and then #11, whose last launch adds
    #10's df contribution and its own as ``combine_split`` does and writes
    g_mu; every element of the leading batch in the same launches, against
    the cache's index when it has one (``per_element``). A CPU tensor takes
    the plain twins and ``combine_split``."""
    if cache.x_hi.shape[-2] <= SINGLE_BWD_MAX_N:
        return stage23_bwd_all(mu, bh, bl, qh, ql, cache, g_m, g_v, g_sp, g_corr)
    if mu.device.type == "cpu":
        mean_inp, g_B = stage23_vjp_mean_plain(mu, bh, bl, cache, g_m, g_v)
        pairs_inp, g_Q = stage23_vjp_pairs_plain(mu, qh, ql, cache, g_sp, g_corr)
        return combine_split(mean_inp, pairs_inp), g_B, g_Q
    lead = mu.shape[:-1]
    mu, g_m, g_sp, g_corr = (_batched(t, 1) for t in (mu, g_m, g_sp, g_corr))
    g_v = _batched(g_v, 2)
    bh, bl, qh, ql = (_batched(t, 3) for t in (bh, bl, qh, ql))
    batch = mu.shape[0]
    n, ns, d, cidx = _check("df_mm_bwd_mean + df_mm_bwd_pair", cache, batch, mu=mu, bh=bh, bl=bl, qh=qh, ql=ql,
                            g_m=g_m, g_v=g_v, g_sp=g_sp, g_corr=g_corr)
    ct = _ct_block(batch, ns, d, mu.device, g_m, g_v, g_sp, g_corr)
    # every buffer of both launches exists before the first: #11's first
    # launch may run beside #10, so no scratch of one may reuse the other's
    mean = _MeanLaunch(mu, n, ns, d, batch)
    pairs = _PairLaunch(mu, n, ns, d, batch)
    mean.launch(mu, bh, bl, cache, ct, cidx)
    pairs.launch(mu, qh, ql, cache, ct, cidx, mean_out=mean.out)
    return (pairs.g_mu().reshape(lead + (d,)), mean.g_B().reshape(lead + (ns, ns, ns)),
            pairs.g_Q().reshape(lead + pairs.g_Q().shape[1:]))


def stage23_bwd_all(mu, bh, bl, qh, ql, cache, g_m, g_v, g_sp, g_corr):
    """The whole VJP of ``stage23_vjp_plain`` in one launch (#9), at any N,
    for every element of the leading batch. A CPU tensor takes the plain
    twin; a CUDA tensor launches the kernel or raises."""
    if mu.device.type == "cpu":
        return stage23_vjp_plain(mu, bh, bl, qh, ql, cache, g_m, g_v, g_sp, g_corr)
    lead = mu.shape[:-1]
    mu, g_m, g_sp, g_corr = (_batched(t, 1) for t in (mu, g_m, g_sp, g_corr))
    g_v = _batched(g_v, 2)
    bh, bl, qh, ql = (_batched(t, 3) for t in (bh, bl, qh, ql))
    batch = mu.shape[0]
    n, ns, d, cidx = _check("df_mm_bwd", cache, batch, mu=mu, bh=bh, bl=bl, qh=qh, ql=ql, g_m=g_m, g_v=g_v,
                            g_sp=g_sp, g_corr=g_corr)
    lib = _build.load()
    if lib.gpmpc_df_mm_tile() != BWD_TILE:
        raise RuntimeError(f"df_mm_bwd: the kernels' tile is {lib.gpmpc_df_mm_tile()}, the wrapper's {BWD_TILE}")
    p = ns * (ns + 1) // 2
    dev = mu.device
    shapes = bwd_buffer_shapes(n, ns, d, batch)
    mean_part, unit_part, out = (torch.empty(shapes[k], dtype=torch.float32, device=dev)
                                 for k in ("mean_part", "unit_part", "out"))
    rc = lib.gpmpc_df_mm_bwd_f32(mu.data_ptr(), bh.data_ptr(), bl.data_ptr(), qh.data_ptr(), ql.data_ptr(),
                                 *_cache_ptrs(cache), g_m.data_ptr(), g_v.data_ptr(), g_sp.data_ptr(),
                                 g_corr.data_ptr(), mean_part.data_ptr(), unit_part.data_ptr(), out.data_ptr(), n, ns,
                                 d, cidx, batch, _stream(mu))
    _build.check(rc, "df_mm_bwd")
    LAUNCHES["df_mm_bwd"] += 1
    return (out[:, :d].reshape(lead + (d,)), out[:, d:d + ns ** 3].reshape(lead + (ns, ns, ns)),
            out[:, d + ns ** 3:].reshape(lead + (p, ns, ns)))


def bwd_launch_info(n: int, ns: int) -> dict:
    """#9's launch at N on the current card (``_build.launch_info``)."""
    return _build.launch_info("gpmpc_df_mm_bwd_info", n, ns)


@functools.lru_cache(maxsize=None)
def _zeros(k: int, device: torch.device) -> torch.Tensor:
    """k f32 zeros on device, made once (never written)."""
    return torch.zeros(k, dtype=torch.float32, device=device)


def _ct_block(batch, ns, d, device, g_m=None, g_v=None, g_sp=None, g_corr=None):
    """#10's and #11's cotangent block g_M (B, ns), g_V (B, ns, d), g_S_p (B,
    P), g_corr (B, ns) (one cat, csrc/df_mm_bwd.cuh cot_block), zeros where a
    launch reads none."""
    parts = [g.reshape(-1) if g is not None else _zeros(batch * k, device)
             for g, k in ((g_m, ns), (g_v, ns * d), (g_sp, ns * (ns + 1) // 2), (g_corr, ns))]
    return torch.cat(parts)


# #10's and #11's plans (csrc/df_mm_split.cu mean_plan, pair_plan): the 32-point
# tiles, the most blocks of #10's one cluster and warps of each, the most
# units of a block of #11's chain-rule launch (1 + ns warps each)
BWD_TILE, MEAN_MAX_CLUSTER, MEAN_MAX_WARPS, PAIR_UNIT_MAX_UNITS = 32, 16, 8, 2


def mean_launch_plan(n: int, ns: int, sms: int) -> dict:
    """#10's grid at N on a card with ``sms`` SMs: one cluster of ``cluster``
    blocks of ``warps`` warps. Block r takes the tiles r, r + cluster, ... of
    every model; its item i (a warp each, warp w the items w, w + warps, ...)
    is model i % ns of tile r + cluster (i // ns), a lane a stored point."""
    tiles = -(-n // BWD_TILE)
    cluster = min(MEAN_MAX_CLUSTER, tiles, sms)
    return dict(tiles=tiles, cluster=cluster, warps=min(MEAN_MAX_WARPS, ns * -(-tiles // cluster)))


def pair_launch_plan(n: int, ns: int, sms: int) -> dict:
    """#11's grids at N on a card with ``sms`` SMs: P tiles^2 pair blocks
    (block b: pair b // tiles^2, row tile (b // tiles) % tiles, column tile
    b % tiles), then the 2 P tiles units of the chain rule (unit u = (side P
    + pair) tiles + chunk, the 32 points of one side of a pair), 1 + ns warps
    each (warp w of a block: unit block (unit_warps // (1 + ns)) + w // (1 +
    ns), its residual w % (1 + ns)), enough units to a block to spread them
    over the SMs."""
    p = ns * (ns + 1) // 2
    tiles = -(-n // BWD_TILE)
    units = 2 * p * tiles
    per = min(PAIR_UNIT_MAX_UNITS, max(1, -(-units // sms)))
    return dict(tiles=tiles, tile_blocks=p * tiles * tiles, units=units, unit_warps=per * (1 + ns),
                unit_blocks=-(-units // per))


def split_buffer_shapes(n: int, ns: int, d: int, batch: int) -> dict:
    """#10's and #11's buffers, each with the batch axis in front as
    ``fwd_buffer_shapes`` (element b's after element b - 1's,
    csrc/df_mm_split.cu): #10's items' partials [2][ns][tiles][d + ns^2] and
    out (g_inp hi, lo (d), g_B); #11's tiles' row and column partials
    [2][P][1 + ns][tiles][N], the units' sums [2][2 P tiles][d + ns^2] and
    out (g_inp hi, lo (P, d), g_Q, g_mu (d)). The plan is one element's."""
    nt, p = -(-n // BWD_TILE), ns * (ns + 1) // 2
    return dict(mean_part=(batch, 2, ns, nt, d + ns * ns), mean_out=(batch, 2 * d + ns ** 3),
                row_part=(batch, 2, p, 1 + ns, nt, n), col_part=(batch, 2, p, 1 + ns, nt, n),
                unit_part=(batch, 2, 2 * p * nt, d + ns * ns), pair_out=(batch, 2 * p * d + p * ns * ns + d))


class _MeanLaunch:
    """#10's buffers for a batch: the items' partials and out (g_inp hi, lo
    (d), g_B) per element."""

    def __init__(self, mu, n, ns, d, batch=1):
        shapes = split_buffer_shapes(n, ns, d, batch)
        self.ns, self.d, self.batch = ns, d, batch
        self.mean_part = torch.empty(shapes["mean_part"], dtype=torch.float32, device=mu.device)
        self.out = torch.empty(shapes["mean_out"], dtype=torch.float32, device=mu.device)

    def launch(self, mu, bh, bl, cache, ct, cidx=None):
        n, d = cache.x_hi.shape[-2:]
        rc = _build.load().gpmpc_df_mm_bwd_mean_f32(
            mu.data_ptr(), bh.data_ptr(), bl.data_ptr(), *_cache_ptrs(cache), ct.data_ptr(),
            self.mean_part.data_ptr(), self.out.data_ptr(), n, self.ns, d, cidx, self.batch, _stream(mu))
        _build.check(rc, "df_mm_bwd_mean")
        LAUNCHES["df_mm_bwd_mean"] += 1

    def g_inp(self):
        return self.out[:, :self.d], self.out[:, self.d:2 * self.d]

    def g_B(self):
        return self.out[:, 2 * self.d:].view(self.batch, self.ns, self.ns, self.ns)


class _PairLaunch:
    """#11's buffers for a batch: the tiles' row and column partials, the
    units' sums and out (g_inp hi, lo (P, d), g_Q, then g_mu (d) when given
    #10's out) per element."""

    def __init__(self, mu, n, ns, d, batch=1):
        shapes = split_buffer_shapes(n, ns, d, batch)
        self.p, self.ns, self.d, self.batch = ns * (ns + 1) // 2, ns, d, batch
        self.row_part, self.col_part, self.unit_part, self.out = (
            torch.empty(shapes[k], dtype=torch.float32, device=mu.device)
            for k in ("row_part", "col_part", "unit_part", "pair_out"))

    def launch(self, mu, qh, ql, cache, ct, cidx=None, mean_out=None):
        n, d = cache.x_hi.shape[-2:]
        rc = _build.load().gpmpc_df_mm_bwd_pair_f32(
            mu.data_ptr(), qh.data_ptr(), ql.data_ptr(), *_cache_ptrs(cache), ct.data_ptr(),
            None if mean_out is None else mean_out.data_ptr(), self.row_part.data_ptr(), self.col_part.data_ptr(),
            self.unit_part.data_ptr(), self.out.data_ptr(), n, self.ns, d, cidx, self.batch, _stream(mu))
        _build.check(rc, "df_mm_bwd_pair")
        LAUNCHES["df_mm_bwd_pair"] += 1

    def g_inp(self):
        pd = self.p * self.d
        return (self.out[:, :pd].view(self.batch, self.p, self.d),
                self.out[:, pd:2 * pd].view(self.batch, self.p, self.d))

    def g_Q(self):
        pd = self.p * self.d
        return self.out[:, 2 * pd:2 * pd + self.p * self.ns * self.ns].view(self.batch, self.p, self.ns, self.ns)

    def g_mu(self):
        return self.out[:, 2 * self.p * self.d + self.p * self.ns * self.ns:]


def stage23_bwd_mean(mu, bh, bl, cache, g_m, g_v):
    """The mean path's VJP (#10) as in ``stage23_vjp_mean_plain``, one launch
    for every element of the leading batch. A CPU tensor takes the plain
    twin; a CUDA tensor launches the kernel or raises."""
    if mu.device.type == "cpu":
        return stage23_vjp_mean_plain(mu, bh, bl, cache, g_m, g_v)
    lead = mu.shape[:-1]
    mu, g_m, g_v, bh, bl = _batched(mu, 1), _batched(g_m, 1), _batched(g_v, 2), _batched(bh, 3), _batched(bl, 3)
    batch = mu.shape[0]
    n, ns, d, cidx = _check("df_mm_bwd_mean", cache, batch, mu=mu, bh=bh, bl=bl, g_m=g_m, g_v=g_v)
    mean = _MeanLaunch(mu, n, ns, d, batch)
    mean.launch(mu, bh, bl, cache, _ct_block(batch, ns, d, mu.device, g_m=g_m, g_v=g_v), cidx)
    h, l = mean.g_inp()
    return (h.reshape(lead + (d,)), l.reshape(lead + (d,))), mean.g_B().reshape(lead + (ns, ns, ns))


def stage23_bwd_pairs(mu, qh, ql, cache, g_sp, g_corr):
    """Every pair's VJP (#11; the pair is a grid axis of one launch, where the
    reference launches once per pair) as in ``stage23_vjp_pairs_plain``, one
    launch for every element of the leading batch. A CPU tensor takes the
    plain twin; a CUDA tensor launches the kernel or raises."""
    if mu.device.type == "cpu":
        return stage23_vjp_pairs_plain(mu, qh, ql, cache, g_sp, g_corr)
    lead = mu.shape[:-1]
    mu, g_sp, g_corr, qh, ql = _batched(mu, 1), _batched(g_sp, 1), _batched(g_corr, 1), _batched(qh, 3), _batched(ql, 3)
    batch = mu.shape[0]
    n, ns, d, cidx = _check("df_mm_bwd_pair", cache, batch, mu=mu, qh=qh, ql=ql, g_sp=g_sp, g_corr=g_corr)
    pairs = _PairLaunch(mu, n, ns, d, batch)
    pairs.launch(mu, qh, ql, cache, _ct_block(batch, ns, d, mu.device, g_sp=g_sp, g_corr=g_corr), cidx)
    (h, l), g_q = pairs.g_inp(), pairs.g_Q()
    p = pairs.p
    return (h.reshape(lead + (p, d)), l.reshape(lead + (p, d))), g_q.reshape(lead + (p, ns, ns))


def mean_launch_info(n: int, ns: int, d: int) -> dict:
    """#10's launch at N on the current card (``_build.launch_info``; grid is
    its one cluster)."""
    return _build.launch_info("gpmpc_df_mm_bwd_mean_info", n, ns, d)


def pair_launch_info(n: int, ns: int) -> dict:
    """#11's pair-block launch at N on the current card (``_build.launch_info``),
    with the chain-rule launch's registers, warps per block and blocks."""
    return _build.launch_info("gpmpc_df_mm_bwd_pair_info", n, ns,
                              extra=("unit_registers", "unit_warps", "unit_blocks"))


# ---------------------------------------------------------------------------
# autograd composites
# ---------------------------------------------------------------------------


class Stage23(torch.autograd.Function):
    """Stages 2-3 as raw df partials: forward #8, backward ``stage23_bwd``
    (#9, or #10 and #11 past N = 128) with the hi cotangents only (each raw output is a df reduction whose tangent is
    (dv, 0), so the lo cotangent carries nothing). B^-1 and Q get the same
    gradient on both halves; the cache gets none."""

    @staticmethod
    def forward(ctx, mu, bh, bl, qh, ql, cache):
        ctx.cache = cache
        ctx.save_for_backward(mu, bh, bl, qh, ql)
        return stage23_fwd(mu, bh, bl, qh, ql, cache)

    @staticmethod
    def backward(ctx, *cts):
        mu, bh, bl, qh, ql = ctx.saved_tensors
        ns, d = ctx.cache.ils_hi.shape[-2:]
        p = qh.shape[-3]
        lead = tuple(mu.shape[:-1])
        shapes = ((ns,), (ns, d), (p,), (ns,))
        hi = [torch.zeros(lead + s, dtype=mu.dtype, device=mu.device) if g is None else g
              for g, s in zip(cts[0::2], shapes)]
        g_mu, g_b, g_q = stage23_bwd(mu, bh, bl, qh, ql, ctx.cache, *hi)
        return g_mu, g_b, g_b, g_q, g_q, None


def split_path(mu, sv, cache):
    """The step by the split path, differentiable in (mu, sv): df stage 1
    (PyTorch ops), ``Stage23`` and the finish (``_reference_path``)."""
    ii, jj, _, _ = pair_indices(cache.ils_hi.shape[-2], mu.device)
    Bh, Bl, c32, Qh, Ql, sdr = df_stage1(cache, sv, ii, jj)
    return finish(Stage23.apply(mu, Bh, Bl, Qh, Ql, cache), c32, sdr)


class FullStep(torch.autograd.Function):
    """The whole step: forward #12; backward by autograd of ``split_path``
    with respect to (mu, sv), which launches #8 and #9 (#10 and #11 past
    N = 128; the reference's ``_build_full.core``)."""

    @staticmethod
    def forward(ctx, mu, sv, cache):
        ctx.cache = cache
        ctx.save_for_backward(mu, sv)
        return full_step_fwd(mu, sv, cache)

    @staticmethod
    def backward(ctx, g_m, g_v, g_sp):
        mu, sv = ctx.saved_tensors
        with torch.enable_grad():
            leaves = (mu.detach().requires_grad_(True), sv.detach().requires_grad_(True))
            outs = split_path(*leaves, ctx.cache)
            pairs = [(o, g) for o, g in zip(outs, (g_m, g_v, g_sp)) if g is not None]
            g_mu, g_sv = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                             allow_unused=True)
        return g_mu, g_sv, None


def full_step(mu, sv, cache):
    """M (..., ns), V (..., ns, d), S_p (..., P) of one moment-matching step
    in df32, differentiable in mu (..., d) and sv (..., ns, ns): every
    element of the leading batch in one launch of each kernel, against the
    cache's index when it has one (``per_element``)."""
    return FullStep.apply(mu, sv, cache)

"""Batched Gaussian-process dynamics model: the planning step's GP math.

Port of the parts of ``gpmpc_tpu/models/gp.py`` that one steady-state
planning step runs: hyperparameter boxes, the masked Cholesky factorization
(with its padding invariant), the rank-1 append, PILCO moment matching and
the horizon rollout, in f32/f64 and in mixed mode (an f64 master split into
a double-float32 cache, ``DFCache``, rolled out by ``moment_match_df``), and
the exact marginal log likelihood with its hyperparameter training
(``negative_mll``, ``train_hyperparams``).
One stacked model family with a leading Ns axis; the stored points live in a
fixed-capacity padded buffer with an active mask:

* Gram rows/cols of inactive points are zeroed and their diagonal set to 1,
  so ``K + diag(noise)`` is ``[K_active + sigma^2 I, 0; 0, I]``;
* targets of inactive points are zero, so ``beta`` is zero on padding;
* ``iK`` is zero outside the active block.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..ops.df32 import df_add, df_add_f32, df_exp, df_mul, df_sum, split_f64
from ..ops.df_mm import df_stage1 as _df_stage1
from ..ops.df_mm import pair_indices, per_element
from ..ops.lanewise import lanewise


class GPBounds(NamedTuple):
    """Interval boxes of the hyperparameters (constrained space): lengthscale
    bounds (Ns, D); outputscale and noise-variance bounds (Ns,)."""

    min_lengthscale: torch.Tensor
    max_lengthscale: torch.Tensor
    min_outputscale: torch.Tensor
    max_outputscale: torch.Tensor
    min_noise: torch.Tensor
    max_noise: torch.Tensor


class GPParams(NamedTuple):
    """Raw (unconstrained) hyperparameters, one stacked row per state dim."""

    raw_lengthscales: torch.Tensor  # (Ns, D)
    raw_outputscale: torch.Tensor  # (Ns,)
    raw_noise: torch.Tensor  # (Ns,)


class FactorizationCache(NamedTuple):
    """Everything inference needs that depends only on memory and params."""

    x_mem: torch.Tensor  # (N, D) padded memory inputs
    mask: torch.Tensor  # (N,) bool active-point mask
    iK: torch.Tensor  # (Ns, N, N), zero outside the active block
    beta: torch.Tensor  # (Ns, N), zero on padding
    lengthscales: torch.Tensor  # (Ns, D) constrained
    outputscales: torch.Tensor  # (Ns,) constrained
    L: torch.Tensor  # (Ns, N, N) lower Cholesky of K + sigma^2 I (identity on padding)
    noises: torch.Tensor  # (Ns,) constrained noise variances
    y_mem: torch.Tensor  # (N, Ns) padded targets, zero on padding
    # None: one cache, shared by every element of a batched rollout; else
    # (B,) int32: the fields are C caches stacked on a leading axis and
    # element b rolls out on cache index[b] (``with_index``)
    index: Optional[torch.Tensor] = None


def constrain(raw, lo, hi):
    """raw -> lower + (upper - lower) * sigmoid(raw)."""
    return lo + (hi - lo) * lanewise(torch.sigmoid, raw)


def unconstrain(value, lo, hi):
    """constrained -> raw; clips slightly inside the box for finiteness."""
    frac = torch.clamp((value - lo) / (hi - lo), 1e-12, 1.0 - 1e-12)
    return lanewise(torch.log, frac) - lanewise(torch.log1p, -frac)


def params_from_constrained(lengthscales, outputscale, noise, bounds: GPBounds) -> GPParams:
    return GPParams(
        raw_lengthscales=unconstrain(lengthscales, bounds.min_lengthscale, bounds.max_lengthscale),
        raw_outputscale=unconstrain(outputscale, bounds.min_outputscale, bounds.max_outputscale),
        raw_noise=unconstrain(noise, bounds.min_noise, bounds.max_noise),
    )


def constrained_params(params: GPParams, bounds: GPBounds):
    """(lengthscales (Ns, D), outputscale (Ns,), noise (Ns,))."""
    return (
        constrain(params.raw_lengthscales, bounds.min_lengthscale, bounds.max_lengthscale),
        constrain(params.raw_outputscale, bounds.min_outputscale, bounds.max_outputscale),
        constrain(params.raw_noise, bounds.min_noise, bounds.max_noise),
    )


def _gram(lengthscales, outputscales, x):
    """The Gram matrix by the JAX package's dtype rule: its Pallas kernel
    takes f32 only and f64 goes to XLA, so here f64 takes the plain form on
    every device and f32 goes to ``ops.gram`` (the CUDA kernel on the card).
    A leading batch of memories (the seeds of an f32 episode batch) is one
    call: one launch of the Gram kernel (#1) on the card, one batched plain
    form on the CPU, the parameters broadcast to the memories' batch."""
    if x.dtype == torch.float64:
        return ops.gram_ref(lengthscales, outputscales, x)
    lead = x.shape[:-2]
    ls = lengthscales.expand(lead + lengthscales.shape[-2:]).contiguous()
    outs = outputscales.expand(lead + outputscales.shape[-1:]).contiguous()
    return ops.gram(ls, outs, x.contiguous())


def _cov_core(*args, batch=1):
    """The cov core by the same dtype rule as ``_gram``: f32 through
    ``ops.cov_core``; f64 through it under ``ops.disable_pallas``, so that
    it takes the plain core, or an installed override first (the N-sharded
    planner's core takes f64 calls too, as in the JAX package)."""
    if args[0].dtype == torch.float64:
        with ops.disable_pallas():
            return ops.cov_core(*args, batch=batch)
    return ops.cov_core(*args, batch=batch)


def masked_cholesky_factorize(params: GPParams, bounds: GPBounds, x, y, mask) -> FactorizationCache:
    """(iK, beta, L) of ``K + sigma^2 I`` on the active block, identity
    padding elsewhere; the dtype and device are those of ``x``. A leading
    batch (the seeds of an episode batch: params (..., Ns, D), x (..., N,
    D), y (..., N, Ns), mask (..., N)) factorizes every memory in the same
    batched calls, each matrix on its own, into a cache with that leading
    axis."""
    lengthscales, outputscales, noise = constrained_params(params, bounds)
    n = x.shape[-2]
    dtype = x.dtype
    mask_f = mask.to(dtype)
    mask2 = mask_f[..., :, None] * mask_f[..., None, :]

    K = _gram(lengthscales, outputscales, x)
    eye = torch.eye(n, dtype=dtype, device=x.device)
    K = K * mask2[..., None, :, :]
    diag_fix = torch.where(mask[..., None, :], noise[..., :, None], torch.ones((), dtype=dtype, device=x.device))
    K = K + eye * diag_fix[..., :, None, :]

    L = torch.linalg.cholesky(K)
    # iK = L^-T L^-1: one batched triangular solve and a symmetric product
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)
    iK = torch.einsum("...mki,...mkj->...mij", Linv, Linv) * mask2[..., None, :, :]

    y_masked = (y * mask_f[..., :, None]).transpose(-1, -2)[..., :, :, None]  # (Ns, N, 1)
    beta = torch.cholesky_solve(y_masked, L, upper=False)[..., 0] * mask_f[..., None, :]

    return FactorizationCache(
        x_mem=x, mask=mask, iK=iK, beta=beta, lengthscales=lengthscales,
        outputscales=outputscales, L=L, noises=noise, y_mem=y * mask_f[..., :, None],
    )


def extend_factorization(cache: FactorizationCache, x_new, y_new) -> FactorizationCache:
    """Append ONE point in O(Ns N^2): bordered Cholesky row plus a rank-1
    Schur update of the materialized inverse,

      iK_new = iK + v v^T / s,  v = iK k - e,  s = c - k^T iK k,
      beta   = iK_new y_new.

    The padding invariants hold afterwards."""
    dtype = cache.x_mem.dtype
    device = cache.x_mem.device
    x_new = x_new.to(dtype)
    y_new = y_new.to(dtype)
    n_cap = cache.x_mem.shape[0]
    n = cache.mask.to(torch.int32).sum()  # insert slot
    e = (torch.arange(n_cap, device=device) == n).to(dtype)
    mask_f = cache.mask.to(dtype)

    x_mem = cache.x_mem + e[:, None] * (x_new[None, :] - cache.x_mem)
    y_mem = cache.y_mem + e[:, None] * (y_new[None, :] - cache.y_mem)
    new_mask = torch.logical_or(cache.mask, e.to(torch.bool))

    diff = (cache.x_mem - x_new[None, :])[None, :, :] / cache.lengthscales[:, None, :]
    k_col = cache.outputscales[:, None] * torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))
    k_col = k_col * mask_f[None, :]
    c = cache.outputscales + cache.noises

    l21 = torch.linalg.solve_triangular(cache.L, k_col[..., None], upper=False)[..., 0]
    l22 = torch.sqrt(torch.clamp(c - torch.sum(l21 * l21, dim=-1), min=1e-12))
    new_row = l21 * (1.0 - e)[None, :] + l22[:, None] * e[None, :]
    L_new = cache.L * (1.0 - e)[None, :, None] + new_row[:, None, :] * e[None, :, None]

    u = torch.einsum("mij,mj->mi", cache.iK, k_col)
    s = torch.clamp(c - torch.sum(k_col * u, dim=-1), min=1e-12)
    v = u - e[None, :]
    iK_new = cache.iK + v[:, :, None] * v[:, None, :] / s[:, None, None]

    beta_new = torch.einsum("mij,jm->mi", iK_new, y_mem)
    return cache._replace(x_mem=x_mem, y_mem=y_mem, mask=new_mask, L=L_new, iK=iK_new, beta=beta_new)


def _small_spd_inv_det(M) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse and determinant of small SPD matrices (..., k, k) by an
    unrolled Cholesky of elementwise ops. A pivot guard clamps each pivot at
    a tiny fraction of its row diagonal: inactive on healthy inputs, it keeps
    an f32 covariance that drifted indefinite from NaN-ing the rollout."""
    k = M.shape[-1]
    eps = 1e-10
    L = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = M[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                s = torch.maximum(s, eps * torch.abs(M[..., i, i]) + 1e-30)
                L[i][i] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    det = L[0][0] * L[0][0]
    for i in range(1, k):
        det = det * (L[i][i] * L[i][i])
    Li = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            if i == j:
                Li[i][i] = 1.0 / L[i][i]
            else:
                s = L[i][j] * Li[j][j]
                for p in range(j + 1, i):
                    s = s + L[i][p] * Li[p][j]
                Li[i][j] = -s / L[i][i]
    rows = []
    for i in range(k):
        row = []
        for j in range(k):
            lo = max(i, j)
            s = Li[lo][i] * Li[lo][j]
            for p in range(lo + 1, k):
                s = s + Li[p][i] * Li[p][j]
            row.append(s)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2), det


# Above this state dimension the unrolled Cholesky's O(Ns^3) op count stops
# paying for itself against the batched linalg routines (the JAX package's
# limit and rule).
_UNROLL_MAX_DIM = 8


def _spd_inv_det(M) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse and determinant of SPD matrices (..., k, k): the unrolled,
    pivot-guarded ``_small_spd_inv_det`` up to ``_UNROLL_MAX_DIM``, past it a
    Cholesky factorization and solve, NaN where M is not positive definite
    (as JAX's ``cholesky`` and ``_cho_solve`` give)."""
    k = M.shape[-1]
    if k <= _UNROLL_MAX_DIM:
        return _small_spd_inv_det(M)
    L = _cholesky_or_nan(M)
    eye = torch.eye(k, dtype=M.dtype, device=M.device).expand_as(M)
    det = torch.prod(torch.diagonal(L, dim1=-2, dim2=-1), dim=-1) ** 2
    return torch.cholesky_solve(eye, L, upper=False), det


class DFCache(NamedTuple):
    """Double-float32 split of an f64 master FactorizationCache: the cache of
    the mixed-mode rollout. Every cancellation-sensitive master quantity is
    an exact f32 (hi, lo) pair, so the rollout runs in f32 arithmetic with
    f64-grade results."""

    x_hi: torch.Tensor  # (N, D)
    x_lo: torch.Tensor
    mask: torch.Tensor  # (N,)
    iK_hi: torch.Tensor  # (Ns, N, N)
    iK_lo: torch.Tensor
    beta_hi: torch.Tensor  # (Ns, N)
    beta_lo: torch.Tensor
    ils_hi: torch.Tensor  # (Ns, D) 1/lengthscale
    ils_lo: torch.Tensor
    ils2_hi: torch.Tensor  # (Ns, D) 1/lengthscale^2
    ils2_lo: torch.Tensor
    log_outs_hi: torch.Tensor  # (Ns,)
    log_outs_lo: torch.Tensor
    outs: torch.Tensor  # (Ns,) f32 outputscales
    y_mem: torch.Tensor  # kept so the planner's cache bookkeeping stays uniform
    index: Optional[torch.Tensor] = None  # as FactorizationCache.index

    @property
    def x_mem(self):
        return self.x_hi

    @property
    def outputscales(self):
        return self.outs


def split_cache_df(cache: FactorizationCache) -> DFCache:
    """Split an f64 master cache into the df32 rollout cache."""
    if cache.x_mem.dtype != torch.float64:
        raise TypeError(f"split_cache_df needs the f64 master cache, got {cache.x_mem.dtype}")
    x_hi, x_lo = split_f64(cache.x_mem)
    iK_hi, iK_lo = split_f64(cache.iK)
    beta_hi, beta_lo = split_f64(cache.beta)
    ils64 = 1.0 / cache.lengthscales
    ils_hi, ils_lo = split_f64(ils64)
    ils2_hi, ils2_lo = split_f64(ils64 * ils64)
    lo_hi, lo_lo = split_f64(lanewise(torch.log, cache.outputscales))
    return DFCache(
        x_hi=x_hi, x_lo=x_lo, mask=cache.mask, iK_hi=iK_hi, iK_lo=iK_lo,
        beta_hi=beta_hi, beta_lo=beta_lo, ils_hi=ils_hi, ils_lo=ils_lo,
        ils2_hi=ils2_hi, ils2_lo=ils2_lo, log_outs_hi=lo_hi, log_outs_lo=lo_lo,
        outs=cache.outputscales.to(torch.float32), y_mem=cache.y_mem.to(torch.float32), index=cache.index,
    )


def with_index(cache, index):
    """The cache of a batched rollout whose element b rolls out on cache
    index[b] of the caches stacked on the fields' leading axis: index a
    sequence or tensor of ints, kept as int32 on the cache's device (the
    kernels read it there), or None for one cache shared by every element."""
    if index is not None:
        index = torch.as_tensor(index, dtype=torch.int32).to(cache.x_mem.device)
    return cache._replace(index=index)


def select_elements(cache, idx):
    """The cache of the batch elements idx (a device tensor of positions) of
    a batched rollout: the shared cache as it is, else its index at idx."""
    return cache if cache.index is None else cache._replace(index=cache.index[idx])


def _fold(lead, t, k):
    """t (..., *tail), its k trailing dims the tail, broadcast to lead + tail
    and folded into the tail's first axis: (prod(lead) tail[0], *tail[1:])."""
    tail = tuple(t.shape[t.dim() - k:])
    return t.expand(tuple(lead) + tail).reshape((-1,) + tail[1:])


def _batched_cov_core(core, lead, p, pair_args, ik_args, diag_pos):
    """A cov core (``core(*pair_operands, *ik_operands, diag_pos)`` -> its
    per-pair outputs, then its per-diagonal ones) over the leading batch
    ``lead``: with no batch the call as it is; else one call with the batch
    folded into the pair axis: each pair operand (given with its trailing
    rank, (t, k)) (B P, ...), iK stacked per element (B ns, N, N) and
    diag_pos shifted to b P + d, and the outputs unfolded to lead + (P,) and
    lead + (ns,). Each pair's sums are its own, and the kernels plan the
    launch for one element (``batch``), so every element gets what it would
    alone, bit for bit."""
    if not lead:
        return core(*(t for t, _ in pair_args), *ik_args, diag_pos)
    nb = math.prod(lead)
    folded = [_fold(lead, t, k) for t, k in pair_args]
    iks = [_fold(lead, t, 3) for t in ik_args]
    dpos = tuple(b * p + q for b in range(nb) for q in diag_pos)
    outs = core(*folded, *iks, dpos, **({"batch": nb} if nb > 1 else {}))
    half = len(outs) // 2
    return tuple(o.reshape(tuple(lead) + (p,)) for o in outs[:half]) + tuple(
        o.reshape(tuple(lead) + (len(diag_pos),)) for o in outs[half:])


def _assemble_S(S_p, M, outs, ii, jj):
    """The Ns x Ns predictive covariance (..., ns, ns) from the upper-triangle
    pairs S_p (..., P), the output scales (..., ns) and the mean M (..., ns)."""
    ns = M.shape[-1]
    S = torch.zeros(S_p.shape[:-1] + (ns, ns), dtype=S_p.dtype, device=S_p.device)
    S[..., ii, jj] = S_p
    S = S + S.transpose(-1, -2) - torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))
    S = S + torch.diag_embed(outs)
    return S - M[..., :, None] * M[..., None, :]


def moment_match(cache: FactorizationCache, input_mu, input_var):
    """Exact GP posterior moments under a Gaussian input (PILCO).

    input_mu (..., D); input_var (..., D, D) with only its top-left Ns x Ns
    state block nonzero (actions are deterministic), so every D x D solve
    collapses to an Ns x Ns one. Returns M (..., Ns), S (..., Ns, Ns) and V
    (..., D, Ns). A leading batch rolls out against the cache's index
    (``with_index``), or against the one cache; the cov core runs it as one
    call (``_batched_cov_core``).
    """
    c = per_element(cache)
    x_mem, beta = c.x_mem, c.beta
    ls = c.lengthscales
    outs = c.outputscales
    ns, d = ls.shape[-2:]
    dtype = x_mem.dtype
    device = x_mem.device
    sv = input_var[..., :ns, :ns]
    eye_ns = torch.eye(ns, dtype=dtype, device=device)

    inp = x_mem - input_mu[..., None, :]
    inv_ls = 1.0 / ls

    # --- mean and input-output covariance ------------------------------
    iN = inp[..., None, :, :] * inv_ls[..., :, None, :]  # (Ns, N, D)
    B_ss = inv_ls[..., :, :ns, None] * sv[..., None, :, :] * inv_ls[..., :, None, :ns] + eye_ns
    B_inv, det_B = _spd_inv_det(B_ss)
    t_s = torch.einsum("...mnk,...mkj->...mnj", iN[..., :ns], B_inv)
    t = torch.cat([t_s, iN[..., ns:]], dim=-1)
    lb = lanewise(torch.exp, -0.5 * torch.sum(iN * t, dim=-1)) * beta  # (Ns, N)
    tiL = t * inv_ls[..., :, None, :]
    cm = outs / torch.sqrt(det_B)

    M = torch.sum(lb, dim=-1) * cm
    V = torch.einsum("...mnd,...mn->...md", tiL, lb) * cm[..., :, None]

    # --- predictive covariance, upper-triangle pairs only ----------------
    inv_ls2 = inv_ls * inv_ls
    ii, jj, dpos, diag_pos = pair_indices(ns, device)

    scale_sum = inv_ls2[..., ii, :ns] + inv_ls2[..., jj, :ns]  # (P, ns)
    d_inv_s = 1.0 / scale_sum
    A_ss = sv[..., None, :, :] + torch.diag_embed(d_inv_s)
    A_inv, det_A = _spd_inv_det(A_ss)
    AinvS = torch.einsum("...pkl,...lm->...pkm", A_inv, sv)
    Q = d_inv_s[..., :, None] * AinvS * 0.5
    sqrt_det_R = torch.sqrt(det_A * torch.prod(scale_sum, dim=-1))

    Xi = inp[..., None, :, :ns] * inv_ls2[..., :, None, :ns]  # (Ns, N, ns)
    Xi_p = Xi[..., ii, :, :]
    Xj_p = Xi[..., jj, :, :]
    XQ = torch.einsum("...pnd,...pde->...pne", Xi_p, Q)
    XjQ = torch.einsum("...pnd,...pde->...pne", Xj_p, Q)
    Xs = torch.sum(XQ * Xi_p, dim=-1)
    X2s = torch.sum(XjQ * Xj_p, dim=-1)

    k = lanewise(torch.log, outs)[..., :, None] - 0.5 * torch.sum(iN * iN, dim=-1)  # (Ns, N)
    a_row = k[..., ii, :] + Xs
    c_col = k[..., jj, :] + X2s
    U = 2.0 * XQ

    p = ii.shape[0]
    S_p, corr = _batched_cov_core(
        _cov_core, Xs.shape[:-2], p,
        ((a_row, 2), (c_col, 2), (U, 3), (Xj_p, 3), (beta[..., ii, :], 2), (beta[..., jj, :], 2)), (c.iK,), diag_pos)
    S_p = S_p.index_add(-1, dpos, -corr)
    S_p = S_p / sqrt_det_R
    return M, _assemble_S(S_p, M, outs, ii, jj), V.transpose(-1, -2)


def _df_mat_small(xh, xl, mh, ml):
    """(..., P, N, ns) x (..., P, ns, ns) -> (..., P, N, ns) by unrolled df
    dots."""
    ns = xh.shape[-1]
    cols_h, cols_l = [], []
    for j in range(ns):
        ah, al = df_mul(xh[..., 0], xl[..., 0], mh[..., :, None, 0, j], ml[..., :, None, 0, j])
        for k in range(1, ns):
            ph, pl = df_mul(xh[..., k], xl[..., k], mh[..., :, None, k, j], ml[..., :, None, k, j])
            ah, al = df_add(ah, al, ph, pl)
        cols_h.append(ah)
        cols_l.append(al)
    return torch.stack(cols_h, dim=-1), torch.stack(cols_l, dim=-1)


def moment_match_df(cache: DFCache, input_mu, input_var):
    """Moment matching in double-float32: the math of ``moment_match`` with
    every cancellation-prone quantity carried as an f32 (hi, lo) pair.

    input_mu (..., D) and input_var (..., D, D) arrive in f32 from the
    rollout and are taken as exact; x_mem, 1/ls, log outs, beta and iK come
    pre-split from the f64 master (``split_cache_df``). The Ns x Ns solves
    run in df32 (``_df_stage1``), the (Ns, N, D) mean path in df ops and the
    (P, N, N) covariance pipeline in ``ops.df_cov_core`` (the CUDA kernels
    on the card; a leading batch folded into its pair axis, one call).
    Returns M (..., Ns), S (..., Ns, Ns) and V (..., D, Ns) in f32.
    """
    f32 = torch.float32
    ns = cache.ils_hi.shape[-2]
    sv32 = input_var[..., :ns, :ns].to(f32)
    mu32 = input_mu.to(f32)
    device = cache.x_hi.device
    ii, jj, dpos, diag_pos = pair_indices(ns, device)
    Bh, Bl, c32, Qh, Ql, sqrt_det_R32 = _df_stage1(cache, sv32, ii, jj)
    cache = per_element(cache)
    d = cache.ils_hi.shape[-1]

    # ---- mean and input-output covariance (df over (Ns, N, D)) ----------
    # inp = x_mem - mu, exact given the f32 mu
    inp_h, inp_l = df_add_f32(cache.x_hi, cache.x_lo, -mu32[..., None, :])
    iN_h, iN_l = df_mul(inp_h[..., None, :, :], inp_l[..., None, :, :], cache.ils_hi[..., :, None, :],
                        cache.ils_lo[..., :, None, :])

    # t = iN with the state block transformed by B^-1 (action/time columns pass)
    t_cols_h, t_cols_l = [], []
    for j in range(ns):
        ah, al = df_mul(iN_h[..., 0], iN_l[..., 0], Bh[..., :, None, 0, j], Bl[..., :, None, 0, j])
        for k in range(1, ns):
            ph, pl = df_mul(iN_h[..., k], iN_l[..., k], Bh[..., :, None, k, j], Bl[..., :, None, k, j])
            ah, al = df_add(ah, al, ph, pl)
        t_cols_h.append(ah)
        t_cols_l.append(al)
    t_h = torch.cat([torch.stack(t_cols_h, dim=-1), iN_h[..., ns:]], dim=-1)
    t_l = torch.cat([torch.stack(t_cols_l, dim=-1), iN_l[..., ns:]], dim=-1)

    # exponent -0.5 sum_d iN t: the large-magnitude cancellation
    eh, el = df_mul(iN_h, iN_l, t_h, t_l)
    exp_h, exp_l = df_sum(eh, el, axis=-1)
    q_h, q_l = df_exp(torch.clamp(-0.5 * exp_h, max=60.0), -0.5 * exp_l)
    lb_h, lb_l = df_mul(q_h, q_l, cache.beta_hi, cache.beta_lo)  # (Ns, N)

    M_h, M_l = df_sum(lb_h, lb_l, axis=-1)
    M = c32 * (M_h + M_l)

    tiL_h, tiL_l = df_mul(t_h, t_l, cache.ils_hi[..., :, None, :], cache.ils_lo[..., :, None, :])
    vh, vl = df_mul(tiL_h, tiL_l, lb_h[..., None], lb_l[..., None])
    V_h, V_l = df_sum(vh, vl, axis=-2)  # (Ns, D)
    V = c32[..., :, None] * (V_h + V_l)

    # ---- predictive covariance (df over (P, N, N)) -----------------------
    p = ii.shape[0]
    ils2_h, ils2_l = cache.ils2_hi[..., :ns], cache.ils2_lo[..., :ns]
    # Xi[m, n, e] = inp[n, e] / ls_m[e]^2 (state columns only)
    Xi_h, Xi_l = df_mul(inp_h[..., None, :, :ns], inp_l[..., None, :, :ns], ils2_h[..., :, None, :],
                        ils2_l[..., :, None, :])
    Xi_ph, Xi_pl = Xi_h[..., ii, :, :], Xi_l[..., ii, :, :]  # (P, N, ns)
    Xj_ph, Xj_pl = Xi_h[..., jj, :, :], Xi_l[..., jj, :, :]
    XQ_h, XQ_l = _df_mat_small(Xi_ph, Xi_pl, Qh, Ql)
    Xs_h, Xs_l = df_sum(*df_mul(XQ_h, XQ_l, Xi_ph, Xi_pl), axis=-1)  # (P, N)
    XjQ_h, XjQ_l = _df_mat_small(Xj_ph, Xj_pl, Qh, Ql)
    X2s_h, X2s_l = df_sum(*df_mul(XjQ_h, XjQ_l, Xj_ph, Xj_pl), axis=-1)

    # k_m(n) = log outs_m - 0.5 sum iN^2
    k_h, k_l = df_sum(*df_mul(iN_h, iN_l, iN_h, iN_l), axis=-1)  # (Ns, N)
    k_h, k_l = df_add(cache.log_outs_hi[..., :, None].expand_as(k_h), cache.log_outs_lo[..., :, None].expand_as(k_h),
                      -0.5 * k_h, -0.5 * k_l)

    a_h, a_l = df_add(k_h[..., ii, :], k_l[..., ii, :], Xs_h, Xs_l)  # (P, N)
    c_h, c_l = df_add(k_h[..., jj, :], k_l[..., jj, :], X2s_h, X2s_l)
    U_h, U_l = 2.0 * XQ_h, 2.0 * XQ_l  # exact doubling

    Sp_h, Sp_l, corr_h, corr_l = _batched_cov_core(
        ops.df_cov_core, Xs_h.shape[:-2], p,
        ((a_h, 2), (a_l, 2), (c_h, 2), (c_l, 2), (U_h, 3), (U_l, 3), (Xj_ph, 3), (Xj_pl, 3),
         (cache.beta_hi[..., ii, :], 2), (cache.beta_lo[..., ii, :], 2), (cache.beta_hi[..., jj, :], 2),
         (cache.beta_lo[..., jj, :], 2)),
        (cache.iK_hi, cache.iK_lo), diag_pos)

    # S_p(diag) and corr cancel from ~1e3..1e4 to ~1e-2: subtract in df and
    # collapse to f32 only after the cancellation
    zeros = torch.zeros_like(Sp_h)
    Sp_h, Sp_l = df_add(Sp_h, Sp_l, -zeros.index_copy(-1, dpos, corr_h), -zeros.index_copy(-1, dpos, corr_l))
    S_p = (Sp_h + Sp_l) / sqrt_det_R32
    return M, _assemble_S(S_p, M, cache.outs, ii, jj), V.transpose(-1, -2)


def moment_match_df_fused(cache: DFCache, input_mu, input_var):
    """``moment_match_df`` with the whole step in one kernel launch per
    horizon step (``ops.df_mm``, the reference's ``moment_match_df_fused``):
    stage 1, the mean path, the (P, N, N) covariance pipeline and the finish
    run in ``df_mm.full_step`` (forward kernel #12; its backward launches #8
    and #9 on the split path), for every element of a leading batch in the
    same launch; only the Ns x Ns S assembly and the M M^T subtraction stay
    here. On the CPU the same composite runs on the kernels' plain twins.
    Only the reference's ``n <= 512`` branch is ported: its other branch
    (stage 1 outside, ``stage23_pallas``) is dead under dispatch, whose
    range ends at N = 128. Returns M (..., Ns), S (..., Ns, Ns) and V (...,
    D, Ns) in f32.
    """
    ns = cache.ils_hi.shape[-2]
    f32 = torch.float32
    sv32 = input_var[..., :ns, :ns].to(f32)
    mu32 = input_mu.to(f32)
    ii, jj, _, _ = pair_indices(ns, cache.x_hi.device)
    M, V, S_p = ops.df_mm.full_step(mu32, sv32, cache)
    return M, _assemble_S(S_p, M, per_element(cache).outs, ii, jj), V.transpose(-1, -2)


def predict_trajectory(cache: FactorizationCache, actions, state_mu, state_var,
                       current_time_idx, include_time_model: bool):
    """Moment-matched rollout over the horizon (a Python loop over steps):
    Sigma_{t+1} = S + Sigma_t + Sigma_row V + V^T Sigma_row^T.

    actions (..., Nh, Na); state_mu (..., Ns); state_var (..., Ns, Ns), the
    leading batches broadcast against each other (restarts from one state,
    seeds each from its own), every element one rollout of the same
    launches. Returns states_mu (..., Nh+1, Ns) and states_var (..., Nh+1,
    Ns, Ns), initial state first.
    """
    ns = state_mu.shape[-1]
    d = cache.x_mem.shape[-1]
    dtype = state_mu.dtype
    lead = torch.broadcast_shapes(state_mu.shape[:-1], state_var.shape[:-2], actions.shape[:-2])
    single = not lead  # one rollout runs as a batch of one, so that it rounds as an element of a batch does
    lead = lead or torch.Size([1])
    mu, var = state_mu.expand(lead + (ns,)), state_var.expand(lead + (ns, ns))
    mus, vars_ = [mu], [var]
    if isinstance(cache, DFCache):
        ns_, d_ = cache.ils_hi.shape[-2:]
        fused = ops.use_df_fused(cache.x_hi.shape[-2], ns_, d_, cache.x_hi.device)
        mm = moment_match_df_fused if fused else moment_match_df
    else:
        mm = moment_match
    for t in range(actions.shape[-2]):
        input_var = F.pad(var, (0, d - ns, 0, d - ns))
        parts = [mu, actions[..., t, :].to(dtype).expand(lead + actions.shape[-1:])]
        if include_time_model:
            step = torch.as_tensor(current_time_idx, dtype=dtype, device=mu.device).reshape(1) + t
            parts.append(step.expand(lead + (1,)))
        input_mu = torch.cat(parts, dim=-1)
        dmu, dvar, v = mm(cache, input_mu, input_var)
        sv = input_var[..., :ns, :]
        mu = mu + dmu
        var = dvar + var + sv @ v + v.transpose(-1, -2) @ sv.transpose(-1, -2)
        mus.append(mu)
        vars_.append(var)
    mus, vars_ = torch.stack(mus, dim=-2), torch.stack(vars_, dim=-3)
    return (mus[0], vars_[0]) if single else (mus, vars_)


# ----------------------------------------------------------------------------
# Marginal log likelihood and hyperparameter training
# ----------------------------------------------------------------------------


def _cholesky_or_nan(K):
    """Lower Cholesky factor of K, NaN where K is not positive definite (as
    JAX's cholesky returns), so that a failed factorization makes a NaN loss
    the line search rejects instead of an exception."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _log2pi(dtype, device):
    return torch.tensor(math.log(2.0 * math.pi), dtype=dtype, device=device)


def negative_mll(params: GPParams, bounds: GPBounds, x, y, mask):
    """Per-model negative exact marginal log likelihood, normalized by the
    number of active points (GPyTorch's ExactMarginalLogLikelihood, the
    reference's training objective, gp_model.py:226-229):

      loss_m = 0.5 * (y^T K^-1 y + logdet(K + s^2 I) + N log 2pi) / N

    Returns (Ns,) losses. Padded rows contribute nothing (unit diagonal,
    zero targets)."""
    lengthscales, outputscales, noise = constrained_params(params, bounds)
    n = x.shape[0]
    dtype = x.dtype
    mask_f = mask.to(dtype)
    mask2 = mask_f[:, None] * mask_f[None, :]
    n_active = torch.sum(mask_f)

    K = ops.gram_ref(lengthscales, outputscales, x) * mask2[None]
    eye = torch.eye(n, dtype=dtype, device=x.device)
    diag_fix = torch.where(mask[None, :], noise[:, None], torch.ones((), dtype=dtype, device=x.device))
    K = K + torch.einsum("ij,mj->mij", eye, diag_fix)
    L = _cholesky_or_nan(K)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    y_m = (y * mask_f[:, None]).T[:, :, None]
    alpha = torch.cholesky_solve(y_m, L, upper=False)[..., 0]
    quad = torch.sum(alpha * y_m[..., 0], dim=-1)
    return 0.5 * (quad + logdet + n_active * _log2pi(dtype, x.device)) / torch.clamp(n_active, min=1.0)


class TrainConfigDevice(NamedTuple):
    """Training knobs (the JAX package's name): the line search's base step
    ``lr``, the L-BFGS iterations, the gradient-value clip and the
    optimizer's history and line-search lengths."""

    lr: float
    iters: int
    clip_grad_value: float
    maxcor: int = 10
    maxls: int = 12


def _single_model_negative_mll(raw, lo, hi, x, y_col, mask):
    """Negative MLL of ONE output-dim GP from its flat raw vector
    [raw_lengthscales (D,), raw_outputscale, raw_noise]; lo/hi are the
    matching constraint bounds in the same layout. Batched over leading
    axes: raw, lo, hi (..., D+2), x (..., N, D), y_col (..., N), mask (...,
    N), broadcast; each element's Gram, Cholesky and solve are its own."""
    d = x.shape[-1]
    c = constrain(raw, lo, hi)
    ls, outputscale, noise = c[..., :d], c[..., d], c[..., d + 1]
    dtype = x.dtype
    mask_f = mask.to(dtype)
    mask2 = mask_f[..., :, None] * mask_f[..., None, :]
    n_active = torch.sum(mask_f, dim=-1)

    xs = x / ls[..., None, :]
    sq = torch.sum(xs * xs, dim=-1)
    d2 = torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * (xs @ xs.transpose(-1, -2)), min=0.0)
    K = outputscale[..., None, None] * lanewise(torch.exp, -0.5 * d2) * mask2
    K = K + torch.diag_embed(torch.where(mask, noise[..., None], torch.ones((), dtype=dtype, device=x.device)))
    L = _cholesky_or_nan(K)
    logdet = 2.0 * torch.sum(lanewise(torch.log, torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    y_m = y_col * mask_f
    alpha = torch.cholesky_solve(y_m[..., :, None], L, upper=False)[..., 0]
    quad = torch.sum(alpha * y_m, dim=-1)
    return 0.5 * (quad + logdet + n_active * _log2pi(dtype, x.device)) / torch.clamp(n_active, min=1.0)


def _flat_boxes(params: GPParams, bounds: GPBounds):
    """(lo, hi, raw0) (Ns, D+2) in the flat per-model layout
    [lengthscales (D,), outputscale, noise]."""
    lo = torch.cat([bounds.min_lengthscale, bounds.min_outputscale[..., None], bounds.min_noise[..., None]], dim=-1)
    hi = torch.cat([bounds.max_lengthscale, bounds.max_outputscale[..., None], bounds.max_noise[..., None]], dim=-1)
    raw0 = torch.cat([params.raw_lengthscales, params.raw_outputscale[..., None], params.raw_noise[..., None]],
                     dim=-1)
    return lo, hi, raw0


def training_draws(params: GPParams, x, generator: Optional[torch.Generator], restarts: int, draws=None):
    """The re-init fractions (restarts, Ns, D+2) in [0, 1): ``draws`` when
    given, else drawn from ``generator``; in the dtype and on the device of
    ``x``."""
    ns, d = params.raw_lengthscales.shape
    if draws is None:
        draws = torch.rand((restarts, ns, d + 2), generator=generator, dtype=x.dtype)
    draws = torch.as_tensor(draws, dtype=x.dtype).to(x.device)
    if tuple(draws.shape) != (restarts, ns, d + 2):
        raise ValueError(f"draws of shape {tuple(draws.shape)}, expected {(restarts, ns, d + 2)}")
    return draws


def train_restarts(params: GPParams, bounds: GPBounds, x, y, mask, cfg: TrainConfigDevice, draws):
    """The L-BFGS runs of ``train_hyperparams``, one per restart and model,
    from the re-inits ``draws`` (..., R, Ns, D+2), as one lockstep batch
    (``lbfgs_minimize_batch``; the JAX package's double vmap): the best raw
    vector and loss each run saw, (..., R, Ns, D+2) and (..., R, Ns). A
    leading batch (the seeds of an episode batch) trains each its own memory,
    x (..., N, D), y (..., N, Ns), mask (..., N), in the same batch; the
    boxes are shared."""
    from ..controllers.lbfgs import lbfgs_minimize_batch  # local import: controllers import this module

    lo, hi, _ = _flat_boxes(params, bounds)
    *lead, r, ns, k = draws.shape
    n, d = x.shape[-2:]
    seeds = math.prod(lead)
    init = unconstrain(lo + draws * (hi - lo), lo, hi).reshape(-1, k)
    lo_e, hi_e = (b.expand(draws.shape).reshape(-1, k) for b in (lo, hi))
    dev = x.device
    seed_of = torch.arange(seeds, device=dev).repeat_interleave(r * ns)
    model_of = torch.arange(ns, device=dev).repeat(seeds * r)
    xs, ys, ms = x.reshape(-1, n, d), y.reshape(-1, n, ns), mask.reshape(-1, n)

    def loss_fn(raw, idx):
        s, m = seed_of[idx], model_of[idx]
        x_b = xs[0] if seeds == 1 else xs[s]
        return _single_model_negative_mll(raw, lo_e[idx], hi_e[idx], x_b, ys[s, :, m], ms[s])

    best_x, best_f = lbfgs_minimize_batch(loss_fn, init, maxiter=cfg.iters, maxcor=cfg.maxcor, maxls=cfg.maxls,
                                          clip_grad_value=cfg.clip_grad_value, keep_best=True,
                                          init_step_scale=cfg.lr)
    return best_x.reshape(draws.shape), best_f.reshape(draws.shape[:-1])


def keep_best(params: GPParams, bounds: GPBounds, x, y, mask, raws, losses) -> Tuple[GPParams, torch.Tensor]:
    """Per model, the restart of least loss (the first on a tie) if it beats
    the incumbent parameters' loss, else the incumbent: (best_params,
    best_losses (..., Ns)) from raws (..., R, Ns, D+2) and losses (..., R,
    Ns); a leading batch as in ``train_restarts``."""
    d = params.raw_lengthscales.shape[-1]
    lo, hi, raw0 = _flat_boxes(params, bounds)
    with torch.no_grad():
        baseline = _single_model_negative_mll(raw0, lo, hi, x[..., None, :, :], y.transpose(-1, -2),
                                              mask[..., None, :])
    ridx = torch.argmin(losses, dim=-2, keepdim=True)  # (..., 1, Ns)
    cand_raw = torch.take_along_dim(raws, ridx[..., None], dim=-3)[..., 0, :, :]
    cand_losses = torch.take_along_dim(losses, ridx, dim=-2)[..., 0, :]
    improved = cand_losses < baseline
    new_raw = torch.where(improved[..., None], cand_raw, raw0)
    new_params = GPParams(raw_lengthscales=new_raw[..., :d], raw_outputscale=new_raw[..., d],
                          raw_noise=new_raw[..., d + 1])
    return new_params, torch.minimum(cand_losses, baseline)


def train_hyperparams(params: GPParams, bounds: GPBounds, x, y, mask, generator: Optional[torch.Generator],
                      cfg: TrainConfigDevice, restarts: int = 1, draws=None) -> Tuple[GPParams, torch.Tensor]:
    """MLL hyperparameter optimization with keep-best semantics (the
    reference's training process, gp_model.py:193-306): per model, start
    from a uniform re-init inside the constraint box, run L-BFGS with
    gradient-value clipping on that model's exact MLL, and keep the best
    (loss, params) seen, falling back to the incumbent parameters when no
    run beats them. Each of the ``restarts`` x Ns runs is independent (JAX
    vmaps them; here they are one lockstep L-BFGS batch, ``train_restarts``;
    the restart-sharded trainer splits them across ranks,
    parallel/sharding.py).

    The re-init fractions are ``draws`` (restarts, Ns, D+2) in [0, 1) when
    given, else drawn from ``generator``. Everything runs in the dtype and
    on the device of ``x``. Returns (best_params, best_losses (Ns,))."""
    draws = training_draws(params, x, generator, restarts, draws)
    raws, losses = train_restarts(params, bounds, x, y, mask, cfg, draws)
    return keep_best(params, bounds, x, y, mask, raws, losses)

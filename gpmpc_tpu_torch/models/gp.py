"""Batched Gaussian-process dynamics model: the planning step's GP math.

Port of the parts of ``gpmpc_tpu/models/gp.py`` that one steady-state
planning step runs: hyperparameter boxes, the masked Cholesky factorization
(with its padding invariant), the rank-1 append, PILCO moment matching and
the horizon rollout. One stacked model family with a leading Ns axis; the
stored points live in a fixed-capacity padded buffer with an active mask:

* Gram rows/cols of inactive points are zeroed and their diagonal set to 1,
  so ``K + diag(noise)`` is ``[K_active + sigma^2 I, 0; 0, I]``;
* targets of inactive points are zero, so ``beta`` is zero on padding;
* ``iK`` is zero outside the active block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops


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


def constrain(raw, lo, hi):
    """raw -> lower + (upper - lower) * sigmoid(raw)."""
    return lo + (hi - lo) * torch.sigmoid(raw)


def unconstrain(value, lo, hi):
    """constrained -> raw; clips slightly inside the box for finiteness."""
    frac = torch.clamp((value - lo) / (hi - lo), 1e-12, 1.0 - 1e-12)
    return torch.log(frac) - torch.log1p(-frac)


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


def masked_cholesky_factorize(params: GPParams, bounds: GPBounds, x, y, mask) -> FactorizationCache:
    """(iK, beta, L) of ``K + sigma^2 I`` on the active block, identity
    padding elsewhere; the dtype and device are those of ``x``."""
    lengthscales, outputscales, noise = constrained_params(params, bounds)
    n = x.shape[0]
    dtype = x.dtype
    mask_f = mask.to(dtype)
    mask2 = mask_f[:, None] * mask_f[None, :]

    K = ops.gram(lengthscales, outputscales, x)  # CUDA kernel on the card
    eye = torch.eye(n, dtype=dtype, device=x.device)
    K = K * mask2[None]
    diag_fix = torch.where(mask[None, :], noise[:, None], torch.ones((), dtype=dtype, device=x.device))
    K = K + torch.einsum("ij,mj->mij", eye, diag_fix)

    L = torch.linalg.cholesky(K)
    # iK = L^-T L^-1: one batched triangular solve and a symmetric product
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)
    iK = torch.einsum("mki,mkj->mij", Linv, Linv) * mask2[None]

    y_masked = (y * mask_f[:, None]).T[:, :, None]  # (Ns, N, 1)
    beta = torch.cholesky_solve(y_masked, L, upper=False)[..., 0] * mask_f[None, :]

    return FactorizationCache(
        x_mem=x, mask=mask, iK=iK, beta=beta, lengthscales=lengthscales,
        outputscales=outputscales, L=L, noises=noise, y_mem=y * mask_f[:, None],
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


@functools.lru_cache(maxsize=None)
def _pair_indices(ns: int, device: torch.device):
    """Upper-triangle pair indices (ii, jj), the pair index of each (m, m) as
    a tensor and as a tuple. Made once per device: a fresh host-to-device
    index copy on every step would stall the stream."""
    ii, jj = np.triu_indices(ns)
    diag = np.where(ii == jj)[0]
    return (torch.as_tensor(ii, device=device), torch.as_tensor(jj, device=device),
            torch.as_tensor(diag, device=device), tuple(int(p) for p in diag))


def moment_match(cache: FactorizationCache, input_mu, input_var):
    """Exact GP posterior moments under a Gaussian input (PILCO).

    input_mu (D,); input_var (D, D) with only its top-left Ns x Ns state block
    nonzero (actions are deterministic), so every D x D solve collapses to an
    Ns x Ns one. Returns M (Ns,), S (Ns, Ns) and V (D, Ns).
    """
    x_mem, beta = cache.x_mem, cache.beta
    ls = cache.lengthscales
    outs = cache.outputscales
    ns, d = ls.shape
    dtype = x_mem.dtype
    device = x_mem.device
    sv = input_var[:ns, :ns]
    eye_ns = torch.eye(ns, dtype=dtype, device=device)

    inp = x_mem - input_mu[None, :]
    inv_ls = 1.0 / ls

    # --- mean and input-output covariance ------------------------------
    iN = inp[None, :, :] * inv_ls[:, None, :]  # (Ns, N, D)
    B_ss = inv_ls[:, :ns, None] * sv[None, :, :] * inv_ls[:, None, :ns] + eye_ns
    B_inv, det_B = _small_spd_inv_det(B_ss)
    t_s = torch.einsum("mnk,mkj->mnj", iN[..., :ns], B_inv)
    t = torch.cat([t_s, iN[..., ns:]], dim=-1)
    lb = torch.exp(-0.5 * torch.sum(iN * t, dim=-1)) * beta  # (Ns, N)
    tiL = t * inv_ls[:, None, :]
    c = outs / torch.sqrt(det_B)

    M = torch.sum(lb, dim=-1) * c
    V = torch.einsum("mnd,mn->md", tiL, lb) * c[:, None]

    # --- predictive covariance, upper-triangle pairs only ----------------
    inv_ls2 = inv_ls * inv_ls
    ii, jj, dpos, diag_pos = _pair_indices(ns, device)

    scale_sum = inv_ls2[ii, :ns] + inv_ls2[jj, :ns]  # (P, ns)
    d_inv_s = 1.0 / scale_sum
    A_ss = sv[None, :, :] + torch.diag_embed(d_inv_s)
    A_inv, det_A = _small_spd_inv_det(A_ss)
    AinvS = torch.einsum("pkl,lm->pkm", A_inv, sv)
    Q = d_inv_s[..., :, None] * AinvS * 0.5
    sqrt_det_R = torch.sqrt(det_A * torch.prod(scale_sum, dim=-1))

    Xi = inp[None, :, :ns] * inv_ls2[:, None, :ns]  # (Ns, N, ns)
    Xi_p = Xi[ii]
    Xj_p = Xi[jj]
    XQ = torch.einsum("pnd,pde->pne", Xi_p, Q)
    XjQ = torch.einsum("pnd,pde->pne", Xj_p, Q)
    Xs = torch.sum(XQ * Xi_p, dim=-1)
    X2s = torch.sum(XjQ * Xj_p, dim=-1)

    k = torch.log(outs)[:, None] - 0.5 * torch.sum(iN * iN, dim=-1)  # (Ns, N)
    a_row = k[ii] + Xs
    c_col = k[jj] + X2s
    U = 2.0 * XQ

    S_p, corr = ops.cov_core(a_row, c_col, U, Xj_p, beta[ii], beta[jj], cache.iK, diag_pos)
    S_p = S_p.index_add(0, dpos, -corr)
    S_p = S_p / sqrt_det_R

    S = torch.zeros((ns, ns), dtype=dtype, device=device).index_put((ii, jj), S_p)
    S = S + S.T - torch.diag(torch.diagonal(S))
    S = S + torch.diag(outs)
    S = S - M[:, None] * M[None, :]
    return M, S, V.T


def predict_trajectory(cache: FactorizationCache, actions, state_mu, state_var,
                       current_time_idx, include_time_model: bool):
    """Moment-matched rollout over the horizon (a Python loop over steps):
    Sigma_{t+1} = S + Sigma_t + Sigma_row V + V^T Sigma_row^T.

    actions (Nh, Na); state_mu (Ns,); state_var (Ns, Ns). Returns
    states_mu (Nh+1, Ns) and states_var (Nh+1, Ns, Ns), initial state first.
    """
    ns = state_mu.shape[0]
    d = cache.x_mem.shape[1]
    dtype = state_mu.dtype
    mu, var = state_mu, state_var
    mus, vars_ = [mu], [var]
    for t in range(actions.shape[0]):
        input_var = F.pad(var, (0, d - ns, 0, d - ns))
        parts = [mu, actions[t].to(dtype)]
        if include_time_model:
            parts.append(torch.as_tensor(current_time_idx, dtype=dtype, device=mu.device).reshape(1) + t)
        input_mu = torch.cat(parts)
        dmu, dvar, v = moment_match(cache, input_mu, input_var)
        sv = input_var[:ns]
        mu = mu + dmu
        var = dvar + var + sv @ v + v.T @ sv.T
        mus.append(mu)
        vars_.append(var)
    return torch.stack(mus), torch.stack(vars_)

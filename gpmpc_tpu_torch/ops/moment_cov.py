"""Moment-matching covariance core: CUDA kernels, their plain twins and the
autograd composite.

The pairwise kernel matrix of one moment-matching step,

  E[p, n, k] = exp(min(a[p, n] + c[p, k] + U[p, n, :] . Xj[p, k, :], 60)),

is consumed only through two contractions:

  S_p[p]  = sum_{n,k} bi[p, n] E[p, n, k] bj[p, k]          (P,)
  corr[m] = sum_{n,k} iK[m, n, k] E[diag_pos[m], n, k]       (Ns,)

Kernels (``csrc/cov_core.cu``), each replacing a Pallas TPU kernel of
``gpmpc_tpu/ops/pallas_moment_cov.py``:

* ``cov_fwd`` replaces ``_cov_fwd_kernel`` (via ``_cov_fwd_call``). Grid
  (P, ceil(N/16)), 256 threads: a block owns 16 rows of one pair, threads
  stride the N columns, each thread keeps its sum of bi E bj (and of iK E on
  diagonal pairs), and a warp-shuffle plus shared-memory reduction writes
  one partial per block into (P, tiles) scratch that the wrapper sums.
* ``cov_bwd_row`` replaces ``_bwd_row_kernel`` (via ``_bwd_row_call``).
  Grid (P, ceil(N/8)), 8 warps, one warp per row n reducing over k:
  with W = g wr wc^T E + g_corr iK E it writes ga = rowsum W, gU = W Xj and
  g_wr = g (E wc). ``CovCore.backward`` runs it twice, the second time with
  (a, c), (U, Xj) and (bi, bj) swapped for the column side; iK is symmetric
  in the square case, so the same slab serves both sides.

``_gik_kernel`` (grad wrt iK) is not ported: iK is constant while planning,
and ``CovCore`` refuses a gradient wrt iK.

What bounds them on an H100: at the flagship shape (P=6, N=384, ns=3) each
call reads the 1.77 MB iK slab once and evaluates 0.9 M exps, about half a
microsecond of memory traffic at 3.35 TB/s, so the launch latency (several
microseconds) dominates. The design keeps E out of device memory entirely
(recomputed in the backward, never stored) and uses no atomics, so results
repeat bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

LAUNCHES = {"cov_fwd": 0, "cov_bwd_row": 0}

_INDEX_CACHE: dict = {}


def _index(diag_pos: Tuple[int, ...], device, dtype) -> torch.Tensor:
    """diag_pos as a device tensor, made once per (positions, device, dtype)."""
    key = (tuple(diag_pos), str(device), dtype)
    t = _INDEX_CACHE.get(key)
    if t is None:
        t = torch.tensor(list(diag_pos), dtype=dtype, device=device)
        _INDEX_CACHE[key] = t
    return t


def _check_cuda_f32(name: str, **tensors: torch.Tensor) -> None:
    device = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, others on {device}")


def _e_slab(a, c, u, xj):
    """E (P, Nr, Nc) = exp(min(a + c^T + U Xj^T, 60)), the capped exponent
    of cov_core_xla (the cap guards the f32 overflow of a misfiring
    log-domain cancellation; healthy exponents are <= ~0)."""
    expo = a[:, :, None] + c[:, None, :] + torch.einsum("pne,pke->pnk", u, xj)
    return torch.exp(torch.clamp(expo, max=60.0))


def cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos):
    """Plain PyTorch (S_p, corr): twin of gpmpc_tpu.ops.cov_core_xla,
    differentiable by autograd in every argument."""
    e = _e_slab(a, c, u, xj)
    s_p = torch.einsum("pn,pnk,pk->p", bi, e, bj)
    corr = torch.einsum("mnk,mnk->m", ik, e.index_select(0, _index(diag_pos, e.device, torch.long)))
    return s_p, corr


# ---------------------------------------------------------------------------
# forward kernel (its plain twin is cov_core_ref)
# ---------------------------------------------------------------------------


def cov_fwd(a, c, u, xj, bi, bj, ik, diag_pos):
    """(S_p (P,), corr (n_diag,)). A CPU tensor takes the plain version
    (cov_core_ref); a CUDA tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        return cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos)
    _check_cuda_f32("cov_fwd", a=a, c=c, u=u, xj=xj, bi=bi, bj=bj, ik=ik)
    p, nr = a.shape
    nc = c.shape[1]
    ns = u.shape[2]
    if u.shape != (p, nr, ns) or xj.shape != (p, nc, ns) or bi.shape != (p, nr) \
            or bj.shape != (p, nc) or ik.shape != (len(diag_pos), nr, nc):
        raise ValueError("cov_fwd: inconsistent shapes")
    lib = _build.load()
    tiles = -(-nr // lib.gpmpc_cov_fwd_rows())
    sp_part = torch.empty((p, tiles), dtype=torch.float32, device=a.device)
    co_part = torch.empty((p, tiles), dtype=torch.float32, device=a.device)
    dpos = _index(diag_pos, a.device, torch.int32)
    rc = lib.gpmpc_cov_fwd_f32(
        a.data_ptr(), c.data_ptr(), u.data_ptr(), xj.data_ptr(), bi.data_ptr(),
        bj.data_ptr(), ik.data_ptr(), dpos.data_ptr(), len(diag_pos),
        sp_part.data_ptr(), co_part.data_ptr(), p, nr, nc, ns,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "cov_fwd")
    LAUNCHES["cov_fwd"] += 1
    s_p = sp_part.sum(dim=1)
    corr = co_part.index_select(0, _index(diag_pos, a.device, torch.long)).sum(dim=1)
    return s_p, corr


# ---------------------------------------------------------------------------
# row-side backward kernel and its plain twin
# ---------------------------------------------------------------------------


def cov_bwd_row_plain(g, a, c, u, xj, wr, wc, ik, gco, diag_pos):
    """What ``cov_bwd_row`` computes, in plain PyTorch (the CPU path).

    With W = g wr wc^T E + gco iK_slot E: (rowsum W, W Xj, g (E wc))."""
    e = _e_slab(a, c, u, xj)
    ewc = e * wc[:, None, :]
    w = (g[:, None, None] * wr[:, :, None]) * ewc
    corr_w = torch.zeros_like(e)
    for m, p in enumerate(diag_pos):
        corr_w[p] = gco[p] * ik[m] * e[p]
    w = w + corr_w
    return w.sum(dim=2), torch.einsum("pnk,pke->pne", w, xj), g[:, None] * ewc.sum(dim=2)


def cov_fwd_abs_terms(a, c, u, xj, bi, bj, ik, diag_pos):
    """Sum of the absolute values of the terms of each ``cov_fwd`` output.
    The rounding error of an f32 sum is bounded by a small multiple of
    eps32 times it, whatever the order of summation; E > 0 keeps its
    exponent, only the factors are taken absolute."""
    return cov_core_ref(a, c, u, xj, bi.abs(), bj.abs(), ik.abs(), diag_pos)


def cov_bwd_row_abs_terms(g, a, c, u, xj, wr, wc, ik, gco, diag_pos):
    """Sum of the absolute values of the terms of each ``cov_bwd_row``
    output (see cov_fwd_abs_terms): E keeps its signed exponent, the
    factors g, wr, wc, gco, iK and, in gU, Xj are taken absolute."""
    e = _e_slab(a, c, u, xj)
    ewc = e * wc.abs()[:, None, :]
    w = (g.abs()[:, None, None] * wr.abs()[:, :, None]) * ewc
    corr_w = torch.zeros_like(e)
    for m, p in enumerate(diag_pos):
        corr_w[p] = gco[p].abs() * ik[m].abs() * e[p]
    w = w + corr_w
    return w.sum(dim=2), torch.einsum("pnk,pke->pne", w, xj.abs()), g.abs()[:, None] * ewc.sum(dim=2)


def cov_bwd_row(g, a, c, u, xj, wr, wc, ik, gco, diag_pos):
    """(ga (P,Nr), gU (P,Nr,ns), g_wr (P,Nr)). A CPU tensor takes the plain
    twin; a CUDA tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        return cov_bwd_row_plain(g, a, c, u, xj, wr, wc, ik, gco, diag_pos)
    _check_cuda_f32("cov_bwd_row", g=g, a=a, c=c, u=u, xj=xj, wr=wr, wc=wc, ik=ik, gco=gco)
    p, nr = a.shape
    nc = c.shape[1]
    ns = u.shape[2]
    if g.shape != (p,) or gco.shape != (p,) or u.shape != (p, nr, ns) \
            or xj.shape != (p, nc, ns) or wr.shape != (p, nr) or wc.shape != (p, nc) \
            or ik.shape != (len(diag_pos), nr, nc):
        raise ValueError("cov_bwd_row: inconsistent shapes")
    lib = _build.load()
    ga = torch.empty((p, nr), dtype=torch.float32, device=a.device)
    gu = torch.empty((p, nr, ns), dtype=torch.float32, device=a.device)
    gwr = torch.empty((p, nr), dtype=torch.float32, device=a.device)
    dpos = _index(diag_pos, a.device, torch.int32)
    rc = lib.gpmpc_cov_bwd_row_f32(
        g.data_ptr(), a.data_ptr(), c.data_ptr(), u.data_ptr(), xj.data_ptr(),
        wr.data_ptr(), wc.data_ptr(), ik.data_ptr(), gco.data_ptr(), dpos.data_ptr(),
        len(diag_pos), ga.data_ptr(), gu.data_ptr(), gwr.data_ptr(), p, nr, nc, ns,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "cov_bwd_row")
    LAUNCHES["cov_bwd_row"] += 1
    return ga, gu, gwr


# ---------------------------------------------------------------------------
# autograd composite
# ---------------------------------------------------------------------------


class CovCore(torch.autograd.Function):
    """(S_p, corr) with the kernel backward; mirrors _make_cov_core
    (gpmpc_tpu/ops/pallas_moment_cov.py:241-285) for the square case."""

    @staticmethod
    def forward(ctx, a, c, u, xj, bi, bj, ik, diag_pos):
        ctx.diag_pos = tuple(diag_pos)
        ctx.save_for_backward(a, c, u, xj, bi, bj, ik)
        return cov_fwd(a, c, u, xj, bi, bj, ik, ctx.diag_pos)

    @staticmethod
    def backward(ctx, g_s, g_corr):
        a, c, u, xj, bi, bj, ik = ctx.saved_tensors
        diag_pos = ctx.diag_pos
        if ctx.needs_input_grad[6]:
            raise NotImplementedError(
                "CovCore: the gradient wrt iK needs kernel #4 (_gik_kernel, "
                "gpmpc_tpu/ops/pallas_moment_cov.py:192), which is not ported")
        if a.shape[1] != c.shape[1]:
            raise NotImplementedError("CovCore: rectangular (sharded) slabs are not ported")
        p = a.shape[0]
        g_s = torch.zeros(p, dtype=a.dtype, device=a.device) if g_s is None else g_s.contiguous()
        g_co = torch.zeros(p, dtype=a.dtype, device=a.device)
        if g_corr is not None:
            # corr cotangent scattered to the pair axis, zero off-diagonal
            g_co = g_co.index_copy(0, _index(diag_pos, a.device, torch.long), g_corr)
        ga, gu, gbi = cov_bwd_row(g_s, a, c, u, xj, bi, bj, ik, g_co, diag_pos)
        gc, gxj, gbj = cov_bwd_row(g_s, c, a, xj, u, bj, bi, ik, g_co, diag_pos)
        return ga, gc, gu, gxj, gbi, gbj, None, None

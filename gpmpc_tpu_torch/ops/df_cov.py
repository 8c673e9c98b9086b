"""Double-float32 moment-matching covariance core: CUDA kernels, their plain
twins and the autograd composite.

The df32 twin of ``moment_cov``: every quantity is an f32 (hi, lo) pair,

  E[p, n, k] = exp(min(a[p, n] (+) c[p, k] (+) sum_e U[p, n, e] Xj[p, k, e], 60))
  S_p[p]     = sum_{n,k} bi[p, n] E[p, n, k] bj[p, k]          (P,)
  corr[m]    = sum_{n,k} iK[m, n, k] E[diag_pos[m], n, k]       (n_diag,)

At the trained-GP flagship the exponent is a large-magnitude cancellation
and S_p and corr cancel from ~1e3 terms to ~1e-2, so plain f32 drowns both
(PERFORMANCE.md's precision boundary). Kernels (``csrc/df_cov.cu`` on
``csrc/df32.cuh``), each replacing a Pallas TPU kernel of
``gpmpc_tpu/ops/pallas_df_cov.py``:

* ``df_fwd`` replaces ``_fwd_kernel`` (the lean forward, body ``_fwd_cell``):
  df (S_p, corr). It serves every forward-only evaluation.
* ``df_fwdres`` replaces ``_fwdres_kernel`` (body ``_fwdres_cell``): the
  same slab and 16 df linearization residuals. The core's gradients are
  linear in the output cotangents (gs, gco):

    grad_a[p,n]    = gs[p] bi[p,n] A1[p,n] + gco[p] A2[p,n]
    grad_U[p,n,e]  = gs[p] bi[p,n] B1_e[p,n] + gco[p] B2_e[p,n]
    grad_c[p,k]    = gs[p] bj[p,k] C1[p,k] + gco[p] C2[p,k]
    grad_Xj[p,k,e] = gs[p] bj[p,k] D1_e[p,k] + gco[p] D2_e[p,k]

  with A1 = sum_k bj E, A2 = sum_k iK E, B1_e = sum_k bj E Xj_e,
  B2_e = sum_k iK E Xj_e (row side) and C1 = sum_n bi E, C2 = sum_n iK E,
  D1_e = sum_n bi E U_e, D2_e = sum_n iK E U_e (column side). S_p and corr
  follow from A1 and A2, so one launch serves a value-and-grad evaluation
  and the backward is small df math outside the kernel (``DfCovCore``).
* ``df_bwd`` replaces ``_bwd_kernel`` (body ``_bwd_cell``, launched by
  ``_build_bwd``): the stacked backward of the reference's
  ``GPMPC_DF_COV_VJP=stacked`` scheme. For 2P stacked rows (the row side
  (a, U, bi) against (c, Xj, bj), then the column side with the roles
  swapped), with w = gs bi bj (+) gco iK and gE = w E in df: ga = sum_k gE
  and gU_e = sum_k gE Xj_e, summed in df and collapsed to f32 at the end.
  On square slabs both sides read iK's row slab at their own row index,
  which is iK's column slab because iK is symmetric: one launch. On
  rectangular ones (Nr rows against Nc columns, a rank's slab of the
  N-sharded core) the reference's ``sides=1`` variant: one launch over the
  P row-side rows, one over the P column-side rows with the roles swapped
  and iK transposed, which the kernel reads down the untransposed slab's
  columns. A warp owns one whole stacked row (N = 384 columns is 12 per
  lane), so every sum ends inside its warp: no partials.
  ``DfCovCoreStacked`` pairs it with the lean forward.

The VJP scheme is read once, at import, from ``GPMPC_DF_COV_VJP`` into
``VJP_MODE``, as the reference reads it (``pallas_df_cov._VJP_MODE``):
"residual" (the default; any value other than "stacked") or "stacked".
``ops.df_cov_core`` reads ``VJP_MODE`` at each call, so a program may set
the attribute to switch schemes.

The iK-weighted residuals (A2, B2, C2, D2) exist only on the diagonal pairs
and are zero on the others (the TPU kernel reads an unused model's slab
there, whose values nothing consumes).

None of the kernels stores E. What bounds them on an H100 is arithmetic:
each E element costs about 700 f32 add/multiply instructions (12 df Horner
steps in the exp alone), none of which may fuse into an FMA, so the bound is
instructions over the FP32 lanes' issue rate, far above the bytes of the df
iK slab. Both forwards run on row bands: a block owns a band of rows of one
pair against all columns, a warp one row, and the bands' sizes are chosen
from the card's SM count so that all blocks fit one wave and carry about the
same work, a diagonal pair's (with its iK terms) in shorter bands (the lean
forward's planned here, ``fwd_launch_plan``; ``fwd_launch_info`` and
``fwdres_launch_info`` report the launches). The lean forward sums each
band's terms inside its lanes, then its warps; the forward with residuals
ends its row sums inside their warp and adds its column sums over the band's
warps in shared memory, written per band. The bands' partials are summed by
a second launch, a programmatic dependent, in df32 in a fixed order (the
lean forward's writes S_p and corr in diag_pos order, so the wrapper runs no
PyTorch operation after it), so no atomics and runs repeat bitwise.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import torch

from . import _build
from .df32 import df_add, df_exp, df_mul, df_mul_f32, df_sum, fast_two_sum, two_sum
from .moment_cov import _index, element_pairs

LAUNCHES = {"df_fwd": 0, "df_fwdres": 0, "df_bwd": 0}
MAX_NS = 3  # the kernels' template instantiations (csrc/df_cov.cu)
VJP_MODE = "stacked" if os.environ.get("GPMPC_DF_COV_VJP", "residual") == "stacked" else "residual"


def _e_exponent_df(ah, al, ch, cl, uh, ul, xjh, xjl):
    """The df exponent a (+) c (+) sum_e U_e Xj_e (..., P, Nr, Nc) of E, before
    the cap, from a (..., P, Nr), c (..., P, Nc), U (..., P, Nr, ns), Xj
    (..., P, Nc, ns)."""
    eh, el = two_sum(ah[..., :, None], ch[..., None, :])
    el = el + (al[..., :, None] + cl[..., None, :])
    eh, el = fast_two_sum(eh, el)
    for e in range(uh.shape[-1]):
        th, tl = df_mul(uh[..., :, None, e], ul[..., :, None, e], xjh[..., None, :, e], xjl[..., None, :, e])
        eh, el = df_add(eh, el, th, tl)
    return eh, el


def _e_slab_df(ah, al, ch, cl, uh, ul, xjh, xjl):
    """df E (P, Nr, Nc) with the cap at 60 on the exponent's hi part (twin of
    pallas_df_cov._e_slab_df)."""
    eh, el = _e_exponent_df(ah, al, ch, cl, uh, ul, xjh, xjl)
    return df_exp(torch.clamp(eh, max=60.0), el)


def df_cov_core_ref(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos):
    """Plain PyTorch (S_p h, l, corr h, l): twin of gpmpc_tpu.ops.df_cov_core_xla,
    differentiable by autograd. The CPU path of ``ops.df_cov_core``."""
    p = ah.shape[0]
    eh, el = _e_slab_df(ah, al, ch, cl, uh, ul, xjh, xjl)
    th, tl = df_mul(eh, el, bih[:, :, None], bil[:, :, None])
    th, tl = df_mul(th, tl, bjh[:, None, :], bjl[:, None, :])
    sp_h, sp_l = df_sum(th.reshape(p, -1), tl.reshape(p, -1), axis=-1)
    dpos = _index(diag_pos, ah.device, torch.long)
    dh, dl = df_mul(eh.index_select(0, dpos), el.index_select(0, dpos), ikh, ikl)
    corr_h, corr_l = df_sum(dh.reshape(len(diag_pos), -1), dl.reshape(len(diag_pos), -1), axis=-1)
    return sp_h, sp_l, corr_h, corr_l


def _ik_pairs(ikh, ikl, p, diag_pos):
    """The iK slab of each pair: the model's slab on diagonal pairs, zero on
    the others. (P, Nr, Nc) hi and lo."""
    zh = torch.zeros((p,) + tuple(ikh.shape[1:]), dtype=ikh.dtype, device=ikh.device)
    dpos = _index(diag_pos, ikh.device, torch.long)
    return zh.index_copy(0, dpos, ikh), zh.index_copy(0, dpos, ikl)


# ---------------------------------------------------------------------------
# plain twins of the two kernels
# ---------------------------------------------------------------------------


def df_cov_fwd_plain(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos):
    """What ``df_cov_fwd`` computes (``_fwd_cell`` over a whole slab): df
    S_p = sum bi E bj and corr = sum iK E, each reduced over k, then over n."""
    eh, el = _e_slab_df(ah, al, ch, cl, uh, ul, xjh, xjl)
    wh, wl = df_mul(eh, el, bih[:, :, None], bil[:, :, None])
    wh, wl = df_mul(wh, wl, bjh[:, None, :], bjl[:, None, :])
    sp_h, sp_l = df_sum(*df_sum(wh, wl, axis=-1), axis=-1)
    dpos = _index(diag_pos, ah.device, torch.long)
    qh, ql = df_mul(eh.index_select(0, dpos), el.index_select(0, dpos), ikh, ikl)
    co_h, co_l = df_sum(*df_sum(qh, ql, axis=-1), axis=-1)
    return sp_h, sp_l, co_h, co_l


def df_cov_fwdres_plain(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos):
    """What ``df_cov_fwdres`` computes (``_fwdres_cell`` over a whole slab):
    (rows, cols), each a list of 4 + 4 ns f32 (P, N) tensors
    [A1h, A1l, A2h, A2l, B1_0h, B1_0l, ..., B2_0h, B2_0l, ...] and
    [C1h, C1l, C2h, C2l, D1_0h, ..., D2_0h, ...]; the iK-weighted ones are
    zero on off-diagonal pairs."""
    p = ah.shape[0]
    ns = uh.shape[-1]
    eh, el = _e_slab_df(ah, al, ch, cl, uh, ul, xjh, xjl)
    ikph, ikpl = _ik_pairs(ikh, ikl, p, diag_pos)
    wbh, wbl = df_mul(eh, el, bjh[:, None, :], bjl[:, None, :])
    qh, ql = df_mul(eh, el, ikph, ikpl)
    vbh, vbl = df_mul(eh, el, bih[:, :, None], bil[:, :, None])

    def rsum(h, l):
        return df_sum(h, l, axis=-1)

    def csum(h, l):
        return df_sum(h, l, axis=-2)

    row = [rsum(wbh, wbl), rsum(qh, ql)]
    row += [rsum(*df_mul(wbh, wbl, xjh[:, None, :, e], xjl[:, None, :, e])) for e in range(ns)]
    row += [rsum(*df_mul(qh, ql, xjh[:, None, :, e], xjl[:, None, :, e])) for e in range(ns)]
    col = [csum(vbh, vbl), csum(qh, ql)]
    col += [csum(*df_mul(vbh, vbl, uh[:, :, None, e], ul[:, :, None, e])) for e in range(ns)]
    col += [csum(*df_mul(qh, ql, uh[:, :, None, e], ul[:, :, None, e])) for e in range(ns)]
    return [t for pair in row for t in pair], [t for pair in col for t in pair]


def _bwd_side_plain(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikph, ikpl, gs, gco):
    """One side of the stacked backward (``_bwd_cell`` over whole slabs):
    rows (a, U, bi) against columns (c, Xj, bj), iK (P, rows, columns) per
    pair (zero off the diagonal). ga (P, rows), gU (P, rows, ns) in f32."""
    gs, gco = gs[:, None, None], gco[:, None, None]
    eh, el = _e_slab_df(ah, al, ch, cl, uh, ul, xjh, xjl)
    wh, wl = df_mul_f32(*df_mul(bih[:, :, None], bil[:, :, None], bjh[:, None, :], bjl[:, None, :]), gs)
    wh, wl = df_add(wh, wl, *df_mul_f32(ikph, ikpl, gco))
    geh, gel = df_mul(wh, wl, eh, el)
    ga = (lambda s: s[0] + s[1])(df_sum(geh, gel, axis=-1))
    gu = [(lambda s: s[0] + s[1])(df_sum(*df_mul(geh, gel, xjh[:, None, :, e], xjl[:, None, :, e]), axis=-1))
          for e in range(uh.shape[-1])]
    return ga, torch.stack(gu, dim=-1)


def df_cov_bwd_plain(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, gs, gco, diag_pos):
    """What ``df_cov_bwd`` computes (``_bwd_cell`` over both sides' whole
    slabs): (ga (P, Nr), gc (P, Nc), gU (P, Nr, ns), gXj (P, Nc, ns)) in f32
    at the cotangents gs (P,) and gco (P,), gco zero off the diagonal pairs.
    The column side runs with the roles swapped, on iK's row slab where the
    slabs are square (iK is symmetric there, as the kernel reads it) and on
    its transpose where they are not."""
    ikph, ikpl = _ik_pairs(ikh, ikl, ah.shape[0], diag_pos)
    ga, gu = _bwd_side_plain(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikph, ikpl, gs, gco)
    if ah.shape[1] != ch.shape[1]:
        ikph, ikpl = ikph.transpose(1, 2), ikpl.transpose(1, 2)
    gc, gxj = _bwd_side_plain(ch, cl, ah, al, xjh, xjl, uh, ul, bjh, bjl, bih, bil, ikph, ikpl, gs, gco)
    return ga, gc, gu, gxj


def df_cov_abs_terms(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos):
    """The sum of the absolute values of the terms of every output of the two
    kernels, in f64 from the collapsed operands: (S_p, corr) scales and the
    (rows, cols) residual scales, each residual's scale given for its hi and
    lo entry alike. A compensated sum's error is bounded by a small multiple
    of eps32^2 times this, whatever the order of summation."""
    f64 = torch.float64

    def v(h, l):
        return h.to(f64) + l.to(f64)

    a, c, u, xj = v(ah, al), v(ch, cl), v(uh, ul), v(xjh, xjl)
    bi, bj, ik = v(bih, bil).abs(), v(bjh, bjl).abs(), v(ikh, ikl).abs()
    p = a.shape[0]
    e = torch.exp(torch.clamp(a[:, :, None] + c[:, None, :] + torch.einsum("pne,pke->pnk", u, xj), max=60.0))
    dpos = _index(diag_pos, a.device, torch.long)
    ikp = torch.zeros((p,) + tuple(ik.shape[1:]), dtype=f64, device=a.device).index_copy(0, dpos, ik)
    sp = torch.einsum("pn,pnk,pk->p", bi, e, bj)
    corr = torch.einsum("mnk,mnk->m", ik, e.index_select(0, dpos))
    q = ikp * e
    row = [torch.einsum("pnk,pk->pn", e, bj), q.sum(-1)]
    row += [torch.einsum("pnk,pk->pn", e, bj * xj[..., i].abs()) for i in range(u.shape[-1])]
    row += [torch.einsum("pnk,pk->pn", q, xj[..., i].abs()) for i in range(u.shape[-1])]
    col = [torch.einsum("pnk,pn->pk", e, bi), q.sum(-2)]
    col += [torch.einsum("pnk,pn->pk", e, bi * u[..., i].abs()) for i in range(u.shape[-1])]
    col += [torch.einsum("pnk,pn->pk", q, u[..., i].abs()) for i in range(u.shape[-1])]
    return (sp, corr), ([t for t in row for _ in range(2)], [t for t in col for _ in range(2)])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_NAMES = ("ah", "al", "ch", "cl", "uh", "ul", "xjh", "xjl", "bih", "bil", "bjh", "bjl", "ikh", "ikl")


def _check(name: str, args, diag_pos) -> Tuple[int, int, int, int]:
    """Device, dtype, shape and contiguity of the 14 operands; (P, Nr, Nc, ns)."""
    device = args[0].device
    for arg, t in zip(_NAMES, args):
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes float32 (hi, lo) halves only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    p, nr = args[0].shape
    nc = args[2].shape[1]
    ns = args[4].shape[2]
    shapes = [(p, nr), (p, nc), (p, nr, ns), (p, nc, ns), (p, nr), (p, nc), (len(diag_pos), nr, nc)]
    for i, shape in enumerate(shapes):
        for t in args[2 * i:2 * i + 2]:
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: operand shape {tuple(t.shape)}, expected {shape}")
    if not 1 <= ns <= MAX_NS:
        raise NotImplementedError(f"{name}: the kernels take 1 <= ns <= {MAX_NS} state dims, got {ns}")
    return p, nr, nc, ns


def _ptrs(args):
    return [t.data_ptr() for t in args]


FWD_MAX_ROWS = 20  # kFwdMaxWarps of csrc/df_cov.cu: a band's rows, a warp each


def fwd_elem_cost(ns: int, diag: bool) -> int:
    """f32 instructions per slab element of ``df_fwd``, from the counts of
    csrc/df32.cuh's operations (df_add 11, df_mul 32, df_exp 566; the
    exponent's two_sum and fast_two_sum 11, its cap 1): E, the S_p term
    bi E bj and its sum, and on a diagonal pair the corr term iK E and its
    sum (chip_smoke.df_instructions_per_element counts the same)."""
    df_add, df_mul, df_exp = 11, 32, 566
    e = 11 + ns * (df_mul + df_add) + 1 + df_exp
    return e + 2 * df_mul + df_add + (df_mul + df_add if diag else 0)


FWD_SCHEDULERS = 4  # warp schedulers of an SM: a block's warp w runs on scheduler w % 4


@functools.lru_cache(maxsize=None)
def fwd_launch_plan(p: int, n: int, diag_pos: Tuple[int, ...], ns: int, sms: int) -> dict:
    """The row bands of ``df_fwd`` for P pairs of N rows on a card with
    ``sms`` SMs. Block b takes the bands of pair 0, then of pair 1, ... (a
    pair of ``rows`` rows per band has ceil(N / rows) bands, the last one
    shorter); warp w of band t owns the row t rows + w (w < rows), its lanes
    the columns lane + 32 j. A diagonal pair's bands have ``rows_diag`` rows,
    another's ``rows_off``. A block runs one warp per row, spread over the
    SM's FWD_SCHEDULERS warp schedulers, so it takes as long as its busiest
    scheduler: ceil(rows / 4) rows of ``fwd_elem_cost`` each. The plan is the
    (rows_diag, rows_off), each at most FWD_MAX_ROWS and N, whose bands fit
    one wave of one block per SM with the least such time, on a tie the
    fewest blocks; where none fits, the longest bands. ``threads`` is the
    block: 32 times the longer band."""
    kinds = set(diag_pos)
    cd, co = fwd_elem_cost(ns, True), fwd_elem_cost(ns, False)
    cap = min(FWD_MAX_ROWS, n)

    def cost(rows_d, rows_o):
        bands_d, bands_o = -(-n // rows_d), -(-n // rows_o)
        blocks = len(kinds) * bands_d + (p - len(kinds)) * bands_o
        busiest = max(-(-rows_d // FWD_SCHEDULERS) * cd if kinds else 0,
                      -(-rows_o // FWD_SCHEDULERS) * co if len(kinds) < p else 0)
        return (blocks > sms, busiest, blocks), (rows_d, rows_o, blocks, max(bands_d, bands_o))

    rows_d_all = range(1, cap + 1) if kinds else (cap,)
    rows_o_all = range(1, cap + 1) if len(kinds) < p else (cap,)
    key, (rows_d, rows_o, blocks, max_bands) = min(cost(rd, ro) for rd in rows_d_all for ro in rows_o_all)
    if key[0]:  # no plan fits one wave
        rows_d, rows_o, blocks, max_bands = cost(cap, cap)[1]
    return dict(rows_diag=rows_d, rows_off=rows_o, blocks=blocks, max_bands=max_bands,
                threads=32 * max(rows_d if kinds else 1, rows_o if len(kinds) < p else 1))


def df_cov_fwd(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos, batch: int = 1):
    """(S_p h, l (P,), corr h, l (n_diag,)). A CPU tensor takes the plain twin;
    a CUDA tensor launches the kernel or raises. On the card the four are
    views of the summing launch's one output: no PyTorch operation follows
    the kernels. ``batch``: the pairs are that many batch elements
    (``moment_cov.element_pairs``), and the bands are planned for one."""
    args = (ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl)
    if ah.device.type == "cpu":
        return df_cov_fwd_plain(*args, diag_pos)
    p, nr, nc, ns = _check("df_cov_fwd", args, diag_pos)
    diag_pos = tuple(diag_pos)
    if not all(0 <= q < p for q in diag_pos):  # the summing launch reads pair diag_pos[m]'s partials
        raise ValueError(f"df_cov_fwd: diag_pos {diag_pos} outside the {p} pairs")
    lib = _build.load()
    pe, de = element_pairs(p, diag_pos, batch)
    plan = fwd_launch_plan(pe, nr, de, ns, _build.sm_count(ah.device))
    part = torch.empty((2, p, plan["max_bands"], 2), dtype=torch.float32, device=ah.device)
    out = torch.empty((2, p + len(diag_pos)), dtype=torch.float32, device=ah.device)
    rc = lib.gpmpc_df_fwd_f32(*_ptrs(args), _index(diag_pos, ah.device, torch.int32).data_ptr(), len(diag_pos),
                              part.data_ptr(), out.data_ptr(), p, nr, nc, ns, plan["rows_diag"], plan["rows_off"],
                              plan["max_bands"], plan["blocks"] * batch,
                              torch.cuda.current_stream(ah.device).cuda_stream)
    _build.check(rc, "df_cov_fwd")
    LAUNCHES["df_fwd"] += 1
    return out[0, :p], out[1, :p], out[0, p:], out[1, p:]


def fwd_launch_info(p: int, n: int, diag_pos: Tuple[int, ...], ns: int) -> dict:
    """``df_fwd``'s launch at (P, N, diag_pos) on the current card
    (``_build.launch_info``), with the rows per band of a diagonal pair and
    of another pair."""
    plan = fwd_launch_plan(p, n, tuple(diag_pos), ns, _build.sm_count(torch.device("cuda")))
    return _build.launch_info("gpmpc_df_fwd_info", ns, plan["rows_diag"], plan["rows_off"], plan["max_bands"],
                              plan["blocks"], extra=("rows_diag", "rows_off"))


def df_cov_fwdres(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos, batch: int = 1):
    """(rows, cols): the 4 + 4 ns row-side and column-side residuals as in
    ``df_cov_fwdres_plain``. A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernel or raises. ``batch`` as in ``df_cov_fwd`` (the C
    side plans the bands, csrc/df_cov.cu fwdres_bands)."""
    args = (ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl)
    if ah.device.type == "cpu":
        return df_cov_fwdres_plain(*args, diag_pos)
    p, nr, nc, ns = _check("df_cov_fwdres", args, diag_pos)
    lib = _build.load()
    nv = 2 + 2 * ns
    element_pairs(p, diag_pos, batch)
    max_bands = lib.gpmpc_df_fwdres_max_bands(p, nr, len(diag_pos), ns, batch)
    dev = ah.device
    col_part = torch.empty((2, p, max_bands, nv, nc), dtype=torch.float32, device=dev)
    row_out = torch.empty((2, p, nv, nr), dtype=torch.float32, device=dev)
    col_out = torch.empty((2, p, nv, nc), dtype=torch.float32, device=dev)
    rc = lib.gpmpc_df_fwdres_f32(*_ptrs(args), _index(diag_pos, dev, torch.int32).data_ptr(), len(diag_pos),
                                 col_part.data_ptr(), row_out.data_ptr(), col_out.data_ptr(), p, nr, nc, ns, batch,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "df_cov_fwdres")
    LAUNCHES["df_fwdres"] += 1
    rows = [row_out[h, :, v] for v in range(nv) for h in range(2)]
    cols = [col_out[h, :, v] for v in range(nv) for h in range(2)]
    return rows, cols


def fwdres_launch_info(p: int, nr: int, n_diag: int, ns: int, batch: int = 1) -> dict:
    """``df_fwdres``'s launch at (P, Nr, n_diag) on the current card
    (``_build.launch_info``), with the rows per band of a diagonal pair and
    of another pair."""
    return _build.launch_info("gpmpc_df_fwdres_info", p, nr, n_diag, ns, batch, extra=("rows_diag", "rows_off"))


def df_cov_bwd(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, gs, gco, diag_pos):
    """(ga (P, Nr), gc (P, Nc), gU (P, Nr, ns), gXj (P, Nc, ns)) of the
    stacked backward, as in ``df_cov_bwd_plain``: one launch on square
    slabs, one per side on rectangular ones. A CPU tensor takes the plain
    twin; a CUDA tensor launches the kernel or raises."""
    args = (ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl)
    if ah.device.type == "cpu":
        return df_cov_bwd_plain(*args, gs, gco, diag_pos)
    p, nr, nc, ns = _check("df_cov_bwd", args, diag_pos)
    for arg, t in (("gs", gs), ("gco", gco)):
        if t.dtype != torch.float32:
            raise TypeError(f"df_cov_bwd: {arg} is {t.dtype}; the kernel takes float32 only")
        if t.device != ah.device or tuple(t.shape) != (p,) or not t.is_contiguous():
            raise ValueError(f"df_cov_bwd: {arg} must be a contiguous ({p},) tensor on {ah.device}")
    lib = _build.load()
    dev = ah.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    diag = _index(diag_pos, dev, torch.int32).data_ptr()
    ga = torch.empty(p * (nr + nc), dtype=torch.float32, device=dev)  # the row side's rows, then the column side's
    gu = torch.empty((p * (nr + nc), ns), dtype=torch.float32, device=dev)
    if nr == nc:
        rc = lib.gpmpc_df_bwd_f32(*_ptrs(args), gs.data_ptr(), gco.data_ptr(), diag, len(diag_pos),
                                  ga.data_ptr(), gu.data_ptr(), p, nr, ns, stream)
        _build.check(rc, "df_cov_bwd")
        LAUNCHES["df_bwd"] += 1
    else:
        for side, off in ((0, 0), (1, p * nr)):
            rc = lib.gpmpc_df_bwd_side_f32(*_ptrs(args), gs.data_ptr(), gco.data_ptr(), diag, len(diag_pos),
                                           ga[off:].data_ptr(), gu[off:].data_ptr(), p, nr, nc, ns, side, stream)
            _build.check(rc, "df_cov_bwd")
            LAUNCHES["df_bwd"] += 1
    r = p * nr
    return ga[:r].view(p, nr), ga[r:].view(p, nc), gu[:r].view(p, nr, ns), gu[r:].view(p, nc, ns)


# ---------------------------------------------------------------------------
# autograd composites
# ---------------------------------------------------------------------------


class DfCovCore(torch.autograd.Function):
    """df (S_p, corr) whose backward is the residual scheme of
    ``_make_core`` (gpmpc_tpu/ops/pallas_df_cov.py:549-638): the forward
    launches ``df_cov_fwdres`` and forms S_p = sum_n bi A1 and
    corr = sum_n A2[diag] in df; the backward combines the residuals with
    the hi cotangents only (the df custom JVPs carry tangents as (dv, 0), so
    adding the lo cotangent would double the gradient) and returns gradients
    for a, c, U and Xj. The lo halves, beta and iK get none: beta and iK are
    factorization-cache constants while planning."""

    @staticmethod
    def forward(ctx, ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos, batch=1):
        diag_pos = tuple(diag_pos)
        rows, cols = df_cov_fwdres(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos, batch)
        a1h, a1l, a2h, a2l = rows[:4]
        sp_h, sp_l = df_sum(*df_mul(bih, bil, a1h, a1l), axis=-1)
        co_h, co_l = df_sum(a2h, a2l, axis=-1)
        d = _index(diag_pos, ah.device, torch.long)
        ctx.diag_pos = diag_pos
        ctx.ns = uh.shape[-1]
        ctx.save_for_backward(bih, bil, bjh, bjl, *rows, *cols)
        return sp_h, sp_l, co_h.index_select(0, d), co_l.index_select(0, d)

    @staticmethod
    def backward(ctx, ct_sh, ct_sl, ct_ch, ct_cl):
        ns = ctx.ns
        bih, bil, bjh, bjl, *res = ctx.saved_tensors
        nres = 4 + 4 * ns
        rows, cols = res[:nres], res[nres:]
        p = bih.shape[0]
        gs = ct_sh[:, None]  # (P, 1), hi cotangent only
        gco = torch.zeros(p, dtype=ct_ch.dtype, device=ct_ch.device).index_copy(
            0, _index(ctx.diag_pos, ct_ch.device, torch.long), ct_ch)[:, None]

        def combine(w1h, w1l, r1h, r1l, r2h, r2l):
            # gs w1 r1 (+) gco r2, in df until the final collapse
            th, tl = df_mul_f32(*df_mul(w1h, w1l, r1h, r1l), gs)
            sh, sl = df_mul_f32(r2h, r2l, gco)
            oh, ol = df_add(th, tl, sh, sl)
            return oh + ol

        def side(w1h, w1l, res):
            # value 0 and 1 (A1, A2 / C1, C2), then each e: B1_e with B2_e / D1_e with D2_e
            g = combine(w1h, w1l, *res[0:4])
            ge = [combine(w1h, w1l, *res[4 + 2 * e:6 + 2 * e], *res[4 + 2 * (ns + e):6 + 2 * (ns + e)])
                  for e in range(ns)]
            return g, torch.stack(ge, dim=-1)

        ga, gu = side(bih, bil, rows)
        gc, gxj = side(bjh, bjl, cols)
        return (ga, None, gc, None, gu, None, gxj, None, None, None, None, None, None, None, None, None)


class DfCovCoreStacked(torch.autograd.Function):
    """df (S_p, corr) whose backward is the stacked scheme of ``_make_core``
    (gpmpc_tpu/ops/pallas_df_cov.py:643-700, ``GPMPC_DF_COV_VJP=stacked``):
    the forward is the lean forward (``df_cov_fwd``) and saves the operands;
    the backward is ``df_cov_bwd`` over the row side and the role-swapped
    column side (one launch on square slabs, one per side on rectangular
    ones), with the hi cotangents only (see DfCovCore). It returns
    gradients for a, c, U and Xj."""

    @staticmethod
    def forward(ctx, ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos, batch=1):
        ctx.diag_pos = tuple(diag_pos)
        ctx.save_for_backward(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl)
        return df_cov_fwd(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, ctx.diag_pos, batch)

    @staticmethod
    def backward(ctx, ct_sh, ct_sl, ct_ch, ct_cl):
        args = ctx.saved_tensors
        p = args[0].shape[0]
        gs = ct_sh.contiguous()  # hi cotangent only
        gco = torch.zeros(p, dtype=ct_ch.dtype, device=ct_ch.device).index_copy(
            0, _index(ctx.diag_pos, ct_ch.device, torch.long), ct_ch)
        ga, gc, gu, gxj = df_cov_bwd(*args, gs, gco, ctx.diag_pos)
        return (ga, None, gc, None, gu, None, gxj, None, None, None, None, None, None, None, None, None)

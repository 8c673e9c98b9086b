"""Moment-matching covariance core: CUDA kernels, their plain twins and the
autograd composite.

The pairwise kernel matrix of one moment-matching step,

  E[p, n, k] = exp(min(a[p, n] + c[p, k] + U[p, n, :] . Xj[p, k, :], 60)),

is consumed only through two contractions:

  S_p[p]  = sum_{n,k} bi[p, n] E[p, n, k] bj[p, k]          (P,)
  corr[m] = sum_{n,k} iK[m, n, k] E[diag_pos[m], n, k]       (Ns,)

Kernels (``csrc/cov_core.cu``), each replacing a Pallas TPU kernel of
``gpmpc_tpu/ops/pallas_moment_cov.py``:

* ``cov_fwd`` replaces ``_cov_fwd_kernel`` (via ``_cov_fwd_call``). Row
  bands: a block owns a band of rows of one pair against all N columns, a
  thread one column (its operands in registers) against every m-th row of
  the band, m = 1024 // N row groups (the same work per thread to within
  one element, a warp's iK reads contiguous), and the bands of all pairs
  fit one wave of one block per SM where they can (``fwd_launch_plan``).
  Each block writes one partial of bi E bj (and of iK E on diagonal
  pairs); a second launch, a programmatic dependent, adds each output's
  partials in a fixed order and writes S_p and corr, so no PyTorch
  reduction follows the kernel. The forward itself is a programmatic
  dependent of the kernel before it on the stream.
* ``cov_bwd`` replaces ``_bwd_row_kernel`` (via ``_bwd_row_call``), which
  the reference launches once per side. One launch runs both sides on 2P
  stacked rows (``bwd_launch_plan``): rows P..2P-1 are the column side, with
  (a, U, wr) and (c, Xj, wc) swapped, and read iK's row slab at their own
  row index (iK is symmetric in the square case). On a rectangular slab (Nr
  rows against Nc columns, a rank's slab of the N-sharded core) the same
  launch runs the column side's Nc rows on iK's transpose, which it reads
  down the untransposed slab's columns at stride Nc (the reference's second
  launch on ``swapaxes(ik)``, pallas_moment_cov.py:271, without the copy).
  One warp per stacked row
  reducing over its columns: with W = g wr wc^T E + g_corr iK E it writes
  ga = rowsum W, gU = W Xj and g_wr = g (E wc). A lane's iK entries and the
  block's column operands (staged in shared memory) are loaded before any
  E, and its columns are unrolled. The corr cotangent is read in diag_pos
  order through each pair's slot, so ``CovCore.backward`` runs no PyTorch
  scatter before the launch; the launch is a programmatic dependent of the
  kernel before it. Its launch count keeps the key ``cov_bwd_row``: one per
  backward.
* ``cov_gik`` replaces ``_gik_kernel`` (via ``_gik_call``): the gradient
  with respect to iK, gK[m] = g_corr[m] E[diag_pos[m]] (Ns, Nr, Nc). One
  wave of row bands in blocks of up to 1,024 threads (``gik_launch_plan``):
  a thread loads the operands of a row and 4 consecutive columns of the
  diagonal pair (16-byte loads where aligned), computes their 4 E and
  writes them with one 16-byte store, its row and columns found from its
  2-D index without a division; E by the same f32 operations as the
  forward, so gK keeps its bits. A programmatic dependent of the kernel
  before it (``cov_bwd`` in ``CovCore.backward``), so its launch overlaps
  that kernel's tail. ``CovCore.backward`` launches it, as a launch of its own,
  only when iK needs a gradient (the reference's separate call, which XLA
  drops when nothing consumes it): iK is constant while planning, so a
  planning step launches it zero times.

What bounds them on an H100: at the flagship shape (P=6, N=384, ns=3) each
call reads the 1.77 MB iK slab once and evaluates 0.9 M exps (the backward
1.8 M, both sides), about half a microsecond of memory traffic at 3.35 TB/s,
so launch latency (~2 us per launch) and dependent memory latency dominate:
the forward issues a thread's column operands and iK loads together, before
the band's rows are staged, the backward a lane's iK entries before the
column operands are staged, and each hides its launch's start behind the
kernel before it. The design keeps E out of device memory entirely
(recomputed in the backward, never stored) and uses no atomics, so results
repeat bitwise. ``cov_gik`` writes its 1.77 MB output once: by bytes that
bounds it (0.53 us), in practice its launch and its latency do (a launch
that does nothing costs ~1.9 us of device time per call, ~1.0 us as a
programmatic dependent, ``_build.empty_launch``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .lanewise import lanewise

LAUNCHES = {"cov_fwd": 0, "cov_bwd_row": 0, "cov_gik": 0}

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
    return lanewise(torch.exp, torch.clamp(expo, max=60.0))


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


MAX_NS = 8  # GPMPC_MAX_NS of csrc/cov_core.cu: a row's ns values live in fixed arrays
FWD_MAX_ROWS = 1024  # kFwdMaxRows of csrc/cov_core.cu: a band's row operands fill shared memory


def fwd_launch_plan(p: int, n: int, sms: int) -> Tuple[int, int]:
    """(rows per band, bands per pair) of ``cov_fwd`` for P pairs of N rows
    on a card with ``sms`` SMs. Block b takes band t = b % bands of pair
    b // bands, rows t rows to (t + 1) rows (the last band of a pair
    shorter), against all N columns. rows is the least whose P bands fit one
    block per SM, so the grid is one wave; with more pairs than SMs, or past
    FWD_MAX_ROWS rows, more waves."""
    rows = max(1, -(-p * n // sms))
    while rows < n and p * -(-n // rows) > sms:
        rows += 1
    rows = min(rows, n, FWD_MAX_ROWS)
    return rows, -(-n // rows)


def element_pairs(p: int, diag_pos, batch: int) -> Tuple[int, Tuple[int, ...]]:
    """(pairs, diagonal pairs) of one batch element of a launch whose P pairs
    are ``batch`` elements of P / batch pairs each, element b's diagonal
    pairs at b P / batch + those of element 0 (``models.gp`` folds a
    batched rollout so): the launch is planned for one element, so that an
    element sums in the same order whatever the batch."""
    diag_pos = tuple(diag_pos)
    pe, de = p // max(batch, 1), len(diag_pos) // max(batch, 1)
    if batch < 1 or p % batch or len(diag_pos) % batch or diag_pos != tuple(
            b * pe + q for b in range(batch) for q in diag_pos[:de]):
        raise ValueError(f"{p} pairs with diag_pos {diag_pos} are not {batch} batch elements of one pattern")
    return pe, diag_pos[:de]


def _check_ns(name: str, ns: int) -> None:
    """Refuse, before the launch, a state width the kernels do not take."""
    if not 1 <= ns <= MAX_NS:
        raise NotImplementedError(f"{name}: the kernels take 1 <= ns <= {MAX_NS} state dims, got {ns}")


def cov_fwd(a, c, u, xj, bi, bj, ik, diag_pos, batch: int = 1):
    """(S_p (P,), corr (n_diag,)). A CPU tensor takes the plain version
    (cov_core_ref); a CUDA tensor launches the kernel or raises. ``batch``:
    the pairs are that many batch elements (``element_pairs``), and the
    bands are planned for one."""
    if a.device.type == "cpu":
        return cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos)
    _check_cuda_f32("cov_fwd", a=a, c=c, u=u, xj=xj, bi=bi, bj=bj, ik=ik)
    p, nr = a.shape
    nc = c.shape[1]
    ns = u.shape[2]
    if u.shape != (p, nr, ns) or xj.shape != (p, nc, ns) or bi.shape != (p, nr) \
            or bj.shape != (p, nc) or ik.shape != (len(diag_pos), nr, nc):
        raise ValueError("cov_fwd: inconsistent shapes")
    _check_ns("cov_fwd", ns)
    if not all(0 <= q < p for q in diag_pos):  # the summing launch reads pair diag_pos[m]'s partials
        raise ValueError(f"cov_fwd: diag_pos {tuple(diag_pos)} outside the {p} pairs")
    lib = _build.load()
    rows, bands = fwd_launch_plan(element_pairs(p, diag_pos, batch)[0], nr, _build.sm_count(a.device))
    part = torch.empty((2, p * bands), dtype=torch.float32, device=a.device)
    out = torch.empty(p + len(diag_pos), dtype=torch.float32, device=a.device)
    rc = lib.gpmpc_cov_fwd_f32(
        a.data_ptr(), c.data_ptr(), u.data_ptr(), xj.data_ptr(), bi.data_ptr(),
        bj.data_ptr(), ik.data_ptr(), _index(diag_pos, a.device, torch.int32).data_ptr(), len(diag_pos),
        part.data_ptr(), out.data_ptr(), p, nr, nc, ns, rows, bands,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "cov_fwd")
    LAUNCHES["cov_fwd"] += 1
    return out[:p], out[p:]


def fwd_launch_info(p: int, n: int, ns: int) -> dict:
    """``cov_fwd``'s launch at (P, N, ns) on the current card
    (``_build.launch_info``), with the rows of a band."""
    rows, bands = fwd_launch_plan(p, n, _build.sm_count(torch.device("cuda")))
    return _build.launch_info("gpmpc_cov_fwd_info", p, n, ns, rows, bands, extra=("rows",))


# ---------------------------------------------------------------------------
# backward kernel (both sides) and its plain twins
# ---------------------------------------------------------------------------


BWD_WARPS = 8  # kBwdWarps of csrc/cov_core.cu: stacked rows of a block, a warp each
BWD_LANE_COLS = 12  # kBwdCols of csrc/cov_core.cu: a lane's columns per batch of 32 BWD_LANE_COLS


def bwd_launch_plan(p: int, nr: int, nc: int = None) -> dict:
    """The grid of ``cov_bwd`` for P pairs of Nr rows against Nc columns (Nc
    = Nr unless given): block (x, s), x < ``row_blocks``, s < 2P, owns the
    stacked rows x BWD_WARPS + w, w < BWD_WARPS (a warp each; rows past its
    side's idle), of stacked pair s: the row side of pair s (Nr rows, Nc
    columns) for s < P, the column side of pair s - P (Nc rows, Nr columns)
    otherwise. A lane takes the columns lane + 32 j of each batch of 32
    BWD_LANE_COLS; ``batches`` is the most a side has."""
    nc = nr if nc is None else nc
    n = max(nr, nc)
    return dict(row_blocks=-(-n // BWD_WARPS), stacked_pairs=2 * p, threads=32 * BWD_WARPS,
                batches=-(-n // (32 * BWD_LANE_COLS)))


def cov_bwd_row_plain(g, a, c, u, xj, wr, wc, ik, gco, diag_pos):
    """One side of ``cov_bwd``, in plain PyTorch: the row side as written,
    the column side with (a, c), (U, Xj) and (wr, wc) swapped.

    With W = g wr wc^T E + gco iK_slot E (gco (P,), zero off the diagonal
    pairs): (rowsum W, W Xj, g (E wc))."""
    e = _e_slab(a, c, u, xj)
    ewc = e * wc[:, None, :]
    w = (g[:, None, None] * wr[:, :, None]) * ewc
    corr_w = torch.zeros_like(e)
    for m, p in enumerate(diag_pos):
        corr_w[p] = gco[p] * ik[m] * e[p]
    w = w + corr_w
    return w.sum(dim=2), torch.einsum("pnk,pke->pne", w, xj), g[:, None] * ewc.sum(dim=2)


def cov_bwd_plain(g, a, c, u, xj, bi, bj, ik, g_corr, diag_pos):
    """What ``cov_bwd`` computes, in plain PyTorch (the CPU path): the two
    one-side calls, the corr cotangent scattered to the pair axis; the
    column side on iK's row slab where the slabs are square (iK is
    symmetric there, as the kernel reads it), on its transpose (Nc, Nr)
    where they are not. (ga, gc, gU, gXj, gbi, gbj)."""
    gco = torch.zeros(a.shape[0], dtype=g_corr.dtype, device=g_corr.device).index_copy(
        0, _index(diag_pos, g_corr.device, torch.long), g_corr)
    ik_col = ik if a.shape[1] == c.shape[1] else ik.transpose(1, 2)
    ga, gu, gbi = cov_bwd_row_plain(g, a, c, u, xj, bi, bj, ik, gco, diag_pos)
    gc, gxj, gbj = cov_bwd_row_plain(g, c, a, xj, u, bj, bi, ik_col, gco, diag_pos)
    return ga, gc, gu, gxj, gbi, gbj


def cov_fwd_abs_terms(a, c, u, xj, bi, bj, ik, diag_pos):
    """Sum of the absolute values of the terms of each ``cov_fwd`` output.
    The rounding error of an f32 sum is bounded by a small multiple of
    eps32 times it, whatever the order of summation; E > 0 keeps its
    exponent, only the factors are taken absolute."""
    return cov_core_ref(a, c, u, xj, bi.abs(), bj.abs(), ik.abs(), diag_pos)


def cov_bwd_row_abs_terms(g, a, c, u, xj, wr, wc, ik, gco, diag_pos):
    """Sum of the absolute values of the terms of each output of one side
    of ``cov_bwd`` (see cov_fwd_abs_terms): E keeps its signed exponent, the
    factors g, wr, wc, gco, iK and, in gU, Xj are taken absolute."""
    e = _e_slab(a, c, u, xj)
    ewc = e * wc.abs()[:, None, :]
    w = (g.abs()[:, None, None] * wr.abs()[:, :, None]) * ewc
    corr_w = torch.zeros_like(e)
    for m, p in enumerate(diag_pos):
        corr_w[p] = gco[p].abs() * ik[m].abs() * e[p]
    w = w + corr_w
    return w.sum(dim=2), torch.einsum("pnk,pke->pne", w, xj.abs()), g.abs()[:, None] * ewc.sum(dim=2)


def cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, diag_pos):
    """(ga (P, Nr), gc (P, Nc), gU (P, Nr, ns), gXj (P, Nc, ns), gbi (P, Nr),
    gbj (P, Nc)): the cov core's backward on both sides at the S_p
    cotangent g (P,) and the corr cotangent g_corr (n_diag,), in diag_pos
    order, on square or rectangular (Nr != Nc) slabs. A CPU tensor takes
    the plain twin; a CUDA tensor launches the kernel once or raises."""
    if a.device.type == "cpu":
        return cov_bwd_plain(g, a, c, u, xj, bi, bj, ik, g_corr, diag_pos)
    _check_cuda_f32("cov_bwd", g=g, a=a, c=c, u=u, xj=xj, bi=bi, bj=bj, ik=ik, g_corr=g_corr)
    p, nr = a.shape
    nc = c.shape[1]
    ns = u.shape[2]
    if g.shape != (p,) or g_corr.shape != (len(diag_pos),) or c.shape != (p, nc) or u.shape != (p, nr, ns) \
            or xj.shape != (p, nc, ns) or bi.shape != (p, nr) or bj.shape != (p, nc) \
            or ik.shape != (len(diag_pos), nr, nc):
        raise ValueError("cov_bwd: inconsistent shapes")
    _check_ns("cov_bwd", ns)
    if not all(0 <= q < p for q in diag_pos):  # a diagonal pair reads its slot's iK slab and cotangent
        raise ValueError(f"cov_bwd: diag_pos {tuple(diag_pos)} outside the {p} pairs")
    lib = _build.load()
    plan = bwd_launch_plan(p, nr, nc)
    ga = torch.empty(p * (nr + nc), dtype=torch.float32, device=a.device)
    gu = torch.empty((p * (nr + nc), ns), dtype=torch.float32, device=a.device)
    gw = torch.empty(p * (nr + nc), dtype=torch.float32, device=a.device)
    rc = lib.gpmpc_cov_bwd_f32(
        g.data_ptr(), a.data_ptr(), c.data_ptr(), u.data_ptr(), xj.data_ptr(), bi.data_ptr(), bj.data_ptr(),
        ik.data_ptr(), g_corr.data_ptr(), _index(diag_pos, a.device, torch.int32).data_ptr(), len(diag_pos),
        ga.data_ptr(), gu.data_ptr(), gw.data_ptr(), p, nr, nc, ns, plan["row_blocks"],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "cov_bwd")
    LAUNCHES["cov_bwd_row"] += 1
    r = p * nr  # the row side's rows, then the column side's
    return (ga[:r].view(p, nr), ga[r:].view(p, nc), gu[:r].view(p, nr, ns), gu[r:].view(p, nc, ns),
            gw[:r].view(p, nr), gw[r:].view(p, nc))


def bwd_launch_info(p: int, n: int, ns: int) -> dict:
    """``cov_bwd``'s launch at (P, N, ns) on the current card
    (``_build.launch_info``)."""
    return _build.launch_info("gpmpc_cov_bwd_info", p, n, ns)


# ---------------------------------------------------------------------------
# iK gradient kernel and its plain twin
# ---------------------------------------------------------------------------


def cov_gik_plain(g_corr, a, c, u, xj, diag_pos):
    """What ``cov_gik`` computes, in plain PyTorch (the CPU path): the
    gradient with respect to iK, g_corr[m] E[diag_pos[m]] (Ns, Nr, Nc)."""
    d = _index(diag_pos, a.device, torch.long)
    e = _e_slab(a.index_select(0, d), c.index_select(0, d), u.index_select(0, d), xj.index_select(0, d))
    return g_corr[:, None, None] * e


def cov_gik_expo_abs(a, c, u, xj, diag_pos):
    """|a| + |c| + sum_e |U_e Xj_e| of each element of the diagonal pairs'
    exponent (Ns, Nr, Nc): the rounding of the exponent, whatever the order
    of its terms, is a small multiple of eps32 times this, and moves E by as
    much relative to itself."""
    d = _index(diag_pos, a.device, torch.long)
    a, c, u, xj = (t.index_select(0, d).abs() for t in (a, c, u, xj))
    return a[:, :, None] + c[:, None, :] + torch.einsum("pne,pke->pnk", u, xj)


GIK_THREADS = 1024  # kGikThreads of csrc/cov_core.cu: most threads of a block


def gik_launch_plan(n_diag: int, nr: int, nc: int, sms: int) -> dict:
    """The grid of ``cov_gik`` for n_diag models of Nr rows and Nc columns
    on a card with ``sms`` SMs. Block (m, t) owns model m and rows t rows ..
    (t + 1) rows (the last band shorter) against every column; its thread
    (x, y) of tx x ty takes the band's rows y + ty i against the quads
    x + tx j of quads = ceil(Nc / 4), quad q the columns 4 q .. 4 q + 3.
    rows is the least whose n_diag bands fit one wave of one block per SM;
    tx covers a row's quads (at most GIK_THREADS), ty as many of the band's
    rows as fit the rest of GIK_THREADS."""
    rows = max(1, -(-n_diag * nr // sms))
    while rows < nr and n_diag * -(-nr // rows) > sms:
        rows += 1
    rows = min(rows, nr)
    quads = -(-nc // 4)
    tx = min(quads, GIK_THREADS)
    ty = min(rows, GIK_THREADS // tx)
    bands = -(-nr // rows)
    return dict(rows=rows, bands=bands, quads=quads, tx=tx, ty=ty, blocks=n_diag * bands)


def cov_gik(g_corr, a, c, u, xj, diag_pos):
    """gK (Ns, Nr, Nc) = g_corr[m] E[diag_pos[m]]. A CPU tensor takes the
    plain twin; a CUDA tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        return cov_gik_plain(g_corr, a, c, u, xj, diag_pos)
    _check_cuda_f32("cov_gik", g_corr=g_corr, a=a, c=c, u=u, xj=xj)
    p, nr = a.shape
    nc = c.shape[1]
    ns = u.shape[2]
    if g_corr.shape != (len(diag_pos),) or u.shape != (p, nr, ns) or xj.shape != (p, nc, ns) \
            or c.shape != (p, nc):
        raise ValueError("cov_gik: inconsistent shapes")
    if not all(0 <= q < p for q in diag_pos):  # the kernel reads pair diag_pos[m]'s operands
        raise ValueError(f"cov_gik: diag_pos {tuple(diag_pos)} outside the {p} pairs")
    _check_ns("cov_gik", ns)
    lib = _build.load()
    plan = gik_launch_plan(len(diag_pos), nr, nc, _build.sm_count(a.device))
    gk = torch.empty((len(diag_pos), nr, nc), dtype=torch.float32, device=a.device)
    rc = lib.gpmpc_cov_gik_f32(
        g_corr.data_ptr(), a.data_ptr(), c.data_ptr(), u.data_ptr(), xj.data_ptr(),
        _index(diag_pos, a.device, torch.int32).data_ptr(), len(diag_pos), gk.data_ptr(), nr, nc, ns,
        plan["rows"], plan["tx"], plan["ty"], torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "cov_gik")
    LAUNCHES["cov_gik"] += 1
    return gk


def gik_launch_info(n_diag: int, nr: int, nc: int, ns: int) -> dict:
    """``cov_gik``'s launch at (n_diag, Nr, Nc, ns) on the current card
    (``_build.launch_info``), with the plan's rows."""
    plan = gik_launch_plan(n_diag, nr, nc, _build.sm_count(torch.device("cuda")))
    return _build.launch_info("gpmpc_cov_gik_info", n_diag, nr, ns, plan["rows"], plan["tx"], plan["ty"],
                              extra=("rows",))


# ---------------------------------------------------------------------------
# autograd composite
# ---------------------------------------------------------------------------


class CovCore(torch.autograd.Function):
    """(S_p, corr) with the kernel backward; mirrors _make_cov_core
    (gpmpc_tpu/ops/pallas_moment_cov.py:241-285) on square and rectangular
    slabs. The backward of both sides is one ``cov_bwd`` launch; the iK
    gradient is its own launch (``cov_gik``), made only when iK needs one."""

    @staticmethod
    def forward(ctx, a, c, u, xj, bi, bj, ik, diag_pos, batch=1):
        ctx.diag_pos = tuple(diag_pos)
        ctx.save_for_backward(a, c, u, xj, bi, bj, ik)
        return cov_fwd(a, c, u, xj, bi, bj, ik, ctx.diag_pos, batch)

    @staticmethod
    def backward(ctx, g_s, g_corr):
        a, c, u, xj, bi, bj, ik = ctx.saved_tensors
        diag_pos = ctx.diag_pos
        p = a.shape[0]
        g_s = torch.zeros(p, dtype=a.dtype, device=a.device) if g_s is None else g_s.contiguous()
        g_corr = torch.zeros(len(diag_pos), dtype=a.dtype, device=a.device) if g_corr is None \
            else g_corr.contiguous()
        ga, gc, gu, gxj, gbi, gbj = cov_bwd(g_s, a, c, u, xj, bi, bj, ik, g_corr, diag_pos)
        gik = None
        if ctx.needs_input_grad[6]:
            gik = cov_gik(g_corr, a, c, u, xj, diag_pos)
        return ga, gc, gu, gxj, gbi, gbj, gik, None, None

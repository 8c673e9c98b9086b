"""Batched ARD-RBF Gram matrix: the CUDA kernel and its plain twin.

``gram_kernel`` (``csrc/gram.cu``) replaces the Pallas TPU kernel
``gpmpc_tpu/ops/pallas_gram.py: gram_ard_rbf_pallas``. It keeps the
squared-norm expansion and the max(., 0) clamp of ``gp.gram_ard_rbf`` so
both round alike.

What bounds it on an H100: it writes Ns*N^2 floats (1.77 MB at the flagship
Ns=3, N=384) and reads a few KB, so by bytes it is bound by that write,
about half a microsecond at 3.35 TB/s; a launch that does nothing costs
more device time than that (the launch floor, ``_build.empty_launch``), so
in practice the launch and the kernel's latency bound it. The design:
one wave of row bands in blocks of up to 1,024 threads (``launch_plan``), each block
staging the scaled points x / ls of its columns and rows in shared memory,
so each quotient is computed once per block rather than twice per feature
of every entry, and each thread writing a row's 4 consecutive columns with
one 16-byte store; launched as a programmatic dependent, which shortens
the launch after the PyTorch op before it on the refresh path. Every entry
keeps the first design's f32 operations in their order, so the outputs are
the same bits. A leading batch of memories (an episode batch's seeds) is
one launch, grid z the element, planned for one memory.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .lanewise import lanewise
from .moment_cov import _check_cuda_f32

LAUNCHES = {"gram": 0}

THREADS = 1024  # kGramThreads of csrc/gram.cu: most threads of a block, a thread a (row, 4-column) item
MAX_QUADS = 512  # kGramMaxQuads: 4-column groups of a column chunk
MAX_BATCH = 65535  # the grid's z extent: one element a z index


def launch_plan(ns: int, n: int, sms: int) -> dict:
    """The grid of ``gram`` for Ns models of N points on a card with ``sms``
    SMs. Block b owns model b // bands and rows t rows .. (t + 1) rows of
    it, t = b % bands (the last band shorter), against every column, in
    chunks of 4 quads columns; its thread (x, y) of quads x rows takes
    item i = y quads + x of each chunk, row y against the columns 4 x ..
    4 x + 3.
    rows is the least whose Ns bands fit one wave of one block per SM;
    quads is all of a row's 4-column groups where the band's rows x quads
    fit THREADS items."""
    rows = max(1, -(-ns * n // sms))
    while rows < n and ns * -(-n // rows) > sms:
        rows += 1
    rows = min(rows, n, THREADS)
    quads = min(-(-n // 4), MAX_QUADS, THREADS // rows)
    bands = -(-n // rows)
    return dict(rows=rows, bands=bands, quads=quads, blocks=ns * bands, chunks=-(-n // (4 * quads)))


def gram_ref(lengthscales, outputscales, x):
    """Plain PyTorch twin of gpmpc_tpu.models.gp.gram_ard_rbf:
    (..., Ns, D), (..., Ns), (..., N, D) -> (..., Ns, N, N), the leading
    batches broadcast."""
    xs = x[..., None, :, :] / lengthscales[..., :, None, :]
    sq = torch.sum(xs * xs, dim=-1)
    cross = torch.einsum("...mnd,...mkd->...mnk", xs, xs)
    d2 = torch.clamp(sq[..., :, :, None] + sq[..., :, None, :] - 2.0 * cross, min=0.0)
    return outputscales[..., :, None, None] * lanewise(torch.exp, -0.5 * d2)


def gram(lengthscales, outputscales, x):
    """K (..., Ns, N, N) for lengthscales (..., Ns, D), outputscales (...,
    Ns) and x (..., N, D) of one leading batch shape (an episode batch's
    seeds, each its own memory and parameters): one launch for the batch,
    planned for one memory (grid z the element), so each element is its
    single launch bit for bit. A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return gram_ref(lengthscales, outputscales, x)
    _check_cuda_f32("gram", lengthscales=lengthscales, outputscales=outputscales, x=x)
    ns, d = lengthscales.shape[-2:]
    n = x.shape[-2]
    lead = tuple(x.shape[:-2])
    if lengthscales.shape != lead + (ns, d) or outputscales.shape != lead + (ns,) or x.shape != lead + (n, d):
        raise ValueError("gram: inconsistent shapes")
    batch = math.prod(lead)
    if not 1 <= batch <= MAX_BATCH:
        raise NotImplementedError(f"gram: the kernel takes a batch of 1 to {MAX_BATCH}, got {batch}")
    lib = _build.load()
    plan = launch_plan(ns, n, _build.sm_count(x.device))
    out = torch.empty(lead + (ns, n, n), dtype=torch.float32, device=x.device)
    rc = lib.gpmpc_gram_f32(
        lengthscales.data_ptr(), outputscales.data_ptr(), x.data_ptr(), out.data_ptr(),
        ns, n, d, plan["rows"], plan["quads"], batch, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "gram")
    LAUNCHES["gram"] += 1
    return out


def launch_info(ns: int, n: int) -> dict:
    """``gram``'s launch at (Ns, N) on the current card
    (``_build.launch_info``), with the plan's rows and quads."""
    plan = launch_plan(ns, n, _build.sm_count(torch.device("cuda")))
    return _build.launch_info("gpmpc_gram_info", ns, n, plan["rows"], plan["quads"], extra=("rows", "quads"))

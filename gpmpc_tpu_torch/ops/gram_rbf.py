"""Batched ARD-RBF Gram matrix: the CUDA kernel and its plain twin.

``gram_kernel`` (``csrc/gram.cu``) replaces the Pallas TPU kernel
``gpmpc_tpu/ops/pallas_gram.py: gram_ard_rbf_pallas``. Grid
(ceil(N/16), ceil(N/16), Ns) of 16x16 blocks, one thread per output entry,
the ragged edge masked. It keeps the squared-norm expansion and the
max(., 0) clamp of ``gp.gram_ard_rbf`` so both round alike.

What bounds it on an H100: it writes Ns*N^2 floats (1.77 MB at the flagship
Ns=3, N=384) and reads a few KB, so it is bound by that write, about half a
microsecond at 3.35 TB/s, far below the launch latency. Nothing in the
design needs more: each entry is written once, coalesced along j.
"""

from __future__ import annotations

import torch

from . import _build
from .moment_cov import _check_cuda_f32

LAUNCHES = {"gram": 0}


def gram_ref(lengthscales, outputscales, x):
    """Plain PyTorch twin of gpmpc_tpu.models.gp.gram_ard_rbf:
    (Ns, D), (Ns,), (N, D) -> (Ns, N, N)."""
    xs = x[None, :, :] / lengthscales[:, None, :]
    sq = torch.sum(xs * xs, dim=-1)
    cross = torch.einsum("mnd,mkd->mnk", xs, xs)
    d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, min=0.0)
    return outputscales[:, None, None] * torch.exp(-0.5 * d2)


def gram(lengthscales, outputscales, x):
    """K (Ns, N, N). A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernel or raises."""
    if x.device.type == "cpu":
        return gram_ref(lengthscales, outputscales, x)
    _check_cuda_f32("gram", lengthscales=lengthscales, outputscales=outputscales, x=x)
    ns, d = lengthscales.shape
    n = x.shape[0]
    if outputscales.shape != (ns,) or x.shape != (n, d):
        raise ValueError("gram: inconsistent shapes")
    lib = _build.load()
    out = torch.empty((ns, n, n), dtype=torch.float32, device=x.device)
    rc = lib.gpmpc_gram_f32(
        lengthscales.data_ptr(), outputscales.data_ptr(), x.data_ptr(), out.data_ptr(),
        ns, n, d, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "gram")
    LAUNCHES["gram"] += 1
    return out

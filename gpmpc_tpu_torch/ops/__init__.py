"""Op dispatch for the port: hand-written CUDA kernels on the card, plain
PyTorch on the CPU.

A CPU tensor goes to the plain version. A CUDA float32 tensor (for the df32
core: float32 hi and lo halves) goes to the kernel at every size (the TPU's
``PALLAS_COV_MIN_N`` and ``n > 128`` thresholds are TPU measurements and are
not copied; an H100 threshold waits for the card's numbers). A CUDA tensor
of any other dtype raises: there is no fallback that hides the card or the
kernel. float64 is routed to the plain forms before these entry points
(``models.gp``), by the JAX package's rule that its Pallas kernels take f32
only.
"""

from __future__ import annotations

import torch

from . import df_cov as _df_mod
from . import gram_rbf as _gram_mod
from . import moment_cov as _cov_mod
from .df_cov import DfCovCore, df_cov_core_ref, df_cov_fwd
from .gram_rbf import gram, gram_ref
from .moment_cov import CovCore, cov_core_ref


def cov_core(a, c, u, xj, bi, bj, ik, diag_pos):
    """(S_p, corr) of the moment-matching covariance (see moment_cov). On
    the CPU the plain core, differentiable in every argument; on the card
    CovCore, whose kernels take float32 only."""
    if a.device.type == "cpu":
        return cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos)
    return CovCore.apply(a, c, u, xj, bi, bj, ik, tuple(diag_pos))


def df_cov_core(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos):
    """df32 (S_p h, l, corr h, l) of the moment-matching covariance (see
    df_cov). On the CPU the plain core, differentiable by autograd. On the
    card, under autograd (grad mode on and an operand requiring a gradient)
    DfCovCore, which launches the forward-with-residuals kernel; otherwise
    the lean forward kernel, as the JAX core runs its primal kernel outside
    value_and_grad."""
    args = (ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl)
    if ah.device.type == "cpu":
        return df_cov_core_ref(*args, diag_pos)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return DfCovCore.apply(*args, tuple(diag_pos))
    return df_cov_fwd(*args, tuple(diag_pos))


_COUNTS = (_gram_mod.LAUNCHES, _cov_mod.LAUNCHES, _df_mod.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


__all__ = ["cov_core", "cov_core_ref", "CovCore", "df_cov_core", "df_cov_core_ref", "DfCovCore",
           "gram", "gram_ref", "launch_counts", "reset_launch_counts"]

"""Op dispatch for the port: hand-written CUDA kernels on the card, plain
PyTorch on the CPU.

A CPU tensor goes to the plain version. A CUDA float32 tensor goes to the
kernel at every size (the TPU's ``PALLAS_COV_MIN_N`` threshold is a TPU
measurement and is not copied; an H100 threshold waits for the card's
numbers). A CUDA tensor of any other dtype raises: there is no fallback
that hides the card or the kernel.
"""

from __future__ import annotations

from . import gram_rbf as _gram_mod
from . import moment_cov as _cov_mod
from .gram_rbf import gram, gram_ref
from .moment_cov import CovCore, cov_core_ref


def cov_core(a, c, u, xj, bi, bj, ik, diag_pos):
    """(S_p, corr) of the moment-matching covariance (see moment_cov). On
    the CPU the plain core, differentiable in every argument; on the card
    CovCore, whose kernels take float32 only."""
    if a.device.type == "cpu":
        return cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos)
    return CovCore.apply(a, c, u, xj, bi, bj, ik, tuple(diag_pos))


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {**_gram_mod.LAUNCHES, **_cov_mod.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_gram_mod.LAUNCHES, _cov_mod.LAUNCHES):
        for name in counts:
            counts[name] = 0


__all__ = ["cov_core", "cov_core_ref", "CovCore", "gram", "gram_ref",
           "launch_counts", "reset_launch_counts"]

"""Op dispatch for the port: hand-written CUDA kernels on the card, plain
PyTorch on the CPU.

A CPU tensor goes to the plain version. A CUDA float32 tensor (for the df32
cores: float32 hi and lo halves) goes to the kernel at every size the kernel
takes (the TPU's ``PALLAS_COV_MIN_N`` and ``n > 128`` thresholds of the cov
cores are TPU measurements and are not copied; an H100 threshold waits for
the card's numbers). A CUDA tensor of any other dtype raises: there is no
fallback that hides the card or the kernel. Shapes the kernels do not take
go to the plain forms by explicit shape rules, as the JAX package sends them
to its XLA twins:

* float64 is routed to the plain forms by the callers (``models.gp``:
  the Gram before this module, the cov core under ``disable_pallas``, so
  that an installed override still takes it; the N-sharded cores of
  ``parallel.sharding`` on each rank's slab), by the JAX package's rule
  that its Pallas kernels take f32 only;
* more than ``COV_MAX_NS`` (8) state dims: the f32 cov core takes the plain
  core (its kernels hold a row's ns values in fixed arrays);
* more than ``DF_COV_MAX_NS`` (3) state dims: the df32 cov core takes the
  plain core, as the reference's ``df_cov_core`` sends them to
  ``df_cov_core_xla`` (``pallas_df_cov.supported_rect``);
* the whole-step df32 path (``df_mm``) runs where the reference's
  ``use_df_pallas`` would: on the card, within ``df_mm.supported``
  (32 <= N <= 128, ns <= 3, d <= 8), see ``use_df_fused``.

Under autograd the df32 cov core keeps a df backward on every device,
whose cotangent sums stay df: by default the residual scheme ``DfCovCore``
(the forward-with-residuals kernel on the card, its plain twin on the CPU);
with ``df_cov.VJP_MODE == "stacked"`` (``GPMPC_DF_COV_VJP=stacked``, read at
import, or the attribute set by the program) ``DfCovCoreStacked`` (the lean
forward, then the stacked backward kernel; their twins on the CPU).
Differentiating the plain core by autograd sums each cotangent-weighted E
term in plain f32, which cancels at cond(K) ~ 1e6 (ROADMAP C1).

Three switches, under the reference's names (gpmpc_tpu/ops/__init__.py),
change the dispatch for the calls made inside them; "pallas" there means
the hand-written CUDA kernels here. ``disable_pallas`` sends ``gram``,
``cov_core`` and ``df_cov_core`` to their plain forms and turns the
whole-step path off (``use_df_fused``); ``override_cov_core`` and
``override_df_cov_core`` install another core, which the two cores call
before any other rule. The N-sharded planner installs all three
(``parallel.sharding.build_nsharded_plan_fn``). Nothing turns them on but
a caller's ``with``.
"""

from __future__ import annotations

import contextlib

import torch

from . import df_cov as _df_mod
from . import df_mm
from . import gram_rbf as _gram_mod
from . import moment_cov as _cov_mod
from .df_cov import DfCovCore, DfCovCoreStacked, df_cov_core_ref, df_cov_fwd
from .gram_rbf import gram_ref
from .moment_cov import CovCore, cov_core_ref

COV_MAX_NS = _cov_mod.MAX_NS
DF_COV_MAX_NS = _df_mod.MAX_NS


_PALLAS_DISABLED = False
_COV_CORE_OVERRIDE = None
_DF_COV_CORE_OVERRIDE = None


@contextlib.contextmanager
def disable_pallas():
    """Inside: the Gram and both cov cores take their plain forms and the
    whole-step path is off (the cores' overrides still apply first)."""
    global _PALLAS_DISABLED
    prev = _PALLAS_DISABLED
    _PALLAS_DISABLED = True
    try:
        yield
    finally:
        _PALLAS_DISABLED = prev


@contextlib.contextmanager
def override_cov_core(fn):
    """Install fn(a, c, u, xj, bi, bj, ik, diag_pos) -> (s_p, corr) as the
    cov core for the calls made inside the context."""
    global _COV_CORE_OVERRIDE
    prev = _COV_CORE_OVERRIDE
    _COV_CORE_OVERRIDE = fn
    try:
        yield
    finally:
        _COV_CORE_OVERRIDE = prev


@contextlib.contextmanager
def override_df_cov_core(fn):
    """Install fn(*df_operands, diag_pos) -> (Sp_h, Sp_l, corr_h, corr_l) as
    the df32 cov core for the calls made inside the context."""
    global _DF_COV_CORE_OVERRIDE
    prev = _DF_COV_CORE_OVERRIDE
    _DF_COV_CORE_OVERRIDE = fn
    try:
        yield
    finally:
        _DF_COV_CORE_OVERRIDE = prev


def gram(lengthscales, outputscales, x):
    """The ARD-RBF Gram (see gram_rbf): the kernel on a CUDA tensor, the
    plain form on the CPU and under ``disable_pallas``."""
    if _PALLAS_DISABLED:
        return gram_ref(lengthscales, outputscales, x)
    return _gram_mod.gram(lengthscales, outputscales, x)


def cov_core(a, c, u, xj, bi, bj, ik, diag_pos, batch=1):
    """(S_p, corr) of the moment-matching covariance (see moment_cov). An
    installed override first, in every dtype; under ``disable_pallas`` the
    plain core; otherwise ``_cov_core_by_device``. ``batch``: the pairs are
    that many elements of a batched rollout, folded into the pair axis
    (``models.gp._batched_cov_core``); the kernels plan for one element."""
    if _COV_CORE_OVERRIDE is not None:
        return _COV_CORE_OVERRIDE(a, c, u, xj, bi, bj, ik, diag_pos)
    if _PALLAS_DISABLED:
        return cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos)
    return _cov_core_by_device(a, c, u, xj, bi, bj, ik, diag_pos, batch)


def _cov_core_by_device(a, c, u, xj, bi, bj, ik, diag_pos, batch=1):
    """``cov_core``'s rules without the switches (what the N-sharded core
    runs on each rank's slab): the plain core, differentiable in every
    argument, on the CPU and on the card past COV_MAX_NS state dims;
    otherwise CovCore, whose kernels take float32 only."""
    if a.device.type == "cpu" or u.shape[-1] > COV_MAX_NS:
        return cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos)
    return CovCore.apply(a, c, u, xj, bi, bj, ik, tuple(diag_pos), batch)


def df_cov_core(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos, batch=1):
    """df32 (S_p h, l, corr h, l) of the moment-matching covariance (see
    df_cov). An installed override first; under ``disable_pallas`` the
    plain core, differentiable by autograd; otherwise
    ``_df_cov_core_by_device``. ``batch`` as in ``cov_core``."""
    args = (ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl)
    if _DF_COV_CORE_OVERRIDE is not None:
        return _DF_COV_CORE_OVERRIDE(*args, diag_pos)
    if _PALLAS_DISABLED:
        return df_cov_core_ref(*args, diag_pos)
    return _df_cov_core_by_device(*args, diag_pos, batch)


def _df_cov_core_by_device(ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl, diag_pos, batch=1):
    """``df_cov_core``'s rules without the switches (what the N-sharded df
    core runs on each rank's slab). Under autograd (grad mode on and an
    operand requiring a gradient) DfCovCore, which takes the
    forward-with-residuals kernel on the card and its plain twin on the
    CPU, or DfCovCoreStacked when ``df_cov.VJP_MODE`` is "stacked" (read at
    each call); otherwise the lean forward kernel on the card (as the JAX
    core runs its primal kernel outside value_and_grad) and the plain core
    on the CPU. On the card past DF_COV_MAX_NS state dims, the plain core,
    differentiable by autograd."""
    args = (ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl)
    if ah.device.type != "cpu" and uh.shape[-1] > DF_COV_MAX_NS:
        return df_cov_core_ref(*args, diag_pos)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        core = DfCovCoreStacked if _df_mod.VJP_MODE == "stacked" else DfCovCore
        return core.apply(*args, tuple(diag_pos), batch)
    if ah.device.type == "cpu":
        return df_cov_core_ref(*args, diag_pos)
    return df_cov_fwd(*args, tuple(diag_pos), batch)


def use_df_fused(n: int, ns: int, d: int, device) -> bool:
    """Whether a mixed-mode step at N stored points runs the whole-step df32
    path (``models.gp.moment_match_df_fused``): on a CUDA device within the
    reference's range ``df_mm.supported``, as the reference's
    ``use_df_pallas`` takes it on the TPU only, never on the CPU, and never
    under ``disable_pallas``."""
    return torch.device(device).type == "cuda" and df_mm.supported(n, ns, d) and not _PALLAS_DISABLED


_COUNTS = (_gram_mod.LAUNCHES, _cov_mod.LAUNCHES, _df_mod.LAUNCHES, df_mm.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


__all__ = ["cov_core", "cov_core_ref", "CovCore", "df_cov_core", "df_cov_core_ref", "DfCovCore", "DfCovCoreStacked",
           "df_mm", "disable_pallas", "gram", "gram_ref", "launch_counts", "override_cov_core", "override_df_cov_core",
           "reset_launch_counts", "use_df_fused"]

"""L-BFGS, unconstrained and box-constrained (projected), to SciPy
L-BFGS-B's budget semantics.

Port of ``gpmpc_tpu/controllers/lbfgs.py`` for one restart: the two-loop
recursion over a rolling (s, y) history, the backtracking Armijo line search
(with box clipping of each trial where there is a box), SciPy's ``maxfun``
total evaluation budget with its sequential-equivalent ``consumed`` count,
keep-best, gradient-value clipping and the NaN guards. The JAX ``lax.scan`` /
``lax.cond`` control flow becomes a Python loop with one host read per
iteration (the accept test); the arithmetic stays on the tensors' device.

The one line search here evaluates value and gradient at the largest step
first and backtracks forward-only when it is rejected, stopping at the first
accept. The JAX package runs this grad-first order in the planner and
evaluates every trial in one batch for training (``_line_search``); both
accept the first (largest) step that passes the same Armijo test, so they
select the same point (tests/test_lbfgs.py::test_grad_first_matches_batched_line_search
pins it there, and tests/test_torch_training.py holds ``lbfgs_minimize``,
with a ``step_scale`` ladder and no box, to JAX's batched search).

A failed search leaves the iterate, the history and the best point as they
were, so every later iteration would repeat it exactly: the loop stops there.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

_ARMIJO_C1 = 1e-4
_CURVATURE_EPS = 1e-10


class _History:
    """Rolling (s, y, rho) curvature pairs, newest last, at most maxcor."""

    def __init__(self, maxcor: int):
        self.maxcor = maxcor
        self.s: list = []
        self.y: list = []
        self.rho: list = []

    def push(self, s, y, rho):
        if len(self.s) == self.maxcor:
            del self.s[0], self.y[0], self.rho[0]
        self.s.append(s)
        self.y.append(y)
        self.rho.append(rho)


def _two_loop(hist: _History, gamma, q):
    """H q by the two-loop recursion (newest pair first, then oldest first).
    Entries not yet filled are skipped, which is what their zero weight
    does in the JAX version."""
    alphas = []
    for s, y, rho in zip(reversed(hist.s), reversed(hist.y), reversed(hist.rho)):
        alpha = rho * torch.dot(s, q)
        q = q - alpha * y
        alphas.append(alpha)
    r = gamma * q
    for s, y, rho, alpha in zip(hist.s, hist.y, hist.rho, reversed(alphas)):
        beta = rho * torch.dot(y, r)
        r = r + (alpha - beta) * s
    return r


def _value_and_grad(fun: Callable, clip_grad_value: Optional[float] = None) -> Callable:
    """x -> (f, df/dx) by autograd, both detached; the gradient clipped to
    [-clip_grad_value, clip_grad_value] when that is given."""

    def vg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(x)
            (g,) = torch.autograd.grad(f, x)
        if clip_grad_value is not None:
            g = torch.clamp(g, -clip_grad_value, clip_grad_value)
        return f.detach(), g

    return vg


def _armijo(f_try, f, x_try, g, gx):
    return bool(torch.isfinite(f_try) & (f_try <= f + _ARMIJO_C1 * (torch.dot(x_try, g) - gx)) & (f_try < f))


def _line_search_grad_first(fun, vg, x, f, g, direction, lower, upper, maxls, step_scale=None):
    """(x_new, f_new, g_new, success, consumed): one value-and-grad at the
    largest step; on reject, forward-only trials at the next steps down and
    a value-and-grad at the first accepted one. The steps are 1, 1/2, 1/4,
    ..., or with ``step_scale`` (the torch-LBFGS ``lr``) step_scale *
    2^(maxls-1), ..., 2 step_scale, step_scale. Each trial is clipped to
    [lower, upper] unless ``lower`` is None. ``consumed`` is the number of
    evaluations a sequential backtracking search spends (first accept index
    + 1, or maxls on failure). On failure x is kept.

    The JAX cold branch (and its training search) evaluates the trials as
    one batch; here they are a Python loop over the candidates that stops at
    the first accept, which selects the same point."""
    gx = torch.dot(x, g)
    if step_scale is None:
        steps = 0.5 ** torch.arange(maxls, dtype=x.dtype, device=x.device)
    else:
        steps = step_scale * 2.0 ** torch.arange(maxls - 1, -1, -1, dtype=x.dtype, device=x.device)

    def trial(i):
        x_try = x + steps[i] * direction
        return x_try if lower is None else torch.clamp(x_try, lower, upper)

    x1 = trial(0)
    f1, g1 = vg(x1)
    if _armijo(f1, f, x1, g, gx):
        return x1, f1, g1, True, 1
    for i in range(1, maxls):
        x_try = trial(i)
        with torch.no_grad():
            f_try = fun(x_try)
        if _armijo(f_try, f, x_try, g, gx):
            f_acc, g_acc = vg(x_try)
            return x_try, f_acc, g_acc, True, i + 1
    return x, f, g, False, maxls


def _lbfgs_core(fun, x0, lower, upper, maxiter, maxcor, maxls, maxfun, clip_grad_value, keep_best,
                step_scale):
    """The L-BFGS iteration of both entry points; ``lower`` None is
    unconstrained (the gradient is not projected, trials are not clipped).
    Returns (x, f): the best point seen if ``keep_best``, else the last."""
    vg = _value_and_grad(fun, clip_grad_value)
    x = x0.detach() if lower is None else torch.clamp(x0.detach(), lower, upper)
    f, g = vg(x)
    eps = 1e-12
    hist = _History(maxcor)
    gamma = torch.ones((), dtype=x.dtype, device=x.device)
    best_x, best_f = x, f
    evals = 1  # SciPy counts the initial (f, g) evaluation

    for _ in range(maxiter):
        if maxfun is not None and evals > maxfun:
            break  # frozen from here on, as the JAX scan's skip branch
        pg = g
        if lower is not None:
            at_bound = ((x <= lower + eps) & (g > 0)) | ((x >= upper - eps) & (g < 0))
            pg = torch.where(at_bound, torch.zeros_like(g), g)
        direction = -_two_loop(hist, gamma, pg)
        # not a descent direction: fall back to steepest descent
        direction = torch.where(torch.dot(direction, g) < 0, direction, -pg)
        x_new, f_new, g_new, success, consumed = _line_search_grad_first(
            fun, vg, x, f, g, direction, lower, upper, maxls, step_scale)
        evals += consumed
        if not success:
            break  # a fixed point: every later iteration repeats this one

        s = x_new - x
        y = g_new - g
        sy = torch.dot(s, y)
        if bool(sy > _CURVATURE_EPS):
            hist.push(s, y, 1.0 / sy)
            gamma = sy / torch.clamp(torch.dot(y, y), min=_CURVATURE_EPS)
        x, f, g = x_new, f_new, g_new
        if bool(f < best_f):
            best_x, best_f = x, f
    return (best_x, best_f) if keep_best else (x, f)


def lbfgs_minimize(
    fun: Callable,
    x0,
    maxiter: int,
    maxcor: int = 10,
    maxls: int = 12,
    clip_grad_value: Optional[float] = None,
    keep_best: bool = False,
    maxfun: Optional[int] = None,
    init_step_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unconstrained L-BFGS. Returns (x, f), the best point seen if
    ``keep_best``.

    ``init_step_scale`` is the torch-LBFGS ``lr`` equivalent: the smallest
    trial step of the line search, which tries it doubled maxls - 1 times
    first. None keeps the plain backtracking ladder starting at 1."""
    return _lbfgs_core(fun, x0, None, None, int(maxiter), int(maxcor), int(maxls),
                       None if maxfun is None else int(maxfun), clip_grad_value, bool(keep_best),
                       None if init_step_scale is None else float(init_step_scale))


def lbfgs_b_minimize(
    fun: Callable,
    x0,
    lower,
    upper,
    maxiter: int,
    maxcor: int = 10,
    maxls: int = 12,
    maxfun: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize fun over the box [lower, upper]. Returns (x, f) of the best
    point seen (the JAX package's keep_best=True, the planner's setting).

    ``maxfun`` is SciPy's total-evaluation cap: once the sequential-equivalent
    evaluation count exceeds it, the remaining iterations do nothing."""
    return _lbfgs_core(fun, x0, lower, upper, maxiter, maxcor, maxls, maxfun, None, True, None)

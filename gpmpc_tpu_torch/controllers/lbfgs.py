"""Box-constrained L-BFGS (projected), to SciPy L-BFGS-B's budget semantics.

Port of ``gpmpc_tpu/controllers/lbfgs.py`` for one restart: the two-loop
recursion over a rolling (s, y) history, the grad-first backtracking Armijo
line search with box clipping of each trial, SciPy's ``maxfun`` total
evaluation budget with its sequential-equivalent ``consumed`` count,
keep-best, and the NaN guards. The JAX ``lax.scan`` / ``lax.cond`` control
flow becomes a Python loop with one host read per iteration (the accept
test); the arithmetic stays on the tensors' device.

The grad-first search evaluates value and gradient at the largest step
first and backtracks only when it is rejected. It accepts the same points as
the JAX package's batched search (pinned there by
tests/test_lbfgs.py::test_grad_first_matches_batched_line_search), so it is
the only search here.
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


def _value_and_grad(fun: Callable) -> Callable:
    """x -> (f, df/dx) by autograd, both detached."""

    def vg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    return vg


def _armijo(f_try, f, x_try, g, gx):
    return bool(torch.isfinite(f_try) & (f_try <= f + _ARMIJO_C1 * (torch.dot(x_try, g) - gx)) & (f_try < f))


def _line_search_grad_first(fun, vg, x, f, g, direction, lower, upper, maxls):
    """(x_new, f_new, g_new, success, consumed): one value-and-grad at the
    largest step (1); on reject, forward-only trials at 1/2, 1/4, ... and a
    value-and-grad at the first accepted one. ``consumed`` is the number of
    evaluations a sequential backtracking search spends (first accept index
    + 1, or maxls on failure). On failure x is kept.

    The JAX cold branch evaluates all remaining trials as one batch; here
    they are a Python loop over the candidates that stops at the first
    accept, which selects the same point."""
    gx = torch.dot(x, g)
    steps = 0.5 ** torch.arange(maxls, dtype=x.dtype, device=x.device)
    x1 = torch.clamp(x + steps[0] * direction, lower, upper)
    f1, g1 = vg(x1)
    if _armijo(f1, f, x1, g, gx):
        return x1, f1, g1, True, 1
    for i in range(1, maxls):
        x_try = torch.clamp(x + steps[i] * direction, lower, upper)
        with torch.no_grad():
            f_try = fun(x_try)
        if _armijo(f_try, f, x_try, g, gx):
            f_acc, g_acc = vg(x_try)
            return x_try, f_acc, g_acc, True, i + 1
    return x, f, g, False, maxls


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
    vg = _value_and_grad(fun)
    x = torch.clamp(x0.detach(), lower, upper)
    f, g = vg(x)
    eps = 1e-12
    hist = _History(maxcor)
    gamma = torch.ones((), dtype=x.dtype, device=x.device)
    best_x, best_f = x, f
    evals = 1  # SciPy counts the initial (f, g) evaluation

    for _ in range(maxiter):
        if maxfun is not None and evals > maxfun:
            break  # frozen from here on, as the JAX scan's skip branch
        at_bound = ((x <= lower + eps) & (g > 0)) | ((x >= upper - eps) & (g < 0))
        pg = torch.where(at_bound, torch.zeros_like(g), g)
        direction = -_two_loop(hist, gamma, pg)
        # not a descent direction: fall back to steepest descent
        direction = torch.where(torch.dot(direction, g) < 0, direction, -pg)
        x_new, f_new, g_new, success, consumed = _line_search_grad_first(
            fun, vg, x, f, g, direction, lower, upper, maxls)
        evals += consumed

        if success:
            s = x_new - x
            y = g_new - g
            sy = torch.dot(s, y)
            if bool(sy > _CURVATURE_EPS):
                hist.push(s, y, 1.0 / sy)
                gamma = sy / torch.clamp(torch.dot(y, y), min=_CURVATURE_EPS)
        x, f, g = x_new, f_new, g_new
        if bool(f < best_f):
            best_x, best_f = x, f
    return best_x, best_f

"""L-BFGS, unconstrained and box-constrained (projected), to SciPy
L-BFGS-B's budget semantics, over a batch of independent problems in
lockstep.

Port of ``gpmpc_tpu/controllers/lbfgs.py``, whose optimizer the JAX package
vmaps over restarts (the planner), over restarts x models (MLL training) and
over seeds (on-device episodes). Here the batch runs in lockstep: every
iteration makes one batched value-and-grad evaluation for all the problems
still running, then the forward-only backtracking trials batched over the
problems still searching, then one batched value-and-grad at their accepted
points. Each problem keeps its own iterate, value, gradient, best point,
``maxfun`` evaluation count, box, trial-step scale and rolling (s, y, rho)
curvature history, whose unfilled slots carry zero weight as in JAX; a
problem that exhausted ``maxfun`` or failed its line search is frozen, as
the JAX scan's skip branch freezes it, and left out of later evaluations. So
each problem computes what it would alone: the two-loop recursion, the
backtracking Armijo line search (with box clipping of each trial where there
is a box), SciPy's ``maxfun`` total evaluation budget with its
sequential-equivalent ``consumed`` count, keep-best, gradient-value clipping
and the NaN guards. The JAX ``lax.scan`` / ``lax.cond`` control flow becomes
a Python loop with one host read per lockstep stage (the accept tests of the
whole batch); the arithmetic stays on the tensors' device.

The line search evaluates value and gradient at the largest step first and
backtracks forward-only when it is rejected, stopping at the first accept.
The JAX package runs this grad-first order in the planner and evaluates
every trial in one batch for training (``_line_search``); both accept the
first (largest) step that passes the same Armijo test, so they select the
same point (tests/test_lbfgs.py::test_grad_first_matches_batched_line_search
pins it there, and tests/test_torch_training.py holds ``lbfgs_minimize``,
with a ``step_scale`` ladder and no box, to JAX's batched search).

A failed search leaves the iterate, the history and the best point as they
were, so every later iteration would repeat it exactly: the problem is
frozen there.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

_ARMIJO_C1 = 1e-4
_CURVATURE_EPS = 1e-10


def _dot(a, b):
    """Row-wise dot products of (B, n) tensors: (B,)."""
    return torch.sum(a * b, dim=-1)


def _two_loop(s_hist, y_hist, rho, gamma, q):
    """H q by the two-loop recursion for each problem, over its (B, maxcor,
    n) history (newest last; unfilled slots zero with rho 0, which leaves q
    and r as they are, as their zero weight does in JAX)."""
    m = s_hist.shape[1]
    alphas = []
    for k in range(m - 1, -1, -1):
        alpha = rho[:, k] * _dot(s_hist[:, k], q)
        q = q - alpha[:, None] * y_hist[:, k]
        alphas.append(alpha)
    r = gamma[:, None] * q
    for k in range(m):
        beta = rho[:, k] * _dot(y_hist[:, k], r)
        r = r + (alphas[m - 1 - k] - beta)[:, None] * s_hist[:, k]
    return r


def _value_and_grad(fun: Callable, clip_grad_value: Optional[float] = None) -> Callable:
    """(x (b, n), idx) -> (f (b,), df/dx (b, n)) by autograd, both detached;
    the gradient clipped to [-clip_grad_value, clip_grad_value] when that is
    given. The problems are independent, so the gradient of the sum of
    their values is each one's own gradient."""

    def vg(x, idx):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(x, idx)
            (g,) = torch.autograd.grad(f.sum(), x)
        if clip_grad_value is not None:
            g = torch.clamp(g, -clip_grad_value, clip_grad_value)
        return f.detach(), g

    return vg


def _armijo(f_try, f, x_try, g, gx):
    """The accept test of each problem, (b,) bool on the device."""
    return torch.isfinite(f_try) & (f_try <= f + _ARMIJO_C1 * (_dot(x_try, g) - gx)) & (f_try < f)


def _rows(t, idx):
    """The rows idx of a per-problem tensor, or the tensor shared by all."""
    return t if t is None or t.dim() < 2 else t[idx]


def _lbfgs_core(fun, x0, lower, upper, maxiter, maxcor, maxls, maxfun, clip_grad_value, keep_best,
                step_scale):
    """The lockstep L-BFGS iteration of every entry point, over the B
    problems x0 (B, n): ``fun(x (b, n), idx (b,))`` the values of the
    problems idx at x. ``lower`` None is unconstrained (the gradient is not
    projected, trials are not clipped); else ``lower``, ``upper`` (n,) for
    all or (B, n). ``step_scale`` None or (B,). Returns (x, f) (B, n) and
    (B,): each problem's best point seen if ``keep_best``, else its last."""
    vg = _value_and_grad(fun, clip_grad_value)
    nb, n = x0.shape
    dev, dt = x0.device, x0.dtype
    x = x0.detach().clone() if lower is None else torch.clamp(x0.detach(), lower, upper)
    everyone = torch.arange(nb, device=dev)
    f, g = vg(x, everyone)
    eps = 1e-12
    s_hist = torch.zeros((nb, maxcor, n), dtype=dt, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((nb, maxcor), dtype=dt, device=dev)
    gamma = torch.ones(nb, dtype=dt, device=dev)
    best_x, best_f = x.clone(), f.clone()
    if step_scale is None:
        steps = (0.5 ** torch.arange(maxls, dtype=dt, device=dev)).expand(nb, maxls)
    else:
        steps = step_scale[:, None] * 2.0 ** torch.arange(maxls - 1, -1, -1, dtype=dt, device=dev)
    evals = np.ones(nb, dtype=np.int64)  # SciPy counts the initial (f, g) evaluation
    running = np.ones(nb, dtype=bool)

    for _ in range(maxiter):
        if maxfun is not None:
            running &= evals <= maxfun  # frozen from here on, as the JAX scan's skip branch
        act = np.flatnonzero(running)
        if act.size == 0:
            break
        a = torch.as_tensor(act, device=dev)
        xa, fa, ga = x[a], f[a], g[a]
        lo, hi = _rows(lower, a), _rows(upper, a)
        pg = ga
        if lower is not None:
            at_bound = ((xa <= lo + eps) & (ga > 0)) | ((xa >= hi - eps) & (ga < 0))
            pg = torch.where(at_bound, torch.zeros_like(ga), ga)
        direction = -_two_loop(s_hist[a], y_hist[a], rho[a], gamma[a], pg)
        # not a descent direction: fall back to steepest descent
        direction = torch.where((_dot(direction, ga) < 0)[:, None], direction, -pg)
        gx = _dot(xa, ga)
        steps_a = steps[a]

        def trial(i, r):
            x_try = xa[r] + steps_a[r, i:i + 1] * direction[r]
            return x_try if lower is None else torch.clamp(x_try, _rows(lo, r), _rows(hi, r))

        # the largest step, value and gradient, for every running problem
        x_new = trial(0, slice(None))
        f_new, g_new = vg(x_new, a)
        ok = _armijo(f_new, fa, x_new, ga, gx).cpu().numpy()
        consumed = np.ones(act.size, dtype=np.int64)
        searching = np.flatnonzero(~ok)
        late = []
        # backtracking, forward only, over the problems still searching
        for i in range(1, maxls):
            if searching.size == 0:
                break
            r = torch.as_tensor(searching, device=dev)
            x_try = trial(i, r)
            with torch.no_grad():
                f_try = fun(x_try, a[r])
            hit = _armijo(f_try, fa[r], x_try, ga[r], gx[r]).cpu().numpy()
            accepted = searching[hit]
            x_new[torch.as_tensor(accepted, device=dev)] = x_try[torch.as_tensor(hit, device=dev)]
            consumed[accepted] = i + 1
            ok[accepted] = True
            if accepted.size:
                late.append(accepted)
            searching = searching[~hit]
        consumed[searching] = maxls
        if late:  # value and gradient at the points accepted after a backtrack
            r = torch.as_tensor(np.concatenate(late), device=dev)
            f_new[r], g_new[r] = vg(x_new[r], a[r])
        evals[act] += consumed
        running[act[~ok]] = False  # a fixed point: every later iteration repeats this one

        k = torch.as_tensor(np.flatnonzero(ok), device=dev)
        if k.numel() == 0:
            continue
        idx = a[k]
        s = x_new[k] - xa[k]
        y = g_new[k] - ga[k]
        sy = _dot(s, y)
        curv = sy > _CURVATURE_EPS
        push = curv[:, None, None]
        s_hist[idx] = torch.where(push, torch.cat([s_hist[idx, 1:], s[:, None]], dim=1), s_hist[idx])
        y_hist[idx] = torch.where(push, torch.cat([y_hist[idx, 1:], y[:, None]], dim=1), y_hist[idx])
        rho[idx] = torch.where(curv[:, None], torch.cat([rho[idx, 1:], (1.0 / sy)[:, None]], dim=1), rho[idx])
        gamma[idx] = torch.where(curv, sy / torch.clamp(_dot(y, y), min=_CURVATURE_EPS), gamma[idx])
        x[idx], f[idx], g[idx] = x_new[k], f_new[k], g_new[k]
        better = f_new[k] < best_f[idx]
        best_x[idx] = torch.where(better[:, None], x_new[k], best_x[idx])
        best_f[idx] = torch.where(better, f_new[k], best_f[idx])
    return (best_x, best_f) if keep_best else (x, f)


def _single(fun: Callable) -> Callable:
    """A one-problem objective x (n,) -> f () as the batch objective of B = 1."""
    return lambda x, idx: fun(x[0]).reshape(1)


def _scales(init_step_scale, nb, x0):
    if init_step_scale is None:
        return None
    return torch.as_tensor(init_step_scale, dtype=x0.dtype).to(x0.device).expand(nb).contiguous()


def lbfgs_minimize_batch(
    fun: Callable,
    x0,
    maxiter: int,
    maxcor: int = 10,
    maxls: int = 12,
    clip_grad_value: Optional[float] = None,
    keep_best: bool = False,
    maxfun: Optional[int] = None,
    init_step_scale=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unconstrained L-BFGS of the B problems x0 (B, n) in lockstep;
    ``fun(x (b, n), idx (b,))`` gives the values (b,) of the problems idx (a
    device tensor of rows of x0) at x, each depending on its own row only.
    Returns (x (B, n), f (B,)), each problem's best point seen if
    ``keep_best``. ``init_step_scale``: as in ``lbfgs_minimize``, one for
    all or (B,)."""
    return _lbfgs_core(fun, x0, None, None, int(maxiter), int(maxcor), int(maxls),
                       None if maxfun is None else int(maxfun), clip_grad_value, bool(keep_best),
                       _scales(init_step_scale, x0.shape[0], x0))


def lbfgs_b_minimize_batch(
    fun: Callable,
    x0,
    lower,
    upper,
    maxiter: int,
    maxcor: int = 10,
    maxls: int = 12,
    maxfun: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box L-BFGS-B of the B problems x0 (B, n) in lockstep, ``fun`` as in
    ``lbfgs_minimize_batch``, the box ``lower``, ``upper`` (n,) for all or
    (B, n). Returns each problem's best point seen and its value."""
    return _lbfgs_core(fun, x0, lower, upper, int(maxiter), int(maxcor), int(maxls),
                       None if maxfun is None else int(maxfun), None, True, None)


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
    """Unconstrained L-BFGS of one problem, ``fun(x (n,))``: the B = 1 case
    of ``lbfgs_minimize_batch``. Returns (x, f), the best point seen if
    ``keep_best``.

    ``init_step_scale`` is the torch-LBFGS ``lr`` equivalent: the smallest
    trial step of the line search, which tries it doubled maxls - 1 times
    first. None keeps the plain backtracking ladder starting at 1."""
    x, f = lbfgs_minimize_batch(_single(fun), x0[None], maxiter, maxcor, maxls, clip_grad_value, keep_best, maxfun,
                                init_step_scale)
    return x[0], f[0]


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
    """Minimize fun over the box [lower, upper]: one problem, the B = 1 case
    of ``lbfgs_b_minimize_batch``. Returns (x, f) of the best point seen
    (the JAX package's keep_best=True, the planner's setting).

    ``maxfun`` is SciPy's total-evaluation cap: once the sequential-equivalent
    evaluation count exceeds it, the remaining iterations do nothing."""
    x, f = lbfgs_b_minimize_batch(_single(fun), x0[None], lower, upper, maxiter, maxcor, maxls, maxfun)
    return x[0], f[0]

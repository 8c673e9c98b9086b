"""Per-phase timing of the planning step.

Port of ``gpmpc_tpu/utils/profiling.py``: the factorization, one objective
evaluation, one value-and-grad and a whole plan, each timed on its own.
Times are blocked: ``time_fn`` synchronizes the CUDA devices its function's
outputs live on before it reads the clock, so a time is what a caller waits
for, not what it takes to queue the work.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from ..controllers.planner import _cast_cache, _objective_and_info, _plan_from_cache
from ..models.gp import masked_cholesky_factorize


def block_until_ready(out) -> None:
    """Wait for the CUDA devices holding any tensor of ``out`` (nested
    tuples, lists and dicts)."""
    stack, devices = [out], set()
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.device.type == "cuda":
                devices.add(item.device)
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (tuple, list)):
            stack.extend(item)
    for device in devices:
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, iters: int = 30, warmup: int = 2) -> float:
    """Mean blocked seconds per call over ``iters`` calls, after ``warmup``."""
    for _ in range(warmup):
        out = fn(*args)
    block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def phase_breakdown(make_args) -> Dict[str, float]:
    """Time the phases of one MPC planning step on the tensors' device.

    ``make_args`` returns (spec, bounds, params, x, y, mask, state_mu,
    state_var, inits, action_prev), the tensors on one device. The
    factorization runs in the dtype of ``x`` and the rollout in that of
    ``state_mu``: an f64 ``x`` with an f32 state is mixed mode (the f64
    master split into df32), as in the Planner.
    """
    spec, bounds, params, x, y, mask, state_mu, state_var, inits, action_prev = make_args()

    def fact(p, xx, yy, mm):
        return masked_cholesky_factorize(p, bounds, xx, yy, mm)

    def objective(p, xx, yy, mm, a):
        cache = _cast_cache(fact(p, xx, yy, mm), state_mu.dtype)
        cost, _ = _objective_and_info(spec, cache, a, state_mu, state_var, action_prev, 0)
        return cost

    def one_eval(p, xx, yy, mm, a):
        with torch.no_grad():
            return objective(p, xx, yy, mm, a)

    def one_vg(p, xx, yy, mm, a):
        a = a.detach().requires_grad_(True)
        with torch.enable_grad():
            cost = objective(p, xx, yy, mm, a)
            (g,) = torch.autograd.grad(cost, a)
        return cost.detach(), g

    def plan(xx, yy, mm, p, st_mu, st_var, a0, a_prev):
        return _plan_from_cache(spec, fact(p, xx, yy, mm), st_mu, st_var, a0, a_prev, 0)

    return {
        "factorize_s": time_fn(fact, params, x, y, mask),
        "objective_eval_s": time_fn(one_eval, params, x, y, mask, inits[0]),
        "objective_value_and_grad_s": time_fn(one_vg, params, x, y, mask, inits[0]),
        "full_plan_s": time_fn(plan, x, y, mask, params, state_mu, state_var, inits, action_prev, iters=20),
    }

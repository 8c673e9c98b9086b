"""The pendulum flagship workload of bench.py:113-190, for the port.

Ns=3 states, Na=1 action (D=4), horizon 15, 300 stored points padded to the
384 bucket, one L-BFGS-B restart with maxiter=maxfun=maxls=maxcor=4, the
benchmark's GP parameters and bounds, and synthetic memory drawn from
``numpy.random.default_rng(0)`` in bench.py's draw order. ``run_steps``
(``start_steps``, then ``plan_step``s) drives the steady state as bench.py
does: one refresh of the cache, then planning steps that each append one
stored point.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .controllers.planner import Planner, PlanSpec
from .mappers.action import ActionMapperSpec
from .mappers.reward import RewardSpec
from .models.gp import GPBounds, GPParams, params_from_constrained


@dataclass
class Problem:
    spec: PlanSpec
    bounds: GPBounds
    params: GPParams
    x: np.ndarray  # (bucket, D) host memory, updated in place by run_steps
    y: np.ndarray  # (bucket, Ns)
    mask: np.ndarray  # (bucket,) bool
    n_points: int
    extra_x: np.ndarray  # points appended one per step
    extra_y: np.ndarray
    state_mu: torch.Tensor
    state_var: torch.Tensor
    inits: torch.Tensor  # (1, Nh*Na)
    action_prev: torch.Tensor


def flagship_problem(device, dtype, n_points=300, bucket=384, nh=15, iters=50) -> Problem:
    """The flagship setup on ``device`` in ``dtype``; ``n_points``,
    ``bucket`` and ``nh`` shrink it (the widths and GP parameters stay)."""
    ns, na = 3, 1
    d = ns + na
    rng = np.random.default_rng(0)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    reward = RewardSpec(
        target_state_action_norm=t([1.0, 0.5, 0.5, 0.5]),
        weight_matrix_cost=t(np.diag([1.0, 0.1, 0.1, 1e-3])),
        target_state_norm=t([1.0, 0.5, 0.5]),
        weight_matrix_cost_terminal=t(np.diag([5.0, 2.0, 2.0])),
        use_constraints=False, state_min=t(np.zeros(ns)), state_max=t(np.ones(ns)),
        area_multiplier=1.0, exploration_factor=1.0, clip_lower_bound_cost_to_0=False,
    )
    action = ActionMapperSpec(limit_action_change=False, max_change_action_norm=t([0.3]),
                              len_horizon=nh, dim_action=na)
    spec = PlanSpec(reward=reward, action=action, include_time_model=False, len_horizon=nh,
                    dim_action=na, dim_state=ns, maxiter=4, maxcor=4, maxls=4, maxfun=4)
    bounds = GPBounds(
        min_lengthscale=t(np.full((ns, d), 4e-3)), max_lengthscale=t(np.full((ns, d), 10.0)),
        min_outputscale=t(np.full(ns, 1e-2)), max_outputscale=t(np.full(ns, 0.95)),
        min_noise=t(np.full(ns, 1e-6)), max_noise=t(np.full(ns, 1e-4)),
    )
    params = params_from_constrained(t(np.full((ns, d), 0.5)), t(np.full(ns, 5e-2)),
                                     t(np.full(ns, 1e-5)), bounds)
    x = np.zeros((bucket, d))
    y = np.zeros((bucket, ns))
    mask = np.zeros(bucket, dtype=bool)
    x[:n_points] = rng.uniform(0, 1, (n_points, d))
    y[:n_points] = rng.normal(0, 0.02, (n_points, ns))
    mask[:n_points] = True
    extra_x = rng.uniform(0, 1, (iters + 1, d))
    extra_y = rng.normal(0, 0.02, (iters + 1, ns))
    return Problem(
        spec=spec, bounds=bounds, params=params, x=x, y=y, mask=mask, n_points=n_points,
        extra_x=extra_x, extra_y=extra_y,
        state_mu=t(rng.uniform(0, 1, ns)), state_var=t(np.eye(ns) * 1e-6),
        inits=t(rng.uniform(0, 1, (1, nh * na))), action_prev=t([0.5]),
    )


def start_steps(prob: Problem, device, dtype, steps) -> Planner:
    """A Planner with its cache refreshed on the first ``prob.n_points``
    points, ready for ``steps`` calls of ``plan_step``."""
    if prob.n_points + steps > prob.x.shape[0]:
        raise ValueError(f"{steps} steps overflow the {prob.x.shape[0]} bucket from {prob.n_points} points")
    prob.mask[prob.n_points:] = False
    planner = Planner(prob.spec, dtype=dtype, device=device)
    planner.refresh_cache(prob.x, prob.y, prob.mask, prob.params, prob.bounds)
    return planner


def plan_step(planner: Planner, prob: Problem, i):
    """Steady-state step ``i``: append stored point ``i``, then plan.
    Returns (a_opt, info)."""
    j = prob.n_points + i
    prob.x[j], prob.y[j], prob.mask[j] = prob.extra_x[i], prob.extra_y[i], True
    a_opt, _, info = planner.plan(prob.x, prob.y, prob.mask, prob.params, prob.bounds, prob.state_mu,
                                  prob.state_var, prob.inits, prob.action_prev, i)
    return a_opt, info


def run_steps(prob: Problem, device, dtype, steps, sync=None):
    """start_steps, then ``steps`` plan_steps. ``sync`` (e.g.
    torch.cuda.synchronize) ends each timed step. Returns
    (planner, [(a_opt, info)], [seconds per step])."""
    planner = start_steps(prob, device, dtype, steps)
    plans, secs = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        plans.append(plan_step(planner, prob, i))
        if sync:
            sync()
        secs.append(time.perf_counter() - t0)
    return planner, plans, secs

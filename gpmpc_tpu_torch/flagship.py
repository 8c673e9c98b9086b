"""The pendulum flagship workloads of the JAX package's benchmarks, for the port.

Ns=3 states, Na=1 action (D=4), horizon 15, 300 stored points padded to the
384 bucket, one L-BFGS-B restart with maxiter=maxfun=maxls=maxcor=4 and
synthetic memory drawn from ``numpy.random.default_rng(0)``:

* ``flagship_problem``: bench.py:113-190, the f32 flagship (lengthscale 0.5,
  outputscale 5e-2, noise 1e-5), in bench.py's draw order;
* ``trained_gp_problem``: scripts/bench_df32.py:47-140, the trained-GP
  flagship in mixed mode (lengthscale 0.35, outputscale 0.9, noise 1e-6, so
  cond(K) ~ 1e6; an f64 master with f32 state and specs), in bench_df32's
  draw order.

``run_steps`` (``start_steps``, then ``plan_step``s) drives the steady state
as the benchmarks do: one refresh of the cache, then planning steps that
each append one stored point.

``pendulum_config`` (defined in ``example_configs``) is the pendulum
example's controller configuration (examples/pendulum/config_pendulum.py),
for ``GpMpcController`` on ``envs.PendulumEnv``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .controllers.planner import Planner, PlanSpec
from .example_configs import pendulum_config  # noqa: F401  (re-exported)
from .mappers.action import ActionMapperSpec
from .mappers.reward import RewardSpec
from .memory import bucket_size
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
    master_dtype: torch.dtype  # of params, bounds and the factorization cache


def _specs(t, ns, na, nh):
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
    return PlanSpec(reward=reward, action=action, include_time_model=False, len_horizon=nh,
                    dim_action=na, dim_state=ns, maxiter=4, maxcor=4, maxls=4, maxfun=4)


def _problem(device, dtype, master_dtype, gp, n_points, bucket, nh, n_extra) -> Problem:
    """Specs, GP boxes and parameters (``gp``: lengthscale, outputscale,
    noise, min noise) and memory drawn in the benchmarks' order."""
    ns, na = 3, 1
    d = ns + na
    rng = np.random.default_rng(0)

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    def m(a):
        return t(a, master_dtype)

    lengthscale, outputscale, noise, min_noise = gp
    bounds = GPBounds(
        min_lengthscale=m(np.full((ns, d), 4e-3)), max_lengthscale=m(np.full((ns, d), 10.0)),
        min_outputscale=m(np.full(ns, 1e-2)), max_outputscale=m(np.full(ns, 0.95)),
        min_noise=m(np.full(ns, min_noise)), max_noise=m(np.full(ns, 1e-4)),
    )
    params = params_from_constrained(m(np.full((ns, d), lengthscale)), m(np.full(ns, outputscale)),
                                     m(np.full(ns, noise)), bounds)
    x = np.zeros((bucket, d))
    y = np.zeros((bucket, ns))
    mask = np.zeros(bucket, dtype=bool)
    x[:n_points] = rng.uniform(0, 1, (n_points, d))
    y[:n_points] = rng.normal(0, 0.02, (n_points, ns))
    mask[:n_points] = True
    extra_x = rng.uniform(0, 1, (n_extra, d))
    extra_y = rng.normal(0, 0.02, (n_extra, ns))
    return Problem(
        spec=_specs(t, ns, na, nh), bounds=bounds, params=params, x=x, y=y, mask=mask,
        n_points=n_points, extra_x=extra_x, extra_y=extra_y,
        state_mu=t(rng.uniform(0, 1, ns)), state_var=t(np.eye(ns) * 1e-6),
        inits=t(rng.uniform(0, 1, (1, nh * na))), action_prev=t([0.5]), master_dtype=master_dtype,
    )


def flagship_problem(device, dtype, n_points=300, bucket=384, nh=15, iters=50) -> Problem:
    """The f32 flagship setup (bench.py) on ``device`` in ``dtype``;
    ``n_points``, ``bucket`` and ``nh`` shrink it (the widths and GP
    parameters stay)."""
    return _problem(device, dtype, dtype, (0.5, 5e-2, 1e-5, 1e-6), n_points, bucket, nh, iters + 1)


def trained_gp_problem(device, dtype=torch.float32, n_points=300, nh=15, iters=30, bucket=None) -> Problem:
    """The trained-GP flagship (scripts/bench_df32.py): an f64 master (params,
    bounds with min noise 1e-7, the cache) and state and specs in ``dtype``,
    float32 for mixed mode. ``n_extra = iters + 1 + max(iters // 2, 1)``
    points are drawn to append, and the bucket is ``bucket_size(n_points +
    n_extra)`` (384 at the defaults) unless given."""
    n_extra = iters + 1 + max(iters // 2, 1)
    bucket = bucket_size(n_points + n_extra) if bucket is None else bucket
    return _problem(device, dtype, torch.float64, (0.35, 0.9, 1e-6, 1e-7), n_points, bucket, nh, n_extra)


def start_steps(prob: Problem, device, dtype, steps) -> Planner:
    """A Planner with its cache refreshed on the first ``prob.n_points``
    points, ready for ``steps`` calls of ``plan_step``."""
    if prob.n_points + steps > prob.x.shape[0]:
        raise ValueError(f"{steps} steps overflow the {prob.x.shape[0]} bucket from {prob.n_points} points")
    prob.mask[prob.n_points:] = False
    planner = Planner(prob.spec, dtype=dtype, device=device, master_dtype=prob.master_dtype)
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

"""MPC planning step: factorize or extend -> rollout -> cost -> L-BFGS-B.

Port of ``gpmpc_tpu/controllers/planner.py``. Objective:

  minimize  -mean(reward_traj + exploration_factor * sqrt(var_traj))

over flat actions in [0, 1]^(Nh*Na), the horizon including the terminal
stage, optionally clamping the reward UCB to <= 0 with a straight-through
clamp. ``Planner`` keeps the factorization cache on the device between
steps: one new stored point is an O(Ns N^2) extension, anything else a full
refactorization.

Restarts: the JAX package optimizes all restarts in one vmapped program;
here they run one after another, each an independent L-BFGS-B from its own
init, which computes what the vmap computes (a restart under vmap does not
see the others, and the batched line search the vmap runs accepts the same
points as the grad-first one here: tests/test_lbfgs.py pins it in JAX). The
restarts would share one rollout once the kernels take a batch axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..mappers.action import ActionMapperSpec, mpc_to_model_actions, ste_clamp
from ..mappers.reward import RewardSpec, rewards_trajectory
from ..models.gp import (
    FactorizationCache,
    GPBounds,
    GPParams,
    constrained_params,
    extend_factorization,
    masked_cholesky_factorize,
    predict_trajectory,
    split_cache_df,
)
from .lbfgs import lbfgs_b_minimize


class PlanSpec(NamedTuple):
    reward: RewardSpec
    action: ActionMapperSpec
    include_time_model: bool
    len_horizon: int
    dim_action: int
    dim_state: int
    maxiter: int
    maxcor: int
    maxls: int
    maxfun: Optional[int] = None  # SciPy total-eval budget; None = uncapped


class TrajectoryInfo(NamedTuple):
    states_mu_pred: torch.Tensor  # (Nh+1, Ns)
    states_var_pred: torch.Tensor  # (Nh+1, Ns, Ns)
    rewards_traj: torch.Tensor  # (Nh+1,)
    rewards_traj_var: torch.Tensor  # (Nh+1,)
    mean_reward_ucb: torch.Tensor  # scalar


def _objective_and_info(spec: PlanSpec, cache: FactorizationCache, actions_mpc, state_mu,
                        state_var, action_prev, iter_ctrl):
    actions_model = mpc_to_model_actions(spec.action, actions_mpc, action_prev)
    states_mu, states_var = predict_trajectory(
        cache, actions_model, state_mu, state_var, iter_ctrl, spec.include_time_model)
    rewards, rewards_var = rewards_trajectory(spec.reward, states_mu, states_var, actions_model)
    # the analytic cost variance is >= 0 exactly but can drift slightly
    # negative in f32; an unguarded sqrt would NaN the objective
    ucb = rewards + spec.reward.exploration_factor * torch.sqrt(torch.clamp(rewards_var, min=0.0))
    if spec.reward.clip_lower_bound_cost_to_0:
        ucb = ste_clamp(ucb, -float("inf"), 0.0)
    mean_ucb = torch.mean(ucb)
    return -mean_ucb, TrajectoryInfo(states_mu, states_var, rewards, rewards_var, mean_ucb)


def _cast_cache(cache: FactorizationCache, dtype):
    """The cache in the rollout's compute dtype. An f64 master with an f32
    rollout is mixed mode: the cache is split into the double-float32
    rollout cache (``split_cache_df``), since a plain downcast loses exactly
    the bits the moment-matching cancellations need. Otherwise every float
    field is cast."""
    if cache.x_mem.dtype == dtype:
        return cache
    if dtype == torch.float32 and cache.x_mem.dtype == torch.float64:
        return split_cache_df(cache)
    return FactorizationCache(*(a.to(dtype) if a.is_floating_point() else a for a in cache))


def _select_restart(fs) -> int:
    """The restart to keep, of objectives fs (R,): the least, a NaN counted
    as +inf; the first when every objective is NaN (the reference falls
    back to it, gp_mpc_controller.py:146-148)."""
    nan = torch.isnan(fs)
    if bool(nan.all()):
        return 0
    return int(torch.argmin(torch.where(nan, torch.full_like(fs, float("inf")), fs)))


def _plan_from_cache(spec: PlanSpec, cache: FactorizationCache, state_mu, state_var, inits,
                     action_prev, iter_ctrl):
    """(a_opt, actions_model, info) of the best of R restarts, inits (R, Nh*Na)."""
    cache = _cast_cache(cache, state_mu.dtype)

    def objective(a):
        cost, _ = _objective_and_info(spec, cache, a, state_mu, state_var, action_prev, iter_ctrl)
        return cost

    lower = torch.zeros_like(inits[0])
    upper = torch.ones_like(inits[0])
    xs, fs = zip(*(lbfgs_b_minimize(objective, a0, lower, upper, maxiter=spec.maxiter, maxcor=spec.maxcor,
                                    maxls=spec.maxls, maxfun=spec.maxfun) for a0 in inits))
    a_opt = xs[_select_restart(torch.stack(fs))]
    with torch.no_grad():
        _, info = _objective_and_info(spec, cache, a_opt, state_mu, state_var, action_prev, iter_ctrl)
        actions_model = mpc_to_model_actions(spec.action, a_opt, action_prev)
    return a_opt, actions_model, info


def extend_plan(spec: PlanSpec, cache: FactorizationCache, x_new, y_new, state_mu, state_var,
                inits, action_prev, iter_ctrl):
    """The steady-state planning step (JAX ``build_extend_plan_fn``): extend
    the cache by one point, then plan. Returns (new_cache, a_opt,
    actions_model, info)."""
    cache2 = extend_factorization(cache, x_new, y_new)
    a_opt, actions_model, info = _plan_from_cache(
        spec, cache2, state_mu, state_var, inits, action_prev, iter_ctrl)
    return cache2, a_opt, actions_model, info


class Planner:
    """Planning functions plus the factorization-cache lifecycle.

    The cache is rebuilt from scratch (O(Ns N^3)) only when hyperparameters
    change, the padding bucket changes, or memory changed other than by
    appends; one new stored point per step is an O(Ns N^2) extension.

    ``dtype`` is the compute dtype of the rollout and the optimizer: ``plan``
    takes a state of that dtype and raises TypeError on another;
    ``master_dtype`` is that of the factorization cache, ``dtype`` unless
    given. ``master_dtype=float64``
    with ``dtype=float32`` is mixed mode: an f64 master, split into a
    double-float32 rollout cache for each plan. That is the JAX package's
    default configuration, whose Planner keeps an f64 master whenever x64 is on
    (as it is by default); torch has no global x64 switch, so here the
    choice is an argument. ``device`` defaults to ``cuda``.
    """

    # more appended points than this per step -> full refactorize is cheaper
    _MAX_EXTENDS_PER_STEP = 8

    def __init__(self, spec: PlanSpec, dtype=torch.float32, device="cuda", master_dtype=None):
        self.device = torch.device(device)
        master_dtype = dtype if master_dtype is None else master_dtype
        for dt in (dtype, master_dtype):
            if dt not in (torch.float32, torch.float64):
                raise TypeError(f"Planner takes float32 or float64, got {dt}")
        self.spec = spec
        self.dtype = dtype
        self.master_dtype = master_dtype
        self._cache: Optional[FactorizationCache] = None
        self._cache_n = -1
        self._cache_bucket = -1
        self._cache_params = None  # identity of the GPParams the cache was built with
        self._cache_was_dummy = False
        self._extend_safe = True
        self._extend_safe_params = None

    def _check_state(self, state_mu):
        if state_mu.dtype != self.dtype:
            raise TypeError(f"this Planner rolls out in {self.dtype}; got a {state_mu.dtype} state")

    def _tensor(self, a, dtype=None):
        # master-dtype copy: callers update their host buffers in place between
        # steps, and a CPU tensor made with as_tensor would share that memory
        return torch.tensor(np.asarray(a), dtype=dtype or self.master_dtype, device=self.device)

    def _extend_numerically_safe(self, params, bounds) -> bool:
        """The rank-1 extension loses ~eps * cond(K) per update. An f64
        master is always safe; an f32 one only while eps * cond_estimate is
        far below one, else every step refactorizes."""
        if self.master_dtype == torch.float64:
            return True
        if params is self._extend_safe_params:
            return self._extend_safe
        _, outputscale, noise = constrained_params(params, bounds)
        cond_est = float(torch.max(outputscale / noise)) + 1.0
        self._extend_safe = torch.finfo(self.master_dtype).eps * cond_est < 1e-3
        self._extend_safe_params = params
        return self._extend_safe

    def _cache_status(self, x_pad, y_pad, mask, params, bounds=None, is_dummy=None):
        bucket = int(x_pad.shape[0])
        n_active = int(np.sum(mask))
        if is_dummy is None:
            # callers without a Memory object: the dummy placeholder is a
            # single all-zero point
            is_dummy = bool(n_active == 1 and not np.any(x_pad[0]) and not np.any(y_pad[0]))
        appended = n_active - self._cache_n
        can_extend = (
            self._cache is not None
            and params is self._cache_params
            and bucket == self._cache_bucket
            and not self._cache_was_dummy
            and 0 <= appended <= self._MAX_EXTENDS_PER_STEP
            and (bounds is None or self._extend_numerically_safe(params, bounds))
        )
        return bucket, n_active, is_dummy, appended, can_extend

    def _note_cache(self, bucket, n_active, is_dummy, params):
        self._cache_n = n_active
        self._cache_bucket = bucket
        self._cache_params = params
        self._cache_was_dummy = is_dummy

    def refresh_cache(self, x_pad, y_pad, mask, params, bounds, is_dummy=None) -> FactorizationCache:
        """Bring the device factorization cache up to date with memory
        (host arrays x_pad (N, D), y_pad (N, Ns), mask (N,))."""
        bucket, n_active, is_dummy, appended, can_extend = self._cache_status(
            x_pad, y_pad, mask, params, bounds, is_dummy=is_dummy)
        if can_extend:
            for i in range(self._cache_n, n_active):
                self._cache = extend_factorization(
                    self._cache, self._tensor(x_pad[i]), self._tensor(y_pad[i]))
        else:
            # the master is factorized in its own dtype whatever the
            # parameters' (the JAX package's ``upcast`` of an f32 session's
            # parameters to its f64 master)
            def master(tree, cls):
                return cls(*(a.to(device=self.device, dtype=self.master_dtype) for a in tree))

            self._cache = masked_cholesky_factorize(
                master(params, GPParams), master(bounds, GPBounds), self._tensor(x_pad), self._tensor(y_pad),
                self._tensor(mask, dtype=torch.bool))
        self._note_cache(bucket, n_active, is_dummy, params)
        return self._cache

    def plan(self, x_pad, y_pad, mask, params, bounds, state_mu, state_var, inits, action_prev,
             iter_ctrl, is_dummy=None):
        """(a_opt, actions_model, info) for the current memory."""
        self._check_state(state_mu)
        bucket, n_active, is_dummy, appended, can_extend = self._cache_status(
            x_pad, y_pad, mask, params, bounds, is_dummy=is_dummy)
        if can_extend and appended == 1:
            i = self._cache_n
            self._cache, a_opt, actions_model, info = extend_plan(
                self.spec, self._cache, self._tensor(x_pad[i]), self._tensor(y_pad[i]),
                state_mu, state_var, inits, action_prev, iter_ctrl)
            self._note_cache(bucket, n_active, is_dummy, params)
            return a_opt, actions_model, info
        # forward the resolved flag so the value-based dummy heuristic never
        # re-runs when a Memory-derived flag exists
        cache = self.refresh_cache(x_pad, y_pad, mask, params, bounds, is_dummy=is_dummy)
        return _plan_from_cache(self.spec, cache, state_mu, state_var, inits, action_prev, iter_ctrl)

    def evaluate(self, x_pad, y_pad, mask, params, bounds, state_mu, state_var, actions_mpc, action_prev,
                 iter_ctrl, is_dummy=None):
        """(actions_model, info) of one given action sequence, forward only:
        the random-warmup rollout (the JAX ``build_cached_eval_fn`` after a
        cache refresh)."""
        self._check_state(state_mu)
        cache = _cast_cache(self.refresh_cache(x_pad, y_pad, mask, params, bounds, is_dummy=is_dummy),
                            state_mu.dtype)
        with torch.no_grad():
            _, info = _objective_and_info(self.spec, cache, actions_mpc, state_mu, state_var, action_prev, iter_ctrl)
            actions_model = mpc_to_model_actions(self.spec.action, actions_mpc, action_prev)
        return actions_model, info

"""Setpoint quadratic cost with analytic mean and variance under a Gaussian
state, optional CDF state-constraint penalties, and a terminal cost.

Port of ``gpmpc_tpu/mappers/reward.py``. Per stage, with the block-diagonal
weight W, error e = [s; a] - target and state-action covariance Sigma
(action block zero):

  E[cost]   = tr(Sigma W) + e^T W e
  Var[cost] = 2 tr((W Sigma)^2) + 4 e^T W Sigma W e

As in the reference, the constraint penalty passes the variance diagonal
where the normal CDF expects a standard deviation. The stage loop is a batch
dimension.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class RewardSpec(NamedTuple):
    target_state_action_norm: torch.Tensor  # (Ns+Na,)
    weight_matrix_cost: torch.Tensor  # (Ns+Na, Ns+Na)
    target_state_norm: torch.Tensor  # (Ns,)
    weight_matrix_cost_terminal: torch.Tensor  # (Ns, Ns)
    use_constraints: bool
    state_min: torch.Tensor  # (Ns,)
    state_max: torch.Tensor  # (Ns,)
    area_multiplier: float
    exploration_factor: float
    clip_lower_bound_cost_to_0: bool


def _normal_cdf(x, mu, sigma):
    return 0.5 * (1.0 + torch.special.erf((x - mu) / (sigma * math.sqrt(2.0))))


def _quad_cost(error, sa_var, W):
    """Batched over a leading axis: error (B, K), sa_var (B, K, K), W (K, K)."""
    e_row = error[:, None, :]
    e_col = error[:, :, None]
    cost_mu = torch.diagonal(sa_var @ W, dim1=-2, dim2=-1).sum(-1) + (e_row @ W @ e_col)[:, 0, 0]
    TS = W @ sa_var
    cost_var = 2.0 * torch.diagonal(TS @ TS, dim1=-2, dim2=-1).sum(-1) \
        + 4.0 * (e_row @ TS @ W @ e_col)[:, 0, 0]
    return cost_mu, cost_var


def reward_single(spec: RewardSpec, state_mu, state_var, action):
    """Stage reward (negative cost) and cost variance, batched over stages:
    state_mu (B, Ns), state_var (B, Ns, Ns), action (B, Na) -> (B,), (B,)."""
    na = action.shape[-1]
    error = torch.cat([state_mu, action], dim=-1) - spec.target_state_action_norm
    sa_var = F.pad(state_var, (0, na, 0, na))
    cost_mu, cost_var = _quad_cost(error, sa_var, spec.weight_matrix_cost)
    if spec.use_constraints:
        # the reference's live path adds the CDF penalties without area_multiplier
        var_diag = torch.diagonal(state_var, dim1=-2, dim2=-1)
        pen_min = _normal_cdf(spec.state_min, state_mu, var_diag)
        pen_max = 1.0 - _normal_cdf(spec.state_max, state_mu, var_diag)
        cost_mu = cost_mu + pen_max.sum(-1) + pen_min.sum(-1)
    return -cost_mu, cost_var


def reward_terminal(spec: RewardSpec, state_mu, state_var):
    """Terminal reward with its own weights: (Ns,), (Ns, Ns) -> scalars."""
    error = (state_mu - spec.target_state_norm)[None]
    cost_mu, cost_var = _quad_cost(error, state_var[None], spec.weight_matrix_cost_terminal)
    return -cost_mu[0], cost_var[0]


def rewards_trajectory(spec: RewardSpec, states_mu, states_var, actions):
    """Stage rewards on states[:-1] with actions, terminal on states[-1]:
    ((Nh+1,), (Nh+1,))."""
    r_stage, rv_stage = reward_single(spec, states_mu[:-1], states_var[:-1], actions)
    r_term, rv_term = reward_terminal(spec, states_mu[-1], states_var[-1])
    return torch.cat([r_stage, r_term[None]]), torch.cat([rv_stage, rv_term[None]])

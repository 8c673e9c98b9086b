"""Action mappings: optimizer variables in [0, 1] -> normalized model actions.

Port of ``gpmpc_tpu/mappers/action.py``. The normalization mapping is a
reshape; the derivative mapping (``limit_action_change``) maps per-step
deltas to [-max_change, +max_change], cumsums them from the previous action
and clamps to [0, 1] with a straight-through gradient. ``norm_action`` and
``denorm_action`` map raw env actions to and from the normalized ones on the
host, in numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class _SteClamp(torch.autograd.Function):
    """Clamp whose gradient passes straight through, so the optimizer's
    gradient still flows at the bounds."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ste_clamp(x, lo: float, hi: float):
    return _SteClamp.apply(x, lo, hi)


class ActionMapperSpec(NamedTuple):
    limit_action_change: bool
    max_change_action_norm: torch.Tensor  # (Na,)
    len_horizon: int
    dim_action: int


def mpc_to_model_actions(spec: ActionMapperSpec, actions_mpc, action_prev):
    """Flat (..., Nh*Na) optimizer variables -> (..., Nh, Na) normalized
    actions; ``action_prev`` (..., Na) anchors the cumsum of the derivative
    mapping. Leading batches broadcast."""
    acts = actions_mpc.reshape(actions_mpc.shape[:-1] + (spec.len_horizon, spec.dim_action))
    if not spec.limit_action_change:
        return acts
    mc = spec.max_change_action_norm
    deltas = acts * 2.0 * mc - mc
    deltas = deltas.expand(torch.broadcast_shapes(deltas.shape[:-2], action_prev.shape[:-1]) + deltas.shape[-2:])
    deltas = torch.cat([deltas[..., :1, :] + action_prev[..., None, :], deltas[..., 1:, :]], dim=-2)
    return ste_clamp(torch.cumsum(deltas, dim=-2), 0.0, 1.0)


def norm_action(action_raw, action_low, action_high):
    return (np.asarray(action_raw, dtype=np.asarray(action_low).dtype) - action_low) / (action_high - action_low)


def denorm_action(action_model, action_low, action_high):
    return np.asarray(action_model) * (action_high - action_low) + action_low

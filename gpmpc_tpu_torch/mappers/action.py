"""Action mappings: optimizer variables in [0, 1] -> normalized model actions.

Port of ``gpmpc_tpu/mappers/action.py``. The normalization mapping is a
reshape; the derivative mapping (``limit_action_change``) maps per-step
deltas to [-max_change, +max_change], cumsums them from the previous action
and clamps to [0, 1] with a straight-through gradient.
"""

from __future__ import annotations

from typing import NamedTuple

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
    """Flat (Nh*Na,) optimizer variables -> (Nh, Na) normalized actions;
    ``action_prev`` anchors the cumsum of the derivative mapping."""
    acts = actions_mpc.reshape(spec.len_horizon, spec.dim_action)
    if not spec.limit_action_change:
        return acts
    mc = spec.max_change_action_norm
    deltas = acts * 2.0 * mc - mc
    deltas = torch.cat([deltas[:1] + action_prev, deltas[1:]], dim=0)
    return ste_clamp(torch.cumsum(deltas, dim=0), 0.0, 1.0)

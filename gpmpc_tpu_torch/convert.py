"""Numpy arrays in, the port's objects out.

Hands the JAX package's parameters and state to the port: convert each JAX
array with ``numpy.asarray`` and pass the fields by name (a NamedTuple's
``_asdict()``), e.g. ``gp_params_from_numpy(**{k: np.asarray(v) for k, v in
params._asdict().items()})``. Every function takes the target ``dtype`` and
``device`` (default ``cuda``); float arrays are cast to ``dtype``, masks stay
boolean, and flags, counts and scalars stay Python values.

A controller's state crosses as its GP raw parameters (``gp_params_from_numpy``)
and its memory (``load_memory``, whose arrays stay numpy, as in both
packages).
"""

from __future__ import annotations

import numpy as np
import torch

from .mappers.action import ActionMapperSpec
from .mappers.reward import RewardSpec
from .memory.buffer import Memory
from .models.gp import DFCache, FactorizationCache, GPBounds, GPParams, split_cache_df


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def gp_params_from_numpy(raw_lengthscales, raw_outputscale, raw_noise, *,
                         dtype=torch.float32, device="cuda") -> GPParams:
    return GPParams(*(_t(a, dtype, device) for a in (raw_lengthscales, raw_outputscale, raw_noise)))


def gp_bounds_from_numpy(min_lengthscale, max_lengthscale, min_outputscale, max_outputscale,
                         min_noise, max_noise, *, dtype=torch.float32, device="cuda") -> GPBounds:
    return GPBounds(*(_t(a, dtype, device) for a in (
        min_lengthscale, max_lengthscale, min_outputscale, max_outputscale, min_noise, max_noise)))


def reward_spec_from_numpy(target_state_action_norm, weight_matrix_cost, target_state_norm,
                           weight_matrix_cost_terminal, use_constraints, state_min, state_max,
                           area_multiplier, exploration_factor, clip_lower_bound_cost_to_0, *,
                           dtype=torch.float32, device="cuda") -> RewardSpec:
    return RewardSpec(
        target_state_action_norm=_t(target_state_action_norm, dtype, device),
        weight_matrix_cost=_t(weight_matrix_cost, dtype, device),
        target_state_norm=_t(target_state_norm, dtype, device),
        weight_matrix_cost_terminal=_t(weight_matrix_cost_terminal, dtype, device),
        use_constraints=bool(use_constraints),
        state_min=_t(state_min, dtype, device),
        state_max=_t(state_max, dtype, device),
        area_multiplier=float(area_multiplier),
        exploration_factor=float(exploration_factor),
        clip_lower_bound_cost_to_0=bool(clip_lower_bound_cost_to_0),
    )


def action_spec_from_numpy(limit_action_change, max_change_action_norm, len_horizon, dim_action, *,
                           dtype=torch.float32, device="cuda") -> ActionMapperSpec:
    return ActionMapperSpec(
        limit_action_change=bool(limit_action_change),
        max_change_action_norm=_t(max_change_action_norm, dtype, device),
        len_horizon=int(len_horizon),
        dim_action=int(dim_action),
    )


def cache_from_numpy(x_mem, mask, iK, beta, lengthscales, outputscales, L, noises, y_mem, *,
                     dtype=torch.float32, device="cuda") -> FactorizationCache:
    return FactorizationCache(
        x_mem=_t(x_mem, dtype, device),
        mask=torch.tensor(np.asarray(mask), dtype=torch.bool, device=device),
        iK=_t(iK, dtype, device),
        beta=_t(beta, dtype, device),
        lengthscales=_t(lengthscales, dtype, device),
        outputscales=_t(outputscales, dtype, device),
        L=_t(L, dtype, device),
        noises=_t(noises, dtype, device),
        y_mem=_t(y_mem, dtype, device),
    )


def df_cache_from_numpy(x_mem, mask, iK, beta, lengthscales, outputscales, L, noises, y_mem, *,
                        device="cuda") -> DFCache:
    """The JAX package's f64 master cache, split into the port's df32 rollout
    cache on ``device`` (what the mixed planner rolls out on)."""
    return split_cache_df(cache_from_numpy(x_mem, mask, iK, beta, lengthscales, outputscales, L, noises,
                                           y_mem, dtype=torch.float64, device=device))


# a Memory's state: its arrays, then its counters
MEMORY_ARRAYS = ("inputs", "states_next", "rewards", "iter_ctrls", "errors", "stds", "active_data_mask",
                 "model_inputs", "model_targets")
MEMORY_COUNTERS = ("len_mem", "len_mem_last_processed", "len_mem_model")


def memory_state(memory) -> dict:
    """The arrays (copied) and counters of a Memory of either package, by
    name."""
    state = {k: np.array(getattr(memory, k)) for k in MEMORY_ARRAYS}
    state.update({k: int(getattr(memory, k)) for k in MEMORY_COUNTERS})
    return state


def load_memory(memory: Memory, **state) -> Memory:
    """Put ``memory`` in the state ``memory_state`` read from another
    Memory (of the same dims); the arrays keep their dtype, the float ones
    that of ``memory``. Returns ``memory``."""
    for k in MEMORY_ARRAYS:
        a = np.asarray(state[k])
        setattr(memory, k, np.array(a, dtype=memory.dtype if a.dtype.kind == "f" else a.dtype))
    for k in MEMORY_COUNTERS:
        setattr(memory, k, int(state[k]))
    return memory

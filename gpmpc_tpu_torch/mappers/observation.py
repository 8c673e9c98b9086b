"""Observation <-> normalized-state mapping.

A copy of ``gpmpc_tpu/mappers/observation.py`` (plain numpy). Equivalent of the reference's NormalizationObservationStateMapper
(normalization_observation_state_mapper.py:14-22): min-max normalize the env
observation to [0,1]^Ns using the observation-space bounds; the observation
variance is normalized by (high-low)^2, and a fixed configured diagonal
variance is used when the env reports none
(abstract_observation_state_mapper.py:13).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ObservationNormalizer:
    def __init__(self, observation_low, observation_high, obs_var_norm, dtype=np.float64):
        self.obs_low = np.asarray(observation_low, dtype=dtype)
        self.obs_high = np.asarray(observation_high, dtype=dtype)
        self.range = self.obs_high - self.obs_low
        self.var_norm_factor = self.range**2
        self.dim_observation = len(self.obs_low)
        self.obs_var_norm = np.diag(np.asarray(obs_var_norm, dtype=dtype))
        self.dtype = dtype

    def get_state(self, obs, obs_var: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        state = (np.asarray(obs, dtype=self.dtype) - self.obs_low) / self.range
        if obs_var is not None:
            state_var = np.asarray(obs_var, dtype=self.dtype) / self.var_norm_factor
        else:
            state_var = self.obs_var_norm
        return state, state_var

    def denorm_state(self, state) -> np.ndarray:
        return np.asarray(state, dtype=self.dtype) * self.range + self.obs_low

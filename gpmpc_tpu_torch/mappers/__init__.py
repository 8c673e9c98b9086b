"""Observation, action and reward mappings."""

from .action import ActionMapperSpec, denorm_action, mpc_to_model_actions, norm_action
from .observation import ObservationNormalizer
from .reward import RewardSpec, reward_single, reward_terminal, rewards_trajectory

__all__ = [
    "ActionMapperSpec",
    "ObservationNormalizer",
    "RewardSpec",
    "denorm_action",
    "mpc_to_model_actions",
    "norm_action",
    "reward_single",
    "reward_terminal",
    "rewards_trajectory",
]

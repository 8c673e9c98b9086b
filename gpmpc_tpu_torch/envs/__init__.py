"""Gym-free environments (copies of ``gpmpc_tpu/envs``, plain numpy)."""

from .base import Box, EnvBase
from .pendulum import PendulumEnv

__all__ = ["Box", "EnvBase", "PendulumEnv"]

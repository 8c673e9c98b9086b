"""Gym-free environments (copies of ``gpmpc_tpu/envs``, plain numpy)."""

from .base import Box, EnvBase
from .mountain_car import MountainCarContinuousEnv
from .pendulum import PendulumEnv
from .process_control import ProcessControl

__all__ = ["Box", "EnvBase", "MountainCarContinuousEnv", "PendulumEnv", "ProcessControl"]

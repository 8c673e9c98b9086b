"""Configuration dataclasses (a copy of ``gpmpc_tpu/config``)."""

from .configs import (
    ActionsConfig,
    Config,
    ControllerConfig,
    MemoryConfig,
    ModelConfig,
    ObservationConfig,
    RewardConfig,
    TrainingConfig,
    VisuConfig,
)

__all__ = [
    "ActionsConfig",
    "Config",
    "ControllerConfig",
    "MemoryConfig",
    "ModelConfig",
    "ObservationConfig",
    "RewardConfig",
    "TrainingConfig",
    "VisuConfig",
]

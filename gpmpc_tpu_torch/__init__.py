"""gpmpc_tpu_torch: the PyTorch/CUDA port of gpmpc_tpu (GP-MPC, data-efficient
RL with probabilistic model predictive control) for NVIDIA Hopper.

The controller (``GpMpcController``, built from a ``Config``) plans with the
steady-state planning step (``controllers.planner.Planner``) in f64, in
mixed mode (``Config(dtype="float32")``: an f64 master with a double-float32
rollout) or in f32, and trains its GP hyperparameters in a worker thread.
``run_env`` and ``run_env_multiple`` run online-learning episodes of it on
a gym-style env (``envs``), ``ControlVisualizations`` plots them, and
``example_configs`` holds the three shipped examples' configurations, and
``parallel`` splits planning and training across the ranks of a
``torch.distributed`` group.
The moment-matching covariance core (f32 and df32), the whole df32 step and
the Gram matrix run in hand-written CUDA kernels (``ops``). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, where every kernel is
replaced by its plain PyTorch twin. Importing the package sets no global
state and builds nothing; the kernels are compiled at first use.
"""

from .config import (
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
from .controllers.controller import GpMpcController, IterationInformation
from .runner.run_env import run_env, run_env_multiple
from .viz.visu import ControlVisualizations

__all__ = [
    "ActionsConfig",
    "Config",
    "ControllerConfig",
    "ControlVisualizations",
    "GpMpcController",
    "IterationInformation",
    "MemoryConfig",
    "ModelConfig",
    "ObservationConfig",
    "RewardConfig",
    "TrainingConfig",
    "VisuConfig",
    "run_env",
    "run_env_multiple",
]

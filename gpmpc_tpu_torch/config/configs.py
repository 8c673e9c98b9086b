"""Configuration tree for the GP-MPC controller.

A copy of ``gpmpc_tpu/config/configs.py`` (plain dataclasses holding numpy
arrays, no JAX), with the same fields, defaults and keyword names. It mirrors
the reference config surface (reference rl_gp_mpc/config_classes/*.py:
Config aggregating 7 sub-configs, total_config.py:14-31). There is no
import-time global-dtype side effect; precision is selected per controller
via ``Config.dtype`` (and, for the port's pure-f32 session, the controller's
``master_dtype``).

Scalar-vs-list broadcasting follows the reference's ``extend_dim`` /
``extend_dim_lengthscale_time`` semantics (functions_process_config.py:18-36):
scalars broadcast to per-state/per-input vectors, and when the time feature is
enabled the last input column gets its own lengthscale bounds/init.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

ArrayLike = Union[float, int, Sequence[float], np.ndarray]


def _as_1d(value: ArrayLike, dim: int, name: str) -> np.ndarray:
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full((dim,), float(arr))
    if arr.shape != (dim,):
        raise ValueError(f"{name}: expected shape ({dim},), got {arr.shape}")
    return arr


def _as_2d(value: ArrayLike, dim0: int, dim1: int, name: str) -> np.ndarray:
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full((dim0, dim1), float(arr))
    elif arr.ndim == 1:
        if arr.shape[0] == dim0:
            # per-model scalar lengthscale broadcast across inputs
            arr = np.repeat(arr[:, None], dim1, axis=1)
        elif arr.shape[0] == dim1:
            arr = np.repeat(arr[None, :], dim0, axis=0)
        else:
            raise ValueError(f"{name}: cannot broadcast shape {arr.shape} to ({dim0}, {dim1})")
    if arr.shape != (dim0, dim1):
        raise ValueError(f"{name}: expected shape ({dim0}, {dim1}), got {arr.shape}")
    return arr


@dataclass
class ObservationConfig:
    """Observation→state mapping config (reference observation_config.py:3-11).

    obs_var_norm: fixed per-dim observation variance (normalized units) used
    when the env does not report one.
    """

    obs_var_norm: ArrayLike = (1e-6, 1e-6, 1e-6)


@dataclass
class RewardConfig:
    """Setpoint quadratic cost config (reference reward_config.py:4-64)."""

    target_state_norm: ArrayLike = (1.0, 0.5, 0.5)
    weight_state: ArrayLike = (1.0, 0.1, 0.1)
    weight_state_terminal: ArrayLike = (10.0, 5.0, 5.0)
    target_action_norm: ArrayLike = (0.5,)
    weight_action: ArrayLike = (0.05,)
    exploration_factor: float = 3.0
    use_constraints: bool = False
    state_min: ArrayLike = (-0.1, 0.05, 0.05)
    state_max: ArrayLike = (1.1, 0.95, 0.925)
    # accepted for reference-config compatibility but intentionally unused:
    # the reference's live get_reward path adds constraint CDF penalties
    # un-multiplied (setpoint_distance_reward_mapper.py:66); only its dead
    # get_rewards duplicate applies the multiplier.
    area_multiplier: float = 1.0
    clip_lower_bound_cost_to_0: bool = False


@dataclass
class ActionsConfig:
    """Action-space mapping config (reference actions_config.py:4-16)."""

    limit_action_change: bool = False
    max_change_action_norm: ArrayLike = (0.05,)


@dataclass
class ModelConfig:
    """GP dynamics-model config (reference model_config.py:4-67).

    ``gp_init`` keys follow the reference naming: ``noise_covar.noise`` is the
    noise *variance*, ``base_kernel.lengthscale`` per-(model, input), and
    ``outputscale`` the kernel scale.
    """

    gp_init: dict = field(
        default_factory=lambda: {
            "noise_covar.noise": [1e-4, 1e-4, 1e-4],
            "base_kernel.lengthscale": [
                [0.75, 0.75, 0.75, 0.75],
                [0.75, 0.75, 0.75, 0.75],
                [0.75, 0.75, 0.75, 0.75],
            ],
            "outputscale": [5e-2, 5e-2, 5e-2],
        }
    )
    init_lengthscale_time: float = 100.0
    min_std_noise: ArrayLike = 1e-3
    max_std_noise: ArrayLike = 3e-1
    min_outputscale: ArrayLike = 1e-5
    max_outputscale: ArrayLike = 0.95
    min_lengthscale: ArrayLike = 4e-3
    max_lengthscale: ArrayLike = 25.0
    min_lengthscale_time: float = 10.0
    max_lengthscale_time: float = 10000.0
    include_time_model: bool = False

    def resolved(self, dim_state: int, dim_input: int) -> "ResolvedModelConfig":
        """Broadcast all bounds/inits to full per-(model, input) arrays.

        Equivalent of the reference's ``extend_dimensions_params``
        (model_config.py:46-67).
        """
        min_noise_var = _as_1d(self.min_std_noise, dim_state, "min_std_noise") ** 2
        max_noise_var = _as_1d(self.max_std_noise, dim_state, "max_std_noise") ** 2
        min_outputscale = _as_1d(self.min_outputscale, dim_state, "min_outputscale")
        max_outputscale = _as_1d(self.max_outputscale, dim_state, "max_outputscale")

        if self.include_time_model:
            d_nontime = dim_input - 1
            min_ls = np.empty((dim_state, dim_input))
            max_ls = np.empty((dim_state, dim_input))
            min_ls[:, :d_nontime] = _as_2d(self.min_lengthscale, dim_state, d_nontime, "min_lengthscale")
            max_ls[:, :d_nontime] = _as_2d(self.max_lengthscale, dim_state, d_nontime, "max_lengthscale")
            min_ls[:, -1] = self.min_lengthscale_time
            max_ls[:, -1] = self.max_lengthscale_time
            init_ls = np.empty((dim_state, dim_input))
            init_ls[:, :d_nontime] = _as_2d(
                self.gp_init["base_kernel.lengthscale"], dim_state, d_nontime, "gp_init lengthscale"
            )
            init_ls[:, -1] = self.init_lengthscale_time
        else:
            min_ls = _as_2d(self.min_lengthscale, dim_state, dim_input, "min_lengthscale")
            max_ls = _as_2d(self.max_lengthscale, dim_state, dim_input, "max_lengthscale")
            init_ls = _as_2d(self.gp_init["base_kernel.lengthscale"], dim_state, dim_input, "gp_init lengthscale")

        init_noise_var = _as_1d(self.gp_init["noise_covar.noise"], dim_state, "gp_init noise")
        init_outputscale = _as_1d(self.gp_init["outputscale"], dim_state, "gp_init outputscale")

        return ResolvedModelConfig(
            include_time_model=self.include_time_model,
            min_noise_var=min_noise_var,
            max_noise_var=max_noise_var,
            min_outputscale=min_outputscale,
            max_outputscale=max_outputscale,
            min_lengthscale=min_ls,
            max_lengthscale=max_ls,
            init_noise_var=init_noise_var,
            init_outputscale=init_outputscale,
            init_lengthscale=init_ls,
        )


@dataclass
class ResolvedModelConfig:
    """ModelConfig broadcast to concrete (dim_state, dim_input) arrays."""

    include_time_model: bool
    min_noise_var: np.ndarray
    max_noise_var: np.ndarray
    min_outputscale: np.ndarray
    max_outputscale: np.ndarray
    min_lengthscale: np.ndarray
    max_lengthscale: np.ndarray
    init_noise_var: np.ndarray
    init_outputscale: np.ndarray
    init_lengthscale: np.ndarray


@dataclass
class MemoryConfig:
    """Transition-memory config (reference memory_config.py:4-21).

    ``points_batch_memory`` is the chunk by which the memory's buffers grow;
    it corresponds to the reference's preallocated batch size of 1500.
    """

    check_errors_for_storage: bool = True
    min_error_prediction_state_for_memory: ArrayLike = (3e-4, 3e-4, 3e-4)
    min_prediction_state_std_for_memory: ArrayLike = (3e-3, 3e-3, 3e-3)
    points_batch_memory: int = 1500


@dataclass
class TrainingConfig:
    """Hyperparameter-training config (reference training_config.py:3-24).

    ``lr_train`` is the torch-LBFGS learning rate of the reference's MLL
    optimizer (gp_model.py:262-269, line_search_fn='strong_wolfe'); here it
    is the base trial step of the L-BFGS line search, with doubling
    expansion candidates standing in for strong-wolfe bracketing growth
    (controllers/lbfgs.py `init_step_scale`).

    ``step_print_train`` (the reference's per-iteration print cadence inside
    the spawned training process, gp_model.py:270-279) is accepted for
    config-surface parity but INTENTIONALLY INERT, like ``eps``, as in the
    JAX package; ``print_train`` prints the per-model losses once per
    completed training (controllers/controller.py check_and_close_processes).
    """

    lr_train: float = 7e-3
    iter_train: int = 15
    training_frequency: int = 25
    clip_grad_value: float = 1e-3
    print_train: bool = False
    step_print_train: int = 5  # inert — see class docstring
    # additions of the JAX package, kept with its names: the number of
    # random-restart initializations trained per call (the reference runs
    # exactly one random re-init per training call, gp_model.py:236-253), and
    # ``async_dispatch``, accepted and unused there and here (training is
    # always dispatched asynchronously, controllers/controller.py).
    restarts_train: int = 1
    async_dispatch: bool = True


@dataclass
class ControllerConfig:
    """MPC controller config (reference controller_config.py:1-37)."""

    len_horizon: int = 15
    actions_optimizer_params: dict = field(
        default_factory=lambda: {
            "maxcor": 30,
            "eps": 1e-2,
            "maxfun": 30,
            "maxiter": 30,
            "maxls": 30,
        }
    )
    init_from_previous_actions: bool = True
    restarts_optim: int = 1
    optimize: bool = True
    num_repeat_actions: int = 1


@dataclass
class VisuConfig:
    """Visualization config (reference visu_config.py:1-20)."""

    save_render_env: bool = True
    render_live_plot_2d: bool = True
    render_env: bool = True
    save_live_plot_2d: bool = False
    folder_save: str = "folder_save"


@dataclass
class Config:
    """Top-level config aggregating all sub-configs (reference total_config.py:14-31)."""

    observation: ObservationConfig = field(default_factory=ObservationConfig)
    reward: RewardConfig = field(default_factory=RewardConfig)
    actions: ActionsConfig = field(default_factory=ActionsConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    # numeric dtype of the memory, the GP parameters and the rollout; float64
    # matches the reference (total_config.py:11), float32 is mixed mode (an
    # f64 factorization master with a double-float32 rollout).
    dtype: str = "float64"

    def __init__(
        self,
        observation_config: Optional[ObservationConfig] = None,
        reward_config: Optional[RewardConfig] = None,
        actions_config: Optional[ActionsConfig] = None,
        model_config: Optional[ModelConfig] = None,
        memory_config: Optional[MemoryConfig] = None,
        training_config: Optional[TrainingConfig] = None,
        controller_config: Optional[ControllerConfig] = None,
        dtype: str = "float64",
        **kwargs,
    ):
        # Accept both the reference's *_config keyword names and plain names.
        self.observation = observation_config or kwargs.get("observation") or ObservationConfig()
        self.reward = reward_config or kwargs.get("reward") or RewardConfig()
        self.actions = actions_config or kwargs.get("actions") or ActionsConfig()
        self.model = model_config or kwargs.get("model") or ModelConfig()
        self.memory = memory_config or kwargs.get("memory") or MemoryConfig()
        self.training = training_config or kwargs.get("training") or TrainingConfig()
        self.controller = controller_config or kwargs.get("controller") or ControllerConfig()
        self.dtype = dtype

    def replace(self, **kwargs) -> "Config":
        new = Config()
        for f in ("observation", "reward", "actions", "model", "memory", "training", "controller", "dtype"):
            setattr(new, f, kwargs.get(f, getattr(self, f)))
        return new

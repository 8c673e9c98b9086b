"""The controller configurations of the three shipped examples, for the port.

Each copies ``examples/<env>/config_<env>.py``'s ``get_config``: the same
arguments and defaults, plus ``dtype`` (``"float64"``, the JAX examples'
precision, or ``"float32"``, mixed mode: an f64 factorization master with a
double-float32 rollout).

* ``pendulum_config``: examples/pendulum/config_pendulum.py (Nh=15, repeat 1,
  an L-BFGS-B budget of 4), for ``envs.PendulumEnv``; also takes
  ``training_frequency`` (25 there);
* ``mountain_car_config``: examples/mountain_car/config_mountaincar.py
  (Nh=10, repeat 5, two restarts at a budget of 8, sparse reward handled by
  the exploration term and weight_state=[1, 0]), for
  ``envs.MountainCarContinuousEnv``;
* ``process_control_config``: examples/process_control/config_process_control.py
  (MIMO, Nh=4, repeat 10, two restarts at a budget of 15, the time model on
  by default), for ``envs.ProcessControl``.
"""

from __future__ import annotations

from .config import (
    ActionsConfig,
    Config,
    ControllerConfig,
    MemoryConfig,
    ModelConfig,
    ObservationConfig,
    RewardConfig,
    TrainingConfig,
)


def pendulum_config(len_horizon=15, include_time_model=False, num_repeat_actions=1, dtype="float64",
                    training_frequency=25) -> Config:
    """The pendulum example's configuration, with its ``dtype`` and
    ``training_frequency`` as arguments."""
    return Config(
        observation_config=ObservationConfig(obs_var_norm=[1e-6, 1e-6, 1e-6]),
        reward_config=RewardConfig(
            target_state_norm=[1, 0.5, 0.5],
            weight_state=[1, 0.1, 0.1],
            weight_state_terminal=[5, 2, 2],
            target_action_norm=[0.5],
            weight_action=[1e-3],
            exploration_factor=1,
            use_constraints=False,
            state_min=[-3, -3, -3],
            state_max=[3, 3, 3],
            area_multiplier=1,
            clip_lower_bound_cost_to_0=False,
        ),
        actions_config=ActionsConfig(limit_action_change=False, max_change_action_norm=[0.3]),
        model_config=ModelConfig(
            gp_init={
                "noise_covar.noise": [1e-5, 1e-5, 1e-5],
                "base_kernel.lengthscale": [0.5, 0.5, 0.5],
                "outputscale": [5e-2, 5e-2, 5e-2],
            },
            min_std_noise=1e-3,
            max_std_noise=1e-2,
            min_outputscale=1e-2,
            max_outputscale=0.95,
            min_lengthscale=4e-3,
            max_lengthscale=10.0,
            min_lengthscale_time=10,
            max_lengthscale_time=10000,
            init_lengthscale_time=100,
            include_time_model=include_time_model,
        ),
        memory_config=MemoryConfig(
            check_errors_for_storage=True,
            min_error_prediction_state_for_memory=[3e-4, 3e-4, 3e-4],
            min_prediction_state_std_for_memory=[3e-3, 3e-3, 3e-3],
            points_batch_memory=1500,
        ),
        training_config=TrainingConfig(
            lr_train=7e-3, iter_train=15, training_frequency=training_frequency, clip_grad_value=1e-3
        ),
        controller_config=ControllerConfig(
            len_horizon=len_horizon,
            actions_optimizer_params={"maxcor": 4, "eps": 1e-2, "maxfun": 4, "maxiter": 4, "maxls": 4},
            num_repeat_actions=num_repeat_actions,
        ),
        dtype=dtype,
    )


def mountain_car_config(len_horizon=10, num_repeat_actions=5, include_time_model=False, dtype="float64") -> Config:
    """The mountain-car example's configuration, with its ``dtype``."""
    return Config(
        observation_config=ObservationConfig(obs_var_norm=[1e-6, 1e-6]),
        reward_config=RewardConfig(
            target_state_norm=[1, 0.5],
            weight_state=[1, 0],
            weight_state_terminal=[5, 0],
            target_action_norm=[0.5],
            weight_action=[0.05],
            exploration_factor=1,
            use_constraints=False,
            state_min=[0.2, -2],
            state_max=[0.925, 0.85],
            area_multiplier=1,
            clip_lower_bound_cost_to_0=False,
        ),
        actions_config=ActionsConfig(limit_action_change=False, max_change_action_norm=[0.3]),
        model_config=ModelConfig(
            gp_init={
                "noise_covar.noise": [1e-5, 1e-5],
                "base_kernel.lengthscale": [0.5, 0.5],
                "outputscale": [5e-2, 5e-2],
            },
            min_std_noise=1e-3,
            max_std_noise=1e-2,
            min_outputscale=1e-5,
            max_outputscale=0.95,
            min_lengthscale=4e-3,
            max_lengthscale=25.0,
            min_lengthscale_time=10,
            max_lengthscale_time=10000,
            init_lengthscale_time=100,
            include_time_model=include_time_model,
        ),
        memory_config=MemoryConfig(
            check_errors_for_storage=True,
            min_error_prediction_state_for_memory=[3e-3, 3e-3],
            min_prediction_state_std_for_memory=[3e-3, 3e-3],
            points_batch_memory=1500,
        ),
        training_config=TrainingConfig(
            lr_train=7e-3, iter_train=20, training_frequency=60, clip_grad_value=1e-3
        ),
        controller_config=ControllerConfig(
            len_horizon=len_horizon,
            actions_optimizer_params={"maxcor": 8, "eps": 1e-2, "maxfun": 8, "maxiter": 8, "maxls": 8},
            init_from_previous_actions=True,
            restarts_optim=2,
            optimize=True,
            num_repeat_actions=num_repeat_actions,
        ),
        dtype=dtype,
    )


def process_control_config(len_horizon=4, include_time_model=True, num_repeat_actions=10, use_constraints=False,
                           limit_action_change=False, dtype="float64") -> Config:
    """The process-control example's configuration, with its ``dtype``."""
    return Config(
        observation_config=ObservationConfig(obs_var_norm=[1e-6, 1e-6]),
        reward_config=RewardConfig(
            target_state_norm=[0.5, 0.5],
            weight_state=[1, 1],
            weight_state_terminal=[1, 1],
            target_action_norm=[0, 0],
            weight_action=[1e-4, 1e-4],
            exploration_factor=1,
            use_constraints=use_constraints,
            state_min=[0.1, 0.3],
            state_max=[0.9, 0.8],
            area_multiplier=1,
            clip_lower_bound_cost_to_0=False,
        ),
        actions_config=ActionsConfig(limit_action_change=limit_action_change, max_change_action_norm=[0.1, 0.2]),
        model_config=ModelConfig(
            gp_init={
                "noise_covar.noise": [1e-5, 1e-5],
                "base_kernel.lengthscale": [0.25, 0.25],
                "outputscale": [5e-2, 5e-2],
            },
            init_lengthscale_time=100,
            min_std_noise=1e-3,
            max_std_noise=3e-1,
            min_outputscale=1e-5,
            max_outputscale=0.95,
            min_lengthscale=5e-2,
            max_lengthscale=25.0,
            include_time_model=include_time_model,
            min_lengthscale_time=5,
            max_lengthscale_time=1000,
        ),
        memory_config=MemoryConfig(
            check_errors_for_storage=True,
            min_error_prediction_state_for_memory=[1e-5, 1e-5],
            min_prediction_state_std_for_memory=[3e-3, 3e-3],
            points_batch_memory=1500,
        ),
        training_config=TrainingConfig(
            lr_train=7e-3, iter_train=15, training_frequency=15, clip_grad_value=1e-3
        ),
        controller_config=ControllerConfig(
            len_horizon=len_horizon,
            actions_optimizer_params={"maxcor": 15, "eps": 1e-2, "maxfun": 15, "maxiter": 15, "maxls": 15},
            init_from_previous_actions=True,
            restarts_optim=2,
            optimize=True,
            num_repeat_actions=num_repeat_actions,
        ),
        dtype=dtype,
    )

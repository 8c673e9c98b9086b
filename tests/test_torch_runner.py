"""The port's run_env / run_env_multiple against the JAX package's, on the CPU.

* An f64 pendulum episode through both packages' ``run_env``: the costs
  within TOL = 1e-9 (the same f64 arithmetic in another order; measured
  gap 5.8e-15). Training does not fire (training_frequency past the
  episode): the two controllers train asynchronously and could swap new
  parameters in at different steps. Training's own parity is held by
  tests/test_torch_training.py and tests/test_torch_controller.py; the
  two-restart mountain-car episode by tests/test_torch_restarts.py.
* The run_env cases of tests/test_controller_integration.py on the port
  (short pendulum episode, process control, derivative action mapper,
  constraints, time model).
* ``run_env_multiple`` with two runs: its cost array and its plot, in a
  temporary working directory, and no training thread left behind.
* ``run_env`` without ``device`` runs on cuda and raises where torch finds
  no CUDA device.
"""

import threading

import numpy as np
import pytest
import torch

import gpmpc_tpu
import gpmpc_tpu_torch
from gpmpc_tpu.envs import PendulumEnv as JaxPendulum
from gpmpc_tpu.runner.run_env import run_env as jax_run_env
from gpmpc_tpu_torch import run_env, run_env_multiple
from gpmpc_tpu_torch.envs import PendulumEnv, ProcessControl

from tests.test_torch_controller import small_pendulum_config

TOL = 1e-9


def _train_threads():
    return {t for t in threading.enumerate() if t.name.startswith("gpmpc-train")}


def test_pendulum_episode_matches_jax():
    kw = dict(random_actions_init=5, num_steps=10, verbose=False, seed=0)
    jcosts = jax_run_env(JaxPendulum(seed=0), small_pendulum_config(gpmpc_tpu, len_horizon=3, training_frequency=100),
                         None, **kw)
    tcosts = run_env(PendulumEnv(seed=0), small_pendulum_config(gpmpc_tpu_torch, len_horizon=3,
                                                                 training_frequency=100), None, device="cpu", **kw)
    assert len(tcosts) == 10
    np.testing.assert_allclose(tcosts, jcosts, rtol=0, atol=TOL)


# --- the run_env cases of tests/test_controller_integration.py on the port ---


def test_pendulum_short_episode_runs():
    before = _train_threads()
    costs = run_env(PendulumEnv(seed=0), small_pendulum_config(gpmpc_tpu_torch), visu_config=None,
                    random_actions_init=5, num_steps=16, verbose=False, seed=0, device="cpu")
    assert len(costs) == 16
    assert np.all(np.isfinite(costs))
    assert _train_threads() <= before  # the training that fired at step 12 was waited for, its thread stopped


def test_process_control_env_runs():
    env = ProcessControl(change_params=False, seed=0)
    p = gpmpc_tpu_torch
    cfg = p.Config(
        observation_config=p.ObservationConfig(obs_var_norm=[1e-6, 1e-6]),
        reward_config=p.RewardConfig(
            target_state_norm=[0.5, 0.5], weight_state=[1, 1], weight_state_terminal=[1, 1],
            target_action_norm=[0.0, 0.0], weight_action=[1e-4, 1e-4], exploration_factor=1,
            state_min=[0.1, 0.3], state_max=[0.9, 0.8],
        ),
        actions_config=p.ActionsConfig(limit_action_change=False, max_change_action_norm=[0.1, 0.2]),
        model_config=p.ModelConfig(
            gp_init={"noise_covar.noise": [1e-5, 1e-5], "base_kernel.lengthscale": [0.25, 0.25],
                     "outputscale": [5e-2, 5e-2]},
            min_lengthscale=5e-2,
        ),
        memory_config=p.MemoryConfig(min_error_prediction_state_for_memory=[1e-5, 1e-5],
                                     min_prediction_state_std_for_memory=[3e-3, 3e-3], points_batch_memory=64),
        training_config=p.TrainingConfig(iter_train=2, training_frequency=10),
        controller_config=p.ControllerConfig(
            len_horizon=3, actions_optimizer_params={"maxiter": 3, "maxcor": 4, "maxls": 5}, num_repeat_actions=2),
    )
    costs = run_env(env, cfg, visu_config=None, random_actions_init=6, num_steps=14, verbose=False, device="cpu")
    assert len(costs) == 14
    assert np.all(np.isfinite(costs))


def test_derivative_action_mapper_integration():
    costs = run_env(PendulumEnv(seed=5), small_pendulum_config(gpmpc_tpu_torch, limit_action_change=True),
                    visu_config=None, random_actions_init=4, num_steps=10, verbose=False, device="cpu")
    assert np.all(np.isfinite(costs))


def test_constraints_integration():
    costs = run_env(PendulumEnv(seed=6), small_pendulum_config(gpmpc_tpu_torch, use_constraints=True),
                    visu_config=None, random_actions_init=4, num_steps=10, verbose=False, device="cpu")
    assert np.all(np.isfinite(costs))


def test_time_model_integration():
    cfg = small_pendulum_config(gpmpc_tpu_torch)
    cfg.model.include_time_model = True
    costs = run_env(PendulumEnv(seed=7), cfg, visu_config=None, random_actions_init=4, num_steps=10, verbose=False,
                    device="cpu")
    assert np.all(np.isfinite(costs))


def test_run_env_multiple_two_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = _train_threads()
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3, training_frequency=4)
    costs = run_env_multiple(PendulumEnv(seed=0), "Pendulum-v0", cfg, None, num_runs=2, random_actions_init=4,
                             num_steps=6, verbose=False, device="cpu")
    assert costs.shape == (2, 6) and np.all(np.isfinite(costs))
    # run i is seeded i: its warmup actions differ, so its costs do
    assert not np.array_equal(costs[0, 1:], costs[1, 1:])
    plot = tmp_path / "multiple_runs_costs_Pendulum-v0.png"
    assert plot.is_file() and plot.stat().st_size > 1000
    assert _train_threads() <= before


def test_run_env_multiple_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed, as on the card's machine,
    run_env_multiple returns the runs' costs with a warning and writes no
    plot, instead of failing after the runs."""
    import sys

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises ImportError
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3, training_frequency=100)
    with pytest.warns(UserWarning, match="matplotlib is not installed"):
        costs = run_env_multiple(PendulumEnv(seed=0), "Pendulum-v0", cfg, None, num_runs=2, random_actions_init=4,
                                 num_steps=4, verbose=False, device="cpu")
    assert costs.shape == (2, 4) and np.all(np.isfinite(costs))
    assert not list(tmp_path.iterdir())


def test_run_env_defaults_to_cuda():
    """Without ``device`` the episode runs on cuda; where torch finds no
    CUDA device run_env and run_env_multiple raise instead of carrying on
    on the CPU."""
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3)
    if torch.cuda.is_available():
        costs = run_env(PendulumEnv(seed=0), cfg, None, random_actions_init=2, num_steps=2, verbose=False)
        assert len(costs) == 2
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            run_env(PendulumEnv(seed=0), cfg, None, num_steps=2, verbose=False)
        with pytest.raises(RuntimeError, match="no CUDA"):
            run_env_multiple(PendulumEnv(seed=0), "Pendulum-v0", cfg, None, num_runs=1, num_steps=2, verbose=False)

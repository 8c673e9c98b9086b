"""Online-learning episode runner.

Port of ``gpmpc_tpu/runner/run_env.py`` (the reference ``run_env`` /
``run_env_multiple``, run_env_function.py:14-49, 52-72): random warmup
actions, then MPC actions; per-step cost bookkeeping via
``compute_cost_unnormalized``; transitions fed back through ``add_memory``
with the one-step-ahead prediction for the storage filter; multi-run
mean±std cost aggregation.

Works with the built-in gym-free envs (4-tuple step) and with
gym/gymnasium envs (5-tuple step, tuple reset).

``device`` is passed to ``GpMpcController``: None is ``cuda``, and without a
CUDA device the controller raises; pass ``device="cpu"`` to run on the CPU.
Each episode ends with ``ctrl.close()``, which waits for a training still
running and stops the controller's training thread.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from ..config.configs import Config, VisuConfig
from ..controllers.controller import GpMpcController


def _env_reset(env):
    out = env.reset()
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
        return np.asarray(out[0])
    return np.asarray(out)


def _env_step(env, action):
    out = env.step(action)
    if len(out) == 5:  # gymnasium: obs, reward, terminated, truncated, info
        obs, reward, terminated, truncated, info = out
        return np.asarray(obs), float(reward), bool(terminated or truncated), info
    obs, reward, done, info = out
    return np.asarray(obs), float(reward), bool(done), info


def run_env(
    env,
    control_config: Config,
    visu_config: Optional[VisuConfig] = None,
    random_actions_init: int = 10,
    num_steps: int = 150,
    verbose: bool = True,
    seed: int = 0,
    device=None,
):
    """Run one online GP-MPC episode; returns the per-step cost list."""
    from ..viz.visu import ControlVisualizations

    visu_obj = None
    if visu_config is not None:
        visu_obj = ControlVisualizations(env=env, num_steps=num_steps, control_config=control_config,
                                         visu_config=visu_config)

    ctrl_obj = GpMpcController(
        observation_low=env.observation_space.low,
        observation_high=env.observation_space.high,
        action_low=env.action_space.low,
        action_high=env.action_space.high,
        config=control_config,
        seed=seed,
        device=device,
    )
    try:
        obs = _env_reset(env)
        costs = []

        for idx_ctrl in range(num_steps):
            action_is_random = idx_ctrl < random_actions_init
            action = ctrl_obj.get_action(obs_mu=obs, random=action_is_random)
            iter_info = ctrl_obj.get_iter_info()

            cost, _cost_var = ctrl_obj.compute_cost_unnormalized(obs, action)
            costs.append(cost)
            if visu_obj is not None:
                visu_obj.update(obs=obs, reward=-cost, action=action, env=env, iter_info=iter_info)

            obs_new, _reward, _done, _info = _env_step(env, action)

            ctrl_obj.add_memory(
                obs=obs,
                action=action,
                obs_new=obs_new,
                reward=-cost,
                predicted_state=iter_info.predicted_states[1] if iter_info is not None else None,
                predicted_state_std=iter_info.predicted_states_std[1] if iter_info is not None else None,
            )
            obs = obs_new
            if verbose and iter_info is not None:
                print(str(iter_info))

        if visu_obj is not None:
            visu_obj.save(ctrl_obj)
        ctrl_obj.check_and_close_processes()
    finally:
        ctrl_obj.close()
        if visu_obj is not None:
            visu_obj.close()
    if hasattr(env, "close"):
        env.close()
    return costs


def run_env_multiple(
    env,
    env_name: str,
    control_config: Config,
    visu_config: Optional[VisuConfig] = None,
    num_runs: int = 10,
    random_actions_init: int = 10,
    num_steps: int = 150,
    verbose: bool = True,
    save_plot: bool = True,
    device=None,
):
    """Repeat run_env with seeds 0..num_runs-1; plot the mean±std cost curve
    to ``multiple_runs_costs_<env_name>.png`` in the working directory
    (reference run_env_function.py:52-72). Returns the costs (num_runs,
    num_steps). Where matplotlib is not installed (the card's machine has
    none), it warns and writes no plot instead of failing after the runs."""
    costs_runs = []
    for run_idx in range(num_runs):
        costs = run_env(
            env,
            control_config,
            visu_config,
            random_actions_init=random_actions_init,
            num_steps=num_steps,
            verbose=verbose,
            seed=run_idx,
            device=device,
        )
        costs_runs.append(costs)

    costs_runs = np.array(costs_runs)
    costs_mean = costs_runs.mean(axis=0)
    costs_std = costs_runs.std(axis=0)

    if save_plot:
        try:
            import matplotlib
        except ImportError:
            warnings.warn("run_env_multiple: matplotlib is not installed, so no plot of the costs is written")
            return costs_runs
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.arange(len(costs_mean))
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.plot(x, costs_mean)
        ax.fill_between(x, costs_mean - costs_std, costs_mean + costs_std, alpha=0.4)
        ax.set_title(f"Costs of multiple {env_name} runs")
        ax.set_ylabel("Cost")
        ax.set_xlabel("Env iteration")
        fig.savefig(f"multiple_runs_costs_{env_name}.png")
        plt.close(fig)

    return costs_runs

"""Reproduce the baseline workloads headless on the port and report cost curves.

Port of ``scripts/reproduce_baselines.py``: the same six workloads, with the
same step counts, warmups, ``--smoke`` lengths, env arguments and
configuration edits, run through the port's ``run_env``:

  1. pendulum                       Nh=15, repeat 1
  2. mountain_car                   Nh=12, repeat 5, two restarts
  3. process_control                Nh=5, repeat 5, static plant
  4. mountain_car_constrained       state constraints (CDF penalties), with
                                    the violations counted per run
  5. process_control_action_change  the derivative action mapper
                                    (limit_action_change)
  6. process_control_time_varying   include_time_model=True, the plant's
                                    parameters redrawn every 500 steps

Usage (from the repository root):

  python -m gpmpc_tpu_torch.reproduce_baselines                       # all, full length, on the card
  python -m gpmpc_tpu_torch.reproduce_baselines --smoke --device cpu  # short sanity pass on the CPU
  python -m gpmpc_tpu_torch.reproduce_baselines --only pendulum --runs 3 --dtype float32

``--device`` defaults to ``cuda`` and raises where torch finds no CUDA
device. ``--dtype`` is ``float64`` (the JAX package's precision, the
default) or ``float32``: mixed mode, an f64 factorization master with a
double-float32 rollout through the CUDA kernels. The configurations are the
examples' (``example_configs``).

Prints one JSON line per workload with the per-step mean cost curve's
summary (the JAX script's keys, plus ``device`` and ``dtype``), and writes
the full curves to ``baselines_out_torch/<name>.json``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .envs import MountainCarContinuousEnv, PendulumEnv, ProcessControl
from .example_configs import mountain_car_config, pendulum_config, process_control_config
from .runner.run_env import run_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "baselines_out_torch")


def _run_many(make_env, config, args, random_actions_init, num_steps):
    curves = []
    for seed in range(args.runs):
        env = make_env(seed)
        costs = run_env(
            env, config, visu_config=None,
            random_actions_init=random_actions_init, num_steps=num_steps,
            verbose=False, seed=seed, device=args.device,
        )
        curves.append(costs)
    return np.asarray(curves)


def workload_pendulum(args):
    steps = 30 if args.smoke else 150
    return _run_many(lambda s: PendulumEnv(seed=s), pendulum_config(len_horizon=15, dtype=args.dtype),
                     args, random_actions_init=10, num_steps=steps)


def workload_mountain_car(args):
    steps = 40 if args.smoke else 500
    return _run_many(lambda s: MountainCarContinuousEnv(seed=s),
                     mountain_car_config(num_repeat_actions=5, dtype=args.dtype),
                     args, random_actions_init=20, num_steps=steps)


def _pc_env(seed, change_params=False, period_change=500):
    return ProcessControl(
        dt=1, s_range=(20, 30), fi_range=(0.15, 0.3), ci_range=(0.15, 0.2),
        cr_range=(0.8, 1.0), noise_l_prop_range=(5e-3, 1e-2), noise_co_prop_range=(5e-3, 1e-2),
        sp_l_range=(0.4, 0.6), sp_co_range=(0.4, 0.6),
        change_params=change_params, period_change=period_change, seed=seed,
    )


def workload_process_control(args):
    steps = 60 if args.smoke else 500
    warm = 20 if args.smoke else 100
    cfg = process_control_config(len_horizon=5, include_time_model=False, num_repeat_actions=5, dtype=args.dtype)
    return _run_many(lambda s: _pc_env(s), cfg, args, random_actions_init=warm, num_steps=steps)


class _ObsRecorder:
    """Env proxy that records every observation the controller sees, so that
    constraint violations can be counted."""

    def __init__(self, env):
        self._env = env
        self.observations = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, *a, **k):
        out = self._env.reset(*a, **k)
        obs = out[0] if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict) else out
        self.observations.append(list(map(float, obs)))
        return out

    def step(self, action):
        out = self._env.step(action)
        self.observations.append(list(map(float, out[0])))
        return out


def workload_mountain_car_constrained(args):
    """The states-constraints demo: mountain car with CDF penalties keeping
    the car on the cliff (position capped below the top), speed limited, and
    a left wall. Reported as per-run violation counts of the normalized state
    against [state_min, state_max], the warmup steps excluded (random actions
    are not the controller's doing)."""
    steps = 40 if args.smoke else 500
    warm = 20
    cfg = mountain_car_config(num_repeat_actions=5, dtype=args.dtype)
    cfg.reward.use_constraints = True
    state_min = [0.12, 0.25]  # [position, velocity] normalized
    state_max = [0.90, 0.75]
    cfg.reward.state_min = state_min
    cfg.reward.state_max = state_max
    cfg.reward.area_multiplier = 1.0

    curves, violations = [], []
    for seed in range(args.runs):
        env = _ObsRecorder(MountainCarContinuousEnv(seed=seed))
        costs = run_env(env, cfg, visu_config=None, random_actions_init=warm, num_steps=steps, verbose=False,
                        seed=seed, device=args.device)
        curves.append(costs)
        obs = np.asarray(env.observations)
        lo, hi = np.asarray(env.observation_space.low), np.asarray(env.observation_space.high)
        norm = (obs - lo) / (hi - lo)
        # obs[k] is the state before action k: the controller's states start
        # after the warmup actions have been applied
        post = norm[warm + 1:]
        bad = np.any((post < np.asarray(state_min)) | (post > np.asarray(state_max)), axis=1)
        violations.append(int(bad.sum()))
    extra = {
        "constraint_violations_per_run": violations,
        "constraint_violation_rate": round(float(np.mean(violations)) / max(1, steps - warm), 4),
        "violation_steps_counted": int(steps - warm),
    }
    return np.asarray(curves), extra


def workload_process_control_action_change(args):
    """The action-change limitation demo: process control with the
    derivative action parametrization, no state constraints."""
    steps = 60 if args.smoke else 500
    warm = 20 if args.smoke else 100
    cfg = process_control_config(len_horizon=5, include_time_model=False, num_repeat_actions=5, dtype=args.dtype)
    cfg.actions.limit_action_change = True
    cfg.actions.max_change_action_norm = [0.1, 0.2]
    return _run_many(lambda s: _pc_env(s), cfg, args, random_actions_init=warm, num_steps=steps)


def workload_process_control_time_varying(args):
    steps = 80 if args.smoke else 1500
    warm = 20 if args.smoke else 100
    cfg = process_control_config(len_horizon=5, include_time_model=True, num_repeat_actions=10, dtype=args.dtype)
    return _run_many(lambda s: _pc_env(s, change_params=True, period_change=500), cfg,
                     args, random_actions_init=warm, num_steps=steps)


WORKLOADS = {
    "pendulum": workload_pendulum,
    "mountain_car": workload_mountain_car,
    "process_control": workload_process_control,
    "mountain_car_constrained": workload_mountain_car_constrained,
    "process_control_action_change": workload_process_control_action_change,
    "process_control_time_varying": workload_process_control_time_varying,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true", help="short sanity runs")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--only", nargs="*", default=None, choices=sorted(WORKLOADS))
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"],
                   help="float64 (the JAX package's precision) or float32 (mixed mode: an f64 master "
                        "factorization with a double-float32 rollout)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("reproduce_baselines runs on cuda unless given --device, and torch finds no CUDA "
                           "device; pass --device cpu to run on the CPU")
    os.makedirs(args.out, exist_ok=True)
    for name in args.only or list(WORKLOADS):
        out = WORKLOADS[name](args)
        curves, extra = out if isinstance(out, tuple) else (out, {})
        mean = curves.mean(axis=0)
        tail = mean[-max(1, len(mean) // 5):]
        summary = {
            "workload": name,
            "runs": int(curves.shape[0]),
            "steps": int(curves.shape[1]),
            "mean_cost_last_fifth": round(float(tail.mean()), 5),
            "mean_cost_first_fifth": round(float(mean[: max(1, len(mean) // 5)].mean()), 5),
            **extra,
            "device": args.device,
            "dtype": args.dtype,
        }
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump({**summary, "mean_curve": mean.tolist()}, f)
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

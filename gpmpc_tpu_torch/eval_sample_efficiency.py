"""Multi-seed sample-efficiency sweep of on-device episodes.

Port of ``scripts/eval_sample_efficiency.py``. The reference's headline
claims are cost-vs-interaction curves averaged over 10-20 serial host runs
(reference run_env_function.py:52-72; README.md:99-133 "Pendulum solved in
< 100 interactions"). Here every seed's whole episode (warmup, planning,
memory, training and the env) runs on the device through
``runner.episode``, the seeds in lockstep (one batched program, as JAX's
vmap over keys).

Usage (from the repository root):

  python -m gpmpc_tpu_torch.eval_sample_efficiency                      # pendulum, 10 seeds
  python -m gpmpc_tpu_torch.eval_sample_efficiency --env mountain_car --seeds 5 --dtype mixed
  python -m gpmpc_tpu_torch.eval_sample_efficiency --steps 12 --seeds 2 --device cpu

``--dtype``: float64 (parity), float32 (everything in f32) or mixed (an f64
master factorization and f64 training with a double-float32 rollout, the
env in f64). ``--device`` defaults to ``cuda``; without a CUDA device the
sweep raises unless given ``--device cpu``. ``--no-pallas`` runs both
sweeps under ``ops.disable_pallas()``: the Gram, the cov cores and the
whole-step path take their plain PyTorch forms (the JAX script's flag, whose
"pallas" means the hand-written CUDA kernels here).

Prints one JSON line: the mean cost curve's summary, the
interactions-to-solve metric (the first step after which the mean cost over
a 20-step window stays below the threshold), the wall seconds of a first
sweep (which builds the kernels on first use) and of a second one
(``sweep_wall_s``), and the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import ops
from .envs import torch_dynamics
from .example_configs import mountain_car_config, pendulum_config, process_control_config
from .runner.episode import build_episodes_batch_fn, episode_spec_from_config
from .utils.profiling import block_until_ready

# per env: (config, steps, warmup, solve threshold), as in the JAX script
SWEEPS = {
    "pendulum": (lambda: pendulum_config(len_horizon=15), 150, 10, 0.05),
    "mountain_car": (lambda: mountain_car_config(num_repeat_actions=5), 500, 20, 0.12),
    # the host-path baseline row's settings (RESULTS.md,
    # scripts/reproduce_baselines.py workload_process_control)
    "process_control": (lambda: process_control_config(len_horizon=5, include_time_model=False,
                                                       num_repeat_actions=5), 500, 100, 0.05),
}


def sweep_setup(env: str = "pendulum", dtype: str = "float32", device=None, steps=None, threshold=None,
                edit_config=None) -> SimpleNamespace:
    """The sweep's env spec, configuration, episode spec and initial GP
    parameters. ``edit_config(config)`` may change the configuration before
    the episode spec is made from it."""
    make_config, default_steps, warmup, default_threshold = SWEEPS[env]
    cfg = make_config()
    mixed = dtype == "mixed"
    env_dtype = torch.float32 if dtype == "float32" else torch.float64
    env_spec = getattr(torch_dynamics, f"{env}_spec")(dtype=env_dtype, device=device)
    cfg.dtype = "float32" if mixed else dtype
    if edit_config is not None:
        edit_config(cfg)
    steps = steps or default_steps
    spec, params0 = episode_spec_from_config(env_spec, cfg, num_steps=steps, warmup=warmup, mixed_df32=mixed)
    return SimpleNamespace(env=env_spec, config=cfg, spec=spec, params0=params0, steps=steps, warmup=warmup,
                           threshold=default_threshold if threshold is None else threshold, mixed=mixed)


def interactions_to_solve(mean_cost: np.ndarray, threshold: float, window: int = 20):
    """The first t where the mean cost over [t, t + window) is below the
    threshold, else None."""
    for t in range(0, len(mean_cost) - window):
        if mean_cost[t:t + window].mean() < threshold:
            return t
    return None


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", default="pendulum", choices=list(SWEEPS))
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--dtype", default="float32", choices=["float32", "float64", "mixed"],
                   help="float64 (parity) solves reliably; float32 degrades once training sharpens the GP; "
                        "mixed = f64 master factorization and training + df32 rollout")
    p.add_argument("--no-pallas", action="store_true",
                   help="run with the CUDA kernels' dispatch disabled (ops.disable_pallas: the plain forms)")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="run the episodes in segments of this many steps, every seed's in turn (the carry stays "
                        "on the device)")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)

    setup = sweep_setup(args.env, args.dtype, device=args.device, steps=args.steps, threshold=args.threshold)
    steps = setup.steps
    batch_fn = build_episodes_batch_fn(setup.spec, steps_per_call=args.steps_per_call)
    seeds = list(range(args.seeds))

    with ops.disable_pallas() if args.no_pallas else contextlib.nullcontext():
        t0 = time.perf_counter()
        out = batch_fn(seeds, setup.params0)
        block_until_ready(out)
        compile_and_run_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = batch_fn(seeds, setup.params0)
        block_until_ready(out)
        steady_run_s = time.perf_counter() - t0

    costs = out["cost"].double().cpu().numpy()  # (seeds, steps)
    mean = costs.mean(axis=0)
    print(json.dumps({
        "env": args.env,
        "seeds": args.seeds,
        "steps": steps,
        "mean_cost_last20": round(float(mean[-20:].mean()), 5),
        "interactions_to_solve": interactions_to_solve(mean, setup.threshold),
        "solve_threshold": setup.threshold,
        "sweep_wall_s": round(steady_run_s, 2),
        "compile_plus_run_s": round(compile_and_run_s, 2),
        # complete online-learning throughput: every env step of the
        # aggregate includes planning, memory filtering, factorization and
        # its share of the periodic MLL training
        "aggregate_env_steps_per_sec": round(args.seeds * steps / steady_run_s, 2),
        "episodes_per_sec": round(args.seeds / steady_run_s, 3),
        "dtype": args.dtype,
        "device": str(setup.spec.device),
    }), flush=True)


if __name__ == "__main__":
    main()

"""The port's sample-efficiency sweep (``python -m
gpmpc_tpu_torch.eval_sample_efficiency``) on the CPU: its JSON line has the
JAX script's keys plus ``device``, and without ``--device`` it runs on cuda,
which raises where torch finds none."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpmpc_tpu_torch import eval_sample_efficiency as sweep

ROOT = Path(__file__).resolve().parents[1]


def _jax_keys():
    """The keys of the JSON object scripts/eval_sample_efficiency.py prints,
    read from its source (running it compiles the JAX episode)."""
    tree = ast.parse((ROOT / "scripts/eval_sample_efficiency.py").read_text())
    printed = next(n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "dumps")
    return [k.value for k in printed.args[0].keys]


def test_sweep_prints_jax_keys_plus_device():
    """Two seeds of a mixed mountain-car sweep, 6 steps (random evaluations
    at 0 and 5): the keys, the device, and finite numbers."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "gpmpc_tpu_torch.eval_sample_efficiency", "--env", "mountain_car",
                          "--dtype", "mixed", "--seeds", "2", "--steps", "6", "--steps-per-call", "4",
                          "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == _jax_keys() + ["device"]
    assert line["device"] == "cpu" and line["dtype"] == "mixed" and line["seeds"] == 2 and line["steps"] == 6
    assert line["solve_threshold"] == 0.12 and line["interactions_to_solve"] is None  # 6 steps < one window
    assert line["aggregate_env_steps_per_sec"] > 0 and line["sweep_wall_s"] >= 0


@pytest.mark.parametrize("env", list(sweep.SWEEPS))
def test_sweep_setup(env):
    """Each env's set-up: the JAX script's steps, warmup and threshold,
    mixed mode's f64 env and f32 episode."""
    setup = sweep.sweep_setup(env, "mixed", device="cpu", edit_config=lambda cfg: setattr(cfg.training,
                                                                                         "training_frequency", 7))
    assert (setup.steps, setup.warmup, setup.threshold) == {"pendulum": (150, 10, 0.05),
                                                           "mountain_car": (500, 20, 0.12),
                                                           "process_control": (500, 100, 0.05)}[env]
    assert setup.env.dtype == torch.float64 and setup.spec.dtype == torch.float32 and setup.spec.mixed_df32
    assert setup.spec.training_frequency == 7 and setup.spec.num_steps == setup.steps


def test_sweep_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA"):
        sweep.main(["--steps", "2", "--seeds", "1"])


def test_no_pallas_flag_runs_the_sweep_under_disable_pallas(monkeypatch, capsys):
    """``--no-pallas`` parses, runs a 2-step sweep with the dispatch switch
    on (both sweeps), and leaves it off afterwards."""
    from gpmpc_tpu_torch import ops

    seen = []
    real = sweep.build_episodes_batch_fn

    def build(spec, steps_per_call=None):
        fn = real(spec, steps_per_call=steps_per_call)

        def run(*args):
            seen.append(ops._PALLAS_DISABLED)
            return fn(*args)

        return run

    monkeypatch.setattr(sweep, "build_episodes_batch_fn", build)
    sweep.main(["--env", "mountain_car", "--dtype", "mixed", "--seeds", "1", "--steps", "2", "--device", "cpu",
                "--no-pallas"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 2 and line["device"] == "cpu"
    assert seen == [True, True] and ops._PALLAS_DISABLED is False

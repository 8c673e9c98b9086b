"""``python -m gpmpc_tpu_torch.reproduce_baselines`` against
scripts/reproduce_baselines.py.

* Each of the six workloads hands ``run_env`` the JAX script's env (its
  class and every argument), configuration (field by field, section by
  section), warmup, step count and seeds, at the full lengths and under
  ``--smoke``, for two runs. Neither side plans here: ``run_env`` is replaced
  on both sides by a recorder that steps the env with a constant action and
  returns constant costs, so no JAX program is compiled; the workloads'
  curves and the constrained workload's violation counts, made from those
  steps, must come out equal too.
* One ``--smoke`` workload through the port's ``main`` on the CPU, cut to
  12 steps (10 random, one planned step with the time model) by a wrapper
  around the real ``run_env``: its JSON line and its curve file in
  ``tmp_path``.
* Without a CUDA device the default ``--device cuda`` raises.
"""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gpmpc_tpu
from gpmpc_tpu_torch import reproduce_baselines as port

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ("observation", "reward", "actions", "model", "memory", "training", "controller")


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_reproduce_baselines", ROOT / "scripts/reproduce_baselines.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    spec.loader.exec_module(module)  # puts examples/* on sys.path for the JAX example configs
    yield module
    sys.path[:] = path


def _recorder(calls):
    """A stand-in for run_env: records its arguments, steps the env with the
    middle of its action box and returns the step index as each cost."""

    def run_env(env, config, visu_config=None, random_actions_init=10, num_steps=150, verbose=True, seed=0,
                device=None):
        calls.append(dict(env=env, config=config, visu_config=visu_config, random_actions_init=random_actions_init,
                          num_steps=num_steps, verbose=verbose, seed=seed))
        env.reset()
        action = (np.asarray(env.action_space.low) + np.asarray(env.action_space.high)) / 2
        for _ in range(num_steps):
            env.step(action)
        return [float(i + seed) for i in range(num_steps)]

    return run_env


def _env_fields(env):
    env = getattr(env, "_env", env)  # the constrained workload's observation recorder
    out = {"class": type(env).__name__}
    for k, v in vars(env).items():
        if k == "rng":
            continue
        if hasattr(v, "low"):  # a Box
            out[k] = (np.asarray(v.low).tolist(), np.asarray(v.high).tolist())
        else:
            out[k] = np.asarray(v).tolist()
    return out


def _same_config(out, ref, where):
    for name in SECTIONS:
        a, b = vars(getattr(out, name)), vars(getattr(ref, name))
        assert a.keys() == b.keys(), (where, name)
        for k in a:
            if isinstance(b[k], dict):
                assert a[k].keys() == b[k].keys(), (where, name, k)
                assert all(np.array_equal(a[k][j], b[k][j]) for j in b[k]), (where, name, k)
            else:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (where, name, k)
    assert out.dtype == ref.dtype == "float64", where


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_workloads_carry_the_jax_scripts_envs_configs_and_lengths(jax_script, monkeypatch, smoke):
    assert list(port.WORKLOADS) == list(jax_script.WORKLOADS)
    jcalls, tcalls = [], []
    monkeypatch.setattr(gpmpc_tpu, "run_env", _recorder(jcalls))
    monkeypatch.setattr(port, "run_env", _recorder(tcalls))
    args = port.parse_args(["--runs", "2", "--device", "cpu"] + (["--smoke"] if smoke else []))
    assert (args.dtype, args.out) == ("float64", str(ROOT / "baselines_out_torch"))
    for name in jax_script.WORKLOADS:
        start = len(jcalls), len(tcalls)
        ref = jax_script.WORKLOADS[name](SimpleNamespace(smoke=smoke, runs=2))
        out = port.WORKLOADS[name](args)
        ref, ref_extra = ref if isinstance(ref, tuple) else (ref, {})
        out, out_extra = out if isinstance(out, tuple) else (out, {})
        np.testing.assert_array_equal(out, ref)
        assert out_extra == ref_extra, name
        pairs = list(zip(jcalls[start[0]:], tcalls[start[1]:]))
        assert len(pairs) == 2 == len(jcalls) - start[0] == len(tcalls) - start[1], name
        for j, t in pairs:
            assert _env_fields(t["env"]) == _env_fields(j["env"]), name
            _same_config(t["config"], j["config"], name)
            for k in ("visu_config", "random_actions_init", "num_steps", "verbose", "seed"):
                assert t[k] == j[k], (name, k)
    if smoke:
        assert [c["num_steps"] for c in tcalls[::2]] == [30, 40, 60, 40, 60, 80]


def test_float32_runs_the_same_workloads_in_mixed_mode(monkeypatch):
    calls = []
    monkeypatch.setattr(port, "run_env", _recorder(calls))
    port.workload_process_control_time_varying(port.parse_args(["--dtype", "float32", "--device", "cpu"]))
    cfg = calls[0]["config"]
    assert cfg.dtype == "float32" and cfg.model.include_time_model and cfg.controller.num_repeat_actions == 10
    assert calls[0]["env"].change_params and calls[0]["env"].period_change == 500


def test_smoke_workload_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    real = port.run_env

    def cut(env, config, visu_config=None, random_actions_init=10, num_steps=150, **kw):
        assert (random_actions_init, num_steps) == (20, 80)  # the time-varying workload's --smoke lengths
        return real(env, config, visu_config, random_actions_init=10, num_steps=12, **kw)

    monkeypatch.setattr(port, "run_env", cut)
    port.main(["--smoke", "--device", "cpu", "--only", "process_control_time_varying", "--out", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workload"] == "process_control_time_varying" and (line["runs"], line["steps"]) == (1, 12)
    assert (line["device"], line["dtype"]) == ("cpu", "float64")
    saved = json.loads((tmp_path / "process_control_time_varying.json").read_text())
    assert len(saved["mean_curve"]) == 12 and np.all(np.isfinite(saved["mean_curve"]))
    assert saved["mean_cost_last_fifth"] == line["mean_cost_last_fifth"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device exists here")
def test_default_device_raises_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA"):
        port.main(["--only", "pendulum", "--out", str(tmp_path)])

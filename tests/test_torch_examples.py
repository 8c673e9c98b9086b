"""gpmpc_tpu_torch.example_configs against the shipped examples' get_config
(examples/<env>/config_<env>.py), field by field, at their defaults and at
the arguments the example runners pass; ``dtype`` changes the dtype only."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from gpmpc_tpu_torch import example_configs

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ("observation", "reward", "actions", "model", "memory", "training", "controller")
EXAMPLES = {
    "pendulum": ("examples/pendulum/config_pendulum.py", example_configs.pendulum_config),
    "mountain_car": ("examples/mountain_car/config_mountaincar.py", example_configs.mountain_car_config),
    "process_control": ("examples/process_control/config_process_control.py",
                        example_configs.process_control_config),
}
# (example, get_config keyword arguments): the defaults, then what each runner
# passes (run_<env>.py and run_<env>_multiple.py)
CASES = [
    ("pendulum", {}),
    ("pendulum", dict(len_horizon=15, num_repeat_actions=1)),
    ("pendulum", dict(len_horizon=12, num_repeat_actions=1)),
    ("mountain_car", {}),
    ("mountain_car", dict(len_horizon=12, num_repeat_actions=5)),
    ("process_control", {}),
    ("process_control", dict(len_horizon=5, include_time_model=False, num_repeat_actions=5)),
    ("process_control", dict(len_horizon=5, include_time_model=True, num_repeat_actions=10)),
]


def _example(path):
    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_section(out, ref, name):
    a, b = vars(getattr(out, name)), vars(getattr(ref, name))
    assert a.keys() == b.keys(), name
    for k in a:
        if isinstance(b[k], dict):
            assert a[k].keys() == b[k].keys(), (name, k)
            assert all(np.array_equal(a[k][j], b[k][j]) for j in b[k]), (name, k)
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (name, k)


@pytest.mark.parametrize("example,kwargs", CASES, ids=[f"{e}-{'-'.join(map(str, k.values())) or 'defaults'}"
                                                        for e, k in CASES])
def test_example_config_is_the_jax_example(example, kwargs):
    path, port_config = EXAMPLES[example]
    ref = _example(path).get_config(**kwargs)
    out = port_config(**kwargs)
    for name in SECTIONS:
        _same_section(out, ref, name)
    assert out.dtype == ref.dtype == "float64"
    mixed = port_config(**kwargs, dtype="float32")
    for name in SECTIONS:
        _same_section(mixed, ref, name)
    assert mixed.dtype == "float32"


def test_flagship_reexports_pendulum_config():
    from gpmpc_tpu_torch import flagship

    assert flagship.pendulum_config is example_configs.pendulum_config


def _call_kwargs(path, func):
    """The literal keyword arguments of every call of ``func`` in a file."""
    import ast

    calls = [n for n in ast.walk(ast.parse((ROOT / path).read_text())) if isinstance(n, ast.Call)
             and getattr(n.func, "id", getattr(n.func, "attr", None)) == func]
    return [{k.arg: ast.literal_eval(k.value) for k in c.keywords
             if isinstance(k.value, (ast.Constant, ast.Tuple, ast.UnaryOp))} for c in calls]


def test_process_control_multiple_runner_is_the_jax_examples(tmp_path, monkeypatch):
    """examples/process_control/run_process_control_multiple_torch.py builds
    the JAX runner's env (every argument), configuration and
    run_env_multiple call (read from its source), and runs on the CPU at a
    cut: two runs of 12 steps (10 random, one planned step with the time
    model), its plot in the working directory."""
    path = "examples/process_control/run_process_control_multiple_torch.py"
    jax_path = "examples/process_control/run_process_control_multiple.py"
    runner = _example(path)
    (env_kw,) = _call_kwargs(jax_path, "ProcessControl")
    from gpmpc_tpu_torch.envs import ProcessControl

    env, ref_env = vars(runner.make_env()), vars(ProcessControl(**env_kw))
    assert env.keys() == ref_env.keys()
    for k in env:
        same = (env[k].bit_generator.state == ref_env[k].bit_generator.state if k == "rng"
                else np.array_equal(env[k].low, ref_env[k].low) and np.array_equal(env[k].high, ref_env[k].high)
                if hasattr(env[k], "low")
                else np.array_equal(np.asarray(env[k]), np.asarray(ref_env[k])))
        assert same, k
    (cfg_kw,) = _call_kwargs(jax_path, "get_config")
    ref = _example("examples/process_control/config_process_control.py").get_config(**cfg_kw)
    for name in SECTIONS:
        _same_section(runner.make_config(), ref, name)
    (run_kw,) = _call_kwargs(jax_path, "run_env_multiple")
    (port_kw,) = _call_kwargs(path, "run_env_multiple")
    assert {k: v for k, v in port_kw.items() if k != "num_runs"} == {k: v for k, v in run_kw.items()
                                                                     if k not in ("num_runs", "num_steps")}
    import inspect

    defaults = inspect.signature(runner.run_process_control_multiple).parameters
    assert (defaults["num_runs"].default, defaults["num_steps"].default) == (run_kw["num_runs"], run_kw["num_steps"])
    assert runner.ENV_NAME == "process_control"

    monkeypatch.chdir(tmp_path)
    costs = runner.run_process_control_multiple(device="cpu", num_runs=2, num_steps=12)
    assert costs.shape == (2, 12) and np.all(np.isfinite(costs))
    assert (tmp_path / "multiple_runs_costs_process_control.png").stat().st_size > 1000

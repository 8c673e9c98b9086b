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

"""Process-control episodes through both packages' ``run_env``, on the CPU.

The process-control example's configuration (examples/process_control/
config_process_control.py, the port's ``example_configs.process_control_config``)
on the env arguments of scripts/reproduce_baselines.py's ``_pc_env``, in
f64 through the JAX package's and the port's ``run_env``, three ways:

* the time-varying plant with the time model (``change_params=True`` and a
  ``period_change`` that falls inside the episode, ``include_time_model=True``:
  D = ns + na + 1 with the raw iteration index as the last input, repeat 2);
* the action-change limit (the derivative action mapper at na = 2);
* the state constraints (CDF penalties on ``state_min`` / ``state_max``).

Each is cut to horizon 3 and 12 steps, 4 of them random, with the example's
two restarts and L-BFGS-B budget; training does not fire
(``training_frequency`` past the episode), as in
tests/test_torch_runner.py's pendulum episode: the two controllers train on
threads and could swap parameters in at different steps. The costs are held
to 1e-9 (the same f64 arithmetic in another order).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from gpmpc_tpu.envs import ProcessControl as JaxProcessControl
from gpmpc_tpu.runner.run_env import run_env as jax_run_env
from gpmpc_tpu_torch import run_env
from gpmpc_tpu_torch.envs import ProcessControl
from gpmpc_tpu_torch.example_configs import process_control_config

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9
STEPS, WARMUP, HORIZON = 12, 4, 3


def _jax_get_config():
    spec = importlib.util.spec_from_file_location(
        "config_process_control", ROOT / "examples/process_control/config_process_control.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.get_config


def _env(cls, change_params, period_change):
    """scripts/reproduce_baselines.py's ``_pc_env`` for seed 0."""
    return cls(dt=1, s_range=(20, 30), fi_range=(0.15, 0.3), ci_range=(0.15, 0.2), cr_range=(0.8, 1.0),
               noise_l_prop_range=(5e-3, 1e-2), noise_co_prop_range=(5e-3, 1e-2), sp_l_range=(0.4, 0.6),
               sp_co_range=(0.4, 0.6), change_params=change_params, period_change=period_change, seed=0)


# (id, config keyword arguments, change_params, period_change)
CASES = [
    ("time-varying", dict(include_time_model=True, num_repeat_actions=2), True, 5),
    ("action-change", dict(include_time_model=False, num_repeat_actions=2, limit_action_change=True), False, 500),
    ("constraints", dict(include_time_model=False, num_repeat_actions=2, use_constraints=True), False, 500),
]


@pytest.mark.parametrize("kwargs,change_params,period_change", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_process_control_episode_matches_jax(kwargs, change_params, period_change):
    configs = []
    for make in (_jax_get_config(), process_control_config):
        cfg = make(len_horizon=HORIZON, **kwargs)
        cfg.training.training_frequency = 10 * STEPS
        configs.append(cfg)
    kw = dict(random_actions_init=WARMUP, num_steps=STEPS, verbose=False, seed=0)
    jenv, tenv = _env(JaxProcessControl, change_params, period_change), _env(ProcessControl, change_params,
                                                                            period_change)
    jcosts = jax_run_env(jenv, configs[0], None, **kw)
    tcosts = run_env(tenv, configs[1], None, device="cpu", **kw)
    assert len(tcosts) == STEPS
    np.testing.assert_allclose(tcosts, jcosts, rtol=0, atol=TOL)
    if change_params:  # the plant's parameters changed inside the episode, on both sides alike
        assert tenv.iter == STEPS and STEPS > period_change
        np.testing.assert_array_equal([tenv.s, tenv.fi, tenv.cr], [jenv.s, jenv.fi, jenv.cr])

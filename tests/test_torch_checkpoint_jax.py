"""Checkpoints across the two packages: a JAX-written ``.npz`` restored into
the port's controller, and a port-written one into the JAX package's.

The controllers run the time-varying process-control example's
configuration (Ns = 2, Na = 2, the time model, horizon 2, repeat 2) on
``ProcessControl`` for 6 random steps, then save. Each side restores the
other's file into a fresh controller and saves it again: every key the two
packages share comes back equal (the GP parameters, the whole memory with
its time column, the counters, the warm start and the numpy generator's
state). The one key of each package's own is handled as
gpmpc_tpu_torch/utils/checkpoint.py documents: the port keeps its ``seed``
when a JAX file (which carries ``train_key``) is restored, and the JAX
controller keeps its ``train_key`` when a port file (which carries
``seed``) is. The restored controller's next random step then takes the
same action as the original's: the same generator state, the same previous
action.
"""

import importlib.util
from pathlib import Path

import numpy as np

from gpmpc_tpu.controllers.controller import GpMpcController as JaxController
from gpmpc_tpu.envs import ProcessControl as JaxProcessControl
from gpmpc_tpu_torch import GpMpcController
from gpmpc_tpu_torch.envs import ProcessControl
from gpmpc_tpu_torch.example_configs import process_control_config

ROOT = Path(__file__).resolve().parents[1]
STEPS = 6


def _jax_config():
    spec = importlib.util.spec_from_file_location(
        "config_process_control", ROOT / "examples/process_control/config_process_control.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.get_config(len_horizon=2, include_time_model=True, num_repeat_actions=2)


def _box(env):
    return env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high


def _run(ctrl, env):
    obs = env.reset()
    for _ in range(STEPS):
        action = ctrl.get_action(obs, random=True)
        obs_new, reward, _, _ = env.step(action)
        ctrl.add_memory(obs, action, obs_new, reward)
        obs = obs_new
    return obs


def _same_shared_keys(saved, again):
    shared = (set(saved) & set(again)) - {"seed", "train_key"}
    assert {"raw_lengthscales", "mem_model_inputs", "mem_counters", "rng_state", "actions_mpc_previous_iter",
            "past_action", "iter_ctrl"} <= shared
    for k in sorted(shared):
        np.testing.assert_array_equal(np.asarray(again[k]), np.asarray(saved[k]), err_msg=k)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    env = JaxProcessControl(change_params=False, seed=0)
    jctrl = JaxController(*_box(env), _jax_config(), seed=3)
    obs = _run(jctrl, env)
    path = jctrl.save_checkpoint(str(tmp_path / "jax.npz"))
    saved = dict(np.load(path))
    assert "train_key" in saved and "seed" not in saved
    assert np.array_equal(saved["mem_inputs"][:, -1], np.arange(STEPS))  # the time column

    ctrl = GpMpcController(*_box(ProcessControl(change_params=False, seed=0)),
                           process_control_config(len_horizon=2, include_time_model=True, num_repeat_actions=2),
                           seed=9, device="cpu")
    try:
        ctrl.restore_checkpoint(path)
        assert ctrl.seed == 9  # a JAX file carries no seed: the port keeps its own
        _same_shared_keys(saved, ctrl.save_state())
        np.testing.assert_array_equal(ctrl.get_action(obs, random=True), jctrl.get_action(obs, random=True))
    finally:
        ctrl.close()


def test_port_checkpoint_restores_into_jax(tmp_path):
    env = ProcessControl(change_params=False, seed=0)
    ctrl = GpMpcController(*_box(env), process_control_config(len_horizon=2, include_time_model=True,
                                                               num_repeat_actions=2), seed=3, device="cpu")
    try:
        obs = _run(ctrl, env)
        path = ctrl.save_checkpoint(str(tmp_path / "port.npz"))
    finally:
        ctrl.close()
    saved = dict(np.load(path))
    assert "seed" in saved and "train_key" not in saved

    jctrl = JaxController(*_box(JaxProcessControl(change_params=False, seed=0)), _jax_config(), seed=9)
    key = np.asarray(jctrl._train_key).copy()
    jctrl.restore_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jctrl._train_key), key)  # a port file carries no key: JAX keeps its own
    _same_shared_keys(saved, jctrl.save_state())
    np.testing.assert_array_equal(np.asarray(jctrl.get_action(obs, random=True)), ctrl.get_action(obs, random=True))

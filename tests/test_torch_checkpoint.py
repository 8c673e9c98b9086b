"""Checkpoint and resume of the port's controller (utils/checkpoint.py):
tests/test_checkpoint.py on the port (a restored controller reproduces the
original's actions, held to 1e-10 as there; they are the same arithmetic
on the same state, and come out equal), the snapshot's keys against the
JAX package's, and a restore that puts the tensors on the restoring
controller's device and dtype."""

import numpy as np
import torch

import gpmpc_tpu
import gpmpc_tpu_torch
from gpmpc_tpu.controllers.controller import GpMpcController as JaxController
from gpmpc_tpu_torch import GpMpcController
from gpmpc_tpu_torch.envs import PendulumEnv
from tests.test_torch_controller import small_pendulum_config


def _controller(env, cfg, **kw):
    box = (env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high)
    return GpMpcController(*box, cfg, seed=3, device="cpu", **kw)


def _run_steps(ctrl, env, obs, n, start_random=0):
    traj = []
    for i in range(n):
        a = ctrl.get_action(obs, random=i < start_random)
        info = ctrl.get_iter_info()
        obs_new, r, d, _ = env.step(a)
        ctrl.add_memory(obs, a, obs_new, r, info.predicted_states[1], info.predicted_states_std[1])
        obs = obs_new
        traj.append(a.copy())
    return obs, traj


def test_checkpoint_roundtrip_reproduces_actions(tmp_path):
    cfg = small_pendulum_config(gpmpc_tpu_torch, training_frequency=1000)  # parameters stay put
    env = PendulumEnv(seed=11)
    ctrl = _controller(env, cfg)
    obs, _ = _run_steps(ctrl, env, env.reset(), 8, start_random=4)

    path = str(tmp_path / "ckpt.npz")
    ctrl.save_checkpoint(path)
    env_state_snapshot = env.state.copy()

    # the original goes on
    env.state = env_state_snapshot.copy()
    _, traj_a = _run_steps(ctrl, env, obs.copy(), 3)

    # restored into a fresh controller, from the same point
    env2 = PendulumEnv(seed=11)
    env2.reset()
    env2.state = env_state_snapshot.copy()
    ctrl2 = _controller(env2, cfg)
    ctrl2.restore_checkpoint(path)
    np.testing.assert_array_equal(ctrl2.gp_params.raw_lengthscales.numpy(), ctrl.gp_params.raw_lengthscales.numpy())
    assert ctrl2.memory.len_mem == 8
    assert ctrl2.iter_ctrl == 8

    _, traj_b = _run_steps(ctrl2, env2, obs.copy(), 3)
    # the same rng stream and state: the same actions
    for a, b in zip(traj_a, traj_b):
        np.testing.assert_allclose(a, b, atol=1e-10)
    ctrl.close()
    ctrl2.close()


def test_snapshot_keys_match_jax():
    """The JAX package's keys, with ``seed`` for its ``train_key`` (the port
    derives each training's draws from the seed)."""
    env = PendulumEnv(seed=0)
    box = (env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high)
    jkeys = set(JaxController(*box, small_pendulum_config(gpmpc_tpu), seed=5).save_state())
    ctrl = _controller(env, small_pendulum_config(gpmpc_tpu_torch))
    state = ctrl.save_state()
    assert set(state) == (jkeys - {"train_key"}) | {"seed"}
    assert int(state["seed"]) == 3
    ctrl.close()


def test_restore_lands_on_the_controllers_device_and_dtype():
    """An f64 controller's state restored into a mixed-mode one (float32
    parameters): every GP parameter on the restoring controller's device in
    its dtype, equal to the saved values rounded to it, the planner's cache
    dropped, the seed carried over."""
    env = PendulumEnv(seed=2)
    src = _controller(env, small_pendulum_config(gpmpc_tpu_torch, training_frequency=4, iter_train=1))
    _run_steps(src, env, env.reset(), 5, start_random=4)
    src.wait_for_training()
    src.seed = 17
    state = src.save_state()

    dst = _controller(env, small_pendulum_config(gpmpc_tpu_torch).replace(dtype="float32"))
    dst.get_action(env.reset(), random=True)
    assert dst.planner._cache is not None
    dst.restore_state(state)
    assert dst.planner._cache is None and dst.seed == 17 and dst.iter_ctrl == 5
    for k in ("raw_lengthscales", "raw_outputscale", "raw_noise"):
        t = getattr(dst.gp_params, k)
        assert t.device == dst.device and t.dtype == torch.float32, k
        assert torch.equal(t, getattr(src.gp_params, k).float()), k
    np.testing.assert_array_equal(dst.memory.inputs[:5], src.memory.inputs[:5].astype(np.float32))
    a = dst.get_action(env.reset())
    assert np.all(np.isfinite(a))
    src.close()
    dst.close()

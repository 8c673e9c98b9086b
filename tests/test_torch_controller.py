"""The port's controller lifecycle against the JAX package's, on the CPU.

* The port's PendulumEnv reproduces the JAX package's trajectory exactly
  (the same numpy code).
* An f64 controller episode at horizon 3 in the 32 bucket: random warmup
  (``Planner.evaluate``), one training that fires at the same step on both
  sides and is integrated there (JAX's result is injected into the port, so
  that both plan with the same parameters), then planned steps. Both see
  the same observations and store the same (JAX) actions. Actions, cost
  evaluations and IterationInformation fields (each to its largest entry)
  are held to TOL = 1e-9 through the warmup, as tests/test_torch_planner.py
  holds the planner (the same f64 arithmetic in another order; measured
  gaps 1e-13 or less), and to TRAINED_TOL after the swap (see there). The
  memories must be equal: every array exactly, except the prediction errors
  and stds the storage filter records, which come from each side's own
  predictions and are held to TRAINED_TOL.
* The pendulum cases of tests/test_controller_integration.py on the port.
* One mixed-mode planned step on the CPU against the port's own f64 plan,
  by chip_smoke.py's MIXED_TOL plan criterion (through the smoke's own
  comparison).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmpc_tpu
import gpmpc_tpu_torch
from gpmpc_tpu.controllers.controller import GpMpcController as JaxController
from gpmpc_tpu.envs import PendulumEnv as JaxPendulum
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.controllers.controller import GpMpcController
from gpmpc_tpu_torch.envs import PendulumEnv
from gpmpc_tpu_torch.flagship import pendulum_config

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9
# After the swap the trained GP sits at its noise floor (1e-6, cond(K) ~ 1e6)
# and f64 rounding no longer stays near 1e-16 through a plan: the JAX
# controller against itself, extending its factorization or refactorizing
# it at each step (the same arithmetic exactly, in another order), differs
# by 1.2e-9 and then 5.7e-9 of the action scale in its second and third
# planned steps, and by 1.2e-8 and 1.8e-8 in predicted_states_std. The port
# against JAX measured 4.0e-9 and 1.2e-8 in the actions and at most 4.3e-8
# in any IterationInformation field (predicted_states_std); the tolerance
# leaves ~2x over that, while a wrong formula shows at 1e-3 or more.
TRAINED_TOL = 1e-7


def small_pendulum_config(pkg, len_horizon=5, limit_action_change=False, use_constraints=False, **training):
    """tests/test_controller_integration.py's small_pendulum_config, built
    with either package's config classes."""
    return pkg.Config(
        observation_config=pkg.ObservationConfig(obs_var_norm=[1e-6, 1e-6, 1e-6]),
        reward_config=pkg.RewardConfig(
            target_state_norm=[1, 0.5, 0.5], weight_state=[1, 0.1, 0.1], weight_state_terminal=[5, 2, 2],
            target_action_norm=[0.5], weight_action=[1e-3], exploration_factor=1, use_constraints=use_constraints,
            state_min=[-0.1, -0.1, -0.1], state_max=[1.1, 1.1, 1.1],
        ),
        actions_config=pkg.ActionsConfig(limit_action_change=limit_action_change, max_change_action_norm=[0.3]),
        model_config=pkg.ModelConfig(
            gp_init={"noise_covar.noise": [1e-5, 1e-5, 1e-5], "base_kernel.lengthscale": [0.5, 0.5, 0.5],
                     "outputscale": [5e-2, 5e-2, 5e-2]},
            min_std_noise=1e-3, max_std_noise=1e-2, min_outputscale=1e-2, max_outputscale=0.95,
            min_lengthscale=4e-3, max_lengthscale=10.0,
        ),
        memory_config=pkg.MemoryConfig(min_error_prediction_state_for_memory=[3e-4] * 3,
                                       min_prediction_state_std_for_memory=[3e-3] * 3, points_batch_memory=64),
        training_config=pkg.TrainingConfig(**{"iter_train": 3, "training_frequency": 12, "restarts_train": 1,
                                              **training}),
        controller_config=pkg.ControllerConfig(
            len_horizon=len_horizon, actions_optimizer_params={"maxiter": 3, "maxcor": 4, "maxls": 5},
            restarts_optim=1, num_repeat_actions=1,
        ),
    )


def _controller(env, cfg, **kw):
    box = (env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high)
    return GpMpcController(*box, cfg, device="cpu", **kw)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_pendulum_env_matches_jax():
    jenv, tenv = JaxPendulum(seed=3), PendulumEnv(seed=3)
    assert np.array_equal(tenv.reset(), jenv.reset())
    for box in ("observation_space", "action_space"):
        for k in ("low", "high"):
            assert np.array_equal(getattr(getattr(tenv, box), k), getattr(getattr(jenv, box), k))
    rng = np.random.default_rng(0)
    for _ in range(60):
        a = rng.uniform(-2.5, 2.5, 1)  # beyond the torque box too: both clip
        jo, jr, jd, _ = jenv.step(a)
        to, tr, td, _ = tenv.step(a)
        assert np.array_equal(to, jo) and tr == jr and td == jd
    assert np.array_equal(tenv.state, jenv.state)


def test_pendulum_config_is_the_example_config():
    spec = importlib.util.spec_from_file_location("config_pendulum", ROOT / "examples/pendulum/config_pendulum.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ref, out = example.get_config(), pendulum_config()
    for name in ("observation", "reward", "actions", "model", "memory", "training", "controller"):
        assert vars(getattr(out, name)) == vars(getattr(ref, name)), name
    assert out.dtype == ref.dtype == "float64"


def _jax_draws(ctrl, iter_ctrl):
    """The re-init fractions the JAX controller's training at iter_ctrl draws."""
    restarts = int(ctrl.config.training.restarts_train)
    keys = jax.random.split(jax.random.fold_in(ctrl._train_key, iter_ctrl), ctrl.dim_state * restarts)
    keys = keys.reshape(restarts, ctrl.dim_state, -1)
    return torch.tensor(np.stack([[np.asarray(jax.random.uniform(keys[r, m], (ctrl.dim_input + 2,), jnp.float64))
                                   for m in range(ctrl.dim_state)] for r in range(restarts)]))


def _close(out, ref, what, tol=TOL):
    out, ref = np.asarray(out, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert out.shape == ref.shape, what
    scale = max(float(np.max(np.abs(ref))), 1e-30) if ref.size else 1.0
    assert float(np.max(np.abs(out - ref), initial=0.0)) <= tol * scale, what


def test_controller_episode_matches_jax():
    warmup, planned, freq = 5, 3, 5
    jcfg = small_pendulum_config(gpmpc_tpu, len_horizon=3, training_frequency=freq)
    tcfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3, training_frequency=freq)
    env = JaxPendulum(seed=0)
    box = (env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high)
    jctrl = JaxController(*box, jcfg, seed=0)
    tctrl = GpMpcController(*box, tcfg, seed=0, device="cpu")
    tctrl.train_draws = lambda it: _jax_draws(jctrl, it)
    obs = env.reset()
    for i in range(warmup + planned):
        random = i < warmup
        tol = TOL if random else TRAINED_TOL
        ja = jctrl.get_action(obs, random=random)
        ta = tctrl.get_action(obs, random=random)
        _close(ta, ja, f"action at step {i}", tol)
        if random:
            assert np.array_equal(ta, ja), "warmup actions are the same numpy draws"
        jinfo, tinfo = jctrl.get_iter_info(), tctrl.get_iter_info()
        for k, v in vars(jinfo).items():
            _close(getattr(tinfo, k), v, f"iter info {k} at step {i}", tol)
        jcost = jctrl.compute_cost_unnormalized(obs, ja)
        tcost = tctrl.compute_cost_unnormalized(obs, ja)
        _close(tcost, jcost, f"cost at step {i}")
        obs_new, reward, _, _ = env.step(ja)
        for ctrl, info in ((jctrl, jinfo), (tctrl, tinfo)):
            ctrl.add_memory(obs, ja, obs_new, -jcost[0], info.predicted_states[1], info.predicted_states_std[1])
        obs = obs_new
        if i == warmup - 1:
            # the training fired in this add_memory on both sides: integrate it here
            assert jctrl._pending_train is not None and tctrl._pending_train is not None
            jax.block_until_ready(jctrl._pending_train)
            jctrl.check_and_close_processes()
            tctrl.wait_for_training()
            assert jctrl._pending_train is None and tctrl._pending_train is None
            assert np.all(np.isfinite(tctrl._last_train_losses))
            # the port trained the same problem from the same draws; it plans
            # with JAX's result from here
            tctrl.gp_params = convert.gp_params_from_numpy(
                **{k: np.asarray(v) for k, v in jctrl.gp_params._asdict().items()}, dtype=torch.float64,
                device="cpu")
            for out, ref in zip(tctrl.get_hyperparameters(), jctrl.get_hyperparameters()):
                np.testing.assert_array_equal(out, ref)
    assert tctrl.planner._cache_n == jctrl.planner._cache_n
    js, ts = convert.memory_state(jctrl.memory), convert.memory_state(tctrl.memory)
    for k in js:
        if k in ("errors", "stds"):
            _close(np.nan_to_num(ts[k]), np.nan_to_num(js[k]), k, TRAINED_TOL)
            assert np.array_equal(np.isnan(ts[k]), np.isnan(js[k])), k
        else:
            assert np.array_equal(ts[k], js[k]), k
    tctrl.close()


# --- the pendulum cases of tests/test_controller_integration.py on the port ---


def _episode(env, cfg, random_actions_init, num_steps, seed=0):
    """run_env's loop (gpmpc_tpu/runner/run_env.py) on the port's
    controller; returns the per-step costs."""
    ctrl = _controller(env, cfg, seed=seed)
    obs = env.reset()
    costs = []
    for i in range(num_steps):
        action = ctrl.get_action(obs, random=i < random_actions_init)
        info = ctrl.get_iter_info()
        cost, _ = ctrl.compute_cost_unnormalized(obs, action)
        costs.append(cost)
        obs_new, _, _, _ = env.step(action)
        ctrl.add_memory(obs, action, obs_new, -cost, info.predicted_states[1], info.predicted_states_std[1])
        obs = obs_new
    ctrl.check_and_close_processes()
    ctrl.close()
    return costs


def test_action_repeat_caches_actions():
    env = PendulumEnv(seed=1)
    cfg = small_pendulum_config(gpmpc_tpu_torch)
    cfg.controller.num_repeat_actions = 3
    ctrl = _controller(env, cfg)
    obs = env.reset()
    actions = [ctrl.get_action(obs, random=True) for _ in range(4)]
    np.testing.assert_allclose(actions[0], actions[1])
    np.testing.assert_allclose(actions[0], actions[2])
    assert len(ctrl.info_iters["cost"]) == 2  # planned at iterations 0 and 3 only
    ctrl.close()


def test_iter_info_contents():
    env = PendulumEnv(seed=2)
    cfg = small_pendulum_config(gpmpc_tpu_torch)
    ctrl = _controller(env, cfg)
    obs = env.reset()
    ctrl.get_action(obs, random=True)
    info = ctrl.get_iter_info()
    nh = cfg.controller.len_horizon
    assert info.predicted_states.shape == (nh + 1, 3)
    assert info.predicted_states_std.shape == (nh + 1, 3)
    assert info.predicted_actions.shape == (nh, 1)
    assert info.predicted_costs.shape == (nh + 1,)
    assert np.isfinite(info.cost)
    assert len(ctrl.info_iters["cost"]) == 1
    assert "predicted_costs" in str(info)
    ctrl.close()


def test_compute_cost_unnormalized_positive_far_from_target():
    env = PendulumEnv(seed=3)
    ctrl = _controller(env, small_pendulum_config(gpmpc_tpu_torch))
    cost_down, var = ctrl.compute_cost_unnormalized(np.array([-1.0, 0.0, 0.0]), np.array([0.0]))
    cost_up, _ = ctrl.compute_cost_unnormalized(np.array([1.0, 0.0, 0.0]), np.array([0.0]))
    assert cost_down > cost_up
    assert var >= 0
    ctrl.close()


def test_training_triggers_and_hotswaps():
    env = PendulumEnv(seed=4)
    cfg = small_pendulum_config(gpmpc_tpu_torch, training_frequency=6)
    ctrl = _controller(env, cfg)
    ls_before, os_before, nz_before = ctrl.get_hyperparameters()
    params_before = ctrl.gp_params
    obs = env.reset()
    for _ in range(8):
        a = ctrl.get_action(obs, random=True)
        info = ctrl.get_iter_info()
        obs_new, r, _, _ = env.step(a)
        ctrl.add_memory(obs, a, obs_new, r, info.predicted_states[1], info.predicted_states_std[1])
        obs = obs_new
    ctrl.wait_for_training()
    assert ctrl._pending_train is None
    assert ctrl.gp_params is not params_before  # swapped in
    ls_after, os_after, nz_after = ctrl.get_hyperparameters()
    assert ls_after.shape == ls_before.shape
    assert np.all(np.isfinite(ctrl._last_train_losses)) and ctrl.last_train_seconds > 0
    # the next planning step refactorizes with the new parameters
    ctrl.get_action(obs)
    assert ctrl.planner._cache_params is ctrl.gp_params
    ctrl.close()


def test_derivative_action_mapper_integration():
    costs = _episode(PendulumEnv(seed=5), small_pendulum_config(gpmpc_tpu_torch, limit_action_change=True), 4, 10)
    assert np.all(np.isfinite(costs))


def test_constraints_integration():
    costs = _episode(PendulumEnv(seed=6), small_pendulum_config(gpmpc_tpu_torch, use_constraints=True), 4, 10)
    assert np.all(np.isfinite(costs))


def test_time_model_integration():
    cfg = small_pendulum_config(gpmpc_tpu_torch)
    cfg.model.include_time_model = True
    costs = _episode(PendulumEnv(seed=7), cfg, 4, 10)
    assert np.all(np.isfinite(costs))


def test_mixed_planned_step_holds_to_f64_plan():
    """Config(dtype="float32") is mixed mode: f32 memory and parameters, an
    f64 master and a df32 rollout. One planned step after a warmup and a
    training, held to the port's f64 plan of the same memory, parameters,
    state, inits and previous action by chip_smoke.py's MIXED_TOL."""
    smoke = _smoke()
    env = PendulumEnv(seed=0)
    ctrl = _controller(env, pendulum_config(len_horizon=3, dtype="float32", training_frequency=6))
    assert ctrl.memory.dtype == np.float32 and ctrl.gp_params.raw_noise.dtype == torch.float32
    assert ctrl.planner.master_dtype == torch.float64 and ctrl.planner.dtype == torch.float32
    calls = smoke.record_plans(ctrl.planner)
    obs = env.reset()
    for i in range(7):
        a = ctrl.get_action(obs, random=i < 6)
        info = ctrl.get_iter_info()
        obs_new, r, _, _ = env.step(a)
        ctrl.add_memory(obs, a, obs_new, r, info.predicted_states[1], info.predicted_states_std[1])
        obs = obs_new
        if i == 5:
            ctrl.wait_for_training()
    assert len(calls) == 1
    assert ctrl.planner._cache.x_mem.dtype == torch.float64
    gaps = smoke.controller_plan_gaps(ctrl, calls[0], torch.device("cpu"))
    assert all(v <= smoke.MIXED_TOL[k] for k, v in gaps.items()), gaps
    ctrl.close()


def test_pure_f32_session():
    """master_dtype=float32 (JAX with x64 off): an f32 master, and training
    on the controller's device in f32."""
    env = PendulumEnv(seed=0)
    ctrl = _controller(env, small_pendulum_config(gpmpc_tpu_torch, len_horizon=3, training_frequency=4)
                       .replace(dtype="float32"), master_dtype=torch.float32)
    obs = env.reset()
    for i in range(6):
        a = ctrl.get_action(obs, random=i < 4)
        info = ctrl.get_iter_info()
        obs_new, r, _, _ = env.step(a)
        ctrl.add_memory(obs, a, obs_new, r, info.predicted_states[1], info.predicted_states_std[1])
        obs = obs_new
        if i == 3:
            ctrl.wait_for_training()
            assert ctrl.gp_params.raw_noise.dtype == torch.float32
    assert ctrl.planner._cache.x_mem.dtype == torch.float32
    assert np.all(np.isfinite(a))
    ctrl.close()


def test_controller_defaults_to_cuda():
    """Without ``device`` the controller runs on cuda; where torch finds no
    CUDA device it raises instead of carrying on on the CPU."""
    env = PendulumEnv(seed=0)
    box = (env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high)
    cfg = small_pendulum_config(gpmpc_tpu_torch)
    if torch.cuda.is_available():
        ctrl = GpMpcController(*box, cfg)
        assert ctrl.device.type == "cuda" and ctrl.planner.device.type == "cuda"
        ctrl.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            GpMpcController(*box, cfg)

"""The port's on-device episodes (runner/episode.py) against the JAX
package's (runner/jit_episode.py) and against the port's own controller, on
the CPU.

* The memory functions: tests/test_jit_episode.py's three memory cases on
  the port, and random add/prepare sequences at k = 3 against JAX's
  ``memory_prepare``, exactly (every field, drops past the model buffer
  included).
* ``episode_spec_from_config`` and ``_model_cap_for`` field by field.
* Whole episodes against JAX's ``build_episode_fn``: tests/test_torch_episode_jax.py.
* The seed batch equals single episodes bit for bit, segmented or not.
* tests/test_cross_path.py's protocol between the port's episode and the
  port's GpMpcController (time model on with action repeat 2; and with
  training), to 1e-8: the two share the training draws given a seed.
* A mixed episode against the f64 episode under
  tests/test_df32.py::test_full_episode_df32_matches_f64_curve's three
  bounds, cut to keep the file fast: 16 steps (for 36) at horizon 3 (for 5)
  and action repeat 2 (for 1), one training (for two). It runs the port's
  own draws (the same in both dtypes) where that test runs 0.5 constants,
  under which every plan of the pendulum stays at its 0.5 init (the warmup
  rows all hold the action 0.5, so the GP's mean has no slope in it there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmpc_tpu
import gpmpc_tpu_torch
from gpmpc_tpu.envs import jax_dynamics as jd
from gpmpc_tpu.runner import jit_episode as je
from gpmpc_tpu_torch.config import MemoryConfig
from gpmpc_tpu_torch.controllers.controller import GpMpcController
from gpmpc_tpu_torch.envs import torch_dynamics as td
from gpmpc_tpu_torch.example_configs import mountain_car_config, process_control_config
from gpmpc_tpu_torch.memory.buffer import Memory
from gpmpc_tpu_torch.runner import episode as te
from tests.test_torch_controller import small_pendulum_config

CPU = torch.device("cpu")
CROSS_TOL = 1e-8


# --- the memory functions ---


def test_memory_prepare_matches_host_semantics():
    """The device memory_prepare agrees with the host Memory on stride,
    filter and target formation."""
    ns, na, k, cap = 2, 1, 3, 32
    rng = np.random.default_rng(0)
    host = Memory(MemoryConfig(check_errors_for_storage=False, points_batch_memory=cap), dim_input=ns + na,
                  dim_state=ns, step_model=k)
    dev = te.memory_init(cap, ns + na, ns, torch.float64, device=CPU)
    states = rng.uniform(0, 1, (13, ns))
    for i in range(12):
        a = rng.uniform(0, 1, (na,))
        host.add(states[i], a, states[i + 1], 0.0, i)
        dev = te.memory_add(dev, torch.tensor(np.concatenate([states[i], a])), torch.tensor(states[i + 1]), True)
    host.prepare_for_model()
    dev = te.memory_prepare(dev, k, ns)
    hx, hy = host.get()
    n = int(dev.len_model)
    assert n == len(hx)
    np.testing.assert_array_equal(dev.model_inputs[:n].numpy(), hx)
    np.testing.assert_array_equal(dev.model_targets[:n].numpy(), hy)


def test_memory_prepare_respects_filter_flags():
    ns, cap = 2, 16
    dev = te.memory_init(cap, 3, ns, torch.float64, device=CPU)
    for i in range(6):
        dev = te.memory_add(dev, torch.full((3,), float(i), dtype=torch.float64),
                            torch.full((2,), float(i + 1), dtype=torch.float64), i % 2 == 0)
    dev = te.memory_prepare(dev, 1, ns)
    assert int(dev.len_model) == 3  # only the even rows were stored
    np.testing.assert_array_equal(dev.model_inputs[:3, 0].numpy(), [0.0, 2.0, 4.0])


def test_empty_memory_mask_has_dummy_point():
    mask = te.memory_active_mask(te.memory_init(8, 3, 2, torch.float64, device=CPU))
    assert int(mask.sum()) == 1 and bool(mask[0])


@pytest.mark.parametrize("model_cap", [None, 4], ids=["fits", "drops"])
def test_memory_matches_jax_exactly(model_cap):
    """Random rows and storage flags, prepared at k = 3 after every few adds:
    every field equals JAX's after each prepare, also where the model buffer
    (model_cap 4) is full and JAX's scatter drops the points past it."""
    ns, d, k, cap = 2, 4, 3, 40
    rng = np.random.default_rng(3)
    jmem = je.memory_init(cap, d, ns, jnp.float64, model_cap=model_cap)
    tmem = te.memory_init(cap, d, ns, torch.float64, model_cap=model_cap, device=CPU)
    for i in range(cap):
        x, s, flag = rng.uniform(-1, 1, d), rng.uniform(-1, 1, ns), bool(rng.uniform() < 0.7)
        jmem = je.memory_add(jmem, jnp.asarray(x), jnp.asarray(s), jnp.asarray(flag))
        tmem = te.memory_add(tmem, torch.tensor(x), torch.tensor(s), torch.tensor(flag))
        if rng.uniform() < 0.3 or i == cap - 1:
            jmem, tmem = je.memory_prepare(jmem, k, ns), te.memory_prepare(tmem, k, ns)
            for name, jv in jmem._asdict().items():
                tv = getattr(tmem, name)
                assert tv.dtype == {"flags": torch.bool}.get(name, torch.float64 if tv.is_floating_point()
                                                              else torch.int32), name
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
            np.testing.assert_array_equal(te.memory_active_mask(tmem).numpy(),
                                          np.asarray(je.memory_active_mask(jmem)))
    if model_cap:
        assert int(tmem.len_model) > model_cap  # points were dropped


# --- the spec ---


def _spec_pairs(name):
    """(JAX config, port config, JAX env spec, port env spec) of each case."""
    if name == "pendulum":
        return (small_pendulum_config(gpmpc_tpu, len_horizon=2), small_pendulum_config(gpmpc_tpu_torch, len_horizon=2),
                jd.pendulum_spec(), td.pendulum_spec(device=CPU))
    import importlib.util
    from pathlib import Path

    folder, module = {"mountain_car": ("mountain_car", "config_mountaincar"),
                      "process_control": ("process_control", "config_process_control")}[name]
    path = Path(__file__).resolve().parents[1] / "examples" / folder / f"{module}.py"
    loader = importlib.util.spec_from_file_location(module, path)
    example = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(example)
    port = mountain_car_config() if name == "mountain_car" else process_control_config()
    return (example.get_config(), port, getattr(jd, f"{name}_spec")(), getattr(td, f"{name}_spec")(device=CPU))


def _same(out, ref, what):
    if isinstance(ref, tuple):
        assert type(out).__name__ == type(ref).__name__ and out._fields == ref._fields, what
        for k in ref._fields:
            _same(getattr(out, k), getattr(ref, k), f"{what}.{k}")
    elif isinstance(ref, (jnp.ndarray, np.ndarray)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=what)
    else:
        assert out == ref, what


@pytest.mark.parametrize("name", ["pendulum", "mountain_car", "process_control"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_episode_spec_from_config_matches_jax(name, dtype):
    jcfg, tcfg, jenv, tenv = _spec_pairs(name)
    jcfg.dtype = tcfg.dtype = dtype
    jspec, jp0 = je.episode_spec_from_config(jenv, jcfg, num_steps=70, warmup=6)
    tspec, tp0 = te.episode_spec_from_config(tenv, tcfg, num_steps=70, warmup=6)
    for k in je.EpisodeSpec._fields:
        if k == "env":
            continue
        if k == "dtype":
            assert tspec.dtype == {"float64": torch.float64, "float32": torch.float32}[dtype]
            assert np.dtype(jspec.dtype) == np.dtype(dtype)
            continue
        _same(getattr(tspec, k), getattr(jspec, k), k)
    assert tspec.device == CPU and tspec.env is tenv
    _same(tp0, jp0, "params0")


def test_model_cap_for_matches_jax():
    for cap in (32, 64, 96, 160, 512, 1024):
        for k in (1, 2, 3, 5, 10):
            assert te._model_cap_for(cap, k) == je._model_cap_for(cap, k), (cap, k)


def test_episode_spec_defaults_to_cuda_and_checks_mixed():
    cfg = small_pendulum_config(gpmpc_tpu_torch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            te.episode_spec_from_config(td.pendulum_spec(), cfg, num_steps=8, warmup=2)
    with pytest.raises(ValueError, match="float32"):
        te.episode_spec_from_config(td.pendulum_spec(device=CPU), cfg, num_steps=8, warmup=2, mixed_df32=True)


# --- batches and segments ---


def _pendulum_spec(steps=10, freq=7, **kw):
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=2, training_frequency=freq, iter_train=1)
    cfg.controller.num_repeat_actions = 2
    return te.episode_spec_from_config(td.pendulum_spec(device=CPU), cfg, num_steps=steps, warmup=4, cap=32, **kw)


def _assert_equal_outs(out, ref):
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        fields = v._fields if isinstance(v, tuple) else (None,)
        for f in fields:
            a, b = (out[k], v) if f is None else (getattr(out[k], f), getattr(v, f))
            assert torch.equal(a, b), (k, f)


def test_batch_equals_single_episodes_bit_for_bit():
    """Three seeds (random draws, a training at t = 6): the batch's outputs
    are the three single episodes', and a run in segments of 3 steps is the
    unsegmented run, bit for bit; the seeds' trajectories differ."""
    spec, p0 = _pendulum_spec()
    seeds = [0, 1, 2]
    batch = te.run_episodes_batch(spec, p0, seeds)
    one = te.build_episode_fn(spec)
    singles = [one(s, p0) for s in seeds]
    for i, single in enumerate(singles):
        _assert_equal_outs({k: (type(v)(*(f[i] for f in v)) if isinstance(v, tuple) else v[i])
                            for k, v in batch.items()}, single)
    _assert_equal_outs(te.build_episodes_batch_fn(spec, steps_per_call=3)(seeds, p0), batch)
    assert batch["cost"].shape == (3, 10) and bool(torch.isfinite(batch["cost"]).all())
    assert not torch.equal(batch["cost"][0], batch["cost"][1])
    assert not torch.equal(batch["final_params"].raw_noise[0], p0.raw_noise)  # the training ran


# --- the episode against the port's controller (tests/test_cross_path.py) ---


class _ConstRng:
    """The controller's numpy rng with every uniform draw 0.5, the
    episode's deterministic_inits."""

    def uniform(self, size=None):
        return 0.5 if size is None else np.full(size, 0.5)


@pytest.mark.parametrize("include_time_model, nrep, freq", [(True, 2, 10**6), (False, 2, 5)],
                         ids=["time_model_repeat_2", "with_training"])
def test_episode_matches_controller(include_time_model, nrep, freq):
    steps = 12
    cfg = small_pendulum_config(gpmpc_tpu_torch, training_frequency=freq, iter_train=2)
    cfg.model.include_time_model = include_time_model
    cfg.controller.num_repeat_actions = nrep
    cfg.memory.check_errors_for_storage = True  # the storage filter on both paths
    env = td.pendulum_spec(device=CPU)
    spec, p0 = te.episode_spec_from_config(env, cfg, num_steps=steps, warmup=0, cap=32, deterministic_inits=True)
    out = te.build_episode_fn(spec)(0, p0)
    obs_seq, act_seq = out["obs"].numpy(), out["action_raw"].numpy()
    obs_next = np.concatenate([obs_seq[1:], out["final_obs"].numpy()[None]])

    ctrl = GpMpcController(env.obs_low, env.obs_high, env.act_low, env.act_high, cfg, seed=0, device=CPU)
    ctrl._rng = _ConstRng()
    swaps = 0
    try:
        for t in range(steps):
            # refactorize at every planning step, as the episode does
            ctrl.planner.invalidate_cache()
            a = ctrl.get_action(obs_mu=obs_seq[t])
            info = ctrl.get_iter_info()
            np.testing.assert_allclose(a, act_seq[t], atol=CROSS_TOL, err_msg=f"action at step {t}")
            ctrl.add_memory(obs_seq[t], act_seq[t], obs_next[t], 0.0, info.predicted_states[1],
                            info.predicted_states_std[1])
            if ctrl._pending_train is not None:
                ctrl.wait_for_training()
                assert (t + 1) % freq == 0
                swaps += 1
    finally:
        ctrl.close()
    assert swaps == steps // freq
    for k in p0._fields:
        np.testing.assert_allclose(getattr(ctrl.gp_params, k).numpy(), getattr(out["final_params"], k).numpy(),
                                   atol=CROSS_TOL, err_msg=k)
    ctrl.memory.prepare_for_model()
    hx, hy = ctrl.memory.get()
    fmem = te.memory_prepare(out["final_mem"], nrep, 3)
    n = int(fmem.len_model)
    assert n == len(hx)
    np.testing.assert_allclose(fmem.model_inputs[:n].numpy(), hx, atol=CROSS_TOL)
    np.testing.assert_allclose(fmem.model_targets[:n].numpy(), hy, atol=CROSS_TOL)
    if include_time_model:
        # the time column is the env step in both paths, a multiple of nrep
        assert np.all(hx[:, -1] % nrep == 0)
        np.testing.assert_array_equal(fmem.model_inputs[:n, -1].numpy(), hx[:, -1])


# --- mixed mode against f64 ---


def test_mixed_episode_tracks_f64():
    """The same pendulum episode (one seed's draws, which are made in f64,
    the storage filter, one training) in f64 and in mixed mode (f64 master,
    double-float32 rollout, the env in f64): the curves start
    indistinguishable, stay loosely coupled and end at the same control
    quality, by tests/test_df32.py::test_full_episode_df32_matches_f64_curve's
    bounds."""
    steps, warmup, curves = 16, 8, {}
    for mode in ("f64", "mixed"):
        cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3, training_frequency=12, iter_train=2)
        cfg.dtype = "float64" if mode == "f64" else "float32"
        cfg.controller.num_repeat_actions = 2
        spec, p0 = te.episode_spec_from_config(td.pendulum_spec(device=CPU), cfg, num_steps=steps, warmup=warmup,
                                               cap=64, mixed_df32=mode == "mixed")
        out = te.build_episode_fn(spec)(3, p0)
        assert out["cost"].dtype == (torch.float64 if mode == "f64" else torch.float32)
        curves[mode] = out["cost"].double().numpy()
    diff = np.abs(curves["mixed"] - curves["f64"])
    assert diff[:warmup].max() < 1e-3, diff[:warmup]
    assert float(diff.mean()) < 0.05, diff
    tail = steps - steps // 4
    assert abs(curves["mixed"][tail:].mean() - curves["f64"][tail:].mean()) < 0.02

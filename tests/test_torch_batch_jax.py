"""The port's episode batch (runner/episode.py ``build_episodes_batch_fn``,
the seeds in lockstep) against the JAX package's vmap of its episode over
keys (runner/jit_episode.py ``build_episodes_batch_fn``), in f64 on the CPU.

Two seeds of the mountain-car example's configuration with its two L-BFGS-B
restarts, cut to horizon 2, repeat 2, 8 steps (random evaluations at t = 0
and 2, planned steps of seeds x restarts at t = 4 and 6), budget 3; its
training_frequency (60) is past the episode. JAX's random values are fed to
the port through ``EpisodeDraws`` per seed, each from that seed's key: the
initial env state, the previous action, the warmup sequences and the
restarts' inits. Every per-step output of both seeds within TOL = 1e-9 of
its largest entry (tests/test_torch_episode_jax.py's bound before a
training), the memory's counters and flags exactly. One JAX compile of the
vmapped episode (~20-40 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpmpc_tpu.envs import jax_dynamics as jd
from gpmpc_tpu.runner import jit_episode as je
from gpmpc_tpu_torch.envs import torch_dynamics as td
from gpmpc_tpu_torch.runner import episode as te
from tests.test_torch_episode import _spec_pairs

CPU = torch.device("cpu")
STEPS, WARMUP, NH, REPEAT, BUDGET = 8, 4, 2, 2, 3
TOL = 1e-9


def _uniform(key, shape, dtype=jnp.float64):
    return torch.tensor(np.asarray(jax.random.uniform(key, shape, dtype)))


def _jax_draws(keys, spec, dtype=jnp.float64):
    """A draws factory: seed i's EpisodeDraws returns what JAX's episode (in
    ``dtype``) draws from keys[i]."""
    na, n_flat = spec.plan.dim_action, spec.plan.len_horizon * spec.plan.dim_action
    tdtype = torch.float32 if dtype == jnp.float32 else torch.float64

    def make(seed, spec_):
        key = keys[seed]
        k_init, k_scan, k_prev = jax.random.split(key, 3)
        state, _ = jd.mountain_car_spec(dtype).init_fn(k_init)
        step_keys = []
        for _ in range(STEPS):
            k_scan, k_plan, _, k_rand = jax.random.split(k_scan, 4)
            step_keys.append((k_plan, k_rand))

        class Draws(te.EpisodeDraws):
            def env_init(self):
                return td.mountain_car_spec(dtype=tdtype, device=CPU,
                                            draw=lambda g, name: np.asarray(state)[:1]).init_fn(self.generator)

            def action_prev(self):
                return _uniform(k_prev, (na,), dtype)

            def warmup_actions(self, t):
                return _uniform(step_keys[t][1], (n_flat,), dtype)

            def inits(self, t):
                return _uniform(jax.random.split(step_keys[t][0])[0], (spec_.restarts_optim, n_flat), dtype)

        return Draws(seed, spec_)

    return make


def test_two_seed_episode_batch_matches_jax_vmap():
    jcfg, tcfg, jenv, tenv = _spec_pairs("mountain_car")
    for cfg in (jcfg, tcfg):
        cfg.dtype = "float64"
        cfg.controller.len_horizon = NH
        cfg.controller.num_repeat_actions = REPEAT
        cfg.controller.actions_optimizer_params = {**cfg.controller.actions_optimizer_params, "maxiter": BUDGET,
                                                   "maxfun": BUDGET}
    kw = dict(num_steps=STEPS, warmup=WARMUP, cap=32)
    jspec, jp0 = je.episode_spec_from_config(jenv, jcfg, **kw)
    tspec, tp0 = te.episode_spec_from_config(tenv, tcfg, **kw)
    assert tspec.restarts_optim == jspec.restarts_optim == 2
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jout = je.build_episodes_batch_fn(jspec)(keys, jp0)
    tout = te.build_episodes_batch_fn(tspec, draws=_jax_draws(keys, tspec))([0, 1], tp0)
    for k in ("obs", "action_raw", "cost", "env_reward", "pred_state", "pred_std", "final_obs"):
        out, ref = tout[k].numpy(), np.asarray(jout[k])
        assert out.shape == ref.shape, k
        gap = float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        assert gap <= TOL, (k, gap)
    for name in ("flags", "len_mem", "len_last", "len_model"):
        np.testing.assert_array_equal(getattr(tout["final_mem"], name).numpy(),
                                      np.asarray(getattr(jout["final_mem"], name)), err_msg=name)
    planned = np.asarray(jout["action_raw"])[:, WARMUP:]
    assert np.all(planned != 0.0) and not np.array_equal(planned[0], planned[1])  # the plans moved, per seed

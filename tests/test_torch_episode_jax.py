"""Whole on-device episodes of the port (runner/episode.py) against the JAX
package's ``build_episode_fn`` (runner/jit_episode.py), in f64 on the CPU.

One pendulum episode: horizon 2, 8 steps, warmup 4, one training at t = 5
(training_frequency 6), cap 32. JAX's random values are fed to the port
through ``EpisodeDraws``: the initial env state, the initial previous action
and the training's re-inits (fold_in(fold_in(key, TRAIN_KEY_TAG), t + 1)),
and, in the second case, the warmup sequences and the L-BFGS-B inits of
JAX's per-step keys. Two cases:

* ``deterministic_inits`` (0.5 constants): the protocol of
  tests/test_cross_path.py. There every planned step stays at its init (the
  warmup rows all hold the action 0.5, where the GP's mean has no slope in
  the action), so it holds the rollouts, the storage filter, the memory and
  the training, not the optimizer's moves;
* JAX's own draws: the planned steps move.

Actions, costs, env rewards, pred_state and pred_std, each to its largest
entry: TOL = 1e-9 through the step of the training, as
tests/test_torch_controller.py holds the controller, and TRAINED_TOL (1e-7,
its reason there) after it; final_params and the float fields of final_mem
to TRAINED_TOL, its flags and counters exactly. Measured: 4e-11 before the
training, 1e-10 in the trained raw parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmpc_tpu
import gpmpc_tpu_torch
from gpmpc_tpu.controllers.controller import TRAIN_KEY_TAG
from gpmpc_tpu.envs import jax_dynamics as jd
from gpmpc_tpu.runner import jit_episode as je
from gpmpc_tpu_torch.envs import torch_dynamics as td
from gpmpc_tpu_torch.runner import episode as te
from tests.test_torch_controller import TOL, TRAINED_TOL, small_pendulum_config

CPU = torch.device("cpu")
STEPS, WARMUP, FREQ, NH = 8, 4, 6, 2  # the training fires at t = 5


def _uniform(key, shape):
    return torch.tensor(np.asarray(jax.random.uniform(key, shape, jnp.float64)))


def _jax_draws(key, spec):
    """EpisodeDraws that return the values JAX's episode draws from ``key``."""
    ns, na, restarts = spec.plan.dim_state, spec.plan.dim_action, spec.restarts_train
    d, n_flat = ns + na, spec.plan.len_horizon * spec.plan.dim_action
    k_init, k_scan, k_prev = jax.random.split(key, 3)
    state, _ = jd.pendulum_spec().init_fn(k_init)
    step_keys = []  # (k_plan, k_rand) of each step: split(key, 4) of the scan's carried key
    for _ in range(STEPS):
        k_scan, k_plan, _, k_rand = jax.random.split(k_scan, 4)
        step_keys.append((k_plan, k_rand))
    base = jax.random.fold_in(key, TRAIN_KEY_TAG)

    class Draws(te.EpisodeDraws):
        def env_init(self):
            return td.pendulum_spec(device=CPU, draw=lambda g, name: np.asarray(state)).init_fn(self.generator)

        def action_prev(self):
            return _uniform(k_prev, (na,))

        def warmup_actions(self, t):
            return _uniform(step_keys[t][1], (n_flat,))

        def inits(self, t):
            return _uniform(jax.random.split(step_keys[t][0])[0], (spec.restarts_optim, n_flat))

        def train(self, t):
            keys = jax.random.split(jax.random.fold_in(base, t + 1), ns * restarts).reshape(restarts, ns, -1)
            return torch.stack([torch.stack([_uniform(keys[r, m], (d + 2,)) for m in range(ns)])
                                for r in range(restarts)])

    return Draws


@pytest.mark.parametrize("deterministic_inits", [True, False], ids=["deterministic_inits", "jax_draws"])
def test_f64_episode_matches_jax(deterministic_inits):
    jcfg = small_pendulum_config(gpmpc_tpu, len_horizon=NH, training_frequency=FREQ)
    tcfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=NH, training_frequency=FREQ)
    kw = dict(num_steps=STEPS, warmup=WARMUP, cap=32, deterministic_inits=deterministic_inits)
    jspec, jp0 = je.episode_spec_from_config(jd.pendulum_spec(), jcfg, **kw)
    tspec, tp0 = te.episode_spec_from_config(td.pendulum_spec(device=CPU), tcfg, **kw)
    key = jax.random.PRNGKey(0)
    jout = je.build_episode_fn(jspec)(key, jp0)
    tout = te.build_episode_fn(tspec, draws=_jax_draws(key, tspec))(0, tp0)

    for k in ("obs", "action_raw", "cost", "env_reward", "pred_state", "pred_std"):
        out, ref = tout[k].numpy(), np.asarray(jout[k])
        assert out.shape == ref.shape, k
        gaps = np.abs(out - ref).reshape(STEPS, -1).max(axis=1) / max(float(np.abs(ref).max()), 1e-30)
        assert np.all(gaps[:FREQ] <= TOL), (k, gaps)  # steps 0..5 plan with the initial parameters
        assert np.all(gaps <= TRAINED_TOL), (k, gaps)
    planned = np.asarray(jout["action_raw"])[WARMUP:, 0]
    assert np.all(planned == 0.0) if deterministic_inits else np.all(planned != 0.0)  # see the docstring
    for k, ref in jout["final_params"]._asdict().items():
        ref = np.asarray(ref)
        assert np.abs(getattr(tout["final_params"], k).numpy() - ref).max() <= TRAINED_TOL * np.abs(ref).max(), k
    assert not np.array_equal(np.asarray(jout["final_params"].raw_noise), np.asarray(jp0.raw_noise))  # it trained
    for k, ref in jout["final_mem"]._asdict().items():
        out, ref = getattr(tout["final_mem"], k).numpy(), np.asarray(ref)
        if out.dtype.kind == "f":
            assert np.abs(out - ref).max() <= TRAINED_TOL * max(float(np.abs(ref).max()), 1.0), k
        else:
            np.testing.assert_array_equal(out, ref, err_msg=k)

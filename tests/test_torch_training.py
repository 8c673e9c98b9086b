"""The port's marginal likelihood, unconstrained L-BFGS and hyperparameter
training against the JAX package's, and the cases of tests/test_training.py
on the port.

The same numpy inputs go to both packages in f64. The MLLs are the same
arithmetic in another order: held to 1e-12 relative. L-BFGS and training
iterate on those values; as long as both sides accept the same line-search
steps, their iterates differ by rounding alone, but the iterations amplify
it: on the training problem here the raw parameters of the two sides
differed by 3e-15 after one iteration, 4e-11 after five, 4e-9 after ten and
1e-5 after twenty (one model of four; the MLL at a noise floor of 1e-6 is
badly conditioned). So the training comparison runs a short budget of ten
iterations, where the losses agree to ~1e-11 relative, held to 1e-9, and
the constrained parameters to ~1e-9 of their box, held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.controllers import lbfgs as jlbfgs
from gpmpc_tpu.models import gp as jgp
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.controllers import lbfgs as tlbfgs
from gpmpc_tpu_torch.models import gp as tgp

NS, D, N = 2, 3, 30


def _problem(seed=42, n=N, pad=0):
    """tests/test_training.py's data (a smooth function plus noise) and
    deliberately bad init, optionally padded with ``pad`` masked rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, D))
    y = np.stack([np.sin(3 * x[:, 0]) * 0.1 + 0.05 * x[:, 1], 0.1 * x[:, 2] ** 2], axis=1)
    y += rng.normal(0, 1e-3, y.shape)
    x = np.concatenate([x, np.zeros((pad, D))])
    y = np.concatenate([y, np.zeros((pad, NS))])
    mask = np.arange(n + pad) < n
    bounds = jgp.GPBounds(
        min_lengthscale=jnp.full((NS, D), 4e-3), max_lengthscale=jnp.full((NS, D), 25.0),
        min_outputscale=jnp.full((NS,), 1e-5), max_outputscale=jnp.full((NS,), 0.95),
        min_noise=jnp.full((NS,), 1e-6), max_noise=jnp.full((NS,), 0.09),
    )
    params = jgp.params_from_constrained(jnp.full((NS, D), 20.0), jnp.full((NS,), 0.9), jnp.full((NS,), 0.05),
                                         bounds)
    return params, bounds, x, y, mask


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _port(params, bounds):
    cpu = dict(dtype=torch.float64, device="cpu")
    return convert.gp_params_from_numpy(**_np(params), **cpu), convert.gp_bounds_from_numpy(**_np(bounds), **cpu)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.max(np.abs(out - ref) / np.abs(ref)))


@pytest.mark.parametrize("pad", [0, 2], ids=["dense", "padded"])
def test_negative_mll_matches_jax(pad):
    params, bounds, x, y, mask = _problem(pad=pad)
    ref = jgp.negative_mll(params, bounds, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    tparams, tbounds = _port(params, bounds)
    out = tgp.negative_mll(tparams, tbounds, _t(x), _t(y), _t(mask, torch.bool))
    assert _rel(out.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("pad", [0, 2], ids=["dense", "padded"])
def test_single_model_negative_mll_and_grad_match_jax(pad):
    params, bounds, x, y, mask = _problem(pad=pad)
    rng = np.random.default_rng(5)
    raw = rng.normal(0, 1, D + 2)
    lo = np.concatenate([np.asarray(bounds.min_lengthscale[0]), np.asarray(bounds.min_outputscale[:1]),
                         np.asarray(bounds.min_noise[:1])])
    hi = np.concatenate([np.asarray(bounds.max_lengthscale[0]), np.asarray(bounds.max_outputscale[:1]),
                         np.asarray(bounds.max_noise[:1])])
    for m in range(NS):
        f_ref, g_ref = jax.value_and_grad(jgp._single_model_negative_mll)(
            jnp.asarray(raw), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(x), jnp.asarray(y[:, m]),
            jnp.asarray(mask))
        r = _t(raw).requires_grad_(True)
        f = tgp._single_model_negative_mll(r, _t(lo), _t(hi), _t(x), _t(y[:, m]), _t(mask, torch.bool))
        (g,) = torch.autograd.grad(f, r)
        assert _rel(float(f.detach()), float(f_ref)) <= 1e-12
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-10,
                                   atol=1e-10 * float(np.max(np.abs(g_ref))))


def _rosenbrock(xp):
    """A narrow curved valley (f64, six unknowns): the line search
    backtracks, the clip binds and the iterates converge."""

    def f(x):
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    return f


@pytest.mark.parametrize("clip,keep_best,scale,maxiter,maxls", [
    (None, False, None, 30, 12),  # plain backtracking from step 1
    (1.0, True, 7e-3, 40, 12),  # training's setting: clip, keep-best, the lr ladder
    (1e-1, True, 7e-3, 150, 6),  # long enough that the search fails at the end (the early stop)
], ids=["plain", "training", "to-failure"])
def test_lbfgs_minimize_matches_jax(clip, keep_best, scale, maxiter, maxls):
    """The port's grad-first search against JAX's batched ``_line_search``
    (which ``lbfgs_minimize`` runs): with a step_scale ladder and no box they
    accept the same points, so the iterates agree to rounding."""
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.5, 0.3])
    kw = dict(maxiter=maxiter, maxcor=10, maxls=maxls, clip_grad_value=clip, keep_best=keep_best,
              init_step_scale=scale)
    x_ref, f_ref = jlbfgs.lbfgs_minimize(_rosenbrock(jnp), jnp.asarray(x0), **kw)
    x_out, f_out = tlbfgs.lbfgs_minimize(_rosenbrock(torch), _t(x0), **kw)
    f_ref = float(f_ref)
    assert abs(float(f_out) - f_ref) <= 1e-9 * abs(f_ref) + 1e-15
    np.testing.assert_allclose(x_out.numpy(), np.asarray(x_ref), rtol=0, atol=1e-9)


def _jax_draws(key, restarts, ns, d):
    """The uniform re-init fractions jgp.train_hyperparams draws from key."""
    keys = jax.random.split(key, ns * restarts).reshape(restarts, ns, -1)
    return np.stack([[np.asarray(jax.random.uniform(keys[r, m], (d + 2,), dtype=jnp.float64))
                      for m in range(ns)] for r in range(restarts)])


def test_train_hyperparams_matches_jax_with_its_draws():
    params, bounds, x, y, mask = _problem(pad=2)
    cfg_j = jgp.TrainConfigDevice(lr=7e-3, iters=10, clip_grad_value=1e-1)
    key = jax.random.PRNGKey(7)
    restarts = 2
    new_ref, losses_ref = jgp.train_hyperparams(params, bounds, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                                                key, cfg_j, restarts=restarts)
    tparams, tbounds = _port(params, bounds)
    new_out, losses_out = tgp.train_hyperparams(
        tparams, tbounds, _t(x), _t(y), _t(mask, torch.bool), None, tgp.TrainConfigDevice(*cfg_j),
        restarts=restarts, draws=_jax_draws(key, restarts, NS, D))
    assert _rel(losses_out.numpy(), losses_ref) <= 1e-9
    lo_hi = [(bounds.min_lengthscale, bounds.max_lengthscale), (bounds.min_outputscale, bounds.max_outputscale),
             (bounds.min_noise, bounds.max_noise)]
    for out, ref, (lo, hi) in zip(tgp.constrained_params(new_out, tbounds), jgp.constrained_params(new_ref, bounds),
                                  lo_hi):
        gap = np.abs(out.numpy() - np.asarray(ref)) / (np.asarray(hi) - np.asarray(lo))
        assert gap.max() <= 1e-6


# --- the cases of tests/test_training.py on the port -------------------------


def _port_problem(rng_seed=42):
    params, bounds, x, y, mask = _problem(seed=rng_seed)
    tparams, tbounds = _port(params, bounds)
    return tparams, tbounds, _t(x), _t(y), _t(mask, torch.bool)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_training_improves_mll():
    params, bounds, x, y, mask = _port_problem()
    cfg = tgp.TrainConfigDevice(lr=7e-3, iters=60, clip_grad_value=1e-1)
    before = tgp.negative_mll(params, bounds, x, y, mask).numpy()
    _, losses = tgp.train_hyperparams(params, bounds, x, y, mask, _gen(0), cfg)
    after = losses.numpy()
    assert np.all(after <= before + 1e-9)
    assert np.any(after < before - 0.1)  # materially better than the bad init


def test_training_respects_interval_constraints():
    params, bounds, x, y, mask = _port_problem()
    cfg = tgp.TrainConfigDevice(lr=7e-3, iters=30, clip_grad_value=1e-1)
    new_params, _ = tgp.train_hyperparams(params, bounds, x, y, mask, _gen(1), cfg)
    ls, outs, noise = tgp.constrained_params(new_params, bounds)
    assert torch.all(ls >= bounds.min_lengthscale) and torch.all(ls <= bounds.max_lengthscale)
    assert torch.all(outs >= bounds.min_outputscale)
    assert torch.all(noise <= bounds.max_noise)


def test_training_keeps_incumbent_when_better():
    """A 1-iteration budget from a random re-init cannot beat well-trained
    parameters: the incumbents are returned (keep-best against the
    incumbent, reference gp_model.py:231-235)."""
    params, bounds, x, y, mask = _port_problem()
    cfg_long = tgp.TrainConfigDevice(lr=7e-3, iters=80, clip_grad_value=1e-1)
    good_params, good_losses = tgp.train_hyperparams(params, bounds, x, y, mask, _gen(2), cfg_long)
    cfg_short = tgp.TrainConfigDevice(lr=7e-3, iters=1, clip_grad_value=1e-3)
    kept_params, kept_losses = tgp.train_hyperparams(good_params, bounds, x, y, mask, _gen(3), cfg_short)
    assert torch.all(kept_losses <= good_losses + 1e-9)
    for a, b in zip(kept_params, good_params):
        assert torch.equal(a, b)


def test_training_restarts():
    params, bounds, x, y, mask = _port_problem()
    cfg = tgp.TrainConfigDevice(lr=7e-3, iters=20, clip_grad_value=1e-1)
    _, losses = tgp.train_hyperparams(params, bounds, x, y, mask, _gen(4), cfg, restarts=3)
    assert tuple(losses.shape) == (NS,)
    _, one = tgp.train_hyperparams(params, bounds, x, y, mask, None, cfg, restarts=1,
                                   draws=torch.rand((3, NS, D + 2), generator=_gen(4), dtype=torch.float64)[:1])
    assert torch.all(losses <= one)  # the best of three runs includes the first


def _time_model_problem(seed=3, n=30, pad=2):
    """The process-control example's model with the time model on (ns = 2,
    D = ns + na + 1 = 5), its bounds and initial parameters resolved by each
    package's own ``ModelConfig.resolved`` (the time lengthscale's box 5-1000
    and init 100, extend_dim_lengthscale_time), on inputs whose last column
    is the raw iteration index of a point stored every 10 env steps (0-290),
    as the memory stores it at ``num_repeat_actions`` = 10; the targets drift
    with time as a plant whose parameters change does."""
    import importlib.util
    from pathlib import Path

    from gpmpc_tpu_torch.example_configs import process_control_config

    path = Path(__file__).resolve().parents[1] / "examples/process_control/config_process_control.py"
    spec = importlib.util.spec_from_file_location("config_process_control", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ns, d = 2, 5
    rj = module.get_config(len_horizon=5, include_time_model=True, num_repeat_actions=10).model.resolved(ns, d)
    rt = process_control_config(len_horizon=5, include_time_model=True, num_repeat_actions=10).model.resolved(ns, d)
    for name in vars(rj):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
    assert np.all(rj.min_lengthscale[:, -1] == 5) and np.all(rj.max_lengthscale[:, -1] == 1000)

    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(0, 1, (n, d - 1)), 10.0 * np.arange(n)[:, None]], axis=1)
    y = np.stack([0.05 * np.sin(3 * x[:, 0]) - 0.02 * x[:, 2] + 1e-4 * x[:, 4],
                  0.03 * x[:, 1] * x[:, 3] - 0.01 * np.cos(x[:, 4] / 50.0)], axis=1)
    y += rng.normal(0, 1e-3, y.shape)
    x = np.concatenate([x, np.zeros((pad, d))])
    y = np.concatenate([y, np.zeros((pad, ns))])
    mask = np.arange(n + pad) < n
    bounds = jgp.GPBounds(*(jnp.asarray(v) for v in (rj.min_lengthscale, rj.max_lengthscale, rj.min_outputscale,
                                                      rj.max_outputscale, rj.min_noise_var, rj.max_noise_var)))
    params = jgp.params_from_constrained(jnp.asarray(rj.init_lengthscale), jnp.asarray(rj.init_outputscale),
                                         jnp.asarray(rj.init_noise_var), bounds)
    return params, bounds, x, y, mask


def test_train_hyperparams_with_the_time_model_matches_jax_with_its_draws():
    """``train_hyperparams`` at D = 5 with the raw time column and the time
    lengthscale's bounds (the time-varying process-control workload's
    training), held to JAX's with JAX's draws: the losses within 1e-9
    relative and the constrained parameters within 1e-7 of their box, over the
    example's 15 iterations from its initial parameters and from a restart."""
    params, bounds, x, y, mask = _time_model_problem()
    ns, d = x.shape[1] - 3, x.shape[1]
    cfg_j = jgp.TrainConfigDevice(lr=7e-3, iters=15, clip_grad_value=1e-3)
    key = jax.random.PRNGKey(11)
    restarts = 2
    new_ref, losses_ref = jgp.train_hyperparams(params, bounds, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                                                key, cfg_j, restarts=restarts)
    tparams, tbounds = _port(params, bounds)
    new_out, losses_out = tgp.train_hyperparams(
        tparams, tbounds, _t(x), _t(y), _t(mask, torch.bool), None, tgp.TrainConfigDevice(*cfg_j),
        restarts=restarts, draws=_jax_draws(key, restarts, ns, d))
    assert _rel(losses_out.numpy(), losses_ref) <= 1e-9
    lo_hi = [(bounds.min_lengthscale, bounds.max_lengthscale), (bounds.min_outputscale, bounds.max_outputscale),
             (bounds.min_noise, bounds.max_noise)]
    for out, ref, (lo, hi) in zip(tgp.constrained_params(new_out, tbounds), jgp.constrained_params(new_ref, bounds),
                                  lo_hi):
        gap = np.abs(out.numpy() - np.asarray(ref)) / (np.asarray(hi) - np.asarray(lo))
        assert gap.max() <= 1e-7
    # the training moved the parameters: the comparison is not of two untouched inits
    assert not np.allclose(np.asarray(new_ref.raw_lengthscales), np.asarray(params.raw_lengthscales))

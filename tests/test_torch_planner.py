"""The port's mappers, L-BFGS-B and planner against the JAX package.

The same numpy inputs go to both packages. Float64 paths are held to 1e-9
(the same arithmetic in another order). The slice test runs a few
steady-state Planner.plan steps at a small size in f64 on both sides (the
JAX Planner keeps an f64 master under x64 and does not split it), and one
extend-and-plan step in f32 against the JAX build_extend_plan_fn on an f32
cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.controllers import lbfgs as jlbfgs
from gpmpc_tpu.controllers import planner as jplanner
from gpmpc_tpu.mappers import action as jaction
from gpmpc_tpu.mappers import reward as jreward
from gpmpc_tpu.models import gp as jgp
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.controllers import lbfgs as tlbfgs
from gpmpc_tpu_torch.controllers import planner as tplanner
from gpmpc_tpu_torch.mappers import action as taction
from gpmpc_tpu_torch.mappers import reward as treward

CPU = torch.device("cpu")
NS, NA = 3, 1
D = NS + NA


def _np(tree):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in tree._asdict().items()}


def _close(out, ref, rtol=1e-9):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _specs(nh, dtype, use_constraints=False, limit_action_change=False, clip=False):
    jr = jreward.RewardSpec(
        target_state_action_norm=jnp.asarray([1.0, 0.5, 0.5, 0.5], dtype),
        weight_matrix_cost=jnp.asarray(np.diag([1.0, 0.1, 0.1, 1e-3]), dtype),
        target_state_norm=jnp.asarray([1.0, 0.5, 0.5], dtype),
        weight_matrix_cost_terminal=jnp.asarray(np.diag([5.0, 2.0, 2.0]), dtype),
        use_constraints=use_constraints,
        state_min=jnp.asarray([0.1, 0.2, 0.1], dtype),
        state_max=jnp.asarray([0.9, 0.8, 0.95], dtype),
        area_multiplier=1.0, exploration_factor=1.0, clip_lower_bound_cost_to_0=clip,
    )
    ja = jaction.ActionMapperSpec(limit_action_change=limit_action_change,
                                  max_change_action_norm=jnp.asarray([0.3], dtype), len_horizon=nh, dim_action=NA)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tr = convert.reward_spec_from_numpy(**_np(jr), dtype=tdt, device=CPU)
    ta = convert.action_spec_from_numpy(**_np(ja), dtype=tdt, device=CPU)
    kw = dict(include_time_model=False, len_horizon=nh, dim_action=NA, dim_state=NS,
              maxiter=4, maxcor=4, maxls=4, maxfun=4)
    return jplanner.PlanSpec(reward=jr, action=ja, **kw), tplanner.PlanSpec(reward=tr, action=ta, **kw)


@pytest.mark.parametrize("use_constraints", [False, True])
def test_rewards_trajectory_matches_jax(use_constraints):
    rng = np.random.default_rng(0)
    jspec, tspec = _specs(5, np.float64, use_constraints=use_constraints)
    mus = rng.uniform(0, 1, (6, NS))
    a = rng.normal(0, 0.05, (6, NS, NS))
    vars_ = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(NS)
    acts = rng.uniform(0, 1, (5, NA))
    ref = jreward.rewards_trajectory(jspec.reward, jnp.asarray(mus), jnp.asarray(vars_), jnp.asarray(acts))
    out = treward.rewards_trajectory(tspec.reward, torch.tensor(mus), torch.tensor(vars_), torch.tensor(acts))
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("limit_action_change", [False, True])
def test_mpc_to_model_actions_matches_jax(limit_action_change):
    import jax

    rng = np.random.default_rng(1)
    jspec, tspec = _specs(6, np.float64, limit_action_change=limit_action_change)
    a = rng.uniform(0, 1, 6)
    prev = np.asarray([0.9])  # near the top: the cumsum clamps, the STE gradient passes
    w = rng.normal(0, 1, (6, NA))
    ref = jaction.mpc_to_model_actions(jspec.action, jnp.asarray(a), jnp.asarray(prev))
    g_ref = jax.grad(lambda z: jnp.sum(jaction.mpc_to_model_actions(jspec.action, z, jnp.asarray(prev)) * w))(
        jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    out = taction.mpc_to_model_actions(tspec.action, at, torch.tensor(prev))
    (g,) = torch.autograd.grad((out * torch.tensor(w)).sum(), at)
    _close(out, ref, rtol=1e-12)
    _close(g, g_ref, rtol=1e-12)


def _gp_problem(seed, n, bucket, dtype=np.float64):
    """Flagship GP parameters and bounds (bench.py) on n random points."""
    rng = np.random.default_rng(seed)
    bounds = jgp.GPBounds(
        min_lengthscale=jnp.full((NS, D), 4e-3, dtype), max_lengthscale=jnp.full((NS, D), 10.0, dtype),
        min_outputscale=jnp.full((NS,), 1e-2, dtype), max_outputscale=jnp.full((NS,), 0.95, dtype),
        min_noise=jnp.full((NS,), 1e-6, dtype), max_noise=jnp.full((NS,), 1e-4, dtype),
    )
    params = jgp.params_from_constrained(jnp.full((NS, D), 0.5, dtype), jnp.full((NS,), 5e-2, dtype),
                                         jnp.full((NS,), 1e-5, dtype), bounds)
    x = np.zeros((bucket, D))
    y = np.zeros((bucket, NS))
    mask = np.zeros(bucket, dtype=bool)
    x[:n] = rng.uniform(0, 1, (n, D))
    y[:n] = rng.normal(0, 0.02, (n, NS))
    mask[:n] = True
    extra = (rng.uniform(0, 1, (8, D)), rng.normal(0, 0.02, (8, NS)))
    state = (rng.uniform(0, 1, NS), np.eye(NS) * 1e-6, rng.uniform(0, 1, (1, 4 * NA)), np.asarray([0.5]))
    return params, bounds, x, y, mask, extra, state


def _objectives(nh, n, bucket):
    jspec, tspec = _specs(nh, np.float64)
    params, bounds, x, y, mask, _, (mu, var, inits, prev) = _gp_problem(3, n, bucket)
    jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    tc = convert.cache_from_numpy(**_np(jc), dtype=torch.float64, device=CPU)

    def jfun(a):
        return jplanner._objective_and_info(jspec, jc, a, jnp.asarray(mu), jnp.asarray(var), jnp.asarray(prev), 0)[0]

    def tfun(a):
        return tplanner._objective_and_info(tspec, tc, a, torch.tensor(mu), torch.tensor(var), torch.tensor(prev), 0)[0]

    return jfun, tfun, jspec


def _rosenbrock_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosenbrock_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


@pytest.mark.parametrize("case", ["mpc_objective", "rosenbrock_backtracking", "quad_bound_active"])
def test_lbfgs_b_grad_first_matches_jax(case):
    """The planner's objective (tests/test_lbfgs.py::_mpc_objective at a
    small size) with the pendulum budget, plus cases that drive the reject
    (backtracking) branch, the maxfun freeze and an active bound."""
    n = 6
    if case == "mpc_objective":
        n = 4
        jfun, tfun, spec = _objectives(n, 24, 32)
        kw = dict(maxiter=spec.maxiter, maxcor=spec.maxcor, maxls=spec.maxls, maxfun=spec.maxfun)
        x0 = np.random.default_rng(4).uniform(0, 1, n)
    elif case == "rosenbrock_backtracking":
        jfun, tfun = _rosenbrock_j, _rosenbrock_t
        kw = dict(maxiter=25, maxcor=6, maxls=6)
        x0 = np.zeros(n)
    else:
        def jfun(z):
            return jnp.sum((z - 2.0) ** 2)

        def tfun(z):
            return torch.sum((z - 2.0) ** 2)

        kw = dict(maxiter=10, maxcor=4, maxls=4, maxfun=6)
        x0 = np.full(n, 0.25)
    x_j, f_j = jlbfgs.lbfgs_b_minimize(jfun, jnp.asarray(x0), jnp.zeros(n), jnp.ones(n), keep_best=True,
                                       grad_first=True, **kw)
    x_t, f_t = tlbfgs.lbfgs_b_minimize(tfun, torch.tensor(x0), torch.zeros(n, dtype=torch.float64),
                                       torch.ones(n, dtype=torch.float64), **kw)
    _close(x_t, x_j)
    _close(f_t, f_j)


def _jax_planner_steps(jspec, params, bounds, x, y, mask, n, extra, state, steps):
    planner = jplanner.Planner(jspec)
    mu, var, inits, prev = (jnp.asarray(v) for v in state)
    planner.refresh_cache(x, y, mask, params, bounds)
    out = []
    for i in range(steps):
        x[n + i], y[n + i], mask[n + i] = extra[0][i], extra[1][i], True
        out.append(planner.plan(x, y, mask, params, bounds, mu, var, inits, prev, i))
    return out


def test_planner_steady_state_steps_match_jax_f64():
    """refresh_cache, then steady-state plans that each append one point
    (the extend-and-plan path) at a small size, f64 on both sides."""
    nh, n, bucket, steps = 4, 20, 32, 3
    jspec, tspec = _specs(nh, np.float64)
    params, bounds, x, y, mask, extra, state = _gp_problem(5, n, bucket)
    ref = _jax_planner_steps(jspec, params, bounds, x.copy(), y.copy(), mask.copy(), n, extra, state, steps)

    tparams = convert.gp_params_from_numpy(**_np(params), dtype=torch.float64, device=CPU)
    tbounds = convert.gp_bounds_from_numpy(**_np(bounds), dtype=torch.float64, device=CPU)
    planner = tplanner.Planner(tspec, dtype=torch.float64, device=CPU)
    mu, var, inits, prev = (torch.tensor(v) for v in state)
    planner.refresh_cache(x, y, mask, tparams, tbounds)
    for i in range(steps):
        x[n + i], y[n + i], mask[n + i] = extra[0][i], extra[1][i], True
        assert planner._cache_status(x, y, mask, tparams, tbounds)[4]  # extends, no refactorize
        a_opt, actions_model, info = planner.plan(x, y, mask, tparams, tbounds, mu, var, inits, prev, i)
        ja, jam, jinfo = ref[i]
        _close(a_opt, ja)
        _close(actions_model, jam)
        for o, r in zip(info, jinfo):
            _close(o, r)
        assert float(np.abs(np.asarray(ja) - state[2][0]).max()) > 1e-3  # the optimizer moved


def test_planner_refactorizes_when_params_change():
    nh, n, bucket = 4, 12, 16
    _, tspec = _specs(nh, np.float64)
    params, bounds, x, y, mask, extra, _ = _gp_problem(6, n, bucket)
    tparams = convert.gp_params_from_numpy(**_np(params), dtype=torch.float64, device=CPU)
    tbounds = convert.gp_bounds_from_numpy(**_np(bounds), dtype=torch.float64, device=CPU)
    planner = tplanner.Planner(tspec, dtype=torch.float64, device=CPU)
    planner.refresh_cache(x, y, mask, tparams, tbounds)
    x[n], y[n], mask[n] = extra[0][0], extra[1][0], True
    assert planner._cache_status(x, y, mask, tparams, tbounds)[4]
    swapped = tparams._replace(raw_noise=tparams.raw_noise + 0.0)
    assert not planner._cache_status(x, y, mask, swapped, tbounds)[4]
    cache = planner.refresh_cache(x, y, mask, swapped, tbounds)
    fresh = tplanner.masked_cholesky_factorize(swapped, tbounds, torch.tensor(x), torch.tensor(y), torch.tensor(mask))
    torch.testing.assert_close(cache.iK, fresh.iK)


def test_planner_refuses_unported_modes():
    """Dtypes other than f32 and f64 (the three regimes f32, f64 and mixed
    are supported on every device), and more than one restart."""
    _, tspec = _specs(4, np.float64)
    with pytest.raises(TypeError):
        tplanner.Planner(tspec, dtype=torch.float16, device="cuda")
    with pytest.raises(TypeError):
        tplanner.Planner(tspec, dtype=torch.float32, device="cuda", master_dtype=torch.bfloat16)
    params, bounds, x, y, mask, _, (mu, var, inits, prev) = _gp_problem(2, 8, 16)
    cache = convert.cache_from_numpy(
        **_np(jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))),
        dtype=torch.float64, device=CPU)
    two_inits = torch.tensor(np.concatenate([inits, inits]))
    with pytest.raises(NotImplementedError):
        tplanner._plan_from_cache(tspec, cache, torch.tensor(mu), torch.tensor(var), two_inits,
                                  torch.tensor(prev), 0)


def test_extend_plan_f32_matches_jax_f32_cache():
    """One f32 extend-and-plan step against JAX build_extend_plan_fn on an
    f32 cache (masked_cholesky_factorize(..., upcast=False)): both sides run
    pure f32, summing in different orders. At 20 well-conditioned points f32
    carries ~5 digits of the objective; a_opt and the info fields are held
    to 1e-4 relative to each field's largest entry."""
    nh, n, bucket = 4, 20, 32
    f32 = np.float32
    jspec, tspec = _specs(nh, f32)
    params, bounds, x, y, mask, extra, state = _gp_problem(7, n, bucket, dtype=f32)
    jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x, f32), jnp.asarray(y, f32), jnp.asarray(mask),
                                       upcast=False)
    assert jc.iK.dtype == jnp.float32
    mu, var, inits, prev = (v.astype(f32) for v in state)
    xn, yn = extra[0][0].astype(f32), extra[1][0].astype(f32)
    ref = jplanner.build_extend_plan_fn(jspec)(jc, jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(mu),
                                               jnp.asarray(var), jnp.asarray(inits), jnp.asarray(prev), 0)
    tc = convert.cache_from_numpy(**_np(jc), dtype=torch.float32, device=CPU)
    out = tplanner.extend_plan(tspec, tc, torch.tensor(xn), torch.tensor(yn), torch.tensor(mu), torch.tensor(var),
                               torch.tensor(inits), torch.tensor(prev), 0)
    _close(out[0].iK, ref[0].iK, rtol=1e-5)
    _close(out[1], ref[1], rtol=1e-4)
    for o, r in zip(out[3], ref[3]):
        _close(o, r, rtol=1e-4)


def test_f32_flagship_plan_is_nan_in_both_packages():
    """The f32 flagship planning step (bench.py: 300 points in the 384
    bucket, horizon 15) on an f32 cache (masked_cholesky_factorize(...,
    upcast=False), as the JAX bench runs with x64 off), JAX
    build_extend_plan_fn beside the port's f32 CPU extend_plan: the
    objective at the initial actions is NaN in both packages (the
    moment-matching contractions cancel below eps32, see
    tests/test_torch_gp.py), L-BFGS-B accepts no step, and both return the
    initial actions and a NaN TrajectoryInfo. This pins that the port's
    flagship step does the same work as the reference's."""
    from gpmpc_tpu_torch.flagship import flagship_problem

    f32 = np.float32
    prob = flagship_problem(CPU, torch.float64)
    jspec, tspec = _specs(prob.spec.len_horizon, f32)
    params = jgp.GPParams(**{k: jnp.asarray(v.numpy(), f32) for k, v in prob.params._asdict().items()})
    bounds = jgp.GPBounds(**{k: jnp.asarray(v.numpy(), f32) for k, v in prob.bounds._asdict().items()})
    jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(prob.x, f32), jnp.asarray(prob.y, f32),
                                       jnp.asarray(prob.mask), upcast=False)
    assert jc.iK.dtype == jnp.float32
    tc = convert.cache_from_numpy(**_np(jc), dtype=torch.float32, device=CPU)
    mu, var, inits, prev = (v.numpy().astype(f32) for v in (prob.state_mu, prob.state_var, prob.inits,
                                                             prob.action_prev))
    xn, yn = prob.extra_x[0].astype(f32), prob.extra_y[0].astype(f32)

    f_j = jplanner._objective_and_info(jspec, jc, jnp.asarray(inits[0]), jnp.asarray(mu), jnp.asarray(var),
                                       jnp.asarray(prev), 0)[0]
    f_t = tplanner._objective_and_info(tspec, tc, torch.tensor(inits[0]), torch.tensor(mu), torch.tensor(var),
                                       torch.tensor(prev), 0)[0]
    assert np.isnan(float(f_j)) and np.isnan(float(f_t))

    ref = jplanner.build_extend_plan_fn(jspec)(jc, jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(mu),
                                               jnp.asarray(var), jnp.asarray(inits), jnp.asarray(prev), 0)
    out = tplanner.extend_plan(tspec, tc, torch.tensor(xn), torch.tensor(yn), torch.tensor(mu), torch.tensor(var),
                               torch.tensor(inits), torch.tensor(prev), 0)
    np.testing.assert_array_equal(np.asarray(ref[1]), inits[0])
    np.testing.assert_array_equal(out[1].numpy(), inits[0])
    assert np.isnan(float(ref[3].mean_reward_ucb)) and np.isnan(float(out[3].mean_reward_ucb))

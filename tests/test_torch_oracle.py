"""The port's cost mapper, action mapper and GP math against the numpy float64
oracle (tests/oracle/np_oracle.py), as tests/test_cost_and_actions.py and
tests/test_gp_math.py hold the JAX package to it.

The same tolerances as there: the rewards within 1e-10 relative; the
factorizations and trajectories within 1e-8, one moment-matching step
within 1e-9 absolute; the MLL within 1e-9 relative. The reward cases also
run at the process-control widths (Ns = 2, Na = 2) with the example's
constraint box, and the derivative action mapper at Na = 2 with the
example's change limits; the trajectory also with the time model's raw
step index as the last input.
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.mappers.action import ActionMapperSpec, mpc_to_model_actions, ste_clamp
from gpmpc_tpu_torch.mappers.reward import RewardSpec, reward_single, reward_terminal, rewards_trajectory
from gpmpc_tpu_torch.models import gp as tgp
from tests.oracle import np_oracle
from tests.test_gp_math import D, NA, NS, make_problem

F64 = dict(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def make_spec(ns, na, use_constraints=False, area_multiplier=1.0):
    """tests/test_cost_and_actions.py's spec (Ns = 3, Na = 1), or the
    process-control example's weights and box (Ns = 2, Na = 2)."""
    if ns == 3:
        w_sa, target = np.array([1.0, 0.1, 0.1, 0.05]), np.array([1.0, 0.5, 0.5, 0.5])
        w_term, smin, smax = np.diag([5.0, 2.0, 2.0]), np.array([-0.1, 0.05, 0.05]), np.array([1.1, 0.95, 0.925])
    else:
        w_sa, target = np.array([1.0, 1.0, 1e-4, 1e-4]), np.array([0.5, 0.5, 0.0, 0.0])
        w_term, smin, smax = np.diag([1.0, 1.0]), np.array([0.1, 0.3]), np.array([0.9, 0.8])
    assert len(w_sa) == ns + na
    return RewardSpec(
        target_state_action_norm=_t(target), weight_matrix_cost=_t(np.diag(w_sa)), target_state_norm=_t(target[:ns]),
        weight_matrix_cost_terminal=_t(w_term), use_constraints=use_constraints, state_min=_t(smin),
        state_max=_t(smax), area_multiplier=area_multiplier, exploration_factor=1.0, clip_lower_bound_cost_to_0=False)


# (ns, na, use_constraints, area_multiplier): the JAX tests' two cases (the
# area multiplier must not change the penalty, as on the reference's live
# path), and the process-control widths with and without the box
REWARD_CASES = [(3, 1, False, 1.0), (3, 1, True, 7.0), (2, 2, False, 1.0), (2, 2, True, 1.0)]


@pytest.mark.parametrize("ns,na,use_constraints,area", REWARD_CASES,
                         ids=["pendulum", "pendulum-constraints", "process-control", "process-control-constraints"])
def test_reward_single_matches_oracle(rng, ns, na, use_constraints, area):
    spec = make_spec(ns, na, use_constraints, area)
    mu = rng.uniform(0, 1, ns)
    sv = rng.normal(0, 0.1, (ns, ns))
    var = sv @ sv.T * 0.01 if not use_constraints else np.diag(rng.uniform(1e-4, 1e-2, ns))
    a = rng.uniform(0, 1, na)
    r, rv = reward_single(spec, _t(mu)[None], _t(var)[None], _t(a)[None])
    r_ref, rv_ref = np_oracle.reward(mu, var, a, spec.target_state_action_norm.numpy(),
                                     spec.weight_matrix_cost.numpy(), use_constraints=use_constraints,
                                     state_min=spec.state_min.numpy(), state_max=spec.state_max.numpy())
    np.testing.assert_allclose(float(r[0]), r_ref, rtol=1e-10)
    np.testing.assert_allclose(float(rv[0]), rv_ref, rtol=1e-10)


@pytest.mark.parametrize("ns,na", [(3, 1), (2, 2)])
def test_reward_terminal_and_trajectory_match_oracle(rng, ns, na):
    """The terminal reward, and the trajectory's last element, which takes
    the terminal weights."""
    spec = make_spec(ns, na)
    mu = rng.uniform(0, 1, ns)
    var = np.diag(rng.uniform(1e-4, 1e-2, ns))
    r, rv = reward_terminal(spec, _t(mu), _t(var))
    r_ref, rv_ref = np_oracle.reward_terminal(mu, var, spec.target_state_norm.numpy(),
                                              spec.weight_matrix_cost_terminal.numpy())
    np.testing.assert_allclose(float(r), r_ref, rtol=1e-10)
    np.testing.assert_allclose(float(rv), rv_ref, rtol=1e-10)
    nh = 5
    mus = rng.uniform(0, 1, (nh + 1, ns))
    vars_ = np.stack([np.diag(rng.uniform(1e-4, 1e-2, ns)) for _ in range(nh + 1)])
    acts = rng.uniform(0, 1, (nh, na))
    r, rv = rewards_trajectory(spec, _t(mus), _t(vars_), _t(acts))
    assert r.shape == (nh + 1,) and rv.shape == (nh + 1,)
    r_term, _ = np_oracle.reward_terminal(mus[-1], vars_[-1], spec.target_state_norm.numpy(),
                                          spec.weight_matrix_cost_terminal.numpy())
    np.testing.assert_allclose(float(r[-1]), r_term, rtol=1e-10)
    for t in range(nh):
        r_ref, _ = np_oracle.reward(mus[t], vars_[t], acts[t], spec.target_state_action_norm.numpy(),
                                    spec.weight_matrix_cost.numpy())
        np.testing.assert_allclose(float(r[t]), r_ref, rtol=1e-10)


def test_ste_clamp_gradient_passthrough():
    """Clamp forward, identity backward."""
    x = torch.tensor([-0.5, 0.5, 1.5], requires_grad=True)
    (ste_clamp(x, 0.0, 1.0) * 3.0).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0, 3.0])


def test_normalization_action_mapping(rng):
    spec = ActionMapperSpec(limit_action_change=False, max_change_action_norm=_t([0.3]), len_horizon=4,
                            dim_action=1)
    flat = _t(rng.uniform(0, 1, 4))
    np.testing.assert_allclose(mpc_to_model_actions(spec, flat, _t([0.5])).numpy().ravel(), flat.numpy())


@pytest.mark.parametrize("mc,flat,prev,want", [
    ([0.3], [0.5, 1.0, 0.0], [0.4], [[0.4], [0.7], [0.4]]),  # deltas 0, +mc, -mc
    # the process-control example's limits at Na = 2: deltas (0, +0.2), (+0.1, -0.2), (-0.1, 0)
    ([0.1, 0.2], [0.5, 1.0, 1.0, 0.0, 0.0, 0.5], [0.3, 0.6], [[0.3, 0.8], [0.4, 0.6], [0.3, 0.6]]),
], ids=["na1", "na2"])
def test_derivative_action_mapping(mc, flat, prev, want):
    """Affine to [-mc, +mc], cumsum from the previous action, STE clamp."""
    na = len(mc)
    spec = ActionMapperSpec(limit_action_change=True, max_change_action_norm=_t(mc), len_horizon=len(flat) // na,
                            dim_action=na)
    out = mpc_to_model_actions(spec, _t(flat), _t(prev)).numpy()
    np.testing.assert_allclose(out, want, atol=1e-12)


def test_derivative_action_clamped_but_grad_flows():
    spec = ActionMapperSpec(limit_action_change=True, max_change_action_norm=_t([0.5]), len_horizon=2, dim_action=1)
    flat = _t([1.0, 1.0]).requires_grad_(True)  # pushes both steps past 1.0
    vals = mpc_to_model_actions(spec, flat, _t([0.9]))
    np.testing.assert_allclose(vals.detach().numpy().ravel(), [1.0, 1.0])
    vals.sum().backward()
    assert np.all(np.abs(flat.grad.numpy()) > 0)


# --- GP math (tests/test_gp_math.py's oracle cases) ---------------------------


def _port(params, bounds, x_pad, y_pad, mask):
    np_ = {k: np.asarray(v) for k, v in params._asdict().items()}
    nb = {k: np.asarray(v) for k, v in bounds._asdict().items()}
    return (convert.gp_params_from_numpy(**np_, **F64), convert.gp_bounds_from_numpy(**nb, **F64), _t(x_pad),
            _t(y_pad), torch.tensor(np.asarray(mask)))


@pytest.mark.parametrize("pad_to", [None, 40])
def test_factorizations_match_oracle(rng, pad_to):
    params, bounds, x, y, ls, outs, noise, x_pad, y_pad, mask = make_problem(rng, pad_to=pad_to)
    cache = tgp.masked_cholesky_factorize(*_port(params, bounds, x_pad, y_pad, mask))
    iK_ref, beta_ref = np_oracle.factorizations(x, y, ls, outs, noise)
    n = x.shape[0]
    np.testing.assert_allclose(cache.iK.numpy()[:, :n, :n], iK_ref, atol=1e-8)
    np.testing.assert_allclose(cache.beta.numpy()[:, :n], beta_ref, atol=1e-8)
    if pad_to is not None:  # the padding exactly zero
        assert np.all(cache.iK.numpy()[:, n:, :] == 0) and np.all(cache.beta.numpy()[:, n:] == 0)


@pytest.mark.parametrize("pad_to", [None, 40])
def test_moment_match_matches_oracle(rng, pad_to):
    params, bounds, x, y, ls, outs, noise, x_pad, y_pad, mask = make_problem(rng, pad_to=pad_to)
    cache = tgp.masked_cholesky_factorize(*_port(params, bounds, x_pad, y_pad, mask))
    input_mu = rng.uniform(0, 1, size=(D,))
    sv = rng.normal(0, 0.1, size=(NS, NS))
    input_var = np.zeros((D, D))
    input_var[:NS, :NS] = sv @ sv.T * 0.01
    M, S, V = tgp.moment_match(cache, _t(input_mu), _t(input_var))
    iK_ref, beta_ref = np_oracle.factorizations(x, y, ls, outs, noise)
    M_ref, S_ref, V_ref = np_oracle.moment_match(x, iK_ref, beta_ref, ls, outs, input_mu, input_var)
    for out, ref in ((M, M_ref), (S, S_ref), (V, V_ref)):
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-9)


@pytest.mark.parametrize("time_model", [False, True], ids=["plain", "time-feature"])
def test_trajectory_matches_oracle(rng, time_model):
    """A 6-step rollout; with the time model, the raw step index (not
    normalized) as the last input, from step 17, over stored points whose
    time column is 0..19 and a time lengthscale of 100."""
    if not time_model:
        params, bounds, x, y, ls, outs, noise, x_pad, y_pad, mask = make_problem(rng, pad_to=32)
        t0 = 0
    else:
        d, n = D + 1, 20
        x = rng.uniform(0, 1, (n, d))
        x[:, -1] = np.arange(n)
        y = rng.normal(0, 0.05, (n, NS))
        ls = np.concatenate([rng.uniform(0.3, 2.0, (NS, D)), np.full((NS, 1), 100.0)], axis=1)
        outs, noise = rng.uniform(0.02, 0.4, NS), rng.uniform(1e-5, 1e-3, NS)
        bounds = tgp.GPBounds(*(torch.full(shape, v, **F64) for shape, v in (
            ((NS, d), 1e-3), ((NS, d), 1e4), ((NS,), 1e-6), ((NS,), 2.0), ((NS,), 1e-7), ((NS,), 1.0))))
        params = tgp.params_from_constrained(_t(ls), _t(outs), _t(noise), bounds)
        x_pad, y_pad, mask, t0 = x, y, np.ones(n, bool), 17
    if time_model:
        cache = tgp.masked_cholesky_factorize(params, bounds, _t(x_pad), _t(y_pad), torch.tensor(mask))
    else:
        cache = tgp.masked_cholesky_factorize(*_port(params, bounds, x_pad, y_pad, mask))
    nh = 6
    actions = rng.uniform(0, 1, (nh, NA))
    state_mu = rng.uniform(0, 1, NS)
    state_var = np.diag(rng.uniform(1e-6, 1e-4, NS))
    mus, vars_ = tgp.predict_trajectory(cache, _t(actions), _t(state_mu), _t(state_var), t0, time_model)
    iK_ref, beta_ref = np_oracle.factorizations(x, y, ls, outs, noise)
    mus_ref, vars_ref = np_oracle.predict_trajectory(x, iK_ref, beta_ref, ls, outs, actions, state_mu, state_var,
                                                     current_time_idx=t0, include_time_model=time_model)
    np.testing.assert_allclose(mus.numpy(), mus_ref, atol=1e-8)
    np.testing.assert_allclose(vars_.numpy(), vars_ref, atol=1e-8)


def test_negative_mll_matches_oracle(rng):
    params, bounds, x, y, ls, outs, noise, x_pad, y_pad, mask = make_problem(rng, pad_to=40)
    losses = tgp.negative_mll(*_port(params, bounds, x_pad, y_pad, mask))
    for m in range(NS):
        np.testing.assert_allclose(float(losses[m]), np_oracle.negative_mll(x, y[:, m], ls[m], outs[m], noise[m]),
                                   rtol=1e-9)

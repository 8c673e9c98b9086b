"""The port's GP math (gpmpc_tpu_torch.models.gp) against the JAX package.

Float64 on both sides from the same numpy problem (make_problem of
tests/test_gp_math.py, with padding); the two implementations do the same
arithmetic in a different order, so they agree to ~1e-12 relative and are
held to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.models import gp as jgp
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.models import gp as tgp
from tests.test_gp_math import make_problem

RTOL = 1e-9
CPU = torch.device("cpu")


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _torch_problem(params, bounds, x_pad, y_pad, mask):
    tp = convert.gp_params_from_numpy(**_np(params), dtype=torch.float64, device=CPU)
    tb = convert.gp_bounds_from_numpy(**_np(bounds), dtype=torch.float64, device=CPU)
    return tp, tb, torch.tensor(x_pad), torch.tensor(y_pad), torch.tensor(mask)


def _assert_cache_close(tc, jc, rtol=RTOL):
    for name in jgp.FactorizationCache._fields:
        ref = np.asarray(getattr(jc, name))
        out = getattr(tc, name).numpy()
        if ref.dtype == bool:
            np.testing.assert_array_equal(out, ref, err_msg=name)
        else:
            np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max(), err_msg=name)


def test_constrain_roundtrip_matches_jax():
    params, bounds, _, _, ls, outs, noise, *_ = make_problem(np.random.default_rng(0))
    tp, tb, *_ = _torch_problem(params, bounds, np.zeros((1, 4)), np.zeros((1, 3)), np.ones(1, bool))
    for out, ref, want in zip(tgp.constrained_params(tp, tb), jgp.constrained_params(params, bounds),
                              (ls, outs, noise)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-9)
    again = tgp.params_from_constrained(*(torch.tensor(v) for v in (ls, outs, noise)), tb)
    for out, ref in zip(again, params):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-9)


@pytest.mark.parametrize("pad_to", [None, 40])
def test_masked_cholesky_factorize_matches_jax(pad_to):
    params, bounds, x, y, *_, x_pad, y_pad, mask = make_problem(np.random.default_rng(1), pad_to=pad_to)
    jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x_pad), jnp.asarray(y_pad), jnp.asarray(mask))
    tc = tgp.masked_cholesky_factorize(*_torch_problem(params, bounds, x_pad, y_pad, mask))
    _assert_cache_close(tc, jc)
    if pad_to is not None:  # padding invariant: zero iK and beta, unit diagonal of L
        n = x.shape[0]
        assert torch.all(tc.iK[:, n:, :] == 0) and torch.all(tc.iK[:, :, n:] == 0)
        assert torch.all(tc.beta[:, n:] == 0)
        assert torch.all(torch.diagonal(tc.L, dim1=-2, dim2=-1)[:, n:] == 1)


def test_extend_factorization_matches_jax_over_several_appends():
    rng = np.random.default_rng(2)
    params, bounds, x, y, *_, x_pad, y_pad, mask = make_problem(rng, n=20, pad_to=32)
    jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x_pad), jnp.asarray(y_pad), jnp.asarray(mask))
    tc = tgp.masked_cholesky_factorize(*_torch_problem(params, bounds, x_pad, y_pad, mask))
    new_x = rng.uniform(0, 1, (5, 4))
    new_y = rng.normal(0, 0.05, (5, 3))
    for xn, yn in zip(new_x, new_y):
        jc = jgp.extend_factorization(jc, jnp.asarray(xn), jnp.asarray(yn))
        tc = tgp.extend_factorization(tc, torch.tensor(xn), torch.tensor(yn))
    _assert_cache_close(tc, jc)
    # and against a fresh factorization of the grown memory
    x_pad[20:25], y_pad[20:25], mask[20:25] = new_x, new_y, True
    fresh = tgp.masked_cholesky_factorize(*_torch_problem(params, bounds, x_pad, y_pad, mask))
    np.testing.assert_allclose(tc.beta.numpy(), fresh.beta.numpy(), rtol=1e-6, atol=1e-6 * float(fresh.beta.abs().max()))


def _cache_pair(seed, pad_to=40):
    params, bounds, *_, x_pad, y_pad, mask = make_problem(np.random.default_rng(seed), pad_to=pad_to)
    jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x_pad), jnp.asarray(y_pad), jnp.asarray(mask))
    return jc, convert.cache_from_numpy(**_np(jc), dtype=torch.float64, device=CPU)


def test_small_spd_inv_det_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (5, 3, 3))
    m = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)
    inv_j, det_j = jgp._small_spd_inv_det(jnp.asarray(m))
    inv_t, det_t = tgp._small_spd_inv_det(torch.tensor(m))
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-12)
    np.testing.assert_allclose(det_t.numpy(), np.asarray(det_j), rtol=1e-12)
    np.testing.assert_allclose(inv_t.numpy(), np.linalg.inv(m), rtol=1e-9)


def test_moment_match_matches_jax():
    jc, tc = _cache_pair(4)
    rng = np.random.default_rng(5)
    mu = rng.uniform(0, 1, 4)
    a = rng.normal(0, 0.05, (3, 3))
    var = np.zeros((4, 4))
    var[:3, :3] = a @ a.T + 1e-4 * np.eye(3)
    ref = jgp.moment_match(jc, jnp.asarray(mu), jnp.asarray(var))
    out = tgp.moment_match(tc, torch.tensor(mu), torch.tensor(var))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL, atol=RTOL * np.abs(r).max())


@pytest.mark.parametrize("include_time_model", [False, True])
def test_predict_trajectory_matches_jax(include_time_model):
    jc, tc = _cache_pair(6)
    if include_time_model:  # a fifth input column: the time index
        params, bounds, *_, x_pad, y_pad, mask = make_problem(np.random.default_rng(6), d=5, pad_to=40)
        jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x_pad), jnp.asarray(y_pad), jnp.asarray(mask))
        tc = convert.cache_from_numpy(**_np(jc), dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(7)
    actions = rng.uniform(0, 1, (6, 1))
    mu0 = rng.uniform(0, 1, 3)
    var0 = np.eye(3) * 1e-4
    ref = jgp.predict_trajectory(jc, jnp.asarray(actions), jnp.asarray(mu0), jnp.asarray(var0), 3, include_time_model)
    out = tgp.predict_trajectory(tc, torch.tensor(actions), torch.tensor(mu0), torch.tensor(var0), 3,
                                 include_time_model)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL, atol=RTOL * np.abs(r).max())


def test_f32_flagship_moment_match_fails_in_both_packages():
    """Pins a fault of the reference (ROADMAP queue C): at the bench.py
    flagship (300 random-target points in the 384 bucket, lengthscale 0.5,
    noise 1e-5) |beta| exceeds 1e3 and the cov-core contractions cancel far
    below eps32, so ONE f32 moment-matching step already predicts a wrong
    (negative) variance, in the JAX package as in the port. In f64 the two
    agree, but only to ~3e-5: the same cancellation costs f64 about eleven
    of its sixteen digits."""
    from gpmpc_tpu_torch.flagship import flagship_problem

    prob = flagship_problem(CPU, torch.float64)
    params = {k: v.numpy() for k, v in prob.params._asdict().items()}
    bounds = {k: v.numpy() for k, v in prob.bounds._asdict().items()}
    mu = np.concatenate([prob.state_mu.numpy(), prob.inits[0, :1].numpy()])
    var = np.zeros((4, 4))
    var[:3, :3] = prob.state_var.numpy()

    def jax_var(dtype):
        jc = jgp.masked_cholesky_factorize(
            jgp.GPParams(**{k: jnp.asarray(v, dtype) for k, v in params.items()}),
            jgp.GPBounds(**{k: jnp.asarray(v, dtype) for k, v in bounds.items()}),
            jnp.asarray(prob.x, dtype), jnp.asarray(prob.y, dtype), jnp.asarray(prob.mask))
        return np.diag(np.asarray(jgp.moment_match(jc, jnp.asarray(mu, dtype), jnp.asarray(var, dtype))[1]))

    def port_var(dtype):
        tc = tgp.masked_cholesky_factorize(
            convert.gp_params_from_numpy(**params, dtype=dtype, device=CPU),
            convert.gp_bounds_from_numpy(**bounds, dtype=dtype, device=CPU),
            torch.tensor(prob.x, dtype=dtype), torch.tensor(prob.y, dtype=dtype), torch.tensor(prob.mask))
        assert float(tc.beta.abs().max()) > 1e3
        return torch.diagonal(tgp.moment_match(tc, torch.tensor(mu, dtype=dtype),
                                               torch.tensor(var, dtype=dtype))[1]).numpy()

    v64 = port_var(torch.float64)
    np.testing.assert_allclose(v64, jax_var(np.float64), rtol=1e-4)
    assert np.all((v64 > 0) & (v64 < 1e-4)), v64
    for v32 in (jax_var(np.float32), port_var(torch.float32)):
        assert np.max(np.abs(v32 - v64) / v64) > 10.0, (v32, v64)
        assert np.min(v32) < 0, v32

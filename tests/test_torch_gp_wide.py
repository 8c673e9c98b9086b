"""Moment matching past the unrolled Cholesky's limit (ns > 8), port against JAX.

Both packages unroll the small SPD solves of ``moment_match`` up to
``_UNROLL_MAX_DIM`` = 8 state dims and take a Cholesky factorization and
solve past it, which gives NaN where B_ss or A_ss is not positive definite
(the unrolled form's pivot guard keeps such an input finite). Float64 from
the same numpy problem at ns = 9 (D = 10, N = 24), held to 1e-9 as
tests/test_torch_gp.py holds the narrow widths.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gpmpc_tpu.models import gp as jgp
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.models import gp as tgp
from tests.test_gp_math import make_problem

RTOL = 1e-9
NS, D, N = 9, 10, 24


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _cache_pair():
    params, bounds, *_, x_pad, y_pad, mask = make_problem(np.random.default_rng(9), n=N, ns=NS, d=D)
    jc = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x_pad), jnp.asarray(y_pad), jnp.asarray(mask))
    return jc, convert.cache_from_numpy(**_np(jc), dtype=torch.float64, device=torch.device("cpu"))


def _close(out, ref):
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL, atol=RTOL * np.abs(r).max())


def test_wide_state_limit_matches_jax():
    assert tgp._UNROLL_MAX_DIM == jgp._UNROLL_MAX_DIM == 8
    assert NS > tgp._UNROLL_MAX_DIM


def test_moment_match_past_the_unroll_limit_matches_jax():
    jc, tc = _cache_pair()
    rng = np.random.default_rng(10)
    mu = rng.uniform(0, 1, D)
    a = rng.normal(0, 0.05, (NS, NS))
    var = np.zeros((D, D))
    var[:NS, :NS] = a @ a.T + 1e-4 * np.eye(NS)
    _close(tgp.moment_match(tc, torch.tensor(mu), torch.tensor(var)),
           jgp.moment_match(jc, jnp.asarray(mu), jnp.asarray(var)))


def test_predict_trajectory_past_the_unroll_limit_matches_jax():
    jc, tc = _cache_pair()
    rng = np.random.default_rng(11)
    actions = rng.uniform(0, 1, (3, D - NS))
    mu0 = rng.uniform(0, 1, NS)
    var0 = np.eye(NS) * 1e-4
    _close(tgp.predict_trajectory(tc, torch.tensor(actions), torch.tensor(mu0), torch.tensor(var0), 0, False),
           jgp.predict_trajectory(jc, jnp.asarray(actions), jnp.asarray(mu0), jnp.asarray(var0), 0, False))


def test_indefinite_input_is_nan_in_both_packages():
    """An input covariance that makes B_ss = iL S iL + I indefinite (S = -10 I
    against lengthscales of 0.3 to 2): NaN in both, in the same places."""
    jc, tc = _cache_pair()
    mu = np.random.default_rng(12).uniform(0, 1, D)
    var = np.zeros((D, D))
    var[:NS, :NS] = -10.0 * np.eye(NS)
    out = tgp.moment_match(tc, torch.tensor(mu), torch.tensor(var))
    ref = jgp.moment_match(jc, jnp.asarray(mu), jnp.asarray(var))
    assert np.isnan(out[0].numpy()).all() and np.isnan(np.asarray(ref[0])).all()
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(np.isnan(o.numpy()), np.isnan(np.asarray(r)))

"""tests/test_df32.py's ``test_rollout_df_matches_f64`` on the port: the
15-step double-float32 rollout (an f64 master split into the df32 cache)
against the f64 rollout of the same cache, on the ill-conditioned state of
the f32 failure regime (a pendulum random-action memory of 150 points with
sharpened hyperparameters, noise 1e-6: |beta| > 50), within the JAX test's
bounds: 5e-4 on the means, 5e-3 on the covariances. Port against port on
the CPU (the df32 path's plain twins). The f64 side is held to JAX's f64
``predict_trajectory`` on JAX's own build of the same cache (one small
compile), so a fault shared by both port paths cannot pass.
"""

import numpy as np
import torch

from gpmpc_tpu_torch.envs import PendulumEnv
from gpmpc_tpu_torch.models import gp as tgp

F64 = dict(dtype=torch.float64)
MU0, V0 = np.array([0.55, 0.48, 0.52]), np.eye(3) * 1e-6


def _actions():
    return np.random.default_rng(1).uniform(0, 1, (15, 1)).astype(np.float32)


def _ill_conditioned_state(noise_val=1e-6, n=150):
    """tests/test_df32.py's ``_ill_conditioned_state`` built with the port."""
    env = PendulumEnv(seed=0)
    obs = env.reset()
    lo, hi = env.observation_space.low, env.observation_space.high
    rng = np.random.default_rng(0)
    rows, ys = [], []
    for _ in range(n):
        a = rng.uniform(-2, 2, 1)
        s = (obs - lo) / (hi - lo)
        obs2, _, _, _ = env.step(a)
        rows.append(np.concatenate([s, (a + 2) / 4]))
        ys.append((obs2 - lo) / (hi - lo) - s)
        obs = obs2
    x, y = torch.tensor(np.array(rows)), torch.tensor(np.array(ys))
    ns, d = 3, x.shape[1]
    bounds = tgp.GPBounds(torch.full((ns, d), 4e-3, **F64), torch.full((ns, d), 10.0, **F64),
                          torch.full((ns,), 1e-3, **F64), torch.full((ns,), 0.95, **F64),
                          torch.full((ns,), 1e-7, **F64), torch.full((ns,), 1e-3, **F64))
    params = tgp.params_from_constrained(torch.tensor([[0.25, 0.3, 0.35, 0.6]] * ns, **F64),
                                         torch.full((ns,), 5e-2, **F64), torch.full((ns,), noise_val, **F64), bounds)
    return tgp.masked_cholesky_factorize(params, bounds, x, y, torch.ones(n, dtype=torch.bool))


def test_rollout_df_matches_f64():
    cache64 = _ill_conditioned_state()
    assert float(cache64.beta.abs().max()) > 50  # genuinely ill-conditioned
    dfc = tgp.split_cache_df(cache64)
    actions = torch.tensor(_actions())
    mu0, v0 = torch.tensor(MU0), torch.tensor(V0)
    with torch.no_grad():
        mus64, vars64 = tgp.predict_trajectory(cache64, actions.double(), mu0, v0, 0, False)
        musdf, varsdf = tgp.predict_trajectory(dfc, actions, mu0.float(), v0.float(), 0, False)
    assert musdf.dtype == torch.float32 and musdf.shape == (16, 3)
    assert float((musdf - mus64.float()).abs().max()) < 5e-4
    assert float((varsdf - vars64.float()).abs().max()) < 5e-3


def test_f64_rollout_matches_jax():
    """The port's f64 side of the test above against JAX's f64 rollout of
    tests/test_df32.py's cache (the same memory, built by the JAX package):
    within 1e-9 (measured 4.5e-13 on the means, 7.5e-13 on the covariances)."""
    import jax
    import jax.numpy as jnp

    from gpmpc_tpu.models.gp import predict_trajectory
    from tests.test_df32 import _ill_conditioned_state as jax_ill_conditioned_state

    jcache, _, _ = jax_ill_conditioned_state()
    actions = _actions()
    ref = jax.jit(lambda: predict_trajectory(jcache, jnp.asarray(actions, jnp.float64), jnp.asarray(MU0),
                                             jnp.asarray(V0), 0, False))()
    with torch.no_grad():
        out = tgp.predict_trajectory(_ill_conditioned_state(), torch.tensor(actions).double(), torch.tensor(MU0),
                                     torch.tensor(V0), 0, False)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-9)

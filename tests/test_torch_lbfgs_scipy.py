"""The port's L-BFGS-B against SciPy's, as tests/test_lbfgs.py holds the JAX
package's (its ``test_box_constrained_matches_scipy`` and
``test_mpc_objective_parity_with_scipy``), on the CPU in f64. No JAX.

* An interior optimum in the box [0, 1]^6: the port's point within 1e-4 of
  SciPy's.
* The full MPC objective at the reference's pendulum budget (maxiter =
  maxcor = maxls = maxfun = 4, bounds [0, 1]) from the same init: both
  improve on it, and the port's improvement is at least 0.9 of SciPy's.
"""

import numpy as np
import torch
from scipy.optimize import minimize as scipy_minimize

from gpmpc_tpu_torch.controllers.lbfgs import lbfgs_b_minimize
from gpmpc_tpu_torch.controllers.planner import PlanSpec, _objective_and_info
from gpmpc_tpu_torch.mappers.action import ActionMapperSpec
from gpmpc_tpu_torch.mappers.reward import RewardSpec
from gpmpc_tpu_torch.models import gp as tgp

F64 = dict(dtype=torch.float64)


def quad(x):
    return ((x - 0.3) ** 2).sum() + 0.5 * (x[:-1] * x[1:]).sum()


def _value_and_grad(fun):
    def fj(z):
        x = torch.tensor(z, **F64, requires_grad=True)
        f = fun(x)
        (g,) = torch.autograd.grad(f, x)
        return float(f.detach()), g.numpy()

    return fj


def test_box_constrained_matches_scipy():
    """Interior solution: projected L-BFGS finds SciPy L-BFGS-B's optimum."""
    n = 6
    x0 = np.full(n, 0.5)
    ref = scipy_minimize(_value_and_grad(quad), x0, jac=True, method="L-BFGS-B", bounds=[(0, 1)] * n)
    x, _ = lbfgs_b_minimize(quad, torch.tensor(x0, **F64), torch.zeros(n, **F64), torch.ones(n, **F64), maxiter=60,
                            maxcor=10, maxls=20)
    np.testing.assert_allclose(x.numpy(), ref.x, atol=1e-4)


def _mpc_objective():
    """tests/test_lbfgs.py's problem: Ns = 3, Na = 1, horizon 15, 64 random
    stored points, the reference's pendulum budget of 4."""
    rng = np.random.default_rng(7)
    ns, na, nh, n, budget = 3, 1, 15, 64, 4
    w, target, w_term = [1.0, 0.1, 0.1, 1e-3], [1.0, 0.5, 0.5, 0.5], [5.0, 2.0, 2.0]
    d = ns + na
    reward = RewardSpec(
        target_state_action_norm=torch.tensor(target, **F64), weight_matrix_cost=torch.diag(torch.tensor(w, **F64)),
        target_state_norm=torch.tensor(target[:ns], **F64), weight_matrix_cost_terminal=torch.diag(
            torch.tensor(w_term, **F64)), use_constraints=False, state_min=torch.zeros(ns, **F64),
        state_max=torch.ones(ns, **F64), area_multiplier=1.0, exploration_factor=1.0,
        clip_lower_bound_cost_to_0=False)
    action = ActionMapperSpec(limit_action_change=False, max_change_action_norm=torch.full((na,), 0.3, **F64),
                              len_horizon=nh, dim_action=na)
    spec = PlanSpec(reward=reward, action=action, include_time_model=False, len_horizon=nh,
                    dim_action=na, dim_state=ns, maxiter=budget, maxcor=budget, maxls=budget, maxfun=budget)
    bounds = tgp.GPBounds(torch.full((ns, d), 4e-3, **F64), torch.full((ns, d), 10.0, **F64),
                          torch.full((ns,), 1e-2, **F64), torch.full((ns,), 0.95, **F64),
                          torch.full((ns,), 1e-6, **F64), torch.full((ns,), 1e-4, **F64))
    params = tgp.params_from_constrained(torch.full((ns, d), 0.5, **F64), torch.full((ns,), 5e-2, **F64),
                                         torch.full((ns,), 1e-5, **F64), bounds)
    x = rng.uniform(0, 1, (n, d))
    cache = tgp.masked_cholesky_factorize(params, bounds, torch.tensor(x), torch.tensor(rng.normal(0, 0.02, (n, ns))),
                                          torch.ones(n, dtype=torch.bool))
    state_mu = torch.tensor(rng.uniform(0, 1, ns))
    state_var = torch.eye(ns, **F64) * 1e-6
    action_prev = torch.full((na,), 0.5, **F64)

    def objective(a):
        return _objective_and_info(spec, cache, a, state_mu, state_var, action_prev, 0)[0]

    return objective, rng.uniform(0, 1, nh * na), spec


def test_mpc_objective_parity_with_scipy():
    objective, x0, spec = _mpc_objective()
    n = len(x0)
    ref = scipy_minimize(_value_and_grad(objective), x0, jac=True, method="L-BFGS-B", bounds=[(0, 1)] * n,
                         options={"maxiter": spec.maxiter, "maxcor": spec.maxcor, "maxls": spec.maxls,
                                  "maxfun": spec.maxfun})
    _, f_ours = lbfgs_b_minimize(objective, torch.tensor(x0, **F64), torch.zeros(n, **F64), torch.ones(n, **F64),
                                 maxiter=spec.maxiter, maxcor=spec.maxcor, maxls=spec.maxls, maxfun=spec.maxfun)
    with torch.no_grad():
        f0 = float(objective(torch.tensor(x0, **F64)))
    assert float(f_ours) < f0 and ref.fun < f0  # both improved on the init
    assert f0 - float(f_ours) > 0.9 * (f0 - float(ref.fun))  # within 10 % of SciPy's improvement


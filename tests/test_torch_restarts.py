"""Multi-restart planning in the port against the JAX package, on the CPU in f64.

The JAX planner optimizes R restarts in one vmapped program; the port runs
them one after another (controllers/planner.py). One JAX program serves
several cases here, so that its compile is paid once: the mountain-car
example's controller (its configuration at horizon 3, two restarts) runs a
``run_env`` episode on both sides, and its jitted cached plan and cached
evaluation are then reused on that episode's memory.

* The two-restart mountain-car episode: the costs of both sides within TOL.
  The example's training_frequency (60) is past the episode, so no training
  fires and both plan with the initial parameters.
* R = 2 and R = 3 restarts on the episode's factorization cache: a_opt,
  actions_model and TrajectoryInfo within TOL of JAX's vmapped plan
  (``build_cached_plan_fn``), each restart's objective within TOL of JAX's
  objective at that restart's point, and JAX's a_opt is the point of the
  restart the port chose (the restarts end TOL-distinct).
* The restart selection's NaN rule against the JAX formula, and in a plan.
* tests/test_lbfgs.py::test_vmap_restarts on the port: a loop of
  ``lbfgs_b_minimize`` against JAX's vmap of it.

TOL = 1e-9: the same f64 arithmetic in another order (measured gaps 6e-17
in the episode's costs, 2e-16 in a_opt and 9e-16 in TrajectoryInfo), while a
wrong restart or a different line search shows at 1e-3 or more.
"""

import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.controllers import planner as jplanner
from gpmpc_tpu.controllers.lbfgs import lbfgs_b_minimize as jlbfgs_b_minimize
from gpmpc_tpu.envs import MountainCarContinuousEnv as JaxMountainCar
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.controllers import planner as tplanner
from gpmpc_tpu_torch.controllers.lbfgs import lbfgs_b_minimize
from gpmpc_tpu_torch.envs import MountainCarContinuousEnv
from gpmpc_tpu_torch.example_configs import mountain_car_config

# the runner modules (each package's ``runner.run_env`` attribute is the function)
jrun = importlib.import_module("gpmpc_tpu.runner.run_env")
trun = importlib.import_module("gpmpc_tpu_torch.runner.run_env")
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9
# a converged L-BFGS point is fixed by its objective only to about
# sqrt(eps64) ~ 1.5e-8 (the objective changes by eps64 there)
CONVERGED_XTOL = 1e-7
CPU = torch.device("cpu")
HORIZON, WARMUP, STEPS = 3, 10, 16  # plans at steps 10 and 15 (repeat 5)


def _jax_config():
    spec = importlib.util.spec_from_file_location("config_mountaincar",
                                                  ROOT / "examples/mountain_car/config_mountaincar.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.get_config(len_horizon=HORIZON)


def _recording(module, monkeypatch):
    """Record the controllers ``module``'s run_env builds."""
    made = []

    class Recorded(module.GpMpcController):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(module, "GpMpcController", Recorded)
    return made


@pytest.fixture(scope="module")
def episode():
    """Both sides' mountain-car episodes: (JAX costs, port costs, JAX
    controller, port controller)."""
    with pytest.MonkeyPatch.context() as mp:
        jmade, tmade = _recording(jrun, mp), _recording(trun, mp)
        jcosts = jrun.run_env(JaxMountainCar(seed=0), _jax_config(), None, random_actions_init=WARMUP,
                              num_steps=STEPS, verbose=False)
        tcosts = trun.run_env(MountainCarContinuousEnv(seed=0), mountain_car_config(len_horizon=HORIZON), None,
                              random_actions_init=WARMUP, num_steps=STEPS, verbose=False, device="cpu")
    return jcosts, tcosts, jmade[0], tmade[0]


def test_mountain_car_episode_matches_jax(episode):
    jcosts, tcosts, jctrl, tctrl = episode
    assert len(tcosts) == STEPS and np.all(np.isfinite(tcosts))
    np.testing.assert_allclose(tcosts, jcosts, rtol=0, atol=TOL)
    assert tctrl.config.controller.restarts_optim == 2
    assert len(tctrl.info_iters["cost"]) == len(jctrl.info_iters["cost"]) == STEPS // 5 + 1
    # no training fired on either side
    assert tctrl._last_train_losses is None and tctrl._pending_train is None
    assert jctrl._pending_train is None
    assert np.array_equal(jctrl.memory.get_padded()[0], tctrl.memory.get_padded()[0])


def _plan_inputs(jctrl, restarts):
    x_pad, y_pad, mask, _ = jctrl.memory.get_padded()
    assert x_pad.shape[0] == 32
    n = int(mask.sum())
    rng = np.random.default_rng(restarts)
    ns = jctrl.dim_state
    return dict(x_pad=x_pad, y_pad=y_pad, mask=mask, state_mu=np.array(x_pad[n - 1, :ns]),
                state_var=np.eye(ns) * 1e-6, inits=rng.uniform(size=(restarts, HORIZON * jctrl.dim_action)),
                action_prev=np.array([0.5]))


def _record_restarts(monkeypatch):
    """Each restart's (x, f) and the chosen restart of the port's plans."""
    seen = {"restarts": [], "chosen": []}
    minimize, select = tplanner.lbfgs_b_minimize, tplanner._select_restart

    def recorded_minimize(*args, **kwargs):
        out = minimize(*args, **kwargs)
        seen["restarts"].append(out)
        return out

    def recorded_select(fs):
        seen["chosen"].append(select(fs))
        return seen["chosen"][-1]

    monkeypatch.setattr(tplanner, "lbfgs_b_minimize", recorded_minimize)
    monkeypatch.setattr(tplanner, "_select_restart", recorded_select)
    return seen


def _close(out, ref, what):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(out - ref).max()) <= TOL * max(scale, 1.0), what


@pytest.mark.parametrize("restarts", [2, 3])
def test_restart_plan_matches_jax_vmap(episode, restarts, monkeypatch):
    _, _, jctrl, tctrl = episode
    p = _plan_inputs(jctrl, restarts)
    jcache = jplanner._factorize_jit(jctrl.gp_params, jctrl.bounds, jnp.asarray(p["x_pad"]), jnp.asarray(p["y_pad"]),
                                     jnp.asarray(p["mask"]), upcast=True)
    jargs = [jnp.asarray(p[k]) for k in ("state_mu", "state_var")]
    ja, jam, jinfo = jctrl.planner._plan_cached(jcache, *jargs, jnp.asarray(p["inits"]), jnp.asarray(p["action_prev"]),
                                                WARMUP)

    seen = _record_restarts(monkeypatch)
    tcache = convert.cache_from_numpy(**{k: np.asarray(v) for k, v in jcache._asdict().items()},
                                      dtype=torch.float64, device=CPU)
    targs = [torch.tensor(p[k]) for k in ("state_mu", "state_var", "inits", "action_prev")]
    ta, tam, tinfo = tplanner._plan_from_cache(tctrl.plan_spec, tcache, *targs, WARMUP)
    _close(ta, ja, "a_opt")
    _close(tam, jam, "actions_model")
    for name, o, r in zip(tinfo._fields, tinfo, jinfo):
        _close(o, r, name)

    xs = [x.numpy() for x, _ in seen["restarts"]]
    assert len(xs) == restarts and len(seen["chosen"]) == 1
    # JAX's a_opt is the point of exactly the restart the port chose
    gaps = [float(np.abs(x - np.asarray(ja)).max()) for x in xs]
    assert [g <= TOL for g in gaps] == [r == seen["chosen"][0] for r in range(restarts)], gaps
    # each restart's objective is JAX's objective at its point
    for x, f in seen["restarts"]:
        _, info = jctrl.planner._eval_cached(jcache, *jargs, jnp.asarray(x.numpy()), jnp.asarray(p["action_prev"]),
                                             WARMUP)
        assert abs(float(f) + float(info.mean_reward_ucb)) <= TOL * max(abs(float(f)), 1.0)
    fs = [float(f) for _, f in seen["restarts"]]
    assert seen["chosen"][0] == int(np.argmin(fs))


def _jax_select(fs):
    """The JAX planner's restart selection (gpmpc_tpu/controllers/planner.py)."""
    fs = jnp.asarray(fs)
    fs_safe = jnp.where(jnp.isnan(fs), jnp.inf, fs)
    return int(jnp.where(jnp.all(jnp.isnan(fs)), 0, jnp.argmin(fs_safe)))


@pytest.mark.parametrize("fs", [[1.0, np.nan], [np.nan, 2.0], [np.nan, np.nan], [np.nan, np.nan, np.nan],
                                [3.0, 1.0, np.nan], [2.0, 2.0], [np.inf, np.nan], [np.nan, -1.0, -1.0]])
def test_select_restart_nan_rule(fs):
    """The least objective, NaN as +inf, the first on ties and when all are
    NaN."""
    assert tplanner._select_restart(torch.tensor(fs, dtype=torch.float64)) == _jax_select(fs)


@pytest.mark.parametrize("nan_restarts,chosen", [((0,), 1), ((1,), 0), ((0, 1), 0)])
def test_plan_keeps_the_restart_of_the_nan_rule(episode, nan_restarts, chosen, monkeypatch):
    """A restart whose objective is NaN is passed over; with every restart
    NaN the plan is the first restart's point, as in JAX."""
    _, _, _, tctrl = episode
    points = []

    def minimize(fun, x0, *args, **kwargs):
        x = x0.detach().clone()
        f = fun(x).detach()
        points.append(x)
        return x, torch.full_like(f, float("nan")) if len(points) - 1 in nan_restarts else f

    monkeypatch.setattr(tplanner, "lbfgs_b_minimize", minimize)
    p = _plan_inputs(tctrl, 2)
    inits = torch.tensor(p["inits"])
    a_opt, _, info = tplanner._plan_from_cache(tctrl.plan_spec, tctrl.planner._cache, torch.tensor(p["state_mu"]),
                                               torch.tensor(p["state_var"]), inits, torch.tensor(p["action_prev"]),
                                               WARMUP)
    assert torch.equal(a_opt, inits[chosen])
    assert torch.isfinite(info.mean_reward_ucb)


def test_vmap_restarts():
    """tests/test_lbfgs.py::test_vmap_restarts on the port: four restarts of
    the box-constrained L-BFGS, one after another, against JAX's vmap of
    them (its batched line search): after 3 iterations within TOL, and
    converged (20) the objectives within TOL and the points within
    CONVERGED_XTOL."""
    inits = np.random.default_rng(0).uniform(0, 1, (4, 5))
    lo, hi = np.zeros(5), np.ones(5)

    def quad(x, xp=torch):
        return xp.sum((x - 0.3) ** 2) + 0.5 * xp.sum(x[:-1] * x[1:])

    for maxiter, xtol in ((3, TOL), (20, CONVERGED_XTOL)):
        def solve(x0):
            return jlbfgs_b_minimize(lambda x: quad(x, jnp), x0, jnp.asarray(lo), jnp.asarray(hi), maxiter=maxiter,
                                     maxcor=5, maxls=10)

        jxs, jfs = jax.vmap(solve)(jnp.asarray(inits))
        out = [lbfgs_b_minimize(quad, torch.tensor(x0), torch.tensor(lo), torch.tensor(hi), maxiter=maxiter,
                                maxcor=5, maxls=10) for x0 in inits]
        xs = torch.stack([x for x, _ in out])
        fs = torch.stack([f for _, f in out])
        assert xs.shape == (4, 5)
        assert torch.isfinite(fs).all()
        np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0, atol=xtol)
        np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), rtol=0, atol=TOL)

"""Mixed mode of the port (f64 master, double-float32 rollout) against the JAX package.

The JAX side runs on the CPU with x64 on, as its default configuration does: an
f64 master cache split into df32 by ``split_cache_df``, ``moment_match_df``
through the XLA df cov core. The same numpy draws feed both packages.

Tolerances:

* ``split_cache_df``: bit for bit (the same f64 -> (hi, lo) roundings).
* ``_df_stage1`` and ``moment_match_df``, df32 on both sides, on a cache
  with cond(K) ~ 1e6 (the recipe of tests/test_df32.py::_ill_conditioned_state):
  STAGE1_RTOL and MM_RTOL of each output's largest entry. The two packages
  round the same df operations alike except where XLA:CPU contracts a
  multiply-add, which moves a df result by ~eps32^2; the outputs are
  collapsed to f32 at the end, so they agree to about one f32 ulp. Both are
  also held to f64 ``moment_match`` (MM_F64_RTOL), which plain f32 misses by
  20x to 2700x that at this conditioning (checked here too).
* The slice, ``extend_plan`` in mixed mode against JAX
  ``build_extend_plan_fn`` on the f64 cache with an f32 state, at the
  trained-GP flagship's parameters cut to 40 points in the 64 bucket and a
  horizon of 2 (the JAX program's XLA:CPU compile takes minutes and grows
  with the horizon), by both routes of the port's rollout (the df cov core
  and the whole-step path): PLAN_ATOL on a_opt (actions in [0, 1]),
  PLAN_RTOL on the objective and TrajectoryInfo. Both sides optimize an f32 objective
  whose gradient differs in the last bits, and L-BFGS-B carries such
  differences into its iterates.
"""

import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.controllers import planner as jplanner
from gpmpc_tpu.envs.pendulum import PendulumEnv
from gpmpc_tpu.mappers import action as jaction
from gpmpc_tpu.mappers import reward as jreward
from gpmpc_tpu.models import gp as jgp
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.controllers import planner as tplanner
from gpmpc_tpu_torch import ops as tops
from gpmpc_tpu_torch.flagship import run_steps, start_steps, trained_gp_problem
from gpmpc_tpu_torch.models import gp as tgp
from gpmpc_tpu_torch.ops import df_cov, df_mm

CPU = torch.device("cpu")
NS, NA = 3, 1
D = NS + NA
f32, f64 = jnp.float32, jnp.float64

STAGE1_RTOL = 1e-13  # measured 3.6e-15
MM_RTOL = 5e-7  # port vs JAX df32, measured up to 1.0e-7 (M)
MM_F64_RTOL = 1e-6  # df32 vs f64, measured up to 2.2e-7; plain f32 misses by 2.2e-5 to 2.7e-3
PLAN_ATOL = 1e-3
PLAN_RTOL = 1e-4


def _np(tree):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in tree._asdict().items()}


def _ill_conditioned_cache(noise=1e-6, n=150):
    """Pendulum random-action memory with sharpened hyperparameters (noise
    1e-6, cond(K) ~ 1e6), as tests/test_df32.py builds it: the JAX f64 cache."""
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
    x = jnp.asarray(np.array(rows), f64)
    y = jnp.asarray(np.array(ys), f64)
    ls = jnp.asarray(np.array([[0.25, 0.3, 0.35, 0.6]] * NS), f64)
    bounds = jgp.GPBounds(
        jnp.full((NS, D), 4e-3, f64), jnp.full((NS, D), 10.0, f64), jnp.full((NS,), 1e-3, f64),
        jnp.full((NS,), 0.95, f64), jnp.full((NS,), 1e-7, f64), jnp.full((NS,), 1e-3, f64))
    params = jgp.params_from_constrained(ls, jnp.full((NS,), 5e-2, f64), jnp.full((NS,), noise, f64), bounds)
    return jgp.masked_cholesky_factorize(params, bounds, x, y, jnp.ones((n,), bool))


@pytest.fixture(scope="module")
def ill_cache():
    return _ill_conditioned_cache()


def _close(out, ref, rtol, what=""):
    out = np.asarray(out.detach().numpy() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.max(np.abs(out - ref)) / max(np.max(np.abs(ref)), 1e-30)
    assert err <= rtol, f"{what}: error {err:.3e} of the largest entry > {rtol}"


def test_split_cache_df_is_bit_exact_against_jax(ill_cache):
    ref = jgp.split_cache_df(ill_cache)
    port = convert.df_cache_from_numpy(**_np(ill_cache), device=CPU)
    assert isinstance(port, tgp.DFCache)
    for name, r in _np(ref).items():
        o = getattr(port, name)
        assert o.dtype == (torch.bool if name == "mask" else torch.float32), name
        np.testing.assert_array_equal(o.numpy(), r, err_msg=name)


def test_df_stage1_matches_jax(ill_cache):
    """B^-1, c, Q and sqrt det R of one step, df32 on both sides, at a state
    variance whose small solves are well inside the pivot guard."""
    sv = (np.eye(NS) * 1e-4 + 2e-5).astype(np.float32)
    ii, jj = np.triu_indices(NS)
    ref = jax.jit(lambda c, s: jgp._df_stage1(c, s, ii, jj))(jgp.split_cache_df(ill_cache), jnp.asarray(sv))
    port = tgp._df_stage1(convert.df_cache_from_numpy(**_np(ill_cache), device=CPU), torch.tensor(sv),
                          torch.as_tensor(ii), torch.as_tensor(jj))
    names = ("B_inv_h", "B_inv_l", "c", "Q_h", "Q_l", "sqrt_det_R")
    for k in (1, 4):  # lo halves: held through hi + lo below
        assert np.max(np.abs(port[k].numpy())) <= np.max(np.abs(port[k - 1].numpy())) * 2.0 ** -23
    for (hk, lk), name in (((0, 1), "B_inv"), ((3, 4), "Q")):
        _close(port[hk].double() + port[lk].double(), np.asarray(ref[hk], np.float64) + np.asarray(ref[lk]),
               STAGE1_RTOL, name)
    for k in (2, 5):
        _close(port[k], ref[k], STAGE1_RTOL, names[k])


@pytest.mark.parametrize("var_scale", [1e-6, 1e-4])
def test_moment_match_df_matches_jax_and_f64(ill_cache, var_scale):
    mu = np.array([0.55, 0.48, 0.52, 0.5])
    var = np.zeros((D, D))
    var[:NS, :NS] = np.eye(NS) * var_scale
    M64, S64, V64 = jax.jit(jgp.moment_match)(ill_cache, jnp.asarray(mu), jnp.asarray(var))
    Mj, Sj, Vj = jax.jit(jgp.moment_match_df)(jgp.split_cache_df(ill_cache), jnp.asarray(mu, f32),
                                              jnp.asarray(var, f32))
    cache = convert.df_cache_from_numpy(**_np(ill_cache), device=CPU)
    Mt, St, Vt = tgp.moment_match_df(cache, torch.tensor(mu, dtype=torch.float32),
                                     torch.tensor(var, dtype=torch.float32))
    t64 = convert.cache_from_numpy(**_np(ill_cache), dtype=torch.float64, device=CPU)
    out64 = tgp.moment_match(t64, torch.tensor(mu), torch.tensor(var))
    t32 = convert.cache_from_numpy(**_np(ill_cache), dtype=torch.float32, device=CPU)
    out32 = tgp.moment_match(t32, *(torch.tensor(v, dtype=torch.float32) for v in (mu, var)))
    for name, port, jx, ref, port64, plain32 in zip("MSV", (Mt, St, Vt), (Mj, Sj, Vj), (M64, S64, V64),
                                                    out64, out32):
        assert port.dtype == torch.float32
        _close(port, jx, MM_RTOL, f"{name} port vs JAX df32")
        _close(port, ref, MM_F64_RTOL, f"{name} port df32 vs f64")
        _close(jx, ref, MM_F64_RTOL, f"{name} JAX df32 vs f64")
        _close(port64, ref, 1e-9, f"{name} port f64 vs JAX f64")
        with pytest.raises(AssertionError):
            _close(plain32, ref, 10 * MM_F64_RTOL, f"{name} plain f32 vs f64")


def _trained_specs(nh):
    """The trained-GP flagship's specs (scripts/bench_df32.py) for both
    packages, f32."""
    jr = jreward.RewardSpec(
        target_state_action_norm=jnp.asarray([1.0, 0.5, 0.5, 0.5], f32),
        weight_matrix_cost=jnp.asarray(np.diag([1.0, 0.1, 0.1, 1e-3]), f32),
        target_state_norm=jnp.asarray([1.0, 0.5, 0.5], f32),
        weight_matrix_cost_terminal=jnp.asarray(np.diag([5.0, 2.0, 2.0]), f32),
        use_constraints=False, state_min=jnp.zeros(NS, f32), state_max=jnp.ones(NS, f32),
        area_multiplier=1.0, exploration_factor=1.0, clip_lower_bound_cost_to_0=False)
    ja = jaction.ActionMapperSpec(False, jnp.asarray([0.3], f32), nh, NA)
    kw = dict(include_time_model=False, len_horizon=nh, dim_action=NA, dim_state=NS,
              maxiter=4, maxcor=4, maxls=4, maxfun=4)
    tr = convert.reward_spec_from_numpy(**_np(jr), dtype=torch.float32, device=CPU)
    ta = convert.action_spec_from_numpy(**_np(ja), dtype=torch.float32, device=CPU)
    return jplanner.PlanSpec(reward=jr, action=ja, **kw), tplanner.PlanSpec(reward=tr, action=ta, **kw)


def test_mixed_extend_plan_matches_jax():
    """The slice: one steady-state step in mixed mode (extend the f64 master
    by one point, split it into df32, one L-BFGS-B restart over the df32
    rollout) against JAX build_extend_plan_fn, which splits inside. The port
    runs it twice, once per route of its rollout: the df cov core route
    (``moment_match_df``, the CPU's dispatch) and the whole-step route
    (``moment_match_df_fused``, the card's dispatch in the 32..128 buckets,
    selected here by patching ``ops.use_df_fused``), both held against the
    one JAX result, whose XLA ``moment_match_df`` is the reference's oracle
    of its fused path."""
    nh = 2
    prob = trained_gp_problem(CPU, n_points=40, nh=nh, iters=4, bucket=64)
    jspec, tspec = _trained_specs(nh)
    jparams = jgp.GPParams(*(jnp.asarray(t.numpy()) for t in prob.params))
    jbounds = jgp.GPBounds(*(jnp.asarray(t.numpy()) for t in prob.bounds))
    jcache = jgp.masked_cholesky_factorize(jparams, jbounds, jnp.asarray(prob.x), jnp.asarray(prob.y),
                                           jnp.asarray(prob.mask))
    state = [t.numpy() for t in (prob.state_mu, prob.state_var, prob.inits, prob.action_prev)]
    x_new, y_new = prob.extra_x[0], prob.extra_y[0]

    jout = jplanner.build_extend_plan_fn(jspec)(jcache, jnp.asarray(x_new), jnp.asarray(y_new),
                                                *(jnp.asarray(s) for s in state), 0)
    tcache = convert.cache_from_numpy(**_np(jcache), dtype=torch.float64, device=CPU)
    fused = []

    def use_fused(n, ns, d, device):
        fused.append(df_mm.supported(n, ns, d))
        return fused[-1]

    for route in ("df_cov", "fused"):
        before = df_mm.LAUNCHES["df_mm_full"]
        with mock.patch.object(tgp.ops, "use_df_fused", use_fused if route == "fused" else tgp.ops.use_df_fused):
            tout = tplanner.extend_plan(tspec, tcache, torch.tensor(x_new), torch.tensor(y_new),
                                        *(torch.tensor(s) for s in state), 0)
        assert df_mm.LAUNCHES["df_mm_full"] == before  # the CPU takes the plain twins
        for name, o, r in zip(tcache._fields, tout[0], jout[0]):  # the extended f64 master
            _close(o.double() if o.dtype != torch.bool else o, np.asarray(r, np.float64), 1e-9, name)
        a_port, a_jax = tout[1].numpy(), np.asarray(jout[1])
        assert tout[1].dtype == torch.float32
        assert np.all(np.isfinite(a_port)) and a_port.min() >= 0 and a_port.max() <= 1
        np.testing.assert_allclose(a_port, a_jax, rtol=0, atol=PLAN_ATOL, err_msg=route)
        _close(tout[2], jout[2], PLAN_RTOL, f"{route} actions_model")
        for name, o, r in zip(tout[3]._fields, tout[3], jout[3]):
            assert bool(torch.isfinite(o).all()), name
            _close(o, r, PLAN_RTOL, f"{route} {name}")
    assert fused and all(fused)  # the fused route ran at every rollout step


def test_mixed_planner_extends_the_f64_master_and_plans_on_df32():
    """Planner(dtype=f32, master_dtype=f64): the refresh builds an f64 master,
    a steady-state plan extends it (no refactorization, since an f64 master
    is always safe to extend) and rolls out on its df32 split; the step
    equals extend_plan on the same master."""
    prob = trained_gp_problem(CPU, n_points=20, nh=2, iters=2, bucket=32)
    planner = start_steps(prob, CPU, torch.float32, 1)
    master = planner._cache
    assert planner.master_dtype == torch.float64 and master.iK.dtype == torch.float64
    assert isinstance(tplanner._cast_cache(master, torch.float32), tgp.DFCache)
    j = prob.n_points
    prob.x[j], prob.y[j], prob.mask[j] = prob.extra_x[0], prob.extra_y[0], True
    assert planner._cache_status(prob.x, prob.y, prob.mask, prob.params, prob.bounds)[4]
    a_opt, _, info = planner.plan(prob.x, prob.y, prob.mask, prob.params, prob.bounds, prob.state_mu,
                                  prob.state_var, prob.inits, prob.action_prev, 0)
    _, a_ref, _, info_ref = tplanner.extend_plan(
        prob.spec, master, torch.tensor(prob.extra_x[0]), torch.tensor(prob.extra_y[0]), prob.state_mu,
        prob.state_var, prob.inits, prob.action_prev, 0)
    assert a_opt.dtype == torch.float32 and planner._cache.iK.dtype == torch.float64
    assert torch.equal(a_opt, a_ref)
    for o, r in zip(info, info_ref):
        assert torch.equal(o, r)


def test_stacked_vjp_plan_matches_residual_plan():
    """A short mixed CPU plan (the trained-GP problem at 40 points in the 64
    bucket, horizon 5) under ``df_cov.VJP_MODE = "stacked"`` (the lean
    forward's and the stacked backward's twins) against the same plan under
    the default residual scheme. The two VJPs sum the same df terms in
    another order, so the plans agree to PLAN_ATOL on a_opt and PLAN_RTOL on
    the objective's gradient and TrajectoryInfo (L-BFGS-B carries last-bit
    gradient differences into its iterates); no kernel is launched."""
    prob = trained_gp_problem(CPU, n_points=40, nh=5, iters=2, bucket=64)

    def plan(mode):
        saved = df_cov.VJP_MODE
        df_cov.VJP_MODE = mode
        try:
            planner, plans, _ = run_steps(prob, CPU, torch.float32, 1)
            a = prob.inits[0].clone().requires_grad_(True)
            cost, _ = tplanner._objective_and_info(prob.spec, tplanner._cast_cache(planner._cache, torch.float32), a,
                                                   prob.state_mu, prob.state_var, prob.action_prev, 0)
            return plans[0], torch.autograd.grad(cost, a)[0]
        finally:
            df_cov.VJP_MODE = saved

    tops.reset_launch_counts()
    (a_res, info_res), g_res = plan("residual")
    (a_st, info_st), g_st = plan("stacked")
    assert all(v == 0 for v in tops.launch_counts().values())
    assert float((a_st - a_res).abs().max()) <= PLAN_ATOL
    _close(g_st, g_res, PLAN_RTOL, "objective gradient")
    for name, o, r in zip(info_res._fields, info_st, info_res):
        _close(o, r, PLAN_RTOL, name)


def test_planner_refuses_a_state_of_another_dtype():
    """``dtype`` alone picks the rollout: an f64 state given to the mixed
    Planner (dtype f32, master f64) would silently run a plain f64 rollout,
    and an f32 state given to an f64 Planner a mixed one, so both raise."""
    prob = trained_gp_problem(CPU, n_points=8, nh=2, iters=2, bucket=16)
    for dtype, state_dtype in ((torch.float32, torch.float64), (torch.float64, torch.float32)):
        planner = tplanner.Planner(prob.spec, dtype=dtype, device=CPU, master_dtype=torch.float64)
        with pytest.raises(TypeError, match="rolls out in"):
            planner.plan(prob.x, prob.y, prob.mask, prob.params, prob.bounds, prob.state_mu.to(state_dtype),
                         prob.state_var.to(state_dtype), prob.inits.to(state_dtype),
                         prob.action_prev.to(state_dtype), 0)
        assert planner._cache is None  # refused before any work


def test_trained_gp_problem_draws_bench_df32_arrays():
    """trained_gp_problem draws what scripts/bench_df32.py draws (same seed
    and order): memory, the first appended point, state, inits, GP params
    and bounds. bench_point is run up to its first planning step against a
    stand-in Planner that records its arguments."""
    spec = importlib.util.spec_from_file_location(
        "bench_df32", Path(__file__).resolve().parents[1] / "scripts" / "bench_df32.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    seen = {}

    class Stop(Exception):
        pass

    class Recorder:
        def __init__(self, spec):
            seen["spec"] = spec

        def refresh_cache(self, x, y, mask, params, bounds):
            seen["refresh"] = (x.copy(), y.copy(), mask.copy(), params, bounds)

        def plan(self, x, y, mask, params, bounds, mu, var, inits, prev, i):
            seen["plan"] = (x.copy(), mu, var, inits, prev)
            raise Stop

    with mock.patch.object(jplanner, "Planner", Recorder), pytest.raises(Stop):
        bench.bench_point(300, 15, 30)
    prob = trained_gp_problem(CPU)
    x, y, mask, params, bounds = seen["refresh"]
    assert prob.x.shape == x.shape == (384, D)
    np.testing.assert_array_equal(prob.x[:300], x[:300])
    np.testing.assert_array_equal(prob.y, y)
    np.testing.assert_array_equal(prob.mask, mask)
    x1, mu, var, inits, prev = seen["plan"]
    np.testing.assert_array_equal(prob.extra_x[0], x1[300])
    for o, r in ((prob.state_mu, mu), (prob.state_var, var), (prob.inits, inits), (prob.action_prev, prev)):
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for o, r in zip(list(prob.params) + list(prob.bounds), list(params) + list(bounds)):
        assert o.dtype == torch.float64  # raw params: torch's and XLA's log may differ in the last bit
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-14)
    assert prob.spec.len_horizon == seen["spec"].len_horizon == 15
    assert (prob.spec.maxiter, prob.spec.maxfun, prob.spec.maxls, prob.spec.maxcor) == (4, 4, 4, 4)


_FLAGSHIP = {}


def _flagship_cov_operands_and_f64_grads():
    """The df cov core's operands of the first moment-matching step of the
    trained-GP flagship (300 points in the 384 bucket, cond(K) ~ 1e6) at the
    initial state, the loss weights of S_p - corr as moment_match_df forms
    it, and that loss's f64 gradient in (a, c, U, Xj). Made once."""
    from gpmpc_tpu_torch.ops import moment_cov

    if not _FLAGSHIP:
        prob = trained_gp_problem(CPU)
        cache = tplanner._cast_cache(start_steps(prob, CPU, torch.float32, 0)._cache, torch.float32)
        seen = []
        dispatch = tgp.ops.df_cov_core

        def record(*args):
            seen.append(args)
            return dispatch(*args)

        mu = torch.cat([prob.state_mu, prob.inits[0, :NA]])
        var = torch.zeros(D, D)
        var[:NS, :NS] = prob.state_var
        with mock.patch.object(tgp.ops, "df_cov_core", record), torch.no_grad():
            tgp.moment_match_df(cache, mu, var)
        *args, diag_pos = seen[0]
        w = torch.ones(args[0].shape[0])
        wc = -torch.ones(len(diag_pos))  # the loss moment_match_df forms: S_p(diag) - corr
        c64 = [args[2 * i].double() + args[2 * i + 1].double() for i in range(7)]
        leaves = [t.clone().requires_grad_(True) for t in c64[:4]]
        s64, co64 = moment_cov.cov_core_ref(*leaves, *c64[4:], diag_pos)
        g64 = torch.autograd.grad((w.double() * s64).sum() + (wc.double() * co64).sum(), leaves)
        _FLAGSHIP.update(args=args, diag_pos=diag_pos, w=w, wc=wc, g64=g64)
    f = _FLAGSHIP
    return f["args"], f["diag_pos"], f["w"], f["wc"], f["g64"]


def test_cpu_mixed_gradient_matches_f64_at_the_trained_gp_flagship():
    """Fault C1 repaired: the CPU dispatch ops.df_cov_core under autograd
    takes DfCovCore's residual backward on its plain twins (the card's
    scheme), so its gradient of S_p - corr at the trained-GP flagship's
    operands is within 1e-6 of f64 of its largest entry (the plain core's
    misses by ~1e-2, pinned below)."""
    args, diag_pos, w, wc, g64 = _flagship_cov_operands_and_f64_grads()
    a = [t.clone() for t in args]
    leaves = [a[i].requires_grad_(True) for i in (0, 2, 4, 6)]
    sh, sl, ch, cl = tgp.ops.df_cov_core(*a, diag_pos)
    grads = torch.autograd.grad((w * (sh + sl)).sum() + (wc * (ch + cl)).sum(), leaves)
    for g, g_ref in zip(grads, g64):
        err = float((g.double() - g_ref).abs().max()) / float(g_ref.abs().max())
        assert err <= 1e-6, err


def test_ns4_dispatch_refuses_the_df_kernels():
    """The port's twin of tests/test_df32.py::test_ns4_pallas_gates_refuse:
    a 4-state env never takes the whole-step path (on any device, at any
    bucket) and, on the card, sends the df cov core to its plain form; Ns = 3
    is eligible on the card only."""
    cuda = torch.device("cuda")
    for bucket in (64, 128, 256, 384, 512):
        assert not tgp.ops.use_df_fused(bucket, 4, 5, cuda)
        assert not tgp.ops.use_df_fused(bucket, 3, 4, CPU)
    assert 4 > tgp.ops.DF_COV_MAX_NS
    assert tgp.ops.use_df_fused(128, 3, 4, cuda) and tgp.ops.use_df_fused(32, 3, 4, cuda)
    assert not tgp.ops.use_df_fused(192, 3, 4, cuda) and not tgp.ops.use_df_fused(16, 3, 4, cuda)


def test_ns4_moment_match_df_matches_jax():
    """Ns = 4, which the df kernels do not take: moment_match_df (the plain
    df core on every device) against JAX moment_match_df (its XLA df core)
    and both against f64, on a small cache of 48 points (the fast half of
    tests/test_df32.py::test_ns4_env_falls_back_to_xla_df_and_matches_oracle)."""
    ns, d, n = 4, 5, 48
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(0, 1, (n, d)), f64)
    y = jnp.asarray(rng.normal(0, 0.05, (n, ns)), f64)
    bounds = jgp.GPBounds(
        jnp.full((ns, d), 4e-3, f64), jnp.full((ns, d), 10.0, f64), jnp.full((ns,), 1e-3, f64),
        jnp.full((ns,), 0.95, f64), jnp.full((ns,), 1e-7, f64), jnp.full((ns,), 1e-3, f64))
    params = jgp.params_from_constrained(jnp.asarray(np.full((ns, d), 0.3), f64), jnp.full((ns,), 0.1, f64),
                                         jnp.full((ns,), 1e-6, f64), bounds)
    jcache = jgp.masked_cholesky_factorize(params, bounds, x, y, jnp.ones((n,), bool))
    mu = rng.uniform(0.3, 0.7, d)
    var = np.zeros((d, d))
    var[:ns, :ns] = np.eye(ns) * 1e-4
    ref64 = jax.jit(jgp.moment_match)(jcache, jnp.asarray(mu), jnp.asarray(var))
    refdf = jax.jit(jgp.moment_match_df)(jgp.split_cache_df(jcache), jnp.asarray(mu, f32), jnp.asarray(var, f32))
    port = tgp.moment_match_df(convert.df_cache_from_numpy(**_np(jcache), device=CPU),
                               torch.tensor(mu, dtype=torch.float32), torch.tensor(var, dtype=torch.float32))
    for name, o, j, r in zip("MSV", port, refdf, ref64):
        _close(o, j, MM_RTOL, f"{name} port vs JAX df32")
        _close(o, r, MM_F64_RTOL, f"{name} port df32 vs f64")


def test_plain_core_gradient_cancels_at_the_trained_gp_flagship_in_both_packages():
    """Pins a fault of the CPU path (ROADMAP C). At the trained-GP flagship
    (300 points in the 384 bucket, cond(K) ~ 1e6) the df cov core's
    S_p(diag) and corr cancel from ~1e3 terms, and so do their gradients.
    Differentiated by autograd through the plain df core, which sums each
    cotangent-weighted E term in plain f32 (the port's CPU dispatch before
    C1 was repaired, and the JAX package's df_cov_core_xla under jax.grad,
    which the JAX CPU path still runs), the gradient of S_p - corr
    misses f64 by ~1e-2 of its largest entry; DfCovCore's residual backward
    (the card's path, here on its plain twins) keeps the residuals in df
    until the cotangents are applied and agrees to ~1e-8. Operands: the cov
    core's of the first moment-matching step at the initial state."""
    from gpmpc_tpu.ops import df_cov_core_xla
    from gpmpc_tpu_torch.ops import df_cov

    args, diag_pos, w, wc, g64 = _flagship_cov_operands_and_f64_grads()

    def torch_grads(core):
        a = [t.clone() for t in args]
        leaves = [a[i].requires_grad_(True) for i in (0, 2, 4, 6)]
        sh, sl, ch, cl = core(*a, diag_pos)
        return [g.double() for g in torch.autograd.grad((w * (sh + sl)).sum() + (wc * (ch + cl)).sum(), leaves)]

    jargs = [jnp.asarray(t.numpy()) for t in args]

    def jloss(ah, ch, uh, xjh):
        x = list(jargs)
        x[0], x[2], x[4], x[6] = ah, ch, uh, xjh
        sh, sl, co_h, co_l = df_cov_core_xla(*x, diag_pos)
        return jnp.sum(sh + sl) - jnp.sum(co_h + co_l)

    g_jax = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(jargs[0], jargs[2], jargs[4], jargs[6])
    worst = {"plain": 0.0, "jax": 0.0}
    for g_plain, g_res, g_j, g_ref in zip(torch_grads(df_cov.df_cov_core_ref), torch_grads(df_cov.DfCovCore.apply),
                                          g_jax, g64):
        scale = float(g_ref.abs().max())
        assert float((g_res - g_ref).abs().max()) <= 1e-6 * scale
        worst["plain"] = max(worst["plain"], float((g_plain - g_ref).abs().max()) / scale)
        g_j = np.asarray(g_j, np.float64)
        worst["jax"] = max(worst["jax"], float(np.max(np.abs(g_j - g_ref.numpy()))) / scale)
    print("relative gradient error of the plain cores at the trained-GP flagship:", worst)
    assert worst["plain"] >= 1e-3 and worst["jax"] >= 1e-3, worst

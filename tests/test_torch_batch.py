"""The port's batch axis, port against port on the CPU: a batched call
gives each element exactly what its own call gives, bit for bit.

The JAX package runs restarts, restarts x models and seeds under vmap; the
port runs each as one lockstep batch (``controllers.lbfgs``) whose
rollouts launch each kernel once for the batch (``ops.df_mm`` #12, #8 and
#9 take a batch axis; the cov cores take the batch folded into their pair
axis). The JAX parity of the one-at-a-time port is held elsewhere
(tests/test_torch_df_mm.py, test_torch_restarts.py, test_torch_training.py,
test_torch_episode_jax.py); here the batch is held to it:

* the plain twins of #12, #8 and #9 (the CPU path and the kernels' oracle)
  on a batch against one call per element, with one shared cache and with
  per-seed caches (``with_index``), at ns = 3 and ns = 2 with d = 5;
* the lockstep L-BFGS and L-BFGS-B at B = 3, one problem converging early,
  one running into ``maxfun`` and one with a NaN objective, against three
  B = 1 runs, in f64 and f32;
* ``train_restarts`` (restarts x models, and a two-seed batch of them)
  against one run per (seed, restart, model);
* a three-restart plan against three one-restart plans and
  ``_select_restart``, in f64 and in mixed mode by both df32 routes;
* a batched env step and a mixed two-seed episode batch against singles.

Small sizes (N = 32); each case a few seconds.
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch import flagship, ops
from gpmpc_tpu_torch.controllers import planner as planner_mod
from gpmpc_tpu_torch.controllers.lbfgs import lbfgs_b_minimize_batch, lbfgs_minimize_batch
from gpmpc_tpu_torch.envs import torch_dynamics as td
from gpmpc_tpu_torch.models import gp
from gpmpc_tpu_torch.ops import df_mm, moment_cov
from gpmpc_tpu_torch.ops.lanewise import lanewise

CPU = torch.device("cpu")


def _equal(a, b):
    """Bit for bit, NaN equal to NaN; tensors or tuples of them."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool(torch.equal(a, b) or torch.equal(torch.isnan(a), torch.isnan(b))
                                       and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _df_cache(n, ns, d, seed):
    """A random df32 cache (f64 draws split into halves) of the trained-GP
    problem's widths."""
    rng = np.random.default_rng(seed)
    ils = 1.0 / rng.uniform(0.3, 0.8, (ns, d))
    ik = rng.normal(0, 0.1, (ns, n, n))
    f64 = dict(x=rng.uniform(0, 1, (n, d)), ils=ils, ils2=ils * ils, log_outs=np.log(rng.uniform(0.5, 1.0, ns)),
               beta=rng.normal(0, 1, (ns, n)), iK=(ik + ik.transpose(0, 2, 1)) / 2)
    fields = {}
    for name, v in f64.items():
        hi = v.astype(np.float32)
        fields[f"{name}_hi"] = torch.tensor(hi)
        fields[f"{name}_lo"] = torch.tensor((v - hi.astype(np.float64)).astype(np.float32))
    outs = torch.tensor(np.exp(f64["log_outs"]), dtype=torch.float32)
    return gp.DFCache(mask=torch.ones(n, dtype=torch.bool), outs=outs, y_mem=torch.zeros(n, ns), **fields)


def _stack(caches, index):
    return gp.with_index(type(caches[0])(*(torch.stack(f) if f[0] is not None else None for f in zip(*caches))),
                         index)


@pytest.mark.parametrize("ns, d", [(3, 4), (2, 5)], ids=["ns3", "ns2_d5"])
@pytest.mark.parametrize("mode", ["shared", "per-seed"])
def test_df_mm_twins_batch_equals_single_calls(ns, d, mode):
    n, b = 32, 4
    caches = [_df_cache(n, ns, d, seed) for seed in (1, 2)]
    index = [0] * b if mode == "shared" else [0, 0, 1, 1]
    bcache = caches[0] if mode == "shared" else _stack(caches, index)
    rng = np.random.default_rng(3)
    mu = torch.tensor(rng.uniform(0.3, 0.7, (b, d)), dtype=torch.float32)
    sv = torch.tensor(np.stack([np.eye(ns) * 1e-2 * (1 + 0.2 * k) + 2e-3 for k in range(b)]), dtype=torch.float32)
    p = ns * (ns + 1) // 2
    g = [torch.tensor(rng.normal(0, 1, (b,) + s), dtype=torch.float32) for s in ((ns,), (ns, d), (p,), (ns,))]
    ii, jj, _, _ = df_mm.pair_indices(ns, CPU)
    Bh, Bl, c32, Qh, Ql, sdr = df_mm.df_stage1(bcache, sv, ii, jj)
    full = df_mm.full_step_fwd(mu, sv, bcache)
    raw = df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, bcache)
    vjp = df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, bcache, *g)
    split = df_mm.split_path(mu, sv, bcache)
    for k in range(b):
        c = caches[index[k]]
        one = df_mm.df_stage1(c, sv[k], ii, jj)
        assert _equal([t[k] for t in (Bh, Bl, c32, Qh, Ql, sdr)], one), k
        assert _equal([t[k] for t in full], df_mm.full_step_fwd(mu[k], sv[k], c)), k
        assert _equal([t[k] for t in raw], df_mm.stage23_fwd(mu[k], *one[:2], *one[3:5], c)), k
        assert _equal([t[k] for t in vjp], df_mm.stage23_bwd_all(mu[k], *one[:2], *one[3:5], c,
                                                                 *(t[k] for t in g))), k
        assert _equal([t[k] for t in split], df_mm.split_path(mu[k], sv[k], c)), k
    # FullStep's backward rebuilds stage 1 once for the batch: each element's gradient its own
    leaves = (mu.clone().requires_grad_(True), sv.clone().requires_grad_(True))
    outs = df_mm.full_step(*leaves, bcache)
    grads = torch.autograd.grad(sum(o.sum() for o in outs), leaves)
    for k in range(b):
        one = (mu[k].clone().requires_grad_(True), sv[k].clone().requires_grad_(True))
        o1 = df_mm.full_step(*one, caches[index[k]])
        assert _equal([t[k] for t in grads], torch.autograd.grad(sum(o.sum() for o in o1), one)), k


def _problems(dtype):
    """Three problems' objective f(x (b, 4), idx): a convex quadratic that
    converges in a few iterations, a Rosenbrock that runs until the
    evaluation budget, and one whose value is NaN."""
    a = torch.tensor([[3.0, 0.5, 0.0, 0.0], [0.5, 2.0, 0.2, 0.0], [0.0, 0.2, 1.5, 0.1], [0.0, 0.0, 0.1, 1.0]],
                     dtype=dtype)
    c = torch.tensor([1.0, -2.0, 0.5, 0.3], dtype=dtype)

    def quad(x):
        return 0.5 * torch.einsum("bi,ij,bj->b", x, a, x) - (x * c).sum(-1)

    def rosen(x):
        return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2).sum(-1)

    def f(x, idx):
        out = torch.zeros(x.shape[0], dtype=dtype)
        for k, fn in enumerate((quad, rosen, lambda x_: quad(x_) * float("nan"))):
            rows = idx == k
            out[rows] = fn(x[rows])
        return out

    return f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("boxed", [False, True], ids=["lbfgs", "lbfgs_b"])
def test_lockstep_lbfgs_equals_single_runs(dtype, boxed):
    fun = _problems(dtype)
    x0 = torch.tensor([[0.3, -0.2, 0.1, 0.4], [-1.2, 1.0, -0.5, 0.8], [0.1, 0.1, 0.1, 0.1]], dtype=dtype)
    kw = dict(maxiter=40, maxcor=5, maxls=8, maxfun=30)

    def run(x, idx0):
        shift = lambda x_, idx, o=idx0: fun(x_, idx + o)  # noqa: E731
        if boxed:
            lo = torch.tensor([-1.5, -0.5, -1.0, -1.0], dtype=dtype)
            return lbfgs_b_minimize_batch(shift, x, lo, lo + 2.5, **kw)
        return lbfgs_minimize_batch(shift, x, clip_grad_value=50.0, keep_best=True,
                                    init_step_scale=torch.tensor([0.05, 0.01, 0.05], dtype=dtype)[idx0:idx0 + len(x)],
                                    **kw)

    xs, fs = run(x0, 0)
    for k in range(3):
        x1, f1 = run(x0[k:k + 1], k)
        assert _equal(xs[k], x1[0]) and _equal(fs[k], f1[0]), k
    assert torch.isnan(fs[2]) and torch.equal(xs[2], x0[2])  # frozen at its NaN start
    assert float(fs[0]) < float(fun(x0[:1], torch.tensor([0]))[0])  # the quadratic moved
    assert float(fs[1]) < float(fun(x0[1:2], torch.tensor([1]))[0])


def _train_problem(seeds):
    ns, d, n = 2, 3, 32
    g = torch.Generator().manual_seed(5)
    x = torch.rand((seeds, n, d), generator=g, dtype=torch.float64)
    y = 0.1 * torch.randn((seeds, n, ns), generator=g, dtype=torch.float64)
    mask = torch.arange(n) < torch.tensor([10, 14])[:seeds, None]
    t = lambda v, shape: torch.full(shape, v, dtype=torch.float64)  # noqa: E731
    bounds = gp.GPBounds(t(4e-3, (ns, d)), t(10.0, (ns, d)), t(1e-2, (ns,)), t(0.95, (ns,)), t(1e-6, (ns,)),
                         t(1e-2, (ns,)))
    p0 = gp.params_from_constrained(t(0.5, (ns, d)), t(0.3, (ns,)), t(1e-3, (ns,)), bounds)
    params = gp.GPParams(*(a.expand((seeds,) + a.shape) for a in p0))
    draws = torch.rand((seeds, 2, ns, d + 2), generator=g, dtype=torch.float64)
    return params, bounds, x, y, mask, draws, gp.TrainConfigDevice(lr=0.1, iters=30, clip_grad_value=0.1)


def test_train_restarts_batch_equals_single_runs():
    """Two seeds x two restarts x two models as one batch, against each run
    alone (one seed, one restart, one model), and the one-seed call."""
    params, bounds, x, y, mask, draws, cfg = _train_problem(2)
    raws, losses = gp.train_restarts(params, bounds, x, y, mask, cfg, draws)
    assert raws.shape == draws.shape and losses.shape == draws.shape[:-1]
    lo, hi, _ = gp._flat_boxes(params, bounds)
    for s in range(2):
        one_seed = gp.train_restarts(gp.GPParams(*(a[s] for a in params)), bounds, x[s], y[s], mask[s], cfg,
                                     draws[s])
        assert _equal(one_seed, (raws[s], losses[s])), s
        for r in range(2):
            for m in range(2):
                init = gp.unconstrain(lo[m] + draws[s, r, m] * (hi[m] - lo[m]), lo[m], hi[m])
                loss = lambda raw, idx, s=s, m=m: gp._single_model_negative_mll(  # noqa: E731
                    raw, lo[m], hi[m], x[s], y[s, :, m], mask[s])
                xb, fb = lbfgs_minimize_batch(loss, init[None], maxiter=cfg.iters, maxcor=cfg.maxcor,
                                              maxls=cfg.maxls, clip_grad_value=cfg.clip_grad_value,
                                              keep_best=True, init_step_scale=cfg.lr)
                assert _equal((xb[0], fb[0]), (raws[s, r, m], losses[s, r, m])), (s, r, m)
    best, best_losses = gp.keep_best(params, bounds, x, y, mask, raws, losses)
    for s in range(2):
        one = gp.keep_best(gp.GPParams(*(a[s] for a in params)), bounds, x[s], y[s], mask[s], raws[s], losses[s])
        assert _equal(list(one[0]) + [one[1]], [a[s] for a in best] + [best_losses[s]]), s


@pytest.mark.parametrize("mode", ["f64", "mixed_df_cov", "mixed_whole_step"])
def test_restart_batch_equals_single_restart_plans(mode, monkeypatch):
    """A three-restart plan against three one-restart plans: each restart's
    result bit for bit, and the plan is the one ``_select_restart`` keeps."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    prob = flagship.trained_gp_problem(CPU, dtype=dtype, n_points=20, nh=2, bucket=32)
    prob.spec = prob.spec._replace(maxiter=2, maxfun=3)
    planner = flagship.start_steps(prob, CPU, dtype, 1)
    if mode == "f64":
        planner = planner_mod.Planner(prob.spec, dtype=dtype, device=CPU)
        planner.refresh_cache(prob.x, prob.y, prob.mask, gp.GPParams(*(a.double() for a in prob.params)),
                              gp.GPBounds(*(a.double() for a in prob.bounds)))
    monkeypatch.setattr(ops, "use_df_fused", lambda *a: mode == "mixed_whole_step")
    cache = planner_mod._cast_cache(planner._cache, dtype)
    inits = torch.tensor(np.random.default_rng(7).uniform(0, 1, (3, prob.inits.shape[1])), dtype=dtype)
    args = (prob.state_mu, prob.state_var)
    xs, fs = planner_mod._run_restarts(prob.spec, cache, *args, inits, prob.action_prev, 0)
    singles = [planner_mod._run_restarts(prob.spec, cache, *args, inits[r:r + 1], prob.action_prev, 0)
               for r in range(3)]
    for r, (x1, f1) in enumerate(singles):
        assert _equal((xs[r], fs[r]), (x1[0], f1[0])), r
    a_opt, _, info = planner_mod._best_restart(prob.spec, cache, xs, fs, *args, prob.action_prev, 0)
    keep = planner_mod._select_restart(torch.stack([f[0] for _, f in singles]))
    ref = planner_mod._best_restart(prob.spec, cache, *singles[keep], *args, prob.action_prev, 0)
    assert _equal(a_opt, ref[0]) and _equal(tuple(info), tuple(ref[2]))
    assert not torch.equal(xs[0], xs[1])


def test_env_batch_step_equals_single_steps():
    """Each env's batched step (the seeds' states stacked, each its own
    generator) against one step per seed, bit for bit."""
    for spec in (td.pendulum_spec(device=CPU), td.mountain_car_spec(device=CPU),
                 td.process_control_spec(change_params=True, period_change=1, device=CPU)):
        gens = [torch.Generator().manual_seed(s) for s in range(3)]
        states, obs = zip(*(spec.init_fn(g) for g in gens))
        acts = torch.tensor([[0.3, 0.1], [-0.5, 0.7], [0.9, 0.2]], dtype=torch.float64)[:, :len(spec.act_low)]
        singles = [torch.Generator().manual_seed(s) for s in range(3)]
        for g in singles:
            spec.init_fn(g)
        batch = spec.step_fn(td.stack_states(list(states)), acts, gens)
        for s in range(3):
            one = spec.step_fn(states[s], acts[s], singles[s])
            assert _equal(batch[1][s], one[1]) and _equal(batch[2][s], one[2]), (spec.name, s)


def test_lanewise_is_position_invariant():
    """An element's exp, log, sigmoid and sin by ``lanewise`` do not depend on
    the tensor around it (torch's scalar tail rounds differently)."""
    x = torch.linspace(0.1, 3.0, 77, dtype=torch.float64)
    for fn in (torch.exp, torch.log, torch.sigmoid, torch.sin):
        full = lanewise(fn, x)
        assert all(torch.equal(full[i:i + 1], lanewise(fn, x[i:i + 1])) for i in range(77)), fn


def test_element_pairs_checks_the_fold():
    assert moment_cov.element_pairs(12, (0, 3, 5, 6, 9, 11), 2) == (6, (0, 3, 5))
    with pytest.raises(ValueError):
        moment_cov.element_pairs(12, (0, 3, 5, 6, 9, 10), 2)

"""The whole-step df32 path of the port (ops/df_mm.py) against the JAX package.

Both packages run on the same numpy-made cache: pendulum random-action memory
with sharpened hyperparameters (noise 1e-6, cond(K) ~ 1e6, the recipe of
tests/test_df32.py::_ill_conditioned_state), 40 points in the 64 bucket and
90 in the 96 bucket (the bucket that is not a power of two, which the port
runs unpadded), an f64 master split into df32.

The JAX oracle is the reference's XLA df path (``moment_match_df`` and
``df_cov_core_xla``), which the reference names the fused path's oracle
(gpmpc_tpu/models/gp.py, ``moment_match_df_fused``): the Pallas bodies of
pallas_df_mm.py compile for many minutes on XLA:CPU at these sizes.

Tolerances:

* the raw S_p and corr partials of ``stage23_plain`` against
  ``df_cov_core_xla`` on the operands that JAX ``moment_match_df`` forms:
  DF_RTOL of each output's sum of |terms|, as the df cov core is held
  (the two sides form the operands in another order, ~eps32^2);
* M, S and V of ``full_step_plain`` and of the split path against JAX
  ``moment_match_df``: MM_RTOL of each output's largest entry, as
  tests/test_torch_mixed.py holds ``moment_match_df``;
* the gradient in (mu, sv) of ``FullStep`` (on its plain twins here) against
  ``jax.grad`` of JAX ``moment_match_df`` (GRAD_JAX_RTOL) and against the
  f64 gradient of ``moment_match`` (GRAD_F64_RTOL), of the largest entry.
  Both packages carry the same f32-grade derivative rules, but JAX sums the
  cotangents in plain f32, which cancels at this conditioning: JAX misses
  f64 by 5.9e-5 to 1.4e-4 here, the port (cotangents in df) by 2.6e-6 to
  1.0e-5, so the two differ by JAX's error (measured up to 1.4e-4);
* ``stage23_vjp_plain`` against torch autograd of ``stage23_plain`` (the
  port's df ops carry the same derivative rules, summed in plain f32) and
  against central finite differences in f64 of the collapsed outputs, on a
  well-conditioned random cache (noise 5e-2; measured 2.9e-6 and 1.6e-6):
  VJP_RTOL and FD_RTOL of the largest entry. At noise 1e-3 autograd's plain
  f32 sums already miss the finite differences by 1.5e-3;
* the split backward's twins (the mean path's VJP, #10, and each pair's,
  #11) against ``jax.vjp`` of the reference's ``_mean_part`` and
  ``_pair_part`` bodies with its cotangent layout, on the same
  well-conditioned cache in the 64 bucket (the bodies reduce by halving, so
  N is a power of two): VJP_RTOL of the largest entry, as autograd above;
* the split route (``stage23_bwd`` past N = 128) against #9's twin
  ``stage23_vjp_plain`` at N = 160 on the trained-GP problem's cache
  (cond(K) ~ 1e6): both sum the same df terms, grouped differently, and
  collapse once (SPLIT_RTOL).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import ops as jops
from gpmpc_tpu.envs.pendulum import PendulumEnv
from gpmpc_tpu.models import gp as jgp
from gpmpc_tpu.ops import df_cov_core_xla
from gpmpc_tpu.ops import pallas_df_mm as jpdm
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.controllers import planner as tplanner
from gpmpc_tpu_torch.flagship import trained_gp_problem
from gpmpc_tpu_torch.models import gp as tgp
from gpmpc_tpu_torch.ops import df_cov, df_mm

CPU = torch.device("cpu")
NS, NA = 3, 1
D = NS + NA
f32, f64 = jnp.float32, jnp.float64

DF_RTOL = 1e-12
MM_RTOL = 5e-7
GRAD_JAX_RTOL = 3e-4
GRAD_F64_RTOL = 3e-5
VJP_RTOL = 1e-5
FD_RTOL = 1e-5
SPLIT_RTOL = 1e-9
PAIR_JAX_RTOL = 1e-3  # JAX's f32 transposes of one pair's VJP, measured up to 4.8e-4 off the port
CASES = [(40, 64), (90, 96)]


def _np(tree):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in tree._asdict().items()}


def _pendulum_cache(n, bucket, noise=1e-6):
    """The JAX f64 cache of n pendulum points in a bucket (zero padding, mask)."""
    env = PendulumEnv(seed=0)
    obs = env.reset()
    lo, hi = env.observation_space.low, env.observation_space.high
    rng = np.random.default_rng(0)
    x = np.zeros((bucket, D))
    y = np.zeros((bucket, NS))
    for i in range(n):
        a = rng.uniform(-2, 2, 1)
        s = (obs - lo) / (hi - lo)
        obs2, _, _, _ = env.step(a)
        x[i] = np.concatenate([s, (a + 2) / 4])
        y[i] = (obs2 - lo) / (hi - lo) - s
        obs = obs2
    ls = jnp.asarray(np.array([[0.25, 0.3, 0.35, 0.6]] * NS), f64)
    bounds = jgp.GPBounds(
        jnp.full((NS, D), 4e-3, f64), jnp.full((NS, D), 10.0, f64), jnp.full((NS,), 1e-3, f64),
        jnp.full((NS,), 0.95, f64), jnp.full((NS,), 1e-7, f64), jnp.full((NS,), 1e-3, f64))
    params = jgp.params_from_constrained(ls, jnp.full((NS,), 5e-2, f64), jnp.full((NS,), noise, f64), bounds)
    return jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(np.arange(bucket) < n))


MU = np.array([0.55, 0.48, 0.52, 0.5])


def _var():
    var = np.zeros((D, D))
    var[:NS, :NS] = np.eye(NS) * 1e-4 + 2e-5
    return var


W_M, W_S, W_V = np.array([1.0, -2.0, 0.5]), np.arange(1.0, 10.0).reshape(3, 3) / 9, np.linspace(-1, 1, D * NS).reshape(D, NS)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}_in_{c[1]}")
def case(request):
    """Both packages' caches and the JAX results of one size, computed once."""
    n, bucket = request.param
    jcache = _pendulum_cache(n, bucket)
    dfc = jgp.split_cache_df(jcache)
    mu, var = jnp.asarray(MU, f32), jnp.asarray(_var(), f32)

    def mm_and_operands(c, m, v):
        seen = []

        def record(*args):
            seen.append(args)
            return df_cov_core_xla(*args)

        with mock.patch.object(jops, "df_cov_core", record):
            out = jgp.moment_match_df(c, m, v)
        *operands, diag_pos = seen[0]
        return out, df_cov_core_xla(*operands, diag_pos), operands

    (mm, core, operands) = jax.jit(mm_and_operands)(dfc, mu, var)

    def loss(m, v):
        M, S, V = jgp.moment_match_df(dfc, m, v)
        return jnp.sum(jnp.asarray(W_M, f32) * M) + jnp.sum(jnp.asarray(W_S, f32) * S) + jnp.sum(
            jnp.asarray(W_V, f32) * V)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(mu, var)

    def loss64(m, v):
        M, S, V = jgp.moment_match(jcache, m, v)
        return jnp.sum(W_M * M) + jnp.sum(W_S * S) + jnp.sum(W_V * V)

    grads64 = jax.jit(jax.grad(loss64, argnums=(0, 1)))(jnp.asarray(MU), jnp.asarray(_var()))
    tcache = convert.df_cache_from_numpy(**_np(jcache), device=CPU)
    return dict(tcache=tcache, mm=[np.asarray(t) for t in mm], core=[np.asarray(t) for t in core],
                operands=[np.asarray(t) for t in operands], grads=[np.asarray(g) for g in grads],
                grads64=[np.asarray(g) for g in grads64])


def _inputs():
    return torch.tensor(MU, dtype=torch.float32), torch.tensor(_var(), dtype=torch.float32)


def _stage1(cache, sv):
    ii, jj, _, _ = df_mm.pair_indices(NS, CPU)
    return df_mm.df_stage1(cache, sv, ii, jj)


def _rel(out, ref):
    out = np.asarray(out.detach().numpy() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.max(np.abs(out - ref)) / max(np.max(np.abs(ref)), 1e-300))


def test_stage23_raw_partials_match_xla_df_cov_core(case):
    """S_p and corr of stage23_plain (operands formed from mu, B^-1 and Q)
    against df_cov_core_xla on the operands JAX moment_match_df forms."""
    cache = case["tcache"]
    mu, var = _inputs()
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, var[:NS, :NS])
    raw = df_mm.stage23_plain(mu, Bh, Bl, Qh, Ql, cache)
    ops_t = [torch.tensor(a) for a in case["operands"]]
    diag = (0, 3, 5)
    (sp_abs, co_abs), _ = df_cov.df_cov_abs_terms(*ops_t, diag)
    for (h, l), (jh, jl), scale in (((raw[4], raw[5]), case["core"][:2], sp_abs),
                                    ((raw[6], raw[7]), case["core"][2:], co_abs)):
        out = h.double() + l.double()
        ref = torch.tensor(jh, dtype=torch.float64) + torch.tensor(jl, dtype=torch.float64)
        err = (out - ref).abs() / scale
        assert float(err.max()) <= DF_RTOL, float(err.max())


def test_full_step_and_split_path_match_jax_moment_match_df(case):
    """M, S, V of the fused step (full_step_plain, through
    moment_match_df_fused) and of the split path (stage 1, stage23_plain,
    the finish) against JAX moment_match_df."""
    cache = case["tcache"]
    mu, var = _inputs()
    fused = tgp.moment_match_df_fused(cache, mu, var)
    with torch.no_grad():
        M, V, S_p = df_mm.split_path(mu, var[:NS, :NS], cache)
    full = df_mm.full_step_plain(mu, var[:NS, :NS].contiguous(), cache)
    for a, b in zip((M, V, S_p), full):
        assert torch.equal(a, b)  # the same arithmetic
    for name, o, r in zip("MSV", fused, case["mm"]):
        assert o.dtype == torch.float32
        assert _rel(o, r) <= MM_RTOL, (name, _rel(o, r))


def test_fullstep_gradient_matches_jax_grad(case):
    """The gradient in (mu, var) through FullStep (its backward: stage 1 by
    autograd, stage23_vjp_plain) against jax.grad of JAX moment_match_df,
    both against the f64 gradient of moment_match for the record."""
    cache = case["tcache"]
    mu, var = (t.requires_grad_(True) for t in _inputs())
    M, S, V = tgp.moment_match_df_fused(cache, mu, var)
    loss = (torch.tensor(W_M, dtype=torch.float32) * M).sum() + (torch.tensor(W_S, dtype=torch.float32) * S).sum() \
        + (torch.tensor(W_V, dtype=torch.float32) * V).sum()
    g = torch.autograd.grad(loss, (mu, var))
    errs = [_rel(o, r) for o, r in zip(g, case["grads"])]
    errs64 = [_rel(o, r) for o, r in zip(g, case["grads64"])]
    print("port vs JAX:", errs, "port vs f64:", errs64,
          "JAX vs f64:", [_rel(r, r64) for r, r64 in zip(case["grads"], case["grads64"])])
    assert max(errs) <= GRAD_JAX_RTOL, errs
    assert max(errs64) <= GRAD_F64_RTOL, errs64


def _random_cache(seed=3, n=48, bucket=64, noise=5e-2):
    """A well-conditioned cache (noise 5e-2, wide lengthscales) as the port's
    DFCache."""
    rng = np.random.default_rng(seed)
    x = np.zeros((bucket, D))
    y = np.zeros((bucket, NS))
    x[:n] = rng.uniform(0, 1, (n, D))
    y[:n] = rng.normal(0, 0.1, (n, NS))
    bounds = jgp.GPBounds(
        jnp.full((NS, D), 4e-3, f64), jnp.full((NS, D), 10.0, f64), jnp.full((NS,), 1e-3, f64),
        jnp.full((NS,), 0.95, f64), jnp.full((NS,), 1e-7, f64), jnp.full((NS,), 1e-1, f64))
    params = jgp.params_from_constrained(jnp.full((NS, D), 0.6, f64), jnp.full((NS,), 0.5, f64),
                                         jnp.full((NS,), noise, f64), bounds)
    jcache = jgp.masked_cholesky_factorize(params, bounds, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(np.arange(bucket) < n))
    return convert.df_cache_from_numpy(**_np(jcache), device=CPU)


def test_stage23_vjp_plain_matches_autograd_and_finite_differences():
    cache = _random_cache()
    mu, var = _inputs()
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, var[:NS, :NS] * 100)
    rng = np.random.default_rng(5)
    g = [torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in ((NS,), (NS, D), (6,), (NS,))]
    vjp = df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, cache, *g)

    leaves = [t.clone().requires_grad_(True) for t in (mu, Bh, Bl, Qh, Ql)]
    raw = df_mm.stage23_plain(*leaves, cache)
    loss = sum((gk * raw[2 * k]).sum() for k, gk in enumerate(g))
    ag = torch.autograd.grad(loss, leaves)
    for o, r in zip((vjp[0], vjp[1], vjp[1], vjp[2], vjp[2]), ag):
        assert _rel(o, r) <= VJP_RTOL, _rel(o, r)

    def value(m, bh, qh):
        out = df_mm.stage23_plain(m, bh, Bl, qh, Ql, cache)
        return sum(float((gk.double() * (out[2 * k].double() + out[2 * k + 1].double())).sum())
                   for k, gk in enumerate(g))

    h = 2.0 ** -12  # exact in f32 at these magnitudes

    def fd(base, call):
        grad = torch.zeros(base.numel(), dtype=torch.float64)
        for i in range(base.numel()):
            up, dn = base.clone().reshape(-1), base.clone().reshape(-1)
            up[i] += h
            dn[i] -= h
            grad[i] = (call(up.reshape(base.shape)) - call(dn.reshape(base.shape))) / (2 * h)
        return grad.reshape(base.shape)

    fds = (fd(mu, lambda m: value(m, Bh, Qh)), fd(Bh, lambda b: value(mu, b, Qh)), fd(Qh, lambda q: value(mu, Bh, q)))
    errs = [_rel(o, r) for o, r in zip(vjp, fds)]
    print("stage23_vjp_plain vs f64 finite differences:", errs)
    assert max(errs) <= FD_RTOL, errs


def test_split_bwd_twins_match_jax_vjp_of_mean_and_pair_parts():
    """#10's twin against jax.vjp of ``_mean_part`` with respect to mu and
    B^-1 (hi and lo halves: the port gives both the same gradient, as the
    reference's custom derivatives do), and #11's twin, pair by pair,
    against jax.vjp of ``_pair_part`` with respect to mu and Q_k, at the
    cotangents of the reference's layout (ct[0:4] for the mean path, ct[4, k]
    and, on the diagonal pairs, ct[6, i] for pair k; the lo cotangents reach
    no input). The port's contributions are to inp = x - mu: g_mu = -them.
    The mean path to VJP_RTOL. The pairs to PAIR_JAX_RTOL: JAX's transposes
    sum each pair's cotangent-weighted E terms in plain f32, which cancel
    (JAX and the port differ by up to 4.8e-4 there); so the pairs' gradients
    are also held to f64 central differences of the df forward, along a
    random direction in mu and one in Q, by FD_RTOL of the sum of |terms|
    (the port measured 1.1e-6 and 6.1e-8 there)."""
    cache = _random_cache()
    mu, var = _inputs()
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, var[:NS, :NS] * 100)
    rng = np.random.default_rng(7)
    g_m, g_v, g_sp, g_corr = (rng.normal(size=s).astype(np.float32) for s in ((NS,), (NS, D), (6,), (NS,)))
    c = {k: jnp.asarray(getattr(cache, k).numpy()) for k in ("x_hi", "x_lo", "ils_hi", "ils_lo", "ils2_hi", "ils2_lo",
                                                             "log_outs_hi", "log_outs_lo", "beta_hi", "beta_lo",
                                                             "iK_hi", "iK_lo")}
    mu_j = [jnp.float32(v) for v in mu.numpy()]
    bh_j, bl_j = ([jnp.float32(v) for v in t.numpy().reshape(-1)] for t in (Bh, Bl))

    def mean(*rows):
        return jpdm._mean_part(list(rows[:D]), list(rows[D:D + NS ** 3]), list(rows[D + NS ** 3:]), c["x_hi"], c["x_lo"],
                               c["ils_hi"], c["ils_lo"], c["beta_hi"], c["beta_lo"], ns=NS, d=D)

    _, pull = jax.vjp(mean, *(mu_j + bh_j + bl_j))
    lo_ct = rng.normal(size=NS + NS * D).astype(np.float32)
    grads = [np.asarray(g) for g in pull((jnp.asarray(g_m), jnp.asarray(lo_ct[:NS]), jnp.asarray(g_v.reshape(-1)),
                                          jnp.asarray(lo_ct[NS:])))]
    (inp_h, inp_l), g_b = df_mm.stage23_vjp_mean_plain(mu, Bh, Bl, cache, torch.tensor(g_m), torch.tensor(g_v))
    assert _rel(-(inp_h.double() + inp_l.double()), np.array(grads[:D])) <= VJP_RTOL
    for half in (grads[D:D + NS ** 3], grads[D + NS ** 3:]):
        assert _rel(g_b.reshape(-1), np.array(half)) <= VJP_RTOL

    (p_h, p_l), g_q = df_mm.stage23_vjp_pairs_plain(mu, Qh, Ql, cache, torch.tensor(g_sp), torch.tensor(g_corr))
    ii, jj = np.triu_indices(NS)
    errs = []
    for k, (i_p, j_p) in enumerate(zip(ii, jj)):
        qh_j, ql_j = ([jnp.float32(v) for v in t[k].numpy().reshape(-1)] for t in (Qh, Ql))

        def pair(*rows):
            return jpdm._pair_part(list(rows[:D]), list(rows[D:D + NS * NS]), list(rows[D + NS * NS:]), c["x_hi"],
                                   c["x_lo"], c["ils_hi"], c["ils_lo"], c["ils2_hi"], c["ils2_lo"], c["log_outs_hi"],
                                   c["log_outs_lo"], c["beta_hi"], c["beta_lo"], c["iK_hi"], c["iK_lo"],
                                   i_p=int(i_p), j_p=int(j_p), ns=NS, d=D)

        _, pull = jax.vjp(pair, *(mu_j + qh_j + ql_j))
        ct_co = jnp.float32(g_corr[i_p] if i_p == j_p else 0.0)
        grads = [np.asarray(g) for g in pull((jnp.float32(g_sp[k]), jnp.float32(0.5), ct_co, jnp.float32(0.0)))]
        errs.append(_rel(-(p_h[k].double() + p_l[k].double()), np.array(grads[:D])))
        errs += [_rel(g_q[k].reshape(-1), np.array(half)) for half in (grads[D:D + NS * NS], grads[D + NS * NS:])]
    print("each pair's g_mu and g_Q, port vs JAX:", errs)
    assert max(errs) <= PAIR_JAX_RTOL, errs

    def value(m, qh):  # the pairs' cotangent-weighted raw outputs, f64 from the df forward
        out = df_mm.stage23_plain(m, Bh, Bl, qh, Ql, cache)
        return float(torch.tensor(g_sp, dtype=torch.float64) @ (out[4].double() + out[5].double())
                     + torch.tensor(g_corr, dtype=torch.float64) @ (out[6].double() + out[7].double()))

    # central differences along one random direction in mu and one in Q: the
    # step actually taken (in f32) against the port's gradient, in f64
    g_mu_pairs = -(p_h.double() + p_l.double()).sum(0)
    for base, grad, call in ((mu, g_mu_pairs, lambda x: value(x, Qh)), (Qh, g_q.double(), lambda x: value(mu, x))):
        step = torch.tensor(rng.normal(size=tuple(base.shape)), dtype=torch.float32) * 2.0 ** -16
        up, dn = base + step, base - step
        fd = call(up) - call(dn)
        dot = float((grad * (up.double() - dn.double())).sum())
        scale = float((grad.abs() * (up.double() - dn.double()).abs()).sum())
        print("directional derivative, port vs f64 central differences:", abs(fd - dot) / scale)
        assert abs(fd - dot) <= FD_RTOL * scale, (fd, dot)


def test_split_route_matches_stage23_vjp_plain_past_128():
    """Past N = 128 ``stage23_bwd`` takes the split (on the CPU, the twins of
    #10 and #11, combined in df by ``combine_split``), which agrees with #9's
    twin at N = 160 on the trained-GP problem's df32 cache (cond(K) ~ 1e6,
    150 points, refreshed by the port)."""
    prob = trained_gp_problem(CPU, n_points=150, nh=1, iters=1, bucket=160)
    master = tplanner.Planner(prob.spec, dtype=torch.float32, device=CPU, master_dtype=torch.float64).refresh_cache(
        prob.x, prob.y, prob.mask, prob.params, prob.bounds)
    cache = tplanner._cast_cache(master, torch.float32)
    mu, var = _inputs()
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, var[:NS, :NS])
    rng = np.random.default_rng(11)
    g = [torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in ((NS,), (NS, D), (6,), (NS,))]
    assert cache.x_hi.shape[0] > df_mm.SINGLE_BWD_MAX_N
    split = df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, cache, *g)
    whole = df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, cache, *g)
    errs = [_rel(o, r) for o, r in zip(split, whole)]
    assert max(errs) <= SPLIT_RTOL, errs

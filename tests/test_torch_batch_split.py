"""The batch axis of the split whole-step backward (#10 ``df_mm_bwd_mean``
and #11 ``df_mm_bwd_pair``, past N = 128) and of the f32 refresh's Gram
(#1), on the CPU, where the wrappers take their plain twins.

* At N = 192, B = 2, with one cache shared by both elements and with
  per-element caches chosen by an index (``models.gp.with_index``): the
  batched twins of #10 and #11 and the batched ``stage23_bwd`` equal their
  single calls bit for bit, and match the JAX package's vmapped VJP of the
  reference's ``_mean_part`` and ``_pair_part`` bodies (its cotangent
  layout, as tests/test_torch_df_mm.py
  ``test_split_bwd_twins_match_jax_vjp_of_mean_and_pair_parts``) to the
  same tolerances: VJP_RTOL for the mean path, PAIR_JAX_RTOL for the pairs
  (JAX's transposes sum the pairs' cancelling terms in plain f32). The
  reference's bodies reduce by halving, so the JAX side runs on the cache
  zero-padded to 256 as the reference pads it (``_pad_cache_pow2``: exact,
  every padded term carries a zero beta or iK factor). The caches hold 48
  random points in the 192 bucket (the port runs N = 192, padding rows
  included), as well conditioned as that test's 48 points: JAX's
  plain-f32 pair cotangents grow with the points they sum (at 160 points
  they missed the port's df ones by up to 1.6e-5 absolute, 3.0e-2 of the
  smallest pair's largest g_mu entry, while g_Q and the mean path held
  their tolerances; at 48 points in the 192 bucket, 4.8e-4), an error of
  JAX's f32 transposes and not of the batch, which the bit-for-bit checks
  hold.
* The f32 Gram of a batch of memories (``models.gp._gram``) is one call of
  the Gram wrapper, equals the single calls bit for bit, and matches JAX's
  ``gram_ard_rbf`` under vmap to GRAM_RTOL and GRAM_ATOL (the Pallas Gram's
  tolerance in tests/test_pallas_ops.py), with parameters per memory and
  shared.
* A two-seed f32 mountain-car episode batch (the cuts of
  tests/test_torch_batch_jax.py) against the JAX package's vmapped f32
  batch: F32_EPISODE_TOL, see there.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.envs import jax_dynamics as jd
from gpmpc_tpu.models import gp as jgp
from gpmpc_tpu.ops import pallas_df_mm as jpdm
from gpmpc_tpu.runner import jit_episode as je
from gpmpc_tpu_torch import convert
from gpmpc_tpu_torch.envs import torch_dynamics as td
from gpmpc_tpu_torch.models import gp as tgp
from gpmpc_tpu_torch.ops import df_mm, gram_rbf
from gpmpc_tpu_torch.runner import episode as te
from tests.test_torch_batch_jax import BUDGET, NH, REPEAT, STEPS, WARMUP, _jax_draws
from tests.test_torch_df_mm import PAIR_JAX_RTOL, VJP_RTOL, _np, _rel
from tests.test_torch_episode import _spec_pairs

CPU = torch.device("cpu")
NS, D = 3, 4  # the pendulum's widths, as tests/test_torch_df_mm.py's
N_SPLIT, POINTS, BATCH = 192, 48, 2
P = NS * (NS + 1) // 2
GRAM_RTOL, GRAM_ATOL = 2e-5, 2e-6
# The f32 episode batch against JAX's, relative to each output's largest
# entry: the two packages round their f32 sums (the Gram's, the cov core's,
# the rollout's) in another order, so the predictions and costs part in
# their last bits at each step; measured 2.0e-7 (the cost; pred_std
# 2.0e-7, pred_state 1.1e-7, the observations 8e-10, the actions equal),
# within a few eps32 = 1.2e-7. A wrong refresh or plan moves the plans'
# actions, which feed back into every later output.
F32_EPISODE_TOL = 1e-6


def _stack(caches, index):
    """The caches stacked on a leading axis, element b reading index[b]."""
    fields = {f: torch.stack([getattr(c, f) for c in caches]) for f in caches[0]._fields
              if isinstance(getattr(caches[0], f), torch.Tensor)}
    return tgp.with_index(caches[0]._replace(**fields), index)


MODES = {"shared": [0, 0], "indexed": [1, 0]}  # each element's cache


def _random_cache(seed, n=POINTS, bucket=N_SPLIT, noise=5e-2):
    """tests/test_torch_df_mm.py's well-conditioned random cache (noise
    5e-2, lengthscales 0.6) at these widths, as the port's DFCache."""
    f64 = jnp.float64
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


def _split_inputs(bcache):
    """Each element's mu, B^-1 and Q (df stage 1 of its own state
    covariance) and its hi cotangents."""
    rng = np.random.default_rng(17)
    mu = torch.tensor(rng.uniform(0.3, 0.7, (BATCH, D)), dtype=torch.float32)
    var = np.eye(NS) * 1e-2 + 2e-3
    sv = torch.tensor(np.stack([var * (1 + 0.3 * k) for k in range(BATCH)]), dtype=torch.float32)
    ii, jj, _, _ = df_mm.pair_indices(NS, CPU)
    bh, bl, _, qh, ql, _ = df_mm.df_stage1(bcache, sv, ii, jj)
    g = [torch.tensor(rng.normal(size=(BATCH,) + s), dtype=torch.float32) for s in ((NS,), (NS, D), (P,), (NS,))]
    return mu, bh, bl, qh, ql, g


@pytest.fixture(scope="module")
def split():
    """The two caches, each mode's batched cache and inputs, and JAX's
    vmapped VJPs of every distinct (element, cache) of both modes in one
    batch (the shared mode's two elements, the indexed mode's first)."""
    caches = [_random_cache(seed=3 + k) for k in range(2)]
    modes = {}
    for mode, index in MODES.items():
        bcache = caches[0] if mode == "shared" else _stack(caches, index)
        modes[mode] = (bcache, _split_inputs(bcache))
    combos = [("shared", 0), ("shared", 1), ("indexed", 0)]
    assert all(MODES["indexed"][b] == 0 for b in range(1, BATCH))  # its other elements are the shared mode's
    pick = [torch.stack([modes[m][1][k][b] for m, b in combos]) for k in range(5)]
    g = [torch.stack([modes[m][1][5][k][b] for m, b in combos]) for k in range(4)]
    mean, pairs = _jax_split_vjps(*pick, g, caches, [MODES[m][b] for m, b in combos])
    jax_at = {}
    for mode, index in MODES.items():
        rows = [combos.index((mode, b)) if (mode, b) in combos else combos.index(("shared", b))
                for b in range(BATCH)]
        jax_at[mode] = ([t[rows] for t in mean], [[t[rows] for t in p] for p in pairs])
    return caches, modes, jax_at


def _jax_fields(cache, n_pad):
    """The port cache's df fields as JAX arrays, the N-axis slabs zero-padded
    to n_pad (the reference's _pad_cache_pow2)."""
    out = {}
    for k in df_mm._CACHE_FIELDS:
        v = getattr(cache, k).numpy()
        e = n_pad - cache.x_hi.shape[-2]
        if k in ("x_hi", "x_lo"):
            v = np.pad(v, ((0, e), (0, 0)))
        elif k in ("beta_hi", "beta_lo"):
            v = np.pad(v, ((0, 0), (0, e)))
        elif k in ("iK_hi", "iK_lo"):
            v = np.pad(v, ((0, 0), (0, e), (0, e)))
        out[k] = jnp.asarray(v)
    return out


def _jax_split_vjps(mu, bh, bl, qh, ql, g, caches, index):
    """JAX's vmap over the batch of jax.vjp of ``_mean_part`` (to mu and the
    B^-1 halves) and of each pair's ``_pair_part`` (to mu and the Q_k
    halves), each element on cache index[b]."""
    n_pad = 1 << (N_SPLIT - 1).bit_length()
    per = [_jax_fields(c, n_pad) for c in caches]
    c = {k: jnp.stack([per[i][k] for i in index]) for k in df_mm._CACHE_FIELDS}
    j = {name: jnp.asarray(t.numpy()) for name, t in zip(("mu", "bh", "bl", "qh", "ql"), (mu, bh, bl, qh, ql))}
    g_m, g_v, g_sp, g_corr = (jnp.asarray(t.numpy()) for t in g)

    def mean_vjp(mu, bh, bl, g_m, g_v, c):
        def f(mu, bh, bl):
            return jpdm._mean_part(list(mu), list(bh), list(bl), c["x_hi"], c["x_lo"], c["ils_hi"], c["ils_lo"],
                                   c["beta_hi"], c["beta_lo"], ns=NS, d=D)

        _, pull = jax.vjp(f, mu, bh.reshape(-1), bl.reshape(-1))
        return pull((g_m, jnp.zeros_like(g_m), g_v.reshape(-1), jnp.zeros_like(g_v.reshape(-1))))

    def pair_vjp(mu, qh, ql, gs, gco, c, i_p, j_p):
        def f(mu, qh, ql):
            return jpdm._pair_part(list(mu), list(qh), list(ql), c["x_hi"], c["x_lo"], c["ils_hi"], c["ils_lo"],
                                   c["ils2_hi"], c["ils2_lo"], c["log_outs_hi"], c["log_outs_lo"], c["beta_hi"],
                                   c["beta_lo"], c["iK_hi"], c["iK_lo"], i_p=i_p, j_p=j_p, ns=NS, d=D)

        _, pull = jax.vjp(f, mu, qh.reshape(-1), ql.reshape(-1))
        zero = jnp.zeros_like(gs)
        return pull((gs, zero, gco, zero))

    mean = jax.vmap(mean_vjp)(j["mu"], j["bh"], j["bl"], g_m, g_v, c)
    pairs = []
    for k, (i_p, j_p) in enumerate(zip(*np.triu_indices(NS))):
        gco = g_corr[:, i_p] if i_p == j_p else jnp.zeros_like(g_sp[:, k])
        one = functools.partial(pair_vjp, i_p=int(i_p), j_p=int(j_p))
        pairs.append(jax.vmap(one)(j["mu"], j["qh"][:, k], j["ql"][:, k], g_sp[:, k], gco, c))
    return [np.asarray(t) for t in mean], [[np.asarray(t) for t in p] for p in pairs]


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_split_twins_equal_single_calls_and_match_jax_vmap(split, mode):
    split_caches, modes, jax_at = split
    index = MODES[mode]
    bcache, (mu, bh, bl, qh, ql, g) = modes[mode]
    assert bcache.x_hi.shape[-2] > df_mm.SINGLE_BWD_MAX_N
    (m_h, m_l), g_b = df_mm.stage23_vjp_mean_plain(mu, bh, bl, bcache, g[0], g[1])
    (p_h, p_l), g_q = df_mm.stage23_vjp_pairs_plain(mu, qh, ql, bcache, g[2], g[3])
    split = df_mm.stage23_bwd(mu, bh, bl, qh, ql, bcache, *g)
    assert tuple(split[0].shape) == (BATCH, D) and tuple(split[2].shape) == (BATCH, P, NS, NS)
    for b in range(BATCH):
        c = split_caches[index[b]]
        one = df_mm.stage23_vjp_mean_plain(mu[b], bh[b], bl[b], c, g[0][b], g[1][b])
        assert all(torch.equal(x[b], y) for x, y in zip((m_h, m_l, g_b), (*one[0], one[1]))), b
        one = df_mm.stage23_vjp_pairs_plain(mu[b], qh[b], ql[b], c, g[2][b], g[3][b])
        assert all(torch.equal(x[b], y) for x, y in zip((p_h, p_l, g_q), (*one[0], one[1]))), b
        one = df_mm.stage23_bwd(mu[b], bh[b], bl[b], qh[b], ql[b], c, *(t[b] for t in g))
        assert all(torch.equal(x[b], y) for x, y in zip(split, one)), b

    mean, pairs = jax_at[mode]
    errs = []
    for b in range(BATCH):
        errs.append(_rel(-(m_h[b].double() + m_l[b].double()), mean[0][b]))
        errs += [_rel(g_b[b].reshape(-1), half[b]) for half in mean[1:]]
    print("mean path, port vs JAX vmap:", errs)
    assert max(errs) <= VJP_RTOL, errs
    errs = []
    for k, (g_mu_k, qh_k, ql_k) in enumerate(pairs):
        for b in range(BATCH):
            errs.append(_rel(-(p_h[b, k].double() + p_l[b, k].double()), g_mu_k[b]))
            errs += [_rel(g_q[b, k].reshape(-1), half[b]) for half in (qh_k, ql_k)]
    print("pairs, port vs JAX vmap:", errs)
    assert max(errs) <= PAIR_JAX_RTOL, errs


@pytest.mark.parametrize("params", ["per-memory", "shared"])
def test_batched_gram_is_one_call_equal_to_single_calls_and_matches_jax_vmap(params):
    rng = np.random.default_rng(23)
    n, lead = 37, (BATCH,) if params == "per-memory" else ()
    ls = rng.uniform(0.2, 1.5, lead + (NS, D)).astype(np.float32)
    outs = rng.uniform(0.1, 1.0, lead + (NS,)).astype(np.float32)
    x = rng.uniform(0, 1, (BATCH, n, D)).astype(np.float32)
    with mock.patch.object(gram_rbf, "gram", wraps=gram_rbf.gram) as calls:
        k = tgp._gram(torch.tensor(ls), torch.tensor(outs), torch.tensor(x))
    assert calls.call_count == 1 and tuple(k.shape) == (BATCH, NS, n, n)
    for b in range(BATCH):
        one = tgp._gram(torch.tensor(ls[b] if lead else ls), torch.tensor(outs[b] if lead else outs),
                        torch.tensor(x[b]))
        assert torch.equal(k[b], one), b
    axes = 0 if lead else None
    ref = np.asarray(jax.vmap(jgp.gram_ard_rbf, in_axes=(axes, axes, 0))(jnp.asarray(ls), jnp.asarray(outs),
                                                                         jnp.asarray(x)))
    np.testing.assert_allclose(k.numpy(), ref, rtol=GRAM_RTOL, atol=GRAM_ATOL)


def test_two_seed_f32_episode_batch_matches_jax_vmap():
    """tests/test_torch_batch_jax.py's two-seed mountain-car episode batch
    in f32 (both packages' env, draws, GP and rollout in f32, as the sweep's
    ``--dtype float32`` runs them), the JAX draws fed to
    the port, every per-step output within F32_EPISODE_TOL of its largest
    entry, the memory's counters and flags exactly; f32's one launch of the
    Gram per refresh is counted on the twin: one call per refresh (the
    random evaluations at t = 0 and 2, the plans at t = 4 and 6)."""
    jcfg, tcfg, _, _ = _spec_pairs("mountain_car")
    jenv, tenv = jd.mountain_car_spec(jnp.float32), td.mountain_car_spec(dtype=torch.float32, device=CPU)
    for cfg in (jcfg, tcfg):
        cfg.dtype = "float32"
        cfg.controller.len_horizon = NH
        cfg.controller.num_repeat_actions = REPEAT
        cfg.controller.actions_optimizer_params = {**cfg.controller.actions_optimizer_params, "maxiter": BUDGET,
                                                   "maxfun": BUDGET}
    kw = dict(num_steps=STEPS, warmup=WARMUP, cap=32)
    jspec, jp0 = je.episode_spec_from_config(jenv, jcfg, **kw)
    tspec, tp0 = te.episode_spec_from_config(tenv, tcfg, **kw)
    assert tspec.dtype == torch.float32
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jout = je.build_episodes_batch_fn(jspec)(keys, jp0)
    with mock.patch.object(gram_rbf, "gram", wraps=gram_rbf.gram) as calls:
        tout = te.build_episodes_batch_fn(tspec, draws=_jax_draws(keys, tspec, jnp.float32))([0, 1], tp0)
    assert calls.call_count == STEPS // REPEAT
    gaps = {}
    for k in ("obs", "action_raw", "cost", "env_reward", "pred_state", "pred_std", "final_obs"):
        out, ref = tout[k].numpy(), np.asarray(jout[k])
        assert out.shape == ref.shape, k
        gaps[k] = float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
    print("f32 episode batch, port vs JAX vmap:", gaps)
    assert max(gaps.values()) <= F32_EPISODE_TOL, gaps
    for name in ("flags", "len_mem", "len_last", "len_model"):
        np.testing.assert_array_equal(getattr(tout["final_mem"], name).numpy(),
                                      np.asarray(getattr(jout["final_mem"], name)), err_msg=name)

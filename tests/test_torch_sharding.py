"""The port's multi-device path (gpmpc_tpu_torch.parallel) on the CPU.

Ranks are CPU processes of a gloo group, started from a file rendezvous in
the test's temporary directory (no network port). One module-scoped spawn
per world size (2 and 4 ranks) runs every multi-rank check in each rank and
writes each rank's results to a file; the tests read them. A rank imports
neither JAX nor the JAX package: the JAX references are computed here, in
the test process, on the conftest's 8-device CPU mesh.

Held:

* the shard-mapped f32 and df32 cov cores at 2 and 4 ranks against JAX's
  ``make_shardmapped_cov_core`` / ``make_shardmapped_df_cov_core``
  (``use_pallas=False``, ns = 2, N = 64), values and gradients: the f32
  core to rtol 2e-5 (values) and rtol 2e-4 + atol 2e-5 (gradients), as
  tests/test_sharding.py holds its f32 core; the f64 core to 1e-12 of each
  output's largest entry; the df32 core, under both df32 VJP schemes, to
  rtol 1e-8 (values) and 1e-6 of each gradient's largest entry, as
  tests/test_sharding.py holds its df core. Every rank returns the same
  bits;
* the port's ``dryrun_training_step`` in every rank at 2 and 4 ranks, and
  at 1 rank here;
* the restart-sharded f64 plan bit for bit, and the N-sharded one within
  1e-8, of the replicated port plan (N = 64, 3 and 4 restarts);
* the rectangular plain twins (``cov_bwd_plain``, ``df_cov_bwd_plain``) on
  a 24 x 64 slab against autograd of the plain cores and against JAX's
  ``cov_core_xla`` gradients;
* the dispatch switches: restored on exit and on an exception, the
  override called.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gpmpc_tpu_torch import ops
from gpmpc_tpu_torch.controllers.planner import PlanSpec, _plan_from_cache
from gpmpc_tpu_torch.mappers.action import ActionMapperSpec
from gpmpc_tpu_torch.mappers.reward import RewardSpec
from gpmpc_tpu_torch.models.gp import GPBounds, masked_cholesky_factorize, params_from_constrained
from gpmpc_tpu_torch.ops import df_cov, moment_cov
from gpmpc_tpu_torch.parallel import sharding

WORLDS = (2, 4)
NS, N = 2, 64
DIAG = (0, 2)  # the pairs (0, 0) and (1, 1) of the upper triangle of ns = 2


def _cov_operands(dtype):
    """f32/f64 cov-core operands (P = 3, N = 64, ns = 2) whose outputs do not
    cancel, and a symmetric iK."""
    rng = np.random.default_rng(7)
    p = NS * (NS + 1) // 2
    ik = rng.normal(0, 0.5, (NS, N, N))
    return [x.astype(dtype) for x in (
        rng.normal(-1, 0.3, (p, N)), rng.normal(-1, 0.3, (p, N)), rng.normal(0, 0.2, (p, N, NS)),
        rng.normal(0, 0.2, (p, N, NS)), rng.normal(0, 1.0, (p, N)), rng.normal(0, 1.0, (p, N)),
        (ik + ik.transpose(0, 2, 1)) / 2)]


def _df_operands():
    """The 14 df32 halves of tests/test_sharding.py's df case: the trained-GP
    regime (exponents <= 0, +-1e3 beta, symmetric iK), ns = 2, N = 64."""
    rng = np.random.default_rng(11)
    p = NS * (NS + 1) // 2
    a = -np.abs(rng.normal(2.0, 1.5, (p, N))) * 3.0
    c = -np.abs(rng.normal(2.0, 1.5, (p, N))) * 3.0
    u = rng.normal(0.0, 0.4, (p, N, NS))
    xj = rng.normal(0.0, 0.4, (p, N, NS))
    bi = rng.normal(0.0, 1e3, (p, N))
    bj = rng.normal(0.0, 1e3, (p, N))
    ik = rng.normal(0.0, 30.0, (NS, N, N))
    ik = (ik + np.swapaxes(ik, 1, 2)) / 2.0
    flat = []
    for x in (a, c, u, xj, bi, bj, ik):
        hi = x.astype(np.float32)
        flat += [hi, (x - hi.astype(np.float64)).astype(np.float32)]
    return flat


DF_W = np.arange(1.0, 4.0, dtype=np.float32)  # the loss weights of S_p (P = 3) and corr (ns = 2)
DF_WC = (np.arange(1.0, NS + 1) * 0.7).astype(np.float32)


def _cov_loss(s_p, corr):
    return (s_p * s_p).sum() + corr.sum()


def _port_cov_core(core, dtype):
    """(loss, grads of a, c, U, Xj, bi, bj) of a port cov core."""
    t = [torch.tensor(x) for x in _cov_operands(dtype)]
    leaves = [x.requires_grad_(True) for x in t[:6]]
    loss = _cov_loss(*core(*leaves, t[6], DIAG))
    return [loss.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _port_df_core(core):
    """(loss, grads of ah, ch, Uh, Xjh) of a port df32 core."""
    args = [torch.tensor(x) for x in _df_operands()]
    leaves = [args[i].requires_grad_(True) for i in (0, 2, 4, 6)]
    sh, sl, ch, cl = core(*args, DIAG)
    loss = (torch.tensor(DF_W) * (sh + sl)).sum() + (torch.tensor(DF_WC) * (ch + cl)).sum()
    return [loss.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _plan_problem(restarts):
    """A small f64 planning problem with N = 64 stored points (56 active) and
    ``restarts`` inits."""
    ns, na, nh = 2, 1, 3
    d = ns + na
    rng = np.random.default_rng(5)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    reward = RewardSpec(target_state_action_norm=t(np.full(d, 0.5)), weight_matrix_cost=t(np.eye(d)),
                        target_state_norm=t(np.full(ns, 0.5)), weight_matrix_cost_terminal=t(np.eye(ns)),
                        use_constraints=False, state_min=t(np.zeros(ns)), state_max=t(np.ones(ns)),
                        area_multiplier=1.0, exploration_factor=1.0, clip_lower_bound_cost_to_0=False)
    action = ActionMapperSpec(limit_action_change=False, max_change_action_norm=t([0.1]), len_horizon=nh,
                              dim_action=na)
    spec = PlanSpec(reward=reward, action=action, include_time_model=False, len_horizon=nh, dim_action=na,
                    dim_state=ns, maxiter=3, maxcor=3, maxls=3)
    bounds = GPBounds(min_lengthscale=t(np.full((ns, d), 1e-3)), max_lengthscale=t(np.full((ns, d), 50.0)),
                      min_outputscale=t(np.full(ns, 1e-6)), max_outputscale=t(np.full(ns, 2.0)),
                      min_noise=t(np.full(ns, 1e-7)), max_noise=t(np.full(ns, 1.0)))
    params = params_from_constrained(t(np.full((ns, d), 0.5)), t(np.full(ns, 0.3)), t(np.full(ns, 1e-4)), bounds)
    mask = np.zeros(N, dtype=bool)
    mask[:56] = True
    x = rng.uniform(0, 1, (N, d)) * mask[:, None]
    y = rng.normal(0, 0.05, (N, ns)) * mask[:, None]
    args = (t(x), t(y), torch.tensor(mask), params, bounds, t(rng.uniform(0, 1, ns)), t(np.eye(ns) * 1e-4),
            t(rng.uniform(0, 1, (restarts, nh * na))), t([0.5]), 0)
    return spec, args


def _replicated_plan(spec, args):
    x, y, mask, params, bounds, *rest = args
    return _plan_from_cache(spec, masked_cholesky_factorize(params, bounds, x, y, mask), *rest)


def _rank_main(rank, world, init_file, out_dir):
    """Every multi-rank check, in one rank; writes rank<r>.npz."""
    torch.set_num_threads(1)
    sharding.init_group("cpu", rank, world, init_file)
    try:
        mesh = sharding.make_mesh(world, device="cpu")
        out = {}
        for dtype in (np.float32, np.float64):
            core = sharding.make_shardmapped_cov_core(mesh)
            for i, v in enumerate(_port_cov_core(core, dtype)):
                out[f"cov_{np.dtype(dtype).name}_{i}"] = v
        for mode in ("residual", "stacked"):
            df_cov.VJP_MODE = mode
            try:
                for i, v in enumerate(_port_df_core(sharding.make_shardmapped_df_cov_core(mesh))):
                    out[f"df_{mode}_{i}"] = v
            finally:
                df_cov.VJP_MODE = "residual"
        for restarts in (3, 4):
            spec, args = _plan_problem(restarts)
            a_ref, _, info_ref = _replicated_plan(spec, args)
            a_r, info_r = sharding.build_sharded_plan_fn(spec, sharding.make_mesh(world, device="cpu"))(*args)
            a_n, _, info_n = sharding.build_nsharded_plan_fn(spec, mesh)(*args)
            out[f"plan{restarts}_restart_equal"] = np.array(
                torch.equal(a_r, a_ref) and all(torch.equal(u, v) for u, v in zip(info_r, info_ref)))
            out[f"plan{restarts}_nshard_gap"] = np.array(max(
                float((u - v).abs().max()) for u, v in zip((a_n, *info_n), (a_ref, *info_ref))))
        sharding.dryrun_training_step(world, device="cpu")
        out["dryrun_ok"] = np.array(True)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    """{world: [each rank's results]} from one spawn per world size."""
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world in WORLDS:
            out = Path(tmp) / f"w{world}"
            out.mkdir()
            mp.spawn(_rank_main, args=(world, str(out / "init"), str(out)), nprocs=world, join=True)
            results[world] = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    return results


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's shard-mapped cores on the 8-device mesh, the same losses."""
    import jax
    import jax.numpy as jnp

    from gpmpc_tpu.parallel.sharding import make_mesh, make_shardmapped_cov_core, make_shardmapped_df_cov_core

    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    mesh = make_mesh(8, axis="n")
    refs = {}
    for dtype in (np.float32, np.float64):
        ops_ = [jnp.asarray(x) for x in _cov_operands(dtype)]
        core = make_shardmapped_cov_core(mesh, axis="n", use_pallas=False)

        def loss(*t):
            return _cov_loss(*core(*t, ops_[6], DIAG))

        with mesh:
            val, grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6))))(*ops_[:6])
        refs[np.dtype(dtype).name] = [np.asarray(val)] + [np.asarray(g) for g in grads]
    flat = [jnp.asarray(x) for x in _df_operands()]
    core = make_shardmapped_df_cov_core(mesh, axis="n", use_pallas=False)

    def df_loss(ah, ch, uh, xjh):
        args = list(flat)
        args[0], args[2], args[4], args[6] = ah, ch, uh, xjh
        sh, sl, co_h, co_l = core(*args, DIAG)
        return jnp.sum(jnp.asarray(DF_W) * (sh + sl)) + jnp.sum(jnp.asarray(DF_WC) * (co_h + co_l))

    with mesh:
        val, grads = jax.jit(jax.value_and_grad(df_loss, argnums=(0, 1, 2, 3)))(flat[0], flat[2], flat[4], flat[6])
    refs["df"] = [np.asarray(val)] + [np.asarray(g) for g in grads]
    return refs


def _outputs(res, prefix):
    return [res[k] for k in sorted((k for k in res if k.startswith(prefix)), key=lambda k: int(k.rsplit("_", 1)[1]))]


@pytest.mark.parametrize("world", WORLDS)
def test_shardmapped_cov_cores_match_jax(ranks, jax_refs, world):
    """The f32 and f64 cores: values and the gradients of all six operands
    (the column operands' summed over the ranks, not scaled by their
    number)."""
    for dtype, rtol, atol in (("float32", 2e-4, 2e-5), ("float64", 1e-12, 0.0)):
        got = _outputs(ranks[world][0], f"cov_{dtype}_")
        ref = jax_refs[dtype]
        if dtype == "float32":
            np.testing.assert_allclose(got[0], ref[0], rtol=2e-5)
            for g, r in zip(got[1:], ref[1:]):
                np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)
        else:
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("mode", ["residual", "stacked"])
@pytest.mark.parametrize("world", WORLDS)
def test_shardmapped_df_cov_core_matches_jax(ranks, jax_refs, world, mode):
    """The df32 core (its partials combined by the all_gather and df tree)
    under each df32 VJP scheme: the value and the gradients of a, c, U, Xj."""
    got = _outputs(ranks[world][0], f"df_{mode}_")
    ref = jax_refs["df"]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-8)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_bits(ranks, world):
    first = ranks[world][0]
    for other in ranks[world][1:]:
        assert first.keys() == other.keys()
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_and_sharded_plans_match_the_replicated_plan(ranks, world):
    """dryrun_training_step passed in every rank; the restart-sharded plan is
    the replicated plan bit for bit (3 restarts: uneven chunks; 4), the
    N-sharded plan within 1e-8 (a_opt and every TrajectoryInfo field)."""
    for res in ranks[world]:
        assert bool(res["dryrun_ok"])
        for restarts in (3, 4):
            assert bool(res[f"plan{restarts}_restart_equal"])
            assert float(res[f"plan{restarts}_nshard_gap"]) <= 1e-8


def test_one_rank_dryrun_and_bitwise_plans(monkeypatch):
    """At one rank (a gloo group on a HashStore): the dry run, both sharded
    plans bit for bit equal to the replicated plan (a one-rank sum and
    gather change no bit), the N-sharded plan through the shard-mapped core,
    and the mesh's refusals."""
    sharding.init_group("cpu")
    try:
        sharding.dryrun_training_step(1, device="cpu")
        spec, args = _plan_problem(2)
        a_ref, _, info_ref = _replicated_plan(spec, args)
        mesh = sharding.make_mesh(1, device="cpu")
        a_r, info_r = sharding.build_sharded_plan_fn(spec, mesh)(*args)
        calls = []
        core = sharding._ShardedCore.apply
        monkeypatch.setattr(sharding._ShardedCore, "apply", lambda *a: calls.append(a[0].combine) or core(*a))
        a_n, _, info_n = sharding.build_nsharded_plan_fn(spec, mesh)(*args)
        assert calls and set(calls) == {sharding._sum_outputs}
        for a, info in ((a_r, info_r), (a_n, info_n)):
            assert torch.equal(a, a_ref) and all(torch.equal(u, v) for u, v in zip(info, info_ref))
        with pytest.raises(ValueError, match="need 2 ranks"):
            sharding.make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="nccl"):
            sharding.make_mesh(1, device="cuda")
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        sharding.make_mesh(1, device="cpu")


def test_uneven_n_raises():
    spec, args = _plan_problem(1)
    x, y, mask, params, bounds = args[:5]
    cache = masked_cholesky_factorize(params, bounds, x, y, mask)
    mesh = sharding.Mesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="do not split evenly over 3 ranks"):
        sharding.shard_cache_n(cache, mesh)


def test_shard_cache_n_cuts_the_square_fields_to_row_slabs():
    _, args = _plan_problem(1)
    x, y, mask, params, bounds = args[:5]
    cache = masked_cholesky_factorize(params, bounds, x, y, mask)
    mesh = sharding.Mesh(group=None, rank=1, size=4, device=torch.device("cpu"))
    sharded = sharding.shard_cache_n(cache, mesh)
    assert torch.equal(sharded.iK, cache.iK[:, 16:32]) and torch.equal(sharded.L, cache.L[:, 16:32])
    for name in ("x_mem", "mask", "beta", "y_mem"):
        assert getattr(sharded, name) is getattr(cache, name)


# ---------------------------------------------------------------------------
# the rectangular plain twins (the CPU path of #3's and #7's backwards)
# ---------------------------------------------------------------------------

NR = 24  # a row slab of 24 stored points against N = 64 columns


def _rect_cov(dtype):
    a, c, u, xj, bi, bj, ik = _cov_operands(dtype)
    return [a[:, :NR], c, u[:, :NR], xj, bi[:, :NR], bj, ik[:, :NR]]


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_rectangular_cov_bwd_plain_matches_autograd_and_jax(dtype, rtol):
    """cov_bwd_plain on a 24 x 64 slab (the column side on iK's transpose)
    against autograd of the plain core and JAX's VJP of cov_core_xla, each
    output relative to its largest entry; CovCore's autograd takes it too."""
    import jax
    import jax.numpy as jnp

    from gpmpc_tpu.ops import cov_core_xla

    args = [np.ascontiguousarray(x) for x in _rect_cov(dtype)]
    g = np.array([1.0, -0.5, 2.0], dtype=dtype)
    g_corr = np.array([1.5, -2.0], dtype=dtype)
    _, vjp = jax.vjp(lambda *t: cov_core_xla(*t, jnp.asarray(args[6]), DIAG), *(jnp.asarray(v) for v in args[:6]))
    ref = [np.asarray(r) for r in vjp((jnp.asarray(g), jnp.asarray(g_corr)))]
    t = [torch.tensor(v) for v in args]
    plain = moment_cov.cov_bwd_plain(torch.tensor(g), *t, torch.tensor(g_corr), DIAG)
    leaves = [x.clone().requires_grad_(True) for x in t[:6]]
    s, co = moment_cov.cov_core_ref(*leaves, t[6], DIAG)
    auto = torch.autograd.grad((s * torch.tensor(g)).sum() + (co * torch.tensor(g_corr)).sum(), leaves)
    leaves = [x.clone().requires_grad_(True) for x in t[:6]]
    s, co = moment_cov.CovCore.apply(*leaves, t[6], DIAG)
    via_core = torch.autograd.grad((s * torch.tensor(g)).sum() + (co * torch.tensor(g_corr)).sum(), leaves)
    for outs in (plain, auto, via_core):
        for out, r in zip(outs, ref):
            assert out.shape == r.shape
            scale = np.abs(r).max()
            np.testing.assert_allclose(out.detach().numpy() / scale, r / scale, rtol=0, atol=rtol)


def test_rectangular_df_cov_bwd_plain_matches_autograd_and_jax():
    """df_cov_bwd_plain on a 24 x 64 slab: the row side's ga, gU and the
    column side's gc, gXj against the f64 autograd of the f64 plain core on
    the collapsed operands, at the hi cotangents (one f32 rounding of each
    entry, the twin's final collapse, plus 1e-9 of each output's largest
    entry), and DfCovCoreStacked's gradients (which take it) against
    JAX's gradients of df_cov_core_xla on the slab (3e-6, as the square
    slabs are held in tests/test_torch_df32.py)."""
    import jax
    import jax.numpy as jnp

    from gpmpc_tpu.ops import df_cov_core_xla

    flat = _df_operands()
    for i in (0, 1, 4, 5, 8, 9, 12, 13):  # the row operands and iK: the slab's rows
        flat[i] = np.ascontiguousarray(flat[i][:, :NR])
    t = [torch.tensor(x) for x in flat]
    gs = torch.tensor(DF_W)
    gco = torch.zeros(3).index_copy(0, torch.tensor(DIAG), torch.tensor(DF_WC))
    out = df_cov.df_cov_bwd_plain(*t, gs, gco, DIAG)

    v = [(t[2 * i].double() + t[2 * i + 1].double()).requires_grad_(i < 4) for i in range(7)]
    e = torch.exp(torch.clamp(v[0][:, :, None] + v[1][:, None, :] + torch.einsum("pne,pke->pnk", v[2], v[3]),
                              max=60.0))
    sp = torch.einsum("pn,pnk,pk->p", v[4], e, v[5])
    corr = torch.einsum("mnk,mnk->m", v[6], e[list(DIAG)])
    ref = torch.autograd.grad((gs.double() * sp).sum() + (torch.tensor(DF_WC).double() * corr).sum(), v[:4])
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.double().numpy(), r.numpy(), rtol=2.0 ** -23, atol=1e-9 * float(r.abs().max()))

    jflat = [jnp.asarray(x) for x in flat]

    def loss(ah, ch, uh, xjh):
        args = list(jflat)
        args[0], args[2], args[4], args[6] = ah, ch, uh, xjh
        sh, sl, co_h, co_l = df_cov_core_xla(*args, DIAG)
        return jnp.sum(jnp.asarray(DF_W) * (sh + sl)) + jnp.sum(jnp.asarray(DF_WC) * (co_h + co_l))

    gx = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(jflat[0], jflat[2], jflat[4], jflat[6])
    leaves = [t[i].clone().requires_grad_(True) for i in (0, 2, 4, 6)]
    args = list(t)
    args[0], args[2], args[4], args[6] = leaves
    sh, sl, ch, cl = df_cov.DfCovCoreStacked.apply(*args, DIAG)
    got = torch.autograd.grad((gs * (sh + sl)).sum() + (torch.tensor(DF_WC) * (ch + cl)).sum(), leaves)
    for g_t, g_x in zip(got, gx):
        g_x = np.asarray(g_x)
        np.testing.assert_allclose(g_t.numpy(), g_x, rtol=0, atol=3e-6 * np.abs(g_x).max())


def test_rectangular_cov_bwd_plan_covers_both_sides():
    """#3's grid on a rectangular slab: ceil(max(Nr, Nc) / 8) row blocks, so
    the column side's Nc rows (Nc > Nr) and the row side's Nr rows are all
    owned; see tests/test_torch_launch_plans.py for the element coverage."""
    plan = moment_cov.bwd_launch_plan(3, NR, N)
    assert plan["row_blocks"] * moment_cov.BWD_WARPS >= N and plan["stacked_pairs"] == 6
    assert plan == moment_cov.bwd_launch_plan(3, N, NR)


# ---------------------------------------------------------------------------
# the dispatch switches
# ---------------------------------------------------------------------------


def test_switches_restore_on_exit_and_on_exception():
    for switch, attr, arg in ((ops.disable_pallas, "_PALLAS_DISABLED", ()),
                              (ops.override_cov_core, "_COV_CORE_OVERRIDE", (len,)),
                              (ops.override_df_cov_core, "_DF_COV_CORE_OVERRIDE", (len,))):
        before = getattr(ops, attr)
        with switch(*arg):
            assert getattr(ops, attr) is not before
            with switch(*arg):  # nested: restores the outer state
                pass
            assert getattr(ops, attr) is not before
        assert getattr(ops, attr) is before
        with pytest.raises(KeyError):
            with switch(*arg):
                raise KeyError("inside")
        assert getattr(ops, attr) is before


def test_overrides_are_called_before_every_other_rule():
    seen = []
    cov = [torch.tensor(x) for x in _cov_operands(np.float64)]
    df = [torch.tensor(x) for x in _df_operands()]

    def cov_override(*args):
        seen.append(("cov", len(args)))
        return moment_cov.cov_core_ref(*args)

    def df_override(*args):
        seen.append(("df", len(args)))
        return df_cov.df_cov_core_ref(*args)

    with ops.disable_pallas(), ops.override_cov_core(cov_override), ops.override_df_cov_core(df_override):
        ops.cov_core(*cov, DIAG)
        ops.df_cov_core(*df, DIAG)
        assert not ops.use_df_fused(64, 2, 3, "cuda")
    assert seen == [("cov", 8), ("df", 15)]
    assert ops.use_df_fused(64, 2, 3, "cuda")  # restored: the card's whole-step range again


def test_disable_pallas_takes_the_plain_forms():
    """Under the switch the Gram and the cores on a CUDA-less tensor of any
    kind take their plain forms (here: a meta tensor, which the kernels'
    wrappers refuse)."""
    ls, outs = torch.ones(2, 3, device="meta"), torch.ones(2, device="meta")
    x = torch.ones(5, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gram(ls, outs, x)
    with ops.disable_pallas():
        assert ops.gram(ls, outs, x).shape == (2, 5, 5)
        args = [torch.ones(3, 8, device="meta"), torch.ones(3, 8, device="meta"), torch.ones(3, 8, 2, device="meta"),
                torch.ones(3, 8, 2, device="meta"), torch.ones(3, 8, device="meta"), torch.ones(3, 8, device="meta"),
                torch.ones(2, 8, 8, device="meta")]
        s, co = ops.cov_core(*args, DIAG)
        assert s.shape == (3,) and co.shape == (2,)
        df_args = [x for a in args for x in (a, a)]
        assert [o.shape for o in ops.df_cov_core(*df_args, DIAG)] == [(3,), (3,), (2,), (2,)]

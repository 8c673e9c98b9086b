"""Multi-device scaling on torch.distributed: the port of
``gpmpc_tpu/parallel/sharding.py``.

The reference spreads three embarrassingly parallel axes over a 1-D device
mesh; here the mesh is a torch.distributed process group, one rank per
device, every rank running the same program (SPMD by hand: PyTorch has no
GSPMD, so each collective is written out):

* optimizer restarts (``build_sharded_plan_fn``): each rank runs its
  contiguous chunk of the restarts through the planner's restart batch; an
  ``all_gather`` of (x, f) and the first argmin pick the plan;
* the stored-point axis N (``shard_cache_n``, ``build_nsharded_plan_fn``):
  each rank contracts its row slab of the (P, N, N) moment-matching kernel
  matrix in the shard-mapped cov cores, whose partials are combined across
  ranks (an ``all_reduce`` for the f32/f64 core; an ``all_gather`` and a
  pairwise df32 tree for the df32 core);
* training restarts (``build_sharded_train_fn``): each rank runs its chunk
  of the MLL restarts; an ``all_gather`` and the keep-best rule pick the
  parameters.

The group's backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors (``init_group``). A failed NCCL initialisation raises; nothing
falls back to another backend. ``dryrun_training_step`` runs the whole
composite on tiny shapes in every rank of a group and holds each sharded
result to its replicated twin.

Every rank computes the same replicated values outside the sharded
contractions, so every rank takes the same optimizer decisions and calls
the same collectives in the same order.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import ops
from ..controllers.planner import PlanSpec, _best_restart, _cast_cache, _plan_from_cache, _run_restarts
from ..models.gp import (
    FactorizationCache,
    GPBounds,
    GPParams,
    TrainConfigDevice,
    keep_best,
    masked_cholesky_factorize,
    params_from_constrained,
    train_hyperparams,
    train_restarts,
    training_draws,
)
from ..ops import moment_cov
from ..ops.df32 import df_add


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_group(device, rank: int = 0, world_size: int = 1, init_file: Optional[str] = None) -> torch.device:
    """Initialise the default process group for ``device``'s backend (NCCL
    for a CUDA device, gloo for the CPU) and return this rank's device (a
    CUDA device without an index takes ``cuda:rank``). The rendezvous is a
    file (``init_file``, a ``file://`` init shared by the ranks) or, for one
    rank without a file, an in-process ``HashStore``: no network port. One
    collective follows, so a failed NCCL initialisation raises here."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank if device.index is None else device.index)
        torch.cuda.set_device(device)
    backend = _backend(device)
    if init_file is None:
        if world_size != 1:
            raise ValueError("more than one rank needs a shared init_file")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world_size)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if float(probe) != world_size:
        raise RuntimeError(f"process group check: all_reduce gave {float(probe)} over {world_size} ranks")
    return device


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group, this rank, the group's size and this
    rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D mesh over the default process group (``init_group``), on
    ``device`` (``cuda:rank`` by default). Raises when no group is
    initialised, when the group has fewer ranks than ``n_devices`` (or more:
    a mesh is the whole group), or when the group's backend does not serve
    the device. The reference's fallback to virtual CPU devices has no
    counterpart: a CPU mesh is a gloo group of CPU processes. Nor have its
    axis names: a group has one axis, so no function of this module takes
    the reference's ``axis`` argument."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_group (or init_process_group) first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and size != n_devices:
        raise ValueError(f"need {n_devices} ranks, the process group has {size}")
    device = torch.device("cuda", rank) if device is None else torch.device(device)
    if dist.get_backend() != _backend(device):
        raise ValueError(f"a {device.type} mesh needs the {_backend(device)} backend, the group has "
                         f"{dist.get_backend()}")
    return Mesh(group=dist.group.WORLD, rank=rank, size=size, device=device)


def _gather(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (all the same shape), concatenated in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=dim)


def _sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``t``, the same on every rank."""
    t = t.clone().contiguous()
    dist.all_reduce(t, group=mesh.group)
    return t


def _chunk(count: int, mesh: Mesh):
    """This rank's contiguous chunk of ``count`` items: (start, stop, the
    chunk length every rank pads to). Rank r's chunk starts at r * per, so
    the ranks' padded chunks, gathered in rank order, hold item i at i and
    the padding after the last item."""
    per = -(-count // mesh.size)
    start = min(count, mesh.rank * per)
    return start, min(count, start + per), per


def _pad(t: torch.Tensor, length: int, value: float) -> torch.Tensor:
    """``t`` padded along dim 0 to ``length`` rows of ``value``."""
    pad = torch.full((length - t.shape[0],) + tuple(t.shape[1:]), value, dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


# ---------------------------------------------------------------------------
# restart-sharded planning
# ---------------------------------------------------------------------------


def build_sharded_plan_fn(spec: PlanSpec, mesh: Mesh):
    """Planning step with the restarts split across the mesh's ranks.

    The planner's ``_plan_from_cache`` with a gather in the middle: every
    rank factorizes (replicated) and runs its contiguous chunk of ``inits``
    through the planner's restart batch (``_run_restarts``); the ranks
    ``all_gather`` the chunks' (x, f); the planner's ``_best_restart`` then
    keeps the first least objective, a NaN counted as +inf (JAX's argmin;
    the first restart when every one is NaN), and recomputes the info at
    a_opt. Each restart's arithmetic is the one the replicated planner
    does, so the plan equals it (bit for bit on a deterministic device).
    Returns plan(x_pad, y_pad, mask, params, bounds, state_mu, state_var,
    inits, action_prev, iter_ctrl) -> (a_opt, info), on tensors of
    ``mesh.device``."""

    def plan(x_pad, y_pad, mask, params: GPParams, bounds: GPBounds, state_mu, state_var, inits, action_prev,
             iter_ctrl):
        cache = _cast_cache(masked_cholesky_factorize(params, bounds, x_pad, y_pad, mask), state_mu.dtype)
        r = inits.shape[0]
        start, stop, per = _chunk(r, mesh)
        xs, fs = _run_restarts(spec, cache, state_mu, state_var, inits[start:stop], action_prev, iter_ctrl)
        xs = _gather(_pad(xs.detach(), per, 0.0), mesh)[:r]
        fs = _gather(_pad(fs.detach(), per, float("nan")), mesh)[:r]
        a_opt, _, info = _best_restart(spec, cache, xs, fs, state_mu, state_var, action_prev, iter_ctrl)
        return a_opt, info

    return plan


# ---------------------------------------------------------------------------
# N-sharded planning: the cache's row slabs and the shard-mapped cov cores
# ---------------------------------------------------------------------------


def _rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of the stored-point axis of length N."""
    if n % mesh.size:
        raise ValueError(f"N = {n} stored points do not split evenly over {mesh.size} ranks (the buckets are "
                         f"multiples of 32; use a mesh whose size divides N)")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_cache_n(cache: FactorizationCache, mesh: Mesh) -> FactorizationCache:
    """The cache with its two O(N^2) fields cut to this rank's row slab of
    the stored-point axis: iK (Ns, N/ranks, N), which the shard-mapped cov
    cores read, and L (Ns, N/ranks, N), which planning never reads.

    What runs where (PyTorch has no GSPMD to decide it): the (P, N, N)
    pairwise contraction of moment matching, the step's only O(N^2) work,
    runs on the rank's rows inside the shard-mapped cores
    (``make_shardmapped_cov_core``, ``make_shardmapped_df_cov_core``), its
    S_p and corr partials combined across ranks. The O(N) work stays
    replicated, so x_mem, mask, beta and y_mem stay whole on every rank: the
    mean path (lb, M, V: O(Ns N D)) and the pair operands (a, c, U, Xj,
    beta[ii], beta[jj]: O(P N ns)). Cutting them to the slab as well would
    take an all_reduce of M and V and an all_gather of the column operands
    (c, Xj, beta[jj]) back to full length before the core, more traffic than
    the replicated work it saves. A sharded cache is for planning: the rank-1
    append (``extend_factorization``) needs the whole L and iK."""
    rows = _rows(mesh, cache.x_mem.shape[0])
    return cache._replace(iK=cache.iK[:, rows].contiguous(), L=cache.L[:, rows].contiguous())


def _slab(t: torch.Tensor, rows: slice, n: int) -> torch.Tensor:
    """An iK operand as this rank's row slab: sliced from the whole (Ns, N,
    N), or taken as given when it is already the (Ns, N/ranks, N) slab."""
    if t.shape[1] == n:
        return t[:, rows]
    if t.shape[1] == rows.stop - rows.start:
        return t
    raise ValueError(f"iK of shape {tuple(t.shape)} is neither whole ({n} rows) nor a {rows.stop - rows.start}-row slab")


class _ShardedCore(torch.autograd.Function):
    """A cov core over the mesh, differentiable: the rank's row slab through
    the local core, its outputs combined across ranks.

    Forward: the row operands (``plan.row_args``) and the iK operands
    (``plan.ik_args``, unless already slabs) are cut to this rank's rows, the
    column operands stay whole; ``plan.local`` runs on them, building its own
    autograd graph where a gradient is wanted (so the local core's backward,
    kernels included, runs once, in this backward); ``plan.combine`` merges
    the ranks' outputs. Backward: the output cotangents, the same on every
    rank, go unchanged to the local outputs (a sum's transpose); the local
    gradients of the row operands are ``all_gather``ed to full length, those
    of the column operands (each rank's partial) ``all_reduce``d, an iK
    slab's gathered where iK came whole. So every rank returns the same full
    gradients: the transpose that JAX's shard_map applies. A collective's
    own autograd (``torch.distributed.nn``) would instead all-reduce the
    replicated cotangents, multiplying them by the number of ranks."""

    @staticmethod
    def forward(ctx, plan, *operands):
        n = operands[plan.row_args[0]].shape[1]
        rows = _rows(plan.mesh, n)
        local_in, cut = [], []
        for i, t in enumerate(operands):
            if i in plan.row_args:
                t, c = t[:, rows], True
            elif i in plan.ik_args:
                t, c = _slab(t, rows, n), t.shape[1] == n
            else:
                c = False
            t = t.detach().contiguous()
            if ctx.needs_input_grad[1 + i]:
                t.requires_grad_(True)
            local_in.append(t)
            cut.append(c)
        with torch.enable_grad():
            local_out = plan.local(*local_in)
        ctx.plan, ctx.cut, ctx.local_in, ctx.local_out = plan, cut, local_in, local_out
        return plan.combine(plan.mesh, [o.detach() for o in local_out])

    @staticmethod
    def backward(ctx, *cts):
        plan = ctx.plan
        wanted = [i for i, t in enumerate(ctx.local_in) if t.requires_grad]
        outs = [(o, ct) for o, ct in zip(ctx.local_out, cts) if o.requires_grad]
        local = torch.autograd.grad([o for o, _ in outs], [ctx.local_in[i] for i in wanted],
                                    grad_outputs=[torch.zeros_like(o) if ct is None else ct for o, ct in outs],
                                    allow_unused=True)
        grads = [None] * len(ctx.local_in)
        for i, g in zip(wanted, local):  # None alike on every rank: the local graphs are the same
            if g is not None:
                grads[i] = _gather(g, plan.mesh, dim=1) if ctx.cut[i] else (
                    g if i in plan.ik_args else _sum(g, plan.mesh))
        return (None, *grads)


def _sum_outputs(mesh: Mesh, outs):
    """S_p and corr summed over the ranks (one all_reduce of both)."""
    s_p, corr = outs
    both = _sum(torch.cat([s_p, corr]), mesh)
    return both[:s_p.shape[0]], both[s_p.shape[0]:]


def df_tree_axis0(h, l):
    """(ranks, ...) df partials -> (...) df-summed, pairwise in rank order."""
    chunks = [(h[i], l[i]) for i in range(h.shape[0])]
    while len(chunks) > 1:
        nxt = [df_add(*chunks[i], *chunks[i + 1]) for i in range(0, len(chunks) - 1, 2)]
        if len(chunks) % 2:
            nxt.append(chunks[-1])
        chunks = nxt
    return chunks[0]


def _df_tree_outputs(mesh: Mesh, outs):
    """The df (S_p h, l, corr h, l) partials combined without losing their
    compensation: an all_gather of every rank's pairs, then a pairwise df
    tree in rank order, the same on every rank. A component-wise all_reduce
    would sum the hi parts in plain f32: the S_p partials are ~1e3-magnitude
    terms cancelling to ~1e-2, and that sum re-loses exactly the bits the
    df32 pipeline keeps."""
    sh, sl, ch, cl = outs
    p = sh.shape[0]
    allp = _gather(torch.stack([torch.cat([sh, ch]), torch.cat([sl, cl])])[None], mesh)  # (ranks, 2, P + n_diag)
    h, l = df_tree_axis0(allp[:, 0], allp[:, 1])
    return h[:p], l[:p], h[p:], l[p:]


def make_shardmapped_cov_core(mesh: Mesh):
    """The moment-matching cov core over the mesh: each rank contracts its
    (P, N/ranks) row slab (a, U, bi and iK's rows) against the whole columns
    (c, Xj, bj) and the S_p / corr partials are all_reduced.

    The local core is ``ops.cov_core``'s by-device rule without the
    switches (this core is what the N-sharded planner installs under
    ``disable_pallas``), float64 taking the plain core by the dtype rule of
    ``models.gp``: on a float32 CUDA tensor of at most ``ops.COV_MAX_NS``
    state dims the kernel pair (#2 forward, #3 backward, whose rectangular
    launch serves the slab; #4 where iK needs a gradient), else the plain
    core. The reference's ``use_pallas`` and
    ``min_pallas_rows`` (a TPU threshold) are not copied. Returns core(a, c,
    u, xj, bi, bj, ik, diag_pos) -> (s_p, corr), ``ik`` whole (Ns, N, N) or
    the rank's slab."""

    def core(a, c, u, xj, bi, bj, ik, diag_pos):
        diag = tuple(int(v) for v in diag_pos)
        local = moment_cov.cov_core_ref if a.dtype == torch.float64 else ops._cov_core_by_device
        plan = SimpleNamespace(mesh=mesh, row_args=(0, 2, 4), ik_args=(6,), combine=_sum_outputs,
                               local=lambda *t: local(*t, diag))
        return _ShardedCore.apply(plan, a, c, u, xj, bi, bj, ik)

    return core


def make_shardmapped_df_cov_core(mesh: Mesh):
    """The df32 cov core over the mesh (the trained-GP regime): each rank
    contracts its row slab (a, U, bi and iK's rows, hi and lo) against the
    whole columns (c, Xj, bj) and the df partials are combined by an
    all_gather and a pairwise df tree in rank order (``_df_tree_outputs``).

    The local core is ``ops.df_cov_core``'s by-device rule without the
    switches: under autograd the residual scheme (#6; the stacked one, #5
    then #7's one-side-per-launch rectangular backward, when
    ``df_cov.VJP_MODE`` is "stacked"), else the lean forward (#5); the plain
    twins on the CPU, the plain core past ``ops.DF_COV_MAX_NS`` state dims
    on the card. The reference's ``use_pallas`` is not copied. Returns
    core(*14 df operands, diag_pos) -> (Sp_h, Sp_l, corr_h, corr_l)."""

    def core(*args):
        *operands, diag_pos = args
        diag = tuple(int(v) for v in diag_pos)
        plan = SimpleNamespace(mesh=mesh, row_args=(0, 1, 4, 5, 8, 9), ik_args=(12, 13), combine=_df_tree_outputs,
                               local=lambda *t: ops._df_cov_core_by_device(*t, diag))
        return _ShardedCore.apply(plan, *operands)

    return core


def build_nsharded_plan_fn(spec: PlanSpec, mesh: Mesh):
    """Planning step with the stored-point axis N sharded across the mesh.

    The same signature and result as the planner's ``_plan_from_cache`` on a
    fresh factorization: the f64 (or f32) master is factorized whole on
    every rank (the Cholesky does not partition), cut to the rank's slab
    (``shard_cache_n``) and planned under ``ops.disable_pallas()`` with both
    shard-mapped cores installed, as the reference's ``call`` does. So the
    Gram and the whole-step kernels are off on this path, and the cov
    kernels run on each rank's slab (mixed mode: an f64 master split into
    the df32 rollout cache, whose iK halves are the slab's)."""
    cov_override = make_shardmapped_cov_core(mesh)
    df_cov_override = make_shardmapped_df_cov_core(mesh)

    def plan(x_pad, y_pad, mask, params: GPParams, bounds: GPBounds, state_mu, state_var, inits, action_prev,
             iter_ctrl):
        with ops.disable_pallas(), ops.override_cov_core(cov_override), ops.override_df_cov_core(df_cov_override):
            cache = shard_cache_n(masked_cholesky_factorize(params, bounds, x_pad, y_pad, mask), mesh)
            return _plan_from_cache(spec, cache, state_mu, state_var, inits, action_prev, iter_ctrl)

    return plan


# ---------------------------------------------------------------------------
# restart-sharded training
# ---------------------------------------------------------------------------


def build_sharded_train_fn(bounds: GPBounds, cfg: TrainConfigDevice, mesh: Mesh, restarts: int):
    """Hyperparameter training with the restarts split across the mesh.

    Every rank draws the same full (restarts, Ns, D+2) re-init fractions
    from its own copy of one generator (or takes the given ``draws``), runs
    its contiguous chunk of restarts (``models.gp.train_restarts``), and the
    ranks all_gather the chunks' best (raw, loss); the reference's keep-best
    rule (``models.gp.keep_best``) then picks each model's parameters. So
    the result equals ``train_hyperparams(..., draws=...)`` on one device.
    Returns train(params, x, y, mask, generator=None, draws=None) ->
    (best_params, best_losses)."""

    def train(params: GPParams, x, y, mask, generator: Optional[torch.Generator] = None, draws=None):
        draws = training_draws(params, x, generator, restarts, draws)
        start, stop, per = _chunk(restarts, mesh)
        raws, losses = train_restarts(params, bounds, x, y, mask, cfg, draws[start:stop])
        raws = _gather(_pad(raws.detach(), per, 0.0), mesh)[:restarts]
        losses = _gather(_pad(losses.detach(), per, float("inf")), mesh)[:restarts]
        return keep_best(params, bounds, x, y, mask, raws, losses)

    return train


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def dryrun_training_step(n_devices: int, dtype=torch.float64, device=None) -> None:
    """One full sharded control-training step on tiny shapes, held to its
    replicated twin; called in every rank of an initialised group of
    ``n_devices`` ranks, on ``device`` (``cuda:rank`` by default).

    Asserts what the reference asserts at its shapes (Ns = 2, Na = 1,
    horizon 3, N = 8, one restart per rank): the restart-sharded plan equals
    the replicated planner (1e-8), the N-sharded plan too (1e-8), the
    N-sharded mixed (f64 master, df32 rollout) plan is finite and inside the
    box (f64 runs only), and the restart-sharded training equals the
    unsharded keep-best training (1e-8)."""
    from ..mappers.action import ActionMapperSpec
    from ..mappers.reward import RewardSpec

    ns, na, nh, n = 2, 1, 3, 8
    d = ns + na
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    rng = np.random.default_rng(0)

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    reward_spec = RewardSpec(
        target_state_action_norm=t(np.full(ns + na, 0.5)), weight_matrix_cost=t(np.eye(ns + na)),
        target_state_norm=t(np.full(ns, 0.5)), weight_matrix_cost_terminal=t(np.eye(ns)), use_constraints=False,
        state_min=t(np.zeros(ns)), state_max=t(np.ones(ns)), area_multiplier=1.0, exploration_factor=1.0,
        clip_lower_bound_cost_to_0=False,
    )
    action_spec = ActionMapperSpec(limit_action_change=False, max_change_action_norm=t(np.full(na, 0.1)),
                                   len_horizon=nh, dim_action=na)
    plan_spec = PlanSpec(reward=reward_spec, action=action_spec, include_time_model=False, len_horizon=nh,
                         dim_action=na, dim_state=ns, maxiter=2, maxcor=3, maxls=3)
    bounds = GPBounds(
        min_lengthscale=t(np.full((ns, d), 1e-3)), max_lengthscale=t(np.full((ns, d), 50.0)),
        min_outputscale=t(np.full(ns, 1e-6)), max_outputscale=t(np.full(ns, 2.0)),
        min_noise=t(np.full(ns, 1e-7)), max_noise=t(np.full(ns, 1.0)),
    )
    params = params_from_constrained(t(np.full((ns, d), 0.7)), t(np.full(ns, 0.05)), t(np.full(ns, 1e-4)), bounds)
    x = t(rng.uniform(0, 1, (n, d)))
    y = t(rng.normal(0, 0.02, (n, ns)))
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    state_mu = t(rng.uniform(0, 1, ns))
    state_var = t(np.eye(ns) * 1e-4)
    inits = t(rng.uniform(0, 1, (n_devices, nh * na)))
    action_prev = t(np.full(na, 0.5))
    args = (x, y, mask, params, bounds, state_mu, state_var, inits, action_prev, 0)

    def close(got, want, what):
        err = float((got.double() - want.double()).abs().max())
        if not err <= 1e-8:
            raise AssertionError(f"dryrun: {what} differs from the replicated result by {err:.3e}")

    # ---- replicated references (the same math on one rank) ---------------
    cache = masked_cholesky_factorize(params, bounds, x, y, mask)
    a_ref, _, _ = _plan_from_cache(plan_spec, cache, state_mu, state_var, inits, action_prev, 0)
    train_cfg = TrainConfigDevice(lr=7e-3, iters=2, clip_grad_value=1e-1)
    draws = training_draws(params, x, torch.Generator().manual_seed(0), n_devices)
    ref_params, ref_losses = train_hyperparams(params, bounds, x, y, mask, None, train_cfg, restarts=n_devices,
                                               draws=draws)

    # restart-sharded planning must equal the replicated planner
    a_opt, _ = build_sharded_plan_fn(plan_spec, mesh)(*args)
    if tuple(a_opt.shape) != (nh * na,):
        raise AssertionError(f"dryrun: a_opt of shape {tuple(a_opt.shape)}")
    close(a_opt, a_ref, "restart-sharded a_opt")

    # memory-axis (N) sharded planning must equal it too
    a_n, _, _ =build_nsharded_plan_fn(plan_spec, mesh)(*args)
    close(a_n, a_ref, "N-sharded a_opt")

    # ---- N-sharded trained-GP (mixed: f64 master, df32 rollout) ----------
    # finite and inside the box; its value equality is held at the core's
    # level (tests/test_torch_sharding.py), as in the reference
    if dtype == torch.float64:
        t0 = time.perf_counter()
        f32 = torch.float32
        spec_df = plan_spec._replace(
            reward=reward_spec._replace(**{k: getattr(reward_spec, k).to(f32) for k in (
                "target_state_action_norm", "weight_matrix_cost", "target_state_norm",
                "weight_matrix_cost_terminal", "state_min", "state_max")}),
            action=action_spec._replace(max_change_action_norm=action_spec.max_change_action_norm.to(f32)),
            maxiter=1, maxls=1)
        params_sharp = params_from_constrained(t(np.full((ns, d), 0.35)), t(np.full(ns, 0.9)), t(np.full(ns, 1e-6)),
                                               bounds)
        a_df, _, info_df = build_nsharded_plan_fn(spec_df, mesh)(
            x, y, mask, params_sharp, bounds, state_mu.to(f32), (state_var * 1e-2).to(f32), inits.to(f32),
            action_prev.to(f32), 0)
        if not (bool(torch.isfinite(a_df).all()) and float(a_df.min()) >= 0 and float(a_df.max()) <= 1):
            raise AssertionError(f"dryrun: N-sharded df32 a_opt {a_df} not finite in [0, 1]")
        if not bool(torch.isfinite(info_df.mean_reward_ucb)):
            raise AssertionError("dryrun: N-sharded df32 plan's objective is not finite")
        if mesh.rank == 0:
            print(f"[dryrun] n-sharded df32 plan ok ({time.perf_counter() - t0:.1f}s)", flush=True)

    # restart-sharded training must equal unsharded keep-best training
    new_params, losses = build_sharded_train_fn(bounds, train_cfg, mesh, restarts=n_devices)(
        params, x, y, mask, draws=draws)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("dryrun: non-finite training losses")
    close(losses, ref_losses, "sharded training losses")
    for got, want, name in zip(new_params, ref_params, GPParams._fields):
        close(got, want, f"sharded training {name}")

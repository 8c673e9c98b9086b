"""Online-learning episodes kept on the device, over a batch of seeds.

Port of ``gpmpc_tpu/runner/jit_episode.py``. An episode is the whole
online-learning loop: warmup randomization, MPC planning (factorize,
moment-matched rollout, box L-BFGS-B over the restarts), the
storage-filtered transition memory, periodic MLL hyperparameter training,
and the env itself (``envs.torch_dynamics``), with every tensor of it
(env state, memory, parameters, storage flags, counters) on the spec's
device. The JAX package compiles it into one ``lax.scan`` and vmaps it over
seeds; here there is no compiler, so the names keep their meaning and the
control flow becomes Python:

* the predicates of ``lax.cond``, planning (``t % num_repeat_actions ==
  0``), the random warmup (``t < warmup``) and training (``(t + 1) %
  training_frequency == 0``), are functions of t and so Python branches;
  the store flag, the memory's counters and mask and every buffer stay
  device tensors, and a step reads nothing back to the host beyond what
  L-BFGS(-B) reads once per iteration and the restart selection;
* the seed batch runs in lockstep, as JAX's vmap runs it: every tensor of
  the carry has the seed axis in front, and each step is one batched env
  step, memory scatter and f64 factorization at ``model_cap`` for all the
  seeds, one batched MLL training of seeds x restarts x models
  (``train_restarts``) and one planning step of seeds x restarts, each seed
  against its own cache (``with_index``), whose rollouts are one launch of
  each kernel per horizon step. Each seed keeps its own generator and draws,
  and computes what its episode alone computes, bit for bit on the CPU
  (``build_episode_fn`` is the batch of one);
* ``steps_per_call`` segments run the seeds' next steps with the carry kept
  on the device, as JAX's host-stitched segments do; the result is the
  unsegmented run's, bit for bit.

Semantics are those of the JAX episode step for step (jit_episode.py:350-444):
planning only on ``t % num_repeat_actions == 0`` with the cached action
replayed in between; warmup steps evaluate a random action sequence, whose
rollout still gives the storage filter its prediction; training fires
synchronously at ``(t + 1) % training_frequency == 0``, in f64 under
``mixed_df32`` (parameters and bounds cast to f64 and the new raw
parameters back). Each planning step factorizes the memory's ``model_cap``
buffer afresh (no extension); under ``mixed_df32`` the factorization is an
f64 master split into the double-float32 rollout cache, as
``Planner.refresh_cache`` makes it.

Randomness: JAX's threefry keys cannot be reproduced, so every draw comes
from ``EpisodeDraws`` in one documented order, and a test replaces any draw
there. The training draws follow the controller's (``training_draws``), so
that this episode and ``GpMpcController`` train alike given a seed.

Seeds take the place of JAX's keys: ``build_episode_fn(spec)(seed,
params0)``, ``build_episodes_batch_fn(spec)(seeds, params0)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config.configs import Config
from ..controllers.controller import training_draws
from ..controllers.planner import PlanSpec, _cast_cache, _objective_and_info, _run_restarts, _select_restart
from ..envs.torch_dynamics import TorchEnvSpec, stack_states
from ..mappers.action import ActionMapperSpec, mpc_to_model_actions
from ..mappers.reward import RewardSpec, reward_single
from ..models.gp import GPBounds, GPParams, TrainConfigDevice, keep_best, masked_cholesky_factorize, \
    params_from_constrained, train_restarts, with_index


class MemoryState(NamedTuple):
    """Fixed-capacity device-resident transition memory (memory/buffer.py is
    the host twin): tensors on one device, the counters int32 0-dim."""

    inputs: torch.Tensor  # (cap, D) raw per-step transitions
    states_next: torch.Tensor  # (cap, Ns)
    flags: torch.Tensor  # (cap,) storage-filter decisions
    model_inputs: torch.Tensor  # (model_cap, D) materialized GP points
    model_targets: torch.Tensor  # (model_cap, Ns)
    len_mem: torch.Tensor
    len_last: torch.Tensor
    len_model: torch.Tensor


def memory_init(cap: int, d: int, ns: int, dtype, model_cap: Optional[int] = None, device=None) -> MemoryState:
    """An empty memory of ``cap`` raw rows. model_cap sizes the GP-point
    buffers apart from the raw log: with action repeat k only every k-th raw
    row can become a model point, so model_cap = cap // k + 1 (bucketed,
    ``_model_cap_for``) bounds them exactly, and the (Ns, model_cap,
    model_cap) factorization scales with the point count, not the step
    count. ``device`` None is ``cuda``."""
    mcap = cap if model_cap is None else model_cap
    kw = dict(dtype=dtype, device=torch.device("cuda" if device is None else device))
    count = torch.zeros((), dtype=torch.int32, device=kw["device"])
    return MemoryState(
        inputs=torch.zeros((cap, d), **kw),
        states_next=torch.zeros((cap, ns), **kw),
        flags=torch.zeros((cap,), dtype=torch.bool, device=kw["device"]),
        model_inputs=torch.zeros((mcap, d), **kw),
        model_targets=torch.zeros((mcap, ns), **kw),
        len_mem=count,
        len_last=count.clone(),
        len_model=count.clone(),
    )


def memory_add(mem: MemoryState, x_row, s_next, store_flag) -> MemoryState:
    """Append one raw row at ``len_mem`` (a device index: no host read). The
    memory must have room: episodes size cap to hold every step. A memory
    with a leading seed axis appends each seed's row (x_row (S, D), s_next
    (S, Ns), store_flag (S,)) at its own ``len_mem``."""
    i = mem.len_mem.to(torch.int64)[..., None]
    flag = torch.as_tensor(store_flag, dtype=torch.bool, device=mem.flags.device).expand(mem.len_mem.shape)

    def put(buf, row):
        return buf.scatter(-2, i[..., None].expand(i.shape + row.shape[-1:]), row[..., None, :])

    return mem._replace(
        inputs=put(mem.inputs, x_row),
        states_next=put(mem.states_next, s_next),
        flags=mem.flags.scatter(-1, i, flag[..., None]),
        len_mem=mem.len_mem + 1,
    )


def memory_prepare(mem: MemoryState, step_model: int, ns: int) -> MemoryState:
    """Materialize model inputs and targets from the unprocessed rows (the
    masked scatter equivalent of gp_memory.py:66-83; targets y_i =
    s_next[i+k-1] - s[i]). Positions past the model buffer are dropped, as
    JAX's ``mode="drop"`` scatter drops them: they go to one scratch row past
    its end, which is cut off."""
    cap = mem.inputs.shape[-2]
    device = mem.inputs.device
    idx = torch.arange(cap, dtype=torch.int32, device=device)
    len_last, len_mem, len_model = (c[..., None] for c in (mem.len_last, mem.len_mem, mem.len_model))
    elig = ((idx % step_model == 0) & (idx >= len_last) & (idx < len_mem) & mem.flags
            & (idx + step_model - 1 < len_mem))
    mcap = mem.model_inputs.shape[-2]
    elig_i = elig.to(torch.int32)
    offs = torch.cumsum(elig_i, -1, dtype=torch.int32) - 1
    pos = torch.where(elig, len_model + offs, torch.full_like(offs, mcap))
    pos = torch.clamp(pos, max=mcap).to(torch.int64)  # mcap = the dropped row
    tgt_idx = torch.clamp(idx + step_model - 1, max=cap - 1).to(torch.int64)
    targets = mem.states_next[..., tgt_idx, :] - mem.inputs[..., :ns]

    def scatter(buf, rows):
        padded = torch.cat([buf, buf.new_zeros(buf.shape[:-2] + (1, buf.shape[-1]))], dim=-2)
        return padded.scatter(-2, pos[..., None].expand(rows.shape), rows)[..., :mcap, :]

    return mem._replace(
        model_inputs=scatter(mem.model_inputs, mem.inputs),
        model_targets=scatter(mem.model_targets, targets),
        len_model=mem.len_model + torch.sum(elig_i, dim=-1, dtype=torch.int32),
        len_last=mem.len_mem.clone(),
    )


def memory_active_mask(mem: MemoryState) -> torch.Tensor:
    """Active GP points; an empty memory gives the single dummy zero point
    (gp_memory.py:109-111): the model buffers are zero-initialized, so row 0
    is exactly that point."""
    mcap = mem.model_inputs.shape[-2]
    n = torch.clamp(mem.len_model, min=1)[..., None]
    return torch.arange(mcap, dtype=torch.int32, device=mem.model_inputs.device) < n


class EpisodeSpec(NamedTuple):
    """Everything fixed about an episode."""

    env: TorchEnvSpec
    plan: PlanSpec
    bounds: GPBounds
    train_cfg: TrainConfigDevice
    obs_var_norm_diag: torch.Tensor  # (Ns,)
    thr_err: torch.Tensor  # (Ns,)
    thr_std: torch.Tensor  # (Ns,)
    check_storage: bool
    num_steps: int
    warmup: int
    cap: int
    num_repeat_actions: int
    training_frequency: int
    restarts_optim: int
    init_from_previous_actions: bool
    include_time_model: bool
    dtype: torch.dtype
    # test hook: 0.5-constant warmup sequences and L-BFGS-B inits, so that
    # the episode can be held step for step against the controller
    deterministic_inits: bool = False
    # random re-inits per MLL training (config.training.restarts_train)
    restarts_train: int = 1
    # mixed mode: factorize and train in f64, roll out in double-float32
    # (dtype float32)
    mixed_df32: bool = False
    # GP-point buffer capacity; None = cap (see memory_init)
    model_cap: Optional[int] = None
    # where every tensor of the episode lives: the env's device
    device: torch.device = torch.device("cpu")


def _model_cap_for(cap: int, num_repeat_actions: int) -> int:
    """Exact bucketed bound on materialized GP points: raw rows at indices
    0, k, 2k, ... of a cap-row log -> cap // k + 1 candidates."""
    if num_repeat_actions <= 1:
        return cap
    pts = cap // num_repeat_actions + 1
    return min(cap, max(32, int(np.ceil(pts / 32.0)) * 32))


def episode_spec_from_config(
    env: TorchEnvSpec,
    config: Config,
    num_steps: int,
    warmup: int,
    cap=None,
    deterministic_inits: bool = False,
    mixed_df32: bool = False,
) -> Tuple[EpisodeSpec, GPParams]:
    """(spec, initial GP parameters) of an episode of ``env`` under
    ``config``, on the env's device (``cuda`` unless the env was made with
    another). Mixed mode needs ``config.dtype == "float32"``."""
    device = env.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the episode runs on the env's device, cuda, and torch finds no CUDA device; make the "
                           "env with device='cpu' to run on the CPU")
    dtype = torch.float64 if config.dtype == "float64" else torch.float32
    if mixed_df32 and dtype != torch.float32:
        raise ValueError("mixed_df32 needs config.dtype float32")
    ns = len(env.obs_low)
    na = len(env.act_low)
    d = ns + na + (1 if config.model.include_time_model else 0)
    if cap is None:
        cap = max(32, int(np.ceil(num_steps / 32.0)) * 32)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    rm = config.model.resolved(ns, d)
    bounds = GPBounds(
        min_lengthscale=t(rm.min_lengthscale), max_lengthscale=t(rm.max_lengthscale),
        min_outputscale=t(rm.min_outputscale), max_outputscale=t(rm.max_outputscale),
        min_noise=t(rm.min_noise_var), max_noise=t(rm.max_noise_var),
    )
    params0 = params_from_constrained(t(rm.init_lengthscale), t(rm.init_outputscale), t(rm.init_noise_var), bounds)

    rc = config.reward
    target_state = np.asarray(rc.target_state_norm, float)
    reward_spec = RewardSpec(
        target_state_action_norm=t(np.concatenate([target_state, np.asarray(rc.target_action_norm, float)])),
        weight_matrix_cost=t(np.diag(np.concatenate([np.asarray(rc.weight_state, float),
                                                     np.asarray(rc.weight_action, float)]))),
        target_state_norm=t(target_state),
        weight_matrix_cost_terminal=t(np.diag(np.asarray(rc.weight_state_terminal, float))),
        use_constraints=bool(rc.use_constraints),
        state_min=t(rc.state_min),
        state_max=t(rc.state_max),
        area_multiplier=float(rc.area_multiplier),
        exploration_factor=float(rc.exploration_factor),
        clip_lower_bound_cost_to_0=bool(rc.clip_lower_bound_cost_to_0),
    )
    action_spec = ActionMapperSpec(
        limit_action_change=bool(config.actions.limit_action_change),
        max_change_action_norm=t(config.actions.max_change_action_norm),
        len_horizon=config.controller.len_horizon,
        dim_action=na,
    )
    opt = config.controller.actions_optimizer_params
    plan_spec = PlanSpec(
        reward=reward_spec,
        action=action_spec,
        include_time_model=bool(config.model.include_time_model),
        len_horizon=config.controller.len_horizon,
        dim_action=na,
        dim_state=ns,
        maxiter=int(opt.get("maxiter", 30)),
        maxcor=int(opt.get("maxcor", 30)),
        maxls=int(opt.get("maxls", opt.get("maxiter", 30))),
        maxfun=int(opt["maxfun"]) if "maxfun" in opt else None,
    )
    tc = config.training
    train_cfg = TrainConfigDevice(lr=float(tc.lr_train), iters=int(tc.iter_train) * 20,
                                  clip_grad_value=float(tc.clip_grad_value))

    spec = EpisodeSpec(
        env=env,
        plan=plan_spec,
        bounds=bounds,
        train_cfg=train_cfg,
        obs_var_norm_diag=t(config.observation.obs_var_norm),
        thr_err=t(config.memory.min_error_prediction_state_for_memory),
        thr_std=t(config.memory.min_prediction_state_std_for_memory),
        check_storage=bool(config.memory.check_errors_for_storage),
        num_steps=int(num_steps),
        warmup=int(warmup),
        cap=int(cap),
        num_repeat_actions=int(config.controller.num_repeat_actions),
        training_frequency=int(config.training.training_frequency),
        restarts_optim=max(1, int(config.controller.restarts_optim)),
        init_from_previous_actions=bool(config.controller.init_from_previous_actions),
        include_time_model=bool(config.model.include_time_model),
        dtype=dtype,
        deterministic_inits=bool(deterministic_inits),
        restarts_train=max(1, int(tc.restarts_train)),
        mixed_df32=bool(mixed_df32),
        model_cap=_model_cap_for(int(cap), int(config.controller.num_repeat_actions)),
        device=device,
    )
    return spec, params0


class EpisodeDraws:
    """Every random draw of one episode, from one ``torch.Generator`` on the
    CPU seeded with the seed, in this order:

    1. ``env_init``: the env's initial state (the env spec's draws);
    2. ``action_prev``: the initial previous action, (Na,) in [0, 1);
    3. then step by step: at a planning step, ``warmup_actions`` (a warmup
       step's random sequence, (Nh*Na,)) or ``inits`` (a planned step's
       restart inits, (R, Nh*Na)), neither under ``deterministic_inits``;
       then at every step the env step's draws (``TorchEnvSpec.step_fn``
       with ``generator``; process control's only).

    The training at step t draws its re-inits (restarts, Ns, D+2) apart
    (``train``), from (seed, TRAIN_KEY_TAG, t + 1) as the controller's
    training at iter_ctrl t + 1 does (``training_draws``). Uniform values are
    drawn in f64 and cast to the episode's dtype, so that one seed gives
    episodes of every dtype the same starting values. A test replaces a draw
    by overriding its method."""

    def __init__(self, seed: int, spec: EpisodeSpec):
        self.seed = int(seed)
        self.spec = spec
        self.generator = torch.Generator().manual_seed(self.seed)

    def env_init(self):
        return self.spec.env.init_fn(self.generator)

    def action_prev(self) -> torch.Tensor:
        return torch.rand(self.spec.plan.dim_action, generator=self.generator, dtype=torch.float64)

    def warmup_actions(self, t: int) -> torch.Tensor:
        plan = self.spec.plan
        return torch.rand(plan.len_horizon * plan.dim_action, generator=self.generator, dtype=torch.float64)

    def inits(self, t: int) -> torch.Tensor:
        plan = self.spec.plan
        return torch.rand((self.spec.restarts_optim, plan.len_horizon * plan.dim_action), generator=self.generator,
                          dtype=torch.float64)

    def train(self, t: int) -> torch.Tensor:
        spec = self.spec
        d = spec.plan.dim_state + spec.plan.dim_action + (1 if spec.include_time_model else 0)
        return training_draws(self.seed, t + 1, spec.restarts_train, spec.plan.dim_state, d)


class _Carry(NamedTuple):
    """The seeds' episode state between steps (the JAX scan's carry, its
    keys replaced by the draws), every tensor with the seed axis in front."""

    env_state: object
    obs: torch.Tensor
    mem: MemoryState
    params: GPParams
    action_raw_cached: torch.Tensor
    action_model_prev: torch.Tensor
    prev_mpc: torch.Tensor
    have_prev: bool
    pred_state: torch.Tensor
    pred_std: torch.Tensor
    draws: list  # EpisodeDraws, one per seed


def _cast(tree, dtype):
    return type(tree)(*(a.to(dtype) for a in tree))


def plan_batch(spec: PlanSpec, master, state_mu, state_var, inits, action_prev, t):
    """One planning step of S seeds in lockstep: master the seeds' caches
    stacked on a leading axis, state_mu (S, Ns), state_var (Ns, Ns) for all,
    inits (S, R, Nh*Na), action_prev (S, Na). All S R restarts run as one
    L-BFGS-B batch, each seed's against its own cache; then each seed's kept
    restart (``_select_restart``) and its info, recomputed in one batched
    rollout. Returns (a_opt
    (S, Nh*Na), info with the seed axis in front)."""
    seeds, restarts = inits.shape[:2]
    cache = _cast_cache(master, state_mu.dtype)
    per_seed = torch.arange(seeds)
    xs, fs = _run_restarts(spec, with_index(cache, per_seed.repeat_interleave(restarts)),
                           state_mu.repeat_interleave(restarts, dim=0), state_var, inits.reshape(seeds * restarts, -1),
                           action_prev.repeat_interleave(restarts, dim=0), t)
    a_opt = torch.stack([x[_select_restart(f)] for x, f in zip(xs.reshape(seeds, restarts, -1),
                                                                 fs.reshape(seeds, restarts))])
    with torch.no_grad():
        _, info = _objective_and_info(spec, with_index(cache, per_seed), a_opt, state_mu, state_var, action_prev, t)
    return a_opt, info


class _Episode:
    """init_carry and step of one spec over a batch of seeds in lockstep
    (the JAX ``_build_episode_parts`` under vmap)."""

    def __init__(self, spec: EpisodeSpec):
        if spec.cap < spec.num_steps:
            raise ValueError(f"cap {spec.cap} holds fewer rows than the episode's {spec.num_steps} steps")
        self.spec = spec
        env = spec.env
        self.ns, self.na = len(env.obs_low), len(env.act_low)
        self.d = self.ns + self.na + (1 if spec.include_time_model else 0)
        self.n_flat = spec.plan.len_horizon * self.na

        def t(a):
            return torch.tensor(np.asarray(a, dtype=np.float64), dtype=spec.dtype, device=spec.device)

        self.obs_low, self.obs_high = t(env.obs_low), t(env.obs_high)
        self.act_low, self.act_high = t(env.act_low), t(env.act_high)
        self.obs_var = torch.diag(spec.obs_var_norm_diag)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float64).to(device=self.spec.device, dtype=self.spec.dtype)

    def _draws(self, draws, what, t):
        """Each seed's draw ``what`` at step t, stacked (in the episode's
        dtype, on its device)."""
        return self._tensor(torch.stack([getattr(d, what)(t) for d in draws]))

    def norm_obs(self, obs):
        return (obs - self.obs_low) / (self.obs_high - self.obs_low)

    def make_cache(self, mem: MemoryState, params, mask):
        """The factorizations the plan rolls out from, the seeds' stacked:
        under mixed_df32 the f64 masters (cast as the Planner casts them,
        split by ``plan_batch``), else in the episode's dtype."""
        spec = self.spec
        if spec.mixed_df32:
            f64 = torch.float64
            return masked_cholesky_factorize(_cast(params, f64), _cast(spec.bounds, f64),
                                             mem.model_inputs.to(f64), mem.model_targets.to(f64), mask)
        return masked_cholesky_factorize(params, spec.bounds, mem.model_inputs, mem.model_targets, mask)

    def plan_actions(self, mem, params, state_mu, prev_mpc, have_prev, action_prev, t, draws):
        spec = self.spec
        seeds = state_mu.shape[0]
        cache = self.make_cache(mem, params, memory_active_mask(mem))
        if spec.deterministic_inits:
            inits = torch.full((seeds, spec.restarts_optim, self.n_flat), 0.5, dtype=spec.dtype, device=spec.device)
        else:
            inits = self._draws(draws, "inits", t)
        if spec.init_from_previous_actions and have_prev:
            shifted = torch.cat([prev_mpc[:, self.na:], prev_mpc[:, -self.na:]], dim=-1)
            inits = torch.cat([shifted[:, None], inits[:, 1:]], dim=1)
        return plan_batch(spec.plan, cache, state_mu, self.obs_var, inits, action_prev, t)

    def eval_actions(self, mem, params, state_mu, actions_mpc, action_prev, t):
        spec = self.spec
        cache = self.make_cache(mem, params, memory_active_mask(mem))
        cache = with_index(_cast_cache(cache, spec.dtype), torch.arange(state_mu.shape[0]))
        _, info = _objective_and_info(spec.plan, cache, actions_mpc, state_mu, self.obs_var, action_prev, t)
        return actions_mpc, info

    def train(self, mem: MemoryState, params: GPParams, t: int, draws) -> GPParams:
        """The synchronous MLL training at step t of every seed on its memory
        as it would be prepared now (the carry keeps the unprepared memory,
        as in JAX): seeds x restarts x models as one L-BFGS batch, each seed
        from its own draws."""
        spec = self.spec
        mem3 = memory_prepare(mem, spec.num_repeat_actions, self.ns)
        dt = torch.float64 if spec.mixed_df32 else spec.dtype
        p, b = _cast(params, dt), _cast(spec.bounds, dt)
        x, y, mask = mem3.model_inputs.to(dt), mem3.model_targets.to(dt), memory_active_mask(mem3)
        train_draws = torch.stack([torch.as_tensor(d.train(t), dtype=dt) for d in draws]).to(x.device)
        raws, losses = train_restarts(p, b, x, y, mask, spec.train_cfg, train_draws)
        new_params, _ = keep_best(p, b, x, y, mask, raws, losses)
        return _cast(new_params, spec.dtype)

    def init_carry(self, draws: list, params0: GPParams) -> _Carry:
        spec = self.spec
        seeds = len(draws)
        kw = dict(dtype=spec.dtype, device=spec.device)
        env_states, obs = zip(*(d.env_init() for d in draws))
        mem = memory_init(spec.cap, self.d, self.ns, spec.dtype, model_cap=spec.model_cap, device=spec.device)
        return _Carry(
            env_state=stack_states(list(env_states)),
            obs=torch.stack(obs).to(spec.dtype),
            mem=type(mem)(*(a.expand((seeds,) + a.shape).clone() for a in mem)),
            params=type(params0)(*(a.expand((seeds,) + a.shape).clone() for a in params0)),
            action_raw_cached=torch.zeros((seeds, self.na), **kw),
            action_model_prev=self._tensor(torch.stack([d.action_prev() for d in draws])),
            prev_mpc=torch.zeros((seeds, self.n_flat), **kw),
            have_prev=False,
            pred_state=torch.zeros((seeds, self.ns), **kw),
            pred_std=torch.zeros((seeds, self.ns), **kw),
            draws=list(draws),
        )

    def step(self, c: _Carry, t: int) -> Tuple[_Carry, dict]:
        spec = self.spec
        ns = self.ns
        seeds = c.obs.shape[0]
        state_mu = self.norm_obs(c.obs)
        mem, a_raw, a_model0 = c.mem, c.action_raw_cached, c.action_model_prev
        prev_mpc, have_prev, pred_state, pred_std = c.prev_mpc, c.have_prev, c.pred_state, c.pred_std

        if t % spec.num_repeat_actions == 0:
            mem = memory_prepare(mem, spec.num_repeat_actions, ns)
            if t < spec.warmup:
                if spec.deterministic_inits:
                    rand_mpc = torch.full((seeds, self.n_flat), 0.5, dtype=spec.dtype, device=spec.device)
                else:
                    rand_mpc = self._draws(c.draws, "warmup_actions", t)
                a_opt, info = self.eval_actions(mem, c.params, state_mu, rand_mpc, c.action_model_prev, t)
            else:
                a_opt, info = self.plan_actions(mem, c.params, state_mu, c.prev_mpc, c.have_prev,
                                                c.action_model_prev, t, c.draws)
            a_model0 = mpc_to_model_actions(spec.plan.action, a_opt, c.action_model_prev)[..., 0, :]
            a_raw = a_model0 * (self.act_high - self.act_low) + self.act_low
            prev_mpc, have_prev = a_opt, True
            pred_state = info.states_mu_pred[..., 1, :]
            pred_std = torch.sqrt(torch.clamp(torch.diagonal(info.states_var_pred[..., 1, :, :], dim1=-2, dim2=-1),
                                              min=0.0))

        # realized cost of (obs, action): compute_cost_unnormalized's
        a_model_now = (a_raw - self.act_low) / (self.act_high - self.act_low)
        reward_now, _ = reward_single(spec.plan.reward, state_mu[:, None], self.obs_var.expand(seeds, 1, ns, ns),
                                      a_model_now[:, None])
        cost_now = -reward_now[:, 0]

        env_state, obs_new, env_reward = spec.env.step_fn(c.env_state, a_raw, [d.generator for d in c.draws])
        # under mixed mode the env runs in f64: the observation comes back
        # in the episode's dtype
        obs_new = obs_new.to(spec.dtype)

        # memory add with the storage filter (gp_memory.py:31-64)
        s_next = self.norm_obs(obs_new)
        parts = [state_mu, a_model_now]
        if spec.include_time_model:
            parts.append(torch.full((seeds, 1), float(t), dtype=spec.dtype, device=spec.device))
        x_row = torch.cat(parts, dim=-1)
        if spec.check_storage:
            store = torch.any(torch.abs(pred_state - s_next) > spec.thr_err, dim=-1) \
                & torch.any(pred_std > spec.thr_std, dim=-1)
        else:
            store = True
        mem = memory_add(mem, x_row, s_next, store)

        params = c.params
        if (t + 1) % spec.training_frequency == 0:
            params = self.train(mem, params, t, c.draws)

        out = {"obs": c.obs, "action_raw": a_raw, "cost": cost_now, "env_reward": env_reward,
               "pred_state": pred_state, "pred_std": pred_std}
        carry = _Carry(env_state, obs_new, mem, params, a_raw, a_model0, prev_mpc, have_prev, pred_state, pred_std,
                       c.draws)
        return carry, out

    def run(self, carry: _Carry, ts) -> Tuple[_Carry, list]:
        outs = []
        with torch.no_grad():
            for t in ts:
                carry, out = self.step(carry, int(t))
                outs.append(out)
        return carry, outs


def _stack_steps(outs: list) -> dict:
    """The steps' outputs with the step axis after the seed axis."""
    return {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}


def _finalize_outs(outs: dict, carry: _Carry) -> dict:
    outs["final_params"] = carry.params
    outs["final_obs"] = carry.obs  # obs AFTER the last step
    outs["final_mem"] = carry.mem  # the whole MemoryState
    return outs


def _element(tree, i: int):
    """Seed i of a batch's outputs (fields of NamedTuples too)."""
    if isinstance(tree, dict):
        return {k: _element(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(f[i] for f in tree))
    return tree[i]


def build_episodes_batch_fn(spec: EpisodeSpec, steps_per_call: Optional[int] = None, draws=EpisodeDraws):
    """fn(seeds, params0): the episodes of the seeds in lockstep (the JAX
    package's vmap over keys), every output with a leading seed axis: the
    port's ``run_env_multiple`` kept on the device. ``draws(seed, spec)``
    makes each seed's ``EpisodeDraws``.

    ``steps_per_call`` runs the episodes in segments of that many steps,
    the carry kept on the device between them (JAX bounds each device
    dispatch so); the result is the unsegmented run's, bit for bit."""
    episode = _Episode(spec)
    seg = spec.num_steps if steps_per_call is None else max(1, int(steps_per_call))

    def run(seeds, params0):
        carry = episode.init_carry([draws(int(s), spec) for s in seeds], params0)
        outs = []
        for s0 in range(0, spec.num_steps, seg):
            carry, part = episode.run(carry, range(s0, min(s0 + seg, spec.num_steps)))
            outs.extend(part)
        return _finalize_outs(_stack_steps(outs), carry)

    return run


def build_episode_fn(spec: EpisodeSpec, draws=EpisodeDraws):
    """fn(seed, params0) -> dict of per-step tensors (obs, action_raw, cost,
    env_reward, pred_state, pred_std; leading axis the step) and
    final_params, final_obs, final_mem: the batch of one seed."""
    batch = build_episodes_batch_fn(spec, draws=draws)

    def run(seed: int, params0: GPParams) -> dict:
        return _element(batch([seed], params0), 0)

    return run


def run_episodes_batch(spec: EpisodeSpec, params0: GPParams, seeds, steps_per_call: Optional[int] = None):
    """One-shot convenience wrapper over build_episodes_batch_fn."""
    return build_episodes_batch_fn(spec, steps_per_call=steps_per_call)(seeds, params0)

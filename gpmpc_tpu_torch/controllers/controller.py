"""GP-MPC controller: host orchestration around the planner and training.

Port of ``gpmpc_tpu/controllers/controller.py`` (the reference
GpMpcController, gp_mpc_controller.py:21-317): ``get_action``,
``add_memory``, ``compute_cost_unnormalized``, ``get_iter_info``,
``store_iter_info``, ``check_and_close_processes`` and
``get_hyperparameters``, constructed from gym-style space bounds and a
``Config``.

* Device: ``device=None`` is ``cuda``; without a CUDA device the controller
  raises rather than carry on on the CPU. Pass ``device="cpu"`` to run there
  (every kernel then runs its plain twin).
* Regime: ``Config(dtype="float64")`` is f64 throughout.
  ``Config(dtype="float32")`` is mixed mode, an f64 factorization master
  with a double-float32 rollout, which is what the JAX controller runs with
  x64 on (its default). ``master_dtype=torch.float32`` stands in for JAX's
  x64 switch turned off: the pure-f32 session. The memory and the GP
  parameters stay in the config's dtype.
* Training: the exact-MLL L-BFGS (``models.gp.train_hyperparams``) runs in
  one worker thread (a single-worker ``concurrent.futures`` executor), in
  place of the reference's spawned process and JAX's asynchronous dispatch.
  In mixed mode it runs in f64 on the CPU, as JAX sends it to the host CPU
  on an accelerator, and the raw parameters are cast back; otherwise it runs
  on the controller's device in the config's dtype. Its result is swapped in
  between planning steps once its future is done
  (``check_and_close_processes``); ``wait_for_training`` blocks until then.
  The re-init draws of each dispatch come from a ``torch.Generator`` seeded
  from (seed, TRAIN_KEY_TAG, iter_ctrl), the JAX key schedule's inputs.
* The warmup actions and the restart inits use numpy's
  ``default_rng(seed)`` exactly as the JAX controller does.
* Checkpointing: ``save_state`` / ``restore_state`` (a dict of numpy
  arrays) and ``save_checkpoint`` / ``restore_checkpoint`` (.npz), see
  ``utils/checkpoint.py``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.configs import Config
from ..mappers.action import ActionMapperSpec, denorm_action, norm_action
from ..mappers.observation import ObservationNormalizer
from ..mappers.reward import RewardSpec, reward_single
from ..memory.buffer import Memory
from ..models.gp import GPBounds, GPParams, TrainConfigDevice, constrained_params, params_from_constrained, \
    train_hyperparams
from ..utils import checkpoint as _checkpoint
from .planner import Planner, PlanSpec

NUM_DECIMALS_REPR = 3

# rng-domain separator of the training draws (the JAX package's key tag)
TRAIN_KEY_TAG = 0x7A17


@dataclass
class IterationInformation:
    """Per-planning-step record (reference iteration_info_class.py:6-58)."""

    iteration: int
    state: np.ndarray
    cost: float
    cost_std: float
    mean_predicted_cost: float
    mean_predicted_cost_std: float
    lower_bound_mean_predicted_cost: float
    predicted_idxs: np.ndarray
    predicted_states: np.ndarray
    predicted_states_std: np.ndarray
    predicted_actions: np.ndarray
    predicted_costs: np.ndarray
    predicted_costs_std: np.ndarray

    def __str__(self) -> str:
        np.set_printoptions(precision=NUM_DECIMALS_REPR, suppress=True)
        parts = ["\n"]
        for key, item in self.__dict__.items():
            if isinstance(item, np.ndarray):
                rep = np.array2string(item, threshold=np.inf, max_line_width=np.inf, separator=",").replace("\n", "")
            else:
                rep = str(np.round(item, NUM_DECIMALS_REPR))
            parts.append(f"{key}: {rep}\n")
        return "".join(parts)


def training_draws(seed: int, iter_ctrl: int, restarts: int, ns: int, d: int) -> torch.Tensor:
    """The uniform re-init draws (restarts, Ns, D+2), f64 on the CPU, of a
    training dispatched at ``iter_ctrl``, from a generator seeded from (seed,
    TRAIN_KEY_TAG, iter_ctrl), as JAX folds the same three into its key. The
    controller and the on-device episode (runner/episode.py, whose training
    at step t is dispatched at iter_ctrl t + 1) both draw here, so that they
    train alike given a seed."""
    state = np.random.SeedSequence([seed, TRAIN_KEY_TAG, iter_ctrl]).generate_state(2, np.uint32)
    generator = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    return torch.rand((restarts, ns, d + 2), generator=generator, dtype=torch.float64)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class GpMpcController:
    def __init__(self, observation_low, observation_high, action_low, action_high, config: Config, seed: int = 0,
                 device=None, master_dtype=torch.float64):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GpMpcController runs on cuda unless given a device, and torch finds no CUDA "
                               "device; pass device='cpu' to run on the CPU")
        self.config = config
        self.seed = seed
        self.dtype = np.float64 if config.dtype == "float64" else np.float32
        self.torch_dtype = torch.float64 if self.dtype == np.float64 else torch.float32
        if master_dtype not in (torch.float32, torch.float64):
            raise TypeError(f"master_dtype is float32 or float64, got {master_dtype}")
        master = torch.float64 if self.dtype == np.float64 else master_dtype
        # JAX's mixed_train: an f32 session with an f64 master trains in f64
        self._mixed = master == torch.float64 and self.torch_dtype == torch.float32

        self.observation_state_mapper = ObservationNormalizer(
            observation_low, observation_high, np.asarray(config.observation.obs_var_norm), dtype=self.dtype)
        self.action_low = np.asarray(action_low, dtype=self.dtype)
        self.action_high = np.asarray(action_high, dtype=self.dtype)
        self.dim_action = len(self.action_low)
        self.dim_state = self.observation_state_mapper.dim_observation
        self.dim_input = self.dim_state + self.dim_action + (1 if config.model.include_time_model else 0)

        # --- model hyperparameters and interval constraints --------------
        rm = config.model.resolved(self.dim_state, self.dim_input)
        t = self._tensor
        self.bounds = GPBounds(
            min_lengthscale=t(rm.min_lengthscale), max_lengthscale=t(rm.max_lengthscale),
            min_outputscale=t(rm.min_outputscale), max_outputscale=t(rm.max_outputscale),
            min_noise=t(rm.min_noise_var), max_noise=t(rm.max_noise_var),
        )
        self.gp_params: GPParams = params_from_constrained(
            t(rm.init_lengthscale), t(rm.init_outputscale), t(rm.init_noise_var), self.bounds)

        # --- memory -------------------------------------------------------
        self.memory = Memory(
            config.memory, dim_input=self.dim_input, dim_state=self.dim_state,
            include_time_model=config.model.include_time_model,
            step_model=config.controller.num_repeat_actions, dtype=self.dtype,
        )

        # --- reward and action specs -------------------------------------
        rc = config.reward
        target_state = np.asarray(rc.target_state_norm, dtype=self.dtype)
        weights = np.concatenate([np.asarray(rc.weight_state, dtype=self.dtype),
                                  np.asarray(rc.weight_action, dtype=self.dtype)])
        self.reward_spec = RewardSpec(
            target_state_action_norm=t(np.concatenate([target_state, np.asarray(rc.target_action_norm,
                                                                                 dtype=self.dtype)])),
            weight_matrix_cost=t(np.diag(weights)),
            target_state_norm=t(target_state),
            weight_matrix_cost_terminal=t(np.diag(np.asarray(rc.weight_state_terminal, dtype=self.dtype))),
            use_constraints=bool(rc.use_constraints),
            state_min=t(rc.state_min),
            state_max=t(rc.state_max),
            area_multiplier=float(rc.area_multiplier),
            exploration_factor=float(rc.exploration_factor),
            clip_lower_bound_cost_to_0=bool(rc.clip_lower_bound_cost_to_0),
        )
        self.action_spec = ActionMapperSpec(
            limit_action_change=bool(config.actions.limit_action_change),
            max_change_action_norm=t(config.actions.max_change_action_norm),
            len_horizon=config.controller.len_horizon,
            dim_action=self.dim_action,
        )
        opt = config.controller.actions_optimizer_params
        self.plan_spec = PlanSpec(
            reward=self.reward_spec,
            action=self.action_spec,
            include_time_model=bool(config.model.include_time_model),
            len_horizon=config.controller.len_horizon,
            dim_action=self.dim_action,
            dim_state=self.dim_state,
            maxiter=int(opt.get("maxiter", 30)),
            maxcor=int(opt.get("maxcor", 30)),
            maxls=int(opt.get("maxls", opt.get("maxiter", 30))),
            # ``eps`` is accepted and unused, by the reference too (jac=True)
            maxfun=int(opt["maxfun"]) if "maxfun" in opt else None,
        )
        self.planner = Planner(self.plan_spec, dtype=self.torch_dtype, device=self.device, master_dtype=master)

        # --- training -----------------------------------------------------
        tc = config.training
        # torch.optim.LBFGS runs up to 20 inner iterations per .step() (its
        # max_iter default), so iter_train outer steps of the reference
        # allow 20 * iter_train quasi-Newton iterations
        self.train_cfg = TrainConfigDevice(lr=float(tc.lr_train), iters=int(tc.iter_train) * 20,
                                           clip_grad_value=float(tc.clip_grad_value))
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="gpmpc-train")
        self._pending_train: Optional[concurrent.futures.Future] = None
        self._last_train_losses: Optional[np.ndarray] = None
        self.last_train_seconds: Optional[float] = None

        # --- misc state ---------------------------------------------------
        self.actions_mpc_previous_iter: Optional[np.ndarray] = None
        self.action_model_previous_iter = np.random.default_rng(seed).uniform(
            size=(self.dim_action,)).astype(self.dtype)
        self.past_action: Optional[np.ndarray] = None
        self.iter_ctrl = 0
        self.info_iters: Dict[str, List] = {}
        self.iter_info: Optional[IterationInformation] = None
        self._rng = np.random.default_rng(seed)
        self.n_horizon_flat = config.controller.len_horizon * self.dim_action

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=self.dtype), device=self.device)

    # ------------------------------------------------------------------
    def get_action(self, obs_mu, obs_var=None, random: bool = False):
        """One control step; plans only when iter_ctrl is a multiple of
        num_repeat_actions, else replays the cached action
        (reference gp_mpc_controller.py:52-112)."""
        self.check_and_close_processes()
        if self.iter_ctrl % self.config.controller.num_repeat_actions == 0:
            self.memory.prepare_for_model()
            state_mu, state_var = self.observation_state_mapper.get_state(obs_mu, obs_var)
            x_pad, y_pad, mask, _ = self.memory.get_padded()
            # the placeholder flag from the Memory's own emptiness, never
            # inferred from data values
            is_dummy = self.memory.len_mem_model == 0
            t = self._tensor
            if random or not self.config.controller.optimize:
                actions_mpc_opt = self._rng.uniform(size=(self.n_horizon_flat,)).astype(self.dtype)
                actions_model, info = self.planner.evaluate(
                    x_pad, y_pad, mask, self.gp_params, self.bounds, t(state_mu), t(state_var),
                    t(actions_mpc_opt), t(self.action_model_previous_iter), self.iter_ctrl, is_dummy=is_dummy)
            else:
                a_opt, actions_model, info = self.planner.plan(
                    x_pad, y_pad, mask, self.gp_params, self.bounds, t(state_mu), t(state_var),
                    t(self._make_inits()), t(self.action_model_previous_iter), self.iter_ctrl, is_dummy=is_dummy)
                actions_mpc_opt = _numpy(a_opt)
            self.actions_mpc_previous_iter = np.array(actions_mpc_opt)

            actions_model_np = _numpy(actions_model)
            actions_raw = denorm_action(actions_model_np, self.action_low, self.action_high)
            next_action_raw = actions_raw[0]
            self.action_model_previous_iter = actions_model_np[0]

            self._record_iter_info(state_mu, state_var, actions_model_np, info)
            self.past_action = np.asarray(next_action_raw)
        else:
            next_action_raw = self.past_action

        self.iter_ctrl += 1
        return np.array(next_action_raw)

    def _make_inits(self) -> np.ndarray:
        """Restart initializations: warm start (shift-left-by-one-action) on
        restart 0 when available, random elsewhere
        (reference gp_mpc_controller.py:125-131, action_init_functions.py:4-10)."""
        restarts = max(1, int(self.config.controller.restarts_optim))
        inits = self._rng.uniform(size=(restarts, self.n_horizon_flat)).astype(self.dtype)
        if self.config.controller.init_from_previous_actions and self.actions_mpc_previous_iter is not None:
            warm = self.actions_mpc_previous_iter.copy()
            warm[: -self.dim_action] = warm[self.dim_action:]
            inits[0] = warm
        return inits

    def _record_iter_info(self, state_mu, state_var, actions_model, info) -> None:
        rewards_traj = _numpy(info.rewards_traj)
        rewards_var = _numpy(info.rewards_traj_var)
        states_mu_pred = _numpy(info.states_mu_pred)
        states_var_pred = _numpy(info.states_var_pred)
        states_std_pred = np.sqrt(np.maximum(np.diagonal(states_var_pred, axis1=-2, axis2=-1), 0.0))

        reward, reward_var = self._reward_single_host(state_mu, state_var, actions_model[0])
        nrep = self.config.controller.num_repeat_actions
        nh = self.config.controller.len_horizon
        idxs = np.arange(self.iter_ctrl, self.iter_ctrl + nh * nrep, nrep)

        self.iter_info = IterationInformation(
            iteration=self.iter_ctrl,
            state=states_mu_pred[0],
            cost=float(-reward),
            cost_std=float(np.sqrt(max(reward_var, 0.0))),
            mean_predicted_cost=float(np.min([-rewards_traj.mean(), 3])),
            mean_predicted_cost_std=float(np.sqrt(np.maximum(rewards_var, 0.0)).mean()),
            lower_bound_mean_predicted_cost=float(info.mean_reward_ucb),
            predicted_idxs=idxs,
            predicted_states=states_mu_pred,
            predicted_states_std=states_std_pred,
            predicted_actions=actions_model,
            predicted_costs=-rewards_traj,
            predicted_costs_std=np.sqrt(np.maximum(rewards_var, 0.0)),
        )
        self.store_iter_info(self.iter_info)

    def _reward_single_host(self, state_mu, state_var, action_model):
        t = self._tensor
        with torch.no_grad():
            r, rv = reward_single(self.reward_spec, t(state_mu)[None], t(state_var)[None], t(action_model)[None])
        return float(r[0]), float(rv[0])

    # ------------------------------------------------------------------
    def add_memory(self, obs, action, obs_new, reward, predicted_state=None, predicted_state_std=None):
        """Store a transition; start training every training_frequency
        iterations (reference gp_mpc_controller.py:165-199)."""
        state_mu, _ = self.observation_state_mapper.get_state(obs)
        state_mu_new, _ = self.observation_state_mapper.get_state(obs_new)
        action_model = norm_action(action, self.action_low, self.action_high)

        self.memory.add(
            state_mu, action_model, state_mu_new, reward, iter_ctrl=self.iter_ctrl - 1,
            predicted_state=None if predicted_state is None else np.asarray(predicted_state),
            predicted_state_std=None if predicted_state_std is None else np.asarray(predicted_state_std),
        )

        if self.iter_ctrl % self.config.training.training_frequency == 0 and self._pending_train is None:
            self.start_training_process()

    def train_draws(self, iter_ctrl: int) -> torch.Tensor:
        """The uniform re-init draws (restarts, Ns, D+2) of the training
        dispatched at ``iter_ctrl`` (``training_draws``)."""
        return training_draws(self.seed, iter_ctrl, max(1, int(self.config.training.restarts_train)),
                              self.dim_state, self.dim_input)

    def start_training_process(self):
        """Dispatch MLL training to the worker thread (replaces the
        reference's spawned process, gp_mpc_controller.py:201-214)."""
        self.memory.prepare_for_model()
        x_pad, y_pad, mask, _ = self.memory.get_padded()
        # iter_ctrl here is (env step index + 1) at the firing condition
        draws = self.train_draws(self.iter_ctrl)
        self._pending_train = self._executor.submit(self._train, self.gp_params, x_pad, y_pad, mask, draws)

    def _train(self, params: GPParams, x_pad, y_pad, mask, draws):
        """The worker thread's job: (new params on the controller's device in
        its dtype, losses (Ns,) as numpy, seconds on the host clock)."""
        start = time.perf_counter()
        device, dtype = (torch.device("cpu"), torch.float64) if self._mixed else (self.device, self.torch_dtype)

        def cast(tree, cls):
            return cls(*(a.to(device=device, dtype=dtype) for a in tree))

        def arr(a, dt=dtype):
            return torch.tensor(a, dtype=dt, device=device)

        new_params, losses = train_hyperparams(
            cast(params, GPParams), cast(self.bounds, GPBounds), arr(x_pad), arr(y_pad), arr(mask, torch.bool),
            None, self.train_cfg, restarts=max(1, int(self.config.training.restarts_train)), draws=draws)
        new_params = GPParams(*(a.to(device=self.device, dtype=self.torch_dtype) for a in new_params))
        return new_params, _numpy(losses), time.perf_counter() - start

    def check_and_close_processes(self):
        """Swap in finished training results between planning steps
        (reference gp_mpc_controller.py:216-227); a training still running
        is left to run."""
        if self._pending_train is None or not self._pending_train.done():
            return
        new_params, losses, seconds = self._pending_train.result()  # re-raises a failed training
        self.gp_params = new_params
        self._last_train_losses = losses
        self.last_train_seconds = seconds
        self._pending_train = None
        if self.config.training.print_train:
            print(f"training done — losses per model: {self._last_train_losses}")

    def wait_for_training(self):
        """Block until a dispatched training has finished, then swap it in
        (what the JAX package's callers do with ``block_until_ready``)."""
        if self._pending_train is not None:
            concurrent.futures.wait([self._pending_train])
            self.check_and_close_processes()

    def close(self):
        """Wait for a dispatched training and stop the worker thread."""
        self._executor.shutdown(wait=True)

    # ------------------------------------------------------------------
    def compute_cost_unnormalized(self, obs, action, obs_var=None):
        """Cost mean and variance of a raw (unnormalized) observation and
        action (reference gp_mpc_controller.py:287-305)."""
        state_mu, state_var = self.observation_state_mapper.get_state(obs, obs_var)
        action_model = norm_action(action, self.action_low, self.action_high)
        reward, reward_var = self._reward_single_host(state_mu, state_var, action_model)
        return -reward, reward_var

    def get_iter_info(self) -> IterationInformation:
        return self.iter_info

    def store_iter_info(self, iter_info: IterationInformation) -> None:
        for key, val in iter_info.__dict__.items():
            self.info_iters.setdefault(key, []).append(copy.deepcopy(val))

    def save_state(self):
        """Controller state snapshot (the reference's save_state,
        gp_model.py:308-315, extended to the whole controller for exact
        resume)."""
        return _checkpoint.controller_state_dict(self)

    def restore_state(self, state) -> None:
        _checkpoint.load_controller_state(self, state)

    def save_checkpoint(self, path: str) -> str:
        """Persist to disk (.npz)."""
        return _checkpoint.save_checkpoint(self, path)

    def restore_checkpoint(self, path: str) -> None:
        _checkpoint.restore_checkpoint(self, path)

    def get_hyperparameters(self):
        """Constrained (lengthscales, outputscales, noise variances) as numpy."""
        return tuple(_numpy(a) for a in constrained_params(self.gp_params, self.bounds))

"""Controller state snapshot and disk checkpoint/resume.

Port of ``gpmpc_tpu/utils/checkpoint.py``. The snapshot is a dict of numpy
arrays covering the whole controller state: the GP hyperparameters (raw),
the entire transition memory, the planner's warm-start state and the random
state, written with numpy's npz format. The keys are the JAX package's
where the state is the same. The one difference: the JAX controller keeps a
training key (``train_key``); the port derives each training's draws from
(seed, TRAIN_KEY_TAG, iter_ctrl) (controllers/controller.py
``training_draws``), so it stores ``seed`` in its place.

``save_state`` / ``restore_state`` on GpMpcController give exact resume: a
restored controller produces the same actions as the original (see
tests/test_torch_checkpoint.py). A restore puts every tensor on the
restoring controller's device, in its dtype, and drops its planner's
factorization cache (the memory was replaced wholesale, not appended to).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..models.gp import GPParams


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def controller_state_dict(ctrl) -> Dict[str, np.ndarray]:
    """Snapshot everything needed to resume a GpMpcController."""
    mem = ctrl.memory
    state = {
        # hyperparameters (raw space): the reference's SavedState.parameters
        "raw_lengthscales": _numpy(ctrl.gp_params.raw_lengthscales),
        "raw_outputscale": _numpy(ctrl.gp_params.raw_outputscale),
        "raw_noise": _numpy(ctrl.gp_params.raw_noise),
        # memory: SavedState.inputs/states_change plus its bookkeeping
        "mem_inputs": mem.inputs[: mem.len_mem],
        "mem_states_next": mem.states_next[: mem.len_mem],
        "mem_rewards": mem.rewards[: mem.len_mem],
        "mem_iter_ctrls": mem.iter_ctrls[: mem.len_mem],
        "mem_errors": mem.errors[: mem.len_mem],
        "mem_stds": mem.stds[: mem.len_mem],
        "mem_active_mask": mem.active_data_mask[: mem.len_mem],
        "mem_model_inputs": mem.model_inputs[: mem.len_mem_model],
        "mem_model_targets": mem.model_targets[: mem.len_mem_model],
        "mem_counters": np.array([mem.len_mem, mem.len_mem_last_processed, mem.len_mem_model], dtype=np.int64),
        # controller host state
        "iter_ctrl": np.array(ctrl.iter_ctrl, dtype=np.int64),
        "action_model_previous_iter": np.asarray(ctrl.action_model_previous_iter),
        "seed": np.array(ctrl.seed, dtype=np.int64),
    }
    # numpy Generator state (PCG64): two 128-bit ints as decimal strings
    bg = ctrl._rng.bit_generator.state
    state["rng_state"] = np.array(
        [str(bg["state"]["state"]), str(bg["state"]["inc"]), str(int(bg["has_uint32"])), str(bg["uinteger"])])
    if ctrl.past_action is not None:
        state["past_action"] = np.asarray(ctrl.past_action)
    if ctrl.actions_mpc_previous_iter is not None:
        state["actions_mpc_previous_iter"] = np.asarray(ctrl.actions_mpc_previous_iter)
    return state


def load_controller_state(ctrl, state: Dict[str, np.ndarray]) -> None:
    """Restore a controller from a snapshot made by controller_state_dict."""
    ctrl.gp_params = GPParams(*(torch.tensor(np.asarray(state[k]), dtype=ctrl.torch_dtype, device=ctrl.device)
                                for k in GPParams._fields))

    mem = ctrl.memory
    n, nlp, nm = (int(v) for v in state["mem_counters"])
    while len(mem.inputs) < n:
        mem._grow()
    while len(mem.model_inputs) < max(nm, 1):
        mem._grow_model()
    mem.inputs[:n] = state["mem_inputs"]
    mem.states_next[:n] = state["mem_states_next"]
    mem.rewards[:n] = state["mem_rewards"]
    mem.iter_ctrls[:n] = state["mem_iter_ctrls"]
    mem.errors[:n] = state["mem_errors"]
    mem.stds[:n] = state["mem_stds"]
    mem.active_data_mask[:n] = state["mem_active_mask"]
    mem.model_inputs[:nm] = state["mem_model_inputs"]
    mem.model_targets[:nm] = state["mem_model_targets"]
    mem.len_mem, mem.len_mem_last_processed, mem.len_mem_model = n, nlp, nm

    ctrl.iter_ctrl = int(state["iter_ctrl"])
    ctrl.action_model_previous_iter = np.asarray(state["action_model_previous_iter"])
    if "seed" in state:
        ctrl.seed = int(state["seed"])
    if "rng_state" in state:
        s = [str(v) for v in state["rng_state"]]
        bg = ctrl._rng.bit_generator.state
        bg["state"]["state"] = int(s[0])
        bg["state"]["inc"] = int(s[1])
        bg["has_uint32"] = int(s[2])
        bg["uinteger"] = int(s[3])
        ctrl._rng.bit_generator.state = bg
    if "past_action" in state:
        ctrl.past_action = np.asarray(state["past_action"])
    if "actions_mpc_previous_iter" in state:
        ctrl.actions_mpc_previous_iter = np.asarray(state["actions_mpc_previous_iter"])
    # the memory was replaced wholesale: the incremental factorization cache
    # can no longer assume an append-only history
    ctrl.planner.invalidate_cache()


def save_checkpoint(ctrl, path: str) -> str:
    """Write the controller snapshot to ``path`` (.npz)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **controller_state_dict(ctrl))
    return path


def restore_checkpoint(ctrl, path: str) -> None:
    with np.load(path, allow_pickle=False) as data:
        load_controller_state(ctrl, dict(data))

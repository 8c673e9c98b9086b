"""Transition memory with similarity/error-based point selection, and the
padding buckets of its device view.

A copy of ``gpmpc_tpu/memory/buffer.py`` (plain numpy, in the config's
dtype), the reference Memory (gp_memory.py:8-112):

* every transition is recorded (inputs, next states, rewards, iteration
  indices, prediction errors/stds);
* a point enters the GP training set only if the storage filter passes:
  ``any(|s_pred - s_next| > thr_err) AND any(std_pred > thr_std)`` when both
  predictions are provided (the reference README says OR but the code at
  gp_memory.py:52,58 combines with ``and``; the code is replicated);
* model inputs/targets are materialized lazily at ``prepare_for_model``,
  subsampled with stride ``step_model`` (= num_repeat_actions), with targets
  being state *changes* over step_model env steps:
  ``y_t = s[t + step_model - 1] - s[t]`` (gp_memory.py:90-93);
* empty memory yields a single dummy zero point (gp_memory.py:109-111).

Storage grows in ``points_batch_memory`` chunks. The view the planner takes
is padded to one of a small set of bucket sizes, so it sees few distinct
shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config.configs import MemoryConfig

_BUCKETS = (32, 64, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536, 2048)


def bucket_size(n: int, capacity: Optional[int] = None) -> int:
    """Smallest bucket >= n; beyond the largest, the next multiple of 512.
    ``capacity`` is accepted for the JAX signature and unused, as there."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


class Memory:
    def __init__(
        self,
        config: MemoryConfig,
        dim_input: int,
        dim_state: int,
        include_time_model: bool = False,
        step_model: int = 1,
        dtype=np.float64,
    ):
        self.config = config
        self.dim_input = dim_input
        self.dim_state = dim_state
        self.include_time_model = include_time_model
        self.step_model = step_model
        self.dtype = dtype

        chunk = config.points_batch_memory
        self._chunk = chunk
        self.inputs = np.zeros((chunk, dim_input), dtype=dtype)
        self.states_next = np.zeros((chunk, dim_state), dtype=dtype)
        self.rewards = np.zeros((chunk,), dtype=dtype)
        self.iter_ctrls = np.zeros((chunk,), dtype=np.int64)
        self.errors = np.full((chunk, dim_state), np.nan, dtype=dtype)
        self.stds = np.full((chunk, dim_state), np.nan, dtype=dtype)
        self.active_data_mask = np.zeros((chunk,), dtype=bool)

        self.model_inputs = np.zeros((chunk, dim_input), dtype=dtype)
        self.model_targets = np.zeros((chunk, dim_state), dtype=dtype)

        self.len_mem = 0
        self.len_mem_last_processed = 0
        self.len_mem_model = 0

        self._thr_err = np.asarray(config.min_error_prediction_state_for_memory, dtype=dtype)
        self._thr_std = np.asarray(config.min_prediction_state_std_for_memory, dtype=dtype)

    # ------------------------------------------------------------------
    def _grow(self):
        def g(a):
            extra = np.zeros((self._chunk,) + a.shape[1:], dtype=a.dtype)
            return np.concatenate([a, extra], axis=0)

        self.inputs = g(self.inputs)
        self.states_next = g(self.states_next)
        self.rewards = g(self.rewards)
        self.iter_ctrls = g(self.iter_ctrls)
        self.errors = np.concatenate(
            [self.errors, np.full((self._chunk, self.dim_state), np.nan, dtype=self.dtype)], axis=0
        )
        self.stds = np.concatenate(
            [self.stds, np.full((self._chunk, self.dim_state), np.nan, dtype=self.dtype)], axis=0
        )
        self.active_data_mask = np.concatenate([self.active_data_mask, np.zeros((self._chunk,), dtype=bool)])

    def _grow_model(self):
        self.model_inputs = np.concatenate(
            [self.model_inputs, np.zeros((self._chunk, self.dim_input), dtype=self.dtype)], axis=0
        )
        self.model_targets = np.concatenate(
            [self.model_targets, np.zeros((self._chunk, self.dim_state), dtype=self.dtype)], axis=0
        )

    # ------------------------------------------------------------------
    def add(
        self,
        state: np.ndarray,
        action_model: np.ndarray,
        state_next: np.ndarray,
        reward: float,
        iter_ctrl: int = 0,
        predicted_state: Optional[np.ndarray] = None,
        predicted_state_std: Optional[np.ndarray] = None,
    ) -> None:
        """Record one transition and run the storage-filter decision
        (reference gp_memory.py:31-64)."""
        if len(self.inputs) < self.len_mem + 1:
            self._grow()

        x = np.zeros((self.dim_input,), dtype=self.dtype)
        sa = np.concatenate([np.asarray(state, dtype=self.dtype), np.asarray(action_model, dtype=self.dtype)])
        x[: len(sa)] = sa
        if self.include_time_model:
            x[-1] = iter_ctrl

        i = self.len_mem
        self.inputs[i] = x
        self.states_next[i] = np.asarray(state_next, dtype=self.dtype)
        self.rewards[i] = reward
        self.iter_ctrls[i] = iter_ctrl

        store = True
        if self.config.check_errors_for_storage:
            if predicted_state is not None:
                err = np.abs(np.asarray(predicted_state, dtype=self.dtype) - self.states_next[i])
                store = bool(np.any(err > self._thr_err))
                self.errors[i] = err
            else:
                self.errors[i] = np.nan
            if predicted_state_std is not None:
                std = np.asarray(predicted_state_std, dtype=self.dtype)
                store = store and bool(np.any(std > self._thr_std))
                self.stds[i] = std
            else:
                self.stds[i] = np.nan

        self.active_data_mask[i] = store
        self.len_mem += 1

    def prepare_for_model(self) -> None:
        """Materialize model inputs/targets from unprocessed transitions
        (reference gp_memory.py:66-83).

        Unlike the reference — which only ever calls this at planning steps
        aligned to ``num_repeat_actions`` and can therefore blindly advance
        ``len_mem_last_processed`` to ``len_mem`` — this may also be called
        at training triggers that are NOT stride-aligned (the controller
        trains every ``training_frequency`` env steps). So the watermark only
        advances past stride-aligned candidates whose ``step_model`` target
        window ``s[t + step_model - 1]`` is already complete; incomplete ones
        stay unprocessed and are picked up (at the same aligned offsets) on a
        later call. Invariant: ``len_mem_last_processed % step_model == 0``,
        which keeps ``get_indexes_processed`` (stride from 0) consistent.
        """
        cand = np.arange(self.len_mem_last_processed, self.len_mem, self.step_model)
        # complete-window candidates form a prefix of `cand` (it is increasing)
        complete = cand[cand + self.step_model - 1 < self.len_mem]
        idxs = complete[self.active_data_mask[complete]]
        n_add = len(idxs)
        while len(self.model_inputs) < self.len_mem_model + n_add:
            self._grow_model()
        if n_add:
            self.model_inputs[self.len_mem_model : self.len_mem_model + n_add] = self.inputs[idxs]
            self.model_targets[self.len_mem_model : self.len_mem_model + n_add] = (
                self.states_next[idxs + self.step_model - 1] - self.inputs[idxs, : self.dim_state]
            )
        self.len_mem_model += n_add
        if len(complete):
            self.len_mem_last_processed = int(complete[-1]) + self.step_model

    # ------------------------------------------------------------------
    def get(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dense active (inputs, targets); dummy zero point when empty
        (reference gp_memory.py:105-112)."""
        if self.len_mem_model > 0:
            return (
                self.model_inputs[: self.len_mem_model],
                self.model_targets[: self.len_mem_model],
            )
        return (
            np.zeros((1, self.dim_input), dtype=self.dtype),
            np.zeros((1, self.dim_state), dtype=self.dtype),
        )

    def get_padded(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """(x_pad, y_pad, mask, bucket) — static-shape device view."""
        x, y = self.get()
        n = len(x)
        b = bucket_size(n)
        x_pad = np.zeros((b, self.dim_input), dtype=self.dtype)
        y_pad = np.zeros((b, self.dim_state), dtype=self.dtype)
        mask = np.zeros((b,), dtype=bool)
        x_pad[:n] = x
        y_pad[:n] = y
        mask[:n] = True
        return x_pad, y_pad, mask, b

    def get_memory_total(self) -> Tuple[np.ndarray, np.ndarray]:
        """All processed points regardless of filter (reference gp_memory.py:85-99)."""
        idxs = self.get_indexes_processed()
        idxs = idxs[idxs + self.step_model - 1 < self.len_mem]
        inputs = self.inputs[idxs]
        targets = self.states_next[idxs + self.step_model - 1] - self.inputs[idxs, : self.dim_state]
        return inputs, targets

    def get_indexes_processed(self) -> np.ndarray:
        return np.arange(0, self.len_mem_last_processed, self.step_model)

    def get_mask_model_inputs(self) -> np.ndarray:
        return self.active_data_mask[self.get_indexes_processed()]

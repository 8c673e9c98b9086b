"""Minimal gym-compatible env interface (no gym dependency).

A copy of ``gpmpc_tpu/envs/base.py`` (plain numpy).

The reference runs against gym 0.17's 4-tuple step API
(run_env_function.py:34). These built-in envs expose the same surface —
``observation_space``/``action_space`` with low/high, ``reset() -> obs``,
``step(a) -> (obs, reward, done, info)`` — so the runner works identically
with them, with real gym/gymnasium envs (5-tuple handled in the runner), or
with any user env following either convention. Deterministic seeding makes
them usable as test fixtures (SURVEY.md §4 calls for gym-free replicas of
Pendulum-v0 / MountainCarContinuous-v0 since gym 0.17 is unavailable).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Box(NamedTuple):
    low: np.ndarray
    high: np.ndarray

    @property
    def shape(self):
        return self.low.shape

    def sample(self, rng: np.random.Generator):
        return rng.uniform(self.low, self.high).astype(np.float64)


class EnvBase:
    observation_space: Box
    action_space: Box
    name: str = "env"

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def seed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def render(self, mode="human"):
        return None

    @staticmethod
    def _fig_to_rgb(fig) -> "np.ndarray":
        """Rasterize a matplotlib figure to an (H, W, 3) uint8 frame —
        backs the built-in envs' render(mode='rgb_array'), which feeds the
        episode video capture (reference records mp4 via gym VideoRecorder,
        visu_object.py:56)."""
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())
        return buf[:, :, :3].copy()

    def close(self):
        return None

    def __exit__(self, *args):
        self.close()

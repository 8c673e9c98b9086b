"""Deterministic, gym-free replica of MountainCarContinuous-v0 dynamics.

A copy of ``gpmpc_tpu/envs/mountain_car.py`` (plain numpy).

Same physics/reward as OpenAI gym 0.17 (the reference's sparse-reward
exploration benchmark, reference README.md:123-133): position in
[-1.2, 0.6], velocity in [-0.07, 0.07], engine power 0.0015, +100 on
reaching the 0.45 goal, -0.1*a^2 action penalty per step.
"""

from __future__ import annotations

import numpy as np

from .base import Box, EnvBase


class MountainCarContinuousEnv(EnvBase):
    name = "MountainCarContinuous-v0"

    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07
    goal_position = 0.45
    power = 0.0015

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self.observation_space = Box(
            low=np.array([self.min_position, -self.max_speed]),
            high=np.array([self.max_position, self.max_speed]),
        )
        self.action_space = Box(low=np.array([-1.0]), high=np.array([1.0]))
        self.state = np.zeros(2)

    def reset(self):
        self.state = np.array([self.rng.uniform(-0.6, -0.4), 0.0])
        return self.state.copy()

    def step(self, action):
        position, velocity = self.state
        force = float(np.clip(np.asarray(action).reshape(-1)[0], -1.0, 1.0))

        velocity += force * self.power - 0.0025 * np.cos(3 * position)
        velocity = np.clip(velocity, -self.max_speed, self.max_speed)
        position += velocity
        position = np.clip(position, self.min_position, self.max_position)
        if position == self.min_position and velocity < 0:
            velocity = 0.0

        done = bool(position >= self.goal_position)
        reward = (100.0 if done else 0.0) - 0.1 * force**2

        self.state = np.array([position, velocity])
        return self.state.copy(), reward, done, {}

    def render(self, mode="human"):
        if mode != "rgb_array":
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        pos = float(self.state[0])
        xs = np.linspace(self.min_position, self.max_position, 100)
        ys = np.sin(3 * xs) * 0.45 + 0.55
        fig, ax = plt.subplots(figsize=(3.2, 2.0), dpi=80)
        ax.plot(xs, ys, color="k", lw=1)
        ax.plot([pos], [np.sin(3 * pos) * 0.45 + 0.55], marker="o", markersize=8, color="tab:red")
        gx = self.goal_position
        ax.plot([gx, gx], [np.sin(3 * gx) * 0.45 + 0.55, np.sin(3 * gx) * 0.45 + 0.75], color="g", lw=2)
        ax.axis("off")
        frame = self._fig_to_rgb(fig)
        plt.close(fig)
        return frame

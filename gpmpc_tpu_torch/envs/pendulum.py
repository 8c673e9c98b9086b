"""Deterministic, gym-free replica of classic Pendulum-v0 dynamics.

A copy of ``gpmpc_tpu/envs/pendulum.py`` (plain numpy).

Same physics and reward as OpenAI gym 0.17 Pendulum-v0 (the reference's
headline benchmark env, reference README.md:99-105): state (theta, thetadot),
observation (cos, sin, thetadot), torque in [-2, 2], dt=0.05, g=10, m=l=1.
"""

from __future__ import annotations

import numpy as np

from .base import Box, EnvBase


def angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class PendulumEnv(EnvBase):
    name = "Pendulum-v0"

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self.observation_space = Box(
            low=np.array([-1.0, -1.0, -self.max_speed]),
            high=np.array([1.0, 1.0, self.max_speed]),
        )
        self.action_space = Box(low=np.array([-self.max_torque]), high=np.array([self.max_torque]))
        self.state = np.zeros(2)

    def reset(self):
        high = np.array([np.pi, 1.0])
        self.state = self.rng.uniform(-high, high)
        return self._get_obs()

    def step(self, action):
        th, thdot = self.state
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -self.max_torque, self.max_torque))
        g, m, l, dt = self.g, self.m, self.l, self.dt

        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (-3 * g / (2 * l) * np.sin(th + np.pi) + 3.0 / (m * l**2) * u) * dt
        newth = th + newthdot * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)

        self.state = np.array([newth, newthdot])
        return self._get_obs(), -costs, False, {}

    def _get_obs(self):
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot])

    def render(self, mode="human"):
        if mode != "rgb_array":
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        th = float(self.state[0])
        fig, ax = plt.subplots(figsize=(2.4, 2.4), dpi=80)
        # gym draws the rod tip at (sin th, cos th): upright = up
        ax.plot([0, np.sin(th)], [0, np.cos(th)], lw=6, color="#8b4513", solid_capstyle="round")
        ax.add_patch(plt.Circle((0, 0), 0.05, color="k"))
        ax.set_xlim(-1.2, 1.2)
        ax.set_ylim(-1.2, 1.2)
        ax.set_aspect("equal")
        ax.axis("off")
        frame = self._fig_to_rgb(fig)
        plt.close(fig)
        return frame

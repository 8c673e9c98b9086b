"""Tank level/concentration process-control env.

A copy of ``gpmpc_tpu/envs/process_control.py`` (plain numpy).

Re-implementation of the reference's custom MIMO testbed
(reference rl_gp_mpc/envs/process_control.py:6-154): a tank with an
uncontrolled inflow (flow fi, concentration ci), a controlled inflow
(action[1], concentration cr) and a controlled outflow (action[0]); Euler
mass-balance integration, log-uniform measurement noise on both observations,
random parameter draws, and optional parameter re-randomization every
``period_change`` steps to exercise time-varying dynamics.

Observations: [level, concentration]; actions: [outflow, inflow] in [0,1].
Reward: negative squared distance of (level, concentration) from their
setpoints.
"""

from __future__ import annotations

import numpy as np

from .base import Box, EnvBase


class ProcessControl(EnvBase):
    name = "processcontrol"

    def __init__(
        self,
        dt=1.0,
        s_range=(9, 11),
        fi_range=(0.0, 0.2),
        ci_range=(0.0, 0.2),
        cr_range=(0.5, 1.0),
        noise_l_prop_range=(1e-5, 1e-3),
        noise_co_prop_range=(1e-5, 1e-3),
        sp_l_range=(0.2, 0.8),
        sp_co_range=(0.2, 0.4),
        change_params=True,
        period_change=50,
        seed: int = 0,
        verbose: bool = False,
    ):
        super().__init__(seed)
        self.observation_space = Box(low=np.array([0.0, 0.0]), high=np.array([10.0, 1.0]))
        self.action_space = Box(low=np.array([0.0, 0.0]), high=np.array([1.0, 1.0]))

        self.dt = dt
        self.s_range = s_range
        self.fi_range = fi_range
        self.ci_range = ci_range
        self.cr_range = cr_range
        self.noise_l_prop_range = noise_l_prop_range
        self.noise_co_prop_range = noise_co_prop_range
        self.sp_l_range = sp_l_range
        self.sp_co_range = sp_co_range
        self.change_params = change_params
        self.period_change = period_change
        self.verbose = verbose
        self.iter = 0
        self.define_params()

    def define_params(self):
        r = self.rng
        self.s = r.uniform(*self.s_range)
        self.fi = r.uniform(*self.fi_range)
        self.ci = r.uniform(*self.ci_range)
        self.cr = r.uniform(*self.cr_range)
        self.noise_l_prop = np.exp(r.uniform(np.log(self.noise_l_prop_range[0]), np.log(self.noise_l_prop_range[1])))
        self.noise_co_prop = np.exp(r.uniform(np.log(self.noise_co_prop_range[0]), np.log(self.noise_co_prop_range[1])))
        self.sp_l = r.uniform(*self.sp_l_range)
        self.sp_co = r.uniform(*self.sp_co_range)
        if hasattr(self, "v"):
            self._clip_after_param_change()
        if self.verbose:
            print(
                f"New params: s={self.s:.2f} fi={self.fi:.2f} ci={self.ci:.2f} cr={self.cr:.2f} "
                f"noise_l={self.noise_l_prop:.4f} noise_co={self.noise_co_prop:.4f} "
                f"sp_l={self.sp_l:.2f} sp_co={self.sp_co:.2f}"
            )

    def _clip_after_param_change(self, prop_level_max=0.9):
        v_prev = self.v
        self.v = np.clip(self.v, 0.0, prop_level_max * self.s * self.observation_space.high[0])
        if v_prev > 0:
            self.r = self.r * self.v / v_prev

    def reset(self, min_prop=0.3, max_prop=0.7):
        self.iter = 0
        lo, hi = self.observation_space.low, self.observation_space.high
        obs = np.clip(self.observation_space.sample(self.rng), min_prop * (hi - lo) + lo, max_prop * (hi - lo) + lo)
        self.v = obs[0] * self.s
        self.r = obs[1] * self.v
        return self.get_obs()

    def step(self, action):
        action = np.asarray(action, dtype=np.float64)
        dv = self.fi + action[1] - action[0]
        dr = self.fi * self.ci + action[1] * self.cr - action[0] * self.r / (self.v + 1e-3)
        self.v += dv * self.dt
        self.r += dr * self.dt
        self.iter += 1

        lo, hi = self.observation_space.low, self.observation_space.high
        self.v = np.clip(self.v, lo[0] * self.s, hi[0] * self.s)
        self.r = np.clip(self.r, lo[1] * self.v, hi[1] * self.v)

        reward = -((self.v / self.s - self.sp_l) ** 2 + (self.r / (self.v + 1e-6) - self.sp_co) ** 2)
        if self.change_params and self.iter % self.period_change == 0:
            self.define_params()
        return self.get_obs(), reward, False, {}

    def render(self, mode="human"):
        if mode != "rgb_array":
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        level = float(self.v / self.s) / float(self.observation_space.high[0])
        conc = float(self.r / (self.v + 1e-6)) / float(self.observation_space.high[1])
        fig, ax = plt.subplots(figsize=(2.4, 2.4), dpi=80)
        ax.bar([0, 1], [level, conc], color=["tab:blue", "tab:orange"], width=0.6)
        ax.axhline(self.sp_l, xmin=0.05, xmax=0.45, color="tab:blue", ls="--", lw=1)
        ax.axhline(self.sp_co, xmin=0.55, xmax=0.95, color="tab:orange", ls="--", lw=1)
        ax.set_xticks([0, 1], ["level", "conc"])
        ax.set_ylim(0, 1)
        frame = self._fig_to_rgb(fig)
        plt.close(fig)
        return frame

    def get_obs(self):
        lo, hi = self.observation_space.low, self.observation_space.high
        l_mes = self.v / self.s
        co_mes = self.r / (self.v + 1e-6)
        if self.noise_l_prop != 0:
            l_mes += self.rng.normal(0, self.noise_l_prop * hi[0])
        if self.noise_co_prop != 0:
            co_mes += self.rng.normal(0, self.noise_co_prop * hi[1])
        return np.array([np.clip(l_mes, lo[0], hi[0]), np.clip(co_mes, lo[1], hi[1])])

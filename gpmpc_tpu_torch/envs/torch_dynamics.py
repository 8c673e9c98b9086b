"""The three envs as pure tensor functions, for on-device episodes.

Port of ``gpmpc_tpu/envs/jax_dynamics.py``: the dynamics of the numpy envs
(pendulum.py, mountain_car.py, process_control.py) as functions of a state
held in tensors on the env's device, so that an episode
(``runner/episode.py``) keeps the env beside the model and never reads it
back to the host.

Each env is a ``TorchEnvSpec``: ``init_fn(generator) -> (env_state, obs)``
and ``step_fn(env_state, action_raw, generator) -> (env_state, obs,
reward)``, with ``generator`` a ``torch.Generator`` on the CPU. Every random
value an env takes goes through its one replaceable ``draw(generator,
name)``, which returns the named values in their ranges (f64, on the CPU;
the env casts them to its dtype and device):

* pendulum: ``"init"``, (2,) the angle in [-pi, pi) and the angular speed
  in [-1, 1);
* mountain car: ``"init"``, (1,) the position in [-0.6, -0.4);
* process control: ``"params"``, (8,) the tank parameters in the order of
  ``PROCESS_PARAMS`` (the two noise levels log-uniform); ``"frac"``, (2,)
  the initial level and concentration fractions in [0.3, 0.7); ``"noise"``,
  (2,) the standard normals of one observation's measurement noise. Its
  init draws params, frac, noise; each step draws params only where
  ``change_params`` redraws them (every ``period_change`` steps), then
  noise.

JAX's keys cannot be reproduced here, so a test that holds an env to the
JAX one passes a ``draw`` that returns the JAX package's values.

A batch of envs (the seeds of an episode batch, in lockstep) steps in one
call: ``step_fn`` takes a state stacked over a leading axis
(``stack_states`` of the seeds' ``init_fn`` states) and actions (S, Na),
with ``generator`` a list of the seeds' generators, each seed's draws made
from its own in its order; every element computes what it would alone.

``dtype`` is the env's arithmetic (f64 under mixed mode, as in the JAX
package's sweep); an action of another dtype is cast to it first, which is
exact from f32 to f64, as JAX's type promotion is. ``device`` None is
``cuda``, where the step tensors then live.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.lanewise import lanewise

PROCESS_PARAMS = ("s", "fi", "ci", "cr", "noise_l", "noise_co", "sp_l", "sp_co")


class TorchEnvSpec(NamedTuple):
    name: str
    obs_low: np.ndarray
    obs_high: np.ndarray
    act_low: np.ndarray
    act_high: np.ndarray
    init_fn: Callable  # generator -> (env_state, obs)
    step_fn: Callable  # (env_state, action_raw, generator) -> (env_state, obs, reward)
    dtype: torch.dtype = torch.float64
    device: torch.device = torch.device("cpu")


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _uniform(generator, lo, hi):
    """Uniform (f64, CPU) in [lo, hi) elementwise, lo and hi sequences."""
    lo, hi = torch.tensor(lo, dtype=torch.float64), torch.tensor(hi, dtype=torch.float64)
    return lo + torch.rand(lo.shape, generator=generator, dtype=torch.float64) * (hi - lo)


def _drawn(values, dtype, device) -> torch.Tensor:
    """A draw's values (a tensor or anything numpy takes) as a tensor of the
    env's dtype on its device."""
    return torch.tensor(np.array(values, dtype=np.float64)).to(device=device, dtype=dtype)


def _draw_each(draw, generator, name, dtype, device) -> torch.Tensor:
    """The named draw from one generator, or from each of a list of them
    (a batch of envs), stacked on a leading axis."""
    if isinstance(generator, (list, tuple)):
        return torch.stack([_drawn(draw(g, name), dtype, device) for g in generator])
    return _drawn(draw(generator, name), dtype, device)


def stack_states(states):
    """The env states of a batch of envs (each from ``init_fn``) stacked on
    a leading axis: tensors stacked; a dict's tensors stacked and its other
    values (the step counter, the same for every env in lockstep) kept."""
    first = states[0]
    if isinstance(first, dict):
        return {k: stack_states([s[k] for s in states]) if isinstance(v, (dict, torch.Tensor)) else v
                for k, v in first.items()}
    return torch.stack(states)


def _angle_normalize(x):
    return ((x + math.pi) % (2 * math.pi)) - math.pi


def pendulum_spec(dtype=torch.float64, device=None, draw=None) -> TorchEnvSpec:
    max_speed, max_torque, dt, g, m, l = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
    device = _device(device)

    def default_draw(generator, name):
        return _uniform(generator, [-math.pi, -1.0], [math.pi, 1.0])

    draw = draw or default_draw

    def _obs(state):
        th, thdot = state[..., 0], state[..., 1]
        return torch.stack([lanewise(torch.cos, th), lanewise(torch.sin, th), thdot], dim=-1)

    def init_fn(generator):
        state = _drawn(draw(generator, "init"), dtype, device)
        return state, _obs(state)

    def step_fn(state, action_raw, generator):
        th, thdot = state[..., 0], state[..., 1]
        u = torch.clamp(action_raw[..., 0].to(dtype), -max_torque, max_torque)
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (-3 * g / (2 * l) * lanewise(torch.sin, th + math.pi) + 3.0 / (m * l**2) * u) * dt
        newth = th + newthdot * dt
        newthdot = torch.clamp(newthdot, -max_speed, max_speed)
        new_state = torch.stack([newth, newthdot], dim=-1)
        return new_state, _obs(new_state), -cost

    return TorchEnvSpec(
        name="Pendulum-v0",
        obs_low=np.array([-1.0, -1.0, -max_speed]),
        obs_high=np.array([1.0, 1.0, max_speed]),
        act_low=np.array([-max_torque]),
        act_high=np.array([max_torque]),
        init_fn=init_fn,
        step_fn=step_fn,
        dtype=dtype,
        device=device,
    )


def mountain_car_spec(dtype=torch.float64, device=None, draw=None) -> TorchEnvSpec:
    min_pos, max_pos, max_speed, goal, power = -1.2, 0.6, 0.07, 0.45, 0.0015
    device = _device(device)

    def default_draw(generator, name):
        return _uniform(generator, [-0.6], [-0.4])

    draw = draw or default_draw

    def init_fn(generator):
        pos = _drawn(draw(generator, "init"), dtype, device)
        state = torch.cat([pos.reshape(1), torch.zeros(1, dtype=dtype, device=device)])
        return state, state

    def step_fn(state, action_raw, generator):
        pos, vel = state[..., 0], state[..., 1]
        force = torch.clamp(action_raw[..., 0].to(dtype), -1.0, 1.0)
        vel = torch.clamp(vel + force * power - 0.0025 * lanewise(torch.cos, 3 * pos), -max_speed, max_speed)
        new_pos = torch.clamp(pos + vel, min_pos, max_pos)
        vel = torch.where((new_pos == min_pos) & (vel < 0), torch.zeros_like(vel), vel)
        reward = torch.where(new_pos >= goal, 100.0, 0.0).to(dtype) - 0.1 * force**2
        new_state = torch.stack([new_pos, vel], dim=-1)
        return new_state, new_state, reward

    return TorchEnvSpec(
        name="MountainCarContinuous-v0",
        obs_low=np.array([min_pos, -max_speed]),
        obs_high=np.array([max_pos, max_speed]),
        act_low=np.array([-1.0]),
        act_high=np.array([1.0]),
        init_fn=init_fn,
        step_fn=step_fn,
        dtype=dtype,
        device=device,
    )


def process_control_spec(
    dt=1.0,
    s_range=(20, 30),
    fi_range=(0.15, 0.3),
    ci_range=(0.15, 0.2),
    cr_range=(0.8, 1.0),
    noise_l_prop_range=(5e-3, 1e-2),
    noise_co_prop_range=(5e-3, 1e-2),
    sp_l_range=(0.4, 0.6),
    sp_co_range=(0.4, 0.6),
    change_params=False,
    period_change=200,
    dtype=torch.float64,
    device=None,
    draw=None,
) -> TorchEnvSpec:
    """Tank process env. env_state is a dict of the physical state (v, r),
    the step counter ``iter`` (a Python int: whether a step redraws the
    parameters is a function of the step) and the parameters, each a 0-dim
    tensor; with change_params they are redrawn every period_change steps
    (reference process_control.py:93-95)."""
    obs_low = np.array([0.0, 0.0])
    obs_high = np.array([10.0, 1.0])
    device = _device(device)
    log_l, log_co = np.log(noise_l_prop_range), np.log(noise_co_prop_range)
    param_lo = [s_range[0], fi_range[0], ci_range[0], cr_range[0], log_l[0], log_co[0], sp_l_range[0], sp_co_range[0]]
    param_hi = [s_range[1], fi_range[1], ci_range[1], cr_range[1], log_l[1], log_co[1], sp_l_range[1], sp_co_range[1]]

    def default_draw(generator, name):
        if name == "params":
            u = _uniform(generator, param_lo, param_hi)
            return torch.cat([u[:4], torch.exp(u[4:6]), u[6:]])
        if name == "frac":
            return _uniform(generator, [0.3, 0.3], [0.7, 0.7])
        return torch.randn(2, generator=generator, dtype=torch.float64)

    draw = draw or default_draw

    def _draw_params(generator):
        values = _draw_each(draw, generator, "params", dtype, device)
        return {k: values[..., i] for i, k in enumerate(PROCESS_PARAMS)}

    def _obs(env_state, generator):
        p = env_state["params"]
        noise = _draw_each(draw, generator, "noise", dtype, device)
        l_mes = env_state["v"] / p["s"] + noise[..., 0] * p["noise_l"] * obs_high[0]
        co_mes = env_state["r"] / (env_state["v"] + 1e-6) + noise[..., 1] * p["noise_co"] * obs_high[1]
        return torch.stack([torch.clamp(l_mes, obs_low[0], obs_high[0]), torch.clamp(co_mes, obs_low[1], obs_high[1])],
                           dim=-1)

    def init_fn(generator):
        params = _draw_params(generator)
        frac = _drawn(draw(generator, "frac"), dtype, device)
        v = frac[0] * obs_high[0] * params["s"]
        r = frac[1] * obs_high[1] * v
        env_state = {"v": v, "r": r, "iter": 0, "params": params}
        return env_state, _obs(env_state, generator)

    def step_fn(env_state, action_raw, generator):
        p = env_state["params"]
        v, r = env_state["v"], env_state["r"]
        a = action_raw.to(dtype)
        dv = p["fi"] + a[..., 1] - a[..., 0]
        dr = p["fi"] * p["ci"] + a[..., 1] * p["cr"] - a[..., 0] * r / (v + 1e-3)
        v = v + dv * dt
        r = r + dr * dt
        it = env_state["iter"] + 1
        v = torch.minimum(torch.maximum(v, obs_low[0] * p["s"]), obs_high[0] * p["s"])
        r = torch.minimum(torch.maximum(r, obs_low[1] * v), obs_high[1] * v)
        reward = -((v / p["s"] - p["sp_l"]) ** 2 + (r / (v + 1e-6) - p["sp_co"]) ** 2)

        if change_params and it % period_change == 0:
            p = _draw_params(generator)
            # clip v to 90% of the new tank's capacity
            v_clipped = torch.minimum(torch.maximum(v, torch.zeros_like(v)), 0.9 * p["s"] * obs_high[0])
            r = torch.where(v > 0, r * v_clipped / v, r)
            v = v_clipped

        new_state = {"v": v, "r": r, "iter": it, "params": p}
        return new_state, _obs(new_state, generator), reward

    return TorchEnvSpec(
        name="processcontrol",
        obs_low=obs_low,
        obs_high=obs_high,
        act_low=np.array([0.0, 0.0]),
        act_high=np.array([1.0, 1.0]),
        init_fn=init_fn,
        step_fn=step_fn,
        dtype=dtype,
        device=device,
    )

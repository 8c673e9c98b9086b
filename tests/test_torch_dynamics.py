"""The port's on-device env dynamics (envs/torch_dynamics.py) against the
JAX package's (envs/jax_dynamics.py), in f64 on the CPU.

JAX's random keys cannot be reproduced in torch, so each port env takes
JAX's drawn values through its one replaceable ``draw``: the initial state,
process control's parameters and initial fractions, and its measurement
noise (the standard normals JAX draws from the same keys, recomputed here).
Both then run the same arithmetic, held to TOL = 1e-12 of each value's scale
(measured gaps: a few ulps).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.envs import jax_dynamics as jd
from gpmpc_tpu_torch.envs import torch_dynamics as td

TOL = 1e-12
CPU = "cpu"


def _close(out, ref, what):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, dtype=np.float64)
    assert out.shape == ref.shape, what
    assert np.all(np.abs(out - ref) <= TOL * np.maximum(1.0, np.abs(ref))), (what, out, ref)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("name", ["pendulum", "mountain_car", "process_control"])
def test_spec_boxes_match_jax(name):
    jspec = getattr(jd, f"{name}_spec")()
    tspec = getattr(td, f"{name}_spec")(device=CPU)
    assert tspec.name == jspec.name
    for k in ("obs_low", "obs_high", "act_low", "act_high"):
        assert np.array_equal(getattr(tspec, k), getattr(jspec, k)), k
    assert tspec.dtype == torch.float64 and tspec.device.type == "cpu"
    assert getattr(td, f"{name}_spec")().device.type == "cuda"  # cuda unless asked


def test_pendulum_init_and_steps_match_jax():
    jspec = jd.pendulum_spec()
    rng = np.random.default_rng(0)
    for seed in range(3):
        jstate, jobs = jspec.init_fn(jax.random.PRNGKey(seed))
        tspec = td.pendulum_spec(device=CPU, draw=lambda g, name, s=np.asarray(jstate): s)
        tstate, tobs = tspec.init_fn(torch.Generator())
        _close(tstate, jstate, "init state")
        _close(tobs, jobs, "init obs")
        for i in range(40):
            a = rng.uniform(-2.5, 2.5, 1)  # beyond the torque box too: both clip
            jstate, jobs, jr = jspec.step_fn(jstate, jnp.asarray(a), None)
            tstate, tobs, tr = tspec.step_fn(tstate, _t(a), None)
            for out, ref, what in ((tstate, jstate, "state"), (tobs, jobs, "obs"), (tr, jr, "reward")):
                _close(out, ref, f"{what} at step {i}")


@pytest.mark.parametrize("event, start, force", [("wall", (-1.15, -0.05), -1.0), ("goal", (0.40, 0.03), 1.0),
                                                   ("valley", (-0.5, 0.0), 0.3)])
def test_mountain_car_steps_match_jax(event, start, force):
    """Through the left wall (position clipped, velocity zeroed), into the
    goal (reward 100) and in the valley; actions beyond the box clip."""
    jspec = jd.mountain_car_spec()
    tspec = td.mountain_car_spec(device=CPU)
    jstate, tstate = jnp.asarray(start), _t(start)
    rng = np.random.default_rng(1)
    events = set()
    for i in range(12):
        a = np.array([force * (1.0 + rng.uniform(-0.2, 0.6))])
        jstate, jobs, jr = jspec.step_fn(jstate, jnp.asarray(a), None)
        tstate, tobs, tr = tspec.step_fn(tstate, _t(a), None)
        for out, ref, what in ((tstate, jstate, "state"), (tobs, jobs, "obs"), (tr, jr, "reward")):
            _close(out, ref, f"{what} at step {i}")
        if float(jstate[0]) == -1.2 and float(jstate[1]) == 0.0:
            events.add("wall")
        events.add("goal" if float(jr) > 50 else "valley")
    assert event in events


def test_mountain_car_init_draw_and_dtype():
    jstate, jobs = jd.mountain_car_spec().init_fn(jax.random.PRNGKey(4))
    tspec = td.mountain_car_spec(device=CPU, draw=lambda g, name: np.asarray(jstate[:1]))
    tstate, tobs = tspec.init_fn(torch.Generator())
    _close(tstate, jstate, "init")
    # the default draw: a position in [-0.6, -0.4), at rest, in the spec's dtype
    state, _ = td.mountain_car_spec(dtype=torch.float32, device=CPU).init_fn(torch.Generator().manual_seed(0))
    assert state.dtype == torch.float32 and -0.6 <= float(state[0]) < -0.4 and float(state[1]) == 0.0


def _jax_noise(key):
    """The two standard normals of one JAX process-control observation."""
    return np.array([float(jax.random.normal(key, (), jnp.float64)),
                     float(jax.random.normal(jax.random.fold_in(key, 1), (), jnp.float64))])


def _params(state):
    return np.array([float(state["params"][k]) for k in td.PROCESS_PARAMS])


def test_process_control_matches_jax_across_param_changes():
    """change_params with period 3: seven steps cross two redraws of the
    tank parameters (the level clipped to 90 % of the new tank); JAX's
    drawn parameters, fractions and noise are fed to the port."""
    period = 3
    jspec = jd.process_control_spec(change_params=True, period_change=period)
    key = jax.random.PRNGKey(7)
    jstate, jobs = jspec.init_fn(key)
    kp, ko, ks = jax.random.split(key, 3)
    feed = [_params(jstate), np.asarray(jax.random.uniform(ks, (2,), jnp.float64, 0.3, 0.7)), _jax_noise(ko)]

    def draw(generator, name):
        value = feed.pop(0)
        assert len(value) == {"params": 8, "frac": 2, "noise": 2}[name], name
        return value

    tspec = td.process_control_spec(change_params=True, period_change=period, device=CPU, draw=draw)
    tstate, tobs = tspec.init_fn(torch.Generator())
    assert not feed
    _close(tobs, jobs, "init obs")
    for k in ("v", "r"):
        _close(tstate[k], jstate[k], f"init {k}")

    rng = np.random.default_rng(2)
    redraws = 0
    for i in range(7):
        a = rng.uniform(0, 1, 2)
        k = jax.random.PRNGKey(100 + i)
        jstate2, jobs, jr = jspec.step_fn(jstate, jnp.asarray(a), k)
        if (i + 1) % period == 0:
            feed.append(_params(jstate2))
            redraws += 1
            assert not np.array_equal(_params(jstate2), _params(jstate))
        feed.append(_jax_noise(jax.random.fold_in(k, 3)))
        tstate, tobs, tr = tspec.step_fn(tstate, _t(a), torch.Generator())
        assert not feed
        jstate = jstate2
        _close(tobs, jobs, f"obs at step {i}")
        _close(tr, jr, f"reward at step {i}")
        for name in ("v", "r"):
            _close(tstate[name], jstate[name], f"{name} at step {i}")
        _close(_params(tstate), _params(jstate), f"params at step {i}")
        assert tstate["iter"] == int(jstate["iter"]) == i + 1
    assert redraws == 2


def test_process_control_default_draws():
    """The default draws: parameters in their ranges (noise levels
    log-uniform), fractions in [0.3, 0.7), and one generator's stream that
    repeats from the same seed."""
    spec = td.process_control_spec(change_params=True, period_change=2, device=CPU)
    ranges = [(20, 30), (0.15, 0.3), (0.15, 0.2), (0.8, 1.0), (5e-3, 1e-2), (5e-3, 1e-2), (0.4, 0.6), (0.4, 0.6)]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        state, obs = spec.init_fn(g)
        trace = [obs]
        for _ in range(4):
            state, obs, _ = spec.step_fn(state, torch.tensor([0.3, 0.4], dtype=torch.float64), g)
            trace.append(obs)
            for (lo, hi), v in zip(ranges, _params(state)):
                assert lo <= v < hi
        return torch.stack(trace)

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    assert math.isfinite(float(run(5).sum()))

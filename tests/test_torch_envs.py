"""The port's MountainCarContinuousEnv and ProcessControl against the JAX
package's: the same numpy code, so the same seeds and actions give the same
trajectories exactly (observations, rewards, done flags, internal state)."""

import numpy as np
import pytest

from gpmpc_tpu.envs import MountainCarContinuousEnv as JaxMountainCar
from gpmpc_tpu.envs import ProcessControl as JaxProcessControl
from gpmpc_tpu_torch.envs import MountainCarContinuousEnv, ProcessControl


def _same_boxes(tenv, jenv):
    for box in ("observation_space", "action_space"):
        for k in ("low", "high"):
            assert np.array_equal(getattr(getattr(tenv, box), k), getattr(getattr(jenv, box), k))


@pytest.mark.parametrize("seed", [0, 3])
def test_mountain_car_matches_jax(seed):
    """Beyond the action box too (both clip), and long enough to hit the
    left wall (velocity reset) and the goal (done, +100)."""
    rng = np.random.default_rng(seed)
    push = np.concatenate([np.ones(50), -np.ones(50), np.ones(150)])  # rock to the wall, then to the goal
    actions = [np.array([a]) for a in push + rng.uniform(-0.6, 0.6, push.size)]
    tenv, jenv = MountainCarContinuousEnv(seed=seed), JaxMountainCar(seed=seed)
    _same_boxes(tenv, jenv)
    assert np.array_equal(tenv.reset(), jenv.reset())
    wall = done = False
    for a in actions:
        jo, jr, jd, _ = jenv.step(a)
        to, tr, td, _ = tenv.step(a)
        assert np.array_equal(to, jo) and tr == jr and td == jd
        wall |= bool(to[0] == tenv.min_position)
        done |= td
    assert np.array_equal(tenv.state, jenv.state)
    assert wall and done


@pytest.mark.parametrize("kw", [dict(change_params=False, seed=0),
                                dict(change_params=True, period_change=7, seed=1, dt=0.5, s_range=(20, 30))],
                         ids=["fixed", "changing"])
def test_process_control_matches_jax(kw):
    """With change_params the parameters are drawn again every period_change
    steps; 30 steps cross four such boundaries."""
    rng = np.random.default_rng(5)
    actions = [rng.uniform(-0.1, 1.1, 2) for _ in range(30)]
    tenv, jenv = ProcessControl(**kw), JaxProcessControl(**kw)
    params = ("s", "fi", "ci", "cr", "noise_l_prop", "noise_co_prop", "sp_l", "sp_co")
    assert all(getattr(tenv, p) == getattr(jenv, p) for p in params)
    drawn = {tenv.s}
    _same_boxes(tenv, jenv)
    assert np.array_equal(tenv.reset(), jenv.reset())
    for a in actions:
        jo, jr, jd, _ = jenv.step(a)
        to, tr, td, _ = tenv.step(a)
        assert np.array_equal(to, jo) and tr == jr and td == jd
        assert (tenv.v, tenv.r, tenv.iter) == (jenv.v, jenv.r, jenv.iter)
        assert all(getattr(tenv, p) == getattr(jenv, p) for p in params)
        drawn.add(tenv.s)
    assert len(drawn) == (5 if kw["change_params"] else 1)

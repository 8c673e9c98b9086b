"""The port's visualizations (headless Agg backend): the four cases of
tests/test_viz.py on the port, the live plot's wiring, and the 3D plot's
GP posterior against the JAX package's on the same controller state.

The posterior mean is held to TOL = 1e-9 relative to each output's largest
entry, and the posterior variance (std^2) to TOL of the output's prior
variance (its outputscale): the variance is that outputscale less a term of
the same size, so its rounding error scales with the outputscale, not with
the (small) variance. Both are the same f64 arithmetic in another order.
Measured: the mean 1.7e-12 and the variance 6.3e-11 with the trained
parameters (noise at its 1e-6 floor, cond(K) ~ 1e6, where std itself
differs by 1.8e-7 relative), both ~1e-13 with the initial ones.
"""

import glob
import os

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import gpmpc_tpu_torch  # noqa: E402
from gpmpc_tpu.models.gp import GPBounds as JaxBounds  # noqa: E402
from gpmpc_tpu.models.gp import GPParams as JaxParams  # noqa: E402
from gpmpc_tpu.viz.static_3d import _posterior_mean_std as jax_posterior_mean_std  # noqa: E402
from gpmpc_tpu_torch import ControlVisualizations, GpMpcController, VisuConfig, run_env  # noqa: E402
from gpmpc_tpu_torch.envs import MountainCarContinuousEnv, PendulumEnv, ProcessControl  # noqa: E402
from gpmpc_tpu_torch.viz.static_3d import _posterior_mean_std, save_plot_model_3d  # noqa: E402

from tests.test_torch_controller import small_pendulum_config  # noqa: E402

TOL = 1e-9


def _visu(tmp_path, **kw):
    return VisuConfig(**{"render_live_plot_2d": False, "render_env": False, "save_render_env": False,
                         "save_live_plot_2d": False, "folder_save": str(tmp_path), **kw})


def test_visualizations_write_artifacts(tmp_path):
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3)
    costs = run_env(PendulumEnv(seed=0), cfg, _visu(tmp_path), random_actions_init=4, num_steps=8, verbose=False,
                    device="cpu")
    assert len(costs) == 8

    pngs = glob.glob(os.path.join(str(tmp_path), "**", "*.png"), recursive=True)
    names = sorted(os.path.basename(p) for p in pngs)
    assert names == ["history_2d.png", "model_3d.png"], names
    for p in pngs:
        assert os.path.getsize(p) > 1000  # non-empty render


def test_env_video_capture(tmp_path):
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3)
    run_env(PendulumEnv(seed=0), cfg, _visu(tmp_path, save_render_env=True), random_actions_init=4, num_steps=6,
            verbose=False, device="cpu")
    vids = glob.glob(os.path.join(str(tmp_path), "**", "render_env.*"), recursive=True)
    assert vids, "no env video written"
    assert os.path.getsize(vids[0]) > 2000


def test_env_render_rgb_arrays():
    for env in (PendulumEnv(seed=0), MountainCarContinuousEnv(seed=0), ProcessControl(seed=0)):
        env.reset()
        frame = env.render(mode="rgb_array")
        assert frame is not None and frame.ndim == 3 and frame.shape[2] == 3
        assert frame.std() > 1.0  # not a constant image
        assert env.render(mode="human") is None


def _filtered_controller(**training):
    """A CPU controller after 14 random steps with the storage filter on
    (tests/test_viz.py's 3D case); a training that fires is waited for."""
    env = PendulumEnv(seed=0)
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3, **training)
    cfg.memory.check_errors_for_storage = True
    ctrl = GpMpcController(env.observation_space.low, env.observation_space.high, env.action_space.low,
                           env.action_space.high, cfg, seed=0, device="cpu")
    obs = env.reset()
    for _ in range(14):
        a = ctrl.get_action(obs_mu=obs, random=True)
        info = ctrl.get_iter_info()
        obs_new, r, _, _ = env.step(a)
        ctrl.add_memory(obs, a, obs_new, r, predicted_state=info.predicted_states[1],
                        predicted_state_std=info.predicted_states_std[1])
        obs = obs_new
    ctrl.wait_for_training()
    ctrl.memory.prepare_for_model()
    return ctrl


def test_3d_plot_has_memory_overlays(tmp_path):
    ctrl = _filtered_controller()
    try:
        path = save_plot_model_3d(ctrl, folder_save=str(tmp_path))
        assert path and os.path.getsize(path) > 10_000
    finally:
        ctrl.close()


@pytest.mark.parametrize("training", [{}, {"training_frequency": 100}], ids=["trained", "initial"])
def test_posterior_mean_std_matches_jax(training):
    """The port's posterior (torch, on the controller's device) against the
    JAX package's on the same memory and parameters (after the training
    that fires at step 12, or the initial ones), at the stored points and
    on random points beyond them."""
    ctrl = _filtered_controller(**training)
    ctrl.close()
    jax_ctrl = SimpleNamespace(
        memory=ctrl.memory,  # get_padded() gives host numpy arrays, what the JAX function reads
        gp_params=JaxParams(*(jnp.asarray(a.numpy()) for a in ctrl.gp_params)),
        bounds=JaxBounds(*(jnp.asarray(a.numpy()) for a in ctrl.bounds)),
    )
    x_mem, _ = ctrl.memory.get()
    query = np.concatenate([x_mem, np.random.default_rng(0).uniform(-0.2, 1.2, (40, x_mem.shape[1]))])
    mean, std = _posterior_mean_std(ctrl, query)
    jmean, jstd = jax_posterior_mean_std(jax_ctrl, query)
    assert mean.shape == std.shape == (ctrl.dim_state, len(query))
    assert np.all(np.abs(mean - jmean) <= TOL * np.abs(jmean).max(axis=1, keepdims=True))
    outputscale = ctrl.get_hyperparameters()[1][:, None]
    assert np.all(np.abs(std**2 - jstd**2) <= TOL * outputscale)


def test_live_plot_is_not_ported(tmp_path):
    """The live plot is ported now; the test keeps its earlier name. With
    render_live_plot_2d=True the visualization no longer raises: it starts
    the live plot's child process, feeds it and stops it at close, alone
    and through run_env (whose default VisuConfig turns it on)."""
    env = PendulumEnv(seed=0)
    cfg = small_pendulum_config(gpmpc_tpu_torch, len_horizon=3)
    visu = ControlVisualizations(env, 4, cfg, _visu(tmp_path, render_live_plot_2d=True))
    assert visu._live is not None and visu._live.proc.is_alive()
    visu._live.close(timeout=120)  # the child's start-up takes seconds, more on a loaded machine
    assert visu._live.proc.exitcode == 0
    visu.close()  # after the child: returns at once
    costs = run_env(env, cfg, VisuConfig(folder_save=str(tmp_path)), num_steps=2, verbose=False, device="cpu")
    assert len(costs) == 2
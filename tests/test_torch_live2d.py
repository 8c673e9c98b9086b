"""The port's live 2D plot (viz/live2d.py): a spawned child process, fed by
a queue, headless here (no DISPLAY: matplotlib's Agg backend)."""

import os
from types import SimpleNamespace

import numpy as np

from gpmpc_tpu_torch.viz.live2d import LivePlotProcess


def _iter_info(t, ns=2, nh=3):
    rng = np.random.default_rng(t)
    return SimpleNamespace(predicted_idxs=np.arange(t + 1, t + 1 + nh), predicted_states=rng.uniform(0, 1, (nh + 1, ns)),
                           predicted_states_std=rng.uniform(0, 0.1, (nh + 1, ns)), mean_predicted_cost=0.5,
                           mean_predicted_cost_std=0.05)


def test_live_plot_takes_records_and_exits(tmp_path, monkeypatch):
    """A few records, one without an iteration info, then the None sentinel:
    the child draws every record, writes the animation it was asked for and
    exits with code 0."""
    monkeypatch.delenv("DISPLAY", raising=False)
    folder = str(tmp_path / "live")
    live = LivePlotProcess(num_steps=6, dim_state=2, dim_action=1, use_constraints=True,
                           state_min=np.array([0.1, 0.2]), state_max=np.array([0.9, 0.8]), save_animation=True,
                           folder_save=folder)
    assert live.proc.is_alive() and live.proc.daemon
    for t in range(4):
        live.push(np.array([0.1 * t, 0.5]), np.array([0.3]), 1.0 - 0.1 * t, _iter_info(t) if t != 2 else None)
    live.close(timeout=120)  # the child imports torch and matplotlib first: seconds, more on a loaded machine
    assert not live.proc.is_alive()
    assert live.proc.exitcode == 0
    assert os.path.getsize(os.path.join(folder, "live_2d.gif")) > 0

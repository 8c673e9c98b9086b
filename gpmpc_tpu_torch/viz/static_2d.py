"""Static post-run 2D history plot.

A copy of ``gpmpc_tpu/viz/static_2d.py`` (numpy and matplotlib).

Equivalent of the reference static_2d_graph.py:15-95: three stacked axes —
normalized states with k-step-ahead predictions ±3σ, step actions, and
realized cost with mean predicted cost ±3σ — plus constraint lines, saved as
PNG into the run folder.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def save_plot_2d(
    states: np.ndarray,
    actions: np.ndarray,
    costs: np.ndarray,
    iter_infos: List,
    folder_save: str,
    use_constraints: bool = False,
    state_min: Optional[np.ndarray] = None,
    state_max: Optional[np.ndarray] = None,
    num_repeat_actions: int = 1,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    num_steps = len(states)
    dim_state = states.shape[1] if states.ndim == 2 else 1
    dim_action = actions.shape[1] if actions.ndim == 2 else 1
    x = np.arange(num_steps)

    fig, axes = plt.subplots(nrows=3, figsize=(12, 9), sharex=True)

    # one-step-ahead predictions gathered from iteration infos
    pred_mu = np.full((num_steps, dim_state), np.nan)
    pred_std = np.full((num_steps, dim_state), np.nan)
    pred_cost = np.full((num_steps,), np.nan)
    pred_cost_std = np.full((num_steps,), np.nan)
    for info in iter_infos:
        if info is None:
            continue
        idxs = np.asarray(info.predicted_idxs)
        mus = np.asarray(info.predicted_states)[1:]
        stds = np.asarray(info.predicted_states_std)[1:]
        valid = idxs < num_steps
        k = min(valid.sum(), len(mus))
        pred_mu[idxs[:k]] = mus[:k]
        pred_std[idxs[:k]] = stds[:k]
        it = int(info.iteration)
        if it < num_steps:
            pred_cost[it] = info.mean_predicted_cost
            pred_cost_std[it] = info.mean_predicted_cost_std

    for d in range(dim_state):
        (line,) = axes[0].plot(x, states[:, d], label=f"state {d}")
        color = line.get_color()
        axes[0].plot(x, pred_mu[:, d], "--", color=color, alpha=0.7)
        axes[0].fill_between(
            x,
            pred_mu[:, d] - 3 * pred_std[:, d],
            pred_mu[:, d] + 3 * pred_std[:, d],
            color=color,
            alpha=0.15,
        )
        if use_constraints and state_min is not None:
            axes[0].axhline(state_min[d], color=color, linestyle=":", alpha=0.5)
            axes[0].axhline(state_max[d], color=color, linestyle=":", alpha=0.5)
    axes[0].set_ylabel("normalized states")
    axes[0].legend(loc="upper right", fontsize=8)

    for d in range(dim_action):
        axes[1].step(x, actions[:, d], where="post", label=f"action {d}")
    axes[1].set_ylabel("normalized actions")
    axes[1].legend(loc="upper right", fontsize=8)

    axes[2].plot(x, costs, label="cost")
    axes[2].plot(x, pred_cost, "--", label="mean predicted cost")
    axes[2].fill_between(
        x, pred_cost - 3 * pred_cost_std, pred_cost + 3 * pred_cost_std, alpha=0.15
    )
    axes[2].set_ylabel("cost")
    axes[2].set_xlabel("env iteration")
    axes[2].legend(loc="upper right", fontsize=8)

    os.makedirs(folder_save, exist_ok=True)
    path = os.path.join(folder_save, "history_2d.png")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path

"""Live 2D plot in a child process.

Port of ``gpmpc_tpu/viz/live2d.py`` (numpy and matplotlib only, in the child),
the equivalent of the reference LivePlotParallel (dynamic_2d_graph.py:22-258): a
spawned process consumes a Queue of per-step records and redraws three
stacked axes (states + one-step predictions ±3σ, step actions, cost + mean
predicted cost ±3σ). A ``None`` sentinel shuts it down gracefully. When
``save_animation`` is set, frames are captured and assembled into a GIF with
imageio (if available) at close time.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Optional

import numpy as np


def _live_plot_worker(queue, num_steps, dim_state, dim_action, use_constraints, state_min, state_max, save_animation, folder_save):
    import matplotlib

    if save_animation or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    interactive = bool(os.environ.get("DISPLAY")) and not save_animation
    if interactive:
        plt.ion()

    fig, axes = plt.subplots(nrows=3, figsize=(10, 8), sharex=True)
    states = np.full((num_steps, dim_state), np.nan)
    actions = np.full((num_steps, dim_action), np.nan)
    costs = np.full((num_steps,), np.nan)
    pred_mu = np.full((num_steps, dim_state), np.nan)
    pred_std = np.full((num_steps, dim_state), np.nan)
    pred_cost = np.full((num_steps,), np.nan)
    pred_cost_std = np.full((num_steps,), np.nan)
    frames = []
    t = 0

    while True:
        item = queue.get()
        if item is None:
            break
        (state, action, cost, p_idxs, p_mu, p_std, p_cost, p_cost_std) = item
        if t < num_steps:
            states[t] = np.nan_to_num(state)
            actions[t] = np.nan_to_num(action)
            costs[t] = cost
            if p_idxs is not None and len(p_idxs) > 0:
                nxt = int(p_idxs[0])
                if nxt < num_steps and p_mu is not None:
                    pred_mu[nxt] = np.nan_to_num(p_mu)
                    pred_std[nxt] = np.nan_to_num(p_std)
            if p_cost is not None:
                pred_cost[t] = p_cost
                pred_cost_std[t] = p_cost_std
        t += 1

        x = np.arange(num_steps)
        for ax in axes:
            ax.cla()
        for d in range(dim_state):
            (line,) = axes[0].plot(x, states[:, d], label=f"state {d}")
            color = line.get_color()
            axes[0].plot(x, pred_mu[:, d], "--", color=color, alpha=0.6)
            axes[0].fill_between(x, pred_mu[:, d] - 3 * pred_std[:, d], pred_mu[:, d] + 3 * pred_std[:, d], color=color, alpha=0.15)
            if use_constraints:
                axes[0].axhline(state_min[d], color=color, linestyle=":", alpha=0.5)
                axes[0].axhline(state_max[d], color=color, linestyle=":", alpha=0.5)
        axes[0].set_ylabel("states")
        for d in range(dim_action):
            axes[1].step(x, actions[:, d], where="post")
        axes[1].set_ylabel("actions")
        axes[2].plot(x, costs, label="cost")
        axes[2].plot(x, pred_cost, "--", label="predicted")
        axes[2].fill_between(x, pred_cost - 3 * pred_cost_std, pred_cost + 3 * pred_cost_std, alpha=0.15)
        axes[2].set_ylabel("cost")
        axes[2].set_xlabel("iteration")

        if interactive:
            plt.pause(0.01)
        if save_animation:
            fig.canvas.draw()
            frame = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
            frames.append(frame)

    if save_animation and frames:
        try:
            import imageio

            os.makedirs(folder_save, exist_ok=True)
            imageio.mimsave(os.path.join(folder_save, "live_2d.gif"), frames, fps=10)
        except Exception as exc:
            print(f"live-plot animation save failed: {exc}")
    plt.close(fig)


class LivePlotProcess:
    def __init__(self, num_steps, dim_state, dim_action, use_constraints, state_min, state_max, save_animation, folder_save):
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.proc = ctx.Process(
            target=_live_plot_worker,
            args=(self.queue, num_steps, dim_state, dim_action, use_constraints, state_min, state_max, save_animation, folder_save),
            daemon=True,
        )
        self.proc.start()

    def push(self, state_norm, action_norm, cost, iter_info) -> None:
        p_idxs = np.asarray(iter_info.predicted_idxs) if iter_info is not None else None
        p_mu = np.asarray(iter_info.predicted_states)[1] if iter_info is not None else None
        p_std = np.asarray(iter_info.predicted_states_std)[1] if iter_info is not None else None
        p_cost = iter_info.mean_predicted_cost if iter_info is not None else None
        p_cost_std = iter_info.mean_predicted_cost_std if iter_info is not None else None
        self.queue.put((state_norm, action_norm, cost, p_idxs, p_mu, p_std, p_cost, p_cost_std))

    def close(self, timeout: float = 10.0) -> None:
        """Send the sentinel and wait up to ``timeout`` seconds for the child
        to draw what it was sent and exit; terminate it past that."""
        try:
            self.queue.put(None)
            self.proc.join(timeout=timeout)
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join()
        except Exception:
            pass

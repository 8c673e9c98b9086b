"""Static post-run 3D model plots.

Equivalent of the reference static_3d_graph.py:20-136: for each output dim,
pick the 2 most important inputs (largest inverse lengthscale), impute the
remaining input dims over a grid (KNN regressor when sklearn is available,
mean imputation otherwise), and render contour3D surfaces of the GP
posterior mean and std together with the stored (green) vs filtered-out
(black) memory points.

Port of ``gpmpc_tpu/viz/static_3d.py``: the GP posterior is computed in
PyTorch on the controller's device and moved to numpy for the plot.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.gp import constrained_params, masked_cholesky_factorize


def _posterior_mean_std(ctrl_obj, x_query: np.ndarray):
    """Plain (deterministic-input) GP posterior at query points, batched:
    (mean, std), each (Ns, Q) numpy, computed on the controller's device in
    its dtype."""
    x_pad, y_pad, mask, _ = ctrl_obj.memory.get_padded()

    def t(a, dtype=ctrl_obj.torch_dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=ctrl_obj.device)

    with torch.no_grad():
        xm, mask_t = t(x_pad), t(mask, torch.bool)
        cache = masked_cholesky_factorize(ctrl_obj.gp_params, ctrl_obj.bounds, xm, t(y_pad), mask_t)
        ls, outs, _ = constrained_params(ctrl_obj.gp_params, ctrl_obj.bounds)
        # cross-covariance k(x*, X): (Ns, Q, N)
        xs_q = t(x_query)[None, :, :] / ls[:, None, :]
        xs_m = xm[None, :, :] / ls[:, None, :]
        d2 = (
            torch.sum(xs_q**2, -1)[:, :, None]
            + torch.sum(xs_m**2, -1)[:, None, :]
            - 2.0 * torch.einsum("mqd,mnd->mqn", xs_q, xs_m)
        )
        Kqm = outs[:, None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
        Kqm = Kqm * mask_t.to(Kqm.dtype)[None, None, :]
        mean = torch.einsum("mqn,mn->mq", Kqm, cache.beta)
        var = outs[:, None] - torch.einsum("mqn,mnk,mqk->mq", Kqm, cache.iK, Kqm)
        std = torch.sqrt(torch.clamp(var, min=1e-12))
    return mean.cpu().numpy(), std.cpu().numpy()


def save_plot_model_3d(ctrl_obj, folder_save: str, grid: int = 50, plot_points_memory: bool = True) -> str:
    """Full reference parity (static_3d_graph.py:20-136): per output dim,
    GP mean + std contour3D surfaces over the 2 most important inputs,
    stored (green x) vs filtered-out (black x) memory scatter, trajectory
    quivers through consecutive transitions, and a prediction-error scatter
    on the std panel."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x_mem, y_mem = ctrl_obj.memory.get()
    if len(x_mem) < 3:
        return ""
    ls, _, _ = ctrl_obj.get_hyperparameters()
    dim_state = ctrl_obj.dim_state
    dim_input = ctrl_obj.dim_input

    # all processed points (stored AND filtered-out) + the filter mask
    # (reference uses memory.get_memory_total()/get_mask_model_inputs())
    inputs_total, targets_total = ctrl_obj.memory.get_memory_total()
    active_mask = np.asarray(ctrl_obj.memory.get_mask_model_inputs()[: len(inputs_total)], dtype=bool)
    have_total = len(inputs_total) >= 2 and len(active_mask) == len(inputs_total)

    try:
        from sklearn.neighbors import KNeighborsRegressor
        from sklearn.pipeline import Pipeline
        from sklearn.preprocessing import StandardScaler

        have_sklearn = True
    except Exception:
        have_sklearn = False

    # posterior at every processed point -> |error| scatter on the std panel
    # (reference static_3d_graph.py:120-136)
    if plot_points_memory and have_total:
        mean_total, _ = _posterior_mean_std(ctrl_obj, np.asarray(inputs_total, dtype=float))
        errors_total = np.abs(mean_total.T - np.asarray(targets_total, dtype=float))  # (Ntot, Ns)
    else:
        errors_total = None

    fig = plt.figure(figsize=(6 * dim_state, 10))
    for m in range(dim_state):
        importance = 1.0 / ls[m]
        top2 = np.argsort(importance)[::-1][:2]
        i0, i1 = int(top2[0]), int(top2[1])

        g0 = np.linspace(x_mem[:, i0].min(), x_mem[:, i0].max(), grid)
        g1 = np.linspace(x_mem[:, i1].min(), x_mem[:, i1].max(), grid)
        G0, G1 = np.meshgrid(g0, g1)
        q = np.tile(x_mem.mean(axis=0), (grid * grid, 1))
        q[:, i0] = G0.ravel()
        q[:, i1] = G1.ravel()

        rest = [d for d in range(dim_input) if d not in (i0, i1)]
        if have_sklearn and rest and len(x_mem) >= 5:
            for d in rest:
                knn = Pipeline([("scale", StandardScaler()), ("knn", KNeighborsRegressor(n_neighbors=min(5, len(x_mem))))])
                knn.fit(x_mem[:, [i0, i1]], x_mem[:, d])
                q[:, d] = knn.predict(q[:, [i0, i1]])

        mean, std = _posterior_mean_std(ctrl_obj, q)

        ax1 = fig.add_subplot(2, dim_state, m + 1, projection="3d")
        ax1.contour3D(G0, G1, mean[m].reshape(grid, grid), 50, cmap="viridis")
        ax1.set_title(f"GP mean — output {m}")
        ax1.set_xlabel(f"input {i0}")
        ax1.set_ylabel(f"input {i1}")

        ax2 = fig.add_subplot(2, dim_state, dim_state + m + 1, projection="3d")
        ax2.contour3D(G0, G1, std[m].reshape(grid, grid), 50, cmap="inferno")
        ax2.set_title(f"GP std — output {m}")
        ax2.set_xlabel(f"input {i0}")
        ax2.set_ylabel(f"input {i1}")

        if plot_points_memory and have_total:
            xt = np.asarray(inputs_total, dtype=float)
            yt = np.asarray(targets_total, dtype=float)
            # stored points (green) and filtered-out points (black) on the
            # mean panel (reference static_3d_graph.py:96-110)
            ax1.scatter(xt[active_mask, i0], xt[active_mask, i1], yt[active_mask, m], marker="x", c="g")
            if np.any(~active_mask):
                ax1.scatter(xt[~active_mask, i0], xt[~active_mask, i1], yt[~active_mask, m], marker="x", c="k")
            # trajectory quivers: arrows between consecutive transitions
            # (reference static_3d_graph.py:112-118)
            ax1.quiver(
                xt[:-1, i0], xt[:-1, i1], yt[:-1, m],
                xt[1:, i0] - xt[:-1, i0], xt[1:, i1] - xt[:-1, i1], yt[1:, m] - yt[:-1, m],
                color="k", linestyle="solid", alpha=0.3, arrow_length_ratio=0.001, length=0.9,
            )
            # prediction-error scatter + quivers on the std panel
            # (reference static_3d_graph.py:120-136)
            err = errors_total[:, m]
            ax2.scatter(xt[active_mask, i0], xt[active_mask, i1], err[active_mask], marker="x", c="g")
            if np.any(~active_mask):
                ax2.scatter(xt[~active_mask, i0], xt[~active_mask, i1], err[~active_mask], marker="x", c="k")
            ax2.quiver(
                xt[:-1, i0], xt[:-1, i1], err[:-1],
                xt[1:, i0] - xt[:-1, i0], xt[1:, i1] - xt[:-1, i1], err[1:] - err[:-1],
                color="k", linestyle="solid", alpha=0.3, arrow_length_ratio=0.001, length=0.9,
            )
        else:
            ax1.scatter(x_mem[:, i0], x_mem[:, i1], y_mem[:, m], c="g", s=6)

    os.makedirs(folder_save, exist_ok=True)
    path = os.path.join(folder_save, "model_3d.png")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path

"""Visualization facade.

Equivalent of the reference ControlVisualizations (visu_object.py:21-114):
collects normalized states/actions/rewards and deep-copied iteration infos,
optionally drives a live 2D plot, and on save() writes the static 2D history
plot and 3D model plots into a timestamped run folder
(visu_objects/utils.py:13-19 folder layout).

Port of ``gpmpc_tpu/viz/visu.py``. The live 2D plot (``viz/live2d.py``) is
not ported yet: ``render_live_plot_2d=True`` raises NotImplementedError.
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import List, Optional

import numpy as np

from ..config.configs import Config, VisuConfig


class ControlVisualizations:
    def __init__(self, env, num_steps: int, control_config: Config, visu_config: VisuConfig):
        self.env = env
        self.num_steps = num_steps
        self.control_config = control_config
        self.visu_config = visu_config

        self.states: List[np.ndarray] = []
        self.actions: List[np.ndarray] = []
        self.rewards: List[float] = []
        self.iter_infos: List = []

        env_name = getattr(env, "name", None) or getattr(getattr(env, "spec", None), "id", "env")
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.folder_save = os.path.join(visu_config.folder_save, str(env_name), stamp)

        # env video capture (reference records mp4 via gym VideoRecorder,
        # visu_object.py:56); frames are collected per update() and written
        # as render_env.mp4 (gif fallback when no ffmpeg backend) on save()
        self._frames: List[np.ndarray] = []
        self._capture_video = bool(visu_config.save_render_env)

        if visu_config.render_live_plot_2d:
            raise NotImplementedError(
                "render_live_plot_2d: the live 2D plot (gpmpc_tpu/viz/live2d.py) is not ported yet "
                "(ROADMAP queue A item 7); pass VisuConfig(render_live_plot_2d=False)")

    # ------------------------------------------------------------------
    def update(self, obs, reward, action, env=None, iter_info=None) -> None:
        obs = np.asarray(obs, dtype=float)
        action = np.asarray(action, dtype=float)
        obs_low = np.asarray(self.env.observation_space.low, dtype=float)
        obs_high = np.asarray(self.env.observation_space.high, dtype=float)
        act_low = np.asarray(self.env.action_space.low, dtype=float)
        act_high = np.asarray(self.env.action_space.high, dtype=float)

        state_norm = (obs - obs_low) / (obs_high - obs_low)
        action_norm = (action - act_low) / (act_high - act_low)

        self.states.append(state_norm)
        self.actions.append(action_norm)
        self.rewards.append(float(reward))
        self.iter_infos.append(copy.deepcopy(iter_info))

        if self.visu_config.render_env and hasattr(self.env, "render"):
            try:
                self.env.render()
            except Exception:
                pass

        if self._capture_video:
            frame = self._render_frame()
            if frame is not None:
                self._frames.append(frame)

    def _render_frame(self) -> Optional[np.ndarray]:
        """Grab one rgb frame, tolerating gym-0.17 (render(mode=...)),
        gymnasium (render_mode attr), and the built-in envs."""
        env = self.env
        if not hasattr(env, "render"):
            return None
        try:
            frame = env.render(mode="rgb_array")
        except TypeError:
            try:
                frame = env.render()
            except Exception:
                return None
        except Exception:
            return None
        if frame is None:
            return None
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[2] < 3:
            return None
        return frame[:, :, :3].astype(np.uint8)

    def _save_video(self) -> Optional[str]:
        if not self._frames:
            return None
        # imageio needs uniform frame shapes; crop to the smallest
        h = min(f.shape[0] for f in self._frames)
        w = min(f.shape[1] for f in self._frames)
        frames = [f[:h, :w] for f in self._frames]
        import imageio

        path_mp4 = os.path.join(self.folder_save, "render_env.mp4")
        try:
            imageio.mimsave(path_mp4, frames, fps=20)
            return path_mp4
        except Exception:
            path_gif = os.path.join(self.folder_save, "render_env.gif")
            imageio.mimsave(path_gif, frames, fps=20)
            return path_gif

    def get_costs(self) -> List[float]:
        return [-r for r in self.rewards]

    # ------------------------------------------------------------------
    def save(self, ctrl_obj=None) -> None:
        os.makedirs(self.folder_save, exist_ok=True)
        if self._capture_video:
            try:
                self._save_video()
            except Exception as exc:  # pragma: no cover
                print(f"env video save failed: {exc}")
        from .static_2d import save_plot_2d

        save_plot_2d(
            states=np.array(self.states),
            actions=np.array(self.actions),
            costs=np.array(self.get_costs()),
            iter_infos=self.iter_infos,
            folder_save=self.folder_save,
            use_constraints=bool(self.control_config.reward.use_constraints),
            state_min=np.asarray(self.control_config.reward.state_min, dtype=float),
            state_max=np.asarray(self.control_config.reward.state_max, dtype=float),
            num_repeat_actions=self.control_config.controller.num_repeat_actions,
        )
        if ctrl_obj is not None:
            try:
                from .static_3d import save_plot_model_3d

                save_plot_model_3d(ctrl_obj, folder_save=self.folder_save)
            except Exception as exc:  # pragma: no cover
                print(f"3d model plot failed: {exc}")

    def close(self) -> None:
        """Nothing to release without the live plot (kept for the JAX
        package's interface)."""

"""The online-learning episode runners: ``run_env`` / ``run_env_multiple``
(a port of ``gpmpc_tpu/runner/run_env.py``) and the on-device episodes over
a batch of seeds (``episode``, the port of ``runner/jit_episode.py``)."""

from .episode import (
    EpisodeSpec,
    build_episode_fn,
    build_episodes_batch_fn,
    episode_spec_from_config,
    run_episodes_batch,
)
from .run_env import run_env, run_env_multiple

__all__ = [
    "EpisodeSpec",
    "build_episode_fn",
    "episode_spec_from_config",
    "run_env",
    "run_env_multiple",
    "build_episodes_batch_fn",
    "run_episodes_batch",
]

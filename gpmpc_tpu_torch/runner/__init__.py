"""The online-learning episode runner (a port of ``gpmpc_tpu/runner/run_env.py``)."""

from .run_env import run_env, run_env_multiple

__all__ = ["run_env", "run_env_multiple"]

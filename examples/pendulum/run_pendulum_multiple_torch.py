"""20 pendulum runs on the PyTorch/CUDA port (run_pendulum_multiple.py's
twin); writes multiple_runs_costs_Pendulum-v0.png.

    python examples/pendulum/run_pendulum_multiple_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "../.."))

from gpmpc_tpu_torch import run_env_multiple
from gpmpc_tpu_torch.envs import PendulumEnv
from gpmpc_tpu_torch.example_configs import pendulum_config

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    num_runs = 20
    env = PendulumEnv(seed=0)
    control_config = pendulum_config(len_horizon=12, num_repeat_actions=1)
    visu_config = None
    run_env_multiple(
        env, "Pendulum-v0", control_config, visu_config, num_runs, random_actions_init=10, num_steps=300,
        verbose=False, device=args.device,
    )

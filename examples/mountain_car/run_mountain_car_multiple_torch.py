"""10 mountain-car runs on the PyTorch/CUDA port
(run_mountain_car_multiple.py's twin); writes
multiple_runs_costs_MountainCarContinuous-v0.png.

    python examples/mountain_car/run_mountain_car_multiple_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "../.."))

from gpmpc_tpu_torch import run_env_multiple
from gpmpc_tpu_torch.envs import MountainCarContinuousEnv
from gpmpc_tpu_torch.example_configs import mountain_car_config

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    env = MountainCarContinuousEnv(seed=0)
    control_config = mountain_car_config(len_horizon=12, num_repeat_actions=5)
    run_env_multiple(
        env, "MountainCarContinuous-v0", control_config, None, num_runs=10,
        random_actions_init=20, num_steps=500, verbose=False, device=args.device,
    )

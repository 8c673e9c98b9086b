"""The mountain-car example on the PyTorch/CUDA port (run_mountaincar.py's twin).

    python examples/mountain_car/run_mountaincar_torch.py            # on the card
    python examples/mountain_car/run_mountaincar_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "../.."))

from gpmpc_tpu_torch import VisuConfig, run_env
from gpmpc_tpu_torch.envs import MountainCarContinuousEnv
from gpmpc_tpu_torch.example_configs import mountain_car_config


def run_mountain_car(num_steps=500, random_actions_init=20, num_repeat_actions=5, len_horizon=12, verbose=True,
                     device="cuda"):
    env = MountainCarContinuousEnv(seed=0)
    control_config = mountain_car_config(len_horizon=len_horizon, num_repeat_actions=num_repeat_actions)
    visu_config = VisuConfig(render_live_plot_2d=False, render_env=False)
    return run_env(
        env, control_config, visu_config, random_actions_init=random_actions_init, num_steps=num_steps,
        verbose=verbose, device=device,
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    costs = run_mountain_car(device=args.device)

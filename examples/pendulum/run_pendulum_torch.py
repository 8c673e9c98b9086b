"""The pendulum example on the PyTorch/CUDA port (run_pendulum.py's twin).

    python examples/pendulum/run_pendulum_torch.py            # on the card
    python examples/pendulum/run_pendulum_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "../.."))

from gpmpc_tpu_torch import VisuConfig, run_env
from gpmpc_tpu_torch.envs import PendulumEnv
from gpmpc_tpu_torch.example_configs import pendulum_config


def run_pendulum(num_steps=150, random_actions_init=10, num_repeat_actions=1, len_horizon=15, verbose=True,
                 device="cuda"):
    env = PendulumEnv(seed=0)
    control_config = pendulum_config(len_horizon=len_horizon, num_repeat_actions=num_repeat_actions)
    visu_config = VisuConfig(render_live_plot_2d=False, render_env=False)
    return run_env(
        env, control_config, visu_config, random_actions_init=random_actions_init, num_steps=num_steps,
        verbose=verbose, device=device,
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    costs = run_pendulum(device=args.device)
    print(f"final mean cost over last 50 steps: {sum(costs[-50:]) / 50:.4f}")

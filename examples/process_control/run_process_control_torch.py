"""The process-control example on the PyTorch/CUDA port
(run_process_control.py's twin).

    python examples/process_control/run_process_control_torch.py            # on the card
    python examples/process_control/run_process_control_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "../.."))

from gpmpc_tpu_torch import VisuConfig, run_env
from gpmpc_tpu_torch.envs import ProcessControl
from gpmpc_tpu_torch.example_configs import process_control_config


def run_process_control(device="cuda"):
    env = ProcessControl(
        dt=1,
        s_range=(20, 30),
        fi_range=(0.15, 0.3),
        ci_range=(0.15, 0.2),
        cr_range=(0.8, 1.0),
        noise_l_prop_range=(5e-3, 1e-2),
        noise_co_prop_range=(5e-3, 1e-2),
        sp_l_range=(0.4, 0.6),
        sp_co_range=(0.4, 0.6),
        change_params=False,
        period_change=200,
        seed=0,
    )
    control_config = process_control_config(len_horizon=5, include_time_model=False, num_repeat_actions=5)
    visu_config = VisuConfig(render_live_plot_2d=False, render_env=False)
    return run_env(env, control_config, visu_config, random_actions_init=100, num_steps=500, verbose=True,
                   device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    costs = run_process_control(device=args.device)

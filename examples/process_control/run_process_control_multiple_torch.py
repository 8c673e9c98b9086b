"""Ten time-varying process-control runs on the PyTorch/CUDA port
(run_process_control_multiple.py's twin): the time model on and the
plant's parameters redrawn every 500 steps; writes
multiple_runs_costs_process_control.png.

    python examples/process_control/run_process_control_multiple_torch.py                  # on the card, f64
    python examples/process_control/run_process_control_multiple_torch.py --dtype float32  # mixed mode
    python examples/process_control/run_process_control_multiple_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "../.."))

from gpmpc_tpu_torch import run_env_multiple
from gpmpc_tpu_torch.envs import ProcessControl
from gpmpc_tpu_torch.example_configs import process_control_config

ENV_NAME = "process_control"


def make_env(period_change=500):
    """The example's plant: its parameters redrawn every ``period_change`` steps."""
    return ProcessControl(
        dt=1,
        s_range=(20, 30),
        fi_range=(0.2, 0.3),
        ci_range=(0.1, 0.2),
        cr_range=(0.9, 1.0),
        noise_l_prop_range=(3e-3, 1e-2),
        noise_co_prop_range=(3e-3, 1e-2),
        sp_l_range=(0.4, 0.6),
        sp_co_range=(0.4, 0.6),
        change_params=True,
        period_change=period_change,
        seed=0,
    )


def make_config(dtype="float64"):
    return process_control_config(len_horizon=5, include_time_model=True, num_repeat_actions=10, dtype=dtype)


def run_process_control_multiple(device="cuda", dtype="float64", num_runs=10, num_steps=1000):
    return run_env_multiple(
        make_env(), ENV_NAME, make_config(dtype), None, num_runs=num_runs,
        random_actions_init=10, num_steps=num_steps, verbose=False, device=device,
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="float64", choices=["float64", "float32"],
                        help="float64, the JAX example's precision, or float32: mixed mode")
    args = parser.parse_args()
    run_process_control_multiple(device=args.device, dtype=args.dtype)

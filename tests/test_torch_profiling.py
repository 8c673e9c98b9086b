"""The port's planning-step timers (utils/profiling.py) on the CPU: the
phases JAX's ``phase_breakdown`` names, each a positive time (in f64: a
mixed-mode breakdown runs its df32 rollouts ~100 times, ~30 s on the
CPU)."""

import ast
from pathlib import Path

import torch

from gpmpc_tpu_torch.flagship import flagship_problem
from gpmpc_tpu_torch.utils.profiling import phase_breakdown, time_fn

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _jax_phase_keys():
    """The keys of the dict JAX's phase_breakdown returns, read from its
    source (running it compiles four XLA programs)."""
    tree = ast.parse((ROOT / "gpmpc_tpu/utils/profiling.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "phase_breakdown")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return [k.value for k in ret.value.keys]


def test_phase_breakdown_keys_and_times():
    prob = flagship_problem(CPU, torch.float64, n_points=12, bucket=16, nh=2)

    def make_args():
        x, y = (torch.tensor(a, dtype=prob.master_dtype) for a in (prob.x, prob.y))
        return (prob.spec, prob.bounds, prob.params, x, y, torch.tensor(prob.mask), prob.state_mu, prob.state_var,
                prob.inits, prob.action_prev)

    out = phase_breakdown(make_args)
    assert list(out) == _jax_phase_keys() == ["factorize_s", "objective_eval_s", "objective_value_and_grad_s",
                                              "full_plan_s"]
    assert all(t > 0 for t in out.values()), out


def test_time_fn_is_a_mean_per_call():
    calls = []
    t = time_fn(lambda x: calls.append(x) or (x, {"y": [x]}), torch.ones(3), iters=5, warmup=2)
    assert len(calls) == 7 and t > 0

"""Where a planning step's time goes on the card.

    python -m gpmpc_tpu_torch.profile_plan [--steps 3] [--mixed [--points 300 --bucket 384]]
                                          [--df-cov-route] [--out FILE.json]
    python -m gpmpc_tpu_torch.profile_plan --count-ops [--points 40 --bucket 64] [--fused | --df-cov-route]

For the flagship (300 points in the 384 bucket) and the 24-point case of
chip_smoke.py's accuracy check, both f32, or with ``--mixed`` for the
trained-GP problem in mixed mode (an f64 master, a df32 rollout; 300 points
in the 384 bucket unless ``--points``/``--bucket`` say otherwise; at buckets
32..128 the card runs the whole-step path, ``ops.df_mm``, and
``--df-cov-route`` sends those steps through the df cov core route instead,
by patching ``ops.use_df_fused``, for a comparison): refresh
the cache, take warm-up steps, then profile ``--steps`` steady-state
planning steps with ``torch.profiler`` (CPU and CUDA activity), each ended
by ``torch.cuda.synchronize()``. Reports per step: wall ms, device-busy ms
(the union of kernel intervals), the idle share, kernel count, kernel
launches of the port's own kernels and their device ms per launch, peak
device memory, and the kernels with the most device time. The profiler
slows the host, so its wall times exceed chip_smoke.py's. Exits non-zero
without a CUDA device.

``--count-ops`` needs no card: it counts the PyTorch operator calls that
launch work (views excluded) of one mixed-mode steady-state planning step of
the trained-GP problem on the CPU, at ``--points`` in ``--bucket``, split
into those outside the port's kernel wrappers (each one kernel on the card)
and the calls of the wrappers (the df32 cov core, or with ``--fused`` the
whole-step path's, which the CPU reaches only so patched), each one or two
kernel launches on the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from unittest import mock

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from . import ops
from .flagship import flagship_problem, plan_step, start_steps, trained_gp_problem
from .ops import df_mm

CASES = (("flagship_300_in_384", 300, 384), ("accuracy_24_in_32", 24, 32))
MIXED_CASE = ("trained_gp_mixed_300_in_384", 300, 384)


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _problem(name, n_points, bucket, dev, steps):
    if name.startswith("trained_gp"):
        return trained_gp_problem(dev, n_points=n_points, iters=steps, bucket=bucket)
    return flagship_problem(dev, torch.float32, n_points=n_points, bucket=bucket)


def _route(fused: bool):
    """Patch the whole-step dispatch on (within its range) or off."""
    return mock.patch.object(ops, "use_df_fused", lambda n, ns, d, device: fused and df_mm.supported(n, ns, d))


def profile_case(name, n_points, bucket, steps, dev, warmup=2):
    prob = _problem(name, n_points, bucket, dev, warmup + steps)
    planner = start_steps(prob, dev, torch.float32, warmup + steps)

    def step(i):
        plan_step(planner, prob, i)
        torch.cuda.synchronize()

    for i in range(warmup):
        step(i)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            step(i)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # the raw trace events: prof.events() would build a tree of Python
    # objects over every event (millions in a mixed step), slow to make and to
    # tear down
    kernels = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    del prof
    by_name = collections.defaultdict(float)
    count = collections.Counter()
    for kname, start, end in kernels:
        by_name[kname] += end - start
        count[kname] += 1
    port = {}
    for short in ("gram_kernel", "cov_fwd_kernel", "cov_bwd_kernel", "df_fwd_kernel",
                  "df_fwdres_kernel", "df_fwd_sum_kernel", "df_mm_fwd_kernel", "df_mm_fwd_sum_kernel",
                  "df_mm_bwd_kernel", "df_mm_bwd_sum_kernel"):
        names = [k for k in by_name if short in k]
        n = sum(count[k] for k in names)
        port[short] = (sum(by_name[k] for k in names) / 1e3 / n) if n else None
    busy_ms = _busy_us([(start, end) for _, start, end in kernels]) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        case=name, steps=steps, wall_ms=wall_ms,
        device_busy_ms=busy_ms if kernels else None,
        idle_share=(1.0 - busy_ms / wall_ms) if kernels else None,
        kernels_per_step=len(kernels) / steps,
        port_kernel_launches_per_step={k: v / steps for k, v in ops.launch_counts().items()},
        peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
        top_kernels_ms_per_step=[(k[:90], v / 1e3 / steps) for k, v in top],
        port_kernel_device_ms_per_launch=port,
    )


class _OpCounter(TorchDispatchMode):
    """Counts operator calls that launch work (not views), apart inside the
    df cov core."""

    def __init__(self):
        super().__init__()
        self.outside = 0
        self.inside = 0
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not (func.is_view or func.__name__.split(".")[0] in ("detach", "lift_fresh")):
            if self.depth:
                self.inside += 1
            else:
                self.outside += 1
        return func(*args, **(kwargs or {}))


def count_ops(n_points, bucket, fused=False) -> dict:
    """Operator calls of one mixed-mode steady-state planning step on the
    CPU; ``fused`` patches the whole-step dispatch on, as the card takes it."""
    cpu = torch.device("cpu")
    prob = trained_gp_problem(cpu, n_points=n_points, iters=2, bucket=bucket)
    counter = _OpCounter()
    calls = collections.Counter()

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            counter.depth += 1
            try:
                return fn(*args)
            finally:
                counter.depth -= 1
        return call

    def df_cov_core(*args):
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in args[:14])
        return counted("df_cov_core " + ("value_and_grad" if grad else "forward"), dispatch)(*args)

    dispatch = ops.df_cov_core
    with _route(fused):
        planner = start_steps(prob, cpu, torch.float32, 2)
        plan_step(planner, prob, 0)
        with mock.patch.object(ops, "df_cov_core", df_cov_core), \
                mock.patch.object(df_mm, "full_step_fwd", counted("df_mm_full", df_mm.full_step_fwd)), \
                mock.patch.object(df_mm, "stage23_fwd", counted("df_mm_fwd", df_mm.stage23_fwd)), \
                mock.patch.object(df_mm, "stage23_bwd_all", counted("df_mm_bwd", df_mm.stage23_bwd_all)), \
                mock.patch.object(df_mm, "stage23_bwd_mean", counted("df_mm_bwd_mean", df_mm.stage23_bwd_mean)), \
                mock.patch.object(df_mm, "stage23_bwd_pairs", counted("df_mm_bwd_pair", df_mm.stage23_bwd_pairs)), \
                counter:
            plan_step(planner, prob, 1)
    return dict(points=n_points, bucket=bucket, route="fused" if fused else "df_cov",
                ops_outside_kernel_wrappers=counter.outside, ops_inside_plain_twins=counter.inside,
                wrapper_calls=dict(calls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mixed", action="store_true", help="profile the trained-GP flagship in mixed mode instead")
    ap.add_argument("--count-ops", action="store_true", help="count the operators of one mixed step on the CPU")
    ap.add_argument("--points", type=int, default=None, help="stored points (40 for --count-ops, else 300)")
    ap.add_argument("--bucket", type=int, default=None, help="bucket (64 for --count-ops, else 384)")
    ap.add_argument("--fused", action="store_true", help="--count-ops: count the whole-step route")
    ap.add_argument("--df-cov-route", action="store_true",
                    help="--mixed: send the whole-step range through the df cov core route instead")
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if args.count_ops:
        print(json.dumps(count_ops(args.points or 40, args.bucket or 64, fused=args.fused)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("profile_plan: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    if args.mixed:
        n, b = args.points or MIXED_CASE[1], args.bucket or MIXED_CASE[2]
        with _route(not args.df_cov_route):
            results = [profile_case(f"trained_gp_mixed_{n}_in_{b}" + ("_df_cov_route" if args.df_cov_route else ""),
                                    n, b, args.steps, dev, warmup=1)]
    else:
        results = [profile_case(name, n, b, args.steps, dev) for name, n, b in CASES]
    for r in results:
        busy = "not measured" if r["device_busy_ms"] is None else f"{r['device_busy_ms']:.3f} ms"
        idle = "not measured" if r["idle_share"] is None else f"{r['idle_share']:.4f}"
        print(f"{r['case']}: wall {r['wall_ms']:.2f} ms/step, device busy {busy}, idle share {idle}, "
              f"{r['kernels_per_step']:.0f} kernels/step, port launches {r['port_kernel_launches_per_step']}, "
              f"peak {r['peak_mem_mb']:.1f} MiB", flush=True)
        print(f"    device ms per launch of the port's kernels: {r['port_kernel_device_ms_per_launch']}",
              flush=True)
        for k, v in r["top_kernels_ms_per_step"]:
            print(f"    {v:9.4f} ms  {k}", flush=True)
    doc = {"card": card, "torch": torch.__version__, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps({"card": card, "cases": [{k: r[k] for k in ("case", "wall_ms", "device_busy_ms",
                                                                    "idle_share", "kernels_per_step")}
                                              for r in results]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

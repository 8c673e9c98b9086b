"""Where a planning step's time goes on the card.

    python -m gpmpc_tpu_torch.profile_plan [--steps 3] [--out FILE.json]

For the flagship (300 points in the 384 bucket) and the 24-point case of
chip_smoke.py's accuracy check, both f32: refresh the cache, take two
warm-up steps, then profile ``--steps`` steady-state planning steps with
``torch.profiler`` (CPU and CUDA activity), each ended by
``torch.cuda.synchronize()``. Reports per step: wall ms, device-busy ms
(the union of kernel intervals), the idle share, kernel count, kernel
launches of the port's own kernels and their device ms per launch, peak
device memory, and the kernels with the most device time. The profiler
slows the host, so its wall times exceed chip_smoke.py's. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import ops
from .flagship import flagship_problem, plan_step, start_steps

CASES = (("flagship_300_in_384", 300, 384), ("accuracy_24_in_32", 24, 32))


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


def profile_case(name, n_points, bucket, steps, dev):
    prob = flagship_problem(dev, torch.float32, n_points=n_points, bucket=bucket)
    planner = start_steps(prob, dev, torch.float32, 2 + steps)

    def step(i):
        plan_step(planner, prob, i)
        torch.cuda.synchronize()

    for i in range(2):
        step(i)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + steps):
            step(i)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(float)
    count = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    port = {}
    for short in ("gram_kernel", "cov_fwd_kernel", "cov_bwd_row_kernel"):
        names = [k for k in by_name if short in k]
        n = sum(count[k] for k in names)
        port[short] = (sum(by_name[k] for k in names) / 1e3 / n) if n else None
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / steps
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_plan: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30, check=True).stdout.strip()
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

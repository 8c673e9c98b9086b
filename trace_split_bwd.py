#!/usr/bin/env python3
"""Per-launch device times of the whole-step VJP on the card: the split
route past N = 128 (#10 ``df_mm_bwd_mean``, #11 ``df_mm_bwd_pair`` and the
df combination of their outputs) beside the single launch (#9
``df_mm_bwd``).

    python3 trace_split_bwd.py [--sizes 192 384 512] [--calls 10] [--out FILE.json]

For each N, on the trained-GP problem's operands of chip_smoke.py phase 3
(the 15th rollout step of 0.8 N points, at most 300, in the N bucket, in
mixed mode) at unit cotangents: each wrapper's device time per call
(``chip_smoke.cuda_ms``: the calls queued behind a sleep kernel), then
``--calls`` calls of each under ``torch.profiler``, and per kernel of the
wrapper its device microseconds per launch, and per call the gap from the
end of one of its kernels to the start of the next. Prints the card's name
and power limit and one JSON line; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gpmpc_tpu_torch.ops import df_mm


def _short(name: str) -> str:
    """A kernel's function name without its namespace, template and arguments."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", name)
    return m.group(1) if m else name[:60]


def trace(fn, calls: int) -> dict:
    """Per kernel of ``fn`` (in launch order): device us per launch and
    launches per call; the gaps between consecutive kernels of one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, _short(e.name()))
                     for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA)
    del prof
    per = len(kernels) // calls
    by_name = collections.OrderedDict()
    gaps = collections.defaultdict(list)
    for c in range(calls):
        call = kernels[c * per:(c + 1) * per]
        for k, (start, end, name) in enumerate(call):
            by_name.setdefault(name, []).append(end - start)
            if k:
                gaps[f"{call[k - 1][2]} -> {name}"].append(start - call[k - 1][1])
    other = sum(end - start for start, end, name in kernels if "df_mm" not in name) / calls
    return dict(kernels_per_call=per, other_us_per_call=other,
                us_per_launch={k: statistics.median(v) for k, v in by_name.items()},
                launches_per_call={k: len(v) / calls for k, v in by_name.items()},
                gap_us={k: statistics.median(v) for k, v in gaps.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[192, 384, 512])
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_split_bwd: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card, flush=True)
    results = []
    for n in args.sizes:
        cache, mu, sv = chip_smoke.trained_gp_step_inputs(dev, n)
        ns, d = cache.ils_hi.shape
        ii, jj, _, _ = df_mm.pair_indices(ns, dev)
        Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
        p = Qh.shape[0]
        g = (torch.ones(ns, device=dev), torch.ones(ns, d, device=dev), torch.ones(p, device=dev),
             -torch.ones(ns, device=dev))
        calls = {"df_mm_bwd_mean": lambda: df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1]),
                 "df_mm_bwd_pair": lambda: df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3]),
                 "split route": lambda: df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, cache, *g),
                 "df_mm_bwd": lambda: df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)}
        rand = chip_smoke.random_df_mm_problem(dev, n, seed=n)
        bitwise = {}
        for label, (c_, m_, s_) in (("trained-GP", (cache, mu, sv)), ("random", rand)):
            b_h, b_l, _, q_h, q_l, _ = df_mm.df_stage1(c_, s_, ii, jj)
            gg = chip_smoke.split_cotangents(m_, p)
            split = df_mm.stage23_bwd(m_, b_h, b_l, q_h, q_l, c_, *gg)
            whole = df_mm.stage23_bwd_all(m_, b_h, b_l, q_h, q_l, c_, *gg)
            bitwise[label] = {nm: bool(torch.equal(o, r)) for nm, o, r in zip(("g_mu", "g_B", "g_Q"), split, whole)}
        print(f"N={n} split route against df_mm_bwd, bit for bit: {bitwise}", flush=True)
        results.append(dict(n=n, what="bitwise", **bitwise))
        for what, fn in calls.items():
            ms, _ = chip_smoke.cuda_ms(fn, reps=4 if what == "split route" else 16)
            row = dict(n=n, what=what, wrapper_ms=ms, **trace(fn, args.calls))
            results.append(row)
            print(f"N={n} {what}: {ms:.4f} ms per call (device); kernels "
                  + ", ".join(f"{k} {v:.2f} us x{row['launches_per_call'][k]:g}"
                              for k, v in row["us_per_launch"].items() if "df_mm" in k)
                  + f"; {row['kernels_per_call']} kernels per call, the others {row['other_us_per_call']:.2f} us; gaps "
                  + ", ".join(f"{k} {v:.2f} us" for k, v in row["gap_us"].items() if "df_mm" in k), flush=True)
    line = json.dumps({"card": card, "trace": results})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

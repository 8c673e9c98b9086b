"""Device times of the f32 Gram (#1 ``gram``) and the cov core's iK
gradient (#4 ``cov_gik``) on the card, beside the launch floor.

    python -m gpmpc_tpu_torch.trace_kernels [--calls 20] [--blocks-per-sm 1 2 4]
        [--save FILE.pt | --compare FILE.pt] [--out FILE.json]

Run from the repository root (it imports ``chip_smoke`` and
``trace_split_bwd`` from there). At the flagship shapes (the Gram on the
pendulum flagship's 300 points in the 384 bucket, 3 x 384 x 384; the iK
gradient on random operands of the flagship's cov core, P = 6, N = 384,
ns = 3, diag_pos (0, 3, 5)) it prints each wrapper's device ms per call
(``chip_smoke.cuda_ms``: the calls queued behind a sleep kernel) and, under
``torch.profiler``, each launch's device microseconds; the same for
``cov_bwd`` alone and ``cov_bwd`` then ``cov_gik`` (``CovCore.backward``
with an iK gradient). The launch floor is the device time per call of a
launch that does nothing, timed the same way: ``torch.cuda._sleep(1)``,
and where the package has it (``_build.empty_launch``) an empty kernel of
one block and of one wave of 256-thread blocks, launched plainly and as a
programmatic dependent, also each after a ``fill_`` of a tensor of the
Gram's size (a plain PyTorch kernel, as precedes the Gram on the refresh
path), beside the ``fill_`` alone and then the Gram.

``--blocks-per-sm 1 2 4`` also times both kernels under the plans for
that many blocks per SM (the wrapper's plan is for one), where the package
plans its grids in Python (``gram_rbf.launch_plan``,
``moment_cov.gik_launch_plan``).

``--save`` writes both kernels' outputs on fixed operands (also at a ragged
N = 301 and, for the iK gradient, rectangular 200 x 301 slabs) to a file;
``--compare`` reads such a file, written by another tree, and prints
whether this tree's outputs equal it bit for bit. Prints the card's name and
power limit and one JSON line; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from unittest import mock

import numpy as np
import torch

import chip_smoke
import trace_split_bwd
from gpmpc_tpu_torch.flagship import flagship_problem
from gpmpc_tpu_torch.models.gp import constrained_params
from gpmpc_tpu_torch.ops import _build, gram_rbf, moment_cov

DIAG = (0, 3, 5)


def gram_operands(dev, n=None, seed=0):
    """The flagship's Gram operands (n None) or random ones of its widths at n points."""
    if n is None:
        prob = flagship_problem(dev, torch.float32)
        ls, outs, _ = constrained_params(prob.params, prob.bounds)
        return ls.contiguous(), outs.contiguous(), torch.as_tensor(prob.x, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.uniform(0.3, 2.0, (3, 4)), rng.uniform(0.02, 0.4, 3), rng.uniform(0, 1, (n, 4))))


def gik_operands(dev, nr, nc, seed=0, p=6, ns=3):
    """Random iK-gradient operands (a, c, U, Xj) with Nr rows and Nc columns,
    drawn as chip_smoke.random_cov_operands draws them, and g_corr."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(-2, 0.5, (p, nr)), rng.normal(-2, 0.5, (p, nc)), rng.normal(0, 0.3, (p, nr, ns)),
              rng.normal(0, 0.3, (p, nc, ns)))
    g = torch.linspace(1.0, -2.0, len(DIAG), device=dev)
    return (g, *(torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays))


def outputs(dev) -> dict:
    """Both kernels' outputs on fixed operands, for a bitwise comparison across trees."""
    return {"gram 384 flagship": gram_rbf.gram(*gram_operands(dev)),
            "gram 301": gram_rbf.gram(*gram_operands(dev, 301, seed=301)),
            "cov_gik 384": moment_cov.cov_gik(*gik_operands(dev, 384, 384), DIAG),
            "cov_gik 200x301": moment_cov.cov_gik(*gik_operands(dev, 200, 301, seed=1), DIAG)}


def floor_calls(fill) -> dict:
    """The launches that do nothing, by name; with the package's empty
    kernel also after ``fill.fill_`` (a plain PyTorch kernel, as before the
    Gram on the refresh path), and that fill alone."""
    calls = {"torch.cuda._sleep(1)": lambda: torch.cuda._sleep(1)}
    if hasattr(_build, "empty_launch"):
        wave = _build.sm_count(torch.device("cuda"))
        for dependent in (False, True):
            kind = "programmatic dependent" if dependent else "plain"
            calls[f"empty 1x32 {kind}"] = lambda d=dependent: _build.empty_launch(1, 32, d)
            calls[f"empty {wave}x256 {kind}"] = lambda d=dependent, w=wave: _build.empty_launch(w, 256, d)
        calls["fill_ alone"] = lambda: fill.fill_(1.0)
        for dependent in (False, True):
            kind = "programmatic dependent" if dependent else "plain"
            calls[f"fill_ then empty {wave}x256 {kind}"] = lambda d=dependent, w=wave: (
                fill.fill_(1.0), _build.empty_launch(w, 256, d))
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--blocks-per-sm", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card, flush=True)
    results = []
    if args.save or args.compare:
        outs = outputs(dev)
        torch.cuda.synchronize()
        if args.save:
            torch.save({k: v.cpu() for k, v in outs.items()}, args.save)
            print(f"saved {sorted(outs)} to {args.save}", flush=True)
        if args.compare:
            ref = torch.load(args.compare)
            same = {k: bool(torch.equal(outs[k].cpu(), ref[k])) for k in outs}
            print(f"outputs against {args.compare}, bit for bit: {same}", flush=True)
            results.append(dict(what="bitwise", **same))

    ls, outs_, x = gram_operands(dev)
    gik = gik_operands(dev, 384, 384)
    g_corr, a, c, u, xj = gik
    rng = np.random.default_rng(7)
    bi, bj = (torch.tensor(rng.normal(0, 1, (6, 384)), dtype=torch.float32, device=dev) for _ in range(2))
    ikh = rng.normal(0, 0.1, (3, 384, 384))
    ik = torch.tensor((ikh + ikh.transpose(0, 2, 1)) / 2, dtype=torch.float32, device=dev)
    g = torch.linspace(1.0, 2.0, 6, device=dev)
    fill = torch.empty(3, 384, 384, device=dev)
    calls = dict(floor_calls(fill))
    calls.update({
        "gram 3x384x384": lambda: gram_rbf.gram(ls, outs_, x),
        "fill_ then gram 3x384x384": lambda: (fill.fill_(1.0), gram_rbf.gram(ls, outs_, x)),
        "cov_gik 3x384x384": lambda: moment_cov.cov_gik(*gik, DIAG),
        "cov_bwd": lambda: moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG),
        "cov_bwd then cov_gik": lambda: (moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG),
                                         moment_cov.cov_gik(*gik, DIAG)),
    })
    for what, fn in calls.items():
        ms, host = chip_smoke.cuda_ms(fn)
        row = dict(what=what, device_ms=ms, host_ms=host, **trace_split_bwd.trace(fn, args.calls))
        results.append(row)
        print(f"{what}: {ms:.5f} ms per call (device), host {host:.4f} ms; kernels "
              + ", ".join(f"{k} {v:.2f} us x{row['launches_per_call'][k]:g}" for k, v in row["us_per_launch"].items())
              + "; gaps " + (", ".join(f"{k} {v:.2f} us" for k, v in row["gap_us"].items()) or "none"), flush=True)
    for k in args.blocks_per_sm:
        for what, mod, name, fn in (("gram", gram_rbf, "launch_plan", calls["gram 3x384x384"]),
                                    ("cov_gik", moment_cov, "gik_launch_plan", calls["cov_gik 3x384x384"])):
            plan = getattr(mod, name)
            with mock.patch.object(mod, name, lambda *a, plan=plan: plan(*a[:-1], a[-1] * k)):
                ms, _ = chip_smoke.cuda_ms(fn)
                shape = getattr(mod, name)(*((3, 384) if what == "gram" else (3, 384, 384)), _build.sm_count(dev))
            results.append(dict(what=f"{what} at {k} blocks per SM", device_ms=ms, plan=shape))
            print(f"{what} 3x384x384 planned for {k} blocks per SM ({shape}): {ms:.5f} ms per call (device)",
                  flush=True)
    line = json.dumps({"card": card, "trace": results})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

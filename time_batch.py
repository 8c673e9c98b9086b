"""Device time of the whole-step kernels, #12 (``df_mm_full``), #8
(``df_mm_fwd``) and #9 (``df_mm_bwd``), per call at N = 128 on the
trained-GP problem's operands (chip_smoke.py's ``trained_gp_step_inputs``,
timed by its ``cuda_ms``), for a batch of B = 1 and, where the tree's
wrappers take a batch axis, 2, 4 and 8 elements against one shared cache.

Run it on the card from the repo root: ``python3 time_batch.py``. It uses
only what every tree since the kernels' redesign has (the single-element
wrappers and those two functions of chip_smoke.py), so copied into another
tree's root (e.g. the parent commit unpacked by ``git archive``) it times
that tree's kernels the same way; compare two trees only within one call.
Prints one JSON line: {"tree": the working directory, "card": nvidia-smi's
name and power limit, "ms": {"B=1": {kernel: device ms}, ...}}.
"""

import json
import os

import torch

import chip_smoke as cs
from gpmpc_tpu_torch.ops import _build, df_mm


def main() -> None:
    dev = torch.device("cuda")
    _build.load()
    cache, mu1, sv1 = cs.trained_gp_step_inputs(dev, 128)
    ns, d = cache.ils_hi.shape
    p = ns * (ns + 1) // 2
    ii, jj, _, _ = df_mm.pair_indices(ns, dev)
    out = {}
    for b in (1, 2, 4, 8):
        off = torch.linspace(0.0, 2e-3, b, device=dev)
        mu = mu1 if b == 1 else (mu1 + off[:, None]).contiguous()
        sv = sv1 if b == 1 else (sv1 * (1 + off[:, None, None])).contiguous()
        lead = () if b == 1 else (b,)
        g = [torch.ones(lead + s, device=dev) for s in ((ns,), (ns, d), (p,), (ns,))]
        try:
            Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
            calls = {"df_mm_full": lambda: df_mm.full_step_fwd(mu, sv, cache),
                     "df_mm_fwd": lambda: df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache),
                     "df_mm_bwd": lambda: df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)}
            out[f"B={b}"] = {name: cs.cuda_ms(fn)[0] for name, fn in calls.items()}
        except (ValueError, RuntimeError, IndexError):  # a tree whose wrappers take one element
            break
    print(json.dumps({"tree": os.getcwd(), "card": cs.card_line(), "ms": out}), flush=True)


if __name__ == "__main__":
    main()

"""Device time of the kernels that take a batch axis, per call, for a batch
of B = 1 and, where the tree's wrappers take a batch axis, 2, 4 and 8
elements: #12 (``df_mm_full``), #8 (``df_mm_fwd``) and #9 (``df_mm_bwd``)
at N = 128 and the split backward #10 (``df_mm_bwd_mean``) and #11
(``df_mm_bwd_pair``) at N = 384 on the trained-GP problem's operands
against one shared cache (chip_smoke.py's ``trained_gp_step_inputs``), and
the Gram #1 (``gram``) at the flagship's 3 x 384 x 384 with one memory's
parameters for every element, each timed by chip_smoke.py's ``cuda_ms``.

Run it on the card from the repo root: ``python3 time_batch.py``. It uses
only what every tree since the kernels' redesign has (the single-element
wrappers and those functions of chip_smoke.py), so copied into another
tree's root (e.g. the parent commit unpacked by ``git archive``) it times
that tree's kernels the same way, leaving out a batch its wrappers refuse;
compare two trees only within one call. Prints one JSON line: {"tree": the
working directory, "card": nvidia-smi's name and power limit, "ms": {"B=1":
{kernel: device ms}, ...}}.
"""

import json
import os

import torch

import chip_smoke as cs
from gpmpc_tpu_torch.flagship import flagship_problem
from gpmpc_tpu_torch.models.gp import constrained_params
from gpmpc_tpu_torch.ops import _build, df_mm
from gpmpc_tpu_torch.ops import gram_rbf

# a tree whose wrapper takes one element raises one of these on a batch
REFUSED = (ValueError, RuntimeError, IndexError, NotImplementedError)


def calls_at(b, dev, steps, gram_args):
    """Each kernel's wrapper call on a batch of b elements (b = 1: the
    single-element call)."""
    calls = {}
    for n, names in ((128, ("df_mm_full", "df_mm_fwd", "df_mm_bwd")), (384, ("df_mm_bwd_mean", "df_mm_bwd_pair"))):
        every = wrappers_at(b, dev, *steps[n])
        calls.update({f"{k} N={n}": every[k] for k in names})
    ls, outs, x = gram_args if b == 1 else (t.expand((b,) + t.shape).contiguous() for t in gram_args)
    calls["gram 3x384x384"] = lambda: gram_rbf.gram(ls, outs, x)
    return calls


def wrappers_at(b, dev, cache, mu1, sv1):
    """The whole-step wrappers' calls on b elements of one step's operands."""
    ns, d = cache.ils_hi.shape
    p = ns * (ns + 1) // 2
    off = torch.linspace(0.0, 2e-3, b, device=dev)
    mu = mu1 if b == 1 else (mu1 + off[:, None]).contiguous()
    sv = sv1 if b == 1 else (sv1 * (1 + off[:, None, None])).contiguous()
    lead = () if b == 1 else (b,)
    g = [torch.ones(lead + s, device=dev) for s in ((ns,), (ns, d), (p,), (ns,))]
    ii, jj, _, _ = df_mm.pair_indices(ns, dev)
    Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
    return {"df_mm_full": lambda: df_mm.full_step_fwd(mu, sv, cache),
            "df_mm_fwd": lambda: df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache),
            "df_mm_bwd": lambda: df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g),
            "df_mm_bwd_mean": lambda: df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1]),
            "df_mm_bwd_pair": lambda: df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3])}


def main() -> None:
    dev = torch.device("cuda")
    _build.load()
    steps = {n: cs.trained_gp_step_inputs(dev, n) for n in (128, 384)}
    prob = flagship_problem(dev, torch.float32)
    ls, outs, _ = constrained_params(prob.params, prob.bounds)
    gram_args = (ls.contiguous(), outs.contiguous(), torch.as_tensor(prob.x, dtype=torch.float32, device=dev))
    out = {}
    for b in (1, 2, 4, 8):
        row = {}
        for name, fn in calls_at(b, dev, steps, gram_args).items():
            try:
                row[name] = cs.cuda_ms(fn)[0]
            except REFUSED:  # a tree whose wrapper takes one element
                continue
        out[f"B={b}"] = row
    print(json.dumps({"tree": os.getcwd(), "card": cs.card_line(), "ms": out}), flush=True)


if __name__ == "__main__":
    main()

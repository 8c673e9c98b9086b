"""Device times of the cov-core, df cov-core and Gram kernels at the
reference's larger buckets, beside their bounds and plain versions.

    python -m gpmpc_tpu_torch.time_large_n

Run from the repository root (it imports ``chip_smoke`` from there). The
port's memory buckets reach 2048 (memory/buffer.py), as the JAX df cov
kernels serve every padded N up to 2048, and a mixed step past 128 stored
points runs #5 and #6 (or #5 and #7 under the stacked VJP). At each N, on
random operands of the flagship's widths whose outputs do not cancel (P = 6,
ns = 3, diag_pos (0, 3, 5); chip_smoke.py's draws), it times #2 ``cov_fwd``,
#3 ``cov_bwd`` (both sides, one launch), #5 ``df_cov_fwd``, #6
``df_cov_fwdres`` and #7 ``df_cov_bwd``, and #1 ``gram`` (3 models x 4
features, ``trace_kernels.gram_operands``) at the largest N: device ms per call (``chip_smoke.cuda_ms``, the
calls queued behind a sleep kernel), the plain version's ms between events
(``chip_smoke.event_ms``) and the bound of chip_smoke.py's phase 3
(``cov_fwd_bound``, ``cov_bwd_bound``, ``df_cov_bound``; the Gram's by its
bytes and operations). The kernels' agreement with the plain versions at
these N is tests/test_torch_cuda.py's (``*_at_large_n``). Prints the card's
name and power limit and one JSON line; exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke
from gpmpc_tpu_torch.ops import df_cov, gram_rbf, moment_cov
from gpmpc_tpu_torch.trace_kernels import gram_operands

DIAG = (0, 3, 5)
SIZES = (768, 1536, 2048)


def time_at(dev, n) -> list:
    p, ns, nd = 6, 3, len(DIAG)
    cov = chip_smoke.random_cov_operands(dev, p, n, ns, DIAG, seed=n)
    df = chip_smoke.random_df_operands(dev, p, n, ns, DIAG, seed=n + 1)
    g_s = torch.linspace(1.0, 2.0, p, device=dev)
    g_c = torch.linspace(1.0, 3.0, nd, device=dev)
    gco = torch.zeros(p, device=dev).index_copy(0, torch.tensor(DIAG, device=dev), g_c)
    rows = []
    for name, kern, plain, (b, by) in (
            ("cov_fwd", lambda: moment_cov.cov_fwd(*cov, DIAG), lambda: moment_cov.cov_core_ref(*cov, DIAG),
             chip_smoke.cov_fwd_bound(p, n, ns, nd)),
            ("cov_bwd_row", lambda: moment_cov.cov_bwd(g_s, *cov, g_c, DIAG),
             lambda: moment_cov.cov_bwd_plain(g_s, *cov, g_c, DIAG), chip_smoke.cov_bwd_bound(p, n, n, ns, nd)),
            ("df_fwd", lambda: df_cov.df_cov_fwd(*df, DIAG), lambda: df_cov.df_cov_fwd_plain(*df, DIAG),
             chip_smoke.df_cov_bound("df_fwd", p, n, ns, nd)),
            ("df_fwdres", lambda: df_cov.df_cov_fwdres(*df, DIAG), lambda: df_cov.df_cov_fwdres_plain(*df, DIAG),
             chip_smoke.df_cov_bound("df_fwdres", p, n, ns, nd)),
            ("df_bwd", lambda: df_cov.df_cov_bwd(*df, g_s, gco, DIAG),
             lambda: df_cov.df_cov_bwd_plain(*df, g_s, gco, DIAG), chip_smoke.df_cov_bound("df_bwd", p, n, ns, nd))):
        ms, host = chip_smoke.cuda_ms(kern)
        plain_ms = chip_smoke.event_ms(plain)
        rows.append(dict(name=name, n=n, p=p, ns=ns, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by))
        print(f"{name} N={n} (P={p}, ns={ns}): {ms:.4f} ms (device) plain {plain_ms:.4f} ms bound {b:.5f} ms ({by}), "
              f"{b / ms:.1%} of it; host {host:.4f} ms per call", flush=True)
    return rows


def time_gram(dev, n) -> dict:
    ns, d = 3, 4
    ls, outs, x = gram_operands(dev, n, seed=n)
    ms, host = chip_smoke.cuda_ms(lambda: gram_rbf.gram(ls, outs, x))
    plain_ms = chip_smoke.event_ms(lambda: gram_rbf.gram_ref(ls, outs, x))
    b, by = chip_smoke.bound_ms(4 * (ns * d + ns + n * d + ns * n * n), ns * n * n * (8 * d + 6))
    print(f"gram N={n} ({ns}x{n}x{n}, d={d}): {ms:.4f} ms (device) plain {plain_ms:.4f} ms bound {b:.5f} ms ({by}), "
          f"{b / ms:.1%} of it; host {host:.4f} ms per call", flush=True)
    return dict(name="gram", n=n, ns=ns, d=d, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_large_n: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    rows = [r for n in SIZES for r in time_at(dev, n)] + [time_gram(dev, max(SIZES))]
    print(card, flush=True)
    print(json.dumps({"card": card, "kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpmpc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``gpmpc_tpu_torch/ops/csrc`` (one nvcc call,
into ``build/gpmpc_tpu_torch/``), holds each kernel against its plain
PyTorch version at the flagship shapes, drives the port's main path (one
refresh of the factorization cache, then steady-state f32 planning steps of
the pendulum flagship: Ns=3, Na=1, horizon 15, 300 stored points in the 384
bucket, one L-BFGS-B restart at maxiter=maxfun=maxls=maxcor=4), checks that
every kernel was launched on that path, holds the planning step against
the same steps run by the port on the CPU in float64, and times the step.
The f64 comparison is held to a tolerance at 24 stored points, where the
f32 arithmetic is well conditioned; at the flagship's 300 points f32 itself
breaks down (see ACC_TOL) and the f32 objective is printed.

Output: one line per phase with its elapsed seconds; then the card's name and
power limit, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is present or any phase fails. A watchdog ends a hung run
with a traceback after ``WATCHDOG_S`` seconds.
"""

from __future__ import annotations

import faulthandler
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gpmpc_tpu_torch import ops
from gpmpc_tpu_torch.controllers.planner import Planner, _objective_and_info
from gpmpc_tpu_torch.flagship import flagship_problem, run_steps
from gpmpc_tpu_torch.models import gp as gp_mod
from gpmpc_tpu_torch.models.gp import constrained_params
from gpmpc_tpu_torch.ops import _build
from gpmpc_tpu_torch.ops import gram_rbf as gram_mod
from gpmpc_tpu_torch.ops import moment_cov

WATCHDOG_S = 175  # a little under the 180 s budget of a cold run
PLAN_STEPS = 5
TIMED_STEPS = 20
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet

# Kernel tolerances, f32 on both sides. Gram entries are independent:
# rtol 2e-5, atol 2e-6, as tests/test_pallas_ops.py holds the Pallas Gram.
# Each cov-core output is a sum of up to N^2 = 1.5e5 terms of both signs,
# which the kernel sums in another order (block partials, warp shuffles,
# FMAs) than the plain einsum, and whose E is rounded differently through
# the exponent. The error of an f32 sum is bounded by a small multiple of
# eps32 times the sum of |terms|, so each output is held to
# max |kernel - plain| <= COV_TOL * max sum(|terms|) (moment_cov's
# *_abs_terms). On an H100 the error was at most 8.5e-8 of that scale
# (this script's phase 3 output); COV_TOL leaves a 3.5x margin. On the
# flagship's operands the outputs cancel far below eps32 times their scale
# (the largest S_p is 4.5e-9 of it: |beta| > 1e3), so there the check
# bounds the error but cannot see every wrong output. The random operands of the flagship's shapes
# (P=6, N=384, ns=3) do not cancel: each output's max |ref| is at least
# MIN_RESOLVED of its scale, ~1.7e3 times COV_TOL, and a planted fault (a
# dropped bj or Xj factor, a wrong iK slot) missed by 7e-5 to 1e-1 of the
# scale on the card, 240x COV_TOL or more.
GRAM_RTOL, GRAM_ATOL = 2e-5, 2e-6
COV_TOL = 3e-7
MIN_RESOLVED = 5e-4

# Accuracy of the planning step against the port's float64 CPU run of the
# same steps, on the flagship's widths, horizon, optimizer budget and GP
# parameters with 24 stored points in the 32 bucket, where the f32 rollout
# is well conditioned: on the card f32 agrees with f64 to ~1e-5 in the
# objective, ~5e-5 in the gradient and ~7e-6 in a_opt. The tolerance, 1e-3
# for each (objective relative, gradient and TrajectoryInfo relative to
# each field's largest entry, a_opt absolute on actions in [0, 1]), leaves
# room for another card or summation order while a wrong kernel or path
# shows as an error of order 1e-2 or more. At the flagship's 300 points the
# f32 arithmetic itself fails (the cov-core contractions cancel far below
# eps32, in the JAX package's f32 path too; tests/test_torch_gp.py pins it)
# and the f32 objective is NaN, so there it is printed, not held to f64.
ACC_POINTS, ACC_BUCKET = 24, 32
ACC_TOL = 1e-3

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.2f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def objective_and_grad(prob, cache, actions):
    """The planning objective and its gradient at fixed actions."""
    a = actions.detach().clone().requires_grad_(True)
    cost, _ = _objective_and_info(prob.spec, cache, a, prob.state_mu, prob.state_var,
                                  prob.action_prev, 0)
    (g,) = torch.autograd.grad(cost, a)
    return float(cost.detach()), g.double().cpu()


def cuda_ms(fn, reps=16, rounds=5, warmup=5) -> tuple[float, float]:
    """(device ms, host ms) per call of fn. A single launch takes the host
    longer to issue than the card to run, so timing back-to-back calls
    measures the host. Instead the card is first kept busy with a sleep
    kernel long enough for the host to queue ``reps`` calls behind it; CUDA
    events around the queued calls then time the device work alone. ``reps``
    stays small because the launch queue holds about a thousand pending
    kernels, beyond which queueing blocks. A round in which the sleep ended
    before the host finished queueing is dropped and the sleep doubled; the
    result is the median of ``rounds`` rounds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(host_ms * 4e6) + 1_000_000  # 2x the host time at 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    while len(times) < rounds:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_behind = start.query()  # the card reached the calls before all were queued
        torch.cuda.synchronize()
        if host_behind:
            cycles *= 2
            if cycles > 4e9:
                raise RuntimeError("cuda_ms: the host could not queue the calls ahead of the card")
            continue
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), host_ms / reps


def max_err(out, ref, scale=None) -> tuple[float, float]:
    """(max |out - ref|, that over max |scale|), scale defaulting to ref."""
    diff = float((out.double() - ref.double()).abs().max())
    s = ref if scale is None else scale
    return diff, diff / max(float(s.double().abs().max()), 1e-30)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over HBM rate or f32
    operations over the f32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flagship_cov_operands(device):
    """The cov-core operands of the last (15th) rollout step at the flagship,
    where the state covariance is widest: recorded from the dispatch while the
    port evaluates the objective at the initial actions in float64 on the CPU
    (the f32 rollout is not finite there), then cast to f32 on ``device``."""
    cpu = torch.device("cpu")
    prob = flagship_problem(cpu, torch.float64)
    cache = Planner(prob.spec, dtype=torch.float64, device=cpu).refresh_cache(
        prob.x, prob.y, prob.mask, prob.params, prob.bounds)
    seen = []
    dispatch = ops.cov_core

    def record(*args):
        seen.append(args)
        return dispatch(*args)

    gp_mod.ops.cov_core = record
    try:
        with torch.no_grad():
            _objective_and_info(prob.spec, cache, prob.inits[0], prob.state_mu,
                                prob.state_var, prob.action_prev, 0)
    finally:
        gp_mod.ops.cov_core = dispatch
    *tensors, diag_pos = seen[-1]
    return [t.to(device=device, dtype=torch.float32).contiguous() for t in tensors], tuple(diag_pos)


def check_kernels(dev):
    """Each kernel against its plain version on the card at flagship shapes."""
    results = {}
    prob = flagship_problem(dev, torch.float32)
    ls, outs, _ = constrained_params(prob.params, prob.bounds)
    x = torch.as_tensor(prob.x, dtype=torch.float32, device=dev)
    ns, d = ls.shape
    n = x.shape[0]

    k_out = gram_mod.gram(ls, outs, x)
    k_ref = gram_mod.gram_ref(ls, outs, x)
    excess = float(((k_out - k_ref).abs() - (GRAM_ATOL + GRAM_RTOL * k_ref.abs())).max())
    abs_e, rel_e = max_err(k_out, k_ref)
    ms, host = cuda_ms(lambda: gram_mod.gram(ls, outs, x))
    plain, _ = cuda_ms(lambda: gram_mod.gram_ref(ls, outs, x))
    b, by = bound_ms(4 * (ns * d + ns + n * d + ns * n * n), ns * n * n * (8 * d + 6))
    log(f"kernel gram ({ns}x{n}x{n}): max abs err {abs_e:.3e} rel {rel_e:.3e} (tol atol {GRAM_ATOL} "
        f"+ rtol {GRAM_RTOL}) | kernel {ms:.4f} ms plain {plain:.4f} ms bound {b:.5f} ms ({by}); "
        f"host {host:.4f} ms per call")
    if not excess <= 0.0:
        raise AssertionError(f"gram kernel disagrees with gram_ref: max abs err {abs_e:.3e}")
    results["gram"] = dict(err=abs_e, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)

    cov_flag, diag_pos = flagship_cov_operands(dev)
    cov_rand = random_cov_operands(dev, *cov_flag[0].shape, cov_flag[2].shape[2], diag_pos)
    err_fwd = max(check_cov_fwd("flagship", cov_flag, diag_pos),
                  check_cov_fwd("random", cov_rand, diag_pos))
    err_bwd = max(check_cov_bwd("flagship", cov_flag, diag_pos),
                  check_cov_bwd("random", cov_rand, diag_pos))

    a, c, u, xj, bi, bj, ik = cov_flag
    p, n = a.shape
    ns_ = u.shape[2]
    nd = len(diag_pos)
    ms, host = cuda_ms(lambda: moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, diag_pos))
    plain, _ = cuda_ms(lambda: moment_cov.cov_core_ref(a, c, u, xj, bi, bj, ik, diag_pos))
    b, by = bound_ms(4 * (4 * p * n + 2 * p * n * ns_ + nd * n * n + nd + p + nd),
                     p * n * n * (2 * ns_ + 5) + nd * n * n * 2)
    log(f"kernel cov_fwd (P={p}, N={n}, ns={ns_}): kernel {ms:.4f} ms plain {plain:.4f} ms "
        f"bound {b:.5f} ms ({by}); host {host:.4f} ms per call")
    results["cov_fwd"] = dict(err=err_fwd, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)

    g = torch.linspace(1.0, 2.0, p, device=dev)
    gco = _scatter_diag(torch.linspace(1.0, 3.0, nd, device=dev), p, diag_pos)
    ms, host = cuda_ms(lambda: moment_cov.cov_bwd_row(g, a, c, u, xj, bi, bj, ik, gco, diag_pos))
    plain, _ = cuda_ms(lambda: moment_cov.cov_bwd_row_plain(g, a, c, u, xj, bi, bj, ik, gco, diag_pos))
    b, by = bound_ms(4 * (2 * p + 4 * p * n + 2 * p * n * ns_ + nd * n * n + 2 * p * n + p * n * ns_),
                     p * n * n * (4 * ns_ + 8) + nd * n * n * 3)
    log(f"kernel cov_bwd_row (one side): kernel {ms:.4f} ms plain {plain:.4f} ms "
        f"bound {b:.5f} ms ({by}); host {host:.4f} ms per call")
    results["cov_bwd_row"] = dict(err=err_bwd, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    return results


def random_cov_operands(dev, p, n, ns, diag_pos, seed=0):
    """Cov-core operands of the flagship's shapes whose outputs do not
    cancel (drawn as tests/test_torch_cuda.py draws them): every output is
    at least ``MIN_RESOLVED`` of its sum of |terms|, so a kernel that is
    wrong by the size of an output fails COV_TOL."""
    rng = np.random.default_rng(seed)
    ikh = rng.normal(0, 0.1, (len(diag_pos), n, n))
    arrays = (rng.normal(-2, 0.5, (p, n)), rng.normal(-2, 0.5, (p, n)), rng.normal(0, 0.3, (p, n, ns)),
              rng.normal(0, 0.3, (p, n, ns)), rng.normal(0, 1, (p, n)), rng.normal(0, 1, (p, n)),
              (ikh + ikh.transpose(0, 2, 1)) / 2)
    return [torch.tensor(x, dtype=torch.float32, device=dev) for x in arrays]


def _scatter_diag(values, p, diag_pos):
    """Per-diagonal values scattered to the pair axis, zero elsewhere."""
    idx = torch.as_tensor(diag_pos, device=values.device)
    return torch.zeros(p, device=values.device).index_copy(0, idx, values)


def hold_cov(what, label, out, ref, scale) -> float:
    """Hold one cov output to COV_TOL of its largest sum of |terms|; print
    the error beside |ref|. On the random operands also require that the
    output is resolvable: max |ref| at least MIN_RESOLVED of that scale."""
    abs_e, rel_e = max_err(out, ref, scale)
    resolved = float(ref.double().abs().max()) / max(float(scale.double().abs().max()), 1e-30)
    log(f"kernel {what} [{label}]: max abs err {abs_e:.3e} = {rel_e:.3e} of max sum|terms| "
        f"{float(scale.abs().max()):.4g} (tol {COV_TOL}); max |ref| {float(ref.abs().max()):.4g} "
        f"= {resolved:.3e} of it")
    if not rel_e <= COV_TOL:
        raise AssertionError(f"{what} [{label}] disagrees with its plain version")
    if label == "random" and not resolved >= MIN_RESOLVED:
        raise AssertionError(f"{what} [random]: output {resolved:.3e} of its scale, not resolvable")
    return abs_e


def check_cov_fwd(label, operands, diag_pos) -> float:
    s_k, co_k = moment_cov.cov_fwd(*operands, diag_pos)
    s_r, co_r = moment_cov.cov_core_ref(*operands, diag_pos)
    s_abs, co_abs = moment_cov.cov_fwd_abs_terms(*operands, diag_pos)
    return max(hold_cov("cov_fwd S_p", label, s_k, s_r, s_abs),
               hold_cov("cov_fwd corr", label, co_k, co_r, co_abs))


def check_cov_bwd(label, operands, diag_pos) -> float:
    """Row and column sides through autograd of CovCore, against autograd
    of the plain core; the leaves are a, c, U, Xj, bi and bj."""
    a, c, u, xj, bi, bj, ik = operands
    p, nd = a.shape[0], len(diag_pos)
    w_s = torch.linspace(1.0, 2.0, p, device=a.device)
    w_c = torch.linspace(1.0, 3.0, nd, device=a.device)

    def grads(core):
        leaves = [t.clone().requires_grad_(True) for t in (a, c, u, xj, bi, bj)]
        s, co = core(*leaves, ik, diag_pos)
        return torch.autograd.grad((s * w_s).sum() + (co * w_c).sum(), leaves)

    g_k = grads(moment_cov.CovCore.apply)
    g_r = grads(moment_cov.cov_core_ref)
    gco = _scatter_diag(w_c, p, diag_pos)
    row = moment_cov.cov_bwd_row_abs_terms(w_s, a, c, u, xj, bi, bj, ik, gco, diag_pos)
    col = moment_cov.cov_bwd_row_abs_terms(w_s, c, a, xj, u, bj, bi, ik.transpose(1, 2), gco, diag_pos)
    scales = (row[0], col[0], row[1], col[1], row[2], col[2])
    return max(hold_cov(f"cov_bwd_row {name}", label, out, ref, scale)
               for name, out, ref, scale in zip(("ga", "gc", "gU", "gXj", "gbi", "gbj"), g_k, g_r, scales))


def check_plans(plans, spec, finite_info):
    for a_opt, info in plans:
        a = a_opt.double().cpu()
        if not (torch.isfinite(a).all() and a.min() >= 0 and a.max() <= 1):
            raise AssertionError(f"a_opt not finite in [0, 1]: {a}")
        if tuple(a.shape) != (spec.len_horizon * spec.dim_action,):
            raise AssertionError(f"a_opt shape {tuple(a.shape)}")
        if tuple(info.states_mu_pred.shape) != (spec.len_horizon + 1, spec.dim_state):
            raise AssertionError(f"states_mu_pred shape {tuple(info.states_mu_pred.shape)}")
        if finite_info and not all(bool(torch.isfinite(f).all()) for f in info):
            raise AssertionError("non-finite TrajectoryInfo")


def compare_to_f64(dev, n_points, bucket):
    """Run the same steps on the card in f32 and on the CPU in f64; return
    (objective rel, gradient rel, a_opt abs, info rel) gaps and the card's plans."""
    cpu = torch.device("cpu")
    prob = flagship_problem(dev, torch.float32, n_points=n_points, bucket=bucket)
    planner, plans, _ = run_steps(prob, dev, torch.float32, PLAN_STEPS)
    ref_prob = flagship_problem(cpu, torch.float64, n_points=n_points, bucket=bucket)
    ref_planner, ref_plans, _ = run_steps(ref_prob, cpu, torch.float64, PLAN_STEPS)
    f_card, g_card = objective_and_grad(prob, planner._cache, prob.inits[0])
    f_ref, g_ref = objective_and_grad(ref_prob, ref_planner._cache, ref_prob.inits[0])
    gaps = dict(
        objective=abs(f_card - f_ref) / abs(f_ref),
        gradient=max_err(g_card, g_ref)[1],
        a_opt=max(max_err(a.cpu(), r)[0] for (a, _), (r, _) in zip(plans, ref_plans)),
        info=max(max_err(x.cpu(), y)[1] for (_, i), (_, r) in zip(plans, ref_plans)
                 for x, y in zip(i, r)),
    )
    log(f"  {n_points} points in the {bucket} bucket, card f32 vs CPU f64: objective {f_card:.9g} vs "
        f"{f_ref:.9g}; gaps " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    return gaps, plans


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs only on a CUDA card",
              file=sys.stderr, flush=True)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        return _run()
    finally:
        faulthandler.cancel_dump_traceback_later()


def _run() -> int:
    dev = torch.device("cuda")
    # the reference math is full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    _build.load()
    log(f"phase 2 build: {'compiled' if _build.info.compiled else 'reused'} {_build.info.path} "
        f"in {_build.info.seconds:.2f} s")
    for line in _build.info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    kern = check_kernels(dev)
    log("phase 3 kernels: all three match their plain versions on the card")

    prob = flagship_problem(dev, torch.float32)
    spec = prob.spec
    ops.reset_launch_counts()
    planner, plans, _ = run_steps(prob, dev, torch.float32, PLAN_STEPS)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"phase 4 main path: refresh + {PLAN_STEPS} flagship plans, launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    check_plans(plans, spec, finite_info=False)
    f_card, _ = objective_and_grad(prob, planner._cache, prob.inits[0])
    log(f"  flagship f32 objective at the initial actions: {f_card:.9g} (f32 breaks down at "
        f"300 points, in the JAX package too; see ACC_TOL)")

    gaps, plans = compare_to_f64(dev, ACC_POINTS, ACC_BUCKET)
    check_plans(plans, spec, finite_info=True)
    if not all(v <= ACC_TOL for v in gaps.values()):
        raise AssertionError(f"card f32 disagrees with CPU f64 beyond {ACC_TOL}: {gaps}")
    log(f"phase 4 accuracy: {ACC_POINTS} points within {ACC_TOL} of f64")

    prob = flagship_problem(dev, torch.float32)
    _, _, secs = run_steps(prob, dev, torch.float32, TIMED_STEPS, sync=torch.cuda.synchronize)
    med = statistics.median(secs) * 1e3
    log(f"phase 5 timing: median blocked flagship planning step {med:.2f} ms over {TIMED_STEPS} "
        f"steps (min {min(secs) * 1e3:.2f}, max {max(secs) * 1e3:.2f}) on {card}")

    sources = {"gram": "gpmpc_tpu_torch/ops/csrc/gram.cu",
               "cov_fwd": "gpmpc_tpu_torch/ops/csrc/cov_core.cu",
               "cov_bwd_row": "gpmpc_tpu_torch/ops/csrc/cov_core.cu"}
    replaces = {"gram": "gpmpc_tpu/ops/pallas_gram.py:28",
                "cov_fwd": "gpmpc_tpu/ops/pallas_moment_cov.py:111",
                "cov_bwd_row": "gpmpc_tpu/ops/pallas_moment_cov.py:175"}
    kernels = [dict(name=name, route="cuda", source=sources[name], replaces=replaces[name],
                    launches=launches[name], max_abs_err=kern[name]["err"], ms=kern[name]["ms"],
                    plain_ms=kern[name]["plain_ms"], bound_ms=kern[name]["bound_ms"],
                    bound_by=kern[name]["bound_by"], library_ms=None)
               for name in ("gram", "cov_fwd", "cov_bwd_row")]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

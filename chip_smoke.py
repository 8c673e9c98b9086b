#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpmpc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``gpmpc_tpu_torch/ops/csrc`` (one nvcc -c per
source, all started together, and one link, into ``build/gpmpc_tpu_torch/``),
holds each kernel against its plain PyTorch version at the flagship shapes
(phase 3), then drives the port's paths, each with the launch counts set to
0 just before it and read just after:

* the f32 flagship (phase 4): one refresh of the factorization cache, then
  steady-state f32 planning steps of the pendulum flagship (Ns=3, Na=1,
  horizon 15, 300 stored points in the 384 bucket, one L-BFGS-B restart at
  maxiter=maxfun=maxls=maxcor=4), held to the port's float64 CPU run at 24
  stored points, where f32 is well conditioned (at 300 points f32 itself
  breaks down, see ACC_TOL, and the f32 objective is printed);
* the trained-GP flagship in mixed mode (phase 4, mixed): an f64 master
  refreshed on the card, then steady-state steps whose rollout runs in
  double-float32 through the df32 cov kernels, held to the card's own
  float64 plan of the same steps (MIXED_TOL); the first step's f64 plan is
  replayed with parts of the mixed objective and optimizer, to show which
  of them moves a_opt (``a_opt_witness``);
* the trained-GP problem at 100 points in the 128 bucket in mixed mode
  (phase 4, whole-step; horizon FUSED_NH): the same, with every rollout step
  through the whole-step df32 kernels (#12 forward, #8 and #9 in the
  backward) instead of the df cov kernels, held to the card's f64 plan;
* the gradient of the f32 planning objective with respect to the
  factorization cache's iK (phase 4, iK gradient) at 24 points, where the
  cov core's iK-gradient kernel runs, held to the port's float64 CPU run;
* the trained-GP flagship in mixed mode under the stacked df32 VJP (phase 4,
  stacked: ``df_cov.VJP_MODE = "stacked"``, the reference's
  ``GPMPC_DF_COV_VJP=stacked``; horizon STACKED_NH): the lean forward and
  the stacked backward kernel instead of the forward with residuals, held
  to the card's f64 plan of the same horizon;
* the controller (phase 6): the pendulum example's ``GpMpcController`` in
  mixed mode on ``PendulumEnv``, driven through ``get_action`` and
  ``add_memory``: 10 random warmup steps (``Planner.evaluate``), the MLL
  training they fire (f64, on the controller's CPU thread), then 2 planned
  steps, each held to the card's f64 plan of the same memory and
  parameters; with at most 32 stored points every rollout step runs the
  whole-step kernels (#12, and #8 and #9 in the backward);
* the runner (phase 7): the mountain-car example's configuration in mixed
  mode on ``MountainCarContinuousEnv`` through ``run_env`` itself, 21 steps
  (20 random, evaluated at every 5th step, then one planned step of two
  L-BFGS-B restarts at a budget cut to MC_MAXFUN), every rollout step
  through the whole-step kernels at ns = 2, d = 3; the plan is held to the
  card's f64 plan of the same memory, parameters and both inits, and the
  restart each side keeps is printed.

Phase 3 holds the twelve kernels to their plain versions: the f32 Gram and
cov kernels (forward, row backward, iK gradient) at the flagship's shapes,
the df cov kernels (lean forward, forward with residuals, stacked backward)
on the trained-GP flagship's operands and random ones, the whole-step
kernels at N = 32, 96, 128 and 384 (and at ns = 2, d = 3, phase 7's widths,
on random operands at N = 32 and 100) and the split backward (the mean path's
and the pairs' VJP) at N = 192 and 384, on the trained-GP problem's operands
and random ones, each redesigned kernel also for bitwise repeats, the split
route bit for bit against #9 and its on-card combination against
``combine_split``, the Gram also at a ragged N and the iK gradient on
rectangular slabs; it also reports the launch floor (an empty kernel,
plainly and as a programmatic dependent), and the launch shape, time and
bound of the ten kernels redesigned for the H100 (#9 df_mm_bwd, #6
df_fwdres, #12 df_mm_full, #2 cov_fwd, #5 df_fwd, #3 cov_bwd_row, both sides
in one launch, #11 df_mm_bwd_pair and #10 df_mm_bwd_mean at N = 192 and 384,
#10 beside its latency floor, #1 gram and #4 cov_gik beside the launch
floor) beside unchanged kernels timed in the same run, and the times of #12
at N = 32 and 96 and of #2 at N = 32. Phase 4 also holds the launch
counts of #5 and #3 on their paths, phase 5 those of #10 and #11, phase 6
those of #12, #8 and #9 in each controller step and phase 7 those of the
mountain-car episode (EXPECTED_LAUNCHES). Phase 5
times the blocked planning step of the paths and 15-step rollouts of the
mixed routes at ROLLOUT_BUCKETS; at 384 the whole-step route's
value-and-grad rollout runs the split backward, and its gradient is held to
the df cov route's and to the f64 rollout's. Phase 6 times each controller
step (blocked) and the training on its thread, phase 7 the episode, its
planned step and its random steps (blocked).

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
from types import SimpleNamespace

import numpy as np
import torch

from gpmpc_tpu_torch import GpMpcController, ops, run_env
from gpmpc_tpu_torch.controllers import planner as planner_mod
from gpmpc_tpu_torch.controllers.lbfgs import lbfgs_b_minimize
from gpmpc_tpu_torch.controllers.planner import Planner, _cast_cache, _objective_and_info
from gpmpc_tpu_torch.envs import MountainCarContinuousEnv, PendulumEnv
from gpmpc_tpu_torch.example_configs import mountain_car_config
from gpmpc_tpu_torch.flagship import (
    flagship_problem,
    pendulum_config,
    plan_step,
    run_steps,
    start_steps,
    trained_gp_problem,
)
from gpmpc_tpu_torch.models import gp as gp_mod
from gpmpc_tpu_torch.models.gp import constrained_params
from gpmpc_tpu_torch.ops import _build, df_cov, df_mm
from gpmpc_tpu_torch.ops import gram_rbf as gram_mod
from gpmpc_tpu_torch.ops import moment_cov

WATCHDOG_S = 175  # a little under the 180 s budget of a cold run
# Depths of the paths. A cold run took 102-160 s on H100 hosts of different
# speed (the f32 step 416-848 ms) with 5, 10 and 2 here, so they were cut to
# keep a slow host well inside WATCHDOG_S; no path or check was dropped.
# The controller (phase 6, ~22 s on the card) took a cold run to ~165 s on
# one host, so three more depths were cut: TIMED_STEPS from 5 to 3, and the
# horizon of the stacked-VJP mixed plan (STACKED_NH) and of the whole-step
# plan at 128 (FUSED_NH) from 15 to 5. The residual mixed plan keeps the
# flagship's 15, and phase 6 plans through the whole-step path at 15.
# Phase 7 (the mountain-car episode through run_env) has one cut of its own,
# the example's L-BFGS-B budget (MC_MAXFUN).
PLAN_STEPS = 3
TIMED_STEPS = 3
MIXED_STEPS = 1  # trained-GP flagship steps in mixed mode, each checked and timed
FUSED_STEPS = 1  # whole-step path steps, each checked and timed
STACKED_NH = 5
FUSED_NH = 5
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
# f32 add or multiply instructions per second that cannot fuse into an FMA:
# 16,896 FP32 lanes x 1.98 GHz boost, half the 67 TFLOP/s FMA figure
H100_F32_INSTR_PER_S = 33.5e12
# cycles from one dependent f32 add or multiply to the next (the latency
# floor of a chain of them, with nvidia-smi's maximum SM clock)
F32_LATENCY_CYCLES = 4

# The kernels redesigned for the H100 after their first port, and their
# device times before (chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at
# 700 W: #9 and #6 from their first design's runs, the others from the runs
# of the design before this one; #3's is two one-side launches, 2 x
# 0.0081-0.0083; #11 and #10 at N = 384; #1 and #4 at 3 x 384 x 384):
# phase 3 prints each beside its new time, its launch shape and its bound
# (#1 and #4 also beside the launch floor), with #8 and #7 from the same
# call as controls.
REDESIGNED_BEFORE_MS = {"df_mm_bwd": "0.0596-0.0600", "df_fwdres": "0.0688-0.0696", "df_mm_full": "0.0271-0.0274",
                        "cov_fwd": "0.0214-0.0223", "df_fwd": "0.0461-0.0462", "cov_bwd_row": "0.0162-0.0166",
                        "df_mm_bwd_pair": "0.2339-0.2406", "df_mm_bwd_mean": "0.0205-0.0213",
                        "gram": "0.0073-0.0075", "cov_gik": "0.0038-0.0040"}
# Launches of #5 and #3 on their driven paths (phase 4), held exactly: the
# f32 refresh + PLAN_STEPS plans run 30 backwards per plan (two
# value-and-grad objective evaluations of 15 rollout steps), one cov_bwd_row
# launch each; a mixed plan runs 5 forward-only evaluations of 15 steps
# through df_fwd. The stacked plan, at horizon STACKED_NH = 5, runs 5
# value-and-grad evaluations and the forward-only one of its result, each
# forward through df_fwd: 30 (150 at horizon 15; the plain twins on the CPU
# take the same line-search decisions). The plans have run these
# evaluations in every run on the card. Phase 5's
# whole-step value-and-grad rollout at 384 runs one split backward per step
# (#10, then #11) of its 15.
# Phase 6's controller steps, each a 15-step rollout per evaluation: a warmup
# step one forward-only rollout (15 df_mm_full); a planned step runs df_mm_full
# in every rollout and df_mm_fwd and df_mm_bwd in the backward of each
# value-and-grad one: the first planned step 5 value-and-grad evaluations, 3
# forward-only line-search trials and the rollout of its result, the second
# 3, 3 and 1 (the same counts on the plain twins on the CPU, by the same
# line-search decisions).
# Phase 7's mountain-car episode, each rollout 12 steps: the random steps 0,
# 5, 10 and 15 one forward-only rollout each (48 df_mm_full); the planned
# step two restarts of 4 value-and-grad evaluations each (MC_MAXFUN = 3 ends
# a restart after its first evaluation and three accepted line searches; no
# forward-only trial) and the rollout of its result: 9 x 12 df_mm_full, 8 x
# 12 df_mm_fwd and df_mm_bwd (the same counts on the plain twins on the CPU).
EXPECTED_LAUNCHES = {"cov_bwd_row per f32 plan": 30, "df_fwd per residual mixed plan": 75,
                     "df_fwd per stacked mixed plan": 30, "df_mm_bwd_mean per split rollout": 15,
                     "df_mm_bwd_pair per split rollout": 15,
                     "controller warmup step": {"df_mm_full": 15},
                     "controller planned steps": ({"df_mm_full": 135, "df_mm_fwd": 75, "df_mm_bwd": 75},
                                                  {"df_mm_full": 105, "df_mm_fwd": 45, "df_mm_bwd": 45}),
                     "mountain-car episode": {"df_mm_full": 156, "df_mm_fwd": 96, "df_mm_bwd": 96}}

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
# The cov core's iK gradient (cov_gik) has independent entries g_corr[m] E,
# so it is held elementwise. The kernel forms E's exponent a + c + sum_e
# U_e Xj_e with FMAs, the plain twin with an add and an einsum: the two
# round in another order, each by at most (ns + 2) / 2 eps32 of the sum of
# the terms' magnitudes (moment_cov.cov_gik_expo_abs), which moves E by as
# much relative to itself, and expf and torch.exp each round within 2 ulp.
# So |kernel - plain| <= GIK_RTOL (1 + that sum) |plain| per element, with
# GIK_RTOL = 8 eps32 (2.5 eps32 per unit of the sum at ns = 3, 4 eps32 for
# the two exps, room to spare), plus |g_corr| 2^-126 where E is subnormal.
# A wrong pair slot or a dropped factor moves an entry by O(1) of itself.
GIK_RTOL = 8 * 2.0 ** -23

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

# df32 kernels. Each E element is computed by the kernel with the same
# uncontracted f32 operations as by the plain twin, so the two differ only
# in the order of their compensated sums, whose error is a small multiple of
# eps32^2 = 3.6e-15 of each output's sum of |terms| (df_cov.df_cov_abs_terms):
# max |kernel - plain| <= DF_TOL * that scale, output by output. On an H100
# the error was at most 5.2e-15 of the scale. Planted faults missed by far
# more: a contracted two_prod (a Veltkamp split fused into an FMA) turned
# the rollout's operands to NaN, a dropped lo half of the row residuals
# missed by 1.6e-8 of the scale, a wrong iK slot by 7.3e-3 (on the random
# operands only: the trained-GP flagship's three models share one iK).
DF_TOL = 1e-11
# DfCovCore's gradients collapse to f32 after the df combination: held to
# DF_GRAD_TOL of their largest entry against autograd of the plain core, as
# tests/test_torch_df32.py holds them against JAX on the CPU. The whole-step
# VJP kernel (df_mm_bwd) carries every cotangent in df and collapses only its
# outputs, so against its plain twin it differs by the order of its df sums;
# it is held to the same DF_GRAD_TOL of its largest entry.
DF_GRAD_TOL = 3e-6
# The stacked backward (df_bwd) is the same VJP as the residual scheme: both
# sum every cotangent-weighted term in df and collapse at the end, so on the
# same operands their gradients agree to DF_GRAD_TOL (phase 3 prints the
# gap). The whole objective's gradient need not: downstream of the cov core
# the rollout's tangents are plain f32 (the df32 custom derivatives) and its
# sums over the stored points cancel, so a last-bit difference in the cov
# core's gradient can move the objective's gradient by up to its f32-grade
# error (MIXED_TOL's gradient; phase 4 prints the gap). The stacked step is
# therefore held, like the residual one, to the card's f64 plan by
# MIXED_TOL, and its gradient to the residual step's by MIXED_TOL's gradient.
# The whole-step kernels (ops/df_mm.py) at these N on the trained-GP problem
# (0.8 N points in the N bucket, 300 in 384) and on random operands. Their
# raw df partials (df_mm_fwd) are held as the df cov kernels' are (DF_TOL of
# each output's sum of |terms|). df_mm_full's outputs are f32 values after
# the finish: each collapse to f32 and each scaling rounds once, so each is
# held to FULL_EPS of itself plus DF_TOL of its sum of |terms| scaled as the
# output is (by c, or by 1 / sqrt det R).
DF_MM_SIZES = (32, 96, 128, 384)
RAGGED_N = 100  # and on random operands at an N with a ragged last tile
NS2_SIZES = (32, RAGGED_N)  # and at ns = 2, d = 3 (phase 7's widths) on random operands
# the split backward (#10 mean path, #11 pairs) that serves N > 128, each
# output against its plain twin to DF_GRAD_TOL of its largest entry, and the
# combined split route against #9 (#9 is right at any N), timed at both
SPLIT_SIZES = (192, 384)
FULL_EPS = 4 * 2.0 ** -23
# launches of each whole-step wrapper (the split route's cotangent cat apart)
LAUNCHES_PER_CALL = {"df_mm_full": 2, "df_mm_fwd": 2, "df_mm_bwd": 2, "df_mm_bwd_mean": 1, "df_mm_bwd_pair": 3}
# the whole-step path (phase 4): the trained-GP problem at 100 points in the
# 128 bucket, where the card's dispatch takes it (ops.use_df_fused)
FUSED_POINTS, FUSED_BUCKET = 100, 128
# phase 5's 15-step rollouts of each route, for the H100 dispatch range (64
# was dropped to keep the cold run well inside WATCHDOG_S: 139 s on a slow host)
ROLLOUT_BUCKETS = (128, 384)

# Mixed mode against the card's float64 plan of the same trained-GP step.
# objective and gradient: at the initial actions on the caches after the
# step (relative; the gradient to its largest entry). info: the mixed
# plan's TrajectoryInfo against the f64 rollout at the same actions (each
# field relative to its largest entry). plan: the f64 objective at the
# mixed plan's a_opt may exceed the f64 objective at the f64 plan's a_opt by
# this much of its magnitude (the largest over the steps; negative when the
# mixed plan is better). The a_opt gap itself is printed per step, not
# held: L-BFGS-B stops after maxfun=4 evaluations, and the mixed gradient's
# f32-grade error alone can send it down another path. a_opt_witness shows
# it on each run. On an H100 the first step's mixed a_opt differed from the
# f64 plan's by 0.17; the f64 plan replayed with the mixed gradient (f64
# values) landed 0.18 from the f64 plan's a_opt and 0.019 from the mixed
# plan's, while the replays with mixed values (f64 gradient) or with the
# optimizer in f32 stayed within 1.1e-5 of the f64 plan.
# The objective is a df32 value, f64-grade (measured 8.9e-6 to 3.1e-5 of
# f64 on an H100); the gradient is f32-grade by design (the df32 custom
# derivatives carry plain f32 tangents; only the cov core's residuals stay
# df until the cotangents are applied): measured 2.6e-4 to 5.7e-4, and the
# gradient tolerance is about 5x that. A cov core whose gradient is summed
# in plain f32 (autograd through the plain df core, as the JAX package's
# XLA twin is differentiated) missed it by 7.5 of its largest entry on the
# card (a planted fault of the dispatch), and a plain f32 rollout is NaN.
MIXED_TOL = {"objective": 1e-4, "gradient": 3e-3, "info": 1e-3, "plan": 1e-2}

# The controller (phase 6): the pendulum example's GpMpcController in mixed
# mode on PendulumEnv(seed=0), CONTROLLER_WARMUP random steps
# (run_pendulum.py's random_actions_init), the training they fire, blocked
# until it is swapped in, then CONTROLLER_PLANNED planned steps. The one
# reduction: training_frequency is 10 in place of the example's 25, so that
# training fires right after the warmup. With at most 32 stored points every
# rollout step takes the whole-step path (ops.use_df_fused); each step's
# launches are held in EXPECTED_LAUNCHES.
CONTROLLER_WARMUP = 10
CONTROLLER_PLANNED = 2
CONTROLLER_TRAINING_FREQUENCY = 10

# The mountain-car example through run_env (phase 7): its configuration in
# mixed mode (Ns=2, Na=1, horizon 12, repeat 5, two L-BFGS-B restarts, its GP
# init, bounds and memory thresholds) on MountainCarContinuousEnv(seed=0),
# run_mountaincar.py's 20 random warmup steps and one more step. With repeat 5
# the controller evaluates a random sequence at steps 0, 5, 10 and 15 and
# plans at step 20; the example's training_frequency (60) is past the
# episode, so no training fires. The one cut: the L-BFGS-B budget, maxfun =
# maxiter = 8 in the example, is MC_MAXFUN here (each value-and-grad rollout
# at horizon 12 takes ~1 s of host time on the card, and a planned step of
# two restarts at the example's budget would take up to 16 of them). At most
# 4 stored points sit in the 32 bucket, so every rollout step takes the
# whole-step path (ops.use_df_fused) at ns = 2, d = 3; the episode's launches
# are held in EXPECTED_LAUNCHES.
MC_HORIZON, MC_REPEAT, MC_WARMUP, MC_STEPS = 12, 5, 20, 21
MC_MAXFUN = 3

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.2f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def objective_and_grad(prob, cache, actions):
    """The planning objective and its gradient at fixed actions, on the cache
    cast as the planner casts it (split into df32 in mixed mode)."""
    a = actions.detach().clone().requires_grad_(True)
    cost, _ = _objective_and_info(prob.spec, _cast_cache(cache, prob.state_mu.dtype), a, prob.state_mu,
                                  prob.state_var, prob.action_prev, 0)
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


def event_ms(fn, reps=3, warmup=1) -> float:
    """Device-timeline ms per call between CUDA events around ``reps``
    back-to-back calls. For a plain version of thousands of small launches
    the card waits on the host between them, so this includes those gaps
    (it is what a caller of that version waits for)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(out, ref, scale=None) -> tuple[float, float]:
    """(max |out - ref|, that over max |scale|), scale defaulting to ref."""
    diff = float((out.double() - ref.double()).abs().max())
    s = ref if scale is None else scale
    return diff, diff / max(float(s.double().abs().max()), 1e-30)


def bound_ms(nbytes: float, flops: float, ops_per_s: float = H100_F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: bytes over HBM rate or operations
    over the card's peak rate for them, whichever is larger."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def launch_report(name, info, ms, bound, extra="") -> str:
    """One line on a redesigned kernel: its launch shape on this card (ptxas
    registers and spills, threads, resident blocks per SM, grid, waves), its
    device time against its bound, and its time before the redesign."""
    return (f"redesigned {name}: {info['registers']} registers, {info['spill_bytes']} spill bytes, "
            f"{info['threads']} threads, {info['blocks_per_sm']} blocks per SM, grid {info['grid']} on "
            f"{info['sms']} SMs = {info['waves']:.2f} waves; {ms:.4f} ms against its bound {bound:.5f} ms = "
            f"{bound / ms:.1%} of the bound{extra} (before: {REDESIGNED_BEFORE_MS[name]} ms)")


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30, check=True)
    return float(out.stdout.strip().splitlines()[0])


def df_op_instructions() -> SimpleNamespace:
    """f32 add, multiply and logic instructions of each df32 operation of
    csrc/df32.cuh (none may fuse into an FMA)."""
    two_sum, fast_two_sum = 6, 3
    two_prod = 2 * 2 + 4 + 2 * two_sum + 2 + fast_two_sum  # 2 splits, 4 products, 2 two_sums
    df_add = two_sum + 2 + fast_two_sum
    df_mul = two_prod + 4 + fast_two_sum
    return SimpleNamespace(
        two_sum=two_sum, fast_two_sum=fast_two_sum, two_prod=two_prod, df_add=df_add, df_mul=df_mul,
        df_add_f32=two_sum + 1 + fast_two_sum, df_mul_f32=two_prod + 2 + fast_two_sum,
        # rint(x / ln2), k ln2 in df, r = x - k ln2, 12 Horner steps, 2^k, 2 scales
        df_exp=2 + two_prod + 2 + fast_two_sum + df_add + 12 * (df_mul + df_add) + 5 + 2)


def df_instructions_per_element(ns: int) -> dict:
    """f32 add, multiply and logic instructions per slab element of the df32
    kernels, counted from csrc/df32.cuh and csrc/df_cov.cu (none may fuse
    into an FMA): per element of every pair, and the extra on the diagonal
    pairs (the iK terms)."""
    c = df_op_instructions()
    df_add, df_mul, df_mul_f32 = c.df_add, c.df_mul, c.df_mul_f32
    e = c.two_sum + 2 + c.fast_two_sum + ns * (df_mul + df_add) + 1 + c.df_exp
    # df_mm_bwd: G = E (bi bj gs (+ iK gco)), its row and column sums, and
    # both sides' sums weighted by Xj and U (collapsed coefficients)
    bwd = e + df_mul + df_mul_f32 + df_mul + 1 + 2 * df_add + 2 * ns * (df_mul_f32 + df_add)
    return {
        "df_fwd": (e + 2 * df_mul + df_add, df_mul + df_add),
        "df_fwdres": (e + 2 * df_mul + 2 * df_add + 2 * ns * (df_mul + df_add),
                      df_mul + 2 * df_add + 2 * ns * (df_mul + df_add)),
        # df_bwd, per element of each of the 2P stacked rows: w = bi bj gs
        # (+ iK gco), gE = w E, its sum and ns sums weighted by Xj (in df)
        "df_bwd": (e + 2 * df_mul + df_mul_f32 + df_add + ns * (df_mul + df_add), df_mul_f32 + df_add),
        "df_mm_full": (e + 2 * df_mul + df_add, df_mul + df_add),
        "df_mm_fwd": (e + 2 * df_mul + df_add, df_mul + df_add),
        "df_mm_bwd": (bwd, df_mul_f32 + df_add),
        "df_mm_bwd_pair": (bwd, df_mul_f32 + df_add),
    }


def mean_vjp_instructions(ns: int, d: int) -> int:
    """f32 instructions per (model, stored point) of the mean path's VJP
    (df_mm_bwd_mean, csrc/df_mm.cuh mean_point and df_mm_bwd.cu
    bwd_mean_tile): the point's forward quantities, then its df cotangents
    and their warp sums; none may fuse into an FMA."""
    c = df_op_instructions()
    fwd = (d * (c.df_add_f32 + c.df_mul) + ns * (ns * c.df_mul + (ns - 1) * c.df_add) + d * c.df_mul
           + (d - 1) * c.df_add + 2 + c.df_exp + c.df_mul)
    vjp = (d * (c.df_mul + 2 * c.two_prod + c.df_add + c.df_mul_f32 + 4) + 2 * c.df_mul_f32 + 2
           + d * (2 * c.df_mul_f32 + c.df_add) + ns * ns * (2 * c.df_mul_f32 + c.df_add) + (d - ns) * c.df_add
           + d * c.df_mul_f32 + (d + ns * ns) * c.df_add)
    return fwd + vjp


class _Depth:
    """An f32 value by its depth: the longest chain of dependent f32
    instructions that computes it (a load or a constant has depth 0)."""

    __slots__ = ("d",)

    def __init__(self, d=0):
        self.d = d

    def op(self, *others):
        return _Depth(1 + max([self.d] + [o.d for o in others if isinstance(o, _Depth)]))

    def __add__(self, o):
        return self.op(o)

    __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = __add__

    def __neg__(self):  # a sign flip folds into the instruction that reads it
        return self


def _one(a):
    """One dependent instruction on a (a mask, a conversion, a min or a shuffle)."""
    return a.op() if isinstance(a, _Depth) else a


def df_op_depths() -> SimpleNamespace:
    """The df32 operations of csrc/df32.cuh on _Depth values, in their
    instruction order: what a lane's dependent chain through them is."""

    def two_sum(a, b):
        s = a + b
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    def fast_two_sum(a, b):
        s = a + b
        return s, b - (s - a)

    def two_prod(a, b):
        ah, bh = _one(a), _one(b)
        al, bl = a - ah, b - bh
        s = two_sum(ah * bl, al * bh)
        p = two_sum(ah * bh, s[0])
        return fast_two_sum(p[0], (s[1] + p[1]) + al * bl)

    def df_add(x, y):
        s = two_sum(x[0], y[0])
        return fast_two_sum(s[0], s[1] + (x[1] + y[1]))

    def df_add_f32(x, y):
        s = two_sum(x[0], y)
        return fast_two_sum(s[0], s[1] + x[1])

    def df_mul(x, y):
        p = two_prod(x[0], y[0])
        return fast_two_sum(p[0], p[1] + (x[0] * y[1] + x[1] * y[0]))

    def df_mul_f32(x, y):
        p = two_prod(x[0], y)
        return fast_two_sum(p[0], p[1] + x[1] * y)

    def df_exp(x):
        k = _one(x[0] * 1.4426950)
        t = two_prod(k, 0.6931472)
        t = fast_two_sum(t[0], t[1] + k * -1.9046e-9)
        r = df_add(x, (-t[0], -t[1]))
        e = (0.0, 0.0)
        for _ in range(12):
            e = df_add(df_mul(e, r), (0.0, 0.0))
        scale = _one(_one(_one(k)))
        return e[0] * scale, e[1] * scale

    return SimpleNamespace(two_prod=two_prod, df_add=df_add, df_add_f32=df_add_f32, df_mul=df_mul,
                           df_mul_f32=df_mul_f32, df_exp=df_exp, collapse=lambda x: x[0] + x[1])


def mean_vjp_chain(ns: int, d: int, n: int) -> int:
    """The dependent chain of #10 (df_mm_bwd_mean) in f32 instructions: one
    lane's mean_point and VJP (csrc/df_mm.cuh, df_mm_bwd.cu mean_item), the
    warp sums of its outputs (a shuffle and a df add per level), then block
    0's sequential sum over the ns ceil(N / 32) items. Loads count 0, so the
    chain times the instruction latency is a floor on the launch's time."""
    o = df_op_depths()
    ld, f = (lambda: (_Depth(), _Depth())), _Depth
    i_n = [o.df_mul(o.df_add_f32(ld(), f()), ld()) for _ in range(d)]
    t = []
    for _ in range(ns):
        acc = o.df_mul(i_n[0], ld())
        for k in range(1, ns):
            acc = o.df_add(acc, o.df_mul(i_n[k], ld()))
        t.append(acc)
    t += i_n[ns:]
    ex = o.df_mul(i_n[0], t[0])
    for e in range(1, d):
        ex = o.df_add(ex, o.df_mul(i_n[e], t[e]))
    q = o.df_exp((_one(ex[0] * -0.5), ex[1] * -0.5))
    lb = o.df_mul(q, ld())
    lb_c, q_c, beta_c = o.collapse(lb), o.collapse(q), o.collapse(ld())
    g_lb, g_t, ils_c = (f(), 0.0), [], []
    for e in range(d):
        ils = ld()
        ils_c.append(o.collapse(ils))
        g_lb = o.df_add(g_lb, o.two_prod(f(), o.collapse(o.df_mul(t[e], ils))))
        g_t.append(o.df_mul_f32(o.two_prod(f(), lb_c), ils_c[e]))
    g_ex = o.df_mul_f32(o.df_mul_f32(g_lb, beta_c), q_c)
    g_ex = (g_ex[0] * -0.5, g_ex[1] * -0.5)
    g_i = [o.df_mul_f32(g_ex, o.collapse(t[e])) for e in range(d)]
    g_t = [o.df_add(g_t[e], o.df_mul_f32(g_ex, o.collapse(i_n[e]))) for e in range(d)]
    g_b = []
    for j in range(ns):
        for k in range(ns):
            g_i[k] = o.df_add(g_i[k], o.df_mul_f32(g_t[j], o.collapse(ld())))
            g_b.append(o.df_mul_f32(g_t[j], o.collapse(i_n[k])))
    for e in range(ns, d):
        g_i[e] = o.df_add(g_i[e], g_t[e])
    lane = 0
    for x in [o.df_mul_f32(g_i[e], ils_c[e]) for e in range(d)] + g_b:
        for _ in range(5):
            x = o.df_add(x, (_one(x[0]), _one(x[1])))
        lane = max(lane, x[0].d, x[1].d)
    acc = (0.0, 0.0)
    for _ in range(ns * -(-n // 32)):
        acc = o.df_add(acc, ld())
    return lane + max(acc[0].d, acc[1].d)


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
    dispatch = gp_mod._cov_core

    def record(*args):
        seen.append(args)
        return dispatch(*args)

    gp_mod._cov_core = record
    try:
        with torch.no_grad():
            _objective_and_info(prob.spec, cache, prob.inits[0], prob.state_mu,
                                prob.state_var, prob.action_prev, 0)
    finally:
        gp_mod._cov_core = dispatch
    *tensors, diag_pos = seen[-1]
    return [t.to(device=device, dtype=torch.float32).contiguous() for t in tensors], tuple(diag_pos)


def check_kernels(dev):
    """Each f32 kernel against its plain version on the card at flagship shapes."""
    results = {}
    prob = flagship_problem(dev, torch.float32)
    ls, outs, _ = constrained_params(prob.params, prob.bounds)
    x = torch.as_tensor(prob.x, dtype=torch.float32, device=dev)
    ns, d = ls.shape
    n = x.shape[0]

    floor = launch_floor()
    log("kernel launch floor (device ms per call of a launch that does nothing): " + ", ".join(
        f"{name} {ms:.5f}" for name, ms in floor.items()))
    floor_dep = floor[f"empty {_build.sm_count(dev)}x256 programmatic dependent"]

    abs_e = check_gram("flagship", ls, outs, x)
    n_rag = ragged_n(lambda m: gram_mod.launch_plan(ns, m, _build.sm_count(dev))["rows"])
    rng = np.random.default_rng(n_rag)
    abs_e = max(abs_e, check_gram(f"random N={n_rag}", *(torch.tensor(v, dtype=torch.float32, device=dev) for v in (
        rng.uniform(0.3, 2.0, (ns, d)), rng.uniform(0.02, 0.4, ns), rng.uniform(0, 1, (n_rag, d))))))
    ms, host = cuda_ms(lambda: gram_mod.gram(ls, outs, x))
    plain, _ = cuda_ms(lambda: gram_mod.gram_ref(ls, outs, x))
    b, by = bound_ms(4 * (ns * d + ns + n * d + ns * n * n), ns * n * n * (8 * d + 6))
    log(f"kernel gram ({ns}x{n}x{n}): kernel {ms:.4f} ms plain {plain:.4f} ms bound {b:.5f} ms ({by}); "
        f"host {host:.4f} ms per call")
    results["gram"] = dict(err=abs_e, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    results["gram"]["report"] = launch_report("gram", gram_mod.launch_info(ns, n), ms, b, floor_extra(ms, floor_dep))
    log("kernel " + results["gram"]["report"])
    both, fill = after_torch_op_ms(lambda: gram_mod.gram(ls, outs, x), torch.empty(ns, n, n, device=dev))
    log(f"kernel gram after a PyTorch kernel (a fill_ of its size, as on the refresh path): {both:.4f} ms "
        f"against the fill_ alone {fill:.4f}: {both - fill:.4f} ms for the gram")

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
    b, by = cov_fwd_bound(p, n, ns_, nd)
    log(f"kernel cov_fwd (P={p}, N={n}, ns={ns_}): wrapper {ms:.4f} ms (device, 2 launches) plain {plain:.4f} ms "
        f"bound {b:.5f} ms ({by}); host {host:.4f} ms per call")
    results["cov_fwd"] = dict(err=err_fwd, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    results["cov_fwd"]["report"] = launch_report("cov_fwd", moment_cov.fwd_launch_info(p, n, ns_), ms, b)
    log("kernel " + results["cov_fwd"]["report"])
    n32 = random_cov_operands(dev, p, ACC_BUCKET, ns_, diag_pos, seed=ACC_BUCKET)
    check_cov_fwd("random N=32", n32, diag_pos)
    ms32, _ = cuda_ms(lambda: moment_cov.cov_fwd(*n32, diag_pos))
    log(f"kernel cov_fwd (P={p}, N={ACC_BUCKET}, ns={ns_}, random operands): wrapper {ms32:.4f} ms (device) "
        f"bound {cov_fwd_bound(p, ACC_BUCKET, ns_, nd)[0]:.5f} ms")

    g = torch.linspace(1.0, 2.0, p, device=dev)
    g_corr = torch.linspace(1.0, 3.0, nd, device=dev)
    ms, host = cuda_ms(lambda: moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, diag_pos))
    plain, _ = cuda_ms(lambda: moment_cov.cov_bwd_plain(g, a, c, u, xj, bi, bj, ik, g_corr, diag_pos))
    # both sides: the operands and iK read once, the six gradients written once
    b, by = bound_ms(4 * (p + nd + 4 * p * n + 2 * p * n * ns_ + nd * n * n + 4 * p * n + 2 * p * n * ns_),
                     2 * (p * n * n * (4 * ns_ + 8) + nd * n * n * 3))
    log(f"kernel cov_bwd_row (both sides, one launch): kernel {ms:.4f} ms plain {plain:.4f} ms "
        f"bound {b:.5f} ms ({by}); host {host:.4f} ms per call")
    results["cov_bwd_row"] = dict(err=err_bwd, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    results["cov_bwd_row"]["report"] = launch_report("cov_bwd_row", moment_cov.bwd_launch_info(p, n, ns_), ms, b)
    log("kernel " + results["cov_bwd_row"]["report"])

    err_gik = max(check_cov_gik("flagship", cov_flag, diag_pos), check_cov_gik("random", cov_rand, diag_pos))
    # rectangular slabs the flagship path never sends: Nc % 4 != 0, Nr not a
    # whole number of the plan's bands, each diagonal pair its own E
    nc_rect = 301
    nr_rect = ragged_n(lambda m: moment_cov.gik_launch_plan(nd, m, nc_rect, _build.sm_count(dev))["rows"], start=203)
    rect = random_gik_operands(dev, p, nr_rect, nc_rect, ns_, seed=nr_rect)
    err_gik = max(err_gik, check_cov_gik_kernel(f"random {nr_rect}x{nc_rect}", rect, diag_pos))
    g_corr = torch.linspace(1.0, 3.0, nd, device=dev)
    ms, host = cuda_ms(lambda: moment_cov.cov_gik(g_corr, a, c, u, xj, diag_pos))
    plain, _ = cuda_ms(lambda: moment_cov.cov_gik_plain(g_corr, a, c, u, xj, diag_pos))
    b, by = bound_ms(4 * (nd + nd * (2 * n + 2 * n * ns_) + nd * n * n), nd * n * n * (2 * ns_ + 3))
    log(f"kernel cov_gik (Ns={nd}, N={n}, ns={ns_}): kernel {ms:.4f} ms plain {plain:.4f} ms "
        f"bound {b:.5f} ms ({by}); host {host:.4f} ms per call")
    results["cov_gik"] = dict(err=err_gik, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    results["cov_gik"]["report"] = launch_report("cov_gik", moment_cov.gik_launch_info(nd, n, n, ns_), ms, b,
                                                 floor_extra(ms, floor_dep))
    log("kernel " + results["cov_gik"]["report"])
    # CovCore.backward's pair: cov_bwd, then cov_gik as its programmatic dependent
    both, _ = cuda_ms(lambda: (moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, diag_pos),
                               moment_cov.cov_gik(g_corr, a, c, u, xj, diag_pos)))
    log(f"kernel cov_bwd then cov_gik (CovCore.backward with an iK gradient): {both:.4f} ms (device) against "
        f"{results['cov_bwd_row']['ms']:.4f} + {ms:.4f} apart; the programmatic-dependent launch floor "
        f"{floor_dep:.5f} ms")
    return results


def launch_floor() -> dict:
    """Device ms per call of launches that do nothing (the launch floor,
    which no kernel's design can remove): ``torch.cuda._sleep(1)``, and an
    empty kernel of one block of 32 threads and of one wave of 256-thread
    blocks, launched plainly and as a programmatic dependent, each timed by
    cuda_ms as the kernels are."""
    sms = _build.sm_count(torch.device("cuda"))
    calls = {"torch.cuda._sleep(1)": lambda: torch.cuda._sleep(1)}
    for blocks, threads in ((1, 32), (sms, 256)):
        for dependent in (False, True):
            kind = "programmatic dependent" if dependent else "plain"
            calls[f"empty {blocks}x{threads} {kind}"] = (
                lambda b=blocks, t=threads, d=dependent: _build.empty_launch(b, t, d))
    return {name: cuda_ms(fn)[0] for name, fn in calls.items()}


def after_torch_op_ms(fn, like) -> tuple[float, float]:
    """(device ms per call of a plain PyTorch kernel (``like.fill_``, as a
    PyTorch op precedes the Gram on the refresh path) then fn, that of the
    fill alone): their difference is fn's cost on such a path."""
    return cuda_ms(lambda: (like.fill_(1.0), fn()))[0], cuda_ms(lambda: like.fill_(1.0))[0]


def floor_extra(ms, floor) -> str:
    """A redesigned kernel's time against the launch floor of its kind of
    launch (programmatic dependent), for launch_report."""
    return f"; programmatic-dependent launch floor {floor:.5f} ms = {floor / ms:.1%} of it"


def ragged_n(rows_at, start=301) -> int:
    """The largest N <= start with N % 4 != 0 and N not a whole number of
    the bands of rows_at(N) rows: a ragged row end and a short last band."""
    for m in range(start, 4, -1):
        if m % 4 and m % rows_at(m):
            return m
    raise AssertionError("ragged_n: no ragged size below start")


def check_gram(label, ls, outs, x) -> float:
    """The Gram kernel against gram_ref elementwise (GRAM_RTOL, GRAM_ATOL),
    called twice for bitwise repeats."""
    k_out = gram_mod.gram(ls, outs, x)
    k_ref = gram_mod.gram_ref(ls, outs, x)
    excess = float(((k_out - k_ref).abs() - (GRAM_ATOL + GRAM_RTOL * k_ref.abs())).max())
    abs_e, rel_e = max_err(k_out, k_ref)
    log(f"kernel gram [{label}] ({ls.shape[0]}x{x.shape[0]}x{x.shape[0]}, d={x.shape[1]}): max abs err "
        f"{abs_e:.3e} rel {rel_e:.3e} (tol atol {GRAM_ATOL} + rtol {GRAM_RTOL})")
    if not excess <= 0.0:
        raise AssertionError(f"gram kernel [{label}] disagrees with gram_ref: max abs err {abs_e:.3e}")
    hold_repeat("gram", label, (k_out,), (gram_mod.gram(ls, outs, x),))
    return abs_e


def cov_fwd_bound(p, n, ns, nd) -> tuple[float, str]:
    """cov_fwd's bound: its operands and outputs once, 2 ns + 5 f32
    operations per element and 2 more on the diagonal pairs."""
    return bound_ms(4 * (4 * p * n + 2 * p * n * ns + nd * n * n + nd + p + nd),
                    p * n * n * (2 * ns + 5) + nd * n * n * 2)


def hold_gik(what, label, out, ref, g_corr, expo_abs) -> float:
    """Hold an iK gradient elementwise to GIK_RTOL (1 + sum|exponent terms|)
    of itself, plus |g_corr| 2^-126 (see GIK_RTOL)."""
    diff = (out.double() - ref.double()).abs()
    tol = GIK_RTOL * (1.0 + expo_abs.double()) * ref.double().abs() + g_corr.double().abs()[:, None, None] * 2.0 ** -126
    worst = float((diff / tol).max())
    log(f"kernel {what} [{label}]: max abs err {float(diff.max()):.3e}, {worst:.3e} of its elementwise tolerance "
        f"(GIK_RTOL {GIK_RTOL:.2e} (1 + sum|exponent terms|) |ref|); max |ref| {float(ref.abs().max()):.4g}")
    if not worst <= 1.0:
        raise AssertionError(f"{what} [{label}] disagrees with its plain version")
    return float(diff.max())


def check_cov_gik_kernel(label, operands, diag_pos) -> float:
    """The iK-gradient kernel against its plain twin, called twice for
    bitwise repeats (any Nr x Nc slabs)."""
    a, c, u, xj = operands[:4]
    expo = moment_cov.cov_gik_expo_abs(a, c, u, xj, diag_pos)
    g_corr = torch.linspace(1.0, -2.0, len(diag_pos), device=a.device)
    out = moment_cov.cov_gik(g_corr, a, c, u, xj, diag_pos)
    err = hold_gik("cov_gik", label, out, moment_cov.cov_gik_plain(g_corr, a, c, u, xj, diag_pos), g_corr, expo)
    hold_repeat("cov_gik", label, (out,), (moment_cov.cov_gik(g_corr, a, c, u, xj, diag_pos),))
    return err


def check_cov_gik(label, operands, diag_pos) -> float:
    """The iK-gradient kernel against its plain twin, and CovCore's iK
    gradient (which launches it) against autograd of the plain core."""
    a, c, u, xj, bi, bj, ik = operands
    p, nd = a.shape[0], len(diag_pos)
    expo = moment_cov.cov_gik_expo_abs(a, c, u, xj, diag_pos)
    err = check_cov_gik_kernel(label, operands, diag_pos)
    w_s = torch.linspace(1.0, 2.0, p, device=a.device)
    w_c = torch.linspace(1.0, 3.0, nd, device=a.device)

    def ik_grad(core):
        leaf = ik.clone().requires_grad_(True)
        s, co = core(a, c, u, xj, bi, bj, leaf, diag_pos)
        return torch.autograd.grad((s * w_s).sum() + (co * w_c).sum(), leaf)[0]

    return max(err, hold_gik("cov_gik via CovCore iK gradient", label, ik_grad(moment_cov.CovCore.apply),
                             ik_grad(moment_cov.cov_core_ref), w_c, expo))


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


def random_gik_operands(dev, p, nr, nc, ns, seed):
    """The iK gradient's operands (a, c, U, Xj) of Nr rows and Nc columns,
    drawn as random_cov_operands draws them: each pair its own E."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(-2, 0.5, (p, nr)), rng.normal(-2, 0.5, (p, nc)), rng.normal(0, 0.3, (p, nr, ns)),
              rng.normal(0, 0.3, (p, nc, ns)))
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
    err = max(hold_cov("cov_fwd S_p", label, s_k, s_r, s_abs), hold_cov("cov_fwd corr", label, co_k, co_r, co_abs))
    hold_repeat("cov_fwd", label, (s_k, co_k), moment_cov.cov_fwd(*operands, diag_pos))
    return err


def hold_repeat(what, label, first, again) -> None:
    """A kernel whose cross-block sums run in a fixed order repeats bitwise."""
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"{what} [{label}]: two calls differ (its sums are not in a fixed order)")


def check_cov_bwd(label, operands, diag_pos) -> float:
    """The two-side backward kernel against its plain twin (the two one-side
    calls), called twice for bitwise repeats; then the row and column sides
    through autograd of CovCore, against autograd of the plain core; the
    leaves are a, c, U, Xj, bi and bj."""
    a, c, u, xj, bi, bj, ik = operands
    p, nd = a.shape[0], len(diag_pos)
    w_s = torch.linspace(1.0, 2.0, p, device=a.device)
    w_c = torch.linspace(1.0, 3.0, nd, device=a.device)
    gco = _scatter_diag(w_c, p, diag_pos)
    row = moment_cov.cov_bwd_row_abs_terms(w_s, a, c, u, xj, bi, bj, ik, gco, diag_pos)
    col = moment_cov.cov_bwd_row_abs_terms(w_s, c, a, xj, u, bj, bi, ik.transpose(1, 2), gco, diag_pos)
    scales = (row[0], col[0], row[1], col[1], row[2], col[2])
    names = ("ga", "gc", "gU", "gXj", "gbi", "gbj")
    out = moment_cov.cov_bwd(w_s, a, c, u, xj, bi, bj, ik, w_c, diag_pos)
    ref = moment_cov.cov_bwd_plain(w_s, a, c, u, xj, bi, bj, ik, w_c, diag_pos)
    err = max(hold_cov(f"cov_bwd_row kernel {name}", label, o, r, scale)
              for name, o, r, scale in zip(names, out, ref, scales))
    hold_repeat("cov_bwd_row", label, out, moment_cov.cov_bwd(w_s, a, c, u, xj, bi, bj, ik, w_c, diag_pos))

    def grads(core):
        leaves = [t.clone().requires_grad_(True) for t in (a, c, u, xj, bi, bj)]
        s, co = core(*leaves, ik, diag_pos)
        return torch.autograd.grad((s * w_s).sum() + (co * w_c).sum(), leaves)

    g_k = grads(moment_cov.CovCore.apply)
    g_r = grads(moment_cov.cov_core_ref)
    return max(err, max(hold_cov(f"cov_bwd_row via CovCore {name}", label, o, r, scale)
                        for name, o, r, scale in zip(names, g_k, g_r, scales)))


def trained_gp_df_operands(dev):
    """The df cov-core operands of the last (15th) rollout step of the
    trained-GP flagship in mixed mode at the initial actions, recorded on the
    card from the dispatch (the lean forward kernel serves that rollout)."""
    prob = trained_gp_problem(dev)
    cache = Planner(prob.spec, dtype=torch.float32, device=dev, master_dtype=torch.float64).refresh_cache(
        prob.x, prob.y, prob.mask, prob.params, prob.bounds)
    seen = []
    dispatch = ops.df_cov_core

    def record(*args):
        seen.append(args)
        return dispatch(*args)

    gp_mod.ops.df_cov_core = record
    try:
        with torch.no_grad():
            _objective_and_info(prob.spec, _cast_cache(cache, torch.float32), prob.inits[0], prob.state_mu,
                                prob.state_var, prob.action_prev, 0)
    finally:
        gp_mod.ops.df_cov_core = dispatch
    *tensors, diag_pos = seen[-1]
    return [t.contiguous() for t in tensors], tuple(diag_pos)


def random_df_operands(dev, p, n, ns, diag_pos, seed=1):
    """df operands of the flagship's shapes whose outputs do not cancel (f64
    draws split into f32 halves): every output is at least MIN_RESOLVED of
    its sum of |terms|."""
    rng = np.random.default_rng(seed)
    ikh = rng.normal(0, 0.1, (len(diag_pos), n, n))
    draws = (rng.normal(-2, 0.5, (p, n)), rng.normal(-2, 0.5, (p, n)), rng.normal(0, 0.3, (p, n, ns)),
             rng.normal(0, 0.3, (p, n, ns)), rng.normal(0, 1, (p, n)), rng.normal(0, 1, (p, n)),
             (ikh + ikh.transpose(0, 2, 1)) / 2)
    out = []
    for x in draws:
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        out += [torch.tensor(hi, device=dev), torch.tensor(lo, device=dev)]
    return out


def hold_df(what, label, out_h, out_l, ref_h, ref_l, scale) -> float:
    """Hold one df output (hi + lo, in f64) to DF_TOL of its largest sum of
    |terms|; on the random operands also require it to be resolvable."""
    out = out_h.double() + out_l.double()
    ref = ref_h.double() + ref_l.double()
    abs_e, rel_e = max_err(out, ref, scale)
    resolved = float(ref.abs().max()) / max(float(scale.abs().max()), 1e-300)
    log(f"kernel {what} [{label}]: max abs err {abs_e:.3e} = {rel_e:.3e} of max sum|terms| "
        f"{float(scale.abs().max()):.4g} (tol {DF_TOL}); max |ref| {float(ref.abs().max()):.4g} "
        f"= {resolved:.3e} of it")
    if not rel_e <= DF_TOL:
        raise AssertionError(f"{what} [{label}] disagrees with its plain version")
    if label == "random" and float(scale.abs().max()) > 0 and not resolved >= MIN_RESOLVED:
        raise AssertionError(f"{what} [random]: output {resolved:.3e} of its scale, not resolvable")
    return abs_e


def check_df_operands(label, args, diag_pos) -> tuple[float, float]:
    """Both df kernels against their plain twins on one operand set, and
    DfCovCore's gradients (the residual kernel and the df backward) against
    autograd through the plain core. Returns (fwd err, fwdres err)."""
    (s_abs, co_abs), (row_abs, col_abs) = df_cov.df_cov_abs_terms(*args, diag_pos)
    out = df_cov.df_cov_fwd(*args, diag_pos)
    ref = df_cov.df_cov_fwd_plain(*args, diag_pos)
    err_fwd = max(hold_df("df_fwd S_p", label, out[0], out[1], ref[0], ref[1], s_abs),
                  hold_df("df_fwd corr", label, out[2], out[3], ref[2], ref[3], co_abs))
    hold_repeat("df_fwd", label, out, df_cov.df_cov_fwd(*args, diag_pos))
    rows, cols = df_cov.df_cov_fwdres(*args, diag_pos)
    rows_r, cols_r = df_cov.df_cov_fwdres_plain(*args, diag_pos)
    names = ["A1", "A2"] + [f"B1_{e}" for e in range(3)] + [f"B2_{e}" for e in range(3)]
    names_c = ["C1", "C2"] + [f"D1_{e}" for e in range(3)] + [f"D2_{e}" for e in range(3)]
    err_res = 0.0
    for outs, refs, scales, nm in ((rows, rows_r, row_abs, names), (cols, cols_r, col_abs, names_c)):
        for k in range(0, len(outs), 2):
            err_res = max(err_res, hold_df(f"df_fwdres {nm[k // 2]}", label, outs[k], outs[k + 1],
                                           refs[k], refs[k + 1], scales[k]))
    if label == "random":
        p = args[0].shape[0]
        w = torch.linspace(1.0, 2.0, p, device=args[0].device)
        wc = torch.linspace(1.0, 3.0, len(diag_pos), device=args[0].device)

        def grads(core):
            a = [t.clone() for t in args]
            leaves = [a[i].requires_grad_(True) for i in (0, 2, 4, 6)]
            sh, sl, ch, cl = core(*a, diag_pos)
            return torch.autograd.grad((w * (sh + sl)).sum() + (wc * (ch + cl)).sum(), leaves)

        for name, g, r in zip(("ga", "gc", "gU", "gXj"), grads(df_cov.DfCovCore.apply),
                              grads(df_cov.df_cov_core_ref)):
            hold_grad(f"df_fwdres via DfCovCore {name}, against autograd of the plain core", label, g, r)
    return err_fwd, err_res


def check_df_kernels(dev):
    """The two df32 kernels against their plain twins on the card: on the
    trained-GP flagship's operands and on random operands of its shapes."""
    flag, diag_pos = trained_gp_df_operands(dev)
    p, n = flag[0].shape
    ns = flag[4].shape[2]
    rand = random_df_operands(dev, p, n, ns, diag_pos)
    errs = [check_df_operands("flagship", flag, diag_pos), check_df_operands("random", rand, diag_pos)]
    results = {}
    counts = df_instructions_per_element(ns)
    nd = len(diag_pos)
    in_bytes = 4 * 2 * (4 * p * n + 2 * p * n * ns + nd * n * n)
    for i, (name, kern, plain) in enumerate((("df_fwd", df_cov.df_cov_fwd, df_cov.df_cov_fwd_plain),
                                            ("df_fwdres", df_cov.df_cov_fwdres, df_cov.df_cov_fwdres_plain))):
        ms, host = cuda_ms(lambda: kern(*flag, diag_pos))
        plain_ms = event_ms(lambda: plain(*flag, diag_pos))
        per, per_diag = counts[name]
        out_bytes = 4 * 2 * (2 * p + nd) if name == "df_fwd" else 4 * 2 * 2 * (2 + 2 * ns) * p * n
        b, by = bound_ms(in_bytes + out_bytes, (p * per + nd * per_diag) * n * n, H100_F32_INSTR_PER_S)
        log(f"kernel {name} (P={p}, N={n}, ns={ns}): wrapper {ms:.4f} ms (device, kernel + summing launch) "
            f"plain {plain_ms:.4f} ms bound {b:.5f} ms ({by}: {per} + {per_diag} on diagonal pairs f32 "
            f"instructions per element over {H100_F32_INSTR_PER_S:.3g}/s); host {host:.4f} ms per call")
        results[name] = dict(err=max(e[i] for e in errs), ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)
    results["df_fwdres"]["report"] = launch_report("df_fwdres", df_cov.fwdres_launch_info(p, n, nd, ns),
                                                   results["df_fwdres"]["ms"], results["df_fwdres"]["bound_ms"])
    log("kernel " + results["df_fwdres"]["report"])
    results["df_fwd"]["report"] = launch_report("df_fwd", df_cov.fwd_launch_info(p, n, diag_pos, ns),
                                                results["df_fwd"]["ms"], results["df_fwd"]["bound_ms"])
    log("kernel " + results["df_fwd"]["report"])

    # the stacked backward on the flagship's operands and random ones at 384,
    # and random ones at 96 (tests/test_torch_cuda.py adds ragged N)
    err_bwd = max(check_df_bwd("flagship", flag, diag_pos), check_df_bwd("random", rand, diag_pos),
                  check_df_bwd("random N=96", random_df_operands(dev, p, 96, ns, diag_pos, seed=2), diag_pos))
    gs = torch.linspace(1.0, 2.0, p, device=dev)
    gco = _scatter_diag(torch.linspace(1.0, 3.0, nd, device=dev), p, diag_pos)
    ms, host = cuda_ms(lambda: df_cov.df_cov_bwd(*flag, gs, gco, diag_pos))
    plain_ms = event_ms(lambda: df_cov.df_cov_bwd_plain(*flag, gs, gco, diag_pos))
    per, per_diag = counts["df_bwd"]
    b, by = bound_ms(in_bytes + 4 * 2 * p + 4 * 2 * p * n * (1 + ns), 2 * (p * per + nd * per_diag) * n * n,
                     H100_F32_INSTR_PER_S)
    log(f"kernel df_bwd (2P={2 * p} stacked rows, N={n}, ns={ns}): kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"bound {b:.5f} ms ({by}: {per} + {per_diag} on diagonal pairs f32 instructions per element of each side "
        f"over {H100_F32_INSTR_PER_S:.3g}/s); host {host:.4f} ms per call")
    results["df_bwd"] = dict(err=err_bwd, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)
    return results


def check_df_bwd(label, args, diag_pos) -> float:
    """The stacked backward kernel against its plain twin (ga and gU of both
    sides, DF_GRAD_TOL of each output's largest entry), and the stacked
    composite's gradients (lean forward, then this kernel) against the
    residual composite's (DfCovCore): the same VJP, to the same tolerance."""
    p, nd = args[0].shape[0], len(diag_pos)
    dev = args[0].device
    w = torch.linspace(1.0, 2.0, p, device=dev)
    wc = torch.linspace(1.0, 3.0, nd, device=dev)
    out = df_cov.df_cov_bwd(*args, w, _scatter_diag(wc, p, diag_pos), diag_pos)
    ref = df_cov.df_cov_bwd_plain(*args, w, _scatter_diag(wc, p, diag_pos), diag_pos)

    def grads(core):
        a = [t.clone() for t in args]
        leaves = [a[i].requires_grad_(True) for i in (0, 2, 4, 6)]
        sh, sl, ch, cl = core(*a, diag_pos)
        return torch.autograd.grad((w * (sh + sl)).sum() + (wc * (ch + cl)).sum(), leaves)

    errs = [hold_grad(f"df_bwd {nm}", label, o, r) for nm, o, r in zip(("ga", "gU"), out, ref)]
    for nm, o, r in zip(("ga", "gc", "gU", "gXj"), grads(df_cov.DfCovCoreStacked.apply), grads(df_cov.DfCovCore.apply)):
        hold_grad(f"df_bwd via DfCovCoreStacked {nm}, against DfCovCore", label, o, r)
    return max(errs)


def hold_grad(what, label, out, ref) -> float:
    """Hold a gradient to DF_GRAD_TOL of its largest entry."""
    abs_e, rel_e = max_err(out, ref)
    log(f"kernel {what} [{label}]: max abs err {abs_e:.3e} = {rel_e:.3e} of max |grad| (tol {DF_GRAD_TOL})")
    if not rel_e <= DF_GRAD_TOL:
        raise AssertionError(f"{what} [{label}] disagrees")
    return abs_e


def trained_gp_step_inputs(dev, n):
    """The whole-step operands of the 15th rollout step of the trained-GP
    problem cut to the n bucket (0.8 n points, at most 300), in mixed mode at
    the initial actions: the df32 cache (its f64 master refreshed on the
    card) and the step's input mean and state covariance, recorded from the
    rollout's dispatch."""
    prob = trained_gp_problem(dev, n_points=min(300, int(0.8 * n)), bucket=n)
    cache = _cast_cache(Planner(prob.spec, dtype=torch.float32, device=dev, master_dtype=torch.float64)
                        .refresh_cache(prob.x, prob.y, prob.mask, prob.params, prob.bounds), torch.float32)
    seen = []
    originals = {name: getattr(gp_mod, name) for name in ("moment_match_df", "moment_match_df_fused")}

    def recorder(fn):
        def record(c, mu, var):
            seen.append((mu, var))
            return fn(c, mu, var)
        return record

    for name, fn in originals.items():
        setattr(gp_mod, name, recorder(fn))
    try:
        with torch.no_grad():
            _objective_and_info(prob.spec, cache, prob.inits[0], prob.state_mu, prob.state_var, prob.action_prev, 0)
    finally:
        for name, fn in originals.items():
            setattr(gp_mod, name, fn)
    mu, var = seen[-1]
    ns = cache.ils_hi.shape[0]
    return cache, mu.float().contiguous(), var[:ns, :ns].float().contiguous()


def random_df_mm_problem(dev, n, seed, ns=3, d=4):
    """A random cache of the trained-GP problem's widths (f64 draws split
    into f32 halves) whose raw outputs do not cancel: each at least
    MIN_RESOLVED of its sum of |terms|. Returns (cache, mu, sv)."""
    rng = np.random.default_rng(seed)

    def split(x):
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        return torch.tensor(hi, device=dev), torch.tensor(lo, device=dev)

    ils = 1.0 / rng.uniform(0.3, 0.8, (ns, d))
    ik = rng.normal(0, 0.1, (ns, n, n))
    outs = rng.uniform(0.5, 1.0, ns)
    f = {}
    for name, x in (("x", rng.uniform(0, 1, (n, d))), ("ils", ils), ("ils2", ils * ils), ("log_outs", np.log(outs)),
                    ("beta", rng.normal(0, 1, (ns, n))), ("iK", (ik + ik.transpose(0, 2, 1)) / 2)):
        f[f"{name}_hi"], f[f"{name}_lo"] = split(x)
    cache = SimpleNamespace(outs=torch.tensor(outs, dtype=torch.float32, device=dev), **f)
    mu = torch.tensor(rng.uniform(0.3, 0.7, d), dtype=torch.float32, device=dev)
    sv = torch.tensor(np.eye(ns) * 1e-2 + 2e-3, dtype=torch.float32, device=dev)
    return cache, mu, sv


def check_df_mm_operands(label, cache, mu, sv) -> tuple[float, float, float]:
    """The three whole-step kernels against their plain twins on one operand
    set: #12's final outputs (FULL_TOL), #8's raw df partials (DF_TOL of
    each output's sum of |terms|) and #9's gradients (DF_GRAD_TOL of the
    largest entry, at fixed cotangents). Returns the three max abs errors."""
    ns, d = cache.ils_hi.shape
    n = cache.x_hi.shape[0]
    ii, jj, diag, _ = df_mm.pair_indices(ns, mu.device)
    Bh, Bl, c32, Qh, Ql, sdr = df_mm.df_stage1(cache, sv, ii, jj)
    m_abs, v_abs, sp_abs, co_abs = df_mm.abs_terms(mu, Bh, Bl, Qh, Ql, cache)

    raw = df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache)
    ref = df_mm.stage23_plain(mu, Bh, Bl, Qh, Ql, cache)
    err_fwd = max(hold_df(f"df_mm_fwd {nm} (N={n})", label, raw[2 * k], raw[2 * k + 1], ref[2 * k], ref[2 * k + 1],
                          scale)
                  for k, (nm, scale) in enumerate(zip(("M", "V", "S_p", "corr"), (m_abs, v_abs, sp_abs, co_abs))))
    hold_repeat(f"df_mm_fwd (N={n})", label, raw, df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache))

    out = df_mm.full_step_fwd(mu, sv, cache)
    hold_repeat(f"df_mm_full (N={n})", label, out, df_mm.full_step_fwd(mu, sv, cache))
    ref = df_mm.full_step_plain(mu, sv, cache)
    sp_scale = (sp_abs + torch.zeros_like(sp_abs).index_add(0, diag, co_abs)) / sdr.double()
    err_full, worst = 0.0, 0.0
    for nm, o, r, scale in zip(("M", "V", "S_p"), out, ref,
                               (m_abs * c32.double(), v_abs * c32.double()[:, None], sp_scale)):
        diff = (o.double() - r.double()).abs()
        excess = float((diff / (FULL_EPS * r.double().abs() + DF_TOL * scale)).max())
        err_full, worst = max(err_full, float(diff.max())), max(worst, excess)
        log(f"kernel df_mm_full {nm} (N={n}) [{label}]: max abs err {float(diff.max()):.3e}, "
            f"{excess:.3e} of its tolerance ({FULL_EPS:.2e} of |ref| + {DF_TOL} of sum|terms|); "
            f"max |ref| {float(r.abs().max()):.4g}")
    if not worst <= 1.0:
        raise AssertionError(f"df_mm_full [{label}] (N={n}) disagrees with its plain twin")

    p = Qh.shape[0]
    g = [torch.linspace(lo, hi, k, device=mu.device).reshape(shape)
         for lo, hi, k, shape in ((1.0, 2.0, ns, (ns,)), (-1.0, 1.0, ns * d, (ns, d)), (1.0, 2.0, p, (p,)),
                                  (-1.0, -2.0, ns, (ns,)))]
    out = df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)  # #9, at every N
    ref = df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, cache, *g)
    err_bwd = max(hold_grad(f"df_mm_bwd {nm} (N={n})", label, o, r) for nm, o, r in zip(("g_mu", "g_B", "g_Q"), out, ref))
    log(f"kernel df_mm_bwd (N={n}) [{label}]: bit for bit with its plain twin: "
        f"{all(torch.equal(o, r) for o, r in zip(out, ref))}")
    return err_full, err_fwd, err_bwd


def split_cotangents(mu, p):
    """The fixed cotangents g_M, g_V, g_S_p, g_corr of the phase 3 VJP checks."""
    ns, d = 3, mu.shape[0]
    return [torch.linspace(lo, hi, k, device=mu.device).reshape(shape)
            for lo, hi, k, shape in ((1.0, 2.0, ns, (ns,)), (-1.0, 1.0, ns * d, (ns, d)), (1.0, 2.0, p, (p,)),
                                     (-1.0, -2.0, ns, (ns,)))]


def check_df_mm_split(label, cache, mu, sv) -> tuple[float, float]:
    """The split backward (#10 the mean path, #11 every pair) against its
    plain twins, each output (a df contribution collapsed in f64, or an f32
    gradient) to DF_GRAD_TOL of its largest entry, each called twice for
    bitwise repeats; the combined split route (``stage23_bwd``) against #9
    at the same N, exactly (the parent printed bit for bit at every N and
    operand set here: the same df sums, g_mu's in another order hidden by
    the collapse), and its g_mu (#11's last launch adds #10's df
    contribution and the pairs') against ``combine_split`` run by PyTorch on
    the card on #10's and #11's outputs, bit for bit (the same IEEE
    operations in the same order)."""
    ns = cache.ils_hi.shape[0]
    n = cache.x_hi.shape[0]
    ii, jj, _, _ = df_mm.pair_indices(ns, mu.device)
    Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
    g = split_cotangents(mu, Qh.shape[0])

    def v(x):
        return x[0].double() + x[1].double()

    (m_inp, g_b), (m_ref, g_b_ref) = (df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1]),
                                      df_mm.stage23_vjp_mean_plain(mu, Bh, Bl, cache, g[0], g[1]))
    err_mean = max(hold_grad(f"df_mm_bwd_mean g_inp (N={n})", label, v(m_inp), v(m_ref)),
                   hold_grad(f"df_mm_bwd_mean g_B (N={n})", label, g_b, g_b_ref))
    again = df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1])
    hold_repeat(f"df_mm_bwd_mean (N={n})", label, (*m_inp, g_b), (*again[0], again[1]))
    (p_inp, g_q), (p_ref, g_q_ref) = (df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3]),
                                      df_mm.stage23_vjp_pairs_plain(mu, Qh, Ql, cache, g[2], g[3]))
    err_pair = max(hold_grad(f"df_mm_bwd_pair g_inp (N={n})", label, v(p_inp), v(p_ref)),
                   hold_grad(f"df_mm_bwd_pair g_Q (N={n})", label, g_q, g_q_ref))
    again = df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3])
    hold_repeat(f"df_mm_bwd_pair (N={n})", label, (*p_inp, g_q), (*again[0], again[1]))
    split = df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, cache, *g)
    combined = df_mm.combine_split(m_inp, p_inp)
    log(f"split route's on-card combination against combine_split (N={n}) [{label}]: bit for bit: "
        f"{torch.equal(split[0], combined)}")
    if not (torch.equal(split[0], combined) and torch.equal(split[1], g_b) and torch.equal(split[2], g_q)):
        raise AssertionError(f"the split route's g_mu [{label}] (N={n}) differs from combine_split's")
    whole = df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)
    for nm, o, r in zip(("g_mu", "g_B", "g_Q"), split, whole):
        hold_grad(f"split route (df_mm_bwd_mean + df_mm_bwd_pair) {nm}, against df_mm_bwd (N={n})", label, o, r)
    exact = all(torch.equal(o, r) for o, r in zip(split, whole))
    log(f"split route against df_mm_bwd (N={n}) [{label}]: bit for bit: {exact}")
    if not exact:
        raise AssertionError(f"the split route [{label}] (N={n}) differs from df_mm_bwd in its last bits")
    return err_mean, err_pair


def check_df_mm_kernels(dev):
    """#12, #8 and #9 against their plain twins on the card at N = 32, 96
    (the bucket that is not a power of two), 128 and 384 (and on random
    operands at RAGGED_N), and #10 and #11
    at N = 192 and 384, on the trained-GP problem's operands and on random
    ones; then their times at the trained-GP operands of the paths' shapes:
    N = 128 for #12, #8 and #9 (the whole-step planning step), N = 384 for
    #10 and #11 (phase 5's value-and-grad rollout), with #9 beside them."""
    errs, split_errs, steps = [], [], {}
    for n in sorted(set(DF_MM_SIZES) | set(SPLIT_SIZES)):
        steps[n] = trained_gp_step_inputs(dev, n)
        rand = random_df_mm_problem(dev, n, seed=n)
        if n in DF_MM_SIZES:
            errs.append(check_df_mm_operands("trained-GP", *steps[n]))
            errs.append(check_df_mm_operands("random", *rand))
        if n in SPLIT_SIZES:
            split_errs.append(check_df_mm_split("trained-GP", *steps[n]))
            split_errs.append(check_df_mm_split("random", *rand))
    # a ragged N (not a multiple of the 32-column tiles) on random operands
    errs.append(check_df_mm_operands("random", *random_df_mm_problem(dev, RAGGED_N, seed=RAGGED_N)))
    # phase 7's state width (the mountain-car example: ns = 2, d = 3) in its bucket and at a ragged N
    for n in NS2_SIZES:
        errs.append(check_df_mm_operands("random ns=2", *random_df_mm_problem(dev, n, seed=n + 2, ns=2, d=3)))
    results = {}
    for n, names in ((128, ("df_mm_full", "df_mm_fwd", "df_mm_bwd")), (192, ("df_mm_bwd_mean", "df_mm_bwd_pair")),
                     (384, ("df_mm_bwd_mean", "df_mm_bwd_pair"))):
        cache, mu, sv = steps[n]
        ns, d = cache.ils_hi.shape
        ii, jj, _, _ = df_mm.pair_indices(ns, dev)
        Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
        p = Qh.shape[0]
        g = (torch.ones(ns, device=dev), torch.ones(ns, d, device=dev), torch.ones(p, device=dev),
             -torch.ones(ns, device=dev))
        calls = {"df_mm_full": (lambda: df_mm.full_step_fwd(mu, sv, cache), lambda: df_mm.full_step_plain(mu, sv, cache)),
                 "df_mm_fwd": (lambda: df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache),
                               lambda: df_mm.stage23_plain(mu, Bh, Bl, Qh, Ql, cache)),
                 "df_mm_bwd": (lambda: df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g),
                               lambda: df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, cache, *g)),
                 "df_mm_bwd_mean": (lambda: df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1]),
                                    lambda: df_mm.stage23_vjp_mean_plain(mu, Bh, Bl, cache, g[0], g[1])),
                 "df_mm_bwd_pair": (lambda: df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3]),
                                    lambda: df_mm.stage23_vjp_pairs_plain(mu, Qh, Ql, cache, g[2], g[3]))}
        counts = df_instructions_per_element(ns)
        in_bytes = 4 * 2 * (n * d + 3 * ns * d + ns + ns * n + ns * n * n) + 4 * (d + ns * ns + 2 * ns ** 3
                                                                               + 2 * p * ns * ns)
        out_bytes = {"df_mm_full": 4 * (ns + ns * d + p), "df_mm_fwd": 4 * 2 * (2 * ns + ns * d + p),
                     "df_mm_bwd": 4 * (d + ns ** 3 + p * ns * ns), "df_mm_bwd_mean": 4 * (2 * d + ns ** 3),
                     "df_mm_bwd_pair": 4 * (2 * p * d + p * ns * ns)}
        for name in names:
            kern, plain = calls[name]
            ms, host = cuda_ms(kern)
            plain_ms = event_ms(plain)
            if name == "df_mm_bwd_mean":
                per = mean_vjp_instructions(ns, d)
                ops_, what = ns * n * per, f"{per} f32 instructions per (model, point)"
            else:
                per, per_diag = counts[name]
                ops_ = (p * per + ns * per_diag) * n * n
                what = (f"{per} + {per_diag} on diagonal pairs f32 instructions per slab element; the per-point "
                        f"work is not counted")
            nbytes = (4 * 2 * (n * d + 3 * ns * d + ns + ns * n) + 4 * (d + 2 * ns ** 3) if name == "df_mm_bwd_mean"
                      else in_bytes) + out_bytes[name]  # the mean path reads no iK and no Q
            b, by = bound_ms(nbytes, ops_, H100_F32_INSTR_PER_S)
            log(f"kernel {name} (P={p}, N={n}, ns={ns}, trained-GP operands): wrapper {ms:.4f} ms (device, "
                f"{LAUNCHES_PER_CALL[name]} launches) plain {plain_ms:.4f} ms bound {b:.5f} ms ({by}: {what}, over "
                f"{H100_F32_INSTR_PER_S:.3g}/s); host {host:.4f} ms per call")
            err = max(e[names.index(name)] for e in (errs if n == 128 else split_errs))
            results[name if n != 192 else f"{name} N=192"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                                                                  bound_by=by)
        if n in SPLIT_SIZES:
            ms_all, _ = cuda_ms(calls["df_mm_bwd"][0])
            ms_split, _ = cuda_ms(lambda: df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, cache, *g))
            log(f"kernel df_mm_bwd at N={n} (trained-GP operands): {ms_all:.4f} ms against the split route "
                f"(one cotangent cat, df_mm_bwd_mean, df_mm_bwd_pair with the df combination) {ms_split:.4f} ms, "
                f"device, per call")
    bwd = results["df_mm_bwd"]
    bwd["report"] = launch_report("df_mm_bwd", df_mm.bwd_launch_info(128, 3), bwd["ms"], bwd["bound_ms"])
    log("kernel " + results["df_mm_bwd"]["report"])
    d = steps[384][0].ils_hi.shape[1]
    clock = max_sm_clock_mhz()
    for n in SPLIT_SIZES:
        key = "" if n == 384 else f" N={n}"
        pair, mean = results["df_mm_bwd_pair" + key], results["df_mm_bwd_mean" + key]
        info = df_mm.pair_launch_info(n, 3)
        plan = df_mm.pair_launch_plan(n, 3, info["sms"])
        if (info["grid"], info["unit_warps"], info["unit_blocks"]) != (plan["tile_blocks"], plan["unit_warps"],
                                                                     plan["unit_blocks"]):
            raise AssertionError(f"df_mm_bwd_pair's launch {info} is not df_mm.pair_launch_plan's {plan}")
        pair["report"] = launch_report(
            "df_mm_bwd_pair", info, pair["ms"], pair["bound_ms"],
            f" at N={n}; chain rule {info['unit_blocks']} blocks of {info['unit_warps']} warps, "
            f"{info['unit_registers']} registers")
        info = df_mm.mean_launch_info(n, 3, d)
        plan = df_mm.mean_launch_plan(n, 3, info["sms"])
        if (info["grid"], info["threads"]) != (plan["cluster"], 32 * plan["warps"]):
            raise AssertionError(f"df_mm_bwd_mean's launch {info} is not df_mm.mean_launch_plan's {plan}")
        chain = mean_vjp_chain(3, d, n)
        floor = chain * F32_LATENCY_CYCLES / (clock * 1e3)
        mean["report"] = launch_report(
            "df_mm_bwd_mean", info, mean["ms"], mean["bound_ms"],
            f" at N={n} (one cluster); latency floor {floor:.5f} ms ({chain} dependent f32 instructions x "
            f"{F32_LATENCY_CYCLES} cycles at {clock:.0f} MHz) = {floor / mean['ms']:.1%} of it")
        log("kernel " + pair["report"])
        log("kernel " + mean["report"])
    full = results["df_mm_full"]
    full["report"] = launch_report("df_mm_full", df_mm.full_launch_info(128, 3), full["ms"], full["bound_ms"])
    log("kernel " + full["report"])
    for n in (32, 96):  # the other buckets of the whole-step path
        cache, mu, sv = steps[n]
        ms, _ = cuda_ms(lambda: df_mm.full_step_fwd(mu, sv, cache))
        log(f"kernel df_mm_full (N={n}, trained-GP operands): wrapper {ms:.4f} ms (device, 2 launches)")
    return results


def check_launches(name, counts, expected) -> None:
    """A redesigned kernel's launches on its driven path (EXPECTED_LAUNCHES)."""
    if counts[name] != expected:
        raise AssertionError(f"kernel {name} launched {counts[name]} times on its path, expected {expected}")


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
    (objective rel, gradient rel, a_opt abs, info rel) gaps, the card's plans
    and both sides' (problem, cache) after the steps."""
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
    return gaps, plans, ((prob, planner._cache), (ref_prob, ref_planner._cache))


def ik_gradient(prob, cache, actions):
    """The gradient of the planning objective at fixed actions with respect
    to the factorization cache's iK (how the plan's cost moves with the
    cached inverse): the cov core's iK gradient, summed over the rollout."""
    ik = cache.iK.detach().clone().requires_grad_(True)
    cost, _ = _objective_and_info(prob.spec, cache._replace(iK=ik), actions, prob.state_mu, prob.state_var,
                                  prob.action_prev, 0)
    (g,) = torch.autograd.grad(cost, ik)
    return g.double().cpu()


def f64_reference(dev, steps, **sizes):
    """The card's own float64 plan of ``steps`` trained-GP steps (``sizes``:
    n_points and bucket of the problem, the flagship's by default), the
    reference of ``compare_mixed_to_f64``: made once, held against both
    df32 VJP schemes."""
    prob = trained_gp_problem(dev, dtype=torch.float64, **sizes)
    planner = start_steps(prob, dev, torch.float64, steps)
    plans = []
    for i in range(steps):
        plans.append(plan_step(planner, prob, i))
        if i == 0:
            cache0 = planner._cache
    f, g = objective_and_grad(prob, planner._cache, prob.inits[0])
    return SimpleNamespace(prob=prob, planner=planner, plans=plans, cache0=cache0, f=f, g=g)


def compare_mixed_to_f64(prob, planner, plans, ref, witness=True, label="trained-GP"):
    """The gaps of MIXED_TOL against the card's f64 plan ``ref`` of the same
    steps (the plan gap the largest over the steps, each plan's f64
    objective taken on the caches after the last step) and the a_opt gap of
    each step (printed only); then ``a_opt_witness`` on the first step.
    Returns the gaps and the mixed gradient at the initial actions."""
    ref_prob, ref_planner = ref.prob, ref.planner
    f_card, g_card = objective_and_grad(prob, planner._cache, prob.inits[0])

    def f64_at(a):
        with torch.no_grad():
            return _objective_and_info(ref_prob.spec, ref_planner._cache, a.to(torch.float64), ref_prob.state_mu,
                                       ref_prob.state_var, ref_prob.action_prev, 0)

    plan_gaps, a_gaps = [], []
    for (a_mix, _), (a_ref, _) in zip(plans, ref.plans):
        f_mix_plan, f_ref_plan = float(f64_at(a_mix)[0]), float(f64_at(a_ref)[0])
        plan_gaps.append((f_mix_plan - f_ref_plan) / abs(f_ref_plan))
        a_gaps.append(max_err(a_mix, a_ref)[0])
        log(f"  step {len(a_gaps) - 1}: f64 objective at the plans {f_mix_plan:.9g} (mixed) vs "
            f"{f_ref_plan:.9g} (f64); a_opt gap {a_gaps[-1]:.3e} (not held, see MIXED_TOL)")
    _, info64 = f64_at(plans[-1][0])
    gaps = dict(
        objective=abs(f_card - ref.f) / abs(ref.f),
        gradient=max_err(g_card, ref.g)[1],
        info=max(max_err(x, y)[1] for x, y in zip(plans[-1][1], info64)),
        plan=max(plan_gaps),
    )
    log(f"  {label} {prob.n_points} points in the {prob.x.shape[0]} bucket, card mixed vs card f64: "
        f"objective {f_card:.9g} vs {ref.f:.9g}; gaps " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    if witness:
        a_opt_witness(prob, ref_prob, ref.cache0, ref.plans[0][0], plans[0][0])
    return gaps, g_card


def a_opt_witness(prob, ref_prob, cache, a_ref, a_mix):
    """Why a_opt is not held. The first step's f64 plan is replayed on its
    f64 cache (``prob``: the mixed problem, whose rollout cache is that
    cache's df32 split):

    * unchanged: must give the planner's f64 a_opt (printed 0);
    * f32 optimizer: L-BFGS-B on f32 iterates over the f64 objective
      rounded to f32, as the mixed plan runs it;
    * mixed gradient: f64 values with the mixed gradient at every point;
    * mixed value: mixed values with the f64 gradient at every point.

    Each replay's a_opt is printed as its distance from the f64 plan's and
    from the mixed plan's."""
    spec = ref_prob.spec
    df_cache = _cast_cache(cache, torch.float32)

    def evaluate(mixed, a, grad):
        """(value, gradient or None) in f64 of one precision's objective."""
        p, c = (prob, df_cache) if mixed else (ref_prob, cache)
        x = a.detach().to(p.state_mu.dtype).requires_grad_(grad)
        cost, _ = _objective_and_info(p.spec, c, x, p.state_mu, p.state_var, p.action_prev, 0)
        return cost.detach().double(), torch.autograd.grad(cost, x)[0].double() if grad else None

    def objective(a, value_mixed=False, grad_mixed=False):
        grad = torch.is_grad_enabled()
        f, g = evaluate(value_mixed, a, grad and value_mixed == grad_mixed)
        if not grad:
            return f
        if value_mixed != grad_mixed:
            g = evaluate(grad_mixed, a, True)[1]
        s = torch.dot(a, g)
        return f + (s - s.detach())  # value f, gradient g

    replays = {"unchanged": (objective, torch.float64),
               "f32 optimizer": (lambda a: objective(a.double()).float(), torch.float32),
               "mixed gradient": (lambda a: objective(a, grad_mixed=True), torch.float64),
               "mixed value": (lambda a: objective(a, value_mixed=True), torch.float64)}
    moves = {}
    for name, (fun, dtype) in replays.items():
        a0 = ref_prob.inits[0].to(dtype)
        a_opt, _ = lbfgs_b_minimize(fun, a0, torch.zeros_like(a0), torch.ones_like(a0), maxiter=spec.maxiter,
                                    maxcor=spec.maxcor, maxls=spec.maxls, maxfun=spec.maxfun)
        moves[name] = (max_err(a_opt, a_ref)[0], max_err(a_opt, a_mix)[0])
    log(f"  a_opt witness, step 0 (mixed plan's a_opt gap {max_err(a_mix, a_ref)[0]:.3e}): the f64 plan "
        f"replayed lands at (distance from the f64 plan's a_opt, from the mixed plan's) "
        + ", ".join(f"{k} ({f:.3e}, {m:.3e})" for k, (f, m) in moves.items()))


def time_rollouts(dev, card):
    """Phase 5's rollout timings for the H100 dispatch range of the
    whole-step path: one 15-step rollout of the trained-GP problem at each
    of ROLLOUT_BUCKETS (0.8 N points, 300 in 384) at the initial actions,
    through ``moment_match_df_fused`` and through ``moment_match_df``, each
    called directly, forward-only and value-and-grad (the gradient in the
    actions); at 384 also ``moment_match_df`` under the stacked df32 VJP
    (value-and-grad: its forward is the df cov route's). Blocked ms (host
    clock, ended by a synchronize) of one rollout each, after one
    forward-only warm-up rollout of each route. At 384 the whole-step
    route's value-and-grad rollout is the split backward's driven path: its
    launch counts are set to 0 just before it and read just after (returned),
    and its gradient is held to the df cov route's and to the card's f64
    rollout's by MIXED_TOL["gradient"]."""
    split_launches = None
    for n in ROLLOUT_BUCKETS:
        prob = trained_gp_problem(dev, n_points=min(300, int(0.8 * n)), bucket=n)
        cache = _cast_cache(Planner(prob.spec, dtype=torch.float32, device=dev, master_dtype=torch.float64)
                            .refresh_cache(prob.x, prob.y, prob.mask, prob.params, prob.bounds), torch.float32)
        ns, d = cache.ils_hi.shape

        def rollout(mm, cache, prob, grad):
            a = prob.inits[0].reshape(-1, 1).clone().requires_grad_(grad)
            mu, var = prob.state_mu, prob.state_var
            with torch.set_grad_enabled(grad):
                for t in range(a.shape[0]):
                    input_var = torch.nn.functional.pad(var, (0, d - ns, 0, d - ns))
                    dmu, dvar, v = mm(cache, torch.cat([mu, a[t]]), input_var)
                    sv = input_var[:ns]
                    mu, var = mu + dmu, dvar + var + sv @ v + v.T @ sv.T
                out = mu.sum() + var.sum()
                g = torch.autograd.grad(out, a)[0] if grad else None
            torch.cuda.synchronize()
            return g

        routes = [("fused", gp_mod.moment_match_df_fused, "residual", (False, True)),
                  ("df_cov", gp_mod.moment_match_df, "residual", (False, True))]
        if n == 384:
            routes.append(("df_cov stacked", gp_mod.moment_match_df, "stacked", (True,)))
        times, grads = {}, {}
        for route, mm, mode, modes in routes:
            df_cov.VJP_MODE = mode
            try:
                for grad in modes:
                    if not grad:
                        rollout(mm, cache, prob, False)  # warm-up
                    if grad and route == "fused" and n == 384:
                        ops.reset_launch_counts()
                    t0 = time.perf_counter()
                    grads[route] = rollout(mm, cache, prob, grad)
                    times[(route, grad)] = (time.perf_counter() - t0) * 1e3
                    if grad and route == "fused" and n == 384:
                        split_launches = ops.launch_counts()
            finally:
                df_cov.VJP_MODE = "residual"
        log(f"phase 5 rollout N={n} ({prob.n_points} points), 15 steps, blocked ms: " + ", ".join(
            f"{route} {'value-and-grad' if grad else 'forward'} {ms:.2f}" for (route, grad), ms in times.items())
            + f" on {card}")
        if n == 384:
            log(f"  launches in the whole-step value-and-grad rollout at N={n}: {split_launches}")
            for name in ("df_mm_bwd_mean", "df_mm_bwd_pair"):
                check_launches(name, split_launches, EXPECTED_LAUNCHES[f"{name} per split rollout"])
            if split_launches["df_mm_bwd"] != 0:
                raise AssertionError(f"kernel df_mm_bwd was launched at N={n}, past the reference's single-launch range")
            ref_prob = trained_gp_problem(dev, dtype=torch.float64, n_points=prob.n_points, bucket=n)
            ref_cache = Planner(ref_prob.spec, dtype=torch.float64, device=dev).refresh_cache(
                ref_prob.x, ref_prob.y, ref_prob.mask, ref_prob.params, ref_prob.bounds)
            g64 = rollout(gp_mod.moment_match, ref_cache, ref_prob, True).double()
            gaps = {f"{route} vs {other}": max_err(grads[route].double(), ref)[1]
                    for route, other, ref in (("fused", "df_cov", grads["df_cov"].double()), ("fused", "f64", g64),
                                              ("df_cov", "f64", g64), ("df_cov stacked", "f64", g64))}
            log(f"  value-and-grad gradient gaps at N={n} (relative to the largest entry): "
                + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
            if not all(v <= MIXED_TOL["gradient"] for v in gaps.values()):
                raise AssertionError(f"rollout gradients at N={n} disagree beyond {MIXED_TOL['gradient']}: {gaps}")
    return split_launches


def record_plans(planner):
    """Keep the arguments and result of every ``planner.plan`` call: returns
    the list they are appended to, as (args, (a_opt, actions_model, info))."""
    calls = []
    plan = planner.plan

    def recorded(*args, **kwargs):
        out = plan(*args, **kwargs)
        calls.append((args, out))
        return out

    planner.plan = recorded
    return calls


def _as_dtype(tree, dtype):
    return type(tree)(*(a.to(dtype) if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in tree))


def controller_plan_gaps(ctrl, call, dev):
    """MIXED_TOL's gaps (``compare_mixed_to_f64``) of one planned step of a
    mixed-mode controller, recorded by ``record_plans`` and compared right
    after it, against a float64 Planner's plan on ``dev`` of the same
    memory, parameters, state, inits and previous action."""
    args, (a_opt, _, info) = call
    x_pad, y_pad, mask, params, bounds, state_mu, state_var, inits, action_prev, iter_ctrl = args
    f64 = torch.float64
    spec64 = ctrl.plan_spec._replace(reward=_as_dtype(ctrl.plan_spec.reward, f64),
                                     action=_as_dtype(ctrl.plan_spec.action, f64))
    ref_planner = Planner(spec64, dtype=f64, device=dev)
    ref_args = [a.to(f64) for a in (state_mu, state_var, inits, action_prev)]
    a_ref, _, info_ref = ref_planner.plan(x_pad, y_pad, mask, _as_dtype(params, f64), _as_dtype(bounds, f64),
                                          *ref_args, iter_ctrl)

    def problem(spec, state_mu, state_var, inits, action_prev):
        return SimpleNamespace(spec=spec, state_mu=state_mu, state_var=state_var, inits=inits,
                               action_prev=action_prev, n_points=int(mask.sum()), x=x_pad)

    ref_prob = problem(spec64, *ref_args)
    f, g = objective_and_grad(ref_prob, ref_planner._cache, ref_prob.inits[0])
    ref = SimpleNamespace(prob=ref_prob, planner=ref_planner, plans=[(a_ref, info_ref)], f=f, g=g)
    gaps, _ = compare_mixed_to_f64(problem(ctrl.plan_spec, state_mu, state_var, inits, action_prev), ctrl.planner,
                                   [(a_opt, info)], ref, witness=False, label="controller")
    return gaps


def check_controller_launches(kind, i, launches):
    """Controller step ``i`` launched exactly its EXPECTED_LAUNCHES and no
    other kernel of the port."""
    expected = (EXPECTED_LAUNCHES["controller warmup step"] if kind == "warmup"
                else EXPECTED_LAUNCHES["controller planned steps"][i - CONTROLLER_WARMUP])
    wrong = {k: n for k, n in launches.items() if n != expected.get(k, 0)}
    if wrong:
        raise AssertionError(f"controller {kind} step {i} launched {wrong}, expected {expected} and no other kernel")


def check_on_card(ctrl):
    """The controller's GP parameters and its planner's cache are on the card."""
    tensors = list(ctrl.planner._cache) + list(ctrl.gp_params) + list(ctrl.bounds)
    off = {str(t.device) for t in tensors if isinstance(t, torch.Tensor) and t.device.type != "cuda"}
    if off:
        raise AssertionError(f"the controller's planner holds tensors on {off}")


def drive_controller(dev, card):
    """Phase 6: the pendulum example's controller in mixed mode on ``dev``
    through GpMpcController.get_action / add_memory (see CONTROLLER_WARMUP).
    Each get_action is timed blocked, its launches counted from 0; each
    planned step is held to the card's f64 plan by MIXED_TOL right after it,
    and the planner's tensors must be on the card."""
    env = PendulumEnv(seed=0)
    box = (env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high)
    ctrl = GpMpcController(*box, pendulum_config(dtype="float32", training_frequency=CONTROLLER_TRAINING_FREQUENCY),
                           seed=0, device=dev)
    calls = record_plans(ctrl.planner)
    secs = {"warmup": [], "planned": []}
    obs = env.reset()
    try:
        for i in range(CONTROLLER_WARMUP + CONTROLLER_PLANNED):
            kind = "warmup" if i < CONTROLLER_WARMUP else "planned"
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            action = ctrl.get_action(obs, random=kind == "warmup")
            torch.cuda.synchronize()
            secs[kind].append(time.perf_counter() - t0)
            launches = ops.launch_counts()
            info = ctrl.get_iter_info()
            cost, _ = ctrl.compute_cost_unnormalized(obs, action)
            obs_new, _, _, _ = env.step(action)
            ctrl.add_memory(obs, action, obs_new, -cost, info.predicted_states[1], info.predicted_states_std[1])
            obs = obs_new
            log(f"phase 6 controller {kind} step {i}: {secs[kind][-1]:.3f} s blocked, {ctrl.memory.len_mem_model} "
                f"stored points, action {float(action[0]):.6f}, cost {cost:.6f}, launches "
                + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
            check_controller_launches(kind, i, launches)
            if kind == "planned":
                check_on_card(ctrl)
                gaps = controller_plan_gaps(ctrl, calls[-1], dev)
                if not all(v <= MIXED_TOL[k] for k, v in gaps.items()):
                    raise AssertionError(f"controller step {i} disagrees with the card's f64 plan beyond "
                                         f"{MIXED_TOL}: {gaps}")
            if i == CONTROLLER_WARMUP - 1:
                if ctrl._pending_train is None:
                    raise AssertionError("the training did not fire after the warmup")
                t0 = time.perf_counter()
                ctrl.wait_for_training()
                log(f"phase 6 controller training: {ctrl.last_train_seconds:.3f} s in f64 on the CPU thread "
                    f"({ctrl.memory.len_mem_model} points, {ctrl.train_cfg.iters} L-BFGS iterations at most per "
                    f"model), waited {time.perf_counter() - t0:.3f} s for it after the warmup; losses "
                    f"{ctrl._last_train_losses.tolist()}")
    finally:
        ctrl.close()
    if len(calls) != CONTROLLER_PLANNED:
        raise AssertionError(f"{len(calls)} plans for {CONTROLLER_PLANNED} planned steps")
    log(f"phase 6 controller: blocked s per warmup step (Planner.evaluate) median "
        f"{statistics.median(secs['warmup']):.3f} (" + ", ".join(f"{t:.3f}" for t in secs["warmup"])
        + "), per planned step " + ", ".join(f"{t:.3f}" for t in secs["planned"]) + f" on {card}")
    log(f"phase 6 controller accuracy: {CONTROLLER_PLANNED} planned steps within {MIXED_TOL} of the card's f64 "
        f"plans; launches per warmup step {EXPECTED_LAUNCHES['controller warmup step']}, per planned step "
        f"{EXPECTED_LAUNCHES['controller planned steps']}, no other kernel")


def drive_run_env(dev, card):
    """Phase 7: the mountain-car example in mixed mode through the port's
    run_env on ``dev`` (see MC_HORIZON), two restarts at its one planned
    step. Hooks installed for the phase (and removed after it) time each
    get_action blocked with its launches, record the planned call (as
    ``record_plans`` does) and the restart each plan keeps. Holds: 21
    finite costs, the episode's launches (EXPECTED_LAUNCHES, no other
    kernel), the planner's tensors on the card, and the plan against the
    card's f64 plan of the same memory, parameters and both inits by
    MIXED_TOL."""
    cfg = mountain_car_config(len_horizon=MC_HORIZON, num_repeat_actions=MC_REPEAT, dtype="float32")
    opt = cfg.controller.actions_optimizer_params
    cfg.controller.actions_optimizer_params = {**opt, "maxfun": MC_MAXFUN, "maxiter": MC_MAXFUN}
    steps, calls, chosen = [], [], []
    get_action, plan, select = GpMpcController.get_action, Planner.plan, planner_mod._select_restart

    def timed_get_action(ctrl, *args, **kwargs):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        out = get_action(ctrl, *args, **kwargs)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        steps.append(SimpleNamespace(ctrl=ctrl, secs=time.perf_counter() - t0,
                                     launches={k: after[k] - before[k] for k in after if after[k] != before[k]}))
        return out

    def recorded_plan(planner, *args, **kwargs):
        out = plan(planner, *args, **kwargs)
        calls.append((args, out))
        return out

    def recorded_select(fs):
        chosen.append((select(fs), fs.tolist()))
        return chosen[-1][0]

    GpMpcController.get_action, Planner.plan, planner_mod._select_restart = (timed_get_action, recorded_plan,
                                                                            recorded_select)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        costs = run_env(MountainCarContinuousEnv(seed=0), cfg, None, random_actions_init=MC_WARMUP,
                        num_steps=MC_STEPS, verbose=False, seed=0, device=dev)
        torch.cuda.synchronize()
        episode_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        ctrl = steps[0].ctrl
        planned = [i for i in range(0, MC_STEPS, MC_REPEAT) if i >= MC_WARMUP]
        for i, step in enumerate(steps):
            if step.launches or i in planned:
                log(f"phase 7 run_env step {i} ({'planned' if i in planned else 'random'}): {step.secs:.3f} s "
                    f"blocked, launches " + ", ".join(f"{k} {n}" for k, n in step.launches.items()))
        log(f"phase 7 run_env: {MC_STEPS} mountain-car steps in {episode_s:.3f} s blocked ({ctrl.memory.len_mem_model} "
            f"stored points in the {ctrl.memory.get_padded()[3]} bucket), launches "
            + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
        if len(costs) != MC_STEPS or not np.all(np.isfinite(costs)):
            raise AssertionError(f"run_env returned {len(costs)} costs, finite: {np.isfinite(costs).tolist()}")
        expected = EXPECTED_LAUNCHES["mountain-car episode"]
        wrong = {k: n for k, n in launches.items() if n != expected.get(k, 0)}
        if wrong:
            raise AssertionError(f"the mountain-car episode launched {wrong}, expected {expected} and no other kernel")
        if len(calls) != len(planned) or len(chosen) != len(planned):
            raise AssertionError(f"{len(calls)} plans for the planned steps {planned}")
        if ctrl.config.controller.restarts_optim != 2 or calls[0][0][7].shape[0] != 2:
            raise AssertionError("the mountain-car plan did not run two restarts")
        check_on_card(ctrl)
        check_plans([(a, info) for _, (a, _, info) in calls], ctrl.plan_spec, finite_info=True)
        t0 = time.perf_counter()
        gaps = controller_plan_gaps(ctrl, calls[0], dev)
        ref_s = time.perf_counter() - t0
    finally:
        GpMpcController.get_action, Planner.plan, planner_mod._select_restart = get_action, plan, select
    (mixed_best, mixed_fs), (f64_best, f64_fs) = chosen
    log(f"phase 7 run_env restarts: mixed plan kept restart {mixed_best} of objectives {mixed_fs}, the card's f64 "
        f"plan restart {f64_best} of {f64_fs}")
    if not all(v <= MIXED_TOL[k] for k, v in gaps.items()):
        raise AssertionError(f"the mountain-car plan disagrees with the card's f64 plan beyond {MIXED_TOL}: {gaps}")
    log(f"phase 7 run_env accuracy: the planned step within {MIXED_TOL} of the card's f64 plan (made and compared "
        f"in {ref_s:.3f} s); episode {episode_s:.3f} s blocked, planned step {steps[planned[0]].secs:.3f} s, random "
        f"steps median {statistics.median(steps[i].secs for i in range(0, MC_WARMUP, MC_REPEAT)):.3f} s on {card}")


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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    kern = check_kernels(dev)
    kern.update(check_df_kernels(dev))
    kern.update(check_df_mm_kernels(dev))
    log("phase 3 kernels: all twelve match their plain versions on the card")
    for name in ("df_mm_full", "cov_fwd", "df_mm_bwd", "df_fwdres", "df_fwd", "cov_bwd_row", "df_mm_bwd_pair N=192",
                 "df_mm_bwd_pair", "df_mm_bwd_mean N=192", "df_mm_bwd_mean", "gram", "cov_gik"):
        log(f"phase 3 {kern[name]['report']}")
    log("phase 3 controls in this call: " + ", ".join(
        f"{name} {kern[name]['ms']:.4f} ms" for name in ("df_mm_fwd", "df_bwd")))

    prob = flagship_problem(dev, torch.float32)
    spec = prob.spec
    ops.reset_launch_counts()
    planner, plans, _ = run_steps(prob, dev, torch.float32, PLAN_STEPS)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"phase 4 main path f32: refresh + {PLAN_STEPS} flagship plans, launches {launches}")
    for name in ("gram", "cov_fwd", "cov_bwd_row"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the f32 main path")
    if launches["cov_gik"] != 0:
        raise AssertionError("kernel cov_gik was launched by a planning step (iK is constant while planning)")
    check_launches("cov_bwd_row", launches, EXPECTED_LAUNCHES["cov_bwd_row per f32 plan"] * PLAN_STEPS)
    check_plans(plans, spec, finite_info=False)
    f_card, _ = objective_and_grad(prob, planner._cache, prob.inits[0])
    log(f"  flagship f32 objective at the initial actions: {f_card:.9g} (f32 breaks down at "
        f"300 points, in the JAX package too; see ACC_TOL)")

    gaps, plans, ((aprob, acache), (rprob, rcache)) = compare_to_f64(dev, ACC_POINTS, ACC_BUCKET)
    check_plans(plans, spec, finite_info=True)
    if not all(v <= ACC_TOL for v in gaps.values()):
        raise AssertionError(f"card f32 disagrees with CPU f64 beyond {ACC_TOL}: {gaps}")
    log(f"phase 4 accuracy: {ACC_POINTS} points within {ACC_TOL} of f64")

    ops.reset_launch_counts()
    gk_card = ik_gradient(aprob, acache, aprob.inits[0])
    torch.cuda.synchronize()
    gik_launches = ops.launch_counts()
    gk_gap = max_err(gk_card, ik_gradient(rprob, rcache, rprob.inits[0]))[1]
    log(f"phase 4 iK gradient: the f32 objective's gradient in the cache's iK ({ACC_POINTS} points in the "
        f"{ACC_BUCKET} bucket), launches {gik_launches}; gap to CPU f64 {gk_gap:.3e} of its largest entry "
        f"(tol {ACC_TOL})")
    if gik_launches["cov_gik"] <= 0:
        raise AssertionError("kernel cov_gik was not launched by the iK gradient")
    if not gk_gap <= ACC_TOL:
        raise AssertionError(f"card iK gradient disagrees with CPU f64 beyond {ACC_TOL}: {gk_gap:.3e}")

    mprob = trained_gp_problem(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mplanner, mplans, msecs = run_steps(mprob, dev, torch.float32, MIXED_STEPS, sync=torch.cuda.synchronize)
    torch.cuda.synchronize()
    mixed_launches = ops.launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"phase 4 main path mixed: f64 refresh + {MIXED_STEPS} trained-GP flagship plans "
        f"(300 points in the {mprob.x.shape[0]} bucket), launches {mixed_launches}")
    check_plans(mplans, mprob.spec, finite_info=True)
    # accuracy before the launch check, so that a path which skips a kernel
    # shows what it does to the plan
    ref64 = f64_reference(dev, MIXED_STEPS)
    mgaps, _ = compare_mixed_to_f64(mprob, mplanner, mplans, ref64)
    if not all(v <= MIXED_TOL[k] for k, v in mgaps.items()):  # plan: a signed excess
        raise AssertionError(f"card mixed mode disagrees with card f64 beyond {MIXED_TOL}: {mgaps}")
    for name in ("df_fwd", "df_fwdres"):
        if mixed_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the mixed main path")
    for name in ("df_bwd", "df_mm_full", "df_mm_fwd", "df_mm_bwd"):  # residual scheme; 384 is outside 32..128
        if mixed_launches[name] != 0:
            raise AssertionError(f"kernel {name} was launched on the mixed main path")
    check_launches("df_fwd", mixed_launches, EXPECTED_LAUNCHES["df_fwd per residual mixed plan"] * MIXED_STEPS)
    log(f"phase 4 mixed accuracy: within {MIXED_TOL} of the card's f64 plan")

    df_cov.VJP_MODE = "stacked"
    try:
        sprob = trained_gp_problem(dev, nh=STACKED_NH)
        ops.reset_launch_counts()
        splanner, splans, ssecs = run_steps(sprob, dev, torch.float32, MIXED_STEPS, sync=torch.cuda.synchronize)
        torch.cuda.synchronize()
        stacked_launches = ops.launch_counts()
        log(f"phase 4 main path mixed, stacked VJP: f64 refresh + {MIXED_STEPS} trained-GP flagship plans "
            f"(300 points in the {sprob.x.shape[0]} bucket, horizon {STACKED_NH}), launches {stacked_launches}")
        check_plans(splans, sprob.spec, finite_info=True)
        sgaps, g_stacked = compare_mixed_to_f64(sprob, splanner, splans,
                                                f64_reference(dev, MIXED_STEPS, nh=STACKED_NH), witness=False)
    finally:
        df_cov.VJP_MODE = "residual"
    if not all(v <= MIXED_TOL[k] for k, v in sgaps.items()):
        raise AssertionError(f"card mixed mode (stacked VJP) disagrees with card f64 beyond {MIXED_TOL}: {sgaps}")
    _, g_residual = objective_and_grad(sprob, splanner._cache, sprob.inits[0])  # the same cache, residual VJP
    vjp_gap = max_err(g_stacked, g_residual)[1]
    log(f"  stacked vs residual VJP: objective gradient at the initial actions differs by {vjp_gap:.3e} of its "
        f"largest entry (tol MIXED_TOL gradient {MIXED_TOL['gradient']}; the two cov-core VJPs agree to "
        f"DF_GRAD_TOL in phase 3)")
    if not vjp_gap <= MIXED_TOL["gradient"]:
        raise AssertionError(f"the stacked VJP's gradient disagrees with the residual VJP's: {vjp_gap:.3e}")
    for name in ("df_fwd", "df_bwd"):
        if stacked_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the stacked mixed path")
    if stacked_launches["df_fwdres"] != 0:
        raise AssertionError("kernel df_fwdres was launched under the stacked VJP")
    check_launches("df_fwd", stacked_launches, EXPECTED_LAUNCHES["df_fwd per stacked mixed plan"] * MIXED_STEPS)
    log(f"phase 4 stacked accuracy: within {MIXED_TOL} of the card's f64 plan")

    sizes = dict(n_points=FUSED_POINTS, bucket=FUSED_BUCKET, nh=FUSED_NH)
    fprob = trained_gp_problem(dev, **sizes)
    ops.reset_launch_counts()
    fplanner, fplans, fsecs = run_steps(fprob, dev, torch.float32, FUSED_STEPS, sync=torch.cuda.synchronize)
    torch.cuda.synchronize()
    fused_launches = ops.launch_counts()
    log(f"phase 4 main path mixed, whole-step: f64 refresh + {FUSED_STEPS} trained-GP plans ({FUSED_POINTS} points "
        f"in the {FUSED_BUCKET} bucket, horizon {FUSED_NH}), launches {fused_launches}")
    check_plans(fplans, fprob.spec, finite_info=True)
    fgaps, _ = compare_mixed_to_f64(fprob, fplanner, fplans, f64_reference(dev, FUSED_STEPS, **sizes), witness=False)
    if not all(v <= MIXED_TOL[k] for k, v in fgaps.items()):
        raise AssertionError(f"card mixed mode (whole-step) disagrees with card f64 beyond {MIXED_TOL}: {fgaps}")
    for name in ("df_mm_full", "df_mm_fwd", "df_mm_bwd"):
        if fused_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the whole-step path")
    for name in ("df_fwd", "df_fwdres", "df_bwd", "df_mm_bwd_mean", "df_mm_bwd_pair"):
        if fused_launches[name] != 0:
            raise AssertionError(f"kernel {name} was launched on the whole-step path")
    log(f"phase 4 whole-step accuracy: within {MIXED_TOL} of the card's f64 plan")

    prob = flagship_problem(dev, torch.float32)
    _, _, secs = run_steps(prob, dev, torch.float32, TIMED_STEPS, sync=torch.cuda.synchronize)
    med = statistics.median(secs) * 1e3
    log(f"phase 5 timing: median blocked flagship f32 planning step {med:.2f} ms over {TIMED_STEPS} "
        f"steps (min {min(secs) * 1e3:.2f}, max {max(secs) * 1e3:.2f}) on {card}")
    log(f"phase 5 timing: median blocked trained-GP mixed planning step "
        f"{statistics.median(msecs) * 1e3:.2f} ms over the {len(msecs)} steps of phase 4 ("
        + ", ".join(f"{t * 1e3:.2f}" for t in msecs) + f" ms; {mixed_launches['df_fwd']} df_fwd and "
        f"{mixed_launches['df_fwdres']} df_fwdres launches in all; peak {peak_mib:.1f} MiB) on {card}")
    log(f"phase 5 timing: median blocked trained-GP mixed planning step under the stacked VJP (horizon {STACKED_NH}) "
        f"{statistics.median(ssecs) * 1e3:.2f} ms over the {len(ssecs)} steps of phase 4 ("
        + ", ".join(f"{t * 1e3:.2f}" for t in ssecs) + f" ms; {stacked_launches['df_fwd']} df_fwd and "
        f"{stacked_launches['df_bwd']} df_bwd launches in all) on {card}")
    log(f"phase 5 timing: median blocked trained-GP whole-step planning step ({FUSED_POINTS} points in the "
        f"{FUSED_BUCKET} bucket, horizon {FUSED_NH}) {statistics.median(fsecs) * 1e3:.2f} ms over the {len(fsecs)} steps of phase 4 ("
        + ", ".join(f"{t * 1e3:.2f}" for t in fsecs) + f" ms) on {card}")
    split_launches = time_rollouts(dev, card)
    drive_controller(dev, card)
    drive_run_env(dev, card)

    kernels_of = {  # name: (source, the TPU kernel it replaces, the driven path's launch counts)
        "gram": ("gram.cu", "pallas_gram.py:28", launches),
        "cov_fwd": ("cov_core.cu", "pallas_moment_cov.py:111", launches),
        "cov_bwd_row": ("cov_core.cu", "pallas_moment_cov.py:175", launches),
        "cov_gik": ("cov_core.cu", "pallas_moment_cov.py:192", gik_launches),
        "df_fwd": ("df_cov.cu", "pallas_df_cov.py:214", mixed_launches),
        "df_fwdres": ("df_cov.cu", "pallas_df_cov.py:378", mixed_launches),
        "df_bwd": ("df_cov.cu", "pallas_df_cov.py:478", stacked_launches),
        "df_mm_full": ("df_mm_fwd.cu", "pallas_df_mm.py:688", fused_launches),
        "df_mm_fwd": ("df_mm_fwd.cu", "pallas_df_mm.py:451", fused_launches),
        "df_mm_bwd": ("df_mm_bwd.cu", "pallas_df_mm.py:510", fused_launches),
        "df_mm_bwd_mean": ("df_mm_bwd.cu", "pallas_df_mm.py:483", split_launches),
        "df_mm_bwd_pair": ("df_mm_bwd.cu", "pallas_df_mm.py:557", split_launches)}
    kernels = [dict(name=name, route="cuda", source=f"gpmpc_tpu_torch/ops/csrc/{src}", replaces=f"gpmpc_tpu/ops/{rep}",
                    launches=counts[name], max_abs_err=kern[name]["err"], ms=kern[name]["ms"],
                    plain_ms=kern[name]["plain_ms"], bound_ms=kern[name]["bound_ms"],
                    bound_by=kern[name]["bound_by"], library_ms=None)
               for name, (src, rep, counts) in kernels_of.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

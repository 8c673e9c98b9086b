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
* the trained-GP flagship in mixed mode (phase 4, mixed; horizon
  MIXED_NH): an f64 master refreshed on the card, then steady-state steps
  whose rollout runs in
  double-float32 through the df32 cov kernels, held to the card's own
  float64 plan of the same steps (MIXED_TOL); where the first step's a_opt
  differs from the f64 plan's, its f64 plan is replayed with parts of the
  mixed objective and optimizer, to show which of them moves a_opt
  (``a_opt_witness``);
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
  restart each side keeps is printed; then the controller is saved to an
  .npz and restored into a fresh controller on the card, whose tensors and
  forward-only ``Planner.evaluate`` must equal the original's bit for bit;
* the on-device episodes (phase 8): a two-seed mixed mountain-car sweep
  through ``runner.episode.build_episodes_batch_fn`` with the set-up of
  ``python -m gpmpc_tpu_torch.eval_sample_efficiency --env mountain_car
  --dtype mixed`` cut to SWEEP_STEPS steps: random evaluations at t = 0, 5,
  10 and 15, one f64 training on the card at t = 19 and one planned step
  of two restarts at t = 20, every rollout step through the whole-step
  kernels at ns = 2, d = 3; each seed's plan is held to the card's f64 plan
  of the same memory, trained parameters, state and inits; then the same
  sweep in f32 (``--dtype float32``, the CLI's default: each refresh one
  Gram launch for both seeds' memories, an f32 training, the rollout
  through #2 and #3), held to the card's f64 plans by F32_SWEEP_TOL;
* the multi-device path (phase 9): a one-rank NCCL group on the card (an
  in-process HashStore, destroyed at the end of the phase), the port's
  ``parallel.sharding.dryrun_training_step`` on it, then the N-sharded mixed
  plan (``build_nsharded_plan_fn``: the f64 master factorized whole, iK cut
  to the rank's row slab, the df32 cov kernels run through the shard-mapped
  core, the Gram and whole-step kernels off) of phase 4's trained-GP step,
  held to phase 4's card f64 plan by MIXED_TOL and to phase 4's residual
  plan's launch counts, its gap to phase 4's own mixed plan printed. One
  card runs no multi-rank collective: NCCL refuses two ranks on one card;
* the time-varying process-control example (phase 10): its env and
  configuration in mixed mode through ``run_env_multiple``, two runs of
  PC_STEPS steps (a random step, the plant's parameters redrawn, an MLL
  training waited for, one planned step of two restarts on the trained
  parameters), every rollout step through the whole-step kernels at ns = 2,
  d = 5 with the raw step index as the time input; each run's plan is held
  to the card's f64 plan of the same memory, parameters, state and inits,
  and its launches exactly.

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
rectangular slabs, the batch axis (#12, #8 and #9 at N = 32 and 128, #10
and #11 at N = 192 and 384, at B = 2 and 4, a shared cache and per-seed
caches, and #1 on batches of memories, each element bit for bit its single
launch; device ms at B = 1, 2, 4 and 8 beside the bound times B), and #2,
#3, #5, #6 and #7 on the N-sharded cores' row slabs (RECT_SPLITS), each slab against the plain twins and the slabs'
combined outputs and gradients against the square launch's, with #3's and
#7's rectangular backwards timed beside their square launches, and the
process-control path's ns = 2 instances (check_ns2_kernels: #12, #8 and #9
at d = 5 with a raw time column, #2, #3, #5, #6 and #7 at P = 3 in the 192
bucket), each timed beside its bound; it also reports the launch floor (an empty kernel,
plainly and as a programmatic dependent), and the launch shape, time and
bound of the ten kernels redesigned for the H100 (#9 df_mm_bwd, #6
df_fwdres, #12 df_mm_full, #2 cov_fwd, #5 df_fwd, #3 cov_bwd_row, both sides
in one launch, #11 df_mm_bwd_pair and #10 df_mm_bwd_mean at N = 192 and 384,
#10 beside its latency floor, #1 gram and #4 cov_gik beside the launch
floor) beside unchanged kernels timed in the same run, and the times of #12
at N = 32 and 96 and of #2 at N = 32. Phase 4 also holds the launch
counts of #5 and #3 on their paths, phase 5 those of #10 and #11, phase 6
those of #12, #8 and #9 in each controller step, phase 7 those of the
mountain-car episode, phase 8 those of the sweep and phase 10 those of each
process-control run and its planned step (EXPECTED_LAUNCHES). Phase 5
times the blocked planning step of the paths and 15-step rollouts of the
mixed routes at ROLLOUT_BUCKETS; at 384 the whole-step route's
value-and-grad rollout runs the split backward, once for one restart and
once for two restarts in one batch (each restart's gradient bit for bit
its single rollout's), and the gradients are held to the df cov route's and
to the f64 rollout's. Phase 6 times each controller
step (blocked) and the training on its thread, phase 7 the episode, its
planned step and its random steps (blocked), phase 8 each seed's episode
and training (blocked) and the sweep's aggregate env steps per second,
phase 10 each run, its planned step and its training (blocked).

Output: one line per phase with its elapsed seconds; then the card's name and
power limit, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is present or any phase fails. A watchdog ends a hung run
with a traceback after ``WATCHDOG_S`` seconds.
"""

from __future__ import annotations

import contextlib
import faulthandler
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from gpmpc_tpu_torch import GpMpcController, ops, run_env, run_env_multiple
from gpmpc_tpu_torch.controllers import planner as planner_mod
from gpmpc_tpu_torch.controllers.lbfgs import lbfgs_b_minimize
from gpmpc_tpu_torch.controllers.planner import Planner, _cast_cache, _objective_and_info
from gpmpc_tpu_torch.envs import MountainCarContinuousEnv, PendulumEnv
from gpmpc_tpu_torch.eval_sample_efficiency import sweep_setup
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
from gpmpc_tpu_torch.parallel import sharding
from gpmpc_tpu_torch.runner import episode as episode_mod
from gpmpc_tpu_torch.runner.episode import build_episodes_batch_fn

WATCHDOG_S = 175  # a little under the 180 s budget of a cold run
# Depths of the paths. A cold run took 102-160 s on H100 hosts of different
# speed (the f32 step 416-848 ms) with 5, 10 and 2 here, so they were cut to
# keep a slow host well inside WATCHDOG_S; no path or check was dropped.
# The controller (phase 6, ~22 s on the card) took a cold run to ~165 s on
# one host, so three more depths were cut: TIMED_STEPS from 5 to 3, and the
# horizon of the stacked-VJP mixed plan (STACKED_NH) and of the whole-step
# plan at 128 (FUSED_NH) from 15 to 5. Phase 8 (the sweep) took a cold run on
# a slow host past the watchdog (phase 7 ended at 174.8 s there), so the
# residual mixed plan's horizon (MIXED_NH) was cut from 15 to 5 as well
# (its plan and the a_opt witness took 48.6 s of that run); phase 6 plans
# through the whole-step path at 15. Phase 9 (the N-sharded plan) and the
# row-slab checks of phase 3 added ~10 s, which would have put a cold run on
# that slow host at ~160-164 s, so the a_opt witness, a printed diagnostic,
# now runs only where the mixed a_opt differs from the f64 plan's (at
# horizon 5 it does not; the witness took 6.6 s of a 134 s cold run).
# Phase 7 (the mountain-car episode through run_env) has one cut of its own,
# the example's L-BFGS-B budget (MC_MAXFUN); phase 8 (the sweep) takes the
# same cut and those listed at SWEEP_SEEDS. Phase 10 (the process-control
# runs) and phase 3's ns = 2 checks took a cold run on a slow host to 170.1 s
# (phase 9 ended at 160.4 s there, 112.7 s on another host), so phase 10 was
# cut first (see PC_RUNS), then three earlier depths: PLAN_STEPS and
# TIMED_STEPS from 3 to 2 and CONTROLLER_PLANNED from 2 to 1. With
# CONTROLLER_PLANNED at 2 (its second step 3.2 s and its f64 comparison
# ~2 s on the card) that slow host is estimated at ~168 s, past the 165 s
# the cuts aim under; with 1, at ~162 s (PERF.md, section 6). Both are
# estimates: no run has measured the final tree on that host. The f32 sweep
# (phase 8), the batch checks of #10, #11 and #1 (phase 3) and the
# two-restart rollout (phase 5) added ~8 s on a fast host, so phase 5's
# rollouts at N = 128 (timings only, no check; 6.2 s there) were cut
# (ROLLOUT_BUCKETS).
PLAN_STEPS = 2
TIMED_STEPS = 2
MIXED_STEPS = 1  # trained-GP flagship steps in mixed mode, each checked and timed
FUSED_STEPS = 1  # whole-step path steps, each checked and timed
MIXED_NH = 5
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
# launch each; the residual mixed plan, at horizon MIXED_NH = 5, runs 5
# value-and-grad evaluations through df_fwdres and the forward-only one of
# its result through df_fwd: 5, and df_fwdres 25 (75 and 75 at horizon 15,
# where it took 4 more forward-only trials; the plain twins on the CPU count
# the same); phase 9's N-sharded plan of the same step launches the same. The
# stacked plan, at horizon STACKED_NH = 5, runs 5
# value-and-grad evaluations and the forward-only one of its result, each
# forward through df_fwd: 30 (150 at horizon 15; the plain twins on the CPU
# take the same line-search decisions). The plans have run these
# evaluations in every run on the card. Phase 5's
# whole-step value-and-grad rollout at 384 runs one split backward per step
# (#10, then #11) of its 15.
# Phase 6's controller steps, each a 15-step rollout per evaluation: a warmup
# step one forward-only rollout (15 df_mm_full); a planned step runs df_mm_full
# in every rollout and df_mm_fwd and df_mm_bwd in the backward of each
# value-and-grad one: the planned step 5 value-and-grad evaluations, 3
# forward-only line-search trials and the rollout of its result (a second
# planned step, warm-started from the first plan, before the cut of
# CONTROLLER_PLANNED: 3, 3 and 1; 105 / 45 / 45, also on the card after the
# cut) (the same counts on the plain twins on the CPU, by the same
# line-search decisions).
# Phase 7's mountain-car episode, each rollout 12 steps: the random steps 0,
# 5, 10 and 15 one forward-only rollout each (48 df_mm_full); the planned
# step two restarts in one lockstep batch, 4 value-and-grad evaluations of
# the batch (MC_MAXFUN = 3 ends each restart after its first evaluation and
# three accepted line searches; no forward-only trial) and the rollout of its
# result: 5 x 12 df_mm_full, 4 x 12 df_mm_fwd and df_mm_bwd (the same counts
# on the plain twins on the CPU).
# Phase 8's sweep, each rollout 10 steps, the two seeds in lockstep: the
# random evaluations at t = 0, 5, 10 and 15 one batched rollout each (40
# df_mm_full; the training at t = 19 runs in f64, no kernel) and the planned
# step at t = 20, the seeds' two restarts each in one batch of four, as phase
# 7's (5 x 10 df_mm_full, 4 x 10 df_mm_fwd and df_mm_bwd), counted on the
# plain twins on the CPU with the whole-step dispatch on.
# The f32 sweep (the same cuts, in f32): 5 refreshes of both seeds'
# memories (the random evaluations at t = 0, 5, 10 and 15, the planned step
# at t = 20), each one Gram launch for both seeds; the rollouts through #2
# and #3 with the seeds folded into the pair axis, as the mixed sweep's
# through #12, #8 and #9: 90 cov_fwd, 40 cov_bwd_row (the f32 training runs
# the plain Gram of its MLL, no kernel), counted on the plain twins on the
# CPU with the f32 cov core's dispatch patched on: 5 / 90 / 40. The card
# takes one more value-and-grad batch and one more forward-only trial in
# the planned step's line searches (110 / 50): the f32 objective after the
# training is ill-conditioned (F32_SWEEP_TOL), so the kernels' summation
# order moves the line search's decisions, as in phase 10's run 0. The
# card's kernels sum in a fixed order, so the card repeats it; those are the
# counts held here.
# Phase 10's process-control runs, each rollout 5 steps: the random steps 0,
# 10 and 20 one forward-only rollout each (15 df_mm_full); the planned step
# 30 two restarts in one lockstep batch, 3 value-and-grad evaluations of the
# batch (15 df_mm_fwd and df_mm_bwd; no forward-only trial) and the rollout of
# its result (20 df_mm_full), counted on the plain twins on the CPU with the
# whole-step dispatch on. Run 0's planned step counts the same there, but not
# on the card: its second restart's second value-and-grad evaluation rounds
# to the same f32 objective as the first (the df32 objective's own error,
# ~1e-7 of it, decides the rounding), so that restart's line
# search finds no decrease and backtracks 14 times, forward only, and fails:
# 3 value-and-grad and 14 forward-only batches and the rollout of the
# result, 90 / 15 / 15. The card's kernels sum in a fixed
# order, so the card repeats it; those are the counts held here.
EXPECTED_LAUNCHES = {"cov_bwd_row per f32 plan": 30, "df_fwd per residual mixed plan": 5,
                     "df_fwdres per residual mixed plan": 25,
                     "df_fwd per stacked mixed plan": 30, "df_mm_bwd_mean per split rollout": 15,
                     "df_mm_bwd_pair per split rollout": 15,
                     "controller warmup step": {"df_mm_full": 15},
                     "controller planned steps": ({"df_mm_full": 135, "df_mm_fwd": 75, "df_mm_bwd": 75},),
                     "mountain-car episode": {"df_mm_full": 108, "df_mm_fwd": 48, "df_mm_bwd": 48},
                     "mountain-car sweep": {"df_mm_full": 90, "df_mm_fwd": 40, "df_mm_bwd": 40},
                     "mountain-car f32 sweep": {"gram": 5, "cov_fwd": 110, "cov_bwd_row": 50},
                     "process-control run": {
                         "planned steps": (({"df_mm_full": 90, "df_mm_fwd": 15, "df_mm_bwd": 15},),
                                           ({"df_mm_full": 20, "df_mm_fwd": 15, "df_mm_bwd": 15},)),
                         "runs": ({"df_mm_full": 105, "df_mm_fwd": 15, "df_mm_bwd": 15},
                                  {"df_mm_full": 35, "df_mm_fwd": 15, "df_mm_bwd": 15})}}

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
# the random operand sets drawn not to cancel, held to MIN_RESOLVED: the
# flagship's shapes and the ns = 2 (P = 3) shapes of the process-control path
RESOLVED_LABELS = ("random", "random P=3")
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
# the time-varying process-control path's shapes (ns = 2, P = 3; d = 5 with
# the raw time column): #12, #8 and #9 at these N, and #2, #3, #5, #6 and #7
# on a step of a cache of PC_CACHE_POINTS points (the 1500-step workload's
# last, stored every 10 steps) in its bucket, past 128 (check_ns2_kernels)
PC_DF_MM_SIZES = (32, RAGGED_N)
PC_CACHE_POINTS, PC_CACHE_BUCKET = 150, 192
FULL_EPS = 4 * 2.0 ** -23
# launches of each whole-step wrapper (the split route's cotangent cat apart)
LAUNCHES_PER_CALL = {"df_mm_full": 2, "df_mm_fwd": 2, "df_mm_bwd": 2, "df_mm_bwd_mean": 1, "df_mm_bwd_pair": 3}
# the whole-step path (phase 4): the trained-GP problem at 100 points in the
# 128 bucket, where the card's dispatch takes it (ops.use_df_fused)
FUSED_POINTS, FUSED_BUCKET = 100, 128
# phase 5's 15-step rollouts of each route, at 384, where the whole-step
# route's backward runs split (64 was dropped to keep the cold run well
# inside WATCHDOG_S, 139 s on a slow host; 128, timings only, to make room
# for the f32 sweep and the batch checks: 6.2 s of a ~120 s cold run on a
# fast host)
ROLLOUT_BUCKETS = (384,)

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
# until it is swapped in, then CONTROLLER_PLANNED planned steps (2 before
# the cut above). The one reduction: training_frequency is 10 in place of
# the example's 25, so that training fires right after the warmup. With at most 32 stored points every
# rollout step takes the whole-step path (ops.use_df_fused); each step's
# launches are held in EXPECTED_LAUNCHES.
CONTROLLER_WARMUP = 10
CONTROLLER_PLANNED = 1
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

# The mountain-car sweep through runner/episode.py (phase 8): the set-up of
# ``python -m gpmpc_tpu_torch.eval_sample_efficiency --env mountain_car
# --dtype mixed`` (eval_sample_efficiency.sweep_setup: the example's
# configuration at repeat 5 and its default horizon 10, the env in f64, the
# f64 master and training with a df32 rollout), the episodes of seeds
# SWEEP_SEEDS run by build_episodes_batch_fn on the card. Random evaluations
# at t = 0, 5, 10 and 15 (warmup 20), one synchronous f64 training on the
# card at t = 19, one planned step of two restarts at t = 20 on the trained
# GP. cap 32 and model_cap 32: every rollout step runs #12 (#8 and #9 in
# the backward) at ns = 2, d = 3. Cuts: 500 steps to SWEEP_STEPS, 10 seeds
# to 2, training_frequency 60 to SWEEP_TRAINING_FREQUENCY (so that the
# training fires inside the cut episode) and the L-BFGS-B budget 8 to
# MC_MAXFUN, as in phase 7; iter_train keeps its 20 (400 L-BFGS iterations
# at most per model).
SWEEP_SEEDS = (0, 1)
SWEEP_STEPS = 25
SWEEP_TRAINING_FREQUENCY = 20
# The same sweep in f32 (phase 8, f32): ``--dtype float32``, the CLI's
# default (env, refresh, training and rollout in f32), at the same cuts.
# Its plans against the card's f64 plans, MIXED_TOL's gaps: after the
# training at t = 19 the f32 plan is ill-conditioned in both packages. At
# seed 0's planned step (4 points) JAX's own f32 objective misses its f64
# one by 3.1e-2 and its gradient by 2.8e-2 (on the CPU, the port's inputs);
# the port's f32 cache and JAX's each miss the f64 cache by 2.6e-4 in beta,
# and at seed 1 a change of the f32 cache at the level of its rounding
# (3.8e-7 of iK, the port's against JAX's) moved the port's objective by
# 2.7e-4. The port measured objective 9.5e-2, gradient 1.4e-1, info 2.4e-1
# and plan 1.4e-3 at seed 0 on the CPU (2.7e-4, 1.4e-5, 5.6e-6, -6.7e-6 at
# seed 1), so the card's summation order may move the first three as far
# again: they are held to about 3x those. The plan gap (the f64 objective at
# the f32 plan against the f64 plan's) stays well conditioned and is held as
# MIXED_TOL holds it. The kernels themselves are held in phase 3.
F32_SWEEP_TOL = {"objective": 0.3, "gradient": 0.5, "info": 0.75, "plan": 1e-2}

# The time-varying process-control example through run_env_multiple (phase
# 10): examples/process_control/run_process_control_multiple_torch.py's env
# and configuration in mixed mode (Ns=2, Na=2, the time model: D = 5 with the
# raw step index as the last input, horizon 5, repeat 10, two L-BFGS-B
# restarts), PC_RUNS runs (seeds 0 and 1) on the card. A run: PC_WARMUP
# random steps (a forward-only rollout at steps 0, 10 and 20), the plant's
# parameters redrawn after its steps 14 and 29, the training dispatched after
# step 29 (f64, on the controller's CPU thread, on the three stored points
# (0 -> 10, 10 -> 20, 20 -> 30): time column 0, 10, 20, the last two across
# or after a redraw) and waited for before step 30, whose plan of two
# restarts runs on the trained parameters. Cuts: 10 runs to PC_RUNS, 1000
# steps to PC_STEPS, the plant's period_change 500 to PC_PERIOD_CHANGE and
# training_frequency 15 to PC_TRAINING_FREQUENCY (so that both fall inside
# the cut run, before its one planned step) and the L-BFGS-B budget 15 to
# PC_MAXFUN (3 in phases 7-8); the random warmup goes from the example's 10
# to PC_WARMUP steps, so that the training and the plan see more than one
# point; iter_train keeps its 15 (at 5 the training kept its initial
# parameters). Three stored points sit in the 32 bucket: every rollout step
# runs #12 (#8 and #9 in the backward) at ns = 2, d = 5. Earlier versions
# planned at steps 10 and 20 (21 steps, training every 15, budget 3), then
# at step 10 only on one stored point; one planned step at budget 3 took the
# phase 9.7 s of a 170.1 s cold run on a slow host (PERF.md, section 6).
PC_RUNS, PC_WARMUP, PC_STEPS, PC_PERIOD_CHANGE, PC_TRAINING_FREQUENCY, PC_MAXFUN = 2, 30, 31, 15, 30, 2
PC_EXAMPLE = "examples/process_control/run_process_control_multiple_torch.py"

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
    cast as the planner casts it (split into df32 in mixed mode), at the
    problem's step index (``iter_ctrl``, the time model's input; 0 unless
    given)."""
    a = actions.detach().clone().requires_grad_(True)
    cost, _ = _objective_and_info(prob.spec, _cast_cache(cache, prob.state_mu.dtype), a, prob.state_mu,
                                  prob.state_var, prob.action_prev, getattr(prob, "iter_ctrl", 0))
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
    (df_mm_bwd_mean, csrc/df_mm.cuh mean_point and df_mm_bwd.cuh
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
    lane's mean_point and VJP (csrc/df_mm.cuh, df_mm_bwd.cuh mean_item), the
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

    def record(*args):
        seen.append(args)
        return moment_cov.cov_core_ref(*args)

    with ops.override_cov_core(record), torch.no_grad():
        _objective_and_info(prob.spec, cache, prob.inits[0], prob.state_mu, prob.state_var, prob.action_prev, 0)
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
    b, by = cov_bwd_bound(p, n, n, ns_, nd)
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

    # the N-sharded core's row slabs: #2 and #3 on them, their partials and
    # gradients combined as the sharded core combines them, and #3 timed
    for label, operands in (("flagship", cov_flag), ("random", cov_rand)):
        for name, e in zip(("cov_fwd", "cov_bwd_row"), check_cov_rect(label, operands, diag_pos)):
            results[name]["err"] = max(results[name]["err"], e)
    log(f"kernel cov_bwd_row rectangular slabs (both sides, one launch each; P={p}, ns={ns_}): " + ", ".join(
        rect_time(lambda o: moment_cov.cov_bwd(g, *o, g_corr, diag_pos), cov_flag, ROW_ARGS_COV, IK_ARGS_COV, k,
                  lambda nr: cov_bwd_bound(p, nr, n, ns_, nd)) for k in RECT_SPLITS)
        + f"; square {n} x {n} {results['cov_bwd_row']['ms']:.4f} ms (bound {results['cov_bwd_row']['bound_ms']:.5f})")
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
    if label in RESOLVED_LABELS and not resolved >= MIN_RESOLVED:
        raise AssertionError(f"{what} [{label}]: output {resolved:.3e} of its scale, not resolvable")
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
    if label in RESOLVED_LABELS and float(scale.abs().max()) > 0 and not resolved >= MIN_RESOLVED:
        raise AssertionError(f"{what} [{label}]: output {resolved:.3e} of its scale, not resolvable")
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
    ns = args[4].shape[2]
    names = ["A1", "A2"] + [f"B1_{e}" for e in range(ns)] + [f"B2_{e}" for e in range(ns)]
    names_c = ["C1", "C2"] + [f"D1_{e}" for e in range(ns)] + [f"D2_{e}" for e in range(ns)]
    err_res = 0.0
    for outs, refs, scales, nm in ((rows, rows_r, row_abs, names), (cols, cols_r, col_abs, names_c)):
        for k in range(0, len(outs), 2):
            err_res = max(err_res, hold_df(f"df_fwdres {nm[k // 2]}", label, outs[k], outs[k + 1],
                                           refs[k], refs[k + 1], scales[k]))
    if label in RESOLVED_LABELS:
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


def df_cov_bound(name, p, n, ns, nd) -> tuple[float, str]:
    """bound_ms of a square df cov launch (df_fwd, df_fwdres or df_bwd): its
    operands read once and its outputs written once, against its non-FMA f32
    instructions (``df_instructions_per_element``) over every element of the
    (P, N, N) slab."""
    per, per_diag = df_instructions_per_element(ns)[name]
    in_bytes = 4 * 2 * (4 * p * n + 2 * p * n * ns + nd * n * n)
    if name == "df_bwd":
        return bound_ms(in_bytes + 4 * 2 * p + 4 * 2 * p * n * (1 + ns), 2 * (p * per + nd * per_diag) * n * n,
                        H100_F32_INSTR_PER_S)
    out_bytes = 4 * 2 * (2 * p + nd) if name == "df_fwd" else 4 * 2 * 2 * (2 + 2 * ns) * p * n
    return bound_ms(in_bytes + out_bytes, (p * per + nd * per_diag) * n * n, H100_F32_INSTR_PER_S)


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
    for i, (name, kern, plain) in enumerate((("df_fwd", df_cov.df_cov_fwd, df_cov.df_cov_fwd_plain),
                                            ("df_fwdres", df_cov.df_cov_fwdres, df_cov.df_cov_fwdres_plain))):
        ms, host = cuda_ms(lambda: kern(*flag, diag_pos))
        plain_ms = event_ms(lambda: plain(*flag, diag_pos))
        per, per_diag = counts[name]
        b, by = df_cov_bound(name, p, n, ns, nd)
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
    b, by = df_cov_bound("df_bwd", p, n, ns, nd)
    log(f"kernel df_bwd (2P={2 * p} stacked rows, N={n}, ns={ns}): kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"bound {b:.5f} ms ({by}: {per} + {per_diag} on diagonal pairs f32 instructions per element of each side "
        f"over {H100_F32_INSTR_PER_S:.3g}/s); host {host:.4f} ms per call")
    results["df_bwd"] = dict(err=err_bwd, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)

    # the N-sharded core's row slabs: #5, #6 and #7 on them, their partials
    # and gradients combined as the sharded core combines them, #7 timed
    for label, args in (("flagship", flag), ("random", rand)):
        e_fwd, e_res, e_bwd = check_df_rect(label, args, diag_pos)
        for name, e in (("df_fwd", e_fwd), ("df_fwdres", e_res), ("df_bwd", e_bwd)):
            results[name]["err"] = max(results[name]["err"], e)

    def df_bwd_bound(nr):
        in_r = 4 * 2 * (2 * p * (nr + n) + p * (nr + n) * ns + nd * nr * n)
        return bound_ms(in_r + 4 * 2 * p + 4 * p * (nr + n) * (1 + ns), 2 * (p * per + nd * per_diag) * nr * n,
                        H100_F32_INSTR_PER_S)

    log(f"kernel df_bwd rectangular slabs (one launch per side; P={p}, ns={ns}): " + ", ".join(
        rect_time(lambda o: df_cov.df_cov_bwd(*o, gs, gco, diag_pos), flag, ROW_ARGS_DF, IK_ARGS_DF, k, df_bwd_bound)
        for k in RECT_SPLITS) + f"; square {n} x {n} {ms:.4f} ms (one launch, bound {b:.5f})")
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


def hold_grad(what, label, out, ref, scale=None) -> float:
    """Hold a gradient to DF_GRAD_TOL of its largest entry (or of the
    largest entry of ``scale``)."""
    abs_e, rel_e = max_err(out, ref, scale)
    log(f"kernel {what} [{label}]: max abs err {abs_e:.3e} = {rel_e:.3e} of max |grad| (tol {DF_GRAD_TOL})")
    if not rel_e <= DF_GRAD_TOL:
        raise AssertionError(f"{what} [{label}] disagrees")
    return abs_e


# The N-sharded cores' row slabs (phase 3): the rows of a 2- and a 4-way
# split of the 384 bucket, 192 x 384 and 96 x 384, on the flagship's
# operands and random ones. Each slab is held to the plain twins by the
# square kernels' tolerances; the slabs' partials, combined as the sharded
# cores combine them (S_p and corr summed over the slabs in rank order, the
# df ones by the df tree of parallel/sharding.py), and their gradients (the
# row side's concatenated, the column side's summed) to the square launch's
# outputs. A column-side gradient summed over slabs in f32 rounds by eps32
# of the sum of the slabs' |partials|, which on the flagship's cancelling
# operands exceeds the output itself: the df ones are held to DF_GRAD_TOL
# of the larger of the two.
RECT_SPLITS = (2, 4)
ROW_ARGS_COV, IK_ARGS_COV = (0, 2, 4), (6,)
ROW_ARGS_DF, IK_ARGS_DF = (0, 1, 4, 5, 8, 9), (12, 13)


def row_slab(operands, k, r, row_args, ik_args):
    """Rank r's operands of a k-way split of the stored points: the row
    operands' and iK's rows r N / k .. (r + 1) N / k, the column operands
    whole."""
    n = operands[row_args[0]].shape[1]
    rows = slice(r * n // k, (r + 1) * n // k)
    return [t[:, rows].contiguous() if i in row_args or i in ik_args else t for i, t in enumerate(operands)]


def cov_bwd_bound(p, nr, nc, ns, nd) -> tuple[float, str]:
    """#3 on Nr rows against Nc columns, both sides: the operands and iK
    read once, the six gradients written once; E, its two products and the
    ns-contraction's FMAs for each element of each side."""
    io = 4 * (p + nd + 2 * p * (nr + nc) + p * (nr + nc) * ns + nd * nr * nc + 2 * p * (nr + nc) + p * (nr + nc) * ns)
    return bound_ms(io, 2 * (p * nr * nc * (4 * ns + 8) + nd * nr * nc * 3))


def rect_time(call, operands, row_args, ik_args, k, bound) -> str:
    """``call`` on rank 0's slab of a k-way split, timed: 'Nr x Nc t ms
    (bound b ms)'."""
    slab = row_slab(operands, k, 0, row_args, ik_args)
    nr, nc = slab[row_args[0]].shape[1], operands[row_args[0]].shape[1]
    ms, _ = cuda_ms(lambda: call(slab))
    return f"{nr} x {nc} {ms:.4f} ms (bound {bound(nr)[0]:.5f})"


def check_cov_rect(label, operands, diag_pos) -> tuple[float, float]:
    """#2 and #3 on each slab of each split against their plain twins
    (check_cov_fwd, check_cov_bwd), then the split's combined S_p, corr and
    gradients against the square launch's, each to COV_TOL of the square
    output's sum of |terms|. Returns the largest errors of (#2, #3) against
    their plain twins on the slabs."""
    a, c, u, xj, bi, bj, ik = operands
    p, n = a.shape
    w_s = torch.linspace(1.0, 2.0, p, device=a.device)
    w_c = torch.linspace(1.0, 3.0, len(diag_pos), device=a.device)
    gco = _scatter_diag(w_c, p, diag_pos)
    s_abs, co_abs = moment_cov.cov_fwd_abs_terms(*operands, diag_pos)
    row = moment_cov.cov_bwd_row_abs_terms(w_s, a, c, u, xj, bi, bj, ik, gco, diag_pos)
    col = moment_cov.cov_bwd_row_abs_terms(w_s, c, a, xj, u, bj, bi, ik.transpose(1, 2), gco, diag_pos)
    fwd = moment_cov.cov_fwd(*operands, diag_pos)
    bwd = moment_cov.cov_bwd(w_s, *operands, w_c, diag_pos)
    e_fwd = e_bwd = 0.0
    for k in RECT_SPLITS:
        slabs = [row_slab(operands, k, r, ROW_ARGS_COV, IK_ARGS_COV) for r in range(k)]
        tag = f"{label} {n // k}x{n}"
        for r, slab in enumerate(slabs):
            e_fwd = max(e_fwd, check_cov_fwd(f"{tag} slab {r}", slab, diag_pos))
            ops.reset_launch_counts()
            e_bwd = max(e_bwd, check_cov_bwd(f"{tag} slab {r}", slab, diag_pos))
            # the kernel's call, its repeat and CovCore's backward: one launch each, both sides
            if ops.launch_counts()["cov_bwd_row"] != 3:
                raise AssertionError(f"cov_bwd_row on a slab launched {ops.launch_counts()['cov_bwd_row']} times, "
                                     f"expected 3")
        parts = [moment_cov.cov_fwd(*slab, diag_pos) for slab in slabs]
        grads = [moment_cov.cov_bwd(w_s, *slab, w_c, diag_pos) for slab in slabs]
        combined = (sum(q[0] for q in parts), sum(q[1] for q in parts))
        for what, out, ref, scale in zip(("S_p", "corr"), combined, fwd, (s_abs, co_abs)):
            hold_cov(f"cov_fwd {what}, {k} slabs summed, against the square launch", label, out, ref, scale)
        names = ("ga", "gc", "gU", "gXj", "gbi", "gbj")
        for i, (name, ref, scale) in enumerate(zip(names, bwd, (row[0], col[0], row[1], col[1], row[2], col[2]))):
            # even outputs: the row side's, concatenated; odd: the column side's, summed
            out = torch.cat([q[i] for q in grads], dim=1) if i % 2 == 0 else sum(q[i] for q in grads)
            hold_cov(f"cov_bwd_row {name}, {k} slabs combined, against the square launch", label, out, ref, scale)
    return e_fwd, e_bwd


def check_df_rect(label, args, diag_pos) -> tuple[float, float, float]:
    """#5, #6 and #7 on each slab of each split against their plain twins
    (check_df_operands, check_df_bwd: two launches a slab, one a side), then
    the split's df partials combined by the sharded core's df tree
    (``sharding.df_tree_axis0``) against the square launch's S_p and corr,
    its residuals (the row side's concatenated, the column side's df-summed
    in rank order) against the square's, each to DF_TOL of the square
    output's sum of |terms|, and its stacked-backward gradients (the row
    side's concatenated, the column side's summed) to DF_GRAD_TOL. Returns
    the largest errors of (#5, #6, #7) against their plain twins on the
    slabs."""
    p, n = args[0].shape
    dev = args[0].device
    w = torch.linspace(1.0, 2.0, p, device=dev)
    gco = _scatter_diag(torch.linspace(1.0, 3.0, len(diag_pos), device=dev), p, diag_pos)
    (s_abs, co_abs), (row_abs, col_abs) = df_cov.df_cov_abs_terms(*args, diag_pos)
    fwd = df_cov.df_cov_fwd(*args, diag_pos)
    rows_sq, cols_sq = df_cov.df_cov_fwdres(*args, diag_pos)
    bwd = df_cov.df_cov_bwd(*args, w, gco, diag_pos)
    e_fwd = e_res = e_bwd = 0.0
    for k in RECT_SPLITS:
        slabs = [row_slab(args, k, r, ROW_ARGS_DF, IK_ARGS_DF) for r in range(k)]
        tag = f"{label} {n // k}x{n}"
        for r, slab in enumerate(slabs):
            ef, er = check_df_operands(f"{tag} slab {r}", slab, diag_pos)
            ops.reset_launch_counts()
            e_bwd = max(e_bwd, check_df_bwd(f"{tag} slab {r}", slab, diag_pos))
            # one launch per side, for the kernel's call and the stacked composite's backward
            if ops.launch_counts()["df_bwd"] != 4:
                raise AssertionError(f"df_bwd on a slab launched {ops.launch_counts()['df_bwd']} times, expected 4")
            e_fwd, e_res = max(e_fwd, ef), max(e_res, er)
        parts = [df_cov.df_cov_fwd(*slab, diag_pos) for slab in slabs]
        sh, sl = sharding.df_tree_axis0(torch.stack([q[0] for q in parts]), torch.stack([q[1] for q in parts]))
        ch, cl = sharding.df_tree_axis0(torch.stack([q[2] for q in parts]), torch.stack([q[3] for q in parts]))
        hold_df(f"df_fwd S_p, {k} slabs by the df tree, against the square launch", label, sh, sl, fwd[0], fwd[1],
                s_abs)
        hold_df(f"df_fwd corr, {k} slabs by the df tree, against the square launch", label, ch, cl, fwd[2], fwd[3],
                co_abs)
        res = [df_cov.df_cov_fwdres(*slab, diag_pos) for slab in slabs]
        for j in range(0, len(rows_sq), 2):
            rh, rl = (torch.cat([q[0][j + h] for q in res], dim=1) for h in (0, 1))
            chh, cll = sharding.df_tree_axis0(torch.stack([q[1][j] for q in res]),
                                               torch.stack([q[1][j + 1] for q in res]))
            hold_df(f"df_fwdres row residual {j // 2}, {k} slabs, against the square launch", label, rh, rl,
                    rows_sq[j], rows_sq[j + 1], row_abs[j] + 1e-300)
            hold_df(f"df_fwdres column residual {j // 2}, {k} slabs, against the square launch", label, chh, cll,
                    cols_sq[j], cols_sq[j + 1], col_abs[j] + 1e-300)
        grads = [df_cov.df_cov_bwd(*slab, w, gco, diag_pos) for slab in slabs]
        for i, (name, ref) in enumerate(zip(("ga", "gc", "gU", "gXj"), bwd)):
            if i % 2 == 0:
                out, scale = torch.cat([q[i] for q in grads], dim=1), None
            else:
                out = sum(q[i] for q in grads)
                scale = torch.maximum(ref.abs().max(), sum(q[i].abs() for q in grads).max()).expand_as(ref)
            hold_grad(f"df_bwd {name}, {k} slabs combined, against the square launch", label, out, ref, scale)
    return e_fwd, e_res, e_bwd


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
    mu, var = seen[-1]  # a rollout of one runs as a batch of one
    mu, var = mu.reshape(mu.shape[-1:]), var.reshape(var.shape[-2:])
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


def df_mm_bound(name, n, ns, d) -> tuple[float, str, str]:
    """bound_ms of a whole-step wrapper at (N, ns, d): its operands read once
    and its outputs written once, against its non-FMA f32 instructions per
    slab element (#10: per model and point), and what was counted."""
    p = ns * (ns + 1) // 2
    in_bytes = 4 * 2 * (n * d + 3 * ns * d + ns + ns * n + ns * n * n) + 4 * (d + ns * ns + 2 * ns ** 3
                                                                           + 2 * p * ns * ns)
    out_bytes = {"df_mm_full": 4 * (ns + ns * d + p), "df_mm_fwd": 4 * 2 * (2 * ns + ns * d + p),
                 "df_mm_bwd": 4 * (d + ns ** 3 + p * ns * ns), "df_mm_bwd_mean": 4 * (2 * d + ns ** 3),
                 "df_mm_bwd_pair": 4 * (2 * p * d + p * ns * ns)}
    if name == "df_mm_bwd_mean":
        per = mean_vjp_instructions(ns, d)
        ops_, what = ns * n * per, f"{per} f32 instructions per (model, point)"
    else:
        per, per_diag = df_instructions_per_element(ns)[name]
        ops_ = (p * per + ns * per_diag) * n * n
        what = (f"{per} + {per_diag} on diagonal pairs f32 instructions per slab element; the per-point "
                f"work is not counted")
    nbytes = (4 * 2 * (n * d + 3 * ns * d + ns + ns * n) + 4 * (d + 2 * ns ** 3) if name == "df_mm_bwd_mean"
              else in_bytes) + out_bytes[name]  # the mean path reads no iK and no Q
    return (*bound_ms(nbytes, ops_, H100_F32_INSTR_PER_S), what)


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
        for name in names:
            kern, plain = calls[name]
            ms, host = cuda_ms(kern)
            plain_ms = event_ms(plain)
            b, by, what = df_mm_bound(name, n, ns, d)
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


def process_control_cache(n_points, bucket, seed):
    """A float64 factorization cache, on the CPU, of the time-varying
    process-control workload's shapes (Ns=2, Na=2, the time model: D = 5):
    ``n_points`` points stored every 10 steps, so that the last input column
    holds the raw step index 0, 10, 20, ..., states in [0.3, 0.7] changing by
    ~1e-2, actions in [0, 1], padded to ``bucket``; lengthscales inside the
    example's bounds (0.25-2 on the states and actions, 50-1000 on time),
    its initial outputscale 0.05 and noise 1e-5. Returns (cache, mu (D,), sv
    (Ns, Ns)) of a planning step at the next stored step, in f64."""
    rng = np.random.default_rng(seed)
    ns, d = 2, 5
    x, y = np.zeros((bucket, d)), np.zeros((bucket, ns))
    x[:n_points, :ns] = rng.uniform(0.3, 0.7, (n_points, ns))
    x[:n_points, ns:d - 1] = rng.uniform(0, 1, (n_points, d - 1 - ns))
    x[:n_points, -1] = 10.0 * np.arange(n_points)
    y[:n_points] = rng.normal(0, 1e-2, (n_points, ns))
    mask = np.arange(bucket) < n_points
    ls = np.concatenate([rng.uniform(0.25, 2.0, (ns, d - 1)), rng.uniform(50, 1000, (ns, 1))], axis=1)
    f64 = dict(dtype=torch.float64)
    bounds = gp_mod.GPBounds(
        torch.tensor([[5e-2] * (d - 1) + [5.0]] * ns, **f64), torch.tensor([[25.0] * (d - 1) + [1000.0]] * ns, **f64),
        torch.full((ns,), 1e-5, **f64), torch.full((ns,), 0.95, **f64), torch.full((ns,), 1e-6, **f64),
        torch.full((ns,), 0.09, **f64))
    params = gp_mod.params_from_constrained(torch.tensor(ls, **f64), torch.full((ns,), 5e-2, **f64),
                                            torch.full((ns,), 1e-5, **f64), bounds)
    cache = gp_mod.masked_cholesky_factorize(params, bounds, torch.tensor(x), torch.tensor(y), torch.tensor(mask))
    mu = torch.tensor(np.concatenate([rng.uniform(0.4, 0.6, ns), rng.uniform(0, 1, d - 1 - ns),
                                      [10.0 * n_points + 5]]))
    sv = torch.tensor(np.eye(ns) * 1e-4 + 2e-5)
    return cache, mu, sv


def shape_line(info) -> str:
    return (f"{info['registers']} registers, {info['threads']} threads, {info['blocks_per_sm']} blocks per SM, grid "
            f"{info['grid']} = {info['waves']:.2f} waves")


def check_ns2_kernels(dev) -> dict:
    """The kernels of the time-varying process-control path at ns = 2 against
    their plain twins on the card, on operands of a process-control cache
    with its raw time column: #12, #8 and #9 at d = 5 at N = 32 and RAGGED_N
    (and on random operands of those shapes), #5, #6 and #7 on the df cov
    core's operands of a step of a PC_CACHE_POINTS-point cache in the
    PC_CACHE_BUCKET bucket (past 128, where the dispatch sends a mixed step
    to them), and #2 and #3 on the f32 cov core's operands of the same step;
    each also on random operands of its shapes whose outputs do not cancel
    (label ``random P=3``). Prints each kernel's time, launch shape and
    bound. Returns the largest error of each kernel."""
    errs = {}

    def keep(name, e):
        errs[name] = max(errs.get(name, 0.0), e)

    for n in PC_DF_MM_SIZES:
        cache64, mu, sv = process_control_cache(int(0.8 * n), n, seed=n)
        cache = _cast_cache(_to_device(cache64, dev), torch.float32)
        mu, sv = mu.to(dev, torch.float32), sv.to(dev, torch.float32)
        for label, operands in ((f"process-control ns=2 d=5, time to {10 * int(0.8 * n) + 5}", (cache, mu, sv)),
                                ("random ns=2 d=5", random_df_mm_problem(dev, n, seed=n + 5, ns=2, d=5))):
            for name, e in zip(("df_mm_full", "df_mm_fwd", "df_mm_bwd"), check_df_mm_operands(label, *operands)):
                keep(name, e)
        ns, d = cache.ils_hi.shape
        ii, jj, _, _ = df_mm.pair_indices(ns, dev)
        Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
        p = Qh.shape[0]
        g = (torch.ones(ns, device=dev), torch.ones(ns, d, device=dev), torch.ones(p, device=dev),
             -torch.ones(ns, device=dev))
        sms = _build.sm_count(dev)
        shapes = {"df_mm_full": shape_line(df_mm.full_launch_info(n, ns)),
                  "df_mm_fwd": f"#12's grid, {df_mm.fwd_launch_plan(n, ns, sms)['rows_per_warp']} rows per warp",
                  "df_mm_bwd": shape_line(df_mm.bwd_launch_info(n, ns))}
        for name, call in (("df_mm_full", lambda: df_mm.full_step_fwd(mu, sv, cache)),
                           ("df_mm_fwd", lambda: df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache)),
                           ("df_mm_bwd", lambda: df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g))):
            ms, _ = cuda_ms(call)
            b, by, _ = df_mm_bound(name, n, ns, d)
            log(f"kernel {name} at ns=2 (P={p}, N={n}, d={d}, process-control operands): {ms:.4f} ms (device, "
                f"{LAUNCHES_PER_CALL[name]} launches; {shapes[name]}) bound {b:.5f} ms ({by})")

    cache64, mu, sv = process_control_cache(PC_CACHE_POINTS, PC_CACHE_BUCKET, seed=PC_CACHE_POINTS)
    ns, d = sv.shape[0], mu.shape[0]
    var = torch.zeros(d, d, dtype=torch.float64)
    var[:ns, :ns] = sv
    seen, seen_df = [], []
    with torch.no_grad(), ops.override_cov_core(lambda *a: seen.append(a) or ops.cov_core_ref(*a)):
        gp_mod.moment_match(cache64, mu, var)
    with torch.no_grad(), ops.override_df_cov_core(lambda *a: seen_df.append(a) or ops.df_cov_core_ref(*a)):
        gp_mod.moment_match_df(gp_mod.split_cache_df(cache64), mu.float(), var.float())
    *cov_t, diag_pos = seen[-1]
    cov_pc = [t.to(device=dev, dtype=torch.float32).contiguous() for t in cov_t]
    *df_t, diag_pos_df = seen_df[-1]
    df_pc = [t.to(dev).contiguous() for t in df_t]
    p, n = cov_pc[0].shape
    nd = len(diag_pos)
    where = f"{PC_CACHE_POINTS} process-control points in the {n} bucket, time to {10 * PC_CACHE_POINTS + 5}"
    cov_rand = random_cov_operands(dev, p, n, ns, diag_pos, seed=n + 7)
    df_rand = random_df_operands(dev, p, n, ns, diag_pos_df, seed=n + 8)
    for label, operands in ((where, cov_pc), ("random P=3", cov_rand)):
        keep("cov_fwd", check_cov_fwd(label, operands, diag_pos))
        keep("cov_bwd_row", check_cov_bwd(label, operands, diag_pos))
    for label, args in ((where, df_pc), ("random P=3", df_rand)):
        e_fwd, e_res = check_df_operands(label, args, diag_pos_df)
        keep("df_fwd", e_fwd)
        keep("df_fwdres", e_res)
        keep("df_bwd", check_df_bwd(label, args, diag_pos_df))

    g_s = torch.linspace(1.0, 2.0, p, device=dev)
    g_c = torch.linspace(1.0, 3.0, nd, device=dev)
    gco = _scatter_diag(g_c, p, diag_pos_df)
    timed = (("cov_fwd", lambda: moment_cov.cov_fwd(*cov_pc, diag_pos), cov_fwd_bound(p, n, ns, nd),
              shape_line(moment_cov.fwd_launch_info(p, n, ns))),
             ("cov_bwd_row", lambda: moment_cov.cov_bwd(g_s, *cov_pc, g_c, diag_pos), cov_bwd_bound(p, n, n, ns, nd),
              shape_line(moment_cov.bwd_launch_info(p, n, ns))),
             ("df_fwd", lambda: df_cov.df_cov_fwd(*df_pc, diag_pos_df), df_cov_bound("df_fwd", p, n, ns, nd),
              shape_line(df_cov.fwd_launch_info(p, n, diag_pos_df, ns))),
             ("df_fwdres", lambda: df_cov.df_cov_fwdres(*df_pc, diag_pos_df), df_cov_bound("df_fwdres", p, n, ns, nd),
              shape_line(df_cov.fwdres_launch_info(p, n, nd, ns))),
             ("df_bwd", lambda: df_cov.df_cov_bwd(*df_pc, g_s, gco, diag_pos_df), df_cov_bound("df_bwd", p, n, ns, nd),
              "one launch"))
    for name, call, (b, by), shape in timed:
        ms, _ = cuda_ms(call)
        log(f"kernel {name} at ns=2 (P={p}, N={n}, process-control operands): {ms:.4f} ms (device; {shape}) bound "
            f"{b:.5f} ms ({by})")
    return errs


# The batch axis of #12, #8 and #9 (phase 3): B elements in one launch,
# each with its own mu, state covariance (and B^-1, Q, cotangents), against
# one shared cache (a plan's restarts) or against C = 2 caches, element b
# reading cache b / (B / C) (an episode batch's seeds, restarts inner). Each
# element equals its own single launch bit for bit (the launch plans one
# element; nothing is summed across elements), at every N, ns and d of the
# paths; the batched launch is held to the batched plain twin within DF_TOL,
# FULL_EPS and DF_GRAD_TOL at BATCH_TWIN (B, cache) pairs. BATCH_TIMES: the
# batches timed at N = 128 against their bound times B. FOLD_N: the bucket
# of the folded df cov core check (#5, #6 at B = 2: the batch folded into
# the pair axis, the bands planned for one element).
BATCH_SIZES = (2, 4)
BATCH_TWIN = ((2, "shared"), (4, "per-seed"))
BATCH_TIMES = (1, 2, 4, 8)
BATCH_NS_D = ((3, 4), (2, 5))
BATCH_N = (32, 128)
FOLD_N = 192
# The split backward past N = 128 (#10, #11) takes the same batch axis: at
# B = BATCH_SIZES, N = SPLIT_SIZES, a shared cache and per-seed caches, each
# element bit for bit its single launch (#10 and #11 apart and the split
# route), the batch held to its batched plain twins by DF_GRAD_TOL of each
# output's largest entry (check_df_mm_split's) at BATCH_TWIN; the Gram (#1)
# at B = BATCH_SIZES of memories with their own parameters at the
# flagship's 384 and at a ragged N, each element bit for bit its single
# launch and the batch within GRAM_RTOL, GRAM_ATOL of gram_ref; each timed
# at B = BATCH_TIMES beside its bound times B (#10, #11 at N = 384 on the
# trained-GP operands, #1 at 3 x 384 x 384).


def stacked_cache(caches, index, dev):
    """The caches stacked on a leading axis, element b reading cache index[b]."""
    fields = {f: torch.stack([getattr(c, f) for c in caches]).contiguous()
              for f in df_mm._CACHE_FIELDS + ("outs",)}
    return SimpleNamespace(index=torch.tensor(index, dtype=torch.int32, device=dev), **fields)


def batch_elements(dev, b, ns, d, seed):
    """b elements' mu (b, d) and state covariances (b, ns, ns), each its own."""
    rng = np.random.default_rng(seed)
    mu = torch.tensor(rng.uniform(0.3, 0.7, (b, d)), dtype=torch.float32, device=dev)
    sv = torch.tensor(np.stack([np.eye(ns) * 1e-2 * (1 + 0.2 * k) + 2e-3 for k in range(b)]), dtype=torch.float32,
                      device=dev)
    return mu, sv


def batch_cotangents(dev, b, ns, d):
    """Fixed cotangents g_M, g_V, g_S_p, g_corr of b elements, each its own."""
    p = ns * (ns + 1) // 2
    scale = torch.linspace(1.0, 1.5, b, device=dev)
    return [scale.reshape((b,) + (1,) * len(shape)) * torch.linspace(lo, hi, k, device=dev).reshape(shape)
            for lo, hi, k, shape in ((1.0, 2.0, ns, (ns,)), (-1.0, 1.0, ns * d, (ns, d)), (1.0, 2.0, p, (p,)),
                                     (-1.0, -2.0, ns, (ns,)))]


def check_batch(label, bcache, caches, index, mu, sv, twin) -> tuple[float, float, float]:
    """#12, #8 and #9 on a batch: each element bit for bit its own single
    launch on its own cache, and (``twin``) the batch within tolerance of
    the batched plain twin. Returns the three kernels' max abs errors to the
    twin (0 where not held to it)."""
    b, d = mu.shape
    ns = sv.shape[-1]
    ii, jj, diag, _ = df_mm.pair_indices(ns, mu.device)
    Bh, Bl, c32, Qh, Ql, sdr = df_mm.df_stage1(bcache, sv, ii, jj)
    g = batch_cotangents(mu.device, b, ns, d)
    calls = {"df_mm_full": (lambda: df_mm.full_step_fwd(mu, sv, bcache),
                            lambda k, c: df_mm.full_step_fwd(mu[k], sv[k], c),
                            lambda: df_mm.full_step_plain(mu, sv, bcache)),
             "df_mm_fwd": (lambda: df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, bcache),
                           lambda k, c: df_mm.stage23_fwd(mu[k], Bh[k], Bl[k], Qh[k], Ql[k], c),
                           lambda: df_mm.stage23_plain(mu, Bh, Bl, Qh, Ql, bcache)),
             "df_mm_bwd": (lambda: df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, bcache, *g),
                           lambda k, c: df_mm.stage23_bwd_all(mu[k], Bh[k], Bl[k], Qh[k], Ql[k], c,
                                                              *(t[k] for t in g)),
                           lambda: df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, bcache, *g))}
    errs = []
    for name, (batched, single, plain) in calls.items():
        before = df_mm.LAUNCHES[name]
        out = batched()
        if df_mm.LAUNCHES[name] != before + 1:
            raise AssertionError(f"{name} [{label}]: the batch of {b} took {df_mm.LAUNCHES[name] - before} launches")
        for k in range(b):
            one = single(k, caches[index[k]])
            if not all(torch.equal(o[k], r) for o, r in zip(out, one)):
                raise AssertionError(f"{name} [{label}]: element {k} of the batch of {b} differs from its single "
                                     f"launch")
        if not twin:
            errs.append(0.0)
            continue
        ref = plain()
        worst, err = 0.0, 0.0
        for k in range(b):
            c = caches[index[k]]
            m_abs, v_abs, sp_abs, co_abs = df_mm.abs_terms(mu[k], Bh[k], Bl[k], Qh[k], Ql[k], c)
            if name == "df_mm_fwd":
                for j, scale in enumerate((m_abs, v_abs, sp_abs, co_abs)):
                    o = out[2 * j][k].double() + out[2 * j + 1][k].double()
                    r = ref[2 * j][k].double() + ref[2 * j + 1][k].double()
                    e, rel = max_err(o, r, scale)
                    err, worst = max(err, e), max(worst, rel / DF_TOL)
            elif name == "df_mm_full":
                sp_scale = (sp_abs + torch.zeros_like(sp_abs).index_add(0, diag, co_abs)) / sdr[k].double()
                for o, r, scale in zip(out, ref, (m_abs * c32[k].double(), v_abs * c32[k].double()[:, None],
                                                  sp_scale)):
                    diff = (o[k].double() - r[k].double()).abs()
                    err = max(err, float(diff.max()))
                    worst = max(worst, float((diff / (FULL_EPS * r[k].double().abs() + DF_TOL * scale)).max()))
            else:
                for o, r in zip(out, ref):
                    e, rel = max_err(o[k], r[k])
                    err, worst = max(err, e), max(worst, rel / DF_GRAD_TOL)
        if not worst <= 1.0:
            raise AssertionError(f"{name} [{label}]: the batch of {b} disagrees with its batched plain twin "
                                 f"({worst:.3e} of its tolerance)")
        log(f"kernel {name} batch [{label}]: max abs err to the batched plain twin {err:.3e}, {worst:.3e} of its "
            f"tolerance")
        errs.append(err)
    return tuple(errs)


def check_folded_df_cov(dev) -> None:
    """#5 and #6 on two elements' df cov operands folded into one launch's
    pair axis (``models.gp._batched_cov_core``: pairs b P + p, iK stacked,
    diag_pos shifted, the bands planned for one element) against one launch
    per element, bit for bit, in the FOLD_N bucket."""
    ns, n = 3, FOLD_N
    diag_pos = tuple(int(q) for q in df_mm.pair_indices(ns, dev)[3])
    p = ns * (ns + 1) // 2
    elems = [random_df_operands(dev, p, n, ns, diag_pos, seed=n + 11 + k) for k in range(2)]
    folded = [torch.cat(parts).contiguous() for parts in zip(*elems)]
    fold_diag = diag_pos + tuple(p + q for q in diag_pos)
    out = df_cov.df_cov_fwd(*folded, fold_diag, batch=2)
    ones = [df_cov.df_cov_fwd(*e, diag_pos) for e in elems]
    same = all(torch.equal(out[j][k * p:(k + 1) * p], ones[k][j]) for k in range(2) for j in range(2)) \
        and all(torch.equal(out[j][k * len(diag_pos):(k + 1) * len(diag_pos)], ones[k][j]) for k in range(2)
                for j in range(2, 4))
    rows, cols = df_cov.df_cov_fwdres(*folded, fold_diag, batch=2)
    res = [df_cov.df_cov_fwdres(*e, diag_pos) for e in elems]
    same_res = all(torch.equal(t[k * p:(k + 1) * p], r) for k in range(2)
                   for got, want in ((rows, res[k][0]), (cols, res[k][1])) for t, r in zip(got, want))
    fwd_ms, _ = cuda_ms(lambda: df_cov.df_cov_fwd(*folded, fold_diag, batch=2))
    one_ms, _ = cuda_ms(lambda: df_cov.df_cov_fwd(*elems[0], diag_pos))
    res_ms, _ = cuda_ms(lambda: df_cov.df_cov_fwdres(*folded, fold_diag, batch=2))
    res1_ms, _ = cuda_ms(lambda: df_cov.df_cov_fwdres(*elems[0], diag_pos))
    log(f"kernel df_fwd and df_fwdres folded (B=2, P={2 * p}, N={n}): bit for bit with one launch per element: "
        f"{same}, {same_res}; device ms {fwd_ms:.4f} and {res_ms:.4f} against {one_ms:.4f} and {res1_ms:.4f} for "
        f"one element")
    if not (same and same_res):
        raise AssertionError("a folded df cov launch differs from its single launches")


def check_batched_kernels(dev) -> dict:
    """Phase 3's batch axis: #12, #8 and #9 at B = BATCH_SIZES, a shared
    cache and per-seed caches, at N = BATCH_N and (ns, d) = BATCH_NS_D
    (``check_batch``); #10 and #11 the same at N = SPLIT_SIZES
    (``check_split_batch``); #1 on batches of memories
    (``check_gram_batch``); the folded df cov core (``check_folded_df_cov``);
    then device ms per call at B = BATCH_TIMES, each beside its bound times
    B: #10, #11 and #1 (``time_split_and_gram_batches``), #12, #8 and #9 at
    N = 128 on the trained-GP operands. Returns each kernel's largest error
    to its batched twin."""
    errs = {}
    for n in BATCH_N:
        for ns, d in BATCH_NS_D:
            caches = [random_df_mm_problem(dev, n, seed=n + 31 * c + ns, ns=ns, d=d)[0] for c in range(2)]
            for b in BATCH_SIZES:
                mu, sv = batch_elements(dev, b, ns, d, seed=n + b + ns)
                for mode in ("shared", "per-seed"):
                    index = [0] * b if mode == "shared" else [k * 2 // b for k in range(b)]
                    bcache = caches[0] if mode == "shared" else stacked_cache(caches, index, dev)
                    label = f"B={b}, {mode} cache, N={n}, ns={ns}, d={d}"
                    out = check_batch(label, bcache, caches, index, mu, sv, (b, mode) in BATCH_TWIN)
                    for name, e in zip(("df_mm_full", "df_mm_fwd", "df_mm_bwd"), out):
                        errs[name] = max(errs.get(name, 0.0), e)
            log(f"kernel df_mm_full, df_mm_fwd, df_mm_bwd batch (N={n}, ns={ns}, d={d}): B = "
                f"{', '.join(map(str, BATCH_SIZES))} with a shared cache and with per-seed caches, each element bit "
                f"for bit its own single launch")
    for n in SPLIT_SIZES:
        caches = [random_df_mm_problem(dev, n, seed=n + 31 * c)[0] for c in range(2)]
        for b in BATCH_SIZES:
            mu, sv = batch_elements(dev, b, 3, 4, seed=n + b)
            for mode in ("shared", "per-seed"):
                index = [0] * b if mode == "shared" else [k * 2 // b for k in range(b)]
                bcache = caches[0] if mode == "shared" else stacked_cache(caches, index, dev)
                out = check_split_batch(f"B={b}, {mode} cache, N={n}", bcache, caches, index, mu, sv,
                                        (b, mode) in BATCH_TWIN)
                for name, e in zip(("df_mm_bwd_mean", "df_mm_bwd_pair"), out):
                    errs[name] = max(errs.get(name, 0.0), e)
        log(f"kernel df_mm_bwd_mean, df_mm_bwd_pair batch (N={n}, ns=3, d=4): B = "
            f"{', '.join(map(str, BATCH_SIZES))} with a shared cache and with per-seed caches, each element bit for "
            f"bit its own single launch (#10, #11 and the split route)")
    errs["gram"] = check_gram_batch(dev)
    check_folded_df_cov(dev)
    time_split_and_gram_batches(dev)
    cache, mu1, sv1 = trained_gp_step_inputs(dev, 128)
    ns, d = cache.ils_hi.shape
    for b in BATCH_TIMES:
        off = torch.linspace(0.0, 2e-3, b, device=dev)
        mu = (mu1 + off[:, None]).contiguous()
        sv = (sv1 * (1 + off[:, None, None])).contiguous()
        ii, jj, _, _ = df_mm.pair_indices(ns, dev)
        Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
        g = batch_cotangents(dev, b, ns, d)
        times = []
        for name, call in (("df_mm_full", lambda: df_mm.full_step_fwd(mu, sv, cache)),
                           ("df_mm_fwd", lambda: df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache)),
                           ("df_mm_bwd", lambda: df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g))):
            ms, _ = cuda_ms(call)
            bound, _, _ = df_mm_bound(name, 128, ns, d)
            times.append(f"{name} {ms:.4f} ms (bound x B {bound * b:.5f} ms)")
        log(f"kernel batch B={b} (N=128, trained-GP operands, one shared cache): " + ", ".join(times))
    return errs


def check_split_batch(label, bcache, caches, index, mu, sv, twin) -> tuple[float, float]:
    """#10 and #11 on a batch past N = 128: each element of the batched
    wrappers (``stage23_bwd_mean``, ``stage23_bwd_pairs``) and of the split
    route (``stage23_bwd``: #10, then #11 with the df combination) bit for
    bit its own single call on its own cache, one launch of each kernel per
    batched call; with ``twin``, each output within DF_GRAD_TOL of its
    largest entry of the batched plain twins (the mean path's and the pairs'
    df contributions collapsed in f64, g_B, g_Q, and the route's g_mu
    against ``combine_split`` of the twins). Returns #10's and #11's max abs
    errors to the twins (0 where not held to them)."""
    b, d = mu.shape
    ns = sv.shape[-1]
    ii, jj, _, _ = df_mm.pair_indices(ns, mu.device)
    Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(bcache, sv, ii, jj)
    g = batch_cotangents(mu.device, b, ns, d)
    names = ("df_mm_bwd_mean", "df_mm_bwd_pair", "df_mm_bwd")
    before = {k: df_mm.LAUNCHES[k] for k in names}
    m_inp, g_b = df_mm.stage23_bwd_mean(mu, Bh, Bl, bcache, g[0], g[1])
    p_inp, g_q = df_mm.stage23_bwd_pairs(mu, Qh, Ql, bcache, g[2], g[3])
    split = df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, bcache, *g)
    launched = {k: df_mm.LAUNCHES[k] - before[k] for k in names}
    if launched != {"df_mm_bwd_mean": 2, "df_mm_bwd_pair": 2, "df_mm_bwd": 0}:
        raise AssertionError(f"split batch [{label}]: three batched calls launched {launched}")
    for k in range(b):
        c = caches[index[k]]
        one_m = df_mm.stage23_bwd_mean(mu[k], Bh[k], Bl[k], c, g[0][k], g[1][k])
        one_p = df_mm.stage23_bwd_pairs(mu[k], Qh[k], Ql[k], c, g[2][k], g[3][k])
        one_s = df_mm.stage23_bwd(mu[k], Bh[k], Bl[k], Qh[k], Ql[k], c, *(t[k] for t in g))
        for name, got, want in (("df_mm_bwd_mean", (*m_inp, g_b), (*one_m[0], one_m[1])),
                                ("df_mm_bwd_pair", (*p_inp, g_q), (*one_p[0], one_p[1])),
                                ("split route", split, one_s)):
            if not all(torch.equal(x[k], y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} [{label}]: element {k} of the batch of {b} differs from its single "
                                     f"launch")
    if not twin:
        return 0.0, 0.0

    def v(x):
        return x[0].double() + x[1].double()

    ref_m = df_mm.stage23_vjp_mean_plain(mu, Bh, Bl, bcache, g[0], g[1])
    ref_p = df_mm.stage23_vjp_pairs_plain(mu, Qh, Ql, bcache, g[2], g[3])
    ref_s = (df_mm.combine_split(ref_m[0], ref_p[0]), ref_m[1], ref_p[1])
    errs, worst = [0.0, 0.0], 0.0
    for k in range(b):
        for j, pairs in enumerate(((v(m_inp), v(ref_m[0])), (g_b, ref_m[1]), (v(p_inp), v(ref_p[0])), (g_q, ref_p[1]),
                                   *zip(split, ref_s))):
            e, rel = max_err(pairs[0][k], pairs[1][k])
            if j < 4:
                errs[j // 2] = max(errs[j // 2], e)
            worst = max(worst, rel / DF_GRAD_TOL)
    if not worst <= 1.0:
        raise AssertionError(f"split batch [{label}]: the batch of {b} disagrees with its batched plain twins "
                             f"({worst:.3e} of DF_GRAD_TOL)")
    log(f"kernel df_mm_bwd_mean, df_mm_bwd_pair batch [{label}]: max abs err to the batched plain twins "
        f"{errs[0]:.3e}, {errs[1]:.3e}; {worst:.3e} of DF_GRAD_TOL")
    return errs[0], errs[1]


def check_gram_batch(dev) -> float:
    """#1 on a batch of memories with their own parameters (an f32 episode
    batch's refresh) at the flagship's 3 x 384 and at a ragged N: one
    launch, each element bit for bit its single launch, the batch within
    GRAM_RTOL and GRAM_ATOL of the batched gram_ref. Returns the max abs
    error."""
    ns, d, n = 3, 4, 384
    sizes = (n, ragged_n(lambda m: gram_mod.launch_plan(ns, m, _build.sm_count(dev))["rows"]))
    err = 0.0
    for m in sizes:
        for b in BATCH_SIZES:
            rng = np.random.default_rng(m + b)
            ls, outs, x = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (
                rng.uniform(0.3, 2.0, (b, ns, d)), rng.uniform(0.02, 0.4, (b, ns)), rng.uniform(0, 1, (b, m, d))))
            before = gram_mod.LAUNCHES["gram"]
            k_out = gram_mod.gram(ls, outs, x)
            if gram_mod.LAUNCHES["gram"] != before + 1:
                raise AssertionError(f"gram: the batch of {b} took {gram_mod.LAUNCHES['gram'] - before} launches")
            for e in range(b):
                if not torch.equal(k_out[e], gram_mod.gram(ls[e], outs[e], x[e])):
                    raise AssertionError(f"gram: element {e} of the batch of {b} (N={m}) differs from its single "
                                         f"launch")
            k_ref = gram_mod.gram_ref(ls, outs, x)
            excess = float(((k_out - k_ref).abs() - (GRAM_ATOL + GRAM_RTOL * k_ref.abs())).max())
            if not excess <= 0.0:
                raise AssertionError(f"gram: the batch of {b} (N={m}) disagrees with the batched gram_ref")
            err = max(err, max_err(k_out, k_ref)[0])
    log(f"kernel gram batch ({ns} models, N = {', '.join(map(str, sizes))}): B = {', '.join(map(str, BATCH_SIZES))}, "
        f"one launch each, each element bit for bit its single launch; max abs err to the batched gram_ref {err:.3e} "
        f"(tol atol {GRAM_ATOL} + rtol {GRAM_RTOL})")
    return err


def time_split_and_gram_batches(dev) -> None:
    """Device ms per call of #10 and #11 (N = 384, trained-GP operands, one
    shared cache) and of #1 (3 x 384 x 384, one memory's parameters for
    every element) at B = BATCH_TIMES, each beside its bound times B."""
    cache, mu1, sv1 = trained_gp_step_inputs(dev, 384)
    ns, d = cache.ils_hi.shape
    n = cache.x_hi.shape[0]
    ii, jj, _, _ = df_mm.pair_indices(ns, dev)
    prob = flagship_problem(dev, torch.float32)
    ls1, outs1, _ = constrained_params(prob.params, prob.bounds)
    x1 = torch.as_tensor(prob.x, dtype=torch.float32, device=dev)
    gram_bound, _ = bound_ms(4 * (ns * d + ns + n * d + ns * n * n), ns * n * n * (8 * d + 6))
    for b in BATCH_TIMES:
        off = torch.linspace(0.0, 2e-3, b, device=dev)
        mu = (mu1 + off[:, None]).contiguous()
        sv = (sv1 * (1 + off[:, None, None])).contiguous()
        Bh, Bl, _, Qh, Ql, _ = df_mm.df_stage1(cache, sv, ii, jj)
        g = batch_cotangents(dev, b, ns, d)
        ls, outs, x = (t.expand((b,) + t.shape).contiguous() for t in (ls1, outs1, x1))
        times = []
        for name, call in (("df_mm_bwd_mean", lambda: df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1])),
                           ("df_mm_bwd_pair", lambda: df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3]))):
            ms, _ = cuda_ms(call)
            bound, _, _ = df_mm_bound(name, n, ns, d)
            times.append(f"{name} {ms:.4f} ms (bound x B {bound * b:.5f} ms)")
        ms, _ = cuda_ms(lambda: gram_mod.gram(ls, outs, x))
        times.append(f"gram {ms:.4f} ms (bound x B {gram_bound * b:.5f} ms)")
        log(f"kernel batch B={b} (N={n}, trained-GP operands, one shared cache; the Gram at {ns}x{n}x{n}): "
            + ", ".join(times))


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
    each step (printed only); then ``a_opt_witness`` on the first step
    where its a_opt gap is not 0 (at 0 it has nothing to explain, and its
    four replays took 6.6 s of a cold run). Returns the gaps and the mixed
    gradient at the initial actions."""
    ref_prob, ref_planner = ref.prob, ref.planner
    f_card, g_card = objective_and_grad(prob, planner._cache, prob.inits[0])

    def f64_at(a):
        with torch.no_grad():
            return _objective_and_info(ref_prob.spec, ref_planner._cache, a.to(torch.float64), ref_prob.state_mu,
                                       ref_prob.state_var, ref_prob.action_prev, getattr(ref_prob, "iter_ctrl", 0))

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
    if witness and a_gaps[0] > 0:
        a_opt_witness(prob, ref_prob, ref.cache0, ref.plans[0][0], plans[0][0])
    elif witness:
        log("  a_opt witness skipped: the mixed plan's a_opt is the f64 plan's, there is no gap to explain")
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


def elementwise_matmul(a, b):
    """a (..., m, k) @ b (..., k, n) by scalar products of slices added in
    the order of k, so that an element of a batch gets the bits it gets
    alone, forward and backward (elementwise ops only; on the card a cuBLAS
    product of (B, 3, 4) @ (B, 4, 3) rounds differently at B = 1 and 2)."""
    rows = []
    for i in range(a.shape[-2]):
        cols = []
        for c in range(b.shape[-1]):
            acc = a[..., i, 0] * b[..., 0, c]
            for j in range(1, a.shape[-1]):
                acc = acc + a[..., i, j] * b[..., j, c]
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def time_rollouts(dev, card):
    """Phase 5's rollout timings: one 15-step rollout of the trained-GP
    problem at each of ROLLOUT_BUCKETS (0.8 N points, 300 in 384) at the initial actions,
    through ``moment_match_df_fused`` and through ``moment_match_df``, each
    called directly, forward-only and value-and-grad (the gradient in the
    actions); at 384 also ``moment_match_df`` under the stacked df32 VJP
    (value-and-grad: its forward is the df cov route's). Blocked ms (host
    clock, ended by a synchronize) of one rollout each, after one
    forward-only warm-up rollout of each route. Every rollout runs as a
    batch (one rollout as a batch of one, as ``predict_trajectory`` runs
    it). At 384 the whole-step route's value-and-grad rollout of a batch of
    two restarts (the initial actions and their mirror 1 - a, as a plan's
    restarts roll out in lockstep) is the split backward's driven path: its
    launch counts are set to 0 just before it and read just after
    (returned); each restart's gradient must equal the single rollout's of
    the same init bit for bit (these three rollouts form the covariance
    recursion's products by ``elementwise_matmul``, so that only the port's
    own operations could tell a batch from its elements), and the gradients
    are held to the df cov route's and to the card's f64 rollout's by
    MIXED_TOL["gradient"]."""
    split_launches = None
    for n in ROLLOUT_BUCKETS:
        prob = trained_gp_problem(dev, n_points=min(300, int(0.8 * n)), bucket=n)
        cache = _cast_cache(Planner(prob.spec, dtype=torch.float32, device=dev, master_dtype=torch.float64)
                            .refresh_cache(prob.x, prob.y, prob.mask, prob.params, prob.bounds), torch.float32)
        ns, d = cache.ils_hi.shape

        def rollout(mm, cache, prob, grad, inits=None, matmul=torch.matmul):
            inits = prob.inits[:1] if inits is None else inits
            a = inits.reshape(inits.shape[0], -1, 1).clone().requires_grad_(grad)
            mu = prob.state_mu.expand(a.shape[0], ns)
            var = prob.state_var.expand(a.shape[0], ns, ns)
            with torch.set_grad_enabled(grad):
                for t in range(a.shape[1]):
                    input_var = torch.nn.functional.pad(var, (0, d - ns, 0, d - ns))
                    dmu, dvar, v = mm(cache, torch.cat([mu, a[:, t]], dim=-1), input_var)
                    sv = input_var[..., :ns, :]
                    mu, var = mu + dmu, dvar + var + matmul(sv, v) + matmul(v.transpose(-1, -2), sv.transpose(-1, -2))
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
                    split = grad and route == "fused" and n == 384
                    if split:
                        ops.reset_launch_counts()
                    t0 = time.perf_counter()
                    grads[route] = rollout(mm, cache, prob, grad, matmul=elementwise_matmul if split else torch.matmul)
                    times[(route, grad)] = (time.perf_counter() - t0) * 1e3
                    if split:
                        single_launches = ops.launch_counts()
            finally:
                df_cov.VJP_MODE = "residual"
        if n == 384:  # the split backward's driven path: two restarts in one batch
            inits2 = torch.cat([prob.inits, 1 - prob.inits])
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            g_batch = rollout(gp_mod.moment_match_df_fused, cache, prob, True, inits2, elementwise_matmul)
            times[("fused, 2 restarts", True)] = (time.perf_counter() - t0) * 1e3
            split_launches = ops.launch_counts()
            g_second = rollout(gp_mod.moment_match_df_fused, cache, prob, True, inits2[1:], elementwise_matmul)
        log(f"phase 5 rollout N={n} ({prob.n_points} points), 15 steps, blocked ms: " + ", ".join(
            f"{route} {'value-and-grad' if grad else 'forward'} {ms:.2f}" for (route, grad), ms in times.items())
            + f" on {card}")
        if n == 384:
            log(f"  launches in the whole-step value-and-grad rollout at N={n}: one restart {single_launches}, "
                f"two restarts in one batch {split_launches}")
            for counts in (single_launches, split_launches):
                for name in ("df_mm_bwd_mean", "df_mm_bwd_pair"):
                    check_launches(name, counts, EXPECTED_LAUNCHES[f"{name} per split rollout"])
                if counts["df_mm_bwd"] != 0:
                    raise AssertionError(f"kernel df_mm_bwd was launched at N={n}, past the reference's "
                                         f"single-launch range")
            same = [torch.equal(g_batch[k], one[0]) for k, one in enumerate((grads["fused"], g_second))]
            log(f"  two-restart whole-step rollout at N={n}: each restart's gradient bit for bit the single "
                f"rollout's of the same init: {same}")
            if not all(same):
                raise AssertionError(f"the batched whole-step rollout at N={n} differs from its single rollouts")
            ref_prob = trained_gp_problem(dev, dtype=torch.float64, n_points=prob.n_points, bucket=n)
            ref_cache = Planner(ref_prob.spec, dtype=torch.float64, device=dev).refresh_cache(
                ref_prob.x, ref_prob.y, ref_prob.mask, ref_prob.params, ref_prob.bounds)
            g64s = rollout(gp_mod.moment_match, ref_cache, ref_prob, True,
                           torch.cat([ref_prob.inits, 1 - ref_prob.inits])).double()
            g64 = g64s[:1]
            gaps = {f"{route} vs {other}": max_err(grads[route].double(), ref)[1]
                    for route, other, ref in (("fused", "df_cov", grads["df_cov"].double()), ("fused", "f64", g64),
                                              ("df_cov", "f64", g64), ("df_cov stacked", "f64", g64))}
            gaps.update({f"fused restart {k} of 2 vs f64": max_err(g_batch[k].double(), g64s[k])[1] for k in range(2)})
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


@contextlib.contextmanager
def record_controller_steps(wait_for_training=False):
    """While open, every GpMpcController.get_action is timed blocked and
    recorded: yields the list its records are appended to, one per step, as
    SimpleNamespace(ctrl, i (the step's iter_ctrl), secs, launches (the
    port's kernel launches of the step), planned, params (the GP parameters
    the step started on), call (the step's ``planner.plan`` arguments and
    result, as ``record_plans`` keeps them, or None), master (the planner's
    f64 factorization right after that plan), wait_s, train_s). With
    ``wait_for_training`` a planned step first waits for a dispatched
    training, timed apart (wait_s; train_s its seconds on the CPU thread)."""
    steps = []
    get_action = GpMpcController.get_action
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def recorded_get_action(ctrl, obs_mu, obs_var=None, random=False):
        planned = ctrl.iter_ctrl % ctrl.config.controller.num_repeat_actions == 0 and not random
        wait_s = None
        if wait_for_training and planned and ctrl._pending_train is not None:
            t0 = time.perf_counter()
            ctrl.wait_for_training()
            wait_s = time.perf_counter() - t0
        params, before, calls = ctrl.gp_params, ops.launch_counts(), []
        plan = ctrl.planner.plan

        def recorded_plan(*args, **kwargs):
            calls.append((args, plan(*args, **kwargs)))
            return calls[-1][1]

        ctrl.planner.plan = recorded_plan
        t0 = time.perf_counter()
        try:
            out = get_action(ctrl, obs_mu, obs_var, random)
            sync()
        finally:
            del ctrl.planner.plan
        after = ops.launch_counts()
        steps.append(SimpleNamespace(
            ctrl=ctrl, i=ctrl.iter_ctrl - 1, secs=time.perf_counter() - t0, planned=planned, params=params,
            launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
            call=calls[0] if calls else None, master=ctrl.planner._cache if calls else None,
            wait_s=wait_s, train_s=ctrl.last_train_seconds if wait_s is not None else None))
        return out

    GpMpcController.get_action = recorded_get_action
    try:
        yield steps
    finally:
        GpMpcController.get_action = get_action


def _as_dtype(tree, dtype):
    return type(tree)(*(a.to(dtype) if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in tree))


def mixed_plan_gaps(plan_spec, master_cache, call, dev, label="controller"):
    """MIXED_TOL's gaps (``compare_mixed_to_f64``) of one mixed-mode planned
    step, recorded as ``record_plans`` records it, against a float64
    Planner's plan on ``dev`` of the same memory, parameters, state, inits and
    previous action; ``master_cache`` is the f64 factorization the mixed plan
    rolled out from."""
    args, (a_opt, _, info) = call
    x_pad, y_pad, mask, params, bounds, state_mu, state_var, inits, action_prev, iter_ctrl = args
    f64 = torch.float64
    spec64 = plan_spec._replace(reward=_as_dtype(plan_spec.reward, f64), action=_as_dtype(plan_spec.action, f64))
    ref_planner = Planner(spec64, dtype=f64, device=dev)
    ref_args = [a.to(f64) for a in (state_mu, state_var, inits, action_prev)]
    a_ref, _, info_ref = ref_planner.plan(x_pad, y_pad, mask, _as_dtype(params, f64), _as_dtype(bounds, f64),
                                          *ref_args, iter_ctrl)

    def problem(spec, state_mu, state_var, inits, action_prev):
        return SimpleNamespace(spec=spec, state_mu=state_mu, state_var=state_var, inits=inits,
                               action_prev=action_prev, n_points=int(mask.sum()), x=x_pad, iter_ctrl=iter_ctrl)

    ref_prob = problem(spec64, *ref_args)
    f, g = objective_and_grad(ref_prob, ref_planner._cache, ref_prob.inits[0])
    ref = SimpleNamespace(prob=ref_prob, planner=ref_planner, plans=[(a_ref, info_ref)], f=f, g=g)
    gaps, _ = compare_mixed_to_f64(problem(plan_spec, state_mu, state_var, inits, action_prev),
                                   SimpleNamespace(_cache=master_cache), [(a_opt, info)], ref, witness=False,
                                   label=label)
    return gaps


def controller_plan_gaps(ctrl, call, dev):
    """``mixed_plan_gaps`` of a planned step of a mixed-mode controller, compared
    right after it (its planner's cache is the step's master)."""
    return mixed_plan_gaps(ctrl.plan_spec, ctrl.planner._cache, call, dev)


def check_controller_launches(kind, i, launches):
    """Controller step ``i`` launched exactly its EXPECTED_LAUNCHES and no
    other kernel of the port."""
    expected = (EXPECTED_LAUNCHES["controller warmup step"] if kind == "warmup"
                else EXPECTED_LAUNCHES["controller planned steps"][i - CONTROLLER_WARMUP])
    wrong = {k: n for k, n in launches.items() if n != expected.get(k, 0)}
    if wrong:
        raise AssertionError(f"controller {kind} step {i} launched {wrong}, expected {expected} and no other kernel")


def check_tensors_on_card(what, tensors):
    off = {str(t.device) for t in tensors if isinstance(t, torch.Tensor) and t.device.type != "cuda"}
    if off:
        raise AssertionError(f"{what} holds tensors on {off}")


def check_on_card(ctrl):
    """The controller's GP parameters and its planner's cache are on the card."""
    check_tensors_on_card("the controller's planner",
                          list(ctrl.planner._cache) + list(ctrl.gp_params) + list(ctrl.bounds))


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
    step. Hooks installed for the phase (and removed after it) record each
    step (``record_controller_steps``) and the restart each plan keeps. Holds: 21
    finite costs, the episode's launches (EXPECTED_LAUNCHES, no other
    kernel), the planner's tensors on the card, and the plan against the
    card's f64 plan of the same memory, parameters and both inits by
    MIXED_TOL."""
    cfg = mountain_car_config(len_horizon=MC_HORIZON, num_repeat_actions=MC_REPEAT, dtype="float32")
    opt = cfg.controller.actions_optimizer_params
    cfg.controller.actions_optimizer_params = {**opt, "maxfun": MC_MAXFUN, "maxiter": MC_MAXFUN}
    chosen, select = [], planner_mod._select_restart

    def recorded_select(fs):
        chosen.append((select(fs), fs.tolist()))
        return chosen[-1][0]

    planner_mod._select_restart = recorded_select
    try:
        with record_controller_steps() as steps:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            costs = run_env(MountainCarContinuousEnv(seed=0), cfg, None, random_actions_init=MC_WARMUP,
                            num_steps=MC_STEPS, verbose=False, seed=0, device=dev)
            torch.cuda.synchronize()
            episode_s = time.perf_counter() - t0
            launches = ops.launch_counts()
        ctrl = steps[0].ctrl
        planned = [i for i in range(0, MC_STEPS, MC_REPEAT) if i >= MC_WARMUP]
        for step in steps:
            if step.launches or step.i in planned:
                log(f"phase 7 run_env step {step.i} ({'planned' if step.planned else 'random'}): {step.secs:.3f} s "
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
        calls = [s.call for s in steps if s.call is not None]
        if [s.i for s in steps if s.planned] != planned or len(calls) != len(planned) or len(chosen) != len(planned):
            raise AssertionError(f"{len(calls)} plans for the planned steps {planned}")
        if ctrl.config.controller.restarts_optim != 2 or calls[0][0][7].shape[0] != 2:
            raise AssertionError("the mountain-car plan did not run two restarts")
        check_on_card(ctrl)
        check_plans([(a, info) for _, (a, _, info) in calls], ctrl.plan_spec, finite_info=True)
        t0 = time.perf_counter()
        gaps = controller_plan_gaps(ctrl, calls[0], dev)
        ref_s = time.perf_counter() - t0
    finally:
        planner_mod._select_restart = select
    (mixed_best, mixed_fs), (f64_best, f64_fs) = chosen
    log(f"phase 7 run_env restarts: mixed plan kept restart {mixed_best} of objectives {mixed_fs}, the card's f64 "
        f"plan restart {f64_best} of {f64_fs}")
    if not all(v <= MIXED_TOL[k] for k, v in gaps.items()):
        raise AssertionError(f"the mountain-car plan disagrees with the card's f64 plan beyond {MIXED_TOL}: {gaps}")
    log(f"phase 7 run_env accuracy: the planned step within {MIXED_TOL} of the card's f64 plan (made and compared "
        f"in {ref_s:.3f} s); episode {episode_s:.3f} s blocked, planned step {steps[planned[0]].secs:.3f} s, random "
        f"steps median {statistics.median(steps[i].secs for i in range(0, MC_WARMUP, MC_REPEAT)):.3f} s on {card}")
    check_checkpoint_round_trip(ctrl, cfg, dev)


def check_checkpoint_round_trip(ctrl, cfg, dev):
    """Phase 7's controller saved to an .npz and restored into a fresh
    controller on ``dev``: every restored tensor equal to the saved one and
    on the card, the memory and the warm-start state equal, and a
    forward-only ``Planner.evaluate`` of both at the saved previous actions
    equal bit for bit (both planners refactorize: the original's cache is
    dropped first, as the restore drops the fresh one's)."""
    env = MountainCarContinuousEnv(seed=0)
    box = (env.observation_space.low, env.observation_space.high, env.action_space.low, env.action_space.high)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = ctrl.save_checkpoint(os.path.join(tmp, "controller.npz"))
        size = os.path.getsize(path)
        fresh = GpMpcController(*box, cfg, seed=1, device=dev)
        fresh.restore_checkpoint(path)
    fresh.close()
    for name, saved, restored in zip(ctrl.gp_params._fields, ctrl.gp_params, fresh.gp_params):
        if not torch.equal(saved, restored):
            raise AssertionError(f"the restored {name} differs from the saved one")
    check_tensors_on_card("the restored controller", fresh.gp_params)
    for name in ("inputs", "states_next", "model_inputs", "model_targets"):
        if not np.array_equal(getattr(ctrl.memory, name), getattr(fresh.memory, name)):
            raise AssertionError(f"the restored memory's {name} differs")
    if (fresh.seed, fresh.iter_ctrl) != (ctrl.seed, ctrl.iter_ctrl) or not np.array_equal(
            fresh.actions_mpc_previous_iter, ctrl.actions_mpc_previous_iter):
        raise AssertionError("the restored controller's seed, step or warm start differs")

    def evaluate(c):
        x_pad, y_pad, mask, _ = c.memory.get_padded()
        n = c.memory.len_mem
        state_var = np.diag(np.asarray(cfg.observation.obs_var_norm, dtype=c.dtype))
        c.planner.invalidate_cache()
        return c.planner.evaluate(x_pad, y_pad, mask, c.gp_params, c.bounds, c._tensor(c.memory.states_next[n - 1]),
                                  c._tensor(state_var), c._tensor(c.actions_mpc_previous_iter),
                                  c._tensor(c.action_model_previous_iter), c.iter_ctrl)

    t1 = time.perf_counter()
    (saved_actions, saved_info), (restored_actions, restored_info) = evaluate(ctrl), evaluate(fresh)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    for name, a, b in zip(("actions",) + saved_info._fields, (saved_actions,) + saved_info,
                          (restored_actions,) + restored_info):
        if not torch.equal(a, b):
            raise AssertionError(f"Planner.evaluate of the restored controller differs in {name}")
    log(f"phase 7 checkpoint: saved ({size} bytes) and restored into a fresh controller on the card in "
        f"{t1 - t0:.3f} s; parameters, memory and warm start equal, Planner.evaluate of both at the saved previous "
        f"actions bit for bit equal ({eval_s * 1e3:.1f} ms for the two)")


def drive_sharding(dev, card, mprob, mplans, ref64):
    """Phase 9: the multi-device path on a one-rank NCCL group (a HashStore,
    destroyed at the end): the port's ``dryrun_training_step`` on the card,
    then the N-sharded mixed plan (``build_nsharded_plan_fn``) of phase 4's
    trained-GP flagship step (its memory after the step's append, its
    parameters, state and init, horizon MIXED_NH), held to phase 4's card
    f64 plan ``ref64`` by MIXED_TOL (objective and gradient at the initial
    actions through the shard-mapped cores) and to phase 4's launch counts;
    the gap to phase 4's own mixed plan is printed."""
    t0 = time.perf_counter()
    sharding.init_group(dev)
    try:
        sharding.dryrun_training_step(1, device=dev)
        t_dry = time.perf_counter() - t0
        mesh = sharding.make_mesh(1, device=dev)
        md = mprob.master_dtype
        args = (torch.tensor(mprob.x, dtype=md, device=dev), torch.tensor(mprob.y, dtype=md, device=dev),
                torch.tensor(mprob.mask, device=dev), mprob.params, mprob.bounds, mprob.state_mu, mprob.state_var,
                mprob.inits, mprob.action_prev, 0)
        plan = sharding.build_nsharded_plan_fn(mprob.spec, mesh)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        a_opt, _, info = plan(*args)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t1
        launches = ops.launch_counts()
        log(f"phase 9 main path N-sharded mixed: one rank (NCCL), {int(mprob.mask.sum())} points in the "
            f"{mprob.x.shape[0]} bucket, horizon {MIXED_NH}: {t_plan:.3f} s (blocked), launches {launches}")
        check_plans([(a_opt, info)], mprob.spec, finite_info=True)
        expected = {"df_fwd": EXPECTED_LAUNCHES["df_fwd per residual mixed plan"],
                    "df_fwdres": EXPECTED_LAUNCHES["df_fwdres per residual mixed plan"]}
        for name, count in launches.items():
            want = expected.get(name, 0)
            if count != want:
                raise AssertionError(f"kernel {name} launched {count} times on the N-sharded mixed plan, "
                                     f"expected {want} (phase 4's residual plan)")
        cov = sharding.make_shardmapped_cov_core(mesh)
        df_core = sharding.make_shardmapped_df_cov_core(mesh)
        x, y, mask = args[:3]
        with ops.disable_pallas(), ops.override_cov_core(cov), ops.override_df_cov_core(df_core):
            scache = sharding.shard_cache_n(gp_mod.masked_cholesky_factorize(mprob.params, mprob.bounds, x, y, mask),
                                            mesh)
            gaps, _ = compare_mixed_to_f64(mprob, SimpleNamespace(_cache=scache), [(a_opt, info)], ref64,
                                           witness=False, label="N-sharded")
        if not all(v <= MIXED_TOL[k] for k, v in gaps.items()):
            raise AssertionError(f"the N-sharded mixed plan disagrees with the card's f64 plan beyond {MIXED_TOL}: "
                                 f"{gaps}")
        a4, info4 = mplans[0]
        same = torch.equal(a_opt, a4) and all(torch.equal(u, v) for u, v in zip(info, info4))
        log(f"phase 9 N-sharded accuracy: within {MIXED_TOL} of the card's f64 plan; against phase 4's mixed plan: "
            f"a_opt gap {max_err(a_opt, a4)[0]:.3e}, TrajectoryInfo gap "
            f"{max(max_err(u, v)[1] for u, v in zip(info, info4)):.3e} (" + ("bit for bit)" if same else
            f"not bit for bit: phase 4 appended the step's point to its f64 cache by the rank-1 extension, this plan "
            f"factorizes the {int(mprob.mask.sum())} points afresh)"))
    finally:
        torch.distributed.destroy_process_group()
    log(f"phase 9 sharding: dryrun_training_step(1) on the card {t_dry:.3f} s, the phase {time.perf_counter() - t0:.3f} s "
        f"on {card}; one rank shows the path and the kernels on its slab, no multi-rank collective and no speed-up")


def _to_device(tree, dev):
    """Tensors (also inside NamedTuples) moved to ``dev``, anything else kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(a, dev) for a in tree))
    return tree


def seed_master(master, i):
    """Seed i's f64 master of an episode batch's stacked factorizations."""
    return master._replace(index=None, **{k: v[i] for k, v in master._asdict().items()
                                          if isinstance(v, torch.Tensor)})


def drive_sweep(dev, card, dtype="mixed"):
    """Phase 8: the mountain-car sweep of SWEEP_SEEDS through
    runner/episode.py's build_episodes_batch_fn on ``dev`` (see
    SWEEP_SEEDS), the seeds in lockstep, in ``dtype``: "mixed" (f64 master
    and training, df32 rollout through #12, #8 and #9) or "float32" (the
    sweep CLI's default: f32 refresh through #1, one launch for both seeds'
    memories, f32 training, f32 rollout through #2 and #3 with the seeds
    folded into the pair axis). Hooks installed for the phase (and removed
    after it) count each refresh (``masked_cholesky_factorize``), record
    each planning step's stacked masters, states, inits and result
    (``plan_batch``: the seeds' restarts as one L-BFGS-B batch) and time
    each training (``train_restarts``: the seeds' restarts x models as one
    L-BFGS batch, blocked) with its inputs. Holds: finite costs, seeds that
    differ, every output tensor on the card, the sweep's launches
    (EXPECTED_LAUNCHES, no other kernel; in f32 the Gram once per refresh)
    and each seed's planned step against the card's f64 plan of the same
    memory, trained parameters, state and inits by MIXED_TOL (f32:
    F32_SWEEP_TOL). Prints the batch's seconds (and per seed), the
    training's seconds and the gap of its parameters to a CPU training of
    the same dtype, inputs and draws, and the sweep's aggregate env steps
    per second."""

    def edit(cfg):
        cfg.training.training_frequency = SWEEP_TRAINING_FREQUENCY
        opt = cfg.controller.actions_optimizer_params
        cfg.controller.actions_optimizer_params = {**opt, "maxfun": MC_MAXFUN, "maxiter": MC_MAXFUN}

    mixed = dtype == "mixed"
    what, tol = ("mixed", MIXED_TOL) if mixed else ("f32", F32_SWEEP_TOL)
    name = "phase 8 sweep" if mixed else "phase 8 f32 sweep"
    setup = sweep_setup("mountain_car", dtype, device=dev, steps=SWEEP_STEPS, edit_config=edit)
    spec = setup.spec
    seeds = len(SWEEP_SEEDS)
    plans, trainings, refreshes = [], [], []
    plan_batch, train = episode_mod.plan_batch, episode_mod.train_restarts
    factorize = episode_mod.masked_cholesky_factorize

    def recorded_plan(*args):
        out = plan_batch(*args)
        plans.append((args, out))
        return out

    def timed_train(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(*args)
        torch.cuda.synchronize()
        trainings.append(SimpleNamespace(secs=time.perf_counter() - t0, args=args, out=out))
        return out

    def counted_factorize(*args):
        refreshes.append(args[2].shape[:-2])
        return factorize(*args)

    episode_mod.plan_batch, episode_mod.train_restarts = recorded_plan, timed_train
    episode_mod.masked_cholesky_factorize = counted_factorize
    try:
        batch = build_episodes_batch_fn(spec)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = batch(SWEEP_SEEDS, setup.params0)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        episode_mod.plan_batch, episode_mod.train_restarts = plan_batch, train
        episode_mod.masked_cholesky_factorize = factorize
    log(f"{name}: {seeds} {what} mountain-car episodes of {SWEEP_STEPS} steps in lockstep in {sweep_s:.3f} s "
        f"blocked ({sweep_s / seeds:.3f} s per seed), {out['final_mem'].len_model.tolist()} GP points of model_cap "
        f"{spec.model_cap}, {len(refreshes)} refreshes of the {seeds} seeds' memories, launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
    if not bool(torch.isfinite(out["cost"]).all()) or tuple(out["cost"].shape) != (seeds, SWEEP_STEPS):
        raise AssertionError(f"the {what} sweep's costs {tuple(out['cost'].shape)} are not all finite")
    if torch.equal(out["obs"][0], out["obs"][1]):
        raise AssertionError(f"the two seeds' {what} trajectories are equal")
    check_tensors_on_card(f"the {what} sweep's outputs", [v for k, v in out.items() if isinstance(v, torch.Tensor)]
                          + list(out["final_params"]) + list(out["final_mem"]))
    expected = EXPECTED_LAUNCHES["mountain-car sweep" if mixed else "mountain-car f32 sweep"]
    wrong = {k: n for k, n in launches.items() if n != expected.get(k, 0)}
    if wrong:
        raise AssertionError(f"the {what} mountain-car sweep launched {wrong}, expected {expected} and no other "
                             f"kernel")
    if not mixed and (launches["gram"] != len(refreshes) or any(r != (seeds,) for r in refreshes)):
        raise AssertionError(f"the f32 sweep launched the Gram {launches['gram']} times for {len(refreshes)} "
                             f"refreshes of batches {refreshes}, expected one launch per refresh of both seeds")
    if len(plans) != 1 or len(trainings) != 1:
        raise AssertionError(f"{len(plans)} planning steps and {len(trainings)} trainings, expected one each")

    tr = trainings[0]
    cpu = torch.device("cpu")
    raws_cpu, _ = train(*(_to_device(a, cpu) for a in tr.args))
    gap = float((tr.out[0].cpu() - raws_cpu).abs().max() / raws_cpu.abs().max())
    log(f"{name} training: {tr.secs:.3f} s blocked in {'f64' if mixed else 'f32'} on the card, {seeds} seeds x "
        f"{tr.args[6].shape[1]} restarts x {tr.args[6].shape[2]} models as one L-BFGS batch "
        f"({tr.args[4].sum(dim=-1).tolist()} points, {spec.train_cfg.iters} iterations at most); raw parameters "
        f"{gap:.3e} of their largest entry from a CPU training of the same dtype, inputs and draws (printed only)")

    (plan_spec, master, state_mu, state_var, inits, action_prev, t), (a_opt, info) = plans[0]
    gaps_all = []
    t0 = time.perf_counter()
    for i in range(seeds):
        # the planned step at t = 20 plans with the parameters of the
        # training at t = 19, the episode's last: its final_params
        params = type(out["final_params"])(*(f[i] for f in out["final_params"]))
        cache = seed_master(master, i)
        args = (cache.x_mem.cpu().numpy(), cache.y_mem.cpu().numpy(), cache.mask.cpu().numpy(), params, spec.bounds,
                state_mu[i], state_var, inits[i], action_prev[i], t)
        result = (a_opt[i], None, type(info)(*(f[i] for f in info)))
        gaps = mixed_plan_gaps(plan_spec, cache, (args, result), dev, label=f"{what} sweep seed {SWEEP_SEEDS[i]}")
        gaps_all.append(gaps)
        if not all(v <= tol[k] for k, v in gaps.items()):
            raise AssertionError(f"seed {SWEEP_SEEDS[i]}'s {what} planned step disagrees with the card's f64 plan "
                                 f"beyond {tol}: {gaps}")
    ref_s = time.perf_counter() - t0
    log(f"{name} accuracy: each seed's planned step (t = {t}, {inits.shape[1]} restarts, the seeds' "
        f"{seeds * inits.shape[1]} in one batch) within {tol} of the card's f64 plan (made and compared in "
        f"{ref_s:.3f} s): " + "; ".join(", ".join(f"{k} {v:.3e}" for k, v in g.items()) for g in gaps_all))
    log(f"{name}: aggregate_env_steps_per_sec {seeds * SWEEP_STEPS / sweep_s:.3f}, the batch "
        f"{sweep_s:.3f} s ({sweep_s / seeds:.3f} s per seed), training {tr.secs:.3f} s on {card}")
    return launches


def load_example(path):
    """A module of the repo's examples (not a package), loaded from its file."""
    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(path))[0],
                                                  os.path.join(os.path.dirname(os.path.abspath(__file__)), path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive_process_control(dev, card):
    """Phase 10: the time-varying process-control example in mixed mode
    through the port's run_env_multiple on ``dev`` (see PC_RUNS), its plot
    written into a temporary directory. Hooks installed for the phase (and
    removed after it) record each step (``record_controller_steps``, which
    waits for a dispatched training before a planned step and times it
    apart) and count the plant's parameter redraws. Holds: finite costs of every run, the launches of
    each planned step and of each run (EXPECTED_LAUNCHES, no other kernel),
    a redraw of the plant inside each run, the trained parameters reaching
    the plan, the time column of the stored inputs, and each run's planned
    step against the card's f64 plan of the same memory, parameters, state
    and inits by MIXED_TOL."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    example = load_example(PC_EXAMPLE)
    env = example.make_env(period_change=PC_PERIOD_CHANGE)
    cfg = example.make_config(dtype="float32")
    opt = cfg.controller.actions_optimizer_params
    cfg.controller.actions_optimizer_params = {**opt, "maxfun": PC_MAXFUN, "maxiter": PC_MAXFUN}
    cfg.training.training_frequency = PC_TRAINING_FREQUENCY
    repeat, redraws, define_params = cfg.controller.num_repeat_actions, [], env.define_params

    def counted_define_params():
        redraws.append(env.iter)
        return define_params()

    env.define_params = counted_define_params
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    try:
        with (tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings(record=True) as caught,
              record_controller_steps(wait_for_training=True) as steps):
            warnings.simplefilter("always")
            os.chdir(tmp)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            costs = run_env_multiple(env, example.ENV_NAME, cfg, None, num_runs=PC_RUNS,
                                     random_actions_init=PC_WARMUP, num_steps=PC_STEPS, verbose=False, device=dev)
            sync()
            runs_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            plot = os.path.join(tmp, f"multiple_runs_costs_{example.ENV_NAME}.png")
            plot_bytes = os.path.getsize(plot) if os.path.isfile(plot) else 0
    finally:
        os.chdir(cwd)
        del env.define_params
    if costs.shape != (PC_RUNS, PC_STEPS) or not np.all(np.isfinite(costs)):
        raise AssertionError(f"run_env_multiple returned costs of shape {costs.shape}, finite: "
                             f"{bool(np.all(np.isfinite(costs)))}")
    # the plot where matplotlib is installed; else (the card's machine) the warning and no file
    no_plot_warned = any("matplotlib is not installed" in str(w.message) for w in caught)
    if importlib.util.find_spec("matplotlib") is not None:
        if plot_bytes < 1000:
            raise AssertionError(f"run_env_multiple wrote no plot ({plot_bytes} bytes)")
        plot_note = f"plot {plot_bytes} bytes"
    elif not no_plot_warned or plot_bytes:
        raise AssertionError("without matplotlib run_env_multiple did not warn and skip its plot")
    else:
        plot_note = "no matplotlib here: run_env_multiple warned and wrote no plot"
    expected = EXPECTED_LAUNCHES["process-control run"]
    runs = [[s for s in steps if s.ctrl is c] for c in dict.fromkeys(s.ctrl for s in steps)]
    if len(runs) != PC_RUNS or any(len(r) != PC_STEPS for r in runs):
        raise AssertionError(f"{[len(r) for r in runs]} controller steps in {PC_RUNS} runs of {PC_STEPS}")
    total = {}
    for r, run in enumerate(runs):
        ctrl = run[0].ctrl
        planned = [s for s in run if s.planned]
        run_launches = {}
        for s in run:
            for k, n in s.launches.items():
                run_launches[k] = run_launches.get(k, 0) + n
        for k, n in run_launches.items():
            total[k] = total.get(k, 0) + n
        training = [s for s in run if s.wait_s is not None]
        log(f"phase 10 process-control run {r}: {PC_STEPS} steps in {sum(s.secs for s in run):.3f} s blocked "
            f"({ctrl.memory.len_mem_model} stored points, time column "
            f"{ctrl.memory.model_inputs[:ctrl.memory.len_mem_model, -1].tolist()}); planned steps "
            + ", ".join(f"{s.i} {s.secs:.3f} s ({', '.join(f'{k} {n}' for k, n in s.launches.items())})"
                        for s in planned)
            + "; random steps " + ", ".join(f"{s.i} {s.secs:.3f} s" for s in run if s.launches and not s.planned)
            + "; training " + ", ".join(
                f"{s.train_s:.3f} s on the CPU thread, waited {s.wait_s:.3f} s before step {s.i}" for s in training)
            + "; launches " + ", ".join(f"{k} {n}" for k, n in run_launches.items()))
        if [s.i for s in planned] != list(range(PC_WARMUP, PC_STEPS, repeat)) or any(s.call is None for s in planned):
            raise AssertionError(f"run {r} planned at steps {[s.i for s in planned]}")
        for j, s in enumerate(planned):
            want = expected["planned steps"][r][j]
            if {k: n for k, n in s.launches.items() if n} != want:
                raise AssertionError(f"run {r} planned step {s.i} launched {s.launches}, expected {want} and no "
                                     f"other kernel")
            if s.call[0][7].shape[0] != 2:
                raise AssertionError(f"run {r} planned step {s.i} did not run two restarts")
        if run_launches != expected["runs"][r]:
            raise AssertionError(f"run {r} launched {run_launches}, expected {expected['runs'][r]} and no other "
                                 f"kernel")
        if len(training) != 1 or training[0].i != planned[0].i or ctrl._last_train_losses is None:
            raise AssertionError(f"run {r}: the training was not waited for before the planned step")
        used = planned[0].call[0][3]  # the GP parameters the plan ran on
        if torch.equal(used.raw_lengthscales, run[0].params.raw_lengthscales) or not all(
                torch.equal(a, b) for a, b in zip(used, ctrl.gp_params)):
            raise AssertionError(f"run {r}: the trained parameters did not reach the plan")
        times = ctrl.memory.model_inputs[:ctrl.memory.len_mem_model, -1]
        if not np.array_equal(times, np.arange(len(times)) * repeat):
            raise AssertionError(f"run {r}: the stored inputs' time column is {times.tolist()}")
        if dev.type == "cuda":
            check_on_card(ctrl)
        check_plans([(s.call[1][0], s.call[1][2]) for s in planned], ctrl.plan_spec, finite_info=True)
    if sorted(redraws) != sorted(list(range(PC_PERIOD_CHANGE, PC_STEPS, PC_PERIOD_CHANGE)) * PC_RUNS):
        raise AssertionError(f"the plant was redrawn at its steps {redraws}")
    gaps_all, t0 = [], time.perf_counter()
    for r, run in enumerate(runs):
        for s in (s for s in run if s.planned):
            gaps = mixed_plan_gaps(run[0].ctrl.plan_spec, s.master, s.call, dev,
                                   label=f"process-control run {r} step {s.i}")
            gaps_all.append(gaps)
            if not all(v <= MIXED_TOL[k] for k, v in gaps.items()):
                raise AssertionError(f"run {r}'s planned step {s.i} disagrees with the card's f64 plan beyond "
                                     f"{MIXED_TOL}: {gaps}")
    ref_s = time.perf_counter() - t0
    log(f"phase 10 process-control accuracy: each run's planned step within {MIXED_TOL} of the card's f64 plan (made and "
        f"compared in {ref_s:.3f} s): " + "; ".join(", ".join(f"{k} {v:.3e}" for k, v in g.items()) for g in gaps_all))
    log(f"phase 10 process-control: {PC_RUNS} mixed time-varying runs of {PC_STEPS} steps through run_env_multiple in "
        f"{runs_s:.3f} s blocked ({plot_note}; the plant redrawn at its steps {sorted(set(redraws))} of "
        f"each run), the phase {time.perf_counter() - t_phase:.3f} s; launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items() if n) + f" on {card}")


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
    for name, e in check_ns2_kernels(dev).items():
        kern[name]["err"] = max(kern[name]["err"], e)
    for name, e in check_batched_kernels(dev).items():
        kern[name]["err"] = max(kern[name]["err"], e)
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

    mprob = trained_gp_problem(dev, nh=MIXED_NH)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mplanner, mplans, msecs = run_steps(mprob, dev, torch.float32, MIXED_STEPS, sync=torch.cuda.synchronize)
    torch.cuda.synchronize()
    mixed_launches = ops.launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"phase 4 main path mixed: f64 refresh + {MIXED_STEPS} trained-GP flagship plans "
        f"(300 points in the {mprob.x.shape[0]} bucket, horizon {MIXED_NH}), launches {mixed_launches}")
    check_plans(mplans, mprob.spec, finite_info=True)
    # accuracy before the launch check, so that a path which skips a kernel
    # shows what it does to the plan
    ref64 = f64_reference(dev, MIXED_STEPS, nh=MIXED_NH)
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
    check_launches("df_fwdres", mixed_launches, EXPECTED_LAUNCHES["df_fwdres per residual mixed plan"] * MIXED_STEPS)
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
    drive_sweep(dev, card)
    f32_sweep_launches = drive_sweep(dev, card, "float32")
    drive_sharding(dev, card, mprob, mplans, ref64)
    drive_process_control(dev, card)

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
        "df_mm_bwd_mean": ("df_mm_split.cu", "pallas_df_mm.py:483", split_launches),
        "df_mm_bwd_pair": ("df_mm_split.cu", "pallas_df_mm.py:557", split_launches)}
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

"""The launch plans that the port's wrappers compute in Python from the SM
count, against the index arithmetic of their kernels: each plan must cover
every element exactly once.

* ``df_mm.fwd_launch_plan`` (#12 ``df_mm_full`` and #8 ``df_mm_fwd``,
  csrc/df_mm_fwd.cu): pair blocks of FWD_WARPS rpw rows by FWD_COLS columns
  of one pair's (N, N) slab, then mean blocks of FWD_COLS stored points.
* ``moment_cov.fwd_launch_plan`` (#2 ``cov_fwd``, csrc/cov_core.cu): row
  bands of one pair against all columns, a thread a column against every
  m-th row of the band.

Each case mirrors the kernel's mapping from (block, warp or thread, lane,
step) to (pair, row, column) as its source comment states it, counts the
elements each plan reaches and requires every count to be 1. CPU only.
"""

import numpy as np
import pytest

from gpmpc_tpu_torch.ops import df_mm, moment_cov

SIZES = [24, 32, 37, 100, 128, 384]
SMS = [132, 114, 8]
COV_THREADS = 1024  # kFwdThreads of csrc/cov_core.cu


def _df_mm_counts(n, ns, plan):
    """(pair, row, column) and (model, point) counts of #12's grid."""
    p = ns * (ns + 1) // 2
    rpw, rtiles, ctiles = plan["rows_per_warp"], plan["row_tiles"], plan["col_tiles"]
    rows = df_mm.FWD_WARPS * rpw
    b = np.arange(plan["pair_blocks"])[:, None, None, None]
    w = np.arange(df_mm.FWD_WARPS)[None, :, None, None]
    s = np.arange(rpw)[None, None, :, None]
    lane = np.arange(df_mm.FWD_COLS)[None, None, None, :]
    pair = b // (rtiles * ctiles)
    row = (b // ctiles) % rtiles * rows + w + df_mm.FWD_WARPS * s
    col = b % ctiles * df_mm.FWD_COLS + lane
    pair, row, col = np.broadcast_arrays(pair, row, col)
    live = (row < n) & (col < n)
    pairs = np.zeros((p, n, n), dtype=np.int64)
    np.add.at(pairs, (pair[live], row[live], col[live]), 1)
    mb = np.arange(plan["mean_blocks"])[:, None, None]
    m = np.arange(ns)[None, :, None]
    point = mb * df_mm.FWD_COLS + np.arange(df_mm.FWD_COLS)[None, None, :]
    m, point = np.broadcast_arrays(m, point)
    means = np.zeros((ns, n), dtype=np.int64)
    np.add.at(means, (m[point < n], point[point < n]), 1)
    return pairs, means


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", SIZES)
def test_df_mm_fwd_plan_covers_every_element_once(n, sms):
    for ns in (1, 2, 3):
        plan = df_mm.fwd_launch_plan(n, ns, sms)
        assert 1 <= plan["rows_per_warp"] <= df_mm.FWD_MAX_ROWS_PER_WARP
        assert plan["col_tiles"] == plan["mean_blocks"] == -(-n // df_mm.FWD_COLS)
        assert plan["row_tiles"] == -(-n // (df_mm.FWD_WARPS * plan["rows_per_warp"]))
        pairs, means = _df_mm_counts(n, ns, plan)
        assert np.all(pairs == 1), (ns, int(pairs.min()), int(pairs.max()))
        assert np.all(means == 1), (ns, int(means.min()), int(means.max()))
        if sms == 132 and n <= 128 and ns == 3:  # the planning step: one E per lane, one wave
            assert plan["rows_per_warp"] == 1
            assert plan["pair_blocks"] + plan["mean_blocks"] <= df_mm.FWD_BLOCKS_PER_SM * sms


def _cov_counts(p, n, rows, bands):
    """(pair, row, column) counts and per-block thread loads of #2's grid:
    m = max(1, COV_THREADS // N) row groups of N working threads (at most
    COV_THREADS), thread t the columns t % N + work j against the band's
    rows t // N + m i."""
    counts = np.zeros((p, n, n), dtype=np.int64)
    loads = []
    m = COV_THREADS // n if n < COV_THREADS else 1
    work = m * n if n < COV_THREADS else COV_THREADS
    t = np.arange(work)[:, None, None]
    j = np.arange(-(-n // work))[None, :, None]
    for b in range(p * bands):
        pair, n0 = b // bands, b % bands * rows
        nrow = min(rows, n - n0)
        i = np.arange(-(-nrow // m))[None, None, :]
        r, k = np.broadcast_arrays(t // n + m * i, t % n + work * j)
        live = (r < nrow) & (k < n)
        np.add.at(counts, (pair, n0 + r[live], k[live]), 1)
        done = live.sum(axis=(1, 2))
        loads.append(done.max() - done.min())
    return counts, loads


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", SIZES)
def test_cov_fwd_plan_covers_every_element_once(n, sms):
    for p in (1, 6, 36):  # ns = 1, 3 and 8
        rows, bands = moment_cov.fwd_launch_plan(p, n, sms)
        assert 1 <= rows <= min(n, moment_cov.FWD_MAX_ROWS) and bands == -(-n // rows)
        if p <= sms:
            assert p * bands <= sms  # one wave of one block per SM
        counts, loads = _cov_counts(p, n, rows, bands)
        assert np.all(counts == 1), (p, int(counts.min()), int(counts.max()))
        assert max(loads) <= 1  # every thread of a block within one element of the others

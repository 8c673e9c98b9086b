"""The launch plans that the port's wrappers compute in Python from the SM
count, against the index arithmetic of their kernels: each plan must cover
every element exactly once.

* ``df_mm.fwd_launch_plan`` (#12 ``df_mm_full`` and #8 ``df_mm_fwd``,
  csrc/df_mm_fwd.cu): pair blocks of FWD_WARPS rpw rows by FWD_COLS columns
  of one pair's (N, N) slab, then mean blocks of FWD_COLS stored points.
* ``moment_cov.fwd_launch_plan`` (#2 ``cov_fwd``, csrc/cov_core.cu): row
  bands of one pair against all columns, a thread a column against every
  m-th row of the band.
* ``df_cov.fwd_launch_plan`` (#5 ``df_fwd``, csrc/df_cov.cu): row bands of
  one pair against all columns, a warp a row, shorter bands on the diagonal
  pairs, sized for the busiest warp scheduler of an SM.
* ``moment_cov.bwd_launch_plan`` (#3 ``cov_bwd``, csrc/cov_core.cu): 2P
  stacked rows (the row side, then the column side), a warp a row, on
  square and on rectangular (Nr != Nc) slabs. Its grid does not depend on
  the SM count.
* ``df_mm.pair_launch_plan`` (#11 ``df_mm_bwd_pair``, csrc/df_mm_split.cu):
  32 x 32 pair tiles, then the chain rule on (side, pair, 32-point) units,
  1 + ns warps a unit, spread over the SMs.
* ``df_mm.mean_launch_plan`` (#10 ``df_mm_bwd_mean``, csrc/df_mm_split.cu):
  one thread-block cluster, a warp a (model, 32-point tile) item.
* ``gram_rbf.launch_plan`` (#1 ``gram``, csrc/gram.cu) and
  ``moment_cov.gik_launch_plan`` (#4 ``cov_gik``, csrc/cov_core.cu): row
  bands of one model against all columns in chunks, a thread a row's 4
  consecutive columns per item.

Each case mirrors the kernel's mapping from (block, warp or thread, lane,
step) to (pair, row, column) as its source comment states it, counts the
elements each plan reaches and requires every count to be 1. With a batch
axis (#12, #8, #9, #10, #11: grid row y the element, #11's summing launch
a block per element; #1: grid z), each element's partials and outputs must
fill exactly its slice of the wrapper's buffers; a batch
folded into #5's pair axis takes one element's plan for every element. CPU only. The
last cases hold #3's two-side plain twin (the CPU path of ``cov_bwd``) to
its two one-side calls and to the JAX package's cov core VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops import cov_core_xla
from gpmpc_tpu_torch.ops import df_cov, df_mm, gram_rbf, moment_cov

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


def _written(extents, strides, offset=0):
    """The flat indices a loop nest over ``extents`` writes at ``strides``."""
    idx = np.full((), offset, dtype=np.int64)
    for e, st in zip(extents, strides):
        idx = idx[..., None] + st * np.arange(e)
    return idx.ravel()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", [32, 100, 128])
def test_df_mm_batch_elements_fill_their_own_buffer_slices(n, sms):
    """#12, #8 and #9 with a batch axis: grid row y is element y, its grid
    row the one element's plan, and its partials and outputs at y times the
    element's extent (csrc/df_mm_fwd.cu, csrc/df_mm_bwd.cu, as their
    comments state the layouts). Every element's writes fill exactly its
    slice of the wrapper's buffers (``fwd_buffer_shapes``,
    ``bwd_buffer_shapes``), each index once: no element reads or sums
    another's."""
    batch = 3
    for ns in (1, 2, 3):
        for d in sorted({ns, 5, 8}):
            p = ns * (ns + 1) // 2
            plan = df_mm.fwd_launch_plan(n, ns, sms)
            shapes = df_mm.fwd_buffer_shapes(n, ns, d, batch, sms)
            npb, mt = plan["pair_blocks"], plan["mean_blocks"]
            mplane, n_out = ns * (1 + d) * mt, ns + ns * d + p + ns
            writes = {  # element, plane (hi, lo), then the kernel's own index
                "pair_part": _written((batch, 2, npb, 2), (4 * npb, 2 * npb, 2, 1)),
                "mean_part": _written((batch, 2, ns, 1 + d, mt), (2 * mplane, mplane, (1 + d) * mt, mt, 1)),
                "scale": _written((batch, ns + p), (ns + p, 1)),
                "full_out": _written((batch, ns + ns * d + p), (ns + ns * d + p, 1)),
                "fwd_out": _written((batch, 2, n_out), (2 * n_out, n_out, 1))}
            nt = -(-n // df_mm.BWD_TILE)
            nv, units = d + ns * ns, 2 * p * nt
            bshapes = df_mm.bwd_buffer_shapes(n, ns, d, batch)
            writes_bwd = {
                "mean_part": _written((batch, 2, ns, nt, nv), (2 * ns * nt * nv, ns * nt * nv, nt * nv, nv, 1)),
                "unit_part": _written((batch, 2, units, nv), (2 * units * nv, units * nv, nv, 1)),
                "out": _written((batch, d + ns ** 3 + p * ns * ns), (d + ns ** 3 + p * ns * ns, 1))}
            for got, want in ((writes, shapes), (writes_bwd, bshapes)):
                for name, idx in got.items():
                    size = int(np.prod(want[name]))
                    assert np.array_equal(np.sort(idx), np.arange(size)), (ns, d, name)
                    assert want[name][0] == batch and size % batch == 0
            # the grid of one element is the B = 1 launch's (the plan does not see the batch)
            assert df_mm.fwd_buffer_shapes(n, ns, d, 1, sms)["rows_per_warp"] == plan["rows_per_warp"]


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


PLAN_SIZES = [32, 100, 128, 384, 512]
PLAN_SMS = [132, 114, 78]
DF_FWD_LANE_COLS = 2  # kFwdLaneCols of csrc/df_cov.cu: a lane's columns per chunk
# (P, diag_pos, ns): the flagship's three models, one model, two models
DF_CASES = [(6, (0, 3, 5), 3), (1, (0,), 1), (3, (0, 2), 2)]


def _lane_columns(n, lane_cols):
    """The columns lane + 32 j of each chunk of 32 lane_cols, below N."""
    chunk = 32 * lane_cols
    k = (np.arange(0, n, chunk)[:, None, None] + 32 * np.arange(lane_cols)[None, :, None]
         + np.arange(32)[None, None, :]).ravel()
    return k[k < n]


def _df_fwd_counts(p, n, diag_pos, plan):
    """(pair, row, column) counts of #5's grid: block b the bands of pair 0,
    then of pair 1, ...; warp w of band t the row t rows + w (w < rows), its
    lanes the columns lane + 32 j of each chunk. Also the blocks walked and
    the most bands of a pair."""
    counts = np.zeros((p, n, n), dtype=np.int64)
    cols = _lane_columns(n, DF_FWD_LANE_COLS)
    blocks, most = 0, 0
    for q in range(p):
        rows = plan["rows_diag"] if q in diag_pos else plan["rows_off"]
        bands = -(-n // rows)
        most = max(most, bands)
        for t in range(bands):
            for w in range(plan["threads"] // 32):
                row = t * rows + w
                if w < rows and row < n:
                    np.add.at(counts[q, row], cols, 1)
            blocks += 1
    return counts, blocks, most


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_df_fwd_plan_covers_every_element_once(n, sms):
    for p, diag_pos, ns in DF_CASES:
        plan = df_cov.fwd_launch_plan(p, n, diag_pos, ns, sms)
        cap = min(df_cov.FWD_MAX_ROWS, n)
        assert 1 <= plan["rows_diag"] <= cap and 1 <= plan["rows_off"] <= cap
        assert plan["threads"] <= 32 * df_cov.FWD_MAX_ROWS
        counts, blocks, most = _df_fwd_counts(p, n, diag_pos, plan)
        assert np.all(counts == 1), (p, int(counts.min()), int(counts.max()))
        assert blocks == plan["blocks"] and most == plan["max_bands"]  # the summing launch's stride
        if plan["blocks"] > sms:  # more than one wave only where the longest bands cannot fit one
            assert plan["rows_diag"] == plan["rows_off"] == cap
            assert len(diag_pos) * -(-n // cap) + (p - len(diag_pos)) * -(-n // cap) > sms
    # a batch folded into the pair axis (models.gp._batched_cov_core): the
    # element's plan, every element's bands in one launch
    for p, diag_pos, ns in DF_CASES:
        batch = 3
        fold = tuple(b * p + q for b in range(batch) for q in diag_pos)
        plan = df_cov.fwd_launch_plan(p, n, diag_pos, ns, sms)
        assert moment_cov.element_pairs(batch * p, fold, batch) == (p, tuple(diag_pos))
        counts, blocks, most = _df_fwd_counts(batch * p, n, fold, plan)
        assert np.all(counts == 1) and blocks == batch * plan["blocks"] and most == plan["max_bands"]
    if sms == 132 and n == 384:  # the flagship: 4 rows a scheduler on diagonal pairs, 5 elsewhere
        plan = df_cov.fwd_launch_plan(6, 384, (0, 3, 5), 3, 132)
        assert (plan["rows_diag"], plan["rows_off"], plan["blocks"]) == (16, 20, 132)


@pytest.mark.parametrize("ns", [1, 2, 3])
def test_df_fwd_plan_costs_are_the_smokes_instruction_counts(ns):
    """The element costs the band plan weighs are the f32 instruction
    counts chip_smoke.py bounds #5 with (its own count of csrc/df32.cuh)."""
    import chip_smoke

    per, per_diag = chip_smoke.df_instructions_per_element(ns)["df_fwd"]
    assert (df_cov.fwd_elem_cost(ns, False), df_cov.fwd_elem_cost(ns, True)) == (per, per + per_diag)


def _cov_bwd_counts(p, n, plan, nc=None):
    """(side, pair, row, column) counts of #3's grid on Nr = n rows against
    Nc columns (Nc = n unless given), each side's (row, column) in the
    slab's own (Nr, Nc) frame: block (x, s) the stacked rows x BWD_WARPS + w
    of stacked pair s (s < P the row side of pair s, its Nr rows against Nc
    columns; else the column side of pair s - P, whose Nc rows are the
    pair's columns, against its Nr rows), a lane the columns lane + 32 j of
    each batch; rows past a side's idle."""
    nc = n if nc is None else nc
    counts = np.zeros((2, p, n, nc), dtype=np.int64)
    for s in range(plan["stacked_pairs"]):
        side = s // p
        rows, cols = (n, nc) if side == 0 else (nc, n)
        lanes = _lane_columns(cols, moment_cov.BWD_LANE_COLS)
        for x in range(plan["row_blocks"]):
            for w in range(plan["threads"] // 32):
                row = x * moment_cov.BWD_WARPS + w
                if row < rows:
                    if side == 0:
                        np.add.at(counts[0, s % p, row], lanes, 1)
                    else:
                        np.add.at(counts[1, s % p, :, row], lanes, 1)
    return counts


@pytest.mark.parametrize("p", [1, 3, 6])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_cov_bwd_plan_covers_every_element_once(n, p):
    plan = moment_cov.bwd_launch_plan(p, n)
    assert plan["threads"] == 32 * moment_cov.BWD_WARPS and plan["stacked_pairs"] == 2 * p
    assert plan["batches"] == -(-n // (32 * moment_cov.BWD_LANE_COLS))
    counts = _cov_bwd_counts(p, n, plan)
    assert np.all(counts == 1), (int(counts.min()), int(counts.max()))  # every element once on each side


@pytest.mark.parametrize("p", [1, 6])
@pytest.mark.parametrize("nr,nc", [(96, 384), (128, 768), (192, 384), (384, 96), (37, 100)])
def test_cov_bwd_plan_covers_every_element_once_on_rectangular_slabs(nr, nc, p):
    """The same launch on a rank's row slab (Nr != Nc): both sides reach
    every element of the slab once."""
    plan = moment_cov.bwd_launch_plan(p, nr, nc)
    assert plan["row_blocks"] == -(-max(nr, nc) // moment_cov.BWD_WARPS)
    counts = _cov_bwd_counts(p, nr, plan, nc)
    assert np.all(counts == 1), (int(counts.min()), int(counts.max()))


def _cov_args(seed, dtype, p=6, n=40, ns=3):
    rng = np.random.default_rng(seed)
    ikh = rng.normal(0, 0.1, (3, n, n))
    return tuple(v.astype(dtype) for v in (
        rng.normal(-2, 0.5, (p, n)), rng.normal(-2, 0.5, (p, n)), rng.normal(0, 0.3, (p, n, ns)),
        rng.normal(0, 0.3, (p, n, ns)), rng.normal(0, 1, (p, n)), rng.normal(0, 1, (p, n)),
        (ikh + ikh.transpose(0, 2, 1)) / 2))


COV_DIAG = (0, 3, 5)


def test_cov_bwd_plain_is_the_two_one_side_calls():
    """#3's two-side plain twin (the CPU path of cov_bwd, and the oracle of
    the kernel) equals the row-side and the role-swapped column-side calls
    of the one-side twin bit for bit, the corr cotangent scattered by slot."""
    a, c, u, xj, bi, bj, ik = (torch.tensor(v) for v in _cov_args(0, np.float32))
    g = torch.linspace(1.0, 2.0, 6)
    g_corr = torch.tensor([1.0, -2.0, 3.0])
    gco = torch.zeros(6).index_copy(0, torch.tensor(COV_DIAG), g_corr)
    two = moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, COV_DIAG)
    row = moment_cov.cov_bwd_row_plain(g, a, c, u, xj, bi, bj, ik, gco, COV_DIAG)
    col = moment_cov.cov_bwd_row_plain(g, c, a, xj, u, bj, bi, ik, gco, COV_DIAG)
    for out, ref in zip(two, (row[0], col[0], row[1], col[1], row[2], col[2])):
        assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_cov_bwd_matches_jax_vjp(dtype, rtol):
    """cov_bwd (its plain twin here) and CovCore's autograd (which runs it)
    against JAX's VJP of cov_core_xla in all six operands at the same
    cotangents, each output relative to its largest entry."""
    args = _cov_args(1, dtype)
    g = np.linspace(1.0, 2.0, 6).astype(dtype)
    g_corr = np.array([1.0, -2.0, 3.0], dtype=dtype)
    _, vjp = jax.vjp(lambda *t: cov_core_xla(*t, jnp.asarray(args[6]), COV_DIAG), *(jnp.asarray(v) for v in args[:6]))
    ref = [np.asarray(r) for r in vjp((jnp.asarray(g), jnp.asarray(g_corr)))]  # a, c, U, Xj, bi, bj
    t = [torch.tensor(v) for v in args]
    ga, gc, gu, gxj, gbi, gbj = moment_cov.cov_bwd(torch.tensor(g), *t, torch.tensor(g_corr), COV_DIAG)
    leaves = [x.clone().requires_grad_(True) for x in t[:6]]
    s, co = moment_cov.CovCore.apply(*leaves, t[6], COV_DIAG)
    via_core = torch.autograd.grad((s * torch.tensor(g)).sum() + (co * torch.tensor(g_corr)).sum(), leaves)
    for outs in ((ga, gc, gu, gxj, gbi, gbj), via_core):
        for out, r in zip(outs, ref):
            scale = np.abs(r).max()
            np.testing.assert_allclose(out.detach().numpy() / scale, r / scale, rtol=0, atol=rtol)


# ---------------------------------------------------------------------------
# the split whole-step VJP past N = 128: #11 df_mm_bwd_pair (pair tiles, then
# the chain rule on (side, pair, 32-point) units) and #10 df_mm_bwd_mean (one
# thread-block cluster of (model, tile) items), csrc/df_mm_split.cu
# ---------------------------------------------------------------------------

SPLIT_PLAN_SIZES = [129, 192, 384, 512, 1000]
SPLIT_PLAN_SMS = [132, 114, 8]
TILE_WARPS, TILE_ROWS_PER_WARP = 8, 4  # kWarps, kRowsPerWarp of csrc/df_mm.cuh


@pytest.mark.parametrize("sms", SPLIT_PLAN_SMS)
@pytest.mark.parametrize("n", SPLIT_PLAN_SIZES)
def test_df_mm_bwd_pair_tiles_cover_every_element_once(n, sms):
    """#11's pair blocks: block b the tile (b // tiles % tiles, b % tiles) of
    pair b // tiles^2, warp w its rows w + TILE_WARPS r, a lane a column."""
    for ns in (1, 2, 3):
        p = ns * (ns + 1) // 2
        plan = df_mm.pair_launch_plan(n, ns, sms)
        tiles = plan["tiles"]
        assert tiles == -(-n // df_mm.BWD_TILE) and plan["tile_blocks"] == p * tiles * tiles
        b = np.arange(plan["tile_blocks"])[:, None, None, None]
        w = np.arange(TILE_WARPS)[None, :, None, None]
        r = np.arange(TILE_ROWS_PER_WARP)[None, None, :, None]
        lane = np.arange(df_mm.BWD_TILE)[None, None, None, :]
        pair = b // (tiles * tiles)
        row = (b // tiles) % tiles * df_mm.BWD_TILE + w + TILE_WARPS * r
        col = b % tiles * df_mm.BWD_TILE + lane
        pair, row, col = np.broadcast_arrays(pair, row, col)
        live = (row < n) & (col < n)
        counts = np.bincount(((pair * n + row) * n + col)[live], minlength=p * n * n)
        assert counts.size == p * n * n and np.all(counts == 1), (ns, int(counts.min()), int(counts.max()))


@pytest.mark.parametrize("sms", SPLIT_PLAN_SMS)
@pytest.mark.parametrize("n", SPLIT_PLAN_SIZES)
def test_df_mm_bwd_pair_units_cover_every_point_once(n, sms):
    """#11's chain-rule launch: warp w of block x is residual w % (1 + ns) of
    unit x (unit_warps // (1 + ns)) + w // (1 + ns) = (side P + pair) tiles +
    chunk, a lane a point: every (side, pair, chunk) unit gets each of its
    1 + ns warps once and every (side, pair, point) is some lane's once."""
    for ns in (1, 2, 3):
        p, nr = ns * (ns + 1) // 2, 1 + ns
        plan = df_mm.pair_launch_plan(n, ns, sms)
        tiles, units = plan["tiles"], plan["units"]
        per = plan["unit_warps"] // nr
        assert units == 2 * p * tiles and plan["unit_warps"] % nr == 0
        assert 1 <= per <= df_mm.PAIR_UNIT_MAX_UNITS and plan["unit_blocks"] == -(-units // per)
        x = np.arange(plan["unit_blocks"])[:, None]
        w = np.arange(plan["unit_warps"])[None, :]
        u, v = np.broadcast_arrays(x * per + w // nr, w % nr)
        live = u < units
        warps = np.bincount((u * nr + v)[live], minlength=units * nr)
        assert np.all(warps == 1), (ns, int(warps.min()), int(warps.max()))
        side, pair, chunk = u // (p * tiles), (u // tiles) % p, u % tiles
        pts = chunk[live & (v == 0)][:, None] * df_mm.BWD_TILE + np.arange(df_mm.BWD_TILE)[None, :]
        keys = ((side[live & (v == 0)][:, None] * p + pair[live & (v == 0)][:, None]) * n + pts)[pts < n]
        counts = np.bincount(keys, minlength=2 * p * n)
        assert counts.size == 2 * p * n and np.all(counts == 1), (ns, int(counts.min()), int(counts.max()))
        if per < df_mm.PAIR_UNIT_MAX_UNITS:  # the units spread over the SMs, a block each at most
            assert plan["unit_blocks"] <= sms
    if (n, sms) == (384, 132):  # the driven path: 144 units, 2 a block, 72 blocks
        assert df_mm.pair_launch_plan(n, 3, sms) == dict(tiles=12, tile_blocks=864, units=144, unit_warps=8,
                                                          unit_blocks=72)


@pytest.mark.parametrize("sms", SPLIT_PLAN_SMS)
@pytest.mark.parametrize("n", SPLIT_PLAN_SIZES)
def test_df_mm_bwd_mean_cluster_covers_every_point_once(n, sms):
    """#10's one cluster: block r takes the tiles r, r + cluster, ... of
    every model, warp w its items w, w + warps, ... (item i: model i % ns of
    tile r + cluster (i // ns)), a lane a point: every (model, point) once."""
    for ns in (1, 2, 3):
        plan = df_mm.mean_launch_plan(n, ns, sms)
        tiles, cl, warps = plan["tiles"], plan["cluster"], plan["warps"]
        assert 1 <= cl <= min(df_mm.MEAN_MAX_CLUSTER, tiles, sms) and 1 <= warps <= df_mm.MEAN_MAX_WARPS
        counts = np.zeros((ns, n), dtype=np.int64)
        for r in range(cl):
            items = ns * -(-(tiles - r) // cl)
            for w in range(warps):
                for it in range(w, items, warps):
                    m, rt = it % ns, r + cl * (it // ns)
                    pts = rt * df_mm.BWD_TILE + np.arange(df_mm.BWD_TILE)
                    counts[m, pts[pts < n]] += 1
        assert np.all(counts == 1), (ns, int(counts.min()), int(counts.max()))
        if tiles <= min(df_mm.MEAN_MAX_CLUSTER, sms):  # a block a tile: ns warps, one item each
            assert (cl, warps) == (tiles, ns)


@pytest.mark.parametrize("sms", SPLIT_PLAN_SMS)
@pytest.mark.parametrize("n", [129, 192, 384])
def test_df_mm_split_batch_elements_fill_their_own_buffer_slices(n, sms):
    """#10 and #11 with a batch axis: #10's cluster row y and #11's grid row
    y (its first two launches; its summing launch block y) are element y,
    each the one element's plan, and its partials and outputs at y times the
    element's extent (csrc/df_mm_split.cu, as its comments state the layouts:
    #10's items' partials at (m tiles + rt) nv + v of plane (hi, lo) and its
    out, #11's tile partials at part_at(p, v, tile, n), its units' sums at u
    nv + v and its out). Every element's writes fill exactly its slice of
    ``split_buffer_shapes``, each index once."""
    batch = 3
    for ns in (1, 2, 3):
        for d in sorted({ns, 5, 8}):
            p, nr = ns * (ns + 1) // 2, 1 + ns
            nt = -(-n // df_mm.BWD_TILE)
            nv, units = d + ns * ns, 2 * p * nt
            mplane, tplane = ns * nt * nv, p * nr * nt * n
            shapes = df_mm.split_buffer_shapes(n, ns, d, batch)
            writes = {  # element, plane (hi, lo), then the kernel's own index
                "mean_part": _written((batch, 2, ns, nt, nv), (2 * mplane, mplane, nt * nv, nv, 1)),
                "mean_out": _written((batch, 2 * d + ns ** 3), (2 * d + ns ** 3, 1)),
                "row_part": _written((batch, 2, p, nr, nt, n), (2 * tplane, tplane, nr * nt * n, nt * n, n, 1)),
                "col_part": _written((batch, 2, p, nr, nt, n), (2 * tplane, tplane, nr * nt * n, nt * n, n, 1)),
                "unit_part": _written((batch, 2, units, nv), (2 * units * nv, units * nv, nv, 1)),
                "pair_out": _written((batch, 2 * p * d + p * ns * ns + d), (2 * p * d + p * ns * ns + d, 1))}
            for name, idx in writes.items():
                size = int(np.prod(shapes[name]))
                assert np.array_equal(np.sort(idx), np.arange(size)), (ns, d, name)
                assert shapes[name][0] == batch and size % batch == 0
            # the plans do not see the batch: each element's grid is the B = 1 launch's
            one = df_mm.split_buffer_shapes(n, ns, d, 1)
            assert all(one[k][1:] == shapes[k][1:] for k in shapes)
            assert df_mm.pair_launch_plan(n, ns, sms)["tiles"] == nt == df_mm.mean_launch_plan(n, ns, sms)["tiles"]


# ---------------------------------------------------------------------------
# the elementwise O(N^2) outputs: #1 gram (csrc/gram.cu) and #4 cov_gik
# (csrc/cov_core.cu), row bands against all columns in chunks of 4-column items
# ---------------------------------------------------------------------------

BAND_SMS = [132, 114, 8]


def _band_counts(models, nr, nc, plan, threads, items_per_thread=None):
    """(model, row, column) counts of a band grid: block b the rows
    b % bands x rows .. of model b // bands; per chunk of 4 quads columns,
    thread t the items t + threads k (k < items_per_thread, or every k while
    the items last), item i the band's row i // quads against the columns
    c0 + 4 (i % quads) + c, c < 4, below Nc. (#1's thread (x, y) of its
    quads x rows block is thread t = y quads + x.)"""
    rows, quads = plan["rows"], plan["quads"]
    counts = np.zeros(models * nr * nc, dtype=np.int64)
    for b in range(plan["blocks"]):
        m, i0 = b // plan["bands"], b % plan["bands"] * rows
        nrow = min(rows, nr - i0)
        per = items_per_thread if items_per_thread is not None else -(-nrow * quads // threads)
        it = (np.arange(threads)[:, None] + threads * np.arange(per)[None, :]).ravel()
        it = it[it < nrow * quads]
        for c0 in range(0, nc, 4 * quads):
            row = i0 + it // quads
            col = (c0 + 4 * (it % quads))[:, None] + np.arange(4)[None, :]
            row = np.broadcast_to(row[:, None], col.shape)
            live = col < nc
            np.add.at(counts, (m * nr + row[live]) * nc + col[live], 1)
    return counts


@pytest.mark.parametrize("sms", BAND_SMS)
@pytest.mark.parametrize("n", SIZES + [299, 1000])
def test_gram_plan_covers_every_entry_once(n, sms):
    """#1: a thread's one item per chunk reaches every (model, row, column)
    once; a band's rows x quads fit THREADS; the bands of all models fit
    one wave of one block per SM where they can."""
    for ns in (1, 3, 8):
        plan = gram_rbf.launch_plan(ns, n, sms)
        rows, quads = plan["rows"], plan["quads"]
        assert 1 <= rows <= n and 1 <= quads <= gram_rbf.MAX_QUADS
        assert rows * quads <= gram_rbf.THREADS
        assert plan["bands"] == -(-n // rows) and plan["blocks"] == ns * plan["bands"]
        assert plan["chunks"] == -(-n // (4 * quads))
        if ns * n <= sms:
            assert rows == 1 and plan["blocks"] == ns * n
        elif rows < n and rows < gram_rbf.THREADS:
            assert plan["blocks"] <= sms  # one wave
        counts = _band_counts(ns, n, n, plan, gram_rbf.THREADS, 1)
        assert np.all(counts == 1), (ns, int(counts.min()), int(counts.max()))
    if (n, sms) == (384, 132):  # the flagship refresh: 129 blocks of 9 rows, all 96 quads of a row in one chunk
        assert gram_rbf.launch_plan(3, 384, 132) == dict(rows=9, bands=43, quads=96, blocks=129, chunks=1)


@pytest.mark.parametrize("sms", BAND_SMS)
@pytest.mark.parametrize("n", [37, 384])
def test_gram_batch_elements_fill_their_own_slices(n, sms):
    """#1 with a batch axis: grid z is element z, each the one memory's plan,
    its K at z Ns N^2 (csrc/gram.cu): every (element, model, row, column) of
    the (B, Ns, N, N) output once."""
    batch, ns = 3, 3
    plan = gram_rbf.launch_plan(ns, n, sms)
    one = _band_counts(ns, n, n, plan, gram_rbf.THREADS, 1)
    counts = np.zeros(batch * ns * n * n, dtype=np.int64)
    for z in range(batch):
        idx = np.repeat(np.arange(one.size), one)
        np.add.at(counts, z * ns * n * n + idx, 1)
    assert np.all(counts == 1), (int(counts.min()), int(counts.max()))


GIK_SHAPES = [(1, 5), (24, 37), (37, 24), (100, 301), (203, 301), (384, 101), (384, 384), (60, 1500), (2000, 9),
              (5, 5000)]


@pytest.mark.parametrize("sms", BAND_SMS)
@pytest.mark.parametrize("nr,nc", GIK_SHAPES)
def test_cov_gik_plan_covers_every_entry_once(nr, nc, sms):
    """#4 on Nr x Nc slabs: block (m, t)'s thread (x, y) takes the band's
    rows y + ty i against the quads x + tx j; every (model, row, column) is
    reached once; the bands fit one wave of one block per SM where they
    can."""
    for nd in (1, 3):
        plan = moment_cov.gik_launch_plan(nd, nr, nc, sms)
        rows, quads, tx, ty = plan["rows"], plan["quads"], plan["tx"], plan["ty"]
        assert 1 <= rows <= nr and quads == -(-nc // 4)
        assert 1 <= tx <= quads and 1 <= ty <= rows and tx * ty <= moment_cov.GIK_THREADS
        assert plan["bands"] == -(-nr // rows) and plan["blocks"] == nd * plan["bands"]
        if rows < nr:
            assert plan["blocks"] <= sms  # one wave
        counts = np.zeros(nd * nr * nc, dtype=np.int64)
        for m in range(nd):
            for t in range(plan["bands"]):
                n0 = t * rows
                nrow = min(rows, nr - n0)
                r = (np.arange(ty)[:, None] + ty * np.arange(-(-nrow // ty))[None, :]).ravel()
                q = (np.arange(tx)[:, None] + tx * np.arange(-(-quads // tx))[None, :]).ravel()
                r, q = r[r < nrow], q[q < quads]
                col = (4 * q)[:, None] + np.arange(4)[None, :]
                col = col[col < nc]
                np.add.at(counts, ((m * nr + n0 + r)[:, None] * nc + col[None, :]).ravel(), 1)
        assert np.all(counts == 1), (nd, int(counts.min()), int(counts.max()))
    if (nr, nc, sms) == (384, 384, 132):  # the flagship's shapes: 9 rows x 96 quads, one item a thread
        assert moment_cov.gik_launch_plan(3, 384, 384, 132) == dict(rows=9, bands=43, quads=96, tx=96, ty=9,
                                                                      blocks=129)


# the reference's larger buckets (the port's reach 2048, memory/buffer.py),
# where tests/test_torch_cuda.py holds #1, #2, #3, #5, #6 and #7 on the card;
# #6 runs #5's grid. P = 6 (ns = 3) and P = 3 (ns = 2, the process-control
# path's width) on the H100's 132 SMs.
LARGE_SIZES = [768, 1536, 2048]


@pytest.mark.parametrize("n", LARGE_SIZES)
def test_plans_cover_every_element_once_at_large_n(n):
    sms = 132
    for p, diag_pos, ns in ((6, (0, 3, 5), 3), (3, (0, 2), 2)):
        rows, bands = moment_cov.fwd_launch_plan(p, n, sms)  # #2
        assert 1 <= rows <= min(n, moment_cov.FWD_MAX_ROWS) and bands == -(-n // rows)
        counts, _ = _cov_counts(p, n, rows, bands)  # past 1024 columns a thread takes one or two of a row
        assert np.all(counts == 1), ("cov_fwd", p)
        plan = df_cov.fwd_launch_plan(p, n, diag_pos, ns, sms)  # #5
        counts, blocks, most = _df_fwd_counts(p, n, diag_pos, plan)
        assert np.all(counts == 1) and (blocks, most) == (plan["blocks"], plan["max_bands"]), ("df_fwd", p)
        plan = moment_cov.bwd_launch_plan(p, n)  # #3
        assert plan["batches"] == -(-n // (32 * moment_cov.BWD_LANE_COLS))
        assert np.all(_cov_bwd_counts(p, n, plan) == 1), ("cov_bwd", p)
    if n == 2048:  # #1 on three models
        plan = gram_rbf.launch_plan(3, n, sms)
        assert plan["blocks"] <= sms
        assert np.all(_band_counts(3, n, n, plan, gram_rbf.THREADS, 1) == 1)

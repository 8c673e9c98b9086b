"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. On a machine with
the card and nvcc (no JAX needed, hence no repo conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Sizes cover a single row, ragged edges (N not a multiple of the 8-row
backward block, nor a whole number of the df lean forward's bands or
the cov forward's row bands) and the flagship N=384. The kernels whose
cross-block sums run in a fixed order are also called twice and must agree
bit for bit.
The Gram runs at 1, 4 and 8 features, one and three models, and at a
ragged band and several column chunks; the iK gradient also on
rectangular slabs (Nr != Nc, Nc % 4 != 0) at ns 1, 3 and 8.
Tolerances: Gram entries rtol 2e-5 + atol 2e-6; each cov output within
COV_RTOL of the sum of the absolute values of its terms (f32 sums in
another order than the plain einsum, E rounded differently through its
exponent; see chip_smoke.py). An f32 sum in any order stays within a few
eps32 (1.2e-7) of that scale; the exponent's rounding adds |exponent|
eps32 to each E, and COV_RTOL leaves room for both. The df32 kernels compute
each E element exactly as their plain twins do (the same uncontracted f32
operations) and differ only in the order of their compensated sums, whose
error is a small multiple of eps32^2 (3.6e-15) of the same scale:
DF_COV_RTOL. The DfCovCore gradients, collapsed to f32 after the df
combination, are held to DF_GRAD_RTOL of their largest entry, as
tests/test_torch_df32.py holds them on the CPU. The whole-step kernels
(ops/df_mm.py) run at N = 32, 96, 128 and 384 (#12 and #8 also at the
ragged 37 and 100, at every width they take): their raw df partials within
DF_COV_RTOL of each output's sum of |terms|, the whole step's f32 outputs
within FULL_EPS of themselves plus DF_COV_RTOL of their scaled sum of
|terms|, the VJP (df cotangents, collapsed at the end) within DF_GRAD_RTOL
of its largest entry. The dispatch's shape rules: state widths past the
kernels' take the plain cores on the card. The backward kernels of the
last slice: the stacked df cov backward and the split whole-step VJP (the
mean path's and the pairs', at N = 129 to 512 and every width) within
DF_GRAD_RTOL of each output's largest entry and bitwise repeatable, the
split route bit for bit with #9 and its on-card combination with
combine_split, and the cov core's iK gradient elementwise
within GIK_RTOL (1 + the sum of the exponent's |terms|) of itself (the
exponent's rounding in another order, see chip_smoke.py).
The N-sharded cores' kernels on rectangular row slabs (Nr of 96, 128 and
192 rows against Nc of 384 and 768 columns): #2, #3, #5, #6 and #7 against
their plain twins, by the same tolerances, #3 and #7 with their launch
counts (one and two).
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch import ops
from gpmpc_tpu_torch.ops import df_cov, gram_rbf, moment_cov

pytestmark = pytest.mark.cuda

DIAG = (0, 3, 5)
SIZES = [1, 37, 100, 384]
COV_RTOL = 1e-5
DF_COV_RTOL = 1e-12
DF_GRAD_RTOL = 3e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cov_problem(seed, n, dev, p=6, ns=3, m=3):
    rng = np.random.default_rng(seed)
    ikh = rng.normal(0, 0.1, (m, n, n))
    arrays = (rng.normal(-2, 0.5, (p, n)), rng.normal(-2, 0.5, (p, n)), rng.normal(0, 0.3, (p, n, ns)),
              rng.normal(0, 0.3, (p, n, ns)), rng.normal(0, 1, (p, n)), rng.normal(0, 1, (p, n)),
              (ikh + ikh.transpose(0, 2, 1)) / 2)
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("ns", [1, 3])
def test_gram_kernel_matches_plain(dev, n, d, ns):
    """Every feature count (one stage of kGramQ features, a partial one, two)
    and a ragged N; bitwise repeatable."""
    rng = np.random.default_rng(n + 10 * d + 100 * ns)
    ls, outs, x = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.uniform(0.3, 2.0, (ns, d)), rng.uniform(0.02, 0.4, ns), rng.uniform(0, 1, (n, d))))
    out = gram_rbf.gram(ls, outs, x)
    torch.testing.assert_close(out, gram_rbf.gram_ref(ls, outs, x), rtol=2e-5, atol=2e-6)
    assert torch.equal(gram_rbf.gram(ls, outs, x), out)


@pytest.mark.parametrize("n", [299, 1000])
def test_gram_kernel_matches_plain_at_ragged_bands_and_chunks(dev, n):
    """N with a ragged row end and a short last band (299), and N whose
    rows span several column chunks on a card of few SMs (1000 at 8 SMs:
    the wrapper's plan for another SM count, patched in); the last fifth of
    the points are 0, as a bucket's padding is (the kernel divides no 0)."""
    rng = np.random.default_rng(n)
    xs = rng.uniform(0, 1, (n, 4))
    xs[n - n // 5:] = 0.0
    ls, outs, x = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.uniform(0.3, 2.0, (3, 4)), rng.uniform(0.02, 0.4, 3), xs))
    ref = gram_rbf.gram_ref(ls, outs, x)
    torch.testing.assert_close(gram_rbf.gram(ls, outs, x), ref, rtol=2e-5, atol=2e-6)
    plan = gram_rbf.launch_plan
    try:
        gram_rbf.launch_plan = lambda ns_, n_, sms: plan(ns_, n_, 8)
        assert plan(3, n, 8)["chunks"] > 1
        torch.testing.assert_close(gram_rbf.gram(ls, outs, x), ref, rtol=2e-5, atol=2e-6)
    finally:
        gram_rbf.launch_plan = plan


def _pairs(ns):
    """(P, the diagonal pairs' positions) of ns state dims."""
    ii, jj = np.triu_indices(ns)
    return len(ii), tuple(int(k) for k in np.where(ii == jj)[0])


@pytest.mark.parametrize("n", [1, 24, 32, 37, 100, 384, 385])
@pytest.mark.parametrize("ns", [1, 3, 8])
def test_cov_fwd_kernel_matches_plain(dev, n, ns):
    """#2 on row bands at ragged N and every state width class, bitwise
    repeatable (its cross-block sums run in a fixed order)."""
    p, diag = _pairs(ns)
    a, c, u, xj, bi, bj, ik = _cov_problem(n + ns, n, dev, p=p, ns=ns, m=len(diag))
    s, co = moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, diag)
    s_r, co_r = moment_cov.cov_core_ref(a, c, u, xj, bi, bj, ik, diag)
    s_abs, co_abs = moment_cov.cov_fwd_abs_terms(a, c, u, xj, bi, bj, ik, diag)
    assert s.shape == s_r.shape and co.shape == co_r.shape
    assert torch.all((s - s_r).abs() <= COV_RTOL * s_abs)
    assert torch.all((co - co_r).abs() <= COV_RTOL * co_abs)
    again = moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, diag)
    assert torch.equal(again[0], s) and torch.equal(again[1], co)  # bitwise repeatable


@pytest.mark.parametrize("n", SIZES)
def test_cov_bwd_row_kernel_matches_plain(dev, n):
    """#3, both sides in one launch (cov_bwd), against the two one-side
    plain calls, each output within COV_RTOL of its sum of |terms|, bitwise
    repeatable; the corr cotangent in diag_pos order."""
    a, c, u, xj, bi, bj, ik = _cov_problem(n + 1, n, dev)
    g = torch.linspace(1.0, 2.0, 6, device=dev)
    g_corr = torch.tensor([1.0, -2.0, 3.0], device=dev)
    gco = torch.zeros(6, device=dev).index_copy(0, torch.tensor(DIAG, device=dev), g_corr)
    out = moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG)
    ref = moment_cov.cov_bwd_plain(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG)
    row = moment_cov.cov_bwd_row_abs_terms(g, a, c, u, xj, bi, bj, ik, gco, DIAG)
    col = moment_cov.cov_bwd_row_abs_terms(g, c, a, xj, u, bj, bi, ik.transpose(1, 2), gco, DIAG)
    for o, r, s in zip(out, ref, (row[0], col[0], row[1], col[1], row[2], col[2])):
        assert o.shape == r.shape
        assert torch.all((o - r).abs() <= COV_RTOL * s + 1e-30)
    again = moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG)
    assert all(torch.equal(x, y) for x, y in zip(again, out))  # bitwise repeatable


def test_covcore_autograd_matches_plain_and_counts_launches(dev):
    a, c, u, xj, bi, bj, ik = _cov_problem(7, 64, dev)
    ops.reset_launch_counts()

    def grads(core):
        leaves = [t.clone().requires_grad_(True) for t in (a, c, u, xj)]
        s, co = core(*leaves, bi, bj, ik, DIAG)
        return torch.autograd.grad(s.sum() + 2.0 * co.sum(), leaves)

    for o, r in zip(grads(ops.cov_core), grads(moment_cov.cov_core_ref)):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-4 * float(r.abs().max()))
    assert ops.launch_counts() == {"gram": 0, "cov_fwd": 1, "cov_bwd_row": 1, "cov_gik": 0, "df_fwd": 0,
                                   "df_fwdres": 0, "df_bwd": 0, "df_mm_full": 0, "df_mm_fwd": 0, "df_mm_bwd": 0,
                                   "df_mm_bwd_mean": 0, "df_mm_bwd_pair": 0}


def test_cuda_wrappers_refuse_other_dtypes(dev):
    a, c, u, xj, bi, bj, ik = (t.double() for t in _cov_problem(8, 16, dev))
    with pytest.raises(TypeError):
        ops.cov_core(a, c, u, xj, bi, bj, ik, DIAG)
    with pytest.raises(TypeError):
        ops.gram(torch.ones(3, 4, device=dev, dtype=torch.float64), torch.ones(3, device=dev, dtype=torch.float64),
                 torch.ones(5, 4, device=dev, dtype=torch.float64))


def _df_problem(seed, n, dev, p=6, ns=3, m=3):
    """df operands (14 f32 halves split from f64 draws) whose outputs do not
    cancel, on ``dev``."""
    rng = np.random.default_rng(seed)
    ikh = rng.normal(0, 0.1, (m, n, n))
    draws = (rng.normal(-2, 0.5, (p, n)), rng.normal(-2, 0.5, (p, n)), rng.normal(0, 0.3, (p, n, ns)),
             rng.normal(0, 0.3, (p, n, ns)), rng.normal(0, 1, (p, n)), rng.normal(0, 1, (p, n)),
             (ikh + ikh.transpose(0, 2, 1)) / 2)
    out = []
    for x in draws:
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        out += [torch.tensor(hi, device=dev), torch.tensor(lo, device=dev)]
    return out


def _df_within(out_h, out_l, ref_h, ref_l, scale):
    err = ((out_h.double() + out_l.double()) - (ref_h.double() + ref_l.double())).abs()
    assert torch.all(err <= DF_COV_RTOL * scale), float((err / scale).max())


@pytest.mark.parametrize("n", SIZES)
def test_df_fwd_kernel_matches_plain(dev, n):
    args = _df_problem(n, n, dev)
    out = df_cov.df_cov_fwd(*args, DIAG)
    ref = df_cov.df_cov_fwd_plain(*args, DIAG)
    (s_abs, co_abs), _ = df_cov.df_cov_abs_terms(*args, DIAG)
    _df_within(out[0], out[1], ref[0], ref[1], s_abs)
    _df_within(out[2], out[3], ref[2], ref[3], co_abs)
    again = df_cov.df_cov_fwd(*args, DIAG)
    assert all(torch.equal(a, b) for a, b in zip(again, out))  # bitwise repeatable


@pytest.mark.parametrize("n", SIZES)
def test_df_fwdres_kernel_matches_plain(dev, n):
    args = _df_problem(n + 1, n, dev)
    rows, cols = df_cov.df_cov_fwdres(*args, DIAG)
    rows_r, cols_r = df_cov.df_cov_fwdres_plain(*args, DIAG)
    _, (row_abs, col_abs) = df_cov.df_cov_abs_terms(*args, DIAG)
    for out, ref, scale in ((rows, rows_r, row_abs), (cols, cols_r, col_abs)):
        assert len(out) == len(ref) == 16
        for k in range(0, 16, 2):
            _df_within(out[k], out[k + 1], ref[k], ref[k + 1], scale[k] + 1e-300)


def test_dfcovcore_autograd_matches_plain_and_counts_launches(dev):
    """DfCovCore on the card (the residual kernel and the df backward) against
    autograd through the plain core on the card; the dispatch launches the
    lean forward without autograd and the residual kernel with it."""
    args = _df_problem(7, 64, dev)
    w = torch.linspace(1.0, 2.0, 6, device=dev)
    wc = torch.tensor([1.0, 2.0, 3.0], device=dev)

    def grads(core):
        a = [t.clone() for t in args]
        leaves = [a[i].requires_grad_(True) for i in (0, 2, 4, 6)]
        sh, sl, ch, cl = core(*a, DIAG)
        return torch.autograd.grad((w * (sh + sl)).sum() + (wc * (ch + cl)).sum(), leaves)

    ops.reset_launch_counts()
    for o, r in zip(grads(ops.df_cov_core), grads(df_cov.df_cov_core_ref)):
        torch.testing.assert_close(o, r, rtol=0, atol=DF_GRAD_RTOL * float(r.abs().max()))
    assert ops.launch_counts()["df_fwdres"] == 1 and ops.launch_counts()["df_fwd"] == 0
    with torch.no_grad():
        ops.df_cov_core(*args, DIAG)
    assert ops.launch_counts() == {"gram": 0, "cov_fwd": 0, "cov_bwd_row": 0, "cov_gik": 0, "df_fwd": 1,
                                   "df_fwdres": 1, "df_bwd": 0, "df_mm_full": 0, "df_mm_fwd": 0, "df_mm_bwd": 0,
                                   "df_mm_bwd_mean": 0, "df_mm_bwd_pair": 0}


def test_df_kernels_refuse_non_f32_halves(dev):
    args = [t.double() for t in _df_problem(8, 16, dev)]
    with pytest.raises(TypeError):
        ops.df_cov_core(*args, DIAG)
    with pytest.raises(TypeError):
        df_cov.df_cov_fwdres(*args, DIAG)


# ---------------------------------------------------------------------------
# the whole-step df32 kernels (ops/df_mm.py): #12 df_mm_full, #8 df_mm_fwd,
# #9 df_mm_bwd, each against its plain twin on the card
# ---------------------------------------------------------------------------

DF_MM_SIZES = [32, 96, 128, 384]
# the final f32 outputs of #12: each within a few eps32 of itself (the
# collapse after a df sum, then c or 1 / sqrt det R), plus DF_COV_RTOL of its
# sum of |terms| (scaled as the output is) for the df sums' order
FULL_EPS = 4 * 2.0 ** -23


def _df_mm_problem(seed, n, dev, ns=3, d=4, time_column=False):
    """A random DFCache-shaped operand set (f64 draws split into f32 halves)
    whose outputs do not cancel, with an input mean and state covariance.
    ``time_column``: the last input is the time model's raw step index, as
    the memory stores it every 10 steps (0, 10, ..., 10 (n - 1); the mean at
    10 n + 5), with a time lengthscale of 50-1000."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)

    def split(x):
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        return torch.tensor(hi, device=dev), torch.tensor(lo, device=dev)

    ils = 1.0 / rng.uniform(0.3, 0.8, (ns, d))
    ik = rng.normal(0, 0.1, (ns, n, n))
    outs = rng.uniform(0.5, 1.0, ns)
    x = rng.uniform(0, 1, (n, d))
    mu = rng.uniform(0.3, 0.7, d)
    if time_column:
        ils[:, -1] = 1.0 / rng.uniform(50, 1000, ns)
        x[:, -1] = 10.0 * np.arange(n)
        mu[-1] = 10.0 * n + 5
    f = {}
    for name, v in (("x", x), ("ils", ils), ("ils2", ils * ils), ("log_outs", np.log(outs)),
                    ("beta", rng.normal(0, 1, (ns, n))), ("iK", (ik + ik.transpose(0, 2, 1)) / 2)):
        f[f"{name}_hi"], f[f"{name}_lo"] = split(v)
    cache = SimpleNamespace(outs=torch.tensor(outs, dtype=torch.float32, device=dev), **f)
    mu = torch.tensor(mu, dtype=torch.float32, device=dev)
    sv = torch.tensor(np.eye(ns) * 1e-2 + 2e-3, dtype=torch.float32, device=dev)
    return cache, mu, sv


def _stage1(cache, sv):
    from gpmpc_tpu_torch.ops import df_mm

    ii, jj, _, _ = df_mm.pair_indices(sv.shape[0], sv.device)
    return df_mm.df_stage1(cache, sv, ii, jj)


@pytest.mark.parametrize("n", [32, 37, 96, 100, 128, 384])
@pytest.mark.parametrize("ns,d", [(1, 2), (2, 3), (3, 4), (1, 8), (2, 8), (3, 8)])
def test_df_mm_full_kernel_matches_plain(dev, n, ns, d):
    """#12 at every width it takes (d = ns + 1 and 8) and ragged N, and #8,
    which shares its launch, on the same operands: each bitwise repeatable."""
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(n + 10 * ns + d, n, dev, ns=ns, d=d)
    out = df_mm.full_step_fwd(mu, sv, cache)
    ref = df_mm.full_step_plain(mu, sv, cache)
    Bh, Bl, c32, Qh, Ql, sdr = _stage1(cache, sv)
    m_abs, v_abs, sp_abs, co_abs = df_mm.abs_terms(mu, Bh, Bl, Qh, Ql, cache)
    diag = df_mm.pair_indices(ns, dev)[2]
    sp_scale = (sp_abs + torch.zeros_like(sp_abs).index_add(0, diag, co_abs)) / sdr.double()
    scales = (m_abs * c32.double(), v_abs * c32.double()[:, None], sp_scale)
    for o, r, s in zip(out, ref, scales):
        assert o.shape == r.shape
        err = (o.double() - r.double()).abs()
        assert torch.all(err <= FULL_EPS * r.double().abs() + DF_COV_RTOL * s), float(err.max())
    assert all(torch.equal(a, b) for a, b in zip(df_mm.full_step_fwd(mu, sv, cache), out))  # bitwise repeatable
    raw = df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache)
    raw_ref = df_mm.stage23_plain(mu, Bh, Bl, Qh, Ql, cache)
    for k, scale in enumerate((m_abs, v_abs, sp_abs, co_abs)):
        _df_within(raw[2 * k], raw[2 * k + 1], raw_ref[2 * k], raw_ref[2 * k + 1], scale + 1e-300)
    assert all(torch.equal(a, b) for a, b in zip(df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache), raw))


@pytest.mark.parametrize("n", DF_MM_SIZES)
def test_df_mm_fwd_kernel_matches_plain(dev, n):
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(n + 1, n, dev)
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, sv)
    out = df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache)
    ref = df_mm.stage23_plain(mu, Bh, Bl, Qh, Ql, cache)
    for k, scale in enumerate(df_mm.abs_terms(mu, Bh, Bl, Qh, Ql, cache)):
        _df_within(out[2 * k], out[2 * k + 1], ref[2 * k], ref[2 * k + 1], scale)


@pytest.mark.parametrize("n", DF_MM_SIZES)
def test_df_mm_bwd_kernel_matches_plain(dev, n):
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(n + 2, n, dev)
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, sv)
    rng = np.random.default_rng(n)
    g = [torch.tensor(rng.normal(size=s), dtype=torch.float32, device=dev) for s in ((3,), (3, 4), (6,), (3,))]
    out = df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)  # #9 at every N, 384 included
    ref = df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, cache, *g)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        torch.testing.assert_close(o, r, rtol=0, atol=DF_GRAD_RTOL * float(r.abs().max()))


def test_fullstep_autograd_matches_plain_and_counts_launches(dev):
    """FullStep on the card (forward #12; backward #8 then #9 on the split
    path) against FullStep on CPU copies, which runs the plain twins."""
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(11, 64, dev)
    cpu_cache = type(cache)(**{k: v.cpu() for k, v in vars(cache).items()})
    w = [torch.linspace(1.0, 2.0, s, device=dev) for s in (3, 12, 6)]

    def grads(c, m, s):
        leaves = (m.clone().requires_grad_(True), s.clone().requires_grad_(True))
        M, V, Sp = df_mm.full_step(*leaves, c)
        loss = sum((wi.to(M.device) * o.reshape(-1)).sum() for wi, o in zip(w, (M, V, Sp)))
        return torch.autograd.grad(loss, leaves)

    ops.reset_launch_counts()
    g_card = grads(cache, mu, sv)
    counts = ops.launch_counts()
    assert (counts["df_mm_full"], counts["df_mm_fwd"], counts["df_mm_bwd"]) == (1, 1, 1), counts
    assert counts["df_fwd"] == counts["df_fwdres"] == 0
    for o, r in zip(g_card, grads(cpu_cache, mu.cpu(), sv.cpu())):
        torch.testing.assert_close(o.cpu(), r, rtol=0, atol=DF_GRAD_RTOL * float(r.abs().max()))
    with torch.no_grad():
        df_mm.full_step(mu, sv, cache)
    assert ops.launch_counts()["df_mm_full"] == 2 and ops.launch_counts()["df_mm_bwd"] == 1


def test_df_mm_kernels_refuse_non_f32_halves(dev):
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(12, 32, dev)
    with pytest.raises(TypeError):
        df_mm.full_step_fwd(mu.double(), sv, cache)
    bad = type(cache)(**{k: (v.double() if k == "iK_lo" else v) for k, v in vars(cache).items()})
    with pytest.raises(TypeError):
        df_mm.full_step_fwd(mu, sv, bad)
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, sv)
    with pytest.raises(TypeError):
        df_mm.stage23_fwd(mu, Bh.double(), Bl, Qh, Ql, cache)


def test_wide_state_dispatch_takes_the_plain_cores(dev):
    """ns = 4 in mixed mode (past the df kernels' 3) and ns = 9 in f32 (past
    the cov kernels' 8) take the plain cores on the card, by the dispatch's
    shape rules, and do not raise; forward and under autograd."""
    ns, p = 4, 10
    diag = tuple(k for k, (i, j) in enumerate(zip(*np.triu_indices(ns))) if i == j)
    args = _df_problem(13, 24, dev, p=p, ns=ns, m=ns)
    ops.reset_launch_counts()
    out = ops.df_cov_core(*args, diag)
    for o, r in zip(out, df_cov.df_cov_core_ref(*args, diag)):
        assert torch.equal(o, r)
    leaves = [t.clone().requires_grad_(True) for t in args[:2]]
    sh, sl, ch, cl = ops.df_cov_core(*leaves, *args[2:], diag)
    torch.autograd.grad((sh + sl).sum() - (ch + cl).sum(), leaves[0])
    ns, p = 9, 45
    diag = tuple(k for k, (i, j) in enumerate(zip(*np.triu_indices(ns))) if i == j)
    a, c, u, xj, bi, bj, ik = _cov_problem(14, 24, dev, p=p, ns=ns, m=ns)
    s, co = ops.cov_core(a, c, u, xj, bi, bj, ik, diag)
    s_r, co_r = moment_cov.cov_core_ref(a, c, u, xj, bi, bj, ik, diag)
    assert torch.equal(s, s_r) and torch.equal(co, co_r)
    leaf = a.clone().requires_grad_(True)
    torch.autograd.grad(ops.cov_core(leaf, c, u, xj, bi, bj, ik, diag)[0].sum(), leaf)
    with pytest.raises(NotImplementedError):
        moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, diag)
    assert all(v == 0 for v in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the backward kernels of the last slice: #7 df_bwd, #10 df_mm_bwd_mean,
# #11 df_mm_bwd_pair, #4 cov_gik
# ---------------------------------------------------------------------------

GIK_RTOL = 8 * 2.0 ** -23
SPLIT_SIZES = [129, 160, 192, 384, 512]


def _within_largest(out, ref, rtol=DF_GRAD_RTOL):
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=rtol * float(ref.abs().max()))


@pytest.mark.parametrize("n", SIZES)
def test_df_bwd_kernel_matches_plain(dev, n):
    args = _df_problem(n + 2, n, dev)
    gs = torch.linspace(1.0, 2.0, 6, device=dev)
    gco = torch.zeros(6, device=dev).index_copy(0, torch.tensor(DIAG, device=dev),
                                                 torch.tensor([1.0, -2.0, 3.0], device=dev))
    out = df_cov.df_cov_bwd(*args, gs, gco, DIAG)
    ref = df_cov.df_cov_bwd_plain(*args, gs, gco, DIAG)
    for o, r in zip(out, ref):
        _within_largest(o, r)
    assert all(torch.equal(a, b) for a, b in zip(df_cov.df_cov_bwd(*args, gs, gco, DIAG), out))  # repeatable


def test_stacked_dispatch_matches_residual_and_counts_launches(dev):
    """Under VJP_MODE "stacked" the dispatch's autograd takes the lean
    forward and the stacked backward (never the residual kernel), and its
    gradients agree with the residual scheme's."""
    args = _df_problem(15, 96, dev)
    w = torch.linspace(1.0, 2.0, 6, device=dev)
    wc = torch.tensor([1.0, 2.0, 3.0], device=dev)

    def grads(core):
        a = [t.clone() for t in args]
        leaves = [a[i].requires_grad_(True) for i in (0, 2, 4, 6)]
        sh, sl, ch, cl = core(*a, DIAG)
        return torch.autograd.grad((w * (sh + sl)).sum() + (wc * (ch + cl)).sum(), leaves)

    ref = grads(df_cov.DfCovCore.apply)
    mode = df_cov.VJP_MODE
    df_cov.VJP_MODE = "stacked"
    try:
        ops.reset_launch_counts()
        out = grads(ops.df_cov_core)
        counts = ops.launch_counts()
    finally:
        df_cov.VJP_MODE = mode
    assert (counts["df_fwd"], counts["df_bwd"], counts["df_fwdres"]) == (1, 1, 0), counts
    for o, r in zip(out, ref):
        _within_largest(o, r)


def _split_case(n, ns, d, dev):
    """A random problem of the split route's shapes, its stage 1 (B^-1 and Q
    halves) and random cotangents g_M, g_V, g_S_p, g_corr."""
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(n + 10 * ns + d + 3, n, dev, ns=ns, d=d)
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, sv)
    p = Qh.shape[0]
    rng = np.random.default_rng(n + ns + d)
    g = [torch.tensor(rng.normal(size=s), dtype=torch.float32, device=dev) for s in ((ns,), (ns, d), (p,), (ns,))]
    return df_mm, cache, mu, Bh, Bl, Qh, Ql, g


@pytest.mark.parametrize("n", SPLIT_SIZES)
@pytest.mark.parametrize("ns,d", [(1, 2), (2, 3), (3, 4), (1, 8), (2, 8), (3, 8)])
def test_df_mm_split_bwd_kernels_match_plain(dev, n, ns, d):
    """#10 and #11 against their twins (each df output collapsed in f64) at
    every width they take and ragged N, each bitwise repeatable, and the
    split route of stage23_bwd (N > 128) against #9 at the same N: within
    DF_GRAD_RTOL, and bit for bit (the same df sums; g_mu adds them in
    another order, which the collapse to f32 hides)."""
    df_mm, cache, mu, Bh, Bl, Qh, Ql, g = _split_case(n, ns, d, dev)

    def v(x):
        return x[0].double() + x[1].double()

    (m_inp, g_b) = df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1])
    (m_inp_r, g_b_r) = df_mm.stage23_vjp_mean_plain(mu, Bh, Bl, cache, g[0], g[1])
    _within_largest(v(m_inp), v(m_inp_r))
    _within_largest(g_b, g_b_r)
    again = df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1])
    assert all(torch.equal(a, b) for a, b in zip((*again[0], again[1]), (*m_inp, g_b)))
    (p_inp, g_q) = df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3])
    (p_inp_r, g_q_r) = df_mm.stage23_vjp_pairs_plain(mu, Qh, Ql, cache, g[2], g[3])
    _within_largest(v(p_inp), v(p_inp_r))
    _within_largest(g_q, g_q_r)
    again = df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3])
    assert all(torch.equal(a, b) for a, b in zip((*again[0], again[1]), (*p_inp, g_q)))
    ops.reset_launch_counts()
    split = df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, cache, *g)
    counts = ops.launch_counts()
    assert (counts["df_mm_bwd_mean"], counts["df_mm_bwd_pair"], counts["df_mm_bwd"]) == (1, 1, 0), counts
    whole = df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)  # #9 at the same N
    assert ops.launch_counts()["df_mm_bwd"] == 1
    for o, r in zip(split, whole):
        _within_largest(o, r)
        assert torch.equal(o, r)


@pytest.mark.parametrize("n", [129, 384])
def test_df_mm_split_combine_matches_combine_split(dev, n):
    """The split route's on-card combination (#11's last launch adds #10's
    df contribution to mu's cotangent and the pairs') equals combine_split,
    the same IEEE operations in the same order, run by PyTorch on the card's
    #10 and #11 outputs, bit for bit; g_B and g_Q are #10's and #11's."""
    df_mm, cache, mu, Bh, Bl, Qh, Ql, g = _split_case(n, 3, 4, dev)
    m_inp, g_b = df_mm.stage23_bwd_mean(mu, Bh, Bl, cache, g[0], g[1])
    p_inp, g_q = df_mm.stage23_bwd_pairs(mu, Qh, Ql, cache, g[2], g[3])
    g_mu, g_B, g_Q = df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, cache, *g)
    assert torch.equal(g_mu, df_mm.combine_split(m_inp, p_inp))
    assert torch.equal(g_B, g_b) and torch.equal(g_Q, g_q)


@pytest.mark.parametrize("n", SIZES)
def test_cov_gik_kernel_matches_plain(dev, n):
    a, c, u, xj, bi, bj, ik = _cov_problem(n + 4, n, dev)
    g = torch.tensor([1.0, -2.0, 0.5], device=dev)
    out = moment_cov.cov_gik(g, a, c, u, xj, DIAG)
    ref = moment_cov.cov_gik_plain(g, a, c, u, xj, DIAG)
    expo = moment_cov.cov_gik_expo_abs(a, c, u, xj, DIAG)
    assert out.shape == ref.shape == (3, n, n)
    assert torch.all((out - ref).abs() <= GIK_RTOL * (1.0 + expo) * ref.abs())


@pytest.mark.parametrize("nr,nc", [(1, 5), (37, 24), (100, 37), (203, 301), (384, 101), (60, 1500)])
@pytest.mark.parametrize("ns", [1, 3, 8])
def test_cov_gik_kernel_matches_plain_on_rectangular_slabs(dev, nr, nc, ns):
    """Nr != Nc, Nc % 4 != 0 (the pair's columns then not 16-byte aligned,
    scalar loads), Nr not a whole number of the plan's bands, more items
    than threads in a block (60 x 1500); each diagonal pair its own E, so a
    wrong pair slot shows; bitwise repeatable."""
    rng = np.random.default_rng(nr + nc + ns)
    a, c, u, xj = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (
        rng.normal(-2, 0.5, (6, nr)), rng.normal(-2, 0.5, (6, nc)), rng.normal(0, 0.3, (6, nr, ns)),
        rng.normal(0, 0.3, (6, nc, ns))))
    g = torch.tensor([1.0, -2.0, 0.5], device=dev)
    out = moment_cov.cov_gik(g, a, c, u, xj, DIAG)
    ref = moment_cov.cov_gik_plain(g, a, c, u, xj, DIAG)
    expo = moment_cov.cov_gik_expo_abs(a, c, u, xj, DIAG)
    assert out.shape == ref.shape == (3, nr, nc)
    assert torch.all((out - ref).abs() <= GIK_RTOL * (1.0 + expo) * ref.abs())
    assert torch.equal(moment_cov.cov_gik(g, a, c, u, xj, DIAG), out)


def test_redesigned_elementwise_launch_info(dev):
    """#1's and #4's launch reports at the flagship's shapes: no spills, the
    plan's rows and grid, at least one resident block per SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for info, plan in ((gram_rbf.launch_info(3, 384), gram_rbf.launch_plan(3, 384, sms)),
                       (moment_cov.gik_launch_info(3, 384, 384, 3), moment_cov.gik_launch_plan(3, 384, 384, sms))):
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1
        assert (info["rows"], info["grid"]) == (plan["rows"], plan["blocks"])


def test_covcore_ik_grad_launches_cov_gik_only_when_asked(dev):
    """CovCore's iK gradient is the cov_gik kernel, launched once when iK
    needs a gradient and never otherwise; it equals autograd of the plain
    core elementwise."""
    a, c, u, xj, bi, bj, ik = _cov_problem(16, 64, dev)
    ops.reset_launch_counts()
    leaf = a.clone().requires_grad_(True)
    s, co = ops.cov_core(leaf, c, u, xj, bi, bj, ik, DIAG)
    torch.autograd.grad(s.sum() + co.sum(), leaf)
    assert ops.launch_counts()["cov_gik"] == 0

    def ik_grad(core):
        ik_leaf = ik.clone().requires_grad_(True)
        s, co = core(a, c, u, xj, bi, bj, ik_leaf, DIAG)
        return torch.autograd.grad(s.sum() + (co * torch.tensor([1.0, 2.0, 3.0], device=dev)).sum(), ik_leaf)[0]

    out = ik_grad(ops.cov_core)
    assert ops.launch_counts()["cov_gik"] == 1
    ref = ik_grad(moment_cov.cov_core_ref)
    expo = moment_cov.cov_gik_expo_abs(a, c, u, xj, DIAG)
    assert torch.all((out - ref).abs() <= GIK_RTOL * (1.0 + expo) * ref.abs())


def test_backward_kernels_refuse_non_f32(dev):
    from gpmpc_tpu_torch.ops import df_mm

    args = _df_problem(17, 16, dev)
    gs = torch.ones(6, device=dev)
    with pytest.raises(TypeError):
        df_cov.df_cov_bwd(*[t.double() for t in args], gs, gs, DIAG)
    with pytest.raises(TypeError):
        df_cov.df_cov_bwd(*args, gs.double(), gs, DIAG)
    with pytest.raises(ValueError):
        df_cov.df_cov_bwd(*args, gs[:3], gs, DIAG)
    a, c, u, xj, bi, bj, ik = _cov_problem(18, 16, dev)
    with pytest.raises(TypeError):
        moment_cov.cov_gik(torch.ones(3, device=dev), a.double(), c, u, xj, DIAG)
    with pytest.raises(ValueError):
        moment_cov.cov_gik(torch.ones(3, device=dev), a, c, u, xj, (0, 3, 6))
    cache, mu, sv = _df_mm_problem(19, 160, dev)
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, sv)
    with pytest.raises(TypeError):
        df_mm.stage23_bwd_mean(mu, Bh.double(), Bl, cache, torch.ones(3, device=dev), torch.ones(3, 4, device=dev))
    with pytest.raises(TypeError):
        df_mm.stage23_bwd_pairs(mu, Qh, Ql.double(), cache, torch.ones(6, device=dev), torch.ones(3, device=dev))


# ---------------------------------------------------------------------------
# the redesigned kernels: #9 on stacked rows (a cluster of blocks per unit of
# 32 points, a warp per point against all N), #6 on row bands sized to the
# card's SMs
# ---------------------------------------------------------------------------

STACKED_SIZES = [32, 37, 96, 128, 384]


@pytest.mark.parametrize("n", STACKED_SIZES)
@pytest.mark.parametrize("ns,d", [(1, 2), (2, 3), (3, 4), (1, 8), (2, 8), (3, 8)])
def test_df_mm_bwd_stacked_rows_match_plain(dev, n, ns, d):
    """#9 against its twin at every width it takes (d = ns + 1 and 8),
    bitwise repeatable; at 384 also against the split route (#10 + #11),
    whose df cotangents it sums in the same order."""
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(n + 10 * ns + d, n, dev, ns=ns, d=d)
    Bh, Bl, _, Qh, Ql, _ = _stage1(cache, sv)
    p = Qh.shape[0]
    rng = np.random.default_rng(n + ns)
    g = [torch.tensor(rng.normal(size=s), dtype=torch.float32, device=dev) for s in ((ns,), (ns, d), (p,), (ns,))]
    out = df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)
    ref = df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, cache, *g)
    for o, r in zip(out, ref):
        _within_largest(o, r)
    assert all(torch.equal(a, b) for a, b in zip(df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g), out))
    if n > df_mm.SINGLE_BWD_MAX_N:
        for o, r in zip(df_mm.stage23_bwd(mu, Bh, Bl, Qh, Ql, cache, *g), out):
            _within_largest(o, r)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("ns", [1, 2, 3])
def test_df_fwdres_bands_match_plain(dev, n, ns):
    """#6 against its twin for every state width, on a diagonal and an
    off-diagonal pair at least (ns = 1 gets a second, off-diagonal pair),
    bitwise repeatable."""
    p = max(2, ns * (ns + 1) // 2)
    ii, jj = np.triu_indices(ns)
    diag = tuple(int(k) for k in np.where(ii == jj)[0])
    args = _df_problem(n + 7 * ns, n, dev, p=p, ns=ns, m=len(diag))
    rows, cols = df_cov.df_cov_fwdres(*args, diag)
    rows_r, cols_r = df_cov.df_cov_fwdres_plain(*args, diag)
    _, (row_abs, col_abs) = df_cov.df_cov_abs_terms(*args, diag)
    for out, ref, scale in ((rows, rows_r, row_abs), (cols, cols_r, col_abs)):
        assert len(out) == len(ref) == 4 + 4 * ns
        for k in range(0, len(out), 2):
            _df_within(out[k], out[k + 1], ref[k], ref[k + 1], scale[k] + 1e-300)
    again = df_cov.df_cov_fwdres(*args, diag)
    assert all(torch.equal(a, b) for a, b in zip(again[0] + again[1], rows + cols))


# rectangular slabs: a rank's rows of the N-sharded cores (2- and 4-way
# splits of the 384 and 768 buckets, and 128 rows) against all columns
RECT = [(nr, nc) for nr in (96, 128, 192) for nc in (384, 768)]


def _rect_arrays(rng, nr, nc, p, ns, m):
    """(a, c, U, Xj, bi, bj, iK) of Nr rows against Nc columns, drawn as
    _cov_problem draws them, and the slab's rows of a symmetric iK."""
    ik = rng.normal(0, 0.1, (m, nc, nc))
    return (rng.normal(-2, 0.5, (p, nr)), rng.normal(-2, 0.5, (p, nc)), rng.normal(0, 0.3, (p, nr, ns)),
            rng.normal(0, 0.3, (p, nc, ns)), rng.normal(0, 1, (p, nr)), rng.normal(0, 1, (p, nc)),
            ((ik + ik.transpose(0, 2, 1)) / 2)[:, nc - nr:])


@pytest.mark.parametrize("nr,nc", RECT)
def test_cov_kernels_match_plain_on_rectangular_slabs(dev, nr, nc):
    """#2 and #3 on a row slab: each output within COV_RTOL of its sum of
    |terms| (the column side's on iK's transpose), bitwise repeatable, one
    cov_bwd_row launch for both sides, and CovCore's autograd against
    autograd of the plain core."""
    a, c, u, xj, bi, bj, ik = (torch.tensor(x, dtype=torch.float32, device=dev)
                               for x in _rect_arrays(np.random.default_rng(nr + nc), nr, nc, 6, 3, 3))
    s, co = moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, DIAG)
    s_r, co_r = moment_cov.cov_core_ref(a, c, u, xj, bi, bj, ik, DIAG)
    s_abs, co_abs = moment_cov.cov_fwd_abs_terms(a, c, u, xj, bi, bj, ik, DIAG)
    assert torch.all((s - s_r).abs() <= COV_RTOL * s_abs) and torch.all((co - co_r).abs() <= COV_RTOL * co_abs)
    g = torch.linspace(1.0, 2.0, 6, device=dev)
    g_corr = torch.tensor([1.0, -2.0, 3.0], device=dev)
    gco = torch.zeros(6, device=dev).index_copy(0, torch.tensor(DIAG, device=dev), g_corr)
    ops.reset_launch_counts()
    out = moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG)
    assert ops.launch_counts()["cov_bwd_row"] == 1
    ref = moment_cov.cov_bwd_plain(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG)
    row = moment_cov.cov_bwd_row_abs_terms(g, a, c, u, xj, bi, bj, ik, gco, DIAG)
    col = moment_cov.cov_bwd_row_abs_terms(g, c, a, xj, u, bj, bi, ik.transpose(1, 2), gco, DIAG)
    for o, r, sc in zip(out, ref, (row[0], col[0], row[1], col[1], row[2], col[2])):
        assert o.shape == r.shape
        assert torch.all((o - r).abs() <= COV_RTOL * sc + 1e-30)
    again = moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, DIAG)
    assert all(torch.equal(x, y) for x, y in zip(again, out))

    def grads(core):
        leaves = [t.clone().requires_grad_(True) for t in (a, c, u, xj, bi, bj)]
        s_, co_ = core(*leaves, ik, DIAG)
        return torch.autograd.grad((s_ * g).sum() + (co_ * g_corr).sum(), leaves)

    for o, r in zip(grads(moment_cov.CovCore.apply), grads(moment_cov.cov_core_ref)):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-4 * float(r.abs().max()))


@pytest.mark.parametrize("nr,nc", RECT)
def test_df_kernels_match_plain_on_rectangular_slabs(dev, nr, nc):
    """#5, #6 and #7 on a row slab: the lean forward and the residuals within
    DF_COV_RTOL of their sums of |terms|, the stacked backward (two
    launches, one per side) within DF_GRAD_RTOL of each output's largest
    entry and bitwise repeatable, and DfCovCoreStacked's gradients against
    DfCovCore's."""
    args = []
    for x in _rect_arrays(np.random.default_rng(nr * nc), nr, nc, 6, 3, 3):
        hi = x.astype(np.float32)
        args += [torch.tensor(hi, device=dev), torch.tensor((x - hi.astype(np.float64)).astype(np.float32),
                                                            device=dev)]
    out = df_cov.df_cov_fwd(*args, DIAG)
    ref = df_cov.df_cov_fwd_plain(*args, DIAG)
    (s_abs, co_abs), (row_abs, col_abs) = df_cov.df_cov_abs_terms(*args, DIAG)
    _df_within(out[0], out[1], ref[0], ref[1], s_abs)
    _df_within(out[2], out[3], ref[2], ref[3], co_abs)
    rows, cols = df_cov.df_cov_fwdres(*args, DIAG)
    rows_r, cols_r = df_cov.df_cov_fwdres_plain(*args, DIAG)
    for o, r, scale in ((rows, rows_r, row_abs), (cols, cols_r, col_abs)):
        for k in range(0, 16, 2):
            _df_within(o[k], o[k + 1], r[k], r[k + 1], scale[k] + 1e-300)
    gs = torch.linspace(1.0, 2.0, 6, device=dev)
    gco = torch.zeros(6, device=dev).index_copy(0, torch.tensor(DIAG, device=dev),
                                                 torch.tensor([1.0, -2.0, 3.0], device=dev))
    ops.reset_launch_counts()
    out = df_cov.df_cov_bwd(*args, gs, gco, DIAG)
    assert ops.launch_counts()["df_bwd"] == 2
    for o, r in zip(out, df_cov.df_cov_bwd_plain(*args, gs, gco, DIAG)):
        _within_largest(o, r)
    assert all(torch.equal(x, y) for x, y in zip(df_cov.df_cov_bwd(*args, gs, gco, DIAG), out))
    w = torch.linspace(1.0, 2.0, 6, device=dev)
    wc = torch.tensor([1.0, 2.0, 3.0], device=dev)

    def grads(core):
        a = [t.clone() for t in args]
        leaves = [a[i].requires_grad_(True) for i in (0, 2, 4, 6)]
        sh, sl, ch, cl = core(*a, DIAG)
        return torch.autograd.grad((w * (sh + sl)).sum() + (wc * (ch + cl)).sum(), leaves)

    for o, r in zip(grads(df_cov.DfCovCoreStacked.apply), grads(df_cov.DfCovCore.apply)):
        _within_largest(o, r)


# the time-varying process-control path: ns = 2 (P = 3, diag_pos (0, 2)),
# d = 5 with the time model's raw step index as the last input
# ---------------------------------------------------------------------------

NS2_DIAG = (0, 2)
NS2_SIZES = [1, 37, 100, 192, 384]


def _check_cov_kernels(a, c, u, xj, bi, bj, ik, diag):
    """#2 and #3 against their plain twins (each output within COV_RTOL of
    its sum of |terms|), both bitwise repeatable."""
    p, dev = a.shape[0], a.device
    s, co = moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, diag)
    s_r, co_r = moment_cov.cov_core_ref(a, c, u, xj, bi, bj, ik, diag)
    s_abs, co_abs = moment_cov.cov_fwd_abs_terms(a, c, u, xj, bi, bj, ik, diag)
    assert torch.all((s - s_r).abs() <= COV_RTOL * s_abs) and torch.all((co - co_r).abs() <= COV_RTOL * co_abs)
    again = moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, diag)
    assert torch.equal(again[0], s) and torch.equal(again[1], co)
    g = torch.linspace(1.0, 2.0, p, device=dev)
    g_corr = torch.linspace(1.0, -2.0, len(diag), device=dev)
    gco = torch.zeros(p, device=dev).index_copy(0, torch.tensor(diag, device=dev), g_corr)
    out = moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, diag)
    ref = moment_cov.cov_bwd_plain(g, a, c, u, xj, bi, bj, ik, g_corr, diag)
    row = moment_cov.cov_bwd_row_abs_terms(g, a, c, u, xj, bi, bj, ik, gco, diag)
    col = moment_cov.cov_bwd_row_abs_terms(g, c, a, xj, u, bj, bi, ik.transpose(1, 2), gco, diag)
    for o, r, sc in zip(out, ref, (row[0], col[0], row[1], col[1], row[2], col[2])):
        assert o.shape == r.shape
        assert torch.all((o - r).abs() <= COV_RTOL * sc + 1e-30)
    assert all(torch.equal(x, y) for x, y in zip(moment_cov.cov_bwd(g, a, c, u, xj, bi, bj, ik, g_corr, diag), out))


def _check_df_kernels(args, diag):
    """#5, #6 and #7 against their plain twins (the forwards within
    DF_COV_RTOL of their sums of |terms|, the stacked backward within
    DF_GRAD_RTOL of each output's largest entry), each bitwise repeatable."""
    p, dev = args[0].shape[0], args[0].device
    out = df_cov.df_cov_fwd(*args, diag)
    ref = df_cov.df_cov_fwd_plain(*args, diag)
    (s_abs, co_abs), (row_abs, col_abs) = df_cov.df_cov_abs_terms(*args, diag)
    _df_within(out[0], out[1], ref[0], ref[1], s_abs)
    _df_within(out[2], out[3], ref[2], ref[3], co_abs)
    assert all(torch.equal(a, b) for a, b in zip(df_cov.df_cov_fwd(*args, diag), out))
    rows, cols = df_cov.df_cov_fwdres(*args, diag)
    rows_r, cols_r = df_cov.df_cov_fwdres_plain(*args, diag)
    for o, r, scale in ((rows, rows_r, row_abs), (cols, cols_r, col_abs)):
        for k in range(0, len(o), 2):
            _df_within(o[k], o[k + 1], r[k], r[k + 1], scale[k] + 1e-300)
    again = df_cov.df_cov_fwdres(*args, diag)
    assert all(torch.equal(a, b) for a, b in zip(list(again[0]) + list(again[1]), list(rows) + list(cols)))
    gs = torch.linspace(1.0, 2.0, p, device=dev)
    gco = torch.zeros(p, device=dev).index_copy(0, torch.tensor(diag, device=dev),
                                                torch.linspace(1.0, -2.0, len(diag), device=dev))
    out = df_cov.df_cov_bwd(*args, gs, gco, diag)
    for o, r in zip(out, df_cov.df_cov_bwd_plain(*args, gs, gco, diag)):
        _within_largest(o, r)
    assert all(torch.equal(a, b) for a, b in zip(df_cov.df_cov_bwd(*args, gs, gco, diag), out))


@pytest.mark.parametrize("n", NS2_SIZES)
def test_cov_kernels_match_plain_at_ns2(dev, n):
    """The ns = 2 instances of #2 and #3 (the f32 step of a process-control
    or mountain-car problem)."""
    _check_cov_kernels(*_cov_problem(n + 21, n, dev, p=3, ns=2, m=2), NS2_DIAG)


@pytest.mark.parametrize("n", NS2_SIZES)
def test_df_kernels_match_plain_at_ns2(dev, n):
    """The ns = 2 instances of #5, #6 and #7 (a mixed process-control step
    past 128 stored points: 150 of the 1500-step workload in the 192
    bucket)."""
    _check_df_kernels(_df_problem(n + 22, n, dev, p=3, ns=2, m=2), NS2_DIAG)


@pytest.mark.parametrize("n", [32, 37, 100, 128])
def test_df_mm_kernels_match_plain_at_ns2_d5_with_a_time_column(dev, n):
    """#12, #8 and #9 at the time-varying process-control widths (ns = 2,
    d = 5), the last input column the raw step index up to 10 (n - 1) and
    the mean's at 10 n + 5: the df32 split of values in the hundreds and
    thousands leaves lo parts the kernels must carry as their twins do."""
    from gpmpc_tpu_torch.ops import df_mm

    cache, mu, sv = _df_mm_problem(n + 23, n, dev, ns=2, d=5, time_column=True)
    assert float(cache.x_hi[:, -1].max()) == 10.0 * (n - 1) and float(mu[-1]) == 10.0 * n + 5
    out = df_mm.full_step_fwd(mu, sv, cache)
    ref = df_mm.full_step_plain(mu, sv, cache)
    Bh, Bl, c32, Qh, Ql, sdr = _stage1(cache, sv)
    m_abs, v_abs, sp_abs, co_abs = df_mm.abs_terms(mu, Bh, Bl, Qh, Ql, cache)
    diag = df_mm.pair_indices(2, dev)[2]
    sp_scale = (sp_abs + torch.zeros_like(sp_abs).index_add(0, diag, co_abs)) / sdr.double()
    for o, r, sc in zip(out, ref, (m_abs * c32.double(), v_abs * c32.double()[:, None], sp_scale)):
        err = (o.double() - r.double()).abs()
        assert torch.all(err <= FULL_EPS * r.double().abs() + DF_COV_RTOL * sc), float(err.max())
    assert all(torch.equal(a, b) for a, b in zip(df_mm.full_step_fwd(mu, sv, cache), out))
    raw = df_mm.stage23_fwd(mu, Bh, Bl, Qh, Ql, cache)
    raw_ref = df_mm.stage23_plain(mu, Bh, Bl, Qh, Ql, cache)
    for k, scale in enumerate((m_abs, v_abs, sp_abs, co_abs)):
        _df_within(raw[2 * k], raw[2 * k + 1], raw_ref[2 * k], raw_ref[2 * k + 1], scale + 1e-300)
    rng = np.random.default_rng(n)
    g = [torch.tensor(rng.normal(size=sh), dtype=torch.float32, device=dev) for sh in ((2,), (2, 5), (3,), (2,))]
    grads = df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g)
    for o, r in zip(grads, df_mm.stage23_vjp_plain(mu, Bh, Bl, Qh, Ql, cache, *g)):
        _within_largest(o, r)
    assert all(torch.equal(a, b) for a, b in zip(df_mm.stage23_bwd_all(mu, Bh, Bl, Qh, Ql, cache, *g), grads))


# the reference's larger buckets: the port's reach 2048 (memory/buffer.py),
# as the JAX df cov kernels serve every padded N up to 2048
# ---------------------------------------------------------------------------

LARGE_SIZES = [768, 1536, 2048]


@pytest.mark.parametrize("n", LARGE_SIZES)
def test_cov_kernels_match_plain_at_large_n(dev, n):
    _check_cov_kernels(*_cov_problem(n + 31, n, dev), DIAG)


@pytest.mark.parametrize("n", LARGE_SIZES)
def test_df_kernels_match_plain_at_large_n(dev, n):
    _check_df_kernels(_df_problem(n + 32, n, dev), DIAG)


def test_gram_kernel_matches_plain_at_2048(dev):
    rng = np.random.default_rng(2048)
    ls, outs, x = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.uniform(0.3, 2.0, (3, 4)), rng.uniform(0.02, 0.4, 3), rng.uniform(0, 1, (2048, 4))))
    out = gram_rbf.gram(ls, outs, x)
    torch.testing.assert_close(out, gram_rbf.gram_ref(ls, outs, x), rtol=2e-5, atol=2e-6)
    assert torch.equal(gram_rbf.gram(ls, outs, x), out)

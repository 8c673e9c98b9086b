"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. On a machine with
the card and nvcc (no JAX needed, hence no repo conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Sizes cover a single row, ragged edges (N not a multiple of the 16-row
forward tile or the 8-row backward block, nor of the df kernels' 32 x 64
tiles) and the flagship N=384.
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
tests/test_torch_df32.py holds them on the CPU.
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
def test_gram_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    ls, outs, x = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.uniform(0.3, 2.0, (3, 4)), rng.uniform(0.02, 0.4, 3), rng.uniform(0, 1, (n, 4))))
    out = gram_rbf.gram(ls, outs, x)
    torch.testing.assert_close(out, gram_rbf.gram_ref(ls, outs, x), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n", SIZES)
def test_cov_fwd_kernel_matches_plain(dev, n):
    a, c, u, xj, bi, bj, ik = _cov_problem(n, n, dev)
    s, co = moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, DIAG)
    s_r, co_r = moment_cov.cov_core_ref(a, c, u, xj, bi, bj, ik, DIAG)
    s_abs, co_abs = moment_cov.cov_fwd_abs_terms(a, c, u, xj, bi, bj, ik, DIAG)
    assert torch.all((s - s_r).abs() <= COV_RTOL * s_abs)
    assert torch.all((co - co_r).abs() <= COV_RTOL * co_abs)
    assert torch.equal(moment_cov.cov_fwd(a, c, u, xj, bi, bj, ik, DIAG)[0], s)  # bitwise repeatable


@pytest.mark.parametrize("n", SIZES)
def test_cov_bwd_row_kernel_matches_plain(dev, n):
    a, c, u, xj, bi, bj, ik = _cov_problem(n + 1, n, dev)
    g = torch.linspace(1.0, 2.0, 6, device=dev)
    gco = torch.zeros(6, device=dev).index_copy(0, torch.tensor(DIAG, device=dev),
                                                 torch.tensor([1.0, 2.0, 3.0], device=dev))
    out = moment_cov.cov_bwd_row(g, a, c, u, xj, bi, bj, ik, gco, DIAG)
    ref = moment_cov.cov_bwd_row_plain(g, a, c, u, xj, bi, bj, ik, gco, DIAG)
    scale = moment_cov.cov_bwd_row_abs_terms(g, a, c, u, xj, bi, bj, ik, gco, DIAG)
    for o, r, s in zip(out, ref, scale):
        assert torch.all((o - r).abs() <= COV_RTOL * s + 1e-30)


def test_covcore_autograd_matches_plain_and_counts_launches(dev):
    a, c, u, xj, bi, bj, ik = _cov_problem(7, 64, dev)
    ops.reset_launch_counts()

    def grads(core):
        leaves = [t.clone().requires_grad_(True) for t in (a, c, u, xj)]
        s, co = core(*leaves, bi, bj, ik, DIAG)
        return torch.autograd.grad(s.sum() + 2.0 * co.sum(), leaves)

    for o, r in zip(grads(ops.cov_core), grads(moment_cov.cov_core_ref)):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-4 * float(r.abs().max()))
    assert ops.launch_counts() == {"gram": 0, "cov_fwd": 1, "cov_bwd_row": 2, "df_fwd": 0, "df_fwdres": 0}


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
    assert ops.launch_counts() == {"gram": 0, "cov_fwd": 0, "cov_bwd_row": 0, "df_fwd": 1, "df_fwdres": 1}


def test_df_kernels_refuse_non_f32_halves(dev):
    args = [t.double() for t in _df_problem(8, 16, dev)]
    with pytest.raises(TypeError):
        ops.df_cov_core(*args, DIAG)
    with pytest.raises(TypeError):
        df_cov.df_cov_fwdres(*args, DIAG)

"""The port's op layer (gpmpc_tpu_torch.ops) against the JAX package.

Same numpy inputs through both packages: the plain PyTorch cov core and
Gram against their XLA forms and against the Pallas kernels run in interpret
mode (patched the way tests/test_pallas_ops.py does), and the CovCore
autograd composite, forced onto its plain path by CPU tensors, against JAX
gradients. The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.models.gp import gram_ard_rbf
from gpmpc_tpu.ops import cov_core_xla
from gpmpc_tpu.ops import pallas_gram
from gpmpc_tpu.ops import pallas_moment_cov as pmc
from gpmpc_tpu_torch import ops
from gpmpc_tpu_torch.ops import df_cov, gram_rbf, moment_cov

DIAG = (0, 3, 5)
W_S = np.arange(1.0, 7.0)  # loss weights of S_p and corr, as tests/test_pallas_ops.py
W_C = 2.0 * np.arange(1.0, 4.0)


def _interpret():
    from jax.experimental import pallas as pl

    return mock.patch.object(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _cov_problem(seed, dtype, p=6, n=64, ns=3, m=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(-2, 0.5, (p, n))
    c = rng.normal(-2, 0.5, (p, n))
    u = rng.normal(0, 0.3, (p, n, ns))
    xj = rng.normal(0, 0.3, (p, n, ns))
    bi = rng.normal(0, 1, (p, n))
    bj = rng.normal(0, 1, (p, n))
    ikh = rng.normal(0, 0.1, (m, n, n))
    ik = (ikh + ikh.transpose(0, 2, 1)) / 2
    return tuple(v.astype(dtype) for v in (a, c, u, xj, bi, bj, ik))


def _jax_loss_grads(core, args):
    def loss(*t):
        s, co = core(*t, args[6], DIAG)
        return jnp.sum(s * W_S.astype(s.dtype)) + jnp.sum(co * W_C.astype(s.dtype))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(*args[:6])


def _torch_loss_grads(core, args):
    leaves = [torch.tensor(v, requires_grad=True) for v in args[:4]]
    rest = [torch.tensor(v) for v in args[4:]]
    s, co = core(*leaves, *rest, DIAG)
    loss = (s * torch.tensor(W_S, dtype=s.dtype)).sum() + (co * torch.tensor(W_C, dtype=s.dtype)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_cov_core_ref_matches_xla(dtype, rtol):
    args = _cov_problem(0, dtype)
    s_ref, co_ref = (np.asarray(v) for v in cov_core_xla(*(jnp.asarray(v) for v in args), DIAG))
    s, co = moment_cov.cov_core_ref(*(torch.tensor(v) for v in args), DIAG)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=rtol)
    np.testing.assert_allclose(co.numpy(), co_ref, rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_cov_core_grads_through_covcore_match_xla(dtype, rtol):
    """CovCore (kernel-shaped forward and the two row-backward passes, on
    their plain twins here) against JAX autodiff of cov_core_xla."""
    args = _cov_problem(1, dtype)
    g_ref = _jax_loss_grads(cov_core_xla, tuple(jnp.asarray(v) for v in args))
    g = _torch_loss_grads(moment_cov.CovCore.apply, args)
    for out, ref in zip(g, g_ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out / np.abs(ref).max(), ref / np.abs(ref).max(), rtol=0, atol=rtol)
    s, co = moment_cov.CovCore.apply(*(torch.tensor(v) for v in args), DIAG)
    s_ref, co_ref = cov_core_xla(*(jnp.asarray(v) for v in args), DIAG)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=rtol)
    np.testing.assert_allclose(co.numpy(), np.asarray(co_ref), rtol=rtol)


def _sum_scale(args):
    """Per output, the sum of the absolute values of its terms: the f32
    rounding of a sum of terms of both signs is bounded by a multiple of
    eps32 times this, whatever the summation order."""
    a, c, u, xj, bi, bj, ik = (torch.tensor(v, dtype=torch.float64) for v in args)
    s, co = moment_cov.cov_core_ref(a, c, u, xj, bi.abs(), bj.abs(), ik.abs(), DIAG)
    return s.numpy(), co.numpy()


def test_cov_core_matches_pallas_interpret():
    """Forward values and gradients wrt a, c, U, Xj of the plain core and of
    CovCore against the Pallas kernels in interpret mode, f32.

    The Pallas kernel sums each output in row tiles, the plain core in one
    einsum: the forward is held to 2e-5 of the output's sum of |terms|
    (an output that cancels to 1e-3 of that sum moves by ~6e-5 of itself)."""
    args = _cov_problem(2, np.float32)
    jargs = tuple(jnp.asarray(v) for v in args)
    pmc._make_cov_core.cache_clear()
    with _interpret():
        s_pl, co_pl = pmc.cov_core_pallas(*jargs, DIAG)
        g_pl = _jax_loss_grads(pmc.cov_core_pallas, jargs)
    pmc._make_cov_core.cache_clear()
    s, co = ops.cov_core(*(torch.tensor(v) for v in args), DIAG)
    s_scale, co_scale = _sum_scale(args)
    assert np.all(np.abs(s.numpy() - np.asarray(s_pl)) <= 2e-5 * s_scale)
    assert np.all(np.abs(co.numpy() - np.asarray(co_pl)) <= 2e-5 * co_scale)
    for core in (moment_cov.cov_core_ref, moment_cov.CovCore.apply):
        for out, ref in zip(_torch_loss_grads(core, args), g_pl):
            ref = np.asarray(ref)
            np.testing.assert_allclose(out / np.abs(ref).max(), ref / np.abs(ref).max(), rtol=0, atol=2e-5)


def test_cov_bwd_row_plain_matches_autograd():
    """The row-backward twin (what the CUDA kernel computes) equals autograd
    of the plain core on the row side, corr term included, and its g_wr is
    the gradient wrt bi."""
    args = [torch.tensor(v) for v in _cov_problem(3, np.float64)]
    a, c, u, xj, bi, bj, ik = args
    w_s = torch.tensor(W_S)
    w_c = torch.tensor(W_C)
    leaves = [t.clone().requires_grad_(True) for t in (a, u, bi)]
    s, co = moment_cov.cov_core_ref(leaves[0], c, leaves[1], xj, leaves[2], bj, ik, DIAG)
    ga_ref, gu_ref, gbi_ref = torch.autograd.grad((s * w_s).sum() + (co * w_c).sum(), leaves)
    gco = torch.zeros(6, dtype=torch.float64).index_copy(0, torch.tensor(DIAG), w_c)
    ga, gu, gbi = moment_cov.cov_bwd_row_plain(w_s, a, c, u, xj, bi, bj, ik, gco, DIAG)
    torch.testing.assert_close(ga, ga_ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gu, gu_ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gbi, gbi_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_covcore_ik_grad_matches_xla(dtype, rtol):
    """CovCore's gradient with respect to iK (the cov_gik wrapper, on its
    plain twin here) against jax.grad of cov_core_xla with respect to ik,
    and in f32 also against the Pallas composite with _gik_kernel run in
    interpret mode. Each entry is g_corr E > 0 with no cancellation, so it
    is held elementwise: 1e-10 in f64, and in f32 2e-5, as the cov core."""
    args = _cov_problem(4, dtype)
    jargs = tuple(jnp.asarray(v) for v in args)

    def jax_ik_grad(core):
        def loss(ik):
            s, co = core(*jargs[:6], ik, DIAG)
            return jnp.sum(s * W_S.astype(s.dtype)) + jnp.sum(co * W_C.astype(s.dtype))

        return np.asarray(jax.grad(loss)(jargs[6]))

    refs = [jax_ik_grad(cov_core_xla)]
    if dtype == np.float32:
        pmc._make_cov_core.cache_clear()
        with _interpret():
            refs.append(jax_ik_grad(pmc.cov_core_pallas))
        pmc._make_cov_core.cache_clear()
    leaves = [torch.tensor(v, requires_grad=True) for v in args]
    s, co = moment_cov.CovCore.apply(*leaves, DIAG)
    loss = (s * torch.tensor(W_S, dtype=s.dtype)).sum() + (co * torch.tensor(W_C, dtype=s.dtype)).sum()
    g_ik, g_a = torch.autograd.grad(loss, [leaves[6], leaves[0]])
    assert g_ik.shape == (len(DIAG),) + args[6].shape[1:]
    for ref in refs:
        np.testing.assert_allclose(g_ik.numpy(), ref, rtol=rtol, atol=0)
    g_a_ref = _jax_loss_grads(cov_core_xla, jargs)[0]  # the other gradients are unchanged by asking for iK's
    np.testing.assert_allclose(g_a.numpy(), np.asarray(g_a_ref), rtol=0, atol=rtol * np.abs(g_a_ref).max())


def _gram_inputs(seed, n=100, ns=3, d=4):
    rng = np.random.default_rng(seed)
    ls = rng.uniform(0.3, 2.0, (ns, d))
    outs = rng.uniform(0.02, 0.4, (ns,))
    x = rng.uniform(0, 1, (n, d))
    return ls, outs, x


def test_gram_ref_matches_xla_and_pallas_interpret():
    ls, outs, x = (v.astype(np.float32) for v in _gram_inputs(5))
    ref = np.asarray(gram_ard_rbf(jnp.asarray(ls), jnp.asarray(outs), jnp.asarray(x)))
    with _interpret():
        pal = np.asarray(pallas_gram.gram_ard_rbf_pallas(jnp.asarray(ls), jnp.asarray(outs), jnp.asarray(x)))
    out = ops.gram(torch.tensor(ls), torch.tensor(outs), torch.tensor(x)).numpy()
    assert out.shape == ref.shape == pal.shape
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out, pal, rtol=2e-5, atol=2e-6)


def test_gram_ref_matches_xla_f64():
    ls, outs, x = _gram_inputs(6, n=37)
    ref = np.asarray(gram_ard_rbf(jnp.asarray(ls), jnp.asarray(outs), jnp.asarray(x)))
    out = gram_rbf.gram_ref(torch.tensor(ls), torch.tensor(outs), torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU never takes the plain path: the
    wrappers launch the kernel or raise (here: a device with no kernel)."""
    args = [torch.empty(s, device="meta") for s in [(6, 8), (6, 8), (6, 8, 3), (6, 8, 3), (6, 8), (6, 8), (3, 8, 8)]]
    with pytest.raises(ValueError, match="CUDA"):
        moment_cov.cov_fwd(*args, DIAG)
    with pytest.raises(ValueError, match="CUDA"):
        gram_rbf.gram(torch.empty(3, 4, device="meta"), torch.empty(3, device="meta"),
                      torch.empty(8, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.gram(torch.empty(3, 4, device="meta"), torch.empty(3, device="meta"), torch.empty(8, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.cov_core(*args, DIAG)
    df_args = [t for a in args for t in (a, a)]  # (hi, lo) halves
    with pytest.raises(ValueError, match="CUDA"):
        df_cov.df_cov_fwd(*df_args, DIAG)
    with pytest.raises(ValueError, match="CUDA"):
        df_cov.df_cov_fwdres(*df_args, DIAG)
    g6 = torch.empty(6, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        df_cov.df_cov_bwd(*df_args, g6, g6, DIAG)
    with pytest.raises(ValueError, match="CUDA"):
        moment_cov.cov_gik(torch.empty(3, device="meta"), *args[:4], DIAG)
    with pytest.raises(ValueError, match="CUDA"):
        ops.df_cov_core(*df_args, DIAG)
    from types import SimpleNamespace

    from gpmpc_tpu_torch.ops import df_mm

    shapes = dict(x=(8, 4), ils=(3, 4), ils2=(3, 4), log_outs=(3,), beta=(3, 8), iK=(3, 8, 8))
    cache = SimpleNamespace(outs=torch.empty(3, device="meta"),
                            **{f"{k}_{h}": torch.empty(s, device="meta") for k, s in shapes.items() for h in ("hi", "lo")})
    mu, sv = torch.empty(4, device="meta"), torch.empty(3, 3, device="meta")
    b, q = torch.empty(3, 3, 3, device="meta"), torch.empty(6, 3, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        df_mm.full_step_fwd(mu, sv, cache)
    with pytest.raises(ValueError, match="CUDA"):
        df_mm.stage23_fwd(mu, b, b, q, q, cache)
    with pytest.raises(ValueError, match="CUDA"):
        df_mm.stage23_bwd(mu, b, b, q, q, cache, torch.empty(3, device="meta"), torch.empty(3, 4, device="meta"),
                          torch.empty(6, device="meta"), torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        df_mm.stage23_bwd_mean(mu, b, b, cache, torch.empty(3, device="meta"), torch.empty(3, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        df_mm.stage23_bwd_pairs(mu, q, q, cache, torch.empty(6, device="meta"), torch.empty(3, device="meta"))


def test_launch_counts_untouched_on_cpu():
    ops.reset_launch_counts()
    args = [torch.tensor(v) for v in _cov_problem(7, np.float32, n=16)]
    ops.cov_core(*args, DIAG)
    moment_cov.CovCore.apply(*args, DIAG)
    ops.gram(*(torch.tensor(v) for v in _gram_inputs(8, n=16)))
    df_args = [t for a in args for t in (a, torch.zeros_like(a))]  # (hi, lo) halves
    ops.df_cov_core(*df_args, DIAG)
    df_cov.DfCovCore.apply(*df_args, DIAG)
    leaves = [t.clone().requires_grad_(True) for t in df_args]
    torch.autograd.grad(df_cov.DfCovCoreStacked.apply(*leaves, DIAG)[0].sum(), leaves[0])  # #5, then #7
    ik = args[6].clone().requires_grad_(True)
    torch.autograd.grad(moment_cov.CovCore.apply(*args[:6], ik, DIAG)[1].sum(), ik)  # the iK gradient (#4)
    from types import SimpleNamespace

    from gpmpc_tpu_torch.ops import df_mm

    rng = np.random.default_rng(9)
    f = {f"{k}_{h}": torch.tensor(rng.uniform(0.1, 1.0, shape), dtype=torch.float32) * (1.0 if h == "hi" else 1e-8)
         for k, shape in (("x", (16, 4)), ("ils", (3, 4)), ("ils2", (3, 4)), ("log_outs", (3,)), ("beta", (3, 16)),
                          ("iK", (3, 16, 16))) for h in ("hi", "lo")}
    cache = SimpleNamespace(outs=torch.ones(3), **f)
    mu = torch.full((4,), 0.5, requires_grad=True)
    sv = (torch.eye(3) * 1e-2).requires_grad_(True)
    M, V, Sp = df_mm.full_step(mu, sv, cache)  # #12 forward, #8 and #9 in the backward
    torch.autograd.grad(M.sum() + V.sum() + Sp.sum(), (mu, sv))
    g = [torch.ones(s) for s in ((3,), (3, 4), (6,), (3,))]
    cache_160 = SimpleNamespace(outs=torch.ones(3), **{k: torch.cat([v] * 10, dim=-1) if k.startswith("beta") else (
        v.repeat(1, 10, 10) if k.startswith("iK") else (v.repeat(10, 1) if k.startswith("x") else v))
        for k, v in f.items()})
    b3 = torch.eye(3).expand(3, 3, 3).contiguous()
    df_mm.stage23_bwd(mu.detach(), b3, b3 * 0, torch.zeros(6, 3, 3), torch.zeros(6, 3, 3), cache_160, *g)  # #10, #11
    assert ops.launch_counts() == {"gram": 0, "cov_fwd": 0, "cov_bwd_row": 0, "cov_gik": 0, "df_fwd": 0,
                                   "df_fwdres": 0, "df_bwd": 0, "df_mm_full": 0, "df_mm_fwd": 0, "df_mm_bwd": 0,
                                   "df_mm_bwd_mean": 0, "df_mm_bwd_pair": 0}

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
from gpmpc_tpu_torch.ops import gram_rbf, moment_cov

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
    ga, gu, gbi = moment_cov.cov_bwd_row(w_s, a, c, u, xj, bi, bj, ik, gco, DIAG)
    torch.testing.assert_close(ga, ga_ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gu, gu_ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gbi, gbi_ref, rtol=1e-12, atol=1e-12)


def test_covcore_refuses_ik_grad():
    args = [torch.tensor(v) for v in _cov_problem(4, np.float64, n=16)]
    args[0].requires_grad_(True)
    args[6].requires_grad_(True)
    s, co = moment_cov.CovCore.apply(*args, DIAG)
    with pytest.raises(NotImplementedError, match="_gik_kernel"):
        torch.autograd.grad(s.sum() + co.sum(), [args[0], args[6]])


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


def test_launch_counts_untouched_on_cpu():
    ops.reset_launch_counts()
    args = [torch.tensor(v) for v in _cov_problem(7, np.float32, n=16)]
    ops.cov_core(*args, DIAG)
    moment_cov.CovCore.apply(*args, DIAG)
    ops.gram(*(torch.tensor(v) for v in _gram_inputs(8, n=16)))
    assert ops.launch_counts() == {"gram": 0, "cov_fwd": 0, "cov_bwd_row": 0}

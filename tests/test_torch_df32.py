"""The port's double-float32 arithmetic and df32 cov core against the JAX package.

Same numpy inputs through both packages, JAX on the CPU:

* the error-free transformations (two_sum, fast_two_sum, the 12-bit mask
  split, two_prod), split_f64 and df_neg must match bit for bit: each is a
  fixed sequence of exactly rounded f32 operations that no contraction can
  change;
* the df operations (df_add, df_mul, df_div, df_sqrt, df_sum, df_dot_f32,
  df_exp) are held to DF_RTOL relative to the f64 value of hi + lo, against
  JAX (XLA:CPU may contract ``pe + (xh*yl + xl*yh)`` into an FMA where the
  port rounds twice) and against f64 itself; their gradients (df_mul and
  df_exp carry the JAX custom JVPs) against ``jax.grad`` of the same
  expression;
* the df cov core: df_cov_core_ref against df_cov_core_xla, the kernels'
  plain twins against the Pallas cell bodies ``_fwd_cell`` / ``_fwdres_cell``
  / ``_bwd_cell`` (128-row tiles over whole rows, joined with ``_df_tree`` as
  the JAX wrapper does), and the two backward schemes (DfCovCore's residual
  one, DfCovCoreStacked's stacked one) against ``jax.grad`` through
  df_cov_core_xla and against each other. The Pallas cells run eagerly, as
  tests/test_df_cov_tiled.py runs them: interpret mode is far too slow for
  these bodies.

Cov-core tolerances are relative to each output's sum of |terms|
(df_cov_abs_terms): the two sides sum the same df terms in different orders,
and a compensated sum's error is bounded by a small multiple of eps32^2
(3.6e-15) times that scale. COV_RTOL = 1e-12 leaves room for the few-hundred
additions each chain holds; a plain-f32 term or a dropped lo half misses by
~1e-8 or more.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu.ops import df32 as jdf
from gpmpc_tpu.ops import df_cov_core_xla
from gpmpc_tpu.ops.pallas_df_cov import _bwd_cell, _df_tree, _fwd_cell, _fwdres_cell
from gpmpc_tpu_torch import ops
from gpmpc_tpu_torch.ops import df32 as tdf
from gpmpc_tpu_torch.ops import df_cov

DF_RTOL = 2e-13  # df_exp misses f64 by up to 1.1e-13 relative, in the JAX package alike
COV_RTOL = 1e-12
TILE = 128


def _f32(rng, n, spread=5):
    """f32 values over 2*spread decades, both signs."""
    return (rng.normal(0, 1, n) * 10.0 ** rng.integers(-spread, spread, n)).astype(np.float32)


def _df(rng, n, mean=0.0, scale=3.0):
    """A df pair (hi, lo) as numpy f32 arrays, split from f64 draws."""
    x = rng.normal(mean, scale, n)
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


def _v(h, l):
    return np.asarray(h, np.float64) + np.asarray(l, np.float64)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod", "_split12", "split_f64", "df_neg"])
def test_error_free_transforms_are_bit_exact(name):
    rng = np.random.default_rng(0)
    if name == "split_f64":
        x = rng.normal(0, 3, 4096) * 10.0 ** rng.integers(-6, 6, 4096)
        j_out = jdf.split_f64(jnp.asarray(x))
        t_out = tdf.split_f64(torch.tensor(x))
    elif name in ("_split12", "df_neg"):
        a = _f32(rng, 4096)
        args = (a,) if name == "_split12" else (a, _f32(rng, 4096) * np.float32(1e-8))
        j_out = getattr(jdf, name)(*(jnp.asarray(x) for x in args))
        t_out = getattr(tdf, name)(*(torch.tensor(x) for x in args))
    else:
        a, b = _f32(rng, 4096), _f32(rng, 4096)
        if name == "fast_two_sum":  # needs |a| >= |b|
            a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
        j_out = jax.jit(getattr(jdf, name))(jnp.asarray(a), jnp.asarray(b))
        t_out = getattr(tdf, name)(torch.tensor(a), torch.tensor(b))
    for jo, to in zip(j_out, t_out):
        assert to.dtype == torch.float32
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _df_case(name, rng):
    """(jax fn, torch fn, args as numpy, f64 reference, scale for the error)."""
    xh, xl = _df(rng, 2048)
    yh, yl = _df(rng, 2048, mean=1.0)
    x, y = _v(xh, xl), _v(yh, yl)
    if name == "df_add":
        return jdf.df_add, tdf.df_add, (xh, xl, yh, yl), x + y, np.abs(x) + np.abs(y)
    if name == "df_mul":
        return jdf.df_mul, tdf.df_mul, (xh, xl, yh, yl), x * y, np.abs(x * y)
    if name == "df_div":
        return jdf.df_div, tdf.df_div, (xh, xl, yh, yl), x / y, np.abs(x / y)
    if name == "df_sqrt":
        ah, al = np.abs(xh), np.where(xh < 0, -xl, xl)
        a = _v(ah, al)
        return jdf.df_sqrt, tdf.df_sqrt, (ah, al), np.sqrt(a), np.sqrt(a)
    if name == "df_exp":
        eh, el = _df(rng, 2048, mean=-3.0, scale=8.0)
        e = _v(eh, el)
        return jdf.df_exp, tdf.df_exp, (eh, el), np.exp(e), np.exp(e)
    sh, sl = _df(rng, (4, 1001), scale=1e3)
    s = _v(sh, sl)
    if name == "df_dot_f32":  # f32 weights times df terms, summed along the odd axis
        a = rng.normal(0, 1, (4, 1001)).astype(np.float32)
        return (lambda *x: jdf.df_dot_f32(*x, axis=-1), lambda *x: tdf.df_dot_f32(*x, axis=-1), (a, sh, sl),
                (a * s).sum(-1), np.abs(a * s).sum(-1))
    # df_sum over an odd-length axis of terms that cancel
    return (lambda h, l: jdf.df_sum(h, l, axis=-1), lambda h, l: tdf.df_sum(h, l, axis=-1), (sh, sl),
            s.sum(-1), np.abs(s).sum(-1))


@pytest.mark.parametrize("name", ["df_add", "df_mul", "df_div", "df_sqrt", "df_sum", "df_dot_f32", "df_exp"])
def test_df_ops_match_jax_and_f64(name):
    jfn, tfn, args, ref, scale = _df_case(name, np.random.default_rng(1))
    jo = jax.jit(jfn)(*_j(*args))
    to = tfn(*_t(*args))
    port, jaxv = _v(*(t.numpy() for t in to)), _v(*jo)
    assert np.max(np.abs(port - jaxv) / scale) < DF_RTOL
    assert np.max(np.abs(port - ref) / scale) < DF_RTOL


@pytest.mark.parametrize("name", ["df_mul", "df_exp", "df_mul_f32"])
def test_df_custom_gradients_match_jax(name):
    """Gradients of a weighted sum of hi + lo: df_mul and df_exp through
    their custom rules (hi cotangent, both halves of an input alike);
    df_mul_f32 through autograd of the error-free transformations, where the
    split's hi half is detached as JAX's bitcast carries no tangent."""
    rng = np.random.default_rng(2)
    xh, xl = _df(rng, 512, mean=-1.0)
    yh, yl = _df(rng, 512, mean=2.0)
    w = rng.normal(0, 1, 512)
    if name == "df_exp":
        args, jf, tf = (xh, xl), jdf.df_exp, tdf.df_exp
    elif name == "df_mul":
        args, jf, tf = (xh, xl, yh, yl), jdf.df_mul, tdf.df_mul
    else:
        args, jf, tf = (xh, xl, yh), jdf.df_mul_f32, tdf.df_mul_f32

    def jloss(*a):
        h, l = jf(*a)
        return jnp.sum(jnp.asarray(w, jnp.float32) * (h + l))

    g_ref = jax.grad(jloss, argnums=tuple(range(len(args))))(*_j(*args))
    leaves = [t.requires_grad_(True) for t in _t(*args)]
    h, l = tf(*leaves)
    g = torch.autograd.grad((torch.tensor(w, dtype=torch.float32) * (h + l)).sum(), leaves)
    for go, gr in zip(g, g_ref):
        np.testing.assert_allclose(go.numpy(), np.asarray(gr), rtol=1e-6, atol=1e-6 * np.abs(gr).max())


# ---------------------------------------------------------------------------
# the df32 cov core
# ---------------------------------------------------------------------------


def _cov_inputs(n, ns=3, seed=0, scale_beta=1e3):
    """df operands as tests/test_df_cov_tiled.py draws them: exponents <= 0,
    +-1e3 beta (the trained-GP cancellation regime), symmetric iK. Returns
    the 14 numpy halves and diag_pos."""
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(ns)
    p = len(ii)
    diag_pos = tuple(int(q) for q in np.where(ii == jj)[0])
    ik = rng.normal(0.0, 30.0, (ns, n, n))
    draws = (-np.abs(rng.normal(2.0, 1.5, (p, n))) * 3.0, -np.abs(rng.normal(2.0, 1.5, (p, n))) * 3.0,
             rng.normal(0.0, 0.4, (p, n, ns)), rng.normal(0.0, 0.4, (p, n, ns)),
             rng.normal(0.0, scale_beta, (p, n)), rng.normal(0.0, scale_beta, (p, n)),
             (ik + np.swapaxes(ik, 1, 2)) / 2.0)
    flat = []
    for x in draws:
        hi = x.astype(np.float32)
        flat += [hi, (x - hi.astype(np.float64)).astype(np.float32)]
    return flat, diag_pos


def _within(out, ref, scale, rtol=COV_RTOL, what=""):
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= rtol * np.asarray(scale)), f"{what}: max err/scale {np.max(err / np.asarray(scale)):.3e}"


def test_df_cov_core_ref_matches_xla_at_flagship_width():
    """N = 384, the flagship bucket, P = 6, ns = 3."""
    flat, diag_pos = _cov_inputs(384, seed=3)
    out_x = jax.jit(lambda *a: df_cov_core_xla(*a, diag_pos))(*_j(*flat))
    out_t = df_cov.df_cov_core_ref(*_t(*flat), diag_pos)
    (s_abs, co_abs), _ = df_cov.df_cov_abs_terms(*_t(*flat), diag_pos)
    _within(_v(out_t[0], out_t[1]), _v(out_x[0], out_x[1]), s_abs.numpy(), what="S_p")
    _within(_v(out_t[2], out_t[3]), _v(out_x[2], out_x[3]), co_abs.numpy(), what="corr")


def _jax_cells(flat, diag_pos, n):
    """The JAX cell bodies over 128-row tiles of whole rows, joined with
    _df_tree. The iK tile of an off-diagonal pair is zero (the port's
    convention; the TPU kernel reads an unused model's slab there)."""
    ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl = _j(*flat)
    p, ns = ah.shape[0], uh.shape[-1]
    zero = jnp.zeros((TILE, n), jnp.float32)
    fwd, rows, cols = [], [], []

    def col(v):
        return v[..., None]

    for b in range(p):
        slot = diag_pos.index(b) if b in diag_pos else None
        f_parts, c_parts, r_parts = [], [], []
        for i in range(n // TILE):
            r = slice(i * TILE, (i + 1) * TILE)
            ik_t = (ikh[slot, r], ikl[slot, r]) if slot is not None else (zero, zero)
            args = (col(ah[b, r]), col(al[b, r]), col(ch[b]), col(cl[b]), uh[b, r], ul[b, r], xjh[b], xjl[b],
                    col(bih[b, r]), col(bil[b, r]), col(bjh[b]), col(bjl[b]), *ik_t)
            sh, sl, th, tl = _fwd_cell(*args, ns=ns)
            f_parts.append(((sh[0, 0], sl[0, 0]), (th[0, 0], tl[0, 0])))
            row_outs, col_outs = _fwdres_cell(*args, ns=ns)
            r_parts.append([o[:, 0] for o in row_outs])
            c_parts.append([o[0] for o in col_outs])
        s = _df_tree([f[0] for f in f_parts])
        co = _df_tree([f[1] for f in f_parts])
        fwd.append((s, co))
        rows.append([jnp.concatenate([rp[k] for rp in r_parts]) for k in range(len(r_parts[0]))])
        cols.append([])
        for k in range(0, len(c_parts[0]), 2):
            h, l = _df_tree([(cp[k], cp[k + 1]) for cp in c_parts])
            cols[-1] += [h, l]
    sp = np.array([_v(*f[0]) for f in fwd])
    corr = np.array([_v(*fwd[q][1]) for q in diag_pos])
    rows = [np.stack([np.asarray(rows[b][k]) for b in range(p)]) for k in range(len(rows[0]))]
    cols = [np.stack([np.asarray(cols[b][k]) for b in range(p)]) for k in range(len(cols[0]))]
    return sp, corr, rows, cols


@pytest.mark.parametrize("n", [128, 256])
def test_kernel_plain_twins_match_pallas_cells(n):
    flat, diag_pos = _cov_inputs(n, seed=n)
    sp_j, corr_j, rows_j, cols_j = _jax_cells(flat, diag_pos, n)
    args = _t(*flat)
    (s_abs, co_abs), (row_abs, col_abs) = df_cov.df_cov_abs_terms(*args, diag_pos)
    sh, sl, ch_, cl_ = df_cov.df_cov_fwd_plain(*args, diag_pos)
    _within(_v(sh, sl), sp_j, s_abs, what="S_p")
    _within(_v(ch_, cl_), corr_j, co_abs, what="corr")
    rows, cols = df_cov.df_cov_fwdres_plain(*args, diag_pos)
    assert len(rows) == len(rows_j) == len(cols) == len(cols_j) == 4 + 4 * 3
    for side, out, ref, scale in (("row", rows, rows_j, row_abs), ("col", cols, cols_j, col_abs)):
        for k in range(0, len(out), 2):
            _within(_v(out[k], out[k + 1]), _v(ref[k], ref[k + 1]), scale[k], what=f"{side} residual {k // 2}")


def test_df_bwd_twin_matches_pallas_bwd_cell():
    """The stacked backward's plain twin (what df_bwd computes) against the
    JAX cell body ``_bwd_cell`` on the row side and on the role-swapped
    column side, N = 128 (one 128-row tile of whole rows). Both collapse a
    df sum of the same terms to f32: each entry within one f32 rounding of
    itself plus COV_RTOL of its sum of |terms|."""
    n, ns = 128, 3
    flat, diag_pos = _cov_inputs(n, seed=5)
    p = flat[0].shape[0]
    gs = np.linspace(1.0, 2.0, p).astype(np.float32)
    gco = np.zeros(p, np.float32)
    gco[list(diag_pos)] = [1.0, -2.0, 3.0]
    ga, gc, gu, gxj = df_cov.df_cov_bwd_plain(*_t(*flat), *_t(gs, gco), diag_pos)
    ah, al, ch, cl, uh, ul, xjh, xjl, bih, bil, bjh, bjl, ikh, ikl = _j(*flat)
    zero = jnp.zeros((n, n), jnp.float32)
    v = [_v(flat[2 * i], flat[2 * i + 1]) for i in range(7)]  # a, c, U, Xj, bi, bj, iK in f64
    for side in range(2):
        rows = (ah, al, uh, ul, bih, bil) if side == 0 else (ch, cl, xjh, xjl, bjh, bjl)
        cols = (ch, cl, xjh, xjl, bjh, bjl) if side == 0 else (ah, al, uh, ul, bih, bil)
        for b in range(p):
            slot = diag_pos.index(b) if b in diag_pos else None
            ik_t = (ikh[slot], ikl[slot]) if slot is not None else (zero, zero)
            ga_j, gu_j = _bwd_cell(rows[0][b][:, None], rows[1][b][:, None], cols[0][b][:, None], cols[1][b][:, None],
                                   rows[2][b], rows[3][b], cols[2][b], cols[3][b], rows[4][b][:, None],
                                   rows[5][b][:, None], cols[4][b][:, None], cols[5][b][:, None], *ik_t,
                                   jnp.float32(gs[b]), jnp.float32(gco[b]), ns)
            a_r, u_r, b_r = (v[0], v[2], v[4]) if side == 0 else (v[1], v[3], v[5])
            c_c, x_c, b_c = (v[1], v[3], v[5]) if side == 0 else (v[0], v[2], v[4])
            e = np.exp(np.minimum(a_r[b][:, None] + c_c[b][None, :] + u_r[b] @ x_c[b].T, 60.0))
            ik_abs = np.abs(v[6][slot]) * abs(gco[b]) if slot is not None else 0.0
            w = (abs(gs[b]) * np.abs(b_r[b])[:, None] * np.abs(b_c[b])[None, :] + ik_abs) * e
            scales = [w.sum(-1)] + [(w * np.abs(x_c[b][:, q])[None, :]).sum(-1) for q in range(ns)]
            outs = [(ga, gc)[side][b]] + [(gu, gxj)[side][b, :, q] for q in range(ns)]
            refs = [ga_j[:, 0]] + [gu_j[q][:, 0] for q in range(ns)]
            for o, r, sc in zip(outs, refs, scales):
                err = np.abs(o.numpy().astype(np.float64) - np.asarray(r, np.float64))
                tol = 2.0 ** -23 * np.abs(np.asarray(r, np.float64)) + COV_RTOL * sc
                assert np.all(err <= tol), (side, b, float(np.max(err / tol)))


def test_dfcovcore_stacked_backward_matches_xla_grad_and_residual():
    """The stacked scheme (DfCovCoreStacked: the lean forward's twin, then
    the stacked backward's twin), and the CPU dispatch ops.df_cov_core with
    ``df_cov.VJP_MODE = "stacked"``, against jax.grad through
    df_cov_core_xla with the hi-only cotangent convention (3e-6 of the
    largest entry, as the residual scheme is held) and against the residual
    scheme DfCovCore, the same VJP summed in another order (1e-9 of the
    largest entry)."""
    _, _, gx, torch_grads = _backward_case()
    residual = torch_grads(df_cov.DfCovCore.apply)
    mode = df_cov.VJP_MODE
    df_cov.VJP_MODE = "stacked"
    try:
        dispatched = torch_grads(ops.df_cov_core)
    finally:
        df_cov.VJP_MODE = mode
    for g_t in (torch_grads(df_cov.DfCovCoreStacked.apply), dispatched):
        for g, g_x, g_r, name in zip(g_t, gx, residual, ("a", "c", "U", "Xj")):
            np.testing.assert_allclose(g.numpy(), g_x, rtol=0, atol=3e-6 * np.abs(g_x).max(),
                                       err_msg=f"grad mismatch for {name}")
            np.testing.assert_allclose(g.numpy(), g_r.numpy(), rtol=0, atol=1e-9 * float(g_r.abs().max()),
                                       err_msg=f"stacked vs residual for {name}")


@functools.lru_cache(maxsize=None)
def _backward_case():
    """The operands, jax.grad through df_cov_core_xla for a, c, U and Xj, and
    the port's gradients of the same loss for a given core (N = 64)."""
    n, ns = 64, 3
    flat, diag_pos = _cov_inputs(n, seed=1)
    p = flat[0].shape[0]
    w = np.arange(1.0, p + 1, dtype=np.float32)
    wc = np.arange(1.0, ns + 1, dtype=np.float32) * 0.7
    jflat = _j(*flat)

    def loss_x(ah_, ch_, uh_, xjh_):
        args = list(jflat)
        args[0], args[2], args[4], args[6] = ah_, ch_, uh_, xjh_
        sh, sl, co_h, co_l = df_cov_core_xla(*args, diag_pos)
        return jnp.sum(jnp.asarray(w) * (sh + sl)) + jnp.sum(jnp.asarray(wc) * (co_h + co_l))

    gx = jax.jit(jax.grad(loss_x, argnums=(0, 1, 2, 3)))(jflat[0], jflat[2], jflat[4], jflat[6])

    def torch_grads(core):
        args = _t(*flat)
        leaves = [args[i].requires_grad_(True) for i in (0, 2, 4, 6)]
        sh, sl, co_h, co_l = core(*args, diag_pos)
        loss = (torch.tensor(w) * (sh + sl)).sum() + (torch.tensor(wc) * (co_h + co_l)).sum()
        return torch.autograd.grad(loss, leaves)

    return flat, diag_pos, [np.asarray(g) for g in gx], torch_grads


def test_dfcovcore_backward_matches_xla_grad():
    """DfCovCore (residual forward on its plain twin here, the residual
    backward) against jax.grad through df_cov_core_xla, with the hi-only
    cotangent convention, for the action-dependent inputs a, c, U, Xj; and
    the CPU dispatch ops.df_cov_core (DfCovCore on its plain twins, since
    the repair of ROADMAP C1) against the same gradients."""
    _, _, gx, torch_grads = _backward_case()
    for core in (df_cov.DfCovCore.apply, ops.df_cov_core):
        for g_t, g_x, name in zip(torch_grads(core), gx, ("a", "c", "U", "Xj")):
            np.testing.assert_allclose(g_t.numpy(), g_x, rtol=0, atol=3e-6 * np.abs(g_x).max(),
                                       err_msg=f"grad mismatch for {name}")

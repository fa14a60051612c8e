"""Port parity: the day accumulate's backward (ops/day_kernel.py).  The
plain backward ``accumulate_day_bwd_plain``, autograd through the wrapper
``accumulate_day`` (whose CPU backward is that plain twin) and autograd
through ``accumulate_day_plain`` (the closed-form BVN backward), against
``jax.vjp``/``jax.grad`` of the JAX XLA accumulate and of the Pallas one
(interpret mode, as tests/test_pallas_kernel.py runs it off-TPU).  Shapes
and tolerance are those of test_pallas_kernel.py:159-200: T = 24, K = 5,
a 64² buffer, rtol 2e-4 and atol 1e-7."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests._torch_parity import t32, torch

from parasitoids_tpu.ops.daily_kernel import xla_accumulate_day
from parasitoids_tpu.ops.pallas_kernel import pallas_accumulate_day
from parasitoids_tpu_torch.ops import day_kernel
from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day,
                                                  accumulate_day_bwd_plain,
                                                  accumulate_day_plain)

T, K, BUF = 24, 5, 64
N = 2 * K + 1
RHOS = [0.35, 0.93, -0.93, 0.99]
CT_LOSS = 3.0


def _inputs():
    rng = np.random.default_rng(7)
    h = rng.uniform(0.0, 1e-3, T).astype(np.float32)
    mu = rng.uniform(-12.0, 12.0, (T, 2)).astype(np.float32)
    idx = rng.integers(0, BUF - N + 1, (T, 2)).astype(np.int32)
    idx[0] = (0, 0)                     # blocks at both idx extremes
    idx[1] = (BUF - N, BUF - N)
    clipped = rng.integers(0, 2, T).astype(np.float32)
    w = rng.normal(size=(BUF, BUF)).astype(np.float32)
    return h, mu, idx, clipped, w


def _theta(rho):
    # sig_x, sig_y, rho, h scale, mu shift, clip scale, cell
    return np.array([21.1, 10.6, rho, 1.0, 0.0, 1.0, 25.0], np.float32)


@pytest.fixture(scope='module')
def jax_grads():
    """``jax.grad`` of w·buf + 3·loss over theta, through the XLA and the
    Pallas accumulate, and the XLA path's VJP per input, for every rho."""
    h, mu, idx, clipped, w = _inputs()
    out = {}
    for rho in RHOS:
        def obj(t, pallas):
            args = (jnp.asarray(h) * t[3], jnp.asarray(mu) + t[4],
                    jnp.asarray(idx), jnp.asarray(clipped) * t[5],
                    (t[0], t[1], t[2]), t[6])
            if pallas:
                buf, loss = pallas_accumulate_day(*args, K, 8, BUF, True)
            else:
                buf, loss = xla_accumulate_day(*args, K, 8, BUF)
            return (jnp.asarray(w) * buf).sum() + CT_LOSS * loss

        th = jnp.asarray(_theta(rho))
        g_x = np.asarray(jax.grad(lambda t: obj(t, False))(th))
        g_p = np.asarray(jax.grad(lambda t: obj(t, True))(th))

        def acc(hh, mm, cl, Dp, cell):
            return xla_accumulate_day(hh, mm, jnp.asarray(idx), cl, Dp, cell,
                                      K, 8, BUF)

        _, vjp = jax.vjp(acc, jnp.asarray(h), jnp.asarray(mu),
                         jnp.asarray(clipped),
                         (jnp.float32(21.1), jnp.float32(10.6),
                          jnp.float32(rho)), jnp.float32(25.0))
        dh, dmu, dcl, dD, dcell = vjp((jnp.asarray(w),
                                       jnp.float32(CT_LOSS)))
        out[rho] = (g_x, g_p, (np.asarray(dh), np.asarray(dmu),
                               np.asarray(dcl), np.asarray(dD),
                               float(dcell)))
    return out


def _torch_grad(fn, rho):
    h, mu, idx, clipped, w = _inputs()
    th = torch.tensor(_theta(rho), requires_grad=True)
    buf, loss = fn(t32(h) * th[3], (t32(mu) + th[4]).contiguous(), t32(idx),
                   t32(clipped) * th[5], (th[0], th[1], th[2]), th[6], K,
                   BUF)
    ((t32(w) * buf).sum() + CT_LOSS * loss).backward()
    return th.grad.numpy()


@pytest.mark.parametrize('rho', RHOS)
@pytest.mark.parametrize('path', ['wrapper', 'plain_autograd'])
def test_gradient_matches_xla_and_pallas(jax_grads, rho, path):
    g_x, g_p, _ = jax_grads[rho]
    fn = accumulate_day if path == 'wrapper' else accumulate_day_plain
    got = _torch_grad(fn, rho)
    assert np.all(np.isfinite(got)) and np.linalg.norm(g_x) > 0
    np.testing.assert_allclose(got, g_x, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(got, g_p, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize('rho', RHOS)
def test_plain_backward_matches_xla_vjp(jax_grads, rho):
    # every output of the plain twin against the XLA path's VJP with a
    # cotangent on both outputs (buffer and loss)
    h, mu, idx, clipped, w = _inputs()
    got = accumulate_day_bwd_plain(t32(w), CT_LOSS, t32(h), t32(mu),
                                   t32(idx), t32(clipped), (21.1, 10.6, rho),
                                   25.0, K, BUF, chunk=10)
    dh, dmu, dcl, dD, dcell = jax_grads[rho][2]
    for g, want in zip(got[:2], (dh, dmu)):
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                   atol=1e-7 * np.abs(want).max())
    # dclip = ct_loss·h·(1 − Σblock): every block here holds its whole mass,
    # so 1 − Σblock is f32 roundoff of Σblock (one ulp, 6e-8, times ct_loss·h
    # is 2e-10) and the two packages' sums differ by a few ulps
    np.testing.assert_allclose(got[2].numpy(), dcl, rtol=2e-4,
                               atol=1e-6 * CT_LOSS * h.max())
    np.testing.assert_allclose(got[3].numpy(), dD, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(float(got[4]), dcell, rtol=2e-4, atol=1e-7)


def test_gradient_reaches_every_diffusion_parameter():
    # the wrapper stacks (sig_x, sig_y, rho) into one tensor and makes the
    # cell side a tensor, so autograd carries their gradients (the JAX
    # custom_vjp's differentiable Dparams and cell); a tuple passed through
    # the autograd Function untouched would carry none
    h, mu, idx, clipped, w = _inputs()
    ps = [torch.tensor(v, requires_grad=True) for v in (21.1, 10.6, 0.35,
                                                        25.0)]
    buf, loss = accumulate_day(t32(h), t32(mu), t32(idx), t32(clipped),
                               tuple(ps[:3]), ps[3], K, BUF)
    ((t32(w) * buf).sum() + CT_LOSS * loss).backward()
    got = [float(p.grad) for p in ps]
    want = _torch_grad(accumulate_day_plain, 0.35)[[0, 1, 2, 6]]
    assert all(g != 0.0 for g in got)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)
    assert day_kernel.LAUNCHES_BWD == 0       # no kernel on the CPU


# --- the per-corner form of the backward, and shapes that stress it ------

def _seven_sums_vjp(ctb, mu, sig_x, sig_y, rho, cell, K):
    """The BVN cell-mass VJP as seven plain sums over lattice corners of
    per-corner products (the form the CUDA backward accumulates in
    registers): with ctU the adjoint of the four-corner difference and
    Lx, Ly, Lρ the closed-form derivative lattices,
    Σ ctU·Lx·{1, xe_j, jcol_j}, Σ ctU·Ly·{1, ye_i, irow_i} and Σ ctU·Lρ.
    No column or row sum is formed first."""
    n = 2 * K + 1
    ar = torch.arange(n + 1, dtype=mu.dtype)
    jcol, irow = ar - K - 0.5, K + 0.5 - ar
    xe = (jcol * cell - mu[:, 0:1]) / sig_x                  # (C, m)
    ye = (irow * cell - mu[:, 1:2]) / sig_y
    pad = torch.nn.functional.pad(ctb, (1, 1, 1, 1))         # zero border
    ctU = ((pad[:, :-1, 1:] - pad[:, :-1, :-1]) - pad[:, 1:, 1:]) + \
        pad[:, 1:, :-1]
    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-12))
    X, Y = xe[:, None, :], ye[:, :, None]                    # [row i, col j]
    ndtr = torch.special.ndtr
    two_pi = 2.0 * np.pi
    Lx = -torch.exp(-0.5 * X * X) / np.sqrt(two_pi) * ndtr(-(Y - rho * X) / s)
    Ly = -torch.exp(-0.5 * Y * Y) / np.sqrt(two_pi) * ndtr(-(X - rho * Y) / s)
    Lr = torch.exp(-0.5 * (X * X - 2.0 * rho * X * Y + Y * Y) / (s * s)) / \
        (two_pi * s)
    gx, gy = ctU * Lx, ctU * Ly
    sums = [gx.sum(dim=(1, 2)), (gx * X).sum(dim=(1, 2)),
            (gx * jcol[None, None, :]).sum(dim=(1, 2)),
            gy.sum(dim=(1, 2)), (gy * Y).sum(dim=(1, 2)),
            (gy * irow[None, :, None]).sum(dim=(1, 2)),
            (ctU * Lr).sum(dim=(1, 2))]
    dmu = torch.stack([-sums[0] / sig_x, -sums[3] / sig_y], dim=-1)
    return (dmu, -sums[1].sum() / sig_x, -sums[4].sum() / sig_y,
            sums[6].sum(), sums[2].sum() / sig_x + sums[5].sum() / sig_y)


@pytest.mark.parametrize('K', [1, 5])
@pytest.mark.parametrize('rho', [0.0, 0.253, -0.8, 0.95])
def test_per_corner_sums_equal_the_cell_mass_vjp(rho, K):
    # f64, rtol 1e-12: the two differ by the order of the sums only
    from parasitoids_tpu_torch.ops.bvn import cell_masses_vjp, corner_rect
    rng = np.random.default_rng(11)
    C, n = 6, 2 * K + 1
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    mu = f64(rng.uniform(-30.0, 30.0, (C, 2)))
    sig_x, sig_y, cell, r = f64(21.1), f64(10.6), f64(25.0), f64(rho)
    rect = corner_rect(mu, sig_x, sig_y, r, cell, K)
    ctb = torch.where(rect > 0, f64(rng.normal(size=(C, n, n))),
                      torch.zeros_like(rect))
    want = cell_masses_vjp(ctb, mu, sig_x, sig_y, r, cell, K)
    got = _seven_sums_vjp(ctb, mu, sig_x, sig_y, r, cell, K)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-14 * float(w.abs().max()))


def _edge_inputs(K, T, clip_all):
    """A short day that stresses the backward's edges: blocks at both idx
    extremes, minutes without take-off, means several σ off the block's
    centre (so that part of the block is clamped at 0), every minute
    clipped or none."""
    rng = np.random.default_rng(100 * K + T)
    n = 2 * K + 1
    buf = n + 6
    h = rng.uniform(1e-4, 1e-3, T).astype(np.float32)
    mu = rng.uniform(-12.0, 12.0, (T, 2)).astype(np.float32)
    idx = rng.integers(0, buf - n + 1, (T, 2)).astype(np.int32)
    idx[0] = (0, 0)
    if T > 1:
        idx[-1] = (buf - n, buf - n)
        h[2::3] = 0.0
        mu[1] = (3 * 21.1, -4 * 10.6)
        mu[-1] = (-5 * 21.1, 2 * 10.6)
    clipped = np.full(T, float(clip_all), np.float32)
    w = rng.normal(size=(buf, buf)).astype(np.float32)
    return h, mu, idx, clipped, w, buf


@pytest.mark.parametrize('clip_all', [True, False])
@pytest.mark.parametrize('T', [1, 7])
@pytest.mark.parametrize('K,rho', [(1, 0.253), (2, -0.95), (5, 0.8)])
def test_plain_backward_matches_xla_vjp_at_the_edges(K, rho, T, clip_all):
    # rtol 2e-4 and atol 1e-7 of each output's largest magnitude
    # (test_pallas_kernel.py:200), as test_plain_backward_matches_xla_vjp
    # holds them; dclip's atol is 1e-6 of ct_loss·max h (f32 roundoff of
    # Σblock).  The XLA path is the one held: it takes the port's 6/12/20
    # node rule, while the Pallas kernel's fixed 20 nodes and erf
    # polynomial flip far-tail cells across the clamp at 0.
    h, mu, idx, clipped, w, buf = _edge_inputs(K, T, clip_all)

    def acc(hh, mm, cl, Dp, cell):
        return xla_accumulate_day(hh, mm, jnp.asarray(idx), cl, Dp, cell, K,
                                  8, buf)

    _, vjp = jax.vjp(acc, jnp.asarray(h), jnp.asarray(mu),
                     jnp.asarray(clipped),
                     (jnp.float32(21.1), jnp.float32(10.6), jnp.float32(rho)),
                     jnp.float32(25.0))
    dh, dmu, dcl, dD, dcell = vjp((jnp.asarray(w), jnp.float32(CT_LOSS)))
    got = accumulate_day_bwd_plain(t32(w), CT_LOSS, t32(h), t32(mu), t32(idx),
                                   t32(clipped), (21.1, 10.6, rho), 25.0, K,
                                   buf, chunk=3)
    assert all(torch.isfinite(g).all() for g in got)
    for g, want in zip(got[:2], (np.asarray(dh), np.asarray(dmu))):
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                   atol=1e-7 * np.abs(want).max())
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dcl), rtol=2e-4,
                               atol=1e-6 * CT_LOSS * h.max())
    dD = np.asarray(dD)
    np.testing.assert_allclose(got[3].numpy(), dD, rtol=2e-4,
                               atol=1e-7 * max(np.abs(dD).max(), 1.0))
    np.testing.assert_allclose(float(got[4]), float(dcell), rtol=2e-4,
                               atol=1e-7)
    # a minute without take-off passes nothing to its mean offset
    assert np.all(got[1].numpy()[h == 0] == 0)


@pytest.mark.parametrize('case', ['cpu_tensors', 'no_reps'])
def test_pass_ms_bwd_refuses_what_it_cannot_time(case):
    h, mu, idx, clipped, w = _inputs()
    args = (t32(w), CT_LOSS, t32(h), t32(mu), t32(idx), t32(clipped),
            (21.1, 10.6, 0.35), 25.0, K, BUF)
    before = day_kernel.LAUNCHES_BWD
    if case == 'cpu_tensors':
        with pytest.raises(ValueError, match='CUDA tensors'):
            day_kernel.pass_ms_bwd(*args)
    else:
        with pytest.raises(ValueError, match='reps must be at least 1'):
            day_kernel.pass_ms_bwd(*args, reps=0)
    assert day_kernel.LAUNCHES_BWD == before

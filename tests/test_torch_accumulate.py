"""Port parity: the day accumulate (ops/day_kernel.py).  The plain torch
accumulate against JAX's XLA path and its Pallas kernel (interpret mode,
as tests/test_pallas_kernel.py runs it off-TPU), the wrapper's CPU
contract, and the kernel's constant packing."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests._torch_parity import t32, torch

from parasitoids_tpu.ops.bvn import gauss_legendre
from parasitoids_tpu.ops.daily_kernel import xla_accumulate_day
from parasitoids_tpu.ops.pallas_kernel import (_hi_quad_params,
                                               pallas_accumulate_day)
from parasitoids_tpu_torch.ops import day_kernel
from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day,
                                                  accumulate_day_plain)

T, K, BUF = 24, 5, 64
N = 2 * K + 1


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.0, 1e-3, T).astype(np.float32)
    mu = rng.uniform(-12.0, 12.0, (T, 2)).astype(np.float32)
    idx = rng.integers(0, BUF - N + 1, (T, 2)).astype(np.int32)
    # blocks at both ends of the idx range contract
    idx[0] = (0, 0)
    idx[1] = (BUF - N, BUF - N)
    idx[2] = (0, BUF - N)
    clipped = rng.integers(0, 2, T).astype(np.float32)
    return h, mu, idx, clipped


@pytest.mark.parametrize('rho', [0.35, 0.93, -0.93, 0.99])
def test_plain_matches_xla_and_pallas(rho):
    # test_pallas_kernel.py tolerances: atol 2e-6 on buffer and loss, 3e-6
    # at |rho| >= 0.925 (the high-corr series)
    tol = 3e-6 if abs(rho) >= 0.925 else 2e-6
    h, mu, idx, clipped = _inputs()
    Dp = (21.1, 10.6, rho)
    got_buf, got_loss = accumulate_day_plain(t32(h), t32(mu), t32(idx),
                                             t32(clipped), Dp, 25.0, K, BUF)
    args = (jnp.asarray(h), jnp.asarray(mu), jnp.asarray(idx),
            jnp.asarray(clipped), Dp, 25.0)
    x_buf, x_loss = xla_accumulate_day(*args, K, 8, BUF)
    p_buf, p_loss = pallas_accumulate_day(*args, K, 8, BUF,
                                          jax.default_backend() != 'tpu')
    assert got_buf.shape == (BUF, BUF)
    for buf, loss in ((x_buf, x_loss), (p_buf, p_loss)):
        np.testing.assert_allclose(got_buf.numpy(), np.asarray(buf),
                                   atol=tol)
        np.testing.assert_allclose(float(got_loss), float(loss), atol=tol)
    assert float(got_buf.sum()) > 0


def test_wrapper_on_cpu_is_the_plain_twin():
    h, mu, idx, clipped = _inputs(11)
    args = (t32(h), t32(mu), t32(idx), t32(clipped), (21.1, 10.6, 0.35),
            25.0, K, BUF)
    launches = day_kernel.LAUNCHES
    buf, loss = accumulate_day(*args)
    want_buf, want_loss = accumulate_day_plain(*args)
    assert torch.equal(buf, want_buf) and torch.equal(loss, want_loss)
    assert day_kernel.LAUNCHES == launches     # no kernel on the CPU


def test_backward_raises():
    # the backward is first-order only (once_differentiable, as the JAX
    # custom_vjp): a second derivative through it raises
    h, mu, idx, clipped = _inputs()
    hh = t32(h).requires_grad_()
    buf, loss = accumulate_day(hh, t32(mu), t32(idx), t32(clipped),
                               (21.1, 10.6, 0.35), 25.0, K, BUF)
    (g,) = torch.autograd.grad((buf ** 2).sum() + loss, hh,
                               create_graph=True)
    with pytest.raises(RuntimeError, match='once_differentiable'):
        g.sum().backward()


@pytest.mark.parametrize('bad', ['f64', 'idx_dtype', 'shape', 'idx_range',
                                 'strided'])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    h, mu, idx, clipped = (t32(a) for a in _inputs())
    if bad == 'f64':
        h = h.double()
    elif bad == 'idx_dtype':
        idx = idx.long()
    elif bad == 'shape':
        clipped = clipped[:-1]
    elif bad == 'idx_range':
        idx = idx.clone()
        idx[5, 1] = BUF - N + 1
    elif bad == 'strided':
        mu = torch.stack([mu[:, 0], mu[:, 1]], dim=0).T
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        accumulate_day(h, mu, idx, clipped, (21.1, 10.6, 0.35), 25.0, K, BUF)


@pytest.mark.parametrize('rho', [0.253, -0.99])
def test_kernel_constants_match_jax(rho):
    # the CUDA kernel's rho-only constants, packed here on the host, against
    # the JAX expressions (bvn.py _upper_lowcorr for each node count,
    # pallas_kernel.py _hi_quad_params); f32 roundoff
    packed = day_kernel._pack_constants((21.1, 10.6, rho), 25.0,
                                        torch.device('cpu')).numpy()
    r = jnp.float32(rho)
    asr = jnp.arcsin(r)
    sn, w, den = [], [], []
    for G in (6, 12, 20):
        x_np, w_np = gauss_legendre(G)
        s = jnp.sin(asr * 0.5 * (1.0 + jnp.asarray(x_np, jnp.float32)))
        sn.append(np.asarray(s))
        w.append(w_np)
        den.append(np.asarray(1.0 - s * s))
    x_np, w_np = gauss_legendre(20)
    hi_quad, scal = _hi_quad_params(r, jnp.asarray(x_np, jnp.float32),
                                    jnp.asarray(w_np, jnp.float32),
                                    jnp.float32)
    sgn, a, _, _, a_sq, _ = (float(v) for v in scal)
    np.testing.assert_allclose(
        packed[:9], [21.1, 10.6, 25.0, rho, sgn, a, a_sq, a / 2, float(asr)],
        rtol=1e-6)
    want = np.concatenate(sn + w + den + [np.asarray(hi_quad[0]),
                                          1.0 / np.asarray(hi_quad[3]),
                                          w_np])
    np.testing.assert_allclose(packed[16:], want, rtol=1e-5, atol=1e-7)
    assert packed.shape == (16 + 3 * 38 + 3 * 20,)

"""Port parity: the daily kernel builder (ops/daily_kernel.py), torch
against JAX at the tests/test_pallas_kernel.py configurations."""

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_parity import HPARAMS, t32, torch, wind

from parasitoids_tpu.ops import daily_kernel as jdk
from parasitoids_tpu_torch.ops import daily_kernel as tdk

BASE = dict(rad_res=60, K=10, K_local=4)
DLP = (5.8, 5.0, 0.1)


def _both(day_idx, start, Dp, n_per=10):
    flat, cs, T = wind()
    hp32 = tuple(np.float32(v) for v in HPARAMS)
    want = jdk.build_daily_kernel(
        jnp.asarray(flat), jnp.asarray(cs), jnp.int32(day_idx), hp32, Dp,
        DLP, jnp.float32(1.1), jnp.int32(n_per), jnp.float32(1500.0),
        jnp.int32(start), jdk.KernelConfig(periods=T, **BASE))
    got = tdk.build_daily_kernel(
        t32(flat), t32(cs), day_idx, HPARAMS, Dp, DLP, 1.1, n_per, 1500.0,
        start, tdk.KernelConfig(periods=T, **BASE))
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


@pytest.mark.parametrize('day_idx,start,rho', [(0, 0, 0.3), (3, 0, 0.3),
                                               (0, 37, 0.3), (1, 0, 0.93),
                                               (1, 0, -0.99)])
def test_build_daily_kernel_matches_jax(day_idx, start, rho):
    # test_pallas_kernel.py:30-51 configs; atol 2e-6 on pmf and loss (3e-6
    # on the high-corr series), pmf sum 1 +- 1e-4
    tol = 3e-6 if abs(rho) >= 0.925 else 2e-6
    (pmf_j, loss_j), (pmf_t, loss_t) = _both(day_idx, start,
                                             (21.1, 10.6, rho))
    assert pmf_t.shape == (121, 121)
    np.testing.assert_allclose(pmf_t, pmf_j, atol=tol)
    np.testing.assert_allclose(loss_t, loss_j, atol=tol)
    np.testing.assert_allclose(pmf_t.sum(), 1.0, atol=1e-4)


def test_day_scatter_inputs_match_jax():
    # the per-minute inputs are elementwise f32 work: idx and clip exact,
    # h and mu to f32 roundoff
    flat, cs, T = wind()
    cfg = dict(periods=T, **BASE)
    hp32 = tuple(np.float32(v) for v in HPARAMS)
    want = jdk.day_scatter_inputs(jnp.asarray(flat), jnp.asarray(cs), 2,
                                  hp32, np.float32(1.1), 10, 0,
                                  jdk.KernelConfig(**cfg), 1500.0)
    got = tdk.day_scatter_inputs(t32(flat), t32(cs), 2, HPARAMS, 1.1, 10, 0,
                                 tdk.KernelConfig(**cfg), 1500.0)
    h_j, mu_j, idx_j, clip_j, out_j = (np.asarray(w) for w in want)
    h_t, mu_t, idx_t, clip_t, out_t = (g.numpy() for g in got)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(clip_t, clip_j)
    assert idx_t.dtype == np.int32
    np.testing.assert_allclose(h_t, h_j, rtol=1e-6, atol=2e-6 * h_j.max())
    np.testing.assert_allclose(mu_t, mu_j, atol=1e-3)   # meters
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)


def test_n_periods_zero_floors_to_one():
    (_, _), (pmf0, loss0) = _both(1, 0, (21.1, 10.6, 0.3), n_per=0)
    (_, _), (pmf1, _) = _both(1, 0, (21.1, 10.6, 0.3), n_per=1)
    assert np.isfinite(pmf0).all() and np.isfinite(loss0)
    np.testing.assert_allclose(pmf0, pmf1, atol=1e-7)


def test_r_small_vals_dense_matches_jax():
    field = np.random.default_rng(5).uniform(0, 2e-8, (40, 40)).astype(
        np.float32)
    for prob in (False, True):
        want = np.asarray(jdk.r_small_vals_dense(jnp.asarray(field), prob))
        got = tdk.r_small_vals_dense(t32(field), prob).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # degenerate input with no surviving entry passes through
    tiny = torch.full((5, 5), 1e-12)
    assert torch.equal(tdk.r_small_vals_dense(tiny, prob_model=True), tiny)


@pytest.mark.parametrize('flag', ['ref_trunc', 'batched_bvn'])
def test_unported_config_flags_raise(flag):
    # both flags once refused are ported: ref_trunc (the reference's ring
    # truncation of every block and of the local kernel) and batched_bvn
    # (the select node rule) each run the plain accumulate, held against
    # JAX's XLA path with the same flag at test_pallas_kernel.py's limits
    # (atol 2e-6, 3e-6 on the high-|rho| series), across the 0.925 rule
    flat, cs, T = wind()
    hp32 = tuple(np.float32(v) for v in HPARAMS)
    for rho, day in ((0.3, 0), (0.93, 1), (-0.99, 3)):
        want = jdk.build_daily_kernel(
            jnp.asarray(flat), jnp.asarray(cs), jnp.int32(day), hp32,
            (21.1, 10.6, rho), DLP, jnp.float32(1.1), jnp.int32(10),
            jnp.float32(1500.0), jnp.int32(0),
            jdk.KernelConfig(periods=T, **BASE, **{flag: True}))
        got = tdk.build_daily_kernel(
            t32(flat), t32(cs), day, HPARAMS, (21.1, 10.6, rho), DLP, 1.1,
            10, 1500.0, 0, tdk.KernelConfig(periods=T, **BASE,
                                            **{flag: True}))
        tol = 3e-6 if abs(rho) >= 0.925 else 2e-6
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=tol)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=tol)


def test_pallas_flag_on_cpu_raises():
    flat, cs, T = wind()
    cfg = tdk.KernelConfig(periods=T, **BASE, pallas=True)
    with pytest.raises(ValueError, match='CUDA'):
        tdk.build_daily_kernel(t32(flat), t32(cs), 0, HPARAMS,
                               (21.1, 10.6, 0.3), DLP, 1.1, 10, 1500.0, 0,
                               cfg)


def _theta(rho):
    # sig_x, sig_y, rho, local sig_x, sig_y, rho, mu_r, lam (day 2 at
    # mu_r = 0.3 keeps most blocks on the domain, so every entry matters)
    return np.array([21.1, 10.6, rho, *DLP, 0.3, 1.0], np.float32)


def _weights():
    D = 2 * BASE['rad_res'] + 1
    return np.random.default_rng(9).normal(size=(D, D)).astype(np.float32)


def _port_day(th, path, day_idx=2):
    """w·pmf + 3·loss of one day through the plain path or through the
    day-accumulate Function (the CUDA path's glue, whose CPU forward and
    backward are the plain twins) followed by ``finish_day``."""
    flat, cs, T = wind()
    cfg = tdk.KernelConfig(periods=T, **BASE)
    hp = (th[7], *HPARAMS[1:])
    if path == 'plain':
        pmf, loss = tdk.build_daily_kernel(
            t32(flat), t32(cs), day_idx, hp, th[0:3], th[3:6], th[6], 10,
            1500.0, 0, cfg)
    else:
        from parasitoids_tpu_torch.ops.day_kernel import accumulate_day
        h, mu, idx, clip, out = tdk.day_scatter_inputs(
            t32(flat), t32(cs), day_idx, hp, th[6], 10, 0, cfg, 1500.0)
        D = 2 * cfg.rad_res + 1
        buf, clip_loss = accumulate_day(h, mu, idx, clip, th[0:3],
                                        1500.0 / cfg.rad_res, cfg.K,
                                        D + 4 * cfg.K)
        pmf, loss = tdk.finish_day(buf, out, clip_loss, th[3:6], cfg, 1500.0)
    return (t32(_weights()) * pmf).sum() + 3.0 * loss


@pytest.mark.parametrize('rho', [0.3, 0.93, -0.99])
def test_day_gradient_matches_jax(rho):
    # the gradient of one day's pmf and loss in the flight and local
    # diffusion, mu_r and lam: the port's plain path (closed-form BVN
    # backward) and its Function path (whose finish_day adds the local
    # remainder in place into a view of the Function's output) against
    # jax.grad through the JAX XLA path
    import jax
    flat, cs, T = wind()

    def jax_obj(t):
        hp = (t[7], *(np.float32(v) for v in HPARAMS[1:]))
        pmf, loss = jdk.build_daily_kernel(
            jnp.asarray(flat), jnp.asarray(cs), jnp.int32(2), hp,
            (t[0], t[1], t[2]), (t[3], t[4], t[5]), t[6], jnp.int32(10),
            jnp.float32(1500.0), jnp.int32(0),
            jdk.KernelConfig(periods=T, **BASE))
        return (jnp.asarray(_weights()) * pmf).sum() + 3.0 * loss

    want = np.asarray(jax.grad(jax_obj)(jnp.asarray(_theta(rho))))
    assert np.all(want != 0)
    # mu_r's entry sums per-minute mean derivatives over the day: in f32 it
    # lies up to 6e-5 of max|g| from an f64 evaluation of the port, so it
    # gets a wider atol than the rest
    atol = np.full(want.shape, 1e-6 * np.abs(want).max())
    atol[6] = 3e-4 * np.abs(want).max()
    got = {}
    for path in ('plain', 'function'):
        th = torch.tensor(_theta(rho), requires_grad=True)
        _port_day(th, path).backward()
        got[path] = th.grad.numpy()
        assert np.all(np.abs(got[path] - want) <= atol + 2e-4 * np.abs(want))
    np.testing.assert_array_equal(got['function'], got['plain'])

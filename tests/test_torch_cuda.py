"""The hand-written CUDA day kernel on the card, against its plain torch
twin.  Every test here needs an NVIDIA GPU and skips without one; run them
on the card with ``pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest

from tests._torch_parity import (HPARAMS, MAP_SMALL,  # noqa: F401
                                 cuda_device, exact_support_mask, torch,
                                 wind)

from parasitoids_tpu_torch.ops import daily_kernel as tdk
from parasitoids_tpu_torch.ops import day_kernel

pytestmark = pytest.mark.cuda


def _day_inputs(device, K, rad_res=400, day=1, rho=0.253):
    flat, cs, T = wind(interp=30)
    flat_t = torch.from_numpy(flat).to(device)
    cs_t = torch.from_numpy(cs).to(device)
    cfg = tdk.KernelConfig(rad_res=rad_res, periods=T, K=K, K_local=20)
    h, mu, idx, clip, _ = tdk.day_scatter_inputs(
        flat_t, cs_t, day, HPARAMS, 1.179, 30, 0, cfg, 10000.0)
    return (h, mu, idx, clip, (171.82, 144.58, rho), 25.0, K,
            2 * rad_res + 1 + 4 * K)


@pytest.mark.parametrize('rho', [0.253, 0.93, -0.99])
def test_kernel_matches_plain_on_card(cuda_device, rho):
    # atol 2e-6 on buffer and loss, 3e-6 on the high-corr series
    tol = 3e-6 if abs(rho) >= 0.925 else 2e-6
    args = _day_inputs(cuda_device, 44, rho=rho)
    launches = day_kernel.LAUNCHES
    buf, loss = day_kernel.accumulate_day(*args)
    torch.cuda.synchronize()
    assert day_kernel.LAUNCHES == launches + 1
    want_buf, want_loss = day_kernel.accumulate_day_plain(*args)
    np.testing.assert_allclose(buf.cpu().numpy(), want_buf.cpu().numpy(),
                               atol=tol)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=tol)


def test_kernel_is_bitwise_reproducible(cuda_device):
    args = _day_inputs(cuda_device, 29)
    a = day_kernel.accumulate_day(*args)
    b = day_kernel.accumulate_day(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_kernel_refuses_f64_on_card(cuda_device):
    h, mu, idx, clip, Dp, cell, K, buf_len = _day_inputs(cuda_device, 10)
    with pytest.raises(TypeError):
        day_kernel.accumulate_day(h.double(), mu, idx, clip, Dp, cell, K,
                                  buf_len)


def _bwd_args(device, K, rho):
    h, mu, idx, clip, Dp, cell, K, buf_len = _day_inputs(device, K, rho=rho)
    gen = torch.Generator(device=device).manual_seed(1)
    ct_buf = torch.randn((buf_len, buf_len), generator=gen, device=device)
    ct_loss = torch.randn((), generator=gen, device=device)
    return (ct_buf, ct_loss, h, mu, idx, clip,
            torch.tensor(Dp, device=device), torch.tensor(cell, device=device),
            K, buf_len)


@pytest.mark.parametrize('rho', [0.253, 0.93, -0.99])
def test_backward_kernel_matches_plain_on_card(cuda_device, rho):
    # each output within rtol 2e-4 of its scale (test_pallas_kernel.py's
    # rtol); dclip's scale is ct_loss·h, its factor (1 - sum block) is
    # f32 cancellation noise for interior blocks
    args = _bwd_args(cuda_device, 44, rho)
    launches = day_kernel.LAUNCHES_BWD
    got = day_kernel.accumulate_day_bwd(*args)
    torch.cuda.synchronize()
    assert day_kernel.LAUNCHES_BWD == launches + 1
    want = day_kernel.accumulate_day_bwd_plain(*args)
    scales = [w.abs().max() for w in want]
    scales[2] = (args[1] * args[2]).abs().max()
    for g, w, sc in zip(got, want, scales):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 2e-4 * float(sc)


def test_backward_kernel_is_bitwise_reproducible(cuda_device):
    args = _bwd_args(cuda_device, 29, 0.5)
    a = day_kernel.accumulate_day_bwd(*args)
    b = day_kernel.accumulate_day_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_log_posterior_gradient_kernels_vs_plain(cuda_device):
    # the small MAP configuration of tests/test_torch_map.py on the card,
    # through K1-K4 and through the plain path, with the observations whose
    # f64 rate is 0 held out (see exact_support_mask): value rtol 1e-5,
    # gradient relative L2 1e-4
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    z0 = map_fit.initial_z(BayesSetup(map_fit.map_cli_params(MAP_SMALL),
                                      device='cpu'), True)
    keep = exact_support_mask(
        BayesSetup(map_fit.map_cli_params(MAP_SMALL), device='cpu',
                   dtype=torch.float64), z0, True)
    out = []
    for use_pallas in (None, False):
        p = map_fit.map_cli_params(MAP_SMALL)
        p.use_pallas = use_pallas
        setup = BayesSetup(p, device=cuda_device).with_held_out(keep)
        assert setup.setup.kcfg.pallas == (use_pallas is None)
        neg, _, _ = map_fit._make_objective(setup, True)
        z = z0.to(cuda_device).requires_grad_()
        before = day_kernel.LAUNCHES_BWD
        v = neg(z)
        v.backward()
        assert day_kernel.LAUNCHES_BWD - before == (3 if use_pallas is None
                                                    else 0)
        out.append((float(v), z.grad.double().cpu().numpy()))
    (vk, gk), (vp, gp) = out
    assert np.isfinite(vk) and np.all(np.isfinite(gk))
    assert abs(vk - vp) <= 1e-5 * abs(vp)
    assert np.linalg.norm(gk - gp) <= 1e-4 * np.linalg.norm(gp)

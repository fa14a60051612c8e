"""The hand-written CUDA day kernel on the card, against its plain torch
twin.  Every test here needs an NVIDIA GPU and skips without one; run them
on the card with ``pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest

from tests._torch_parity import (HPARAMS, MAP_SMALL,  # noqa: F401
                                 cuda_device, exact_support_mask, torch,
                                 wind)

from chip_smoke import BWD_ATOL, BWD_RTOL
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
    return (h, mu, idx, clip, (171.82, 144.58, rho), 10000.0 / rad_res, K,
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


def _adversarial_inputs(device, case, rho):
    """Seeded synthetic days whose scatter starts stress the split-minute
    gather: every minute at one start, the four extreme corners of the
    buffer, a single minute, a minute count that is no multiple of the
    chunk, the blocks of minutes with no take-off parked in a corner, and
    a narrow window.  A minute's take-off is up to 1.4e-4 (a 1,440-minute
    day sums to about 0.07), so buffer peaks stay in the range of the
    Kalbar days the limits were set on; every third minute has none."""
    K, T, buf_len = {'pileup': (44, 1440, 977), 'corners': (44, 1440, 977),
                     'one_minute': (44, 1, 977), 'ragged': (44, 1000, 977),
                     'parked': (44, 1440, 977), 'narrow': (3, 1440, 113)
                     }[case]
    n = 2 * K + 1
    last = buf_len - n
    rng = np.random.default_rng(7)
    if case == 'pileup':
        idx = np.full((T, 2), last // 2)
    elif case == 'corners':
        corners = np.array([[0, 0], [0, last], [last, 0], [last, last]])
        idx = corners[np.arange(T) % 4]
    else:                      # a wind-like random walk of the start
        steps = rng.integers(-1, 2, size=(T, 2)) * (rng.random((T, 1)) < 0.3)
        idx = np.clip(last // 3 + np.cumsum(steps, axis=0), 0, last)
    h = rng.random(T) * (0.2 / 1440)
    h[1::3] = 0.0                      # minutes with no take-off
    if case == 'parked':               # no take-off before dawn, and a
        h[:300] = 0.0                  # minute without take-off parks its
        idx[h == 0] = [last, 0]        # block in a corner
    mu = rng.uniform(-12.5, 12.5, size=(T, 2))
    # clipped: the block straddles the domain's edge (2K cells in)
    clip = ((idx < 2 * K) | (idx + n > buf_len - 2 * K)).any(axis=1)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=device)
    return (t(h, torch.float32), t(mu, torch.float32), t(idx, torch.int32),
            t(clip, torch.float32), (171.82, 144.58, rho), 25.0, K, buf_len)


@pytest.mark.parametrize('rho', [0.253, -0.99])
@pytest.mark.parametrize('case', ['pileup', 'corners', 'one_minute',
                                  'ragged', 'parked', 'narrow'])
def test_kernel_adversarial_starts(cuda_device, case, rho):
    # the limits of chip_smoke.py [3]: 1e-8 absolute on buffer and loss,
    # and 3e-5 of the buffer peak; two launches bitwise equal
    args = _adversarial_inputs(cuda_device, case, rho)
    buf, loss = day_kernel.accumulate_day(*args)
    again, loss_again = day_kernel.accumulate_day(*args)
    want_buf, want_loss = day_kernel.accumulate_day_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(buf, again) and torch.equal(loss, loss_again)
    peak = float(want_buf.max())
    err = float((buf - want_buf).abs().max())
    assert peak > 0 and err <= 1e-8 and err <= 3e-5 * peak
    # the loss weighs each clipped minute's 1 - sum(block); at high |rho|
    # the block sum carries f32 noise of the four-corner difference (~1e-5
    # of it), so its limit is 1e-8 or 3e-5 of the clipped take-off mass
    h, clip = args[0], args[3]
    assert abs(float(loss) - float(want_loss)) <= max(
        1e-8, 3e-5 * float((clip * h).sum()))
    # cells that no block meets are written, and exactly 0
    buf_len, n = args[7], 2 * args[6] + 1
    met = np.zeros((buf_len, buf_len), bool)
    for r0, c0 in np.unique(args[2].cpu().numpy(), axis=0):
        met[r0:r0 + n, c0:c0 + n] = True
    assert not met.all()
    assert bool((buf.cpu()[torch.from_numpy(~met)] == 0).all())


def test_pass_ms_times_the_three_passes(cuda_device):
    args = _day_inputs(cuda_device, 44)
    launches = day_kernel.LAUNCHES
    ms = day_kernel.pass_ms(*args, reps=3)
    assert ms.shape == (3, 3) and np.all(ms > 0)
    assert day_kernel.LAUNCHES == launches + 3


def test_kernel_refuses_f64_on_card(cuda_device):
    h, mu, idx, clip, Dp, cell, K, buf_len = _day_inputs(cuda_device, 10)
    with pytest.raises(TypeError):
        day_kernel.accumulate_day(h.double(), mu, idx, clip, Dp, cell, K,
                                  buf_len)


def _cotangent(buf_len, device, seed, smooth):
    """Seeded cotangents on the buffer and the loss: white noise, or a
    smooth field of unit scale (a 24 x 24 normal field interpolated
    bicubically), like the one the propagation hands a day's buffer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if smooth:
        coarse = torch.randn((1, 1, 24, 24), generator=gen, device=device)
        ct_buf = torch.nn.functional.interpolate(
            coarse, size=(buf_len, buf_len), mode='bicubic',
            align_corners=True)[0, 0].contiguous()
    else:
        ct_buf = torch.randn((buf_len, buf_len), generator=gen,
                             device=device)
    return ct_buf, torch.randn((), generator=gen, device=device)


def _bwd_args(device, K, rho, smooth=False, rad_res=400):
    h, mu, idx, clip, Dp, cell, K, buf_len = _day_inputs(device, K, rad_res,
                                                         rho=rho)
    ct_buf, ct_loss = _cotangent(buf_len, device, 1, smooth)
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


_BWD_OUTPUTS = ('dh', 'dmu', 'dclip', 'dsig_x', 'dsig_y', 'drho', 'dcell')


def _split(out):
    dh, dmu, dclip, dD, dcell = out
    return [dh, dmu, dclip, *dD, dcell]


def _bwd_limits(K, scales):
    """Each output's limit: chip_smoke.py [6]'s, BWD_RTOL (2e-4,
    test_pallas_kernel.py's rtol) of the output's scale plus its atol.  The
    atols are the f32 noise floors of sums over the (2K+2)² corners of a
    K = 44 window under a unit cotangent and a day's take-off; a narrower
    window sums fewer corners and gets that share of them.  dh has none."""
    share = min(1.0, ((2 * K + 2) / 90.0) ** 2)
    return [share * BWD_ATOL[name] + BWD_RTOL * sc
            for name, sc in zip(_BWD_OUTPUTS, scales)]


def _assert_backward_matches_plain(args):
    """Every output of the backward kernel against the plain version run
    in f64 on the same (f32) inputs: within its limit (see _bwd_limits),
    or no more than twice as far from f64 as the plain version run in f32
    is.  The second clause is for sums that cancel beyond what f32 can
    resolve (a cell of the rebuilt block is a difference of four lattice
    values of order 1, so it carries about 1e-7 of rounding whatever its
    mass, and the corner sums alternate in sign): there the f32 plain
    version is as far from f64 as the kernel, and its distance says what
    f32 can give.  dclip's scale is ct_loss·h.  Returns the kernel's
    outputs; prints each output's scale and the two distances."""
    ct_buf, ct_loss, h, mu, idx, clip, Dp, cell, K, buf_len = args
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                    device=h.device).double()
    got = day_kernel.accumulate_day_bwd(*args)
    plain = _split(day_kernel.accumulate_day_bwd_plain(*args))
    ref = _split(day_kernel.accumulate_day_bwd_plain(
        f64(ct_buf), f64(ct_loss), f64(h), f64(mu), idx, f64(clip), f64(Dp),
        f64(cell), K, buf_len))
    scales = [float(r.abs().max()) for r in ref]
    scales[2] = float((ct_loss * h).abs().max())
    for name, g, p32, r, sc, limit in zip(_BWD_OUTPUTS, _split(got), plain,
                                          ref, scales,
                                          _bwd_limits(K, scales)):
        assert g.shape == r.shape and torch.isfinite(g).all()
        e_k = float((g.double() - r).abs().max())
        e_p = float((p32.double() - r).abs().max())
        print('{}: scale {:.3e}, limit {:.3e}, |kernel - f64 plain| {:.3e}, '
              '|f32 plain - f64 plain| {:.3e}'.format(name, sc, limit, e_k,
                                                      e_p))
        assert e_k <= limit or e_k <= 2 * e_p, name
    return got


@pytest.mark.parametrize('rho', [0.253, -0.99])
@pytest.mark.parametrize('K', [1, 5, 22, 44])
def test_backward_kernel_white_noise_cotangent(cuda_device, K, rho):
    # a whole day against white noise and the f32 plain version, as
    # chip_smoke.py [6] holds it at K = 44
    args = _bwd_args(cuda_device, K, rho, rad_res=200 if K == 22 else 400)
    got = _split(day_kernel.accumulate_day_bwd(*args))
    want = _split(day_kernel.accumulate_day_bwd_plain(*args))
    scales = [float(w.abs().max()) for w in want]
    scales[2] = float((args[1] * args[2]).abs().max())
    for name, g, w, limit in zip(_BWD_OUTPUTS, got, want,
                                 _bwd_limits(K, scales)):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= limit, name


@pytest.mark.parametrize('smooth', [False, True])
@pytest.mark.parametrize('rho', [0.253, -0.99])
@pytest.mark.parametrize('T', [1, 7, 1440])
@pytest.mark.parametrize('K', [1, 5, 22, 44, 88])
def test_backward_kernel_over_windows_and_lengths(cuda_device, K, T, rho,
                                                  smooth):
    # K = 1 is smaller than the lattice ring, K = 88 larger than any whole
    # lattice that fits shared memory (K = 22, 44, 88 are the
    # prior-coverage windows of 50, 25 and 12.5 m cells); T = 1 and 7 leave
    # most of the card idle; minutes 3, 6, ... have no take-off; the
    # cotangent is white noise or a smooth field
    ct_buf, ct_loss, h, mu, idx, clip, Dp, cell, K, buf_len = _bwd_args(
        cuda_device, K, rho, smooth=smooth,
        rad_res={22: 200, 88: 800}.get(K, 400))
    first = 600 if T < 1440 else 0     # mid-morning: take-off under way
    h, mu, idx, clip = (a[first:first + T].contiguous()
                        for a in (h, mu, idx, clip))
    h[2::3] = 0.0
    launches = day_kernel.LAUNCHES_BWD
    _assert_backward_matches_plain((ct_buf, ct_loss, h, mu, idx, clip, Dp,
                                    cell, K, buf_len))
    assert day_kernel.LAUNCHES_BWD == launches + 1


@pytest.mark.parametrize('smooth', [False, True])
@pytest.mark.parametrize('rho', [0.253, -0.99])
@pytest.mark.parametrize('case', ['pileup', 'corners', 'one_minute',
                                  'ragged', 'parked', 'narrow'])
def test_backward_kernel_adversarial_starts(cuda_device, case, rho, smooth):
    # windows at the buffer's four corners, all at one start, a single
    # minute, and a third of the minutes with h = 0
    h, mu, idx, clip, Dp, cell, K, buf_len = _adversarial_inputs(
        cuda_device, case, rho)
    ct_buf, ct_loss = _cotangent(buf_len, cuda_device, 2, smooth)
    got = _assert_backward_matches_plain((ct_buf, ct_loss, h, mu, idx, clip,
                                          Dp, cell, K, buf_len))
    # a minute without take-off passes no gradient to its mean offset
    assert bool((got[1][h == 0] == 0).all())


@pytest.mark.parametrize('K', [29, 44, 88])
def test_backward_kernel_is_bitwise_reproducible(cuda_device, K):
    args = _bwd_args(cuda_device, K, 0.5, rad_res=800 if K == 88 else 400)
    a = day_kernel.accumulate_day_bwd(*args)
    b = day_kernel.accumulate_day_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('ring', [2, 8, 13, 1000])
def test_backward_ring_height_changes_only_the_sum_order(cuda_device, ring,
                                                         monkeypatch):
    # any ring height, one row at a time or the whole lattice at once,
    # gives the plain version's gradient
    monkeypatch.setattr(day_kernel, '_bwd_ring', lambda lib, K: ring)
    _assert_backward_matches_plain(_bwd_args(cuda_device, 22, 0.253, True))


def test_backward_runs_wherever_the_forward_runs(cuda_device):
    # K = 118 is the widest window whose lattice fits block_build's shared
    # memory; the backward has no limit of its own
    h, mu, idx, clip, Dp, cell, K, buf_len = _day_inputs(cuda_device, 118)
    h, mu, idx, clip = (a[600:607].contiguous() for a in (h, mu, idx, clip))
    day_kernel.accumulate_day(h, mu, idx, clip, Dp, cell, K, buf_len)
    ct_buf, ct_loss = _cotangent(buf_len, cuda_device, 3, True)
    _assert_backward_matches_plain((ct_buf, ct_loss, h, mu, idx, clip, Dp,
                                    cell, K, buf_len))


def test_pass_ms_bwd_times_both_launches(cuda_device):
    args = _bwd_args(cuda_device, 44, 0.253)
    launches = day_kernel.LAUNCHES_BWD
    ms = day_kernel.pass_ms_bwd(*args, reps=3)
    assert ms.shape == (3, 2) and np.all(ms > 0)
    assert day_kernel.LAUNCHES_BWD == launches + 3


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

"""The hand-written CUDA day kernel on the card, against its plain torch
twin.  Every test here needs an NVIDIA GPU and skips without one; run them
on the card with ``pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest

from tests._torch_parity import (HPARAMS, MAP_SMALL,  # noqa: F401
                                 cuda_device, exact_support_mask, torch,
                                 wind)

from chip_smoke import (BWD_ATOL, BWD_RTOL, PROBE_CELL, PROBE_KS,
                        low_corner_gap, probe_cases)
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


def _am_setup(device):
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    return BayesSetup(map_fit.map_cli_params(MAP_SMALL), device=device)


def test_forward_projections_are_bitwise_reproducible(cuda_device):
    # the sampler's exact resume rebuilds the cached projections: the same
    # block must give the same bits (no atomic adds anywhere on the path)
    from parasitoids_tpu_torch.bayes import priors
    from parasitoids_tpu_torch.bayes.model import _as_model
    setup = _am_setup(cuda_device)
    m = _as_model(torch.as_tensor(priors.initial_model_params(),
                                  dtype=torch.float32).to(cuda_device))
    with torch.no_grad():
        runs = [setup.forward_projections(m) for _ in range(3)]
    flat = [torch.cat([p.reshape(-1) for p in (*r[0], *r[1], r[2])])
            for r in runs]
    assert torch.equal(flat[0], flat[1]) and torch.equal(flat[0], flat[2])
    assert float(flat[0].abs().max()) > 0


def test_am_resume_is_exact_and_the_sweep_never_waits(cuda_device, tmp_path):
    # the small configuration through K1: a reloaded state continues bit
    # for bit, every forward is one kernel launch a day, and the
    # observation sweep makes no synchronizing call
    from parasitoids_tpu_torch.bayes import sampler
    from parasitoids_tpu_torch.bayes.store import load_chain, save_chain
    setup = _am_setup(cuda_device)
    assert setup.setup.kcfg.pallas
    launches, forwards = day_kernel.LAUNCHES, sampler.FORWARDS
    state = sampler.init_chain_state(
        setup, sampler.chain_generator(0, 0, cuda_device))
    state, tr = sampler.run_mcmc(setup, state, sampler.MCMCConfig(8))
    db = str(tmp_path / 'am')
    save_chain(db, tr[None], state)
    _, again, meta = load_chain(db, setup)
    assert meta['device'] == 'cuda'
    _, tr_a = sampler.run_mcmc(setup, state, sampler.MCMCConfig(6))
    _, tr_b = sampler.run_mcmc(setup, again, sampler.MCMCConfig(6))
    assert torch.equal(tr_a, tr_b) and bool(torch.isfinite(tr_a).all())
    assert day_kernel.LAUNCHES - launches == \
        setup.ndays * (sampler.FORWARDS - forwards)
    with pytest.raises(ValueError, match='device type'):
        load_chain(db, _am_setup('cpu'))
    draws = sampler.draw_step(state.key, 10, torch.float32, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        with torch.no_grad():
            sampler._obs_sweep(setup, draws.obs_eps, draws.obs_log_u,
                               again.o, again.prior_o, again.loglik,
                               again.proj, 1.0, sampler.MCMCConfig(1))
    finally:
        torch.cuda.set_sync_debug_mode('default')


def _nuts_setups(device):
    """The small configuration through the kernels and on the plain path,
    the observations whose f64 rate is 0 at map_fit's start held out."""
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    z0 = map_fit.initial_z(BayesSetup(map_fit.map_cli_params(MAP_SMALL),
                                      device='cpu'), False)
    keep = exact_support_mask(
        BayesSetup(map_fit.map_cli_params(MAP_SMALL), device='cpu',
                   dtype=torch.float64), z0, False)
    out = []
    for use_pallas in (None, False):
        p = map_fit.map_cli_params(MAP_SMALL)
        p.use_pallas = use_pallas
        out.append(BayesSetup(p, device=device).with_held_out(keep))
    return out


def test_nuts_gradient_is_bitwise_reproducible(cuda_device):
    # exact resume of a NUTS chain needs the same value and gradient bits
    # from the same z: no atomic add on the forward or the backward.  At
    # this configuration an observation cell repeats up to 16 times in one
    # gather, whose index_select backward added them atomically: 1 of 9
    # gradients differed before the gathers were made deterministic
    from parasitoids_tpu_torch.bayes import nuts
    setup = _am_setup(cuda_device)
    logpdf, _, z0 = nuts.make_transformed_logpdf(setup)
    lpg = nuts.value_and_grad(logpdf)
    before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
    runs = [lpg(z0) for _ in range(12)]
    torch.cuda.synchronize()
    assert (day_kernel.LAUNCHES - before[0],
            day_kernel.LAUNCHES_BWD - before[1]) == (36, 36)
    for lp, g in runs[1:]:
        assert torch.equal(lp, runs[0][0]) and torch.equal(g, runs[0][1])
    assert bool(torch.isfinite(runs[0][1]).all())


def test_nuts_transition_kernels_vs_plain(cuda_device):
    # one transition near the mode through K1/K3 and on the plain path
    # with the same draws: the same leapfrogs and choices (compared where
    # every choice clears its threshold by 1e-4), proposals within 1e-5
    from tests._torch_parity import NEAR_MODE
    from parasitoids_tpu_torch.bayes import nuts
    kernels, plain = _nuts_setups(cuda_device)
    z = torch.tensor(NEAR_MODE, device=cuda_device)
    inv_mass = torch.full_like(z, 0.01)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    compared = 0
    for seed in range(3):
        draws = nuts.draw_transition(gen, z.shape[0], 3, torch.float32)
        outs, decs = [], []
        for setup in (kernels, plain):
            lpg = nuts.value_and_grad(nuts.make_transformed_logpdf(setup)[0])
            lp, g = lpg(z)
            decisions = []
            outs.append(nuts._nuts_step(lpg, inv_mass, torch.full_like(
                lp, 0.2), 3, z, lp, g, draws, decisions=decisions))
            decs.append(decisions)
        margins = [abs(float(u) - float(t)) for u, t in decs[1]
                   if np.isfinite(float(t))]
        if margins and min(margins) <= 1e-4:
            continue
        compared += 1
        (zk, lpk, _, ak, nk, dk), (zp, lpp, _, ap, n_p, dp) = outs
        assert nk == n_p and bool(dk) == bool(dp)
        np.testing.assert_allclose(zk.cpu().numpy(), zp.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert abs(float(lpk) - float(lpp)) <= 1e-5 * abs(float(lpp))
        assert abs(float(ak) - float(ap)) <= 1e-4
    assert compared >= 2


def test_laplace_hessian_at_401_repeats_in_its_precision(cuda_device):
    # the Laplace Hessian at the MAP CLI default (401², 18 days, K = 22,
    # Kl = 10, sprd_factor) on the f64 plain twin, twice: no kernel launch,
    # and the two runs agree to f64 roundoff (the plain accumulate's
    # index_add adds atomically on the card, so they need not be equal)
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    setup = BayesSetup(map_fit.map_cli_params(), device=cuda_device)
    assert map_fit.hessian_dtype(setup) == torch.float64
    twin = map_fit.plain_twin(setup, torch.float64)
    neg, _, _ = map_fit._make_objective(twin, True)
    z = map_fit.initial_z(setup, True).double()
    before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
    H1, H2 = (map_fit.hessian_columns(neg, z) for _ in range(2))
    torch.cuda.synchronize()
    assert (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD) == before
    assert H1.dtype == torch.float64 and H1.shape == (26, 26)
    assert bool(torch.isfinite(H1).all())
    assert float((H1 - H2).abs().max()) <= 1e-10 * float(H1.abs().max())


def _same_states(a, b):
    """Two stacked chain states bitwise equal, generators included."""
    tensors = all(torch.equal(getattr(a, f), getattr(b, f))
                  for f in a._fields if f not in ('key', 'proj'))
    return tensors and all(torch.equal(x.get_state(), y.get_state())
                           for x, y in zip(a.key, b.key))


def test_pt_swaps_are_bitwise_reproducible(cuda_device, tmp_path):
    # parallel tempering at the small configuration through K1: two runs
    # from the same seeds swap and move alike bit for bit, and a chunked
    # run and a reloaded store continue as the monolithic run
    from parasitoids_tpu_torch.bayes import tempering
    from parasitoids_tpu_torch.bayes.store import load_chain, save_chain
    setup = _am_setup(cuda_device)
    betas = tempering.power_ladder(3, 1.0)
    cfg = tempering.PTConfig(n_rounds=2, swap_every=2)
    runs = [tempering.run_pt(setup, tempering.init_pt_states(setup, 3, 3),
                             betas, 5, tempering.PTConfig(n_rounds=4,
                                                          swap_every=2))
            for _ in range(2)]
    assert _same_states(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2]['swap_accepts'], runs[1][2]['swap_accepts'])
    st, tr1, _ = tempering.run_pt(setup, tempering.init_pt_states(setup, 3, 3),
                                  betas, 5, cfg)
    db = str(tmp_path / 'pt')
    save_chain(db, tr1[:1], st)
    _, st, _ = load_chain(db, setup)
    st, tr2, _ = tempering.run_pt(setup, st, betas, 5, cfg, round_offset=2)
    assert torch.equal(torch.cat([tr1, tr2], 1), runs[0][1])
    assert _same_states(st, runs[0][0])


def test_smc_resume_is_bitwise(cuda_device, tmp_path):
    # SMC at the small configuration through K1: stopped after stage 2,
    # saved as the command line saves it, reloaded and resumed to stage 4,
    # bitwise the run that never stopped; clones hold distinct generators
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import smc
    setup = _am_setup(cuda_device)
    cfg = smc.SMCConfig(n_particles=6, n_moves=1, resample_ess=1.0,
                        min_accepts=0.0, max_move_rounds=1)
    db = str(tmp_path / 'smc')

    class Stop(Exception):
        pass

    def stop_at(stage, keep, save=False):
        def cb(p):
            if save:
                bayes_run._save_smc(db, p, 0, cfg)
            keep.update(p)
            if p['stage'] == stage:
                raise Stop
        return cb

    mono, part, resumed = {}, {}, {}
    for keep, stage, save in ((mono, 4, False), (part, 2, True)):
        with pytest.raises(Stop):
            smc.run_smc(setup, 1, cfg, seed=2,
                        checkpoint=stop_at(stage, keep, save))
    payload, _ = bayes_run._smc_resume_payload(db, setup)
    with pytest.raises(Stop):
        smc.run_smc(setup, None, cfg, seed=2, resume=payload,
                    checkpoint=stop_at(4, resumed))
    assert _same_states(mono['states'], resumed['states'])
    assert mono['logz'] == resumed['logz']
    np.testing.assert_array_equal(mono['logw'], resumed['logw'])
    keys = {bytes(g.get_state().numpy()) for g in mono['states'].key}
    assert all(mono['history']['resampled']) and len(keys) == 6


def _batched_inputs(device, rhos, K=44, day=9, rad_res=400):
    """One Kalbar day for len(rhos) particles (the same minutes, one
    diffusion per particle), as the batched forward gives them."""
    flat, cs, T = wind(interp=30)
    cfg = tdk.KernelConfig(rad_res=rad_res, periods=T, K=K, K_local=20)
    n = len(rhos)
    h, mu, idx, clip, _ = tdk.day_scatter_inputs(
        torch.from_numpy(flat).to(device), torch.from_numpy(cs).to(device),
        day, tuple(torch.full((n, 1), v, device=device) for v in HPARAMS),
        torch.full((n, 1), 1.179, device=device),
        torch.full((n, 1), 30, dtype=torch.int64, device=device), 0, cfg,
        10000.0)
    Dp = torch.tensor([[171.82 + 10 * i, 144.58 - 5 * i, r]
                       for i, r in enumerate(rhos)], device=device)
    return h, mu, idx, clip, Dp, 10000.0 / rad_res, K, 2 * rad_res + 1 + 4 * K


@pytest.mark.parametrize('day', [0, 9, 17])
def test_batched_kernel_matches_plain_on_card(cuda_device, day):
    # four particles whose rho straddles 0.925: one launch against the
    # plain twin (each particle's own Genz tier) at K1's limits (atol
    # 2e-6, 3e-6 where the series runs), one launch counted, two launches
    # bitwise equal
    rhos = (0.253, 0.9, 0.93, -0.99)
    args = _batched_inputs(cuda_device, rhos, day=day)
    launches = day_kernel.LAUNCHES_BATCHED
    buf, loss = day_kernel.accumulate_day_batched(*args)
    torch.cuda.synchronize()
    assert day_kernel.LAUNCHES_BATCHED == launches + 1
    want_buf, want_loss = day_kernel.accumulate_day_batched_plain(*args)
    for i, r in enumerate(rhos):
        tol = 3e-6 if abs(r) > 0.925 else 2e-6
        np.testing.assert_allclose(buf[i].cpu().numpy(),
                                   want_buf[i].cpu().numpy(), atol=tol)
        np.testing.assert_allclose(float(loss[i]), float(want_loss[i]),
                                   atol=tol)
    again = day_kernel.accumulate_day_batched(*args)
    assert torch.equal(buf, again[0]) and torch.equal(loss, again[1])


def test_batched_kernel_particle_is_its_own_launch(cuda_device):
    # a particle of a batched launch is bitwise the launch of that particle
    # alone (the same CTAs, the same order of every sum)
    args = _batched_inputs(cuda_device, (0.253, -0.99, 0.6))
    buf, loss = day_kernel.accumulate_day_batched(*args)
    h, mu, idx, clip, Dp = args[:5]
    for i in range(3):
        one = day_kernel.accumulate_day_batched(
            h[i:i + 1].contiguous(), mu[i:i + 1].contiguous(),
            idx[i:i + 1].contiguous(), clip[i:i + 1].contiguous(),
            Dp[i:i + 1], *args[5:])
        assert torch.equal(one[0][0], buf[i]) and torch.equal(one[1][0],
                                                              loss[i])


def _kernel_outputs(h, mu, idx, Dp, cell, K, buf_len):
    """The buffer(s) and block sums of one forward launch, single or
    particle-batched, as the kernel writes them."""
    from parasitoids_tpu_torch.ops import _build
    lib = _build.load('day_kernel')
    out, args = day_kernel._forward_args(h, mu, idx, Dp, cell, K, buf_len,
                                         day_kernel._CHUNK)
    day_kernel._cuda_call(lib, 'parasitoids_day_accumulate',
                          lib.parasitoids_day_smem_bytes(K), K, h.device,
                          *args)
    return out['buf'], out['bsum']


@pytest.mark.parametrize('day', [0, 9, 17])
def test_batched_particle_is_its_single_launch(cuda_device, day):
    # each particle of one batched launch, one rho in every Genz tier and
    # one on the series, is bitwise the single launch at that particle's
    # (sigma_x, sigma_y, rho): the same node rule, the same instructions
    # in the same order; buffers and block sums as the kernel wrote them,
    # and the buffer through the public wrappers too
    rhos = (0.253, 0.6, 0.8, 0.93, -0.99)
    args = _batched_inputs(cuda_device, rhos, day=day)
    h, mu, idx, clip, Dp, cell, K, L = args
    buf, bsum = _kernel_outputs(h, mu, idx, Dp, cell, K, L)
    wrapped, _ = day_kernel.accumulate_day_batched(*args)
    assert torch.equal(wrapped, buf)
    for i in range(len(rhos)):
        dp = tuple(Dp[i])
        one, one_sum = _kernel_outputs(h[i], mu[i], idx[i], dp, cell, K, L)
        assert torch.equal(one, buf[i]) and torch.equal(one_sum, bsum[i]), \
            rhos[i]
        alone, _ = day_kernel.accumulate_day(h[i], mu[i], idx[i], clip[i],
                                             dp, cell, K, L)
        assert torch.equal(alone, buf[i]), rhos[i]


def test_batched_smc_moves_launch_once_a_day(cuda_device):
    # run_smc(batched=True) at the small configuration: every move round
    # makes ndays batched launches and no single one, and resumes bitwise
    from parasitoids_tpu_torch.bayes import smc
    setup = _am_setup(cuda_device)
    cfg = smc.SMCConfig(n_particles=4, n_moves=1, min_accepts=0.0,
                        max_move_rounds=1)

    class Stop(Exception):
        pass

    def stop_at(stage, keep):
        def cb(p):
            keep.update(p)
            if p['stage'] == stage:
                raise Stop
        return cb

    mono, part, resumed = {}, {}, {}
    with pytest.raises(Stop):
        smc.run_smc(setup, 1, cfg, seed=2, batched=True,
                    checkpoint=stop_at(1, part))
    single = day_kernel.LAUNCHES
    batched = day_kernel.LAUNCHES_BATCHED
    with pytest.raises(Stop):
        smc.run_smc(setup, None, cfg, seed=2, batched=True, resume=part,
                    checkpoint=stop_at(3, resumed))
    torch.cuda.synchronize()
    assert day_kernel.LAUNCHES == single
    assert day_kernel.LAUNCHES_BATCHED - batched == 2 * setup.ndays
    with pytest.raises(Stop):
        smc.run_smc(setup, 1, cfg, seed=2, batched=True,
                    checkpoint=stop_at(3, mono))
    assert _same_states(mono['states'], resumed['states'])
    assert mono['logz'] == resumed['logz']


@pytest.mark.parametrize('K', PROBE_KS)
def test_lattice_division_changes_no_bit(cuda_device, K):
    # the lattice probe: every corner of chip_smoke's probe cases on the
    # series (|rho| >= 0.925, far tails included) through the kernel's
    # exact division is bitwise the same corner through the IEEE division,
    # as block_build and as block_bwd compute it; every case's corners
    # (every Genz tier) are probed
    Dp, mu = probe_cases(K, cuda_device)
    counts = day_kernel.lattice_probe(Dp, mu, PROBE_CELL, K)
    assert counts['corners'] == Dp.shape[0] * (2 * K + 2) ** 2
    assert counts['differ'] == 0, counts


@pytest.mark.parametrize('G', [6, 12, 20])
@pytest.mark.parametrize('K', PROBE_KS)
def test_low_branch_corners_hold_the_f64_twin(cuda_device, K, G):
    # every low-branch corner of chip_smoke's probe cases in the G-node
    # tier (far tails included), as block_build computes it, against the
    # float64 twin of the plain op from the kernel's own f32 inputs.  The
    # bound (chip_smoke.low_corner_gap): each node term within (|x2| + 6)
    # 2^-23 of itself, x2 the base-2 exponent, which is the CPU bound of
    # test_torch_lattice_division (|x2| 2^-23 + 4 ulp, the exponent's three
    # roundings and a correctly rounded exp2) plus the 2 ulp of
    # ex2.approx; the whole term where it flushes (x2 < -125); then one f32
    # rounding for each add, the closing multiply and the phi product
    from parasitoids_tpu_torch.ops.bvn import genz_branch
    Dp, mu = probe_cases(K, cuda_device)
    tier = torch.tensor([genz_branch(abs(r)) == (6, 12, 20).index(G)
                         for r in Dp[:, 2].tolist()], device=cuda_device)
    Dp, mu = Dp[tier], mu[tier]
    assert Dp.shape[0] > 0
    out = day_kernel.lattice_probe(Dp, mu, PROBE_CELL, K)
    q = day_kernel._pack_constants(Dp, PROBE_CELL, cuda_device).cpu().numpy()
    lat, edges = out['lattice'].cpu().numpy(), out['edges'].cpu().numpy()
    worst = [0.0, 0.0]
    for i in range(Dp.shape[0]):
        gap, bound = low_corner_gap(lat[i], edges[i], q[i], G)
        assert (gap <= bound).all(), (i, Dp[i].tolist(), mu[i].tolist(),
                                      float((gap / bound).max()))
        seen = np.abs(lat[i]) >= 1e-8          # the sparsity floor
        worst = [max(worst[0], float((gap / bound).max())),
                 max(worst[1], float((gap / bound)[seen].max()))]
    print('K = {}, {} nodes: {} cases, largest gap / bound {:.4g} ({:.4g} '
          'where the corner reaches 1e-8)'.format(K, G, Dp.shape[0],
                                                  *worst))


# ----------------------------------------------------------------------
# the evaluation replayed as CUDA graphs (utils/graphs.py), 101^2 and 18
# days: each replay bitwise its eager run
# ----------------------------------------------------------------------

_GRAPH_OV = ('domain_info=(10000.0,50)', 'interp_num=2', 'kernel_rad=6',
             'kernel_rad_local=3')


def _graph_setups(device):
    """A setup on the card (its forward replays graphs) and a shallow copy
    of it that runs the eager path."""
    import copy
    from parasitoids_tpu_torch.bayes import map_fit as tm
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    setup = BayesSetup(tm.map_cli_params(_GRAPH_OV), device=device)
    eager = copy.copy(setup)
    eager._replays_graphs = lambda: False
    assert setup._replays_graphs() and setup.ndays == 18
    return setup, eager


def _graph_flat(proj):
    return torch.cat([p.reshape(-1) for p in (*proj[0], *proj[1], proj[2])])


def _graph_value_and_grad(setup, z, use_sprd=True):
    from parasitoids_tpu_torch.bayes import map_fit as tm
    neg, _, _ = tm._make_objective(setup, use_sprd)
    z = z.clone().requires_grad_()
    v = neg(z)
    v.backward()
    return v.detach(), z.grad


def test_graph_replay_is_bitwise_eager_without_gradient(cuda_device):
    # two parameter sets in a row (a stale captured input fails), then the
    # first again
    from parasitoids_tpu_torch.bayes import map_fit as tm
    from parasitoids_tpu_torch.bayes.model import _as_model
    setup, eager = _graph_setups(cuda_device)
    _, constrain, _ = tm._make_objective(setup, True)
    z0 = tm.initial_z(setup, True)
    outs = []
    for z in (z0, z0 + 0.01, z0):
        m, _, sprd = constrain(z)
        with torch.no_grad():
            got = _graph_flat(setup.forward_projections(_as_model(m), sprd))
            want = _graph_flat(eager.forward_projections(_as_model(m), sprd))
        assert torch.equal(got, want)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert len(setup.graphs.entries) == 1


def test_graph_replay_is_bitwise_eager_with_gradient(cuda_device):
    # the projections and every gradient component, two parameter sets
    from parasitoids_tpu_torch.bayes import map_fit as tm
    from parasitoids_tpu_torch.bayes.model import _as_model
    setup, eager = _graph_setups(cuda_device)
    _, constrain, _ = tm._make_objective(setup, True)
    z0 = tm.initial_z(setup, True)
    for z in (z0, z0 - 0.02):
        (va, ga), (vb, gb) = [_graph_value_and_grad(s, z)
                              for s in (setup, eager)]
        assert torch.equal(va, vb) and torch.equal(ga, gb)
        assert bool(torch.isfinite(ga).all()) and float(ga.abs().max()) > 0
        proj, grad = [], []
        for s in (setup, eager):
            zz = z.clone().requires_grad_()
            m, _, sprd = constrain(zz)
            p = _graph_flat(s.forward_projections(_as_model(m), sprd))
            proj.append(p.detach())
            grad.append(torch.autograd.grad(p.sum(), zz)[0])
        assert torch.equal(proj[0], proj[1]) and torch.equal(*grad)


def test_graph_replay_batched_is_bitwise_eager(cuda_device):
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.bayes.priors import sample_prior_model
    setup, eager = _graph_setups(cuda_device)
    bs, be = setup.with_batched_bvn(), eager.with_batched_bvn()
    for seed in (18, 19):
        m = _as_model(sample_prior_model(torch.Generator().manual_seed(seed),
                                         4).to(cuda_device))
        for sprd in (None, 0.3):
            with torch.no_grad():
                got = bs.forward_projections(m, sprd)
                want = be.forward_projections(m, sprd)
            assert got[2].shape[0] == 4
            assert torch.equal(_graph_flat(got), _graph_flat(want))
    assert len(setup.graphs.entries) == 2


def test_graph_results_survive_the_next_replay(cuda_device):
    # a result is a clone: the next replay leaves it as it was
    from parasitoids_tpu_torch.bayes import map_fit as tm
    from parasitoids_tpu_torch.bayes.model import _as_model
    setup, _ = _graph_setups(cuda_device)
    _, constrain, _ = tm._make_objective(setup, True)
    z0 = tm.initial_z(setup, True)
    with torch.no_grad():
        m0, _, s0 = constrain(z0)
        m1, _, s1 = constrain(z0 + 0.01)
        first = setup.forward_projections(_as_model(m0), s0)
        kept = _graph_flat(first).clone()
        second = setup.forward_projections(_as_model(m1), s1)
    torch.cuda.synchronize()
    assert torch.equal(_graph_flat(first), kept)
    assert not torch.equal(_graph_flat(second), kept)
    v0, g0 = _graph_value_and_grad(setup, z0)
    g_kept = g0.clone()
    _graph_value_and_grad(setup, z0 + 0.01)
    torch.cuda.synchronize()
    assert torch.equal(g0, g_kept)


def test_graph_replay_counts_18_launches(cuda_device):
    # a replay adds the launches it holds (the capture's own do not count):
    # 18 K1 a forward, 18 K3 a backward
    from parasitoids_tpu_torch.bayes import map_fit as tm
    from parasitoids_tpu_torch.bayes.model import _as_model
    setup, _ = _graph_setups(cuda_device)
    _, constrain, _ = tm._make_objective(setup, True)
    z0 = tm.initial_z(setup, True)
    for _ in range(2):               # the first evaluation captures
        before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        with torch.no_grad():
            m, _, sprd = constrain(z0)
            setup.forward_projections(_as_model(m), sprd)
        assert (day_kernel.LAUNCHES - before[0],
                day_kernel.LAUNCHES_BWD - before[1]) == (18, 0)
    for _ in range(2):
        before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        _graph_value_and_grad(setup, z0)
        assert (day_kernel.LAUNCHES - before[0],
                day_kernel.LAUNCHES_BWD - before[1]) == (18, 18)
    assert len(setup.graphs.entries) == 2


def test_graph_backward_after_another_replay_raises(cuda_device):
    # a gradient graph's backward reads its forward's memory: after a
    # second forward replay of the same key the first backward raises
    from parasitoids_tpu_torch.bayes import map_fit as tm
    setup, _ = _graph_setups(cuda_device)
    neg, _, _ = tm._make_objective(setup, True)
    z0 = tm.initial_z(setup, True)
    _graph_value_and_grad(setup, z0)                  # captures
    za = z0.clone().requires_grad_()
    zb = (z0 + 0.01).requires_grad_()
    va, vb = neg(za), neg(zb)
    vb.backward()
    with pytest.raises(RuntimeError, match='captured graph'):
        va.backward()


def test_graph_capture_failure_raises_and_runs_nothing_eagerly(
        cuda_device, monkeypatch):
    # a host read inside the captured region fails the capture: the
    # evaluation raises, no graph is kept and no launch is counted
    from parasitoids_tpu_torch.bayes import map_fit as tm
    from parasitoids_tpu_torch.bayes import model as tmodel
    from parasitoids_tpu_torch.bayes.model import _as_model
    setup, _ = _graph_setups(cuda_device)
    real = tmodel.propagate_pop

    def reads_the_card(kernels, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            float(kernels.sum())
        return real(kernels, *a, **k)

    monkeypatch.setattr(tmodel, 'propagate_pop', reads_the_card)
    _, constrain, _ = tm._make_objective(setup, False)
    m, _, _ = constrain(tm.initial_z(setup, False))
    before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
    with torch.no_grad(), pytest.raises(RuntimeError):
        setup.forward_projections(_as_model(m))
    torch.cuda.synchronize()
    assert (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD) == before
    assert not setup.graphs.entries


# ----------------------------------------------------------------------
# a forecast member's fields replayed as a CUDA graph
# (BayesSetup.population_fields, parallel/ensemble.ensemble_fields), at
# the small configuration: each replay bitwise the eager member
# ----------------------------------------------------------------------

def _members(device):
    """Three prior draws, the first and last at flight |rho| 0.1 and 0.12
    (Genz tier 0), the second at 0.5 (tier 1), all at local rho 0."""
    from parasitoids_tpu_torch.bayes.priors import sample_prior_model
    th = sample_prior_model(torch.Generator().manual_seed(16), 3)
    th[:, 8] = torch.tensor([0.55, 0.75, 0.56])      # rho = 2 corr_p - 1
    th[:, 11] = 0.5
    return th.to(device)


def _field_keys(setup):
    return [k[0] for k in setup.graphs.entries if k[0][0] == 'fields']


def test_fields_replay_is_bitwise_eager(cuda_device):
    # members of two Genz keys, all days and a subset of them: every
    # replayed member bitwise the eager member, one graph a key
    from parasitoids_tpu_torch.parallel import ensemble
    setup, eager = _graph_setups(cuda_device)
    th = _members(cuda_device)
    full = None
    for days in (None, (17, 0, 5)):
        with torch.no_grad():
            got = ensemble.ensemble_fields(setup, th, days=days)
            want = ensemble.ensemble_fields(eager, th, days=days)
        assert torch.equal(got, want)
        if days is None:
            full = got
        else:
            assert torch.equal(got, full[:, list(days)])
    assert float(full.sum()) > 0 and not torch.equal(full[0], full[2])
    assert sorted((k[1], k[2] or ()) for k in _field_keys(setup)) == [
        ((0, 0), ()), ((0, 0), (17, 0, 5)), ((1, 0), ()),
        ((1, 0), (17, 0, 5))]


def test_fields_survive_the_next_member(cuda_device):
    # a member's fields are a clone: the next member of the same key,
    # replayed into the same graph memory, leaves them as they were
    from parasitoids_tpu_torch.bayes.model import _as_model
    setup, _ = _graph_setups(cuda_device)
    th = _members(cuda_device)
    with torch.no_grad():
        first = setup.population_fields(_as_model(th[0]))
        kept = first.clone()
        second = setup.population_fields(_as_model(th[2]))
        third = setup.population_fields(_as_model(th[0]))
    torch.cuda.synchronize()
    assert len(setup.graphs.entries) == 1
    assert torch.equal(first, kept) and torch.equal(third, kept)
    assert not torch.equal(second, kept)


def test_members_of_one_key_capture_once(cuda_device):
    # N members of one key: one capture, N replays, and 18 day launches
    # counted a member as an eager member counts them
    from parasitoids_tpu_torch.parallel import ensemble
    from parasitoids_tpu_torch.utils import trace
    setup, _ = _graph_setups(cuda_device)
    th = _members(cuda_device)[[0, 2, 0, 2, 0]]
    before = day_kernel.LAUNCHES
    trace.clear()
    trace.enable()
    try:
        with torch.no_grad():
            ensemble.ensemble_fields(setup, th)
        torch.cuda.synchronize()
    finally:
        trace.disable()
    names = [r.name for r in trace.records()]
    trace.clear()
    assert len(setup.graphs.entries) == 1
    assert names.count('graphs.capture') == 1
    assert names.count('graphs.replay') == 5
    assert names.count('ensemble.member') == 5
    assert day_kernel.LAUNCHES - before == 5 * 18
    (_, capture_s, pool_bytes), = setup.graphs.summary()
    assert capture_s > 0 and pool_bytes > 0


@pytest.mark.parametrize('lead', [(), (4,)])
def test_propagate_pop_one_release_day_is_the_cohort_loop_on_the_card(
        cuda_device, lead):
    # at 801² with the solver's pad, one release day gives the cohort
    # loop's bits on the card (cuFFT's plans included), and five release
    # days its populations within the CPU parity tolerance
    from parasitoids_tpu_torch.models import solver
    from tests._torch_parity import cohort_loop
    rng = np.random.default_rng(21)
    k = np.zeros(lead + (18, 801, 801), np.float32)
    k[..., 380:421, 370:431] = rng.uniform(0, 1, lead + (18, 41, 61))
    k = torch.from_numpy(k / k.sum(axis=(-2, -1), keepdims=True)).to(
        cuda_device)
    cfg = solver.SolverConfig.for_domain(400)
    one = torch.ones(1, device=cuda_device)
    w5 = torch.full((5,), 0.2, device=cuda_device)
    with torch.no_grad():
        assert torch.equal(solver.propagate_pop(k, 1, 130000.0, one, cfg),
                           cohort_loop(k, 1, 130000.0, one, cfg))
        got = solver.propagate_pop(k, 5, 40000.0, w5, cfg)
        want = cohort_loop(k, 5, 40000.0, w5, cfg)
    assert (got - want).abs().max().item() <= 40000.0 * 2e-6


# ----------------------------------------------------------------------
# the AM observation sweep replayed as a CUDA graph
# (bayes/sampler._obs_sweep_graphed), at the small configuration: each
# replay bitwise the eager loop
# ----------------------------------------------------------------------

def _sweep_args(setup, state, n, seed):
    """One sweep's arguments from ``state`` (its observation block, prior,
    likelihood and projections), or ``n`` particles stacked around it
    (their blocks jittered by 5%), and a sweep's draws, from ``seed``."""
    from parasitoids_tpu_torch.bayes import sampler
    from parasitoids_tpu_torch.bayes.priors import log_prior_obs
    dev = state.o.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    o, proj, lead = state.o, state.proj, ()
    if n:
        lead = (n,)
        o = o * (1.0 + 0.05 * torch.randn(lead + o.shape, generator=gen,
                                          device=dev))
        proj = (tuple(torch.stack([p] * n) for p in proj[0]),
                tuple(torch.stack([p] * n) for p in proj[1]),
                torch.stack([proj[2]] * n))
    obs_o = sampler._as_obs(o, setup.n_sent)
    with torch.no_grad():
        prior_o = log_prior_obs(obs_o, setup.field_areas,
                                setup.min_field_area, setup.obs_model)
        ll = setup.log_likelihood(proj, obs_o)
    shape = lead + (sampler._n_obs(setup),)
    return (torch.randn(shape, generator=gen, device=dev),
            torch.log(torch.rand(shape, generator=gen, device=dev)),
            o, prior_o, ll, proj)


def _sweep_start(setup):
    from parasitoids_tpu_torch.bayes import sampler
    return sampler.init_chain_state(
        setup, sampler.chain_generator(0, 0, setup.setup.wind_flat.device))


def _sweep_keys(setup):
    return [k for k in setup.graphs.entries if k[0][0] == 'obs_sweep']


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('n, beta', [(0, 1.0), (0, 0.5), (8, 1.0)],
                         ids=['chain', 'tempered', 'stacked8'])
def test_sweep_graph_is_bitwise_eager(cuda_device, n, beta):
    # two sets of inputs in a row (a stale captured input fails), then the
    # first again: every replay gives the eager loop's bits
    from parasitoids_tpu_torch.bayes import sampler
    setup = _am_setup(cuda_device)
    state = _sweep_start(setup)
    cfg = sampler.MCMCConfig(1)
    outs = []
    with torch.no_grad():
        for seed in (1, 2, 1):
            args = _sweep_args(setup, state, n, seed)
            got = sampler._obs_sweep(setup, *args, beta, cfg)
            assert _equal(got, sampler._obs_sweep_eager(setup, *args, beta,
                                                        cfg))
            assert bool((got[3] > 0).all())
            outs.append(got)
    assert not _equal(outs[0], outs[1]) and _equal(outs[0], outs[2])
    assert len(_sweep_keys(setup)) == 1


def test_sweep_graph_copies_replay_their_own_data(cuda_device):
    # a setup, its with_observations copy and its with_held_out copy share
    # one GraphCache; interleaved, each replay scores its own data and mask
    from parasitoids_tpu_torch.bayes import sampler
    setup = _am_setup(cuda_device)
    other = {'release': [a.cpu().numpy() + 1 for a in setup.obs_release],
             'sentinel': [a.cpu().numpy() + 1 for a in setup.obs_sentinel],
             'grid': setup.obs_grid.cpu().numpy() + 1}
    n_points = sum(int(a.numel()) for a in (
        *setup.obs_release, *setup.obs_sentinel, setup.obs_grid))
    keep = np.random.default_rng(2).random(n_points) < 0.7
    copies = [setup, setup.with_observations(other),
              setup.with_held_out(keep)]
    assert all(c.graphs is setup.graphs for c in copies)
    state = _sweep_start(setup)
    cfg = sampler.MCMCConfig(1)
    with torch.no_grad():
        for seed in (1, 2, 3):
            args = _sweep_args(setup, state, 0, seed)
            wants = []
            for c in copies:
                got = sampler._obs_sweep(c, *args, 1.0, cfg)
                wants.append(sampler._obs_sweep_eager(c, *args, 1.0, cfg))
                assert _equal(got, wants[-1])
            assert not _equal(wants[0], wants[1])
            assert not _equal(wants[0], wants[2])
    assert len(_sweep_keys(setup)) == 2          # unmasked and masked


def test_sweep_replay_never_waits_and_a_chain_is_bitwise_eager(cuda_device):
    # 12 AM steps through the forward's and the sweep's graphs give the
    # eager copy's trace bit for bit; a replay makes no synchronizing call
    import copy
    from parasitoids_tpu_torch.bayes import sampler
    setup = _am_setup(cuda_device)
    eager = copy.copy(setup)
    eager._replays_graphs = lambda: False
    traces = []
    for s in (setup, eager):
        state, tr = sampler.run_mcmc(s, _sweep_start(s),
                                     sampler.MCMCConfig(12))
        traces.append(tr)
    assert torch.equal(*traces) and bool(torch.isfinite(traces[0]).all())
    assert len(_sweep_keys(setup)) == 1
    args = _sweep_args(setup, state, 0, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        with torch.no_grad():
            sampler._obs_sweep(setup, *args, 0.5, sampler.MCMCConfig(1))
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert len(_sweep_keys(setup)) == 1          # it replayed


def test_sweep_replays_count_every_sweep_after_the_capture(cuda_device):
    # the first sweep captures; every later one is a replay
    from parasitoids_tpu_torch.bayes import sampler
    setup = _am_setup(cuda_device)
    state = _sweep_start(setup)
    counts = []
    for _ in range(2):
        before = (sampler.SWEEPS, sampler.SWEEP_REPLAYS)
        state, _ = sampler.run_mcmc(setup, state, sampler.MCMCConfig(5))
        counts.append((sampler.SWEEPS - before[0],
                       sampler.SWEEP_REPLAYS - before[1]))
    assert counts == [(5, 4), (5, 5)]
    (_, _, pool_bytes), = [e for e in setup.graphs.summary()
                           if e[0][0][0] == 'obs_sweep']
    assert pool_bytes > 0

# ----------------------------------------------------------------------
# spans on the card (utils/trace.py)
# ----------------------------------------------------------------------

def test_graph_replay_spans_and_the_backward_on_autograds_thread(
        cuda_device):
    # a graphed value+gradient records its replay on the caller's thread
    # and its backward's replay on autograd's device thread, both in the
    # request; the capture's span is its capture_s
    import threading
    from parasitoids_tpu_torch.utils import trace
    setup, _ = _graph_setups(cuda_device)
    from parasitoids_tpu_torch.bayes import map_fit as tm
    z0 = tm.initial_z(setup, True)
    trace.clear()
    trace.enable()
    try:
        for _ in range(2):               # the first evaluation captures
            with trace.span('request', request=True):
                _graph_value_and_grad(setup, z0)
        torch.cuda.synchronize()
    finally:
        trace.disable()
    recs = trace.records()
    trace.clear()
    named = {}
    for r in recs:
        named.setdefault(r.name, []).append(r)
    cap, = named['graphs.capture']
    entry, = setup.graphs.entries.values()
    assert cap.seconds == pytest.approx(entry.capture_s, rel=1e-12)
    replays, bwds = named['graphs.replay'], named['graphs.replay_bwd']
    assert len(replays) == len(bwds) == 2
    me = threading.get_ident()
    reqs = [r.request for r in named['request']]
    assert len(set(reqs)) == 2
    for rep, bwd, req in zip(replays, bwds, reqs):
        assert rep.thread == me and rep.request == req
        assert bwd.thread != me and bwd.request == req
        assert bwd.start >= rep.end


def test_profiled_propagation_span_has_device_time(cuda_device):
    # in an eager forward the operations launched inside solver.propagate
    # (found through the profiler's launch-to-kernel link) took device time
    from torch.profiler import ProfilerActivity, profile
    from parasitoids_tpu_torch.bayes import map_fit as tm
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.utils import trace
    _, eager = _graph_setups(cuda_device)
    _, constrain, _ = tm._make_objective(eager, False)
    m, _, _ = constrain(tm.initial_z(eager, False))
    with torch.no_grad():
        eager.forward_projections(_as_model(m))      # warm
        torch.cuda.synchronize()
        trace.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eager.forward_projections(_as_model(m))
                torch.cuda.synchronize()
        finally:
            trace.disable()
            trace.clear()
    from torch.autograd import DeviceType
    events = list(prof.events())
    # the span as a host event (the profiler adds a device-side
    # annotation of the same name)
    spans = [e for e in events if e.name == 'solver.propagate' and
             e.device_type == DeviceType.CPU]
    assert len(spans) == 1

    def under(e):
        while e is not None:
            if e.name == 'solver.propagate':
                return True
            e = e.cpu_parent
        return False
    device_us = sum(k.duration for e in events if under(e)
                    for k in e.kernels)
    assert device_us > 0

"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA day kernels from ``parasitoids_tpu_torch/csrc``, holds the
forward (K1/K2) against its plain torch twin on real Kalbar days at the
headline shapes (D = 801, T = 1440, K = 44), reproduces the checked-in
goldens through the kernel, then drives the forward main path — the CLI
population run at the Kalbar default and ``forward_fields`` at the
prior-coverage windows — and checks that every simulation went through the
kernel once per day.  Then the gradient path: the backward kernel (K3/K4)
against its plain twin at the headline shapes and at K = 88, the gradient
of the log posterior at the Bayes default (801²) through the kernels and
through the plain path, and the MAP CLI at its default (401²) with its
value and gradient held against a JAX golden.  Then the sampling path: the
adaptive-Metropolis CLI at the Bayes default (801², two chains, a
checkpoint, a resume), with the forward kernel's launches held to 18 per
forward simulation the chains ran, exact resume on the card, the host
reads of a step counted, and seconds per AM step.  Then the NUTS command
line at the Bayes default (two chains from a short MAP fit), with both
kernels' launches held to 18 per value+gradient, its target held against
the plain path, an interrupted chain resumed bit for bit, the host reads
of a transition counted, and seconds per leapfrog and per transition.  Any
failed phase exits non-zero.  The last line is a JSON object with ``"ok": true`` and the
device; the line before it lists the kernels with their launches, errors,
times (the forward's three passes and the backward's two launches also
timed alone, with CUDA events around the kernels) and bounds, the least
time the card could take for the same work from this run's inputs.  Needs
one CUDA device; imports nothing of JAX or of the JAX package, and checks
that.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')
BUF_TOL, HI_TOL = 2e-6, 3e-6      # atol of test_pallas_kernel.py: upper bounds
# kernel vs plain on the card, set from sound readings at the headline
# shapes on an H100 (largest seen: 4.3e-9 absolute, 1.14e-5 of the buffer
# peak, which lies between 1.7e-4 and 7.3e-4): f32 operation-order noise.
# A weight or scale error of 1e-4 relative breaks both limits.
ABS_LIMIT = 1e-8                  # max |kernel - plain|, buffer and loss
REL_LIMIT = 3e-5                  # max |kernel - plain| / buffer peak


# K3/K4 vs the plain backward on the card: each output within its own
# atol + BWD_RTOL * scale, scale its largest magnitude (ct_loss·h for
# dclip).  Sound readings at the headline shapes on an H100 (days 0/9/17,
# seven rho): dh within 2.3e-5 of its scale (its error is relative, so no
# atol); the largest absolute errors of the others are dmu 4.1e-11, dclip
# 3.5e-9, dsig 4.4e-10, drho 2.8e-8 where |drho| is small (up to 8.3e-7 at
# |drho| 0.29, inside the rtol) and dcell 3.9e-9.  The four shared sums
# cancel over 1,440 minutes, so their error is absolute: f32
# summation-order noise.  Each atol is about ten times its reading.
BWD_RTOL = 2e-4
BWD_ATOL = {'dh': 0.0, 'dmu': 5e-10, 'dclip': 4e-8, 'dsig_x': 5e-9,
            'dsig_y': 5e-9, 'drho': 3e-7, 'dcell': 4e-8}
# log-posterior gradient, kernels vs the plain path at 801² (sound
# readings on an H100: value equal, gradient relative L2 7.4e-7 at most,
# each component within 6.3e-5 of its magnitude), and the MAP value and
# gradient at 401² against the JAX golden (readings 4.7e-7, 2.3e-6, each
# component within 1.9e-6 of the largest), each limit about ten times its
# reading; a component that is 0 (n_periods is pinned) must stay 0 to
# 1e-8 of the largest
GRAD_VALUE_RTOL, GRAD_L2_LIMIT = 1e-6, 1e-5
GRAD_COMP_RTOL, GRAD_COMP_ATOL = 1e-3, 1e-8
GOLDEN_VALUE_RTOL, GOLDEN_L2_LIMIT = 5e-6, 3e-5
GOLDEN_COMP_LIMIT = 2e-5          # max |dg_i| / max |g|
GRAD_GOLDEN = os.path.join(ROOT, 'tests', 'torch_golden',
                           'map_grad_401.npz')
# the AM chain's initial log likelihood at 801² (no pre-spread day) through
# K1 against the plain path run in f64.  One observation's expected count
# of 0.02 is f32 roundoff of the propagation to 0.3-0.5% in either f32
# path, so two f32 values stand further apart than each stands from f64
# (readings on an H100: K1 1.6e-6 of the value from f64, the f32 plain path
# 5.6e-6 and changing from run to run with its atomic adds)
AM_LOGLIK_RTOL = 1e-5
# the NUTS target at 801² at the MAP start (10 Adam steps, near the mode,
# where the gradient's largest component is 85 against 2e4 at [7]'s start)
# through the kernels against the plain path run in f64.  Readings on an
# H100: value 1.23e-6 of itself, gradient relative L2 1.01e-4, worst
# component 1.2e-4 of the largest; the f32 plain path stands 3.9e-7 to
# 7.0e-7, 6.8e-5 to 7.7e-5 and 7.5e-5 to 8.8e-5 from f64, changing from run
# to run with its atomic adds.  Each limit about ten times its reading.
NUTS_VALUE_RTOL, NUTS_GRAD_L2_LIMIT, NUTS_GRAD_COMP_LIMIT = 1e-5, 1e-3, 1e-3


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)
    print('  ok: ' + msg)


def median_ms(fn, reps):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# The card's peak rates for the bounds: HBM3 at 3.35 TB/s and 67 TFLOP/s of
# f32 outside the tensor cores (NVIDIA's H100 SXM data sheet), and 16 exps
# (MUFU.EX2) per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0), at the card's maximum
# SM clock and SM count read in this run.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16


def sfu_rate():
    """Exps per second: SFU_PER_CLOCK_PER_SM x SMs x the maximum SM clock
    that nvidia-smi reports for this card."""
    mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,'
         'nounits'], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6


def lattice_exps(mu, Dp, cell, K):
    """The exps (an erfc counted as one) that the forward's corner lattices
    of these minutes need, counted from this run's data: every corner's
    G-node quadrature on the low-|rho| branch; on the high branch the
    series terms and tail nodes that pass their -80 cut-offs.  Plus Phi of
    each minute's 2 (2K + 2) edge coordinates.  Returns (exps, corners,
    whether the high branch ran)."""
    from parasitoids_tpu_torch.ops.bvn import genz_branch
    from parasitoids_tpu_torch.ops.day_kernel import _pack_constants
    dev = mu.device
    q = _pack_constants(Dp, cell, dev)
    m, T = 2 * K + 2, mu.shape[0]
    corners = T * m * m
    branch = genz_branch(abs(float(q[3])))
    if branch < 3:
        return corners * (6, 12, 20)[branch] + 2 * m * T, corners, False
    sig_x, sig_y, sgn, a_sq = (float(q[i]) for i in (0, 1, 4, 6))
    xs = q[16 + 3 * 38:16 + 3 * 38 + 20]
    ar = torch.arange(m, dtype=torch.float32, device=dev) - (K + 0.5)
    total = 2 * m * T
    for s in range(0, T, 120):
        mc = mu[s:s + 120]
        h = ((ar * cell)[None, :] - mc[:, :1]) / sig_x            # (t, m)
        k = sgn * ((-ar * cell)[None, :] - mc[:, 1:]) / sig_y
        h, k = h[:, None, :], k[:, :, None]                      # (t, m, m)
        hk, bs = h * k, (h - k) ** 2
        n = (-(bs / a_sq + hk) / 2 > -80).sum() + 2 * (-hk < 80).sum()
        n += 2 * (-(bs[..., None] / xs + hk[..., None]) / 2 > -80).sum()
        n += hk.numel() if sgn > 0 else 2 * (k > h).sum()
        total += int(n)
    return total, corners, True


def bound(exps, flops, nbytes, rate):
    """(bound_ms, bound_by, what): the larger of the operations' time (exps
    at the SFU rate or f32 operations at the f32 peak, whichever is longer)
    and the bytes' time at the HBM rate; `what` names the three counts."""
    ops_s = max(exps / rate, flops / F32_FLOPS_PER_S)
    bytes_s = nbytes / HBM_BYTES_PER_S
    what = '{:.4g} exps ({:.4f} ms), {:.4g} f32 ops ({:.4f} ms), {:.4g} B ' \
        '({:.4f} ms)'.format(exps, 1e3 * exps / rate, flops,
                             1e3 * flops / F32_FLOPS_PER_S, nbytes,
                             1e3 * bytes_s)
    return (1e3 * max(ops_s, bytes_s),
            'operations' if ops_s >= bytes_s else 'bytes', what)


def forward_bound(h, mu, Dp, cell, K, buf_len, rate):
    """Least time of one day's forward accumulate: its exps, about 10 f32
    operations per exp (and on the high branch 4 per tail node of every
    corner for its cut-off test), the four-corner differences and the
    scaled add (5 per cell), each input read once and the buffer written
    once."""
    exps, corners, hi = lattice_exps(mu, Dp, cell, K)
    T, n = h.shape[0], 2 * K + 1
    flops = 10 * exps + 5 * T * n * n + (80 * corners if hi else 0)
    nbytes = T * (4 + 8 + 8 + 4) + 4 * buf_len * buf_len
    return bound(exps, flops, nbytes, rate)


def backward_bound(h, mu, Dp, cell, K, buf_len, rate):
    """Least time of one day's backward: the forward's lattice exps plus
    two Phi and one exp a corner and phi, Phi of the edges; about 10 f32
    operations per exp and 20 per corner for the adjoint; the inputs and
    the cotangent buffer read once, the per-minute outputs written once."""
    exps, corners, hi = lattice_exps(mu, Dp, cell, K)
    T, m = h.shape[0], 2 * K + 2
    exps += 3 * corners + 2 * m * T
    flops = 10 * exps + 20 * corners + (80 * corners if hi else 0)
    nbytes = T * (4 + 8 + 8 + 4) + 4 * buf_len * buf_len + T * 16
    return bound(exps, flops, nbytes, rate)


def kalbar_params(pop=True):
    from parasitoids_tpu_torch.config import Params
    p = Params()
    p.cmd_line_chg(['--kalbar'] + (['--pop'] if pop else []))
    p.PLOT = p.OUTPUT = False
    return p


def phase_kernel_vs_plain(dev, card, rate):
    """K1/K2 against the plain accumulate on days 0, 9, 17 of Kalbar at
    the headline shapes, two launches bitwise equal; at day 9, the
    kernels' passes timed alone beside the wrapper, the plain version and
    the bound.  Returns (max errors, timings)."""
    from parasitoids_tpu_torch.models.forward import (prior_coverage_windows,
                                                      setup_forward)
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day,
                                                      accumulate_day_plain,
                                                      pass_ms)
    print('[3] kernel vs plain on the card (D = 801, T = 1440, K = 44)')
    p = kalbar_params()
    cell = p.domain_info[0] / p.domain_info[1]
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    s = setup_forward(p, device=dev)
    K = s.kcfg.K
    buf_len = s.scfg.dom_len + 4 * K
    check((K, s.kcfg.periods, buf_len) == (44, 1440, 977),
          'headline shapes K = 44, T = 1440, buf = 977')
    hp = (p.lam, *p.g_params, *p.f_params)
    err = {'K1': 0.0, 'K2': 0.0, 'rel': 0.0}
    timing = {}
    for day in (0, 9, 17):
        h, mu, idx, clip, _ = day_scatter_inputs(
            s.wind_flat, s.wind_cumsum, day, hp, p.mu_r, p.n_periods, 0,
            s.kcfg, s.rad_dist)
        for rho in (0.253, 0.93, -0.93, 0.99, -0.99):
            Dp = (p.Dparams[0], p.Dparams[1], rho)
            args = (h, mu, idx, clip, Dp, cell, K, buf_len)
            buf, loss = accumulate_day(*args)
            again, loss_again = accumulate_day(*args)
            want_buf, want_loss = accumulate_day_plain(*args)
            torch.cuda.synchronize()
            branch = 'K2' if abs(rho) >= 0.925 else 'K1'
            check(torch.equal(buf, again) and torch.equal(loss, loss_again),
                  'day {:2d} rho {:+.3f} ({}): two launches bitwise equal'
                  .format(day, rho, branch))
            be = float((buf - want_buf).abs().max())
            le = abs(float(loss) - float(want_loss))
            peak = float(want_buf.max())
            e, rel = max(be, le), be / peak
            tol = min(ABS_LIMIT, HI_TOL if branch == 'K2' else BUF_TOL)
            check(np.isfinite(e) and e <= tol and peak > 0 and
                  rel <= REL_LIMIT,
                  'day {:2d} rho {:+.3f} ({}): max |kernel - plain| = {:.3e}'
                  ' (buffer {:.3e}, loss {:.3e}) <= {:.0e}; / peak {:.4e} = '
                  '{:.3e} <= {:.0e}'.format(day, rho, branch, e, be, le, tol,
                                            peak, rel, REL_LIMIT))
            err[branch] = max(err[branch], e)
            err['rel'] = max(err['rel'], rel)
            if day == 9 and rho in (0.253, 0.99):
                passes = pass_ms(*args, reps=20)
                t = dict(ms=median_ms(lambda: accumulate_day(*args), 20),
                         plain_ms=median_ms(
                             lambda: accumulate_day_plain(*args), 5),
                         passes=np.median(passes, axis=0).tolist(),
                         kernel_ms=float(np.median(passes.sum(axis=1))))
                t['bound_ms'], t['bound_by'], what = forward_bound(
                    h, mu, Dp, cell, K, buf_len, rate)
                timing[branch] = t
                print('  day 9 {}: kernels {:.4f} ms (block_build {:.4f}, '
                      'gather {:.4f}, reduce {:.4f}; CUDA events around the '
                      'kernels alone, median of 20); wrapper {:.4f} ms; '
                      'plain {:.4f} ms; bound {:.4f} ms by {} ({}), '
                      'bound / kernels {:.3f} ({})'.format(
                          branch, t['kernel_ms'], *t['passes'], t['ms'],
                          t['plain_ms'], t['bound_ms'], t['bound_by'], what,
                          t['bound_ms'] / t['kernel_ms'], card))
    return err, timing


def phase_goldens(dev):
    """The three checked-in goldens through the kernel, at the
    test_golden.py tolerances."""
    from parasitoids_tpu_torch.config import Params
    from parasitoids_tpu_torch.io import load_run
    from parasitoids_tpu_torch.models.forward import simulate, setup_forward
    from parasitoids_tpu_torch.ops import day_kernel
    print('[4] goldens through the kernel')
    for name, pop, site, ndays in (('kalbar_prob_tiny', False, '--kalbar', 4),
                                   ('kalbar_pop_tiny', True, '--kalbar', 4),
                                   ('carnarvon_pop_tiny', True, '--carnarvon',
                                    7)):
        want, want_days = load_run(os.path.join(GOLDEN, name), 201)
        p = Params()
        p.cmd_line_chg([site])
        p.PLOT = p.OUTPUT = False
        p.PROB_MODEL = not pop
        p.ndays, p.domain_info, p.interp_num = ndays, (4000.0, 100), 6
        p.kernel_rad, p.kernel_rad_local = 20, 6
        s = setup_forward(p, device=dev)
        check(s.kcfg.pallas, name + ': setup takes the CUDA kernel')
        before = day_kernel.LAUNCHES
        fields, days = simulate(p, s)
        got = fields.cpu().numpy()
        check(day_kernel.LAUNCHES - before == ndays,
              '{}: {} kernel launches for {} days'.format(
                  name, day_kernel.LAUNCHES - before, ndays))
        check(list(days) == list(want_days), name + ': day labels')
        scale = max(want.max(), 1e-30)
        e = float(np.abs(got - want).max() / scale)
        check(e <= 2e-5, '{}: max |port - golden| / peak = {:.3e} <= 2e-5'
              .format(name, e))
        m = float(np.max(np.abs(got.sum(axis=(1, 2)) - want.sum(axis=(1, 2)))
                         / want.sum(axis=(1, 2))))
        check(m <= 1e-4, '{}: day mass rel diff {:.3e} <= 1e-4'.format(name,
                                                                       m))
        if site == '--carnarvon':
            r = float(np.max(np.abs(got.sum(axis=(1, 2))[:3] / p.r_number
                                    - 1.0)))
            check(r <= 2e-5, '{}: release-ramp totals rel diff {:.3e} <= '
                  '2e-5'.format(name, r))


def check_pop_sums(sums, r_number, label):
    check(bool(np.isfinite(sums).all()), label + ': finite day sums')
    check(abs(sums[0] / r_number - 1.0) <= 1e-4,
          '{}: day 0 holds the release ({:.1f} of {})'.format(
              label, sums[0], r_number))
    check(bool(np.all(np.diff(sums) <= sums[:-1] * 1e-4)),
          label + ': day sums never grow')
    check(sums[-1] >= 0.95 * r_number,
          '{}: slow loss off the 10 km domain, last day {:.1f} ({:.2%} '
          'lost)'.format(label, sums[-1], 1 - sums[-1] / r_number))


def phase_main_path(dev, card):
    """The CLI run, forward_fields at the bench config, and the prob model,
    with every kernel count zeroed just before and read just after."""
    from parasitoids_tpu_torch import cli
    from parasitoids_tpu_torch.models.forward import (forward_fields,
                                                      prior_coverage_windows,
                                                      setup_forward, simulate)
    from parasitoids_tpu_torch.ops import day_kernel
    print('[5] main path')
    day_kernel.LAUNCHES = 0

    # the CLI at the Kalbar default (801^2, 18 days, auto K)
    before = day_kernel.LAUNCHES
    fields, days = cli.main(argv=['--pop', '--no_plot', '--no_output'],
                            device=dev)
    nd = len(days)
    check(day_kernel.LAUNCHES - before == nd,
          'CLI: {} kernel launches for {} days'.format(
              day_kernel.LAUNCHES - before, nd))
    check(tuple(fields.shape) == (nd, 801, 801) and nd == 18,
          'CLI: fields {}'.format(tuple(fields.shape)))
    check_pop_sums(fields.sum(dim=(1, 2)).double().cpu().numpy(), 130000,
                   'CLI')

    # forward_fields at the prior-coverage windows (K = 44, Kl = 20)
    p = kalbar_params()
    cell = p.domain_info[0] / p.domain_info[1]
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    s = setup_forward(p, device=dev)
    hp = (p.lam, *p.g_params, *p.f_params)
    w = torch.as_tensor(s.dist_weights, dtype=torch.float32).to(dev)

    def run():
        return forward_fields(s.wind_flat, s.wind_cumsum, hp, p.Dparams,
                              p.Dlparams, p.mu_r, p.n_periods, s.rad_dist,
                              s.start_idx, float(p.r_number), w, s.kcfg,
                              s.scfg, s.ndays, int(p.r_dur), False)

    secs = []
    for i in range(4):          # one warm-up, three timed
        before = day_kernel.LAUNCHES
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        per_sim = day_kernel.LAUNCHES - before
        if i:
            secs.append(time.perf_counter() - tic)
            check(per_sim == s.ndays,
                  'forward_fields run {}: {} launches for {} days'.format(
                      i, per_sim, s.ndays))
    check_pop_sums(out.sum(dim=(1, 2)).double().cpu().numpy(), p.r_number,
                   'forward_fields K = 44')
    sec = float(np.median(secs))
    print('  forward_fields (pop, 801^2, 18 days, K = 44, Kl = 20): '
          '{:.4f} s/simulation, {:.1f} simulations/hr (median of 3; {})'
          .format(sec, 3600.0 / sec, card))

    # the probability model at the Kalbar default
    pp = kalbar_params(pop=False)
    before = day_kernel.LAUNCHES
    fields, days = simulate(pp, device=dev)
    check(day_kernel.LAUNCHES - before == len(days),
          'prob model: {} launches for {} days'.format(
              day_kernel.LAUNCHES - before, len(days)))
    sums = fields.sum(dim=(1, 2)).double().cpu().numpy()
    check(bool(np.isfinite(fields.cpu().numpy()).all()) and
          bool(np.all(np.abs(sums - 1.0) <= 1e-4)),
          'prob model: every day sums to 1 +- 1e-4 (worst {:.2e})'.format(
              float(np.abs(sums - 1.0).max())))
    return day_kernel.LAUNCHES, sec, per_sim


BWD_NAMES = ('dh', 'dmu', 'dclip', 'dsig_x', 'dsig_y', 'drho', 'dcell')


def backward_outputs(out):
    dh, dmu, dclip, dD, dcell = out
    return [dh, dmu, dclip, *dD, dcell]


def backward_vs_plain(args, label, f64=False):
    """One backward through the kernel, twice, and through the plain
    version: the launches bitwise equal and every output within its atol
    + BWD_RTOL * scale.  With ``f64`` the plain version runs in f64 on the
    same f32 inputs, and the distance of the f32 plain version from it is
    printed beside the kernel's.  Returns (worst error over scale, worst
    absolute error)."""
    from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day_bwd,
                                                      accumulate_day_bwd_plain)
    got = accumulate_day_bwd(*args)
    again = accumulate_day_bwd(*args)
    plain = accumulate_day_bwd_plain(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          label + ': two launches bitwise equal')
    got, want = backward_outputs(got), backward_outputs(plain)
    if f64:
        ct_buf, ct_loss, h, mu, idx, clip, Dp, cell, K, buf_len = args
        up = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                       device=h.device).double()
        want = backward_outputs(accumulate_day_bwd_plain(
            up(ct_buf), up(ct_loss), up(h), up(mu), idx, up(clip), up(Dp),
            up(cell), K, buf_len))
    scales = [float(w.abs().max()) for w in want]
    scales[2] = float((args[1] * args[2]).abs().max())      # ct_loss * h
    errs = []
    for name, g, w, sc in zip(BWD_NAMES, got, want, scales):
        e = float((g - w).abs().max())
        errs.append((name, e, e / max(sc, 1e-30),
                     e <= BWD_ATOL[name] + BWD_RTOL * sc))
    ok = all(np.isfinite(e) and inside for _, e, _, inside in errs)
    ref = 'f64 plain' if f64 else 'plain'
    msg = '{}: every output within its atol + {:.0e} * scale; |kernel - ' \
        '{}| (/ scale): {}'.format(
            label, BWD_RTOL, ref, ', '.join(
                '{} {:.2e} ({:.2e})'.format(n, e, r) for n, e, r, _ in errs))
    if f64:
        msg += '; |f32 plain - f64 plain| (/ scale): ' + ', '.join(
            '{} {:.2e} ({:.2e})'.format(
                n, float((p - w).abs().max()),
                float((p - w).abs().max()) / max(sc, 1e-30))
            for n, p, w, sc in zip(BWD_NAMES, backward_outputs(plain), want,
                                   scales))
    check(ok, msg)
    return max(r for _, _, r, _ in errs), max(e for _, e, _, _ in errs)


def phase_backward_vs_plain(dev, card, rate):
    """K3/K4 against the plain backward on days 0, 9, 17 of Kalbar at the
    headline shapes, a seeded white-noise cotangent, two launches bitwise
    equal; at day 9, the two launches timed alone beside the wrapper, the
    plain version and the bound; then one day at K = 88 (12.5 m cells),
    wider than any lattice that fits shared memory whole, against the
    plain version run in f64.  A cell of the block is a difference of four
    lattice values of order 1, so its f32 rounding is about 1e-7 whatever
    the cell's mass (1e-3 at most at K = 88), in the kernel and in the f32
    plain version alike; white noise contracts that rounding over 177²
    cells into dh, and two f32 results then stand a whole BWD_RTOL apart
    while each is nearer to f64: the f64 reference leaves the limit to the
    kernel alone.  Returns (worst error over scale, abs error, timings)."""
    from parasitoids_tpu_torch.models.forward import (prior_coverage_windows,
                                                      setup_forward)
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day_bwd,
                                                      accumulate_day_bwd_plain,
                                                      pass_ms_bwd)
    print('[6] backward kernel vs plain on the card (D = 801, T = 1440, '
          'K = 44)')
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {'K3': 0.0, 'K4': 0.0}
    worst_abs = {'K3': 0.0, 'K4': 0.0}
    timing = {}
    for rad_res, days, rhos in ((400, (0, 9, 17), (0.253, 0.5, 0.8, 0.93,
                                                   -0.93, 0.99, -0.99)),
                                (800, (9,), (0.253,))):
        p = kalbar_params()
        p.domain_info = (p.domain_info[0], rad_res)
        cell = p.domain_info[0] / rad_res
        p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
        s = setup_forward(p, device=dev)
        K = s.kcfg.K
        buf_len = s.scfg.dom_len + 4 * K
        check((K, s.kcfg.periods, buf_len) == {400: (44, 1440, 977),
                                               800: (88, 1440, 1953)}[rad_res],
              'cells of {} m: K = {}, T = {}, buf = {}'.format(
                  cell, K, s.kcfg.periods, buf_len))
        hp = (p.lam, *p.g_params, *p.f_params)
        ct_buf = torch.randn((buf_len, buf_len), generator=gen, device=dev)
        ct_loss = torch.randn((), generator=gen, device=dev)
        for day in days:
            h, mu, idx, clip, _ = day_scatter_inputs(
                s.wind_flat, s.wind_cumsum, day, hp, p.mu_r, p.n_periods, 0,
                s.kcfg, s.rad_dist)
            for rho in rhos:
                Dp = (p.Dparams[0], p.Dparams[1], rho)
                args = (ct_buf, ct_loss, h, mu, idx, clip, Dp, cell, K,
                        buf_len)
                branch = 'K4' if abs(rho) >= 0.925 else 'K3'
                rel, err = backward_vs_plain(
                    args, 'K = {} day {:2d} rho {:+.3f} ({})'.format(
                        K, day, rho, branch), f64=K != 44)
                worst[branch] = max(worst[branch], rel)
                worst_abs[branch] = max(worst_abs[branch], err)
                if K != 44 or day != 9 or rho not in (0.253, 0.99):
                    continue
                passes = pass_ms_bwd(*args, reps=20)
                t = dict(ms=median_ms(lambda: accumulate_day_bwd(*args), 20),
                         plain_ms=median_ms(
                             lambda: accumulate_day_bwd_plain(*args), 5),
                         passes=np.median(passes, axis=0).tolist(),
                         kernel_ms=float(np.median(passes.sum(axis=1))))
                t['bound_ms'], t['bound_by'], what = backward_bound(
                    h, mu, Dp, cell, K, buf_len, rate)
                timing[branch] = t
                print('  day 9 {}: kernels {:.4f} ms (block_bwd {:.4f}, '
                      'bwd_reduce {:.4f}; CUDA events around the kernels '
                      'alone, median of 20); wrapper {:.4f} ms; plain {:.4f} '
                      'ms; bound {:.4f} ms by {} ({}), bound / kernels {:.3f} '
                      '({})'.format(
                          branch, t['kernel_ms'], *t['passes'], t['ms'],
                          t['plain_ms'], t['bound_ms'], t['bound_by'], what,
                          t['bound_ms'] / t['kernel_ms'], card))
    return worst, worst_abs, timing


def value_and_grad(neg_logpost, z0):
    z = z0.clone().requires_grad_()
    v = neg_logpost(z)
    v.backward()
    return float(v.detach()), z.grad.detach().double().cpu().numpy()


def timed(fn, reps=3):
    """Median host seconds of ``fn`` (ending in a synchronize) after one
    warm-up run."""
    fn()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - tic)
    return float(np.median(secs))


def phase_posterior_gradient(dev, card):
    """Value and gradient of the log posterior at the Bayes default (801²,
    25 m, K = 44, Kl = 20, 18 days, pre-spread day) through K1-K4 and on
    the plain path; returns (seconds per value, per value+gradient, peak
    bytes)."""
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import (BayesSetup,
                                                   _kalbar_default_params)
    from parasitoids_tpu_torch.ops import day_kernel
    print('[7] log-posterior gradient at the Bayes default (801^2, '
          '18 days, K = 44, Kl = 20, pre-spread day)')
    runs = {}
    for path, use_pallas in (('kernels', None), ('plain', False)):
        p = _kalbar_default_params()
        p.use_pallas = use_pallas
        setup = BayesSetup(p, device=dev)
        check(setup.setup.kcfg.pallas == (use_pallas is None),
              '{}: accumulate path {}'.format(path, 'CUDA kernels'
                                              if setup.setup.kcfg.pallas
                                              else 'plain torch'))
        check((setup.setup.kcfg.K, setup.setup.kcfg.K_local,
               setup.ndays) == (44, 20, 18), path + ': K = 44, Kl = 20, '
              '18 days')
        neg, _, _ = map_fit._make_objective(setup, True)
        z0 = map_fit.initial_z(setup, True)
        before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        runs[path] = value_and_grad(neg, z0)
        torch.cuda.synchronize()
        n_fwd = day_kernel.LAUNCHES - before[0]
        n_bwd = day_kernel.LAUNCHES_BWD - before[1]
        want = (18, 18) if path == 'kernels' else (0, 0)
        check((n_fwd, n_bwd) == want, '{}: {} forward and {} backward '
              'kernel launches for one value+gradient'.format(path, n_fwd,
                                                              n_bwd))
        if path == 'kernels':
            torch.cuda.reset_peak_memory_stats(dev)
            runs[path] = value_and_grad(neg, z0)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            with torch.no_grad():
                sec_v = timed(lambda: neg(z0))
            sec_vg = timed(lambda: value_and_grad(neg, z0))
            print('  {}: {:.4f} s per value, {:.4f} s per value+gradient '
                  '(median of 3), peak {:.1f} MiB allocated for one '
                  'value+gradient ({})'.format(path, sec_v, sec_vg,
                                               peak / 2 ** 20, card))
        else:
            sec_plain = timed(lambda: value_and_grad(neg, z0), reps=1)
            print('  plain: {:.4f} s per value+gradient ({})'.format(
                sec_plain, card))
    (vk, gk), (vp, gp) = runs['kernels'], runs['plain']
    dv = abs(vk - vp) / abs(vp)
    l2 = float(np.linalg.norm(gk - gp) / np.linalg.norm(gp))
    dg, gmax = np.abs(gk - gp), np.abs(gp).max()
    comp = dg / np.maximum(np.abs(gp), 1e-30)
    print('  value kernels {!r} plain {!r}; gradient (plain): {}; '
          'per-component |dg|/|g|: {}'.format(
              vk, vp, np.array2string(gp, precision=3),
              np.array2string(comp, precision=2)))
    check(np.isfinite(vk) and np.all(np.isfinite(gk)) and
          dv <= GRAD_VALUE_RTOL and l2 <= GRAD_L2_LIMIT,
          'kernels vs plain: value rel diff {:.3e} <= {:.0e}, gradient '
          'relative L2 {:.3e} <= {:.0e}'.format(dv, GRAD_VALUE_RTOL, l2,
                                                GRAD_L2_LIMIT))
    inside = dg <= GRAD_COMP_RTOL * np.abs(gp) + GRAD_COMP_ATOL * gmax
    check(bool(np.all(inside)), 'kernels vs plain: every gradient component '
          'within {:.0e} of its magnitude + {:.0e} of the largest (worst '
          '{:.3e} of its magnitude, component {})'.format(
              GRAD_COMP_RTOL, GRAD_COMP_ATOL, float(comp.max()),
              int(comp.argmax())))
    return sec_v, sec_vg, peak, sec_plain, dv, l2


def phase_map_cli(dev, card):
    """The MAP CLI at its default (401², 50 m, K = 22, Kl = 10, 18 days,
    sprd_factor fitted) for 5 Adam steps, with both kernel counts zeroed
    just before and read just after, then its value and gradient at the
    initial z against the JAX golden."""
    import tempfile
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    from parasitoids_tpu_torch.ops import day_kernel
    print('[8] MAP CLI at its default (401^2, 18 days, K = 22, Kl = 10)')
    steps = 5
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'map_fit.txt')
        day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fit = map_fit.main(['--MAP', '--steps', str(steps), '-o', out],
                           device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - tic
        launches = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        check(os.path.getsize(out) > 0 and
              open(out).readline().startswith('MAP fit: logp ='),
              'report written ({} bytes)'.format(os.path.getsize(out)))
    losses = fit['losses']
    check(losses.shape == (steps,) and bool(np.all(np.isfinite(losses))),
          'loss finite at every step: ' + np.array2string(losses))
    check(losses[-1] < losses[0], 'loss falls: {:.4f} -> {:.4f}'.format(
        losses[0], losses[-1]))
    # each step is one value+gradient; the final log posterior one value
    check(launches == ((steps + 1) * 18, steps * 18),
          '{} forward and {} backward launches for {} steps of 18 days'
          .format(*launches, steps))
    print('  {:.4f} s per MAP step including setup ({} steps in {:.2f} s; '
          '{})'.format(sec / steps, steps, sec, card))

    golden = np.load(GRAD_GOLDEN)
    setup = BayesSetup(map_fit.map_cli_params(), device=dev)
    check((setup.setup.kcfg.K, setup.setup.kcfg.K_local, setup.ndays,
           tuple(golden['domain_info'])) == (int(golden['K']),
                                              int(golden['K_local']),
                                              int(golden['ndays']),
                                              (10000.0, 200.0)),
          'golden configuration: 401^2, K = 22, Kl = 10, 18 days')
    neg, _, _ = map_fit._make_objective(setup, True)
    z0 = torch.as_tensor(golden['z0'], device=dev)
    dz = float((map_fit.initial_z(setup, True) - z0).abs().max())
    check(dz <= 1e-6, 'the port\'s initial z is the golden z0 to {:.1e} '
          '(f32 rounding of the bijections)'.format(dz))
    v, g = value_and_grad(neg, z0)
    sec_vg = timed(lambda: value_and_grad(neg, z0))
    want_v, want_g = float(golden['value']), golden['grad']
    dv = abs(v - want_v) / abs(want_v)
    l2 = float(np.linalg.norm(g - want_g) / np.linalg.norm(want_g))
    comp = np.abs(g - want_g) / np.abs(want_g).max()
    print('  value {!r} (JAX {!r}); per-component |dg| / max|g|: {}'.format(
        v, want_v, np.array2string(comp, precision=2)))
    print('  {:.4f} s per value+gradient at 401^2 (median of 3; {})'.format(
        sec_vg, card))
    check(dv <= GOLDEN_VALUE_RTOL and l2 <= GOLDEN_L2_LIMIT and
          float(comp.max()) <= GOLDEN_COMP_LIMIT,
          'JAX golden: value rel diff {:.3e} <= {:.0e}, gradient relative '
          'L2 {:.3e} <= {:.0e}, worst component {:.3e} <= {:.0e} of the '
          'largest'.format(dv, GOLDEN_VALUE_RTOL, l2, GOLDEN_L2_LIMIT,
                           float(comp.max()), GOLDEN_COMP_LIMIT))
    return launches, sec / steps, sec_vg, dv, l2


def flat_proj(proj):
    return torch.cat([p.reshape(-1) for p in (*proj[0], *proj[1], proj[2])])


def states_equal(a, b):
    """Two stacked chain states bitwise equal, generators included."""
    tensors = all(torch.equal(getattr(a, f), getattr(b, f))
                  for f in a._fields if f not in ('key', 'proj'))
    keys = all(torch.equal(x.get_state(), y.get_state())
               for x, y in zip(a.key, b.key))
    return tensors and keys and torch.equal(flat_proj(a.proj),
                                            flat_proj(b.proj))


def count_host_reads(fn):
    """Run ``fn`` with every synchronizing CUDA call reported as a
    warning; returns (result, the calls' places in this repository)."""
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if 'called a synchronizing' in str(message):
            here = [f for f in traceback.extract_stack()
                    if f.filename.startswith(ROOT)]
            seen.append(' <- '.join('{}:{}'.format(
                os.path.relpath(f.filename, ROOT), f.lineno)
                for f in reversed(here[-4:-1])))

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        old_show, warnings.showwarning = warnings.showwarning, record
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
            warnings.showwarning = old_show
    return out, seen


def phase_am_cli(dev, card):
    """The AM CLI at the Bayes default (801², 25 m, K = 44, Kl = 20,
    18 days, no pre-spread day): a new run of two chains with a checkpoint,
    then a resume, with the forward kernel's count zeroed just before and
    read just after; exact resume on the card; the initial log likelihood
    through K1 against the plain accumulate; a step's host reads; seconds
    per step.  Returns (launches, forwards, seconds per step, per model
    block, per sweep, launches per step, device busy seconds per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import sampler
    from parasitoids_tpu_torch.bayes.store import load_chain, save_chain
    from parasitoids_tpu_torch.ops import day_kernel
    from parasitoids_tpu_torch.parallel.chains import run_chains
    print('[9] AM CLI at the Bayes default (801^2, 18 days, K = 44, '
          'Kl = 20, two chains)')
    meta_keys = {'n_samples', 'burn', 'chains', 'obs_sweeps', 'obs_model',
                 'sampler', 'seed', 'device'}
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, 'am')

        def stored():
            with np.load(db + '.npz') as npz, open(db + '.meta.json') as fh:
                return ({k: npz[k] for k in npz.files}, json.load(fh))

        day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
        sampler.FORWARDS = 0
        bayes_run.main(['--new', '20', '10', db, '--chains', '2',
                        '--checkpoint-every', '15', '--seed', '0'],
                       device=dev)
        first, meta = stored()
        dim = first['traces'].shape[-1]
        check(first['traces'].shape == (2, 20, 26) and
              bool(np.isfinite(first['traces']).all()),
              '--new: traces {} finite'.format(first['traces'].shape))
        check(set(meta) == meta_keys and meta['n_samples'] == 20 and
              meta['device'] == 'cuda' and meta['sampler'] == 'am',
              '--new: meta {}'.format(json.dumps(meta)))
        bayes_run.main(['--resume', db, '10'], device=dev)
        torch.cuda.synchronize()
        launches, forwards = day_kernel.LAUNCHES, sampler.FORWARDS
        both, meta = stored()
        check(both['traces'].shape == (2, 30, dim) and
              bool(np.isfinite(both['traces']).all()) and
              np.array_equal(both['traces'][:, :20], first['traces']),
              '--resume: traces {} finite, the first 20 kept'.format(
                  both['traces'].shape))
        check(set(meta) == meta_keys and meta['n_samples'] == 30 and
              meta['burn'] == 10 and meta['obs_sweeps'] == 1,
              '--resume: meta {}'.format(json.dumps(meta)))
        acc = both['state_accepts_m']
        check(bool(np.all(both['state_count'] == 40)) and
              bool(np.all((acc >= 0) & (acc <= 40))),
              'each chain took 40 steps; block proposals accepted: {} and '
              '{}; obs moves accepted: {} and {} of 400'.format(
                  *acc, *both['state_accepts_o']))
        # two chains initialised, two reloaded, and every proposal of the
        # 80 steps whose prior was finite
        check(4 <= forwards <= 4 + 80 and launches == 18 * forwards and
              day_kernel.LAUNCHES_BWD == 0,
              '{} forward launches = 18 x {} forwards (4 + {} of 80 '
              'proposals inside the prior\'s support); no backward launch'
              .format(launches, forwards, forwards - 4))

        # exact resume on the card: some steps in memory, a save, a reload
        setup = bayes_run.build_setup(device=dev)
        cfg = sampler.MCMCConfig(5)
        _, states, _ = load_chain(db, setup)
        states, tr = run_chains(setup, states, sampler.MCMCConfig(3))
        db2 = os.path.join(tmp, 'again')
        save_chain(db2, tr, states)
        _, reloaded, _ = load_chain(db2, setup)
        check(states_equal(states, reloaded),
              'a reloaded state is the state in memory, bit for bit')
        s_a, tr_a = run_chains(setup, states, cfg)
        s_b, tr_b = run_chains(setup, reloaded, cfg)
        torch.cuda.synchronize()
        check(torch.equal(tr_a, tr_b) and states_equal(s_a, s_b),
              '5 steps from the reloaded state bitwise equal to 5 steps in '
              'memory (2 chains)')

        # the initial log likelihood through K1 against the plain
        # accumulate in f64, the f32 plain path's distance beside it
        others = [bayes_run.build_setup([ov], device=dev)
                  for ov in ('use_pallas=False', 'use_f64=True')]
        check(setup.setup.kcfg.pallas and
              not any(s.setup.kcfg.pallas for s in others) and
              others[1].setup.wind_flat.dtype == torch.float64 and
              (setup.setup.kcfg.K, setup.setup.kcfg.K_local, setup.ndays,
               setup.setup.scfg.dom_len) == (44, 20, 18, 801),
              'setups: CUDA kernel, plain torch and plain torch in f64, '
              'K = 44, Kl = 20, 18 days, 801^2')
        ll, ll_plain, ll_64 = [float(sampler.init_chain_state(
            s, sampler.chain_generator(0, 0, dev)).loglik)
            for s in (setup, *others)]
        d = abs(ll - ll_64) / abs(ll_64)
        check(np.isfinite(ll) and d <= AM_LOGLIK_RTOL,
              'initial loglik through K1 {!r}, plain in f64 {!r}: rel diff '
              '{:.3e} <= {:.0e} (plain in f32 {!r}: {:.3e} from f64, {:.3e} '
              'from K1)'.format(ll, ll_64, d, AM_LOGLIK_RTOL, ll_plain,
                                abs(ll_plain - ll_64) / abs(ll_64),
                                abs(ll_plain - ll) / abs(ll)))

        # host reads: none in the sweep, one per block proposal
        state = sampler.unstack_states(s_a)[0]
        n_moves = sampler._n_obs(setup)
        draws = sampler.draw_step(state.key, n_moves, state.m.dtype, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            with torch.no_grad():
                sampler._obs_sweep(setup, draws.obs_eps, draws.obs_log_u,
                                   state.o, state.prior_o, state.loglik,
                                   state.proj, 1.0, sampler.MCMCConfig(1))
        finally:
            torch.cuda.set_sync_debug_mode('default')
        check(True, 'the observation sweep ({} moves) made no synchronizing '
              'call'.format(n_moves))
        n_steps = 4
        (state, _), reads = count_host_reads(
            lambda: sampler.run_mcmc(setup, state,
                                     sampler.MCMCConfig(n_steps)))
        for r in sorted(set(reads)):
            print('  host read x{}: {}'.format(reads.count(r), r))
        check(len(reads) == n_steps, '{} synchronizing calls in {} whole '
              'steps: one per block proposal'.format(len(reads), n_steps))

        # seconds per step and its split, CUDA events on the stream's
        # timeline read after one synchronize at the end
        marks = {'model': [], 'sweep': [], 'step': []}

        def timed_call(fn, key):
            def wrapper(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                marks[key].append((start, end))
                return out
            return wrapper

        real = (sampler._model_proposal, sampler._obs_sweep)
        sampler._model_proposal = timed_call(real[0], 'model')
        sampler._obs_sweep = timed_call(real[1], 'sweep')
        n_timed = 20
        try:
            before = (day_kernel.LAUNCHES, sampler.FORWARDS)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(n_timed):
                state, _ = timed_call(sampler._mcmc_step, 'step')(
                    setup, state, sampler.MCMCConfig(1))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - tic) / n_timed
        finally:
            sampler._model_proposal, sampler._obs_sweep = real
        med = {k: float(np.median([a.elapsed_time(b) for a, b in v])) * 1e-3
               for k, v in marks.items()}
        k1_per_step = (day_kernel.LAUNCHES - before[0]) / n_timed
        check(day_kernel.LAUNCHES - before[0] ==
              18 * (sampler.FORWARDS - before[1]),
              'timed steps: {} forwards in {} steps, 18 K1 launches each'
              .format(sampler.FORWARDS - before[1], n_timed))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = sampler.run_mcmc(setup, state, sampler.MCMCConfig(3))
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        per_step = sum(e.count for e in events) / 3
        busy = sum(e.self_device_time_total for e in events) * 1e-6 / 3
        check(per_step > 0 and busy > 0, 'the profiler saw the card')
        print('  {:.4f} s per AM step per chain (median of {} post-burn '
              'steps, CUDA events; {:.4f} s by the host clock over all): '
              'model block {:.4f} s, observation sweep {:.4f} s; {:.0f} '
              'device launches a step ({:.1f} of them K1), device busy '
              '{:.4f} s a step (idle share {:.3f}); {:.0f} AM steps/hr '
              '({})'.format(med['step'], n_timed, wall, med['model'],
                            med['sweep'], per_step, k1_per_step, busy,
                            1.0 - busy / med['step'],
                            3600.0 / med['step'], card))
    return (launches, forwards, med['step'], med['model'], med['sweep'],
            per_step, busy)


def phase_nuts_cli(dev, card):
    """The NUTS CLI at the Bayes default (801², 25 m, K = 44, Kl = 20,
    18 days, no pre-spread day, plain Poisson, f32): two chains in turn
    from a short MAP fit, with every count zeroed just before and read just
    after; the value and gradient of the NUTS target at the MAP start
    through the kernels against the plain path; an interrupted chain
    resumed from its checkpoint against the chain that never stopped; the
    host reads of a transition; seconds per leapfrog and per transition.
    Returns (K1 launches, K3 launches, value+gradients, seconds per
    leapfrog, seconds per transition per chain, leapfrogs per transition,
    host reads per leapfrog, the run's seconds, device launches and busy
    seconds a leapfrog)."""
    from parasitoids_tpu_torch.bayes import map_fit, nuts
    from parasitoids_tpu_torch.bayes import model as bayes_model
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.ops import day_kernel
    print('[10] NUTS CLI at the Bayes default (801^2, 18 days, K = 44, '
          'Kl = 20, two chains in turn)')
    tic_phase = time.perf_counter()
    burn, draws, depth, map_steps, chains = 8, 4, 4, 10, 2
    print('  cut in depth only: warm-up {} asked (the CLI runs at least 10) '
          '+ {} draws a chain, --max-depth {} (default 6), --init-map-steps '
          '{} (default 200); grid, windows and days not cut'.format(
              burn, draws, depth, map_steps))
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, 'nuts')
        day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
        nuts.VALUE_AND_GRADS = 0
        bayes_model.SKIPPED_FORWARDS = 0
        torch.cuda.synchronize()
        out = bayes_run.main(['--sampler', 'nuts', '--new', str(draws),
                              str(burn), db, '--chains', str(chains),
                              '--init', 'map', '--init-map-steps',
                              str(map_steps), '--max-depth', str(depth),
                              '--checkpoint-every', '3', '--seed', '0'],
                             device=dev)
        torch.cuda.synchronize()
        k1, k3 = day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD
        n_eval = nuts.VALUE_AND_GRADS
        skipped = bayes_model.SKIPPED_FORWARDS
        with np.load(db + '.npz') as npz:
            saved = {k: npz[k] for k in npz.files}
        check(set(saved) == {'traces', 'z_samples', 'step_size', 'inv_mass',
                             'sampler'} and str(saved['sampler']) == 'nuts'
              and saved['traces'].shape == (chains, draws, 26) and
              saved['z_samples'].shape == (chains, draws, 25),
              'trace file: JAX run_nuts keys, traces {}'.format(
                  saved['traces'].shape))
        check(bool(np.isfinite(saved['traces']).all()) and
              bool(np.isfinite(saved['z_samples']).all()),
              'every draw finite')
        check(not os.path.exists(db + '.ckpt.npz') and
              not os.path.exists(db + '.ckpt_durable.npz'),
              'a completed run leaves no checkpoint')
    # the value+gradients: the sampler's own (initial points, step-size
    # search, leapfrogs) and the MAP fit's Adam steps, less any evaluation
    # outside the prior's support (no forward); the MAP fit's last value
    # has no gradient
    n_vg = n_eval + map_steps - skipped
    check(k3 == 18 * n_vg and k1 == 18 * (n_vg + 1),
          'K3 launches {} = 18 x {} value+gradients ({} by the sampler + {} '
          'Adam steps - {} outside the support); K1 launches {} = K3 + 18 '
          '(the MAP fit\'s final value)'.format(k3, n_vg, n_eval, map_steps,
                                              skipped, k1))
    warm = max(burn, 10)
    n_trans = chains * (warm + draws)
    sec = out['seconds']
    leaps = out['n_leapfrog']
    per_leap = sec / max(n_eval, 1)
    per_trans = sec / n_trans
    print('  NUTS: {:.4f} s per leapfrog (the run\'s {:.2f} s over its {} '
          'value+gradients), {:.2f} leapfrogs per draw transition (warm-up '
          'and draws: {:.2f} evaluations per transition), {:.4f} s per '
          'transition per chain; step size {} accept {:.3f}, {} divergences '
          '({})'.format(per_leap, sec, n_eval, float(leaps.mean()),
                        n_eval / n_trans, per_trans,
                        np.array2string(out['step_size'], precision=4),
                        float(out['accept_rate']), int(out['n_divergent']),
                        card))

    # the NUTS target at the MAP start through the kernels, held against
    # the plain path run in f64 with the f32 plain path's distance beside:
    # near the mode the gradient is small, and the two f32 paths stand
    # further apart than [7]'s limits (as [9]'s initial loglik is held)
    setup = bayes_run.build_setup(device=dev)
    plain = bayes_run.build_setup(['use_pallas=False'], device=dev)
    plain64 = bayes_run.build_setup(['use_f64=True'], device=dev)
    check(setup.setup.kcfg.pallas and not plain.setup.kcfg.pallas and
          not plain64.setup.kcfg.pallas and
          plain64.setup.wind_flat.dtype == torch.float64 and
          (setup.setup.kcfg.K, setup.setup.kcfg.K_local, setup.ndays,
           setup.setup.scfg.dom_len) == (44, 20, 18, 801),
          'setups: CUDA kernels, plain torch and plain torch in f64, K = 44, '
          'Kl = 20, 18 days, 801^2')
    z_map = torch.as_tensor(map_fit.map_fit(setup, n_steps=map_steps,
                                            use_sprd=False)['z']).to(dev)
    runs = []
    for s in (setup, plain, plain64):
        zz = z_map.to(s.setup.wind_flat.dtype)
        lp, g = nuts.value_and_grad(nuts.make_transformed_logpdf(s)[0])(zz)
        runs.append((float(lp), g.double().cpu().numpy()))
    v64, g64 = runs[2]

    def distance(v, g):
        return (abs(v - v64) / abs(v64),
                float(np.linalg.norm(g - g64) / np.linalg.norm(g64)),
                float(np.abs(g - g64).max() / np.abs(g64).max()))

    dk, dp = distance(*runs[0]), distance(*runs[1])
    print('  NUTS target at the MAP start: value kernels {!r}, f32 plain {!r}, '
          'f64 plain {!r}; f64 gradient {}'.format(
              runs[0][0], runs[1][0], v64, np.array2string(g64,
                                                           precision=3)))
    check(np.isfinite(runs[0][0]) and np.all(np.isfinite(runs[0][1])) and
          dk[0] <= NUTS_VALUE_RTOL and dk[1] <= NUTS_GRAD_L2_LIMIT and
          dk[2] <= NUTS_GRAD_COMP_LIMIT,
          'NUTS target at the MAP start, kernels against the plain path in '
          'f64: value rel {:.3e} <= {:.0e}, gradient relative L2 {:.3e} <= '
          '{:.0e}, worst component {:.3e} <= {:.0e} of the largest (the f32 '
          'plain path: {:.3e}, {:.3e}, {:.3e})'.format(
              dk[0], NUTS_VALUE_RTOL, dk[1], NUTS_GRAD_L2_LIMIT, dk[2],
              NUTS_GRAD_COMP_LIMIT, *dp))
    del plain, plain64

    # exact resume on the card: one chain from the run's last draw, stopped
    # after its first draw, resumed from the checkpoint of warm-up
    logpdf = nuts.make_transformed_logpdf(setup)[0]
    z0 = torch.as_tensor(saved['z_samples'][:1, -1]).to(dev)
    cfg = nuts.NUTSConfig(num_warmup=4, num_samples=2, max_depth=2,
                          init_step_size=float(out['step_size'][0]))

    def gens():
        return [torch.Generator(device=dev).manual_seed(11)]

    class Stop(Exception):
        pass

    def stop(phase, i, total):
        if (phase, i) == ('sample', 1):
            raise Stop

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'one.ckpt.npz')
        whole = nuts.nuts_sample_stepwise(logpdf, z0, gens(), cfg)
        try:
            nuts.nuts_sample_stepwise(logpdf, z0, gens(), cfg, progress=stop,
                                      checkpoint_path=ckpt,
                                      checkpoint_every=2)
        except Stop:
            pass
        with np.load(ckpt) as d:
            phase = str(d['phase'])
        resumed = nuts.nuts_sample_stepwise(logpdf, z0, gens(), cfg,
                                            checkpoint_path=ckpt,
                                            checkpoint_every=2, resume=True)
    same = all(np.array_equal(whole[k], resumed[k]) for k in
               ('samples', 'logp', 'step_size', 'inv_mass', 'n_leapfrog'))
    check(same and phase == 'warmup',
          'one chain stopped after its first draw and resumed from its '
          'warm-up checkpoint: draws bitwise equal to the chain that never '
          'stopped ({} leapfrogs a draw)'.format(
              whole['n_leapfrog'][0].tolist()))

    # host reads: one per leapfrog, plus one where a gate stops the tree
    lpg = nuts.value_and_grad(logpdf)
    z = z0[0]
    lp, g = lpg(z)
    inv_mass = torch.as_tensor(resumed['inv_mass'][0]).to(dev)
    step = torch.as_tensor(resumed['step_size'][0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    n_leaf = []

    def transitions():
        zz, ll, gg = z, lp, g
        for _ in range(2):
            zz, ll, gg, _, n, _ = nuts._nuts_step(
                lpg, inv_mass, step, 3, zz, ll, gg,
                nuts.draw_transition(gen, zz.shape[0], 3, zz.dtype))
            n_leaf.append(n)

    torch.cuda.synchronize()
    _, reads = count_host_reads(transitions)
    for r in sorted(set(reads)):
        print('  host read x{}: {}'.format(reads.count(r), r))
    per = len(reads) / max(sum(n_leaf), 1)
    check(sum(n_leaf) <= len(reads) <= sum(n_leaf) + 2 and per <= 2.0,
          '{} synchronizing calls in 2 transitions of {} leapfrogs: {:.2f} '
          'per leapfrog (budget 2)'.format(len(reads), n_leaf, per))
    # device launches and busy time a leapfrog, one profiled transition
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_prof = []
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n_prof.append(nuts._nuts_step(
            lpg, inv_mass, step, 2, z, lp, g,
            nuts.draw_transition(gen, z.shape[0], 2, z.dtype))[4])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - tic) / n_prof[0]
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    launches_leap = sum(e.count for e in events) / n_prof[0]
    busy = sum(e.self_device_time_total for e in events) * 1e-6 / n_prof[0]
    check(launches_leap > 0 and busy > 0, 'the profiler saw the card')
    print('  profiled transition of {} leapfrogs: {:.0f} device launches and '
          '{:.4f} s device busy a leapfrog of {:.4f} s (idle share {:.3f}, '
          'the profiler on; {})'.format(n_prof[0], launches_leap, busy, wall,
                                        1.0 - busy / wall, card))
    sec_phase = time.perf_counter() - tic_phase
    print('  phase [10]: {:.1f} s'.format(sec_phase))
    return (k1, k3, n_vg, per_leap, per_trans, float(leaps.mean()), per,
            sec, launches_leap, busy)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible to torch', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)                     # data/ is addressed repo-relative
    from parasitoids_tpu_torch.ops import _build

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    card = '{} ({})'.format(torch.cuda.get_device_name(0), smi)
    dev = torch.device('cuda', 0)
    print('[1] torch {}, CUDA {}, device {}'.format(
        torch.__version__, torch.version.cuda, card))
    nvcc = subprocess.run([_build.nvcc_path(), '--version'],
                          capture_output=True, text=True, check=True).stdout
    print('  nvcc: ' + nvcc.strip().splitlines()[-1])

    print('[2] build')
    tic = time.perf_counter()
    _build.load('day_kernel')
    print('  day_kernel built and loaded in {:.2f} s'.format(
        time.perf_counter() - tic))
    rate = sfu_rate()
    print('  bounds: {:.4g} exps/s (SFU), {:.3g} f32 FLOP/s, {:.3g} B/s'
          .format(rate, F32_FLOPS_PER_S, HBM_BYTES_PER_S))

    err, timing = phase_kernel_vs_plain(dev, card, rate)
    phase_goldens(dev)
    launches, sec, per_sim = phase_main_path(dev, card)
    bwd_err, bwd_abs, bwd_timing = phase_backward_vs_plain(dev, card, rate)
    sec_v, sec_vg, peak, sec_plain, grad_dv, grad_l2 = \
        phase_posterior_gradient(dev, card)
    map_launches, sec_step, sec_vg_401, gold_dv, gold_l2 = \
        phase_map_cli(dev, card)
    (am_launches, am_forwards, am_step, am_model, am_sweep, am_per_step,
     am_busy) = phase_am_cli(dev, card)
    (nuts_k1, nuts_k3, nuts_vg, nuts_leap, nuts_trans, nuts_leaps,
     nuts_reads, nuts_sec, nuts_launches, nuts_busy) = phase_nuts_cli(dev,
                                                                      card)
    check(launches > 0 and min(map_launches) > 0 and am_launches > 0 and
          min(nuts_k1, nuts_k3) > 0,
          'both kernels launched on their main paths, the forward kernel on '
          'the AM path too, both on the NUTS path')
    check('jax' not in sys.modules, 'no JAX module was imported')
    jax_pkg = sorted(k for k in sys.modules if k == 'parasitoids_tpu' or
                     k.startswith('parasitoids_tpu.'))
    check(not jax_pkg, 'no module of the JAX package was imported {}'.format(
        jax_pkg or ''))

    k1, k2 = timing['K1'], timing['K2']
    k3, k4 = bwd_timing['K3'], bwd_timing['K4']
    kernels = [{
        'name': 'day_accumulate (K1 low-|rho| + K2 high-|rho|)',
        'route': 'cuda',
        'source': 'parasitoids_tpu_torch/csrc/day_kernel.cu',
        'replaces': 'parasitoids_tpu/ops/pallas_kernel.py:157',
        'launches': launches + nuts_k1,
        'launches_main_path': launches, 'launches_nuts_cli': nuts_k1,
        'launches_per_simulation': per_sim,
        'max_abs_err': max(err['K1'], err['K2']),
        'max_abs_err_k1': err['K1'], 'max_abs_err_k2': err['K2'],
        'max_err_over_peak': err['rel'],
        'ms': k1['ms'], 'plain_ms': k1['plain_ms'],
        'kernel_ms': k1['kernel_ms'],
        'block_build_ms': k1['passes'][0], 'gather_ms': k1['passes'][1],
        'reduce_ms': k1['passes'][2],
        'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
        'library_ms': None,
        'ms_k2': k2['ms'], 'plain_ms_k2': k2['plain_ms'],
        'kernel_ms_k2': k2['kernel_ms'],
        'block_build_ms_k2': k2['passes'][0],
        'gather_ms_k2': k2['passes'][1], 'reduce_ms_k2': k2['passes'][2],
        'bound_ms_k2': k2['bound_ms'], 'bound_by_k2': k2['bound_by'],
        'sec_per_simulation': sec,
        'sec_per_value_and_grad_801': sec_vg,
        'launches_map_cli': map_launches[0],
        'launches_am_cli': am_launches, 'forwards_am_cli': am_forwards,
        'sec_per_am_step_801': am_step,
        'sec_per_am_model_block_801': am_model,
        'sec_per_am_obs_sweep_801': am_sweep,
        'device_launches_per_am_step_801': am_per_step,
        'device_busy_sec_per_am_step_801': am_busy,
    }, {
        'name': 'day_accumulate_bwd (K3 low-|rho| + K4 high-|rho|)',
        'route': 'cuda',
        'source': 'parasitoids_tpu_torch/csrc/day_kernel.cu',
        'replaces': 'parasitoids_tpu/ops/pallas_kernel.py:326',
        'launches': map_launches[1] + nuts_k3,
        'launches_map_cli': map_launches[1], 'launches_nuts_cli': nuts_k3,
        'max_abs_err': max(bwd_abs.values()),
        'max_err_over_scale_k3': bwd_err['K3'],
        'max_err_over_scale_k4': bwd_err['K4'],
        'ms': k3['ms'], 'plain_ms': k3['plain_ms'],
        'kernel_ms': k3['kernel_ms'],
        'block_bwd_ms': k3['passes'][0], 'bwd_reduce_ms': k3['passes'][1],
        'bound_ms': k3['bound_ms'], 'bound_by': k3['bound_by'],
        'library_ms': None,
        'ms_k4': k4['ms'], 'plain_ms_k4': k4['plain_ms'],
        'kernel_ms_k4': k4['kernel_ms'],
        'block_bwd_ms_k4': k4['passes'][0],
        'bwd_reduce_ms_k4': k4['passes'][1],
        'bound_ms_k4': k4['bound_ms'], 'bound_by_k4': k4['bound_by'],
        'sec_per_value_801': sec_v,
        'sec_per_value_and_grad_801': sec_vg,
        'sec_per_value_and_grad_801_plain': sec_plain,
        'peak_bytes_value_and_grad_801': peak,
        'grad_vs_plain_801_rel_l2': grad_l2,
        'value_vs_plain_801_rel': grad_dv,
        'sec_per_value_and_grad_401': sec_vg_401,
        'sec_per_map_step_401': sec_step,
        'golden_value_rel_401': gold_dv,
        'golden_grad_rel_l2_401': gold_l2,
        'nuts_value_and_grads': nuts_vg,
        'sec_per_nuts_leapfrog_801': nuts_leap,
        'sec_per_nuts_transition_per_chain_801': nuts_trans,
        'nuts_leapfrogs_per_draw_801': nuts_leaps,
        'nuts_host_reads_per_leapfrog': nuts_reads,
        'sec_nuts_cli_801': nuts_sec,
        'device_launches_per_nuts_leapfrog_801': nuts_launches,
        'device_busy_sec_per_nuts_leapfrog_801': nuts_busy,
    }]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

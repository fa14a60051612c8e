"""Device time of the day-accumulate kernels' passes, on a GPU.

    python scripts/time_day_kernel.py [--chunks 32,64,128] [--reps 20]
                                      [--ptxas]
    python scripts/time_day_kernel.py --bwd [--ks 22,44,88] [--reps 20]
                                      [--ptxas]
    python scripts/time_day_kernel.py --particles 1,8,64 [--reps 20]

Forward (default): on Kalbar day 9 at the headline shapes (801², T = 1440,
K = 44, buffer 977²), at ρ = 0.253 (K1, 6-node rule) and ρ = 0.99 (K2),
prints for each gather chunk size the median device milliseconds of
``block_build``, ``gather`` and ``reduce`` (CUDA events around the kernels
alone), their sum, and the wrapper's time (CUDA events around
``accumulate_day``, constants packing included).

``--bwd``: the backward's two launches, ``block_bwd`` and ``bwd_reduce``,
on day 9 at ρ = 0.253 (K3) and ρ = 0.99 (K4), for the prior-coverage
window K = 22, 44, 88 (the 10 km domain in cells of 50, 25 and 12.5 m),
against a seeded random cotangent, with the height of the lattice ring
that the wrapper picks for each K.

``--particles``: the particle-batched launch (``accumulate_day_batched``, each
particle by its own Genz tier) on day 9 of the Bayes default (801², K = 44) for
the first N of the prior's particles (seed 18, as smoke [18] draws them), for
each N: the three passes' median device milliseconds, their sum, and the bound
(chip_smoke.py's: the exps, f32 operations and bytes these particles' inputs
need, at the card's rates).

``--ptxas`` first compiles ``csrc/day_kernel.cu`` with ``-Xptxas -v`` and
prints each kernel's registers, shared memory and spills.  Needs a CUDA
device; imports no JAX.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_report():
    from parasitoids_tpu_torch.ops import _build
    src = os.path.join(_build.CSRC_DIR, 'day_kernel.cu')
    with tempfile.TemporaryDirectory() as tmp:
        flags = [f for f in _build.NVCC_FLAGS if f not in ('-shared',
                                                           '-Xcompiler',
                                                           '-fPIC')]
        proc = subprocess.run([_build.nvcc_path(), *flags, '-Xptxas', '-v',
                               '-c', '-o', os.path.join(tmp, 'k.o'), src],
                              capture_output=True, text=True)
    print(proc.stdout + proc.stderr)
    if proc.returncode:
        sys.exit('nvcc failed')


def day_inputs(rad_res, day=9):
    """(h, mu, idx, clip, Dparams, cell, K, buf_len) of one Kalbar day on
    the card, the 10 km domain cut into ``rad_res`` cells a side of the
    release point, with the prior-coverage windows."""
    from parasitoids_tpu_torch.config import Params
    from parasitoids_tpu_torch.models.forward import (prior_coverage_windows,
                                                      setup_forward)
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    p = Params()
    p.cmd_line_chg(['--kalbar', '--pop'])
    p.PLOT = p.OUTPUT = False
    p.domain_info = (p.domain_info[0], rad_res)
    cell = p.domain_info[0] / rad_res
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    s = setup_forward(p, device='cuda')
    K = s.kcfg.K
    h, mu, idx, clip, _ = day_scatter_inputs(
        s.wind_flat, s.wind_cumsum, day, (p.lam, *p.g_params, *p.f_params),
        p.mu_r, p.n_periods, 0, s.kcfg, s.rad_dist)
    return h, mu, idx, clip, p.Dparams, cell, K, s.scfg.dom_len + 4 * K


def wrapper_ms(fn, reps):
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


def time_forward(args):
    from parasitoids_tpu_torch.ops.day_kernel import accumulate_day, pass_ms
    h, mu, idx, clip, Dp, cell, K, buf_len = day_inputs(400)
    for rho in (0.253, 0.99):
        a = (h, mu, idx, clip, (Dp[0], Dp[1], rho), cell, K, buf_len)
        print('day 9 rho {:+.3f}: wrapper {:.4f} ms (median of {})'.format(
            rho, wrapper_ms(lambda: accumulate_day(*a), args.reps),
            args.reps))
        for chunk in (int(c) for c in args.chunks.split(',')):
            pass_ms(*a, reps=2, chunk=chunk)                # warm-up
            ms = np.median(pass_ms(*a, reps=args.reps, chunk=chunk), axis=0)
            print('  chunk {:4d}: block_build {:.4f} ms, gather {:.4f} ms, '
                  'reduce {:.4f} ms, kernels {:.4f} ms'.format(
                      chunk, *ms, float(ms.sum())))


def time_backward(args):
    from parasitoids_tpu_torch.ops import _build, day_kernel
    lib = _build.load('day_kernel')
    for K_want in (int(v) for v in args.ks.split(',')):
        h, mu, idx, clip, Dp, cell, K, buf_len = day_inputs(
            int(round(400 * K_want / 44)))
        gen = torch.Generator(device='cuda').manual_seed(0)
        ct_buf = torch.randn((buf_len, buf_len), generator=gen, device='cuda')
        ct_loss = torch.randn((), generator=gen, device='cuda')
        for rho in (0.253, 0.99):
            a = (ct_buf, ct_loss, h, mu, idx, clip, (Dp[0], Dp[1], rho), cell,
                 K, buf_len)
            print('day 9 K = {} (cell {} m, buffer {}^2) rho {:+.3f}: wrapper '
                  '{:.4f} ms (median of {})'.format(
                      K, cell, buf_len, rho, wrapper_ms(
                          lambda: day_kernel.accumulate_day_bwd(*a),
                          args.reps), args.reps))
            day_kernel.pass_ms_bwd(*a, reps=2)              # warm-up
            ms = np.median(day_kernel.pass_ms_bwd(*a, reps=args.reps),
                           axis=0)
            print('  ring {:4d}: block_bwd {:.4f} ms, bwd_reduce {:.4f} ms, '
                  'kernels {:.4f} ms'.format(day_kernel._bwd_ring(lib, K),
                                             *ms, float(ms.sum())))


def time_particles(args):
    import chip_smoke
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes.priors import sample_prior_model
    from parasitoids_tpu_torch.ops import day_kernel
    counts = [int(n) for n in args.particles.split(',')]
    setup = bayes_run.build_setup(device='cuda')
    m = sample_prior_model(torch.Generator().manual_seed(18),
                           max(counts)).to('cuda')
    rate = chip_smoke.sfu_rate()
    for n in counts:
        a = chip_smoke.batched_day(setup, m[:n], 9)
        h, mu, idx, clip, Dp, cell, K, buf_len = a
        day_kernel.pass_ms(*a, reps=2)                      # warm-up
        ms = np.median(day_kernel.pass_ms(*a, reps=args.reps), axis=0)
        work = np.sum([chip_smoke.forward_counts(
            h[i], mu[i], tuple(Dp[i]), cell, K, buf_len)
            for i in range(n)], axis=0)
        b, by, what = chip_smoke.bound(*work, rate)
        print('day 9, {} particle(s): block_build {:.4f} ms, gather {:.4f} '
              'ms, reduce {:.4f} ms, kernels {:.4f} ms (median of {}); '
              'bound {:.4f} ms by {} ({})'.format(n, *ms, float(ms.sum()),
                                                  args.reps, b, by, what))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--chunks', default='64')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--bwd', action='store_true')
    ap.add_argument('--ks', default='22,44,88')
    ap.add_argument('--particles', default=None,
                    help='time the particle-batched launch for these '
                         'particle counts, e.g. 1,8,64')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('time_day_kernel: needs a CUDA device')
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    if args.ptxas:
        ptxas_report()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print('card: ' + smi)
    if args.particles:
        time_particles(args)
    else:
        (time_backward if args.bwd else time_forward)(args)


if __name__ == '__main__':
    main()

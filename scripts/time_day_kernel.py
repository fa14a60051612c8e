"""Device time of the forward day-accumulate kernel's passes, on a GPU.

    python scripts/time_day_kernel.py [--chunks 32,64,128] [--reps 20]
                                      [--ptxas]

On Kalbar day 9 at the headline shapes (801², T = 1440, K = 44, buffer
977²), at ρ = 0.253 (K1, 6-node rule) and ρ = 0.99 (K2), prints for each
gather chunk size the median device milliseconds of ``block_build``,
``gather`` and ``reduce`` (CUDA events around the kernels alone), their
sum, and the wrapper's time (CUDA events around ``accumulate_day``,
constants packing included).  ``--ptxas`` first compiles
``csrc/day_kernel.cu`` with ``-Xptxas -v`` and prints each kernel's
registers, shared memory and spills.  Needs a CUDA device; imports no JAX.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--chunks', default='64')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--ptxas', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('time_day_kernel: needs a CUDA device')
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from parasitoids_tpu_torch.config import Params
    from parasitoids_tpu_torch.models.forward import (prior_coverage_windows,
                                                      setup_forward)
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    from parasitoids_tpu_torch.ops.day_kernel import accumulate_day, pass_ms

    if args.ptxas:
        ptxas_report()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print('card: ' + smi)
    p = Params()
    p.cmd_line_chg(['--kalbar', '--pop'])
    p.PLOT = p.OUTPUT = False
    cell = p.domain_info[0] / p.domain_info[1]
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    s = setup_forward(p, device='cuda')
    K = s.kcfg.K
    buf_len = s.scfg.dom_len + 4 * K
    h, mu, idx, clip, _ = day_scatter_inputs(
        s.wind_flat, s.wind_cumsum, 9, (p.lam, *p.g_params, *p.f_params),
        p.mu_r, p.n_periods, 0, s.kcfg, s.rad_dist)
    for rho in (0.253, 0.99):
        a = (h, mu, idx, clip, (p.Dparams[0], p.Dparams[1], rho), cell, K,
             buf_len)
        accumulate_day(*a)
        wrapper = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            accumulate_day(*a)
            end.record()
            end.synchronize()
            wrapper.append(start.elapsed_time(end))
        print('day 9 rho {:+.3f}: wrapper {:.4f} ms (median of {})'.format(
            rho, float(np.median(wrapper)), args.reps))
        for chunk in (int(c) for c in args.chunks.split(',')):
            pass_ms(*a, reps=2, chunk=chunk)                # warm-up
            ms = np.median(pass_ms(*a, reps=args.reps, chunk=chunk), axis=0)
            print('  chunk {:4d}: block_build {:.4f} ms, gather {:.4f} ms, '
                  'reduce {:.4f} ms, kernels {:.4f} ms'.format(
                      chunk, *ms, float(ms.sum())))


if __name__ == '__main__':
    main()

"""Where the time of one value+gradient of the PyTorch port's log posterior
goes, on a GPU.

    python scripts/profile_torch_gradient.py [--map] [--iters N] [--plain]

Default: the Bayes default (Kalbar population model, 801² cells of 25 m,
18 days, K = 44, Kl = 20, pre-spread day) at the MAP starting point;
``--map``: the MAP CLI's default (401², 50 m, K = 22, Kl = 10).  Prints
seconds per value and per value+gradient (host clock around synchronized
runs, median of N), seconds per steady-state Adam step of ``map_fit``,
then one value+gradient under ``torch.profiler``: device busy time, the
device's idle share, CUDA kernel launches, and device time by kernel.
``--plain`` takes the plain torch accumulate instead of the CUDA day
kernels.  Needs a CUDA device; imports no JAX.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _median_secs(fn, iters):
    fn()                                             # warm-up
    secs = []
    for _ in range(iters):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - tic)
    return float(np.median(secs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--map', action='store_true')
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--plain', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_gradient: needs a CUDA device')
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import (BayesSetup,
                                                   _kalbar_default_params)

    p = (map_fit.map_cli_params() if args.map else _kalbar_default_params())
    p.use_pallas = not args.plain
    setup = BayesSetup(p, device='cuda')
    neg, _, _ = map_fit._make_objective(setup, True)
    z0 = map_fit.initial_z(setup, True)

    def value():
        with torch.no_grad():
            return neg(z0)

    def value_and_grad():
        z = z0.clone().requires_grad_()
        neg(z).backward()
        return z.grad

    label = '{}^2, {}'.format(2 * setup.setup.kcfg.rad_res + 1,
                              'plain accumulate' if args.plain
                              else 'CUDA day kernels')
    sec_v = _median_secs(value, args.iters)
    sec_vg = _median_secs(value_and_grad, args.iters)
    # steady-state Adam step: the difference of two fits over their steps
    one = _median_secs(lambda: map_fit.map_fit(setup, n_steps=1), 1)
    six = _median_secs(lambda: map_fit.map_fit(setup, n_steps=6), 1)
    print('{}: {:.4f} s per value, {:.4f} s per value+gradient (median of '
          '{}), {:.4f} s per Adam step (map_fit of 6 steps minus 1)'.format(
              label, sec_v, sec_vg, args.iters, (six - one) / 5))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        value_and_grad()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    print('profiled value+gradient: wall {:.4f} s, device busy {:.4f} s, '
          'device idle share {:.3f}, {} CUDA kernel launches'.format(
              wall, device_us * 1e-6, 1.0 - device_us * 1e-6 / wall,
              sum(e.count for e in events)))
    print('device idle share, estimate (profiled busy / unprofiled wall): '
          '{:.3f}'.format(1.0 - device_us * 1e-6 / sec_vg))
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:15]:
        print('  {:>10.3f} ms  {:>6d} calls  {}'.format(
            e.self_device_time_total * 1e-3, e.count, e.key[:90]))


if __name__ == '__main__':
    main()

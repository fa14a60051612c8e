"""Where the time of one adaptive-Metropolis step of the PyTorch port goes,
on a GPU.

    python scripts/profile_torch_am.py [--steps N] [--obs-sweeps S] [--plain]

The Bayes default (Kalbar population model, 801² cells of 25 m, 18 days,
K = 44, Kl = 20, no pre-spread day), one chain from the reference's
initial values.  Prints seconds per step (host clock around N steps ending
in a synchronize, after a warm-up), the share of block proposals that ran
the forward, then N steps under ``torch.profiler``: device launches and
busy time per step, the device's idle share, and device time by kernel.
``--plain`` takes the plain torch accumulate instead of the CUDA day
kernel.  Needs a CUDA device; imports no JAX.
"""

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--obs-sweeps', type=int, default=1)
    ap.add_argument('--plain', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_am: needs a CUDA device')
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import sampler

    setup = bayes_run.build_setup(
        ['use_pallas=False'] if args.plain else [], device='cuda')
    dev = setup.setup.wind_flat.device
    cfg = sampler.MCMCConfig(args.steps, obs_sweeps=args.obs_sweeps)
    state = sampler.init_chain_state(setup,
                                     sampler.chain_generator(0, 0, dev))
    state, _ = sampler.run_mcmc(setup, state, cfg)           # warm-up
    before = sampler.FORWARDS
    torch.cuda.synchronize()
    tic = time.perf_counter()
    state, _ = sampler.run_mcmc(setup, state, cfg)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - tic) / args.steps
    print('801^2, {}, {} obs sweep(s): {:.4f} s per AM step ({} steps, {} '
          'of them ran the forward), {:.0f} steps/hr ({})'.format(
              'plain accumulate' if args.plain else 'CUDA day kernel',
              args.obs_sweeps, sec, args.steps, sampler.FORWARDS - before,
              3600.0 / sec, torch.cuda.get_device_name(0)))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        sampler.run_mcmc(setup, state, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tic) / args.steps
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) * 1e-6 / args.steps
    print('profiled: wall {:.4f} s a step, device busy {:.4f} s a step, '
          'device idle share {:.3f} (against the unprofiled step: {:.3f}), '
          '{:.0f} device launches a step'.format(
              wall, busy, 1.0 - busy / wall, 1.0 - busy / sec,
              sum(e.count for e in events) / args.steps))
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:15]:
        print('  {:>10.3f} ms a step  {:>8.1f} calls a step  {}'.format(
            e.self_device_time_total * 1e-3 / args.steps,
            e.count / args.steps, e.key[:90]))


if __name__ == '__main__':
    main()

"""Whether the log posterior's gradient is the same bits from run to run
on the card: several value+gradients at one z, compared bit for bit.

    python scripts/check_torch_grad_bits.py [--root DIR] [--runs 5] [--small]

``--root`` names the checkout whose ``parasitoids_tpu_torch`` is imported
(default: this one), so two trees can be held side by side in one call.
The configuration is the Bayes default (801², 18 days, K = 44, Kl = 20) at
the MAP start with the pre-spread day, through the CUDA kernels; with
``--small`` the small configuration of the tests (3 days, 10 km / 50
cells, K 6, Kl 3), whose observation cells repeat up to 16 times in one
gather.  Prints the card, how many runs differ from the first, and the
largest difference of the value and of each gradient component.
"""

import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--small', action='store_true')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)                     # data/ is addressed repo-relative
    import numpy as np
    import torch
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import (BayesSetup,
                                                   _kalbar_default_params)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    if args.small:
        params = map_fit.map_cli_params(
            ['ndays=3', 'domain_info=(10000.0,50)', 'interp_num=2',
             'kernel_rad=6', 'kernel_rad_local=3'])
    else:
        params = _kalbar_default_params()
    setup = BayesSetup(params, device='cuda')
    neg, _, _ = map_fit._make_objective(setup, True)
    z0 = map_fit.initial_z(setup, True)
    runs = []
    for _ in range(args.runs):
        z = z0.clone().requires_grad_()
        v = neg(z)
        v.backward()
        runs.append((v.detach().clone(), z.grad.clone()))
    torch.cuda.synchronize()
    differ = [i for i, (v, g) in enumerate(runs[1:], 1)
              if not (torch.equal(v, runs[0][0]) and
                      torch.equal(g, runs[0][1]))]
    dv = max(float((v - runs[0][0]).abs()) for v, _ in runs)
    dg = np.max([(g - runs[0][1]).abs().cpu().numpy() for _, g in runs],
                axis=0)
    print('{} ({}): {} of {} value+gradients differ from the first; largest '
          '|dvalue| {:.3e}; largest |dgrad| per component {} (|grad| up to '
          '{:.3e})'.format(root, 'small' if args.small else '801^2',
                           len(differ), args.runs - 1, dv,
                           np.array2string(dg, precision=2),
                           float(runs[0][1].abs().max())))


if __name__ == '__main__':
    main()

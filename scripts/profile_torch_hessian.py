"""The memory and time of the Laplace Hessian's first stage: the f64
gradient of the negative log posterior built with ``create_graph``, whose
graph every Hessian row then runs backward through.

    python scripts/profile_torch_hessian.py [--bayes] [--days N]
        [--device cpu]

Default: the MAP CLI's configuration (401², 50 m, K = 22, Kl = 10,
pre-spread day) on its f64 plain twin at the MAP starting point;
``--bayes``: the Bayes default (801², 25 m, K = 44, Kl = 20, no
pre-spread day).  ``--days`` cuts the simulation to that many days (the
saved graph grows with the days, one day's worth each).  Prints the bytes
of every distinct storage that the graph saves (counted with
``torch.autograd.graph.saved_tensors_hooks``), the seconds of the gradient
and of one Hessian row, and on the card the peak bytes allocated.  Runs on
the card unless ``--device cpu`` is given; imports no JAX.
"""

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(prog='profile_torch_hessian.py')
    ap.add_argument('--bayes', action='store_true',
                    help='the Bayes default (801^2) instead of the MAP CLI '
                         'default (401^2)')
    ap.add_argument('--days', type=int, default=None,
                    help='simulate this many days (default: all 18)')
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda')
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)                     # data/ is addressed repo-relative
    from parasitoids_tpu_torch.bayes import map_fit, run
    from parasitoids_tpu_torch.bayes.model import BayesSetup

    overrides = [] if args.days is None else ['ndays={}'.format(args.days)]
    if args.bayes:
        setup, use_sprd = run.build_setup(overrides, device=args.device), False
    else:
        setup = BayesSetup(map_fit.map_cli_params(overrides),
                           device=args.device)
        use_sprd = True
    twin = map_fit.plain_twin(setup, torch.float64)
    neg, _, _ = map_fit._make_objective(twin, use_sprd)
    z = map_fit.initial_z(setup, use_sprd).double().requires_grad_()
    cuda = twin.setup.wind_flat.device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        saved[storage.data_ptr()] = storage.nbytes()
        return t

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    tic = time.perf_counter()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        grad, = torch.autograd.grad(neg(z), z, create_graph=True)
    sync()
    sec_grad = time.perf_counter() - tic
    tic = time.perf_counter()
    torch.autograd.grad(grad, z, grad_outputs=torch.eye(
        z.shape[0], dtype=z.dtype, device=z.device)[8], retain_graph=True)
    sync()
    sec_row = time.perf_counter() - tic
    print('{}, {} days, K = {}, f64 plain twin on {}: the create_graph '
          'gradient saves {:.3f} GB in {} storages; {:.2f} s for the '
          'gradient, {:.2f} s for one Hessian row{}'.format(
              '801^2' if args.bayes else '401^2', twin.ndays,
              twin.setup.kcfg.K, twin.setup.wind_flat.device,
              sum(saved.values()) / 1e9, len(saved), sec_grad, sec_row,
              '; peak {:.3f} GB allocated'.format(
                  torch.cuda.max_memory_allocated() / 1e9) if cuda else ''))


if __name__ == '__main__':
    main()

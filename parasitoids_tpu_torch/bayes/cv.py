"""Exact leave-one-group-out cross-validation by refitting (L4 analysis),
PyTorch port of ``parasitoids_tpu/bayes/cv.py``.

PSIS-LOO (bayes/loo.py) estimates held-out predictive density from ONE
posterior sample by importance reweighting; when a group carries real
information the weights degenerate (``khat > 0.7``) and the estimate is
untrustworthy.  The honest fallback (Vehtari, Gelman & Gabry 2017, sec. 2.3)
is to actually refit without the group and score it directly:

    elpd_g = log E_{theta ~ p(theta | y_{-g})} [ p(y_g | theta) ]

Each fold's refit target is the masked likelihood
(``BayesSetup.split_point_mask`` passed as ``run_smc``'s ``obs_mask``;
priors and forward model untouched), sampled with adaptive tempered SMC
(bayes/smc.py): every fold is an independent prior-to-posterior anneal
with no warmup tuning to hand-hold.  The held-out density is then a
weighted average over the final particle population, whose cached forward
projections make the extra evaluation free of any new simulation.

The reference has no cross-validation machinery of any kind.

CLI: ``python -m parasitoids_tpu_torch.bayes.cv --group block [--folds 0,2]
[--device cpu] [k=v...]``; the particles shard over the visible cards when
their count divides over them.
"""

from __future__ import annotations

import numpy as np
import torch

from .loo import point_groups
from .model import BayesSetup

__all__ = ['exact_logo_cv', 'held_out_elpd']


def held_out_elpd(setup: BayesSetup, payload, member_cols):
    """log E_post[p(y_g | theta)] from an SMC payload's weighted particles.

    Uses the particles' cached projections (ChainState.proj) — no new
    forward simulations; the pointwise log-pmfs of every particle come to
    the host in one transfer."""
    from scipy.special import logsumexp

    from .model import _as_obs
    from .sampler import unstack_states

    logw = np.asarray(payload['logw'], np.float64)
    with torch.no_grad():
        ll = torch.stack([setup.pointwise_loglik(s.proj,
                                                 _as_obs(s.o, setup.n_sent))
                          for s in unstack_states(payload['states'])])
    ll = ll.cpu().numpy().astype(np.float64)
    group_ll = ll[:, member_cols].sum(axis=1)
    logw = logw - logsumexp(logw)
    return float(logsumexp(logw + group_ll)), group_ll


def exact_logo_cv(setup: BayesSetup, by='block', folds=None, seed=0,
                  smc_config=None, mesh=None, verbose=False):
    """Refit-based leave-one-group-out elpd.

    Args:
        setup: full-data BayesSetup.
        by: 'date' or 'block' grouping (loo.point_groups).
        folds: iterable of group indices to hold out (default: all) — in
            practice, the groups PSIS-LOO flagged with high khat.
        smc_config: SMCConfig for each fold's refit (default: 128
            particles, 3 moves/stage).
        mesh: optional device mesh (``parallel.chains.chain_mesh``); each
            fold's particles shard over it (``run_smc(mesh=)``).
    Returns:
        dict with per-fold labels, exact elpd values, the refit logZ per
        fold, and the total over evaluated folds.
    """
    from .smc import SMCConfig, run_smc

    gids, labels = point_groups(setup, by=by)
    if folds is None:
        folds = range(len(labels))
    folds = list(folds)
    bad = [g for g in folds if not 0 <= g < len(labels)]
    if bad:
        raise ValueError('fold indices {} out of range: {} groups ({})'
                         .format(bad, len(labels),
                                 ', '.join(labels[:8])))
    cfg = smc_config or SMCConfig(n_particles=128, n_moves=3)

    out = {'group': by, 'folds': folds, 'labels': [labels[g] for g in folds],
           'elpd': [], 'logz': []}
    for i, g in enumerate(folds):
        keep = gids != g
        mask = setup.split_point_mask(keep)
        if verbose:
            print('fold {}/{}: hold out {} ({} obs)...'.format(
                i + 1, len(folds), labels[g], int((~keep).sum())),
                flush=True)
        payload = run_smc(setup, seed + 1000 * g, cfg, mesh=mesh,
                          seed=seed + g, verbose=verbose, obs_mask=mask)
        elpd_g, _ = held_out_elpd(setup, payload, np.where(~keep)[0])
        out['elpd'].append(elpd_g)
        out['logz'].append(float(payload['logz']))
        if verbose:
            print('fold {}: elpd {:.3f} (refit logZ {:.2f})'.format(
                labels[g], elpd_g, payload['logz']), flush=True)
    out['elpd_total'] = float(np.sum(out['elpd']))
    return out


def main(argv=None, device=None):
    """The cross-validation CLI; ``device`` given here wins over
    ``--device``.  Returns the result dict."""
    import argparse
    import json

    from .run import build_setup
    from .smc import SMCConfig

    ap = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.bayes.cv',
        description='exact leave-one-group-out CV by SMC refits')
    ap.add_argument('--group', choices=['date', 'block'], default='block')
    ap.add_argument('--folds', default=None,
                    help='comma-separated group indices (default: all)')
    ap.add_argument('--particles', type=int, default=128)
    ap.add_argument('--moves', type=int, default=3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default='logo_cv.json')
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                    help='where to run (default cuda; no CPU fallback)')
    ap.add_argument('overrides', nargs='*',
                    help='key=value Params overrides matching the run')
    args = ap.parse_args(argv)
    from .. import device as _device
    from ..parallel.chains import chain_mesh
    device = args.device if device is None else device
    setup = build_setup(args.overrides, device=device)

    mesh = None
    devices = _device.visible_devices(device)
    if len(devices) > 1 and args.particles % len(devices) == 0:
        mesh = chain_mesh(devices=devices)
        print('particles sharded over {} devices'.format(len(devices)))

    folds = ([int(x) for x in args.folds.split(',')]
             if args.folds else None)
    res = exact_logo_cv(
        setup, by=args.group, folds=folds, seed=args.seed,
        smc_config=SMCConfig(n_particles=args.particles,
                             n_moves=args.moves),
        mesh=mesh, verbose=True)
    print('exact LOGO-CV elpd over {} folds: {:.3f}'.format(
        len(res['folds']), res['elpd_total']))
    with open(args.out, 'w') as fh:
        json.dump(res, fh)
    print('wrote', args.out)
    return res


if __name__ == '__main__':
    main()

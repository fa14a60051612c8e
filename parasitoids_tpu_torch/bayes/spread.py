"""Posterior spread maps: per-cell credible intervals of the daily
population fields over posterior draws.  PyTorch port of
``parasitoids_tpu/bayes/spread.py``.

No reference equivalent: the reference can plot the field of ONE parameter
set (Plot_Result.py) — quantifying the spatial uncertainty of a fitted
posterior meant re-running ``Run.py`` by hand per draw and eyeballing.
Here draws from a saved trace run as an ensemble of forward simulations
(parallel/ensemble.py, the members in turn on the card) and are reduced to
per-cell posterior quantiles on the host:

    python -m parasitoids_tpu_torch.bayes.spread runs/kalbar --days 3,18 \
        --draws 20

writes ``<trace>_spread.npz`` (quantile + mean fields per requested day)
and one figure per day: the posterior-median density beside the 90%%
credible-interval width — where the wasps are, and how sure the fit is.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import BayesSetup
from .priors import MODEL_PARAM_NAMES

__all__ = ['posterior_spread', 'prior_spread', 'plot_spread',
           'save_spread', 'main']


def _spread_fields(setup: BayesSetup, m_draws, day_idx, mesh=None):
    """(B, len(day_idx), D, D) population fields for the model-parameter
    draws as host numpy, each member keeping only the requested days, so
    the full (B, ndays, D, D) stack never forms."""
    from ..parallel.ensemble import ensemble_fields
    return ensemble_fields(setup, m_draws, mesh=mesh,
                           days=day_idx).cpu().numpy()


def posterior_spread(setup: BayesSetup, traces, n_draws=20, days=None,
                     quantiles=(0.05, 0.5, 0.95), seed=0, mesh=None):
    """Per-cell posterior quantiles of the population fields.

    Args:
        traces: (n_chains, n_samples, dim) or (n_samples, dim) trace array.
        days: 1-based simulation days to map (default: the last day).
        quantiles: cell-wise quantiles to compute over the draws.
    Returns:
        dict with 'days', 'quantiles', 'maps' (len(quantiles), len(days),
        D, D), 'mean' (len(days), D, D), and the sampled 'draw_rows'.
    """
    from .predictive import subsample_draws

    rows, take = subsample_draws(traces, n_draws, seed)
    m_draws = rows[:, :len(MODEL_PARAM_NAMES)].astype(np.float32)

    days = [int(d) for d in (days if days else [setup.ndays])]
    bad = [d for d in days if not 1 <= d <= setup.ndays]
    if bad:
        raise ValueError('days {} outside the simulated range 1..{}'.format(
            bad, setup.ndays))
    fields = _spread_fields(setup, m_draws, [d - 1 for d in days], mesh)
    return {
        'days': np.asarray(days),
        'quantiles': np.asarray(quantiles, np.float64),
        'maps': np.quantile(fields, quantiles, axis=0),
        'mean': fields.mean(axis=0),
        'draw_rows': take,
    }


def prior_spread(setup: BayesSetup, n_draws=20, days=None,
                 quantiles=(0.05, 0.5, 0.95), seed=0, mesh=None,
                 draws=None):
    """Spread maps under parameters drawn from the exact joint prior — the
    spatial companion to ``predictive.prior_predictive`` (do the priors
    put wasps in plausible places at all?).  The model blocks come from the
    port's prior sampler on a CPU generator seeded with ``seed``, or from
    ``draws`` ((n, 15), to replay another sampler's)."""
    from .priors import sample_prior_model

    m = (sample_prior_model(torch.Generator().manual_seed(int(seed)),
                            n_draws).numpy()
         if draws is None else np.asarray(draws, np.float32))
    return posterior_spread(setup, m[None], n_draws=n_draws, days=days,
                            quantiles=quantiles, seed=seed, mesh=mesh)


def save_spread(spread, path):
    np.savez_compressed(path, **spread)
    return path


def plot_spread(spread, params, outfile_prefix, locinfo=None):
    """Per requested day: posterior-median field (left, plot_result
    conventions) and the credible-interval width between the outer
    quantiles (right, same window).  Returns the written paths."""
    from ..viz.plot_result import (_extent_meters, _mpl, alpha_viridis,
                                   crop_to_support, vmax_excluding_origin)
    plt = _mpl()

    q = spread['quantiles']
    lo_i, hi_i = int(np.argmin(q)), int(np.argmax(q))
    med_i = int(np.argmin(np.abs(q - 0.5)))
    med_label = ('posterior median density' if abs(q[med_i] - 0.5) < 1e-9
                 else 'posterior {:.0f}% quantile density'.format(
                     100 * q[med_i]))
    rad_res = int(params.domain_info[1])
    cell = params.domain_info[0] / params.domain_info[1]
    outs = []
    for k, day in enumerate(np.asarray(spread['days'])):
        med = spread['maps'][med_i, k]
        width = spread['maps'][hi_i, k] - spread['maps'][lo_i, k]
        cropped, window = crop_to_support(med)
        r0, r1, c0, c1 = window
        extent = _extent_meters(window, rad_res, cell)

        fig, axes = plt.subplots(1, 2, figsize=(13, 5.6))
        panels = [(cropped, med_label),
                  (width[r0:r1, c0:c1],
                   '{:.0f}% credible-interval width'.format(
                       100 * (q[hi_i] - q[lo_i])))]
        for ax, (fld, label) in zip(axes, panels):
            masked = np.ma.masked_less_equal(fld, max(fld.max(), 1e-30)
                                             * 1e-3)
            # color scale ignores the origin block (holdback/“didn't fly”
            # mass dwarfs the dispersal spread on early days)
            im = ax.imshow(masked, cmap=alpha_viridis(), extent=extent,
                           vmax=vmax_excluding_origin(masked, window,
                                                      rad_res),
                           zorder=1)
            if locinfo is not None:
                for poly in locinfo.field_polys.values():
                    ax.plot(*np.vstack([poly, poly[:1]]).T, 'r-', lw=0.8,
                            zorder=2)
            ax.set_xlabel('meters east of release')
            ax.set_title(label)
            fig.colorbar(im, ax=ax, shrink=0.85)
        axes[0].set_ylabel('meters north of release')
        fig.suptitle('Posterior spread, day {} PR'.format(int(day)))
        out = '{}_d{}.png'.format(outfile_prefix, int(day))
        fig.savefig(out, dpi=150, bbox_inches='tight')
        plt.close(fig)
        outs.append(out)
    return outs


def main(argv=None, device=None):
    """The spread-map CLI; ``device`` given here wins over ``--device``.
    Returns the spread dict."""
    import argparse

    from .run import build_setup

    ap = argparse.ArgumentParser(prog='parasitoids_tpu_torch.bayes.spread')
    ap.add_argument('trace', nargs='?', default=None,
                    help='saved MCMC trace (npz path); omit with --prior')
    ap.add_argument('--prior', action='store_true',
                    help='prior spread: draw parameters from the joint '
                         'prior instead of a trace')
    # comma-separated (not nargs='+'): greedy nargs would swallow the
    # trailing key=value overrides every non-default run needs
    ap.add_argument('--days', default=None,
                    type=lambda s: [int(v) for v in s.split(',')],
                    help='comma-separated 1-based simulation days to map, '
                         'e.g. --days 3,18 (default: last day)')
    ap.add_argument('--draws', type=int, default=20)
    ap.add_argument('--quantiles', default=(0.05, 0.5, 0.95),
                    type=lambda s: [float(v) for v in s.split(',')],
                    help='comma-separated cell-wise quantiles '
                         '(default 0.05,0.5,0.95)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                    help='where to run (default cuda; no CPU fallback)')
    ap.add_argument('overrides', nargs='*',
                    help='key=value Params overrides matching the run')
    args = ap.parse_args(argv)
    if args.trace is None and not args.prior:
        ap.error('a trace path is required unless --prior is given')
    # a bare key=value first positional is a common slip with --prior; a
    # real trace path with --prior is a conflict (the trace would be
    # silently ignored), not a slip
    if args.prior and args.trace:
        if '=' in args.trace:
            args.overrides = [args.trace] + args.overrides
            args.trace = None
        else:
            ap.error('--prior takes no trace (got {!r}); drop one or '
                     'the other'.format(args.trace))
    from ..parallel.chains import visible_mesh
    device = args.device if device is None else device
    setup = build_setup(args.overrides, device=device)
    mesh = visible_mesh(device)
    if args.prior:
        spread = prior_spread(setup, n_draws=args.draws, days=args.days,
                              quantiles=args.quantiles, seed=args.seed,
                              mesh=mesh)
        base = 'prior_spread'
    else:
        path = (args.trace if args.trace.endswith('.npz')
                else args.trace + '.npz')
        with np.load(path) as npz:
            traces = npz['traces']
        spread = posterior_spread(setup, traces, n_draws=args.draws,
                                  days=args.days,
                                  quantiles=args.quantiles,
                                  seed=args.seed, mesh=mesh)
        base = path[:-4] + '_spread'
    print('wrote', save_spread(spread, base + '.npz'))
    try:
        outs = plot_spread(spread, setup.params, base,
                           locinfo=setup.locinfo)
        for o in outs:
            print('wrote', o)
    except ImportError as e:    # matplotlib is the optional 'viz' extra
        print('figures skipped (install the viz extra): {}'.format(e))
    return spread


if __name__ == '__main__':
    main()

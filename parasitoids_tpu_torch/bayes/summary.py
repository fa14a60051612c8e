"""One-command analysis report over a saved trace, PyTorch port of
``parasitoids_tpu/bayes/summary.py``.

The reference scatters its post-sampling analysis over four interactive
scripts (Bayes_Plot menus, Bayes_Run menus, CompareToData, hand-read HDF5
summaries).  ``python -m parasitoids_tpu_torch.bayes.summary <trace>
[--draws N] [--group point|date|block] [--seed S] [--device cpu]`` runs the
complete criticism stack in one pass and writes ``<trace>_report.md``:

* run metadata + posterior table (mean, sd, central 90% interval),
* convergence diagnostics (R-hat per parameter, pooled ESS, Geweke flag),
* posterior-predictive p-values per channel x statistic,
* WAIC / PSIS-LOO with reliability flags and the worst-fit observations,
* generated figures (trace plots, predictive overlays, LOO diagnostics)
  referenced inline.

Forward-model work (predictive draws, pointwise likelihoods) is bounded by
``--draws`` and runs through the ensemble (parallel/ensemble.py).  The
trace may come from either package's store (both are npz with ``traces``).
Without matplotlib (the optional 'viz' extra) the figures are skipped and
the report says so; every section is written all the same.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ['build_report', 'main']


def _posterior_table(traces, setup):
    from .priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES, obs_extra_names

    names = (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
             + ['sent_prob[{}]'.format(k) for k in setup.locinfo.sent_ids]
             + list(obs_extra_names(getattr(setup, 'obs_model',
                                            'poisson'))))
    flat = traces.reshape(-1, traces.shape[-1])
    lines = ['| parameter | mean | sd | 5% | 95% |',
             '|---|---|---|---|---|']
    for i, n in enumerate(names):
        col = flat[:, i]
        q5, q95 = np.percentile(col, [5, 95])
        lines.append('| {} | {:.5g} | {:.3g} | {:.5g} | {:.5g} |'.format(
            n, col.mean(), col.std(), q5, q95))
    lines.append('| log-posterior | {:.2f} | {:.2f} | — | — |'.format(
        flat[:, -1].mean(), flat[:, -1].std()))
    return '\n'.join(lines), names


def _diagnostics_section(traces, names):
    from .diagnostics import effective_sample_size, gelman_rubin, geweke

    out = []
    flat = traces.reshape(-1, traces.shape[-1])
    if traces.shape[0] >= 2:
        rhat = np.atleast_1d(gelman_rubin(traces[:, :, :len(names)]))
        bad = [(n, r) for n, r in zip(names, rhat) if r > 1.05]
        out.append('Gelman–Rubin R-hat: max {:.4f}{}'.format(
            float(np.max(rhat)),
            '' if not bad else ' — **{} parameter(s) above 1.05**: {}'
            .format(len(bad), ', '.join('{} ({:.3f})'.format(*b)
                                        for b in bad[:6]))))
    else:
        out.append('Gelman–Rubin: single chain (run `--chains 2+` for '
                   'R-hat).')
    ess_names = ('g_aw', 'sig_x', 'sig_y')
    ess = [effective_sample_size(flat[:, names.index(n)])
           for n in ess_names]
    out.append('Pooled ESS ({}): '.format(', '.join(ess_names))
               + ', '.join('{:.0f}'.format(e) for e in ess))
    gw = np.atleast_2d(geweke(flat[:, 0]))
    if gw.size:
        z = gw[:, -1]
        out.append('Geweke (g_aw): max |z| = {:.2f}{}'.format(
            float(np.abs(z).max()),
            ' — **non-stationary start, consider more burn-in**'
            if np.abs(z).max() > 3 else ''))
    else:
        out.append('Geweke: chain too short for segment comparison.')
    return '\n'.join('- ' + s for s in out)


def _figure(make, *args, **kwargs):
    """``make(*args, **kwargs)``'s result, or None without matplotlib."""
    try:
        return make(*args, **kwargs)
    except ImportError:
        return None


def _fig_line(what, path):
    return '- {}: {}'.format(what, '`{}`'.format(path) if path else
                             'skipped (matplotlib is not installed)')


def build_report(setup, traces, path, draws=100, seed=0, mesh=None,
                 group='date'):
    """Assemble the markdown report; returns the report path."""
    from ..viz import bayes_plot
    from .loo import (group_loglik, plot_loo, point_groups, pointwise_matrix,
                      psis_loo, waic)
    from .predictive import (plot_predictive, posterior_predictive,
                             predictive_pvalues, pvalue_report)

    traces = np.asarray(traces)
    if traces.ndim != 3 or traces.shape[1] == 0:
        raise SystemExit(
            'trace store has no posterior draws yet (shape {}) — an '
            'interrupted run? resume it first'.format(traces.shape))
    base = path[:-4] if path.endswith('.npz') else path
    meta = {}
    if os.path.exists(base + '.meta.json'):
        with open(base + '.meta.json') as fh:
            meta = json.load(fh)

    sec = ['# Analysis report: {}'.format(os.path.basename(base)), '']
    sec.append('- trace: {} chain(s) × {} samples × {} columns'.format(
        *traces.shape))
    if meta:
        sec.append('- meta: `{}`'.format(json.dumps(meta)))
    sec.append('')

    table, names = _posterior_table(traces, setup)
    sec += ['## Posterior', '', table, '']

    sec += ['## Convergence', '', _diagnostics_section(traces, names), '']

    # figures (trace plots land in ./diagnostics/)
    written = _figure(bayes_plot.plot_traces, traces)
    sec += ['## Figures', '',
            '- {} trace/Geweke figures in `./diagnostics/`'.format(
                len(written)) if written is not None else
            _fig_line('trace/Geweke figures', None)]

    pred = posterior_predictive(setup, traces, n_draws=draws, seed=seed,
                                mesh=mesh)
    pv = predictive_pvalues(setup, pred)
    ppath = _figure(plot_predictive, setup, pred, base + '_predictive.png')
    sec.append(_fig_line('predictive overlays', ppath))

    # posterior spread map of the final day (fields are D^2 per draw —
    # bounded tighter than the projection-space work above)
    from .spread import plot_spread, posterior_spread, save_spread
    spr = posterior_spread(setup, traces, n_draws=min(draws, 20),
                           seed=seed, mesh=mesh)
    save_spread(spr, base + '_spread.npz')
    spaths = _figure(plot_spread, spr, setup.params, base + '_spread',
                     locinfo=setup.locinfo)
    sec.append(_fig_line('posterior spread map (day {})'.format(
        int(spr['days'][0])), spaths[0] if spaths else None))

    ll, take = pointwise_matrix(setup, traces, n_draws=draws, seed=seed,
                                mesh=mesh)
    if group != 'point':
        gids, labels = point_groups(setup, by=group)
        gll = group_loglik(ll, gids)
        w, l = waic(gll), psis_loo(gll)
    else:
        from .loo import point_labels
        labels = point_labels(setup)
        w, l = waic(ll), psis_loo(ll)
    lpath = _figure(plot_loo, l, labels, base + '_loo.png')
    sec.append(_fig_line('LOO diagnostics', lpath))
    sec.append('')

    sec += ['## Posterior-predictive p-values', '', '```',
            pvalue_report(pv), '```', '']

    sec += ['## Predictive assessment (leave-one-{}-out)'.format(group), '']
    sec.append('- WAIC elpd: {:.2f} ± {:.2f} (p_waic {:.2f})'.format(
        w['elpd_waic'], w['se'], w['p_waic']))
    sec.append('- PSIS-LOO elpd: {:.2f} ± {:.2f} (p_loo {:.2f}); '
               '{} unit(s) with khat > 0.7{}'.format(
                   l['elpd_loo'], l['se'], l['p_loo'], l['n_bad_khat'],
                   ' — **refit those with `bayes.cv`**'
                   if l['n_bad_khat'] else ''))
    worst = np.argsort(l['elpd_pointwise'])[:5]
    sec.append('- worst-predicted: '
               + '; '.join('{} ({:+.1f})'.format(
                   labels[i], l['elpd_pointwise'][i]) for i in worst))
    sec.append('')

    # power-scaling sensitivity reuses the pointwise matrix's forward sims
    from .sensitivity import (plot_sensitivity, sensitivity_from_trace,
                              report as sens_report)
    sens = sensitivity_from_trace(setup, traces, n_draws=draws, seed=seed,
                                  mesh=mesh, pointwise=(ll, take))
    spath = _figure(plot_sensitivity, sens, base + '_sensitivity.png')
    flagged = [(n, d) for n, d in zip(sens['names'], sens['diagnosis'])
               if d]
    sec += ['## Prior/likelihood sensitivity (power-scaling)', '']
    if flagged:
        sec.append('- flagged: '
                   + '; '.join('{} — {}'.format(n, d) for n, d in flagged))
    else:
        sec.append('- no parameter flagged at threshold {}'.format(
            sens['threshold']))
    sec.append(_fig_line('sensitivity scatter', spath))
    sec += ['', '```', sens_report(sens), '```', '']

    out = base + '_report.md'
    with open(out, 'w') as fh:
        fh.write('\n'.join(sec))
    return out


def main(argv=None, device=None):
    """The report CLI; ``device`` given here wins over ``--device``.
    Returns the report's path."""
    import argparse

    from .run import build_setup

    ap = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.bayes.summary',
        description='one-command analysis report over a saved trace')
    ap.add_argument('trace', help='saved trace (npz path)')
    ap.add_argument('--draws', type=int, default=100,
                    help='posterior draws for predictive/LOO work')
    ap.add_argument('--group', choices=['point', 'date', 'block'],
                    default='date')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                    help='where to run (default cuda; no CPU fallback)')
    ap.add_argument('overrides', nargs='*',
                    help='key=value Params overrides matching the run')
    args = ap.parse_args(argv)
    from ..parallel.chains import visible_mesh
    device = args.device if device is None else device
    setup = build_setup(args.overrides, device=device)
    mesh = visible_mesh(device)

    path = (args.trace if args.trace.endswith('.npz')
            else args.trace + '.npz')
    with np.load(path) as npz:
        traces = npz['traces']
    out = build_report(setup, traces, path, draws=args.draws,
                       seed=args.seed, mesh=mesh, group=args.group)
    print('wrote', out)
    return out


if __name__ == '__main__':
    main()

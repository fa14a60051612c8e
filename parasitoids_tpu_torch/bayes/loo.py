"""Out-of-sample predictive assessment: WAIC and PSIS-LOO, PyTorch port
of ``parasitoids_tpu/bayes/loo.py``.

The reference has no cross-validation machinery at all — model adequacy is
judged by eye from the CompareToData overlays (Plot_SampleLocations.py,
Bayes_Run.py's saved traces are only ever plotted).  Here the fitted model
gets the modern information criteria (Vehtari, Gelman & Gabry 2017):

* **WAIC** — the widely applicable information criterion: in-sample lppd
  minus the pointwise posterior variance penalty,
* **PSIS-LOO** — leave-one-out expected log predictive density estimated
  by Pareto-smoothed importance sampling (no refits: the smoothed weights
  ``w_i^s ∝ 1/p(y_i | θ^s)`` reuse the posterior draws), with the per-point
  Pareto ``k_hat`` diagnostic flagging observations whose LOO estimate is
  unreliable,
* **loo_compare** — paired elpd difference ± SE between two fitted models
  on the same data (e.g. with/without the Kalbar pre-spread day).

The expensive part — one full forward simulation per posterior draw — runs
through the ensemble (parallel/ensemble.py, the members in turn on the
card); the pointwise log-pmf decomposition itself (model.py
``pointwise_loglik``) is a cheap pass over the projections, member by
member.  PSIS post-processing is host-side NumPy f64 (vi.py ``psis``),
sample-size-bounded.

CLI: ``python -m parasitoids_tpu_torch.bayes.loo <trace.npz> [--draws N]
[--device cpu] [k=v...]``
"""

from __future__ import annotations

import numpy as np
import torch

from .model import BayesSetup, _as_obs

__all__ = ['pointwise_matrix', 'waic', 'psis_loo', 'loo_compare',
           'point_labels', 'point_groups', 'group_loglik', 'plot_loo',
           'report']

_KHAT_WARN = 0.7      # Vehtari et al. (2017) reliability threshold
_P_WAIC_WARN = 0.4    # per-point penalty above which WAIC is suspect


# ----------------------------------------------------------------------
# pointwise log-likelihood matrix from a saved trace
# ----------------------------------------------------------------------

def pointwise_matrix(setup: BayesSetup, traces, n_draws=400, seed=0,
                     mesh=None):
    """(S, N) matrix of per-observation log-likelihoods for S posterior
    draws subsampled from a trace.

    Args:
        setup: the BayesSetup the trace was sampled against.
        traces: (n_chains, n_samples, dim) or (n_samples, dim) array in the
            standard trace layout (model block + obs block + logpost).
        n_draws: posterior draws to evaluate (each is one forward sim).
        mesh: optional 1-D device mesh; the draw axis is sharded over it,
            the draws rounded down to a multiple of its size (the mesh
            dropped when there are fewer draws than devices).
    Returns:
        (ll, rows): the float64 matrix and the flat trace rows used.
    """
    from ..parallel.ensemble import ensemble_projections
    from .predictive import subsample_draws
    from .priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES

    draws, take = subsample_draws(traces, n_draws, seed)
    if mesh is not None:
        # as the JAX function: the draw axis splits evenly over the
        # devices; round down to a multiple (or drop the mesh for tiny
        # subsamples)
        if draws.shape[0] < mesh.size:
            mesh = None
        else:
            size = draws.shape[0] - draws.shape[0] % mesh.size
            draws, take = draws[:size], take[:size]
    n_m = len(MODEL_PARAM_NAMES)
    n_o = len(OBS_PARAM_NAMES)
    m_draws = draws[:, :n_m].astype(np.float32)
    n_extra = getattr(setup, 'n_extra_obs', 0)
    o_draws = draws[:, n_m:n_m + n_o + setup.n_sent
                    + n_extra].astype(np.float32)

    rel, sent, grid = ensemble_projections(setup, m_draws, mesh=mesh)
    o_t = torch.as_tensor(o_draws).to(device=grid.device, dtype=grid.dtype)
    with torch.no_grad():
        ll = torch.stack([setup.pointwise_loglik(
            (tuple(r[b] for r in rel), tuple(s[b] for s in sent), grid[b]),
            _as_obs(o_t[b], setup.n_sent)) for b in range(o_t.shape[0])])
    return ll.cpu().numpy().astype(np.float64), take


def point_labels(setup: BayesSetup):
    """Human-readable label per column of the pointwise matrix, in the
    exact ravel order ``pointwise_loglik`` emits (release blocks, sentinel
    blocks, grid)."""
    labels = []
    for k, data in enumerate(setup.obs_release):
        n, d = tuple(data.shape)
        labels += ['release[{}] row {} date {}'.format(k, i, j)
                   for i in range(n) for j in range(d)]
    for k, data in enumerate(setup.obs_sentinel):
        field_ids = setup.locinfo.sent_ids
        n, d = tuple(data.shape)
        labels += ['sentinel[{}] field {} date {}'.format(k, field_ids[i], j)
                   for i in range(n) for j in range(d)]
    n, d = tuple(setup.obs_grid.shape)
    labels += ['grid point {} date {}'.format(i, j)
               for i in range(n) for j in range(d)]
    return labels


def point_groups(setup: BayesSetup, by='date'):
    """(group_ids, group_labels) partitioning the pointwise columns for
    grouped (leave-one-group-out) cross-validation.

    Counts from one field on one date are one sampling event, not
    independent hold-outs; pointwise LOO over-states the available
    information when observations within a group are correlated (Vehtari
    et al.; leave-one-group-out is the honest unit).  ``by='date'`` groups
    each block's observation column (one collection/sampling occasion);
    ``by='block'`` groups whole release/sentinel/grid channels."""
    if by not in ('date', 'block'):
        raise ValueError(by)
    ids = []
    labels = []

    def add(tag, n, d):
        g0 = len(labels)
        if by == 'block':
            labels.append(tag)
            ids.append(np.full(n * d, g0))
        else:
            labels.extend('{} date {}'.format(tag, j) for j in range(d))
            ids.append(np.tile(np.arange(g0, g0 + d), n))

    for k, data in enumerate(setup.obs_release):
        n, d = tuple(data.shape)
        add('release[{}]'.format(k), n, d)
    for k, data in enumerate(setup.obs_sentinel):
        n, d = tuple(data.shape)
        add('sentinel[{}]'.format(k), n, d)
    n, d = tuple(setup.obs_grid.shape)
    add('grid', n, d)
    return np.concatenate(ids), labels


def group_loglik(ll, group_ids):
    """Sum pointwise columns into per-group columns: (S, N) -> (S, G).
    Feed the result to ``waic``/``psis_loo`` for leave-one-group-out."""
    ll = np.asarray(ll, np.float64)
    group_ids = np.asarray(group_ids)
    n_g = int(group_ids.max()) + 1
    out = np.zeros((ll.shape[0], n_g))
    np.add.at(out.T, group_ids, ll.T)
    return out


# ----------------------------------------------------------------------
# information criteria (host NumPy f64 post-processing)
# ----------------------------------------------------------------------

def _logmeanexp(a, axis=0):
    mx = np.max(a, axis=axis)
    safe = np.where(np.isfinite(mx), mx, 0.0)
    out = safe + np.log(np.mean(np.exp(a - np.expand_dims(safe, axis)),
                                axis=axis))
    return np.where(np.isfinite(mx), out, mx)


def waic(ll):
    """Widely applicable information criterion from an (S, N) pointwise
    log-likelihood matrix: ``elpd_waic = lppd - p_waic`` with the variance
    penalty ``p_waic = sum_i Var_s[log p(y_i | θ^s)]``."""
    ll = np.asarray(ll, np.float64)
    n = ll.shape[1]
    lppd_i = _logmeanexp(ll, axis=0)
    p_i = ll.var(axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    return {
        'elpd_waic': float(elpd_i.sum()),
        'p_waic': float(p_i.sum()),
        'lppd': float(lppd_i.sum()),
        'se': float(np.sqrt(n * elpd_i.var(ddof=1))),
        'elpd_pointwise': elpd_i,
        'p_pointwise': p_i,
        'n_high_p': int((p_i > _P_WAIC_WARN).sum()),
    }


def psis_loo(ll):
    """PSIS-LOO elpd from an (S, N) pointwise log-likelihood matrix.

    Per observation the raw importance ratios are ``1/p(y_i | θ^s)``
    (log-weights ``-ll``); their Pareto-smoothed self-normalized average of
    ``p(y_i | θ^s)`` estimates the leave-one-out predictive density.
    ``khat[i] > 0.7`` marks points whose weight tail is too heavy for the
    estimate to be trusted (Vehtari et al. 2017)."""
    from scipy.special import logsumexp

    from .vi import psis

    ll = np.asarray(ll, np.float64)
    s, n = ll.shape
    elpd_i = np.empty(n)
    khat = np.empty(n)
    for i in range(n):
        logw, k = psis(-ll[:, i])
        logw = logw - logsumexp(logw)
        elpd_i[i] = logsumexp(logw + ll[:, i])
        khat[i] = k
    lppd = float(_logmeanexp(ll, axis=0).sum())
    elpd = float(elpd_i.sum())
    return {
        'elpd_loo': elpd,
        'p_loo': lppd - elpd,
        'se': float(np.sqrt(n * elpd_i.var(ddof=1))),
        'elpd_pointwise': elpd_i,
        'khat': khat,
        'n_bad_khat': int((khat > _KHAT_WARN).sum()),
        'khat_max': float(np.max(khat)) if n else np.nan,
    }


def loo_compare(res_a, res_b):
    """Paired elpd difference between two fits evaluated on the SAME
    observations (same pointwise column order): positive favors ``a``.
    The paired SE accounts for the correlation between the two models'
    pointwise scores (Vehtari et al. 2017, sec. 5.2)."""
    a = np.asarray(res_a['elpd_pointwise'], np.float64)
    b = np.asarray(res_b['elpd_pointwise'], np.float64)
    if a.shape != b.shape:
        raise ValueError('pointwise shapes differ: {} vs {}'.format(
            a.shape, b.shape))
    d = a - b
    return {'elpd_diff': float(d.sum()),
            'se_diff': float(np.sqrt(d.shape[0] * d.var(ddof=1)))}


def plot_loo(l, labels, outfile, worst=12):
    """Two-panel LOO diagnostic figure: sorted Pareto khat per observation
    against the 0.7 reliability threshold, and the worst-predicted
    observations by elpd contribution (viz conventions of
    viz/bayes_plot.py; single-hue marks, direct labels)."""
    import os

    import matplotlib
    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    khat = np.asarray(l['khat'], np.float64)
    elpd = np.asarray(l['elpd_pointwise'], np.float64)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.2))

    # infinite khat (PSIS tail fit failed -> unreliable) must plot ABOVE
    # the threshold so the figure agrees with the n_bad_khat count
    fin = khat[np.isfinite(khat)]
    cap = max(1.0, (fin.max() if fin.size else 0.0) + 0.1, _KHAT_WARN + 0.3)
    shown = np.where(np.isfinite(khat), khat, cap)
    order = np.argsort(shown)
    is_inf = ~np.isfinite(khat[order])
    xs = np.arange(khat.shape[0])
    ax1.plot(xs[~is_inf], shown[order][~is_inf], '.', ms=4, color='#31688e')
    if is_inf.any():
        ax1.plot(xs[is_inf], shown[order][is_inf], 'x', ms=4,
                 color='#b40426', label='tail fit failed (khat = inf)')
        ax1.legend(loc='upper left', fontsize=8)
    ax1.axhline(_KHAT_WARN, color='#b40426', lw=1, ls='--')
    ax1.text(0.02, _KHAT_WARN, ' khat = {}'.format(_KHAT_WARN),
             color='#b40426', va='bottom', transform=ax1.get_yaxis_transform())
    ax1.set_xlabel('observation (sorted)')
    ax1.set_ylabel('Pareto khat')
    ax1.set_title('PSIS reliability ({} of {} above threshold)'.format(
        l['n_bad_khat'], khat.shape[0]))
    ax1.grid(alpha=0.25)

    n = min(worst, elpd.shape[0])
    idx = np.argsort(elpd)[:n][::-1]
    ax2.barh(np.arange(n), elpd[idx], color='#31688e')
    ax2.set_yticks(np.arange(n))
    ax2.set_yticklabels([labels[i] if labels else str(i) for i in idx],
                        fontsize=8)
    ax2.set_xlabel('elpd contribution')
    ax2.set_title('worst-predicted observations')
    ax2.grid(alpha=0.25, axis='x')

    fig.tight_layout()
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def report(w, l, labels=None, worst=5, unit='points'):
    """Formatted summary of a waic() + psis_loo() pair."""
    lines = [
        'WAIC:     elpd {:.2f} +/- {:.2f}   p_waic {:.2f}   '
        '({} {} with high p_i)'.format(
            w['elpd_waic'], w['se'], w['p_waic'], w['n_high_p'], unit),
        'PSIS-LOO: elpd {:.2f} +/- {:.2f}   p_loo  {:.2f}   '
        'khat max {:.2f}   ({} points with khat > {})'.format(
            l['elpd_loo'], l['se'], l['p_loo'], l['khat_max'],
            l['n_bad_khat'], _KHAT_WARN),
    ]
    if labels is not None and worst:
        order = np.argsort(l['elpd_pointwise'])[:worst]
        lines.append('worst-predicted observations:')
        for i in order:
            lines.append('  {:<34s} elpd {:+.2f}  khat {:.2f}'.format(
                labels[i], l['elpd_pointwise'][i], l['khat'][i]))
    return '\n'.join(lines)


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def main(argv=None, device=None):
    """The WAIC / PSIS-LOO CLI; ``device`` given here wins over
    ``--device``.  Returns the written JSON payload."""
    import argparse
    import json
    import os

    from .run import build_setup

    ap = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.bayes.loo',
        description='WAIC / PSIS-LOO predictive assessment of a saved '
                    'trace')
    ap.add_argument('trace', help='saved MCMC/SMC/VI trace (npz path)')
    ap.add_argument('--draws', type=int, default=400,
                    help='posterior draws to evaluate (forward sims)')
    ap.add_argument('--group', choices=['point', 'date', 'block'],
                    default='point',
                    help='cross-validation unit: individual counts, one '
                         'sampling occasion (block x date), or whole '
                         'channels (leave-one-group-out)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                    help='where to run (default cuda; no CPU fallback)')
    ap.add_argument('--compare', metavar='trace2',
                    help='second trace over the SAME data: paired elpd '
                         'difference (positive favors the first trace)')
    ap.add_argument('overrides', nargs='*',
                    help='key=value Params overrides matching the run')
    args = ap.parse_args(argv)
    from ..parallel.chains import visible_mesh
    device = args.device if device is None else device
    setup = build_setup(args.overrides, device=device)
    mesh = visible_mesh(device)
    path = args.trace if args.trace.endswith('.npz') else args.trace + '.npz'
    with np.load(path) as npz:
        traces = npz['traces']
    ll, rows = pointwise_matrix(setup, traces, n_draws=args.draws,
                                seed=args.seed, mesh=mesh)
    unit = 'points'
    if args.group == 'point':
        labels = point_labels(setup)
        w = waic(ll)
    else:
        gids, labels = point_groups(setup, by=args.group)
        ll = group_loglik(ll, gids)
        print('leave-one-{}-out over {} groups'.format(args.group,
                                                       len(labels)))
        w = waic(ll)
        # the 0.4 penalty threshold is per OBSERVATION; a group's penalty
        # is ~the sum of its members', so scale by group size
        sizes = np.bincount(gids, minlength=len(labels)).astype(np.float64)
        w['n_high_p'] = int((w['p_pointwise'] > _P_WAIC_WARN * sizes).sum())
        unit = 'groups (size-scaled threshold)'
    l = psis_loo(ll)
    print(report(w, l, labels=labels, unit=unit))
    try:
        print('wrote', plot_loo(l, labels, path[:-4] + '_loo.png'))
    except ImportError as e:    # matplotlib is the optional 'viz' extra
        print('figure skipped (install the viz extra): {}'.format(e))

    if args.compare:
        path2 = (args.compare if args.compare.endswith('.npz')
                 else args.compare + '.npz')
        with np.load(path2) as npz:
            traces2 = npz['traces']
        # the second trace may come from a different OBSERVATION MODEL
        # (obs_model variants, VERDICT r3 item 6): score it under its own
        # likelihood — recorded in its meta sidecar — while the data and
        # pointwise column order stay identical, which is exactly what a
        # paired elpd comparison requires
        setup2 = setup
        meta2_path = path2[:-4] + '.meta.json'
        if os.path.exists(meta2_path):
            with open(meta2_path) as fh:
                om2 = json.load(fh).get('obs_model', 'poisson')
            if om2 != getattr(setup, 'obs_model', 'poisson'):
                print('scoring {} under its own obs_model={}'.format(
                    path2, om2))
                setup2 = build_setup(list(args.overrides)
                                     + ['obs_model=' + om2], device=device)
        ll2, _ = pointwise_matrix(setup2, traces2, n_draws=args.draws,
                                  seed=args.seed, mesh=mesh)
        if args.group != 'point':
            ll2 = group_loglik(ll2, gids)
        l2 = psis_loo(ll2)
        cmp_ = loo_compare(l, l2)
        compare_payload = {
            'trace2': path2, 'elpd_loo_2': float(l2['elpd_loo']),
            'elpd_diff': float(cmp_['elpd_diff']),
            'se_diff': float(cmp_['se_diff']),
        }
        print('paired comparison vs {}:'.format(path2))
        print('  elpd: {:.2f} vs {:.2f}'.format(l['elpd_loo'],
                                                l2['elpd_loo']))
        print('  elpd difference: {:+.2f} +/- {:.2f}  ({})'.format(
            cmp_['elpd_diff'], cmp_['se_diff'],
            'first trace predicts better'
            if cmp_['elpd_diff'] > 2 * cmp_['se_diff'] else
            'second trace predicts better'
            if cmp_['elpd_diff'] < -2 * cmp_['se_diff'] else
            'no clear preference at 2 SE'))

    out = path[:-4] + '_loo.json'
    payload = {
        'n_draws': int(ll.shape[0]), 'n_points': int(ll.shape[1]),
        'group': args.group,
        'waic': {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in w.items()},
        'psis_loo': {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in l.items()},
    }
    if args.compare:
        payload['compare'] = compare_payload
    with open(out, 'w') as fh:
        json.dump(payload, fh)
    print('wrote', out)
    return payload


if __name__ == '__main__':
    main()

"""Posterior- and prior-predictive checks, PyTorch port of
``parasitoids_tpu/bayes/predictive.py``.

No reference equivalent: the reference can only re-run ``Run.py`` per
parameter set by hand.  Here draws from a saved trace run as an ensemble
of forward simulations (parallel/ensemble.py, the members in turn on the
card) and are compared to the observed field data on every channel:

    python -m parasitoids_tpu_torch.bayes.predictive runs/kalbar --draws 20
    python -m parasitoids_tpu_torch.bayes.predictive --prior --draws 20

write ``<trace>_predictive.png`` / ``prior_predictive.png`` — observed
counts against the predictive distribution (thinned through the same
observation model as the likelihood) for grid adults, release-field
emergence and sentinel-field emergence.  ``--prior`` draws parameters
from the exact joint prior (priors.py samplers) instead of a trace — the
standard before-you-fit check that the priors generate data on the right
scale.  ``simulate_observations`` is the single-draw synthetic-data
generator the SBC harness (bayes/sbc.py) is built on.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..viz import _mpl
from .model import BayesSetup, _as_model
from .priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES

__all__ = ['posterior_predictive', 'prior_predictive', 'prior_draws',
           'simulate_observations', 'plot_predictive',
           'predictive_pvalues', 'pvalue_report', 'subsample_draws',
           'main']



def _sample_counts(rng, rate, obs_model='poisson', od=0.0):
    """Draw observed counts from the configured observation model (host
    numpy RNG) — must mirror model.py's likelihood dispatch exactly so
    PPC/SBC data come from the same process the likelihood scores."""
    rate = np.maximum(np.asarray(rate, np.float64), 0.0)
    if obs_model == 'negbin':
        r = float(od)
        p = np.clip(r / (r + rate), 1e-12, 1.0)
        return rng.negative_binomial(r, p)
    if obs_model == 'zip':
        y = rng.poisson(rate)
        return np.where(rng.random(rate.shape) < float(od), 0, y)
    return rng.poisson(rate)


def subsample_draws(traces, n_draws, seed):
    """Flatten a (n_chains, n_samples, dim) or (n_samples, dim) trace and
    subsample ``n_draws`` rows without replacement (seeded).  Returns
    ``(rows, take)`` — the selected rows and their flat indices.  Shared by
    every draw-consuming tool (predictive, spread) so subsampling behavior
    cannot drift between CLIs."""
    traces = np.asarray(traces)
    if traces.ndim == 2:
        traces = traces[None]
    flat = traces.reshape(-1, traces.shape[-1])
    rng = np.random.default_rng(seed)
    take = rng.choice(flat.shape[0], size=min(n_draws, flat.shape[0]),
                      replace=False)
    return flat[take], take


def posterior_predictive(setup: BayesSetup, traces, n_draws=20, seed=0,
                         mesh=None):
    """Thinned-Poisson predictive samples for ``n_draws`` posterior draws.

    Args:
        setup: the BayesSetup the trace was sampled against.
        traces: (n_chains, n_samples, dim) or (n_samples, dim) trace array
            (model block + obs block [+ sentinel probs] + logpost).
    Returns:
        dict with 'grid', 'release', 'sentinel' — lists/arrays of Poisson
        predictive draws with leading axis n_draws — plus the expected
        rates under each draw.
    """
    from ..parallel.ensemble import ensemble_projections

    draws, take = subsample_draws(traces, n_draws, seed)
    rng = np.random.default_rng(seed)

    n_m = len(MODEL_PARAM_NAMES)
    n_o = len(OBS_PARAM_NAMES)
    obs_model = getattr(setup, 'obs_model', 'poisson')
    n_extra = getattr(setup, 'n_extra_obs', 0)
    m_draws = draws[:, :n_m].astype(np.float32)
    o_draws = draws[:, n_m:n_m + n_o + setup.n_sent
                    + n_extra].astype(np.float32)

    rel, sent, grid = _host(ensemble_projections(setup, m_draws, mesh=mesh))

    out = {'grid_rate': [], 'grid': [], 'release': [], 'sentinel': [],
           'draw_rows': take}
    gs = _np(setup.grid_samples)
    eff = [_np(e) for e in setup.release_effort]
    for b in range(m_draws.shape[0]):
        xi, em_p, grid_p = o_draws[b, 0], o_draws[b, 1], o_draws[b, 2]
        sent_p = o_draws[b, 4:4 + setup.n_sent]
        od = o_draws[b, 4 + setup.n_sent] if n_extra else 0.0
        g_rate = grid_p * gs * grid[b]
        out['grid_rate'].append(g_rate)
        out['grid'].append(_sample_counts(rng, g_rate, obs_model, od))
        rel_b = [_sample_counts(
            rng, xi * np.asarray(rel[k][b]) * (eff[k] * em_p)[:, None],
            obs_model, od) for k in range(len(rel))]
        sent_b = [_sample_counts(
            rng, xi * np.asarray(sent[k][b]) * sent_p[:, None],
            obs_model, od) for k in range(len(sent))]
        out['release'].append(rel_b)
        out['sentinel'].append(sent_b)
    out['grid'] = np.stack(out['grid'])
    out['grid_rate'] = np.stack(out['grid_rate'])
    return out


def prior_predictive(setup: BayesSetup, n_draws=20, seed=0, mesh=None,
                     draws=None):
    """Predictive samples under parameters drawn from the exact joint
    prior (no trace needed) — same output structure as
    ``posterior_predictive``.  The parameters come from the port's prior
    samplers on a CPU generator seeded with ``seed``, or from ``draws``,
    ``(model (n, 15), obs (n, n_obs))`` arrays, so that a test can replay
    another sampler's draws."""
    m, o = prior_draws(setup, n_draws, seed) if draws is None else draws
    rows = np.concatenate([np.asarray(m, np.float32),
                           np.asarray(o, np.float32)], axis=1)
    return posterior_predictive(setup, rows[None], n_draws=n_draws,
                                seed=seed, mesh=mesh)


def prior_draws(setup: BayesSetup, n_draws, seed):
    """``n_draws`` model and observation blocks from the joint prior
    (``priors.sample_prior_*``) on a CPU generator seeded with ``seed``;
    f32 numpy."""
    from .priors import sample_prior_model, sample_prior_obs
    gen = torch.Generator().manual_seed(int(seed))
    m = sample_prior_model(gen, n_draws)
    o = sample_prior_obs(gen, _np(setup.field_areas), setup.min_field_area,
                         setup.obs_model, n_draws)
    return m.numpy(), o.numpy()


def _np(t):
    """A tensor (on any device) as numpy."""
    return t.detach().cpu().numpy()


def _host(proj):
    """Ensemble projections ``(rel, sent, grid)`` as numpy."""
    rel, sent, grid = proj
    return [_np(r) for r in rel], [_np(s) for s in sent], _np(grid)


def simulate_observations(setup: BayesSetup, m_vec, o_vec, rng):
    """One synthetic-data draw ``y ~ p(y | m, o)``: the forward model's
    projections pushed through the same thinned-Poisson observation model
    the likelihood evaluates (model.py ``log_likelihood``), sampled.

    Returns ``{'release': [..], 'sentinel': [..], 'grid': arr}`` with
    exactly the shapes of ``setup.obs_release`` / ``obs_sentinel`` /
    ``obs_grid`` — ready for ``BayesSetup.with_observations`` (the SBC
    replicate constructor).
    """
    s = setup.setup
    m = _as_model(torch.as_tensor(np.asarray(m_vec, np.float32)).to(
        device=s.wind_flat.device, dtype=s.wind_flat.dtype))
    o = np.asarray(o_vec, np.float32)
    with torch.no_grad():
        rel, sent, grid = _host(setup.forward_projections(m))
    xi, em_p, grid_p = o[0], o[1], o[2]
    sent_p = o[4:4 + setup.n_sent]
    obs_model = getattr(setup, 'obs_model', 'poisson')
    od = (o[4 + setup.n_sent]
          if getattr(setup, 'n_extra_obs', 0) else 0.0)
    eff = [_np(e) for e in setup.release_effort]
    out = {
        'release': [_sample_counts(
            rng, xi * r * (eff[k] * em_p)[:, None],
            obs_model, od) for k, r in enumerate(rel)],
        'sentinel': [_sample_counts(
            rng, xi * s * sent_p[:, None], obs_model, od)
            for s in sent],
        'grid': _sample_counts(
            rng, grid_p * _np(setup.grid_samples) * grid, obs_model, od),
    }
    return out


_PPC_STATS = {
    'total': np.sum,
    'max': np.max,
    'zero_frac': lambda a: float(np.mean(np.asarray(a) == 0)),
}


def predictive_pvalues(setup: BayesSetup, pred):
    """Posterior-predictive p-values per channel and test statistic:
    ``p = P(T(y_rep) >= T(y_obs))`` with the (1 + k)/(1 + B) finite-draw
    correction (Gelman et al., BDA ch. 6).  Extreme values (< 0.05 or
    > 0.95) mark channels where the fitted model cannot reproduce the
    observed statistic — a quantitative companion to the predictive
    overlay plots, which the reference only ever eyeballs
    (CompareToData.py).

    Returns ``{channel: {stat: p}}`` over the grid, each release block,
    and each sentinel block."""
    out = {}

    def pvals(obs, rep_list):
        res = {}
        b = len(rep_list)
        for name, T in _PPC_STATS.items():
            t_obs = float(T(np.asarray(obs)))
            t_rep = np.array([float(T(np.asarray(r))) for r in rep_list])
            res[name] = float((1 + np.sum(t_rep >= t_obs)) / (1 + b))
        return res

    # channels can be empty for a site (the real-Carnarvon record is
    # sentinel-only — no grid or release-field sampling exists); an empty
    # observation array has no test statistics, so skip, don't crash
    if setup.obs_grid.numel():
        out['grid'] = pvals(_np(setup.obs_grid), list(pred['grid']))
    for k, data in enumerate(setup.obs_release):
        data = _np(data)
        if not data.size:
            continue
        out['release[{}]'.format(k)] = pvals(
            data, [draw[k] for draw in pred['release']])
    for k, data in enumerate(setup.obs_sentinel):
        data = _np(data)
        if not data.size:
            continue
        out['sentinel[{}]'.format(k)] = pvals(
            data, [draw[k] for draw in pred['sentinel']])
    return out


def pvalue_report(pv, lo=0.05, hi=0.95):
    """Formatted p-value table; extreme entries flagged with '!'."""
    stats = list(_PPC_STATS)
    lines = ['{:<14s}'.format('channel')
             + ''.join('{:>12s}'.format(s) for s in stats)]
    for ch, d in pv.items():
        row = '{:<14s}'.format(ch)
        for s in stats:
            p = d[s]
            row += '{:>10.3f}{:2s}'.format(p, ' !' if (p < lo or p > hi)
                                           else '')
        lines.append(row)
    n_bad = sum(1 for d in pv.values() for p in d.values()
                if p < lo or p > hi)
    lines.append('{} extreme statistic(s) (p < {} or > {})'.format(
        n_bad, lo, hi))
    return '\n'.join(lines)


def plot_predictive(setup: BayesSetup, pred, outfile, label='posterior'):
    """Observed vs predictive distributions per channel."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))

    def _empty(ax, title):
        ax.text(0.5, 0.5, 'no data for this site', ha='center',
                va='center', transform=ax.transAxes, color='0.5')
        ax.set_title(title)

    # grid adults: total count per observation day (empty channels are
    # real: the real-Carnarvon record is sentinel-only)
    if setup.obs_grid.numel():
        g_tot = pred['grid'].sum(axis=1)         # (B, n_dates)
        obs_tot = _np(setup.obs_grid).sum(axis=0)
        x = np.arange(g_tot.shape[1])
        axes[0].violinplot([g_tot[:, d] for d in range(g_tot.shape[1])],
                           positions=x, widths=0.7)
        axes[0].plot(x, obs_tot, 'k_', markersize=20, label='observed')
        axes[0].set_title('grid adult totals per obs day')
        axes[0].set_xlabel('observation day')
        axes[0].legend()
    else:
        _empty(axes[0], 'grid adult totals per obs day')

    # release-field emergence totals per collection (per-channel SIZE
    # check, like predictive_pvalues: a present-but-empty channel must
    # draw the 'no data' placeholder, not a degenerate all-zero violin)
    if any(o.numel() for o in setup.obs_release):
        r_tot = np.array([[rb.sum() for rb in draw]
                          for draw in pred['release']])
        obs_r = [_np(o).sum() for o in setup.obs_release]
        axes[1].violinplot([r_tot[:, k] for k in range(r_tot.shape[1])],
                           positions=np.arange(r_tot.shape[1]), widths=0.7)
        axes[1].plot(np.arange(len(obs_r)), obs_r, 'k_', markersize=20,
                     label='observed')
        axes[1].set_title('release-field emergence totals')
        axes[1].set_xlabel('collection')
        axes[1].legend()
    else:
        _empty(axes[1], 'release-field emergence totals')

    # sentinel emergence totals per field (same guard: a sentinel-free
    # site would otherwise crash np.concatenate([]))
    if any(o.numel() for o in setup.obs_sentinel):
        s_tot = np.stack([np.concatenate(
            [sb.sum(axis=1) for sb in draw]) for draw in pred['sentinel']])
        obs_s = np.concatenate(
            [_np(o).sum(axis=1) for o in setup.obs_sentinel])
        xs = np.arange(s_tot.shape[1])
        axes[2].violinplot([s_tot[:, i] for i in xs], positions=xs,
                           widths=0.7)
        axes[2].plot(xs, obs_s, 'k_', markersize=20, label='observed')
        axes[2].set_title('sentinel emergence totals per field')
        axes[2].set_xlabel('sentinel field')
        axes[2].legend()
    else:
        _empty(axes[2], 'sentinel emergence totals per field')

    fig.suptitle('{} predictive ({} draws) vs observed'.format(
        label, pred['grid'].shape[0]))
    fig.tight_layout()
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def main(argv=None, device=None):
    """The predictive-check CLI; ``device`` given here wins over
    ``--device``.  Returns the p-values."""
    import argparse

    from .run import build_setup

    ap = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.bayes.predictive')
    ap.add_argument('trace', nargs='?', default=None,
                    help='saved MCMC trace (npz path); omit with --prior')
    ap.add_argument('--prior', action='store_true',
                    help='prior-predictive: draw parameters from the joint '
                         'prior instead of a trace')
    ap.add_argument('--draws', type=int, default=100,
                    help='posterior draws in the predictive ensemble; '
                         'p-values carry the (1+k)/(1+B) finite-draw '
                         'correction, so bands tighter than ~1/B need '
                         'at least that many draws (default 100)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                    help='where to run (default cuda; no CPU fallback)')
    ap.add_argument('--json', action='store_true',
                    help='also write the p-value table to '
                         '<trace>_ppc<draws>.json (prior_ppc<draws>.json '
                         'with --prior) for study summaries')
    ap.add_argument('overrides', nargs='*',
                    help='key=value Params overrides matching the run')
    args = ap.parse_args(argv)
    if args.trace is None and not args.prior:
        ap.error('a trace path is required unless --prior is given')
    # a bare key=value first positional is a common slip with --prior
    if args.prior and args.trace and '=' in args.trace:
        args.overrides = [args.trace] + args.overrides
        args.trace = None
    from ..parallel.chains import visible_mesh
    device = args.device if device is None else device
    setup = build_setup(args.overrides, device=device)
    mesh = visible_mesh(device)

    def write_json(pv, jpath, n_draws):
        import json
        import time as _time
        payload = {'draws': n_draws, 'seed': args.seed,
                   'date': _time.strftime('%Y-%m-%d'), 'pvalues': pv}
        with open(jpath, 'w') as f:
            json.dump(payload, f, indent=1)
        print('wrote', jpath)

    if args.prior:
        pred = prior_predictive(setup, n_draws=args.draws, seed=args.seed,
                                mesh=mesh)
        pv = predictive_pvalues(setup, pred)
        print(pvalue_report(pv))
        if args.json:
            write_json(pv, 'prior_ppc{}.json'.format(args.draws),
                       args.draws)
        _write_plot(setup, pred, 'prior_predictive.png', label='prior')
        return pv
    else:
        path = (args.trace if args.trace.endswith('.npz')
                else args.trace + '.npz')
        with np.load(path) as npz:
            traces = npz['traces']
        pred = posterior_predictive(setup, traces, n_draws=args.draws,
                                    seed=args.seed, mesh=mesh)
        out = path[:-4] + '_predictive.png'
    pv = predictive_pvalues(setup, pred)
    print(pvalue_report(pv))
    if args.json:
        write_json(pv, path[:-4] + '_ppc{}.json'.format(args.draws),
                   args.draws)
    _write_plot(setup, pred, out)
    return pv


def _write_plot(setup, pred, out, label='posterior'):
    try:
        print('wrote', plot_predictive(setup, pred, out, label=label))
    except ImportError as e:    # matplotlib is the optional 'viz' extra
        print('figure skipped (install the viz extra): {}'.format(e))


if __name__ == '__main__':
    main()

"""MCMC diagnostics plots (L5), the port's copy of
``parasitoids_tpu/viz/bayes_plot.py`` (numpy and matplotlib only).

Rebuilds ``Bayes_Plot.py``: trace plots with Geweke z-score panels saved to
``./diagnostics/``, and posterior histograms grouped the same way as the
reference (f/g take-off parameters :147-209, spread covariances :213-290,
sentinel observation probabilities :294-328, remaining scalars :332-375) —
driven from our npz trace store instead of a PyMC HDF5 database.
"""

from __future__ import annotations

import os

import numpy as np

from ..bayes.diagnostics import geweke
from ..bayes.priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES

__all__ = ['plot_traces', 'plot_f_g', 'plot_sprd_vars',
           'plot_sent_obs_probs', 'plot_other', 'plot_pt_ladder', 'main']


from . import _mpl   # shared headless-backend helper

def _param_names(n_total, obs_model='poisson'):
    """Column names from the trace width.  ``obs_model`` matters for
    variant traces (obs_model != 'poisson' appends one extra slot after
    the sentinel probabilities — priors.obs_extra_names); callers with a
    meta sidecar should pass its recorded value, else the extra column
    would be miscounted as a sentinel probability."""
    from ..bayes.priors import obs_extra_names
    extra = list(obs_extra_names(obs_model))
    n_sent = (n_total - len(MODEL_PARAM_NAMES) - len(OBS_PARAM_NAMES)
              - len(extra) - 1)
    return (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES) +
            ['sent_obs_prob_{}'.format(i) for i in range(n_sent)] +
            extra + ['log_posterior'])


def _flatten(traces):
    traces = np.asarray(traces)
    if traces.ndim == 2:
        traces = traces[None]
    return traces


def plot_traces(traces, outdir='./diagnostics', start=0, stop=None,
                select=None, obs_model='poisson'):
    """Per-parameter trace plot + Geweke z-scores
    (ref Bayes_Plot.py:28-143).

    ``start``/``stop`` window the trace (the reference menus' start/stop
    arguments, Bayes_Run.py:540-702); ``select`` optionally names a subset
    of parameters to plot (per-variable selection from the same menus)."""
    plt = _mpl()
    os.makedirs(outdir, exist_ok=True)
    traces = _flatten(traces)[:, start:stop, :]
    names = _param_names(traces.shape[-1], obs_model)
    if select:
        unknown = sorted(set(select) - set(names))
        if unknown:
            raise ValueError('unknown parameter name(s) {}; known: {}'
                             .format(unknown, names))
    written = []
    for i, name in enumerate(names):
        if select and name not in select:
            continue
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=False)
        for c in range(traces.shape[0]):
            ax1.plot(traces[c, :, i], lw=0.6)
        ax1.set_title('{} trace'.format(name))
        gz = geweke(traces[0, :, i])
        if len(gz):
            ax2.plot(gz[:, 0], gz[:, 1], 'o')
            ax2.axhline(2, color='r', ls='--')
            ax2.axhline(-2, color='r', ls='--')
        ax2.set_title('Geweke z-scores')
        fig.tight_layout()
        path = os.path.join(outdir, 'trace_{}.png'.format(name))
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written


def _hist_group(traces, idxs, title, outfile, start=0,
                obs_model='poisson'):
    plt = _mpl()
    traces = _flatten(traces)
    names = _param_names(traces.shape[-1], obs_model)
    flat = traces[:, start:, :].reshape(-1, traces.shape[-1])
    n = len(idxs)
    ncol = min(n, 3)
    nrow = -(-n // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3 * nrow),
                             squeeze=False)
    for k, i in enumerate(idxs):
        ax = axes[k // ncol][k % ncol]
        ax.hist(flat[:, i], bins=40, density=True, alpha=0.8)
        ax.set_title(names[i])
    for k in range(n, nrow * ncol):
        axes[k // ncol][k % ncol].axis('off')
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(outfile, dpi=120)
    plt.close(fig)
    return outfile


def plot_f_g(traces, outdir='./diagnostics', start=0):
    """Take-off function posteriors (ref Bayes_Plot.py:147-209)."""
    idxs = [MODEL_PARAM_NAMES.index(k)
            for k in ('g_aw', 'g_bw', 'f_a1', 'f_b1_p', 'f_a2', 'f_b2_p')]
    os.makedirs(outdir, exist_ok=True)
    return _hist_group(traces, idxs, 'take-off f/g parameters',
                       os.path.join(outdir, 'posterior_f_g.png'), start)


def plot_sprd_vars(traces, outdir='./diagnostics', start=0):
    """Spread covariance posteriors (ref Bayes_Plot.py:213-290)."""
    idxs = [MODEL_PARAM_NAMES.index(k)
            for k in ('sig_x', 'sig_y', 'corr_p', 'sig_xl', 'sig_yl',
                      'corr_l_p')]
    os.makedirs(outdir, exist_ok=True)
    return _hist_group(traces, idxs, 'diffusion parameters',
                       os.path.join(outdir, 'posterior_sprd.png'), start)


def plot_sent_obs_probs(traces, outdir='./diagnostics', start=0,
                        obs_model='poisson'):
    """Sentinel observation probability posteriors
    (ref Bayes_Plot.py:294-328)."""
    traces = _flatten(traces)
    from ..bayes.priors import obs_extra_names
    n_total = traces.shape[-1] - len(obs_extra_names(obs_model))
    first = len(MODEL_PARAM_NAMES) + len(OBS_PARAM_NAMES)
    idxs = list(range(first, n_total - 1))
    os.makedirs(outdir, exist_ok=True)
    return _hist_group(traces, idxs, 'sentinel observation probabilities',
                       os.path.join(outdir, 'posterior_sent_obs.png'),
                       start)


def plot_other(traces, outdir='./diagnostics', start=0):
    """Remaining scalar posteriors (ref Bayes_Plot.py:332-375)."""
    idxs = [MODEL_PARAM_NAMES.index(k)
            for k in ('lam', 'n_periods', 'mu_r')]
    idxs += [len(MODEL_PARAM_NAMES) + OBS_PARAM_NAMES.index(k)
             for k in ('xi', 'em_obs_prob', 'grid_obs_prob', 'A_collected')]
    os.makedirs(outdir, exist_ok=True)
    return _hist_group(traces, idxs, 'other parameters',
                       os.path.join(outdir, 'posterior_other.png'), start)


def plot_pt_ladder(betas, logliks, swap_attempts, swap_accepts,
                   burn=0, outdir='./diagnostics'):
    """Parallel-tempering ladder diagnostics (no reference counterpart —
    the reference has no tempering).  One figure, three panels:

    * per-rung swap acceptance — healthy ladders sit in ~[0.2, 0.6]
      everywhere; a 0 rung means the ladder has a gap there,
    * the thermodynamic-integration integrand, post-burn
      ``E_beta[loglik]`` vs beta — the shaded area IS the log evidence
      when the ladder reaches beta = 0,
    * per-replica log-likelihood traces (equilibration check).
    """
    plt = _mpl()
    os.makedirs(outdir, exist_ok=True)
    betas = np.asarray(betas, float)
    ll = np.asarray(logliks, float)
    T = betas.shape[0]
    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, figsize=(8, 11))

    rates = np.asarray(swap_accepts, float) / np.maximum(
        np.asarray(swap_attempts, float), 1.0)
    ax1.bar(np.arange(T - 1), rates, color='#3b6ea5')
    ax1.set_xticks(np.arange(T - 1))
    ax1.set_xticklabels(['{:.2g}↔{:.2g}'.format(betas[i], betas[i + 1])
                         for i in range(T - 1)], fontsize=8)
    ax1.set_ylim(0, 1)
    ax1.axhspan(0.2, 0.6, color='green', alpha=0.12)
    ax1.set_ylabel('swap acceptance')
    ax1.set_title('replica-exchange ladder')

    mean_ll = ll[:, burn:].mean(axis=1)
    order = np.argsort(betas)
    ax2.plot(betas[order], mean_ll[order], 'o-', color='#a53b3b')
    ax2.fill_between(betas[order], mean_ll[order], mean_ll[order].min(),
                     alpha=0.15, color='#a53b3b')
    ax2.set_xlabel('inverse temperature beta')
    ax2.set_ylabel('E_beta[log likelihood]')
    ax2.set_title('thermodynamic-integration integrand')

    for t in range(T):
        ax3.plot(ll[t], lw=0.6, label='beta={:.2g}'.format(betas[t]))
    if burn:
        ax3.axvline(burn, color='k', ls='--', lw=0.8)
    ax3.set_xlabel('step')
    ax3.set_ylabel('log likelihood')
    ax3.legend(fontsize=7, ncol=2)
    fig.tight_layout()
    out = os.path.join(outdir, 'pt_ladder.png')
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def main(argv=None):
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print('usage: python -m parasitoids_tpu_torch.viz.bayes_plot '
              '<trace.npz> [start]')
        return
    path = argv[0] if argv[0].endswith('.npz') else argv[0] + '.npz'
    with np.load(path) as npz:
        traces = npz['traces']
    min_dim = len(MODEL_PARAM_NAMES) + len(OBS_PARAM_NAMES) + 1
    if traces.shape[1] == 0 or traces.shape[-1] < min_dim:
        # a checkpoint saved mid-burn-in / pre-posterior stores a
        # placeholder trace block — nothing to plot yet
        print('store has no posterior draws yet (trace shape {}) — '
              'resume the run first'.format(traces.shape))
        return
    start = int(argv[1]) if len(argv) > 1 else 0
    # variant traces carry one extra obs column; the meta sidecar names it
    obs_model = 'poisson'
    meta_path0 = path[:-4] + '.meta.json'
    if os.path.exists(meta_path0):
        import json
        with open(meta_path0) as fh:
            obs_model = json.load(fh).get('obs_model', 'poisson')
    plot_traces(traces, start=start, obs_model=obs_model)
    plot_f_g(traces, start=start)
    plot_sprd_vars(traces, start=start)
    plot_sent_obs_probs(traces, start=start, obs_model=obs_model)
    plot_other(traces, start=start)
    from ..bayes.store import load_extras
    ex = load_extras(path)
    # a --sampler pt store: ladder diagnostics.  SMC stores also save
    # 'betas' (their anneal path) but no per-rung loglik/swap arrays
    if 'betas' in ex and 'loglik' in ex and 'swap_attempts' in ex:
        import json
        meta_path, burn = path[:-4] + '.meta.json', 0
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                burn = int(json.load(fh).get('burn', 0))
        plot_pt_ladder(ex['betas'], ex['loglik'], ex['swap_attempts'],
                       ex['swap_accepts'],
                       burn=min(burn, ex['loglik'].shape[1] - 1))
    print('diagnostics written to ./diagnostics/')


if __name__ == '__main__':
    main()

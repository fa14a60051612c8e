"""Parameter-identifiability analysis from the exact posterior curvature,
PyTorch port of ``parasitoids_tpu/bayes/identify.py``.

Beyond-reference capability: the reference's ``pm.NormApprox``
(Bayes_MAP.py:521-569) prints means and variances and stops — and with a
finite-difference Fortran stack it could go no further.  This rebuild's
posterior is differentiable end to end, so the exact Hessian at the MAP
(``map_fit.laplace_approximation``) supports the classic sloppy-model
analysis (Gutenkunst et al. 2007, PLoS Comput Biol 3:e189):

* **prior → posterior contraction** per parameter (how much the field
  data actually constrains each of the ~20 parameters, vs riding its
  prior),
* **posterior correlations** (which parameters the data only constrains
  jointly — e.g. the classic σ/λ trade-offs),
* **eigen-spectrum of the unconstrained-space covariance**: stiff
  directions (well-determined parameter combinations) vs sloppy ones
  (combinations the experiment cannot see), with the dominant parameter
  loadings of each.

CLI::

    python -m parasitoids_tpu_torch.bayes.identify [-o report.txt]
        [--steps N] [--device cpu] [key=value overrides]

runs a MAP fit + Laplace approximation at the reference's MAP domain and
writes the report.
"""

from __future__ import annotations

import numpy as np

from .model import BayesSetup
from .priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES

__all__ = ['prior_sds', 'identifiability', 'identify_report',
           'plot_identifiability', 'main']

_FIXED_MODEL_SLOTS = (13,)     # n_periods is held fixed in MAP (ref
                               # Bayes_MAP.py:144-147)


def _theta_names(setup):
    from .priors import obs_extra_names
    return (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
            + ['sent_obs_prob_{}'.format(k)
               for k in setup.locinfo.sent_ids]
            + list(obs_extra_names(getattr(setup, 'obs_model',
                                           'poisson'))))


def prior_sds(setup: BayesSetup, n=4000, seed=0, draws=None):
    """Monte-Carlo prior standard deviations of every constrained
    parameter (model block + observation block), via the exact prior
    samplers (priors.py) on a CPU generator seeded with ``seed``, or from
    ``draws``, ``(model (n, 15), obs (n, n_obs))`` arrays, so that a test
    can replay another sampler's draws."""
    from .predictive import prior_draws
    m, o = prior_draws(setup, n, seed) if draws is None else draws
    m = np.asarray(m, np.float32).astype(np.float64)
    o = np.asarray(o, np.float32).astype(np.float64)
    return np.concatenate([m.std(axis=0), o.std(axis=0)])


def identifiability(setup: BayesSetup, fit, lap, n_prior=4000, seed=0,
                    prior_draws=None):
    """Assemble the identifiability summary from a MAP fit + Laplace
    approximation.  Returns a dict: per-parameter table arrays
    (``names``, ``map``, ``post_sd``, ``prior_sd``, ``contraction``),
    the posterior correlation matrix (``corr``), and the z-space
    eigen-analysis (``eig_sd``, ``eig_vec``, ``z_names`` — ascending
    posterior sd, so index 0 is the stiffest direction).  ``prior_draws``:
    see :func:`prior_sds`."""
    names = _theta_names(setup)
    vals = np.concatenate([fit['model'], fit['obs']])
    pri_sd = prior_sds(setup, n=n_prior, seed=seed, draws=prior_draws)
    fixed = np.zeros(len(names), bool)
    fixed[list(_FIXED_MODEL_SLOTS)] = True

    # a negative Laplace variance means the curvature there is not positive
    # definite (the MAP fit has not converged in that direction, or sits at
    # a saddle) — flag it honestly instead of reporting a garbage sd
    cov_t = np.asarray(lap['cov_theta'], np.float64)
    cov_t = 0.5 * (cov_t + cov_t.T)     # autodiff Hessians are symmetric
                                        # only to float tolerance
    var_t = np.diag(cov_t).copy()
    valid = (var_t > 0) & ~fixed
    post_sd = np.where(valid, np.sqrt(np.abs(var_t)), np.nan)
    with np.errstate(divide='ignore', invalid='ignore'):
        contraction = np.where(valid, 1.0 - post_sd / pri_sd, np.nan)

    d = np.where(valid, np.sqrt(np.abs(var_t)), np.nan)
    with np.errstate(divide='ignore', invalid='ignore'):
        corr = cov_t / np.outer(d, d)

    # z-space spectrum: drop the fixed slot(s); append sprd_factor if fit
    z_names = [n for i, n in enumerate(MODEL_PARAM_NAMES)
               if i not in _FIXED_MODEL_SLOTS]
    z_names += list(OBS_PARAM_NAMES) + [
        'sent_obs_prob_{}'.format(k) for k in setup.locinfo.sent_ids]
    keep = [i for i in range(len(names)) if not fixed[i]]
    if fit['use_sprd']:
        z_names.append('sprd_factor')
        keep.append(np.asarray(lap['cov_z']).shape[0] - 1)
    cov_z = np.asarray(lap['cov_z'], np.float64)[np.ix_(keep, keep)]
    evals, evecs = np.linalg.eigh(0.5 * (cov_z + cov_z.T))   # ascending
    return {'names': names, 'map': vals, 'post_sd': post_sd,
            'prior_sd': pri_sd, 'contraction': contraction,
            'corr': corr, 'fixed': fixed, 'valid': valid,
            'eig_sd': np.sqrt(np.clip(evals, 0, None)),
            'n_nonpsd': int(np.sum(evals < 0)),
            'eig_vec': evecs, 'z_names': z_names}


def plot_identifiability(info, outfile):
    """Two-panel figure: the stiff→sloppy eigen-spectrum (log scale, the
    Gutenkunst sloppy-model signature) and per-parameter prior→posterior
    contraction bars (viz conventions of viz/bayes_plot.py)."""
    from ..viz import _mpl
    plt = _mpl()

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.6))

    sd = np.asarray(info['eig_sd'], np.float64)
    sd = np.where(sd > 0, sd, np.nan)
    ax1.semilogy(np.arange(sd.shape[0]), sd, 'o-', ms=4, color='#31688e')
    ax1.set_xlabel('direction (stiff → sloppy)')
    ax1.set_ylabel('posterior sd along eigendirection')
    title = 'sloppy-model spectrum'
    if info.get('n_nonpsd'):
        title += '  ({} non-PSD direction(s) clipped)'.format(
            info['n_nonpsd'])
    ax1.set_title(title)
    ax1.grid(alpha=0.25)

    c = np.asarray(info['contraction'], np.float64)
    names = list(info['names'])
    shown = [(n, v) for n, v, f in zip(names, c, info['fixed']) if not f]
    ys = np.arange(len(shown))
    vals = np.array([v for _, v in shown])
    ax2.barh(ys, np.nan_to_num(vals), color='#31688e')
    bad = ~np.isfinite(vals)
    if bad.any():
        ax2.barh(ys[bad], np.ones(bad.sum()) * 0.02, color='#b40426')
    ax2.set_yticks(ys)
    ax2.set_yticklabels([n for n, _ in shown], fontsize=7)
    ax2.axvline(0.0, color='0.4', lw=0.8)
    ax2.set_xlim(-0.1, 1.0)
    ax2.set_xlabel('prior → posterior contraction (1 = fully determined)')
    ax2.set_title('what the data constrained')
    ax2.invert_yaxis()
    ax2.grid(alpha=0.25, axis='x')

    fig.tight_layout()
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def identify_report(info, corr_threshold=0.5, n_loadings=3, out=None):
    """Human-readable identifiability report."""
    lines = ['Parameter identifiability (Laplace at the MAP; '
             'unconstrained-space spectrum)']
    lines.append('')
    lines.append('{:>18s} {:>12s} {:>11s} {:>11s} {:>12s}'.format(
        'parameter', 'MAP', 'post sd', 'prior sd', 'contraction'))
    for i, n in enumerate(info['names']):
        c = info['contraction'][i]
        tag = ('    (fixed)' if info['fixed'][i] else
               '{:11.1%}'.format(c) if np.isfinite(c) else
               '  (not PSD)')
        lines.append('{:>18s} {:>12.5g} {:>11.4g} {:>11.4g} {:>12s}'.format(
            n, info['map'][i], info['post_sd'][i], info['prior_sd'][i],
            tag))
    if info.get('n_nonpsd'):
        lines.append('  WARNING: {} direction(s) with non-positive '
                     'curvature — increase MAP steps before trusting '
                     'this report'.format(info['n_nonpsd']))
    lines.append('')
    lines.append('strong posterior correlations (|r| >= {:.2f}):'.format(
        corr_threshold))
    corr = info['corr']
    pairs = []
    for i in range(corr.shape[0]):
        for j in range(i + 1, corr.shape[1]):
            if np.isfinite(corr[i, j]) and abs(corr[i, j]) >= corr_threshold:
                pairs.append((abs(corr[i, j]), i, j, corr[i, j]))
    if pairs:
        for _, i, j, r in sorted(pairs, reverse=True):
            lines.append('  {:>18s} ~ {:<18s} r = {:+.3f}'.format(
                info['names'][i], info['names'][j], r))
    else:
        lines.append('  (none)')
    lines.append('')
    lines.append('posterior spectrum (stiff -> sloppy; loadings in '
                 'unconstrained space):')
    sd = info['eig_sd']
    vec = info['eig_vec']
    zn = info['z_names']
    for k in range(len(sd)):
        load = np.argsort(-np.abs(vec[:, k]))[:n_loadings]
        desc = ' '.join('{}{:+.2f}'.format(zn[i], vec[i, k]) for i in load)
        lines.append('  sd {:10.4g}  {}'.format(sd[k], desc))
    text = '\n'.join(lines)
    if out:
        with open(out, 'w') as f:
            f.write(text + '\n')
    return text


def main(argv=None, device=None):
    """The identifiability CLI: MAP fit, Laplace approximation, report.
    ``device`` given here wins over ``--device``.  Returns the summary
    dict."""
    import argparse
    import time

    from .map_fit import laplace_approximation, map_cli_params, map_fit

    ap = argparse.ArgumentParser(prog='parasitoids_tpu_torch.bayes.identify')
    ap.add_argument('-o', '--outname', default='identifiability.txt')
    ap.add_argument('--steps', type=int, default=300,
                    help='Adam steps for the MAP fit')
    ap.add_argument('--prior-draws', type=int, default=4000)
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                    help='where to run (default cuda; no CPU fallback)')
    ap.add_argument('overrides', nargs='*')
    args = ap.parse_args(argv)
    # the reference's MAP domain (Bayes_MAP.py:95)
    setup = BayesSetup(map_cli_params(args.overrides),
                       device=args.device if device is None else device)

    tic = time.time()
    fit = map_fit(setup, n_steps=args.steps)
    print('MAP fit: logp {:.2f} ({:.1f} s)'.format(fit['logp'],
                                                   time.time() - tic))
    tic = time.time()
    lap = laplace_approximation(setup, fit)
    print('Laplace Hessian: {:.1f} s (plain path in {})'.format(
        time.time() - tic, lap['precision']))
    info = identifiability(setup, fit, lap, n_prior=args.prior_draws)
    report = identify_report(info, out=args.outname)
    print(report)
    print('written to', args.outname)
    try:
        import os.path
        png = os.path.splitext(args.outname)[0] + '.png'
        print('wrote', plot_identifiability(info, png))
    except ImportError as e:    # matplotlib is the optional 'viz' extra;
        print('figure skipped (install the viz extra for the PNG): '
              '{}'.format(e))  # the text report above is the deliverable
    return info


if __name__ == '__main__':
    main()

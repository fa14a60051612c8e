"""Power-scaling sensitivity: prior-data conflict detection, PyTorch port
of ``parasitoids_tpu/bayes/sensitivity.py``.

Beyond-reference capability (the reference never asks whether its priors
drive the fit — Bayes_Run.py:102-196 states them and samples): following
Kallioinen, Paananen, Bürkner & Vehtari (2023, "Detecting and diagnosing
prior sensitivity and likelihood noninformativity with power-scaling"), the
prior or the likelihood is perturbed to a power

    p_alpha(theta | y)  ∝  p(theta)^alpha p(y | theta)      (prior scaling)
    p_alpha(theta | y)  ∝  p(theta) p(y | theta)^alpha      (lik.  scaling)

and the induced movement of each posterior marginal is measured WITHOUT
refitting: draws from the base posterior are importance-reweighted by

    log w_s = (alpha - 1) * log p(theta_s)        [prior scaling]
    log w_s = (alpha - 1) * log p(y | theta_s)    [likelihood scaling]

Pareto-smoothed (vi.py ``psis``), and the per-parameter shift is the
normalized symmetric cumulative Jensen-Shannon distance between the
weighted and unweighted empirical CDFs.  The local sensitivity at
alpha = 1 is a symmetric difference over alpha = 2^(+-delta):

    sens = (D(2^-delta) + D(2^delta)) / (2 delta)

Diagnosis per parameter at the paper's 0.05 threshold:

    prior >= t, lik >= t  -> prior-data conflict (prior and data fight)
    prior >= t, lik <  t  -> strong prior / weak likelihood (prior-driven)
    otherwise             -> data-dominated or insensitive (no flag)

The expensive input — one forward simulation per posterior draw for the
per-draw total log-likelihood — reuses loo.py's ``pointwise_matrix``
ensemble; the per-draw log prior is a cheap pass on the host (no forward
model).  All post-processing is host-side NumPy f64.

CLI: ``python -m parasitoids_tpu_torch.bayes.sensitivity <trace.npz>
[--draws N] [--device cpu] [k=v ...]``
"""

from __future__ import annotations

import numpy as np
import torch

from .model import BayesSetup, _as_model, _as_obs

__all__ = ['cjs_dist', 'powerscale_logweights', 'powerscale_sensitivity',
           'sensitivity_from_trace', 'report', 'plot_sensitivity']

SENS_THRESHOLD = 0.05   # Kallioinen et al. (2023) flagging threshold
_KHAT_WARN = 0.7
_ESS_FRAC_WARN = 0.1    # importance-weight ESS/S below this -> warn


# ----------------------------------------------------------------------
# distance + weight machinery (pure NumPy, unit-testable standalone)
# ----------------------------------------------------------------------

def cjs_dist(x, logw):
    """Normalized symmetric cumulative Jensen-Shannon distance between the
    uniform-weight ECDF of ``x`` and its ``exp(logw)``-weighted ECDF.

    The cumulative JS divergence (Nguyen & Vreeken 2015) between CDFs P, Q
    evaluated on the draw lattice:

        CJS(P||Q) = sum dx * P log2(2P / (P + Q)) + sum dx * (Q - P)/(2 ln 2)

    symmetrized, normalized by its upper bound ``sum dx * (P + Q)`` and
    square-rooted — the convention whose 0.05 sensitivity threshold the
    diagnosis uses.  Degenerate marginals (all draws equal, e.g. a fixed
    ``n_periods`` column) return 0.
    """
    x = np.asarray(x, np.float64)
    logw = np.asarray(logw, np.float64)
    idx = np.argsort(x, kind='stable')
    xs = x[idx]
    w = np.exp(logw[idx] - logw.max())
    n = x.shape[0]
    P = np.cumsum(np.full(n, 1.0 / n))
    Q = np.cumsum(w / w.sum())
    dx = np.diff(xs)
    if not np.any(dx > 0):
        return 0.0
    P, Q = P[:-1], Q[:-1]

    def _cjs(P, Q):
        with np.errstate(divide='ignore', invalid='ignore'):
            t = P * np.log2(2.0 * P / (P + Q))
        t = np.where(P > 0, t, 0.0)
        return float(np.sum(dx * t) + np.sum(dx * (Q - P)) / (2 * np.log(2)))

    bound = float(np.sum(dx * (P + Q)))
    if bound <= 0:
        return 0.0
    d2 = (_cjs(P, Q) + _cjs(Q, P)) / bound
    return float(np.sqrt(max(d2, 0.0)))


def powerscale_logweights(base_logdens, alpha):
    """Pareto-smoothed log importance weights moving base-posterior draws
    to the alpha-power-scaled posterior: ``(alpha - 1) * base_logdens``
    where ``base_logdens`` is the per-draw log prior (prior scaling) or
    total log likelihood (likelihood scaling).  Returns (logw, khat)."""
    from .vi import psis

    logw = (alpha - 1.0) * np.asarray(base_logdens, np.float64)
    logw = np.where(np.isfinite(logw), logw, -np.inf)
    return psis(logw)


def powerscale_sensitivity(draws, log_prior, log_lik, names, delta=0.01):
    """Per-parameter power-scaling sensitivities from posterior draws.

    Args:
        draws: (S, P) constrained parameter draws from the base posterior.
        log_prior: (S,) per-draw joint log prior.
        log_lik: (S,) per-draw total log likelihood.
        names: P parameter names.
        delta: log2 half-width of the symmetric difference
            (alpha = 2^(+-delta)).
    Returns:
        dict with 'names', 'prior_sens' (P,), 'lik_sens' (P,), 'diagnosis'
        (P strings, '' when unflagged), 'khat' {scaling: {alpha: k_hat}},
        'threshold', 'delta', 'n_draws'.
    """
    draws = np.asarray(draws, np.float64)
    if draws.ndim != 2 or draws.shape[1] != len(names):
        raise ValueError('draws must be (S, {}), got {}'.format(
            len(names), draws.shape))
    alphas = (2.0 ** -delta, 2.0 ** delta)
    khat = {}
    ess_frac = {}
    dists = {}
    for scaling, dens in (('prior', log_prior), ('lik', log_lik)):
        khat[scaling] = {}
        ess_frac[scaling] = {}
        dists[scaling] = np.zeros((2, draws.shape[1]))
        for j, alpha in enumerate(alphas):
            logw, k = powerscale_logweights(dens, alpha)
            khat[scaling][alpha] = float(k)
            # importance-weight ESS fraction: near 1 when the perturbed
            # posterior is well covered by the draws; tiny when a few
            # draws dominate (unconverged trace / huge likelihood spread)
            w = np.exp(logw - logw.max())
            ess_frac[scaling][alpha] = float(
                w.sum() ** 2 / (w.shape[0] * (w ** 2).sum()))
            for i in range(draws.shape[1]):
                dists[scaling][j, i] = cjs_dist(draws[:, i], logw)
    prior_sens = dists['prior'].sum(axis=0) / (2.0 * delta)
    lik_sens = dists['lik'].sum(axis=0) / (2.0 * delta)

    t = SENS_THRESHOLD
    diagnosis = []
    for p, l in zip(prior_sens, lik_sens):
        if p >= t and l >= t:
            diagnosis.append('prior-data conflict')
        elif p >= t:
            diagnosis.append('strong prior / weak likelihood')
        else:
            diagnosis.append('')
    return {'names': list(names), 'prior_sens': prior_sens,
            'lik_sens': lik_sens, 'diagnosis': diagnosis, 'khat': khat,
            'ess_frac': ess_frac, 'threshold': t, 'delta': delta,
            'n_draws': draws.shape[0]}


# ----------------------------------------------------------------------
# model wiring
# ----------------------------------------------------------------------

def sensitivity_from_trace(setup: BayesSetup, traces, n_draws=400, seed=0,
                           mesh=None, delta=0.01, pointwise=None):
    """Power-scaling sensitivities for every sampled parameter of a saved
    trace (standard layout: model block + obs block [+ sentinel probs]
    + logpost).

    The per-draw total log likelihood comes from ``loo.pointwise_matrix``
    (one forward simulation per draw, sharded over ``mesh``); the per-draw
    log prior is evaluated directly (cheap).  Uses the same seeded
    subsampling as every other draw-consuming tool.  ``pointwise``: an
    already-computed ``(ll, take)`` from ``pointwise_matrix`` with the
    SAME (traces, n_draws, seed) — callers that just ran LOO (e.g.
    bayes/summary.py) reuse it instead of re-simulating every draw.
    """
    from .loo import pointwise_matrix
    from .predictive import subsample_draws
    from .priors import (MODEL_PARAM_NAMES, OBS_PARAM_NAMES,
                         log_prior_model, log_prior_obs)

    if pointwise is None:
        pointwise = pointwise_matrix(setup, traces, n_draws=n_draws,
                                     seed=seed, mesh=mesh)
    ll, take = pointwise
    # same flattening + seed → same rows (subsample_draws is the shared
    # policy); truncate to the mesh-rounded count pointwise_matrix used
    rows, _ = subsample_draws(traces, n_draws, seed)
    rows = rows[:ll.shape[0]]
    log_lik = np.asarray(ll, np.float64).sum(axis=1)

    n_m = len(MODEL_PARAM_NAMES)
    n_o = len(OBS_PARAM_NAMES)
    from .priors import obs_extra_names
    names = (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
             + ['sent_obs_prob_{}'.format(k)
                for k in setup.locinfo.sent_ids]
             + list(obs_extra_names(getattr(setup, 'obs_model',
                                            'poisson'))))
    draws = np.asarray(rows[:, :len(names)], np.float64)

    # the draws' joint log prior in f32 on the host, as the JAX function
    # evaluates it on its device
    fa = setup.field_areas.detach().cpu().float()
    mfa = float(np.float32(setup.min_field_area))

    def _logprior(theta):
        m = _as_model(theta[:n_m])
        o = _as_obs(theta[n_m:len(names)], setup.n_sent)
        return log_prior_model(m) + log_prior_obs(o, fa, mfa,
                                                  setup.obs_model)

    with torch.no_grad():
        log_prior = np.asarray(
            [float(_logprior(th))
             for th in torch.as_tensor(draws.astype(np.float32))],
            np.float64)
    return powerscale_sensitivity(draws, log_prior, log_lik, names,
                                  delta=delta)


# ----------------------------------------------------------------------
# reporting
# ----------------------------------------------------------------------

def report(res):
    """Human-readable sensitivity table (flagged parameters first)."""
    lines = ['power-scaling sensitivity ({} draws, alpha = 2^(+-{}), '
             'threshold {}):'.format(res['n_draws'], res['delta'],
                                     res['threshold'])]
    lines.append('  {:>18s}  {:>10s}  {:>10s}  {}'.format(
        'parameter', 'prior', 'likelihood', 'diagnosis'))
    order = np.argsort(-(np.asarray(res['prior_sens'])
                         + np.asarray(res['lik_sens'])))
    for i in order:
        lines.append('  {:>18s}  {:>10.4f}  {:>10.4f}  {}'.format(
            res['names'][i], res['prior_sens'][i], res['lik_sens'][i],
            res['diagnosis'][i]))
    bad = [(s, a, k) for s, d in res['khat'].items() for a, k in d.items()
           if np.isfinite(k) and k > _KHAT_WARN]
    if bad:
        lines.append('  WARNING: unreliable importance weights '
                     '(khat > {}): {}'.format(
                         _KHAT_WARN,
                         ', '.join('{} alpha={:.4g} khat={:.2f}'.format(
                             s, a, k) for s, a, k in bad)))
    low = [(s, a, e) for s, d in res.get('ess_frac', {}).items()
           for a, e in d.items() if e < _ESS_FRAC_WARN]
    if low:
        lines.append('  WARNING: a few draws dominate the perturbed '
                     'posterior (weight-ESS/S < {}): {} — sensitivities '
                     'are untrustworthy; use more draws from a converged '
                     'chain'.format(
                         _ESS_FRAC_WARN,
                         ', '.join('{} alpha={:.4g} ess={:.0%}'.format(
                             s, a, e) for s, a, e in low)))
    n_flag = sum(1 for d in res['diagnosis'] if d)
    lines.append('  {} of {} parameters flagged'.format(
        n_flag, len(res['names'])))
    return '\n'.join(lines)


def plot_sensitivity(res, outfile):
    """Prior-vs-likelihood sensitivity scatter with threshold quadrants
    (viz conventions of bayes_plot.py: single-hue marks, direct labels)."""
    import os

    import matplotlib
    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    p = np.asarray(res['prior_sens'])
    l = np.asarray(res['lik_sens'])
    t = res['threshold']
    fig, ax = plt.subplots(figsize=(6.4, 5.6))
    ax.axvline(t, color='0.8', lw=1)
    ax.axhline(t, color='0.8', lw=1)
    ax.scatter(p, l, s=22, color='#2f6b8f', zorder=3)
    for i, name in enumerate(res['names']):
        if res['diagnosis'][i] or p[i] > t or l[i] > t:
            ax.annotate(name, (p[i], l[i]), textcoords='offset points',
                        xytext=(4, 4), fontsize=8)
    ax.set_xlabel('prior power-scaling sensitivity')
    ax.set_ylabel('likelihood power-scaling sensitivity')
    ax.set_title('power-scaling sensitivity (threshold {})'.format(t))
    fig.tight_layout()
    fig.savefig(outfile, dpi=150)
    plt.close(fig)
    return outfile


def main(argv=None, device=None):
    """The power-scaling CLI; ``device`` given here wins over
    ``--device``.  Returns the sensitivity dict."""
    import argparse

    from .run import build_setup

    ap = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.bayes.sensitivity',
        description='power-scaling prior/likelihood sensitivity of a '
                    'saved trace (Kallioinen et al. 2023)')
    ap.add_argument('trace', help='saved MCMC/SMC/VI trace (npz path)')
    ap.add_argument('--draws', type=int, default=400,
                    help='posterior draws to evaluate (forward sims)')
    ap.add_argument('--delta', type=float, default=0.01,
                    help='log2 half-width of the alpha perturbation')
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

    path = args.trace if args.trace.endswith('.npz') else args.trace + '.npz'
    with np.load(path) as npz:
        traces = npz['traces']
    res = sensitivity_from_trace(setup, traces, n_draws=args.draws,
                                 seed=args.seed, mesh=mesh, delta=args.delta)
    print(report(res))
    out = path[:-4] + '_sensitivity'
    np.savez(out + '.npz',
             names=np.asarray(res['names']),
             prior_sens=res['prior_sens'], lik_sens=res['lik_sens'],
             diagnosis=np.asarray(res['diagnosis']),
             threshold=res['threshold'], delta=res['delta'],
             n_draws=res['n_draws'])
    print('wrote', out + '.npz')
    try:
        print('wrote', plot_sensitivity(res, out + '.png'))
    except ImportError as e:    # matplotlib is the optional 'viz' extra
        print('figure skipped (install the viz extra): {}'.format(e))
    return res


if __name__ == '__main__':
    main()

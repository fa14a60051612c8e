"""Simulation-based calibration of the full inference stack, PyTorch port
of ``parasitoids_tpu/bayes/sbc.py``.

Beyond-reference capability: the reference has no way to test that its
sampler actually samples the posterior it writes down — PyMC 2's machinery
is trusted blind.  SBC (Talts, Betancourt, Simpson, Vehtari & Gelman 2018,
arXiv:1804.06788) closes the loop with machinery the port already has:
the exact prior samplers (priors.py), the synthetic-data generator
(predictive.simulate_observations — the same thinned-Poisson observation
model the likelihood evaluates), and replicate datasets that enter the
samplers as an argument (``BayesSetup.obs_pytree`` + ``run_mcmc(...,
obs=...)`` for AM; ``make_transformed_logpdf(traced_obs=True)`` +
``logpdf_args=(obs,)`` for NUTS).

Per replicate: draw truth ``theta* ~ prior``, simulate a dataset
``y ~ p(y | theta*)``, run the sampler on ``y``, and record the rank of
``theta*`` among ``L`` thinned posterior draws, per parameter.  If the
sampler is exact, ranks are uniform on {0..L} — *any* systematic bias
(wrong prior, likelihood mismatch, broken adaptation, resume bugs) shows
up as U-shaped, peaked, or skewed rank histograms.  ``sbc_uniformity``
reduces each parameter's histogram to a chi-square p-value.

Replicate ``r``'s randomness derives from (key, seed, r) only: its truth
and chain generators from a hash of ``key`` and ``r``, its dataset and
rank tie-breaking from ``numpy.random.default_rng([seed, r])`` as in the
JAX package, so a checkpointed study resumed is bitwise an uninterrupted
one.  The NUTS arm's Hessian at the truth (``--warm-start``, ``--ridge``)
runs one row at a time (``map_fit.hessian_columns``) on the plain twin
(``map_fit.plain_twin``, f64 on the card): the day kernels are first
order.

CLI::

    python -m parasitoids_tpu_torch.bayes.sbc --replicates 20 \
        --samples 400 --burn 200 [--device cpu] [key=value overrides]

writes ``sbc_ranks.npz`` (the deliverable) and ``sbc.png`` when
matplotlib is installed, and prints per-parameter p-values.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .model import BayesSetup
from .priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES

__all__ = ['run_sbc', 'sbc_uniformity', 'sbc_ecdf_pvals', 'plot_sbc',
           'replicate_truth', 'main']


def _param_names(setup):
    from .priors import obs_extra_names
    return (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
            + ['sent_obs_prob_{}'.format(k)
               for k in setup.locinfo.sent_ids]
            + list(obs_extra_names(getattr(setup, 'obs_model',
                                           'poisson'))))


def replicate_truth(setup: BayesSetup, key, r):
    """Replicate ``r``'s truth ``(m*, o*)`` (f32 numpy) drawn from the
    joint prior on a CPU generator seeded by a hash of ``key`` and ``r``,
    and the seed of its chain generators (``chain_generator(seed, j)``)."""
    from .priors import sample_prior_model, sample_prior_obs
    word = int(np.random.SeedSequence([int(key), int(r)]).generate_state(
        1, np.uint64)[0] >> 1)
    gen = torch.Generator().manual_seed(word)
    m_star = sample_prior_model(gen).numpy()
    o_star = sample_prior_obs(gen, setup.field_areas.cpu().numpy(),
                              setup.min_field_area,
                              getattr(setup, 'obs_model', 'poisson')).numpy()
    return m_star, o_star, word


def _nuts_arm(setup, warm_start, ridge):
    """The NUTS target over a replicate dataset, ``constrain`` and
    ``unconstrain``, and for the warm or ridge arm the function of the
    truth and the dataset that gives the metric or the whitening map."""
    from .map_fit import (_make_objective, _neg_logprior_z,
                          blend_prior_metric, hessian_columns, hessian_dtype,
                          plain_twin, prior_var_z, regularize_cov_z)
    from .nuts import (inv_mass_from_hessian, make_transformed_logpdf,
                       whiten_transform)

    logpdf, constrain, _ = make_transformed_logpdf(setup, traced_obs=True)
    _, _, unconstrain = _make_objective(setup, False)
    if not (warm_start or ridge):
        return logpdf, constrain, unconstrain, None
    # Hessians need a second derivative; the day kernels are first order,
    # so curvature runs on the plain twin (f64 on the card)
    twin = plain_twin(setup, hessian_dtype(setup))
    logpdf_x, _, _ = make_transformed_logpdf(twin, traced_obs=True)
    hdtype = twin.setup.wind_flat.dtype

    def hess(z_true, y):
        obs_x = twin.obs_pytree(y)
        return hessian_columns(lambda zz: -logpdf_x(zz, obs_x),
                               z_true.to(hdtype))

    if not ridge:
        def metric(z_true, y):
            return inv_mass_from_hessian(hess(z_true, y)).to(torch.float32)
        return logpdf, constrain, unconstrain, metric

    # ridge whitening per replicate: prior-curvature Hessians (no forward
    # model) + MC prior variances once, the blend and eigen work on the
    # host in f64
    _, constrain_z, _ = _make_objective(setup, False)
    hess_prior = [torch.func.hessian(_neg_logprior_z(setup, constrain_z,
                                                     with_jacobian=jac))
                  for jac in (False, True)]
    pv = prior_var_z(setup)

    def metric(z_true, y):
        H_raw = hess(z_true, y).cpu().numpy().astype(np.float64)
        Hn, Hp = (np.asarray(h(z_true).cpu().numpy(), np.float64)
                  for h in hess_prior)
        cov = blend_prior_metric(H_raw, Hn, Hp, pv)
        _, _, L, anchor = whiten_transform(
            regularize_cov_z(cov, pv),
            z_true.cpu().numpy().astype(np.float64))
        return L, anchor

    return logpdf, constrain, unconstrain, metric


def _nuts_draws(arm, z_true, obs_r, y, gen, ncfg, stepwise, steps_per_call,
                ridge):
    """One replicate's NUTS draws in z-space (numpy f32) and their log
    densities."""
    from .nuts import nuts_sample, nuts_sample_stepwise, whiten_logpdf
    logpdf, _, _, metric = arm
    dev = z_true.device
    im = None
    if ridge:
        # per-replicate ridge whitening anchored at the truth; NUTS starts
        # at u = 0 (the truth) with an identity metric and Welford dense
        # adaptation ON
        L, anchor = metric(z_true, y)
        center = z_true.cpu().numpy().astype(np.float64)
        logpdf = whiten_logpdf(logpdf, L, center, anchor=anchor,
                               device=dev)
        z0 = torch.zeros_like(z_true)
    else:
        if metric is not None:
            im = metric(z_true, y).to(dev)
        z0 = z_true
    if stepwise:
        out = nuts_sample_stepwise(
            logpdf, z0[None], [gen], ncfg, logpdf_args=(obs_r,),
            steps_per_call=steps_per_call,
            init_inv_mass=None if im is None else im[None])
        draws, logp = out['samples'][0], out['logp'][0]
    else:
        out = nuts_sample(logpdf, z0, gen, ncfg, logpdf_args=(obs_r,),
                          init_inv_mass=im)
        draws = out['samples'].cpu().numpy()
        logp = out['logp'].cpu().numpy()
    if ridge:
        draws = (np.asarray(draws, np.float64) @ L.T
                 + center).astype(np.float32)
    return np.asarray(draws, np.float32), logp


def run_sbc(setup: BayesSetup, n_replicates, key, n_samples=200, burn=100,
            thin=5, seed=0, verbose=False, sampler='am', max_depth=6,
            stepwise=False, steps_per_call=25, obs_sweeps=1, chains=1,
            checkpoint_path=None, warm_start=False, ridge=False):
    """SBC rank statistics for a sampler (``'am'`` or ``'nuts'``).

    ``key``: the integer seed of the replicates' truths and chains
    (:func:`replicate_truth`).  Returns ``{'ranks': (R, dim) int array,
    'L': draws per replicate, 'names': parameter names, 'truths': (R, dim),
    'resumed_at': replicates read from a checkpoint}``.  Chains are
    initialized at the replicate's own truth — SBC permits any
    initialization, and starting in the typical set keeps the required
    burn-in honest for short validation chains.

    ``chains``: AM only — pool each replicate's L rank draws from this
    many independent chains ((burn + n_samples) steps each, same truth
    init, different generators): a single short random-walk chain's
    thinned draws sit on ONE excursion, so when a parameter's
    autocorrelation time approaches the window the truth's rank piles at
    the edges even for an exact sampler (Talts et al. §5.1).

    ``checkpoint_path``: persist (ranks, truths, completed count) after
    every replicate, with a durable twin beside it, and resume from the
    matching one with the most replicates on restart.

    ``sampler='nuts'`` validates the gradient path: the NUTS target holds
    the discrete ``n_periods`` fixed at 30, so the replicate truths are
    drawn from the prior CONDITIONED on ``n_periods = 30``.
    ``stepwise=True`` runs the chain through ``nuts_sample_stepwise``
    (the CLI's sampler) instead of ``nuts_sample``; the draws are the
    same.

    ``warm_start`` (NUTS only): precondition each replicate's chain with a
    dense mass matrix from the Hessian of its own log posterior at the
    replicate truth (``inv_mass_from_hessian``) and keep it FIXED — warmup
    then only adapts the step size.  ``ridge`` (NUTS only): each
    replicate gets the ``--mass ridge`` recipe anchored at its own truth:
    truth-Hessian → ``blend_prior_metric`` → ``regularize_cov_z`` →
    ``whiten_transform``, and NUTS samples the whitened target from an
    identity metric with dense Welford adaptation ON.
    """
    from .predictive import simulate_observations
    from .sampler import (MCMCConfig, chain_generator, init_chain_state,
                          run_mcmc)

    dev = setup.setup.wind_flat.device
    arm = (_nuts_arm(setup, warm_start, ridge) if sampler == 'nuts'
           else None)
    dim = 15 + 4 + setup.n_sent + getattr(setup, 'n_extra_obs', 0)
    ranks = np.zeros((n_replicates, dim), np.int64)
    truths = np.zeros((n_replicates, dim))
    L = len(range(burn, burn + n_samples, thin))
    if sampler != 'nuts':
        L = L * int(chains)
    cfg = MCMCConfig(n_samples=burn + n_samples, obs_sweeps=obs_sweeps)
    start = 0
    # the .ckpt.npz is transient (gitignored); a durable twin with an
    # identical payload lives beside it under a non-ignored name
    durable_path = None
    if checkpoint_path:
        durable_path = (checkpoint_path[:-len('.ckpt.npz')] + '_partial.npz'
                        if checkpoint_path.endswith('.ckpt.npz')
                        else checkpoint_path + '.partial.npz')
    # consult BOTH candidates (a crash can leave them out of step): resume
    # from the matching one with the most completed replicates
    existing, best = 0, None
    for cand in (checkpoint_path, durable_path):
        if not (cand and os.path.exists(cand)):
            continue
        existing += 1
        with np.load(cand) as d:
            old_warm = int(d['warm']) if 'warm' in d.files else 0
            old_ridge = int(d['ridge']) if 'ridge' in d.files else 0
            if (int(d['L']) == L and d['ranks'].shape[1] == dim
                    and int(d['seed']) == seed
                    and str(d['sampler']) == sampler
                    and old_warm == int(bool(warm_start))
                    and old_ridge == int(bool(ridge))):
                done = min(int(d['done']), n_replicates)
                if done > start:
                    start, best = done, cand
                    ranks[:start] = d['ranks'][:start]
                    truths[:start] = d['truths'][:start]
    if verbose and start:
        print('  SBC resume: {} replicate(s) from {}'.format(start, best),
              flush=True)
    elif verbose and existing:
        print('  SBC checkpoint(s) mismatch this config; starting fresh',
              flush=True)
    for r in range(start, n_replicates):
        m_star, o_star, word = replicate_truth(setup, key, r)
        m_star = np.array(m_star)            # writable host copy
        if sampler == 'nuts':
            m_star[13] = 30.0           # condition on the NUTS target
        rng = np.random.default_rng([seed, r])
        y = simulate_observations(setup, m_star, o_star, rng)
        obs_r = setup.obs_pytree(y)
        if sampler == 'nuts':
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
            z_true = arm[2](f32(m_star), f32(o_star), f32(0.3))
            ncfg = _nuts_config(burn, n_samples, max_depth, warm_start,
                                ridge)
            zdraws, logp = _nuts_draws(
                arm, z_true, obs_r, y, chain_generator(word, 0, dev), ncfg,
                stepwise, steps_per_call, ridge)
            with torch.no_grad():
                theta = np.stack([torch.cat(arm[1](z)[:2]).cpu().numpy()
                                  for z in torch.as_tensor(zdraws).to(dev)])
            draws = theta[::thin][:L]
            metric = 'logp[-1] {:.1f}'.format(float(logp[-1]))
        else:
            parts = []
            for j in range(int(chains)):
                state = init_chain_state(setup, chain_generator(word, j, dev),
                                         m0=m_star, o0=o_star, obs=obs_r)
                _, trace = run_mcmc(setup, state, cfg, obs=obs_r)
                parts.append(
                    trace.cpu().numpy()[burn:burn + n_samples:thin, :dim])
            draws = np.concatenate(parts, axis=0)
            metric = 'loglik* {:.1f}'.format(float(state.loglik))
        truth = np.concatenate([m_star, o_star])
        truths[r] = truth
        # rank with randomized tie-breaking (exact for the discrete
        # n_periods component, a no-op for continuous ones)
        less = (draws < truth).sum(axis=0)
        ties = (draws == truth).sum(axis=0)
        ranks[r] = less + rng.integers(0, ties + 1)
        if verbose:
            print('  SBC replicate {}/{}: {}, ranks '
                  '[{} .. {}] of {}'.format(
                      r + 1, n_replicates, metric,
                      ranks[r].min(), ranks[r].max(), L), flush=True)
        if checkpoint_path:
            payload = dict(ranks=ranks, truths=truths, done=r + 1, L=L,
                           seed=seed, sampler=sampler,
                           warm=int(bool(warm_start)),
                           ridge=int(bool(ridge)),
                           names=np.asarray(_param_names(setup)))
            for dest in (checkpoint_path, durable_path):
                tmp = dest + '.tmp.npz'
                np.savez(tmp, **payload)
                os.replace(tmp, dest)
            # commit the durable twin as each replicate lands (a no-op
            # unless PARA_GIT_COMMIT=1, utils/durable.py)
            from ..utils.durable import commit_artifacts
            commit_artifacts([durable_path],
                             'SBC durable partial: {} replicates ({})'
                             .format(r + 1, sampler))
    return {'ranks': ranks, 'L': L, 'names': _param_names(setup),
            'truths': truths, 'resumed_at': start}


def _nuts_config(burn, n_samples, max_depth, warm_start, ridge):
    from .nuts import NUTSConfig
    return NUTSConfig(num_warmup=burn, num_samples=n_samples,
                      max_depth=max_depth,
                      dense_mass=bool(warm_start or ridge),
                      fixed_mass=bool(warm_start and not ridge))


def sbc_uniformity(ranks, L, n_bins=None):
    """Chi-square uniformity p-value per parameter over binned ranks.

    Under a correct sampler each rank is uniform on {0..L}; small p-values
    across many parameters indicate mis-calibration.  (With few replicates
    the test has little power — it is a smoke alarm, not a certificate.)
    """
    from scipy import stats

    ranks = np.asarray(ranks)
    R, dim = ranks.shape
    if n_bins is None:
        n_bins = max(2, min(L + 1, R // 5, 20))
    edges = np.linspace(0, L + 1, n_bins + 1)
    pvals = np.empty(dim)
    for j in range(dim):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        pvals[j] = stats.chisquare(counts).pvalue
    return pvals


def sbc_ecdf_pvals(ranks, L, seed=0):
    """Kolmogorov–Smirnov uniformity p-value per parameter via the
    randomized PIT: under H0 the rank r is uniform on {0..L}, so
    (r + u)/(L + 1) with u ~ U(0,1) is exactly Uniform(0,1) — the KS test
    then applies without discreteness corrections.  Complements the
    binned chi-square (``sbc_uniformity``): KS is sensitive to ECDF-scale
    drift (skew/shift), chi-square to local bin anomalies."""
    from scipy import stats

    ranks = np.asarray(ranks)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=ranks.shape)
    pit = (ranks + u) / (L + 1)
    return np.array([stats.kstest(pit[:, j], 'uniform').pvalue
                     for j in range(ranks.shape[1])])


def plot_sbc(out, outfile, n_bins=None):
    """Rank-histogram grid with the uniform band."""
    import matplotlib
    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    ranks, L, names = out['ranks'], out['L'], out['names']
    R, dim = ranks.shape
    if n_bins is None:
        n_bins = max(2, min(L + 1, R // 5, 20))
    ncol = 5
    nrow = -(-dim // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 2.2 * nrow),
                             squeeze=False)
    edges = np.linspace(0, L + 1, n_bins + 1)
    expect = R / n_bins
    band = 2 * np.sqrt(expect)
    for j in range(nrow * ncol):
        ax = axes[j // ncol][j % ncol]
        if j >= dim:
            ax.axis('off')
            continue
        ax.hist(ranks[:, j], bins=edges)
        ax.axhspan(expect - band, expect + band, alpha=0.2, color='gray')
        ax.axhline(expect, color='gray', lw=1)
        ax.set_title(names[j], fontsize=9)
        ax.set_yticks([])
    fig.suptitle('SBC rank histograms ({} replicates, {} draws each); '
                 'gray = uniform +/- 2sd'.format(R, L))
    fig.tight_layout()
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def main(argv=None, device=None):
    """The SBC command line; ``device`` given here wins over
    ``--device``.  Returns :func:`run_sbc`'s result."""
    import argparse
    import time

    from .run import build_setup

    ap = argparse.ArgumentParser(prog='parasitoids_tpu_torch.bayes.sbc')
    ap.add_argument('--replicates', type=int, default=20)
    ap.add_argument('--samples', type=int, default=400)
    ap.add_argument('--burn', type=int, default=200)
    ap.add_argument('--thin', type=int, default=5)
    ap.add_argument('--obs-sweeps', type=int, default=1,
                    help='AM: obs-block Gibbs sweeps per model step '
                         '(cheap; shortens the xi x obs-prob ridge '
                         'autocorrelation that otherwise shows up as '
                         'U-shaped finite-chain rank histograms)')
    ap.add_argument('--chains', type=int, default=1,
                    help='AM: pool each replicate\'s ranks from this many '
                         'independent chains (breaks the single-excursion '
                         'edge-piling of short windows)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--sampler', choices=['am', 'nuts'], default='am',
                    help='which sampler to calibrate; nuts validates the '
                         'gradient path against the prior conditioned on '
                         'n_periods = 30 (the NUTS target)')
    ap.add_argument('--max-depth', type=int, default=6)
    ap.add_argument('--stepwise', action='store_true',
                    help='NUTS: run the chain through the stepwise sampler '
                         'of the CLI (same draws)')
    ap.add_argument('--steps-per-call', type=int, default=25,
                    help='stepwise NUTS: transitions per progress group')
    ap.add_argument('--warm-start', action='store_true',
                    help='NUTS: fixed dense mass matrix from the Hessian '
                         'at each replicate truth (warmup = step size '
                         'only; same posterior, far fewer gradient evals '
                         '— pair with a short --burn ~50)')
    ap.add_argument('--ridge', action='store_true',
                    help='NUTS: per-replicate ridge whitening at the '
                         'truth (blend_prior_metric + whiten_transform) '
                         'with dense Welford adaptation ON')
    ap.add_argument('--checkpoint', default=None, metavar='PATH',
                    help='persist the ranks after every replicate to PATH '
                         '(and its durable twin) and resume from it')
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                    help='where to run (default cuda; no CPU fallback)')
    ap.add_argument('-o', '--outname', default='sbc')
    ap.add_argument('overrides', nargs='*')
    args = ap.parse_args(argv)

    # the canonical Bayes setup, built as every other inference CLI builds it,
    # so the calibration target cannot drift from the sampler it validates
    setup = build_setup(args.overrides,
                        device=args.device if device is None else device)

    print('SBC: {} replicates x ({} burn + {} samples, thin {})...'.format(
        args.replicates, args.burn, args.samples, args.thin))
    tic = time.time()
    out = run_sbc(setup, args.replicates, args.seed,
                  n_samples=args.samples, burn=args.burn, thin=args.thin,
                  seed=args.seed, verbose=True, sampler=args.sampler,
                  max_depth=args.max_depth, stepwise=args.stepwise,
                  steps_per_call=args.steps_per_call,
                  obs_sweeps=args.obs_sweeps, chains=args.chains,
                  checkpoint_path=args.checkpoint,
                  warm_start=args.warm_start, ridge=args.ridge)
    print('SBC finished: {:.1f} s'.format(time.time() - tic))
    pvals = sbc_uniformity(out['ranks'], out['L'])
    ks = sbc_ecdf_pvals(out['ranks'], out['L'], seed=args.seed)
    for n, p, pk in zip(out['names'], pvals, ks):
        flag = '  <-- check' if min(p, pk) < 0.01 else ''
        print('  {:>18s}: chi2 p = {:.3f}  KS p = {:.3f}{}'.format(
            n, p, pk, flag))
    np.savez(args.outname + '_ranks',
             ranks=out['ranks'], L=out['L'], truths=out['truths'],
             names=np.asarray(out['names']))
    print('wrote {}_ranks.npz'.format(args.outname))
    try:
        print('wrote', plot_sbc(out, args.outname + '.png'))
    except ImportError as e:    # matplotlib is the optional 'viz' extra;
        print('figure skipped (install the viz extra for the PNG): '
              '{}'.format(e))  # the ranks .npz above is the deliverable
    return out


if __name__ == '__main__':
    main()

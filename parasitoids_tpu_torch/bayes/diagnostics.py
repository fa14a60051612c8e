"""MCMC convergence diagnostics (L4 support, host-side numpy), the port's
copy of ``parasitoids_tpu/bayes/diagnostics.py``.

The reference gets Geweke scores and Gelman–Rubin statistics from PyMC
(Bayes_Plot.py:106-143, Bayes_Run.py:685-692); we compute the same three
standard diagnostics directly from chain arrays, plus effective sample size.
"""

from __future__ import annotations

import numpy as np

__all__ = ['geweke', 'gelman_rubin', 'effective_sample_size',
           'truth_diagnostics']


def _spectral_var_0(x):
    """Spectral density at frequency zero (batch-means estimate)."""
    n = len(x)
    if n < 16:
        return x.var(ddof=1) if n > 1 else 0.0
    b = max(4, int(np.sqrt(n)))
    nb = n // b
    means = x[:nb * b].reshape(nb, b).mean(axis=1)
    return b * means.var(ddof=1)


def geweke(trace, first=0.1, last=0.5, intervals=20):
    """Geweke z-scores comparing early-window means against the final
    ``last`` fraction, over ``intervals`` starting points (as PyMC's
    ``geweke``).  Returns (start_index, z) pairs."""
    trace = np.asarray(trace, float)
    n = len(trace)
    last_start = int((1 - last) * n)
    tail = trace[last_start:]
    tail_mean = tail.mean()
    tail_var = _spectral_var_0(tail) / len(tail)
    out = []
    # early segments must end before the comparison tail begins, else late
    # segments are subsets of the tail and compare against themselves
    # (z ~ 0 regardless of convergence); PyMC restricts starts the same way
    seg_len = int(first * n)
    max_start = max(0, last_start - seg_len)
    for start in np.linspace(0, max_start, intervals).astype(int):
        seg = trace[start:start + seg_len]
        if len(seg) < 2:
            continue
        seg_var = _spectral_var_0(seg) / len(seg)
        denom = np.sqrt(seg_var + tail_var)
        z = (seg.mean() - tail_mean) / denom if denom > 0 else 0.0
        out.append((int(start), float(z)))
    return np.array(out)


def gelman_rubin(chains):
    """Potential scale reduction R-hat per parameter.

    Args:
        chains: (n_chains, n_samples) or (n_chains, n_samples, n_params).
    Returns:
        scalar or (n_params,) R-hat.
    """
    chains = np.asarray(chains, float)
    if chains.ndim == 2:
        chains = chains[:, :, None]
    m, n = chains.shape[0], chains.shape[1]
    if m < 2:
        raise ValueError('Gelman-Rubin requires at least 2 chains')
    chain_means = chains.mean(axis=1)             # (m, p)
    chain_vars = chains.var(axis=1, ddof=1)       # (m, p)
    W = chain_vars.mean(axis=0)
    B = n * chain_means.var(axis=0, ddof=1)
    var_hat = (n - 1) / n * W + B / n
    with np.errstate(divide='ignore', invalid='ignore'):
        rhat = np.sqrt(var_hat / W)
    # degenerate cases: all chains constant and equal -> converged (1.0);
    # zero within-chain variance but chains disagree -> inf (not the
    # arbitrary scale-dependent number sqrt(B/n) would give)
    rhat = np.where(W > 0, rhat, np.where(B > 0, np.inf, 1.0))
    return rhat[0] if rhat.size == 1 else rhat


def effective_sample_size(trace, max_lag=None):
    """ESS via initial-positive-sequence autocorrelation summation."""
    x = np.asarray(trace, float)
    n = len(x)
    x = x - x.mean()
    var = x.var()
    if var == 0 or n < 4:
        return float(n)
    if max_lag is None:
        max_lag = min(n // 2, 1000)
    f = np.fft.rfft(x, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:max_lag] / (var * n)
    # sum consecutive pairs until they go negative (Geyer initial positive)
    s = 0.0
    for k in range(1, max_lag - 1, 2):
        pair = acf[k] + acf[k + 1]
        if pair < 0:
            break
        s += pair
    return float(n / (1.0 + 2.0 * s))


def truth_diagnostics(traces, names, truth_vec,
                      ess_params=('sig_x', 'g_aw', 'mu_r')):
    """Posterior-vs-known-truth summary block for recorded fits.

    The one source of truth for the per-sampler diagnostics written to
    study summary JSONs (scripts/run_carnarvon_fit.py and
    scripts/analyze_carn_trace.py both call this).

    Args:
        traces: (n_chains, n_samples, >= len(names)) trace array; a
            single chain reports R-hat as None (needs >= 2 chains).
        names: parameter names, in trace-column order.
        truth_vec: true parameter values, aligned with ``names``.
    Returns:
        dict with draws, max_rhat, ESS for ``ess_params``, per-parameter
        truth z-scores (|mean - truth| / sd), frac_within_2sd, and
        posterior means.
    """
    tr = np.asarray(traces, float)
    if tr.ndim == 2:
        tr = tr[None]
    tr = tr[:, :, :len(names)]
    rhat = (np.atleast_1d(gelman_rubin(tr)) if tr.shape[0] > 1
            else np.full(len(names), np.nan))
    flat = tr.reshape(-1, tr.shape[-1])
    mean, sd = flat.mean(0), flat.std(0)
    z = np.abs(mean - np.asarray(truth_vec, float)) / np.maximum(sd, 1e-12)
    names = list(names)
    ess = [float(effective_sample_size(flat[:, names.index(p)]))
           for p in ess_params]
    return {
        'draws': int(flat.shape[0]),
        'max_rhat': (round(float(np.nanmax(rhat)), 3)
                     if np.isfinite(rhat).any() else None),
        'ess_' + '_'.join(ess_params): [round(e, 1) for e in ess],
        'truth_z': {n: round(float(v), 2) for n, v in zip(names, z)},
        'frac_within_2sd': round(float(np.mean(z < 2)), 3),
        'posterior_mean': {n: round(float(v), 4)
                           for n, v in zip(names, mean)},
    }

"""Pareto-smoothed importance sampling, the host part of
``parasitoids_tpu/bayes/vi.py`` (:205-276): the generalized-Pareto tail
fit and the smoothed weights that PSIS-LOO (``bayes/loo.py``) and
power-scaling sensitivity (``bayes/sensitivity.py``) use.  Host NumPy f64,
copies of the JAX functions.  The variational family, the ELBO fit and the
VI sampler are not ported yet (ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

import numpy as np

__all__ = ['gpd_fit', 'psis']


def gpd_fit(x):
    """Zhang & Stephens (2009) posterior-mean fit of the generalized Pareto
    shape k and scale sigma to exceedances ``x`` (ascending, > 0).  Host
    NumPy f64 — this is sample-size-bounded post-processing."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    m_est = 30 + int(np.sqrt(n))
    j = np.arange(1, m_est + 1)
    b = 1.0 - np.sqrt(m_est / (j - 0.5))
    b = b / (3.0 * x[max(int(n / 4 + 0.5) - 1, 0)]) + 1.0 / x[-1]
    k_b = np.mean(np.log1p(-b[:, None] * x), axis=1)
    with np.errstate(divide='ignore', invalid='ignore'):
        prof = n * (np.log(-b / k_b) - k_b - 1.0)
    prof = np.where(np.isfinite(prof), prof, -np.inf)
    w = np.exp(prof - prof.max())          # stable softmax weights
    w = w / w.sum()
    b_post = np.sum(b * w)
    k_post = np.mean(np.log1p(-b_post * x))
    # sigma from the RAW shape: k and b always carry opposite signs, so
    # -k/b > 0; regularizing first can flip k's sign and yield a negative
    # scale (NaN quantiles downstream in ``psis``)
    sigma = -k_post / b_post
    # weakly-informative shape regularization (Vehtari et al., PSIS paper)
    k_post = (n * k_post + 5.0) / (n + 10.0)
    return k_post, sigma


def psis(logw):
    """Pareto-smoothed importance weights: fit a GPD to the largest
    ``M = min(0.2 n, 3 sqrt(n))`` raw weights and replace them by the
    expected order statistics of the fitted tail.  Returns (smoothed logw,
    k_hat)."""
    logw = np.asarray(logw, np.float64)
    n = logw.shape[0]
    M = int(min(np.ceil(0.2 * n), np.ceil(3.0 * np.sqrt(n))))
    if M < 5 or n < 16:
        return logw.copy(), np.inf
    order = np.argsort(logw)
    shift = logw.max()                     # overflow guard
    w = np.exp(logw - shift)
    cutoff = w[order[-M - 1]]
    # strict exceedances only (arviz semantics): weight ties at the cutoff
    # — ubiquitous in Metropolis chains with repeated states — would
    # otherwise enter the GPD fit as ~0 exceedances and skew it
    tail_idx = order[-M:][w[order[-M:]] > cutoff]
    m_t = tail_idx.shape[0]
    if m_t < 5:
        return logw.copy(), np.inf
    khat, sigma = gpd_fit(np.sort(w[tail_idx] - cutoff))
    if np.isfinite(khat) and sigma > 0:
        # inverse-CDF of the fitted GPD at the expected quantiles
        p = (np.arange(1, m_t + 1) - 0.5) / m_t
        if abs(khat) < 1e-12:
            q = -sigma * np.log1p(-p)
        else:
            q = sigma * np.expm1(-khat * np.log1p(-p)) / khat
        # tail_idx is ascending in logw, and q is ascending in p, so the
        # fitted order statistics map onto the raw tail positionally; cap
        # at the raw maximum (Vehtari et al. recommendation)
        smoothed = np.minimum(np.log(cutoff + q) + shift, shift)
        out = logw.copy()
        out[tail_idx] = smoothed
        return out, khat
    return logw.copy(), np.inf

"""Automatic-differentiation variational inference (ADVI) over the full
posterior, with PSIS quality diagnostics: PyTorch port of
``parasitoids_tpu/bayes/vi.py``.

Beyond-reference capability: the reference's fastest approximate-inference
path is PyMC 2's gradient-free ``NormApprox`` (Bayes_MAP.py:521-569 — a
Laplace approximation from finite-difference curvature).  Because the
forward model is differentiable end to end, a Gaussian ``q(z)`` is fitted
instead to the *transformed-space* posterior by stochastic gradient ascent
on the evidence lower bound (ADVI, Kucukelbir et al. 2017 JMLR) —
mean-field or full-rank — which (unlike Laplace) targets global posterior
mass rather than local curvature at the mode.  This yields:

- a seconds-scale approximate posterior next to the MCMC samplers;
- the ELBO, a lower bound on the model log-evidence — a fourth estimate
  next to parallel tempering's thermodynamic-integration /
  stepping-stone (tempering.py) and SMC's annealed-importance telescope
  (smc.py);
- Pareto-smoothed importance sampling on draws from ``q`` (Vehtari et al.
  PSIS; Yao et al. 2018 "Yes, but did it work?"): the tail-shape ``k_hat``
  diagnoses whether q is usable as an IS proposal (k < 0.7), and the
  importance weights give a (consistent, unlike the ELBO) logZ estimate.

Scope note: like NUTS and the reference's own MAP (Bayes_MAP.py:144-147),
the discrete ``n_periods`` parameter is held fixed at 30, so the ELBO / IS
logZ estimate the *conditional* evidence p(data | n_periods=30); the PT and
SMC estimators marginalize n_periods over its Poisson(30) prior.

Execution: the Monte-Carlo ELBO gradient runs the forward model once per
draw, the draws in turn, each back-propagated on its own with weight
1/n_mc and the gradients summed (JAX's ``lax.map`` inside one
``value_and_grad`` gives the same sum; one 801² graph at a time keeps the
memory of one value+gradient).  Adam is ``torch.optim.Adam``, the update of
``optax.adam`` up to rounding.  Every function that draws takes its
standard normals as an optional argument (``eps``), so that a test can
replay JAX's.  The variational parameters keep JAX's layout (``mu``,
``log_diag``, and the full-rank ``offdiag`` in ``tril_indices(d, -1)``
order), so a store written by either package reloads in the other's
``--resume``.  The PSIS functions are host NumPy f64, copies of the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['advi', 'fit_advi', 'q_draws', 'q_logpdf', 'gpd_fit', 'psis',
           'vi_evidence']

_LOG_2PI = float(np.log(2.0 * np.pi))

# draws of the model target evaluated with a graph (ELBO gradients) and
# without one (evidence draws) by this module; a run reads them beside
# ``ops.day_kernel.LAUNCHES`` / ``LAUNCHES_BWD``
VALUE_AND_GRADS = 0
VALUES = 0


# ----------------------------------------------------------------------
# Gaussian variational family over the active coordinates
# ----------------------------------------------------------------------

def _unpack_scale(params, da):
    """Return (standard-deviation vector or None, full Cholesky or None)."""
    if 'offdiag' in params:
        ld = params['log_diag']
        L = torch.zeros((da, da), dtype=ld.dtype, device=ld.device)
        if da > 1:
            rows, cols = torch.tril_indices(da, da, -1, device=ld.device)
            L = L.index_put((rows, cols), params['offdiag'])
        L = L + torch.diag(torch.exp(ld))
        return None, L
    return torch.exp(params['log_diag']), None


def _q_sample_active(params, eps):
    """One draw of the active block from q given standard-normal eps."""
    da = eps.shape[-1]
    sd, L = _unpack_scale(params, da)
    if L is None:
        return params['mu'] + sd * eps
    return params['mu'] + L @ eps


def _q_entropy(params, da):
    """Differential entropy of q (analytic — the ADVI entropy term)."""
    return 0.5 * da * (_LOG_2PI + 1.0) + torch.sum(params['log_diag'])


def _q_logpdf_active(params, z_active):
    da = z_active.shape[-1]
    sd, L = _unpack_scale(params, da)
    diff = z_active - params['mu']
    if L is None:
        quad = torch.sum((diff / sd) ** 2)
    else:
        y = torch.linalg.solve_triangular(L, diff[:, None], upper=False)
        quad = torch.sum(y ** 2)
    return -0.5 * (quad + da * _LOG_2PI) - torch.sum(params['log_diag'])


def _embed(z0, idx, z_active):
    return z0.index_put((idx,), z_active)


def _normals(key, shape, dtype, device):
    """Standard normals from ``key``: a ``torch.Generator`` on ``device``
    (advanced), or an integer seed of a fresh one."""
    if not isinstance(key, torch.Generator):
        key = torch.Generator(device=device).manual_seed(int(key))
    return torch.randn(shape, generator=key, dtype=dtype, device=device)


# ----------------------------------------------------------------------
# core optimizer (generic over any logpdf)
# ----------------------------------------------------------------------

def advi(logpdf, z0, key, active=None, n_steps=600, n_mc=4,
         learning_rate=0.02, fullrank=False, chunk_steps=25,
         init_log_sigma=-2.0, mu0=None, verbose=False, eps=None):
    """Fit a Gaussian q to ``exp(logpdf)`` (unnormalized) over the
    coordinates marked ``active`` (inactive ones stay pinned at ``z0``,
    e.g. the fixed n_periods slot).  Returns a plain dict (npz-storable).

    ``z0``: a tensor (its device and dtype are the fit's) or an array.
    ``key``: a ``torch.Generator`` on that device, or an integer seed;
    each step draws its ``(n_mc, d_active)`` normals from it, unless
    ``eps`` (``(n_steps, n_mc, d_active)``) gives them.
    ``learning_rate``: a number or a function of the step index (the
    learning-rate schedule of ``optax.adam``).  ``chunk_steps``: steps
    between reads of the losses (and progress lines).
    """
    global VALUE_AND_GRADS
    z0 = torch.as_tensor(z0, dtype=torch.float32)
    dtype, dev = z0.dtype, z0.device
    d = z0.shape[0]
    if active is None:
        active = np.ones(d, bool)
    idx = torch.as_tensor(np.nonzero(np.asarray(active))[0]).to(dev)
    da = int(idx.shape[0])

    mu_init = (torch.as_tensor(np.asarray(mu0, np.float32)).to(dev)[idx]
               if mu0 is not None else z0[idx])
    params = {'mu': mu_init.clone(),
              'log_diag': torch.full((da,), init_log_sigma, dtype=dtype,
                                     device=dev)}
    if fullrank:
        params['offdiag'] = torch.zeros(da * (da - 1) // 2, dtype=dtype,
                                        device=dev)
    for p in params.values():
        p.requires_grad_()
    sched = learning_rate if callable(learning_rate) else None
    opt = torch.optim.Adam(list(params.values()),
                           lr=sched(0) if sched else learning_rate)
    if not isinstance(key, torch.Generator) and eps is None:
        key = torch.Generator(device=dev).manual_seed(int(key))

    losses = []
    chunk = []
    for step in range(n_steps):
        e = (_normals(key, (n_mc, da), dtype, dev) if eps is None
             else torch.as_tensor(eps[step], dtype=dtype).to(dev))
        if sched is not None:
            for g in opt.param_groups:
                g['lr'] = sched(step)
        opt.zero_grad(set_to_none=True)
        total = torch.zeros((), dtype=dtype, device=dev)
        # one forward-model evaluation per MC draw, each back-propagated
        # alone with weight 1/n_mc: the gradient of the mean
        for j in range(n_mc):
            with torch.enable_grad():
                z = _embed(z0, idx, _q_sample_active(params, e[j]))
                val = logpdf(z)
                (-val / n_mc).backward()
            VALUE_AND_GRADS += 1
            total = total + val.detach()
        with torch.enable_grad():
            ent = _q_entropy(params, da)
            (-ent).backward()
        loss = -(total / n_mc + ent.detach())
        with torch.no_grad():
            for p in params.values():
                p.grad = torch.where(torch.isfinite(p.grad), p.grad,
                                     torch.zeros_like(p.grad))
        opt.step()
        chunk.append(loss)
        if len(chunk) == chunk_steps or step + 1 == n_steps:
            losses.append(torch.stack(chunk).cpu().numpy())
            chunk = []
            if verbose:
                print('  ADVI step {:4d}/{}: ELBO estimate {:.2f}'.format(
                    step + 1, n_steps, -float(losses[-1][-1])), flush=True)
    elbo_trace = (-np.concatenate(losses) if losses else np.zeros(0))

    host = lambda t: t.detach().cpu().numpy()
    res = {'mu': host(params['mu']), 'log_diag': host(params['log_diag']),
           'idx': host(idx), 'z0': host(z0), 'fullrank': fullrank,
           'elbo_trace': elbo_trace}
    if fullrank:
        res['offdiag'] = host(params['offdiag'])
    return res


def _res_params(res, device=None):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
    params = {'mu': t(res['mu']), 'log_diag': t(res['log_diag'])}
    if res.get('fullrank') and 'offdiag' in res:
        params['offdiag'] = t(res['offdiag'])
    return params


def q_draws(res, key, n, device=None, eps=None):
    """n draws of the full z vector from the fitted q, on ``device``:
    ``key`` a generator on it or an integer seed; ``eps`` (n, d_active)
    standard normals used instead."""
    params = _res_params(res, device)
    idx = torch.as_tensor(np.asarray(res['idx'])).to(device)
    z0 = torch.as_tensor(np.asarray(res['z0'], np.float32)).to(device)
    da = int(idx.shape[0])
    e = (_normals(key, (n, da), torch.float32, z0.device) if eps is None
         else torch.as_tensor(eps, dtype=torch.float32).to(z0.device))
    with torch.no_grad():
        return torch.stack([_embed(z0, idx, _q_sample_active(params, e[i]))
                            for i in range(n)])


def q_logpdf(res, z):
    """log q(z) over the active block (inactive coordinates are a shared
    point mass, which cancels in importance ratios)."""
    z = torch.as_tensor(z)
    params = _res_params(res, z.device)
    idx = torch.as_tensor(np.asarray(res['idx'])).to(z.device)
    return _q_logpdf_active(params, z.to(torch.float32)[idx])


# ----------------------------------------------------------------------
# PSIS: generalized-Pareto tail fit + smoothed importance weights
# ----------------------------------------------------------------------

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


# ----------------------------------------------------------------------
# model-level wrappers
# ----------------------------------------------------------------------

_N_PERIODS_SLOT = 13    # fixed discrete slot, see map_fit._make_objective


def _model_logpdf(setup, use_sprd=None):
    from .nuts import make_transformed_logpdf
    if use_sprd is None:
        use_sprd = False    # match Bayes_Run (sprd disabled, Run.py:168-175)
    logpdf, constrain, z0 = make_transformed_logpdf(setup, use_sprd)
    active = np.ones(int(z0.shape[0]), bool)
    active[_N_PERIODS_SLOT] = False
    return logpdf, constrain, z0, active


def fit_advi(setup, key, n_steps=600, n_mc=4, learning_rate=0.02,
             fullrank=False, use_sprd=None, init='map', init_map_steps=200,
             chunk_steps=25, verbose=False, eps=None):
    """ADVI over the full parasitoid posterior.  ``init='map'`` (default)
    starts the variational mean at a short MAP fit — the prior point
    predicts ~zero density at most observed cells, where floor-rate
    log-likelihood terms drown the ELBO gradient in f32 noise (same
    rationale as the NUTS initialization, run.py).  ``key``: an integer
    seed of a generator on the setup's device, or such a generator."""
    if use_sprd is None:
        use_sprd = False    # match Bayes_Run (sprd disabled, Run.py:168-175)
    logpdf, constrain, z0, active = _model_logpdf(setup, use_sprd)
    mu0 = None
    if init == 'map':
        from .map_fit import map_fit
        if verbose:
            print('ADVI init: MAP fit ({} steps)...'.format(init_map_steps),
                  flush=True)
        # use_sprd must match _model_logpdf's: the sprd slot changes the
        # z-vector length
        fit = map_fit(setup, n_steps=init_map_steps, use_sprd=use_sprd)
        if verbose:
            print('ADVI init: MAP logp = {:.2f}'.format(fit['logp']),
                  flush=True)
        mu0 = fit['z']
    res = advi(logpdf, z0, key, active=active, n_steps=n_steps, n_mc=n_mc,
               learning_rate=learning_rate, fullrank=fullrank,
               chunk_steps=chunk_steps, mu0=mu0, verbose=verbose, eps=eps)
    res['use_sprd'] = bool(use_sprd)
    return res


def vi_evidence(setup, res, key, n=256, use_sprd=None, eps=None):
    """Importance-sampling evidence check of a fitted q: draws n samples,
    evaluates ``logw = logpost(z) - logq(z)``, and returns the ELBO
    (re-estimated on these draws), the IS logZ ``logsumexp(logw) - log n``,
    and the PSIS tail diagnostic ``k_hat`` (q trustworthy for IS when
    k_hat < 0.7).  Also returns per-draw constrained log posteriors for
    trace storage.  The draws run in turn without a graph; ``key`` as
    :func:`fit_advi`'s, ``eps`` (n, d_active) replaces its normals."""
    global VALUES
    logpdf, constrain, z0, active = _model_logpdf(
        setup, res.get('use_sprd', False) if use_sprd is None else use_sprd)
    zs = q_draws(res, key, n, device=z0.device, eps=eps)
    with torch.no_grad():
        logq = torch.stack([q_logpdf(res, z) for z in zs])
        logp = []
        for z in zs:
            logp.append(logpdf(z))
            VALUES += 1
        logp = torch.stack(logp)
        # constrained-space log posterior per draw (for trace storage): the
        # Jacobian is elementwise-bijection-cheap, no forward model involved
        jac = torch.stack([logpdf.log_jacobian(z) for z in zs])
    logp, logq, jac = (t.cpu().numpy().astype(np.float64)
                       for t in torch.stack([logp, logq, jac]))
    logw = logp - logq
    logw_s, khat = psis(logw)
    n_f = float(n)
    logz_is = float(
        np.log(np.sum(np.exp(logw_s - logw_s.max()))) + logw_s.max()
        - np.log(n_f))
    logpost = logp - jac
    return {'elbo': float(np.mean(logw)), 'logz_is': logz_is,
            'khat': float(khat), 'logw': logw, 'zs': zs.cpu().numpy(),
            'logpost': logpost}

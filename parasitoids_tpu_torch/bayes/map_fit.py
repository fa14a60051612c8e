"""MAP estimation, PyTorch port of the Adam path of
``parasitoids_tpu/bayes/map_fit.py`` (reference Bayes_MAP.py).

The negative log posterior is differentiated end to end (on CUDA through
the day kernel's backward) and minimized with Adam in an unconstrained
reparameterization.  As in the reference, ``n_periods`` is held at 30
(Bayes_MAP.py:144-147) and the Kalbar pre-spread factor is an extra
Uniform(0, 1) parameter (Bayes_MAP.py:200-205).

Run as ``python -m parasitoids_tpu_torch.bayes.map_fit --MAP | --norm
[--starts N --seed S] [--polish N] [--shard-forward]``: Adam from the
reference's initial values or from several prior draws (in turn, or
sharded over the visible cards), optionally an L-BFGS polish,
and with ``--norm`` the Laplace (normal) approximation around the mode
(ref ``pm.NormApprox``, Bayes_MAP.py:521-569): the covariance is the
inverse Hessian of the negative log posterior in the unconstrained space.
``--shard-forward`` spreads each forward simulation's flight minutes over
the visible cards (``parallel/domain.py``).

The Hessian never goes through the CUDA day kernels, whose backward is
first order (in JAX too the Pallas ``custom_vjp`` admits no forward mode).
It is taken on the plain twin of the setup (:func:`plain_twin`), reverse
over reverse, one column at a time (:func:`hessian_columns`).  On the card
the twin runs in f64: the f32 plain accumulate adds atomically there, so
its sums change from run to run.
"""

from __future__ import annotations

import argparse
import copy
import math
import time

import numpy as np
import torch

from ..device import scalar
from .model import _N_MODEL, BayesSetup, _as_model, _as_obs
from .priors import (MODEL_PARAM_NAMES, OBS_PARAM_NAMES,
                     initial_model_params, initial_obs_params,
                     obs_extra_names)
from .transforms import MODEL_TRANSFORMS, Unit, obs_transforms

__all__ = ['blend_prior_metric', 'default_use_sprd', 'hessian_columns',
           'initial_z', 'laplace_approximation', 'laplace_warm_mass',
           'lbfgs_polish', 'main', 'map_cli_params', 'map_fit',
           'map_fit_multistart', 'map_report', 'plain_twin', 'prior_var_z',
           'regularize_cov_z']

_N_PERIODS_FIXED = 30.0
_N_PERIODS_SLOT = MODEL_PARAM_NAMES.index('n_periods')


def default_use_sprd(params):
    """Whether the pre-wind local-spread day (sprd_factor) is fit: on for
    Kalbar as in the reference (Bayes_MAP.py:200-205); generic sites opt in
    with ``"sprd_factor": true`` in their site spec."""
    return (params.dataset == 'kalbar'
            or bool(getattr(params, 'use_sprd_factor', False)))


def _theta_split(setup):
    n_sent = setup.n_sent
    t_obs = obs_transforms(n_sent, setup.min_field_area, setup.obs_model)
    return n_sent, MODEL_TRANSFORMS, t_obs


def _make_objective(setup: BayesSetup, use_sprd, free_n=False,
                    traced_obs=False):
    """``(neg_logpost, constrain, unconstrain)`` over the unconstrained
    vector z: ``neg_logpost(z)`` is the negative log posterior with
    ``n_periods`` pinned at 30.

    ``free_n=True`` returns ``constrain(z, n)`` / ``neg_logpost(z, n)``
    with the discrete ``n_periods`` slot an argument instead (its
    Poisson(30) prior enters through the model block): the target of
    Gibbs-within-NUTS (bayes/nuts.py).  ``traced_obs=True`` returns
    ``neg_logpost(z, obs)`` with the observed dataset an argument
    (``BayesSetup.obs_pytree`` structure) instead of the setup's.  Every
    ``neg_logpost`` also takes ``gate=`` (see ``BayesSetup.log_posterior``)
    and returns None where the gate reads 0."""
    if free_n and traced_obs:
        raise ValueError('free_n and traced_obs are mutually exclusive')
    n_sent, t_m, t_o = _theta_split(setup)
    n_obs = 4 + n_sent + setup.n_extra_obs
    sprd_t = Unit()

    def constrain(z, n_periods=_N_PERIODS_FIXED):
        n_per = scalar(n_periods, z.dtype, z.device)
        m_vec = torch.stack([t.inv(z[i]) if i != _N_PERIODS_SLOT else n_per
                             for i, t in enumerate(t_m)])
        o_vec = torch.stack([t_o[j].inv(z[_N_MODEL + j])
                             for j in range(n_obs)])
        sprd = sprd_t.inv(z[-1]) if use_sprd else None
        return m_vec, o_vec, sprd

    def _neg_logpost(z, n_periods=_N_PERIODS_FIXED, obs=None, gate=None):
        m_vec, o_vec, sprd = constrain(z, n_periods)
        # the setup follows z: a start or chain sharded onto another device
        # evaluates there (BayesSetup.on_device)
        lp = setup.on_device(z.device).log_posterior(
            _as_model(m_vec), _as_obs(o_vec, n_sent), sprd, obs=obs,
            gate=gate)
        return None if lp is None else -lp

    if free_n:
        neg_logpost = _neg_logpost
    elif traced_obs:
        def neg_logpost(z, obs, gate=None):
            return _neg_logpost(z, obs=obs, gate=gate)
    else:
        def neg_logpost(z, gate=None):
            return _neg_logpost(z, gate=gate)

    def unconstrain(m_vec, o_vec, sprd):
        zero = torch.zeros((), dtype=m_vec.dtype, device=m_vec.device)
        parts = [torch.stack([t.fwd(m_vec[i]) if i != _N_PERIODS_SLOT
                              else zero for i, t in enumerate(t_m)]),
                 torch.stack([t_o[j].fwd(o_vec[j]) for j in range(n_obs)])]
        if use_sprd:
            parts.append(sprd_t.fwd(sprd).reshape(1))
        return torch.cat(parts)

    return neg_logpost, constrain, unconstrain


def initial_z(setup: BayesSetup, use_sprd, m0=None, o0=None, sprd0=0.3):
    """The unconstrained starting point of :func:`map_fit` (f32 on the
    setup's device): the reference's initial values unless given."""
    _, _, unconstrain = _make_objective(setup, use_sprd)
    if m0 is None:
        m0 = initial_model_params()
    if o0 is None:
        o0 = initial_obs_params(
            [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
            setup.cell_res ** 2, setup.obs_model)
    dev = setup.setup.wind_flat.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return unconstrain(f32(m0), f32(o0), f32(sprd0))


def _adam(neg_logpost, z0, n_steps, learning_rate):
    """``n_steps`` of ``torch.optim.Adam`` (the update of optax's ``adam``
    up to rounding) from ``z0``; non-finite gradient components are zeroed
    before each update, as in the JAX fit.  Returns ``(z, losses)``, the
    losses a tensor of each step's value before its update."""
    z = z0.detach().clone().requires_grad_()
    opt = torch.optim.Adam([z], lr=learning_rate)
    losses = []
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = neg_logpost(z)
        loss.backward()
        with torch.no_grad():
            z.grad = torch.where(torch.isfinite(z.grad), z.grad,
                                 torch.zeros_like(z.grad))
        opt.step()
        losses.append(loss.detach())
    return z.detach(), (torch.stack(losses) if losses
                        else torch.zeros(0, dtype=z.dtype, device=z.device))


def _fit_dict(setup, use_sprd, z, losses, **extra):
    """The ``map_fit``-shaped result at ``z``: constrained estimates, the
    log posterior there (one more value) and its AIC."""
    neg_logpost, constrain, _ = _make_objective(setup, use_sprd)
    with torch.no_grad():
        m_vec, o_vec, sprd = constrain(z)
        logp = float(-neg_logpost(z))
    n_params = _N_MODEL - 1 + len(o_vec) + (1 if use_sprd else 0)
    out = {
        'z': z.cpu().numpy(),
        'model': m_vec.cpu().numpy(),
        'obs': o_vec.cpu().numpy(),
        'sprd_factor': float(sprd) if use_sprd else None,
        'logp': logp,
        'AIC': 2 * n_params - 2 * logp,    # ref Bayes_MAP.py:494-517
        'losses': np.asarray(losses, np.float32),
        'use_sprd': use_sprd,
    }
    out.update(extra)
    return out


def map_fit(setup: BayesSetup, n_steps=300, learning_rate=0.02,
            use_sprd=None, m0=None, o0=None, sprd0=0.3):
    """Optimize the posterior mode with Adam.  Returns a dict with the
    unconstrained point ``z``, the constrained estimates, the log posterior
    at the mode and its AIC, and the per-step losses."""
    if use_sprd is None:
        use_sprd = default_use_sprd(setup.params)
    neg_logpost, _, _ = _make_objective(setup, use_sprd)
    z, losses = _adam(neg_logpost, initial_z(setup, use_sprd, m0, o0, sprd0),
                      n_steps, learning_rate)
    return _fit_dict(setup, use_sprd, z, losses.cpu().numpy())


def lbfgs_polish(setup: BayesSetup, z, n_steps=30, use_sprd=None):
    """Quasi-Newton refinement of a MAP point: ``n_steps`` iterations of
    ``torch.optim.LBFGS`` with its strong-Wolfe line search (the JAX fit
    takes optax's L-BFGS with a zoom line search; the trajectories differ,
    the optima agree) from an Adam solution ``z``, with the JAX fit's guard
    zeroing non-finite gradient components.  An iteration whose line search
    leaves the finite values is undone and ends the polish; one that finds
    no step empties the memory and restarts from steepest descent, and the
    polish ends when that finds none either.  Returns a
    ``map_fit``-shaped dict whose losses are each iteration's starting
    value."""
    if use_sprd is None:
        use_sprd = default_use_sprd(setup.params)
    neg_logpost, _, _ = _make_objective(setup, use_sprd)
    dev = setup.setup.wind_flat.device
    z = torch.tensor(np.asarray(z, np.float32), device=dev,
                     requires_grad=True)
    # one iteration a call, memory 10 and up to 15 line-search evaluations
    # as optax's defaults (max_eval bounds the line search: its own default
    # for one iteration would leave it a single trial); no tolerance stops
    # an iteration early
    opt = torch.optim.LBFGS([z], lr=1.0, max_iter=1, max_eval=16,
                            history_size=10, tolerance_grad=0.0,
                            tolerance_change=0.0,
                            line_search_fn='strong_wolfe')

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = neg_logpost(z)
        loss.backward()
        with torch.no_grad():
            z.grad = torch.where(torch.isfinite(z.grad), z.grad,
                                 torch.zeros_like(z.grad))
        return loss

    losses = []
    fresh = True
    for _ in range(n_steps):
        before = z.detach().clone()
        loss = opt.step(closure)
        losses.append(float(loss.detach()))
        if not bool(torch.isfinite(z).all()):
            with torch.no_grad():
                z.copy_(before)
            break
        if torch.equal(z.detach(), before):
            # the line search found no step: restart from steepest descent
            # with an empty memory, and stop if that finds none either
            if fresh:
                break
            opt.state.clear()
            fresh = True
        else:
            fresh = False
    return _fit_dict(setup, use_sprd, z.detach(), losses)


def map_fit_multistart(setup: BayesSetup, n_starts=8, seed=0, n_steps=300,
                       learning_rate=0.02, use_sprd=None, mesh=None,
                       verbose=False):
    """Global MAP search: ``n_starts`` Adam runs from over-dispersed
    starting points, best mode wins.  Start 0 is the reference's
    initialisation; the others draw the model and observation blocks from
    the joint prior (``priors.sample_prior_*``, a CPU generator seeded with
    ``seed``) and ``sprd_factor`` from U(0.02, 0.98).  The starts run in
    turn, as the JAX fit's ``lax.map`` runs them; with a ``mesh``
    (``parallel.chains.chain_mesh``; the start count must divide over it)
    each shard's starts run on its device, exactly as without one.
    Returns the best start's ``map_fit``-shaped dict plus
    ``'start_logps'`` (each start's log posterior at its last step) and
    ``'best_start'``."""
    from ..parallel.chains import member_devices
    from .priors import sample_prior_model, sample_prior_obs
    if use_sprd is None:
        use_sprd = default_use_sprd(setup.params)
    neg_logpost, _, unconstrain = _make_objective(setup, use_sprd)
    dev = setup.setup.wind_flat.device
    gen = torch.Generator().manual_seed(int(seed))
    k = n_starts - 1
    ms = sample_prior_model(gen, k)
    os_ = sample_prior_obs(gen, setup.field_areas.cpu().numpy(),
                           setup.min_field_area, setup.obs_model, k)
    sprds = 0.02 + 0.96 * torch.rand(k, generator=gen)
    z0s = [initial_z(setup, use_sprd)] + [
        unconstrain(ms[i].to(dev), os_[i].to(dev), sprds[i].to(dev))
        for i in range(k)]
    if mesh is not None:
        z0s = [z.to(d) for z, d in zip(z0s, member_devices(n_starts, mesh))]
    zs, lasts = [], []
    for i, z0 in enumerate(z0s):
        z, losses = _adam(neg_logpost, z0, n_steps, learning_rate)
        zs.append(z)
        lasts.append(float(losses[-1]) if n_steps else math.nan)
        if verbose:
            print('multistart: start {}/{} done, -logp {:.2f}'.format(
                i + 1, n_starts, lasts[-1]), flush=True)
    logps = -np.asarray(lasts, np.float64)
    best = int(np.nanargmax(logps))
    return _fit_dict(setup, use_sprd, zs[best].to(dev),
                     np.zeros(0, np.float32),
                     start_logps=logps, best_start=best)


# ---------------------------------------------------------------------------
# the second-order rest: Hessian, Laplace approximation, NUTS warm metric
# ---------------------------------------------------------------------------

def hessian_columns(f, z):
    """Full Hessian of scalar ``f`` at ``z``, one row at a time: one
    gradient with ``create_graph``, then for each coordinate i the gradient
    of ``grad f · e_i`` through that graph (reverse over reverse; row i is
    ∂(∂f/∂z_i)/∂z).  Never all d rows batched: JAX's batched ``jax.hessian``
    asked 23.8 GB of a 16 GB TPU at 801² (``parasitoids_tpu/bayes/
    map_fit.py:352-356``); one row costs one backward through the retained
    first-order graph.  Returns a ``(d, d)`` tensor in ``z``'s dtype."""
    z = z.detach().clone().requires_grad_()
    grad, = torch.autograd.grad(f(z), z, create_graph=True)
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    rows = [torch.autograd.grad(grad, z, grad_outputs=eye[i],
                                retain_graph=i + 1 < z.shape[0])[0]
            for i in range(z.shape[0])]
    return torch.stack(rows).detach()


def plain_twin(setup: BayesSetup, dtype=None) -> BayesSetup:
    """The same posterior on the plain accumulate, in ``dtype`` (default
    the setup's own): the counterpart of JAX's ``xla_twin``.  The setup
    itself when it already is one.  The twin is built from this setup's
    own wind arrays (upcast exactly where ``dtype`` is wider) and keeps
    its ``sprd_factor``, forward mesh, observed data and held-out
    ``obs_mask``: a
    Laplace metric of held-out data must take its curvature from the
    held-out likelihood too."""
    from ..models.forward import setup_from_numpy
    s = setup.setup
    own = s.wind_flat.dtype
    dtype = own if dtype is None else dtype
    if not s.kcfg.pallas and dtype == own:
        return setup
    fs = setup_from_numpy(s.wind_flat.cpu().numpy(),
                          s.wind_cumsum.cpu().numpy(), s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, s.wind_flat.device, dtype,
                          use_pallas=False)
    params = copy.copy(setup.params)
    params.use_pallas = False
    twin = BayesSetup(params, sprd_factor=setup.sprd_factor, dtype=dtype,
                      forward_setup=fs, forward_mesh=setup.forward_mesh)

    def cast(group):
        return [t.to(dtype) for t in group]

    twin.obs_release = cast(setup.obs_release)
    twin.obs_sentinel = cast(setup.obs_sentinel)
    twin.obs_grid = setup.obs_grid.to(dtype)
    if setup.obs_mask is not None:
        rel, sent, grid = setup.obs_mask
        twin.obs_mask = (tuple(cast(rel)), tuple(cast(sent)), grid.to(dtype))
    return twin


def hessian_dtype(setup: BayesSetup):
    """The precision of the Laplace Hessian: f64 on the card, where the
    f32 plain accumulate's atomic adds change its sums from run to run;
    the setup's own dtype on the CPU."""
    if setup.setup.wind_flat.device.type == 'cuda':
        return torch.float64
    return setup.setup.wind_flat.dtype


def prior_var_z(setup: BayesSetup, use_sprd=False, n=4000, seed=0,
                draws=None):
    """Monte-Carlo prior variances of the unconstrained parameter vector
    (the z packing of ``_make_objective``), from the exact prior samplers
    (``priors.sample_prior_*`` on a CPU generator seeded with ``seed``, and
    ``sprd_factor`` from U(1e-3, 1 - 1e-3)).  ``draws``: ``(model (n, 15),
    obs (n, n_obs), sprd (n,))`` arrays used instead, so that a test can
    replay another sampler's draws.  The pinned ``n_periods`` slot (packed
    as the constant 0) comes out exactly 0, which the spectral floor of
    :func:`regularize_cov_z` relies on to leave it pinned.  Returns f64
    numpy."""
    from .priors import sample_prior_model, sample_prior_obs
    _, _, unconstrain = _make_objective(setup, use_sprd)
    if draws is None:
        gen = torch.Generator().manual_seed(int(seed))
        ms = sample_prior_model(gen, n)
        os_ = sample_prior_obs(gen, setup.field_areas.cpu().numpy(),
                               setup.min_field_area, setup.obs_model, n)
        sprds = 1e-3 + (1.0 - 2e-3) * torch.rand(n, generator=gen)
    else:
        ms, os_, sprds = (torch.as_tensor(np.array(a, np.float32))
                          for a in draws)
    zs = torch.func.vmap(unconstrain)(ms, os_, sprds)
    return zs.double().numpy().var(axis=0)


def regularize_cov_z(cov_z, prior_var, floor_frac=1e-4):
    """Spectral prior-floor safety net for a Laplace covariance: each
    eigendirection's variance is floored at ``floor_frac`` × its
    prior-variance projection ``vᵀ diag(prior_var) v`` (f64 throughout).
    The floor is tiny on purpose (an sd floor at 1% of the prior sd): a
    data-informed direction may sit orders of magnitude below prior scale;
    the principled repair of crushed directions is
    :func:`blend_prior_metric`, and this floor only keeps any direction
    from reaching f32-epsilon scale.  Pinned slots have ``prior_var = 0``
    (:func:`prior_var_z`), so their floor is 0 and they stay at the PSD
    jitter.  Host numpy, a copy of the JAX function."""
    cov = np.asarray(cov_z, np.float64)
    cov = 0.5 * (cov + cov.T)
    lam, V = np.linalg.eigh(cov)
    proj = (V ** 2 * np.asarray(prior_var, np.float64)[:, None]).sum(0)
    lam = np.maximum(np.abs(lam), floor_frac * proj)
    lam = np.maximum(lam, 1e-12)      # PSD jitter for pinned directions
    out = (V * lam) @ V.T
    return 0.5 * (out + out.T)


def blend_prior_metric(H_raw, H_negprior, H_prior_T, prior_var,
                       noise_rel=1e-5, prior_prec_floor=1e-4,
                       lam_pin=1e12):
    """Posterior covariance estimate that blends prior curvature into
    prior-only and near-null eigendirections (host numpy f64, a copy of
    the JAX function):

    * ``H_lik = H_raw − H_negprior``, the likelihood curvature alone;
    * eigenvalues of ``H_lik`` below ``noise_rel × max|eig|`` (the noise
      floor of an f32 Hessian) or negative are zeroed;
    * the precision is ``H_lik⁺ + H_prior_T``, with ``H_prior_T`` the exact
      prior curvature of the NUTS target (prior and bijection
      log-Jacobian) |eigenvalue|-clipped to ``[prior_prec_floor,
      lam_pin]``;
    * pinned slots (``prior_var == 0``) get precision ``lam_pin``;
    * the covariance is the precision's inverse.

    A prior-only direction thus keeps its full prior scale while a
    data-informed one keeps its likelihood curvature."""
    H_lik = (np.asarray(H_raw, np.float64)
             - np.asarray(H_negprior, np.float64))
    H_lik = 0.5 * (H_lik + H_lik.T)
    lam, V = np.linalg.eigh(H_lik)
    tau = noise_rel * np.max(np.abs(lam)) if lam.size else 0.0
    lam = np.where(lam > tau, lam, 0.0)
    H_lik_psd = (V * lam) @ V.T

    Hp = np.asarray(H_prior_T, np.float64)
    Hp = 0.5 * (Hp + Hp.T)
    lp, Vp = np.linalg.eigh(Hp)
    lp = np.clip(np.abs(lp), prior_prec_floor, lam_pin)
    Hp_psd = (Vp * lp) @ Vp.T

    prec = H_lik_psd + Hp_psd
    pinned = np.asarray(prior_var, np.float64) == 0.0
    if pinned.any():
        idx = np.where(pinned)[0]
        prec[idx, :] = 0.0
        prec[:, idx] = 0.0
        prec[idx, idx] = lam_pin
    prec = 0.5 * (prec + prec.T)
    cov = np.linalg.inv(prec)
    return 0.5 * (cov + cov.T)


def _theta_flat(constrain, use_sprd):
    """``z -> θ`` packed flat: model block, observation block and, when
    fit, ``sprd_factor``."""
    def theta(z):
        m_vec, o_vec, sprd = constrain(z)
        parts = [m_vec, o_vec] + ([sprd.reshape(1)] if use_sprd else [])
        return torch.cat(parts)
    return theta


def _neg_logprior_z(setup: BayesSetup, constrain, with_jacobian,
                    use_sprd=False):
    """Negative log prior over the unconstrained vector, optionally with
    the bijections' log-Jacobian (the prior part of the NUTS target,
    ``nuts.make_transformed_logpdf``).  It runs no forward model, so
    ``torch.func`` differentiates it exactly; every θ_i depends on one z_j,
    so |J| is the product of the Jacobian's row maxima."""
    from .priors import log_prior_model, log_prior_obs
    theta = _theta_flat(constrain, use_sprd)

    def neg_prior(z):
        m_vec, o_vec, _ = constrain(z)
        lp = log_prior_model(_as_model(m_vec)) + log_prior_obs(
            _as_obs(o_vec, setup.n_sent), setup.field_areas.to(z.dtype),
            setup.min_field_area, setup.obs_model)
        if not with_jacobian:
            return -lp
        d = torch.func.jacfwd(theta)(z).abs().amax(dim=1)
        return -lp - torch.sum(torch.log(torch.where(d > 0, d,
                                                     torch.ones_like(d))))

    return neg_prior


def laplace_warm_mass(setup: BayesSetup, n_steps=200, use_sprd=False,
                      floor_frac=1e-4):
    """The ``--mass laplace`` / ``--mass ridge`` warm start: MAP fit →
    Laplace Hessian → likelihood/prior curvature blend
    (:func:`blend_prior_metric`) → spectral safety floor
    (:func:`regularize_cov_z`) → f32 dense inverse mass matrix.  Returns
    ``(fit, inv_mass)``; ``fit['cov_z_reg']`` holds the regularized f64
    covariance (the whitening input of ``--mass ridge``) and
    ``fit['laplace']`` the :func:`laplace_approximation` it came from."""
    fit = map_fit(setup, n_steps=n_steps, use_sprd=use_sprd)
    lap = laplace_approximation(setup, fit)
    _, constrain, _ = _make_objective(setup, use_sprd)
    z = torch.as_tensor(fit['z']).to(setup.setup.wind_flat.device)
    H_negprior, H_prior_T = (
        torch.func.hessian(_neg_logprior_z(setup, constrain, jac,
                                           use_sprd))(z).cpu().numpy()
        for jac in (False, True))
    pv = prior_var_z(setup, use_sprd=use_sprd)
    cov = blend_prior_metric(lap['hess_z'], H_negprior, H_prior_T, pv)
    cov_reg = regularize_cov_z(cov, pv, floor_frac=floor_frac)
    fit['cov_z_reg'] = cov_reg
    fit['laplace'] = lap
    return fit, np.asarray(cov_reg, np.float32)


def laplace_approximation(setup: BayesSetup, fit, dtype=None):
    """Normal approximation around the MAP point (ref ``pm.NormApprox``,
    Bayes_MAP.py:521-569): the mean and full covariance in the
    unconstrained space, and per-parameter standard deviations mapped back
    through the bijections by linearization.

    The Hessian is :func:`hessian_columns` of the negative log posterior on
    :func:`plain_twin` in ``dtype`` (default :func:`hessian_dtype`).  Slots
    that do not enter the posterior (the pinned ``n_periods``) leave an
    exactly-zero row and are regularized away (``free``).  The Laplace log
    evidence (conditional on the pinned ``n_periods``) is
    ``logp + log|J| + (d/2) log 2π − ½ log det H`` over the free block;
    a Hessian that is not positive definite there (an unconverged MAP or a
    saddle) gives NaN and ``hess_pd`` False.  Positive definiteness is read
    from the free block's eigenvalues, not from the sign of its
    determinant as in the JAX function, whose rule passes a saddle with an
    even number of negative directions.  Besides JAX's keys the result
    holds the Hessian's ``precision``, ``seconds`` and, on the card, its
    ``peak_bytes``."""
    use_sprd = fit['use_sprd']
    twin = plain_twin(setup, hessian_dtype(setup) if dtype is None
                      else dtype)
    neg_logpost, constrain, _ = _make_objective(twin, use_sprd)
    dev = twin.setup.wind_flat.device
    z = torch.as_tensor(np.asarray(fit['z'])).to(
        device=dev, dtype=twin.setup.wind_flat.dtype)
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tic = time.perf_counter()
    H = hessian_columns(neg_logpost, z).cpu().numpy()
    seconds = time.perf_counter() - tic
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    H_raw = np.array(H, np.float64)  # before the surgery (blend_prior_metric)
    free = np.abs(np.diag(H)) >= 1e-12
    H = H.copy()
    H[~free, ~free] = 1e12
    cov_z = np.linalg.inv(H)

    jac_full = torch.func.jacfwd(_theta_flat(constrain, use_sprd))(
        z).cpu().numpy()
    # delta method over the model and observation rows (the optional
    # sprd_factor row is the last)
    jac = jac_full[:-1] if use_sprd else jac_full
    cov_theta = jac @ cov_z @ jac.T
    col = np.max(np.abs(jac_full), axis=0)
    log_jac = float(np.sum(np.log(col[free])))
    H_free = H[np.ix_(free, free)]
    _, logdet_h = np.linalg.slogdet(H_free)
    lam = np.linalg.eigvalsh(0.5 * (H_free + H_free.T))
    pd = bool(lam.size == 0 or lam.min() > 0)
    d_free = int(free.sum())
    log_evidence = (fit['logp'] + log_jac
                    + 0.5 * d_free * np.log(2.0 * np.pi) - 0.5 * logdet_h
                    if pd else float('nan'))
    return {'cov_z': cov_z, 'cov_theta': cov_theta, 'hess_z': H_raw,
            'sd_theta': np.sqrt(np.clip(np.diag(cov_theta), 0, None)),
            'free': free, 'log_jac': log_jac, 'logdet_h': float(logdet_h),
            'hess_pd': pd,
            'log_evidence': float(log_evidence),
            'precision': str(z.dtype).replace('torch.', ''),
            'seconds': seconds, 'peak_bytes': peak}


def map_report(setup: BayesSetup, fit, laplace=None, out=None):
    """Human-readable report like the reference's MAP/NormApprox text
    output (Bayes_MAP.py:494-517, 546-565): with a Laplace approximation,
    its log evidence and each parameter's standard deviation."""
    lines = ['MAP fit: logp = {:.4f}, AIC = {:.4f}'.format(
        fit['logp'], fit['AIC'])]
    if laplace and 'log_evidence' in laplace:
        lines.append(
            'Laplace log-evidence (n_periods fixed): {:.4f}{}'.format(
                laplace['log_evidence'],
                '' if laplace['hess_pd'] else
                '  [nan: Hessian not positive definite at the fit]'))
    names = (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
             + ['sent_obs_prob_{}'.format(k)
                for k in setup.locinfo.sent_ids]
             + list(obs_extra_names(setup.obs_model)))
    vals = np.concatenate([fit['model'], fit['obs']])
    sds = laplace['sd_theta'] if laplace else None
    for i, (n, v) in enumerate(zip(names, vals)):
        if sds is not None:
            lines.append('  {:>18s} = {:<12.6g} (sd {:.4g})'.format(
                n, v, sds[i]))
        else:
            lines.append('  {:>18s} = {:<12.6g}'.format(n, v))
    if fit['use_sprd']:
        lines.append('  {:>18s} = {:<12.6g}'.format('sprd_factor',
                                                    fit['sprd_factor']))
    text = '\n'.join(lines)
    if out:
        with open(out, 'w') as f:
            f.write(text + '\n')
    return text


def map_cli_params(overrides=()):
    """The MAP CLI's configuration: Kalbar population model on the coarser
    MAP domain (10000 m, 200 cells, Bayes_MAP.py:95), then ``key=value``
    overrides."""
    from ..config import Params
    params = Params()
    params.cmd_line_chg(['--kalbar'])
    params.PLOT = False
    params.OUTPUT = False
    params.PROB_MODEL = False
    params.domain_info = (10000.0, 200)
    for ov in overrides:
        if '=' in ov:
            k, _, v = ov.partition('=')
            params.chg_param(k, v)
    return params


def main(argv=None, device=None):
    """CLI like the reference ``python Bayes_MAP.py --MAP | --norm``
    (Bayes_MAP.py:572-651): coarser domain, n_periods fixed, Kalbar
    pre-spread factor fit.  ``device`` given here wins over ``--device``.
    Returns the fit, with ``--norm`` its Laplace approximation under
    ``'laplace'``."""
    parser = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.bayes.map_fit')
    g = parser.add_mutually_exclusive_group(required=True)
    g.add_argument('--MAP', action='store_true',
                   help='find the posterior mode')
    g.add_argument('--norm', action='store_true',
                   help='MAP + Laplace normal approximation (the Hessian on '
                        'the plain path, in f64 on the card)')
    parser.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                        help='where to run (default cuda; no CPU fallback)')
    parser.add_argument('-o', '--outname', default='map_fit.txt')
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--starts', type=int, default=1,
                        help='multi-start global MAP: N Adam runs from the '
                             'reference initialisation and N - 1 prior '
                             'draws, sharded over the visible cards when N '
                             'divides over them; best mode wins')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the multi-start prior draws')
    parser.add_argument('--polish', type=int, default=0, metavar='N',
                        help='L-BFGS refinement steps after the Adam fit')
    parser.add_argument('--shard-forward', action='store_true',
                        help='shard each forward simulation\'s '
                             'flight-minute axis over the visible cards '
                             '(single-fit latency scaling, as on '
                             'bayes.run); incompatible with --starts > 1, '
                             'which shards over starts instead')
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)
    if args.shard_forward and args.starts > 1:
        parser.error('--shard-forward is incompatible with --starts > 1 '
                     '(multi-start already shards over the mesh)')
    from .. import device as _device
    from ..parallel.chains import chain_mesh
    from ..parallel.domain import minute_mesh

    device = args.device if device is None else device
    setup = BayesSetup(map_cli_params(args.overrides), device=device)
    dev = setup.setup.wind_flat.device
    print('device {}, accumulate {}'.format(
        dev, 'CUDA day kernel' if setup.setup.kcfg.pallas
        else 'plain torch'))
    devices = _device.visible_devices(device)
    if args.shard_forward:
        if len(devices) > 1:
            setup = setup.with_forward_mesh(minute_mesh(devices=devices))
            print('forward pass sharded over {} devices (flight-minute '
                  'axis)'.format(setup.forward_mesh.size))
        else:
            print('--shard-forward: single device, running unsharded')
    tic = time.time()
    if args.starts > 1:
        mesh = None
        if len(devices) > 1 and args.starts % len(devices) == 0:
            mesh = chain_mesh(devices=devices)
            print('starts sharded over {} devices'.format(len(devices)))
        fit = map_fit_multistart(setup, n_starts=args.starts, seed=args.seed,
                                 n_steps=args.steps, mesh=mesh, verbose=True)
        print('multistart: best start {} of {}; per-start logp: {}'.format(
            fit['best_start'], args.starts,
            np.array2string(fit['start_logps'], precision=1)))
    else:
        fit = map_fit(setup, n_steps=args.steps)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    dt = time.time() - tic
    print('optimization: {:.1f} s for {} steps ({:.2f} sec./model eval incl. '
          'gradient)'.format(dt, args.steps, dt / max(args.steps, 1)))
    if args.polish:
        pre = fit['logp']
        tic = time.time()
        fit = lbfgs_polish(setup, fit['z'], n_steps=args.polish,
                           use_sprd=fit['use_sprd'])
        print('L-BFGS polish: logp {:.4f} -> {:.4f} ({} steps, {:.1f} s; '
              'each step may take several line-search evaluations)'.format(
                  pre, fit['logp'], args.polish, time.time() - tic))
    lap = None
    if args.norm:
        lap = laplace_approximation(setup, fit)
        print('laplace: Hessian on the plain path in {}, {} columns in '
              '{:.1f} s ({:.2f} s a column){}'.format(
                  lap['precision'], lap['hess_z'].shape[0], lap['seconds'],
                  lap['seconds'] / lap['hess_z'].shape[0],
                  '' if lap['peak_bytes'] is None else
                  ', peak {} bytes on the card'.format(lap['peak_bytes'])))
        fit['laplace'] = lap
    report = map_report(setup, fit, lap, out=args.outname)
    print(report)
    print('written to', args.outname)
    return fit


if __name__ == '__main__':
    main()

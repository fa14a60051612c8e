"""MAP estimation, PyTorch port of the Adam path of
``parasitoids_tpu/bayes/map_fit.py`` (reference Bayes_MAP.py).

The negative log posterior is differentiated end to end (on CUDA through
the day kernel's backward) and minimized with Adam in an unconstrained
reparameterization.  As in the reference, ``n_periods`` is held at 30
(Bayes_MAP.py:144-147) and the Kalbar pre-spread factor is an extra
Uniform(0, 1) parameter (Bayes_MAP.py:200-205).

Run as ``python -m parasitoids_tpu_torch.bayes.map_fit --MAP [--starts N
--seed S] [--polish N]``: Adam from the reference's initial values or from
several prior draws (in turn), then optionally an L-BFGS polish.  The
Laplace approximation (``--norm``) is not ported yet (ROADMAP Queue 1 item
13b), nor is the sharded forward (item 16).
"""

from __future__ import annotations

import argparse
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

__all__ = ['default_use_sprd', 'initial_z', 'lbfgs_polish', 'main',
           'map_cli_params', 'map_fit', 'map_fit_multistart', 'map_report']

_N_PERIODS_FIXED = 30.0
_N_PERIODS_SLOT = MODEL_PARAM_NAMES.index('n_periods')
_NOT_PORTED = 'not ported to torch yet (ROADMAP Queue 1 item 13b)'


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
        lp = setup.log_posterior(_as_model(m_vec), _as_obs(o_vec, n_sent),
                                 sprd, obs=obs, gate=gate)
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
    turn, as the JAX fit's ``lax.map`` runs them.  Returns the best start's
    ``map_fit``-shaped dict plus ``'start_logps'`` (each start's log
    posterior at its last step) and ``'best_start'``."""
    from .priors import sample_prior_model, sample_prior_obs
    if mesh is not None:
        raise NotImplementedError('starts sharded over several devices are '
                                  'not ported: ROADMAP Queue 1 item 16')
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
    return _fit_dict(setup, use_sprd, zs[best], np.zeros(0, np.float32),
                     start_logps=logps, best_start=best)


def map_report(setup: BayesSetup, fit, out=None):
    """Human-readable report like the reference's MAP text output
    (Bayes_MAP.py:494-517).  The Laplace log-evidence and standard
    deviations of the JAX report come with the Laplace port."""
    lines = ['MAP fit: logp = {:.4f}, AIC = {:.4f}'.format(
        fit['logp'], fit['AIC'])]
    names = (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
             + ['sent_obs_prob_{}'.format(k)
                for k in setup.locinfo.sent_ids]
             + list(obs_extra_names(setup.obs_model)))
    vals = np.concatenate([fit['model'], fit['obs']])
    for n, v in zip(names, vals):
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
    """CLI like the reference ``python Bayes_MAP.py --MAP``
    (Bayes_MAP.py:572-651): coarser domain, n_periods fixed, Kalbar
    pre-spread factor fit.  ``device`` given here wins over ``--device``.
    Returns the fit."""
    parser = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.bayes.map_fit')
    g = parser.add_mutually_exclusive_group(required=True)
    g.add_argument('--MAP', action='store_true',
                   help='find the posterior mode')
    g.add_argument('--norm', action='store_true',
                   help='MAP + Laplace normal approximation (' + _NOT_PORTED
                   + ')')
    parser.add_argument('--device', choices=('cpu', 'cuda'), default='cuda',
                        help='where to run (default cuda; no CPU fallback)')
    parser.add_argument('-o', '--outname', default='map_fit.txt')
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--starts', type=int, default=1,
                        help='multi-start global MAP: N Adam runs, in turn, '
                             'from the reference initialisation and N - 1 '
                             'prior draws; best mode wins')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the multi-start prior draws')
    parser.add_argument('--polish', type=int, default=0, metavar='N',
                        help='L-BFGS refinement steps after the Adam fit')
    parser.add_argument('--shard-forward', action='store_true',
                        help='minute-sharded forward (not ported: ROADMAP '
                             'Queue 1 item 16)')
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)
    if args.norm:
        parser.error('--norm (Laplace) is ' + _NOT_PORTED)
    if args.shard_forward:
        parser.error('--shard-forward is not ported (ROADMAP Queue 1 item '
                     '16)')

    setup = BayesSetup(map_cli_params(args.overrides),
                       device=args.device if device is None else device)
    dev = setup.setup.wind_flat.device
    print('device {}, accumulate {}'.format(
        dev, 'CUDA day kernel' if setup.setup.kcfg.pallas
        else 'plain torch'))
    tic = time.time()
    if args.starts > 1:
        fit = map_fit_multistart(setup, n_starts=args.starts, seed=args.seed,
                                 n_steps=args.steps, verbose=True)
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
    report = map_report(setup, fit, out=args.outname)
    print(report)
    print('written to', args.outname)
    return fit


if __name__ == '__main__':
    main()

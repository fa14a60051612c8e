"""MAP estimation, PyTorch port of the Adam path of
``parasitoids_tpu/bayes/map_fit.py`` (reference Bayes_MAP.py).

The negative log posterior is differentiated end to end (on CUDA through
the day kernel's backward) and minimized with Adam in an unconstrained
reparameterization.  As in the reference, ``n_periods`` is held at 30
(Bayes_MAP.py:144-147) and the Kalbar pre-spread factor is an extra
Uniform(0, 1) parameter (Bayes_MAP.py:200-205).

Run as ``python -m parasitoids_tpu_torch.bayes.map_fit --MAP``.  The
L-BFGS polish, multi-start, the Laplace approximation (``--norm``) and the
sharded forward are not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .model import _N_MODEL, BayesSetup, _as_model, _as_obs
from .priors import (MODEL_PARAM_NAMES, OBS_PARAM_NAMES,
                     initial_model_params, initial_obs_params,
                     obs_extra_names)
from .transforms import MODEL_TRANSFORMS, Unit, obs_transforms

__all__ = ['default_use_sprd', 'initial_z', 'main', 'map_cli_params',
           'map_fit', 'map_report']

_N_PERIODS_FIXED = 30.0
_N_PERIODS_SLOT = MODEL_PARAM_NAMES.index('n_periods')
_NOT_PORTED = 'not ported to torch yet (ROADMAP Queue 1 item 13)'


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
    ``n_periods`` pinned at 30.  The JAX module's ``free_n`` (NUTS) and
    ``traced_obs`` (SBC) forms wait for those samplers."""
    if free_n or traced_obs:
        raise NotImplementedError(
            'free_n and traced_obs serve NUTS and SBC, which are not ported '
            '(ROADMAP Queue 1 items 14 and 18)')
    n_sent, t_m, t_o = _theta_split(setup)
    n_obs = 4 + n_sent + setup.n_extra_obs
    sprd_t = Unit()

    def constrain(z):
        n_per = torch.full((), _N_PERIODS_FIXED, dtype=z.dtype,
                           device=z.device)
        m_vec = torch.stack([t.inv(z[i]) if i != _N_PERIODS_SLOT else n_per
                             for i, t in enumerate(t_m)])
        o_vec = torch.stack([t_o[j].inv(z[_N_MODEL + j])
                             for j in range(n_obs)])
        sprd = sprd_t.inv(z[-1]) if use_sprd else None
        return m_vec, o_vec, sprd

    def neg_logpost(z):
        m_vec, o_vec, sprd = constrain(z)
        return -setup.log_posterior(_as_model(m_vec), _as_obs(o_vec, n_sent),
                                    sprd)

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


def map_fit(setup: BayesSetup, n_steps=300, learning_rate=0.02,
            use_sprd=None, m0=None, o0=None, sprd0=0.3):
    """Optimize the posterior mode with Adam (``torch.optim.Adam``, the
    update of optax's ``adam`` up to rounding).  Non-finite gradient
    components are zeroed before each update, as in the JAX fit.  Returns a
    dict with the unconstrained point ``z``, the constrained estimates, the
    log posterior at the mode and its AIC, and the per-step losses."""
    if use_sprd is None:
        use_sprd = default_use_sprd(setup.params)
    neg_logpost, constrain, _ = _make_objective(setup, use_sprd)
    z = initial_z(setup, use_sprd, m0, o0, sprd0).clone().requires_grad_()
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
    with torch.no_grad():
        m_vec, o_vec, sprd = constrain(z)
        logp = float(-neg_logpost(z))
    n_params = _N_MODEL - 1 + len(o_vec) + (1 if use_sprd else 0)
    return {
        'z': z.detach().cpu().numpy(),
        'model': m_vec.cpu().numpy(),
        'obs': o_vec.cpu().numpy(),
        'sprd_factor': float(sprd) if use_sprd else None,
        'logp': logp,
        'AIC': 2 * n_params - 2 * logp,    # ref Bayes_MAP.py:494-517
        'losses': (torch.stack(losses).cpu().numpy() if losses
                   else np.zeros(0, np.float32)),
        'use_sprd': use_sprd,
    }


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
                        help='multi-start MAP (' + _NOT_PORTED + ')')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the multi-start draws; a no-op here, '
                        'since a single-start fit draws nothing')
    parser.add_argument('--polish', type=int, default=0, metavar='N',
                        help='L-BFGS refinement (' + _NOT_PORTED + ')')
    parser.add_argument('--shard-forward', action='store_true',
                        help='minute-sharded forward (not ported: ROADMAP '
                             'Queue 1 item 16)')
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)
    if args.norm:
        parser.error('--norm (Laplace) is ' + _NOT_PORTED)
    if args.starts > 1:
        parser.error('--starts > 1 (multi-start) is ' + _NOT_PORTED)
    if args.polish:
        parser.error('--polish (L-BFGS) is ' + _NOT_PORTED)
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
    fit = map_fit(setup, n_steps=args.steps)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    dt = time.time() - tic
    print('optimization: {:.1f} s for {} steps ({:.2f} sec./model eval incl. '
          'gradient)'.format(dt, args.steps, dt / max(args.steps, 1)))
    report = map_report(setup, fit, out=args.outname)
    print(report)
    print('written to', args.outname)
    return fit


if __name__ == '__main__':
    main()

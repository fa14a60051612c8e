"""Ensemble forward simulation (prior and posterior predictive), PyTorch
port of ``parasitoids_tpu/parallel/ensemble.py``.

The reference studies parameter uncertainty only by re-running ``Run.py``
per parameter set.  Here a batch of model-parameter vectors runs as an
ensemble of forward simulations: posterior-predictive projections from
MCMC draws, prior-predictive coverage checks, spread maps.

The members run in turn on the one card, as the JAX package's ``lax.map``
runs them: a θ-batched forward would evaluate every ρ branch of the BVN
for every member.  Each member reads its own Genz branch through
``BayesSetup._branches`` (one host read a member), so member i is exactly
one ``forward_projections`` call.  Members spread over several cards
(``mesh=``) are not ported (ROADMAP Queue 1 item 16b).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bayes.model import BayesSetup, _as_model
from ..models.forward import build_all_kernels
from ..models.solver import propagate_pop

__all__ = ['ensemble_projections', 'ensemble_fields']

_NO_MESH = ('an ensemble sharded over several devices is not ported: '
            'ROADMAP Queue 1 item 16b')


def _thetas(setup: BayesSetup, thetas):
    """``(B, 15)`` model blocks as a tensor of the setup's dtype and
    device."""
    s = setup.setup
    return torch.as_tensor(np.asarray(thetas)).to(
        device=s.wind_flat.device, dtype=s.wind_flat.dtype)


def ensemble_projections(setup: BayesSetup, thetas, mesh=None):
    """Observation projections for a batch of model-parameter vectors.

    Args:
        setup: BayesSetup (site, domain, data alignment).
        thetas: (B, 15) model-parameter blocks (e.g. posterior draws).
        mesh: not ported; raises.
    Returns:
        (release, sentinel, grid) projection batches on the setup's
        device, leading axis B.

    Members run without a pre-spread day (``sprd_factor=None``), as in the
    JAX function: every sampler CLI fits with ``use_sprd=False``.
    """
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    with torch.no_grad():
        outs = [setup.forward_projections(_as_model(th))
                for th in _thetas(setup, thetas)]
    rel = tuple(torch.stack([o[0][k] for o in outs])
                for k in range(len(setup.obs_release)))
    sent = tuple(torch.stack([o[1][k] for o in outs])
                 for k in range(len(setup.obs_sentinel)))
    return rel, sent, torch.stack([o[2] for o in outs])


def _fields_one(setup: BayesSetup):
    """``theta -> (ndays, D, D)`` population fields of one member."""
    s = setup.setup

    def one(theta):
        m = _as_model(theta)
        branches, _ = setup._branches(m)
        n_per = torch.round(m.n_periods).to(torch.int64)
        kernels, _ = build_all_kernels(
            s.wind_flat, s.wind_cumsum, m.hparams(), m.Dparams(),
            m.Dlparams(), m.mu_r, n_per, s.rad_dist, s.start_idx, s.kcfg,
            setup.ndays, branches)
        return propagate_pop(kernels, setup.r_dur, setup.r_number,
                             setup.dist_weights, s.scfg)

    return one


def ensemble_fields(setup: BayesSetup, thetas, mesh=None, days=None):
    """Full per-day population fields for a batch of parameter vectors,
    ``(B, ndays, D, D)`` on the setup's device; ``days`` (0-based indices)
    keeps only those days of each member, so the full stack never forms.
    Memory scales with B·ndays·D²: prefer :func:`ensemble_projections`
    unless the fields themselves are needed."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    one = _fields_one(setup)
    idx = None if days is None else list(days)
    with torch.no_grad():
        return torch.stack([one(th) if idx is None else one(th)[idx]
                            for th in _thetas(setup, thetas)])

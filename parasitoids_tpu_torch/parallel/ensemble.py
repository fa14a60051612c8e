"""Ensemble forward simulation (prior and posterior predictive), PyTorch
port of ``parasitoids_tpu/parallel/ensemble.py``.

The reference studies parameter uncertainty only by re-running ``Run.py``
per parameter set.  Here a batch of model-parameter vectors runs as an
ensemble of forward simulations: posterior-predictive projections from
MCMC draws, prior-predictive coverage checks, spread maps.

The members run in turn, as the JAX package's ``lax.map`` runs them: a
θ-batched forward would evaluate every ρ branch of the BVN for every
member.  Each member reads its own Genz branch through
``BayesSetup._branches`` (one host read a member), so member i is exactly
one ``forward_projections`` call.  With a mesh (``mesh=``) the member axis
is sharded over its devices: each shard's members run on its device
through the setup's copy there, exactly as without a mesh, and the
results come back to the lead device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bayes.model import BayesSetup, _as_model
from ..models.forward import build_all_kernels
from ..models.solver import propagate_pop
from ..utils import trace

__all__ = ['ensemble_projections', 'ensemble_fields']


def _thetas(setup: BayesSetup, thetas):
    """``(B, 15)`` model blocks (an array or a tensor) as a tensor of the
    setup's dtype and device."""
    s = setup.setup
    t = thetas if torch.is_tensor(thetas) else torch.as_tensor(
        np.asarray(thetas))
    return t.to(device=s.wind_flat.device, dtype=s.wind_flat.dtype)


def _sharded_map(fn, setup: BayesSetup, thetas, mesh):
    """``fn(setup on the device, theta) -> tree of tensors`` over the
    rows of ``thetas``, stacked along a new leading axis; with a mesh the
    rows are sharded over its devices, and a batch that does not divide
    the device count is padded (repeating the last row) and the padding
    stripped from the result, so any draw count works on any mesh."""
    from .chains import concat_rows, shard_bounds

    def stack(outs):
        if torch.is_tensor(outs[0]):
            return torch.stack(outs)
        return tuple(stack(list(xs)) for xs in zip(*outs))

    if mesh is None:
        return stack([fn(setup, th) for th in thetas])
    B = thetas.shape[0]
    pad = (-B) % mesh.size
    if pad:
        thetas = torch.cat([thetas, thetas[-1:].expand(
            (pad,) + tuple(thetas.shape[1:]))])
    parts = []
    for d, a, b in shard_bounds(B + pad, mesh):
        local = setup.on_device(d)
        parts.append(stack([fn(local, th) for th in thetas[a:b].to(d)]))
    out = concat_rows(parts, mesh.devices[0])
    return out if not pad else _strip(out, B)


def _strip(tree, B):
    if torch.is_tensor(tree):
        return tree[:B]
    return tuple(_strip(x, B) for x in tree)


def _projections_one(setup: BayesSetup, theta):
    with trace.span('ensemble.member', request=True):
        return setup.forward_projections(_as_model(theta))


def ensemble_projections(setup: BayesSetup, thetas, mesh=None):
    """Observation projections for a batch of model-parameter vectors.

    Args:
        setup: BayesSetup (site, domain, data alignment).
        thetas: (B, 15) model-parameter blocks (e.g. posterior draws).
        mesh: optional 1-D device mesh (``parallel.chains.chain_mesh``);
            the batch axis is sharded over it (padded internally to a
            multiple of the device count).
    Returns:
        (release, sentinel, grid) projection batches on the setup's
        device (the mesh's lead device), leading axis B.

    Members run without a pre-spread day (``sprd_factor=None``), as in the
    JAX function: every sampler CLI fits with ``use_sprd=False``.
    """
    with torch.no_grad():
        return _sharded_map(_projections_one, setup,
                            _thetas(setup, thetas), mesh)


def _fields_one(setup: BayesSetup, theta, days=None):
    """The ``(ndays, D, D)`` population fields of one member, or only
    ``days`` of them."""
    s = setup.setup
    with trace.span('ensemble.member', request=True):
        m = _as_model(theta)
        branches, _ = setup._branches(m)
        n_per = torch.round(m.n_periods).to(torch.int64)
        kernels, _ = build_all_kernels(
            s.wind_flat, s.wind_cumsum, m.hparams(), m.Dparams(),
            m.Dlparams(), m.mu_r, n_per, s.rad_dist, s.start_idx, s.kcfg,
            setup.ndays, branches)
        fields = propagate_pop(kernels, setup.r_dur, setup.r_number,
                               setup.dist_weights, s.scfg)
        return fields if days is None else fields[days]


def ensemble_fields(setup: BayesSetup, thetas, mesh=None, days=None):
    """Full per-day population fields for a batch of parameter vectors,
    ``(B, ndays, D, D)`` on the setup's device; ``days`` (0-based indices)
    keeps only those days of each member, so the full stack never forms.
    Memory scales with B·ndays·D²: prefer :func:`ensemble_projections`
    unless the fields themselves are needed.  ``mesh``: as
    :func:`ensemble_projections`."""
    idx = None if days is None else list(days)
    with torch.no_grad():
        return _sharded_map(lambda s, th: _fields_one(s, th, idx), setup,
                            _thetas(setup, thetas), mesh)

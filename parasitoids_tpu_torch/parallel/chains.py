"""Multi-chain MCMC execution, PyTorch port of
``parasitoids_tpu/parallel/chains.py``.

The reference runs a single sequential PyMC chain per process.  Here the
chains of a run are stacked along a leading axis
(``bayes.sampler.stack_states``) and advance in turn on the one card, as
the JAX package's ``lax.map`` runs a device's local chains: a
chain-batched forward would have to evaluate every ρ branch of the BVN
for every chain.  Chains over several cards (``chain_mesh``,
``shard_chain_states``, ``run_chains(mesh=...)``) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bayes.model import BayesSetup
from ..bayes.priors import initial_model_params
from ..bayes.sampler import (MCMCConfig, chain_generator, init_chain_state,
                             run_mcmc, stack_states, unstack_states)
from ..bayes.transforms import MODEL_TRANSFORMS

__all__ = ['chain_mesh', 'init_chains', 'shard_chain_states', 'run_chains']

_N_PERIODS_SLOT = 13
_NO_MESH = ('chains sharded over several devices are not ported: ROADMAP '
            'Queue 1 item 16b')


def chain_mesh(n_devices=None, devices=None):
    raise NotImplementedError(_NO_MESH)


def shard_chain_states(states, mesh):
    raise NotImplementedError(_NO_MESH)


def init_chains(setup: BayesSetup, seed, n_chains, jitter=0.05):
    """Initialize ``n_chains`` stacked states with jittered starting
    points; chain ``i`` gets the generator ``chain_generator(seed, i)`` on
    the setup's device.

    Over-dispersed starts make Gelman–Rubin meaningful.  The jitter is
    applied in UNCONSTRAINED space (the transforms of bayes/transforms.py)
    so every start is guaranteed inside the prior support: a
    multiplicative jitter on the constrained values can push bounded
    parameters out of support (lam starts at 0.95 with a (0,1) Beta prior;
    an out-of-support start has −inf prior, and with the tiny
    per-parameter proposal scales the chain would never re-enter).
    ``n_periods`` starts at 30 and observation parameters start
    identically across chains.  The jitter is drawn on the host from
    ``seed`` and the chain index, so the starts do not depend on the
    device.
    """
    dev = setup.setup.wind_flat.device
    m0 = torch.as_tensor(initial_model_params(), dtype=torch.float64)
    z0 = np.array([0.0 if i == _N_PERIODS_SLOT else float(t.fwd(v))
                   for i, (t, v) in enumerate(zip(MODEL_TRANSFORMS, m0))])
    states = []
    for i in range(n_chains):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), i]))
        z_i = torch.as_tensor(z0 + jitter * rng.standard_normal(z0.shape))
        m_i = np.array([30.0 if j == _N_PERIODS_SLOT else float(t.inv(z))
                        for j, (t, z) in enumerate(zip(MODEL_TRANSFORMS,
                                                       z_i))])
        states.append(init_chain_state(setup, chain_generator(seed, i, dev),
                                       m0=m_i))
    return stack_states(states)


def run_chains(setup: BayesSetup, states, cfg: MCMCConfig, mesh=None):
    """Advance all chains of the stacked ``states`` by ``cfg.n_samples``
    steps, one chain after the other; returns ``(states, traces)`` with
    the traces an ``(n_chains, n_samples, dim)`` tensor on the setup's
    device."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    out = [run_mcmc(setup, s, cfg) for s in unstack_states(states)]
    return (stack_states([s for s, _ in out]),
            torch.stack([tr for _, tr in out]))

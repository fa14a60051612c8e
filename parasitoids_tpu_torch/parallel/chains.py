"""Multi-chain MCMC execution and the port's device mesh, PyTorch port of
``parasitoids_tpu/parallel/chains.py``.

The reference runs a single sequential PyMC chain per process.  Here the
chains of a run are stacked along a leading axis
(``bayes.sampler.stack_states``) and advance in turn, as the JAX package's
``lax.map`` runs a device's local chains: a chain-batched forward would
have to evaluate every ρ branch of the BVN for every chain.

A :class:`Mesh` is the counterpart of a 1-D ``jax.sharding.Mesh`` in one
process and one host thread: a tuple of devices, the first the lead.  An
axis sharded over it gives each device a contiguous block of its items;
each block's tensors and generators live on that device and run there, and
the results come back to the lead device.  A device may appear more than
once (each entry is one shard), which is how one card, or the CPU in the
tests, runs a mesh.  The shards run one after the other: on several cards
the host queues a shard's work and moves on only where that work reads
the card.  Nothing here uses ``torch.distributed``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..bayes.model import BayesSetup
from ..bayes.priors import initial_model_params
from ..bayes.sampler import (MCMCConfig, chain_generator, init_chain_state,
                             run_mcmc, stack_states, unstack_states)
from ..bayes.transforms import MODEL_TRANSFORMS

__all__ = ['Mesh', 'axis_mesh', 'chain_mesh', 'visible_mesh', 'init_chains',
           'shard_chain_states', 'run_chains', 'shard_bounds',
           'member_devices', 'to_device',
           'take_rows', 'concat_rows', 'psum', 'move_generator']

_N_PERIODS_SLOT = 13


class Mesh:
    """A 1-D mesh of devices: ``devices`` (a tuple of ``torch.device``, the
    first the lead), ``axis_names``, ``shape`` (axis → size) and ``size``.
    Every device is resolved (``device.resolve_device``), so a mesh that
    names a card torch does not see raises; all are of one type."""

    def __init__(self, devices, axis):
        devs = tuple(_device.resolve_device(d) for d in devices)
        if not devs:
            raise ValueError('a mesh needs at least one device')
        if len({d.type for d in devs}) > 1:
            raise ValueError('a mesh spans devices of one type, got {}'
                             .format([str(d) for d in devs]))
        self.devices = devs
        self.axis_names = (axis,)
        self.shape = {axis: len(devs)}
        self.size = len(devs)

    def __repr__(self):
        return 'Mesh({}: {})'.format(self.axis_names[0],
                                     ', '.join(str(d) for d in self.devices))


def axis_mesh(axis, n_devices=None, devices=None):
    """1-D mesh over ``axis``: ``devices`` (which may repeat one), else
    the first ``n_devices`` of ``device.visible_devices()`` (all by
    default) — the shared constructor behind chain_mesh and
    domain.minute_mesh."""
    if devices is None:
        devices = _device.visible_devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices, axis)


def chain_mesh(n_devices=None, devices=None):
    """1-D mesh over a ``chains`` axis."""
    return axis_mesh('chains', n_devices, devices)


def visible_mesh(device=None):
    """A chain mesh over every visible device (``device.visible_devices``)
    when there is more than one, else None: the analysis command lines'
    choice for their draws, as the JAX ones take ``len(jax.devices()) >
    1``.  Prints the device count when it makes one."""
    devices = _device.visible_devices(device)
    if len(devices) < 2:
        return None
    print('draws sharded over {} devices'.format(len(devices)))
    return chain_mesh(devices=devices)


def shard_bounds(n, mesh):
    """``[(device, start, stop)]``: the contiguous block of ``n`` items
    that each shard of ``mesh`` takes.  Raises when ``n`` does not divide
    evenly over the mesh."""
    if n % mesh.size:
        raise ValueError(
            '{} items cannot shard evenly over {} devices; use a count '
            'divisible by the device count (or mesh=None)'.format(
                n, mesh.size))
    per = n // mesh.size
    return [(d, k * per, (k + 1) * per) for k, d in enumerate(mesh.devices)]


def member_devices(n, mesh):
    """The device of each of ``n`` members sharded over ``mesh`` in
    contiguous blocks (:func:`shard_bounds`)."""
    return [d for d, a, b in shard_bounds(n, mesh) for _ in range(a, b)]


def _is_generators(x):
    return (isinstance(x, tuple) and len(x) > 0 and
            all(isinstance(g, torch.Generator) for g in x))


def _rebuild(like, values):
    if hasattr(like, '_fields'):              # a NamedTuple
        return type(like)(*values)
    return type(like)(values)


def move_generator(gen, device):
    """``gen`` on ``device``: itself when it is there, else a generator of
    the same state there.  Only between cards: a CUDA generator's state is
    a (seed, offset) pair that gives the same draws on any card, a CPU
    generator's is not, so a move between device types raises."""
    device = torch.device(device)
    if gen.device == device:
        return gen
    if gen.device.type != 'cuda' or device.type != 'cuda':
        raise ValueError('a generator on {} cannot move to {}: their '
                         'streams differ'.format(gen.device, device))
    new = torch.Generator(device=device)
    new.set_state(gen.get_state())
    return new


def to_device(tree, device, generators=True):
    """``tree`` with every tensor on ``device`` (tuples, lists and
    NamedTuples mapped, anything else kept), and with ``generators`` every
    ``torch.Generator`` moved there too (:func:`move_generator`)."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, torch.Generator):
        return move_generator(tree, device) if generators else tree
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [to_device(x, device, generators)
                               for x in tree])
    return tree


def take_rows(tree, start, stop):
    """Rows ``start:stop`` of the leading (member) axis of every tensor of
    ``tree`` and of every tuple of per-member generators."""
    if torch.is_tensor(tree) or _is_generators(tree):
        return tree[start:stop]
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [take_rows(x, start, stop) for x in tree])
    return tree


def concat_rows(parts, device):
    """The inverse of :func:`take_rows` over the shards ``parts``: tensors
    concatenated on ``device`` in shard order, the per-member generators
    kept where they are."""
    first = parts[0]
    if torch.is_tensor(first):
        return torch.cat([p.to(device) for p in parts])
    if _is_generators(first):
        return tuple(g for p in parts for g in p)
    if isinstance(first, (tuple, list)):
        return _rebuild(first, [concat_rows(list(ps), device)
                                for ps in zip(*parts)])
    return first


def psum(parts, mesh):
    """The sum of the shards' partial tensors ``parts`` on the mesh's lead
    device, added in shard order: the same bits on every run (no atomic
    adds), as exact resume needs."""
    lead = mesh.devices[0]
    total = parts[0].to(lead)
    for p in parts[1:]:
        total = total + p.to(lead)
    return total


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


def shard_chain_states(states, mesh):
    """The stacked ``states`` as one stacked state per shard of ``mesh``,
    each chain's tensors and generator on its shard's device (contiguous
    blocks of chains).  Raises when the chains do not divide evenly over
    the mesh."""
    return [to_device(take_rows(states, a, b), d)
            for d, a, b in shard_bounds(len(states.key), mesh)]


def _run_in_turn(setup, states, cfg):
    out = [run_mcmc(setup, s, cfg) for s in unstack_states(states)]
    return (stack_states([s for s, _ in out]),
            torch.stack([tr for _, tr in out]))


def run_chains(setup: BayesSetup, states, cfg: MCMCConfig, mesh=None):
    """Advance all chains of the stacked ``states`` by ``cfg.n_samples``
    steps, one chain after the other; returns ``(states, traces)`` with
    the traces an ``(n_chains, n_samples, dim)`` tensor.

    With a mesh the chain axis is sharded over its devices (the chain
    count must divide the device count; the CLI runs unsharded otherwise):
    each shard's chains run on its device through the setup's copy there
    (``BayesSetup.on_device``), exactly the ops they run without a mesh,
    so the result is bitwise that of ``mesh=None``.  States and traces
    come back stacked on the lead device; each chain's generator stays on
    its shard's device."""
    if mesh is None:
        return _run_in_turn(setup, states, cfg)
    outs = [_run_in_turn(setup.on_device(shard.m.device), shard, cfg)
            for shard in shard_chain_states(states, mesh)]
    lead = mesh.devices[0]
    return (concat_rows([s for s, _ in outs], lead),
            concat_rows([tr for _, tr in outs], lead))

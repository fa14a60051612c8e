"""MCMC trace persistence with resume (L4 support), PyTorch port of
``parasitoids_tpu/bayes/store.py``.

The reference stores traces in a PyMC HDF5 database opened in append mode
and resumes chains from it (Bayes_Run.py:484-537).  Here the traces plus
the complete sampler state (positions, cached moments, proposal
adaptation, the random generator's state) go into an ``.npz``, so a
resumed run continues exactly where the previous one stopped: traces
bitwise equal to those of a run that never stopped.

The file has the JAX package's layout (``traces``, ``state_<field>``,
``x_<name>`` extras, a ``.meta.json`` sidecar), so the diagnostics and
plots of either package read it.  One field differs: ``state_key`` holds
the bytes of the chain's ``torch.Generator`` (uint8, with a leading chain
axis for stacked chains), not a JAX key, and a CUDA generator's state
differs from a CPU one's.  The sidecar records the device type, and
:func:`load_chain` refuses a store whose key is not a generator state of
the resuming setup's device type.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import sampler
from .sampler import ChainState, _as_model, stack_states

__all__ = ['save_chain', 'load_chain', 'load_extras', 'append_traces']

_STATE_FIELDS = ('m', 'o', 'loglik', 'prior_m', 'prior_o', 'key', 'count',
                 'mean', 'm2', 'accepts_m', 'accepts_o', 'log_scale')


def _key_bytes(key):
    if isinstance(key, torch.Generator):
        return key.get_state().numpy()
    return np.stack([k.get_state().numpy() for k in key])


def save_chain(path, traces, state: ChainState, meta=None, extra=None):
    """Write traces (n_chains, n_samples, dim) + sampler state.  Projections
    are not stored; they are recomputed on resume (one forward simulation a
    chain).  The state's device type goes into the meta as ``device``.

    ``extra``: optional dict of additional arrays stored alongside (prefixed
    ``x_`` in the npz; read back with ``load_extras``).
    """
    if path.endswith('.npz'):
        path = path[:-4]
    d = os.path.dirname(path)
    if d and not os.path.exists(d):
        os.makedirs(d)
    if torch.is_tensor(traces):
        traces = traces.cpu().numpy()
    payload = {'traces': np.asarray(traces)}
    for f in _STATE_FIELDS:
        v = getattr(state, f)
        payload['state_' + f] = (_key_bytes(v) if f == 'key'
                                 else v.cpu().numpy())
    for k, v in (extra or {}).items():
        payload['x_' + k] = np.asarray(v)
    meta = dict(meta or {})
    meta.setdefault('device', state.m.device.type)
    # write-temp-then-rename: a SIGTERM or timeout landing mid-write must
    # never truncate the store a resume loop depends on (os.replace is
    # atomic on POSIX); same for the meta sidecar
    tmp = path + '.tmp.npz'
    np.savez(tmp, **payload)
    os.replace(tmp, path + '.npz')
    tmp_meta = path + '.meta.json.tmp'
    with open(tmp_meta, 'w') as fh:
        json.dump(meta, fh)
    os.replace(tmp_meta, path + '.meta.json')


def load_extras(path):
    """Read back the ``extra`` arrays stored by ``save_chain``."""
    if not path.endswith('.npz'):
        path = path + '.npz'
    with np.load(path) as npz:
        return {k[2:]: npz[k] for k in npz.files if k.startswith('x_')}


def _generator(key_bytes, device, path):
    """A generator on ``device`` in the stored state, or a ValueError when
    the bytes are not such a generator's state."""
    gen = torch.Generator(device=device)
    if key_bytes.dtype != np.uint8 or \
            key_bytes.shape != tuple(gen.get_state().shape):
        raise ValueError(
            '{}: state_key ({} {}) is not the state of a torch generator on '
            '{!r}; the store was written by the JAX package or on another '
            'device type, and its random stream cannot be continued '
            'here'.format(path, key_bytes.dtype, key_bytes.shape,
                          device.type))
    gen.set_state(torch.from_numpy(key_bytes.copy()))
    return gen


@torch.no_grad()
def load_chain(path, setup):
    """Load traces and rebuild the chain state on the setup's device,
    re-evaluating the cached forward projections at the stored position
    (one forward per chain, in turn).  Returns ``(traces, state, meta)``.
    Raises ValueError for a store written on another device type or whose
    key is not the port's."""
    if not path.endswith('.npz'):
        path = path + '.npz'
    dtype = setup.setup.wind_flat.dtype
    dev = setup.setup.wind_flat.device
    meta_path = path[:-4] + '.meta.json'
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    if meta.get('device', dev.type) != dev.type:
        raise ValueError(
            '{} was written on device type {!r} and cannot be resumed on '
            '{!r}: the two generators\' streams differ'.format(
                path, meta['device'], dev.type))
    with np.load(path) as npz:
        traces = npz['traces']
        fields = {}
        for f in _STATE_FIELDS:
            if 'state_' + f in npz:
                fields[f] = npz['state_' + f]
            elif f == 'log_scale':   # stores written before scale adaptation
                fields[f] = np.zeros(np.asarray(npz['state_count']).shape,
                                     np.float32)
            else:
                raise KeyError('state_' + f)

    def rebuild(chain_fields):
        kw = {f: torch.as_tensor(v, dtype=dtype).to(dev)
              for f, v in chain_fields.items() if f != 'key'}
        key = _generator(chain_fields['key'], dev, path)
        proj = sampler._forward(setup, _as_model(kw['m']))
        return ChainState(proj=proj, key=key, **kw)

    if fields['m'].ndim == 2:     # stacked chains, rebuilt in turn
        state = stack_states([rebuild({f: v[i] for f, v in fields.items()})
                              for i in range(fields['m'].shape[0])])
    else:
        state = rebuild(fields)
    return traces, state, meta


def append_traces(old, new):
    return np.concatenate([np.asarray(old), np.asarray(new)], axis=-2)

"""Legacy PyMC-2 HDF5 trace migration.

The reference persists MCMC to a PyMC 2.x HDF5 database
(``pm.MCMC(..., db='hdf5', dbname=fname)``, Bayes_Run.py:484-487; loaded
back with ``pm.database.hdf5.load``, :513).  This build's store is npz
with exact resume (bayes/store.py) — better, but a user coming from the
reference may hold years of legacy chains.  This module reads those
databases WITHOUT PyMC (plain h5py: the backend's layout is one group per
chain, each holding a ``PyMCsamples`` compound-dtype table, one field per
tallied variable) and rewrites them as a trace npz every analysis CLI
accepts (``--analyze``, bayes.summary, bayes.predictive, viz tools).

Column mapping: the reference tallies the DETERMINISTIC
reparameterizations (``f_b1 = fb1_p + 1``, ``corr = 2*corr_p - 1``;
the underlying stochastics are ``trace=False``, Bayes_Run.py:105-128)
while this build's traces store the underlying block — the migration
inverts the reparameterizations.  The trailing column of a native trace
is the log posterior; legacy databases tally only the deviance
(-2 loglik), so the migrated trailing column is ``-deviance/2`` (the log
likelihood), flagged in the meta sidecar.

The port's copy of ``parasitoids_tpu/io/legacy_hdf5.py``, with the
port's parameter names (``bayes/priors.py``); ``h5py`` is imported only
when a database is read.  Host work only: the npz it writes is read by
the port's analysis command lines on any device.

CLI::

    python -m parasitoids_tpu_torch.io.legacy_hdf5 old_run.hdf5 runs/migrated
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ['read_pymc_hdf5', 'migrate_hdf5_trace', 'main']

# legacy tallied name -> (our name, inverse transform)
_DETERMINISTIC_MAP = {
    'f_b1': ('f_b1_p', lambda v: v - 1.0),     # Bayes_Run.py:105-107
    'f_b2': ('f_b2_p', lambda v: v - 1.0),     # :109-111
    'corr': ('corr_p', lambda v: (v + 1.0) / 2.0),       # :118-121
    'corr_l': ('corr_l_p', lambda v: (v + 1.0) / 2.0),   # :125-128
}
# underlying stochastics, in case a db was written with trace=True on them
_UNDERLYING_ALIASES = {
    'fb1_p': 'f_b1_p', 'fb2_p': 'f_b2_p',
    'corr_p': 'corr_p', 'corr_l_p': 'corr_l_p',
    'sig_x_l': 'sig_xl', 'sig_y_l': 'sig_yl',
}


def read_pymc_hdf5(path):
    """Read a PyMC-2 HDF5 database into plain arrays.

    Returns ``(chains, names)``: ``chains`` is a list (one per ``chainN``
    group, in index order) of dicts mapping tallied variable name ->
    (n_samples,) float array; ``names`` is the union of tallied names.
    Works on the pytables layout through h5py — no PyMC/pytables needed.
    """
    import h5py

    chains = []
    names = []
    with h5py.File(path, 'r') as f:
        groups = sorted((k for k in f.keys() if k.startswith('chain')),
                        key=lambda k: int(k[5:] or 0))
        if not groups:
            raise ValueError('{}: no chainN groups — not a PyMC-2 HDF5 '
                             'database'.format(path))
        for g in groups:
            if 'PyMCsamples' not in f[g]:
                raise ValueError('{}: group {} has no PyMCsamples '
                                 'table'.format(path, g))
            tab = f[g]['PyMCsamples'][...]      # structured array
            cols = {}
            for name in tab.dtype.names:
                v = np.asarray(tab[name])
                if v.ndim > 1:                  # array-valued tallies
                    for j in range(v.shape[1]):
                        cols['{}_{}'.format(name, j)] = v[:, j].astype(
                            np.float64)
                else:
                    cols[name] = v.astype(np.float64)
            chains.append(cols)
            for n in cols:
                if n not in names:
                    names.append(n)
    return chains, names


def migrate_hdf5_trace(path, out, sent_ids=None):
    """Convert a legacy database into this build's trace npz + meta.

    ``sent_ids``: sentinel field ids for the trailing observation block
    (default: the Kalbar fields B..G, Bayes_Run.py:155-166).  Missing
    columns are filled with NaN (and reported) rather than failing, so a
    partial legacy tally still migrates.  Returns the written npz path.
    """
    from ..bayes.priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES

    if sent_ids is None:
        sent_ids = ['B', 'C', 'D', 'E', 'F', 'G']
    chains, _ = read_pymc_hdf5(path)
    target = (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
              + ['sent_obs_probs_{}'.format(k) for k in sent_ids])

    def extract(cols, want):
        if want.startswith('sent_obs_probs_'):
            return cols.get(want)
        for legacy, (ours, inv) in _DETERMINISTIC_MAP.items():
            if ours == want and legacy in cols:
                return inv(cols[legacy])
        for legacy, ours in _UNDERLYING_ALIASES.items():
            if ours == want and legacy in cols:
                return cols[legacy]
        return cols.get(want)

    n = min(len(next(iter(c.values()))) for c in chains)
    traces = np.full((len(chains), n, len(target) + 1), np.nan)
    missing = set()
    for ci, cols in enumerate(chains):
        for j, want in enumerate(target):
            v = extract(cols, want)
            if v is None:
                missing.add(want)
            else:
                traces[ci, :, j] = v[:n]
        if 'deviance' in cols:
            traces[ci, :, -1] = -0.5 * cols['deviance'][:n]

    out = out.removesuffix('.npz')
    d = os.path.dirname(out)
    if d and not os.path.exists(d):
        os.makedirs(d)
    np.savez(out, traces=traces)
    with open(out + '.meta.json', 'w') as fh:
        json.dump({'sampler': 'legacy-pymc2-hdf5', 'source': path,
                   'resumable': False,
                   'final_column': 'loglik (-deviance/2), NOT logpost',
                   'missing_columns': sorted(missing),
                   'n_samples': int(n)}, fh)
    if missing:
        import warnings
        warnings.warn('legacy database lacks tallies for: {} (filled with '
                      'NaN)'.format(', '.join(sorted(missing))),
                      RuntimeWarning, stacklevel=2)
    return out + '.npz'


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog='parasitoids_tpu_torch.io.legacy_hdf5',
        description='migrate a reference (PyMC-2) HDF5 MCMC database to '
                    'this build\'s trace npz')
    ap.add_argument('hdf5', help='legacy database path')
    ap.add_argument('out', help='output npz path (without suffix is fine)')
    ap.add_argument('--sent-ids', default='B,C,D,E,F,G',
                    help='comma-separated sentinel field ids '
                         '(default: the Kalbar fields)')
    args = ap.parse_args(argv)
    out = migrate_hdf5_trace(args.hdf5, args.out,
                             args.sent_ids.split(','))
    with np.load(out) as npz:
        tr = npz['traces']
    print('wrote {}: {} chain(s) x {} samples x {} columns'.format(
        out, *tr.shape))
    print('analyze with: python -m parasitoids_tpu_torch.bayes.run '
          '--analyze {}'.format(out.removesuffix('.npz')))


if __name__ == '__main__':
    main()

"""Simulation persistence (L5 support) — reference-compatible npz + json.

Writes/reads the exact on-disk format of the reference driver
(Run.py:490-516): an ``.npz`` holding each day's field as CSR triplets
(``<day>_data``, ``<day>_ind``, ``<day>_indptr``) plus a ``days`` vector, and
a ``.json`` parameter sidecar with the maps key stripped.  Saved runs are
interchangeable with the reference's plotting/analysis tooling, and the
loader also accepts the reference's older COO variant
(CompareToData.py:798-818).
"""

from __future__ import annotations

import os

import numpy as np
from scipy import sparse

__all__ = ['save_run', 'load_run']


def save_run(outfile, fields, days, params=None):
    """Save per-day fields (ndays, D, D) as reference-format npz (+ json).

    Args:
        outfile: path without extension.
        fields: (ndays, D, D) array (dense device or host array).
        days: day labels (ints), one per field.
        params: optional Params for the json sidecar.
    """
    fields = np.asarray(fields)
    d = os.path.dirname(outfile)
    if d and not os.path.exists(d):
        os.makedirs(d)
    payload = {}
    for day, field in zip(days, fields):
        csr = sparse.csr_matrix(field)
        payload[str(day) + '_data'] = csr.data
        payload[str(day) + '_ind'] = csr.indices
        payload[str(day) + '_indptr'] = csr.indptr
    payload['days'] = np.asarray(list(days))
    np.savez(outfile, **payload)
    if params is not None:
        params.save_json(outfile + '.json')


def load_run(filename, dom_len):
    """Load a saved run (ours or the reference's) back into dense fields.

    Returns (fields (ndays, D, D), days).  Handles both CSR triplets and the
    older COO row/col format.
    """
    if filename.endswith('.npz'):
        filename = filename[:-4]
    fields = []
    with np.load(filename + '.npz') as npz:
        days = npz['days'].tolist()
        for day in days:
            V = npz[str(day) + '_data']
            if str(day) + '_indptr' in npz:
                mat = sparse.csr_matrix(
                    (V, npz[str(day) + '_ind'], npz[str(day) + '_indptr']),
                    shape=(dom_len, dom_len))
            else:  # COO variant (row/col)
                mat = sparse.coo_matrix(
                    (V, (npz[str(day) + '_row'], npz[str(day) + '_col'])),
                    shape=(dom_len, dom_len))
            fields.append(mat.toarray())
    return np.stack(fields), days

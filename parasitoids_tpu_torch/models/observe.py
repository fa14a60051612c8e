"""Observation model: population fields → expected counts, PyTorch port of
``parasitoids_tpu/models/observe.py`` (reference Bayes_funcs.py:20-221).

Every projection is factored into static gather indices and weight
matrices, precomputed once on the host from a ``LocInfo``, so inside the
likelihood each projection is a gather plus a small matmul:

    emergence[n, obs_col] = sum_day pop[day, point_n] * W[day, obs_col]

where ``W = M @ B`` combines the incubation-time distribution M
(oviposition day → emergence day, 19-25 days at weights
.05/.1/.2/.3/.2/.1/.05, Bayes_funcs.py:17-18) and the binning matrix B
(emergence day → observation date, Bayes_funcs.py:76-89).  The host
precompute below is copied from the JAX module, which loads JAX and so
cannot be imported here; the projections are torch, with products in full
f32 (the JAX module pins ``Precision.HIGHEST``), and take a leading
particle axis on the fields, ``(N, ndays, D, D)``, as they come from a
batched forward.  The ``*_np`` methods are the JAX module's host numpy
variants, for the figures.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..device import pin_full_f32

__all__ = ['ObservationOps', 'INCUBATION_TIME', 'MAX_INCUBATION']

# oviposition-to-emergence time distribution (19..25 days inclusive),
# ref Bayes_funcs.py:17-18
INCUBATION_TIME = np.array([0.05, 0.1, 0.2, 0.3, 0.2, 0.1, 0.05])
MAX_INCUBATION = 25


def _emergence_weights(collection_day, obs_cols, ndays):
    """W[day, obs_col]: contribution of day-``day`` population (per wasp) to
    expected emergence counted on observation column ``obs_col``
    (copied from ``parasitoids_tpu/models/observe.py:37-54``)."""
    M = np.zeros((ndays, MAX_INCUBATION))
    start_day = max(collection_day - MAX_INCUBATION, 0)
    for day in range(start_day, min(collection_day, ndays)):
        max_post = day + MAX_INCUBATION - collection_day
        if max_post < 0:
            continue
        min_post = max(0, max_post + 1 - INCUBATION_TIME.size)
        span = max_post - min_post + 1
        M[day, min_post:max_post + 1] = INCUBATION_TIME[-span:]
    B = np.zeros((MAX_INCUBATION, len(obs_cols)))
    col_indices = [int(c) - collection_day for c in obs_cols]
    B[0:col_indices[0] + 1, 0] = 1.0
    for n, col in enumerate(col_indices[1:]):
        B[col_indices[n] + 1:col + 1, n + 1] = 1.0
    return M @ B


def _exposure_weights(obs_days, ndays):
    """W[day, obs_col] for the rotating-sentinel ('exposure') protocol:
    column ``col`` counts the emergence from plants exposed during
    ``(obs_days[col-1], obs_days[col]]``, each window day with weight 1
    (copied from ``parasitoids_tpu/models/observe.py:57-74``)."""
    W = np.zeros((ndays, len(obs_days)))
    prev = 0
    for col, d in enumerate(obs_days):
        if d <= prev:
            raise ValueError('exposure-protocol observation dates must be '
                             'strictly increasing and after the release '
                             '(got day {} after day {})'.format(d, prev))
        W[prev:min(d, ndays), col] = 1.0
        prev = d
    return W


class _Projection(NamedTuple):
    point_rows: torch.Tensor   # flattened gather index (row*D + col)
    weights: torch.Tensor      # (ndays, n_obs_cols)


class _Gather(NamedTuple):
    """A gather whose gradient is the same bits on every run.
    ``index_select``'s backward adds into its source with ``index_add_``,
    atomic on the card, so where an index repeats the repeated cotangents
    add in a changing order.  Here the source is read once at each distinct
    index and the repeats are copied by a product with a one-hot matrix,
    whose transpose sums them in a fixed order; the forward's values are
    the same bits as ``index_select``'s."""
    index: torch.Tensor             # the distinct indices, sorted
    expand: torch.Tensor | None     # (n_distinct, n) one-hot, or None


def _dedup_gather(index, dtype):
    idx = index.cpu().numpy()
    uniq, inv = np.unique(idx, return_inverse=True)
    if len(uniq) == len(idx):
        return _Gather(index, None)
    onehot = np.zeros((len(uniq), len(idx)), np.float32)
    onehot[inv, np.arange(len(idx))] = 1.0
    return _Gather(torch.as_tensor(uniq, device=index.device),
                   torch.as_tensor(onehot, device=index.device).to(dtype))


def _gather(x, dim, g: _Gather):
    """``x.index_select(dim, idx)`` (dim -1 or -2 of ``x``, which may lead
    with a particle axis) for the :class:`_Gather` of ``idx``."""
    y = x.index_select(dim, g.index)
    if g.expand is None:
        return y
    return y @ g.expand if dim == -1 else g.expand.T @ y


class ObservationOps:
    """Precomputed observation projections for one LocInfo + domain, with
    the index and weight tensors on ``device`` (weights in ``dtype``)."""

    def __init__(self, locinfo, domain_info, ndays, device='cpu',
                 dtype=torch.float32):
        # host precompute: parasitoids_tpu/models/observe.py:88-206
        D = int(domain_info[1]) * 2 + 1
        res = domain_info[0] / domain_info[1]
        self.dom_len = D
        self.ndays = ndays
        device = torch.device(device)
        pin_full_f32()

        def index(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def weights(a):
            # rounded through f32 like the JAX module's weight matrices
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=device).to(dtype)

        # a simulation shorter than the observation timeline truncates
        # oviposition windows and clamps day gathers: warn with the horizon
        need = [d.days for d in locinfo.collection_datesPR]
        need += [d.days for d in locinfo.grid_obs_datesPR]
        need += [d.days for d in locinfo.card_obs_datesPR]
        if need and max(need) > ndays:
            warnings.warn(
                'simulation covers {} day(s) but observations run to day '
                '{} post-release; late oviposition/observation days are '
                'truncated to the simulated horizon'.format(
                    ndays, max(need)), RuntimeWarning, stacklevel=2)

        ### release-field grid emergence (per collection)
        rel_idx = getattr(locinfo, 'release_coll_idx', None)
        if rel_idx is None:
            rel_idx = list(range(len(locinfo.release_DataFrames)))
        protocols = getattr(locinfo, 'sent_protocols', None)
        if protocols is None:
            protocols = ['lab'] * len(locinfo.sent_DataFrames)
        self.release_proj = []
        for nframe, dframe in enumerate(locinfo.release_DataFrames):
            ncoll = rel_idx[nframe]
            cd = locinfo.collection_datesPR[ncoll].days
            obs = [int(d / np.timedelta64(1, 'D'))
                   for d in dframe['datePR'].unique()]
            idx = [r * D + c for r, c in locinfo.emerg_grids[nframe]]
            if protocols[ncoll] == 'exposure':
                W = _exposure_weights(obs, ndays)
            else:
                W = _emergence_weights(cd, obs, ndays)
            self.release_proj.append(_Projection(index(idx), weights(W)))

        ### sentinel-field emergence (per collection): field sums via a
        ### concatenated cell gather, one contiguous segment per field
        cells = []
        for fid in locinfo.sent_ids:
            fc = locinfo.field_cells[fid]
            cells.append(fc[:, 0] * D + fc[:, 1])
        self.sent_cells = index(np.concatenate(cells))
        self.sent_bounds = [0] + [int(b) for b in np.cumsum(
            [len(c) for c in cells])]
        self.n_sent = len(locinfo.sent_ids)
        self.sentinel_W = []
        for nframe, dframe in enumerate(locinfo.sent_DataFrames):
            cd = locinfo.collection_datesPR[nframe].days
            obs = [int(d / np.timedelta64(1, 'D'))
                   for d in dframe['datePR'].unique()]
            if protocols[nframe] == 'exposure':
                W = _exposure_weights(obs, ndays)
            else:
                W = _emergence_weights(cd, obs, ndays)
            self.sentinel_W.append(weights(W))

        ### grid adult counts: end-of-day density at sampled cells
        # (ref Bayes_funcs.py:167-173: modelsol[date.days-1])
        grid_days = np.array([d.days - 1 for d in locinfo.grid_obs_datesPR],
                             np.int64)
        if (grid_days < 0).any():
            raise ValueError('grid observation dated on/before the '
                             'release day (day {})'.format(
                                 int(grid_days.min()) + 1))
        # runs shorter than the observation schedule clamp to the last
        # simulated day (see the horizon warning above)
        self.grid_idx = index([r * D + c for r, c in locinfo.grid_cells])
        self.grid_days = index(np.minimum(grid_days, ndays - 1))

        ### cardinal-direction transects (a static gather per day)
        self.card_gathers = []
        center = int(domain_info[1])
        card_dists = getattr(locinfo, 'card_dists', None)
        for nday, date in enumerate(locinfo.card_obs_datesPR):
            obslen = locinfo.card_obs[nday].shape[1]
            if card_dists is not None:
                dist = np.asarray(card_dists[nday], float)   # (4, obslen)
            else:
                dist = np.broadcast_to(
                    5 + locinfo.step_size[nday] * (1 + np.arange(obslen)),
                    (4, obslen))
            delta = (dist // res).astype(np.int64)
            rows = np.stack([center - delta[0], center + delta[1],
                             np.full(obslen, center),
                             np.full(obslen, center)])
            cols = np.stack([np.full(obslen, center),
                             np.full(obslen, center),
                             center + delta[2], center - delta[3]])
            day = int(date.days) - 1
            if day < 0:
                raise ValueError('cardinal observation dated on/before '
                                 'the release day')
            self.card_gathers.append((min(day, ndays - 1),
                                      index(rows * D + cols)))

        # the likelihood's gathers, with gradients reproducible on the card
        self._rel_gathers = [_dedup_gather(p.point_rows, dtype)
                             for p in self.release_proj]
        self._sent_gather = _dedup_gather(self.sent_cells, dtype)
        self._grid_gather = _dedup_gather(self.grid_idx, dtype)
        self._day_gather = _dedup_gather(self.grid_days, dtype)

    # ------------------------------------------------------------------
    def project_emergence(self, fields):
        """fields (ndays, D, D) → (release_emerg list, sentinel_emerg list):
        rows = grid points / fields, cols = observation dates
        (Bayes_funcs.py:145-152).  Fields (N, ndays, D, D) give each
        array a leading particle axis."""
        flat = fields.reshape(*fields.shape[:-2], -1)    # (ndays, D*D)
        release = [torch.matmul(_gather(flat, -1, g).transpose(-1, -2),
                                p.weights)
                   for p, g in zip(self.release_proj, self._rel_gathers)]
        cell_vals = _gather(flat, -1, self._sent_gather)  # (ndays, cells)
        # one reduction per field, not an index_add: on the card that adds
        # atomically, in an order that changes from run to run, and the
        # sampler's exact resume needs the same bits from the same state
        field_tot = torch.stack([cell_vals[..., a:b].sum(dim=-1) for a, b in
                                 zip(self.sent_bounds, self.sent_bounds[1:])],
                                dim=-2)
        sentinel = [torch.matmul(field_tot, W) for W in self.sentinel_W]
        return release, sentinel

    def project_grid(self, fields):
        """fields → (n_grid_points, n_obs_dates) expected counts
        (ref Bayes_funcs.py:156-179); a leading particle axis is kept."""
        flat = fields.reshape(*fields.shape[:-2], -1)
        pts = _gather(flat, -1, self._grid_gather)       # (ndays, n_grid)
        return _gather(pts, -2, self._day_gather).transpose(-1, -2)

    def project_card(self, fields):
        """fields → list of (4, obslen) cardinal transect densities
        (ref Bayes_funcs.py:183-221); a leading particle axis is kept."""
        flat = fields.reshape(*fields.shape[:-2], -1)
        return [flat[..., day, :][..., idx] for day, idx in self.card_gathers]

    # --- host (numpy) variants for the figures: the JAX module's, the
    # same arithmetic on numpy arrays, nothing on the device

    def _np(self, t):
        return t.cpu().numpy()

    def project_emergence_np(self, fields):
        flat = np.asarray(fields).reshape(len(fields), -1)
        release = [flat[:, self._np(p.point_rows)].T @ self._np(p.weights)
                   for p in self.release_proj]
        cell_vals = flat[:, self._np(self.sent_cells)]   # (ndays, n_cells)
        field_tot = np.zeros((self.n_sent, flat.shape[0]), cell_vals.dtype)
        seg = np.repeat(np.arange(self.n_sent), np.diff(self.sent_bounds))
        np.add.at(field_tot, seg, cell_vals.T)
        sentinel = [field_tot @ self._np(W) for W in self.sentinel_W]
        return release, sentinel

    def project_grid_np(self, fields):
        flat = np.asarray(fields).reshape(len(fields), -1)
        days = np.clip(self._np(self.grid_days), 0, flat.shape[0] - 1)
        return flat[:, self._np(self.grid_idx)][days].T

    def project_card_np(self, fields):
        flat = np.asarray(fields).reshape(len(fields), -1)
        return [flat[min(day, flat.shape[0] - 1)][self._np(idx)]
                for day, idx in self.card_gathers]

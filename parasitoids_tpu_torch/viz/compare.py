"""Model-vs-data comparison figures (L5).

Rebuilds ``CompareToData.py``: spread maps side by side with emergence-data
histograms (ref main :50-340), model-vs-observed grid-count assessment
(``assess_fit`` :344-528), and a multi-day banner figure (:532-778).
Normalization conventions follow the reference: observed emergence divided
by sampled area (:100-105), model densities projected through the
incubation distribution before comparison (:124-132).

The port's copy of ``parasitoids_tpu/viz/compare.py``: every figure takes
the fields as numpy or as torch tensors (on the card too; they are
brought to the host once), and projects them with the port's host numpy
``ObservationOps.project_*_np``.  ``python -m
parasitoids_tpu_torch.viz.compare <saved_run> [--device cpu|cuda]``.
"""

from __future__ import annotations


import numpy as np
import torch

from ..models.observe import ObservationOps
from .plot_result import alpha_viridis, crop_to_support, _extent_meters

__all__ = ['compare_emergence', 'compare_emergence_3d', 'assess_fit',
           'grid_r_squared',
           'assess_fit_3d', 'banner', 'main']


from . import _mpl   # shared headless-backend helper


def _host(fields):
    """The fields as a host numpy array (a tensor is copied off its
    device once)."""
    if torch.is_tensor(fields):
        return fields.detach().cpu().numpy()
    return np.asarray(fields)


def compare_emergence(fields, days, params, locinfo, outfile=None,
                      bw=False):
    """Side-by-side observed vs model-projected emergence per collection
    (ref CompareToData.main; ``bw`` gives the print-friendly grayscale
    styling of the reference's ``--bw`` flag, CompareToData.py:782-834).
    """
    fields = _host(fields)
    plt = _mpl()
    obs_ops = ObservationOps(locinfo, params.domain_info, len(days))
    rel_model, sent_model = obs_ops.project_emergence_np(fields)
    ncoll = len(locinfo.release_emerg)
    fig, axes = plt.subplots(2, ncoll + 1, figsize=(6 * (ncoll + 1), 8),
                             squeeze=False)

    # spread map of the final day
    rad_res = int(params.domain_info[1])
    cell = params.domain_info[0] / params.domain_info[1]
    cropped, window = crop_to_support(np.asarray(fields[-1]))
    axes[0][0].imshow(np.ma.masked_less_equal(cropped,
                                              cropped.max() * 1e-3),
                      cmap=('Greys' if bw else alpha_viridis()),
                      extent=_extent_meters(window, rad_res, cell))
    axes[0][0].set_title('model spread, day {} PR'.format(days[-1]))
    axes[1][0].axis('off')

    cell_area = cell ** 2
    for k in range(ncoll):
        # observed emergence normalized by sampled area: the release-field
        # total is scaled by the single scalar 100/area.sum() — grid
        # collection sampled that combined area — NOT per-grid-point rows
        # (which are in (datePR,row,col) order, unrelated to the area
        # column's file order).  Ref CompareToData.py:100-105.
        area_total = float(locinfo.grid_data['area'].to_numpy(float).sum())
        obs = (locinfo.release_emerg[k].sum(axis=0) *
               100.0 / max(area_total, 1e-9))
        model = np.asarray(rel_model[k])
        x = np.arange(obs.shape[0])
        sty_o = dict(color='0.2') if bw else {}
        sty_m = (dict(color='white', edgecolor='black', hatch='//')
                 if bw else {})
        axes[0][k + 1].bar(x - 0.2, obs, width=0.4,
                           label='observed/area', **sty_o)
        axes[0][k + 1].bar(x + 0.2, model.sum(axis=0) /
                           max(model.sum(), 1e-9) * obs.sum(), width=0.4,
                           label='model (scaled)', **sty_m)
        axes[0][k + 1].set_title('release-field emergence, collection '
                                 '{}'.format(k))
        axes[0][k + 1].legend()

        # sentinel rows are per-field (sent_ids order): normalize each by
        # its field area, 10000/(cells * m^2/cell), before summing
        # (ref CompareToData.py:105)
        sent_scale = np.array([10000.0 /
                               (locinfo.field_sizes[sid] * cell_area)
                               for sid in locinfo.sent_ids])
        obs_s = locinfo.sentinel_emerg[k] * sent_scale[:, None]
        model_s = np.asarray(sent_model[k])
        xs = np.arange(obs_s.shape[1])
        axes[1][k + 1].bar(xs - 0.2, obs_s.sum(axis=0), width=0.4,
                           label='observed', **sty_o)
        axes[1][k + 1].bar(xs + 0.2, model_s.sum(axis=0) /
                           max(model_s.sum(), 1e-9) * obs_s.sum(),
                           width=0.4, label='model (scaled)', **sty_m)
        axes[1][k + 1].set_title('sentinel emergence, collection '
                                 '{}'.format(k))
        axes[1][k + 1].legend()

    fig.tight_layout()
    outfile = outfile or 'compare_emergence.png'
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def grid_r_squared(fields, days, params, locinfo):
    """R² of scaled model grid densities against the observed adult
    counts, per observation day and pooled — the statistic the
    reference's docstring promises but never implements
    (CompareToData.py:52-54 'TODO: ... R**2 values for the model
    densities at grid points compared to observed adult counts').

    The model column is the effort-weighted expected count rescaled to
    the day's observed total (as in :func:`assess_fit`'s overlay), so R²
    measures *spatial pattern* agreement: 1 - SS_res/SS_tot against the
    day's mean count.  Returns ``{'per_day': {dayPR: r2}, 'pooled': r2}``
    (a day with zero count variance reports nan)."""
    fields = _host(fields)
    obs_ops = ObservationOps(locinfo, params.domain_info, len(days))
    grid_model = np.asarray(obs_ops.project_grid_np(fields))
    out, all_obs, all_exp = {}, [], []
    for d in range(grid_model.shape[1]):
        effort = np.asarray(locinfo.grid_samples[:, d], np.float64)
        obs = np.asarray(locinfo.grid_obs[:, d], np.float64)
        expected = grid_model[:, d] * effort
        scale = obs.sum() / max(expected.sum(), 1e-9)
        exp_s = expected * scale
        ss_tot = float(((obs - obs.mean()) ** 2).sum())
        ss_res = float(((obs - exp_s) ** 2).sum())
        r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else float('nan')
        out[int(locinfo.grid_obs_datesPR[d].days)] = r2
        all_obs.append(obs)
        all_exp.append(exp_s)
    obs = np.concatenate(all_obs)
    exp_s = np.concatenate(all_exp)
    ss_tot = float(((obs - obs.mean()) ** 2).sum())
    pooled = (1.0 - float(((obs - exp_s) ** 2).sum()) / ss_tot
              if ss_tot > 0 else float('nan'))
    return {'per_day': out, 'pooled': pooled}


def assess_fit(fields, days, params, locinfo, outfile=None, bw=False):
    """Model grid densities vs observed grid counts per observation day
    (ref CompareToData.assess_fit, :344-528): per-point separation with
    sampling-effort annotation and the per-day R² in the panel title
    (closing the reference's CompareToData.py:52-54 TODO)."""
    fields = _host(fields)
    plt = _mpl()
    obs_ops = ObservationOps(locinfo, params.domain_info, len(days))
    grid_model = np.asarray(obs_ops.project_grid_np(fields))
    r2 = grid_r_squared(fields, days, params, locinfo)
    n_days = grid_model.shape[1]
    fig, axes = plt.subplots(1, n_days, figsize=(5 * n_days, 4),
                             squeeze=False)
    for d in range(n_days):
        ax = axes[0][d]
        # apply the per-point sampling effort exactly as the likelihood
        # does (model.py: grid_obs_prob * grid_samples * density) —
        # without it, a half-effort point reads as model over-prediction
        effort = np.asarray(locinfo.grid_samples[:, d])
        expected = grid_model[:, d] * effort
        order = np.argsort(expected)
        scale = (locinfo.grid_obs[:, d].sum() /
                 max(expected.sum(), 1e-9))
        mline = dict(color='0.1') if bw else {}
        mdots = dict(color='0.5') if bw else {}
        ax.plot(expected[order] * scale, label='model (effort-scaled)',
                **mline)
        ax.plot(locinfo.grid_obs[order, d], '.', label='observed',
                **mdots)
        day_pr = int(locinfo.grid_obs_datesPR[d].days)
        ax.set_title('grid counts, obs day {} (R² = {:.3f})'.format(
            day_pr, r2['per_day'][day_pr]))
        ax.set_xlabel('grid point (sorted by model)')
        ax.legend()
    fig.tight_layout()
    outfile = outfile or 'assess_fit.png'
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    print('grid R²: pooled {:.3f}; per day {}'.format(
        r2['pooled'], {k: round(v, 3) for k, v in r2['per_day'].items()}))
    return outfile


def compare_emergence_3d(fields, days, params, locinfo, outfile=None,
                         bw=False, coll=0):
    """Paired 3-D emergence histograms, observed vs model-projected
    (ref CompareToData.py:124-132 data prep, :285-335 plot): per-field bar
    rows laid out along a distance-from-release axis, observation days on
    the depth axis — the reference's publication figure class.

    Top panel: observed emergence per field, normalized by sampled area
    (release field by the grid's total sampled area, sentinel fields by
    field area, ref :100-105).  Bottom panel: model per-field densities
    projected through the incubation-time distribution (ref :124-132),
    as emergences/100 m².  Field rows sit at their true centroid distance
    from the release point (the reference hard-codes Kalbar's distances,
    :285; computing them keeps the figure correct for generic sites).
    """
    fields = _host(fields)
    plt = _mpl()
    from ..models.observe import INCUBATION_TIME, MAX_INCUBATION

    res = params.domain_info[0] / params.domain_info[1]
    cell_area = res * res
    fields_np = np.asarray(fields)

    allfield_ids = [locinfo.releasefield_id] + [
        fid for fid in locinfo.sent_ids if fid != locinfo.releasefield_id]
    collection_date = locinfo.collection_datesPR[coll].days

    # ---- observed emergence array (field x dayPR), ref :76-105 ----------
    dframe_rel = locinfo.release_DataFrames[coll]
    dframe = locinfo.sent_DataFrames[coll]
    last_obs = max(int(dframe['datePR'].max().days),
                   int(dframe_rel['datePR'].max().days))
    n_cols = last_obs - collection_date + 1
    obs = np.zeros((len(allfield_ids), n_cols))
    for dPR, grp in dframe_rel.groupby(dframe_rel['datePR'].dt.days):
        obs[0, dPR - collection_date] = grp['E_total'].sum()
    for (dPR, fid), grp in dframe.groupby(
            [dframe['datePR'].dt.days, 'id']):
        if fid in allfield_ids:
            obs[allfield_ids.index(fid), dPR - collection_date] = \
                grp['E_total'].sum()
    area_total = float(locinfo.grid_data['area'].to_numpy(float).sum())
    obs[0] *= 100.0 / max(area_total, 1e-9)
    for n, fid in enumerate(allfield_ids[1:], start=1):
        obs[n] *= 10000.0 / (locinfo.field_sizes[fid] * cell_area)

    # ---- model per-field densities -> projected emergence (ref :110-132)
    n_model_days = min(collection_date, fields_np.shape[0])
    dens = np.zeros((len(allfield_ids), collection_date))
    for day in range(n_model_days):
        for n, fid in enumerate(allfield_ids):
            cells = locinfo.field_cells[fid]
            total = fields_np[day][cells[:, 0], cells[:, 1]].sum()
            dens[n, day] = total / (locinfo.field_sizes[fid] * cell_area)
    proj = np.zeros((len(allfield_ids),
                     collection_date + MAX_INCUBATION))
    min_inc = MAX_INCUBATION - INCUBATION_TIME.size + 1
    for day in range(collection_date):
        proj[:, day + min_inc:day + MAX_INCUBATION + 1] += np.outer(
            dens[:, day], INCUBATION_TIME)
    proj = proj[:, collection_date:]
    width = max(proj.shape[1], n_cols)
    obs = np.pad(obs, ((0, 0), (0, width - n_cols)))
    proj = np.pad(proj, ((0, 0), (0, width - proj.shape[1])))
    emerg_dates = np.arange(collection_date, collection_date + width)

    # field rows at their centroid distance from the release point
    zcoord = []
    for fid in allfield_ids:
        poly = locinfo.field_polys[fid]
        zcoord.append(float(np.hypot(*np.asarray(poly).mean(axis=0))))
    order = np.argsort(zcoord)

    cmap = plt.get_cmap('Greys' if bw else 'viridis')
    color_list = np.linspace(0.95, 0.05, len(zcoord))
    fig = plt.figure(figsize=(9, 10))
    panels = [(obs, '\nEmergence observations\n normalized by area'),
              (proj * 100.0, '\nProjected total\nemergences/100 m$^2$')]
    for ii, (arr, zlabel) in enumerate(panels):
        ax = fig.add_subplot(2, 1, ii + 1, projection='3d')
        for rank, n in enumerate(order):
            ax.bar(emerg_dates, arr[n], zs=zcoord[n], zdir='x',
                   color=cmap(color_list[rank]), alpha=0.7,
                   edgecolor='black')
        ax.set_zlabel(zlabel, fontsize=12)
        ax.set_ylim(emerg_dates[0], emerg_dates[-1])
        ax.set_xlabel('Fields', fontsize=12)
        ax.set_ylabel('Days PR', fontsize=12)
        ax.set_xticks([zcoord[n] for n in order])
        ax.set_xticklabels([allfield_ids[n] for n in order], fontsize=10)
    fig.tight_layout(pad=0.5)
    outfile = outfile or 'compare_emergence_3d.png'
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def assess_fit_3d(fields, days, params, locinfo, outfile=None, bw=False,
                  clipval=50.0):
    """3-D model-density surfaces vs observed grid-count bars per
    observation day (ref CompareToData.assess_fit, :363-443): observed
    counts as bars at their grid coordinates colored by sampling effort,
    the model surface clipped at ``clipval`` wasps/cell and rescaled to
    wasps/10 m², facet colors separating observed cells (white/black by
    effort), grid-boundary cells, and the default surface.

    One deliberate fix vs the reference: the surface here is the model
    field ON the observation day (``fields[obs_day]``); the reference
    indexes ``modelsol[day]`` with the enumeration index 0,1,2
    (CompareToData.py:417), i.e. days 1-3 PR regardless of when the
    observations were taken."""
    fields = _host(fields)
    plt = _mpl()
    res = params.domain_info[0] / params.domain_info[1]
    center = int(params.domain_info[1])
    fields_np = np.asarray(fields)

    gx = locinfo.grid_data['xcoord'].to_numpy(float)
    gy = locinfo.grid_data['ycoord'].to_numpy(float)
    samples = locinfo.grid_data['samples'].to_numpy(float)
    max_eff = samples.max()
    xmax, ymax = np.abs(gx).max() * 1.2, np.abs(gy).max() * 1.2
    xmesh = np.arange(0, xmax + res, res)
    xmesh = np.concatenate((-xmesh[:0:-1], xmesh))
    ymesh = np.arange(0, ymax + res, res)
    ymesh = np.concatenate((-ymesh[:0:-1], ymesh))[::-1]
    xg, yg = np.meshgrid(xmesh, ymesh)

    bndry = np.zeros_like(xg)
    if getattr(locinfo, 'grid_boundary', None) is not None:
        for x, y in locinfo.grid_boundary.T:
            bndry[np.argmin(np.abs(ymesh - y)),
                  np.argmin(np.abs(xmesh - x))] += 1

    base_cmap = plt.get_cmap('gray' if bw else 'viridis')
    surf_cmap = plt.get_cmap('Greys' if bw else 'Oranges')
    default_clr = (*surf_cmap(0.45)[:-1], 0.21)
    bndry_clr = (0.3, 0.3, 0.3, 0.3) if bw else (1, 0, 1, 0.3)

    obs_dates = locinfo.grid_obs_datesPR
    fig = plt.figure(figsize=(5.5 * len(obs_dates), 6))
    scale_10m2 = (10.0 / res) ** 2
    # exact field indices for each mesh coordinate (row decreases with +y),
    # clipped to the domain
    rr = np.clip(center - np.round(ymesh / res).astype(int), 0, 2 * center)
    cc = np.clip(center + np.round(xmesh / res).astype(int), 0, 2 * center)
    for d, date in enumerate(obs_dates):
        ax = fig.add_subplot(1, len(obs_dates), d + 1, projection='3d')
        obs_day = min(date.days - 1, fields_np.shape[0] - 1)
        model_grid = np.minimum(
            fields_np[obs_day][np.ix_(rr, cc)], clipval) * scale_10m2

        # zero-height bars mark every grid point (ref :441)
        ax.bar3d(gx, gy, np.zeros_like(gx), res, res, 0, color='0.95')
        rows = locinfo.grid_obs_DataFrame[
            locinfo.grid_obs_DataFrame['datePR'] == date]
        if len(rows):
            xs = rows['xcoord'].to_numpy(float)
            ys = rows['ycoord'].to_numpy(float)
            counts = rows['obs_count'].to_numpy(float)
            # effort separation: full-effort points light, reduced dark
            # (ref :468-477 colors by samples == 270)
            effs = []
            for x, y in zip(xs, ys):
                k = np.argmin(np.hypot(gx - x, gy - y))
                effs.append(0.75 if samples[k] == max_eff else 0.1)
            ax.bar3d(xs, ys, np.zeros_like(xs), res, res, counts,
                     color=base_cmap(effs))

        # facet colors: observed cells white/black by effort, boundary
        # cells highlighted, default elsewhere (ref :485-512)
        facets = np.empty(xg.shape, dtype=object)
        facets[:] = None
        if len(rows):
            for x, y, cnt in zip(xs, ys, counts):
                if cnt <= 0:
                    continue
                jj = np.argmin(np.abs(xmesh - x))
                ii = np.argmin(np.abs(ymesh - y))
                k = np.argmin(np.hypot(gx - x, gy - y))
                facets[ii, jj] = ((1, 1, 1, 1)
                                  if samples[k] == max_eff else
                                  (0, 0, 0, 1))
        # object-array slots take the color TUPLES one by one (bulk boolean
        # assignment would try to broadcast the 4-vector over the mask)
        for ii, jj in zip(*np.where((bndry > 0)
                                    & (facets == None))):        # noqa: E711
            facets[ii, jj] = bndry_clr
        for ii, jj in zip(*np.where(facets == None)):            # noqa: E711
            facets[ii, jj] = default_clr
        ax.plot_surface(xg, yg, model_grid, facecolors=facets,
                        rstride=1, cstride=1, shade=False)
        ax.view_init(elev=35, azim=-45)
        ax.set_xlabel('\nWest-East (meters)')
        ax.set_ylabel('\nSouth-North (meters)')
        ax.set_zlabel('num/10 m$^2$ model & observed')
        ax.set_title('obs day {} PR'.format(date.days), fontsize=11)
    fig.tight_layout(pad=1.5)
    outfile = outfile or 'assess_fit_3d.png'
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def banner(fields, days, params, locinfo=None, outfile=None, ncols=6,
           bw=False):
    """Multi-day spread banner (ref CompareToData.banner, :532-778)."""
    fields = _host(fields)
    plt = _mpl()
    fields = np.asarray(fields)
    idxs = np.linspace(0, len(days) - 1, min(ncols, len(days))).astype(int)
    rad_res = int(params.domain_info[1])
    cell = params.domain_info[0] / params.domain_info[1]
    _, window = crop_to_support(fields[-1])
    r0, r1, c0, c1 = window
    extent = _extent_meters(window, rad_res, cell)
    fig, axes = plt.subplots(1, len(idxs), figsize=(3.2 * len(idxs), 3.6))
    vmax = np.percentile(fields[-1][r0:r1, c0:c1], 99.9)
    for ax, i in zip(np.atleast_1d(axes), idxs):
        ax.imshow(np.ma.masked_less_equal(fields[i][r0:r1, c0:c1], 0),
                  cmap=('Greys' if bw else alpha_viridis()),
                  extent=extent, vmax=vmax)
        if locinfo is not None:
            for poly in locinfo.field_polys.values():
                ax.plot(*np.vstack([poly, poly[:1]]).T,
                        'k-' if bw else 'r-', lw=0.5)
            ax.set_xlim(extent[0], extent[1])
            ax.set_ylim(extent[2], extent[3])
        ax.set_title('day {}'.format(days[i]), fontsize=9)
        ax.tick_params(labelsize=6)
    fig.tight_layout()
    outfile = outfile or 'banner.png'
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def main(argv=None):
    """The figures of a saved run; ``--device cpu|cuda`` (default cuda)
    is where its fields are held, as every command line of the port."""
    import sys
    from ..cli import split_device
    from ..config import Params
    from ..device import pick_device
    from ..io.locinfo import LocInfo
    from ..io.save import load_run
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = split_device(argv)
    if not argv:
        print('usage: python -m parasitoids_tpu_torch.viz.compare '
              '<saved_run> [-b|-a|-3|-a3] [--bw] [--device cpu|cuda]\n'
              '  (default) 2-D emergence comparison   -3 paired 3-D '
              'emergence histograms\n'
              '  -a 2-D grid-count assessment         -a3 3-D fit '
              'surfaces   -b banner')
        return
    # accept the on-disk .npz name too (tab completion); the sidecar
    # reader and load_run both want the base path
    dev = pick_device(device)
    path = argv[0].removesuffix('.npz')
    params = Params()
    params.file_read_chg(path)
    dom_len = int(params.domain_info[1]) * 2 + 1
    fields, days = load_run(path, dom_len)
    fields = torch.as_tensor(np.asarray(fields)).to(dev)
    locinfo = LocInfo(params.dataset, tuple(params.coord),
                      tuple(params.domain_info))
    bw = '--bw' in argv
    if '-b' in argv:
        print('wrote', banner(fields, days, params, locinfo, bw=bw))
    elif '-a3' in argv:
        print('wrote', assess_fit_3d(fields, days, params, locinfo, bw=bw))
    elif '-a' in argv:
        print('wrote', assess_fit(fields, days, params, locinfo, bw=bw))
    elif '-3' in argv:
        print('wrote', compare_emergence_3d(fields, days, params, locinfo,
                                            bw=bw))
    else:
        print('wrote', compare_emergence(fields, days, params, locinfo,
                                         bw=bw))


if __name__ == '__main__':
    main()

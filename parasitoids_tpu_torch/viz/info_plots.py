"""Experiment-setup figures (L5).

Rebuilds ``MakeInfoPlots.py`` (:17-139): a field map with the average wind
vector drawn as an arrow and a diffusion-cloud scatter sampled from the
flight covariance, plus ``Plot_SampleLocations.py`` (:22-72): the QA overlay
of field polygons, rasterized field cells, and release-grid cells colored by
sampling effort.

The port's copy of ``parasitoids_tpu/viz/info_plots.py`` (host numpy and
matplotlib only): ``python -m parasitoids_tpu_torch.viz.info_plots
[--device cpu|cuda] [flags] [key=value ...]``.
"""

from __future__ import annotations


import numpy as np

__all__ = ['info_plot', 'sample_locations']


from . import _mpl   # shared headless-backend helper

def info_plot(params, locinfo, wind_data=None, outfile='info_plot.png',
              n_cloud=500, seed=0):
    """Field map + mean-wind arrow + sampled diffusion cloud
    (ref MakeInfoPlots.py)."""
    plt = _mpl()
    rng = np.random.default_rng(seed)
    fig, ax = plt.subplots(figsize=(8, 8))
    for fid, poly in locinfo.field_polys.items():
        ax.plot(*np.vstack([poly, poly[:1]]).T, 'k-', lw=1)
        ax.annotate(fid, poly.mean(axis=0), color='b')
    if wind_data is not None:
        mean_wind = np.mean(
            [w[:, :2].mean(axis=0) for w in wind_data.values()], axis=0)
        scale = 2000.0 / max(np.hypot(*mean_wind), 1e-9)
        ax.annotate('', xy=mean_wind * scale, xytext=(0, 0),
                    arrowprops=dict(color='r', width=2))
    sx, sy, rho = params.Dparams
    cov = np.array([[sx ** 2, rho * sx * sy], [rho * sx * sy, sy ** 2]])
    cloud = rng.multivariate_normal([0, 0], cov, n_cloud)
    ax.plot(cloud[:, 0], cloud[:, 1], '.', ms=1.5, alpha=0.4, color='g')
    ax.plot(0, 0, 'r*', ms=12)
    ax.set_aspect('equal')
    ax.set_xlabel('m east of release')
    ax.set_ylabel('m north of release')
    ax.set_title('fields, mean wind, flight diffusion cloud')
    fig.savefig(outfile, dpi=130, bbox_inches='tight')
    plt.close(fig)
    return outfile


def sample_locations(params, locinfo, outfile='sample_locations.png'):
    """Visual check of data import: polygons vs rasterized cells vs release
    grid (ref Plot_SampleLocations.py; described as the non-trivial check of
    field/grid import, test_Bayes.py:69-70)."""
    plt = _mpl()
    res = params.domain_info[0] / params.domain_info[1]
    rad_res = int(params.domain_info[1])
    fig, ax = plt.subplots(figsize=(9, 9))
    for fid, cells in locinfo.field_cells.items():
        x = (cells[:, 1] - rad_res) * res
        y = (rad_res - cells[:, 0]) * res
        ax.plot(x, y, 's', ms=2, alpha=0.4, label='cells {}'.format(fid))
    for fid, poly in locinfo.field_polys.items():
        ax.plot(*np.vstack([poly, poly[:1]]).T, 'k-', lw=1)
    gx = (locinfo.grid_cells[:, 1] - rad_res) * res
    gy = (rad_res - locinfo.grid_cells[:, 0]) * res
    effort = locinfo.grid_data['samples'].to_numpy(float)
    sc = ax.scatter(gx, gy, c=effort, s=25, cmap='autumn', zorder=3,
                    label='release grid')
    fig.colorbar(sc, ax=ax, label='sampling effort')
    ax.set_aspect('equal')
    ax.legend(fontsize=7, loc='lower right')
    ax.set_title('field cells + release grid vs polygons')
    fig.savefig(outfile, dpi=130, bbox_inches='tight')
    plt.close(fig)
    return outfile


def main(argv=None):
    """Both figures for a run's ``Params`` flags.  ``--device cpu|cuda``
    (default cuda) is checked as every command line of the port checks
    it; the figures themselves run on the host."""
    import sys
    from ..cli import split_device
    from ..config import Params
    from ..device import pick_device
    from ..io.locinfo import LocInfo
    from ..io.wind import get_wind_data
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = split_device(argv)
    pick_device(device)
    params = Params()
    if argv:
        params.cmd_line_chg(argv)
    locinfo = LocInfo(params.dataset, params.coord, params.domain_info)
    wind_data, _ = get_wind_data(*params.get_wind_params())
    print('wrote', info_plot(params, locinfo, wind_data))
    print('wrote', sample_locations(params, locinfo))


if __name__ == '__main__':
    main()

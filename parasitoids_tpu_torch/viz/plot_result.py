"""Simulation-result visualization (L5).

Rebuilds the reference's ``Plot_Result.py`` capabilities: resolution-adaptive
single-day plots, all-days sweeps, animation export, and optional satellite
underlays, driven from saved runs or in-memory fields.  Figures are written
to files (headless-friendly); the interactive loader menu of the reference
(Plot_Result.py:491-595) is replaced by a CLI (`python -m
parasitoids_tpu_torch.viz.plot_result <file> [day|all|vid]`).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ['alpha_viridis', 'crop_to_support', 'vmax_excluding_origin',
           'satellite_zoom',
           'plot', 'plot_all',
           'create_animation', 'get_satellite', 'main']


from . import _mpl   # shared headless-backend helper

def alpha_viridis():
    """Viridis with alpha ramping from transparent at zero
    (ref Plot_Result.py:31-41)."""
    import matplotlib as mpl
    base = mpl.colormaps['viridis'].resampled(256)
    colors = base(np.linspace(0, 1, 256))
    colors[:, -1] = np.minimum(1.0, np.linspace(0, 4.0, 256))
    return mpl.colors.ListedColormap(colors)


def crop_to_support(field, rel_tol=1e-3, frame=5):
    """Crop a field to its significant support plus a frame of cells
    (ref Plot_Result.py:199-221: values below ~max*1e-3 are masked and the
    plot window shrinks to what remains)."""
    field = np.asarray(field)
    mask = field > field.max() * rel_tol
    if not mask.any():
        return field, (0, field.shape[0], 0, field.shape[1])
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    r0 = max(rows.min() - frame, 0)
    r1 = min(rows.max() + frame + 1, field.shape[0])
    c0 = max(cols.min() - frame, 0)
    c1 = min(cols.max() + frame + 1, field.shape[1])
    return field[r0:r1, c0:c1], (r0, r1, c0, c1)


def vmax_excluding_origin(masked, window, rad_res):
    """Color-scale maximum ignoring the origin block, which can dwarf the
    dispersal spread (ref Plot_Result.py:217-221).  ``masked`` is the
    support-cropped masked field, ``window`` its crop window."""
    vmax_src = masked.copy()
    r0, _, c0, _ = window
    cr, cc = rad_res - r0, rad_res - c0
    if 0 <= cr < vmax_src.shape[0] and 0 <= cc < vmax_src.shape[1]:
        lo_r, hi_r = max(cr - 2, 0), cr + 3
        lo_c, hi_c = max(cc - 2, 0), cc + 3
        vmax_src[lo_r:hi_r, lo_c:hi_c] = np.ma.masked
    return float(vmax_src.max()) if vmax_src.count() else float(
        masked.max())


def _extent_meters(window, rad_res, cell):
    r0, r1, c0, c1 = window
    return ((c0 - rad_res) * cell, (c1 - rad_res) * cell,
            (rad_res - r1) * cell, (rad_res - r0) * cell)


def _ground_res(lat, zoom):
    """Web-Mercator ground resolution (m/pixel) at latitude/zoom — the
    reference's ``resfunc`` (Plot_Result.py:94-97)."""
    import math
    return 156543.03392 * math.cos(math.radians(lat)) / (2 ** zoom)


def satellite_zoom(lat, dist_m, service='Google'):
    """Zoom-to-resolution search (ref Plot_Result.py:125-139): raise the
    zoom until the domain half-span ``dist_m`` maps into the service's
    pixel window — Google 320–640 px at scale 2 (display-area limit),
    Bing 400–800 px (actual image resolution) — then size the request to
    cover exactly the 2·dist+1 m domain.  Returns ``(zoom, pixel_len)``.
    """
    lo = 320 if service == 'Google' else 400
    zoom = 4
    while not dist_m / lo < _ground_res(lat, zoom) <= dist_m / (lo // 2):
        zoom += 1
        if zoom > 21:          # service maximum; accept the finest tile
            zoom = 21
            break
    pixel_len = int(round((dist_m * 2 + 1) / _ground_res(lat, zoom)))
    return zoom, pixel_len


def get_satellite(maps_key, coord, dist_m, service='Google'):
    """Fetch a static satellite image centered on ``coord`` covering the
    ±``dist_m`` domain (ref Plot_Result.py:101-177), from Google Static
    Maps or Bing (Virtual Earth) Aerial per ``Params.maps_service``.

    The zoom comes from :func:`satellite_zoom`'s resolution search and
    the request is sized so the tile spans exactly the domain; returns
    ``(image, half_span_m)`` with the tile's true half-span for
    geo-registration, or None without a key/network access."""
    if maps_key is None or coord is None:
        return None
    try:
        import io
        import urllib.parse
        import urllib.request
        from PIL import Image
        lat, lon = coord
        zoom, pixel_len = satellite_zoom(lat, dist_m, service)
        if service == 'Google':
            # scale=2 doubles the returned pixels over the same coverage
            # area (ref Plot_Result.py:151-161)
            q = urllib.parse.urlencode({
                'center': '{:03.6f},{:03.6f}'.format(lat, lon),
                'zoom': str(zoom),
                'size': '{0:d}x{0:d}'.format(pixel_len),
                'scale': '2', 'format': 'jpeg', 'maptype': 'satellite',
                'key': maps_key})
            url = 'https://maps.googleapis.com/maps/api/staticmap?' + q
        elif service == 'Bing':
            # ref Plot_Result.py:141-148
            q = urllib.parse.urlencode({
                'mapSize': '{0:d},{0:d}'.format(pixel_len),
                'format': 'jpeg', 'key': maps_key})
            url = ('http://dev.virtualearth.net/REST/v1/Imagery/Map/'
                   'Aerial/{:03.6f}%2C{:03.6f}/{}?'.format(lat, lon, zoom)
                   + q)
        else:
            print('Unknown maps service {!r}. Continuing without '
                  'satellite imagery...'.format(service))
            return None
        with urllib.request.urlopen(url, timeout=10) as resp:
            img = Image.open(io.BytesIO(resp.read()))
        return img, pixel_len * _ground_res(lat, zoom) / 2.0
    except Exception as e:   # network/keys are optional
        print('satellite fetch failed: {}'.format(e))
        return None


def plot(field, day, params, outfile=None, locinfo=None, show=False,
         mask_center=True):
    """Single-day field plot with support cropping
    (ref Plot_Result.py:258-375)."""
    plt = _mpl()
    rad_res = int(params.domain_info[1])
    cell = params.domain_info[0] / params.domain_info[1]
    cropped, window = crop_to_support(field)
    extent = _extent_meters(window, rad_res, cell)

    fig, ax = plt.subplots(figsize=(8, 7))
    sat = get_satellite(getattr(params, 'maps_key', None),
                        getattr(params, 'coord', None),
                        max(abs(e) for e in extent),
                        getattr(params, 'maps_service', 'Google'))
    if sat is not None:
        # the tile is square and centered on the release point; draw it
        # in ITS OWN frame and clamp the view to the crop window —
        # stretching it into the (asymmetric) crop extent would shift and
        # rescale the imagery relative to the density/polygons
        img, half = sat
        ax.imshow(img, extent=(-half, half, -half, half), zorder=0)
        ax.set_xlim(extent[0], extent[1])
        ax.set_ylim(extent[2], extent[3])
    masked = np.ma.masked_less_equal(cropped, cropped.max() * 1e-3)
    vmax = (vmax_excluding_origin(masked, window, rad_res) if mask_center
            else float(masked.max()))
    im = ax.imshow(masked, cmap=alpha_viridis(), extent=extent,
                   vmax=vmax, zorder=1)
    if locinfo is not None:
        for poly in locinfo.field_polys.values():
            ax.plot(*np.vstack([poly, poly[:1]]).T, 'r-', lw=0.8, zorder=2)
    ax.set_xlabel('meters east of release')
    ax.set_ylabel('meters north of release')
    ax.set_title('Day {} PR'.format(day))
    fig.colorbar(im, ax=ax, label='density')
    if outfile:
        fig.savefig(outfile, dpi=150, bbox_inches='tight')
    if show:
        plt.show()
    plt.close(fig)
    return outfile


def plot_all(fields, days, params, outdir=None, locinfo=None):
    """Plot every simulated day (ref Plot_Result.plot_all,
    Plot_Result.py:181-254)."""
    outdir = outdir or (params.outfile + '_plots')
    os.makedirs(outdir, exist_ok=True)
    out = []
    for field, day in zip(np.asarray(fields), days):
        out.append(plot(field, day, params,
                        outfile=os.path.join(outdir,
                                             'day_{}.png'.format(day)),
                        locinfo=locinfo))
    print('wrote {} figures to {}'.format(len(out), outdir))
    return out


def create_animation(fields, days, params, outfile=None, fps=2):
    """Animated spread video (ref Plot_Result.create_mp4,
    Plot_Result.py:379-487)."""
    plt = _mpl()
    from matplotlib import animation
    fields = np.asarray(fields)
    rad_res = int(params.domain_info[1])
    cell = params.domain_info[0] / params.domain_info[1]
    # common window covering the last day's support
    _, window = crop_to_support(fields[-1])
    extent = _extent_meters(window, rad_res, cell)
    r0, r1, c0, c1 = window
    vmax = max(np.percentile(f[r0:r1, c0:c1], 99.9) for f in fields)

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(fields[0][r0:r1, c0:c1], cmap=alpha_viridis(),
                   extent=extent, vmax=vmax)
    title = ax.set_title('Day {} PR'.format(days[0]))

    def update(i):
        im.set_data(fields[i][r0:r1, c0:c1])
        title.set_text('Day {} PR'.format(days[i]))
        return [im, title]

    ani = animation.FuncAnimation(fig, update, frames=len(days))
    outfile = outfile or (params.outfile + '.gif')
    writer = (animation.FFMpegWriter(fps=fps)
              if outfile.endswith(('.mp4', '.avi'))
              else animation.PillowWriter(fps=fps))
    ani.save(outfile, writer=writer)
    plt.close(fig)
    print('wrote', outfile)
    return outfile


def main(argv=None):
    import sys
    from ..config import Params
    from ..io.save import load_run
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print('usage: python -m parasitoids_tpu_torch.viz.plot_result '
              '<saved_run> [all|vid|menu|<day>]')
        return
    # accept the on-disk .npz name too (tab completion); the sidecar
    # reader and load_run both want the base path
    path = argv[0].removesuffix('.npz')
    mode = argv[1] if len(argv) > 1 else 'all'
    params = Params()
    params.file_read_chg(path)
    dom_len = int(params.domain_info[1]) * 2 + 1
    fields, days = load_run(path, dom_len)
    def run_mode(mode):
        if mode == 'all':
            plot_all(fields, days, params)
        elif mode == 'vid':
            create_animation(fields, days, params)
        else:
            day = int(mode)
            if day not in days:
                print('day {} not in this run; available days: {}'.format(
                    day, list(days)))
                return
            idx = days.index(day)
            out = plot(fields[idx], day, params,
                       outfile='{}_day{}.png'.format(path, day))
            print('wrote', out)

    if mode != 'menu':
        run_mode(mode)
        return
    # interactive loader (ref Plot_Result.py:491-595): prompt for days
    # until quit
    print('days in this run: {}'.format(list(days)))
    while True:
        try:
            ans = input('day number, "all", "vid", or "q" to quit: ').strip()
        except EOFError:
            break
        if ans in ('q', 'quit', ''):
            break
        try:
            run_mode(ans)
        except ValueError:
            print('unrecognized input {!r}'.format(ans))


if __name__ == '__main__':
    main()

"""Field/location data import (L1) — the reference ``LocInfo`` rebuilt.

Loads everything the Bayesian layer compares against (ref Data_Import.py):
sentinel-field boundary polygons, the release-field sampling grid, and the
xlsx observation workbooks (sentinel/release emergence, grid counts,
cardinal-transect counts), producing the same inference-ready arrays
(``release_emerg``, ``release_collection``, ``sentinel_emerg``,
``grid_obs``/``grid_samples``, ``card_obs``).

Differences from the reference, all host-side and deliberate:
* xlsx files are read by our zero-dependency reader (io/xlsx.py) instead of
  pandas.read_excel's engine,
* polygon rasterization uses a first-party vectorized crossing-number test
  instead of matplotlib.path (parity-tested against it),
* coordinate matching between the sampling grid and observation rows
  tolerates float rounding instead of exact equality after rotation.

Site-specific parsing is implemented for Kalbar, as in the reference
(Data_Import.py:491-492 raises NotImplementedError for other sites) — but
unlike the reference, any OTHER site can supply its observations generically:
a ``<site>site.json`` spec plus plain-CSV tables (see io/site.py for the spec
format and the ``_generic_*`` methods below for the CSV schemas).
"""

from __future__ import annotations

import math
import os

import numpy as np
import pandas as pd

from .site import load_site_spec, site_spec_path
from .xlsx import read_sheet

__all__ = ['LocInfo', 'points_in_polygon', 'latlong_to_xy']

EARTH_RADIUS_M = 6378100.0  # equatorial radius, ref Data_Import.py:285
GRID_ROTATION_DEG = -33.0   # release grid/road alignment, Data_Import.py:100


def latlong_to_xy(center, lat, long):
    """Equirectangular lat/long -> meters from ``center``
    (ref Data_Import.py:273-296)."""
    o_lat, o_long = math.radians(center[0]), math.radians(center[1])
    lat, long = math.radians(lat), math.radians(long)
    x = EARTH_RADIUS_M * (long - o_long) * math.cos((o_lat + lat) / 2)
    y = EARTH_RADIUS_M * (lat - o_lat)
    return (x, y)


def points_in_polygon(points, verts):
    """Vectorized crossing-number point-in-polygon test.

    Args:
        points: (N, 2) xy points.
        verts: (M, 2) polygon vertices (closed implicitly).
    Returns:
        (N,) bool array.
    """
    pts = np.asarray(points, float)
    v = np.asarray(verts, float)
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x1, y1 = v[:, 0][None, :], v[:, 1][None, :]
    x2, y2 = np.roll(v[:, 0], -1)[None, :], np.roll(v[:, 1], -1)[None, :]
    crosses = ((y1 <= y) != (y2 <= y))
    with np.errstate(divide='ignore', invalid='ignore'):
        x_at_y = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
    hits = crosses & (x < x_at_y)
    return (hits.sum(axis=1) % 2).astype(bool)


def _rot_mat(theta_deg):
    th = math.radians(theta_deg)
    return np.array([[math.cos(th), -math.sin(th)],
                     [math.sin(th), math.cos(th)]])


def _parse_day(value, release_date):
    """A date in a site spec / observation CSV: either an integer meaning
    days post-release, or anything ``pd.Timestamp`` parses (ISO dates)."""
    try:
        return release_date + pd.Timedelta(days=int(value))
    except (TypeError, ValueError):
        return pd.Timestamp(value)


class LocInfo:
    """All experimental-location data (ref Data_Import.LocInfo,
    Data_Import.py:12-254).  See the reference docstring for the full
    attribute inventory; names and array layouts are kept identical so the
    Bayes layer and plotting tools can consume either implementation."""

    def __init__(self, location, release_latlong, domain_info,
                 data_dir='./data'):
        self.data_dir = data_dir
        # generic-site spec (None for kalbar and for spec-less sites; the
        # kalbar xlsx parsers always win for 'kalbar' to preserve parity)
        self._spec = (None if location == 'kalbar'
                      else load_site_spec(data_dir, location))
        res = domain_info[0] / domain_info[1]
        rad_res = int(domain_info[1])

        ### sentinel field polygons -> cells -> sizes
        self.field_polys = self.get_fields(
            '{}/{}fields.txt'.format(data_dir, location), release_latlong)
        self.field_cells = self.get_field_cells(self.field_polys, domain_info)
        empty = [k for k, v in self.field_cells.items() if v.shape[0] == 0]
        if empty:
            raise ValueError(
                'field polygon(s) {} rasterize to zero grid cells — '
                'check the lat/long vertices against the release point '
                'and domain radius'.format(sorted(empty)))
        # cell count = rows of the (n, 2) cell array.  The reference's
        # max(val.shape) (Data_Import.py:74) would report 2 for 0/1-cell
        # fields — identical for every Kalbar field (all >= 3 cells), so
        # this fixes the wart without breaking parity
        self.field_sizes = {key: val.shape[0]
                            for key, val in self.field_cells.items()}

        ### release-field sampling grid
        self.grid_data = self.get_release_grid(
            '{}/{}releasegrid.txt'.format(data_dir, location))
        xmax = self.grid_data['xcoord'].max() + 50
        xmin = self.grid_data['xcoord'].min() - 50
        ymax = self.grid_data['ycoord'].max() + 50
        ymin = self.grid_data['ycoord'].min() - 50
        edges = [np.array([np.linspace(xmin, xmax), ymax * np.ones(50)]),
                 np.array([np.linspace(xmin, xmax), ymin * np.ones(50)]),
                 np.array([xmin * np.ones(50), np.linspace(ymin, ymax)]),
                 np.array([xmax * np.ones(50), np.linspace(ymin, ymax)])]
        self.grid_boundary = np.concatenate(edges, axis=1)

        # rotate grid to align with the road (ref Data_Import.py:99-105);
        # generic sites declare their own angle (default: no rotation)
        self.grid_rotation_deg = (
            GRID_ROTATION_DEG if self._spec is None
            else float(self._spec.get('grid_rotation_deg', 0.0)))
        rot = _rot_mat(self.grid_rotation_deg)
        xy = self.grid_data[['xcoord', 'ycoord']].to_numpy(float) @ rot.T
        self.grid_data[['xcoord', 'ycoord']] = xy
        self.grid_boundary = rot @ self.grid_boundary

        # grid point -> (row, col) cell indices
        self.grid_cells = np.stack(
            [-self.grid_data['ycoord'].to_numpy(float),
             self.grid_data['xcoord'].to_numpy(float)])
        self.grid_cells = (np.around(self.grid_cells / res) +
                           rad_res).T.astype(int)

        ### sentinel emergence observations
        self.get_sentinel_emergence(location)
        self.sent_ids = list(self.sent_DataFrames[0]['id'].unique())

        ### release-field emergence observations
        self.get_releasefield_emergence(location)
        for dframe in self.release_DataFrames:
            xy = dframe[['xcoord', 'ycoord']].to_numpy(float) @ rot.T
            dframe[['xcoord', 'ycoord']] = xy
        self.emerg_grids = []
        for dframe in self.release_DataFrames:
            dframe['row'] = ((-dframe['ycoord'] / res).round(0) +
                             rad_res).astype(int)
            dframe['column'] = ((dframe['xcoord'] / res).round(0) +
                                rad_res).astype(int)
            dframe.sort_values(['datePR', 'row', 'column'], inplace=True)
            dframe.reset_index(inplace=True, drop=True)
            oneday = dframe['datePR'] == dframe['datePR'].min()
            self.emerg_grids.append(list(zip(
                dframe['row'][oneday].values.tolist(),
                dframe['column'][oneday].values.tolist())))

        ### release-field grid adult observations
        self.get_grid_observations(location)
        xy = self.grid_obs_DataFrame[['xcoord', 'ycoord']].to_numpy(float) \
            @ rot.T
        self.grid_obs_DataFrame[['xcoord', 'ycoord']] = xy
        n_grid = self.grid_cells.shape[0]
        n_dates = len(self.grid_obs_datesPR)
        self.grid_obs = np.zeros((n_grid, n_dates))
        self.grid_samples = np.zeros((n_grid, n_dates))
        gx = self.grid_data['xcoord'].to_numpy(float)
        gy = self.grid_data['ycoord'].to_numpy(float)
        for nday, date in enumerate(self.grid_obs_datesPR):
            obs = self.grid_obs_DataFrame[
                self.grid_obs_DataFrame['datePR'] == date]
            ox = obs['xcoord'].to_numpy(float)
            oy = obs['ycoord'].to_numpy(float)
            oc = obs['obs_count'].to_numpy(float)
            matched = np.zeros(ox.shape[0], bool)
            for n in range(n_grid):
                self.grid_samples[n, nday] = self.grid_data['samples'].iloc[n]
                hit = (np.abs(ox - gx[n]) < 1e-6) & (np.abs(oy - gy[n]) < 1e-6)
                if hit.any():
                    self.grid_obs[n, nday] = oc[hit].sum()
                    matched |= hit
            if self._spec is not None and not matched.all():
                # generic CSVs promise on-grid coordinates; silently
                # dropping a typo'd row would erase real observations.
                # (kalbar's raw workbook legitimately contains off-grid
                # rows, so the site-specific path keeps dropping them.)
                bad = np.flatnonzero(~matched)[0]
                rot_inv = _rot_mat(-self.grid_rotation_deg)
                bx, by = rot_inv @ np.array([ox[bad], oy[bad]])
                raise ValueError(
                    'grid observation at ({0:g}, {1:g}) (day {2}) matches '
                    'no release-grid point; every x,y in the grid CSV '
                    'must coincide with a releasegrid point'.format(
                        bx, by, date.days))
        if self.grid_samples.size:    # generic sites may have no grid obs
            smax = self.grid_samples.max()
            if smax <= 0:
                raise ValueError(
                    "the releasegrid 'samples' column is all zero — "
                    'per-point sampling effort is required when grid '
                    'observations are supplied')
            self.grid_samples = self.grid_samples / smax

        ### cardinal-direction observations
        self.get_card_observations(location)
        self.card_obs = []
        # generic sites carry their REAL transect distances (the reference
        # hard-codes the 5 + step_size*(1..n) sampling geometry of its one
        # site, Bayes_funcs.py:193-215; ObservationOps keeps that formula
        # for kalbar and uses these distances otherwise).  The (4, maxlen)
        # layout is the reference's: directions with fewer samples are
        # zero-count-padded (distance padded with the last real value) —
        # placeholder slots, fine for the viz/projection consumers; card
        # counts are NOT part of the likelihood (commented out in the
        # reference too, Bayes_Run.py:318-336)
        self.card_dists = [] if self._spec is not None else None
        for dframe in self.card_obs_DataFrames:
            dframe.sort_values(['direction', 'distance'], inplace=True)
            by_dir = {d: dframe[dframe['direction'] == d]
                      for d in ('north', 'south', 'east', 'west')}
            maxlen = max(len(v) for v in by_dir.values())
            card = np.zeros((4, maxlen))
            for i, d in enumerate(('north', 'south', 'east', 'west')):
                card[i, :len(by_dir[d])] = by_dir[d]['obs_count'].values
            self.card_obs.append(card)
            if self.card_dists is not None:
                dist = np.zeros((4, maxlen))
                for i, d in enumerate(('north', 'south', 'east', 'west')):
                    vals = by_dir[d]['distance'].values.astype(float)
                    dist[i, :len(vals)] = vals
                    if 0 < len(vals) < maxlen:   # pad: repeat the last
                        dist[i, len(vals):] = vals[-1]
                self.card_dists.append(dist)

        ### inference-ready arrays (ref Data_Import.py:215-254)
        self.release_emerg = []
        self.release_collection = []
        self.sentinel_emerg = []
        for dframe in self.release_DataFrames:
            obs_datesPR = dframe['datePR'].unique()
            first = dframe['datePR'] == dframe['datePR'].min()
            datelen = int(first.sum())
            r_array = []
            for x, y in dframe.loc[first, ['xcoord', 'ycoord']].values:
                hit = (np.abs(gx - x) < 1e-6) & (np.abs(gy - y) < 1e-6)
                vals = self.grid_data['collection'].to_numpy(float)[hit]
                if vals.shape != (1,):
                    # most likely a typo'd coordinate in a generic-site
                    # release CSV — name the point in the file's own
                    # (pre-rotation) coordinate frame
                    ox, oy = rot.T @ np.array([x, y])
                    raise ValueError(
                        'release observation point ({0:g}, {1:g}) '
                        'matches {2} release-grid points; every x,y '
                        'must coincide with exactly one point of the '
                        'releasegrid file'.format(ox, oy, vals.size))
                r_array.append(vals[0])
            r_array = np.array(r_array)
            if r_array.max() <= 0:
                raise ValueError(
                    "the releasegrid 'collection' column is zero at every "
                    'observed release point — collection effort is '
                    'required for release-field emergence data')
            self.release_collection.append(r_array / r_array.max())
            E = np.zeros((datelen, len(obs_datesPR)))
            for ndate, date in enumerate(obs_datesPR):
                E[:, ndate] = dframe[dframe['datePR'] == date][
                    'E_total'].values
            self.release_emerg.append(E)
        for dframe in self.sent_DataFrames:
            obs_datesPR = dframe['datePR'].unique()
            E = np.zeros((len(self.sent_ids), len(obs_datesPR)))
            for ndate, date in enumerate(obs_datesPR):
                E[:, ndate] = dframe[dframe['datePR'] == date][
                    'E_total'].values
            self.sentinel_emerg.append(E)

    # ------------------------------------------------------------------
    @staticmethod
    def get_fields(filename, center):
        """Parse field boundary polygons (lat/long vertex lists separated by
        blank lines, each preceded by a field id) into vertex arrays
        (ref Data_Import.py:258-338)."""
        polys = {}
        verts = []
        fid = None

        def flush():
            nonlocal verts, fid
            if verts:
                if fid in polys:
                    raise ValueError('{}: duplicate field id {!r}'.format(
                        filename, fid))
                polys[fid] = np.array(verts)
            # always reset: an id followed by a blank line must not make
            # the next id line parse as a vertex of the dangling field
            verts, fid = [], None

        with open(filename) as f:
            for line in f:
                c = line.find('#')
                if c >= 0:
                    line = line[:c]
                line = line.strip()
                if not line:
                    flush()
                elif fid is None:
                    fid = line
                else:
                    lat, long = (float(v) for v in line.split(','))
                    verts.append(latlong_to_xy(center, lat, long))
        flush()
        return polys

    @staticmethod
    def get_field_cells(polys, domain_info):
        """Rasterize each polygon onto the simulation grid; returns
        {field: (n, 2) array of (row, col)} (ref Data_Import.py:342-368)."""
        res = domain_info[0] / domain_info[1]
        N = int(domain_info[1])
        colm, rowm = np.meshgrid(res * np.arange(-N, N + 1),
                                 res * np.arange(N, -N - 1, -1))
        centers = np.column_stack([colm.ravel(), rowm.ravel()])
        fields = {}
        for fid, verts in polys.items():
            mask = points_in_polygon(centers, verts).reshape(2 * N + 1,
                                                             2 * N + 1)
            fields[fid] = np.argwhere(mask)
        return fields

    @staticmethod
    def get_release_grid(filename):
        """Release-field sampling grid: comma-delimited columns xcoord,
        ycoord, area, samples, collection (ref Data_Import.py:372-415)."""
        rows = []
        with open(filename) as f:
            for line in f:
                c = line.find('#')
                if c >= 0:
                    line = line[:c]
                if line.strip():
                    rows.append([float(v) for v in line.split(',')])
        if not rows:
            raise ValueError('no grid rows found in {} (fill in the '
                             'xcoord,ycoord,area,samples,collection '
                             'table)'.format(filename))
        grid = np.array(rows)
        if grid.ndim != 2:
            raise ValueError('incomplete line in {}: every row needs 5 '
                             'comma-separated values'.format(filename))
        return pd.DataFrame(grid, columns=['xcoord', 'ycoord', 'area',
                                           'samples', 'collection'])

    # ------------------------------------------------------------------
    def _no_site(self, location):
        raise NotImplementedError(
            'no observation parser for site {0!r}: either add a site-'
            'specific loader (as for kalbar) or provide a generic spec at '
            '{1} with CSV observation tables (see parasitoids_tpu/io/'
            'site.py for the format)'.format(
                location, site_spec_path(self.data_dir, location)))

    def get_sentinel_emergence(self, location):
        """Sentinel-field emergence observations
        (ref Data_Import.py:417-492, Kalbar only; generic CSV otherwise)."""
        if location != 'kalbar':
            if self._spec is not None:
                return self._generic_sentinel()
            self._no_site(location)
        data_loc = '{}/sampling_details.xlsx'.format(self.data_dir)
        self.release_date = pd.Timestamp('2005-03-13')
        self.collection_datesPR = [pd.Timestamp('2005-03-31') -
                                   self.release_date]
        df = read_sheet(data_loc, 'Kal-sentinels-raw')
        df = df.rename(columns={'Field descrip': 'descrip',
                                'date emerged': 'date',
                                'Field ID (jpgs)': 'id',
                                'Field ID (paper)': 'paperid'})
        df = df.drop(columns=['descrip', 'paperid'])
        df = df.sort_values(['id', 'date'])
        count_cols = [c for c in df.columns if c not in ('id', 'date')]
        df['All_total'] = df[count_cols].sum(axis=1)
        df['E_total'] = df[['Efemales', 'Emales']].sum(axis=1)
        df['datePR'] = df['date'] - self.release_date
        df = df.sort_values(['datePR', 'id']).reset_index(drop=True)
        self.sent_DataFrames = [df]
        self.sent_protocols = ['lab']

    def get_releasefield_emergence(self, location):
        """Release-field emergence observations
        (ref Data_Import.py:494-562, Kalbar only).  North was left on the
        recorded grid, so coordinates are swapped/flipped and the release
        point moved to the origin."""
        if location != 'kalbar':
            if self._spec is not None:
                return self._generic_release()
            self._no_site(location)
        data_loc = '{}/sampling_details.xlsx'.format(self.data_dir)
        self.releasefield_id = 'A'
        df = read_sheet(data_loc, 'Kal-releasefield-raw')
        tmp = df['xcoord'].copy()
        df['xcoord'] = df['ycoord']
        df['ycoord'] = -tmp
        df['ycoord'] += 300
        df['xcoord'] -= 200
        count_cols = [c for c in df.columns
                      if c not in ('Field', 'xcoord', 'ycoord',
                                   'date emerged')]
        df['All_total'] = df[count_cols].sum(axis=1)
        df['E_total'] = df[['Efemales', 'Emales']].sum(axis=1)
        df['datePR'] = df['date emerged'] - self.release_date
        df = df[(df['xcoord'] != 0) | (df['ycoord'] != 0)]
        self.release_DataFrames = [df.reset_index(drop=True)]
        self.release_coll_idx = [0]

    def get_grid_observations(self, location):
        """Release-field grid adult counts
        (ref Data_Import.py:564-614, Kalbar only; generic CSV otherwise)."""
        if location != 'kalbar':
            if self._spec is not None:
                return self._generic_grid()
            self._no_site(location)
        data_loc = '{}/adult_counts_kalbar.xlsx'.format(self.data_dir)
        df = read_sheet(data_loc, 'adult counts field A')
        df = df.rename(columns={'x coor': 'x', 'y coor': 'y',
                                'num leaves viewed': 'leaves',
                                'num hayati': 'obs_count'})
        df = df[['date', 'collector', 'x', 'y', 'leaves', 'obs_count']]
        df = df.assign(xcoord=df['y'], ycoord=-df['x'])
        df = df.drop(columns=['x', 'y'])
        df['ycoord'] += 300
        df['xcoord'] -= 200
        df['datePR'] = df['date'] - self.release_date
        df = df.sort_values(['datePR', 'xcoord', 'ycoord'])
        df = df.reset_index(drop=True)
        self.grid_obs_datesPR = [pd.Timedelta(d)
                                 for d in df['datePR'].unique()]
        self.grid_obs_DataFrame = df

    def get_card_observations(self, location):
        """Cardinal-direction transect counts
        (ref Data_Import.py:616-651, Kalbar only; generic CSV otherwise)."""
        if location != 'kalbar':
            if self._spec is not None:
                return self._generic_card()
            self._no_site(location)
        data_loc = '{}/adult_counts_kalbar.xlsx'.format(self.data_dir)
        sheets = ['cardinal 15 mar 05', 'cardinal 21 mar 05']
        self.step_size = [2, 2]
        self.card_obs_DataFrames = []
        self.card_obs_datesPR = []
        for sheet in sheets:
            df = read_sheet(data_loc, sheet)
            df = df.rename(columns={'num adults': 'obs_count'})
            df = df.drop(columns=['num viewers'])
            df['datePR'] = df['date'] - self.release_date
            self.card_obs_datesPR.append(df['datePR'].iloc[0])
            self.card_obs_DataFrames.append(df)

    # ------------------------------------------------------------------
    # generic-site CSV loaders (no reference equivalent: Data_Import.py
    # raises NotImplementedError for every site but Kalbar)
    # ------------------------------------------------------------------
    def _read_obs_csv(self, name):
        return pd.read_csv(os.path.join(self.data_dir, name),
                           comment='#', skipinitialspace=True)

    def _generic_sentinel(self):
        """Sentinel emergence from CSVs with columns ``id,date,count``: one
        row per (sentinel field id, emergence date, wasps emerged).  Dates
        are ISO strings or integer days post-release; (id, date) duplicates
        are summed and missing combinations filled with 0 so every
        collection covers the same field set.

        Each collection may declare a ``"protocol"``:

        * ``"lab"`` (default, the Kalbar protocol, ref Bayes_funcs.py:20-152):
          plants sit in the field from release until ``collection_date``,
          then emergence is recorded in the lab on the CSV dates (>= the
          collection date); expected counts convolve oviposition-day
          populations with the 19-25-day incubation distribution.
        * ``"exposure"`` (rotating sentinel plants — the protocol behind
          short-horizon records like data/carnarvonearlemergence.txt, whose
          day-1..21 counts are impossible under 19+-day lab incubation):
          each CSV date's count is the total eventual emergence from plants
          EXPOSED during the window since the previous CSV date, i.e. a
          direct count of that window's oviposition; expected counts sum
          the window's populations with no incubation offset.
          ``collection_date`` should equal the last CSV date (it only
          feeds the simulation-horizon check).
        """
        spec = self._spec
        rd = pd.Timestamp(spec['release_date'])
        self.release_date = rd
        self.collection_datesPR = []
        self.sent_protocols = []
        raw = []
        for coll in spec['collections']:
            df = self._read_obs_csv(coll['sentinel_csv'])
            df = df.assign(id=df['id'].astype(str),
                           date=[_parse_day(v, rd) for v in df['date']])
            raw.append(df)
            self.collection_datesPR.append(
                _parse_day(coll['collection_date'], rd) - rd)
            proto = str(coll.get('protocol', 'lab'))
            if proto not in ('lab', 'exposure'):
                raise ValueError(
                    "collection protocol {!r} unknown — use 'lab' "
                    "(collect once, count lab emergence through the "
                    "incubation distribution) or 'exposure' (rotating "
                    "plants; counts attribute to the exposure window's "
                    "oviposition)".format(proto))
            self.sent_protocols.append(proto)
        ids = sorted(set().union(*[set(df['id']) for df in raw]))
        self.sent_DataFrames = []
        for df in raw:
            counts = df.groupby(['id', 'date'])['count'].sum()
            rows = [(fid, date, float(counts.get((fid, date), 0.0)))
                    for date in df['date'].drop_duplicates().sort_values()
                    for fid in ids]
            frame = pd.DataFrame(rows, columns=['id', 'date', 'E_total'])
            frame['datePR'] = frame['date'] - rd
            self.sent_DataFrames.append(frame)

    def _generic_release(self):
        """Release-field emergence from CSVs with columns ``x,y,date,count``:
        (x, y) must coincide with a point of ``<site>releasegrid.txt`` (same
        meter coordinates, pre-rotation); duplicates are summed and every
        grid point present anywhere in the file is carried on every date
        (missing counts = 0), matching the complete point-by-date layout the
        inference arrays require."""
        spec = self._spec
        rd = self.release_date
        self.releasefield_id = spec.get('releasefield_id', 'A')
        self.release_DataFrames = []
        # collections without a release_csv contribute no release-channel
        # frame (a site may have sentinel records only — e.g. the real
        # carnarvon-early data has no spatial release-field sampling);
        # this index maps each kept frame back to its collection entry so
        # the observation projections pair it with the right
        # collection_date/protocol
        self.release_coll_idx = []
        for ncoll, coll in enumerate(spec['collections']):
            if not coll.get('release_csv'):
                continue
            self.release_coll_idx.append(ncoll)
            df = self._read_obs_csv(coll['release_csv'])
            df = df.assign(x=df['x'].astype(float), y=df['y'].astype(float),
                           date=[_parse_day(v, rd) for v in df['date']])
            counts = df.groupby(['x', 'y', 'date'])['count'].sum()
            pts = sorted(set(zip(df['x'], df['y'])))
            rows = [(x, y, date, float(counts.get((x, y, date), 0.0)))
                    for date in df['date'].drop_duplicates().sort_values()
                    for (x, y) in pts]
            frame = pd.DataFrame(rows, columns=['xcoord', 'ycoord', 'date',
                                                'E_total'])
            frame['datePR'] = frame['date'] - rd
            self.release_DataFrames.append(frame.drop(columns=['date']))

    def _generic_grid(self):
        """Adult grid counts from a CSV with columns ``x,y,date,count``
        ((x, y) as in the release CSV).  Optional: omit ``grid_obs_csv``
        from the spec for a site without grid sampling."""
        spec = self._spec
        rd = self.release_date
        name = spec.get('grid_obs_csv')
        if not name:
            self.grid_obs_datesPR = []
            self.grid_obs_DataFrame = pd.DataFrame(
                {'xcoord': pd.Series(dtype=float),
                 'ycoord': pd.Series(dtype=float),
                 'obs_count': pd.Series(dtype=float),
                 'datePR': pd.Series(dtype='timedelta64[ns]')})
            return
        df = self._read_obs_csv(name)
        df = pd.DataFrame({'xcoord': df['x'].astype(float),
                           'ycoord': df['y'].astype(float),
                           'obs_count': df['count'].astype(float),
                           'datePR': [_parse_day(v, rd) - rd
                                      for v in df['date']]})
        df = df.sort_values(['datePR', 'xcoord', 'ycoord'])
        df = df.reset_index(drop=True)
        self.grid_obs_datesPR = [pd.Timedelta(d)
                                 for d in df['datePR'].unique()]
        self.grid_obs_DataFrame = df

    def _generic_card(self):
        """Cardinal-transect counts: per spec ``cardinal`` entry, a CSV with
        columns ``direction,distance,count`` (direction in north/south/east/
        west; distance in meters from the release point — the actual sample
        positions, honored by the observation projections via
        ``card_dists``; the observation date and a nominal step size live
        in the spec entry).  Optional: an absent/empty ``cardinal`` list
        means no transect observations."""
        spec = self._spec
        rd = self.release_date
        self.step_size = []
        self.card_obs_DataFrames = []
        self.card_obs_datesPR = []
        for entry in spec.get('cardinal', []):
            df = self._read_obs_csv(entry['csv'])
            dirs = df['direction'].astype(str).str.strip().str.lower()
            bad = sorted(set(dirs) - {'north', 'south', 'east', 'west'})
            if bad:
                # a silently unmatched direction would vanish from the
                # (4, n) observation array
                raise ValueError(
                    '{}: unknown direction value(s) {} — use north/'
                    'south/east/west'.format(entry['csv'], bad))
            df = pd.DataFrame({'direction': dirs,
                               'distance': df['distance'].astype(float),
                               'obs_count': df['count'].astype(float)})
            dpr = _parse_day(entry['date'], rd) - rd
            df['datePR'] = dpr
            self.step_size.append(int(entry['step_size']))
            self.card_obs_datesPR.append(dpr)
            self.card_obs_DataFrames.append(df)

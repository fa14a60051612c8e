"""Generic site-specification loader.

The reference supports exactly one site's observation data, with the parsing
hard-coded to its xlsx workbooks (Data_Import.py:491-492 raises
``NotImplementedError`` for anything else).  This build keeps the Kalbar
parsers for parity but adds a documented on-ramp for new sites: drop a
``<name>site.json`` spec next to the site's data files and plain-CSV
observation tables, and the whole stack — forward CLI, Bayesian inference,
plotting — runs on ``dataset=<name>`` with no code changes.

Spec file ``{data_dir}/{name}site.json``::

    {
      "site_name": "data/demo",        // file prefix for wind/fields/grid
      "start_time": "00:00",           // first wind reading: 00:00 or 00:30
      "coord": [-27.0, 152.0],         // release point (lat, long)
      "r_dur": 1,                      // release duration, days
      "r_dist": "uniform",             // or explicit weights [0.2, 0.5, 0.3]
      "r_start": null,                 // release time as day fraction
      "r_number": 10000,               // wasps released
      "release_date": "2005-03-13",    // calendar anchor for CSV dates
      "sprd_factor": false,            // fit a pre-wind local-spread day (MAP)
      "releasefield_id": "A",          // field id of the release field
      "grid_rotation_deg": 0.0,        // sampling-grid/road rotation
      "collections": [                 // one entry per collection event
        {"collection_date": 5,
         "sentinel_csv": "demo_sentinel.csv",
         "release_csv": "demo_release.csv"}
      ],
      "grid_obs_csv": "demo_grid.csv", // optional adult grid counts
      "cardinal": [                    // optional transect counts
        {"date": 2, "step_size": 1, "csv": "demo_card.csv"}
      ]
    }

Every date field (``collection_date``, the ``date`` columns of the CSVs,
cardinal ``date``) accepts either an ISO date string (``"2005-03-18"``) or an
integer meaning days post-release.  CSV schemas are documented on the loader
methods in ``io/locinfo.py`` (``LocInfo._generic_*``).
"""

from __future__ import annotations

import json
import os

__all__ = ['load_site_spec', 'site_spec_path', 'scaffold_site', 'main']


def site_spec_path(data_dir, location):
    return os.path.join(data_dir, '{}site.json'.format(location))


def load_site_spec(data_dir, location):
    """Return the parsed ``<location>site.json`` dict, or None if absent."""
    path = site_spec_path(data_dir, location)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def scaffold_site(name, data_dir='data'):
    """Write a template file set for a new site under ``data_dir``:
    the spec with placeholder values, headed (empty) observation CSVs, and
    commented format stubs for the wind/fields/releasegrid files.  Refuses
    to overwrite existing files.  Returns the list of files written."""
    spec = {
        '_edit_me': 'template written by parasitoids_tpu.io.site — every '
                    'value below is a placeholder; format reference: '
                    'parasitoids_tpu/io/site.py and data/README.md',
        # always the runtime location (dataset=<name> resolution looks in
        # ./data), NOT the staging --data-dir these files were written to
        'site_name': 'data/' + name,
        'start_time': '00:00',
        'coord': [-27.0, 152.0],
        'r_dur': 1,
        'r_dist': 'uniform',
        'r_start': None,
        'r_number': 10000,
        'release_date': '2005-03-13',
        'releasefield_id': 'A',
        'grid_rotation_deg': 0.0,
        'sprd_factor': False,
        'collections': [
            {'collection_date': 5,
             'sentinel_csv': '{}_sentinel.csv'.format(name),
             'release_csv': '{}_release.csv'.format(name)}],
        'grid_obs_csv': '{}_grid.csv'.format(name),
        'cardinal': [
            {'date': 3, 'step_size': 1,
             'csv': '{}_card.csv'.format(name)}],
    }
    files = {
        name + 'site.json': json.dumps(spec, indent=2) + '\n',
        name + 'wind.txt':
            '# one row per 30-min reading: day windx windy (m/s)\n'
            '# 1\t0.10\t-0.20\n',
        name + 'fields.txt':
            '# sentinel-field polygons: field id line, then lat,long\n'
            '# vertex lines, blank line between fields\n'
            '# A\n# -27.001,152.001\n# ...\n',
        name + 'releasegrid.txt':
            '# release-field sampling grid\n'
            '# xcoord,ycoord,area,samples,collection  (meters from the\n'
            '# release point, pre-rotation)\n',
        name + '_sentinel.csv': 'id,date,count\n',
        name + '_release.csv': 'x,y,date,count\n',
        name + '_grid.csv': 'x,y,date,count\n',
        name + '_card.csv': 'direction,distance,count\n',
    }
    existing = [f for f in files if os.path.exists(os.path.join(data_dir,
                                                                f))]
    if existing:
        raise FileExistsError(
            'refusing to overwrite existing site files: {}'.format(
                ', '.join(sorted(existing))))
    os.makedirs(data_dir, exist_ok=True)
    written = []
    for fname, content in files.items():
        path = os.path.join(data_dir, fname)
        with open(path, 'w') as f:
            f.write(content)
        written.append(path)
    return written


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog='parasitoids_tpu.io.site',
        description='scaffold the file set for a new site '
                    '(spec + headed CSVs + format stubs)')
    ap.add_argument('name', help='site name (files become data/<name>*)')
    ap.add_argument('--data-dir', default='data')
    args = ap.parse_args(argv)
    for path in scaffold_site(args.name, args.data_dir):
        print('wrote', path)
    if args.data_dir == 'data':
        print('next: fill in the files, then run\n'
              '  python -m parasitoids_tpu --pop dataset={}'.format(
                  args.name))
    else:
        print('NOTE: dataset=<name> resolution looks in ./data — move '
              'these files into data/ before running '
              'dataset={}'.format(args.name))


if __name__ == '__main__':
    main()

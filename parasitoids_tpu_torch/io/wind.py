"""Wind data ingestion and interpolation (L1, host-side).

Semantics match the reference readers (ParasitoidModel.py:64-227): per-30-min
wind vectors keyed by day, linearly interpolated to ``interp_num`` points per
reading with the ``00:00`` / ``00:30`` start-time fencepost conventions, and
wind magnitude recomputed *after* interpolation.  This runs once before any
simulation (it is not under MCMC), so it stays in NumPy; ``pack_wind``
produces the dense ``(ndays, T, 2)`` array the jitted model consumes.
"""

from __future__ import annotations

import numpy as np

_DENOISE = 1e-4  # wind components below this magnitude are zeroed


def read_wind_file(site_name):
    """Parse ``<site_name>wind.txt``.

    Returns ``(wind_data, days)`` where ``wind_data[day]`` is an ``(n, 3)``
    array of (windx, windy, windr) rows and ``days`` is the sorted list of
    day keys.  Components with magnitude below 1e-4 are zeroed, as in the
    reference (ParasitoidModel.py:85-95).
    """
    days_col = []
    rows = []
    path = site_name + 'wind.txt'
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            c = line.find('#')         # comments, as in the fields/grid
            if c >= 0:                 # parsers (scaffolded stubs use them)
                line = line[:c]
            parts = line.split()
            if not parts:
                continue
            try:
                day = int(parts[0])
                windx = float(parts[1])
                windy = float(parts[2])
            except (ValueError, IndexError):
                # new-site onboarding: name the file and line instead of a
                # bare parse traceback
                raise ValueError(
                    '{}:{}: expected "day windx windy" per 30-min reading '
                    '(tab/space separated), got {!r}'.format(
                        path, lineno, line.rstrip('\n'))) from None
            days_col.append(day)
            rows.append((windx, windy))
    if not rows:
        raise ValueError('{}: no wind readings found'.format(path))

    arr = np.array(rows, dtype=np.float64)
    arr[np.abs(arr) < _DENOISE] = 0.0
    windr = np.hypot(arr[:, 0], arr[:, 1])
    windr[windr < _DENOISE] = 0.0
    full = np.column_stack([arr, windr])

    days_col = np.array(days_col)
    days = sorted(set(days_col.tolist()))
    wind_data = {day: full[days_col == day] for day in days}
    return wind_data, days


def _interp_block(a, b, interp_num):
    """Linear ramp from reading ``a`` toward reading ``b`` (exclusive),
    ``interp_num`` points, vectorized over leading reading axis."""
    s = np.linspace(0.0, 1.0, interp_num + 1)[:-1]
    # a,b: (n, 3) -> (n, interp_num, 3)
    return a[:, None, :] * (1.0 - s)[None, :, None] + b[:, None, :] * s[None, :, None]


def get_wind_data(site_name, interp_num, start_time):
    """Read + interpolate wind to ``interp_num`` points per reading.

    Day convention in the output: every day spans 00:00-23:59 with
    ``48 * interp_num`` rows.  ``start_time`` says whether the raw data's
    first reading is at 00:00 or 00:30; the reference's fencepost handling
    (ParasitoidModel.py:156-225) is reproduced exactly, including magnitude
    recomputation after interpolation.
    """
    wind_data_raw, days = read_wind_file(site_name)
    time_pts = wind_data_raw[days[0]].shape[0]
    for day in days:
        if wind_data_raw[day].shape[0] != time_pts:
            raise ValueError(
                '{}wind.txt: day {} has {} readings but day {} has {} — '
                'every day needs the same reading count'.format(
                    site_name, day, wind_data_raw[day].shape[0], days[0],
                    time_pts))

    wind_data = {}
    if start_time == '00:00':
        for n, day in enumerate(days):
            cur = wind_data_raw[day]
            if n < len(days) - 1:
                # interpolate toward the next day's first reading — the
                # NEXT KEY in the sorted day list, not day+1 (a logger
                # outage can leave a gap in day numbers)
                nxt = wind_data_raw[days[n + 1]][0]
                targets = np.vstack([cur[1:], nxt])
                interp = _interp_block(cur, targets, interp_num)
            else:
                # last day: hold the final reading through its period
                targets = np.vstack([cur[1:], cur[-1]])
                interp = _interp_block(cur, targets, interp_num)
                interp[-1, :, :] = cur[-1]
            interp = interp.reshape(time_pts * interp_num, 3)
            interp[:, 2] = np.hypot(interp[:, 0], interp[:, 1])
            wind_data[day] = interp
    elif start_time == '00:30':
        # midnight belongs to the previous day; the first interp block of a
        # day ramps from the previous day's last reading (or holds, day one)
        for n, day in enumerate(days):
            cur = wind_data_raw[day]
            out = np.empty((time_pts * interp_num, 3))
            if n == 0:
                out[:interp_num] = cur[0]
            else:
                prev = wind_data_raw[days[n - 1]][-1]
                out[:interp_num] = _interp_block(
                    prev[None, :], cur[0][None, :], interp_num)[0]
            inner = _interp_block(cur[:-1], cur[1:], interp_num)
            out[interp_num:] = inner.reshape((time_pts - 1) * interp_num, 3)
            out[:, 2] = np.hypot(out[:, 0], out[:, 1])
            wind_data[day] = out
    else:
        raise ValueError("start_time must be either '00:00' or '00:30'")

    return wind_data, days


def pack_wind(wind_data, days, ndays=None):
    """Stack the per-day dict into a dense ``(ndays, T, 2)`` float array of
    (windx, windy) for device consumption.  Magnitude is recomputed on-device
    where needed."""
    if ndays is None:
        ndays = len(days)
    return np.stack([wind_data[day][:, :2] for day in days[:ndays]], axis=0)

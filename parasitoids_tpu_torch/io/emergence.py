"""Observed emergence text-file reader (L1, host-side).

Same format/behavior as the reference (ParasitoidModel.py:28-60):
``<site_name>emergence.txt`` holds a header of field names and rows of
``day count count ...``.
"""

from __future__ import annotations


def emergence_data(site_name):
    """Return ``{field: {day_post_release: count}}``."""
    em = {}
    with open(site_name + 'emergence.txt') as f:
        fields = f.readline().split()[1:]  # drop the '#date' label
        for field in fields:
            em[field] = {}
        for line in f:
            parts = line.split()
            if not parts:
                continue
            date = int(parts[0])
            for field, val in zip(fields, parts[1:]):
                em[field][date] = int(val)
    return em

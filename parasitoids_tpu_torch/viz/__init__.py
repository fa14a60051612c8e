"""Visualization package (L5) — shared matplotlib backend helper."""

import os


def _mpl():
    """Import pyplot, forcing the headless Agg backend when no display is
    present (DISPLAY covers X11, WAYLAND_DISPLAY covers Wayland-only
    sessions).  One definition for every figure-producing module."""
    import matplotlib
    if not (os.environ.get('DISPLAY')
            or os.environ.get('WAYLAND_DISPLAY')):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt

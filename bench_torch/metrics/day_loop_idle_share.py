"""Share of the device's idle time, in the profiled span stretch, while
the day loop (``forward.day_loop``) runs on the host (``spans.py``)."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.share_of_idle(ctx, runner, 'forward.day_loop')

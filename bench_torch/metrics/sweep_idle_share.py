"""Share of the device's idle time, in the profiled span stretch, while
the AM observation sweep (``am.obs_sweep``) runs on the host
(``spans.py``)."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.share_of_idle(ctx, runner, 'am.obs_sweep')

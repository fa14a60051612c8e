"""Host milliseconds a proposal in the AM observation sweep,
``am.obs_sweep`` (span stretch, ``spans.py``)."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['am.obs_sweep'])

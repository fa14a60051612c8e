"""Host milliseconds a unit in the day loop, ``forward.day_loop`` (span
stretch, ``spans.py``); a graphed path runs it only in its captures."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['forward.day_loop'])

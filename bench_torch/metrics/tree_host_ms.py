"""Host milliseconds a value+gradient of the NUTS tree: the self time of
``nuts.transition`` (its host time outside ``nuts.eval``) in the span
stretch (``spans.py``)."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['nuts.transition'], self_time=True)

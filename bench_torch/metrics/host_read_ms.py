"""Host milliseconds a unit in ``model.host_read``, the evaluation's one
device-to-host read: the host waiting on the device work queued before
it (span stretch, ``spans.py``)."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['model.host_read'])

"""Host CUDA launch calls per unit of the cell (``tracing.launches_per``)."""

from bench_torch import tracing


def read(ctx, runner, name):
    return tracing.launches_per(ctx, runner)

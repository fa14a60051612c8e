"""Device milliseconds a unit of the operations launched inside
``solver.propagate``, in the profiled span stretch (the profiler's
launch-to-kernel link, ``spans.py``): the window's own propagation."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.device_ms(ctx, runner, 'solver.propagate')

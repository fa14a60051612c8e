"""Share of the roofline of one day's accumulate through its public entry
('fwd'), in %: the least time of day 9's work at the cell's current
parameters (``roofline.py``) over the CUDA-event time of the entry."""

from bench_torch import tracing


def read(ctx, runner, name):
    return tracing.accum_roofline(ctx, runner, 'fwd')

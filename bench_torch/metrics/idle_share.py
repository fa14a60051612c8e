"""Idle share of the card over a unit: 1 - (device busy seconds per unit,
profiled) / (wall seconds per unit, the unprofiled window of the same
process).  The profiled wall is not the divisor: CUPTI's tracing of graph
replays inflates it several times."""

from bench_torch import tracing


def read(ctx, runner, name):
    prof = tracing.profile(ctx, runner)
    wall = tracing.wall_per_unit(ctx)
    if prof is None or not prof['units'] or not wall:
        return None
    return 1.0 - (prof['busy_s'] / prof['units']) / wall

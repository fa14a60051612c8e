"""The whole unit's share of the card's peak, in %: the least time of the
unit's counted work (every day's accumulates, the propagation's
transforms and their bytes) at the published peaks over the unprofiled
wall per unit."""

from bench_torch import tracing


def read(ctx, runner, name):
    return tracing.unit_mfu(ctx, runner)

"""Milliseconds of ``models/solver.propagate_pop`` on one evaluation's
daily kernels, every release cohort (CUDA events)."""

from bench_torch import tracing


def read(ctx, runner, name):
    return tracing.propagate_ms(ctx, runner)

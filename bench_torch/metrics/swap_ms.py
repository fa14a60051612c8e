"""Host milliseconds a proposal in parallel tempering's swap sweep,
``pt.swap`` (the stack of the replicas' states, the gathers and the
unstack; span stretch, ``spans.py``); None where the program opens no
such span."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['pt.swap'])

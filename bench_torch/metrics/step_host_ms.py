"""Host milliseconds a value+gradient in the MAP optimizers' own work:
the self time of ``map.step`` (its host time outside the ``map.eval``
evaluations: Adam's update, the L-BFGS direction, its line search's
tests and host reads; span stretch, ``spans.py``); None where the
program opens no such span."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['map.step'], self_time=True)

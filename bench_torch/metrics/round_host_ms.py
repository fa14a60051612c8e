"""Host milliseconds a proposal in the round loop's own work: the self
time of ``pt.round`` (its host time outside the replicas' ``am.step``
requests and the ``pt.swap`` sweep: the swap uniforms, the stacking of
traces and the swap counts; span stretch, ``spans.py``); None where the
program opens no such span."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['pt.round'], self_time=True)

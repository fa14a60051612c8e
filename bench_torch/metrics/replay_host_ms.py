"""Host milliseconds a unit in the captured graphs' replays:
``graphs.replay`` (copy-in, replay, clone-out) and ``graphs.replay_bwd``
(a gradient graph's backward, on autograd's thread) in the span stretch
(``spans.py``); None on the CPU, which replays no graph."""

from bench_torch import spans


def read(ctx, runner, name):
    return spans.host_ms(ctx, runner, ['graphs.replay', 'graphs.replay_bwd'])

"""Captured CUDA graphs of the Bayes evaluation: the port's counterpart of
``jax.jit``.

The JAX package dispatches a whole evaluation as one compiled program
(``parasitoids_tpu/models/forward.py`` jits the day scan and the forward,
``bayes/model.py`` the log posterior).  Run eagerly, the port's
evaluation is thousands of small launches from Python, and the card
waits on the host.  Here the evaluation after its host read (the day
loop, the pre-spread day, the propagation and the projections) is
captured once per key as a CUDA graph and replayed after that: one
launch from the host per evaluation.  ``utils/cache.py`` of the JAX
package, the XLA compile cache, has no twin; this module fills its role.

:func:`evaluate` takes a function of tensors (one stacked parameter
vector, and the pre-spread factor where it is given) and its arguments:

* **Key.**  The caller's key (which path, the Genz branches the
  function was built for, the particle count), whether a gradient is
  wanted, which arguments require one, their shapes, device and dtype.
  Each key is captured at its first evaluation.
* **No gradient** (``torch.cuda.graph``).  The function runs once on a
  side stream first, which builds the kernels, the cuFFT plans and every
  cached constant, then once under capture.  A replay copies the
  arguments into the captured inputs, replays and returns clones of the
  captured outputs: a caller may keep a result (a chain keeps its
  projections) while the next replay overwrites the graph's memory.
* **Gradient** (``torch.cuda.make_graphed_callables``).  The forward and
  its backward, the day kernel's K3/K4 included, are captured as two
  graphs inside one autograd node; the likelihood and the priors stay
  eager around it.  The outputs and the gradients it returns are clones.
  A backward reads the intermediates its own forward left in the graph's
  memory, so it must follow its forward before that key's next forward
  replay; one that does not raises rather than return another
  evaluation's gradient.
* **Memory.**  Each key has a memory pool of its own, held while the
  cache lives (a setup's).  A shared pool would let one key's replay
  overwrite another's intermediates, so a value-only evaluation between
  a gradient evaluation's forward and its backward would corrupt that
  gradient.  The price is the sum of the keys' pools, not their maximum
  (about their eager peaks; ``chip_smoke.py`` [21] prints them).
* **Launch counts.**  The wrappers of ``ops/day_kernel.py`` count in
  Python, so a capture counts what it records and a replay counts
  nothing.  :func:`evaluate` takes the warm-up's and the capture's counts
  off again and adds, at each replay, what the capture recorded (at each
  backward replay, what its backward recorded): the counts read as
  eager runs read them.
* **Spans** (``utils/trace.py``).  A replay is ``graphs.replay``
  (copy-in, replay, clone-out), a gradient replay's backward
  ``graphs.replay_bwd`` (from its node's pre-hook to its hook, on
  autograd's thread), a capture ``graphs.capture``, timed by the same
  clock reads as its ``capture_s``.  No Python runs inside a replayed
  graph, so the spans of the day loop and the propagation appear only
  in captures.
* **Failure.**  A capture that fails raises.  Nothing falls back to the
  eager path on the card.  A capture collects Python's garbage first and
  runs with the cyclic collector paused: a dead setup's graphs freed by a
  collection inside a capture would destroy a CUDA graph while a stream
  captures, which ends that capture.
* **Devices.**  A capture runs on its own device and on a side stream of
  that device (``torch.cuda.graph``'s default capture stream lives on the
  device that was current when it was first made), so the copies of a
  setup on several cards each capture and replay their own graphs.

On CPU tensors :func:`evaluate` runs the function itself.  Nothing here
runs at import.
"""

from __future__ import annotations

import gc
import time
from functools import lru_cache
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..ops import day_kernel
from . import trace

__all__ = ['GraphCache', 'evaluate', 'graph_key']

# ops/day_kernel.py's launch counts
_COUNTS = ('LAUNCHES', 'LAUNCHES_BWD', 'LAUNCHES_BATCHED')


def _counts():
    return {k: getattr(day_kernel, k) for k in _COUNTS}


def _since(before):
    now = _counts()
    return {k: now[k] - before[k] for k in _COUNTS}


def _add(counts, sign=1):
    for k, n in counts.items():
        if n:
            day_kernel._count(k, sign * n)


def _pools(device):
    """Bytes the caching allocator holds on ``device``, by graph pool."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get('segment_pool_id', (0, 0)))
        if seg.get('device') == device.index and pool != (0, 0):
            out[pool] = out.get(pool, 0) + seg['total_size']
    return out


@lru_cache(maxsize=None)
def _capture_stream(device):
    """The side stream on which ``device``'s graphs are captured."""
    return torch.cuda.Stream(device)


def graph_key(key, args):
    """The full key of :func:`evaluate`: the caller's ``key``, whether a
    gradient is wanted, and each argument's ``requires_grad``, shape,
    device and dtype."""
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    return (tuple(key), grad,
            tuple((a.requires_grad and grad, tuple(a.shape), str(a.device),
                   str(a.dtype)) for a in args))


class _Entry(NamedTuple):
    """One captured key: its replay function and what the capture cost
    (host seconds, warm-up included, and graph-pool bytes)."""
    replay: object
    capture_s: float
    pool_bytes: int


class GraphCache:
    """The captured graphs of one setup, by :func:`graph_key`."""

    def __init__(self):
        self.entries = {}

    def summary(self):
        """``[(key, capture seconds, pool bytes)]`` of every capture."""
        return [(k, e.capture_s, e.pool_bytes)
                for k, e in self.entries.items()]


def _warm_up(fn, args, grad):
    """One run of ``fn`` (and its backward) on a side stream, so that
    nothing it builds the first time is built under capture."""
    dev = args[0].device
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        out = [o for o in tree_leaves(fn(*args)) if o.requires_grad]
        if grad:
            torch.autograd.grad(out, [a for a in args if a.requires_grad],
                                [torch.zeros_like(o) for o in out])
    torch.cuda.current_stream(dev).wait_stream(stream)


def _capture_forward(fn, static):
    graph = torch.cuda.CUDAGraph()
    dev = static[0].device
    with torch.no_grad():
        before = _counts()
        with torch.cuda.graph(graph, stream=_capture_stream(dev)):
            out = fn(*static)
        launches = _since(before)

    def replay(args):
        with trace.span('graphs.replay'):
            for s, a in zip(static, args):
                s.copy_(a)
            with torch.cuda.device(dev):
                graph.replay()
            _add(launches)
            return tree_map(torch.clone, out)
    return replay


def _capture_grad(fn, static):
    before = _counts()
    # make_graphed_callables captures on torch.cuda.graph's default stream
    default = torch.cuda.graph.default_capture_stream
    torch.cuda.graph.default_capture_stream = _capture_stream(
        static[0].device)
    try:
        graphed = torch.cuda.make_graphed_callables(fn, tuple(static),
                                                    num_warmup_iters=0)
    finally:
        torch.cuda.graph.default_capture_stream = default
    captured = _since(before)
    launches_bwd = {'LAUNCHES_BWD': captured.pop('LAUNCHES_BWD')}
    launches = dict(captured, LAUNCHES_BWD=0)
    generation = [0]

    def replay(args):
        generation[0] += 1
        mine = generation[0]
        with trace.span('graphs.replay'):
            with torch.cuda.device(args[0].device):
                out = graphed(*args)
            _add(launches)
            node = next(o.grad_fn for o in tree_leaves(out)
                        if o.grad_fn is not None)
            bwd = [None]        # the backward's span, on autograd's thread

            def before_backward(grads):
                if generation[0] != mine:
                    raise RuntimeError(
                        'a backward through a captured graph must follow '
                        'its forward before that graph is replayed again: '
                        '{} replays came between'.format(
                            generation[0] - mine))
                bwd[0] = trace.begin('graphs.replay_bwd')
                _add(launches_bwd)

            def after_backward(grad_in, grad_out):
                out = tuple(None if g is None else g.clone() for g in grad_in)
                trace.end(bwd[0])
                return out

            node.register_prehook(before_backward)
            node.register_hook(after_backward)
            return tree_map(torch.clone, out)
    return replay


def evaluate(cache: GraphCache, key, fn, args):
    """``fn(*args)`` through the captured graph of ``(key, args)``
    (:func:`graph_key`), captured first where it is new.  ``fn`` takes
    tensors and returns a structure of tensors; ``args`` are tensors on
    one device.  On CPU tensors ``fn`` runs as it is."""
    args = tuple(args)
    if args[0].device.type != 'cuda':
        return fn(*args)
    full = graph_key(key, args)
    entry = cache.entries.get(full)
    if entry is None:
        grad = full[1]
        dev = args[0].device
        static = [a.detach().clone().requires_grad_(a.requires_grad and grad)
                  for a in args]
        before = _counts()
        pools = _pools(dev)
        # one pair of clock reads: the capture's span and its capture_s
        tic = time.perf_counter_ns()
        span = trace.begin('graphs.capture', tic)
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.device(dev):
                _warm_up(fn, static, grad)
                capture = _capture_grad if grad else _capture_forward
                replay = capture(fn, static)
                torch.cuda.synchronize(dev)
        finally:
            if collecting:
                gc.enable()
            _add(_since(before), -1)
            toc = time.perf_counter_ns()
            trace.end(span, toc)
        entry = _Entry(replay, (toc - tic) * 1e-9, sum(
            n for p, n in _pools(dev).items() if p not in pools))
        cache.entries[full] = entry
    return entry.replay(args)

"""Spans at the port's layer boundaries: where a unit of work spends its
host time, on the same clock as the device trace.

A span names one stretch of host work: a sampler's unit (a request:
``nuts.transition``, ``am.step``, ``ensemble.member``), the likelihood's
parts, a graph's replay or capture, the day loop, the propagation.
Tracing is off by default.  While it is off, :func:`span` returns one
module-level null context: it allocates nothing, reads no clock and
touches no tensor.  While it is on, a span records its name, its start
and end (``time.perf_counter_ns``), its parent (from a thread-local
stack), its thread and the request it belongs to.  A request's id is
process-global, because one request is in flight at a time: a span that
autograd's device thread opens inside a request carries its id.  Inside
a ``torch.profiler`` session a span also enters
``torch.profiler.record_function(name)``, so it sits in the profiler's
trace beside the kernels.  A span never synchronizes and calls nothing
on the device.

The records stay in memory, at most :data:`LIMIT` of them (later ones
are counted as dropped).  :func:`summary` gives, per name, the count, the
total and self seconds (the duration less what the span's children
cover) and the total seconds of each request.  The benchmark
(``bench_torch/spans.py``) is the only reader.

Spans that open and close in separate callbacks (a graph's backward,
from its node's pre-hook to its hook) use :func:`begin` and :func:`end`,
which also take a clock reading that the caller shares with its own
timer (a graph's capture).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

__all__ = ['NULL', 'span', 'begin', 'end', 'enable', 'disable', 'clear',
           'records', 'summary']

#: the most records kept; later spans are counted as dropped
LIMIT = 1 << 20

#: what :func:`span` returns while tracing is off
NULL = contextlib.nullcontext()

_on = False
_records = []
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)
_request = None


class Record:
    """One finished span; times in ``time.perf_counter_ns`` nanoseconds."""
    __slots__ = ('id', 'name', 'start', 'end', 'parent', 'thread',
                 'request')

    def __init__(self, id, name, start, parent, thread, request):
        self.id, self.name, self.start = id, name, start
        self.end = None
        self.parent, self.thread, self.request = parent, thread, request

    @property
    def seconds(self):
        return (self.end - self.start) * 1e-9


class _Token:
    __slots__ = ('record', 'outer_request', 'opens_request', 'profiled')


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def begin(name, t_ns=None, request=False):
    """Open the span ``name`` (at ``t_ns`` where the caller read the clock
    itself); ``request``: it opens a request, which its children join.
    Returns the token :func:`end` takes, or None while tracing is off."""
    global _request
    if not _on:
        return None
    tok = _Token()
    tok.opens_request = request
    tok.outer_request = _request
    if request:
        _request = next(_requests)
    stack = _stack()
    tok.record = Record(next(_ids), name, 0, stack[-1].id if stack else None,
                        threading.get_ident(), _request)
    stack.append(tok.record)
    tok.profiled = None
    if torch.autograd._profiler_enabled():
        tok.profiled = torch.autograd.profiler.record_function(name)
        tok.profiled.__enter__()
    tok.record.start = time.perf_counter_ns() if t_ns is None else t_ns
    return tok


def end(tok, t_ns=None, keep=True):
    """Close the span ``tok`` (a :func:`begin` token, or None: nothing);
    ``keep=False`` closes it without a record (the work it would have
    named did not run)."""
    global _dropped, _request
    if tok is None:
        return
    rec = tok.record
    rec.end = time.perf_counter_ns() if t_ns is None else t_ns
    if tok.profiled is not None:
        tok.profiled.__exit__(None, None, None)
    stack = _stack()
    if stack and stack[-1] is rec:
        stack.pop()
    elif rec in stack:
        stack.remove(rec)
    if tok.opens_request:
        _request = tok.outer_request
    if keep:
        with _lock:
            if len(_records) < LIMIT:
                _records.append(rec)
            else:
                _dropped += 1


class _Span:
    __slots__ = ('name', 'request', 'tok')

    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        self.tok = begin(self.name, request=self.request)
        return self

    def __exit__(self, *exc):
        end(self.tok)
        return False


def span(name, request=False):
    """A context manager around one span (:func:`begin`, :func:`end`);
    :data:`NULL` while tracing is off."""
    if not _on:
        return NULL
    return _Span(name, request)


def enable():
    """Turn tracing on."""
    global _on
    _on = True


def disable():
    """Turn tracing off; spans open now still close and record."""
    global _on
    _on = False


def clear():
    """Forget every record and the count of dropped ones."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def records():
    """The finished spans kept so far, in the order they closed."""
    with _lock:
        return list(_records)


def _covered(intervals, lo, hi):
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    total, reach = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def summary():
    """``{'dropped': n, 'spans': {name: {'count', 'total_s', 'self_s',
    'by_request': {request id: total seconds}}}}`` over the records kept;
    a span's self time is its duration less the union of its children's
    intervals within it."""
    recs = records()
    children = {}
    for r in recs:
        if r.parent is not None:
            children.setdefault(r.parent, []).append((r.start, r.end))
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {'count': 0, 'total_s': 0.0,
                                    'self_s': 0.0, 'by_request': {}})
        covered = _covered(children.get(r.id, ()), r.start, r.end)
        s['count'] += 1
        s['total_s'] += r.seconds
        s['self_s'] += (r.end - r.start - covered) * 1e-9
        if r.request is not None:
            s['by_request'][r.request] = (s['by_request'].get(r.request, 0.0)
                                          + r.seconds)
    return {'dropped': _dropped, 'spans': out}

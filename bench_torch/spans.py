"""The program's own spans (``parasitoids_tpu_torch/utils/trace.py``), read
for the span metrics of a traced run (``--trace 1``) over two stretches
of units after the window:

* the **span stretch**: tracing on and no profiler, in a fresh process
  of the same cell and seed (this file run as a script, with the run's
  own arguments), since the traced run has profiled the card by the time
  a span metric is read and a ``torch.profiler`` session may leave the
  process's later host work slower; it runs at least ``trace_units``
  units and :data:`SPAN_SECONDS`, and the ``*_ms`` readers take a span's
  host time per unit from it.  That process holds a second copy of the
  cell on the card while it runs;
* the **profiled span stretch** (on the card, in the run's own process):
  tracing and ``torch.profiler`` (CPU and CUDA) on, each span a host
  event of the profile.  The device's idle time (the stretch less the
  union of its device operations) is split at the spans' boundaries,
  each piece credited to the innermost span open then (the one that
  opened last, on any thread) or to "outside"; a span's device time is
  that of the operations launched inside it (the profiler's
  launch-to-kernel link).  CUPTI inflates host time here, so the readers
  take shares of the idle time from it, not seconds.

Each stretch prints its table on standard error; reading either takes
both.  Every reading is memoised in the run's context.  A program
without the recorder, or a span it never opened, reads None.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

OUTSIDE = 'outside any span'
WINDOW = 'bench.spans.stretch'     # the profiled stretch, as a host event
SPAN_SECONDS = 3.0                 # the span stretch's least length
CHILD_TIMEOUT = 900                # seconds the span stretch's process may take


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from parasitoids_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _stretch(ctx, runner, seconds=0.0):
    """Units until ``trace_units`` have run and ``seconds`` have passed,
    the device drained: the units."""
    want = int(ctx.traffic['trace_units'])
    units = 0
    tic = time.perf_counter()
    while units < want or time.perf_counter() - tic < seconds:
        units += runner.unit()
    ctx.sync()
    return units


def host(ctx, runner):
    """The span stretch: ``{'units', 'spans': trace.summary()['spans'],
    'dropped', 'process_s'}`` (the last the seconds its process took),
    or None without the recorder.  Taking it takes the profiled stretch
    too, so that a traced run prints both tables."""
    return ctx.memo('spans.host', lambda: _host(ctx, runner))


def _host(ctx, runner):
    if recorder() is None:
        return None
    a = ctx.args
    argv = ['--workload', a.workload, '--seed', str(a.seed), '--seconds',
            str(a.seconds), '--trace', str(a.trace)]
    if a.rehearse is not None:
        argv += ['--rehearse', str(a.rehearse)]
    tic = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__)] + argv,
        stdout=subprocess.PIPE, text=True, timeout=CHILD_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines:
        print('spans: the span stretch\'s process ended with {}'.format(
            proc.returncode), file=sys.stderr)
        return None
    out = dict(json.loads(lines[-1]), process_s=time.perf_counter() - tic)
    print_host(out)
    idle(ctx, runner)
    return out


def span_stretch(ctx, runner):
    """Tracing on over :func:`_stretch`: ``trace.summary()`` with the
    units."""
    trace = recorder()
    ctx.sync()
    trace.clear()
    trace.enable()
    try:
        units = _stretch(ctx, runner, SPAN_SECONDS)
    finally:
        trace.disable()
    out = dict(trace.summary(), units=units)
    trace.clear()
    return out


def host_ms(ctx, runner, names, self_time=False):
    """Milliseconds a unit of the spans ``names`` together (total time, or
    with ``self_time`` their self time) in the span stretch; None where
    none of them ran."""
    read = host(ctx, runner)
    if read is None or not read['units']:
        return None
    spans = [read['spans'][n] for n in names if n in read['spans']]
    if not spans:
        return None
    key = 'self_s' if self_time else 'total_s'
    return 1e3 * sum(s[key] for s in spans) / read['units']


def idle(ctx, runner):
    """The profiled span stretch on the card: ``{'units', 'window_s',
    'idle_s', 'credit': {span or OUTSIDE: idle s}, 'under': {span: idle s
    while it is open}, 'device': {span: device s launched inside}}``;
    None on the CPU or without the recorder."""
    if ctx.device.type != 'cuda':
        return None
    return ctx.memo('spans.idle', lambda: _idle(ctx, runner))


def _idle(ctx, runner):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    trace = recorder()
    if trace is None:
        return None
    ctx.sync()
    trace.clear()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                units = _stretch(ctx, runner)
    finally:
        trace.disable()
    names = {r.name for r in trace.records()}
    trace.clear()
    events = list(prof.events())
    window = [e for e in events if e.name == WINDOW]
    if not window or not units:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    # a span is also a device-side annotation of its name, over the
    # device work inside it: not an operation of the device
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA and
                 e.name not in names and e.name != WINDOW)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CPU and e.name in names]
    gaps = idle_gaps(dev, w0, w1)
    credit, under = split_idle(gaps, spans)
    out = {'units': units, 'window_s': (w1 - w0) * 1e-6,
           'idle_s': sum(b - a for a, b in gaps) * 1e-6,
           'credit': {k: v * 1e-6 for k, v in credit.items()},
           'under': {k: v * 1e-6 for k, v in under.items()},
           'device': {k: v * 1e-6 for k, v in
                      device_under(events, names).items()}}
    print_idle(out)
    return out


def idle_gaps(dev, w0, w1):
    """The stretches of ``[w0, w1]`` that no interval of ``dev`` (sorted
    ``(start, end)``) covers."""
    gaps, reach = [], w0
    for s, e in dev:
        if s > reach:
            gaps.append((reach, min(s, w1)))
        reach = max(reach, e)
        if reach >= w1:
            break
    if reach < w1:
        gaps.append((reach, w1))
    return [(a, b) for a, b in gaps if b > a]


def split_idle(gaps, spans):
    """``(credit, under)`` of the idle ``gaps`` against the host
    ``spans`` (``(start, end, name)``): each piece of a gap credited to
    the innermost open span (the latest to open) or to :data:`OUTSIDE`,
    and, per name, the idle time while a span of that name is open."""
    points = [(s, 1, i) for i, (s, _, _) in enumerate(spans)]
    points += [(e, 0, i) for i, (_, e, _) in enumerate(spans)]
    points += [(a, 3, -1) for a, _ in gaps] + [(b, 2, -1) for _, b in gaps]
    points.sort()
    credit, under, open_, in_gap, last = {}, {}, {}, False, None
    for t, kind, i in points:
        if in_gap and last is not None and t > last:
            piece = t - last
            if open_:
                inner = max(open_, key=lambda j: (spans[j][0], j))
                name = spans[inner][2]
            else:
                name = OUTSIDE
            credit[name] = credit.get(name, 0.0) + piece
            for n in {spans[j][2] for j in open_}:
                under[n] = under.get(n, 0.0) + piece
        last = t
        if kind == 1:
            open_[i] = True
        elif kind == 0:
            open_.pop(i, None)
        else:
            in_gap = kind == 3
    return credit, under


def device_under(events, names):
    """Device microseconds, per span name, of the operations launched by
    host events inside a span of that name (a host event's ``kernels``
    are the device operations the profiler links to its launches)."""
    out = {}
    for e in events:
        kernels = getattr(e, 'kernels', None)
        if not kernels:
            continue
        us = sum(k.duration for k in kernels)
        seen, p = set(), e
        while p is not None:
            if p.name in names:
                seen.add(p.name)
            p = p.cpu_parent
        for n in seen:
            out[n] = out.get(n, 0.0) + us
    return out


def share_of_idle(ctx, runner, name):
    """The share of the profiled stretch's device idle time while the span
    ``name`` is open; None where it never was."""
    read = idle(ctx, runner)
    if read is None or not read['idle_s'] or name not in read['under']:
        return None
    return read['under'][name] / read['idle_s']


def device_ms(ctx, runner, name):
    """Device milliseconds a unit of the operations launched inside the
    span ``name``; None where nothing was linked to it."""
    read = idle(ctx, runner)
    if read is None or not read['device'].get(name):
        return None
    return 1e3 * read['device'][name] / read['units']


def print_host(read):
    u = read['units']
    print('spans, host ms a unit over {} units (no profiler, in a process '
          'of its own that took {:.1f} s; {} dropped): name, count a unit, '
          'total, self, most in one request'.format(
              u, read['process_s'], read['dropped']), file=sys.stderr)
    for name, s in sorted(read['spans'].items(),
                          key=lambda kv: -kv[1]['total_s']):
        most = max(s['by_request'].values(), default=0.0)
        print('  {:<20s} {:10.4f} {:10.4f} {:10.4f} {:10.4f}'.format(
            name, s['count'] / u, 1e3 * s['total_s'] / u,
            1e3 * s['self_s'] / u, 1e3 * most), file=sys.stderr)


def print_idle(read):
    u, idle_s = read['units'], read['idle_s']
    print('device idle by span, profiled stretch of {} units: {:.6f} s idle '
          'of {:.6f} s; name, idle ms a unit (innermost), share of idle, '
          'idle ms a unit while open, device ms a unit launched '
          'inside'.format(u, idle_s, read['window_s']), file=sys.stderr)
    for name in sorted(set(read['credit']) | set(read['device']),
                       key=lambda n: -read['credit'].get(n, 0.0)):
        c = read['credit'].get(name, 0.0)
        print('  {:<20s} {:10.4f} {:8.4f} {:10.4f} {:10.4f}'.format(
            name, 1e3 * c / u, c / idle_s if idle_s else 0.0,
            1e3 * read['under'].get(name, 0.0) / u,
            1e3 * read['device'].get(name, 0.0) / u), file=sys.stderr)


def _child(argv):
    """The span stretch in a process of its own: the cell's runner built
    from the run's arguments as ``harness._main`` builds it, then
    :func:`span_stretch`, printed as one JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from bench_torch import harness
    import torch
    args = harness.parse(argv)
    bench = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())
    cell = harness.Cell(bench, args.workload)
    if args.rehearse is None:
        device = torch.device('cuda', 0)
    else:
        device = torch.device('cpu')
        torch.set_num_threads(4)
        cell.traffic.update(cell.rehearsal)
    harness.set_cache_dirs()
    ctx = harness.Context(cell, args, device)
    runner = harness.load_module(cell.runner_path, 'bench_runner').Runner(ctx)
    harness.check_imports()
    print(json.dumps(span_stretch(ctx, runner)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(_child(sys.argv[1:]))

"""The benchmark's general machinery: it finds a cell's pieces by name,
sets up, runs the measured window, reads the per-layer metrics, decides
``correct`` and prints the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
Everything else is found by name under ``bench_torch/``:

* ``configs/<config>.json``: the configuration as it is run (the file
  that ``BENCHMARK.json`` names): how the program builds it (``build``)
  and its sizes (``sizes``), which the harness holds the built setup to;
* ``traffic/<mix>.json``: the mix's parameters, and the ``runner`` that
  reads them;
* ``runners/<runner>.py``: a general runner of one kind of work (a NUTS
  chain, an AM chain, a forecast ensemble, batched SMC moves): set-up,
  one unit of work, the answers its comparison takes;
* ``limits/<workload>.json``: each compared number's limit in the cell,
  and where answers are left out as ill-conditioned, the level;
* ``metrics/<metric>.py``, else ``metrics/<name before the first
  dot>.py``: the reader of a per-layer metric;
* ``reference/``: the plain reference the answers are compared with.

Nothing here imports JAX or the JAX package, and the run checks that.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a bad cell)."""


def parse(argv):
    ap = argparse.ArgumentParser(prog='bench_torch/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--rehearse', type=int, default=None, metavar='R',
                    help='run on the CPU at (2R+1)^2 cells (tests only: '
                         'no measurement)')
    return ap.parse_args(argv)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(entries, name, what):
    for e in entries:
        if e['name'] == name:
            return e
    raise BenchError('no {} named {!r} in BENCHMARK.json'.format(what, name))


class Cell:
    """A workload with its configuration, traffic, limits and metrics, all
    read from files found by name."""

    def __init__(self, bench, name, root=ROOT):
        self.bench = bench
        self.work = find(bench['workloads'], name, 'workload')
        self.name = name
        entry = find(bench['configs'], self.work['config'], 'configuration')
        self.config = json.loads((root / entry['file']).read_text())
        here = root / 'bench_torch'
        self.traffic = json.loads(
            (here / 'traffic' / (self.work['traffic'] + '.json')).read_text())
        self.rehearsal = self.traffic.pop('rehearse', {})
        self.limits = json.loads(
            (here / 'limits' / (name + '.json')).read_text())
        # per compared number, the float32 reference's gap above which an
        # answer is ill-conditioned and left out of it
        self.ill = self.limits.get('ill_conditioned', {})
        self.runner_path = here / 'runners' / (self.traffic['runner'] + '.py')
        self.metrics_dir = here / 'metrics'

        def mine(m):
            return name in m.get('workloads', [name])
        self.end_to_end = [m for m in bench['end_to_end'] if mine(m)]
        self.per_layer = [m for m in bench['per_layer'] if mine(m)]

    def reader(self, metric):
        for stem in (metric, metric.split('.')[0]):
            path = self.metrics_dir / (stem + '.py')
            if path.exists():
                return load_module(path, 'bench_metric_' +
                                   stem.replace('.', '_')).read
        raise BenchError('no reader for the metric {!r}'.format(metric))


def check_imports():
    """Neither JAX nor the JAX package was imported."""
    bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')
                 or k == 'parasitoids_tpu' or k.startswith('parasitoids_tpu.'))
    if bad:
        raise BenchError('imported {}: the benchmark runs the PyTorch port '
                         'only'.format(bad[:5]))


def card_info():
    """The card's name, power limit and SM clocks from nvidia-smi."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
             'clocks.max.sm', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi not readable'


def set_cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / 'build' / 'bench_cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')


class Context:
    """What a runner and the metric readers share in one run."""

    def __init__(self, cell, args, device):
        import torch
        self.torch = torch
        self.cell, self.args, self.device = cell, args, device
        self.seed = args.seed
        self.config = cell.config
        self.traffic = cell.traffic
        self.rehearse = args.rehearse
        self.cache = {}

    def sync(self):
        if self.device.type == 'cuda':
            self.torch.cuda.synchronize(self.device)

    def memo(self, key, fn):
        """``fn()`` once per run under ``key`` (profiles and timings that
        several readers share)."""
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]


def run_window(runner, ctx, seconds):
    """Units back to back until ``seconds`` have passed, the device
    drained at the end: ``(units, attempts, window seconds)``."""
    units = attempts = 0
    ctx.sync()
    tic = time.perf_counter()
    while time.perf_counter() - tic < seconds:
        units += runner.unit()
        attempts += 1
    ctx.sync()
    return units, attempts, time.perf_counter() - tic


def decide(checks, limits):
    """``(correct, checks with their limits)``: every number that has a
    limit at or under it, and none missing or not finite.  A dotted name
    (``<name>.median``, ``<name>.excluded``) is shown, and compared only
    where the cell's limits name it; every other number needs a limit."""
    out = {}
    ok = True
    for name, limit in limits.items():
        value = checks.get(name)
        good = (value is not None and math.isfinite(value) and value <= limit)
        ok = ok and good
        out[name] = {'value': value, 'limit': limit}
    missing = {k for k in checks if '.' not in k} - set(limits)
    if missing:
        raise BenchError('numbers compared with no limit: {}'.format(
            sorted(missing)))
    return ok, out


def main(argv, t0):
    args = parse(argv)
    try:
        return _main(args, t0)
    except BenchError as e:
        print('bench_torch: {}'.format(e), file=sys.stderr)
        return 2


def _main(args, t0):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cell = Cell(bench, args.workload)
    import torch
    if args.rehearse is None:
        if not torch.cuda.is_available():
            raise BenchError('no CUDA device visible to torch')
        if torch.cuda.device_count() < cell.work['chips']:
            raise BenchError('the cell needs {} cards, {} visible'.format(
                cell.work['chips'], torch.cuda.device_count()))
        device = torch.device('cuda', 0)
    else:
        device = torch.device('cpu')
        torch.set_num_threads(4)
        cell.traffic.update(cell.rehearsal)
    set_cache_dirs()
    ctx = Context(cell, args, device)
    runner = load_module(cell.runner_path, 'bench_runner').Runner(ctx)
    check_imports()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    counters0 = runner.counters()
    units, attempts, window_s = run_window(runner, ctx, args.seconds)
    counters = {k: v - counters0[k] for k, v in runner.counters().items()}
    ctx.window = dict(units=units, attempts=attempts, seconds=window_s,
                      counters=counters)
    rate = {'value': units / window_s, 'unit': cell.traffic['unit']}
    e2e = {}
    for m in cell.end_to_end:
        if m['name'] == 'setup_s':
            e2e['setup_s'] = {'value': setup_s, 'unit': m['unit']}
        elif m['name'] == cell.traffic['metric']:
            e2e[m['name']] = rate
        else:
            raise BenchError('the cell reports no end-to-end metric '
                             '{!r}'.format(m['name']))

    metrics, breakdown, device_extra = e2e, None, {}
    if args.trace:
        from bench_torch import tracing
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m['name'])(ctx, runner, m['name'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        prof = tracing.profile(ctx, runner)
        if prof is not None:
            breakdown = prof['breakdown']
            device_extra = {'busy_s': prof['busy_s'],
                            'window_s': prof['window_s']}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    counts = dict(runner.counts(), units=units, attempts=attempts,
                  window_s=window_s, setup_s=setup_s,
                  memory_peak_bytes=peak, card=(
                      card_info() if device.type == 'cuda' else 'cpu'))
    print(json.dumps({'counts': counts}), flush=True)

    items, data = runner.answers(), runner.site_data()
    runner.free()
    checks = compare(ctx, runner, items, data)
    correct, shown = decide(checks, cell.limits['limits'])
    check_imports()
    for name, value in checks.items():
        if name.endswith(('.excluded', '.count', '.min')):
            print('shown {}: {!r}'.format(name, value), file=sys.stderr)
    for name, c in shown.items():
        print('compared {}: {!r} (limit {!r})'.format(name, c['value'],
                                                      c['limit']),
              file=sys.stderr)
    line = {'correct': correct, 'attempted': attempts, 'failed': 0,
            'metrics': metrics,
            'device': dict({
                'platform': 'gpu' if device.type == 'cuda' else 'cpu',
                'kind': (torch.cuda.get_device_name(device)
                         if device.type == 'cuda' else 'cpu'),
                'count': 1, 'memory_peak_bytes': peak}, **device_extra)}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['compared'] = shown
    print(json.dumps(line), flush=True)
    return 0


def references(ctx, data, f32=False, control=False):
    """The references the answers are compared with, built from the
    site's ``data``: ``ref``, the plain reference in float64; with
    ``f32``, ``f32``, the same in plain float32 (TF32 off), whose gap at
    an answer reads that answer's own float32 conditioning; with
    ``control``, ``control``, the reference in float32 with its products'
    operands rounded to TF32, put in the program's place."""
    from bench_torch.reference import model as reference
    torch = ctx.torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = {'ref': reference.build(data, torch.float64, ctx.device)}
    if f32:
        refs['f32'] = reference.build(data, torch.float32, ctx.device)
    if control:
        refs['control'] = reference.build(data, torch.float32, ctx.device,
                                          tf32=True)
    return refs


def compare(ctx, runner, items, data):
    """The compared numbers of ``items`` (a runner's answers) against the
    references; the float32 one runs where the cell's limits leave
    ill-conditioned answers out."""
    from bench_torch import program
    refs = references(ctx, data, f32=bool(program.ill_levels(ctx)))
    return runner.compare(items, refs)

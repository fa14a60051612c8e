"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed a short window of the cell's traffic, then
the comparison of its answers with the float64 reference (the program's
reading, the lower one), of the control's answers at the same points
(the reference in float32 with its products' operands rounded to TF32,
the upper one) and of the plain float32 reference's (the level above
which an answer is ill-conditioned).  Each seed's program numbers and
control numbers go through the harness's own decision against the
cell's limits.  ``--fault`` plants one of ``faults.py``'s faults first,
for the readings of a fault.  All seeds in one process, one setup.

    python3 bench_torch/control.py --workload kalbar801-am \\
        --seeds 101,102,103 --seconds 5 [--control-seeds 101,102] \\
        [--fault grad_scaled]

Prints one JSON line a seed; the benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import faults, harness, program  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog='bench_torch/control.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default=None)
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--fault', choices=faults.NAMES, default=None)
    ap.add_argument('--rehearse', type=int, default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',')]
    ctl_seeds = (set(seeds) if args.control_seeds is None else
                 {int(s) for s in args.control_seeds.split(',')})
    import torch
    bench = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())
    cell = harness.Cell(bench, args.workload)
    if args.rehearse is None:
        device = torch.device('cuda', 0)
    else:
        device = torch.device('cpu')
        cell.traffic.update(cell.rehearsal)
    harness.set_cache_dirs()
    if args.fault:
        faults.plant(args.fault)
    limits = cell.limits['limits']
    shared, refs = {}, {}
    for seed in seeds:
        run = argparse.Namespace(seed=seed, rehearse=args.rehearse)
        ctx = harness.Context(cell, run, device)
        ctx.shared = shared
        runner = harness.load_module(cell.runner_path,
                                     'bench_runner').Runner(ctx)
        units, attempts, window_s = harness.run_window(runner, ctx,
                                                       args.seconds)
        ctx.window = dict(units=units, attempts=attempts, seconds=window_s,
                          counters={})
        items, data = runner.answers(), runner.site_data()
        if not refs:
            refs.update(harness.references(
                ctx, data, f32=bool(program.ill_levels(ctx)), control=True))
        use = {k: v for k, v in refs.items()
               if k != 'control' or seed in ctl_seeds}
        checks = runner.compare(items, use)
        harness.check_imports()
        numbers = {k: checks.get(k) for k in limits}
        line = {'workload': args.workload, 'seed': seed,
                'fault': args.fault, 'units': units, 'window_s': window_s,
                'correct': harness.decide(numbers, limits)[0]}
        if 'control' in use:
            line['control_correct'] = harness.decide(
                {k: checks.get(k + '.control', checks.get(k))
                 for k in limits}, limits)[0]
        line.update(checks=checks, elapsed_s=time.perf_counter() - T0)
        print(json.dumps(line), flush=True)
        del runner, items
    return 0


if __name__ == '__main__':
    sys.exit(main())

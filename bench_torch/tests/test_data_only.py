"""A later change adds a cell as data: a configuration, a traffic mix, a
metric reader and the cell's limits as new files, and a ``workloads``
entry, editing no file the benchmark has.  Here that is done in a copy of
the benchmark in a temporary directory, and the new cell runs there."""

import hashlib
import json
import os
import shutil

from conftest import ROOT, run_cell


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted((root / 'bench_torch').rglob('*'))
            if p.is_file() and '__pycache__' not in p.parts}


def test_a_cell_added_as_files_runs(tmp_path):
    shutil.copytree(ROOT / 'bench_torch', tmp_path / 'bench_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    for name in ('parasitoids_tpu_torch', 'data'):
        os.symlink(ROOT / name, tmp_path / name)
    before = digest(tmp_path)
    b = tmp_path / 'bench_torch'
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())

    config = json.loads((b / 'configs' / 'kalbar801.json').read_text())
    config['name'] = 'kalbar801-copy'
    (b / 'configs' / 'kalbar801_copy.json').write_text(json.dumps(config))
    (b / 'traffic' / 'am_short.json').write_text(json.dumps({
        'runner': 'am', 'metric': 'proposals_per_s', 'unit': 'proposals/s',
        'chunk': 10, 'compare': 2, 'trace_units': 10}))
    (b / 'metrics' / 'steps_per_unit.py').write_text(
        'def read(ctx, runner, name):\n'
        '    w = ctx.window\n'
        '    return w["units"] / w["attempts"]\n')
    (b / 'limits' / 'kalbar-copy-am.json').write_text(json.dumps(json.loads(
        (b / 'limits' / 'kalbar801-am.json').read_text())))
    bench['configs'].append({
        'name': 'kalbar801-copy', 'source': 'the kalbar801 configuration',
        'file': 'bench_torch/configs/kalbar801_copy.json', 'reduced': [],
        'why': 'a throwaway copy'})
    bench['workloads'].append({
        'name': 'kalbar-copy-am', 'config': 'kalbar801-copy',
        'traffic': 'am_short', 'chips': 1, 'why': 'a throwaway cell'})
    for m in bench['end_to_end']:
        if m['name'] == 'proposals_per_s':
            m['workloads'].append('kalbar-copy-am')
    bench['per_layer'].append({
        'name': 'steps_per_unit.copy', 'unit': 'steps', 'better': 'higher',
        'source': 'program_counter', 'layer': 'AM step',
        'moves': 'proposals_per_s', 'workloads': ['kalbar-copy-am']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    after = digest(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    rc, line, err = run_cell('kalbar-copy-am', cwd=tmp_path)
    assert rc == 0, err[-3000:]
    assert line['correct'] and set(line['metrics']) == {
        'setup_s', 'proposals_per_s'}
    rc, line, err = run_cell('kalbar-copy-am', cwd=tmp_path, trace=1)
    assert rc == 0, err[-3000:]
    assert line['metrics'] == {'steps_per_unit.copy': {
        'value': 10.0, 'unit': 'steps'}}


def test_only_the_benchmarks_files_give_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and bench_torch/: no
    program, so no result line."""
    shutil.copytree(ROOT / 'bench_torch', tmp_path / 'bench_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    rc, line, _ = run_cell('kalbar801-am', cwd=tmp_path,
                           env={'PYTHONPATH': ''})
    assert rc != 0 and line is None

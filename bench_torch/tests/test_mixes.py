"""Every cell's traffic mix end to end on the CPU at 81² (a rehearsal: the
port's float64 path, 2 seconds), printing a well-formed last line whose
comparison comes out correct."""

import json

import pytest

from conftest import ROOT, run_cell

CELLS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]


def check_line(line, bench, workload, trace):
    assert line is not None
    assert set(line) >= {'correct', 'attempted', 'failed', 'metrics',
                         'device'}
    assert list(line)[-1] == 'compared'
    assert line['device']['platform'] == 'cpu'
    assert line['attempted'] >= 1 and line['failed'] == 0
    if not trace:
        want = {m['name'] for m in bench['end_to_end']
                if workload in m.get('workloads', [workload])}
        assert set(line['metrics']) == want
        for m in line['metrics'].values():
            assert m['value'] > 0
    for c in line['compared'].values():
        assert set(c) == {'value', 'limit'}


@pytest.mark.parametrize('workload', CELLS)
def test_mix_runs_end_to_end(workload, bench):
    rc, line, err = run_cell(workload)
    assert rc == 0, err[-3000:]
    check_line(line, bench, workload, trace=0)
    assert line['correct'], line['compared']
    assert 'compared' in err.strip().splitlines()[-1]


def test_traced_run_reads_no_device_metric_on_the_cpu(bench):
    rc, line, err = run_cell('kalbar801-am', trace=1)
    assert rc == 0, err[-3000:]
    check_line(line, bench, 'kalbar801-am', trace=1)
    assert line['metrics'] == {} and 'breakdown' not in line


def test_no_card_no_result(tmp_path):
    """Without --rehearse a run on a machine with no card exits non-zero
    and prints no result line."""
    import subprocess
    import sys

    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is visible: the run would measure')
    proc = subprocess.run(
        [sys.executable, str(ROOT / 'bench_torch' / 'run.py'), '--workload',
         CELLS[0], '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout

"""The control (the plain reference in float32 with its products'
operands rounded to TF32, put in the program's place) comes out not
correct in every cell, at the rehearsal's cut: ``control.py`` reads the
program's numbers and the control's at the same answers and puts each
through the harness's own decision against the cell's limits; the
program's pass and the control's fail."""

import json
import subprocess
import sys

import pytest

from conftest import REHEARSE, ROOT

CELLS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]


@pytest.mark.parametrize('workload', CELLS)
def test_control_is_not_correct(workload):
    proc = subprocess.run(
        [sys.executable, str(ROOT / 'bench_torch' / 'control.py'),
         '--workload', workload, '--seeds', '21', '--seconds', '2',
         '--rehearse', REHEARSE],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line['correct'] is True, line['checks']
    assert line['control_correct'] is False, line['checks']

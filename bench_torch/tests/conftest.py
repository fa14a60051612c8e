"""Helpers of the benchmark's CPU tests: a run of ``run.py --rehearse`` in
a subprocess, from the repository or from a copy of the benchmark."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
REHEARSE = '40'


def run_cell(workload, seed=7, seconds=2, trace=0, cwd=ROOT, env=None):
    """``(exit code, last stdout line as JSON or None, stderr)``."""
    proc = subprocess.run(
        [sys.executable, str(Path(cwd) / 'bench_torch' / 'run.py'),
         '--workload', workload, '--seed', str(seed), '--seconds',
         str(seconds), '--trace', str(trace), '--rehearse', REHEARSE],
        cwd=cwd, capture_output=True, text=True, timeout=1800,
        env=dict(os.environ, **(env or {})))
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return proc.returncode, last, proc.stderr


@pytest.fixture(scope='session')
def bench():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())

"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, answers, comparison) at the
rehearsal's cut, with one fault of ``faults.py`` planted in the program
each time, for each fault a cell can have: an answer altered where it is
produced, a step that returns its state unchanged, half of a batch left
out, the log likelihood a chain keeps altered where it is produced, and
the day accumulate's gradient altered where it is produced."""

import json
import subprocess
import sys

import pytest

from conftest import REHEARSE, ROOT

RUNNER = '''
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
from bench_torch import faults, harness
faults.plant({fault!r})
sys.exit(harness.main(sys.argv[1:], t0))
'''

FAULTS = [('kalbar801-nuts', 'altered'), ('kalbar801-am', 'altered'),
          ('carnarvon801-forecast', 'altered'),
          ('kalbar801-smc64', 'altered'), ('kalbar801-nuts', 'unchanged'),
          ('kalbar801-am', 'unchanged'), ('kalbar801-smc64', 'unchanged'),
          ('kalbar801-smc64', 'half_batch'),
          ('kalbar801-am', 'loglik_altered'),
          ('kalbar801-smc64', 'loglik_altered'),
          ('kalbar801-nuts', 'grad_scaled')]


@pytest.mark.parametrize('workload,fault', FAULTS)
def test_a_broken_path_is_not_correct(tmp_path, workload, fault):
    script = tmp_path / 'runner.py'
    script.write_text(RUNNER.format(root=str(ROOT), fault=fault))
    proc = subprocess.run(
        [sys.executable, str(script), '--workload', workload, '--seed', '9',
         '--seconds', '2', '--trace', '0', '--rehearse', REHEARSE],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line['correct'] is False, line['compared']

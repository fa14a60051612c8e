"""The span metrics (``spans.py`` and its readers): traced CPU
rehearsals of the cells that have them print the program's span metrics
as finite numbers and leave the device ones out, and stay correct; the
idle split and the launch link on hand-made inputs; and the benchmark's
files as first accepted (``accepted_files.json``, sha256 of each) are
unchanged, since a later change only adds files."""

import hashlib
import json
import math
from types import SimpleNamespace

import pytest

from conftest import ROOT, run_cell

from bench_torch import spans

SPAN_METRICS = {
    'kalbar801-nuts': {'tree_host_ms.nuts', 'host_read_ms.nuts'},
    'kalbar801-am': {'host_read_ms.am', 'sweep_ms.am'},
    'carnarvon801-forecast': {'day_loop_ms.forecast'},
}


@pytest.mark.parametrize('workload', sorted(SPAN_METRICS))
def test_traced_rehearsal_prints_the_span_metrics(workload, bench):
    rc, line, err = run_cell(workload, seed=2**31 + 12345, trace=1)
    assert rc == 0, err[-3000:]
    assert line['correct'], line['compared']
    mine = {m['name']: m for m in bench['per_layer']
            if workload in m.get('workloads', [])}
    # the span metrics read the spans on the CPU too; replays and the
    # device's readings are the card's
    assert set(line['metrics']) == SPAN_METRICS[workload]
    for name, got in line['metrics'].items():
        assert mine[name]['source'] == 'program_span'
        assert got['unit'] == mine[name]['unit']
        assert math.isfinite(got['value']) and got['value'] > 0
    assert 'spans, host ms a unit' in err
    assert 'device idle by span' not in err


def test_idle_is_split_at_the_span_boundaries():
    # idle 0-10 and 20-30; span a 5-25, b 8-12 inside it
    gaps = spans.idle_gaps([(10, 20), (12, 15)], 0, 30)
    assert gaps == [(0, 10), (20, 30)]
    credit, under = spans.split_idle(gaps, [(5, 25, 'a'), (8, 12, 'b')])
    assert credit == {spans.OUTSIDE: 10, 'a': 8, 'b': 2}
    assert under == {'a': 10, 'b': 2}
    assert spans.idle_gaps([(0, 40)], 0, 30) == []


def test_device_time_goes_to_every_span_above_the_launch():
    def ev(name, parent=None, us=()):
        return SimpleNamespace(name=name, cpu_parent=parent, kernels=[
            SimpleNamespace(duration=d) for d in us])
    outer = ev('outer')
    inner = ev('inner', outer)
    events = [outer, inner, ev('aten::add', inner, (3.0, 4.0)),
              ev('aten::mul', outer, (5.0,)), ev('aten::sub', None, (9.0,))]
    assert spans.device_under(events, {'outer', 'inner'}) == {
        'outer': 12.0, 'inner': 7.0}


def test_the_accepted_files_are_unchanged():
    here = ROOT / 'bench_torch'
    want = json.loads((here / 'tests' / 'accepted_files.json').read_text())
    got = {name: hashlib.sha256((here / name).read_bytes()).hexdigest()
           for name in want}
    assert got == want

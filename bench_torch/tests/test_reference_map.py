"""The MAP cell's reference and checks (``kalbar401-map8``): the plain
MAP objective with the pre-spread day (``reference/map.py``) agrees with
the port's float64 objective at seeded points, value and gradient; its
plain Adam update is ``torch.optim.Adam``'s; the configuration is the
MAP command line's and a mix that departs from it is refused; a run
whose Adam steps take twice the learning rate reads ``adam_gap`` far
over its limit, one whose day-accumulate gradient is scaled reads
``grad_gap`` over its limit, one whose projections are scaled reads
``value_gap`` over its limit, one whose fits stand still reads
``unmoved`` 1, and none is correct; and a traced rehearsal is correct
and prints the cell's span and counter metrics."""

import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import REHEARSE, ROOT, run_cell

from bench_torch import program
from bench_torch.reference import map as plain
from bench_torch.reference import model as reference

CELL = 'kalbar401-map8'


@pytest.fixture(scope='module')
def pair():
    from parasitoids_tpu_torch.bayes.run import build_setup
    setup = build_setup(['domain_info=(4000.0,40)'] + [
        '{}={}'.format(k, v) for k, v in program.REHEARSAL.items()],
        device='cpu')
    ctx = types.SimpleNamespace(sizes=program.sizes_of(setup))
    data = program.site_data(ctx, setup)
    return setup, reference.build(data, torch.float64, torch.device('cpu'))


def test_the_map_target_with_the_pre_spread_day(pair):
    from parasitoids_tpu_torch.bayes import map_fit
    setup, post = pair
    neg, _, _ = map_fit._make_objective(setup, True)
    starts = map_fit.start_points(setup, True,
                                  torch.Generator().manual_seed(4), 3)
    for z in starts:
        z = z.double()
        zz = z.clone().requires_grad_()
        v = neg(zz)
        v.backward()
        rz = z.clone().requires_grad_()
        r_v = plain.objective(post, rz, grad=True)
        r_g, = torch.autograd.grad(r_v, rz)
        assert float(v.detach()) == pytest.approx(float(r_v.detach()),
                                                  rel=1e-7)
        assert np.max(np.abs((zz.grad - r_g).numpy())) <= 1e-6 * float(
            r_g.abs().max())
    # the pre-spread day is a pmf: its mass is 1, the share sprd of it in
    # the flight block's window and the rest about the release cell
    m, _, sprd = plain.constrain(post, starts[0].double())
    day = plain.pre_spread(post.fwd, reference.as_model(m), sprd)
    assert float(day.sum()) == pytest.approx(1.0, abs=1e-12)
    assert float(day.min()) >= 0.0


def test_the_plain_adam_update_is_torchs():
    gen = torch.Generator().manual_seed(11)
    z = z0 = torch.randn(26, generator=gen, dtype=torch.float64)
    leaf = z.clone().requires_grad_()
    opt = torch.optim.Adam([leaf], lr=0.02)
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    for t in range(1, 21):
        g = torch.randn(26, generator=gen, dtype=torch.float64) * 10.0 ** (
            t % 7 - 4)
        leaf.grad = g.clone()
        opt.step()
        z, m, v = plain.adam_update(z, g, m, v, t, 0.02)
        assert torch.allclose(leaf.detach(), z, rtol=1e-14, atol=1e-15)
    # twenty steps moved it: the comparison is not of a point at rest
    assert float((z - z0).abs().min()) > 1e-3


def test_the_configuration_is_the_clis_defaults(bench):
    from parasitoids_tpu_torch.bayes import map_fit
    from bench_torch.harness import Cell, load_module
    cell = Cell(bench, CELL)
    fit = cell.config['map']
    assert fit['entry'] == 'parasitoids_tpu_torch.bayes.map_fit'
    # the mix runs the file's fit, and the file is the command line's
    assert all(cell.traffic[k] == fit[k] for k in fit if k in cell.traffic)
    assert cell.config['build']['overrides'] == {
        'domain_info': '(10000.0,200)'}
    assert tuple(map_fit.map_cli_params().domain_info) == (10000.0, 200)
    assert map_fit._N_PERIODS_FIXED == fit['n_periods']
    assert map_fit.default_use_sprd(map_fit.map_cli_params()) is True
    sig = map_fit.map_fit.__defaults__
    assert (sig[0], sig[1]) == (fit['steps'], fit['learning_rate'])
    assert map_fit.lbfgs_polish.__defaults__[0] == fit['polish']
    polish = map_fit.LBFGSPolish(lambda z: (z ** 2).sum(), torch.ones(2))
    d = polish.opt.defaults
    assert (d['history_size'], d['max_eval'], d['line_search_fn']) == (
        fit['lbfgs_history'], fit['lbfgs_max_eval'], fit['line_search'])
    # a mix that departs from the file is refused before any set-up
    runner = load_module(cell.runner_path, 'bench_runner_map').Runner
    ctx = types.SimpleNamespace(config=cell.config, rehearse=None,
                                torch=torch,
                                traffic=dict(cell.traffic, steps=100))
    with pytest.raises(ValueError, match='steps'):
        runner(ctx)


PLANTED = '''
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
from bench_torch import faults, harness
from parasitoids_tpu_torch.bayes import map_fit
{patch}
sys.exit(harness.main(sys.argv[1:], t0))
'''

DOUBLED = '''
start = map_fit.adam_start
map_fit.adam_start = lambda z0, lr: start(z0, 2.0 * lr)
'''

SCALED = '''
faults.plant('grad_scaled')
'''

ALTERED = '''
faults.plant('altered')
'''

# steps that leave the point where it is: Adam's update undone, the
# polish's iterations finding no step
FROZEN = '''
step = map_fit.adam_step


def still(neg_logpost, z, opt):
    before = z.detach().clone()
    loss = step(neg_logpost, z, opt)
    with torch.no_grad():
        z.copy_(before)
    return loss


map_fit.adam_step = still
map_fit.LBFGSPolish.step = lambda self: (setattr(self, 'done', True), 0.0)[1]
'''


def planted(tmp_path, patch, seed):
    """The rehearsal's last line with ``patch`` applied to the program."""
    script = tmp_path / 'runner.py'
    script.write_text(PLANTED.format(root=str(ROOT), patch=patch))
    proc = subprocess.run(
        [sys.executable, str(script), '--workload', CELL, '--seed',
         str(seed), '--seconds', '2', '--trace', '0', '--rehearse',
         REHEARSE], cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_doubled_learning_rate_is_not_correct(tmp_path):
    line = planted(tmp_path, DOUBLED, 9)
    c = line['compared']
    assert c['adam_gap']['value'] > 100 * c['adam_gap']['limit'], c
    assert line['correct'] is False
    # the evaluations themselves are still the program's own
    assert c['value_gap']['value'] <= c['value_gap']['limit']


def test_a_scaled_gradient_is_not_correct(tmp_path):
    line = planted(tmp_path, SCALED, 2**31 + 9)
    c = line['compared']
    assert c['grad_gap']['value'] > c['grad_gap']['limit'], c
    assert line['correct'] is False


def test_altered_projections_are_not_correct(tmp_path):
    line = planted(tmp_path, ALTERED, 5)
    c = line['compared']
    assert c['value_gap']['value'] > 10 * c['value_gap']['limit'], c
    assert line['correct'] is False


def test_fits_that_stand_still_are_not_correct(tmp_path):
    line = planted(tmp_path, FROZEN, 13)
    assert line['compared']['unmoved']['value'] == 1, line['compared']
    assert line['correct'] is False


def test_traced_rehearsal_reads_the_optimizers(bench):
    rc, line, err = run_cell(CELL, seed=2**31 + 777, trace=1)
    assert rc == 0, err[-3000:]
    assert line['correct'], line['compared']
    mine = {m['name']: m for m in bench['per_layer']
            if CELL in m.get('workloads', [])}
    # the CPU reads the spans and the counters; the device metrics and
    # the graphs' replays are the card's
    assert set(line['metrics']) == {'step_host_ms.map8', 'host_read_ms.map8',
                                    'evals_per_iter.map8'}
    for name, got in line['metrics'].items():
        assert got['unit'] == mine[name]['unit']
        assert math.isfinite(got['value']) and got['value'] > 0
    assert line['metrics']['evals_per_iter.map8']['value'] >= 1
    assert 'map.step' in err and 'map.eval' in err

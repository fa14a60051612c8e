"""The parallel-tempering cell's reference and checks (``kalbar801-pt8``):
the plain swap rule (``reference/tempering.py``) decides as the
program's sweep does on seeded log likelihoods; a run whose exchange
rule has its sign flipped reads ``swap_mismatch`` above 0, and one whose
replica steps (on every rung, or on the hot rungs alone) hand their
states back unchanged reads ``unmoved`` 1, and neither is correct; and a
traced rehearsal prints the cell's span and counter metrics."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REHEARSE, ROOT, run_cell

from bench_torch.reference import tempering as plain

CELL = 'kalbar801-pt8'


def seeded(T, seed):
    rng = np.random.default_rng([T, seed])
    ll = (-2000.0 + 40.0 * rng.standard_normal(T)).astype(np.float32)
    u = rng.random(T - 1).astype(np.float32)
    return ll, u


@pytest.mark.parametrize('T', [2, 3, 8])
@pytest.mark.parametrize('parity', [0, 1])
def test_the_plain_rule_decides_as_the_program(T, parity):
    from parasitoids_tpu_torch.bayes import tempering
    betas = tempering.power_ladder(T, 5.0)
    n_acc = n_att = 0
    for seed in range(20):
        ll, u = seeded(T, seed)
        perm, acc, att = tempering._swap_decision(
            torch.as_tensor(ll), torch.as_tensor(betas), parity,
            torch.as_tensor(u))
        r_perm, r_acc, r_att, margins = plain.sweep(
            betas.astype(np.float64), ll.astype(np.float64), parity, u)
        # every decision lies clear of float32 rounding of the rule
        assert all(m > 1e-3 for m in margins.values())
        assert perm.tolist() == r_perm
        assert acc.tolist() == r_acc and att.tolist() == r_att
        n_acc += sum(r_acc)
        n_att += sum(r_att)
    assert n_att == 20 * len(plain.pairs(T, parity))
    # both outcomes occur where the ladder's pairs are attempted
    assert n_att == 0 or 0 < n_acc < n_att


def test_the_rule_from_its_equation():
    betas = [1.0, 0.5, 0.0]
    ll = [-10.0, -12.0, -30.0]
    # pair (0, 1): log alpha = 0.5 * (-2) = -1; u = e^-0.5 rejects
    perm, acc, att, margins = plain.sweep(betas, ll, 0, [math.exp(-0.5),
                                                         0.9])
    assert (perm, acc, att) == ([0, 1, 2], [0, 0], [1, 0])
    assert margins == {0: pytest.approx(0.5)}
    # u = e^-1.5 accepts; parity 1 pairs (1, 2) alone
    perm, acc, _, _ = plain.sweep(betas, ll, 0, [math.exp(-1.5), 0.9])
    assert (perm, acc) == ([1, 0, 2], [1, 0])
    perm, acc, att, _ = plain.sweep(betas, ll, 1, [0.9, math.exp(-9.5)])
    assert (perm, acc, att) == ([0, 2, 1], [0, 1], [0, 1])


def test_the_configuration_is_the_clis_defaults(bench):
    from types import SimpleNamespace

    from parasitoids_tpu_torch.bayes import run, tempering
    from bench_torch.harness import Cell, load_module
    cell = Cell(bench, CELL)
    sampler = cell.config['sampler']
    assert sampler['entry'] == 'parasitoids_tpu_torch.bayes.tempering.run_pt'
    # the mix runs the file's sampler, and the file is --sampler pt's
    assert {k: cell.traffic[k] for k in sampler if k != 'entry'} == \
        {k: v for k, v in sampler.items() if k != 'entry'}
    cli = run.parser.get_default
    cfg = tempering.PTConfig(n_rounds=1)
    assert (cli('temps'), cli('ladder_power'), cli('swap_every')) == \
        (sampler['temps'], sampler['ladder_power'], sampler['swap_every'])
    assert cli('beta_min') == 0 and sampler['ladder'] == 'power'
    assert (cfg.adapt_start, cfg.obs_sweeps) == \
        (sampler['adapt_start'], sampler['obs_sweeps'])
    # a mix that departs from the file is refused before any set-up
    runner = load_module(cell.runner_path, 'bench_runner_pt').Runner
    ctx = SimpleNamespace(config=cell.config, rehearse=None,
                          traffic=dict(cell.traffic, swap_every=5))
    with pytest.raises(ValueError, match='swap_every'):
        runner(ctx)


PLANTED = '''
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
from bench_torch import harness
from parasitoids_tpu_torch.bayes import tempering
{patch}
sys.exit(harness.main(sys.argv[1:], t0))
'''

FLIPPED = '''
rule = tempering._swap_log_alpha
tempering._swap_log_alpha = lambda *a: -rule(*a)
'''

# replica steps that hand their state back unchanged: on every rung, or on
# the hot rungs alone while the cold one moves
FROZEN = '''
advance = tempering._advance


def frozen(setup, state, beta, cfg, draws=None):
    if {hot!r} and beta == 1.0:
        return advance(setup, state, beta, cfg, draws)
    row = torch.cat([state.m, state.o, state.loglik.reshape(1)])
    n = cfg.swap_every
    return state, (row.expand(n, -1).clone(),
                   state.loglik.reshape(1).expand(n).clone())


tempering._advance = frozen
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


def test_a_flipped_exchange_rule_is_not_correct(tmp_path):
    line = planted(tmp_path, FLIPPED, 9)
    assert line['compared']['swap_mismatch']['value'] > 0, line['compared']
    assert line['correct'] is False
    # the states themselves are still the program's own
    assert line['compared']['loglik_gap']['value'] <= \
        line['compared']['loglik_gap']['limit']


@pytest.mark.parametrize('hot', [False, True])
def test_a_frozen_ladder_is_not_correct(tmp_path, hot):
    line = planted(tmp_path, FROZEN.format(hot=hot), 2**31 + 5)
    assert line['compared']['unmoved']['value'] == 1, line['compared']
    assert line['correct'] is False


def test_traced_rehearsal_reads_the_round_loop(bench):
    rc, line, err = run_cell(CELL, seed=2**31 + 777, trace=1)
    assert rc == 0, err[-3000:]
    assert line['correct'], line['compared']
    mine = {m['name']: m for m in bench['per_layer']
            if CELL in m.get('workloads', [])}
    # the CPU reads the spans and the counters; the device metrics and
    # the graphs' replays are the card's
    assert set(line['metrics']) == {'swap_ms.pt8', 'round_host_ms.pt8',
                                    'host_read_ms.pt8', 'sweep_ms.pt8',
                                    'forwards_per_step.pt8'}
    for name, got in line['metrics'].items():
        assert got['unit'] == mine[name]['unit']
        assert math.isfinite(got['value']) and got['value'] > 0
    assert 0 < line['metrics']['forwards_per_step.pt8']['value'] <= 1
    assert 'pt.round' in err and 'pt.swap' in err

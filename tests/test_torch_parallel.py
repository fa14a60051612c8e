"""The port's device mesh (parallel/chains.py) and the command lines'
choice of it, on the CPU at the small configuration (3 days, 10 km / 50
cells, interp 2, K 6, Kl 3).

A mesh here names the CPU several times, as the JAX tests' virtual
devices stand in for chips; the command lines see more than one device
through ``device.visible_devices``, monkeypatched.  Every sharded member
(chain, replica, particle, start, draw) runs the ops it runs without a
mesh, so each command line's result with a mesh is held to its result
without one bit for bit."""

import json

import numpy as np
import pytest

from tests._torch_parity import MAP_SMALL, torch

from parasitoids_tpu_torch import device
from parasitoids_tpu_torch.bayes import cv as tcv
from parasitoids_tpu_torch.bayes import loo as tloo
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import predictive as tpred
from parasitoids_tpu_torch.bayes import run as trun
from parasitoids_tpu_torch.bayes import sensitivity as tsens
from parasitoids_tpu_torch.bayes import smc as tsmc
from parasitoids_tpu_torch.bayes import spread as tspread
from parasitoids_tpu_torch.bayes import summary as tsum
from parasitoids_tpu_torch.bayes.model import BayesSetup, ObservationOps
from parasitoids_tpu_torch.parallel import chains

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

TINY = ['--device', 'cpu'] + list(MAP_SMALL)
CPU = torch.device('cpu')


def _see(monkeypatch, n):
    """Make the command lines see ``n`` devices (the CPU ``n`` times)."""
    monkeypatch.setattr(device, 'visible_devices',
                        lambda d=None: [device.pick_device('cpu')] * n)


@pytest.fixture(scope='module')
def setup():
    return BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu')


# ----------------------------------------------------------------------
# the mesh and its helpers
# ----------------------------------------------------------------------

def test_mesh_type_and_its_default_devices(monkeypatch):
    mesh = chains.chain_mesh(devices=['cpu'] * 3)
    assert mesh.devices == (CPU,) * 3 and mesh.axis_names == ('chains',)
    assert mesh.shape == {'chains': 3} and mesh.size == 3
    assert device.visible_devices('cpu') == [CPU]
    _see(monkeypatch, 8)
    assert chains.chain_mesh().size == 8
    assert chains.chain_mesh(n_devices=2).devices == (CPU, CPU)
    with pytest.raises(ValueError, match='one type'):
        chains.chain_mesh(devices=['cpu', 'meta'])
    with pytest.raises(ValueError, match='at least one'):
        chains.chain_mesh(devices=[])
    if not torch.cuda.is_available():
        # a mesh that names a card while torch sees none raises
        with pytest.raises(RuntimeError, match='no CUDA device'):
            chains.chain_mesh(devices=['cuda:0'])
    assert chains.shard_bounds(6, mesh) == [(CPU, 0, 2), (CPU, 2, 4),
                                            (CPU, 4, 6)]
    with pytest.raises(ValueError, match='divisible'):
        chains.shard_bounds(4, mesh)


def test_psum_and_row_helpers():
    # (the name is the test's from before the minute-sharded forward and
    # its partial sums went) rows taken per shard concatenate back;
    # generators stay where they are and move only between cards
    gens = tuple(torch.Generator() for _ in range(4))
    tree = (torch.arange(8).reshape(4, 2), (torch.ones(4), gens), gens)
    pieces = [chains.take_rows(tree, a, b)
              for _, a, b in chains.shard_bounds(4, chains.chain_mesh(
                  devices=['cpu'] * 2))]
    assert len(pieces[1][2]) == 2 and pieces[1][2][0] is gens[2]
    back = chains.concat_rows(pieces, CPU)
    assert torch.equal(back[0], tree[0]) and back[2] == gens
    assert chains.to_device(gens[0], 'cpu') is gens[0]
    with pytest.raises(ValueError, match='cannot move'):
        chains.move_generator(gens[0], 'meta')


def test_on_device_moves_every_tensor(setup):
    # the copy of a setup on another device holds every tensor there (the
    # meta device stands in for a second card); it is made once, and the
    # setup is its own copy on its own device
    meta = setup.on_device('meta')
    assert setup.on_device('cpu') is setup
    assert setup.on_device('meta') is meta and meta is not setup
    seen = []

    def walk(x):
        if torch.is_tensor(x):
            seen.append(x.device.type)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, (BayesSetup, ObservationOps)):
            for v in vars(x).values():
                walk(v)

    walk(meta)
    assert len(seen) > 20 and set(seen) == {'meta'}
    seen.clear()
    walk(setup)
    assert set(seen) == {'cpu'}
    assert meta.params is setup.params and meta.ndays == setup.ndays
    held = setup.with_held_out(np.ones(505, bool))
    assert held.on_device('meta') is not meta     # copies do not share


# ----------------------------------------------------------------------
# the command lines' mesh choice
# ----------------------------------------------------------------------

def _store(db):
    with np.load(db + '.npz') as d:
        return {k: d[k] for k in d.files}


def _same_store(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('n_dev,chains_,words', [
    (2, 2, 'chains sharded over 2 devices'),
    (8, 2, 'note: 2 chains do not divide 8 devices')])
def test_am_cli_chain_mesh(n_dev, chains_, words, tmp_path, monkeypatch,
                           capsys):
    # the AM command line shards the chains when they divide over the
    # devices (the store bitwise the unsharded one's) and says so when not
    ref = str(tmp_path / 'ref')
    trun.main(['--new', '3', '1', ref, '--chains', str(chains_)] + TINY)
    capsys.readouterr()
    _see(monkeypatch, n_dev)
    db = str(tmp_path / 'mesh')
    trun.main(['--new', '3', '1', db, '--chains', str(chains_)] + TINY)
    assert words in capsys.readouterr().out
    _same_store(_store(db), _store(ref))


@pytest.mark.parametrize('flags,words', [
    (['--sampler', 'nuts', '--chains', '2', '--max-depth', '2', '--init',
      'prior'], 'chains sharded over 2 devices'),
    (['--sampler', 'pt', '--temps', '2', '--swap-every', '1'],
     'one replica per device over 2 devices'),
    (['--sampler', 'smc', '--ess-target', '0.01', '--moves', '1',
      '--min-accepts', '0', '--max-move-rounds', '1'],
     'particles sharded over 2 devices')])
def test_sampler_cli_mesh(flags, words, tmp_path, monkeypatch, capsys):
    # NUTS's chains, PT's replicas (one per device) and SMC's particles
    # over two devices: the store of the run on one, bit for bit
    n = '4' if 'smc' in flags else '2'
    ref = str(tmp_path / 'ref')
    trun.main(['--new', n, '1', ref] + flags + TINY)
    assert words not in capsys.readouterr().out
    _see(monkeypatch, 2)
    db = str(tmp_path / 'mesh')
    trun.main(['--new', n, '1', db] + flags + TINY)
    assert words in capsys.readouterr().out
    _same_store(_store(db), _store(ref))


@pytest.fixture(scope='module')
def trace_file(tmp_path_factory, setup):
    """A two-chain AM trace of three steps, as every sampler writes one."""
    states = chains.init_chains(setup, 1, 2)
    _, tr = chains.run_chains(setup, states, trun.MCMCConfig(3))
    path = str(tmp_path_factory.mktemp('trace') / 'run.npz')
    np.savez(path, traces=tr.numpy())
    return path


@pytest.mark.parametrize('name', ['predictive', 'spread', 'loo',
                                  'sensitivity', 'summary'])
def test_analysis_cli_mesh(name, trace_file, tmp_path, monkeypatch, capsys):
    # the analysis command lines shard their draws over the devices when
    # there are several; the member results are bitwise those in turn
    import os
    os.symlink(os.path.abspath('data'), str(tmp_path / 'data'))
    monkeypatch.chdir(tmp_path)
    main, args = {
        'predictive': (tpred.main, ['--draws', '3', '--json']),
        'spread': (tspread.main, ['--draws', '3', '--days', '1,3']),
        'loo': (tloo.main, ['--draws', '4']),
        'sensitivity': (tsens.main, ['--draws', '4']),
        'summary': (tsum.main, ['--draws', '4', '--group', 'block'])}[name]
    ref = main([trace_file] + args + TINY)
    assert 'sharded' not in capsys.readouterr().out
    _see(monkeypatch, 2)
    got = main([trace_file] + args + TINY)
    assert 'draws sharded over 2 devices' in capsys.readouterr().out
    if name == 'spread':
        for k in ('maps', 'mean'):
            np.testing.assert_array_equal(got[k], ref[k])
    elif name == 'loo':
        assert json.dumps(got, sort_keys=True) == json.dumps(ref,
                                                             sort_keys=True)
    elif name == 'sensitivity':
        np.testing.assert_array_equal(got['prior_sens'], ref['prior_sens'])
        np.testing.assert_array_equal(got['lik_sens'], ref['lik_sens'])
    elif name == 'predictive':
        assert got == ref


def test_loo_rounds_draws_to_the_mesh(setup, trace_file):
    # the draws split evenly over the devices: four draws over three
    # devices keep three; over eight the mesh is dropped
    traces = np.load(trace_file)['traces']
    ll, take = tloo.pointwise_matrix(setup, traces, n_draws=4)
    ll3, take3 = tloo.pointwise_matrix(
        setup, traces, n_draws=4, mesh=chains.chain_mesh(devices=['cpu'] * 3))
    np.testing.assert_array_equal(ll3, ll[:3])
    np.testing.assert_array_equal(take3, take[:3])
    ll8, _ = tloo.pointwise_matrix(
        setup, traces, n_draws=4, mesh=chains.chain_mesh(devices=['cpu'] * 8))
    np.testing.assert_array_equal(ll8, ll)
    res = tsens.sensitivity_from_trace(setup, traces, n_draws=4,
                                       pointwise=(ll3, take3))
    assert res['n_draws'] == 3


def test_map_cli_mesh(tmp_path, monkeypatch, capsys):
    # --starts over the devices: the fit bitwise the one in turn
    out = ['-o', str(tmp_path / 'm.txt')]
    ref = tm.main(['--MAP', '--steps', '2', '--starts', '2'] + out + TINY)
    _see(monkeypatch, 2)
    got = tm.main(['--MAP', '--steps', '2', '--starts', '2'] + out + TINY)
    assert 'starts sharded over 2 devices' in capsys.readouterr().out
    np.testing.assert_array_equal(got['start_logps'], ref['start_logps'])
    np.testing.assert_array_equal(got['z'], ref['z'])


def test_cv_cli_mesh(tmp_path, monkeypatch, capsys):
    # each fold's particles over the devices: the fold's result in turn
    real = tsmc.SMCConfig
    monkeypatch.setattr(tsmc, 'SMCConfig', lambda n_particles, n_moves: real(
        n_particles, n_moves, ess_target=0.01, min_accepts=0.0,
        max_move_rounds=1))
    args = ['--folds', '0', '--particles', '4', '--moves', '1', '--out',
            str(tmp_path / 'cv.json')] + TINY
    ref = tcv.main(args)
    _see(monkeypatch, 2)
    got = tcv.main(args)
    assert 'particles sharded over 2 devices' in capsys.readouterr().out
    assert got == ref

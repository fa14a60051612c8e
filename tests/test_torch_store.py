"""The port's trace store (bayes/store.py) and chain runner
(parallel/chains.py) on the CPU at the small configuration: save/load
round trips, bitwise-exact resume for one chain and for stacked chains
(test_am_sampler.py:56-103), a store written by the port read by the JAX
package's consumers, and the refusals of ``load_chain``."""

import json
import os

import numpy as np
import pytest

from tests._torch_parity import MAP_SMALL, torch

from parasitoids_tpu.bayes import diagnostics as jdiag
from parasitoids_tpu.bayes import store as jstore
from parasitoids_tpu.viz import bayes_plot as jplot
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import sampler as ts
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.bayes.store import (_STATE_FIELDS, append_traces,
                                               load_chain, load_extras,
                                               save_chain)
from parasitoids_tpu_torch.parallel import chains

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')


@pytest.fixture(scope='module')
def setup():
    return BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu')


def _flat(proj):
    return torch.cat([p.reshape(-1) for p in (*proj[0], *proj[1], proj[2])])


def _assert_states_equal(a, b):
    for f in _STATE_FIELDS:
        if f == 'key':
            keys = zip(a.key, b.key) if isinstance(a.key, tuple) \
                else [(a.key, b.key)]
            assert all(torch.equal(x.get_state(), y.get_state())
                       for x, y in keys)
        else:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(_flat(a.proj), _flat(b.proj))


def test_store_resume_exact(tmp_path, setup):
    # continuing from the reloaded state gives the traces of continuing in
    # memory, bit for bit: positions, moments, adaptation and the
    # generator's state all round-trip, and the projections are rebuilt by
    # the same deterministic forward
    state = ts.init_chain_state(setup, ts.chain_generator(1, 0, 'cpu'))
    state, tr1 = ts.run_mcmc(setup, state, ts.MCMCConfig(n_samples=20))
    db = str(tmp_path / 'sub' / 'chain')
    save_chain(db, tr1[None], state, meta={'n': 20})
    assert sorted(os.listdir(tmp_path / 'sub')) == ['chain.meta.json',
                                                    'chain.npz']
    before = ts.FORWARDS
    traces, state2, meta = load_chain(db + '.npz', setup)
    assert ts.FORWARDS == before + 1            # one forward per chain
    assert meta == {'n': 20, 'device': 'cpu'}
    assert traces.shape == (1, 20, 26)
    np.testing.assert_array_equal(traces[0], tr1.numpy())
    _assert_states_equal(state, state2)
    s_a, tr_a = ts.run_mcmc(setup, state, ts.MCMCConfig(n_samples=10))
    s_b, tr_b = ts.run_mcmc(setup, state2, ts.MCMCConfig(n_samples=10))
    assert torch.equal(tr_a, tr_b)
    _assert_states_equal(s_a, s_b)
    assert float(s_a.accepts_m) > 0             # the chain did move


def test_store_resume_stacked_chains(tmp_path, setup):
    states = chains.init_chains(setup, 5, 2)
    assert states.m.shape == (2, 15) and len(states.key) == 2
    cfg = ts.MCMCConfig(n_samples=5)
    states, traces = chains.run_chains(setup, states, cfg)
    assert traces.shape == (2, 5, 26) and states.proj[2].shape[0] == 2
    assert not torch.equal(traces[0], traces[1])
    db = str(tmp_path / 'chains')
    save_chain(db, traces, states, meta={'chains': 2})
    got, states2, meta = load_chain(db, setup)
    assert got.shape == (2, 5, 26) and meta['chains'] == 2
    assert np.load(db + '.npz')['state_key'].shape == (2, 5056)
    assert states2.m.shape == (2, 15)
    _assert_states_equal(states, states2)
    s_a, tr_a = chains.run_chains(setup, states, cfg)
    s_b, tr_b = chains.run_chains(setup, states2, cfg)
    assert torch.equal(tr_a, tr_b)
    _assert_states_equal(s_a, s_b)
    # chains advance in turn: chain 1 alone gives the same trace
    one = ts.unstack_states(load_chain(db, setup)[1])[1]
    _, tr_one = ts.run_mcmc(setup, one, cfg)
    assert torch.equal(tr_one, tr_a[1])
    np.testing.assert_array_equal(
        append_traces(got, tr_a.numpy())[:, 5:], tr_a.numpy())


def test_port_store_is_read_by_the_jax_package(tmp_path, setup, monkeypatch,
                                               capsys):
    # the layout is the JAX package's: traces, x_ extras and the meta
    # sidecar are read by its diagnostics, plots and load_extras unchanged
    states = chains.init_chains(setup, 2, 2)
    states, traces = chains.run_chains(setup, states,
                                       ts.MCMCConfig(n_samples=24))
    db = str(tmp_path / 'store')
    save_chain(db, traces, states,
               meta={'obs_model': 'poisson', 'burn': 0},
               extra={'betas': np.linspace(0, 1, 4)})
    with np.load(db + '.npz') as npz:
        assert set(npz.files) == {'traces', 'x_betas'} | {
            'state_' + f for f in _STATE_FIELDS}
        assert npz['state_key'].dtype == np.uint8
        tr = npz['traces']
    np.testing.assert_array_equal(jstore.load_extras(db)['betas'],
                                  load_extras(db)['betas'])
    rhat = jdiag.gelman_rubin(tr[:, :, :15])
    assert rhat.shape == (15,) and np.all(rhat > 0)
    assert jdiag.effective_sample_size(tr[0, :, 15]) > 0
    assert jplot._param_names(tr.shape[-1])[-1] == 'log_posterior'
    monkeypatch.chdir(tmp_path)
    jplot.main([db])
    assert 'diagnostics written' in capsys.readouterr().out
    made = os.listdir(tmp_path / 'diagnostics')
    assert 'trace_g_aw.png' in made and 'posterior_other.png' in made


def test_load_chain_refuses_a_foreign_key_or_device(tmp_path, setup):
    state = ts.init_chain_state(setup, ts.chain_generator(0, 0, 'cpu'))
    db = str(tmp_path / 'own')
    save_chain(db, np.zeros((1, 0, 26), np.float32), state)
    with np.load(db + '.npz') as npz:
        payload = {k: npz[k] for k in npz.files}
    # a JAX store's key is a (2,) uint32
    other = str(tmp_path / 'jax_key')
    np.savez(other + '.npz', **dict(payload, state_key=np.array(
        [0, 7], np.uint32)))
    with pytest.raises(ValueError, match='state_key'):
        load_chain(other, setup)
    # the state bytes of a generator of another device type
    np.savez(other + '.npz', **dict(payload, state_key=np.zeros(
        16, np.uint8)))
    with pytest.raises(ValueError, match='state_key'):
        load_chain(other, setup)
    # a sidecar that names another device type
    np.savez(other + '.npz', **payload)
    with open(other + '.meta.json', 'w') as fh:
        json.dump({'device': 'cuda'}, fh)
    with pytest.raises(ValueError, match="device type 'cuda'"):
        load_chain(other, setup)
    # no store is half read: the own one still loads
    assert load_chain(db, setup)[2] == {'device': 'cpu'}
    np.savez(other + '.npz', **{k: v for k, v in payload.items()
                                if k != 'state_mean'})
    os.remove(other + '.meta.json')
    with pytest.raises(KeyError, match='state_mean'):
        load_chain(other, setup)


def test_old_store_without_log_scale_loads(tmp_path, setup):
    state = ts.init_chain_state(setup, ts.chain_generator(0, 0, 'cpu'))
    db = str(tmp_path / 'old')
    save_chain(db, np.zeros((1, 0, 26), np.float32),
               state._replace(log_scale=state.log_scale + 0.5))
    with np.load(db + '.npz') as npz:
        payload = {k: npz[k] for k in npz.files if k != 'state_log_scale'}
    np.savez(db + '.npz', **payload)
    _, state2, _ = load_chain(db, setup)
    assert float(state2.log_scale) == 0.0 and state2.log_scale.shape == ()


def test_init_chains_always_in_prior_support(setup):
    # test_parallel.py:116 on the port: jitter in unconstrained space keeps
    # every start inside the support; n_periods starts at 30; the starts
    # are over-dispersed and depend on the seed, not on the device
    states = chains.init_chains(setup, 0, 16, jitter=0.05)
    pm = states.prior_m.numpy()
    assert pm.shape == (16,) and np.isfinite(pm).all()
    m = states.m.numpy()
    assert ((m[:, 12] > 0) & (m[:, 12] < 1)).all()
    assert np.all(m[:, 13] == 30.0)
    assert m[:, 0].std() > 0
    assert torch.equal(states.o[0], states.o[1])
    again = chains.init_chains(setup, 0, 2)
    assert torch.equal(again.m, states.m[:2])
    assert not torch.equal(chains.init_chains(setup, 1, 1).m[0], states.m[0])
    assert len({bytes(k.get_state().numpy()) for k in states.key}) == 16


def test_sharded_chains_raise_naming_their_item(setup, tmp_path):
    # (the name is the test's from before the chain mesh was ported; it
    # now holds the mesh) chains sharded over a mesh that names the CPU
    # twice run the ops they run unsharded, bit for bit; a store written
    # from the mesh resumes on it bit for bit; a chain count that does not
    # divide over the mesh raises
    mesh = chains.chain_mesh(devices=['cpu', 'cpu'])
    assert mesh.size == 2 and mesh.axis_names == ('chains',)
    cfg = ts.MCMCConfig(4)
    st_a, tr_a = chains.run_chains(setup, chains.init_chains(setup, 3, 2),
                                   cfg)
    st_b, tr_b = chains.run_chains(setup, chains.init_chains(setup, 3, 2),
                                   cfg, mesh=mesh)
    assert torch.equal(tr_a, tr_b)
    _assert_states_equal(st_a, st_b)
    shards = chains.shard_chain_states(st_b, mesh)
    assert [len(s.key) for s in shards] == [1, 1]
    assert shards[1].key[0] is st_b.key[1]
    db = str(tmp_path / 'mesh')
    save_chain(db, tr_b.numpy(), st_b)
    _, st_r, _ = load_chain(db, setup)
    st_m, tr_m = chains.run_chains(setup, st_b, cfg, mesh=mesh)
    st_r, tr_r = chains.run_chains(setup, st_r, cfg, mesh=mesh)
    assert torch.equal(tr_m, tr_r)
    _assert_states_equal(st_m, st_r)
    with pytest.raises(ValueError, match='divisible'):
        chains.run_chains(setup, chains.init_chains(setup, 0, 3), cfg,
                          mesh=mesh)

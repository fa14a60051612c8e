"""Port parity of exact leave-one-group-out cross-validation (bayes/cv.py)
at the small configuration of test_torch_sampler.py (3 days, 10 km / 50
cells, interp 2, K 6, Kl 3).

``held_out_elpd`` is held to JAX's on the same weighted particles (the
port's projections recomputed from the same positions) at 1e-6 of the
group's log likelihood (and 1e-4 for zero counts over f32 roundoff rates);
the group's columns are restricted to the
observations whose f64 expected count is positive or whose count is 0 at
every particle (``support_mask_at``: f32 roundoff rates differ between the
packages).  ``exact_logo_cv`` with one fold runs on the port alone: the
fold's refit targets the masked likelihood, and its result has JAX's
layout."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from tests._torch_parity import (MAP_SMALL, chain_state_arrays,
                                 port_chain_state, support_mask_at, torch)

from parasitoids_tpu.bayes import cv as jcv
from parasitoids_tpu.bayes import sampler as js
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu_torch.bayes import cv as tcv
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import sampler as ts
from parasitoids_tpu_torch.bayes import smc as tsmc
from parasitoids_tpu_torch.bayes.loo import point_groups
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.models.forward import setup_from_numpy

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

OV = list(MAP_SMALL)


@pytest.mark.parametrize('by', ['block', 'date'])
def test_held_out_elpd_matches_jax(by):
    jsetup = JaxSetup(tm.map_cli_params(OV))
    s = jsetup.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    tsetup = BayesSetup(tm.map_cli_params(OV), device='cpu',
                        forward_setup=fs)
    ts64 = BayesSetup(tm.map_cli_params(OV), device='cpu',
                      dtype=torch.float64)
    # three particles near the reference start, weighted unevenly
    from parasitoids_tpu_torch.parallel.chains import init_chains
    m0s = init_chains(tsetup, 4, 3).m.numpy()
    jinit = jax.jit(lambda key, m0: js.init_chain_state(jsetup, key,
                                                        m0=m0))
    jstates = [jinit(random.PRNGKey(i), jnp.asarray(m))
               for i, m in enumerate(m0s)]
    jstack = jax.tree.map(lambda *x: jnp.stack(x), *jstates)
    tstack = ts.stack_states([port_chain_state(chain_state_arrays(j),
                                               tsetup, torch.Generator())
                              for j in jstates])
    logw = np.array([0.3, -1.2, 0.0])
    gids, labels = point_groups(tsetup, by=by)
    keep = support_mask_at(ts64, m0s)
    for g in range(len(labels)):
        cols = np.flatnonzero((gids == g) & keep)
        if not len(cols):
            continue
        got, got_ll = tcv.held_out_elpd(tsetup, {'states': tstack,
                                                 'logw': logw}, cols)
        want, want_ll = jcv.held_out_elpd(jsetup, {'states': jstack,
                                                   'logw': logw}, cols)
        # 1e-6 of the group's log likelihood, and 1e-4 for its zero-count
        # observations over f32 roundoff rates (about 1e-5 each, -rate)
        atol = 1e-6 * np.abs(want_ll).max() + 1e-4
        np.testing.assert_allclose(got_ll, want_ll, rtol=0, atol=atol)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert got_ll.shape == (3,) and np.isfinite(got)


@pytest.fixture(scope='module')
def plain():
    return BayesSetup(tm.map_cli_params(OV), device='cpu')


def test_exact_logo_cv_one_fold(plain, monkeypatch):
    # one fold refit by SMC (an ESS target of 1% reaches beta = 1 in one
    # stage): the fold's refit targets the likelihood with its group held
    # out, and the held-out density is scored on the refit's particles
    seen = []
    real = tsmc.run_smc

    def spy(setup, key, cfg, **kw):
        seen.append((key, kw['seed'], kw['obs_mask']))
        out = real(setup, key, cfg, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(tsmc, 'run_smc', spy)
    cfg = tsmc.SMCConfig(n_particles=4, n_moves=1, ess_target=0.01,
                         min_accepts=0.0, max_move_rounds=1)
    res = tcv.exact_logo_cv(plain, by='block', folds=[1], seed=2,
                            smc_config=cfg)
    gids, labels = point_groups(plain, by='block')
    (key, seed, mask), payload = seen
    assert (key, seed) == (2 + 1000, 2 + 1)          # JAX's fold seeding
    want = plain.split_point_mask(gids != 1)
    for a, b in zip((*mask[0], *mask[1], mask[2]),
                    (*want[0], *want[1], want[2])):
        assert torch.equal(a, b)
    assert payload['beta'] == 1.0
    elpd, _ = tcv.held_out_elpd(plain, payload, np.flatnonzero(gids == 1))
    assert res['elpd'] == [elpd] and np.isfinite(elpd)
    assert res['labels'] == [labels[1]] and res['folds'] == [1]
    assert res['logz'] == [payload['logz']] and res['group'] == 'block'
    assert res['elpd_total'] == pytest.approx(elpd)
    with pytest.raises(ValueError, match='out of range'):
        tcv.exact_logo_cv(plain, folds=[len(labels)], smc_config=cfg)
    # each fold's particles sharded over a mesh that names the CPU twice:
    # fold 0's result of the run without one, bit for bit
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    ref = tcv.exact_logo_cv(plain, folds=[0], smc_config=cfg)
    got = tcv.exact_logo_cv(plain, folds=[0], smc_config=cfg,
                            mesh=chain_mesh(devices=['cpu', 'cpu']))
    assert got == ref and np.isfinite(got['elpd_total'])


def test_cv_cli_writes_its_json(tmp_path, monkeypatch):
    # the command line: the fold's result as JSON, JAX's keys
    real = tsmc.SMCConfig
    monkeypatch.setattr(tsmc, 'SMCConfig', lambda n_particles, n_moves: real(
        n_particles, n_moves, ess_target=0.01, min_accepts=0.0,
        max_move_rounds=1))
    out = tmp_path / 'cv.json'
    res = tcv.main(['--folds', '0', '--particles', '4', '--moves', '1',
                    '--out', str(out), '--device', 'cpu'] + OV)
    with open(out) as fh:
        got = json.load(fh)
    assert set(got) == {'group', 'folds', 'labels', 'elpd', 'logz',
                        'elpd_total'}
    assert got['folds'] == [0] and got['elpd_total'] == res['elpd_total']
    assert np.isfinite(got['elpd_total'])

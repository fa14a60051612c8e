"""Port parity of simulation-based calibration (bayes/sbc.py) at the small
configuration of test_torch_sampler.py (3 days, 10 km / 50 cells, interp 2,
K 6, Kl 3).

``sbc_uniformity`` and ``sbc_ecdf_pvals`` are held to JAX's exactly (the
same scipy).  The same truth and the same projections give the same
synthetic dataset in both packages, count for count: the port is handed
JAX's projections, since numpy's Poisson sampler draws another number of
uniforms for a rate that is 0 in one package and f32 roundoff in the other
(tests/_torch_parity.py).  On the port alone: a checkpointed study resumed
is bitwise an uninterrupted one (also from its durable twin, and a
mismatched checkpoint is ignored), and the mechanics of the NUTS, warm-start
and ridge arms of tests/test_validation.py:292, 332, 363."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_parity import MAP_SMALL, torch

from parasitoids_tpu.bayes import predictive as jpred
from parasitoids_tpu.bayes import sbc as jsbc
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu.bayes.sampler import _as_model as j_as_model
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import predictive as tpred
from parasitoids_tpu_torch.bayes import sbc as tsbc
from parasitoids_tpu_torch.bayes.model import BayesSetup

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

OV = list(MAP_SMALL)


@pytest.mark.parametrize('L,shape,seed', [(20, (400, 6), 0), (80, (200, 3), 1),
                                          (7, (30, 2), 2)])
def test_sbc_statistics_match_jax(L, shape, seed):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, L + 1, size=shape)
    np.testing.assert_array_equal(tsbc.sbc_uniformity(ranks, L),
                                  jsbc.sbc_uniformity(ranks, L))
    np.testing.assert_array_equal(tsbc.sbc_ecdf_pvals(ranks, L, seed=seed),
                                  jsbc.sbc_ecdf_pvals(ranks, L, seed=seed))
    bad = np.zeros((shape[0], 2), int)
    assert (tsbc.sbc_uniformity(bad, L) < 1e-6).all()


@pytest.fixture(scope='module')
def plain():
    return BayesSetup(tm.map_cli_params(OV), device='cpu')


def test_same_truth_gives_the_same_dataset(plain, monkeypatch):
    jsetup = JaxSetup(tm.map_cli_params(OV))
    m_star, o_star, _ = tsbc.replicate_truth(plain, 0, 3)
    want = jpred.simulate_observations(jsetup, m_star, o_star,
                                       np.random.default_rng([5, 3]))
    jproj = jsetup.forward_projections(j_as_model(jnp.asarray(m_star)))
    rel, sent, grid = jproj
    t = lambda a: torch.from_numpy(np.array(a))
    monkeypatch.setattr(plain, 'forward_projections', lambda m: (
        tuple(t(r) for r in rel), tuple(t(s) for s in sent), t(grid)))
    got = tpred.simulate_observations(plain, m_star, o_star,
                                      np.random.default_rng([5, 3]))
    for a, b in zip(got['release'] + got['sentinel'] + [got['grid']],
                    want['release'] + want['sentinel'] + [want['grid']]):
        np.testing.assert_array_equal(a, b)
    assert sum(int(a.sum()) for a in got['release']) > 0


def test_replicate_truth_is_a_prior_draw_of_key_and_index(plain):
    from parasitoids_tpu_torch.bayes.priors import (log_prior_model,
                                                    log_prior_obs)
    from parasitoids_tpu_torch.bayes.model import _as_model, _as_obs
    a = tsbc.replicate_truth(plain, 0, 1)
    assert all(np.array_equal(x, y) for x, y in
               zip(a, tsbc.replicate_truth(plain, 0, 1)))
    assert not np.array_equal(a[0], tsbc.replicate_truth(plain, 0, 2)[0])
    assert not np.array_equal(a[0], tsbc.replicate_truth(plain, 1, 1)[0])
    m, o = torch.from_numpy(a[0]), torch.from_numpy(a[1])
    assert np.isfinite(float(log_prior_model(_as_model(m))))
    assert np.isfinite(float(log_prior_obs(_as_obs(o, plain.n_sent),
                                           plain.field_areas,
                                           plain.min_field_area)))


def test_sbc_checkpoint_resume_is_exact(plain, tmp_path):
    # test_validation.py:292 on the port: a study stopped after two
    # replicates and resumed is bitwise the uninterrupted one, also from
    # the durable twin alone; a checkpoint of another config is ignored
    kw = dict(n_samples=6, burn=3, thin=2, seed=3, sampler='am')
    full = tsbc.run_sbc(plain, 3, 0, **kw)
    assert full['L'] == 3 and full['ranks'].shape == (3, 25)
    assert (full['ranks'] >= 0).all() and (full['ranks'] <= 3).all()
    ck = str(tmp_path / 'sbc.ckpt.npz')
    tsbc.run_sbc(plain, 2, 0, checkpoint_path=ck, **kw)
    resumed = tsbc.run_sbc(plain, 3, 0, checkpoint_path=ck, **kw)
    assert resumed['resumed_at'] == 2
    np.testing.assert_array_equal(full['ranks'], resumed['ranks'])
    np.testing.assert_array_equal(full['truths'], resumed['truths'])
    ck2 = str(tmp_path / 'vm.ckpt.npz')
    tsbc.run_sbc(plain, 1, 0, checkpoint_path=ck2, **kw)
    os.remove(ck2)
    assert os.path.exists(str(tmp_path / 'vm_partial.npz'))
    again = tsbc.run_sbc(plain, 2, 0, checkpoint_path=ck2, **kw)
    assert again['resumed_at'] == 1
    np.testing.assert_array_equal(full['ranks'][:2], again['ranks'])
    fresh = tsbc.run_sbc(plain, 1, 0, checkpoint_path=ck,
                         **dict(kw, n_samples=8))
    assert fresh['resumed_at'] == 0


def test_sbc_pooled_chains(plain):
    # chains pool their thinned draws: L multiplies, ranks stay bounded
    out = tsbc.run_sbc(plain, 1, 0, n_samples=4, burn=2, thin=2, seed=3,
                       chains=2)
    assert out['L'] == 4
    assert (out['ranks'] >= 0).all() and (out['ranks'] <= 4).all()


NUTS = dict(n_samples=4, burn=2, thin=2, seed=5, sampler='nuts', max_depth=2)


def test_sbc_nuts_mechanics(plain):
    # truths conditioned on n_periods = 30, ranks over the constrained
    # draws of the gradient sampler (test_validation.py:363)
    out = tsbc.run_sbc(plain, 1, 1, **NUTS)
    assert out['ranks'].shape == (1, 25) and out['L'] == 2
    assert (out['ranks'] >= 0).all() and (out['ranks'] <= out['L']).all()
    assert (out['truths'][:, 13] == 30.0).all()
    step = tsbc.run_sbc(plain, 1, 1, stepwise=True, **NUTS)
    np.testing.assert_array_equal(out['ranks'], step['ranks'])


def test_sbc_warm_start_mechanics(plain, tmp_path):
    # the per-replicate Hessian metric runs, deterministically, and its
    # checkpoint does not resume an arm without it (test_validation.py:332)
    kw = dict(NUTS, warm_start=True)
    out = tsbc.run_sbc(plain, 1, 0, **kw)
    assert (out['ranks'] >= 0).all() and (out['ranks'] <= out['L']).all()
    ck = str(tmp_path / 'sbc_nuts.ckpt.npz')
    again = tsbc.run_sbc(plain, 1, 0, checkpoint_path=ck, **kw)
    np.testing.assert_array_equal(out['ranks'], again['ranks'])
    cold = tsbc.run_sbc(plain, 1, 0, checkpoint_path=ck,
                        **dict(kw, warm_start=False))
    assert cold['resumed_at'] == 0


def test_sbc_ridge_mechanics(plain):
    # per-replicate blend and whitening at the truth, Welford adaptation
    # on: valid, deterministic ranks (test_validation.py:363)
    kw = dict(NUTS, ridge=True)
    out = tsbc.run_sbc(plain, 1, 1, **kw)
    assert out['ranks'].shape == (1, 25)
    assert (out['ranks'] >= 0).all() and (out['ranks'] <= out['L']).all()
    assert np.isfinite(out['truths']).all()
    np.testing.assert_array_equal(out['ranks'],
                                  tsbc.run_sbc(plain, 1, 1, **kw)['ranks'])


def test_sbc_cli_writes_ranks_and_resumes(tmp_path, capsys):
    # the command line: the ranks .npz is the deliverable (the PNG only
    # where matplotlib is installed), --checkpoint resumes
    out = str(tmp_path / 'sbc')
    args = ['--replicates', '2', '--samples', '4', '--burn', '2', '--thin',
            '2', '--device', 'cpu', '-o', out] + OV
    full = tsbc.main(args)
    with np.load(out + '_ranks.npz') as d:
        np.testing.assert_array_equal(d['ranks'], full['ranks'])
        assert int(d['L']) == 2 and d['names'].shape == (25,)
    text = capsys.readouterr().out
    assert 'chi2 p' in text and ('wrote ' + out + '.png' in text or
                                 'figure skipped' in text)
    ck = str(tmp_path / 'c.ckpt.npz')
    one = list(args)
    one[1] = '1'
    tsbc.main(one + ['--checkpoint', ck])
    resumed = tsbc.main(args + ['--checkpoint', ck])
    assert resumed['resumed_at'] == 1
    np.testing.assert_array_equal(resumed['ranks'], full['ranks'])

"""Port parity of the MAP gradient path: ``BayesSetup.log_posterior``
(bayes/model.py), its gradient, ``map_fit`` and the ``--MAP`` CLI
(bayes/map_fit.py), against the JAX package at the small MAP configuration
of test_bayes_units.py:150-161 (3 days, 10 km / 50 cells, interp 2, K 6,
Kl 3).  The port's forward setup is built from the JAX setup's arrays
(``setup_from_numpy``), so both packages see the same wind bits.
Observations with a positive count over an expected count that is 0 in f64
are held out of both likelihoods (see ``exact_support_mask``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests._torch_parity import MAP_SMALL, exact_support_mask, torch

from parasitoids_tpu.bayes import map_fit as jm
from parasitoids_tpu.bayes import priors as jp
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu.bayes.sampler import _as_obs as jax_as_obs
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import priors as tp
from parasitoids_tpu_torch.bayes.model import BayesSetup, _as_model, _as_obs
from parasitoids_tpu_torch.models.forward import setup_from_numpy
from parasitoids_tpu_torch.ops import bvn as tbvn

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

_N_PERIODS = tp.MODEL_PARAM_NAMES.index('n_periods')


@pytest.fixture(scope='module')
def setups():
    """JAX and port setups at the small MAP configuration, and for each
    ``use_sprd`` the start z0 and the two setups with the roundoff-rate
    observations held out."""
    js = JaxSetup(tm.map_cli_params(MAP_SMALL))
    s = js.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    ts = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                    forward_setup=fs)
    ts64 = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                      dtype=torch.float64)
    held = {}
    for use_sprd in (True, False):
        z0 = tm.initial_z(ts, use_sprd)
        keep = exact_support_mask(ts64, z0, use_sprd)
        held[use_sprd] = (z0, keep, js.with_held_out(keep),
                          ts.with_held_out(keep))
    return js, ts, held


def _jax_value_and_grad(setup, use_sprd, z):
    neg, _, _ = jm._make_objective(setup, use_sprd)
    v, g = jax.jit(jax.value_and_grad(neg))(jnp.asarray(z))
    return float(v), np.asarray(g, np.float64)


def _port_value_and_grad(setup, use_sprd, z):
    neg, _, _ = tm._make_objective(setup, use_sprd)
    z = torch.as_tensor(np.asarray(z)).clone().requires_grad_()
    v = neg(z)
    v.backward()
    return float(v.detach()), z.grad.double().numpy()


@pytest.mark.parametrize('use_sprd', [True, False])
def test_log_posterior_value_and_gradient_match_jax(setups, use_sprd):
    _, _, held = setups
    z0, keep, js, ts = held[use_sprd]
    assert keep.mean() > 0.8            # most observations are scored
    want_v, want_g = _jax_value_and_grad(js, use_sprd, z0.numpy())
    got_v, got_g = _port_value_and_grad(ts, use_sprd, z0)
    assert np.isfinite(got_v) and np.all(np.isfinite(got_g))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    assert np.linalg.norm(got_g - want_g) <= 1e-4 * np.linalg.norm(want_g)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3,
                               atol=1e-5 * np.abs(want_g).max())
    # only n_periods (pinned at 30) has no gradient
    assert np.count_nonzero(want_g == 0) >= 1 and want_g[_N_PERIODS] == 0


def test_likelihood_parts_match_jax(setups):
    # the projections, the pointwise log-pmfs and their sum at the initial
    # values (with the pre-spread day), on the scored observations
    js, ts, held = setups
    z0, keep, _, _ = held[True]
    _, jconstrain, _ = jm._make_objective(js, True)
    m, o, sprd = jconstrain(jnp.asarray(z0.numpy()))
    jm_, jo_ = jp.ModelParams(*m), jax_as_obs(o, js.n_sent)
    jproj = js.forward_projections(jm_, sprd)
    _, tconstrain, _ = tm._make_objective(ts, True)
    tm_vec, to_vec, tsprd = tconstrain(z0)
    tm_, to_ = _as_model(tm_vec), _as_obs(to_vec, ts.n_sent)
    tproj = ts.forward_projections(tm_, tsprd)
    jflat = np.concatenate([np.ravel(p) for p in (*jproj[0], *jproj[1],
                                                  jproj[2])])
    tflat = torch.cat([p.reshape(-1) for p in (*tproj[0], *tproj[1],
                                               tproj[2])]).detach().numpy()
    scale = np.abs(jflat).max()
    np.testing.assert_allclose(tflat, jflat, rtol=1e-4, atol=1e-6 * scale)
    jpt = np.asarray(js.pointwise_loglik(jproj, jo_))
    tpt = ts.pointwise_loglik(tproj, to_).detach().numpy()
    np.testing.assert_allclose(tpt[keep], jpt[keep], rtol=1e-5, atol=1e-4)
    mask = ts.split_point_mask(keep)
    np.testing.assert_allclose(
        float(ts.log_likelihood(tproj, to_, obs_mask=mask)),
        float(tpt[keep].sum()), rtol=1e-6)


def test_n_periods_is_rounded_before_the_forward(setups):
    # a theta of 29.9999 runs a 30-period window, as in the JAX model
    # (jnp.round(n_periods), model.py:347); truncation would run 29
    js, ts, _ = setups
    m0 = tp.initial_model_params().astype(np.float32)
    runs = {}
    for n in (29.9999, 30.0, 29.0):
        v = m0.copy()
        v[_N_PERIODS] = n
        proj = ts.forward_projections(tp.ModelParams(*torch.from_numpy(v)))
        runs[n] = torch.cat([p.reshape(-1) for p in (*proj[0], *proj[1],
                                                     proj[2])])
    assert torch.equal(runs[29.9999], runs[30.0])
    assert not torch.equal(runs[29.0], runs[30.0])
    v = m0.copy()
    v[_N_PERIODS] = 29.9999
    jproj = js.forward_projections(jp.ModelParams(*jnp.asarray(v)))
    jflat = np.concatenate([np.ravel(p) for p in (*jproj[0], *jproj[1],
                                                  jproj[2])])
    np.testing.assert_allclose(runs[29.9999].numpy(), jflat, rtol=1e-4,
                               atol=1e-6 * np.abs(jflat).max())


def test_pre_spread_kernel_matches_jax(setups):
    js, ts, _ = setups
    m0 = tp.initial_model_params().astype(np.float32)
    want = np.asarray(js._pre_spread_kernel(
        jp.ModelParams(*jnp.asarray(m0)), jnp.float32(0.3)))
    got = ts._pre_spread_kernel(tp.ModelParams(*torch.from_numpy(m0)), 0.3)
    # cells are four-corner differences of O(1) CDF values: absolute f32
    # roundoff about one ulp of 1 (6e-8) in each package
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got.sum()), 1.0, rtol=1e-6)


def test_outside_support_returns_minus_inf_without_the_forward(setups,
                                                                monkeypatch):
    _, ts, _ = setups
    v = tp.initial_model_params().astype(np.float32)
    v[tp.MODEL_PARAM_NAMES.index('lam')] = 1.5
    o0 = tm.initial_z(ts, False)
    _, constrain, _ = tm._make_objective(ts, False)
    _, o_vec, _ = constrain(o0)

    def no_forward(*a, **k):
        raise AssertionError('the forward ran outside the support')

    monkeypatch.setattr(ts, 'forward_projections', no_forward)
    lp = ts.log_posterior(tp.ModelParams(*torch.from_numpy(v)),
                          _as_obs(o_vec, ts.n_sent))
    assert float(lp) == -np.inf


def test_log_posterior_reads_rho_once_per_evaluation(setups, monkeypatch):
    # the prior and both |rho| are read in one transfer; every BVN of the
    # forward (pre-spread day, each day's local kernel) gets its branch
    # from it and reads no rho itself (on the card each read is a wait)
    _, ts, held = setups
    z0 = held[True][0]
    neg, constrain, _ = tm._make_objective(ts, True)
    m = _as_model(constrain(z0)[0])
    want = [tbvn.genz_branch(abs(float(r))) for r in (m.corr, m.corr_l)]
    grid, seen = tbvn.bvn_upper_grid, []

    def spy(h, k, rho, phi_prod, branch=None):
        seen.append(branch)
        return grid(h, k, rho, phi_prod, branch)

    def no_read(abs_rho):
        raise AssertionError('a BVN read its rho on the host')

    monkeypatch.setattr(tbvn, 'bvn_upper_grid', spy)
    monkeypatch.setattr(tbvn, 'genz_branch', no_read)
    z = z0.clone().requires_grad_()
    neg(z).backward()
    assert torch.isfinite(z.grad).all()
    # each day's flight BVN (the CPU's plain accumulate; on the card it is
    # in the kernel, which reads rho on the device) and local BVN, then the
    # pre-spread day's two; the backward is closed-form and builds none
    assert seen == want * (ts.ndays + 1)


def test_map_fit_matches_jax(setups):
    # three Adam steps (torch.optim.Adam against optax.adam, lr 0.02) on
    # the same held-out objective: the losses agree to 1e-4
    _, _, held = setups
    _, _, js, ts = held[True]
    want = jm.map_fit(js, n_steps=3, use_sprd=True)
    got = tm.map_fit(ts, n_steps=3, use_sprd=True)
    assert got['losses'].shape == (3,)
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-4)
    assert got['losses'][-1] < got['losses'][0]
    np.testing.assert_allclose(got['logp'], want['logp'], rtol=1e-4)
    np.testing.assert_allclose(got['AIC'], want['AIC'], rtol=1e-4)
    np.testing.assert_allclose(got['z'], want['z'], rtol=1e-4, atol=1e-4)
    assert set(got) == set(want)


def test_observation_structures(setups):
    js, ts, _ = setups
    obs = {'release': [np.asarray(a) for a in ts.obs_release],
           'sentinel': [np.asarray(a) for a in ts.obs_sentinel],
           'grid': np.asarray(ts.obs_grid)}
    rel, sent, grid = ts.obs_pytree(obs)
    assert torch.equal(grid, ts.obs_grid)
    new = ts.with_observations(dict(obs, grid=obs['grid'] + 1.0))
    assert torch.equal(new.obs_grid, ts.obs_grid + 1.0)
    assert torch.equal(ts.obs_grid, grid)           # the original is intact
    with pytest.raises(ValueError, match='grid'):
        ts.obs_pytree(dict(obs, grid=obs['grid'][:1]))
    n = sum(int(np.prod(a.shape)) for a in (*rel, *sent, grid))
    keep = np.arange(n) % 3 > 0
    tm_mask = ts.split_point_mask(keep)
    jm_mask = js.split_point_mask(keep)
    for a, b in zip((*tm_mask[0], *tm_mask[1], tm_mask[2]),
                    (*jm_mask[0], *jm_mask[1], jm_mask[2])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match='keep_flat'):
        ts.split_point_mask(np.append(keep, True))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ts.with_forward_mesh(None)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ts.with_batched_bvn()
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tm._make_objective(ts, True, free_n=True)


def test_cli_writes_the_report(tmp_path, capsys):
    out = str(tmp_path / 'map_fit.txt')
    fit = tm.main(['--MAP', '--steps', '2', '-o', out, *MAP_SMALL],
                  device='cpu')
    printed = capsys.readouterr().out
    assert printed.splitlines()[0] == 'device cpu, accumulate plain torch'
    assert np.all(np.isfinite(fit['losses'])) and fit['use_sprd']
    with open(out) as f:
        report = f.read()
    assert report.startswith('MAP fit: logp = ')
    for name in (*tp.MODEL_PARAM_NAMES, *tp.OBS_PARAM_NAMES, 'sprd_factor'):
        assert '{} = '.format(name) in report


@pytest.mark.parametrize('flags', [['--norm'], ['--MAP', '--polish', '2'],
                                   ['--MAP', '--starts', '2'],
                                   ['--MAP', '--shard-forward']])
def test_cli_refuses_what_is_not_ported(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        tm.main(flags + list(MAP_SMALL), device='cpu')
    assert exc.value.code == 2
    assert 'ROADMAP' in capsys.readouterr().err

"""Port parity of the MAP gradient path: ``BayesSetup.log_posterior``
(bayes/model.py), its gradient, ``map_fit`` and the ``--MAP`` CLI
(bayes/map_fit.py), against the JAX package at the small MAP configuration
of test_bayes_units.py:150-161 (3 days, 10 km / 50 cells, interp 2, K 6,
Kl 3).  The port's forward setup is built from the JAX setup's arrays
(``setup_from_numpy``), so both packages see the same wind bits.
Observations with a positive count over an expected count that is 0 in f64
are held out of both likelihoods (see ``exact_support_mask``)."""

import math
from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from tests._torch_parity import (MAP_SMALL, NEAR_MODE, exact_support_mask,
                                 torch)

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
    # the local BVN, built once for every day, then each day's flight BVN
    # (the CPU's plain accumulate; on the card it is in the kernel, which
    # reads rho on the device), then the pre-spread day's two; the
    # backward is closed-form and builds none
    assert seen == [want[1]] + [want[0]] * ts.ndays + want


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
    # the forward-mesh copy (once refused): a mesh led by another device is
    # refused, None routes the forward back, the original is untouched
    from parasitoids_tpu_torch.parallel.domain import minute_mesh
    fm = ts.with_forward_mesh(minute_mesh(devices=['cpu'] * 2))
    assert fm.forward_mesh.size == 2 and ts.forward_mesh is None
    assert fm.with_forward_mesh(None).forward_mesh is None
    with pytest.raises(ValueError, match='lead'):
        ts.with_forward_mesh(minute_mesh(devices=['meta', 'meta']))
    # the ensemble-batched copy (once refused): its kernel configuration is
    # JAX's with_batched_bvn() one, and the original is untouched
    tb, jb = ts.with_batched_bvn(), js.with_batched_bvn()
    assert tb.setup.kcfg.batched_bvn and jb.setup.kcfg.batched_bvn
    assert not ts.setup.kcfg.batched_bvn
    assert (tb.setup.kcfg.K, tb.setup.kcfg.K_local) == (jb.setup.kcfg.K,
                                                        jb.setup.kcfg.K_local)
    # the NUTS and SBC forms of the objective: n_periods and the dataset
    # as arguments, never both
    with pytest.raises(ValueError, match='exclusive'):
        tm._make_objective(ts, True, free_n=True, traced_obs=True)
    _, constrain_n, _ = tm._make_objective(ts, True, free_n=True)
    z0 = tm.initial_z(ts, True)
    assert float(constrain_n(z0, 29.0)[0][_N_PERIODS]) == 29.0


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


@pytest.mark.parametrize('flags', [['--MAP', '--shard-forward',
                                    '--starts', '2']])
def test_cli_refuses_what_is_not_ported(flags, capsys):
    # (the name is the test's from before the sharded forward was ported)
    # --shard-forward runs (test_torch_parallel.py); with --starts > 1 it
    # is refused, as the JAX command line refuses it
    with pytest.raises(SystemExit) as exc:
        tm.main(flags + list(MAP_SMALL), device='cpu')
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert 'incompatible with --starts > 1' in err


@pytest.mark.parametrize('flags', [['--norm'], ['--norm', '--polish', '2'],
                                   ['--norm', '--starts', '2']])
def test_cli_norm_runs_the_laplace_approximation(flags, tmp_path, capsys):
    # --norm: MAP (alone, polished or multi-start), then the Laplace
    # approximation on the plain path; the report adds the log evidence
    # and each parameter's sd
    out = str(tmp_path / 'map_fit.txt')
    fit = tm.main(flags + ['--steps', '2', '-o', out, *MAP_SMALL],
                  device='cpu')
    printed = capsys.readouterr().out
    assert ('laplace: Hessian on the plain path in float32, 26 columns'
            in printed)
    lap = fit['laplace']
    assert lap['hess_z'].shape == (26, 26) and lap['precision'] == 'float32'
    assert np.isfinite(lap['sd_theta']).all() and lap['sd_theta'].shape == (
        25,)
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines[1].startswith('Laplace log-evidence (n_periods fixed): ')
    assert all('(sd ' in line for line in lines[2:-1])
    assert lines[-1].strip().startswith('sprd_factor = ')


# ---------------------------------------------------------------------------
# the first-order rest of map_fit and the NUTS target (bayes/nuts.py)
# ---------------------------------------------------------------------------

def _assert_value_and_grad(got, want):
    """test_log_posterior_value_and_gradient_match_jax's tolerances."""
    (got_v, got_g), (want_v, want_g) = got, want
    assert np.isfinite(got_v) and np.all(np.isfinite(got_g))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    assert np.linalg.norm(got_g - want_g) <= 1e-4 * np.linalg.norm(want_g)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3,
                               atol=1e-5 * np.abs(want_g).max())


def _torch_vg(f, z, *args):
    z = torch.as_tensor(np.asarray(z)).clone().requires_grad_()
    v = f(z, *args)
    v.backward()
    return float(v.detach()), z.grad.double().numpy()


def _jax_vg(f, z, *args):
    v, g = jax.value_and_grad(f)(jnp.asarray(np.asarray(z)), *args)
    return float(v), np.asarray(g, np.float64)


def _scaled_counts(setup):
    """The setup's observations with every positive count doubled (the
    zero counts, and so the held-out set, unchanged)."""
    return {'release': [2.0 * np.asarray(a) for a in setup.obs_release],
            'sentinel': [2.0 * np.asarray(a) for a in setup.obs_sentinel],
            'grid': 2.0 * np.asarray(setup.obs_grid)}


def test_free_n_and_traced_obs_objectives_match_jax(setups):
    # neg_logpost(z, n) and neg_logpost(z, obs) and their gradients
    _, _, held = setups
    z0, _, js, ts = held[False]
    jneg, _, _ = jm._make_objective(js, False, free_n=True)
    tneg, _, _ = tm._make_objective(ts, False, free_n=True)
    for n in (29.0, 30.0, 31.0):
        _assert_value_and_grad(_torch_vg(tneg, z0, n),
                               _jax_vg(jneg, z0, jnp.float32(n)))
    fixed, _, _ = tm._make_objective(ts, False)
    np.testing.assert_allclose(_torch_vg(tneg, z0, 30.0)[0],
                               _torch_vg(fixed, z0)[0], rtol=1e-7)
    y = _scaled_counts(ts)
    jneg, _, _ = jm._make_objective(js, False, traced_obs=True)
    tneg, _, _ = tm._make_objective(ts, False, traced_obs=True)
    _assert_value_and_grad(_torch_vg(tneg, z0, ts.obs_pytree(y)),
                           _jax_vg(jneg, z0, js.obs_pytree(y)))


@pytest.mark.parametrize('form', ['fixed_n', 'free_n', 'traced_obs'])
def test_transformed_logpdf_matches_jax(setups, form):
    # the NUTS target: the unconstrained log posterior with the
    # bijections' log-Jacobian, at z0 and at a seeded nearby point; with
    # n_periods or the dataset as an argument
    from parasitoids_tpu.bayes import nuts as jn
    from parasitoids_tpu_torch.bayes import nuts as tn
    _, _, held = setups
    z0, _, js, ts = held[False]
    kw = {} if form == 'fixed_n' else {form: True}
    jlp, _, jz0 = jn.make_transformed_logpdf(js, **kw)
    tlp, tconstrain, tz0 = tn.make_transformed_logpdf(ts, **kw)
    np.testing.assert_allclose(tz0.numpy(), np.asarray(jz0), rtol=1e-6,
                               atol=1e-7)
    if form == 'free_n':
        targs, jargs = (29.0,), (jnp.float32(29.0),)
    elif form == 'traced_obs':
        y = _scaled_counts(ts)
        targs, jargs = (ts.obs_pytree(y),), (js.obs_pytree(y),)
    else:
        targs = jargs = ()
    z1 = z0.numpy() + 0.05 * np.random.default_rng(0).standard_normal(
        z0.shape[0]).astype(np.float32)
    for z in (z0.numpy(), z1):
        _assert_value_and_grad(_torch_vg(tlp, z, *targs),
                               _jax_vg(jlp, z, *jargs))
        np.testing.assert_allclose(
            float(tlp.log_jacobian(torch.from_numpy(z))),
            float(jlp.log_jacobian(jnp.asarray(z))), rtol=1e-5)
    if form == 'free_n':
        assert float(tconstrain(z0, 29.0)[0][_N_PERIODS]) == 29.0


def test_lbfgs_polish_matches_jax(setups):
    # optax's L-BFGS and torch's take different paths; from the same start
    # near the mode their optima agree to 1e-3 of the log posterior, and
    # from map_fit's point the polish climbs most of the way
    _, _, held = setups
    _, _, js, ts = held[False]
    start = np.asarray(NEAR_MODE, np.float32)
    want = jm.lbfgs_polish(js, start, n_steps=10, use_sprd=False)
    got = tm.lbfgs_polish(ts, start, n_steps=10, use_sprd=False)
    assert got['logp'] >= _torch_vg(tm._make_objective(ts, False)[0],
                                    start)[0] * -1.0 - 1e-3
    np.testing.assert_allclose(got['logp'], want['logp'], rtol=1e-3)
    assert set(got) == set(want)
    adam = tm.map_fit(ts, n_steps=5, use_sprd=False)
    polished = tm.lbfgs_polish(ts, adam['z'], n_steps=30, use_sprd=False)
    assert polished['losses'].shape == (30,)
    assert polished['logp'] > 0.99 * adam['logp']     # -29253 -> about -66
    assert np.all(np.diff(polished['losses']) <= 1e-3)


def test_multistart_runs_the_reference_start_first(setups):
    # start 0 is map_fit's own run, bit for bit (held to JAX above); the
    # other starts are prior draws; the best start's fit is returned
    _, _, held = setups
    _, _, _, ts = held[True]
    fit = tm.map_fit(ts, n_steps=3, use_sprd=True)
    multi = tm.map_fit_multistart(ts, n_starts=3, seed=2, n_steps=3,
                                  use_sprd=True)
    assert multi['start_logps'].shape == (3,)
    assert multi['start_logps'][0] == -fit['losses'][-1]
    assert multi['best_start'] == int(np.argmax(multi['start_logps']))
    assert set(multi) == set(fit) | {'start_logps', 'best_start'}
    again = tm.map_fit_multistart(ts, n_starts=3, seed=2, n_steps=3,
                                  use_sprd=True)
    np.testing.assert_array_equal(again['start_logps'], multi['start_logps'])
    other = tm.map_fit_multistart(ts, n_starts=3, seed=3, n_steps=3,
                                  use_sprd=True)
    assert other['start_logps'][0] == multi['start_logps'][0]
    assert not np.array_equal(other['start_logps'][1:],
                              multi['start_logps'][1:])
    # the starts sharded over a mesh run as in turn, bit for bit
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    meshed = tm.map_fit_multistart(ts, n_starts=3, seed=2, n_steps=3,
                                   use_sprd=True,
                                   mesh=chain_mesh(devices=['cpu'] * 3))
    np.testing.assert_array_equal(meshed['start_logps'],
                                  multi['start_logps'])
    np.testing.assert_array_equal(meshed['z'], multi['z'])
    with pytest.raises(ValueError, match='divisible'):
        tm.map_fit_multistart(ts, n_starts=3, n_steps=1,
                              mesh=chain_mesh(devices=['cpu'] * 2))


def test_cli_polish_starts_and_seed(tmp_path, capsys):
    out = str(tmp_path / 'map_fit.txt')
    fit = tm.main(['--MAP', '--steps', '2', '--starts', '2', '--seed', '1',
                   '--polish', '2', '-o', out, *MAP_SMALL], device='cpu')
    printed = capsys.readouterr().out
    assert 'multistart: best start' in printed
    assert 'L-BFGS polish: logp' in printed
    assert np.isfinite(fit['logp']) and fit['losses'].shape[0] <= 2
    with open(out) as f:
        assert f.read().startswith('MAP fit: logp = ')


def test_nuts_transition_replays_jax(setups):
    # one transition of the parasitoid target near its mode with JAX's
    # draws: the same leapfrogs, choices and proposal
    from parasitoids_tpu.bayes import nuts as jn
    from parasitoids_tpu_torch.bayes import nuts as tn
    from tests.test_torch_nuts import CLEAR, _jax_draws
    _, _, held = setups
    _, _, js, ts = held[False]
    jlp, _, _ = jn.make_transformed_logpdf(js)
    tlp, _, _ = tn.make_transformed_logpdf(ts)
    z = jnp.asarray(np.asarray(NEAR_MODE, np.float32))
    inv_mass = np.full(z.shape[0], 0.01, np.float32)
    step, depth = np.float32(0.2), 3
    jlpg = jax.value_and_grad(jlp)
    jstep = jax.jit(partial(jn._nuts_step, jlpg, jnp.asarray(inv_mass), step,
                            depth))
    tlpg = tn.value_and_grad(tlp)
    lp, g = jlpg(z)
    tz = torch.from_numpy(np.array(z))
    tlp0, tg = tlpg(tz)
    compared, leaves = 0, set()
    for seed in range(3):
        want = jstep(z, lp, g, random.PRNGKey(seed))
        decisions = []
        got = tn._nuts_step(tlpg, torch.from_numpy(inv_mass),
                            torch.tensor(step), depth, tz, tlp0, tg,
                            _jax_draws(random.PRNGKey(seed), z.shape[0],
                                       depth), decisions=decisions)
        if min([abs(float(u) - float(t)) for u, t in decisions
                if math.isfinite(float(t))] or [1.0]) <= CLEAR:
            continue
        compared += 1
        assert got[4] == int(want[4]) and bool(got[5]) == bool(want[5])
        leaves.add(got[4])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
        np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-4,
                                   atol=1e-5)
    assert compared >= 2 and max(leaves) > 1, leaves
    assert not torch.equal(got[0], tz)          # the chain moved


_HOST_READS = ('item', 'tolist', 'numpy', 'cpu', '__bool__', '__float__',
               '__int__', '__index__')


def test_nuts_transition_reads_the_device_once_per_leapfrog(setups,
                                                            monkeypatch):
    # on the card every conversion of a tensor to a Python value waits for
    # the device: a transition reads it once per leapfrog, in the
    # evaluation's own transfer (BayesSetup._branches, which carries the
    # tree's decision as its gate), plus once where a gate stops it; the
    # step-size search likewise
    from parasitoids_tpu_torch.bayes import nuts as tn
    _, _, held = setups
    _, _, _, ts = held[False]
    tlp, _, _ = tn.make_transformed_logpdf(ts)
    lpg = tn.value_and_grad(tlp)
    z = torch.tensor(NEAR_MODE)
    lp, g = lpg(z)                     # constants made once, off the count
    gen = torch.Generator().manual_seed(0)
    draws = [tn.draw_transition(gen, z.shape[0], 4, torch.float32)
             for _ in range(3)]
    xi = torch.randn(z.shape[0], generator=gen)
    inv_mass = torch.full((z.shape[0],), 0.01)
    calls = []
    real_branches = type(ts)._branches
    real_tolist = torch.Tensor.tolist

    def no_read(*a, **k):
        raise AssertionError('a tensor was read on the host')

    def no_copy(*a, **k):
        raise AssertionError('host data was copied to the device')

    def counting_branches(self, m, prior=None, gate=None):
        calls.append(gate is not None)
        monkeypatch.setattr(torch.Tensor, 'tolist', real_tolist)
        try:
            return real_branches(self, m, prior, gate)
        finally:
            monkeypatch.setattr(torch.Tensor, 'tolist', no_read)

    monkeypatch.setattr(type(ts), '_branches', counting_branches)
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, no_read)
    for name in ('as_tensor', 'tensor', 'from_numpy'):
        monkeypatch.setattr(torch, name, no_copy)
    try:
        runs = []
        for d, step in zip(draws, (0.05, 0.2, 0.6)):
            before = len(calls)
            out = tn._nuts_step(lpg, inv_mass, torch.full((), step), 4, z,
                                lp, g, d)
            runs.append((out[4], len(calls) - before))
        before = len(calls)
        tn._find_reasonable_eps(lpg, z, lp, g, inv_mass, xi, 0.1)
        eps_reads = len(calls) - before
    finally:
        monkeypatch.undo()
    for n_leaf, reads in runs:
        assert n_leaf <= reads <= n_leaf + 1 <= 2 * n_leaf, runs
    assert any(n < 15 for n, _ in runs), runs    # a tree stopped on a gate
    assert 2 <= eps_reads <= 31

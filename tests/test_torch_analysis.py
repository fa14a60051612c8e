"""Port parity of the analysis of a saved trace: predictive checks
(``bayes/predictive.py``), the pointwise log likelihood, WAIC, PSIS-LOO
and ``loo_compare`` (``bayes/loo.py``), spread maps (``bayes/spread.py``),
power-scaling sensitivity (``bayes/sensitivity.py``), the
identifiability summary (``bayes/identify.py``) and the one-command
report (``bayes/summary.py``), against the JAX package at the small MAP
configuration of test_bayes_units.py:150-161.  Both packages get the same
trace (24 draws around a point near the mode, made from a seed) and the
same seed.  The observed counts are replaced, in both, by the same counts
with 0 where a positive count sits over an expected count that is 0 in
f64: there the f32 FFT roundoff of each package's projection would set the
log-pmf (``tests/_torch_parity.support_mask_at``).  Tolerances are about
ten times the readings noted beside them."""

import os
import re

import numpy as np
import pytest
import jax
from jax import random

from tests._torch_parity import MAP_SMALL, support_mask_at, torch
from tests.test_torch_ensemble import draws_near_mode

from parasitoids_tpu.bayes import identify as jid
from parasitoids_tpu.bayes import loo as jloo
from parasitoids_tpu.bayes import predictive as jpred
from parasitoids_tpu.bayes import priors as jp
from parasitoids_tpu.bayes import sensitivity as jsens
from parasitoids_tpu.bayes import spread as jspread
from parasitoids_tpu.bayes import summary as jsum
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu.parallel import ensemble as je
from parasitoids_tpu_torch.bayes import identify as tid
from parasitoids_tpu_torch.bayes import loo as tloo
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import predictive as tpred
from parasitoids_tpu_torch.bayes import sensitivity as tsens
from parasitoids_tpu_torch.bayes import spread as tspread
from parasitoids_tpu_torch.bayes import summary as tsum
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.models.forward import setup_from_numpy
from parasitoids_tpu_torch.parallel import ensemble as te

pytestmark = [
    pytest.mark.filterwarnings('ignore:simulation covers:RuntimeWarning'),
    pytest.mark.filterwarnings('ignore:More than 20 figures'),
    pytest.mark.filterwarnings('ignore:invalid value:RuntimeWarning')]

DRAWS = 24        # PSIS fits a tail from 21 draws up


@pytest.fixture(scope='module')
def analysis():
    """JAX and port setups on the same observed data, the trace, and each
    package's pointwise matrix of it."""
    js = JaxSetup(tm.map_cli_params(MAP_SMALL))
    s = js.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    ts = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                    forward_setup=fs)
    ts64 = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                      dtype=torch.float64)
    m, o = draws_near_mode(ts, DRAWS, seed=1)
    logp = -100.0 + np.random.default_rng(2).standard_normal(DRAWS)
    traces = np.concatenate([m, o, logp[:, None].astype(np.float32)],
                            axis=1).reshape(2, DRAWS // 2, -1)
    keep = support_mask_at(ts64, m)
    obs, pos = {}, 0
    for key, group in (('release', ts.obs_release),
                       ('sentinel', ts.obs_sentinel),
                       ('grid', [ts.obs_grid])):
        arrs = []
        for a in group:
            a = a.numpy()
            arrs.append(np.where(keep[pos:pos + a.size].reshape(a.shape),
                                 a, 0.0))
            pos += a.size
        obs[key] = arrs if key != 'grid' else arrs[0]
    js, ts = js.with_observations(obs), ts.with_observations(obs)
    pw_t = tloo.pointwise_matrix(ts, traces, n_draws=DRAWS, seed=3)
    pw_j = jloo.pointwise_matrix(js, traces, n_draws=DRAWS, seed=3)
    return js, ts, traces, pw_j, pw_t


def jax_projections(js):
    """A stand-in for the port's ``ensemble_projections`` that returns the
    JAX package's projections.  A rate that is 0 in one package and f32
    roundoff in the other makes numpy's Poisson sampler take another
    number of uniforms, and every later count of the stream differs; on
    JAX's projections the port must sample JAX's counts exactly (the
    projections themselves are held to JAX in test_torch_ensemble.py)."""
    def projections(setup, thetas, mesh=None):
        rel, sent, grid = je.ensemble_projections(js, thetas)
        t = lambda a: torch.from_numpy(np.array(a))
        return tuple(map(t, rel)), tuple(map(t, sent)), t(grid)
    return projections


def test_posterior_predictive_matches_jax(analysis, monkeypatch):
    # the same draws and rates within f32 noise (reading: 1.6e-7 of the
    # largest); on JAX's projections, the same counts and p-values
    js, ts, traces, _, _ = analysis
    got = tpred.posterior_predictive(ts, traces, n_draws=8, seed=5)
    want = jpred.posterior_predictive(js, traces, n_draws=8, seed=5)
    np.testing.assert_array_equal(got['draw_rows'], want['draw_rows'])
    scale = np.abs(want['grid_rate']).max()
    assert np.abs(got['grid_rate'] - want['grid_rate']).max() <= 2e-6 * scale
    monkeypatch.setattr(te, 'ensemble_projections', jax_projections(js))
    got = tpred.posterior_predictive(ts, traces, n_draws=8, seed=5)
    np.testing.assert_array_equal(got['grid_rate'], want['grid_rate'])
    np.testing.assert_array_equal(got['grid'], want['grid'])
    for key in ('release', 'sentinel'):
        for g, w in zip(got[key], want[key]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert (tpred.predictive_pvalues(ts, got)
            == jpred.predictive_pvalues(js, want))
    assert tpred.pvalue_report(tpred.predictive_pvalues(ts, got)) == \
        jpred.pvalue_report(jpred.predictive_pvalues(js, want))


def _jax_prior_blocks(js, n, seed):
    """The model and observation draws of JAX's ``prior_predictive`` (and
    ``identify.prior_sds``), replayed from its keys."""
    k_m, k_o = random.split(random.PRNGKey(seed))
    m = jax.vmap(jp.sample_prior_model)(random.split(k_m, n))
    o = jax.vmap(lambda k: jp.sample_prior_obs(
        k, js.field_areas, js.min_field_area, 'poisson'))(
            random.split(k_o, n))
    return np.asarray(m), np.asarray(o)


def test_prior_predictive_replays_jax(analysis, monkeypatch):
    js, ts, _, _, _ = analysis
    draws = _jax_prior_blocks(js, 4, 2)
    want = jpred.prior_predictive(js, n_draws=4, seed=2)
    got = tpred.prior_predictive(ts, n_draws=4, seed=2, draws=draws)
    scale = np.abs(want['grid_rate']).max()
    assert np.abs(got['grid_rate'] - want['grid_rate']).max() <= 2e-6 * scale
    monkeypatch.setattr(te, 'ensemble_projections', jax_projections(js))
    got = tpred.prior_predictive(ts, n_draws=4, seed=2, draws=draws)
    np.testing.assert_array_equal(got['grid'], want['grid'])
    assert (tpred.predictive_pvalues(ts, got)
            == jpred.predictive_pvalues(js, want))
    # the port's own prior draws: the seed fixes them
    a = tpred.prior_draws(ts, 3, seed=4)
    np.testing.assert_array_equal(a[0], tpred.prior_draws(ts, 3, seed=4)[0])
    assert a[0].shape == (3, 15) and a[1].shape == (3, 10)


def test_pointwise_matrix_and_criteria_match_jax(analysis):
    # readings: the pointwise log-pmfs within 1.9e-6 of each other (of
    # values up to 8.5); the criteria within 1e-6 of themselves.  A column
    # whose counts are 0 over a rate that is 0 in f64 holds only f32
    # roundoff (|ll| < 1e-6, 1e-10 in the port and 4.8e-7 in JAX): its
    # Pareto tail is noise, so khat is compared on the other columns
    _, ts, _, (ll_j, take_j), (ll_t, take_t) = analysis
    np.testing.assert_array_equal(take_t, take_j)
    assert ll_t.dtype == np.float64 and ll_t.shape == ll_j.shape == (
        DRAWS, 505)
    assert np.abs(ll_t - ll_j).max() <= 2e-5
    w_t, w_j = tloo.waic(ll_t), jloo.waic(ll_j)
    l_t, l_j = tloo.psis_loo(ll_t), jloo.psis_loo(ll_j)
    real = np.abs(ll_j).max(axis=0) > 1e-3
    assert 30 < real.sum() < 505
    noise_keys = ('khat', 'n_bad_khat', 'khat_max')
    for got, want in ((w_t, w_j), (l_t, l_j)):
        assert set(got) == set(want)
        for k in set(got) - set(noise_keys):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=2e-5, err_msg=k)
    np.testing.assert_allclose(l_t['khat'][real], l_j['khat'][real],
                               rtol=1e-3, atol=1e-4)
    assert np.isfinite(l_t['khat']).any()
    gids, labels = tloo.point_groups(ts, by='date')
    jgids, jlabels = jloo.point_groups(ts, by='date')
    np.testing.assert_array_equal(gids, jgids)
    assert labels == jlabels and tloo.point_labels(ts) == jloo.point_labels(
        ts)
    g_t = tloo.psis_loo(tloo.group_loglik(ll_t, gids))
    g_j = jloo.psis_loo(jloo.group_loglik(ll_j, gids))
    np.testing.assert_allclose(g_t['elpd_loo'], g_j['elpd_loo'], rtol=1e-4)
    assert tloo.loo_compare(l_t, l_t) == jloo.loo_compare(l_j, l_j) == {
        'elpd_diff': 0.0, 'se_diff': 0.0}
    half = {**l_t, 'elpd_pointwise': 0.5 * l_t['elpd_pointwise']}
    np.testing.assert_allclose(
        list(tloo.loo_compare(l_t, half).values()),
        list(jloo.loo_compare(l_j, {**l_j, 'elpd_pointwise':
                                    0.5 * l_j['elpd_pointwise']}).values()),
        rtol=1e-4)
    assert tloo.report(w_t, l_t, labels=tloo.point_labels(ts)).count(
        '\n') == jloo.report(w_j, l_j, labels=jloo.point_labels(ts)).count(
            '\n')


def test_posterior_spread_matches_jax(analysis):
    # readings: the quantile maps and the mean within 2.0e-7 of the
    # largest cell
    js, ts, traces, _, _ = analysis
    got = tspread.posterior_spread(ts, traces, n_draws=6, days=[1, 3],
                                   seed=7)
    want = jspread.posterior_spread(js, traces, n_draws=6, days=[1, 3],
                                    seed=7)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['draw_rows'], want['draw_rows'])
    np.testing.assert_array_equal(got['days'], want['days'])
    assert got['maps'].shape == want['maps'].shape == (3, 2, 101, 101)
    for k in ('maps', 'mean'):
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 2e-6 * scale, k
    with pytest.raises(ValueError, match='outside the simulated range'):
        tspread.posterior_spread(ts, traces, n_draws=2, days=[4])


def test_sensitivity_from_trace_matches_jax(analysis):
    # each package's own pointwise matrix and log prior (readings: the
    # sensitivities within 4.9e-5 of themselves, the weights' khat 2.0e-3)
    js, ts, traces, pw_j, pw_t = analysis
    got = tsens.sensitivity_from_trace(ts, traces, n_draws=DRAWS, seed=3,
                                       pointwise=pw_t)
    want = jsens.sensitivity_from_trace(js, traces, n_draws=DRAWS, seed=3,
                                        pointwise=pw_j)
    assert got['names'] == want['names'] and got['n_draws'] == DRAWS
    for k in ('prior_sens', 'lik_sens'):
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=1e-9,
                                   err_msg=k)
    assert got['diagnosis'] == want['diagnosis']
    for scaling in ('prior', 'lik'):
        np.testing.assert_allclose(list(got['khat'][scaling].values()),
                                   list(want['khat'][scaling].values()),
                                   rtol=2e-2)
    assert tsens.report(got).splitlines()[0] == jsens.report(
        want).splitlines()[0]


def test_identify_report_matches_jax(analysis):
    # the same fit, Laplace approximation and prior draws through both
    # packages' summaries: the same report
    js, ts, _, _, _ = analysis
    from tests._torch_parity import NEAR_MODE
    z = np.asarray(NEAR_MODE, np.float32)
    fit = tm._fit_dict(ts, False, torch.as_tensor(z), np.zeros(0))
    lap = tm.laplace_approximation(ts, fit)
    got = tid.identifiability(ts, fit, lap, n_prior=500, seed=1,
                              prior_draws=_jax_prior_blocks(js, 500, 1))
    want = jid.identifiability(js, fit, lap, n_prior=500, seed=1)
    for k in ('prior_sd', 'post_sd', 'contraction', 'corr', 'eig_sd'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                   equal_nan=True, err_msg=k)
    assert got['names'] == want['names'] and got['z_names'] == want[
        'z_names'] and got['n_nonpsd'] == want['n_nonpsd']
    assert tid.identify_report(got) == jid.identify_report(want)
    # the port's own prior draws: slot 13 (n_periods ~ Poisson(30)) has a
    # prior sd near sqrt(30)
    own = tid.prior_sds(ts, n=2000, seed=0)
    assert own.shape == (25,) and abs(own[13] - 30 ** 0.5) < 0.5


def _numbers(line):
    return [float(v) for v in re.findall(r'[-+]?\d+\.\d+(?:e[-+]?\d+)?',
                                         line)]


def _sections(text):
    return [line for line in text.splitlines() if line.startswith('## ')]


def test_build_report_matches_jax(analysis, tmp_path, monkeypatch):
    # the same sections; the posterior table and diagnostics to the
    # character; the elpd lines, p-values and flagged parameters.  The
    # port's ensemble returns JAX's projections, so that both sample one
    # stream of predictive counts (see jax_projections); the spread maps
    # run the port's own forward
    js, ts, traces, _, _ = analysis
    monkeypatch.setattr(te, 'ensemble_projections', jax_projections(js))
    reports = {}
    for name, mod, setup in (('jax', jsum, js), ('port', tsum, ts)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        path = mod.build_report(setup, traces, str(d / 'run.npz'),
                                draws=DRAWS, seed=3)
        with open(path) as fh:
            reports[name] = fh.read()
        assert os.path.basename(path) == 'run_report.md'
    got, want = reports['port'], reports['jax']
    assert _sections(got) == _sections(want) == [
        '## Posterior', '## Convergence', '## Figures',
        '## Posterior-predictive p-values',
        '## Predictive assessment (leave-one-date-out)',
        '## Prior/likelihood sensitivity (power-scaling)']
    assert got.split('## Figures')[0] == want.split('## Figures')[0]

    def block(text, start, end):
        return text.split(start)[1].split(end)[0]

    assert block(got, '## Posterior-predictive p-values', '## Predictive') \
        == block(want, '## Posterior-predictive p-values', '## Predictive')
    for key in ('- WAIC elpd', '- PSIS-LOO elpd'):
        g = [line for line in got.splitlines() if line.startswith(key)]
        w = [line for line in want.splitlines() if line.startswith(key)]
        np.testing.assert_allclose(_numbers(g[0]), _numbers(w[0]),
                                   rtol=1e-4, atol=0.011)
    flagged = [[line for line in t.splitlines()
                if line.startswith(('- flagged', '- no parameter'))]
               for t in (got, want)]
    assert flagged[0] == flagged[1]


def test_summary_and_analysis_clis_run(analysis, tmp_path, monkeypatch,
                                       capsys):
    # the CLIs on a trace file of the shape every sampler writes (the
    # JAX and the port's stores are npz with 'traces'), on the CPU, from
    # a directory that sees the repository's data (the figures of the
    # report and of --prior land in the working directory)
    _, _, traces, _, _ = analysis
    os.symlink(os.path.abspath('data'), str(tmp_path / 'data'))
    monkeypatch.chdir(tmp_path)
    db = str(tmp_path / 'run.npz')
    np.savez(db, traces=traces)
    ov = ['--device', 'cpu'] + list(MAP_SMALL)
    out = tsum.main([db, '--draws', '4', '--group', 'block'] + ov)
    assert out == str(tmp_path / 'run_report.md')
    with open(out) as fh:
        assert len(_sections(fh.read())) == 6
    tpred.main([db, '--draws', '4', '--json'] + ov)
    assert os.path.exists(str(tmp_path / 'run_ppc4.json'))
    payload = tloo.main([db, '--draws', '4'] + ov)
    assert payload['n_draws'] == 4 and payload['n_points'] == 505
    spr = tspread.main([db, '--draws', '3', '--days', '1,3'] + ov)
    assert spr['maps'].shape == (3, 2, 101, 101)
    res = tsens.main([db, '--draws', '4'] + ov)
    assert len(res['names']) == 25
    printed = capsys.readouterr().out
    for name in ('run_predictive.png', 'run_loo.json', 'run_spread.npz',
                 'run_sensitivity.npz'):
        assert name in printed
    pv = tpred.main(['--prior', '--draws', '3'] + ov)
    assert 'grid' in pv and os.path.exists('prior_predictive.png')

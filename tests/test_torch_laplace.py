"""Port parity of the second-order rest of ``bayes/map_fit.py``: the
Hessian (reverse over reverse through the twice-differentiable BVN
backward), the Laplace approximation, the prior-variance Monte Carlo, the
prior-curvature blend and the NUTS warm metric, against the JAX package at
the small MAP configuration of test_bayes_units.py:150-161 (3 days, 10 km /
50 cells, interp 2, K 6, Kl 3) at a point near the mode (``NEAR_MODE``,
no pre-spread day).  The port's forward setup is built from the JAX
setup's arrays; observations with a positive count over an expected count
that is 0 in f64 are held out of both likelihoods (``exact_support_mask``).
Tolerances are about ten times the readings noted beside them."""

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
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.models.forward import setup_from_numpy

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

_N_PERIODS = 13


@pytest.fixture(scope='module')
def near_mode():
    """JAX and port setups at the small MAP configuration with the
    roundoff-rate observations at ``NEAR_MODE`` held out, the port's f64
    setup with the same mask, the point, and JAX's Laplace approximation
    there."""
    js = JaxSetup(tm.map_cli_params(MAP_SMALL))
    s = js.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    ts = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                    forward_setup=fs)
    ts64 = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                      dtype=torch.float64)
    z = np.asarray(NEAR_MODE, np.float32)
    keep = exact_support_mask(ts64, z, False)
    js, ts, ts64 = (x.with_held_out(keep) for x in (js, ts, ts64))
    return js, ts, ts64, z, jm.laplace_approximation(js, _fit(ts, z))


def _fit(setup, z):
    """A ``map_fit``-shaped dict at ``z`` (no pre-spread day)."""
    return tm._fit_dict(setup, False, torch.as_tensor(z), np.zeros(0))


def test_hessian_columns_match_jax(near_mode):
    # f32 reverse over reverse against JAX's forward over reverse through
    # the XLA twin (reading: 1.5e-7 of the largest entry)
    _, ts, _, z, lap_jax = near_mode
    H_jax = lap_jax['hess_z']
    neg, _, _ = tm._make_objective(ts, False)
    H = tm.hessian_columns(neg, torch.as_tensor(z))
    assert H.dtype == torch.float32 and H.shape == (25, 25)
    H = H.double().numpy()
    scale = np.abs(H_jax).max()
    assert np.abs(H - H_jax).max() <= 2e-6 * scale
    # the pinned n_periods slot enters nowhere
    assert not H[_N_PERIODS].any() and not H[:, _N_PERIODS].any()


@pytest.fixture(scope='module')
def hessian64(near_mode):
    _, _, ts64, z, _ = near_mode
    neg, _, _ = tm._make_objective(ts64, False)
    return neg, torch.as_tensor(z, dtype=torch.float64), tm.hessian_columns(
        neg, torch.as_tensor(z, dtype=torch.float64))


@pytest.mark.parametrize('j', [2, 8, 11, 15, 20])
def test_f64_hessian_matches_central_differences(hessian64, j):
    # row j of the f64 Hessian against central differences of the f64
    # gradient (its own first-order backward): an independent check of the
    # double backward (readings: up to 3.2e-11 of the row's largest entry
    # at h = 1e-5); the f64 Hessian is symmetric to roundoff
    neg, z, H = hessian64

    def grad(zz):
        zz = zz.clone().requires_grad_()
        neg(zz).backward()
        return zz.grad

    h = 1e-5
    e = torch.zeros_like(z)
    e[j] = h
    fd = ((grad(z + e) - grad(z - e)) / (2 * h)).numpy()
    row = H[j].numpy()
    assert np.abs(fd - row).max() <= 3e-10 * np.abs(row).max()
    assert float((H - H.T).abs().max()) <= 1e-12 * float(H.abs().max())


def test_laplace_approximation_matches_jax(near_mode):
    # readings: sd_theta 1.7e-4 of itself at worst (a poorly determined
    # slot; 4.2e-5 the next), cov_z 3.8e-5 of the largest entry, log
    # evidence 1.8e-6 of itself
    _, ts, _, z, want = near_mode
    got = tm.laplace_approximation(ts, _fit(ts, z))
    assert got['precision'] == 'float32' and got['peak_bytes'] is None
    assert set(want) <= set(got)
    np.testing.assert_array_equal(got['free'], want['free'])
    assert not got['free'][_N_PERIODS]
    assert got['hess_pd'] and want['hess_pd']
    np.testing.assert_allclose(got['sd_theta'], want['sd_theta'],
                               rtol=2e-3)
    cz, wz = np.asarray(got['cov_z'], np.float64), np.asarray(want['cov_z'])
    assert np.abs(cz - wz).max() <= 4e-4 * np.abs(wz).max()
    np.testing.assert_allclose(got['log_evidence'], want['log_evidence'],
                               rtol=2e-5)
    np.testing.assert_allclose(got['log_jac'], want['log_jac'], rtol=1e-6)
    np.testing.assert_allclose(got['hess_z'], want['hess_z'],
                               atol=2e-6 * np.abs(want['hess_z']).max())


def test_laplace_in_f64_is_the_f32_laplace_refined(near_mode):
    # the card's precision (a f64 plain twin of the f32 setup): the twin
    # keeps the held-out mask, and its Laplace stands within f32 noise of
    # the f32 one (readings: sd_theta 5.7e-4 of itself at worst, the log
    # evidence 7e-6)
    _, ts, _, z, _ = near_mode
    fit = _fit(ts, z)
    twin = tm.plain_twin(ts, torch.float64)
    assert tm.plain_twin(ts) is ts and tm.hessian_dtype(ts) == torch.float32
    assert twin.setup.wind_flat.dtype == torch.float64
    assert not twin.setup.kcfg.pallas and twin.obs_mask is not None
    assert all(torch.equal(a.double(), b) for a, b in zip(
        (*ts.obs_mask[0], *ts.obs_mask[1], ts.obs_mask[2]),
        (*twin.obs_mask[0], *twin.obs_mask[1], twin.obs_mask[2])))
    lap32 = tm.laplace_approximation(ts, fit)
    lap64 = tm.laplace_approximation(ts, fit, dtype=torch.float64)
    assert lap64['precision'] == 'float64' and lap64['hess_pd']
    np.testing.assert_allclose(lap64['sd_theta'], lap32['sd_theta'],
                               rtol=6e-3)
    np.testing.assert_allclose(lap64['log_evidence'], lap32['log_evidence'],
                               rtol=1e-4)


def test_laplace_log_evidence_analytic(monkeypatch):
    """test_bayes_units.py::test_laplace_log_evidence_analytic on the port:
    on an exactly Gaussian objective the Laplace evidence is exact.
    theta = (2 z0, [fixed], 3 z2), neg-logpost = ½ Σ a_i z_i² over the
    free slots: logp_max + (d/2) log 2π − ½ log det A in z-space, plus
    log|J| = log 2 + log 3."""
    a0, a2 = 4.0, 0.25

    def fake_objective(setup, use_sprd, free_n=False):
        def neg_logpost(z):
            return 0.5 * (a0 * z[0] ** 2 + a2 * z[2] ** 2)

        def constrain(z):
            m = torch.stack([2.0 * z[0], torch.full((), 7.0,
                                                    dtype=z.dtype),
                             3.0 * z[2]])
            return m, z.new_zeros(0), None

        return neg_logpost, constrain, None

    class Setup:
        setup = type('S', (), {
            'kcfg': type('K', (), {'pallas': False})(),
            'wind_flat': torch.zeros(1, dtype=torch.float64)})()

    monkeypatch.setattr(tm, '_make_objective', fake_objective)
    logp_max = -1.75
    fit = {'z': np.zeros(3), 'use_sprd': False, 'logp': logp_max}
    lap = tm.laplace_approximation(Setup(), fit)
    assert lap['free'].tolist() == [True, False, True]
    assert lap['hess_pd']
    expected = (logp_max + np.log(2.0) + np.log(3.0)
                + 0.5 * 2 * np.log(2 * np.pi) - 0.5 * np.log(a0 * a2))
    np.testing.assert_allclose(lap['log_evidence'], expected, rtol=1e-5)
    assert lap['cov_z'][1, 1] < 1e-9

    def saddle_objective(setup, use_sprd, free_n=False):
        _, con, unc = fake_objective(setup, use_sprd)
        return (lambda z: -0.5 * a0 * z[0] ** 2 + 0.5 * a2 * z[2] ** 2,
                con, unc)

    monkeypatch.setattr(tm, '_make_objective', saddle_objective)
    lap2 = tm.laplace_approximation(Setup(), fit)
    assert not lap2['hess_pd']
    assert np.isnan(lap2['log_evidence'])


def test_laplace_flags_a_saddle_of_two_negative_directions(monkeypatch):
    # both free directions negative: the determinant is positive, so the
    # JAX function's sign rule reports a positive-definite Hessian and a
    # finite log evidence; the port reads the eigenvalues (the 401² MAP
    # CLI after 5 Adam steps has such a Hessian on the card: smoke [11])
    def objective(setup, use_sprd, free_n=False):
        def neg_logpost(z):
            return -0.5 * (4.0 * z[0] ** 2 + 0.25 * z[2] ** 2)

        def constrain(z):
            return torch.stack([2.0 * z[0], z[1] * 0.0 + 7.0, 3.0 * z[2]]), \
                z.new_zeros(0), None

        return neg_logpost, constrain, None

    class Setup:
        setup = type('S', (), {
            'kcfg': type('K', (), {'pallas': False})(),
            'wind_flat': torch.zeros(1, dtype=torch.float64)})()

    monkeypatch.setattr(tm, '_make_objective', objective)
    fit = {'z': np.zeros(3), 'use_sprd': False, 'logp': -1.75}
    lap = tm.laplace_approximation(Setup(), fit)
    assert lap['free'].tolist() == [True, False, True]
    assert not lap['hess_pd'] and np.isnan(lap['log_evidence'])

    def jax_objective(setup, use_sprd, free_n=False):
        return (lambda z: -0.5 * (4.0 * z[0] ** 2 + 0.25 * z[2] ** 2),
                lambda z: (jnp.stack([2.0 * z[0], jnp.asarray(7.0),
                                      3.0 * z[2]]), jnp.zeros(0), None),
                None)

    monkeypatch.setattr(jm, '_make_objective', jax_objective)
    want = jm.laplace_approximation(Setup(), dict(fit, z=np.zeros(
        3, np.float32)))
    assert want['hess_pd'] and np.isfinite(want['log_evidence'])


def _jax_prior_draws(js, n, seed):
    """The draws of JAX's ``prior_var_z``, replayed from its keys."""
    k_m, k_o, k_s = random.split(random.PRNGKey(seed), 3)
    ms = jax.vmap(jp.sample_prior_model)(random.split(k_m, n))
    os_ = jax.vmap(lambda k: jp.sample_prior_obs(
        k, js.field_areas, js.min_field_area, 'poisson'))(
            random.split(k_o, n))
    sprds = random.uniform(k_s, (n,), jnp.float32, 1e-3, 1 - 1e-3)
    return np.asarray(ms), np.asarray(os_), np.asarray(sprds)


@pytest.mark.parametrize('use_sprd', [False, True])
def test_prior_var_z_replays_jax(near_mode, use_sprd):
    # JAX's draws through the port's bijections (reading: 4e-7 of each)
    js, ts, _, _, _ = near_mode
    want = jm.prior_var_z(js, use_sprd=use_sprd, n=300, seed=1)
    got = tm.prior_var_z(ts, use_sprd=use_sprd,
                         draws=_jax_prior_draws(js, 300, 1))
    assert got.dtype == np.float64 and got.shape == want.shape
    assert got[_N_PERIODS] == 0.0 == want[_N_PERIODS]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_prior_var_z_pins_the_fixed_slot(near_mode):
    # test_ridge_metric.py::test_prior_var_z_pins_fixed_slot on the port's
    # own generator: the n_periods slot is exactly 0, every other slot is
    # positive, and the seed fixes the draws
    _, ts, _, _, _ = near_mode
    pv = tm.prior_var_z(ts, use_sprd=False, n=200, seed=0)
    assert pv.shape == (15 + 4 + ts.n_sent,)
    assert pv[_N_PERIODS] == 0.0
    assert (np.delete(pv, _N_PERIODS) > 0).all()
    np.testing.assert_array_equal(pv, tm.prior_var_z(ts, n=200, seed=0))
    assert not np.array_equal(pv, tm.prior_var_z(ts, n=200, seed=1))


def _prior_hessians(js, ts, z, with_jacobian):
    _, jcon, _ = jm._make_objective(js, False)
    _, tcon, _ = tm._make_objective(ts, False)
    want = np.asarray(jax.jit(jax.hessian(jm._neg_logprior_z(
        js, jcon, with_jacobian)))(jnp.asarray(z)), np.float64)
    got = torch.func.hessian(tm._neg_logprior_z(ts, tcon, with_jacobian))(
        torch.as_tensor(z)).double().numpy()
    return got, want


@pytest.mark.parametrize('with_jacobian', [False, True])
def test_prior_curvature_matches_jax(near_mode, with_jacobian):
    # the forward-model-free prior Hessians of the blend, torch.func
    # against jax.hessian (reading: 4.4e-8 of the largest entry), except
    # where a logit has saturated (slot 23 at z = -27.7, its probability
    # 1e-12): there the log-Jacobian's curvature is 2σ(1 − σ) ≈ 2e-12, which
    # the port reads as 2.4e-7 in f32 (1.8e-12 in f64) and JAX's f32
    # forward mode as 6.0, so the port is held to the closed form
    js, ts, _, z, _ = near_mode
    got, want = _prior_hessians(js, ts, z, with_jacobian)
    sat = np.abs(z) > 20
    assert sat.tolist().count(True) == 1 and sat[23]
    ok = ~(sat[:, None] | sat[None, :]) if with_jacobian else np.ones(
        want.shape, bool)
    assert np.abs(got - want)[ok].max() <= 5e-7 * np.abs(want).max()
    if with_jacobian:
        plain, _ = _prior_hessians(js, ts, z, False)
        sig = 1.0 / (1.0 + np.exp(-np.float64(z[23])))
        jac_part = got[23, 23] - plain[23, 23]
        assert abs(jac_part - 2 * sig * (1 - sig)) <= 3e-6


def test_laplace_warm_mass_is_a_positive_definite_f32_metric(near_mode):
    _, ts, _, _, _ = near_mode
    fit, inv = tm.laplace_warm_mass(ts, n_steps=2, use_sprd=False)
    assert inv.dtype == np.float32 and inv.shape == (25, 25)
    np.testing.assert_array_equal(inv, inv.T)
    assert np.linalg.eigvalsh(inv.astype(np.float64)).min() > 0
    assert fit['cov_z_reg'].dtype == np.float64
    assert set(fit['laplace']) >= {'hess_z', 'cov_z', 'sd_theta'}
    # the pinned slot stays pinned at the spectral jitter
    assert inv[_N_PERIODS, _N_PERIODS] <= 1e-11


def test_map_report_with_laplace(near_mode, tmp_path):
    _, ts, _, z, _ = near_mode
    fit = _fit(ts, z)
    lap = tm.laplace_approximation(ts, fit)
    out = str(tmp_path / 'r.txt')
    text = tm.map_report(ts, fit, lap, out=out)
    lines = text.splitlines()
    assert lines[1].startswith('Laplace log-evidence (n_periods fixed): ')
    assert '(sd ' in lines[2] and len(lines) == 2 + 25
    with open(out) as f:
        assert f.read() == text + '\n'

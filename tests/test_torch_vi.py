"""Port parity of ADVI (bayes/vi.py) against the JAX package.

The variational family (``_unpack_scale``, ``_q_sample_active``,
``_q_entropy``, ``_q_logpdf_active``, ``q_logpdf``, ``q_draws``) is held to
JAX's on the same parameters and normals to 1e-6 relative (f32 arithmetic
in another order); three ``advi`` steps on a correlated Gaussian, with
JAX's normals replayed, are held to ``optax.adam``'s to 1e-5; and
``vi_evidence`` at the small configuration (3 days, 10 km / 50 cells,
interp 2, K 6, Kl 3), JAX's draws replayed, is held to JAX's at 1e-6 of
the log densities' magnitude.  That evidence parity scores only the
zero-count observations (their log-pmf is −rate, so f32 roundoff rates add
nothing; tests/_torch_parity.py).  Then the three toy checks of
tests/test_vi.py:36-94 on the port alone and the command line's
``--new``/``--resume``, mean-field and full-rank."""

import numpy as np
import pytest
import jax.numpy as jnp
from jax import random

from tests._torch_parity import MAP_SMALL, torch

from parasitoids_tpu.bayes import vi as jvi
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import vi as tvi
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.models.forward import setup_from_numpy

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

OV = list(MAP_SMALL)
MU = np.array([1.5, -0.5])
COV = np.array([[1.0, 0.8], [0.8, 1.0]])


def _mvn_targets(offset):
    """The unnormalized correlated Gaussian of tests/test_vi.py:25 in both
    packages; its log normalizer is ``offset``."""
    prec = np.linalg.inv(COV)
    lognorm = -0.5 * (2 * np.log(2 * np.pi) + np.linalg.slogdet(COV)[1])

    def jax_logpdf(z):
        d = z - jnp.asarray(MU, jnp.float32)
        return offset + lognorm - 0.5 * d @ jnp.asarray(prec, jnp.float32) @ d

    p = torch.as_tensor(prec, dtype=torch.float32)
    mu = torch.as_tensor(MU, dtype=torch.float32)

    def torch_logpdf(z):
        d = z - mu
        return offset + lognorm - 0.5 * d @ p @ d

    return jax_logpdf, torch_logpdf


def _params(da, fullrank, seed):
    rng = np.random.default_rng(seed)
    p = {'mu': rng.standard_normal(da).astype(np.float32),
         'log_diag': (0.3 * rng.standard_normal(da)).astype(np.float32)}
    if fullrank:
        p['offdiag'] = (0.2 * rng.standard_normal(da * (da - 1) // 2)
                        ).astype(np.float32)
    return p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize('fullrank', [False, True])
@pytest.mark.parametrize('da', [1, 2, 7])
def test_variational_family_matches_jax(fullrank, da):
    p = _params(da, fullrank, da)
    eps = np.random.default_rng(da + 9).standard_normal(da).astype(np.float32)
    sd_j, L_j = jvi._unpack_scale(_j(p), da)
    sd_t, L_t = tvi._unpack_scale(_t(p), da)
    if fullrank:
        # JAX's offdiag layout: tril_indices(da, -1) in row-major order
        np.testing.assert_array_equal(L_t.numpy(), np.asarray(L_j))
    else:
        np.testing.assert_array_equal(sd_t.numpy(), np.asarray(sd_j))
    z_t = tvi._q_sample_active(_t(p), torch.from_numpy(eps))
    z_j = jvi._q_sample_active(_j(p), jnp.asarray(eps))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(tvi._q_entropy(_t(p), da)),
                               float(jvi._q_entropy(_j(p), da)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tvi._q_logpdf_active(_t(p), z_t)),
        float(jvi._q_logpdf_active(_j(p), jnp.asarray(z_t.numpy()))),
        rtol=1e-6)


@pytest.mark.parametrize('fullrank', [False, True])
def test_q_draws_and_q_logpdf_match_jax(fullrank):
    # a fitted result over 4 active coordinates of 5 (slot 2 pinned)
    p = _params(4, fullrank, 3)
    res = dict(p, idx=np.array([0, 1, 3, 4]),
               z0=np.array([0.1, 0.2, 7.0, 0.4, 0.5], np.float32),
               fullrank=fullrank)
    key = random.PRNGKey(4)
    want = np.asarray(jvi.q_draws(res, key, 6))
    eps = np.asarray(random.normal(key, (6, 4)))
    got = tvi.q_draws(res, None, 6, eps=eps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[:, 2] == 7.0).all()
    for z in want:
        np.testing.assert_allclose(float(tvi.q_logpdf(res, z)),
                                   float(jvi.q_logpdf(res, jnp.asarray(z))),
                                   rtol=1e-6)


def _advi_eps(key, n_steps, n_mc, da):
    """The normals of JAX's ``advi`` steps (vi.py:133-135)."""
    out = []
    for _ in range(n_steps):
        key, sub = random.split(key)
        out.append(np.asarray(random.normal(sub, (n_mc, da))))
    return np.stack(out)


@pytest.mark.parametrize('fullrank', [False, True])
def test_three_advi_steps_match_optax(fullrank):
    # torch.optim.Adam against optax.adam on the same ELBO gradients:
    # three steps of 4 draws from JAX's normals, one coordinate of three
    # pinned, the learning rate a schedule
    jlog, tlog = _mvn_targets(-2.0)
    active = np.array([True, False, True])
    z0 = np.array([0.2, 5.0, -0.1], np.float32)
    lr = lambda i: 0.05 / (1.0 + i)
    key = random.PRNGKey(0)
    kw = dict(active=active, n_steps=3, n_mc=4, fullrank=fullrank,
              chunk_steps=2)
    want = jvi.advi(lambda z: jlog(z[jnp.array([0, 2])]), jnp.asarray(z0),
                    key, learning_rate=lr, **kw)
    got = tvi.advi(lambda z: tlog(z[[0, 2]]), torch.from_numpy(z0), None,
                   learning_rate=lr, eps=_advi_eps(key, 3, 4, 2), **kw)
    for k in ('mu', 'log_diag') + (('offdiag',) if fullrank else ()):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got['elbo_trace'], want['elbo_trace'],
                               rtol=1e-5)
    np.testing.assert_array_equal(got['idx'], want['idx'])
    np.testing.assert_array_equal(got['z0'], want['z0'])
    assert got['fullrank'] == fullrank and got['elbo_trace'].shape == (3,)


def test_advi_zeroes_non_finite_gradients():
    # a target whose gradient is NaN in one coordinate: that coordinate
    # stays at its start, the others move (vi.py:141-142)
    def logpdf(z):
        return -0.5 * z[0] ** 2 + torch.sqrt(z[1] - 10.0)

    res = tvi.advi(logpdf, torch.tensor([1.0, 0.0]), 0, n_steps=3, n_mc=2,
                   learning_rate=0.1)
    assert res['mu'][1] == 0.0 and res['mu'][0] != 1.0


def test_vi_evidence_matches_jax():
    ov = tm.map_cli_params(OV)
    jsetup = JaxSetup(ov)
    s = jsetup.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    tsetup = BayesSetup(tm.map_cli_params(OV), device='cpu',
                        forward_setup=fs)
    data = (*tsetup.obs_release, *tsetup.obs_sentinel, tsetup.obs_grid)
    keep = (torch.cat([d.reshape(-1) for d in data]) == 0).numpy()
    jm, tmk = jsetup.with_held_out(keep), tsetup.with_held_out(keep)
    # a q around the reference start, tight enough that every draw is
    # inside the prior's support
    _, _, z0, active = tvi._model_logpdf(tmk)
    da = int(active.sum())
    res = {'mu': z0.numpy()[active], 'log_diag': np.full(da, -3.0,
                                                         np.float32),
           'idx': np.flatnonzero(active), 'z0': z0.numpy(),
           'fullrank': False, 'use_sprd': False}
    key = random.PRNGKey(2)
    want = jvi.vi_evidence(jm, res, key, n=20)
    got = tvi.vi_evidence(tmk, res, None, n=20,
                          eps=np.asarray(random.normal(key, (20, da))))
    np.testing.assert_allclose(got['zs'], want['zs'], rtol=1e-6, atol=1e-7)
    scale = np.abs(want['logpost']).max()
    for k in ('logw', 'logpost'):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
    for k in ('elbo', 'logz_is'):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
    assert np.isfinite(got['elbo']) and got['elbo'] <= got['logz_is']
    assert (got['khat'] == want['khat'] or
            abs(got['khat'] - want['khat']) < 1e-3)


# ----------------------------------------------------------------------
# the toy checks of tests/test_vi.py on the port
# ----------------------------------------------------------------------

def _cosine(lr0, n):
    return lambda i: lr0 * 0.5 * (1.0 + np.cos(np.pi * min(i, n) / n))


def _logw(res, tlog, n=4000):
    zs = tvi.q_draws(res, 1, n)
    with torch.no_grad():
        return np.array([float(tlog(z)) - float(tvi.q_logpdf(res, z))
                         for z in zs])


def test_advi_fullrank_recovers_gaussian_and_evidence():
    offset = -12.34
    _, tlog = _mvn_targets(offset)
    res = tvi.advi(tlog, torch.zeros(2), 0, n_steps=3000, n_mc=8,
                   learning_rate=_cosine(0.1, 3000), fullrank=True)
    assert np.allclose(res['mu'], MU, atol=0.08)
    L = np.zeros((2, 2))
    L[np.tril_indices(2, -1)] = res['offdiag']
    L += np.diag(np.exp(res['log_diag']))
    assert np.allclose(L @ L.T, COV, atol=0.15)
    logw = _logw(res, tlog)
    assert abs(logw.mean() - offset) < 0.05          # ELBO ~= logZ
    logz_is = np.log(np.mean(np.exp(logw - logw.max()))) + logw.max()
    assert abs(logz_is - offset) < 0.05
    assert tvi.psis(logw)[1] < 0.5


def test_advi_meanfield_elbo_is_strict_lower_bound():
    offset = 3.0
    _, tlog = _mvn_targets(offset)
    res = tvi.advi(tlog, torch.zeros(2), 0, n_steps=3000, n_mc=8,
                   learning_rate=_cosine(0.1, 3000), fullrank=False)
    assert np.allclose(res['mu'], MU, atol=0.1)
    logw = _logw(res, tlog)
    assert offset - 2.0 < logw.mean() < offset - 0.1


def test_advi_active_mask_pins_inactive_coordinate():
    _, tlog = _mvn_targets(0.0)
    res = tvi.advi(lambda z: tlog(z[:2]), torch.tensor([0.0, 0.0, 7.0]), 0,
                   active=np.array([True, True, False]), n_steps=200,
                   n_mc=4, learning_rate=0.05)
    zs = tvi.q_draws(res, 1, 16).numpy()
    assert (zs[:, 2] == 7.0).all() and res['mu'].shape == (2,)


# ----------------------------------------------------------------------
# the command line
# ----------------------------------------------------------------------

@pytest.mark.parametrize('fullrank', [False, True])
def test_vi_cli_new_and_resume(tmp_path, fullrank, capsys):
    import json

    from parasitoids_tpu_torch.bayes import run as brun
    from parasitoids_tpu_torch.bayes.store import load_chain, load_extras
    db = str(tmp_path / 'vi')
    extra = ['--vi-fullrank'] if fullrank else []
    brun.main(['--new', '6', '4', db, '--sampler', 'vi', '--vi-mc', '2',
               '--vi-is', '24', '--init-map-steps', '3', '--device', 'cpu']
              + extra + OV)
    out = capsys.readouterr().out
    assert 'ELBO (evidence lower bound)' in out and 'PSIS k-hat' in out
    with open(db + '.meta.json') as fh:
        meta = json.load(fh)
    assert meta['sampler'] == 'vi' and meta['fullrank'] == fullrank
    assert np.isfinite([meta['elbo'], meta['logz_is']]).all()
    ex = load_extras(db)
    assert ex['mu'].shape == (24,) and 13 not in set(ex['idx'].tolist())
    assert ('offdiag' in ex) == fullrank
    if fullrank:
        assert ex['offdiag'].shape == (24 * 23 // 2,)
    setup = brun.build_setup(OV, device='cpu')
    tr1, _, _ = load_chain(db, setup)
    assert tr1.shape == (1, 6, 26) and np.isfinite(tr1).all()
    np.testing.assert_array_equal(tr1[0, :, 13], 30.0)   # n_periods fixed
    brun.main(['--resume', db, '5', '--sampler', 'vi', '--vi-is', '24',
               '--device', 'cpu'] + OV)
    tr2, _, meta2 = load_chain(db, setup)
    assert tr2.shape == (1, 11, 26) and meta2['n_samples'] == 11
    np.testing.assert_array_equal(tr2[:, :6], tr1)
    # the stored q is reused, not refitted
    np.testing.assert_array_equal(load_extras(db)['mu'], ex['mu'])
    with pytest.raises(SystemExit, match='--sampler'):
        brun.main(['--resume', db, '5', '--sampler', 'smc', '--device',
                   'cpu'] + OV)

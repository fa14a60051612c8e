"""Port parity of adaptive tempered SMC (bayes/smc.py) against the JAX
package, at the small configuration of test_torch_sampler.py (3 days,
10 km / 50 cells, interp 2, K 6, Kl 3).

``ess``, ``next_beta``, ``systematic_resample``, ``_population_cov`` and
``_retune`` are held to JAX's exactly (the same numpy and the same f32
casts).  One stage of ``run_smc`` is held against JAX's from the same
prior particles with JAX's move draws replayed.  That parity scores only
the zero-count observations (``obs_mask``): their log-pmf is −rate, so the
f32 roundoff rates that differ between the packages add nothing of note
(tests/_torch_parity.py explains the roundoff), and no mask has to be
fitted to the particles' path.  The rest runs on the port alone: the
annealed-importance evidence of a conjugate normal, resampled clones with
generators of their own, a checkpoint resumed bit for bit, the command
line's ``--new``/``--resume``, the batched moves and the refused sharded
paths.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from tests._torch_parity import (MAP_SMALL, chain_state_arrays,
                                 port_chain_state, torch)

from parasitoids_tpu.bayes import sampler as js
from parasitoids_tpu.bayes import smc as jsmc
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import sampler as ts
from parasitoids_tpu_torch.bayes import smc as tsmc
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.models.forward import setup_from_numpy

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

RATIO_RTOL = 5e-7         # of |loglik|, as test_torch_sampler.py
RATIO_ATOL = 1e-4
STAGE_KEY = 5             # JAX key of the one-stage parity
OV = list(MAP_SMALL)
CHEAP = tsmc.SMCConfig(n_particles=4, n_moves=1, min_accepts=0.0,
                       max_move_rounds=1)


# ----------------------------------------------------------------------
# host machinery: exactly JAX's
# ----------------------------------------------------------------------

@pytest.mark.parametrize('logw', [np.zeros(10), np.arange(5.0),
                                  np.arange(5.0) + 37.0,
                                  np.array([0.0, 0.0, -np.inf, -np.inf]),
                                  np.r_[np.full(9, -100.0), 0.0]])
def test_ess_matches_jax(logw):
    assert tsmc.ess(logw) == jsmc.ess(logw)


@pytest.mark.parametrize('case', range(5))
def test_next_beta_matches_jax(case):
    rng = np.random.default_rng(0)
    ll = rng.normal(-50.0, 8.0, size=200)
    ll_bad = ll.copy()
    ll_bad[:2] = [-np.inf, np.nan]
    beta, lls, logw, target = [
        (0.0, ll, np.zeros(200), 100.0), (0.0, ll, np.zeros(200), 150.0),
        (0.3, np.zeros(50), np.zeros(50), 25.0),
        (0.999, ll, np.zeros(200), 100.0),
        (0.0, ll_bad, rng.normal(size=200), 60.0)][case]
    got = tsmc.next_beta(beta, lls, logw, target)
    assert got == jsmc.next_beta(beta, lls, logw, target)
    assert 0 < got <= 1.0 - beta
    with pytest.raises(ValueError):
        tsmc.next_beta(1.0, ll, np.zeros(200), 100.0)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_systematic_resample_matches_jax(seed):
    n = 257
    w = np.random.default_rng(seed + 10).random(n)
    w /= w.sum()
    got = tsmc.systematic_resample(w, np.random.default_rng(seed))
    want = jsmc.systematic_resample(w, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=n)
    assert (np.abs(counts - n * w) <= 1.0 + 1e-9).all()


@pytest.mark.parametrize('uniform', [True, False])
def test_population_cov_matches_jax(uniform):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((12, 15)).astype(np.float32)
    logw = np.zeros(12) if uniform else rng.normal(size=12)
    got, want = tsmc._population_cov(m, logw), jsmc._population_cov(m, logw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_retune_matches_jax():
    # the moments that make _proposal_chol rebuild the population
    # covariance: the same f32 casts of the same f64 numbers
    rng = np.random.default_rng(4)
    n = 5
    arrays = {f: rng.standard_normal(s).astype(np.float32) for f, s in (
        ('m', (n, 15)), ('o', (n, 10)), ('loglik', (n,)), ('prior_m', (n,)),
        ('prior_o', (n,)), ('count', (n,)), ('mean', (n, 15)),
        ('m2', (n, 15, 15)), ('accepts_m', (n,)), ('accepts_o', (n,)),
        ('log_scale', (n,)))}
    mu, cov = jsmc._population_cov(arrays['m'], rng.normal(size=n))
    jnew = jsmc._retune(js.ChainState(proj=(), key=None, **{
        k: jnp.asarray(v) for k, v in arrays.items()}), mu, cov, 0.37)
    tnew = tsmc._retune(ts.ChainState(proj=(), key=None, **{
        k: torch.from_numpy(v) for k, v in arrays.items()}), mu, cov, 0.37)
    for f in arrays:
        np.testing.assert_array_equal(getattr(tnew, f).numpy(),
                                      np.asarray(getattr(jnew, f)),
                                      err_msg=f)


def test_annealed_importance_evidence_conjugate_normal():
    # the stage-product identity of test_smc.py:160, driven by the port's
    # next_beta / ESS: log Z of theta ~ N(0,1), y | theta ~ N(theta, s2)
    rng = np.random.default_rng(3)
    y, s2 = 1.3, 0.4
    exact = -0.5 * (np.log(2 * np.pi * (1 + s2)) + y ** 2 / (1 + s2))
    n = 40000
    th = rng.normal(0.0, 1.0, size=n)
    ll = -0.5 * (np.log(2 * np.pi * s2) + (y - th) ** 2 / s2)
    logw = np.zeros(n)
    beta, logz, stages = 0.0, 0.0, 0
    while beta < 1.0:
        d = tsmc.next_beta(beta, ll, logw, target_ess=0.5 * tsmc.ess(logw))
        logz += tsmc._logsumexp((logw - tsmc._logsumexp(logw)) + d * ll)
        logw = logw + d * ll
        beta = 1.0 if d >= 1.0 - beta else beta + d
        stages += 1
        assert stages < 50
    np.testing.assert_allclose(logz, exact, atol=0.02)
    np.testing.assert_allclose(logz, tsmc._logsumexp(ll) - np.log(n),
                               atol=1e-8)


# ----------------------------------------------------------------------
# one stage against JAX's, draws replayed
# ----------------------------------------------------------------------

def _step_draws(key, n_moves):
    """One JAX ``_mcmc_step``'s draws from ``key`` as the port's
    ``StepDraws``, and the key after the step."""
    key, k_prop, k_acc = random.split(key, 3)
    eps = random.normal(k_prop, (15,))
    log_u = jnp.log(random.uniform(k_acc))
    obs_eps, obs_log_u = [], []
    for _ in range(n_moves):
        key, k1, k2 = random.split(key, 3)
        obs_eps.append(random.normal(k1))
        obs_log_u.append(jnp.log(random.uniform(k2)))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return ts.StepDraws(t(eps), t(log_u), t(obs_eps), t(obs_log_u)), key


class _Stop(Exception):
    pass


def _stop_at(stage, keep):
    def cb(payload):
        keep.update(payload)
        if payload['stage'] == stage:
            raise _Stop
    return cb


def _spy(monkeypatch, mod, name, log, wrap=None):
    real = getattr(mod, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        if wrap is not None:
            out = wrap(out)
        log.append(out)
        return out

    monkeypatch.setattr(mod, name, wrapper)


def test_one_stage_matches_jax(monkeypatch):
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
    assert 0.5 < keep.mean() < 1.0
    jmask, tmask = jsetup.split_point_mask(keep), tsetup.split_point_mask(
        keep)
    cfg = jsmc.SMCConfig(n_particles=4, n_moves=2, min_accepts=0.0,
                         max_move_rounds=1)
    # JAX: the initial particles and the states entering the move recorded
    inits, moved_in = [], []
    real_prog = jsmc._move_prog

    def recording_prog(*a):
        move = real_prog(*a)

        def run(states, beta, mask):
            moved_in.append(states)
            return move(states, beta, mask)
        return run

    _spy(monkeypatch, jsmc, 'init_smc_particles', inits)
    monkeypatch.setattr(jsmc, '_move_prog', recording_prog)
    want = {}
    with pytest.raises(_Stop):
        jsmc.run_smc(jsetup, random.PRNGKey(STAGE_KEY), cfg, seed=3,
                     checkpoint=_stop_at(1, want), obs_mask=jmask)
    (jinit,), (jin,) = inits, moved_in
    n_obs = 4 + tsetup.n_sent
    draws = {}
    for i, k in enumerate(np.asarray(jin.key)):
        key = jnp.asarray(k)
        for j in range(cfg.n_moves):
            draws[i, j], key = _step_draws(key, n_moves=n_obs)

    # the port from JAX's initial particles (a stage-0 payload), the same
    # resampling seed, JAX's move draws
    per = [port_chain_state(chain_state_arrays(
        jax.tree.map(lambda x: x[i], jinit)), tsetup, torch.Generator())
        for i in range(4)]
    # the port's own cached likelihood, masked as JAX's init masked it
    with torch.no_grad():
        per = [p._replace(loglik=tsetup.log_likelihood(
            p.proj, ts._as_obs(p.o, tsetup.n_sent), tmask)) for p in per]
    states = ts.stack_states(per)
    np.testing.assert_allclose(states.loglik.numpy(),
                               np.asarray(jinit.loglik), rtol=1e-6)
    start = {'states': states, 'logw': np.zeros(4), 'beta': 0.0,
             'logz': 0.0, 'log_scale': 0.0, 'stage': 0,
             'history': {'betas': [0.0], 'ess': [4.0], 'accept': [],
                         'resampled': [], 'logz': [0.0]}}
    proposals, moves = [], []
    _spy(monkeypatch, ts, '_model_proposal', proposals)
    _spy(monkeypatch, ts, '_obs_move', moves)
    got = {}
    with pytest.raises(_Stop):
        tsmc.run_smc(tsetup, None, tsmc.SMCConfig(*cfg), seed=3,
                     resume=start, checkpoint=_stop_at(1, got),
                     obs_mask=tmask,
                     draws=lambda stage, rnd, i, k: draws[i, k])
    ll_scale = float(np.abs(np.asarray(jinit.loglik)).max())
    tol = RATIO_RTOL * ll_scale + RATIO_ATOL
    beta = got['beta']
    # every decision clear of its ratio by five tolerances
    order = [draws[i, k] for i in range(4) for k in range(cfg.n_moves)]
    assert len(proposals) == len(order)
    us = [float(d.log_u) for d in order] + [
        float(u) for d in order for u in d.obs_log_u]
    ratios = [float(p[4]) for p in proposals] + [float(m[3]) for m in moves]
    for u, r in zip(us, ratios):
        if np.isfinite(r):
            assert abs(u - r) > 5 * (beta * tol + RATIO_ATOL)

    np.testing.assert_allclose(beta, want['beta'], rtol=1e-5)
    np.testing.assert_allclose(got['logz'], want['logz'], rtol=1e-5)
    np.testing.assert_allclose(got['logw'], want['logw'], rtol=1e-5,
                               atol=1e-8)
    assert got['log_scale'] == pytest.approx(want['log_scale'], abs=1e-12)
    for k in ('resampled', 'accept', 'rounds'):
        np.testing.assert_array_equal(got['history'][k],
                                      want['history'][k], err_msg=k)
    a, b = got['states'], want['states']
    # the block proposals come from the f32 Cholesky factor of the
    # population covariance, whose parameters span four orders of scale:
    # the two packages' factors differ by about 1e-5 of each proposal sd
    # (sd_j from the retuned moments JAX moved with), up to 1.1e-4 of it
    # read on the keys here, so the positions are held to 3e-4 of it plus
    # four ulps of the position
    sd = np.sqrt((2.38 ** 2 / 15) * np.exp(np.asarray(jin.log_scale))[:, None]
                 * np.diagonal(np.asarray(jin.m2), axis1=1, axis2=2)
                 / (np.asarray(jin.count)[:, None] - 1.0))
    np.testing.assert_array_less(
        np.abs(a.m.numpy() - np.asarray(b.m)),
        3e-4 * sd + 4 * np.spacing(np.abs(np.asarray(b.m))))
    for f in ('o', 'mean'):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   np.asarray(getattr(b, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    # m2 adds the outer product of the moved position's deviation: its
    # error is the positions' times a deviation, held to 3e-3 sd_i sd_j,
    # plus f32 rounding at the entry's natural scale sqrt(m2_ii m2_jj)
    d2 = np.abs(np.diagonal(np.asarray(b.m2), axis1=1, axis2=2))
    np.testing.assert_array_less(
        np.abs(a.m2.numpy() - np.asarray(b.m2)),
        3e-3 * sd[:, :, None] * sd[:, None, :]
        + 1e-5 * np.sqrt(d2[:, :, None] * d2[:, None, :]))
    # a prior-drawn particle's log likelihood is of order 1e6 here, and a
    # moved particle's position differs as above: the cached densities are
    # held to 1e-5 of themselves (read: 3.1e-6)
    for f in ('loglik', 'prior_m', 'prior_o'):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   np.asarray(getattr(b, f)), rtol=1e-5,
                                   atol=tol, err_msg=f)
    for f in ('count', 'accepts_m', 'accepts_o'):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)), err_msg=f)
    # the within-stage Robbins-Monro step 1/sqrt(count - 499): an ulp
    np.testing.assert_allclose(a.log_scale.numpy(),
                               np.asarray(b.log_scale), rtol=1e-6)


# ----------------------------------------------------------------------
# the port alone
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def plain():
    return BayesSetup(tm.map_cli_params(OV), device='cpu')


def _run_to(setup, stage, cfg=CHEAP, seed=11, key=2, resume=None):
    keep = {}
    with pytest.raises(_Stop):
        tsmc.run_smc(setup, key, cfg, seed=seed, resume=resume,
                     checkpoint=_stop_at(stage, keep))
    return keep


def test_resampled_clones_diverge(plain):
    # resample at every stage (test_smc.py:234): every particle gets a
    # generator of its own, so clones of one ancestor move apart, and the
    # ancestor's generator is not advanced by the derivation
    cfg = tsmc.SMCConfig(n_particles=6, n_moves=1, resample_ess=1.0,
                         min_accepts=0.0, max_move_rounds=1)
    out = _run_to(plain, 2, cfg)
    assert all(out['history']['resampled'])
    states = [g.get_state() for g in out['states'].key]
    assert len({bytes(s.numpy()) for s in states}) == 6
    anc = ts.chain_generator(0, 0, 'cpu')
    before = anc.get_state()
    a, b = tsmc.clone_generator(anc, 0), tsmc.clone_generator(anc, 1)
    assert torch.equal(anc.get_state(), before)
    assert not torch.equal(torch.randn(3, generator=a),
                           torch.randn(3, generator=b))
    again = tsmc.clone_generator(anc, 0)
    assert torch.equal(again.get_state(),
                       tsmc.clone_generator(anc, 0).get_state())


def test_checkpoint_resume_is_bitwise(plain):
    # stopped after stage 2 and resumed from the checkpoint payload to
    # stage 4: the uninterrupted run at stage 4 (test_smc.py:248)
    mono = _run_to(plain, 4)
    part = _run_to(plain, 2)
    resumed = _run_to(plain, 4, key=None, resume=part)
    assert resumed['stage'] == mono['stage'] == 4
    for f in ts.ChainState._fields:
        if f not in ('key', 'proj'):
            assert torch.equal(getattr(mono['states'], f),
                               getattr(resumed['states'], f)), f
    for a, b in zip(mono['states'].key, resumed['states'].key):
        assert torch.equal(a.get_state(), b.get_state())
    assert mono['logz'] == resumed['logz']
    np.testing.assert_array_equal(mono['logw'], resumed['logw'])
    for k in mono['history']:
        np.testing.assert_array_equal(mono['history'][k],
                                      resumed['history'][k])


def test_smc_reads_the_population_once_a_stage(plain, monkeypatch):
    # one transfer a stage (log likelihoods, acceptance counts and model
    # blocks together) and one a move round (acceptance counts)
    calls = []
    real = tsmc._host

    def host(t):
        calls.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(tsmc, '_host', host)
    _run_to(plain, 2)
    assert calls == [(4, 17), (4,), (4, 17), (4,)]


def test_smc_cli_new_and_resume(tmp_path, capsys):
    # --sampler smc: the store after each stage, a resume that continues it
    # bitwise as one run, a completed anneal's posterior draws and evidence
    # report, the report-only resume of a completed run, and the AM path
    # refusing the store (test_smc.py:323)
    from parasitoids_tpu_torch.bayes import run as brun
    from parasitoids_tpu_torch.bayes.store import load_extras
    db = str(tmp_path / 'smc_run')
    knobs = ['--moves', '1', '--min-accepts', '0', '--max-move-rounds', '1',
             '--device', 'cpu']
    with pytest.raises(RuntimeError, match='max_stages=2'):
        brun.main(['--new', '4', '0', db, '--sampler', 'smc',
                   '--max-stages', '2'] + knobs + OV)
    with pytest.raises(RuntimeError, match='max_stages=3'):
        brun.main(['--resume', db, '0', '--sampler', 'smc',
                   '--max-stages', '3'] + knobs + OV)
    setup = brun.build_setup(OV, device='cpu')
    mono = _run_to(setup, 3, CHEAP, seed=0, key=0)
    with np.load(db + '.npz') as d:
        assert d['traces'].shape == (1, 0, 1)        # beta < 1: no draws
        np.testing.assert_array_equal(d['state_m'],
                                      mono['states'].m.numpy())
    ex = load_extras(db)
    np.testing.assert_array_equal(ex['betas'], mono['history']['betas'])
    np.testing.assert_array_equal(ex['logw'], mono['logw'])

    done = str(tmp_path / 'smc_done')
    capsys.readouterr()
    # an ESS target of 1% lets the first stage reach beta = 1
    brun.main(['--new', '4', '0', done, '--sampler', 'smc',
               '--ess-target', '0.01'] + knobs + OV)
    out = capsys.readouterr().out
    assert 'log evidence (SMC):' in out and 'posterior means' in out
    with np.load(done + '.npz') as d:
        tr = d['traces']
    assert tr.shape == (1, 4, 26) and np.isfinite(tr).all()
    ex = load_extras(done)
    assert ex['betas'][-1] == 1.0 and np.isfinite(ex['logz_path']).all()
    brun.main(['--resume', done, '0', '--sampler', 'smc'] + knobs + OV)
    assert 'log evidence (SMC):' in capsys.readouterr().out
    with np.load(done + '.npz') as d:
        np.testing.assert_array_equal(d['traces'], tr)
    with pytest.raises(SystemExit, match='--sampler'):
        brun.main(['--resume', done, '6', '--device', 'cpu'] + OV)


def test_batched_and_sharded_paths_raise(plain, tmp_path, monkeypatch):
    # (the name is the test's from before the particle mesh was ported)
    # the sharded paths run: the particles over a mesh that names the CPU
    # twice, in turn and batched, give the payload of the run without one
    # bit for bit, and four particles do not divide over three devices;
    # the batched ones, once refused, run: run_smc(batched=True) to stage
    # 1 against the in-turn run from the same particles and draws (the
    # same acceptances; the positions differ by the select node rule's
    # roundoff), and PARA_SMC_BATCHED=1 through the command line
    from parasitoids_tpu_torch.bayes.sampler import ChainState
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    mesh = chain_mesh(devices=['cpu', 'cpu'])
    with pytest.raises(ValueError, match='divide evenly'):
        tsmc.run_smc(plain, 0, CHEAP, mesh=chain_mesh(devices=['cpu'] * 3))
    with pytest.raises(ValueError, match='divisible'):
        tsmc.init_smc_particles(plain, 0, 3, mesh=mesh)
    keep = {}
    for batched in (True, False):
        keep[batched] = {}
        with pytest.raises(_Stop):
            tsmc.run_smc(plain, 2, CHEAP, seed=11, batched=batched,
                         checkpoint=_stop_at(1, keep[batched]))
        meshed = {}
        with pytest.raises(_Stop):
            tsmc.run_smc(plain, 2, CHEAP, seed=11, batched=batched,
                         mesh=mesh, checkpoint=_stop_at(1, meshed))
        for f in ChainState._fields:
            if f not in ('proj', 'key'):
                assert torch.equal(getattr(meshed['states'], f),
                                   getattr(keep[batched]['states'], f)), f
        assert all(torch.equal(g.get_state(), h.get_state()) for g, h in
                   zip(meshed['states'].key, keep[batched]['states'].key))
        np.testing.assert_array_equal(meshed['logw'], keep[batched]['logw'])
        assert meshed['logz'] == keep[batched]['logz']
    a, b = keep[True], keep[False]
    assert a['beta'] == b['beta']
    np.testing.assert_array_equal(a['history']['accept'],
                                  b['history']['accept'])
    np.testing.assert_allclose(a['states'].m.numpy(), b['states'].m.numpy(),
                               rtol=1e-3)
    from parasitoids_tpu_torch.bayes import run as brun
    monkeypatch.setenv('PARA_SMC_BATCHED', '1')
    brun.main(['--new', '4', '0', str(tmp_path / 'b'), '--sampler', 'smc',
               '--ess-target', '0.01', '--moves', '1', '--min-accepts', '0',
               '--max-move-rounds', '1', '--device', 'cpu'] + OV)
    with np.load(str(tmp_path / 'b') + '.npz') as d:
        assert d['traces'].shape == (1, 4, 26)
        assert np.isfinite(d['traces']).all()

"""Port parity of the ensemble-batched path: the select node rule of the
BVN (``bvn_cell_masses_batched``), the batched plain accumulate and day
builder, the batched population propagation, projections and likelihood,
``BayesSetup.with_batched_bvn().forward_projections`` over prior draws,
one batched AM move round and ``run_smc(batched=True)``, against the JAX
package (whose batched day accumulate takes the select rule where the
port's takes each particle's own Genz tier: the two agree at the JAX
tolerances used here) at the small configuration of
test_torch_sampler.py (3 days, 10 km / 50 cells, interp 2, K 6, Kl 3) or
the day-kernel tests' (rad_res 60, K 10).  On the CPU the
particle-batched CUDA kernel's wrapper takes its plain twin; the card
holds the kernel against it (tests/test_torch_cuda.py, chip_smoke.py
[18]).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from tests._torch_parity import (HPARAMS, MAP_SMALL, chain_state_arrays,
                                 port_chain_state, t32, torch, wind)

from parasitoids_tpu.bayes import priors as jp
from parasitoids_tpu.bayes import smc as jsmc
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu.ops import bvn as jbvn
from parasitoids_tpu.ops import daily_kernel as jdk
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import sampler as ts
from parasitoids_tpu_torch.bayes import smc as tsmc
from parasitoids_tpu_torch.bayes.model import BayesSetup, _as_model, _as_obs
from parasitoids_tpu_torch.bayes.priors import (log_prior_model,
                                                log_prior_obs,
                                                sample_prior_model,
                                                sample_prior_obs)
from parasitoids_tpu_torch.models.forward import setup_from_numpy
from parasitoids_tpu_torch.models.solver import SolverConfig, propagate_pop
from parasitoids_tpu_torch.ops import bvn as tbvn
from parasitoids_tpu_torch.ops import daily_kernel as tdk
from parasitoids_tpu_torch.ops import day_kernel as tday

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

BVN_ATOL = 2e-6           # tests/test_bvn.py's per-cell limit
DAY_ATOL = 3e-6           # test_torch_daily_kernel.py (high-|rho| series)
BASE = dict(rad_res=60, K=10, K_local=4)
# three particles: low |rho|, just above the select threshold, negative
# high |rho|; the local diffusion straddles 0.925 the other way
RHOS = np.array([0.3, 0.93, -0.99], np.float32)
DLPS = np.array([[5.8, 5.0, 0.1], [6.0, 4.0, 0.95], [5.0, 5.5, -0.5]],
                np.float32)
OV = list(MAP_SMALL)


# ----------------------------------------------------------------------
# the BVN: select rule, particle axis, conditional-decomposition scheme
# ----------------------------------------------------------------------

@pytest.mark.parametrize('rho', [0.0, 0.3, 0.9249, 0.925, 0.9251, -0.95,
                                 0.999])
def test_bvn_cell_masses_batched_matches_jax(rho):
    # one parameter set: the select rule against JAX's at test_bvn.py's
    # atol, across the 0.925 threshold (<= takes the 20-node quadrature)
    mu = np.random.default_rng(2).uniform(-9, 9, (4, 2)).astype(np.float32)
    want = jax.vmap(lambda m: jbvn.bvn_cell_masses_batched(
        m, 21.1, 10.6, rho, 25.0, 7))(jnp.asarray(mu))
    got = tbvn.bvn_cell_masses_batched(t32(mu), 21.1, 10.6, rho, 25.0, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BVN_ATOL)


def test_bvn_cell_masses_batched_particle_axis():
    # one (sigma_x, sigma_y, rho) per particle on a leading axis: JAX's
    # vmap over particles, and the per-particle calls of the port, to the
    # last bit of the per-particle call; the closed-form backward gives
    # each particle its own parameter gradients
    rng = np.random.default_rng(4)
    mu = rng.uniform(-9, 9, (3, 5, 2)).astype(np.float32)
    sx = np.array([21.1, 30.0, 12.0], np.float32)
    sy = np.array([10.6, 18.0, 40.0], np.float32)
    want = jax.vmap(lambda m, a, b, r: jax.vmap(
        lambda mm: jbvn.bvn_cell_masses_batched(mm, a, b, r, 25.0, 6))(m))(
            mu, sx, sy, RHOS)
    args = [t32(a).clone().requires_grad_() for a in (mu, sx, sy, RHOS)]
    got = tbvn.bvn_cell_masses_batched(*args, 25.0, 6)
    assert got.shape == (3, 5, 13, 13)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=BVN_ATOL)
    w = t32(rng.normal(size=got.shape).astype(np.float32))
    (got * w).sum().backward()
    for i in range(3):
        one = [torch.tensor(a[i], requires_grad=True) for a in (mu, sx, sy,
                                                                RHOS)]
        block = tbvn.bvn_cell_masses_batched(*one, 25.0, 6)
        assert torch.equal(block, got[i].detach())
        (block * w[i]).sum().backward()
        for a, b in zip(args, one):
            assert torch.equal(a.grad[i], b.grad)


@pytest.mark.parametrize('mu,sx,sy,rho,cell,K', [
    ((0.0, 0.0), 21.1, 10.6, 0.253, 25.0, 6),
    ((11.0, -7.5), 8.0, 30.0, -0.6, 12.0, 9),
    ((3.0, 4.0), 15.0, 15.0, 0.95, 25.0, 5),
])
def test_bvn_cell_masses_quad_matches_jax(mu, sx, sy, rho, cell, K):
    mu = np.array(mu, np.float32)
    want = jbvn.bvn_cell_masses_quad(jnp.asarray(mu), sx, sy, rho, cell, K)
    got = tbvn.bvn_cell_masses_quad(t32(mu), sx, sy, rho, cell, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BVN_ATOL)


# ----------------------------------------------------------------------
# one day for N parameter sets
# ----------------------------------------------------------------------

def _particles():
    """Three parameter sets (take-off, flight and local diffusion, mu_r,
    n_periods) as numpy rows."""
    hp = np.tile(np.array(HPARAMS, np.float32), (3, 1))
    hp[1, 0], hp[2, 2] = 0.8, 4.0
    Dp = np.stack([[21.1, 10.6, r] for r in RHOS]).astype(np.float32)
    return hp, Dp, DLPS, np.array([1.1, 0.9, 1.3], np.float32), \
        np.array([10, 12, 0])


def _jax_day(i, day, cfg_kw):
    flat, cs, T = wind()
    hp, Dp, Dl, mur, nper = _particles()
    return jdk.build_daily_kernel(
        jnp.asarray(flat), jnp.asarray(cs), jnp.int32(day),
        tuple(hp[i]), tuple(Dp[i]), tuple(Dl[i]), jnp.float32(mur[i]),
        jnp.int32(nper[i]), jnp.float32(1500.0), jnp.int32(0),
        jdk.KernelConfig(periods=T, **BASE, **cfg_kw))


@pytest.mark.parametrize('day', [0, 2])
def test_batched_plain_accumulate_matches_jax(day):
    # the plain twin of the particle-batched kernel: each particle's buffer
    # and loss against JAX's XLA accumulate with the select scheme
    flat, cs, T = wind()
    hp, Dp, _, mur, nper = _particles()
    cfg = tdk.KernelConfig(periods=T, **BASE)
    h, mu, idx, clip, _ = tdk.day_scatter_inputs(
        t32(flat), t32(cs), day, tuple(t32(hp.T.copy())[:, :, None]),
        t32(mur)[:, None], torch.as_tensor(nper)[:, None], 0, cfg, 1500.0)
    assert h.shape == (3, T) and idx.shape == (3, T, 2)
    L = 2 * BASE['rad_res'] + 1 + 4 * BASE['K']
    buf, loss = tday.accumulate_day_batched(h, mu, idx, clip, t32(Dp), 25.0,
                                            BASE['K'], L)
    assert buf.shape == (3, L, L) and loss.shape == (3,)
    for i in range(3):
        wb, wl = jdk.xla_accumulate_day(
            jnp.asarray(h[i].numpy()), jnp.asarray(mu[i].numpy()),
            jnp.asarray(idx[i].numpy()), jnp.asarray(clip[i].numpy()),
            tuple(Dp[i]), 25.0, BASE['K'], 16, L, batched_bvn=True)
        np.testing.assert_allclose(buf[i].numpy(), np.asarray(wb),
                                   atol=DAY_ATOL)
        np.testing.assert_allclose(loss[i].numpy(), np.asarray(wl),
                                   atol=DAY_ATOL)


@pytest.mark.parametrize('rho', [0.253, 0.6, 0.8, 0.93, -0.99])
def test_batched_plain_particle_is_its_own_tier(rho):
    # each particle of the plain twin is bitwise accumulate_day_plain at
    # its own Genz tier (branch=None reads it from the particle's rho),
    # beside a particle of another tier in the same call
    flat, cs, T = wind()
    cfg = tdk.KernelConfig(periods=T, **BASE)
    hp = np.tile(np.array(HPARAMS, np.float32), (2, 1))
    hp[1, 0] = 0.8
    h, mu, idx, clip, _ = tdk.day_scatter_inputs(
        t32(flat), t32(cs), 1, tuple(t32(hp.T.copy())[:, :, None]),
        t32(np.array([1.1, 0.9], np.float32))[:, None],
        torch.as_tensor([10, 12])[:, None], 0, cfg, 1500.0)
    Dp = t32(np.array([[21.1, 10.6, rho], [30.0, 18.0, -0.4 * rho]],
                      np.float32))
    L = 2 * BASE['rad_res'] + 1 + 4 * BASE['K']
    buf, loss = tday.accumulate_day_batched_plain(h, mu, idx, clip, Dp, 25.0,
                                                  BASE['K'], L)
    for i in range(2):
        one, one_loss = tday.accumulate_day_plain(
            h[i], mu[i], idx[i], clip[i], tuple(Dp[i]), 25.0, BASE['K'], L)
        assert torch.equal(buf[i], one) and torch.equal(loss[i], one_loss)


def test_batched_accumulate_takes_no_gradient():
    flat, cs, T = wind()
    cfg = tdk.KernelConfig(periods=T, **BASE)
    h, mu, idx, clip, _ = tdk.day_scatter_inputs(
        t32(flat), t32(cs), 1, HPARAMS, 1.1, 10, 0, cfg, 1500.0)
    L = 2 * BASE['rad_res'] + 1 + 4 * BASE['K']
    Dp = torch.tensor([[21.1, 10.6, 0.3]], requires_grad=True)
    with pytest.raises(ValueError, match='no gradient'):
        tday.accumulate_day_batched(h[None], mu[None], idx[None], clip[None],
                                    Dp, 25.0, BASE['K'], L)
    with pytest.raises(ValueError, match=r'\(N, 3\)'):
        tday.accumulate_day_batched(h[None], mu[None], idx[None], clip[None],
                                    (21.1, 10.6, 0.3), 25.0, BASE['K'], L)


@pytest.mark.parametrize('day', [0, 1])
def test_build_daily_kernel_batched_matches_jax(day):
    # three particles' pmfs and losses in one call against JAX's builder
    # with batched_bvn, particle by particle (the vmap's per-particle
    # program); n_periods = 0 floors to one period as in JAX
    flat, cs, T = wind()
    hp, Dp, Dl, mur, nper = _particles()
    pmf, loss = tdk.build_daily_kernel_batched(
        t32(flat), t32(cs), day, tuple(t32(hp.T.copy())),
        tuple(t32(Dp.T.copy())), tuple(t32(Dl.T.copy())), t32(mur),
        torch.as_tensor(nper), 1500.0, 0,
        tdk.KernelConfig(periods=T, **BASE))
    assert pmf.shape == (3, 121, 121) and loss.shape == (3,)
    for i in range(3):
        want_pmf, want_loss = _jax_day(i, day, dict(batched_bvn=True))
        np.testing.assert_allclose(pmf[i].numpy(), np.asarray(want_pmf),
                                   atol=DAY_ATOL)
        np.testing.assert_allclose(loss[i].numpy(), np.asarray(want_loss),
                                   atol=DAY_ATOL)
        np.testing.assert_allclose(pmf[i].sum().item(), 1.0, atol=1e-4)


def test_propagate_pop_particle_axis_is_per_particle():
    # a leading particle axis propagates each population as alone (the same
    # transforms batched: f32 roundoff of the batched FFT, 1e-6 of the peak)
    rng = np.random.default_rng(6)
    D, ndays = 21, 4
    k = rng.uniform(0, 1, (2, ndays, D, D)).astype(np.float32)
    k /= k.sum(axis=(-2, -1), keepdims=True)
    w = torch.tensor([0.6, 0.4])
    cfg = SolverConfig.for_domain(D // 2)
    both = propagate_pop(t32(k), 2, 1000.0, w, cfg)
    for i in range(2):
        one = propagate_pop(t32(k[i]), 2, 1000.0, w, cfg)
        np.testing.assert_allclose(both[i].numpy(), one.numpy(),
                                   atol=1e-6 * one.abs().max().item())


# ----------------------------------------------------------------------
# the Bayes model over N parameter sets
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def setups():
    ov = tm.map_cli_params(OV)
    jsetup = JaxSetup(ov)
    s = jsetup.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    tsetup = BayesSetup(tm.map_cli_params(OV), device='cpu',
                        forward_setup=fs)
    return jsetup, tsetup


def _draws3(tsetup, seed=3):
    g = torch.Generator().manual_seed(seed)
    m = sample_prior_model(g, 3)
    o = sample_prior_obs(g, tsetup.field_areas.numpy(),
                         tsetup.min_field_area, 'poisson', 3)
    return m, o


def _flat(proj):
    rel, sent, grid = proj
    return [*rel, *sent, grid]


def test_with_batched_bvn_is_a_copy(setups):
    _, tsetup = setups
    tb = tsetup.with_batched_bvn()
    assert tb.setup.kcfg.batched_bvn and not tsetup.setup.kcfg.batched_bvn
    assert tb.setup.kcfg.pallas == tsetup.setup.kcfg.pallas
    assert tb.obs_ops is tsetup.obs_ops


@pytest.mark.parametrize('use_sprd', [False, True])
def test_batched_forward_projections_match_jax_vmap(setups, use_sprd):
    # three prior draws in one batched forward against JAX's
    # vmap(with_batched_bvn().forward_projections): the same f32 relative
    # limit as test_torch_map.py's forward_projections parity (2e-5 of
    # each projection's largest entry); the pre-spread day with one
    # factor per particle
    jsetup, tsetup = setups
    m, _ = _draws3(tsetup)
    sprd = np.array([0.1, 0.3, 0.05], np.float32) if use_sprd else None
    jb = jsetup.with_batched_bvn()

    def one(v, s):
        return jb.forward_projections(
            jp.ModelParams(*[v[i] for i in range(15)]), s)

    want = (jax.vmap(one)(jnp.asarray(m.numpy()), jnp.asarray(sprd))
            if use_sprd else
            jax.vmap(lambda v: one(v, None))(jnp.asarray(m.numpy())))
    got = tsetup.with_batched_bvn().forward_projections(
        _as_model(m), None if sprd is None else t32(sprd))
    for g, w in zip(_flat(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.shape[0] == 3
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max())


def test_batched_likelihood_and_priors_are_per_particle(setups):
    # log_likelihood, log_prior_model and log_prior_obs over N parameter
    # sets: each particle's value as its own in-turn call gives (f32
    # summation order: 1e-6 relative)
    _, tsetup = setups
    m, o = _draws3(tsetup, seed=8)
    proj = tsetup.with_batched_bvn().forward_projections(_as_model(m))
    ll = tsetup.log_likelihood(proj, _as_obs(o, tsetup.n_sent))
    pm = log_prior_model(_as_model(m))
    po = log_prior_obs(_as_obs(o, tsetup.n_sent), tsetup.field_areas,
                       tsetup.min_field_area)
    assert ll.shape == pm.shape == po.shape == (3,)
    for i in range(3):
        pi = (tuple(x[i] for x in proj[0]), tuple(x[i] for x in proj[1]),
              proj[2][i])
        one = tsetup.log_likelihood(pi, _as_obs(o[i], tsetup.n_sent))
        np.testing.assert_allclose(ll[i].item(), one.item(), rtol=1e-6)
        assert pm[i].item() == log_prior_model(_as_model(m[i])).item()
        np.testing.assert_allclose(po[i].item(), log_prior_obs(
            _as_obs(o[i], tsetup.n_sent), tsetup.field_areas,
            tsetup.min_field_area).item(), rtol=1e-6)


# ----------------------------------------------------------------------
# one batched move round against JAX's batched _move_prog
# ----------------------------------------------------------------------

def _step_draws(key, n_moves):
    """One JAX ``_mcmc_step``'s draws from ``key`` as the port's
    ``StepDraws`` (test_torch_smc.py's replay)."""
    key, k_prop, k_acc = random.split(key, 3)
    eps = random.normal(k_prop, (15,))
    log_u = jnp.log(random.uniform(k_acc))
    obs_eps, obs_log_u = [], []
    for _ in range(n_moves):
        key, k1, k2 = random.split(key, 3)
        obs_eps.append(random.normal(k1))
        obs_log_u.append(jnp.log(random.uniform(k2)))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return ts.StepDraws(t(eps), t(log_u), t(obs_eps), t(obs_log_u))


def test_batched_move_round_matches_jax(setups):
    # three prior particles, retuned to their population covariance, one
    # batched AM move at beta = 0.01 on the zero-count observations
    # (test_torch_smc.py explains the mask): JAX's
    # _move_prog(with_batched_bvn(), 1, ..., batched=True) against the
    # port's mcmc_step_batched with JAX's draws replayed
    jsetup, tsetup = setups
    data = (*tsetup.obs_release, *tsetup.obs_sentinel, tsetup.obs_grid)
    keep = (torch.cat([d.reshape(-1) for d in data]) == 0).numpy()
    jmask, tmask = jsetup.split_point_mask(keep), tsetup.split_point_mask(
        keep)
    jstates = jsmc.init_smc_particles(jsetup, random.PRNGKey(7), 3,
                                      obs_mask=jmask)
    mu, cov = jsmc._population_cov(np.asarray(jstates.m), np.zeros(3))
    jstates = jsmc._retune(jstates, mu, cov, 0.0)
    beta = 0.01
    move = jsmc._move_prog(jsetup.with_batched_bvn(), 1, 0.05, None, 1,
                           True)
    want = move(jstates, jnp.float32(beta), jmask)
    n_obs = 4 + tsetup.n_sent
    draws = [_step_draws(jnp.asarray(k), n_obs)
             for k in np.asarray(jstates.key)]
    stacked = ts.StepDraws(*[torch.stack(x) for x in zip(*draws)])
    per = [port_chain_state(chain_state_arrays(
        jax.tree.map(lambda x: x[i], jstates)), tsetup, torch.Generator())
        for i in range(3)]
    with torch.no_grad():
        per = [p._replace(loglik=tsetup.log_likelihood(
            p.proj, _as_obs(p.o, tsetup.n_sent), tmask)) for p in per]
    states = ts.stack_states(per)
    cfg = ts.MCMCConfig(n_samples=1, adapt_start=500, obs_scale=0.05)
    got = ts.mcmc_step_batched(tsetup.with_batched_bvn(), states, cfg,
                               beta=beta, obs_mask=tmask, draws=stacked)
    for f in ('count', 'accepts_m', 'accepts_o'):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.accepts_m.sum() > 0          # a block proposal moved
    # positions to 3e-4 of the proposal sd (test_torch_smc.py: the two
    # packages' f32 Cholesky factors of a covariance spanning four orders
    # of scale), the rest to 1e-5 relative
    sd = np.sqrt((2.38 ** 2 / 15) * np.diagonal(cov)).astype(np.float32)
    np.testing.assert_array_less(
        np.abs(got.m.numpy() - np.asarray(want.m)),
        3e-4 * sd + 4 * np.spacing(np.abs(np.asarray(want.m))))
    for f in ('o', 'loglik', 'prior_m', 'prior_o', 'log_scale'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-4, err_msg=f)


# ----------------------------------------------------------------------
# run_smc(batched=True) on the port
# ----------------------------------------------------------------------

CHEAP = tsmc.SMCConfig(n_particles=4, n_moves=1, min_accepts=0.0,
                       max_move_rounds=1)


class _Stop(Exception):
    pass


def _run_to(setup, stage, batched, resume=None, seed=11, key=2):
    """run_smc stopped after ``stage`` through its checkpoint callback;
    ``batched``: a bool, or a function of the stage the run is at."""
    keep = {}

    def cb(payload):
        keep.update(payload)
        if payload['stage'] == stage:
            raise _Stop

    with pytest.raises(_Stop):
        tsmc.run_smc(setup, key if resume is None else None, CHEAP,
                     seed=seed, resume=resume, checkpoint=cb,
                     batched=batched)
    return keep


def _same_run(a, b):
    for f in ts.ChainState._fields:
        if f not in ('key', 'proj'):
            assert torch.equal(getattr(a['states'], f),
                               getattr(b['states'], f)), f
    for x, y in zip(a['states'].key, b['states'].key):
        assert torch.equal(x.get_state(), y.get_state())
    assert a['logz'] == b['logz'] and a['stage'] == b['stage']
    np.testing.assert_array_equal(a['logw'], b['logw'])
    for k in a['history']:
        np.testing.assert_array_equal(a['history'][k], b['history'][k])


@pytest.fixture(scope='module')
def plain(setups):
    return setups[1]


def test_batched_smc_resumes_bitwise(plain):
    # stopped after stage 1 and resumed to stage 3: the uninterrupted
    # batched run at stage 3, bit for bit; the batched and in-turn runs
    # consume the same draws, so here they accept alike and resample at
    # the same stages (their positions differ by the node rule's roundoff,
    # carried through each stage's retuned covariance)
    mono = _run_to(plain, 3, True)
    part = _run_to(plain, 1, True)
    _same_run(mono, _run_to(plain, 3, True, resume=part))
    inturn = _run_to(plain, 3, False)
    for k in ('accept', 'resampled'):
        np.testing.assert_array_equal(mono['history'][k],
                                      inturn['history'][k])


def test_batched_smc_flips_mode_mid_anneal(plain):
    # the annealer state does not depend on the mode: a run resumed from
    # an in-turn stage 1 with batched moves is the run whose first stage
    # ran in turn, and the other way round
    inturn1 = _run_to(plain, 1, False)
    flipped = _run_to(plain, 2, True, resume=inturn1)
    assert flipped['stage'] == 2 and flipped['beta'] > inturn1['beta']
    batched1 = _run_to(plain, 1, True)
    back = _run_to(plain, 2, False, resume=batched1)
    assert back['stage'] == 2
    # both two-stage runs are deterministic functions of their path
    _same_run(flipped, _run_to(plain, 2, True, resume=_run_to(plain, 1,
                                                              False)))


def test_para_smc_batched_through_bayes_run(tmp_path, capsys, monkeypatch):
    # PARA_SMC_BATCHED=1 on --sampler smc: the JAX CLI's line, a store
    # equal to run_smc(batched=True)'s, and a resume in turn (the flag
    # unset) that continues it
    from parasitoids_tpu_torch.bayes import run as brun
    db = str(tmp_path / 'smc_b')
    knobs = ['--moves', '1', '--min-accepts', '0', '--max-move-rounds', '1',
             '--device', 'cpu']
    monkeypatch.setenv('PARA_SMC_BATCHED', '1')
    with pytest.raises(RuntimeError, match='max_stages=2'):
        brun.main(['--new', '4', '0', db, '--sampler', 'smc',
                   '--max-stages', '2'] + knobs + OV)
    assert 'batched (vmap) rejuvenation enabled' in capsys.readouterr().out
    setup = brun.build_setup(OV, device='cpu')
    mono = _run_to(setup, 2, True, seed=0, key=0)
    with np.load(db + '.npz') as d:
        np.testing.assert_array_equal(d['state_m'], mono['states'].m.numpy())
    monkeypatch.delenv('PARA_SMC_BATCHED')
    with pytest.raises(RuntimeError, match='max_stages=3'):
        brun.main(['--resume', db, '0', '--sampler', 'smc',
                   '--max-stages', '3'] + knobs + OV)
    assert 'rejuvenation enabled' not in capsys.readouterr().out

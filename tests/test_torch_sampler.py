"""Port parity of the adaptive-Metropolis sampler (bayes/sampler.py)
against the JAX package at the small configuration of test_torch_map.py
(3 days, 10 km / 50 cells, interp 2, K 6, Kl 3), for the plain-Poisson and
the negative-binomial observation model.  The port's forward setup is built
from the JAX setup's arrays (``setup_from_numpy``), so both packages see
the same wind bits.

The two packages' random streams differ, so JAX's draws are replayed: the
test splits the JAX key exactly as ``_mcmc_step`` and ``_obs_sweep`` do and
hands the normals and log-uniforms to the port's step (``StepDraws``).

Tolerances.  The log likelihood here is about −4.4e4, where one f32 ulp is
0.004, and the packages' f32 forwards differ in their last bits, so a
log-ratio is held to ``RATIO_RTOL`` of the likelihood's magnitude (about
0.02).  An accept decision is compared only where ``|log u − ratio|``
clears ten times that; the fixed keys below leave no decision nearer.
Observations with a positive count over an expected count that is 0 in f64
are held out of both likelihoods (``support_mask_at``): their log-pmf is
f32 FFT roundoff, different in each package."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from tests._torch_parity import (CHAIN_FIELDS, MAP_SMALL, chain_state_arrays,
                                 port_chain_state, support_mask_at, torch)

from parasitoids_tpu.bayes import sampler as js
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import priors as tp
from parasitoids_tpu_torch.bayes import sampler as ts
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.models.forward import setup_from_numpy

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

RATIO_RTOL = 5e-7         # of |loglik|, plus RATIO_ATOL: a log-ratio
RATIO_ATOL = 1e-4
STEP_KEYS = (3, 20, 84)   # JAX keys of the replayed steps and sweeps


def _split_step_key(key, n_moves):
    """The draws of one JAX ``_mcmc_step`` from ``key`` (sampler.py:227-232
    and :177-198), as the port's ``StepDraws`` on the CPU."""
    key, k_prop, k_acc = random.split(key, 3)
    eps = random.normal(k_prop, (15,))
    log_u = jnp.log(random.uniform(k_acc))
    obs_eps, obs_log_u = _split_sweep_key(key, n_moves)
    return ts.StepDraws(torch.from_numpy(np.array(eps)),
                        torch.from_numpy(np.array(log_u)), obs_eps,
                        obs_log_u)


def _split_sweep_key(key, n_moves):
    obs_eps, obs_log_u = [], []
    for _ in range(n_moves):
        key, k1, k2 = random.split(key, 3)
        obs_eps.append(random.normal(k1))
        obs_log_u.append(jnp.log(random.uniform(k2)))
    return (torch.from_numpy(np.asarray(obs_eps, np.float32)),
            torch.from_numpy(np.asarray(obs_log_u, np.float32)))


class Pair:
    """Both packages' setups for one observation model, a likelihood mask
    that holds out the roundoff-rate observations at the start and at every
    replayed proposal, and the JAX functions, jitted once."""

    def __init__(self, obs_model):
        ov = list(MAP_SMALL) + ['obs_model=' + obs_model]
        self.js = JaxSetup(tm.map_cli_params(ov))
        s = self.js.setup
        fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                              s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                              s.dist_weights, 'cpu', torch.float32)
        self.ts = BayesSetup(tm.map_cli_params(ov), device='cpu',
                             forward_setup=fs)
        ts64 = BayesSetup(tm.map_cli_params(ov), device='cpu',
                          dtype=torch.float64)
        self.n_obs = 4 + self.ts.n_sent + self.ts.n_extra_obs
        m0 = tp.initial_model_params()
        points = [m0]
        for k in STEP_KEYS:
            eps = _split_step_key(random.PRNGKey(k), 0).eps.double().numpy()
            m = m0 + tp.STEP_SCALES * eps
            m[13] = np.round(m[13])
            points.append(m)
        keep = support_mask_at(ts64, points)
        assert keep.mean() > 0.8            # most observations are scored
        self.jmask = self.js.split_point_mask(keep)
        self.tmask = self.ts.split_point_mask(keep)
        cfg = js.MCMCConfig(1)
        self.jinit = jax.jit(lambda key, mask: js.init_chain_state(
            self.js, key, obs_mask=mask))
        self.jstep = jax.jit(lambda st, beta, mask: js._mcmc_step(
            self.js, st, cfg, beta, mask))
        self.jsweep = jax.jit(lambda st, beta, mask: js._obs_sweep(
            self.js, st.key, st.o, st.prior_o, st.loglik, st.proj, beta,
            cfg, mask))
        self.jstate = self.jinit(random.PRNGKey(0), self.jmask)
        self.tol = RATIO_RTOL * abs(float(self.jstate.loglik)) + RATIO_ATOL


@pytest.fixture(scope='module', params=['poisson', 'negbin'])
def pair(request):
    return Pair(request.param)


def _spy(monkeypatch, name, log):
    """Record every result of the port's ``sampler.<name>``."""
    real = getattr(ts, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        log.append(out)
        return out

    monkeypatch.setattr(ts, name, wrapper)


def _assert_clear(log_u, ratios, tol, what):
    margin = np.abs(np.asarray(log_u, np.float64) - np.asarray(ratios,
                                                               np.float64))
    finite = np.isfinite(np.asarray(ratios, np.float64))
    assert np.all(margin[finite] > 10 * tol), \
        '{}: a decision lies within ten tolerances ({:.3g}) of its ' \
        'ratio; pick another key'.format(what, margin[finite].min())


def _assert_states_agree(got, want, tol):
    got, want = chain_state_arrays(got), chain_state_arrays(want)
    for f in CHAIN_FIELDS:
        if f in ('loglik', 'prior_m', 'prior_o'):
            np.testing.assert_allclose(got[f], want[f], rtol=0, atol=tol,
                                       err_msg=f)
        elif f in ('accepts_m', 'accepts_o', 'count'):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            # positions and moments are sums and products of the same f32
            # numbers: a few ulps, with an absolute floor for m2's zeros
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5,
                                       atol=1e-7, err_msg=f)


@pytest.mark.parametrize('count,log_scale', [(0.0, 0.0), (499.0, 0.0),
                                             (500.0, 0.0), (2000.0, 0.7)])
def test_proposal_chol_matches_jax(count, log_scale):
    # seeded diag(scales²) below adapt_start, the scaled empirical
    # covariance from it on (rtol 1e-5; the strict upper triangle is 0)
    rng = np.random.default_rng(int(count))
    a = rng.standard_normal((15, 15)) * tp.STEP_SCALES[:, None]
    arrays = dict(m=tp.initial_model_params(), o=np.zeros(10), loglik=0.0,
                  prior_m=0.0, prior_o=0.0, count=count, mean=np.zeros(15),
                  m2=(a @ a.T) * max(count, 1.0), accepts_m=0.0,
                  accepts_o=0.0, log_scale=log_scale)
    f32 = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    jstate = js.ChainState(proj=(), key=None, **{
        k: jnp.asarray(v) for k, v in f32.items()})
    tstate = ts.ChainState(proj=(), key=None, **{
        k: torch.from_numpy(v) for k, v in f32.items()})
    want = np.asarray(js._proposal_chol(jstate, 500))
    got = ts._proposal_chol(tstate, 500).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert np.all(np.triu(got, 1) == 0)
    if count < 500:
        np.testing.assert_allclose(np.diag(got), tp.STEP_SCALES, rtol=1e-6)


def test_init_chain_state_matches_jax(pair):
    got = ts.init_chain_state(pair.ts, torch.Generator().manual_seed(0),
                              obs_mask=pair.tmask)
    want = pair.jstate
    assert got.o.shape == (pair.n_obs,) and got.m.shape == (15,)
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.prior_m), float(want.prior_m),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.prior_o), float(want.prior_o),
                               rtol=1e-5)
    _assert_states_agree(got, want, pair.tol)
    # the projections at the test_torch_map.py tolerances
    jflat = np.concatenate([np.ravel(p) for p in (*want.proj[0],
                                                  *want.proj[1],
                                                  want.proj[2])])
    tflat = torch.cat([p.reshape(-1) for p in (*got.proj[0], *got.proj[1],
                                               got.proj[2])]).numpy()
    np.testing.assert_allclose(tflat, jflat, rtol=1e-4,
                               atol=1e-6 * np.abs(jflat).max())
    assert not any(t.requires_grad for t in (got.loglik, *got.proj[0]))


@pytest.mark.parametrize('beta', [1.0, 0.0])
@pytest.mark.parametrize('key', STEP_KEYS)
def test_obs_sweep_matches_jax(pair, key, beta, monkeypatch):
    # one sweep of the real JAX function from the shared start, JAX's
    # draws replayed in the port; every decision is clear of its ratio by
    # ten tolerances, so the accepted moves and the final block agree
    jstate = pair.jstate._replace(key=random.PRNGKey(key))
    _, o_want, prior_want, ll_want, acc_want = pair.jsweep(
        jstate, beta, pair.jmask)
    obs_eps, obs_log_u = _split_sweep_key(random.PRNGKey(key), pair.n_obs)
    state = port_chain_state(chain_state_arrays(jstate), pair.ts)
    moves = []
    _spy(monkeypatch, '_obs_move', moves)
    with torch.no_grad():
        o_got, prior_got, ll_got, acc_got = ts._obs_sweep(
            pair.ts, obs_eps, obs_log_u, state.o, state.prior_o,
            state.loglik, state.proj, beta, ts.MCMCConfig(1), pair.tmask)
    assert len(moves) == pair.n_obs
    _assert_clear(obs_log_u.numpy(), [float(m[3]) for m in moves],
                  pair.tol, 'sweep')
    assert float(acc_got) == float(acc_want) and 0 < float(acc_got)
    np.testing.assert_allclose(o_got.numpy(), np.asarray(o_want), rtol=1e-6)
    np.testing.assert_allclose(float(prior_got), float(prior_want),
                               rtol=0, atol=pair.tol)
    np.testing.assert_allclose(float(ll_got), float(ll_want), rtol=0,
                               atol=pair.tol)
    # the input block is chain state: the sweep wrote none of it in place
    np.testing.assert_array_equal(state.o.numpy(), np.asarray(jstate.o))


@pytest.mark.parametrize('beta', [1.0, 0.0])
@pytest.mark.parametrize('key', STEP_KEYS)
def test_mcmc_step_matches_jax(pair, key, beta, monkeypatch):
    # one whole transition of the real JAX step, its draws replayed: the
    # block proposal, its log-ratio (read off the port's proposal and held
    # against JAX's through the accepted state), the decisions, the
    # moments, the sweep and the trace row
    jstate = pair.jstate._replace(key=random.PRNGKey(key))
    jnew, jsample = pair.jstep(jstate, beta, pair.jmask)
    draws = _split_step_key(random.PRNGKey(key), pair.n_obs)
    state = port_chain_state(chain_state_arrays(jstate), pair.ts)
    proposals, moves = [], []
    _spy(monkeypatch, '_model_proposal', proposals)
    _spy(monkeypatch, '_obs_move', moves)
    new, sample = ts._mcmc_step(pair.ts, state, ts.MCMCConfig(1), beta,
                                pair.tmask, draws=draws)
    (m_prop, _, _, _, ratio), = proposals
    _assert_clear([float(draws.log_u)], [float(ratio)], pair.tol, 'block')
    _assert_clear(draws.obs_log_u.numpy(), [float(m[3]) for m in moves],
                  pair.tol, 'sweep')
    want_prop = np.asarray(jstate.m) + tp.STEP_SCALES * draws.eps.numpy()
    want_prop[13] = np.round(want_prop[13])
    np.testing.assert_allclose(m_prop.numpy(), want_prop, rtol=1e-6)
    _assert_states_agree(new, jnew, pair.tol)
    np.testing.assert_allclose(sample.numpy()[:-1],
                               np.asarray(jsample)[:-1], rtol=1e-6)
    np.testing.assert_allclose(float(sample[-1]), float(jsample[-1]),
                               rtol=0, atol=pair.tol)
    assert sample.shape == (15 + pair.n_obs + 1,)


def test_block_decisions_cover_accept_and_reject(pair):
    # over the replayed keys and both temperatures the JAX step both
    # accepts and rejects the block, so the parity above sees both arms
    seen = set()
    for key in STEP_KEYS:
        for beta in (1.0, 0.0):
            jnew, _ = pair.jstep(pair.jstate._replace(
                key=random.PRNGKey(key)), beta, pair.jmask)
            seen.add(float(jnew.accepts_m))
    assert seen == {0.0, 1.0}


@pytest.fixture(scope='module')
def plain():
    """The port's setup alone, unmasked (the chain tests need no JAX)."""
    return BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu')


def test_am_chain_moves_and_adapts(plain):
    # the asserts of test_am_sampler.py:35-52 on the port, then the
    # adapted proposal (a short adapt_start) keeps the chain finite and
    # moves the scale factor
    state = ts.init_chain_state(plain, ts.chain_generator(0, 0, 'cpu'))
    assert np.isfinite(float(state.loglik))
    n = 150
    state, traces = ts.run_mcmc(plain, state, ts.MCMCConfig(n_samples=n))
    traces = traces.numpy()
    assert traces.shape == (n, 15 + 10 + 1)
    assert np.isfinite(traces).all()
    acc_m = float(state.accepts_m) / n
    assert 0.0 < acc_m < 0.95, acc_m
    assert float(state.count) == n
    assert 0 < float(state.accepts_o) < n * 10
    assert float(state.log_scale) == 0.0          # not adapting yet
    state, more = ts.run_mcmc(plain, state,
                              ts.MCMCConfig(n_samples=30, adapt_start=100))
    assert np.isfinite(more.numpy()).all()
    assert float(state.log_scale) != 0.0 and float(state.count) == n + 30
    assert len(np.unique(more.numpy()[:, 15])) > 1    # xi still moves


def test_draws_are_reproducible_and_chains_differ():
    a = ts.draw_step(ts.chain_generator(7, 0, 'cpu'), 10, torch.float32,
                     'cpu')
    b = ts.draw_step(ts.chain_generator(7, 0, 'cpu'), 10, torch.float32,
                     'cpu')
    c = ts.draw_step(ts.chain_generator(7, 1, 'cpu'), 10, torch.float32,
                     'cpu')
    d = ts.draw_step(ts.chain_generator(8, 0, 'cpu'), 10, torch.float32,
                     'cpu')
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.eps, c.eps) and not torch.equal(a.eps, d.eps)
    assert a.eps.shape == (15,) and a.log_u.shape == ()
    assert a.obs_eps.shape == (10,) and a.obs_log_u.shape == (10,)
    assert bool((a.obs_log_u <= 0).all())


@pytest.mark.parametrize('z', [-2.0, 0.7, 3.0])
def test_obs_move_carries_the_hastings_term(plain, z):
    # the random walk's scale follows the current value, so the ratio must
    # carry log q(o|o') − log q(o'|o); at beta = 0 the rest of the ratio is
    # the priors' difference, and what is left is held against the two
    # normal densities in f64 (atol 2e-5: f32 priors of magnitude 10)
    from scipy.stats import norm
    state = ts.init_chain_state(plain, ts.chain_generator(0, 0, 'cpu'))
    cfg = ts.MCMCConfig(1)
    o = state.o.double().numpy()
    with torch.no_grad():
        for j in range(len(o)):
            o_prop, prior_p, _, ratio = ts._obs_move(
                plain, j, torch.tensor(z), state.o, state.prior_o,
                state.loglik, state.proj, 0.0, cfg)
            new = float(o_prop[j])
            s_fwd = max(abs(o[j]), 1e-3) * cfg.obs_scale
            s_rev = max(abs(new), 1e-3) * cfg.obs_scale
            np.testing.assert_allclose(new, o[j] + s_fwd * z, rtol=1e-6)
            want = norm.logpdf(o[j], new, s_rev) - norm.logpdf(new, o[j],
                                                               s_fwd)
            assert abs(want) > 1e-3                 # the term matters here
            got = float(ratio) - (float(prior_p) - float(state.prior_o))
            if np.isfinite(float(prior_p)):
                np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
            others = np.delete(np.arange(len(o)), j)
            assert torch.equal(o_prop[others], state.o[others])


def test_forward_is_skipped_outside_the_prior_support(plain, monkeypatch):
    # a proposal with lam > 1 has a −inf prior: no forward runs, the block
    # is rejected whatever the uniform, and the state stays finite
    state = ts.init_chain_state(plain, ts.chain_generator(0, 0, 'cpu'))
    draws = ts.draw_step(state.key, 10, torch.float32, 'cpu')
    eps = torch.zeros(15)
    eps[12] = 1e3                                  # lam = 0.95 + 0.5
    draws = draws._replace(eps=eps, log_u=torch.tensor(-np.inf))

    def no_forward(*a, **k):
        raise AssertionError('the forward ran outside the support')

    monkeypatch.setattr(plain, 'forward_projections', no_forward)
    before = ts.FORWARDS
    new, sample = ts._mcmc_step(plain, state, ts.MCMCConfig(1), draws=draws)
    assert ts.FORWARDS == before
    assert float(new.accepts_m) == 0.0 and torch.equal(new.m, state.m)
    assert all(a is b for a, b in zip(new.proj[0], state.proj[0]))
    assert torch.isfinite(sample).all() and float(new.count) == 1.0


def test_nan_likelihood_never_enters_the_state():
    # negbin: a move of the dispersion r below 0 gives log(r) = NaN in
    # the likelihood and a −inf prior; whatever the uniform says, the move
    # is rejected and nothing of the state turns NaN
    ov = list(MAP_SMALL) + ['obs_model=negbin']
    setup = BayesSetup(tm.map_cli_params(ov), device='cpu')
    state = ts.init_chain_state(setup, ts.chain_generator(0, 0, 'cpu'))
    n_obs = 4 + setup.n_sent + 1
    assert state.o.shape == (n_obs,)
    o_prop = state.o.clone()
    o_prop[-1] = -1.0
    with torch.no_grad():
        raw = setup.log_likelihood(state.proj, ts._as_obs(o_prop,
                                                          setup.n_sent))
    assert torch.isnan(raw)                       # the hazard is real
    obs_eps = torch.zeros(n_obs)
    obs_eps[-1] = -1e3                            # r = 10 − 500
    obs_log_u = torch.full((n_obs,), -np.inf)     # accept all that can be
    with torch.no_grad():
        o, prior_o, ll, acc = ts._obs_sweep(
            setup, obs_eps, obs_log_u, state.o, state.prior_o, state.loglik,
            state.proj, 1.0, ts.MCMCConfig(1))
    assert float(o[-1]) == float(state.o[-1])
    assert float(acc) == n_obs - 1                # zero steps are accepted
    assert all(torch.isfinite(t).all() for t in (o, prior_o, ll))


_HOST_READS = ('item', 'tolist', 'numpy', 'cpu', '__bool__', '__float__',
               '__int__', '__index__')


def test_step_reads_the_device_once_and_the_sweep_never(plain, monkeypatch):
    # on the card every conversion of a tensor to a Python value waits for
    # the device, and so does every host number or array copied to it: the
    # observation sweep makes none, and the model block makes exactly one
    # (BayesSetup._branches), which also hands every BVN of the forward its
    # branch.  Constants are made on the card once (the warm-up step).
    from parasitoids_tpu_torch.bayes import model as tmodel
    from parasitoids_tpu_torch.ops import bvn as tbvn
    state = ts.init_chain_state(plain, ts.chain_generator(0, 0, 'cpu'))
    cfg = ts.MCMCConfig(1, obs_sweeps=2)
    state, _ = ts._mcmc_step(plain, state, cfg)
    draws = ts.draw_step(state.key, 20, torch.float32, 'cpu')
    calls = []
    real_branches = type(plain)._branches
    real_tolist = torch.Tensor.tolist

    def no_read(*a, **k):
        raise AssertionError('a tensor was read on the host')

    def no_copy(*a, **k):
        raise AssertionError('host data was copied to the device')

    def no_rho_read(abs_rho):
        raise AssertionError('a BVN read its rho on the host')

    def counting_branches(self, m, prior=None):
        calls.append(1)
        monkeypatch.setattr(torch.Tensor, 'tolist', real_tolist)
        try:
            return real_branches(self, m, prior)
        finally:
            monkeypatch.setattr(torch.Tensor, 'tolist', no_read)

    monkeypatch.setattr(type(plain), '_branches', counting_branches)
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, no_read)
    for name in ('as_tensor', 'tensor', 'from_numpy'):
        monkeypatch.setattr(torch, name, no_copy)
    # _branches itself maps its host values through genz_branch
    monkeypatch.setattr(tmodel, 'genz_branch', tbvn.genz_branch)
    monkeypatch.setattr(tbvn, 'genz_branch', no_rho_read)
    try:
        new, sample = ts._mcmc_step(plain, state, cfg, draws=draws)
    finally:
        monkeypatch.undo()
    assert len(calls) == 1
    assert torch.isfinite(sample).all()
    assert float(new.count) == 2.0 and float(new.accepts_o) >= 0

"""Port parity of parallel tempering (bayes/tempering.py) against the JAX
package, at the small configuration of test_torch_sampler.py (3 days,
10 km / 50 cells, interp 2, K 6, Kl 3).

The ladders, ``logsumexp``, ``log_evidence``, ``tune_ladder`` and
``_pairing`` are held to JAX's exactly (the same numpy, or integer
arithmetic).  The swap sweep is held exactly on synthetic stacked states
with JAX's uniforms replayed.  One ``run_pt`` call (T = 3, two rounds of
two steps) is held against JAX's with every step's draws and every
round's uniforms replayed, at the AM step's tolerance of
test_torch_sampler.py: positions and moments to 1e-5, the log densities to
``RATIO_RTOL`` of the likelihood's magnitude, the decisions and swap
counts exactly (each decision clear of its ratio by five of its
tolerances).  Observations with a positive count over an expected count
that is 0 in f64 at any start or proposal are held out of both
likelihoods (``support_mask_at``).  The rest runs on the port alone:
T = 1 is plain AM, chunked runs are bitwise a monolithic one, the command
line's ``--new``/``--resume``, one replica per device
(``run_pt_sharded``, on a mesh that names the CPU once per rung) is
bitwise ``run_pt`` and, draws replayed, JAX's ``run_pt_sharded``, and
the round loop's spans (``pt.round``, ``pt.swap``) record each round and
move no bit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from tests._torch_parity import (MAP_SMALL, chain_state_arrays,
                                 port_chain_state, support_mask_at, torch)

from parasitoids_tpu.bayes import sampler as js
from parasitoids_tpu.bayes import tempering as jt
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import sampler as ts
from parasitoids_tpu_torch.bayes import tempering as tt
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.models.forward import setup_from_numpy

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

RATIO_RTOL = 5e-7         # of |loglik|, as test_torch_sampler.py
RATIO_ATOL = 1e-4
# the replayed swap key and the replicas' JAX keys of the run_pt parity:
# every decision of that run lies clear of its ratio, a swap is accepted
PT_KEY = 27
CHAIN_KEYS = (27, 28, 29)


# ----------------------------------------------------------------------
# host functions: exactly JAX's
# ----------------------------------------------------------------------

@pytest.mark.parametrize('n,beta_min', [(1, 0.1), (2, 0.3), (5, 0.05),
                                        (8, 0.2)])
def test_geometric_ladder_matches_jax(n, beta_min):
    got = tt.geometric_ladder(n, beta_min)
    np.testing.assert_array_equal(got, jt.geometric_ladder(n, beta_min))
    assert got.dtype == np.float32 and got[0] == 1.0


@pytest.mark.parametrize('n,power', [(2, 5.0), (6, 5.0), (8, 3.0)])
def test_power_ladder_matches_jax(n, power):
    got = tt.power_ladder(n, power)
    np.testing.assert_array_equal(got, jt.power_ladder(n, power))
    assert got[0] == 1.0 and got[-1] == 0.0
    with pytest.raises(ValueError):
        tt.power_ladder(1)
    with pytest.raises(ValueError):
        tt.geometric_ladder(0)


@pytest.mark.parametrize('x', [[0.0, 1.0, -3.0], [-np.inf, -np.inf],
                               [1e3, 1e3 + 1.0, -1e3], [np.inf, 0.0]])
def test_logsumexp_matches_jax(x):
    got, want = tt.logsumexp(x), jt.logsumexp(x)
    assert got == want or (np.isnan(got) and np.isnan(want))


def _conjugate_lls(betas, n, seed):
    """Exact tempered-posterior draws of the conjugate normal of
    tests/test_tempering.py:64: theta ~ N(0,1), y | theta ~ N(theta, s2)."""
    rng = np.random.default_rng(seed)
    y, s2 = 1.7, 0.5
    lls = np.empty((len(betas), n))
    for i, b in enumerate(betas):
        tau = 1.0 + b / s2
        th = rng.normal(b * y / s2 / tau, 1.0 / np.sqrt(tau), size=n)
        lls[i] = -0.5 * (np.log(2 * np.pi * s2) + (y - th) ** 2 / s2)
    exact = -0.5 * (np.log(2 * np.pi * (1 + s2)) + y ** 2 / (1 + s2))
    return lls, exact


def _evidence_case(name):
    rng = np.random.default_rng(5)
    n = 2000
    if name == 'conjugate':
        betas = tt.power_ladder(32, power=3.0)
        lls, _ = _conjugate_lls(betas, 4000, 0)
        return betas, lls, 100
    if name == 'incomplete':
        return tt.geometric_ladder(4, beta_min=0.2), np.zeros((4, 10)), 0
    betas = np.array([1.0, 0.5, 0.0], np.float32)
    cold = -2 if name == 'healthy' else -50
    return betas, np.stack([rng.normal(cold, 0.3, n),
                            rng.normal(-5, 0.3, n),
                            rng.normal(-10, 0.3, n)]), 0


@pytest.mark.parametrize('name', ['conjugate', 'incomplete', 'healthy',
                                  'stuck'])
def test_log_evidence_matches_jax(name):
    betas, lls, burn = _evidence_case(name)
    got = tt.log_evidence(betas, lls, burn=burn)
    want = jt.log_evidence(betas, lls, burn=burn)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == 'conjugate':
        # and both recover the exact evidence (tests/test_tempering.py:64)
        _, exact = _conjugate_lls(betas, 1, 0)
        assert got['complete'] and got['equilibrated']
        np.testing.assert_allclose(got['ss'], exact, atol=0.05)
        np.testing.assert_allclose(got['ti'], exact, atol=0.05)
    assert got['complete'] == (name != 'incomplete')
    assert got['equilibrated'] == (name != 'stuck')
    if name == 'stuck':
        assert 1 in np.asarray(got['nonmonotone_at'])


def test_log_evidence_rejects_what_jax_rejects():
    betas, lls, _ = _evidence_case('healthy')
    for args in ((betas[:-1], lls, 0), (betas, lls, lls.shape[1])):
        for f in (tt.log_evidence, jt.log_evidence):
            with pytest.raises(ValueError):
                f(*args)


@pytest.mark.parametrize('case', range(5))
def test_tune_ladder_matches_jax(case):
    betas, rates, kappa = [
        (tt.power_ladder(5), np.full(4, 0.4), 0.5),
        (tt.power_ladder(5), np.array([0.9, 0.3, 0.3, 0.3]), 0.5),
        (tt.geometric_ladder(5, 0.05), np.array([0.8, 0.4, 0.2, 0.1]), 0.6),
        (np.array([1.0, 0.0], np.float32), np.array([0.5]), 0.5),
        (tt.power_ladder(8, 3.0), np.linspace(0.05, 0.9, 7), 0.3)][case]
    got = tt.tune_ladder(betas, rates, kappa)
    np.testing.assert_array_equal(got, jt.tune_ladder(betas, rates, kappa))
    assert got[0] == 1.0 and (np.diff(got) < 0).all()
    with pytest.raises(ValueError):
        tt.tune_ladder(tt.power_ladder(5), np.zeros(2))


@pytest.mark.parametrize('T', [1, 2, 3, 5, 6])
@pytest.mark.parametrize('parity', [0, 1])
def test_pairing_matches_jax(T, parity):
    got = tt._pairing(torch.arange(T), parity, T)
    want = jt._pairing(jnp.arange(T), parity, T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------------
# the swap sweep, with JAX's uniforms
# ----------------------------------------------------------------------

def _synthetic_states(T, seed):
    """Stacked chain-state arrays of T replicas (f32) whose log
    likelihoods are spread so that some swaps accept and some do not."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(m=f(T, 15), o=f(T, 10),
                loglik=(-60.0 * rng.random(T) - 1.0).astype(np.float32),
                prior_m=f(T), prior_o=f(T), count=f(T), mean=f(T, 15),
                m2=f(T, 15, 15), accepts_m=f(T), accepts_o=f(T),
                log_scale=f(T)), (f(T, 3, 2), f(T, 4))


def _swap_uniforms_jax(key, T):
    return np.asarray([random.uniform(random.fold_in(key, p))
                       for p in range(T - 1)], np.float32)


@pytest.mark.parametrize('T', [2, 3, 5])
@pytest.mark.parametrize('parity', [0, 1])
def test_swap_sweep_matches_jax(T, parity):
    # the same stacked states, ladder and uniforms: the same permutation
    # of the swap fields (gathers, so bit for bit), the adaptation fields
    # and generators left with their rung, and the same counts
    arrays, proj = _synthetic_states(T, 10 * T + parity)
    betas = tt.power_ladder(T, 1.0)
    key = random.PRNGKey(7 * T + parity)
    jstates = js.ChainState(
        proj=tuple(jnp.asarray(p) for p in proj),
        key=random.split(random.PRNGKey(0), T),
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    jnew, jacc, jatt = jt._swap_sweep_stacked(jstates, jnp.asarray(betas),
                                              key, parity)
    gens = tuple(torch.Generator() for _ in range(T))
    tstates = ts.ChainState(
        proj=tuple(torch.from_numpy(p) for p in proj), key=gens,
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    new, acc, att = tt._swap_sweep_stacked(
        tstates, torch.from_numpy(betas), parity,
        torch.from_numpy(_swap_uniforms_jax(key, T)))
    for f in arrays:
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(jnew, f)),
                                      err_msg=f)
    for g, w in zip(new.proj, jnew.proj):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(att.numpy(), np.asarray(jatt))
    assert all(a is b for a, b in zip(new.key, gens))
    # the sweep reads nothing back: its outputs stay tensors
    assert torch.is_tensor(acc) and torch.is_tensor(new.loglik)


def test_swap_sweep_cases_accept_and_reject():
    # over the cases above, swaps are both accepted and refused
    seen = set()
    for T in (2, 3, 5):
        for parity in (0, 1):
            arrays, proj = _synthetic_states(T, 10 * T + parity)
            key = random.PRNGKey(7 * T + parity)
            jstates = js.ChainState(
                proj=tuple(jnp.asarray(p) for p in proj),
                key=random.split(random.PRNGKey(0), T),
                **{k: jnp.asarray(v) for k, v in arrays.items()})
            _, acc, att = jt._swap_sweep_stacked(
                jstates, jnp.asarray(tt.power_ladder(T, 1.0)), key, parity)
            seen |= {float(a) for a, n in zip(np.asarray(acc),
                                              np.asarray(att)) if n}
    assert seen == {0.0, 1.0}


def test_swap_uniforms_depend_on_seed_and_round_only():
    a = tt.swap_uniforms(5, 3, 4, 'cpu')
    assert torch.equal(a, tt.swap_uniforms(5, 3, 4, 'cpu'))
    assert not torch.equal(a, tt.swap_uniforms(5, 4, 4, 'cpu'))
    assert not torch.equal(a, tt.swap_uniforms(6, 3, 4, 'cpu'))
    assert a.dtype == torch.float32 and bool(((a >= 0) & (a < 1)).all())


# ----------------------------------------------------------------------
# one run_pt call against JAX's, draws replayed
# ----------------------------------------------------------------------

def _step_draws(key, n_moves):
    """One JAX ``_mcmc_step``'s draws from ``key`` (sampler.py:227-232 and
    :177-198) as the port's ``StepDraws``, and the key after the step."""
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


class PTReplay:
    """The JAX draws of a ``run_pt`` call: each replica's steps from its
    own key chain, each round's swap uniforms from the swap key."""

    def __init__(self, n_moves, rounds, swap_every, swap_key):
        self.steps = {}
        for t, k in enumerate(CHAIN_KEYS):
            key = random.PRNGKey(k)
            for i in range(rounds * swap_every):
                self.steps[t, i], key = _step_draws(key, n_moves)
        self.se = swap_every
        self.swap_key = swap_key
        self.order = []           # (beta index, draws) in call order

    def draws(self, rr, t):
        out = [self.steps[t, rr * self.se + k] for k in range(self.se)]
        self.order += [(t, d) for d in out]
        return out

    def swap_u(self, rr):
        return torch.from_numpy(_swap_uniforms_jax(
            random.fold_in(self.swap_key, rr), len(CHAIN_KEYS)))


def _spy(monkeypatch, name, log):
    real = getattr(ts, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        log.append(out)
        return out

    monkeypatch.setattr(ts, name, wrapper)


@pytest.fixture(scope='module')
def pt_setups():
    """Both packages' setups at the small configuration (the port's built
    from JAX's arrays), the port's in f64, and three jittered starts."""
    jsetup = JaxSetup(tm.map_cli_params(MAP_SMALL))
    s = jsetup.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    tsetup = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                        forward_setup=fs)
    ts64 = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                      dtype=torch.float64)
    starts = tt.init_pt_states(tsetup, 0, 3).m.numpy()
    return jsetup, tsetup, ts64, starts


def _run_port(setup, arrays_or_m0, replay, cfg, betas, monkeypatch,
              from_jax=False, mesh=None):
    """The port's run_pt (run_pt_sharded with a ``mesh``) with the
    replayed draws; returns its result and the spied block proposals and
    observation moves."""
    proposals, moves = [], []
    with monkeypatch.context() as mp:
        _spy(mp, '_model_proposal', proposals)
        _spy(mp, '_obs_move', moves)
        if from_jax:
            states = ts.stack_states([
                port_chain_state(a, setup, torch.Generator())
                for a in arrays_or_m0])
        else:
            states = ts.stack_states([
                ts.init_chain_state(setup, torch.Generator(), m0=m)
                for m in arrays_or_m0])
        if mesh is None:
            out = tt.run_pt(setup, states, betas, None, cfg,
                            draws=replay.draws, swap_u=replay.swap_u)
        else:
            out = tt.run_pt_sharded(setup, states, betas, None, cfg, mesh,
                                    draws=replay.draws, swap_u=replay.swap_u)
    return out, proposals, moves


def _fitted_mask(tsetup, ts64, starts, cfg, betas, swap_key, monkeypatch):
    """The held-out mask of the run_pt parity: observations with a
    positive count over an expected count that is 0 in f64 at a start or
    at any proposal of the masked run, found by iterating the port's run
    with the replayed draws until its proposals are all covered."""
    n_obs = 4 + tsetup.n_sent + tsetup.n_extra_obs
    points = [m for m in starts]
    setup = tsetup
    for _ in range(4):
        _, props, _ = _run_port(setup, starts,
                                PTReplay(n_obs, 2, 2, swap_key), cfg, betas,
                                monkeypatch)
        new = [p[0].numpy() for p in props]
        if len(points) > len(starts) and all(
                any(np.array_equal(q, p) for p in points) for q in new):
            return keep
        points += new
        keep = support_mask_at(ts64, points)
        setup = tsetup.with_held_out(keep)
    raise AssertionError('the mask did not settle; pick another PT_KEY')


def test_run_pt_matches_jax(pt_setups, monkeypatch):
    jsetup, tsetup, ts64, starts = pt_setups
    T, cfg = 3, tt.PTConfig(n_rounds=2, swap_every=2)
    betas = tt.power_ladder(T)
    n_obs = 4 + tsetup.n_sent + tsetup.n_extra_obs
    swap_key = random.PRNGKey(PT_KEY)
    keep = _fitted_mask(tsetup, ts64, starts, cfg, betas, swap_key,
                        monkeypatch)
    assert keep.mean() > 0.8
    jm, tmk = jsetup.with_held_out(keep), tsetup.with_held_out(keep)
    # the masked run's proposals, for the check below
    _, props, _ = _run_port(tmk, starts, PTReplay(n_obs, 2, 2, swap_key),
                            cfg, betas, monkeypatch)

    jinit = jax.jit(lambda key, m0: js.init_chain_state(jm, key, m0=m0))
    jstates = [jinit(random.PRNGKey(k), jnp.asarray(m0))
               for k, m0 in zip(CHAIN_KEYS, starts)]
    jstack = jax.tree.map(lambda *x: jnp.stack(x), *jstates)
    jfinal, jtr, jstats = jt.run_pt(jm, jstack, betas, swap_key, cfg)

    replay = PTReplay(n_obs, 2, 2, swap_key)
    (final, tr, stats), props2, moves = _run_port(
        tmk, [chain_state_arrays(s) for s in jstates], replay, cfg, betas,
        monkeypatch, from_jax=True)
    tol = RATIO_RTOL * abs(float(jstates[0].loglik)) + RATIO_ATOL
    # every proposal of the masked run was one the mask was made for
    assert len(props2) == len(props) == T * 4
    for a, b in zip(props2, props):
        np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-6)
    # every decision clear of its ratio by five of its tolerances (the
    # tolerance scales with the replica's beta)
    beta_of = [betas[t] for t, _ in replay.order]
    block = [(float(d.log_u), float(p[4]), b)
             for (_, d), p, b in zip(replay.order, props2, beta_of)]
    obs_u = [(float(d.obs_log_u[j]), b)
             for (_, d), b in zip(replay.order, beta_of)
             for j in range(n_obs)]
    assert len(moves) == len(obs_u)
    obs = [(lu, float(mv[3]), b) for (lu, b), mv in zip(obs_u, moves)]
    for log_u, ratio, b in block + obs:
        if np.isfinite(ratio):
            assert abs(log_u - ratio) > 5 * (b * tol + RATIO_ATOL), \
                'a decision lies near its ratio; pick another PT_KEY'

    np.testing.assert_array_equal(stats['swap_attempts'].numpy(),
                                  np.asarray(jstats['swap_attempts']))
    np.testing.assert_array_equal(stats['swap_accepts'].numpy(),
                                  np.asarray(jstats['swap_accepts']))
    got, want = tr.numpy(), np.asarray(jtr)
    assert got.shape == want.shape == (T, 4, 15 + n_obs + 1)
    np.testing.assert_allclose(got[..., :-1], want[..., :-1], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got[..., -1], want[..., -1], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(stats['loglik'].numpy(),
                               np.asarray(jstats['loglik']), rtol=0,
                               atol=tol)
    for f in ('m', 'o', 'mean', 'm2'):
        np.testing.assert_allclose(getattr(final, f).numpy(),
                                   np.asarray(getattr(jfinal, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    for f in ('count', 'accepts_m', 'accepts_o', 'log_scale'):
        np.testing.assert_array_equal(getattr(final, f).numpy(),
                                      np.asarray(getattr(jfinal, f)),
                                      err_msg=f)
    # the run both accepted and refused block proposals
    acc_m = final.accepts_m.numpy()
    assert 0 < acc_m.sum() < T * 4


def test_run_pt_sharded_matches_jax(pt_setups, monkeypatch):
    # one replica per device: the port's run_pt_sharded on a mesh that
    # names the CPU three times against JAX's on three virtual devices,
    # every step's draws and every round's uniforms replayed (JAX's
    # sharded swap draws what its stacked one draws); the tolerances of
    # test_run_pt_matches_jax, whose decisions this run repeats
    from parasitoids_tpu.parallel.chains import chain_mesh as jax_mesh
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    jsetup, tsetup, ts64, starts = pt_setups
    T, cfg = 3, tt.PTConfig(n_rounds=2, swap_every=2)
    betas = tt.power_ladder(T)
    n_obs = 4 + tsetup.n_sent + tsetup.n_extra_obs
    swap_key = random.PRNGKey(PT_KEY)
    keep = _fitted_mask(tsetup, ts64, starts, cfg, betas, swap_key,
                        monkeypatch)
    jm, tmk = jsetup.with_held_out(keep), tsetup.with_held_out(keep)
    jinit = jax.jit(lambda key, m0: js.init_chain_state(jm, key, m0=m0))
    jstates = [jinit(random.PRNGKey(k), jnp.asarray(m0))
               for k, m0 in zip(CHAIN_KEYS, starts)]
    jstack = jax.tree.map(lambda *x: jnp.stack(x), *jstates)
    jfinal, jtr, jstats = jt.run_pt_sharded(jm, jstack, betas, swap_key,
                                            cfg, jax_mesh(n_devices=T))
    arrays = [chain_state_arrays(s) for s in jstates]
    (final, tr, stats), _, _ = _run_port(
        tmk, arrays, PTReplay(n_obs, 2, 2, swap_key), cfg, betas,
        monkeypatch, from_jax=True, mesh=chain_mesh(devices=['cpu'] * T))
    tol = RATIO_RTOL * abs(float(jstates[0].loglik)) + RATIO_ATOL
    np.testing.assert_array_equal(stats['swap_attempts'].numpy(),
                                  np.asarray(jstats['swap_attempts']))
    np.testing.assert_array_equal(stats['swap_accepts'].numpy(),
                                  np.asarray(jstats['swap_accepts']))
    got, want = tr.numpy(), np.asarray(jtr)
    assert got.shape == want.shape == (T, 4, 15 + n_obs + 1)
    np.testing.assert_allclose(got[..., :-1], want[..., :-1], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got[..., -1], want[..., -1], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(stats['loglik'].numpy(),
                               np.asarray(jstats['loglik']), rtol=0,
                               atol=tol)
    for f in ('m', 'o', 'mean', 'm2'):
        np.testing.assert_allclose(getattr(final, f).numpy(),
                                   np.asarray(getattr(jfinal, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    for f in ('count', 'accepts_m', 'accepts_o', 'log_scale'):
        np.testing.assert_array_equal(getattr(final, f).numpy(),
                                      np.asarray(getattr(jfinal, f)),
                                      err_msg=f)
    # and it is bitwise the port's stacked run with the same draws
    (final2, tr2, stats2), _, _ = _run_port(
        tmk, arrays, PTReplay(n_obs, 2, 2, swap_key), cfg, betas,
        monkeypatch, from_jax=True)
    assert torch.equal(tr, tr2) and torch.equal(stats['loglik'],
                                                stats2['loglik'])
    for f in ('m', 'o', 'loglik', 'm2', 'log_scale'):
        assert torch.equal(getattr(final, f), getattr(final2, f)), f


# ----------------------------------------------------------------------
# the port alone
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def plain():
    return BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu')


def test_single_temperature_is_plain_am(plain):
    # T = 1: no swap, the replica is the AM chain (test_tempering.py:191)
    states = tt.init_pt_states(plain, 0, 1, jitter=0.0)
    st, tr, stats = tt.run_pt(plain, states, np.ones(1, np.float32), 9,
                              tt.PTConfig(n_rounds=2, swap_every=3))
    s0 = ts.unstack_states(tt.init_pt_states(plain, 0, 1, jitter=0.0))[0]
    _, tr_am = ts.run_mcmc(plain, s0, ts.MCMCConfig(n_samples=6))
    assert torch.equal(tr[0], tr_am)
    assert stats['swap_attempts'].shape == (0,)
    assert stats['loglik'].shape == (1, 6)
    assert float(stats['loglik'][0, -1]) == float(st.loglik[0])


def test_chunked_run_is_monolithic_bitwise(plain):
    # two offset chunks reproduce one monolithic run bit for bit: swap
    # parity and uniforms follow the global round (test_tempering.py:243)
    betas = tt.geometric_ladder(3, beta_min=0.1)
    cfg = tt.PTConfig(n_rounds=2, swap_every=2)
    st_m, tr_m, s_m = tt.run_pt(plain, tt.init_pt_states(plain, 7, 3), betas,
                                8, tt.PTConfig(n_rounds=4, swap_every=2))
    st_c, tr1, s1 = tt.run_pt(plain, tt.init_pt_states(plain, 7, 3), betas,
                              8, cfg)
    st_c, tr2, s2 = tt.run_pt(plain, st_c, betas, 8, cfg, round_offset=2)
    assert torch.equal(tr_m, torch.cat([tr1, tr2], 1))
    assert torch.equal(s_m['loglik'], torch.cat([s1['loglik'],
                                                 s2['loglik']], 1))
    assert torch.equal(s_m['swap_attempts'],
                       s1['swap_attempts'] + s2['swap_attempts'])
    assert torch.equal(s_m['swap_accepts'],
                       s1['swap_accepts'] + s2['swap_accepts'])
    np.testing.assert_array_equal(s_m['swap_attempts'].numpy(), [2.0, 2.0])
    for f in ('m', 'o', 'loglik', 'm2', 'log_scale'):
        assert torch.equal(getattr(st_m, f), getattr(st_c, f)), f
    for a, b in zip(st_m.key, st_c.key):
        assert torch.equal(a.get_state(), b.get_state())


def test_swapped_cache_follows_the_position(plain):
    # after swaps, each replica's cached log likelihood is that of its own
    # position (the swap moved the cache with the position)
    betas = tt.power_ladder(3, 1.0)
    st, _, stats = tt.run_pt(plain, tt.init_pt_states(plain, 1, 3), betas,
                             2, tt.PTConfig(n_rounds=4, swap_every=1))
    assert float(stats['swap_attempts'].sum()) == 4.0
    for t in range(3):
        s = ts.unstack_states(st)[t]
        with torch.no_grad():
            proj = plain.forward_projections(ts._as_model(s.m))
            ll = plain.log_likelihood(proj, ts._as_obs(s.o, plain.n_sent))
        np.testing.assert_allclose(float(ll), float(s.loglik), rtol=1e-6)


@pytest.mark.parametrize('name', ['run_pt_sharded', '_sharded_pt_prog',
                                  '_swap_step_collective'])
def test_sharded_entry_points_raise(name, plain):
    # (the name is the test's from before one replica per device was
    # ported; each case now holds its entry point)
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    betas = tt.geometric_ladder(3, beta_min=0.1)
    cfg = tt.PTConfig(n_rounds=2, swap_every=2)
    mesh = chain_mesh(devices=['cpu'] * 3)
    if name == 'run_pt_sharded':
        # bitwise run_pt, chunked at an offset too; the generators stay
        # with their rung; a ladder that does not match the mesh raises
        for off in (0, 3):
            st_a, tr_a, s_a = tt.run_pt(plain, tt.init_pt_states(plain, 7, 3),
                                        betas, 8, cfg, round_offset=off)
            st_b, tr_b, s_b = tt.run_pt_sharded(
                plain, tt.init_pt_states(plain, 7, 3), betas, 8, cfg, mesh,
                round_offset=off)
            assert torch.equal(tr_a, tr_b)
            for k in s_a:
                assert torch.equal(s_a[k], s_b[k]), k
            for f in ('m', 'o', 'loglik', 'prior_m', 'm2', 'log_scale'):
                assert torch.equal(getattr(st_a, f), getattr(st_b, f)), f
            assert all(torch.equal(a.get_state(), b.get_state())
                       for a, b in zip(st_a.key, st_b.key))
        assert float(s_b['swap_attempts'].sum()) > 0
        with pytest.raises(ValueError, match='one temperature per device'):
            tt.run_pt_sharded(plain, tt.init_pt_states(plain, 7, 2),
                              betas[:2], 8, cfg, mesh)
    elif name == '_sharded_pt_prog':
        # the one-round program: one rung on a one-device mesh advances
        # its replica as run_pt does and makes no swap
        one = chain_mesh(devices=['cpu'])
        fn = tt._sharded_pt_prog(plain, cfg, one, 1)
        s0 = tt.init_pt_states(plain, 4, 1)
        reps, tr, ll, acc, att = fn(ts.unstack_states(s0), np.ones(1),
                                    torch.ones(1), 0, None,
                                    lambda t: None)
        _, tr_ref, s_ref = tt.run_pt(plain, tt.init_pt_states(plain, 4, 1),
                                     np.ones(1, np.float32), 0,
                                     cfg._replace(n_rounds=1))
        assert torch.equal(tr, tr_ref) and torch.equal(ll, s_ref['loglik'])
        assert acc.shape == att.shape == (0,)
        with pytest.raises(ValueError, match='one temperature per device'):
            tt._sharded_pt_prog(plain, cfg, mesh, 2)
    else:
        # the neighbour exchange between replicas held apart is the
        # stacked sweep's gather, bit for bit, for every parity
        for T in (2, 3, 5):
            for parity in (0, 1):
                arrays, proj = _synthetic_states(T, 10 * T + parity)
                u = torch.from_numpy(_swap_uniforms_jax(
                    random.PRNGKey(7 * T + parity), T))
                stacked = ts.ChainState(
                    proj=tuple(torch.from_numpy(p) for p in proj),
                    key=tuple(torch.Generator() for _ in range(T)),
                    **{k: torch.from_numpy(v) for k, v in arrays.items()})
                b = torch.from_numpy(tt.power_ladder(T, 1.0))
                want, wacc, watt = tt._swap_sweep_stacked(stacked, b,
                                                          parity, u)
                reps, acc, att = tt._swap_step_collective(
                    ts.unstack_states(stacked), b, parity, u)
                got = ts.stack_states(reps)
                for f in arrays:
                    assert torch.equal(getattr(got, f),
                                       getattr(want, f)), f
                for g, w in zip(got.proj, want.proj):
                    assert torch.equal(g, w)
                assert torch.equal(acc, wacc) and torch.equal(att, watt)


@pytest.mark.parametrize('T', [1, 2])
def test_sharded_run_is_run_pt_at_short_ladders(T, plain):
    # the shared round loop at its edges: one rung makes no swap, two make
    # one pair, which the odd rounds leave unpaired; run_pt_sharded on a
    # mesh that names the CPU once per rung is run_pt bit for bit
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    betas = tt.geometric_ladder(T, beta_min=0.1)
    cfg = tt.PTConfig(n_rounds=3, swap_every=2)
    mesh = chain_mesh(devices=['cpu'] * T)
    st_a, tr_a, s_a = tt.run_pt(plain, tt.init_pt_states(plain, 5, T), betas,
                                3, cfg)
    st_b, tr_b, s_b = tt.run_pt_sharded(
        plain, tt.init_pt_states(plain, 5, T), betas, 3, cfg, mesh)
    assert tr_a.shape == (T, 6, tr_a.shape[-1])
    assert torch.equal(tr_a, tr_b)
    for k in s_a:
        assert torch.equal(s_a[k], s_b[k]), k
    for f in ('m', 'o', 'loglik', 'prior_m', 'm2', 'log_scale'):
        assert torch.equal(getattr(st_a, f), getattr(st_b, f)), f
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(st_a.key, st_b.key))
    np.testing.assert_array_equal(s_a['swap_attempts'].numpy(),
                                  [2.0] * (T - 1))


# ----------------------------------------------------------------------
# the round loop's spans
# ----------------------------------------------------------------------

def _pt_once(plain, T, traced, entry='run_pt'):
    """Two rounds of two steps on ``T`` rungs, tracing on or off: the
    results and the spans recorded."""
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    from parasitoids_tpu_torch.utils import trace
    betas = tt.power_ladder(T, 5.0) if T > 1 else np.ones(1, np.float32)
    cfg = tt.PTConfig(n_rounds=2, swap_every=2)
    states = tt.init_pt_states(plain, 4, T)
    trace.disable()
    trace.clear()
    if traced:
        trace.enable()
    try:
        if entry == 'run_pt':
            out = tt.run_pt(plain, states, betas, 6, cfg)
        else:
            out = tt.run_pt_sharded(plain, states, betas, 6, cfg,
                                    chain_mesh(devices=['cpu'] * T))
    finally:
        trace.disable()
    recs = trace.records()
    trace.clear()
    return out, recs


@pytest.mark.parametrize('T', [1, 3])
def test_a_round_records_its_steps_and_its_swap(plain, T):
    _, recs = _pt_once(plain, T, traced=True)
    ids = {r.id: r for r in recs}
    rounds = [r for r in recs if r.name == 'pt.round']
    swaps = [r for r in recs if r.name == 'pt.swap']
    steps = [r for r in recs if r.name == 'am.step']
    assert len(rounds) == 2
    # a plain span: no request of its own, each replica step is one
    assert all(r.parent is None and r.request is None for r in rounds)
    for rnd in rounds:
        mine = [s for s in steps if s.parent == rnd.id]
        assert len(mine) == T * 2
        assert len({s.request for s in mine}) == T * 2
    assert len(steps) == 2 * T * 2
    assert len(swaps) == (2 if T > 1 else 0)
    assert all(ids[s.parent].name == 'pt.round' and s.request is None
               for s in swaps)


@pytest.mark.parametrize('entry', ['run_pt', 'run_pt_sharded'])
def test_tracing_moves_no_bit(plain, entry):
    (st_a, tr_a, s_a), _ = _pt_once(plain, 3, False, entry)
    (st_b, tr_b, s_b), recs = _pt_once(plain, 3, True, entry)
    assert recs
    assert torch.equal(tr_a, tr_b)
    for k in s_a:
        assert torch.equal(s_a[k], s_b[k]), k
    for f in ('m', 'o', 'loglik', 'prior_m', 'prior_o', 'count', 'm2',
              'accepts_m', 'accepts_o', 'log_scale'):
        assert torch.equal(getattr(st_a, f), getattr(st_b, f)), f
    for a, b in zip(st_a.proj, st_b.proj):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(st_a.key, st_b.key))


OV = list(MAP_SMALL)


def test_pt_cli_new_and_resume(tmp_path, capsys):
    # --sampler pt end to end (test_tempering.py:304): chunks of
    # --checkpoint-every, the cold chain's post-burn draws, the ladder and
    # the full loglik history in the extras, the evidence report, a resume
    # that continues the store, a 0-step resume that recomputes the report,
    # and the AM path refusing the store
    from parasitoids_tpu_torch.bayes import run as brun
    from parasitoids_tpu_torch.bayes.store import load_extras
    db = str(tmp_path / 'pt_run')
    brun.main(['--new', '12', '4', db, '--sampler', 'pt', '--temps', '3',
               '--swap-every', '3', '--checkpoint-every', '6',
               '--device', 'cpu'] + OV)
    out = capsys.readouterr().out
    assert 'log evidence: TI' in out and 'swap acceptance by rung' in out
    assert out.count('checkpoint: ') == 2      # 6 rounds in chunks of 2
    with np.load(db + '.npz') as d:
        tr1 = d['traces']
    assert tr1.shape == (1, 14, 26)            # 6 rounds x 3 - 4 burn-in
    ex = load_extras(db)
    assert ex['betas'].shape == (3,) and ex['betas'][-1] == 0.0
    assert ex['loglik'].shape == (3, 18) and np.isfinite(ex['loglik']).all()
    brun.main(['--resume', db, '6', '--sampler', 'pt', '--device', 'cpu']
              + OV)
    with np.load(db + '.npz') as d:
        assert d['traces'].shape == (1, 20, 26)
        np.testing.assert_array_equal(d['traces'][:, :14], tr1)
    assert load_extras(db)['loglik'].shape == (3, 24)
    capsys.readouterr()
    brun.main(['--resume', db, '0', '--sampler', 'pt', '--device', 'cpu']
              + OV)
    assert 'log evidence: TI' in capsys.readouterr().out
    with pytest.raises(SystemExit, match='--sampler'):
        brun.main(['--resume', db, '6', '--device', 'cpu'] + OV)


def test_pt_cli_resumes_a_burn_in_only_store(tmp_path, capsys):
    # a store written before any post-burn draw (the (1, 0, 1)
    # placeholder) resumes into the sampling phase (test_tempering.py:357)
    from parasitoids_tpu_torch.bayes import run as brun
    db = str(tmp_path / 'pt_burn')
    brun.main(['--new', '0', '6', db, '--sampler', 'pt', '--temps', '2',
               '--swap-every', '3', '--device', 'cpu'] + OV)
    with np.load(db + '.npz') as d:
        assert d['traces'].shape[1] == 0
    assert 'no post-burn samples yet' in capsys.readouterr().out
    brun.main(['--resume', db, '6', '--sampler', 'pt', '--device', 'cpu']
              + OV)
    with np.load(db + '.npz') as d:
        assert d['traces'].shape == (1, 6, 26)

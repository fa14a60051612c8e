"""The port's NUTS sampler (bayes/nuts.py) against the JAX module.

The two packages' random streams differ, so JAX's draws are replayed: the
tests split the JAX key exactly as ``_nuts_step`` and
``_find_reasonable_eps`` do and hand the numbers to the port's functions
(``NUTSDraws``); a choice is compared only where its log-uniform clears the
threshold by 1e-4.  Then the statistical tests of tests/test_nuts.py on
analytic targets, run on the port (fewer draws than there, at the same
limits), and the stepwise sampler's checkpoints: an interrupted run resumed
from its checkpoint equals the uninterrupted run bit for bit."""

import math
import os
from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import random

from tests._torch_parity import torch

from parasitoids_tpu.bayes import nuts as jn
from parasitoids_tpu_torch.bayes import nuts as tn

CLEAR = 1e-4        # a replayed choice counts where |log u - threshold| > this


def _jax_draws(key, dim, max_depth):
    """The numbers one JAX ``_nuts_step`` takes from ``key``
    (nuts.py:317, :333, :225), as the port's ``NUTSDraws``."""
    key, k_mom = random.split(key)
    xi = random.normal(k_mom, (dim,))
    go, acc, leaf = [], [], []
    for depth in range(max_depth):
        key, k_dir, k_sub, k_acc = random.split(key, 4)
        go.append(bool(random.bernoulli(k_dir)))
        acc.append(float(jnp.log(random.uniform(k_acc))))
        for _ in range(2 ** depth):
            k_sub, k_mn = random.split(k_sub)
            leaf.append(float(jnp.log(random.uniform(k_mn))))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return tn.NUTSDraws(f32(xi), torch.as_tensor(go), f32(acc), f32(leaf))


def _gauss5(seed=0):
    """A 5-d correlated Gaussian: precision from a seeded random matrix."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((5, 5))
    cov = a @ a.T / 5 + 0.2 * np.eye(5)
    prec = np.linalg.inv(cov).astype(np.float32)
    mu = rng.standard_normal(5).astype(np.float32)
    jprec, jmu = jnp.asarray(prec), jnp.asarray(mu)
    tprec, tmu = torch.from_numpy(prec), torch.from_numpy(mu)

    def jlp(z):
        x = z - jmu
        return -0.5 * x @ jprec @ x

    def tlp(z):
        x = z - tmu
        return -0.5 * x @ tprec @ x
    return jlp, tlp, cov


@pytest.mark.parametrize('dense', [False, True])
def test_nuts_step_replays_jax(dense):
    # 20 transitions from seeded starts, each with JAX's draws: the same
    # leapfrog count, divergence, accept statistic and proposal (1e-5)
    jlp, tlp, cov = _gauss5()
    rng = np.random.default_rng(1)
    if dense:
        inv_mass = (0.5 * cov + 0.5 * np.eye(5)).astype(np.float32)
    else:
        inv_mass = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    step = np.float32(0.35)
    jstep = jax.jit(partial(jn._nuts_step, jax.value_and_grad(jlp),
                            jnp.asarray(inv_mass), step, 6))
    tlpg = tn.value_and_grad(tlp)
    compared = 0
    leaves = set()
    for seed in range(20):
        z = rng.standard_normal(5).astype(np.float32)
        lp, g = jax.value_and_grad(jlp)(jnp.asarray(z))
        want = jstep(jnp.asarray(z), lp, g, random.PRNGKey(seed))
        draws = _jax_draws(random.PRNGKey(seed), 5, 6)
        tz = torch.from_numpy(z)
        tlp0, tg = tlpg(tz)
        decisions = []
        got = tn._nuts_step(tlpg, torch.from_numpy(inv_mass),
                            torch.tensor(step), 6, tz, tlp0, tg, draws,
                            decisions=decisions)
        margins = [abs(float(u) - float(t)) for u, t in decisions
                   if math.isfinite(float(t))]
        if margins and min(margins) <= CLEAR:
            continue
        compared += 1
        assert got[4] == int(want[4])
        leaves.add(got[4])
        assert bool(got[5]) == bool(want[5])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5,
                                   atol=1e-6)
    assert compared >= 15 and len(leaves) >= 3, (compared, leaves)


def _leapfrog_ratio(prec, mu, inv_mass, z, xi, eps):
    """The acceptance ratio of one leapfrog of the Gaussian in f64."""
    lp = lambda x: -0.5 * (x - mu) @ prec @ (x - mu)
    grad = lambda x: -prec @ (x - mu)
    p = xi / np.sqrt(inv_mass)
    h0 = -lp(z) + 0.5 * p @ (inv_mass * p)
    ph = p + 0.5 * eps * grad(z)
    z1 = z + eps * inv_mass * ph
    p1 = ph + 0.5 * eps * grad(z1)
    return math.exp(min(max(h0 - (-lp(z1) + 0.5 * p1 @ (inv_mass * p1)),
                            -50.0), 50.0))


def test_find_reasonable_eps_replays_jax():
    # JAX's momentum replayed; compared where every visited ratio clears
    # 1/2 by 1e-4 (the f64 ratio of each visited step says so)
    jlp, tlp, cov = _gauss5()
    prec = np.linalg.inv(cov)
    rng = np.random.default_rng(2)
    jlpg = jax.value_and_grad(jlp)
    tlpg = tn.value_and_grad(tlp)
    seen = set()
    compared = 0
    for seed in range(20):
        z = rng.standard_normal(5).astype(np.float32)
        inv_mass = rng.uniform(0.5, 2.0, 5).astype(np.float32)
        eps0 = float(10.0 ** rng.uniform(-3, 0.5))
        lp, g = jlpg(jnp.asarray(z))
        want, _ = jn._find_reasonable_eps(jlpg, jnp.asarray(z), lp, g,
                                          jnp.asarray(inv_mass),
                                          random.PRNGKey(seed), eps0)
        _, kp = random.split(random.PRNGKey(seed))
        xi = np.array(random.normal(kp, (5,)))
        mu = -np.linalg.solve(prec, np.asarray(g, np.float64)) + z
        # the visited steps, in f64: clear of 1/2?
        ratios = [_leapfrog_ratio(prec, mu, inv_mass.astype(np.float64),
                                  z.astype(np.float64), xi, eps0 * 2.0 ** k)
                  for k in range(-31, 32)]
        if min(abs(r - 0.5) for r in ratios) <= CLEAR:
            continue
        compared += 1
        tz = torch.from_numpy(z)
        tlp0, tg = tlpg(tz)
        got = tn._find_reasonable_eps(tlpg, tz, tlp0, tg,
                                      torch.from_numpy(inv_mass),
                                      torch.from_numpy(xi), eps0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        seen.add(float(got) > eps0)
    assert compared >= 15 and seen == {True, False}


# ---------------------------------------------------------------------------
# statistical tests (tests/test_nuts.py on the port)
# ---------------------------------------------------------------------------

def _corr_gauss_logpdf(z):
    """2-D correlated Gaussian: mean (1, -2), sd (1, 3), rho 0.7."""
    x = (z - torch.tensor([1.0, -2.0])) / torch.tensor([1.0, 3.0])
    return -0.5 * (x[0] ** 2 - 1.4 * x[0] * x[1] + x[1] ** 2) / (1 - 0.49)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_nuts_correlated_gaussian_moments():
    cfg = tn.NUTSConfig(num_warmup=200, num_samples=800, max_depth=8,
                        init_step_size=0.5)
    out = tn.nuts_sample(_corr_gauss_logpdf, torch.zeros(2), _gen(0), cfg)
    s = out['samples'].numpy()
    assert int(out['n_divergent']) == 0
    assert 0.55 < float(out['accept_rate']) <= 1.0
    np.testing.assert_allclose(s.mean(axis=0), [1.0, -2.0], atol=0.25)
    np.testing.assert_allclose(s.std(axis=0), [1.0, 3.0], rtol=0.2)
    assert 0.55 < np.corrcoef(s.T)[0, 1] < 0.85


def test_nuts_mass_matrix_adapts_to_scales():
    sd = torch.tensor([0.05, 5.0, 1.0])
    cfg = tn.NUTSConfig(num_warmup=200, num_samples=400, max_depth=8,
                        init_step_size=0.1)
    out = tn.nuts_sample(lambda z: -0.5 * torch.sum((z / sd) ** 2),
                         torch.zeros(3), _gen(1), cfg)
    np.testing.assert_allclose(np.sqrt(out['inv_mass'].numpy()), sd.numpy(),
                               rtol=0.5)
    np.testing.assert_allclose(out['samples'].numpy().std(axis=0),
                               sd.numpy(), rtol=0.25)


def _gauss_prec(rho, sds):
    cov = np.array([[sds[0] ** 2, rho * sds[0] * sds[1]],
                    [rho * sds[0] * sds[1], sds[1] ** 2]])
    return cov, torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)


def test_nuts_dense_mass_recovers_covariance():
    cov, prec = _gauss_prec(0.9, (1.0, 2.0))
    logpdf = lambda z: -0.5 * z @ prec @ z
    cfg = tn.NUTSConfig(num_warmup=300, num_samples=600, max_depth=8,
                        init_step_size=0.5, dense_mass=True)
    out = tn.nuts_sample(logpdf, torch.zeros(2), _gen(3), cfg)
    inv_mass = out['inv_mass'].numpy()
    assert inv_mass.shape == (2, 2)
    np.testing.assert_allclose(inv_mass, cov, rtol=0.5)
    assert inv_mass[0, 1] > 0.5 * cov[0, 1]
    assert int(out['n_divergent']) == 0
    np.testing.assert_allclose(np.cov(out['samples'].numpy().T), cov,
                               rtol=0.3, atol=0.15)
    out_d = tn.nuts_sample(logpdf, torch.zeros(2), _gen(3),
                           cfg._replace(dense_mass=False))
    np.testing.assert_allclose(np.cov(out_d['samples'].numpy().T), cov,
                               rtol=0.3, atol=0.2)
    assert float(out['step_size']) > 0.5 * float(out_d['step_size'])


def test_nuts_fixed_mass_warm_start():
    cov, prec = _gauss_prec(0.9, (0.2, 5.0))
    im = tn.inv_mass_from_hessian(prec)
    np.testing.assert_allclose(im.numpy(), cov, rtol=1e-3, atol=1e-3)
    cfg = tn.NUTSConfig(num_warmup=100, num_samples=800, max_depth=8,
                        dense_mass=True, fixed_mass=True)
    out = tn.nuts_sample(lambda z: -0.5 * z @ prec @ z, torch.zeros(2),
                         _gen(5), cfg, init_inv_mass=im)
    assert torch.equal(out['inv_mass'], im)         # the metric never moved
    assert int(out['n_divergent']) == 0
    np.testing.assert_allclose(np.cov(out['samples'].numpy().T), cov,
                               rtol=0.3, atol=0.02)
    assert float(out['step_size']) > 0.3


def test_inv_mass_from_hessian_guards():
    H = torch.as_tensor(np.diag([4.0, -4.0, 0.0, 1e12]), dtype=torch.float32)
    im = tn.inv_mass_from_hessian(H).numpy()
    assert np.allclose(np.diag(im), [0.25, 0.25, 100.0, 1e-12])
    assert (np.linalg.eigvalsh(im) > 0).all()
    bad = torch.full((3, 3), math.nan)
    assert torch.equal(tn.inv_mass_from_hessian(bad), torch.eye(3))
    assert torch.equal(tn.psd_clip_covariance(bad), torch.eye(3))
    pc = tn.psd_clip_covariance(torch.as_tensor(np.diag([1.0, -0.5, 1e9]),
                                                dtype=torch.float32))
    assert np.allclose(np.diag(pc.numpy()), [1.0, 0.5, 100.0])
    # against the JAX functions, with and without the prior-variance floor
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    Hs = a @ a.T - 2.0 * np.eye(6, dtype=np.float32)
    pv = rng.uniform(0.1, 3.0, 6)
    for kw in ({}, {'prior_var': pv, 'floor_frac': 0.3}):
        np.testing.assert_allclose(
            tn.inv_mass_from_hessian(torch.from_numpy(Hs), **kw).numpy(),
            np.asarray(jn.inv_mass_from_hessian(jnp.asarray(Hs), **kw)),
            rtol=2e-4, atol=2e-5)


def test_backward_subtree_uturn_symmetric():
    # a straight trajectory is no U-turn in either direction; a genuine
    # U-turn is seen in both (the subtree is one depth of a transition
    # whose directions all point one way)
    def logpdf(z):
        return -0.5 * torch.sum(z * z)

    lpg = tn.value_and_grad(logpdf)
    z0 = torch.zeros(2)
    lp0, g0 = lpg(z0)
    p0 = torch.tensor([1.0, 0.2])
    for eps, depth, turns in [(0.05, d, False) for d in (1, 2, 3, 4)] + [
            (0.5, 4, True)]:
        counts = []
        for right in (True, False):
            draws = tn.NUTSDraws(p0, torch.full((depth + 1,), right),
                                 torch.full((depth + 1,), -math.inf),
                                 torch.full((2 ** (depth + 1) - 1,), 0.0))
            # the first depth subtrees make a straight run of 2**depth - 1
            # leaves; one more depth is the subtree under test
            decisions = []
            out = tn._nuts_step(lpg, torch.ones(2), torch.tensor(eps),
                                depth + 1, z0, lp0, g0, draws,
                                decisions=decisions)
            counts.append(out[4])
        assert counts[0] == counts[1], (eps, depth, counts)
        if not turns:
            assert counts[0] == 2 ** (depth + 1) - 1
        else:
            assert counts[0] < 2 ** (depth + 1) - 1


# ---------------------------------------------------------------------------
# the stepwise sampler: checkpoints, chunks, Gibbs-n
# ---------------------------------------------------------------------------

def _gibbs_target(z, n, rate=5.0, slope=0.0):
    """z0 ~ N(slope*n, 1), z1 ~ N(0, 1), n ~ Poisson(rate) on n >= 1."""
    return (-0.5 * (z[0] - slope * n) ** 2 - 0.5 * z[1] ** 2
            + n * math.log(rate) - rate - torch.lgamma(n + 1.0))


def _gens(seed, n=2):
    return [torch.Generator().manual_seed(seed * 100 + i) for i in range(n)]


class _Stop(Exception):
    pass


def _interrupter(at):
    def progress(phase, i, total):
        if (phase, i) == at:
            raise _Stop
    return progress


def _kw(gibbs):
    return (dict(gibbs_n=_gibbs_target, n0=5.0), None) if gibbs else (
        {}, _corr_gauss_logpdf)


@pytest.mark.parametrize('gibbs', [False, True])
@pytest.mark.parametrize('interrupt', ['warmup', 'draw'])
def test_stepwise_checkpoint_resume_exact(tmp_path, interrupt, gibbs):
    cfg = tn.NUTSConfig(num_warmup=8, num_samples=10, max_depth=4)
    z0s = torch.zeros((2, 2))
    kw, target = _kw(gibbs)
    ckpt = str(tmp_path / 'run.ckpt.npz')
    ref = tn.nuts_sample_stepwise(target, z0s, _gens(5), cfg, **kw)
    stop_at = ('warmup', 5) if interrupt == 'warmup' else ('sample', 4)
    with pytest.raises(_Stop):
        tn.nuts_sample_stepwise(target, z0s, _gens(5), cfg,
                                progress=_interrupter(stop_at),
                                checkpoint_path=ckpt, checkpoint_every=2,
                                **kw)
    assert os.path.exists(ckpt)
    # fresh generators: the checkpoint carries their state
    out = tn.nuts_sample_stepwise(target, z0s, _gens(99), cfg,
                                  checkpoint_path=ckpt, checkpoint_every=2,
                                  resume=True, **kw)
    for key in ('samples', 'logp', 'step_size', 'inv_mass', 'n_leapfrog') + (
            ('n_periods',) if gibbs else ()):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    assert not os.path.exists(ckpt)   # a completed run drops it
    assert out['samples'].shape == (2, 10, 2)


@pytest.mark.parametrize('gibbs', [False, True])
def test_stepwise_chunked_matches_single_step(gibbs):
    cfg = tn.NUTSConfig(num_warmup=8, num_samples=10, max_depth=4)
    kw, target = _kw(gibbs)
    ref = tn.nuts_sample_stepwise(target, torch.zeros((2, 2)), _gens(5), cfg,
                                  **kw)
    out = tn.nuts_sample_stepwise(target, torch.zeros((2, 2)), _gens(5), cfg,
                                  steps_per_call=3, **kw)
    for key in ('samples', 'logp', 'step_size') + (
            ('n_periods',) if gibbs else ()):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_stepwise_chunked_checkpoint_resumes_across_chunk_sizes(tmp_path):
    cfg = tn.NUTSConfig(num_warmup=8, num_samples=10, max_depth=4)
    z0s = torch.zeros((2, 2))
    ckpt = str(tmp_path / 'chunk.ckpt.npz')
    ref = tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(5), cfg)
    with pytest.raises(_Stop):
        tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(5), cfg,
                                progress=_interrupter(('sample', 6)),
                                checkpoint_path=ckpt, checkpoint_every=2,
                                steps_per_call=3)
    out = tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(5), cfg,
                                  checkpoint_path=ckpt, checkpoint_every=2,
                                  resume=True, steps_per_call=4)
    np.testing.assert_array_equal(out['samples'], ref['samples'])
    np.testing.assert_array_equal(out['logp'], ref['logp'])
    assert not os.path.exists(ckpt)


def test_stepwise_resume_rejects_mismatched_config(tmp_path):
    cfg = tn.NUTSConfig(num_warmup=6, num_samples=4, max_depth=4)
    z0s = torch.zeros((2, 2))
    ckpt = str(tmp_path / 'r.ckpt.npz')
    with pytest.raises(_Stop):
        tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(6), cfg,
                                progress=_interrupter(('warmup', 4)),
                                checkpoint_path=ckpt, checkpoint_every=2)
    with pytest.raises(ValueError, match='does not match'):
        tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(6),
                                cfg._replace(max_depth=5),
                                checkpoint_path=ckpt, resume=True)
    # a shorter, older signature resumes when this run keeps the defaults
    with np.load(ckpt) as d:
        payload = {k: d[k] for k in d.files}
    payload['cfg_sig'] = payload['cfg_sig'][:5]
    np.savez(ckpt, **payload)
    out = tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(6), cfg,
                                  checkpoint_path=ckpt, resume=True)
    assert out['samples'].shape == (2, 4, 2)
    with pytest.raises(FileNotFoundError):
        tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(6), cfg,
                                checkpoint_path=ckpt, resume=True)
    # the chains sharded over a mesh that names the CPU twice draw what
    # they draw without one, bit for bit; three chains do not divide
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    mesh = chain_mesh(devices=['cpu', 'cpu'])
    ref = tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(7), cfg)
    got = tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(7), cfg,
                                  mesh=mesh)
    for k in ('samples', 'logp', 'step_size', 'inv_mass', 'n_leapfrog'):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(ValueError, match='divisible'):
        tn.nuts_sample_stepwise(_corr_gauss_logpdf, torch.zeros((3, 2)),
                                _gens(7, 3), cfg, mesh=mesh)
    with pytest.raises(ValueError):
        tn.nuts_sample_stepwise(None, z0s, _gens(6), cfg,
                                gibbs_n=_gibbs_target, n0=5.0,
                                logpdf_args=(1.0,))


def test_gibbs_nuts_n_step_in_signature(tmp_path):
    cfg3 = tn.NUTSConfig(num_warmup=4, num_samples=6, max_depth=3, n_step=3)
    z0s = torch.zeros((2, 2))
    ckpt = str(tmp_path / 'ns.ckpt.npz')
    kw = dict(gibbs_n=_gibbs_target, n0=5.0)
    with pytest.raises(_Stop):
        tn.nuts_sample_stepwise(None, z0s, _gens(7), cfg3,
                                progress=_interrupter(('sample', 2)),
                                checkpoint_path=ckpt, checkpoint_every=1,
                                **kw)
    with pytest.raises(ValueError, match='does not match'):
        tn.nuts_sample_stepwise(None, z0s, _gens(7), cfg3._replace(n_step=1),
                                checkpoint_path=ckpt, resume=True, **kw)
    out = tn.nuts_sample_stepwise(None, z0s, _gens(7), cfg3,
                                  checkpoint_path=ckpt, resume=True, **kw)
    assert out['n_periods'].shape == (2, 6) and not os.path.exists(ckpt)
    # a plain run's signature records the canonical n_step = 1
    cfgp = tn.NUTSConfig(num_warmup=4, num_samples=6, max_depth=3, n_step=5)
    with pytest.raises(_Stop):
        tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(7), cfgp,
                                progress=_interrupter(('sample', 2)),
                                checkpoint_path=ckpt, checkpoint_every=1)
    out = tn.nuts_sample_stepwise(_corr_gauss_logpdf, z0s, _gens(7),
                                  cfgp._replace(n_step=1),
                                  checkpoint_path=ckpt, resume=True)
    assert out['samples'].shape == (2, 6, 2)


def test_nuts_fixed_mass_stepwise_matches_and_resumes(tmp_path):
    _, prec = _gauss_prec(0.6 / math.sqrt(2.0), (1.0, math.sqrt(2.0)))
    logpdf = lambda z: -0.5 * z @ prec @ z
    im = tn.inv_mass_from_hessian(prec)
    cfg = tn.NUTSConfig(num_warmup=30, num_samples=40, max_depth=6,
                        dense_mass=True, fixed_mass=True)
    mono = tn.nuts_sample(logpdf, torch.zeros(2), _gens(7, 1)[0], cfg,
                          init_inv_mass=im)
    step = tn.nuts_sample_stepwise(logpdf, torch.zeros((1, 2)), _gens(7, 1),
                                   cfg, steps_per_call=13,
                                   init_inv_mass=im[None])
    np.testing.assert_array_equal(step['samples'][0], mono['samples'].numpy())
    ckpt = str(tmp_path / 'fm.ckpt.npz')
    with pytest.raises(_Stop):
        tn.nuts_sample_stepwise(logpdf, torch.zeros((1, 2)), _gens(7, 1),
                                cfg, steps_per_call=13, checkpoint_path=ckpt,
                                checkpoint_every=20,
                                progress=_interrupter(('sample', 26)),
                                init_inv_mass=im[None])
    with pytest.raises(ValueError, match='fixed_mass'):
        tn.nuts_sample_stepwise(logpdf, torch.zeros((1, 2)), _gens(7, 1),
                                cfg._replace(fixed_mass=False),
                                checkpoint_path=ckpt, resume=True)
    res = tn.nuts_sample_stepwise(logpdf, torch.zeros((1, 2)), _gens(7, 1),
                                  cfg, steps_per_call=13,
                                  checkpoint_path=ckpt, resume=True)
    np.testing.assert_array_equal(res['samples'][0], mono['samples'].numpy())


def test_on_checkpoint_failures_are_reported_not_raised(tmp_path, capsys):
    cfg = tn.NUTSConfig(num_warmup=4, num_samples=4, max_depth=3)
    seen = []

    def hook(phase, i, path):
        seen.append((phase, i, os.path.exists(path)))
        raise OSError('disk full')

    out = tn.nuts_sample_stepwise(_corr_gauss_logpdf, torch.zeros((1, 2)),
                                  _gens(8, 1), cfg,
                                  checkpoint_path=str(tmp_path / 'c.npz'),
                                  checkpoint_every=2, on_checkpoint=hook)
    assert out['samples'].shape == (1, 4, 2)
    assert seen == [('warmup', 2, True), ('warmup', 4, True),
                    ('draw', 2, True), ('draw', 4, True)]
    assert 'nuts on_checkpoint failed: disk full' in capsys.readouterr().out


def test_gibbs_nuts_discrete_marginal():
    cfg = tn.NUTSConfig(num_warmup=50, num_samples=600, max_depth=5,
                        n_step=2)
    out = tn.nuts_sample_stepwise(None, torch.zeros((2, 2)), _gens(0), cfg,
                                  gibbs_n=_gibbs_target, n0=5.0)
    ns = out['n_periods']
    assert ns.shape == (2, 600) and (ns >= 1.0).all()
    assert np.allclose(ns, np.round(ns))
    # the (n >= 1)-truncated Poisson(5): mean 5.034, variance 4.86
    assert abs(ns.mean() - 5.03) < 0.6
    assert 3.3 < ns.var() < 7.0
    assert 0.1 < float(out['n_accept_rate']) < 1.0
    zs = out['samples']
    assert abs(zs.mean()) < 0.15 and abs(zs.var() - 1.0) < 0.25


def test_gibbs_nuts_coupled_moments():
    cfg = tn.NUTSConfig(num_warmup=60, num_samples=600, max_depth=5,
                        n_step=2)
    out = tn.nuts_sample_stepwise(None, torch.zeros((2, 2)), _gens(1), cfg,
                                  gibbs_n=partial(_gibbs_target, slope=0.2),
                                  n0=5.0)
    ns, zs = out['n_periods'], out['samples']
    assert abs(ns.mean() - 5.03) < 0.6
    assert abs(zs[..., 0].mean() - 0.2 * ns.mean()) < 0.25
    assert abs(zs[..., 1].mean()) < 0.2


# ---------------------------------------------------------------------------
# the ridge-aligned reparameterization
# ---------------------------------------------------------------------------

def test_whiten_transform_and_logpdf_match_jax():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((6, 6))
    cov = a @ a.T + 0.1 * np.eye(6)
    cov[5, :] = cov[:, 5] = 0.0
    cov[5, 5] = 1e-13                         # a pinned direction
    center = rng.standard_normal(6)
    want = jn.whiten_transform(cov, center)
    got = tn.whiten_transform(cov, center)
    for w, g in zip(want[2:], got[2:]):       # L and the anchor
        np.testing.assert_array_equal(g, w)
    u = rng.standard_normal((3, 6))
    np.testing.assert_array_equal(got[0](u), want[0](u))
    np.testing.assert_array_equal(got[1](got[0](u)), want[1](want[0](u)))
    jlp, tlp, _ = _gauss5()
    jlp6 = lambda z: jlp(z[:5]) - 0.5 * z[5] ** 2
    tlp6 = lambda z: tlp(z[:5]) - 0.5 * z[5] ** 2
    L, anchor = got[2], got[3]
    uu = rng.standard_normal(6).astype(np.float32)
    for anc in (None, anchor):
        w = float(jn.whiten_logpdf(jlp6, L, center, anchor=anc)(
            jnp.asarray(uu)))
        g = float(tn.whiten_logpdf(tlp6, L, center, anchor=anc)(
            torch.from_numpy(uu)))
        np.testing.assert_allclose(g, w, rtol=1e-5)
    wg = jn.whiten_logpdf(lambda z, n: jlp6(z) - n, L, center, gibbs=True,
                          anchor=anchor)(jnp.asarray(uu), 2.0)
    tg = tn.whiten_logpdf(lambda z, n: tlp6(z) - n, L, center, gibbs=True,
                          anchor=anchor)(torch.from_numpy(uu), 2.0)
    np.testing.assert_allclose(float(tg), float(wg), rtol=1e-5)


def test_stepwise_logpdf_args_match_the_baked_target():
    # logpdf_args ride along every call: the same draws as the target with
    # the values baked in, and a different shift moves the draws
    def shifted(z, mu):
        x = z - mu
        return -0.5 * torch.sum(x * x)

    cfg = tn.NUTSConfig(num_warmup=5, num_samples=8, max_depth=3)
    mus = [torch.tensor([1.5, -0.5]), torch.tensor([-3.0, 2.0])]
    outs = [tn.nuts_sample_stepwise(shifted, torch.zeros((2, 2)), _gens(11),
                                    cfg, logpdf_args=(mu,)) for mu in mus]
    baked = tn.nuts_sample_stepwise(partial(shifted, mu=mus[0]),
                                    torch.zeros((2, 2)), _gens(11), cfg)
    np.testing.assert_array_equal(outs[0]['samples'], baked['samples'])
    assert not np.allclose(outs[0]['samples'], outs[1]['samples'])
    assert np.allclose(outs[1]['samples'].mean(axis=(0, 1)),
                       mus[1].numpy(), atol=2.0)

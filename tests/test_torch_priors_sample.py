"""The port's prior samplers (``sample_prior_model``, ``sample_prior_obs``
in bayes/priors.py) against the distributions of the JAX module's.

JAX's gamma and beta draws come from a rejection sampler that another
package cannot replay, so those are held by support and moments: every one
of 4,000 draws has a finite log prior, and each coordinate's sample mean
and variance lie within 4 standard errors of the analytic ones.  The
truncated normal is an inverse CDF, so it is replayed: JAX's uniforms
through the port's arithmetic give JAX's draws."""

import math

import numpy as np
import pytest
from jax import random
from scipy import integrate, stats

from tests._torch_parity import torch

from parasitoids_tpu.bayes import priors as jp
from parasitoids_tpu_torch.bayes import priors as tp

N = 4000
FIELD_AREAS = np.array([5200.0, 6400.0, 9000.0, 12500.0, 4800.0, 7300.0])
MIN_AREA = float(FIELD_AREAS.min())


def _gamma(a, rate):
    return a / rate, a / rate ** 2


def _beta(a, b):
    return a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))


def _truncnorm(mu, tau, a, b):
    sd = 1.0 / math.sqrt(tau)
    d = stats.truncnorm((a - mu) / sd, (b - mu) / sd, loc=mu, scale=sd)
    return d.mean(), d.var()


# analytic (mean, variance) of each model-block coordinate, in
# MODEL_PARAM_NAMES order (Bayes_Run.py:102-131)
MODEL_MOMENTS = [_gamma(2.2, 1.0), _gamma(5.0, 1.0),
                 _truncnorm(6.0, 0.3, 0.0, 9.0), _gamma(2.0, 1.0),
                 _truncnorm(20.0, 0.3, 15.0, 24.0), _gamma(2.0, 1.0),
                 _gamma(26.0, 0.15), _gamma(15.0, 0.15), _beta(5.0, 5.0),
                 _gamma(2.0, 0.08), _gamma(2.0, 0.14), _beta(5.0, 5.0),
                 _beta(5.0, 1.0), (30.0, 30.0), (1.0, 1.0)]


def _sentinel_moments(area):
    """Mean and variance of a sentinel probability, Beta(alpha(A), 40)
    with A the truncated-normal A_collected, by quadrature over A."""
    sd = math.sqrt(2500.0)
    d = stats.truncnorm(-2500.0 / sd, (MIN_AREA - 2500.0) / sd, loc=2500.0,
                        scale=sd)

    def beta_at(A):
        m = A / area
        return _beta(m * 40.0 / (1.0 - m), 40.0)

    lo, hi = 0.0, MIN_AREA
    e1 = integrate.quad(lambda A: beta_at(A)[0] * d.pdf(A), lo, hi)[0]
    e2 = integrate.quad(lambda A: (beta_at(A)[1] + beta_at(A)[0] ** 2)
                        * d.pdf(A), lo, hi)[0]
    return e1, e2 - e1 ** 2


def _obs_moments(obs_model):
    rows = [_gamma(1.0, 1.0), (0.5, 1 / 12), (0.5, 1 / 12),
            _truncnorm(2500.0, 1.0 / 2500.0, 0.0, MIN_AREA)]
    rows += [_sentinel_moments(a) for a in FIELD_AREAS]
    if obs_model == 'negbin':
        rows.append(_gamma(2.0, 0.1))
    elif obs_model == 'zip':
        rows.append(_beta(1.0, 3.0))
    return rows


def _assert_moments(x, moments):
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    for j, (mean, var) in enumerate(moments):
        col = x[:, j]
        se_mean = math.sqrt(var / n)
        dev2 = (col - col.mean()) ** 2
        se_var = dev2.std() / math.sqrt(n)
        assert abs(col.mean() - mean) <= 4 * se_mean, (j, col.mean(), mean)
        assert abs(col.var() - var) <= 4 * se_var, (j, col.var(), var)


def test_model_draws_have_the_prior_moments_and_support():
    gen = torch.Generator().manual_seed(0)
    x = tp.sample_prior_model(gen, N)
    assert x.shape == (N, 15) and x.dtype == torch.float32
    _assert_moments(x.numpy(), MODEL_MOMENTS)
    lp = [float(tp.log_prior_model(tp.ModelParams(*row))) for row in x]
    assert np.all(np.isfinite(lp))
    assert np.all(x[:, 13].numpy() == np.round(x[:, 13].numpy()))
    # a single draw is a (15,) vector; one generator, one stream
    one = tp.sample_prior_model(torch.Generator().manual_seed(0))
    assert one.shape == (15,)


@pytest.mark.parametrize('obs_model', ['poisson', 'negbin', 'zip'])
def test_obs_draws_have_the_prior_moments_and_support(obs_model):
    gen = torch.Generator().manual_seed(1)
    x = tp.sample_prior_obs(gen, FIELD_AREAS, MIN_AREA, obs_model, N)
    extra = 0 if obs_model == 'poisson' else 1
    assert x.shape == (N, 4 + len(FIELD_AREAS) + extra)
    _assert_moments(x.numpy(), _obs_moments(obs_model))
    areas = torch.as_tensor(FIELD_AREAS, dtype=torch.float32)
    n = len(FIELD_AREAS)
    for row in x[:500]:
        o = tp.ObsParams(row[0], row[1], row[2], row[3], row[4:4 + n],
                         row[4 + n] if extra else 0.0)
        assert np.isfinite(float(tp.log_prior_obs(o, areas, MIN_AREA,
                                                  obs_model)))
    # the JAX sampler's draws lie on the same support
    jx = np.stack([np.asarray(jp.sample_prior_obs(
        k, FIELD_AREAS, MIN_AREA, obs_model))
        for k in random.split(random.PRNGKey(0), 50)])
    assert jx.shape[1] == x.shape[1]
    assert np.all((jx[:, 1:3] > 0) & (jx[:, 1:3] < 1))
    assert np.all((x.numpy()[:, 1:3] > 0) & (x.numpy()[:, 1:3] < 1))


@pytest.mark.parametrize('mu,tau,a,b', [(6.0, 0.3, 0.0, 9.0),
                                        (20.0, 0.3, 15.0, 24.0),
                                        (2500.0, 1.0 / 2500.0, 0.0,
                                         MIN_AREA)])
def test_truncated_normal_replays_jax(mu, tau, a, b):
    # JAX's own uniforms through the port's inverse CDF give JAX's draws
    keys = random.split(random.PRNGKey(3), 200)
    want = np.array([float(jp._sample_truncnorm(k, mu, tau, a, b))
                     for k in keys])
    u = torch.as_tensor(np.array([float(random.uniform(k)) for k in keys],
                                 np.float32)).double()
    got = tp._truncnorm_from_uniform(u, mu, tau, a, b).numpy()
    # f32 erf_inv in JAX: a draw in the tail stands up to 7.5e-6 off
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.all((got >= a) & (got <= b))


def test_samplers_follow_their_generator():
    a = tp.sample_prior_model(torch.Generator().manual_seed(5), 3)
    b = tp.sample_prior_model(torch.Generator().manual_seed(5), 3)
    c = tp.sample_prior_model(torch.Generator().manual_seed(6), 3)
    assert torch.equal(a, b) and not torch.equal(a, c)

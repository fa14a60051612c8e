"""Prior distributions of the Bayesian model, PyTorch port of
``parasitoids_tpu/bayes/priors.py`` (reference Bayes_Run.py:102-196).

Log densities over the *underlying* sampled parameters, as in the
reference (``corr = 2*corr_p - 1``, ``f_b1 = f_b1_p + 1``).  PyMC-2
parameterization: ``Gamma(alpha, beta)`` with rate beta;
``Normal(mu, tau)`` and ``TruncatedNormal(mu, tau, a, b)`` with precision
tau; ``Poisson(mu)`` over the flight duration ``n_periods``.  Every
function takes tensors (0-d per parameter) and returns a 0-d tensor on
their device, differentiable where finite.  The prior samplers
(``sample_prior_model``, ``sample_prior_obs``) draw from an explicit
``torch.Generator``, on its device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.special import gammaln, xlogy

__all__ = ['ModelParams', 'ObsParams', 'log_prior_model', 'log_prior_obs',
           'MODEL_PARAM_NAMES', 'OBS_PARAM_NAMES', 'initial_model_params',
           'initial_obs_params', 'STEP_SCALES', 'sent_obs_prior_alpha',
           'OBS_EXTRA_NAME', 'obs_extra_names', 'sample_prior_model',
           'sample_prior_obs']

# sampled model-parameter order = the reference's AM block
# (Bayes_Run.py:186-187)
MODEL_PARAM_NAMES = ('g_aw', 'g_bw', 'f_a1', 'f_b1_p', 'f_a2', 'f_b2_p',
                     'sig_x', 'sig_y', 'corr_p', 'sig_xl', 'sig_yl',
                     'corr_l_p', 'lam', 'n_periods', 'mu_r')

# observation-model parameters; sent_obs_probs are appended at run time
OBS_PARAM_NAMES = ('xi', 'em_obs_prob', 'grid_obs_prob', 'A_collected')

# AM block starting proposal scales (Bayes_Run.py:188-196)
STEP_SCALES = np.array([0.04, 0.08, 0.25, 0.05, 0.25, 0.05, 2.0, 2.0,
                        0.0005, 2.0, 2.0, 0.0005, 0.0005, 1.0, 0.005])

# initial values (the `value=` kwargs, Bayes_Run.py:102-132)
_INIT_MODEL = np.array([1.0, 3.8, 6.0, 1.5, 20.0, 1.5, 180.0, 150.0, 0.5,
                        10.0, 10.0, 0.5, 0.95, 30.0, 1.0])

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class ModelParams(NamedTuple):
    """The 15-dimensional AM block, in reference order."""
    g_aw: torch.Tensor
    g_bw: torch.Tensor
    f_a1: torch.Tensor
    f_b1_p: torch.Tensor
    f_a2: torch.Tensor
    f_b2_p: torch.Tensor
    sig_x: torch.Tensor
    sig_y: torch.Tensor
    corr_p: torch.Tensor
    sig_xl: torch.Tensor
    sig_yl: torch.Tensor
    corr_l_p: torch.Tensor
    lam: torch.Tensor
    n_periods: torch.Tensor
    mu_r: torch.Tensor

    @property
    def corr(self):
        return 2.0 * self.corr_p - 1.0

    @property
    def corr_l(self):
        return 2.0 * self.corr_l_p - 1.0

    @property
    def f_b1(self):
        return self.f_b1_p + 1.0

    @property
    def f_b2(self):
        return self.f_b2_p + 1.0

    def hparams(self):
        return (self.lam, self.g_aw, self.g_bw, self.f_a1, self.f_b1,
                self.f_a2, self.f_b2)

    def Dparams(self):
        return (self.sig_x, self.sig_y, self.corr)

    def Dlparams(self):
        return (self.sig_xl, self.sig_yl, self.corr_l)


class ObsParams(NamedTuple):
    xi: torch.Tensor
    em_obs_prob: torch.Tensor
    grid_obs_prob: torch.Tensor
    A_collected: torch.Tensor
    sent_obs_probs: torch.Tensor   # (n_sentinel_fields,)
    # the observation-model variant's extra parameter: the negative-binomial
    # dispersion r (obs_model='negbin') or the zero-inflation probability pi
    # (obs_model='zip'); 0.0 = unused (plain Poisson)
    od: torch.Tensor = 0.0


# observation-model variants: name of the extra parameter
OBS_EXTRA_NAME = {'poisson': None, 'negbin': 'nb_r', 'zip': 'zip_pi'}


def obs_extra_names(obs_model='poisson'):
    """Names of extra obs-parameter slots for the given variant (appended
    AFTER the sentinel probabilities in every packed obs vector)."""
    n = OBS_EXTRA_NAME[obs_model]
    return (n,) if n else ()


def initial_model_params():
    return _INIT_MODEL.copy()


def initial_obs_params(field_sizes_cells, cell_area, obs_model='poisson'):
    """Initial obs-parameter vector (Bayes_Run.py:132-164): sentinel
    observation probabilities start at 0.1*3600/field_area; variant
    extras start mildly non-Poisson (negbin r=10, zip pi=0.1)."""
    sent0 = 0.1 * 3600.0 / (np.asarray(field_sizes_cells) * cell_area)
    parts = [[0.75, 0.05, 0.005, 2500.0], sent0]
    if obs_model == 'negbin':
        parts.append([10.0])
    elif obs_model == 'zip':
        parts.append([0.1])
    return np.concatenate(parts)


# ----------------------------------------------------------------------
# log densities (the JAX module's formulas, term for term)
# ----------------------------------------------------------------------

def _neg_inf(x):
    return torch.full_like(x, -math.inf)


# A distribution's parameters are Python numbers, and the terms that hold
# only them are worked out on the host: a number copied to the card would
# make the prior wait for it.  The one tensor parameter is the sentinel
# fields' Beta alpha.

def _lgamma(v):
    return gammaln(v) if torch.is_tensor(v) else math.lgamma(v)


def _ndtr(v):
    return 0.5 * math.erfc(-v / math.sqrt(2.0))


def _beta_logpdf(x, a, b):
    inside = (x > 0) & (x < 1)
    xs = torch.clamp(x, 1e-12, 1 - 1e-12)
    lp = (xlogy(a - 1, xs) + xlogy(b - 1, 1 - xs)
          + (_lgamma(a + b) - _lgamma(a) - _lgamma(b)))
    return torch.where(inside, lp, _neg_inf(lp))


def _gamma_logpdf(x, alpha, beta):
    """PyMC-2 Gamma(alpha, beta) with beta = rate."""
    lp = (xlogy(alpha - 1, x) - beta * x
          + (alpha * math.log(beta) - math.lgamma(alpha)))
    return torch.where(x > 0, lp, _neg_inf(lp))


def _norm_logpdf(x, mu, sd):
    """jax.scipy.stats.norm.logpdf."""
    return -((x - mu) / sd) ** 2 / 2 - _LOG_SQRT_2PI - math.log(sd)


def _truncnorm_logpdf(x, mu, tau, a, b):
    """PyMC-2 TruncatedNormal(mu, tau, a, b); tau is precision."""
    sd = 1.0 / math.sqrt(tau)
    z = _norm_logpdf(x, mu, sd)
    norm_const = math.log(_ndtr((b - mu) / sd) - _ndtr((a - mu) / sd))
    return torch.where((x >= a) & (x <= b), z - norm_const, _neg_inf(z))


def _normal_logpdf(x, mu, tau):
    return _norm_logpdf(x, mu, 1.0 / math.sqrt(tau))


def _poisson_logpmf(k, mu):
    lp = xlogy(k, mu) - mu - gammaln(k + 1.0)
    return torch.where(k >= 0, lp, _neg_inf(lp))


def log_prior_model(p: ModelParams):
    """Joint log prior over the AM block (Bayes_Run.py:102-131)."""
    lp = _beta_logpdf(p.lam, 5.0, 1.0)
    lp = lp + _truncnorm_logpdf(p.f_a1, 6.0, 0.3, 0.0, 9.0)
    lp = lp + _truncnorm_logpdf(p.f_a2, 20.0, 0.3, 15.0, 24.0)
    lp = lp + _gamma_logpdf(p.f_b1_p, 2.0, 1.0)
    lp = lp + _gamma_logpdf(p.f_b2_p, 2.0, 1.0)
    lp = lp + _gamma_logpdf(p.g_aw, 2.2, 1.0)
    lp = lp + _gamma_logpdf(p.g_bw, 5.0, 1.0)
    lp = lp + _gamma_logpdf(p.sig_x, 26.0, 0.15)
    lp = lp + _gamma_logpdf(p.sig_y, 15.0, 0.15)
    lp = lp + _beta_logpdf(p.corr_p, 5.0, 5.0)
    lp = lp + _gamma_logpdf(p.sig_xl, 2.0, 0.08)
    lp = lp + _gamma_logpdf(p.sig_yl, 2.0, 0.14)
    lp = lp + _beta_logpdf(p.corr_l_p, 5.0, 5.0)
    lp = lp + _normal_logpdf(p.mu_r, 1.0, 1.0)
    lp = lp + _poisson_logpmf(p.n_periods, 30.0)
    return lp


def sent_obs_prior_alpha(A_collected, field_areas, sent_beta=40.0):
    """Per-field Beta alpha for sentinel observation probabilities: the Beta
    mean is A_collected/field_area with fixed beta=40
    (Bayes_Run.py:155-166)."""
    mean = A_collected / field_areas
    return mean * sent_beta / (1.0 - mean)


# ----------------------------------------------------------------------
# prior samplers: the exact distributions whose log densities the
# ``log_prior_*`` functions evaluate (the reference never samples its
# priors; the multi-start MAP and the later SMC and predictive modules
# do).  Each takes the generator it draws from and a number of draws
# ``n``; the draws are computed in f64 on the generator's device and
# returned in f32, one row per draw.
# ----------------------------------------------------------------------

def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, dtype=torch.float64,
                      device=gen.device)


def _sample_gamma(gen, alpha, rate, shape):
    """PyMC-2 Gamma(alpha, beta=rate) by Marsaglia and Tsang's rejection
    sampler (alpha < 1 through the boost U^(1/alpha) of a Gamma(alpha + 1)
    draw).  ``alpha`` is a number or a tensor broadcast to ``shape``.  The
    rounds of proposals repeat until every draw is accepted, a host decision
    per round (about 5% of proposals are rejected)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float64).to(gen.device)
    alpha = alpha.expand(shape)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=torch.float64, device=gen.device)
    todo = torch.ones(shape, dtype=torch.bool, device=gen.device)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, dtype=torch.float64,
                        device=gen.device)
        v = (1.0 + c * x) ** 3
        log_u = torch.log(_uniform(gen, shape))
        ok = (v > 0) & (log_u < 0.5 * x * x + d - d * v +
                        d * torch.log(torch.clamp(v, min=1e-300)))
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
    u = _uniform(gen, shape)
    out = torch.where(boost, out * u ** (1.0 / alpha), out)
    return out / rate


def _sample_beta(gen, a, b, shape):
    x = _sample_gamma(gen, a, 1.0, shape)
    return x / (x + _sample_gamma(gen, b, 1.0, shape))


def _truncnorm_from_uniform(u, mu, tau, a, b):
    """PyMC-2 TruncatedNormal(mu, tau=precision, a, b) from standard
    uniforms ``u`` by the inverse CDF, the arithmetic of JAX's
    ``random.truncated_normal`` (erf of both standardized bounds, a uniform
    between them, ``sqrt(2) erfinv``, clipped inside the bounds)."""
    sd = 1.0 / math.sqrt(tau)
    lo = (a - mu) / sd
    hi = (b - mu) / sd
    ea, eb = math.erf(lo / math.sqrt(2.0)), math.erf(hi / math.sqrt(2.0))
    v = torch.clamp(u * (eb - ea) + ea, min=ea)
    x = math.sqrt(2.0) * torch.erfinv(v)
    x = torch.clamp(x, np.nextafter(lo, np.inf), np.nextafter(hi, -np.inf))
    return mu + sd * x


def _sample_truncnorm(gen, mu, tau, a, b, shape):
    return _truncnorm_from_uniform(_uniform(gen, shape), mu, tau, a, b)


def _draws(gen, n, fn):
    """``fn(shape)`` for ``n`` draws: ``(n, k)`` rows, or ``(k,)`` for
    ``n=None``."""
    out = fn((1,) if n is None else (n,)).to(torch.float32)
    return out[0] if n is None else out


def sample_prior_model(gen, n=None):
    """``n`` draws of the 15-dim model block from the joint prior (the
    distributions of Bayes_Run.py:102-131, in MODEL_PARAM_NAMES order).
    ``log_prior_model`` is finite at every draw."""
    def fn(shape):
        g = lambda alpha, rate: _sample_gamma(gen, alpha, rate, shape)
        t = lambda mu, tau, a, b: _sample_truncnorm(gen, mu, tau, a, b, shape)
        cols = [g(2.2, 1.0), g(5.0, 1.0), t(6.0, 0.3, 0.0, 9.0), g(2.0, 1.0),
                t(20.0, 0.3, 15.0, 24.0), g(2.0, 1.0), g(26.0, 0.15),
                g(15.0, 0.15), _sample_beta(gen, 5.0, 5.0, shape),
                g(2.0, 0.08), g(2.0, 0.14),
                _sample_beta(gen, 5.0, 5.0, shape),
                _sample_beta(gen, 5.0, 1.0, shape),
                torch.poisson(torch.full(shape, 30.0, dtype=torch.float64,
                                         device=gen.device), generator=gen),
                1.0 + torch.randn(shape, generator=gen, dtype=torch.float64,
                                  device=gen.device)]
        return torch.stack(cols, dim=-1)
    return _draws(gen, n, fn)


def sample_prior_obs(gen, field_areas, min_field_area, obs_model='poisson',
                     n=None):
    """``n`` draws of the observation-parameter vector from its joint prior
    (Bayes_Run.py:132-166), including the hierarchical sentinel
    observation probabilities Beta(alpha(A_collected), 40) and, for
    observation-model variants, the extra slot (see ``OBS_EXTRA_NAME``)."""
    areas = torch.as_tensor(np.asarray(field_areas, np.float64)).to(
        gen.device)

    def fn(shape):
        xi = _sample_gamma(gen, 1.0, 1.0, shape)
        em, gr = _uniform(gen, shape), _uniform(gen, shape)
        a_coll = _sample_truncnorm(gen, 2500.0, 1.0 / 2500.0, 0.0,
                                   float(min_field_area), shape)
        alpha = sent_obs_prior_alpha(a_coll[..., None], areas)
        sent = _sample_beta(gen, alpha, 40.0, alpha.shape)
        parts = [torch.stack([xi, em, gr, a_coll], dim=-1), sent]
        if obs_model == 'negbin':
            parts.append(_sample_gamma(gen, 2.0, 0.1, shape)[..., None])
        elif obs_model == 'zip':
            parts.append(_sample_beta(gen, 1.0, 3.0, shape)[..., None])
        return torch.cat(parts, dim=-1)
    return _draws(gen, n, fn)


def log_prior_obs(o: ObsParams, field_areas, min_field_area,
                  obs_model='poisson'):
    """Joint log prior over observation parameters (Bayes_Run.py:132-166).

    ``field_areas``: sentinel field areas in m² (a tensor);
    ``min_field_area``: truncation upper bound for A_collected.
    ``obs_model``: adds the variant extra-parameter prior (negbin
    r ~ Gamma(2, 0.1); zip pi ~ Beta(1, 3)) over ``o.od``.  Parameters
    with a leading particle axis (``(N,)``, the sentinel probabilities
    ``(N, n_sent)``) give ``(N,)`` densities, as ``log_prior_model``
    does elementwise.
    """
    lp = _gamma_logpdf(o.xi, 1.0, 1.0)
    lp = lp + _beta_logpdf(o.em_obs_prob, 1.0, 1.0)
    lp = lp + _beta_logpdf(o.grid_obs_prob, 1.0, 1.0)
    lp = lp + _truncnorm_logpdf(o.A_collected, 2500.0, 1.0 / 2500.0, 0.0,
                                min_field_area)
    alpha = sent_obs_prior_alpha(o.A_collected[..., None], field_areas)
    # hierarchical: invalid whenever A_collected >= a field's area
    valid = torch.all(alpha > 0, dim=-1)
    sent = torch.sum(_beta_logpdf(o.sent_obs_probs, alpha, 40.0), dim=-1)
    lp = lp + torch.where(valid, sent, _neg_inf(sent))
    if obs_model == 'negbin':
        lp = lp + _gamma_logpdf(o.od, 2.0, 0.1)
    elif obs_model == 'zip':
        lp = lp + _beta_logpdf(o.od, 1.0, 3.0)
    return lp

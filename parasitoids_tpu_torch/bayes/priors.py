"""Prior distributions of the Bayesian model, PyTorch port of
``parasitoids_tpu/bayes/priors.py`` (reference Bayes_Run.py:102-196).

Log densities over the *underlying* sampled parameters, as in the
reference (``corr = 2*corr_p - 1``, ``f_b1 = f_b1_p + 1``).  PyMC-2
parameterization: ``Gamma(alpha, beta)`` with rate beta;
``Normal(mu, tau)`` and ``TruncatedNormal(mu, tau, a, b)`` with precision
tau; ``Poisson(mu)`` over the flight duration ``n_periods``.  Every
function takes tensors (0-d per parameter) and returns a 0-d tensor on
their device, differentiable where finite.  The prior samplers
(``sample_prior_*``) are not ported yet.
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
           'OBS_EXTRA_NAME', 'obs_extra_names']

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


def log_prior_obs(o: ObsParams, field_areas, min_field_area,
                  obs_model='poisson'):
    """Joint log prior over observation parameters (Bayes_Run.py:132-166).

    ``field_areas``: sentinel field areas in m² (a tensor);
    ``min_field_area``: truncation upper bound for A_collected.
    ``obs_model``: adds the variant extra-parameter prior (negbin
    r ~ Gamma(2, 0.1); zip pi ~ Beta(1, 3)) over ``o.od``.
    """
    lp = _gamma_logpdf(o.xi, 1.0, 1.0)
    lp = lp + _beta_logpdf(o.em_obs_prob, 1.0, 1.0)
    lp = lp + _beta_logpdf(o.grid_obs_prob, 1.0, 1.0)
    lp = lp + _truncnorm_logpdf(o.A_collected, 2500.0, 1.0 / 2500.0, 0.0,
                                min_field_area)
    alpha = sent_obs_prior_alpha(o.A_collected, field_areas)
    # hierarchical: invalid whenever A_collected >= a field's area
    valid = torch.all(alpha > 0)
    sent = torch.sum(_beta_logpdf(o.sent_obs_probs, alpha, 40.0))
    lp = lp + torch.where(valid, sent, _neg_inf(sent))
    if obs_model == 'negbin':
        lp = lp + _gamma_logpdf(o.od, 2.0, 0.1)
    elif obs_model == 'zip':
        lp = lp + _beta_logpdf(o.od, 1.0, 3.0)
    return lp

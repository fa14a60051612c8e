"""Plain reference of the MAP fit as ``map_fit --MAP`` runs it on the
Kalbar target: the pre-spread day, the MAP objective over the
unconstrained vector, and Adam's update, in plain torch.

**The pre-spread day** (``sprd_factor``, the upstream ``Bayes_Run.py``
lines 241-267 and ``Bayes_MAP.py`` 200-205).  Before the first wind day
the released population is split: the share ``sprd`` drifts by the fixed
mean displacement (-25, 15) m and spreads with the flight covariance,
the rest spreads with the local covariance about the release cell.  The
drift is split into whole cells and a sub-cell remainder; the flight
block is the bivariate-normal mass of each cell of a (2K+1)² window
about the remainder, weighted by ``sprd`` and placed at the whole-cell
offset (rows by -y, columns by +x); the local block, of a (2Kl+1)²
window about the release cell, is weighted by 1 - ``sprd``; whatever
mass the two windows leave out is put on the release cell.  The day is
prepended to the wind days' kernels, propagated with them, and dropped
from the fields.  Departures from the upstream code, which the program
shares: the blocks are cut at the configuration's windows K and Kl, where
the upstream kernel grows its window to its support, and the mass they
cut off goes to the release cell; the blocks take the Genz node rule of
their own |rho| (``reference/model.genz_branch``), as the wind days do.

**The MAP objective** at ``z``: the negative log posterior at the
constrained point (no Jacobian: the MAP fit optimizes the posterior
density of the constrained parameters), ``n_periods`` pinned at 30
(``Bayes_MAP.py`` 144-147), the model and observation blocks through the
bijections of ``reference/model.py``'s NUTS target and ``sprd`` through
the logistic, its Uniform(0, 1) prior adding 0 inside the support.

**Adam** (Kingma & Ba 2015, Algorithm 1): beta1 0.9, beta2 0.999, eps
1e-8, both moments bias-corrected.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference.model import (MODEL_MAPS, N_MODEL,
                                         N_PERIODS_FIXED, _inv, as_model,
                                         cell_masses, genz_branch,
                                         log_prior_model)

DRIFT = (-25.0, 15.0)          # the pre-spread day's mean displacement, m
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _sigmoid(z):
    return 1.0 / (1.0 + torch.exp(-z))


def pre_spread(fwd, m, sprd):
    """The pre-spread day's (D, D) pmf at the model block ``m`` (a dict of
    0-d tensors) and the factor ``sprd``."""
    cfg = fwd.cfg
    K, Kl, c, D, cell = (cfg['K'], cfg['K_local'], cfg['rad_res'], fwd.D,
                         fwd.cell)
    drift = np.asarray(DRIFT)
    whole = np.floor(drift / cell).astype(int)
    rem = torch.as_tensor(drift - whole * cell, dtype=fwd.dtype,
                          device=fwd.device)
    rho, rho_l = 2.0 * m['corr_p'] - 1.0, 2.0 * m['corr_l_p'] - 1.0
    flight = cell_masses(rem, m['sig_x'], m['sig_y'], rho, cell, K,
                         genz_branch(abs(float(rho.detach()))))
    local = cell_masses(torch.zeros(2, dtype=fwd.dtype, device=fwd.device),
                        m['sig_xl'], m['sig_yl'], rho_l, cell, Kl,
                        genz_branch(abs(float(rho_l.detach()))))

    def place(block, row, col):
        n = block.shape[-1]
        row, col = min(max(row, 0), D - n), min(max(col, 0), D - n)
        return F.pad(block, (col, D - col - n, row, D - row - n))
    field = place(sprd * flight, c - int(whole[1]) - K,
                  c + int(whole[0]) - K)
    field = field + place((1.0 - sprd) * local, c - Kl, c - Kl)
    rest = torch.clamp(1.0 - field.sum(), min=0.0)
    return field + F.pad(rest.reshape(1, 1), (c, D - c - 1, c, D - c - 1))


def fields(fwd, m, sprd, grad=False):
    """Expected populations of the wind days, (ndays, D, D), after the
    pre-spread day."""
    kernels = fwd.kernels(m, grad)
    return fwd.propagate(torch.cat([pre_spread(fwd, m, sprd)[None],
                                    kernels]))[1:]


def constrain(post, z):
    """``(model block (15,), observation block, sprd)`` of the
    unconstrained ``z`` (model slots, observation slots, the factor)."""
    n_obs = z.shape[0] - N_MODEL - 1
    obs_maps = ['pos', 'unit', 'unit', (0.0, post.min_area)] + \
        ['unit'] * (n_obs - 4)
    m = [torch.full_like(z[i], N_PERIODS_FIXED) if kind is None
         else _inv(kind, z[i])[0] for i, kind in enumerate(MODEL_MAPS)]
    o = [_inv(kind, z[N_MODEL + j])[0] for j, kind in enumerate(obs_maps)]
    return torch.stack(m), torch.stack(o), _sigmoid(z[-1])


def terms(post, z, grad=False):
    """``(log prior, log-pmfs, resolved)`` of the MAP target at ``z``: the
    log prior of the constrained point, and ``Posterior.log_pmfs``'s
    per-observation log-pmfs with the pre-spread day and its mask of the
    observations it resolves (False at a positive count over an expected
    count under ``RESOLVED`` of its block's largest, which any float32
    path reads as roundoff); the last two None outside the prior's
    support, where no forward runs.  ``grad``: each wind day recomputed
    in the backward (``Forward.kernels``)."""
    m_vec, o_vec, sprd = constrain(post, z)
    m = as_model(m_vec)
    prior = log_prior_model(m) + post.log_prior_obs(o_vec)
    if not math.isfinite(float(prior.detach())):
        return prior, None, None
    proj = post.projections(fields(post.fwd, m, sprd, grad))
    pts, keep = post.log_pmfs(proj, o_vec)
    return prior, pts, keep


def objective(post, z, grad=False):
    """The MAP objective at ``z``: minus the log posterior of the
    constrained point with the pre-spread day (+inf outside the prior's
    support)."""
    prior, pts, _ = terms(post, z, grad)
    return -prior if pts is None else -(prior + pts.sum())


def adam_update(z, g, m, v, t, lr):
    """Step ``t`` (from 1) of Adam from ``z`` with the gradient ``g`` and
    the moments ``m``, ``v`` that ``t - 1`` steps left: ``(z', m', v')``."""
    m = BETA1 * m + (1.0 - BETA1) * g
    v = BETA2 * v + (1.0 - BETA2) * g * g
    m_hat = m / (1.0 - BETA1 ** t)
    v_hat = v / (1.0 - BETA2 ** t)
    return z - lr * m_hat / (torch.sqrt(v_hat) + EPS), m, v

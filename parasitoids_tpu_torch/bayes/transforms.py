"""Constrained <-> unconstrained parameter bijections for gradient-based
optimization, PyTorch port of ``parasitoids_tpu/bayes/transforms.py``.

``log`` for positive parameters, ``logit`` for (0, 1), scaled logit for
bounded intervals, identity for unbounded.  MAP maximizes the
constrained-space posterior (no Jacobian term), matching PyMC's MAP.
"""

from __future__ import annotations

import torch

__all__ = ['Interval', 'Positive', 'Unbounded', 'Unit', 'MODEL_TRANSFORMS',
           'obs_transforms', 'pack', 'unpack']


class Unbounded:
    def fwd(self, theta):   # constrained -> unconstrained
        return theta

    def inv(self, z):
        return z


class Positive:
    def fwd(self, theta):
        return torch.log(theta)

    def inv(self, z):
        return torch.exp(z)


class Unit:
    def fwd(self, theta):
        return torch.log(theta) - torch.log1p(-theta)

    def inv(self, z):
        return 1.0 / (1.0 + torch.exp(-z))


class Interval:
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def fwd(self, theta):
        u = (theta - self.lo) / (self.hi - self.lo)
        return torch.log(u) - torch.log1p(-u)

    def inv(self, z):
        u = 1.0 / (1.0 + torch.exp(-z))
        return self.lo + (self.hi - self.lo) * u


# transforms for the 15-dim model block (order = MODEL_PARAM_NAMES)
MODEL_TRANSFORMS = (
    Positive(),            # g_aw
    Positive(),            # g_bw
    Interval(0.0, 9.0),    # f_a1
    Positive(),            # f_b1_p
    Interval(15.0, 24.0),  # f_a2
    Positive(),            # f_b2_p
    Positive(),            # sig_x
    Positive(),            # sig_y
    Unit(),                # corr_p
    Positive(),            # sig_xl
    Positive(),            # sig_yl
    Unit(),                # corr_l_p
    Unit(),                # lam
    Unbounded(),           # n_periods (fixed during MAP)
    Unbounded(),           # mu_r
)


def obs_transforms(n_sent, max_area, obs_model='poisson'):
    """Transforms for (xi, em_obs_prob, grid_obs_prob, A_collected,
    sent_obs_probs..., [obs-model extra: negbin r > 0 / zip pi in (0,1)])."""
    base = (Positive(), Unit(), Unit(), Interval(0.0, max_area)) + \
        tuple(Unit() for _ in range(n_sent))
    if obs_model == 'negbin':
        return base + (Positive(),)
    if obs_model == 'zip':
        return base + (Unit(),)
    return base


def pack(theta, transforms):
    return torch.stack([t.fwd(theta[i]) for i, t in enumerate(transforms)])


def unpack(z, transforms):
    return torch.stack([t.inv(z[i]) for i, t in enumerate(transforms)])

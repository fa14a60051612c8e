"""Take-off probability functions, PyTorch port of
``parasitoids_tpu/ops/flight.py`` (reference ParasitoidModel.py:231-309).

Scalars may be Python numbers or 0-d tensors; arrays follow the dtype and
device of the wind trace they are applied to.  Parameters given as
``(N, 1)`` tensors (one value per particle) give ``(N, n)`` results: every
reduction runs over the last axis.
"""

from __future__ import annotations

import torch

__all__ = ['g_wind_prob', 'f_time_prob', 'h_flight_prob', 'dmat']


def g_wind_prob(windr, aw, bw):
    """Probability of take-off given wind speed: decreasing logistic,
    computed as a stable sigmoid (the naive ``1/(1+exp(u))`` has an inf/inf
    NaN gradient once ``exp`` overflows)."""
    return torch.sigmoid(-bw * (windr - aw))


def f_time_prob(n, a1, b1, a2, b2, device=None, dtype=torch.float32):
    """Take-off pmf over ``n`` equally spaced times of day: normalized
    positive part of a difference of two stable sigmoids.  When the
    positive part underflows to zero everywhere the pmf is all zero, with a
    zero gradient (a ``where``, not a ``1/tiny`` floor)."""
    t_tild = torch.linspace(0.0, 24.0 - 24.0 / n, n, device=device,
                            dtype=dtype)
    likelihood = torch.clamp(
        torch.sigmoid(b1 * (t_tild - a1)) - torch.sigmoid(b2 * (t_tild - a2)),
        min=0.0)
    total = likelihood.sum(-1, keepdim=True)
    eps = 1e-6
    return torch.where(total > eps,
                       likelihood / torch.clamp(total, min=eps),
                       torch.zeros_like(likelihood))


def h_flight_prob(day_windr, lam, aw, bw, a1, b1, a2, b2):
    """Per-period take-off probability for one day's wind trace:
    ``h = λ (f·g + integral_avg)``, where ``integral_avg`` moves probability
    from wind-blocked periods to later feasible ones (ParasitoidModel.py
    :305-307, ``alpha_pow = 1``)."""
    n = day_windr.shape[0]
    f_func = f_time_prob(n, a1, b1, a2, b2, device=day_windr.device,
                         dtype=day_windr.dtype)
    g_func = g_wind_prob(day_windr, aw, bw)
    t_vec = torch.linspace(1.0, n, n, device=day_windr.device,
                           dtype=day_windr.dtype)
    integral_avg = (f_func * g_func / t_vec /
                    torch.clamp(f_func.amax(-1, keepdim=True), min=1e-12) *
                    torch.cumsum((1.0 - torch.cumsum(f_func, -1)) *
                                 (f_func - f_func * g_func), -1))
    return lam * (f_func * g_func + integral_avg)


def dmat(sig_x, sig_y, rho):
    """Diffusion covariance matrix from (σx, σy, ρ) (ref ``Dmat``)."""
    sig_x, sig_y, rho = (torch.as_tensor(v) for v in (sig_x, sig_y, rho))
    cov = rho * sig_x * sig_y
    return torch.stack([torch.stack([sig_x ** 2, cov]),
                        torch.stack([cov, sig_y ** 2])])

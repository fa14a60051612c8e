"""Runtime numerical sanitizers (SURVEY.md section 5).

The reference carries pmf positivity/normalization assertions with full
parameter dumps attached to the exception (ParasitoidModel.py:528-537,
568-580,588-599) and a one-time RuntimeWarning when wasps advect off the
domain (ParasitoidModel.py:547-558).  Device code can't raise, so the
checks run host-side on simulation outputs: drivers call
:func:`validate_fields` after each run (always cheap — a few reductions),
and :func:`warn_on_loss` reproduces the lost-wasp warning from the kernel
builder's loss accounting.
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ['NumericalCheckError', 'validate_fields', 'warn_on_loss']


class NumericalCheckError(AssertionError):
    """Numerical invariant violated; carries the parameter dump."""


def _dump(params):
    keys = ('site_name', 'dataset', 'domain_info', 'interp_num', 'ndays',
            'n_periods', 'mu_r', 'g_params', 'f_params', 'Dparams',
            'Dlparams', 'lam', 'r_dur', 'r_number', 'r_start',
            'kernel_rad', 'kernel_rad_local', 'quad_nodes')
    return '\n'.join('    {} = {}'.format(k, getattr(params, k, None))
                     for k in keys)


def validate_fields(fields, params, prob_model, atol=1e-4):
    """Invariants on per-day output fields (host-side).

    * no NaN/Inf anywhere,
    * non-negative up to f32 roundoff,
    * probability model: every day sums to 1 within ``atol``
      (ParasitoidModel.py:568-580 asserts the same before sparsifying),
    * population model: day sums never exceed the release total and never
      increase day-over-day (mass only leaves via the absorbing boundary).
    """
    f = np.asarray(fields)
    ctx = '\n  parameters:\n' + _dump(params)
    if not np.isfinite(f).all():
        bad = np.argwhere(~np.isfinite(f))[:5]
        raise NumericalCheckError(
            'non-finite field values at (day,row,col) {}{}'.format(
                bad.tolist(), ctx))
    if f.min() < -1e-6:
        d, r, c = np.unravel_index(f.argmin(), f.shape)
        raise NumericalCheckError(
            'negative density {:.3e} at day {} cell ({},{}){}'.format(
                f.min(), d, r, c, ctx))
    sums = f.sum(axis=(1, 2))
    if prob_model:
        if not np.allclose(sums, 1.0, atol=atol):
            raise NumericalCheckError(
                'daily pmf sums deviate from 1: {}{}'.format(
                    np.round(sums, 6).tolist(), ctx))
    else:
        r_number = float(params.r_number)
        if (sums > r_number * (1 + 1e-3)).any():
            raise NumericalCheckError(
                'population exceeds release total {}: {}{}'.format(
                    r_number, np.round(sums, 2).tolist(), ctx))
        if (sums[1:] > sums[:-1] * (1 + 1e-4)).any():
            raise NumericalCheckError(
                'population increased day-over-day: {}{}'.format(
                    np.round(sums, 2).tolist(), ctx))
    return sums


def warn_on_loss(losses, days, threshold=1e-6):
    """One-time warning when take-off mass was advected beyond the domain
    (the reference's lost-wasp RuntimeWarning, ParasitoidModel.py:547-558)."""
    losses = np.asarray(losses)
    lost_days = [(d, float(l)) for d, l in zip(days, losses)
                 if l > threshold]
    if lost_days:
        worst = max(lost_days, key=lambda t: t[1])
        warnings.warn(
            'wasps advected beyond the domain boundary on {} day(s); worst: '
            'day {} lost {:.3g} of take-off probability. Consider a larger '
            'domain_info radius.'.format(len(lost_days), *worst),
            RuntimeWarning, stacklevel=2)
    return lost_days

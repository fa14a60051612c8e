"""End-to-end forward simulation, PyTorch port of
``parasitoids_tpu/models/forward.py`` (reference Run.main, Run.py:388-487):
wind -> per-day dispersal kernels -> FFT-chained daily fields.

Kernel construction is a Python loop over days (the JAX package's
``lax.scan``); each day's minutes go through the CUDA day kernel on the
card, or the plain accumulate on the CPU, and what the days share (the
kernel's packed constants, the local-diffusion block) is made once before
the loop.  The loop reads nothing back from the card: :func:`simulate`
waits once per phase, for its timings.  The Bayes layer replays the loop
as a captured CUDA graph (``utils/graphs.py``); :func:`simulate` runs it
eagerly.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import Params
from ..device import pick_device, pick_dtype, pin_full_f32
from ..io import get_wind_data, pack_wind
from ..ops.daily_kernel import (KernelConfig, build_daily_kernel,
                                build_daily_kernel_batched, day_invariants)
from ..utils import trace
from ..utils.checks import warn_on_loss
from .solver import SolverConfig, propagate_pop, propagate_prob

__all__ = ['ForwardSetup', 'setup_forward', 'setup_from_numpy',
           'build_all_kernels', 'build_all_kernels_batched', 'forward_fields',
           'simulate', 'prior_coverage_windows', 'wind_prefix_sum']

# Prior-coverage window radii of the Bayes likelihood (m), copied from
# parasitoids_tpu/bayes/model.py:53-62 (that package loads JAX): >= 3.3 sigma
# at the 0.9999 prior quantile of the flight and local diffusion.
_FLIGHT_COVER_M = 1090.0
_LOCAL_COVER_M = 490.0
_DEFAULT_QUAD_NODES = Params().quad_nodes


def prior_coverage_windows(cell_m):
    """(kernel_rad, kernel_rad_local) in cells for a cell size: the static
    window half-widths the Bayes likelihood and its benchmark use."""
    return (int(np.ceil(_FLIGHT_COVER_M / cell_m)),
            int(np.ceil(_LOCAL_COVER_M / cell_m)))


class ForwardSetup(NamedTuple):
    """Host-side preparation of a simulation: packed wind on the device plus
    static configs."""
    wind_flat: torch.Tensor    # (ndays*T, 2)
    wind_cumsum: torch.Tensor  # (ndays*T + 1, 2)
    days: tuple                # day labels from the wind file
    ndays: int
    kcfg: KernelConfig
    scfg: SolverConfig
    rad_dist: float
    start_idx: int             # release start minute on day 0 (pop model)
    dist_weights: np.ndarray   # (r_dur,) release emergence distribution


def wind_prefix_sum(flat: np.ndarray) -> np.ndarray:
    """``(N + 1, 2)`` prefix sum of the packed wind, with a leading zero row:
    summed in f64 and rounded once to ``flat``'s dtype."""
    cs = np.cumsum(flat, axis=0, dtype=np.float64)
    return np.concatenate([np.zeros((1,) + flat.shape[1:]), cs]).astype(
        flat.dtype)


def _resolve_pallas(use_pallas, device, dtype):
    """The accumulate path: None -> the CUDA kernel on CUDA, the plain one on
    the CPU; f64 always the plain one; True on a CPU device raises."""
    if dtype == torch.float64:
        return False
    if use_pallas is None:
        return device.type == 'cuda'
    if use_pallas and device.type != 'cuda':
        raise ValueError('use_pallas=True needs a CUDA device: the CUDA day '
                         'kernel has no CPU or interpret mode')
    return bool(use_pallas)


def setup_from_numpy(wind_flat, wind_cumsum, days, ndays, kcfg, scfg,
                     rad_dist, start_idx, dist_weights, device, dtype,
                     use_pallas=None):
    """A :class:`ForwardSetup` from the numpy arrays of a setup (for example
    a JAX ``ForwardSetup``, so that both packages see the same bits).
    ``kcfg``/``scfg`` may be either package's configs; the accumulate path
    is chosen from ``use_pallas``, ``device`` and ``dtype``."""
    device = torch.device(device)
    pin_full_f32()
    kcfg = KernelConfig(
        rad_res=int(kcfg.rad_res), periods=int(kcfg.periods), K=int(kcfg.K),
        K_local=int(kcfg.K_local), chunk=int(kcfg.chunk),
        pallas=_resolve_pallas(use_pallas, device, dtype),
        ref_trunc=bool(getattr(kcfg, 'ref_trunc', False)),
        batched_bvn=bool(getattr(kcfg, 'batched_bvn', False)))
    return ForwardSetup(
        torch.tensor(np.asarray(wind_flat), dtype=dtype, device=device),
        torch.tensor(np.asarray(wind_cumsum), dtype=dtype, device=device),
        tuple(days), int(ndays), kcfg,
        SolverConfig(int(scfg.dom_len), int(scfg.fft_len)),
        float(rad_dist), int(start_idx), np.asarray(dist_weights))


def _auto_half_width(Dparams, cell, z=4.0, lo=6):
    """Window half-width in cells covering ~z sigma of a diffusion kernel."""
    sig = max(float(Dparams[0]), float(Dparams[1]))
    return max(lo, int(np.ceil(z * sig / cell)) + 1)


def setup_forward(params: Params, device=None, dtype=None) -> ForwardSetup:
    """Load wind and freeze the static configuration of a Params object on
    ``device`` (default: CUDA; the CPU only when asked for) in ``dtype`` (default: f32, f64
    when ``params.use_f64``)."""
    device = pick_device(device)
    dtype = pick_dtype(params, dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    wind_data, days = get_wind_data(*params.get_wind_params())
    ndays = len(days) if params.ndays < 0 else min(params.ndays, len(days))
    packed = pack_wind(wind_data, days, ndays=len(days))
    T = packed.shape[1]
    flat = np.asarray(packed.reshape(-1, 2), np_dtype)
    rad_dist, rad_res = params.domain_info
    cell = rad_dist / rad_res
    # static window half-widths: ~4 sigma of this run's diffusion unless
    # pinned (the Bayes layer pins prior-coverage widths)
    K = (params.kernel_rad if params.kernel_rad is not None
         else _auto_half_width(params.Dparams, cell))
    Kl = (params.kernel_rad_local if params.kernel_rad_local is not None
          else _auto_half_width(params.Dlparams, cell, lo=3))
    if params.quad_nodes != _DEFAULT_QUAD_NODES:
        warnings.warn('quad_nodes={} is ignored: the BVN node count follows '
                      '|rho| (Genz: 6/12/20 nodes, or the high-|rho| series)'
                      .format(params.quad_nodes), UserWarning, stacklevel=2)
    kcfg = KernelConfig(rad_res=int(rad_res), periods=T, K=int(K),
                        K_local=int(Kl),
                        ref_trunc=bool(getattr(params, 'ref_trunc', False)))
    if (not params.PROB_MODEL) and params.r_start is not None:
        start_idx = int(params.r_start * T)
    else:
        start_idx = 0
    if params.r_dur:
        w = np.array([params.r_mthd()(d + 1) for d in range(params.r_dur)])
    else:
        if not params.PROB_MODEL:
            raise ValueError(
                'the population model requires r_dur >= 1 (release '
                'duration in days) — pick a dataset preset/site spec or '
                'pass r_dur=N')
        w = np.ones(1)
    return setup_from_numpy(flat, wind_prefix_sum(flat), days, ndays, kcfg,
                            SolverConfig.for_domain(int(rad_res)), rad_dist,
                            start_idx, w, device, dtype,
                            use_pallas=getattr(params, 'use_pallas', None))


def build_all_kernels(wind_flat, wind_cumsum, hparams, Dparams, Dlparams,
                      mu_r, n_periods, rad_dist, start_idx,
                      kcfg: KernelConfig, ndays: int, branches=(None, None)):
    """Every day's dispersal kernel (the reference's pool fan-out, the JAX
    package's scan over days); returns ``((ndays, D, D), (ndays,) losses)``
    on ``wind_flat``'s device.  The parameters may be tensors that require
    grad; ``branches`` (see ``build_daily_kernel``) spares a host read of
    each tensor ρ per day.  What the days share (the day kernel's packed
    constants, the local-diffusion block) is made once, before the loop."""
    with trace.span('forward.day_loop'):
        inv = day_invariants(Dparams, Dlparams, rad_dist, kcfg,
                             wind_flat.device, wind_flat.dtype, branches[1])
        days = [build_daily_kernel(wind_flat, wind_cumsum, d, hparams,
                                   Dparams, Dlparams, mu_r, n_periods,
                                   rad_dist, start_idx if d == 0 else 0,
                                   kcfg, branches, inv)
                for d in range(ndays)]
        # stacked out of place, so the result is differentiable in every
        # parameter (the day kernel's backward keeps only per-minute inputs,
        # so no per-day checkpoint is needed)
        return (torch.stack([pmf for pmf, _ in days]),
                torch.stack([loss for _, loss in days]))


def build_all_kernels_batched(wind_flat, wind_cumsum, hparams, Dparams,
                              Dlparams, mu_r, n_periods, rad_dist, start_idx,
                              kcfg: KernelConfig, ndays: int):
    """Every day's dispersal kernel for N parameter sets at once (each
    parameter an ``(N,)`` tensor; ``hparams``, ``Dparams`` and ``Dlparams``
    tuples of them), with the select node rule: ``((N, ndays, D, D),
    (N, ndays) losses)``.  On the card with ``kcfg.pallas`` every day is
    one launch of the particle-batched day kernel; nothing reads the
    card.  The packed constants and the local block are made once."""
    with trace.span('forward.day_loop'):
        inv = day_invariants(Dparams, Dlparams, rad_dist, kcfg,
                             wind_flat.device, wind_flat.dtype, batched=True)
        days = [build_daily_kernel_batched(
            wind_flat, wind_cumsum, d, hparams, Dparams, Dlparams, mu_r,
            n_periods, rad_dist, start_idx if d == 0 else 0, kcfg, inv)
            for d in range(ndays)]
        return (torch.stack([pmf for pmf, _ in days], dim=1),
                torch.stack([loss for _, loss in days], dim=1))


def forward_fields(wind_flat, wind_cumsum, hparams, Dparams, Dlparams, mu_r,
                   n_periods, rad_dist, start_idx, r_number, dist_weights,
                   kcfg: KernelConfig, scfg: SolverConfig, ndays: int,
                   r_dur: int, prob_model: bool):
    """Kernel build plus propagation in one call: the library's forward
    simulation, ``(ndays, D, D)`` fields on ``wind_flat``'s device."""
    kernels, _ = build_all_kernels(wind_flat, wind_cumsum, hparams, Dparams,
                                   Dlparams, mu_r, n_periods, rad_dist,
                                   start_idx, kcfg, ndays)
    if prob_model:
        return propagate_prob(kernels, scfg)
    return propagate_pop(kernels, r_dur, r_number, dist_weights, scfg)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def simulate(params: Params, setup: ForwardSetup | None = None,
             timing: dict | None = None, device=None):
    """Run the full forward model for a Params config.

    Returns ``(fields, days)``: the ``(ndays, D, D)`` per-day fields
    (probability pmfs or expected populations) on the setup's device and
    the day labels.  ``timing`` receives ``kernel_phase`` and
    ``conv_phase`` seconds, each ending in a device synchronize.
    """
    if setup is None:
        setup = setup_forward(params, device=device)
    dev = setup.wind_flat.device
    hparams = (params.lam, *params.g_params, *params.f_params)

    tic = time.perf_counter()
    kernels, losses = build_all_kernels(
        setup.wind_flat, setup.wind_cumsum, hparams, params.Dparams,
        params.Dlparams, params.mu_r, params.n_periods, setup.rad_dist,
        setup.start_idx if not params.PROB_MODEL else 0, setup.kcfg,
        setup.ndays)
    _sync(dev)
    if timing is not None:
        timing['kernel_phase'] = time.perf_counter() - tic

    tic = time.perf_counter()
    if params.PROB_MODEL:
        fields = propagate_prob(kernels, setup.scfg)
    else:
        fields = propagate_pop(
            kernels, int(params.r_dur), float(params.r_number),
            torch.as_tensor(setup.dist_weights, dtype=kernels.dtype).to(dev),
            setup.scfg)
    _sync(dev)
    if timing is not None:
        timing['conv_phase'] = time.perf_counter() - tic

    days = list(setup.days)[:setup.ndays]
    warn_on_loss(losses.cpu().numpy(), days)   # ref ParasitoidModel.py:547-558
    return fields, days

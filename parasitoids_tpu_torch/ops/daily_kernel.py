"""Daily dispersal-kernel builder, PyTorch port of
``parasitoids_tpu/ops/daily_kernel.py`` (reference ``prob_mass``,
ParasitoidModel.py:384-613).

One day is: per-minute take-off probabilities and advection means (prefix
sums over the concatenated wind), the minutes' BVN blocks accumulated into
a K-cell padded buffer (:mod:`.day_kernel`), then :func:`finish_day` —
crop, loss accounting, the "didn't fly" local-diffusion remainder and the
sparsify-and-renormalize of ``CalcSol.r_small_vals``.  The result is a
dense ``(2*rad_res+1)²`` pmf.  Nothing here reads a device value on the
host when the caller passes the Genz branches of its tensor ρ, so such a
day loop on CUDA never waits on the card.  What every day of one
evaluation shares (:func:`day_invariants`: the day kernel's packed
constants and the local-diffusion block) a day loop makes once.

Two modes of the JAX builder are kept: ``ref_trunc`` (the reference's
adaptive ring-expansion stopping rule, :func:`ring_truncate`, a parity
tool) and ``batched_bvn`` (the two-branch select node rule of an
ensemble).  Both take the plain accumulate for one parameter set, as the
JAX builder takes its XLA scatter path for them.
:func:`build_daily_kernel_batched` builds one day for N parameter sets at
once: one launch of the particle-batched CUDA day kernel on the card
(``ops.day_kernel.accumulate_day_batched``), its plain twin on the CPU,
each particle's minutes with that particle's own Genz tier; only its
local-diffusion block keeps the select rule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import scalar
from .bvn import SELECT, bvn_cell_masses, bvn_cell_masses_batched
from .day_kernel import (accumulate_day, accumulate_day_batched,
                         accumulate_day_batched_plain, accumulate_day_plain,
                         pack_constants)
from .flight import h_flight_prob

__all__ = ['KernelConfig', 'build_daily_kernel', 'build_daily_kernel_batched',
           'day_invariants', 'day_scatter_inputs', 'finish_day',
           'local_block', 'r_small_vals_dense', 'ring_truncate']

_SECONDS_PER_DAY = 3600 * 24
_NEGVAL = 1e-8  # sparsity threshold, ref CalcSol.py:112


class KernelConfig(NamedTuple):
    """Static configuration of the kernel builder (shapes and path)."""
    rad_res: int          # cells from release point to domain side
    periods: int          # wind samples per day (48 * interp_num)
    K: int                # flight-kernel window half-width (cells)
    K_local: int          # local-diffusion window half-width (cells)
    chunk: int = 240      # minutes per plain block build (bounds memory)
    pallas: bool = False  # True: the CUDA day kernel (CUDA tensors only)
    # the reference's adaptive ring-expansion stopping rule (cdf_eps =
    # 0.001, ParasitoidModel.py:329,348) on every block and the local
    # kernel: a parity tool, run through the plain accumulate
    ref_trunc: bool = False
    # the ensemble's mode: N parameter sets take the particle-batched
    # accumulate, each particle's minutes by its own Genz tier, and the
    # local block by the two-branch select node rule (ops/bvn.py
    # bvn_cell_masses_batched); one parameter set takes the plain
    # accumulate with the select rule throughout, as the JAX builder does
    batched_bvn: bool = False


def r_small_vals_dense(field, prob_model=False, negval=_NEGVAL):
    """Zero entries below ``negval``; in probability-model mode spread the
    removed mass uniformly over the surviving support (CalcSol.py:112-136).
    A field with no surviving entry passes through unchanged.  Leading
    axes are separate fields: the sums run over the last two."""
    keep = field >= negval
    kept = torch.where(keep, field, torch.zeros_like(field))
    if prob_model:
        n_keep = keep.sum(dim=(-2, -1), keepdim=True)
        n = torch.clamp(n_keep, min=1)
        kept = kept + torch.where(
            keep, (1.0 - kept.sum(dim=(-2, -1), keepdim=True)) / n,
            torch.zeros_like(field))
        kept = torch.where(n_keep > 0, kept, field)
    return kept


def ring_truncate(block, K: int, cdf_eps: float = 0.001):
    """Truncate ``(..., 2K+1, 2K+1)`` BVN blocks each to the smallest
    centred square of cells whose cumulative mass exceeds ``1 − cdf_eps``:
    the reference's adaptive ring expansion (ParasitoidModel.py:329-348,
    ``while 1 - val_sum >= cdf_eps: h += 1``).  A block whose window never
    reaches the threshold (one straddling the boundary) is kept whole."""
    n = 2 * K + 1
    i = torch.arange(n, device=block.device)
    cheb = torch.maximum((i - K).abs()[:, None], (i - K).abs()[None, :])
    # ring sums by a one-hot product, then their running sum outward
    onehot = (cheb.reshape(-1)[:, None] ==
              torch.arange(K + 1, device=block.device)).to(block.dtype)
    rings = block.reshape(*block.shape[:-2], n * n) @ onehot
    meets = torch.cumsum(rings, -1) > (1.0 - cdf_eps)
    h_star = torch.where(meets.any(-1), meets.to(torch.int8).argmax(-1),
                         torch.full_like(meets[..., 0], K, dtype=torch.int64))
    keep = cheb <= h_star[..., None, None]
    return torch.where(keep, block, torch.zeros_like(block))


def _advection_means(wind_flat, wind_cumsum, day_idx, n_periods, periods,
                     mu_r):
    """Windowed mean advection per minute of the day in flight meters per
    period (ParasitoidModel.py:439-472): ``n_periods`` samples forward on
    the concatenated wind, truncated at the end of the data."""
    dev, dtype = wind_flat.device, wind_flat.dtype
    total = wind_flat.shape[0]
    # n_periods = 0 is inside the prior's support: floor the window at 1
    n_periods = torch.clamp(scalar(n_periods, torch.int64, dev), min=1)
    starts = day_idx * periods + torch.arange(periods, device=dev)
    ends = torch.clamp(starts + n_periods, max=total)
    counts = (ends - starts).to(dtype)
    sums = wind_cumsum[ends] - wind_cumsum[starts]          # (..., T, 2)
    mu_v = sums / counts[..., None]                          # m/s
    scale = _SECONDS_PER_DAY * (n_periods.to(dtype) / periods) * mu_r
    return mu_v * scale[..., None]


def day_scatter_inputs(wind_flat, wind_cumsum, day_idx, hparams, mu_r,
                       n_periods, start_idx, config: KernelConfig, rad_dist):
    """Per-minute accumulate inputs ``(h_scat, cdf_mu, idx, clip_f,
    outside_loss)`` for day ``day_idx`` (a Python int).  Parameters given
    as ``(N, 1)`` tensors (``n_periods`` and ``mu_r`` too) give a leading
    particle axis on every output: ``(N, T)``, ``(N, T, 2)`` and ``(N,)``
    for the loss."""
    T, K = config.periods, config.K
    rad_res = config.rad_res
    cell = rad_dist / rad_res
    dev, dtype = wind_flat.device, wind_flat.dtype

    # --- per-minute take-off probability -------------------------------
    day_wind = wind_flat[day_idx * T:(day_idx + 1) * T]
    windr = torch.hypot(day_wind[:, 0], day_wind[:, 1])
    lam, aw, bw, a1, b1, a2, b2 = hparams
    hprob = h_flight_prob(windr, lam, aw, bw, a1, b1, a2, b2)
    active = torch.arange(T, device=dev) >= start_idx
    zero = torch.zeros_like(hprob)
    h_eff = torch.where(active, hprob, zero)

    # --- per-minute advection and window placement ---------------------
    mu_v = _advection_means(wind_flat, wind_cumsum, day_idx, n_periods, T,
                            mu_r)                                  # (T, 2)
    grid_off = torch.round(mu_v / cell)
    cdf_mu = (mu_v - grid_off * cell).contiguous()                 # (T, 2)
    col_off = grid_off[..., 0].to(torch.int32)
    row_off = -grid_off[..., 1].to(torch.int32)  # +y decreases row index

    # blocks centred more than K cells beyond the edge miss the domain: all
    # their take-off probability is loss (ParasitoidModel.py:547-558); every
    # other block fits the 2K-padded buffer without clamping
    outside = ((row_off.abs() > rad_res + K) | (col_off.abs() > rad_res + K))
    clipped = (~outside & ((row_off.abs() + K > rad_res) |
                           (col_off.abs() + K > rad_res)))
    idx = torch.stack(
        [torch.where(outside, rad_res, rad_res + K + row_off),
         torch.where(outside, rad_res, rad_res + K + col_off)],
        dim=-1).to(torch.int32).contiguous()
    h_scat = torch.where(outside, zero, h_eff)
    clip_f = clipped.to(dtype)
    outside_loss = torch.where(outside, h_eff, zero).sum(-1)
    return h_scat, cdf_mu, idx, clip_f, outside_loss


def local_block(Dlparams, config: KernelConfig, rad_dist, lead, dtype,
                device, branch=None):
    """The "didn't fly" local-diffusion block, ``lead + (2Kl+1, 2Kl+1)``:
    the same for every day of one evaluation, so a day loop builds it once
    (:func:`day_invariants`).  ``branch``: see :func:`finish_day`;
    ``batched_bvn`` takes the select node rule, ``ref_trunc`` the
    reference's ring expansion."""
    Kl = config.K_local
    cell = rad_dist / config.rad_res
    sl_x, sl_y, sl_rho = Dlparams
    zero_mu = torch.zeros(tuple(lead) + (2,), dtype=dtype, device=device)
    if config.batched_bvn:
        local = bvn_cell_masses_batched(zero_mu, sl_x, sl_y, sl_rho, cell, Kl)
    else:
        local = bvn_cell_masses(zero_mu, sl_x, sl_y, sl_rho, cell, Kl, branch)
    if config.ref_trunc:
        # the reference builds the local kernel with the same ring
        # expansion (ParasitoidModel.py:581-584)
        local = ring_truncate(local, Kl)
    return local


def finish_day(buf, outside_loss, clip_loss, Dlparams, config: KernelConfig,
               rad_dist, branch=None, local=None):
    """Crop the padded buffer, total the loss, add the "didn't fly"
    local-diffusion remainder in place into the centre window, sparsify
    and renormalize.  ``branch``: the Genz branch of the local |ρ| when the
    caller has read it (see ``ops.bvn.genz_branch``).  ``local``: the
    block of :func:`local_block` when the caller built it once for all
    its days, else it is built here.  Returns ``(pmf, loss)``.  A
    ``(N, L, L)`` buffer is N particles: the losses are ``(N,)`` and
    ``Dlparams`` one ``(N,)`` tensor each; ``batched_bvn`` builds the
    local kernel with the select node rule."""
    K, Kl = config.K, config.K_local
    rad_res = config.rad_res
    D = 2 * rad_res + 1
    lead = buf.shape[:-2]

    pmf = buf[..., 2 * K:2 * K + D, 2 * K:2 * K + D]
    pad_mass = buf.sum(dim=(-2, -1)) - pmf.sum(dim=(-2, -1))
    # mass scattered beyond the domain + truncation shortfall of
    # boundary-straddling blocks + blocks wholly off the domain
    loss = pad_mass + clip_loss + outside_loss

    total_flight_prob = pmf.sum(dim=(-2, -1)) + loss
    if local is None:
        local = local_block(Dlparams, config, rad_dist, lead, buf.dtype,
                            buf.device, branch)
    stay = torch.where(total_flight_prob < 0.99999, 1.0 - total_flight_prob,
                       torch.zeros_like(total_flight_prob))
    pmf[..., rad_res - Kl:rad_res + Kl + 1,
        rad_res - Kl:rad_res + Kl + 1] += stay[..., None, None] * local
    return r_small_vals_dense(pmf, prob_model=True), loss


def _kernel_path(config: KernelConfig):
    """One parameter set's days go through the CUDA day kernel."""
    return config.pallas and not config.ref_trunc and not config.batched_bvn


def day_invariants(Dparams, Dlparams, rad_dist, config: KernelConfig,
                   device, dtype, branch=None, batched=False):
    """What every day of one evaluation shares, made once for its day
    loop: ``(consts, local)``, the day kernel's packed constants
    (``ops.day_kernel.pack_constants``; None where the days take the plain
    accumulate) and the local-diffusion block (:func:`local_block`).
    ``branch``: the Genz branch of the local |ρ| (see :func:`finish_day`).
    ``batched``: for :func:`build_daily_kernel_batched`, ``Dparams`` and
    ``Dlparams`` tuples of ``(N,)`` tensors."""
    cell = rad_dist / config.rad_res
    if not batched:
        consts = (pack_constants(Dparams, cell, device)
                  if _kernel_path(config) else None)
        return consts, local_block(Dlparams, config, rad_dist, (), dtype,
                                   device, branch)
    dp = _stacked(Dparams, dtype, device)
    consts = pack_constants(dp, cell, device) if config.pallas else None
    return consts, local_block(Dlparams, config._replace(batched_bvn=True),
                               rad_dist, dp.shape[:1], dtype, device)


def _stacked(Dparams, dtype, device):
    """N particles' ``(σx, σy, ρ)`` as one ``(N, 3)`` tensor."""
    return torch.stack([scalar(v, dtype, device) for v in Dparams], dim=-1)


def build_daily_kernel(wind_flat, wind_cumsum, day_idx, hparams, Dparams,
                       Dlparams, mu_r, n_periods, rad_dist, start_idx,
                       config: KernelConfig, branches=(None, None),
                       invariants=(None, None)):
    """One day's dispersal pmf, ``(2*rad_res+1)²``, and its loss.

    Args:
        wind_flat: (ndays*periods, 2) concatenated interpolated wind (m/s);
            its device and dtype are the computation's.
        wind_cumsum: (ndays*periods + 1, 2) prefix sum of ``wind_flat``.
        day_idx: which day (Python int).
        hparams: (lam, aw, bw, a1, b1, a2, b2) take-off parameters.
        Dparams: (sig_x, sig_y, rho) flight diffusion; numbers, 0-d tensors
            or a (3,) tensor on the device.
        Dlparams: (sig_x, sig_y, rho) local diffusion.
        mu_r: wind-to-flight advection scaling.  n_periods: flight duration
            in wind samples.  rad_dist: meters from release point to side.
        start_idx: first active minute.  config: shapes and path.
        branches: the Genz branches of the flight and local |ρ| when the
            caller has read them (``ops.bvn.genz_branch``); a ``None`` is
            read from its ρ where a BVN needs it (the CUDA day kernel reads
            ρ on the device and needs no branch).
        invariants: ``(consts, local)`` of :func:`day_invariants` when the
            caller made them once for its days; each None is made here.

    ``config.pallas`` selects the CUDA day kernel (CUDA tensors only);
    otherwise, and always with ``ref_trunc`` or ``batched_bvn``, the plain
    accumulate runs.
    """
    if config.pallas and wind_flat.device.type != 'cuda':
        raise ValueError('pallas=True needs CUDA tensors: the CUDA day '
                         'kernel has no CPU or interpret mode')
    T, K = config.periods, config.K
    D = 2 * config.rad_res + 1
    cell = rad_dist / config.rad_res

    h_scat, cdf_mu, idx, clip_f, outside_loss = day_scatter_inputs(
        wind_flat, wind_cumsum, day_idx, hparams, mu_r, n_periods,
        start_idx, config, rad_dist)
    consts, local = invariants
    if _kernel_path(config):
        buf, clip_loss = accumulate_day(h_scat, cdf_mu, idx, clip_f, Dparams,
                                        cell, K, D + 4 * K, consts=consts)
    else:
        buf, clip_loss = accumulate_day_plain(
            h_scat, cdf_mu, idx, clip_f, Dparams, cell, K, D + 4 * K,
            chunk=min(config.chunk, T),
            branch=SELECT if config.batched_bvn else branches[0],
            ref_trunc=config.ref_trunc)
    return finish_day(buf, outside_loss, clip_loss, Dlparams, config,
                      rad_dist, branches[1], local)


def build_daily_kernel_batched(wind_flat, wind_cumsum, day_idx, hparams,
                               Dparams, Dlparams, mu_r, n_periods, rad_dist,
                               start_idx, config: KernelConfig,
                               invariants=(None, None)):
    """One day's dispersal pmf for N parameter sets at once, ``(N, D, D)``,
    and the ``(N,)`` losses (the JAX builder under ``vmap`` with
    ``batched_bvn``, except that each particle's minutes take its own Genz
    tier where JAX takes the select node rule; the local block takes the
    select rule).  Every parameter is an ``(N,)`` tensor (``hparams``,
    ``Dparams`` and ``Dlparams`` tuples of them; ``n_periods``
    integer).  On the card with ``config.pallas`` the day
    is one launch of the particle-batched CUDA kernel for the whole
    population; otherwise the plain batched accumulate runs.  Nothing
    here reads the card.  ``invariants``: ``day_invariants(...,
    batched=True)`` when the caller made them once for its days."""
    if config.ref_trunc:
        raise ValueError('ref_trunc is a parity tool of one parameter set: '
                         'build_daily_kernel takes it')
    T, K = config.periods, config.K
    D = 2 * config.rad_res + 1
    cell = rad_dist / config.rad_res

    def col(v):
        return v.reshape(-1, 1)

    h_scat, cdf_mu, idx, clip_f, outside_loss = day_scatter_inputs(
        wind_flat, wind_cumsum, day_idx, tuple(col(v) for v in hparams),
        col(mu_r), col(n_periods), start_idx, config, rad_dist)
    dp = _stacked(Dparams, wind_flat.dtype, wind_flat.device)
    consts, local = invariants
    if config.pallas:
        buf, clip_loss = accumulate_day_batched(h_scat, cdf_mu, idx, clip_f,
                                                dp, cell, K, D + 4 * K,
                                                consts=consts)
    else:
        buf, clip_loss = accumulate_day_batched_plain(
            h_scat, cdf_mu, idx, clip_f, dp, cell, K, D + 4 * K,
            chunk=min(config.chunk, T))
    return finish_day(buf, outside_loss, clip_loss, Dlparams,
                      config._replace(batched_bvn=True), rad_dist,
                      local=local)

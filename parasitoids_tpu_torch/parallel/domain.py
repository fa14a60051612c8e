"""Minute-sharded single-simulation forward pass (latency scaling), PyTorch
port of ``parasitoids_tpu/parallel/domain.py``.

``parallel/chains.py`` and ``parallel/ensemble.py`` scale throughput: each
device runs whole independent simulations.  This module spreads ONE
forward simulation over a mesh, for the workloads where a single chain's
wall clock is the bottleneck (MAP, NUTS and VI gradient evaluations, each
of which runs one forward simulation per step).

The axis that shards is the kernel builder's flight-minute loop: the
minutes of a day are independent until they are summed into the day
buffer, so each shard of the mesh takes a contiguous block of minutes
(padded to a multiple of the mesh size with take-off probability 0 at
``idx (0, 0)``), accumulates it on its own device through
``ops.day_kernel.accumulate_day`` (on the card the CUDA kernels K1/K2,
and K3/K4 for the gradient through the autograd backward of the copy to
the lead device), and ``chains.psum`` adds the shards' buffers and
truncation losses on the lead device in shard order.  The per-minute
inputs, ``finish_day`` and the FFT propagation run once, on the lead
device.  Only the order of the buffer's sums differs from the unsharded
builder, so results agree to float-summation tolerance; two runs give the
same bits.

The reference has no counterpart: its only intra-simulation parallelism is
a ``multiprocessing.Pool`` over days (Run.py:412-429), which cannot help a
single likelihood evaluation inside MCMC.

Use ``BayesSetup.with_forward_mesh(mesh)`` to route every posterior
evaluation through the sharded builder (its ``with_batched_bvn`` copy
through :func:`build_all_kernels_batched_sharded`, every shard one
particle-batched launch a day).  Do not combine it with the
chain-sharded samplers: those shard the chain axis.
"""

from __future__ import annotations

from functools import partial

import torch

from ..device import scalar
from ..ops.day_kernel import (accumulate_day, accumulate_day_batched,
                              accumulate_day_batched_plain,
                              accumulate_day_plain)
from ..ops.daily_kernel import KernelConfig, day_scatter_inputs, finish_day
from .chains import axis_mesh, psum, shard_bounds

__all__ = ['minute_mesh', 'build_daily_kernel_sharded',
           'build_all_kernels_sharded', 'build_all_kernels_batched_sharded']

_AXIS = 'minutes'


def minute_mesh(n_devices=None, devices=None):
    """1-D mesh over a ``minutes`` axis (all visible devices by
    default; ``devices`` may name one device more than once)."""
    return axis_mesh(_AXIS, n_devices, devices)


def _pad(x, pad, axis):
    """``x`` with ``pad`` zeros appended along ``axis``."""
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _sharded_accumulate(mesh, h_scat, cdf_mu, idx, clip_f, Dparams, cell,
                        config: KernelConfig, buf_len, branch=None):
    """Accumulate one day's minutes with the minute axis sharded over
    ``mesh``: each shard's buffer and loss on its own device, merged by
    :func:`chains.psum` on the lead device.  The CUDA kernel runs where
    the setup takes it (``config.pallas``, not ``ref_trunc``), the plain
    accumulate otherwise.  Inputs with a leading particle axis (``(N, T)``
    and so on, ``Dparams`` an ``(N, 3)`` tensor) take the particle-batched
    accumulate on every shard."""
    batched = h_scat.ndim == 2
    n_dev = mesh.size
    T = h_scat.shape[-1]
    pad = (-T) % n_dev
    if pad:                       # padded minutes scatter h=0 at (0, 0)
        h_scat, clip_f = (_pad(x, pad, -1) for x in (h_scat, clip_f))
        cdf_mu, idx = (_pad(x, pad, -2) for x in (cdf_mu, idx))
    t_local = (T + pad) // n_dev
    kernel = config.pallas and not config.ref_trunc
    bufs, losses = [], []
    for dev, a, b in shard_bounds(T + pad, mesh):
        h, cl = (x[..., a:b].contiguous().to(dev) for x in (h_scat, clip_f))
        mu, ix = (x[..., a:b, :].contiguous().to(dev) for x in (cdf_mu, idx))
        if batched:
            dp = Dparams.to(dev)
            accumulate = (accumulate_day_batched if kernel else partial(
                accumulate_day_batched_plain, chunk=min(config.chunk,
                                                        t_local)))
            buf, loss = accumulate(h, mu, ix, cl, dp, cell, config.K,
                                   buf_len)
        elif kernel:
            dp = tuple(scalar(v, h.dtype, dev) for v in Dparams)
            buf, loss = accumulate_day(h, mu, ix, cl, dp, cell, config.K,
                                       buf_len)
        else:
            dp = tuple(scalar(v, h.dtype, dev) for v in Dparams)
            buf, loss = accumulate_day_plain(
                h, mu, ix, cl, dp, cell, config.K, buf_len,
                chunk=min(config.chunk, t_local), branch=branch,
                ref_trunc=config.ref_trunc)
        bufs.append(buf)
        losses.append(loss)
    return psum(bufs, mesh), psum(losses, mesh)


def _check_lead(mesh, wind_flat):
    if wind_flat.device != mesh.devices[0]:
        raise ValueError('the setup lies on {}, the mesh leads with {}'
                         .format(wind_flat.device, mesh.devices[0]))


def build_daily_kernel_sharded(mesh, wind_flat, wind_cumsum, day_idx,
                               hparams, Dparams, Dlparams, mu_r, n_periods,
                               rad_dist, start_idx, config: KernelConfig,
                               branches=(None, None)):
    """Minute-sharded twin of ``ops.daily_kernel.build_daily_kernel``:
    the same contract and physics, only the order of the buffer's sums
    differs (per-shard partial sums).  ``wind_flat`` lies on the mesh's
    lead device, and so do the results."""
    if config.batched_bvn:
        raise ValueError('a batched_bvn configuration takes N parameter '
                         'sets: build_all_kernels_batched_sharded')
    _check_lead(mesh, wind_flat)
    K = config.K
    D = 2 * config.rad_res + 1
    cell = rad_dist / config.rad_res

    h_scat, cdf_mu, idx, clip_f, outside_loss = day_scatter_inputs(
        wind_flat, wind_cumsum, day_idx, hparams, mu_r, n_periods,
        start_idx, config, rad_dist)
    buf, clip_loss = _sharded_accumulate(
        mesh, h_scat, cdf_mu, idx, clip_f, Dparams, cell, config, D + 4 * K,
        branches[0])
    return finish_day(buf, outside_loss, clip_loss, Dlparams, config,
                      rad_dist, branches[1])


def build_all_kernels_sharded(mesh, wind_flat, wind_cumsum, hparams,
                              Dparams, Dlparams, mu_r, n_periods, rad_dist,
                              start_idx, config: KernelConfig, ndays: int,
                              branches=(None, None)):
    """All daily kernels with the minute axis sharded: the sharded twin of
    ``models.forward.build_all_kernels``, ``((ndays, D, D), (ndays,))`` on
    the lead device, differentiable in every parameter."""
    days = [build_daily_kernel_sharded(
        mesh, wind_flat, wind_cumsum, d, hparams, Dparams, Dlparams, mu_r,
        n_periods, rad_dist, start_idx if d == 0 else 0, config, branches)
        for d in range(ndays)]
    return (torch.stack([pmf for pmf, _ in days]),
            torch.stack([loss for _, loss in days]))


def build_all_kernels_batched_sharded(mesh, wind_flat, wind_cumsum, hparams,
                                      Dparams, Dlparams, mu_r, n_periods,
                                      rad_dist, start_idx,
                                      config: KernelConfig, ndays: int):
    """The minute-sharded twin of ``models.forward.build_all_kernels_batched``
    (N parameter sets at once, each parameter an ``(N,)`` tensor, each
    particle's minutes by its own Genz tier): every shard's minutes of
    every particle through one particle-batched accumulate on its device.
    ``((N, ndays, D, D), (N, ndays))`` on the lead device."""
    _check_lead(mesh, wind_flat)
    K = config.K
    D = 2 * config.rad_res + 1
    cell = rad_dist / config.rad_res
    dtype, dev = wind_flat.dtype, wind_flat.device
    dp = torch.stack([scalar(v, dtype, dev) for v in Dparams], dim=-1)
    cfg = config._replace(batched_bvn=True)
    pmfs, losses = [], []
    for d in range(ndays):
        h_scat, cdf_mu, idx, clip_f, outside_loss = day_scatter_inputs(
            wind_flat, wind_cumsum, d, tuple(v.reshape(-1, 1)
                                             for v in hparams),
            mu_r.reshape(-1, 1), n_periods.reshape(-1, 1),
            start_idx if d == 0 else 0, config, rad_dist)
        buf, clip_loss = _sharded_accumulate(
            mesh, h_scat, cdf_mu, idx, clip_f, dp, cell, config, D + 4 * K)
        pmf, loss = finish_day(buf, outside_loss, clip_loss, Dlparams, cfg,
                               rad_dist)
        pmfs.append(pmf)
        losses.append(loss)
    return torch.stack(pmfs, dim=1), torch.stack(losses, dim=1)

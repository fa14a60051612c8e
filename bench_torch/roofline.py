"""The least work of the day accumulate and the propagation, counted from
a cell's real inputs, and the card's published peaks.

A share of the roofline is the least time the card could take for the
work the inputs need, divided by the measured time.  So every count here
is a floor, whatever computes it:

* only minutes whose take-off probability h_t is not 0 need a lattice;
  their inputs are read once and the day's buffer written once;
* each minute's lattice of (2K+2)² corners needs Genz's tier for the
  parameter set's own |rho| (6, 12 or 20 nodes, or the terms of the
  high-|rho| series that pass their cut-offs), whatever node rule a
  launch uses (the batched launch's select rule takes 20 nodes to 0.925);
* an exp (an erfc counted as one) is priced at the combined rate of the
  MUFU (16 a clock per SM) and the f32 pipes, on which any f32-accurate
  exp takes at least 4 instructions (range reduction and a polynomial),
  so moving exps off the MUFU cannot take a share past 100%;
* the other f32 work is 2 instructions per node and corner (form the
  exponent, accumulate its weighted exp) at the f32 peak.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores and HBM3; the
# card's power limit is printed beside every run (harness.card_info)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FP_INSTR_RATE = PEAK_F32_FLOPS / 2          # an FMA is 2 flops, 1 instruction
MUFU_PER_FP_INSTR = 16 / 128                # MUFU against f32 lanes a clock
EXP_MIN_FP_INSTR = 4
EXP_RATE = FP_INSTR_RATE * (MUFU_PER_FP_INSTR + 1.0 / EXP_MIN_FP_INSTR)
FP_PER_NODE = 2
GENZ_NODES = (6, 12, 20)
RHO_MAX = 1 - 1e-6


def genz_tier(abs_rho):
    return int(abs_rho >= 0.3) + int(abs_rho >= 0.75) + int(abs_rho >= 0.925)


def _high_series_exps(mu, sig_x, sig_y, rho, cell, K):
    """Exps of the high-|rho| series on these minutes' corner lattices:
    the leading term and each tail node where they pass their -80
    cut-offs, the product term where -hk < 80, and the final Phi."""
    m = 2 * K + 2
    dev = mu.device
    a_sq = max((1.0 - rho) * (1.0 + rho), 1e-30)
    a = math.sqrt(a_sq)
    x, _ = np.polynomial.legendre.leggauss(20)
    xs = torch.as_tensor((a / 2 * (1 + x)) ** 2, dtype=torch.float64,
                         device=dev)
    sgn = 1.0 if rho > 0 else -1.0
    ar = torch.arange(m, dtype=torch.float64, device=dev) - (K + 0.5)
    total = 0
    for s in range(0, mu.shape[0], 120):
        mc = mu[s:s + 120].double()
        h = ((ar * cell)[None, :] - mc[:, :1]) / sig_x            # (t, m)
        k = sgn * ((-ar * cell)[None, :] - mc[:, 1:]) / sig_y
        h, k = h[:, None, :], k[:, :, None]                      # (t, m, m)
        hk, bs = h * k, (h - k) ** 2
        n = (-(bs / a_sq + hk) / 2 > -80).sum() + 2 * (-hk < 80).sum()
        n += 2 * (-(bs[..., None] / xs + hk[..., None]) / 2 > -80).sum()
        n += hk.numel() if sgn > 0 else 2 * (k > h).sum()
        total += int(n)
    return total


def lattice_counts(h, mu, dparams, cell, K):
    """``(exps, fp instructions, active minutes, corners)`` of one
    parameter set's day: ``h`` (T,), ``mu`` (T, 2), ``dparams`` (sigma_x,
    sigma_y, rho) numbers."""
    sig_x, sig_y, rho = (float(v) for v in dparams)
    sig_x, sig_y = max(sig_x, 1e-8), max(sig_y, 1e-8)
    rho = min(max(rho, -RHO_MAX), RHO_MAX)
    active = (h != 0)
    n_act = int(active.sum())
    m = 2 * K + 2
    corners = n_act * m * m
    edges = 2 * m * n_act                       # Phi of each edge coordinate
    tier = genz_tier(abs(rho))
    if tier < 3:
        nodes = GENZ_NODES[tier]
        return corners * nodes + edges, corners * nodes * FP_PER_NODE, \
            n_act, corners
    exps = _high_series_exps(mu[active], sig_x, sig_y, rho, cell, K)
    return exps + edges, exps * FP_PER_NODE, n_act, corners


def forward_work(h, mu, dparams, cell, K, buf_len):
    """(exps, fp instructions, bytes) of one day's forward accumulate: h of
    every minute read, the active minutes' offsets, scatter start and clip
    flag read once, the buffer written once."""
    exps, fp, n_act, _ = lattice_counts(h, mu, dparams, cell, K)
    nbytes = 4 * h.shape[0] + n_act * (8 + 8 + 4) + 4 * buf_len * buf_len
    return exps, fp, nbytes


def backward_work(h, mu, dparams, cell, K, buf_len):
    """(exps, fp instructions, bytes) of one day's backward: the forward's
    lattice again, then a phi and two Phi at each corner and phi at each
    edge; the buffer's cotangent read once and each active minute's
    cotangents (h, the two offsets, the clip flag) written once."""
    exps, fp, n_act, corners = lattice_counts(h, mu, dparams, cell, K)
    m = 2 * K + 2
    exps += 3 * corners + 2 * m * n_act
    fp += 2 * corners
    nbytes = (4 * h.shape[0] + n_act * (8 + 8 + 4) +
              4 * buf_len * buf_len + 16 * n_act)
    return exps, fp, nbytes


def batched_work(h, mu, dparams, cell, K, buf_len):
    """(exps, fp instructions, bytes) of one day of N parameter sets: each
    set's forward at its own Genz tier; ``h`` (N, T), ``mu`` (N, T, 2),
    ``dparams`` (N, 3)."""
    tot = [0, 0, 0]
    for i in range(h.shape[0]):
        for j, v in enumerate(forward_work(h[i], mu[i], dparams[i], cell, K,
                                           buf_len)):
            tot[j] += v
    return tuple(tot)


def fft_work(n_ffts, P):
    """(fp instructions, bytes) of ``n_ffts`` real 2-D transforms of side
    P: 2.5 P² log2(P²) flops each (half of a complex transform's
    5 N log2 N), the real side read or written once and the half
    spectrum written or read once."""
    flops = 2.5 * P * P * math.log2(P * P)
    nbytes = 4 * P * P + 8 * P * (P // 2 + 1)
    return n_ffts * flops / 2, n_ffts * nbytes


def least_seconds(exps, fp, nbytes):
    """(seconds, what bounds it) at the published peaks."""
    parts = {'exps': exps / EXP_RATE, 'f32': fp / FP_INSTR_RATE,
             'bytes': nbytes / PEAK_BYTES}
    what = max(parts, key=parts.get)
    return parts[what], what

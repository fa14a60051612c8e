"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA day kernels from ``parasitoids_tpu_torch/csrc``, holds the
forward (K1/K2) against its plain torch twin on real Kalbar days at the
headline shapes (D = 801, T = 1440, K = 44), reproduces the checked-in
goldens through the kernel, then drives the forward main path — the CLI
population run at the Kalbar default and ``forward_fields`` at the
prior-coverage windows — and checks that every simulation went through the
kernel once per day.  Then the gradient path: the backward kernel (K3/K4)
against its plain twin at the headline shapes and at K = 88, the gradient
of the log posterior at the Bayes default (801²) through the kernels and
through the plain path, and the MAP CLI at its default (401²) with its
value and gradient held against a JAX golden.  Then the sampling path: the
adaptive-Metropolis CLI at the Bayes default (801², two chains, a
checkpoint, a resume), with the forward kernel's launches held to 18 per
forward simulation the chains ran, exact resume on the card, the host
reads of a step counted, and seconds per AM step.  Then the NUTS command
line at the Bayes default (two chains from a short MAP fit), with both
kernels' launches held to 18 per value+gradient, its target held against
the plain path, an interrupted chain resumed bit for bit, the host reads
of a transition counted, and seconds per leapfrog and per transition.
Then the curvature and analysis paths: the MAP CLI with ``--norm`` at
401² (no kernel launch while the f64 Hessian runs, its symmetry, three
rows against central differences of the f64 gradient), the NUTS CLI with
``--mass ridge`` at 801² (the whitening sidecar, a run resumed through it
bit for bit), and ``bayes.summary`` over the AM store (18 forward
launches per ensemble member, every section of the JAX report).  Then the
tempered and evidence samplers at the Bayes default: the PT command line
(four replicas, a checkpoint, a resume, one more swap round from the
reloaded store bitwise), ``run_smc`` stopped after stage 3 and resumed
from the command line's store bitwise at stage 5, the ADVI command line
(a fit and a resume from the stored q) with K3 = 18 per value+gradient
and K1 = K3 + 18 per evaluation without a graph, and ``bayes.sbc`` (AM arm)
stopped and resumed through its checkpoint; then a complete SMC anneal and
``bayes.cv`` on one fold at the MAP CLI's small depth.  Then SMC with
batched moves at the Bayes default: the particle-batched kernel against
its plain twin, each particle's batched forward against its in-turn one,
one batched launch a day per move round and no host read in it, a resume
bitwise, and seconds per particle move batched and in turn; and the
forward variants: the CLI with ``ref_trunc=true`` (no kernel launch),
the log-depth propagation against the sequential one, and the
model-vs-data statistics and figures from card tensors.  Then [20] the
member meshes at the Bayes default: the chain, store, replica, particle
(in turn and batched) and draw meshes each bitwise their runs without a
mesh.  Then [21] the evaluation replayed as
CUDA graphs (``utils/graphs.py``; every phase before it runs through them
where the setup is on the card with the day kernel): the no-gradient
forward, the value+gradient and the batched forward of 8 particles at the
Bayes default, each bitwise its eager run for two parameter sets, and
eager against graphed in turns, the seconds, device kernels, host launch
calls and device busy time of an AM step, a value+gradient and a batched
SMC move round, with each capture's seconds and graph-pool bytes.  Any
failed phase exits non-zero.  ``--only 11,12`` (or ``--only 20``, ``--only
21``) runs some phases alone, without the result line (a development
run).  The last line is a JSON
object with ``"ok": true`` and the device; the line before it lists the
kernels with their launches, errors, times (the forward's three passes and
the backward's two launches also timed alone, with CUDA events around the
kernels) and bounds, the least time the card could take for the same work
from this run's inputs.  Needs one CUDA device; imports nothing of JAX or
of the JAX package, and checks that.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')
BUF_TOL, HI_TOL = 2e-6, 3e-6      # atol of test_pallas_kernel.py: upper bounds
# kernel vs plain on the card, set from sound readings at the headline
# shapes on an H100 (largest seen: 4.3e-9 absolute, 1.14e-5 of the buffer
# peak, which lies between 1.7e-4 and 7.3e-4): f32 operation-order noise.
# A weight or scale error of 1e-4 relative breaks both limits.
ABS_LIMIT = 1e-8                  # max |kernel - plain|, buffer and loss
REL_LIMIT = 3e-5                  # max |kernel - plain| / buffer peak


# K3/K4 vs the plain backward on the card: each output within its own
# atol + BWD_RTOL * scale, scale its largest magnitude (ct_loss·h for
# dclip).  Sound readings at the headline shapes on an H100 (days 0/9/17,
# seven rho): dh within 2.3e-5 of its scale (its error is relative, so no
# atol); the largest absolute errors of the others are dmu 4.1e-11, dclip
# 3.5e-9, dsig 4.4e-10, drho 2.8e-8 where |drho| is small (up to 8.3e-7 at
# |drho| 0.29, inside the rtol) and dcell 3.9e-9.  The four shared sums
# cancel over 1,440 minutes, so their error is absolute: f32
# summation-order noise.  Each atol is about ten times its reading.
BWD_RTOL = 2e-4
BWD_ATOL = {'dh': 0.0, 'dmu': 5e-10, 'dclip': 4e-8, 'dsig_x': 5e-9,
            'dsig_y': 5e-9, 'drho': 3e-7, 'dcell': 4e-8}
# log-posterior gradient, kernels vs the plain path at 801² (sound
# readings on an H100: value equal, gradient relative L2 7.4e-7 at most,
# each component within 6.3e-5 of its magnitude), and the MAP value and
# gradient at 401² against the JAX golden (readings 4.7e-7, 2.3e-6, each
# component within 1.9e-6 of the largest), each limit about ten times its
# reading; a component that is 0 (n_periods is pinned) must stay 0 to
# 1e-8 of the largest
GRAD_VALUE_RTOL, GRAD_L2_LIMIT = 1e-6, 1e-5
GRAD_COMP_RTOL, GRAD_COMP_ATOL = 1e-3, 1e-8
GOLDEN_VALUE_RTOL, GOLDEN_L2_LIMIT = 5e-6, 3e-5
GOLDEN_COMP_LIMIT = 2e-5          # max |dg_i| / max |g|
GRAD_GOLDEN = os.path.join(ROOT, 'tests', 'torch_golden',
                           'map_grad_401.npz')
# the AM chain's initial log likelihood at 801² (no pre-spread day) through
# K1 against the plain path run in f64.  One observation's expected count
# of 0.02 is f32 roundoff of the propagation to 0.3-0.5% in either f32
# path, so two f32 values stand further apart than each stands from f64
# (readings on an H100: K1 1.6e-6 of the value from f64, the f32 plain path
# 5.6e-6 and changing from run to run with its atomic adds)
AM_LOGLIK_RTOL = 1e-5
# the NUTS target at 801² at the MAP start (10 Adam steps, near the mode,
# where the gradient's largest component is 85 against 2e4 at [7]'s start)
# through the kernels against the plain path run in f64.  Readings on an
# H100: value 1.23e-6 of itself, gradient relative L2 1.01e-4, worst
# component 1.2e-4 of the largest; the f32 plain path stands 3.9e-7 to
# 7.0e-7, 6.8e-5 to 7.7e-5 and 7.5e-5 to 8.8e-5 from f64, changing from run
# to run with its atomic adds.  Each limit about ten times its reading.
NUTS_VALUE_RTOL, NUTS_GRAD_L2_LIMIT, NUTS_GRAD_COMP_LIMIT = 1e-5, 1e-3, 1e-3
# the f64 Laplace Hessian at 401²: its asymmetry (two reverse-mode paths
# to each entry, f64 atomics in the plain accumulate) and three rows
# against central differences of the f64 gradient, each relative to the
# largest entry (of the matrix, of the row).  The gradient is only
# piecewise smooth: finish_day's 1e-8 sparsity threshold turns a cell on
# or off as the parameters move, and a difference whose two points
# straddle such a switch reads its jump over 2h.  Readings on an H100:
# asymmetry 2.3e-16 to 4.8e-16; the ρ row 1.1e-9 at h = 1e-5 but 7.8e-4
# at h = 1e-4, the σx row 1.2e-5 at h = 1e-5 and 4.5e-10 at 3e-6, the ξ
# row 2.6e-11.  So each row is held at the best of three steps, every
# error printed, each limit about ten times the worst reading
HESS_SYM_LIMIT, HESS_FD_LIMIT = 5e-15, 1e-8
HESS_FD_STEPS = (1e-5, 3e-6, 1e-6)
# SMC's batched moves on a mesh of two shards against the stacked batch
# of 4: positions within the rtol that tests/test_torch_smc.py holds the
# batched moves to against the moves in turn
BATCHED_MESH_RTOL = 1e-3


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)
    print('  ok: ' + msg)


def median_ms(fn, reps):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# The card's peak rates for the bounds: HBM3 at 3.35 TB/s and 67 TFLOP/s of
# f32 outside the tensor cores (NVIDIA's H100 SXM data sheet), and 16 exps
# (MUFU.EX2) per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0), at the card's maximum
# SM clock and SM count read in this run.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16


def sfu_rate():
    """Exps per second: SFU_PER_CLOCK_PER_SM x SMs x the maximum SM clock
    that nvidia-smi reports for this card."""
    mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,'
         'nounits'], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6


def lattice_exps(mu, Dp, cell, K):
    """The exps (an erfc counted as one) that the forward's corner lattices
    of these minutes need, counted from this run's data: every corner's
    G-node quadrature on the low-|rho| branch; on the high branch the
    series terms and tail nodes that pass their -80 cut-offs.  Plus Phi of
    each minute's 2 (2K + 2) edge coordinates.  Genz's tier by |rho|, the
    node rule of every launch, single and particle-batched.  Returns
    (exps, corners, whether the high branch ran)."""
    from parasitoids_tpu_torch.ops.bvn import genz_branch
    from parasitoids_tpu_torch.ops.day_kernel import LAYOUT, _pack_constants
    dev = mu.device
    q = _pack_constants(Dp, cell, dev)
    m, T = 2 * K + 2, mu.shape[0]
    corners = T * m * m
    branch = genz_branch(abs(float(q[3])))
    if branch < 3:
        return corners * (6, 12, 20)[branch] + 2 * m * T, corners, False
    sig_x, sig_y, sgn, a_sq = (float(q[i]) for i in (0, 1, 4, 6))
    xs = q[LAYOUT['kHiXs']:LAYOUT['kHiXs'] + 20]
    ar = torch.arange(m, dtype=torch.float32, device=dev) - (K + 0.5)
    total = 2 * m * T
    for s in range(0, T, 120):
        mc = mu[s:s + 120]
        h = ((ar * cell)[None, :] - mc[:, :1]) / sig_x            # (t, m)
        k = sgn * ((-ar * cell)[None, :] - mc[:, 1:]) / sig_y
        h, k = h[:, None, :], k[:, :, None]                      # (t, m, m)
        hk, bs = h * k, (h - k) ** 2
        n = (-(bs / a_sq + hk) / 2 > -80).sum() + 2 * (-hk < 80).sum()
        n += 2 * (-(bs[..., None] / xs + hk[..., None]) / 2 > -80).sum()
        n += hk.numel() if sgn > 0 else 2 * (k > h).sum()
        total += int(n)
    return total, corners, True


def bound(exps, flops, nbytes, rate):
    """(bound_ms, bound_by, what): the larger of the operations' time (exps
    at the SFU rate or f32 operations at the f32 peak, whichever is longer)
    and the bytes' time at the HBM rate; `what` names the three counts."""
    ops_s = max(exps / rate, flops / F32_FLOPS_PER_S)
    bytes_s = nbytes / HBM_BYTES_PER_S
    what = '{:.4g} exps ({:.4f} ms), {:.4g} f32 ops ({:.4f} ms), {:.4g} B ' \
        '({:.4f} ms)'.format(exps, 1e3 * exps / rate, flops,
                             1e3 * flops / F32_FLOPS_PER_S, nbytes,
                             1e3 * bytes_s)
    return (1e3 * max(ops_s, bytes_s),
            'operations' if ops_s >= bytes_s else 'bytes', what)


def forward_counts(h, mu, Dp, cell, K, buf_len):
    """(exps, f32 operations, bytes) of one day's forward accumulate: its
    exps, about 10 f32 operations per exp (and on the high branch 4 per
    tail node of every corner for its cut-off test), the four-corner
    differences and the scaled add (5 per cell), each input read once and
    the buffer written once."""
    exps, corners, hi = lattice_exps(mu, Dp, cell, K)
    T, n = h.shape[0], 2 * K + 1
    flops = 10 * exps + 5 * T * n * n + (80 * corners if hi else 0)
    nbytes = T * (4 + 8 + 8 + 4) + 4 * buf_len * buf_len
    return exps, flops, nbytes


def forward_bound(h, mu, Dp, cell, K, buf_len, rate):
    """Least time of one day's forward accumulate (see forward_counts)."""
    return bound(*forward_counts(h, mu, Dp, cell, K, buf_len), rate)


def backward_bound(h, mu, Dp, cell, K, buf_len, rate):
    """Least time of one day's backward: the forward's lattice exps plus
    two Phi and one exp a corner and phi, Phi of the edges; about 10 f32
    operations per exp and 20 per corner for the adjoint; the inputs and
    the cotangent buffer read once, the per-minute outputs written once."""
    exps, corners, hi = lattice_exps(mu, Dp, cell, K)
    T, m = h.shape[0], 2 * K + 2
    exps += 3 * corners + 2 * m * T
    flops = 10 * exps + 20 * corners + (80 * corners if hi else 0)
    nbytes = T * (4 + 8 + 8 + 4) + 4 * buf_len * buf_len + T * 16
    return bound(exps, flops, nbytes, rate)


# the lattice probe (ops/day_kernel.lattice_probe): every corner of one
# minute's lattice, for each rho (Genz's 6-, 12- and 20-node rules and the
# series, the node rule of every launch), three diffusions (the Kalbar
# default, the prior's narrowest, and one of a few metres whose corners
# reach hundreds of sigmas, the far tails) and three mean offsets (the
# centre, a sub-cell offset, 0.9 and -0.6 of the window's reach), at
# K = 6, 44, 88.  On the series (|rho| >= 0.925) every corner through the
# kernel's exact division against the IEEE division: no word may differ.
# On the low branches every corner against its float64 twin within
# low_corner_gap's bound.
PROBE_RHOS = (0.0, 0.253, -0.253, 0.5, -0.5, 0.9, -0.9, 0.93, -0.93, -0.99)
PROBE_SIGMAS = ((171.82, 144.58), (21.1, 10.6), (3.0, 2.0))
PROBE_KS = (6, 44, 88)
PROBE_CELL = 25.0
F32_EPS = 2.0 ** -23                      # an ulp is at most this share


def probe_cases(K, dev):
    """(Dparams (P, 3), mu (P, 2)) of the lattice probe at half-width K."""
    reach = K * PROBE_CELL
    rows, mus = [], []
    for rho in PROBE_RHOS:
        for sx, sy in PROBE_SIGMAS:
            for off in ((0.0, 0.0), (12.5, -7.3), (0.9 * reach,
                                                    -0.6 * reach)):
                rows.append((sx, sy, rho))
                mus.append(off)
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.tensor(rows, **f32), torch.tensor(mus, **f32)


def f32_fma(x, y, z):
    """fma(x, y, z) in f32, elementwise in numpy: x y + z rounded once.
    The product of two f32 values is exact in f64, its sum with z is
    carried exactly as s + err (TwoSum), and a sum s that lies on a
    midpoint of two f32 values rounds by the sign of err."""
    x, y, z = (np.asarray(v, np.float32).astype(np.float64)
               for v in (x, y, z))
    p = x * y
    s = p + z
    bz = s - p
    err = (p - (s - bz)) + (z - bz)
    r = s.astype(np.float32)
    lo = np.where(r.astype(np.float64) <= s, r,
                  np.nextafter(r, np.float32(-np.inf)))
    hi = np.nextafter(lo, np.float32(np.inf))
    mid = (s - lo.astype(np.float64)) == (hi.astype(np.float64) - s)
    return np.where(mid & (err > 0), hi, np.where(mid & (err < 0), lo, r))


def corner_hk_hs(h, k):
    """The kernel's f32 h k and (h^2 + k^2) / 2 at corners (h, k), rounded
    as csrc/day_kernel.cu's upper_low_run rounds them."""
    h, k = np.asarray(h, np.float32), np.asarray(k, np.float32)
    return h * k, f32_fma(h, h, k * k) * np.float32(0.5)


def low_corner_gap(lattice, edges, q, G):
    """(|U - U64|, bound) at every corner of one low-branch minute of the
    probe: ``lattice`` (m, m) block_build's corners, ``edges`` (4, m) its
    f32 xe, ye, Phi(-xe), Phi(-ye), ``q`` the minute's packed constants
    row, G its Genz tier's node count.  U64 is the float64 twin of the
    plain op's corner (ops/bvn.py _upper_lowcorr) from the kernel's own f32
    inputs: hk and hs as the kernel rounds them, the packed sn, w,
    1 - sn^2 and asr / (4 pi), the edges and their Phi.  The bound: each
    node term w e, e = exp(x), within (|x2| + 6) 2^-23 of itself, x2 = x
    log2(e) the MUFU's argument (test_torch_lattice_division's CPU bound,
    |x2| 2^-23 + 4 ulp, plus the 2 ulp of ex2.approx; the whole term where
    x2 < -125, since ex2.approx.ftz flushes results below 2^-126); the
    G fused adds, the closing multiply, the product Phi(-h) Phi(-k) and
    the final add each one f32 rounding of what they round; 2^-20 of the
    bound and 4 times the least subnormal for what is left."""
    from parasitoids_tpu_torch.ops.day_kernel import LAYOUT
    off = {6: 0, 12: 6, 20: 18}[G]
    f64 = np.float64
    xe, ye, px, py = np.asarray(edges, np.float32)
    h, k = xe[None, :], ye[:, None]                  # row r, column c
    hk, hs = corner_hk_hs(h, k)

    def row(name):
        return q[LAYOUT[name] + off:LAYOUT[name] + off + G].astype(f64)
    sn, w, den = row('kLoSn'), row('kLoW'), row('kLoDen')
    x = (sn * hk.astype(f64)[..., None] - hs.astype(f64)[..., None]) / den
    x2 = x * np.log2(np.e)
    terms = w * np.exp(x)
    per = np.where(x2 < -125.0, 1.0, (np.abs(x2) + 6.0) * F32_EPS)
    total = terms.sum(-1)
    asr4pi = abs(f64(q[LAYOUT['kAsr4Pi']]))
    phi = px.astype(f64)[None, :] * py.astype(f64)[:, None]
    u64 = phi + f64(q[LAYOUT['kAsr4Pi']]) * total
    half = F32_EPS / 2
    tot_gap = (terms * per).sum(-1) + G * half * (terms * (1 + per)).sum(-1)
    bound = (asr4pi * (tot_gap * (1 + half) + half * total) +
             half * (phi + np.abs(u64))) * (1 + 2.0 ** -20) + 4 * 2.0 ** -149
    return np.abs(np.asarray(lattice, np.float32).astype(f64) - u64), bound


def check_lattice_probe(dev):
    """The probe at PROBE_KS; fails on any word of the series that differs
    from the IEEE division's, and on any low-branch corner farther from
    its float64 twin than low_corner_gap's bound.  Prints the counts and,
    per Genz tier, the largest gap over its bound."""
    from parasitoids_tpu_torch.ops.bvn import genz_branch
    from parasitoids_tpu_torch.ops.day_kernel import (_pack_constants,
                                                      lattice_probe)
    tot = dict(differ=0, corners=0, ieee=0, bwd_vs_fwd=0)
    want = 0
    worst = {6: 0.0, 12: 0.0, 20: 0.0}
    low = 0
    for K in PROBE_KS:
        Dp, mu = probe_cases(K, dev)
        out = lattice_probe(Dp, mu, PROBE_CELL, K)
        for k in tot:
            tot[k] += out[k]
        want += Dp.shape[0] * (2 * K + 2) ** 2
        q = _pack_constants(Dp, PROBE_CELL, dev).cpu().numpy()
        lat, edges = out['lattice'].cpu().numpy(), out['edges'].cpu().numpy()
        for i, rho in enumerate(Dp[:, 2].tolist()):
            branch = genz_branch(abs(rho))
            if branch == 3:
                continue
            G = (6, 12, 20)[branch]
            gap, bound = low_corner_gap(lat[i], edges[i], q[i], G)
            low += int((gap > bound).sum())
            worst[G] = max(worst[G], float((gap / bound).max()))
    print('  lattice probe (Genz rule, K = {}): {} corners, {} differing '
          'words on the series, {} corners on the IEEE division (out of the '
          'exact division\'s range), {} corners where block_bwd\'s value '
          "differs from block_build's; low branches against their float64 "
          'twin: {} corners past the bound, largest gap / bound by node '
          'count {}'.format(', '.join(map(str, PROBE_KS)), tot['corners'],
                            tot['differ'], tot['ieee'], tot['bwd_vs_fwd'],
                            low, {G: round(v, 4) for G, v in worst.items()}))
    check(tot['corners'] == want and tot['differ'] == 0,
          'lattice probe (Genz rule): the exact division gives the IEEE '
          "division's bits at every corner of the series, forward and "
          'backward ({} corners probed)'.format(want))
    check(low == 0, 'lattice probe: every low-branch corner within its '
          'bound of the float64 twin')
    return tot


def check_packed_reciprocals(dev):
    """The reciprocal rows packed on the card are the f32 IEEE quotients
    1 / d of their divisors, and the exponent scales and asr / (4 pi) the
    f32 roundings of their f64 quotients, bit for bit (numpy on the
    host)."""
    from parasitoids_tpu_torch.ops.day_kernel import LAYOUT, _pack_constants
    Dp, _ = probe_cases(44, dev)
    q = _pack_constants(Dp, 25.0, dev).cpu().numpy()
    f = np.float32
    rs = q[:, LAYOUT['kHiRs']:LAYOUT['kHiRs'] + 20]
    pairs = [('kHiXs', 'kHiInvXs', 20), (None, 'kHiInvEp', 20),
             ('kHiRs', 'kHiInvRs', 20)]
    bad = 0
    for d_at, r_at, n in pairs:
        d = f(2) * (f(1) + rs) if d_at is None else \
            q[:, LAYOUT[d_at]:LAYOUT[d_at] + n]
        r = q[:, LAYOUT[r_at]:LAYOUT[r_at] + n]
        bad += int(((f(1) / d).view(np.uint32) != r.view(np.uint32)).sum())
    for d_at, r_at in ((LAYOUT['kA'], LAYOUT['kInvA']),
                       (LAYOUT['kASq'], LAYOUT['kInvASq'])):
        bad += int(((f(1) / q[:, d_at]).view(np.uint32) !=
                    q[:, r_at].view(np.uint32)).sum())
    den = q[:, LAYOUT['kLoDen']:LAYOUT['kLoDen'] + 38].astype(np.float64)
    scale = q[:, LAYOUT['kLoL2Den']:LAYOUT['kLoL2Den'] + 38]
    bad += int(((np.log2(np.e) / den).astype(f).view(np.uint32) !=
                scale.view(np.uint32)).sum())
    asr = q[:, LAYOUT['kAsr']].astype(np.float64)
    bad += int(((asr / (4 * np.pi)).astype(f).view(np.uint32) !=
                q[:, LAYOUT['kAsr4Pi']].view(np.uint32)).sum())
    check(bad == 0, 'the reciprocals, exponent scales and asr / (4 pi) '
          'packed on the card are the f32 roundings of their quotients ({} '
          'rows of {} floats)'.format(q.shape[0], q.shape[1]))


def kalbar_params(pop=True):
    from parasitoids_tpu_torch.config import Params
    p = Params()
    p.cmd_line_chg(['--kalbar'] + (['--pop'] if pop else []))
    p.PLOT = p.OUTPUT = False
    return p


def phase_kernel_vs_plain(dev, card, rate):
    """K1/K2 against the plain accumulate on days 0, 9, 17 of Kalbar at
    the headline shapes, two launches bitwise equal; at day 9, the
    kernels' passes timed alone beside the wrapper, the plain version and
    the bound.  Returns (max errors, timings)."""
    from parasitoids_tpu_torch.models.forward import (prior_coverage_windows,
                                                      setup_forward)
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day,
                                                      accumulate_day_plain,
                                                      pack_constants, pass_ms)
    print('[3] kernel vs plain on the card (D = 801, T = 1440, K = 44)')
    check_packed_reciprocals(dev)
    check_lattice_probe(dev)
    p = kalbar_params()
    cell = p.domain_info[0] / p.domain_info[1]
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    s = setup_forward(p, device=dev)
    K = s.kcfg.K
    buf_len = s.scfg.dom_len + 4 * K
    check((K, s.kcfg.periods, buf_len) == (44, 1440, 977),
          'headline shapes K = 44, T = 1440, buf = 977')
    hp = (p.lam, *p.g_params, *p.f_params)
    err = {'K1': 0.0, 'K2': 0.0, 'rel': 0.0}
    timing = {}
    for day in (0, 9, 17):
        h, mu, idx, clip, _ = day_scatter_inputs(
            s.wind_flat, s.wind_cumsum, day, hp, p.mu_r, p.n_periods, 0,
            s.kcfg, s.rad_dist)
        for rho in (0.253, 0.93, -0.93, 0.99, -0.99):
            Dp = (p.Dparams[0], p.Dparams[1], rho)
            args = (h, mu, idx, clip, Dp, cell, K, buf_len)
            buf, loss = accumulate_day(*args)
            again, loss_again = accumulate_day(*args)
            want_buf, want_loss = accumulate_day_plain(*args)
            torch.cuda.synchronize()
            branch = 'K2' if abs(rho) >= 0.925 else 'K1'
            check(torch.equal(buf, again) and torch.equal(loss, loss_again),
                  'day {:2d} rho {:+.3f} ({}): two launches bitwise equal'
                  .format(day, rho, branch))
            be = float((buf - want_buf).abs().max())
            le = abs(float(loss) - float(want_loss))
            peak = float(want_buf.max())
            e, rel = max(be, le), be / peak
            tol = min(ABS_LIMIT, HI_TOL if branch == 'K2' else BUF_TOL)
            check(np.isfinite(e) and e <= tol and peak > 0 and
                  rel <= REL_LIMIT,
                  'day {:2d} rho {:+.3f} ({}): max |kernel - plain| = {:.3e}'
                  ' (buffer {:.3e}, loss {:.3e}) <= {:.0e}; / peak {:.4e} = '
                  '{:.3e} <= {:.0e}'.format(day, rho, branch, e, be, le, tol,
                                            peak, rel, REL_LIMIT))
            err[branch] = max(err[branch], e)
            err['rel'] = max(err['rel'], rel)
            if day == 9 and rho in (0.253, 0.99):
                passes = pass_ms(*args, reps=20)
                consts = pack_constants(Dp, cell, dev)
                t = dict(ms=median_ms(lambda: accumulate_day(*args), 20),
                         ms_hoisted=median_ms(lambda: accumulate_day(
                             *args, consts=consts), 20),
                         plain_ms=median_ms(
                             lambda: accumulate_day_plain(*args), 5),
                         passes=np.median(passes, axis=0).tolist(),
                         kernel_ms=float(np.median(passes.sum(axis=1))))
                t['bound_ms'], t['bound_by'], what = forward_bound(
                    h, mu, Dp, cell, K, buf_len, rate)
                timing[branch] = t
                print('  day 9 {}: kernels {:.4f} ms (block_build {:.4f}, '
                      'gather {:.4f}, reduce {:.4f}; CUDA events around the '
                      'kernels alone, median of 20); wrapper {:.4f} ms '
                      '({:.4f} ms given the constants packed once, as the '
                      'day loop gives them); plain {:.4f} ms; bound {:.4f} '
                      'ms by {} ({}), bound / kernels {:.3f} ({})'.format(
                          branch, t['kernel_ms'], *t['passes'], t['ms'],
                          t['ms_hoisted'], t['plain_ms'], t['bound_ms'],
                          t['bound_by'], what, t['bound_ms'] / t['kernel_ms'],
                          card))
    return err, timing


def phase_goldens(dev):
    """The three checked-in goldens through the kernel, at the
    test_golden.py tolerances."""
    from parasitoids_tpu_torch.config import Params
    from parasitoids_tpu_torch.io import load_run
    from parasitoids_tpu_torch.models.forward import simulate, setup_forward
    from parasitoids_tpu_torch.ops import day_kernel
    print('[4] goldens through the kernel')
    for name, pop, site, ndays in (('kalbar_prob_tiny', False, '--kalbar', 4),
                                   ('kalbar_pop_tiny', True, '--kalbar', 4),
                                   ('carnarvon_pop_tiny', True, '--carnarvon',
                                    7)):
        want, want_days = load_run(os.path.join(GOLDEN, name), 201)
        p = Params()
        p.cmd_line_chg([site])
        p.PLOT = p.OUTPUT = False
        p.PROB_MODEL = not pop
        p.ndays, p.domain_info, p.interp_num = ndays, (4000.0, 100), 6
        p.kernel_rad, p.kernel_rad_local = 20, 6
        s = setup_forward(p, device=dev)
        check(s.kcfg.pallas, name + ': setup takes the CUDA kernel')
        before = day_kernel.LAUNCHES
        fields, days = simulate(p, s)
        got = fields.cpu().numpy()
        check(day_kernel.LAUNCHES - before == ndays,
              '{}: {} kernel launches for {} days'.format(
                  name, day_kernel.LAUNCHES - before, ndays))
        check(list(days) == list(want_days), name + ': day labels')
        scale = max(want.max(), 1e-30)
        e = float(np.abs(got - want).max() / scale)
        check(e <= 2e-5, '{}: max |port - golden| / peak = {:.3e} <= 2e-5'
              .format(name, e))
        m = float(np.max(np.abs(got.sum(axis=(1, 2)) - want.sum(axis=(1, 2)))
                         / want.sum(axis=(1, 2))))
        check(m <= 1e-4, '{}: day mass rel diff {:.3e} <= 1e-4'.format(name,
                                                                       m))
        if site == '--carnarvon':
            r = float(np.max(np.abs(got.sum(axis=(1, 2))[:3] / p.r_number
                                    - 1.0)))
            check(r <= 2e-5, '{}: release-ramp totals rel diff {:.3e} <= '
                  '2e-5'.format(name, r))


def check_pop_sums(sums, r_number, label):
    check(bool(np.isfinite(sums).all()), label + ': finite day sums')
    check(abs(sums[0] / r_number - 1.0) <= 1e-4,
          '{}: day 0 holds the release ({:.1f} of {})'.format(
              label, sums[0], r_number))
    check(bool(np.all(np.diff(sums) <= sums[:-1] * 1e-4)),
          label + ': day sums never grow')
    check(sums[-1] >= 0.95 * r_number,
          '{}: slow loss off the 10 km domain, last day {:.1f} ({:.2%} '
          'lost)'.format(label, sums[-1], 1 - sums[-1] / r_number))


def phase_main_path(dev, card):
    """The CLI run, forward_fields at the bench config, and the prob model,
    with every kernel count zeroed just before and read just after."""
    from parasitoids_tpu_torch import cli
    from parasitoids_tpu_torch.models.forward import (forward_fields,
                                                      prior_coverage_windows,
                                                      setup_forward, simulate)
    from parasitoids_tpu_torch.ops import day_kernel
    print('[5] main path')
    day_kernel.LAUNCHES = 0

    # the CLI at the Kalbar default (801^2, 18 days, auto K)
    before = day_kernel.LAUNCHES
    fields, days = cli.main(argv=['--pop', '--no_plot', '--no_output'],
                            device=dev)
    nd = len(days)
    check(day_kernel.LAUNCHES - before == nd,
          'CLI: {} kernel launches for {} days'.format(
              day_kernel.LAUNCHES - before, nd))
    check(tuple(fields.shape) == (nd, 801, 801) and nd == 18,
          'CLI: fields {}'.format(tuple(fields.shape)))
    check_pop_sums(fields.sum(dim=(1, 2)).double().cpu().numpy(), 130000,
                   'CLI')

    # forward_fields at the prior-coverage windows (K = 44, Kl = 20)
    p = kalbar_params()
    cell = p.domain_info[0] / p.domain_info[1]
    p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
    s = setup_forward(p, device=dev)
    hp = (p.lam, *p.g_params, *p.f_params)
    w = torch.as_tensor(s.dist_weights, dtype=torch.float32).to(dev)

    def run():
        return forward_fields(s.wind_flat, s.wind_cumsum, hp, p.Dparams,
                              p.Dlparams, p.mu_r, p.n_periods, s.rad_dist,
                              s.start_idx, float(p.r_number), w, s.kcfg,
                              s.scfg, s.ndays, int(p.r_dur), False)

    secs = []
    for i in range(4):          # one warm-up, three timed
        before = day_kernel.LAUNCHES
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        per_sim = day_kernel.LAUNCHES - before
        if i:
            secs.append(time.perf_counter() - tic)
            check(per_sim == s.ndays,
                  'forward_fields run {}: {} launches for {} days'.format(
                      i, per_sim, s.ndays))
    check_pop_sums(out.sum(dim=(1, 2)).double().cpu().numpy(), p.r_number,
                   'forward_fields K = 44')
    sec = float(np.median(secs))
    print('  forward_fields (pop, 801^2, 18 days, K = 44, Kl = 20): '
          '{:.4f} s/simulation, {:.1f} simulations/hr (median of 3; {})'
          .format(sec, 3600.0 / sec, card))

    # the probability model at the Kalbar default
    pp = kalbar_params(pop=False)
    before = day_kernel.LAUNCHES
    fields, days = simulate(pp, device=dev)
    check(day_kernel.LAUNCHES - before == len(days),
          'prob model: {} launches for {} days'.format(
              day_kernel.LAUNCHES - before, len(days)))
    sums = fields.sum(dim=(1, 2)).double().cpu().numpy()
    check(bool(np.isfinite(fields.cpu().numpy()).all()) and
          bool(np.all(np.abs(sums - 1.0) <= 1e-4)),
          'prob model: every day sums to 1 +- 1e-4 (worst {:.2e})'.format(
              float(np.abs(sums - 1.0).max())))
    return day_kernel.LAUNCHES, sec, per_sim


BWD_NAMES = ('dh', 'dmu', 'dclip', 'dsig_x', 'dsig_y', 'drho', 'dcell')


def backward_outputs(out):
    dh, dmu, dclip, dD, dcell = out
    return [dh, dmu, dclip, *dD, dcell]


def backward_vs_plain(args, label, f64=False):
    """One backward through the kernel, twice, and through the plain
    version: the launches bitwise equal and every output within its atol
    + BWD_RTOL * scale.  With ``f64`` the plain version runs in f64 on the
    same f32 inputs, and the distance of the f32 plain version from it is
    printed beside the kernel's.  Returns (worst error over scale, worst
    absolute error)."""
    from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day_bwd,
                                                      accumulate_day_bwd_plain)
    got = accumulate_day_bwd(*args)
    again = accumulate_day_bwd(*args)
    plain = accumulate_day_bwd_plain(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          label + ': two launches bitwise equal')
    got, want = backward_outputs(got), backward_outputs(plain)
    if f64:
        ct_buf, ct_loss, h, mu, idx, clip, Dp, cell, K, buf_len = args
        up = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                       device=h.device).double()
        want = backward_outputs(accumulate_day_bwd_plain(
            up(ct_buf), up(ct_loss), up(h), up(mu), idx, up(clip), up(Dp),
            up(cell), K, buf_len))
    scales = [float(w.abs().max()) for w in want]
    scales[2] = float((args[1] * args[2]).abs().max())      # ct_loss * h
    errs = []
    for name, g, w, sc in zip(BWD_NAMES, got, want, scales):
        e = float((g - w).abs().max())
        errs.append((name, e, e / max(sc, 1e-30),
                     e <= BWD_ATOL[name] + BWD_RTOL * sc))
    ok = all(np.isfinite(e) and inside for _, e, _, inside in errs)
    ref = 'f64 plain' if f64 else 'plain'
    msg = '{}: every output within its atol + {:.0e} * scale; |kernel - ' \
        '{}| (/ scale): {}'.format(
            label, BWD_RTOL, ref, ', '.join(
                '{} {:.2e} ({:.2e})'.format(n, e, r) for n, e, r, _ in errs))
    if f64:
        msg += '; |f32 plain - f64 plain| (/ scale): ' + ', '.join(
            '{} {:.2e} ({:.2e})'.format(
                n, float((p - w).abs().max()),
                float((p - w).abs().max()) / max(sc, 1e-30))
            for n, p, w, sc in zip(BWD_NAMES, backward_outputs(plain), want,
                                   scales))
    check(ok, msg)
    return max(r for _, _, r, _ in errs), max(e for _, e, _, _ in errs)


def phase_backward_vs_plain(dev, card, rate):
    """K3/K4 against the plain backward on days 0, 9, 17 of Kalbar at the
    headline shapes, a seeded white-noise cotangent, two launches bitwise
    equal; at day 9, the two launches timed alone beside the wrapper, the
    plain version and the bound; then one day at K = 88 (12.5 m cells),
    wider than any lattice that fits shared memory whole, against the
    plain version run in f64.  A cell of the block is a difference of four
    lattice values of order 1, so its f32 rounding is about 1e-7 whatever
    the cell's mass (1e-3 at most at K = 88), in the kernel and in the f32
    plain version alike; white noise contracts that rounding over 177²
    cells into dh, and two f32 results then stand a whole BWD_RTOL apart
    while each is nearer to f64: the f64 reference leaves the limit to the
    kernel alone.  Returns (worst error over scale, abs error, timings)."""
    from parasitoids_tpu_torch.models.forward import (prior_coverage_windows,
                                                      setup_forward)
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    from parasitoids_tpu_torch.ops.day_kernel import (accumulate_day_bwd,
                                                      accumulate_day_bwd_plain,
                                                      pack_constants,
                                                      pass_ms_bwd)
    print('[6] backward kernel vs plain on the card (D = 801, T = 1440, '
          'K = 44)')
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {'K3': 0.0, 'K4': 0.0}
    worst_abs = {'K3': 0.0, 'K4': 0.0}
    timing = {}
    for rad_res, days, rhos in ((400, (0, 9, 17), (0.253, 0.5, 0.8, 0.93,
                                                   -0.93, 0.99, -0.99)),
                                (800, (9,), (0.253,))):
        p = kalbar_params()
        p.domain_info = (p.domain_info[0], rad_res)
        cell = p.domain_info[0] / rad_res
        p.kernel_rad, p.kernel_rad_local = prior_coverage_windows(cell)
        s = setup_forward(p, device=dev)
        K = s.kcfg.K
        buf_len = s.scfg.dom_len + 4 * K
        check((K, s.kcfg.periods, buf_len) == {400: (44, 1440, 977),
                                               800: (88, 1440, 1953)}[rad_res],
              'cells of {} m: K = {}, T = {}, buf = {}'.format(
                  cell, K, s.kcfg.periods, buf_len))
        hp = (p.lam, *p.g_params, *p.f_params)
        ct_buf = torch.randn((buf_len, buf_len), generator=gen, device=dev)
        ct_loss = torch.randn((), generator=gen, device=dev)
        for day in days:
            h, mu, idx, clip, _ = day_scatter_inputs(
                s.wind_flat, s.wind_cumsum, day, hp, p.mu_r, p.n_periods, 0,
                s.kcfg, s.rad_dist)
            for rho in rhos:
                Dp = (p.Dparams[0], p.Dparams[1], rho)
                args = (ct_buf, ct_loss, h, mu, idx, clip, Dp, cell, K,
                        buf_len)
                branch = 'K4' if abs(rho) >= 0.925 else 'K3'
                rel, err = backward_vs_plain(
                    args, 'K = {} day {:2d} rho {:+.3f} ({})'.format(
                        K, day, rho, branch), f64=K != 44)
                worst[branch] = max(worst[branch], rel)
                worst_abs[branch] = max(worst_abs[branch], err)
                if K != 44 or day != 9 or rho not in (0.253, 0.99):
                    continue
                passes = pass_ms_bwd(*args, reps=20)
                consts = pack_constants(Dp, cell, dev)
                t = dict(ms=median_ms(lambda: accumulate_day_bwd(*args), 20),
                         ms_hoisted=median_ms(lambda: accumulate_day_bwd(
                             *args, consts=consts), 20),
                         plain_ms=median_ms(
                             lambda: accumulate_day_bwd_plain(*args), 5),
                         passes=np.median(passes, axis=0).tolist(),
                         kernel_ms=float(np.median(passes.sum(axis=1))))
                t['bound_ms'], t['bound_by'], what = backward_bound(
                    h, mu, Dp, cell, K, buf_len, rate)
                timing[branch] = t
                print('  day 9 {}: kernels {:.4f} ms (block_bwd {:.4f}, '
                      'bwd_reduce {:.4f}; CUDA events around the kernels '
                      'alone, median of 20); wrapper {:.4f} ms ({:.4f} ms '
                      'given the forward\'s row of constants); plain {:.4f} '
                      'ms; bound {:.4f} ms by {} ({}), bound / kernels {:.3f} '
                      '({})'.format(
                          branch, t['kernel_ms'], *t['passes'], t['ms'],
                          t['ms_hoisted'], t['plain_ms'], t['bound_ms'],
                          t['bound_by'], what, t['bound_ms'] / t['kernel_ms'],
                          card))
    return worst, worst_abs, timing


def value_and_grad(neg_logpost, z0):
    z = z0.clone().requires_grad_()
    v = neg_logpost(z)
    v.backward()
    return float(v.detach()), z.grad.detach().double().cpu().numpy()


def timed(fn, reps=3):
    """Median host seconds of ``fn`` (ending in a synchronize) after one
    warm-up run."""
    fn()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - tic)
    return float(np.median(secs))


def phase_posterior_gradient(dev, card):
    """Value and gradient of the log posterior at the Bayes default (801²,
    25 m, K = 44, Kl = 20, 18 days, pre-spread day) through K1-K4 and on
    the plain path; returns (seconds per value, per value+gradient, peak
    bytes)."""
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import (BayesSetup,
                                                   _kalbar_default_params)
    from parasitoids_tpu_torch.ops import day_kernel
    print('[7] log-posterior gradient at the Bayes default (801^2, '
          '18 days, K = 44, Kl = 20, pre-spread day)')
    runs = {}
    for path, use_pallas in (('kernels', None), ('plain', False)):
        p = _kalbar_default_params()
        p.use_pallas = use_pallas
        setup = BayesSetup(p, device=dev)
        check(setup.setup.kcfg.pallas == (use_pallas is None),
              '{}: accumulate path {}'.format(path, 'CUDA kernels'
                                              if setup.setup.kcfg.pallas
                                              else 'plain torch'))
        check((setup.setup.kcfg.K, setup.setup.kcfg.K_local,
               setup.ndays) == (44, 20, 18), path + ': K = 44, Kl = 20, '
              '18 days')
        neg, _, _ = map_fit._make_objective(setup, True)
        z0 = map_fit.initial_z(setup, True)
        before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        runs[path] = value_and_grad(neg, z0)
        torch.cuda.synchronize()
        n_fwd = day_kernel.LAUNCHES - before[0]
        n_bwd = day_kernel.LAUNCHES_BWD - before[1]
        want = (18, 18) if path == 'kernels' else (0, 0)
        check((n_fwd, n_bwd) == want, '{}: {} forward and {} backward '
              'kernel launches for one value+gradient'.format(path, n_fwd,
                                                              n_bwd))
        if path == 'kernels':
            torch.cuda.reset_peak_memory_stats(dev)
            runs[path] = value_and_grad(neg, z0)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            with torch.no_grad():
                sec_v = timed(lambda: neg(z0))
            sec_vg = timed(lambda: value_and_grad(neg, z0))
            print('  {}: {:.4f} s per value, {:.4f} s per value+gradient '
                  '(median of 3), peak {:.1f} MiB allocated for one '
                  'value+gradient ({})'.format(path, sec_v, sec_vg,
                                               peak / 2 ** 20, card))
        else:
            sec_plain = timed(lambda: value_and_grad(neg, z0), reps=1)
            print('  plain: {:.4f} s per value+gradient ({})'.format(
                sec_plain, card))
    (vk, gk), (vp, gp) = runs['kernels'], runs['plain']
    dv = abs(vk - vp) / abs(vp)
    l2 = float(np.linalg.norm(gk - gp) / np.linalg.norm(gp))
    dg, gmax = np.abs(gk - gp), np.abs(gp).max()
    comp = dg / np.maximum(np.abs(gp), 1e-30)
    print('  value kernels {!r} plain {!r}; gradient (plain): {}; '
          'per-component |dg|/|g|: {}'.format(
              vk, vp, np.array2string(gp, precision=3),
              np.array2string(comp, precision=2)))
    check(np.isfinite(vk) and np.all(np.isfinite(gk)) and
          dv <= GRAD_VALUE_RTOL and l2 <= GRAD_L2_LIMIT,
          'kernels vs plain: value rel diff {:.3e} <= {:.0e}, gradient '
          'relative L2 {:.3e} <= {:.0e}'.format(dv, GRAD_VALUE_RTOL, l2,
                                                GRAD_L2_LIMIT))
    inside = dg <= GRAD_COMP_RTOL * np.abs(gp) + GRAD_COMP_ATOL * gmax
    check(bool(np.all(inside)), 'kernels vs plain: every gradient component '
          'within {:.0e} of its magnitude + {:.0e} of the largest (worst '
          '{:.3e} of its magnitude, component {})'.format(
              GRAD_COMP_RTOL, GRAD_COMP_ATOL, float(comp.max()),
              int(comp.argmax())))
    return sec_v, sec_vg, peak, sec_plain, dv, l2


def phase_map_cli(dev, card):
    """The MAP CLI at its default (401², 50 m, K = 22, Kl = 10, 18 days,
    sprd_factor fitted) for 5 Adam steps, with both kernel counts zeroed
    just before and read just after, then its value and gradient at the
    initial z against the JAX golden."""
    import tempfile
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    from parasitoids_tpu_torch.ops import day_kernel
    print('[8] MAP CLI at its default (401^2, 18 days, K = 22, Kl = 10)')
    steps = 5
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'map_fit.txt')
        day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fit = map_fit.main(['--MAP', '--steps', str(steps), '-o', out],
                           device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - tic
        launches = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        check(os.path.getsize(out) > 0 and
              open(out).readline().startswith('MAP fit: logp ='),
              'report written ({} bytes)'.format(os.path.getsize(out)))
    losses = fit['losses']
    check(losses.shape == (steps,) and bool(np.all(np.isfinite(losses))),
          'loss finite at every step: ' + np.array2string(losses))
    check(losses[-1] < losses[0], 'loss falls: {:.4f} -> {:.4f}'.format(
        losses[0], losses[-1]))
    # each step is one value+gradient; the final log posterior one value
    check(launches == ((steps + 1) * 18, steps * 18),
          '{} forward and {} backward launches for {} steps of 18 days'
          .format(*launches, steps))
    print('  {:.4f} s per MAP step including setup ({} steps in {:.2f} s; '
          '{})'.format(sec / steps, steps, sec, card))

    golden = np.load(GRAD_GOLDEN)
    setup = BayesSetup(map_fit.map_cli_params(), device=dev)
    check((setup.setup.kcfg.K, setup.setup.kcfg.K_local, setup.ndays,
           tuple(golden['domain_info'])) == (int(golden['K']),
                                              int(golden['K_local']),
                                              int(golden['ndays']),
                                              (10000.0, 200.0)),
          'golden configuration: 401^2, K = 22, Kl = 10, 18 days')
    neg, _, _ = map_fit._make_objective(setup, True)
    z0 = torch.as_tensor(golden['z0'], device=dev)
    dz = float((map_fit.initial_z(setup, True) - z0).abs().max())
    check(dz <= 1e-6, 'the port\'s initial z is the golden z0 to {:.1e} '
          '(f32 rounding of the bijections)'.format(dz))
    v, g = value_and_grad(neg, z0)
    sec_vg = timed(lambda: value_and_grad(neg, z0))
    want_v, want_g = float(golden['value']), golden['grad']
    dv = abs(v - want_v) / abs(want_v)
    l2 = float(np.linalg.norm(g - want_g) / np.linalg.norm(want_g))
    comp = np.abs(g - want_g) / np.abs(want_g).max()
    print('  value {!r} (JAX {!r}); per-component |dg| / max|g|: {}'.format(
        v, want_v, np.array2string(comp, precision=2)))
    print('  {:.4f} s per value+gradient at 401^2 (median of 3; {})'.format(
        sec_vg, card))
    check(dv <= GOLDEN_VALUE_RTOL and l2 <= GOLDEN_L2_LIMIT and
          float(comp.max()) <= GOLDEN_COMP_LIMIT,
          'JAX golden: value rel diff {:.3e} <= {:.0e}, gradient relative '
          'L2 {:.3e} <= {:.0e}, worst component {:.3e} <= {:.0e} of the '
          'largest'.format(dv, GOLDEN_VALUE_RTOL, l2, GOLDEN_L2_LIMIT,
                           float(comp.max()), GOLDEN_COMP_LIMIT))
    return launches, sec / steps, sec_vg, dv, l2


def flat_proj(proj):
    return torch.cat([p.reshape(-1) for p in (*proj[0], *proj[1], proj[2])])


def states_equal(a, b):
    """Two stacked chain states bitwise equal, generators included."""
    tensors = all(torch.equal(getattr(a, f), getattr(b, f))
                  for f in a._fields if f not in ('key', 'proj'))
    keys = all(torch.equal(x.get_state(), y.get_state())
               for x, y in zip(a.key, b.key))
    return tensors and keys and torch.equal(flat_proj(a.proj),
                                            flat_proj(b.proj))


def count_host_reads(fn):
    """Run ``fn`` with every synchronizing CUDA call reported as a
    warning; returns (result, the calls' places in this repository)."""
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if 'called a synchronizing' in str(message):
            here = [f for f in traceback.extract_stack()
                    if f.filename.startswith(ROOT)]
            seen.append(' <- '.join('{}:{}'.format(
                os.path.relpath(f.filename, ROOT), f.lineno)
                for f in reversed(here[-4:-1])))

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        old_show, warnings.showwarning = warnings.showwarning, record
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
            warnings.showwarning = old_show
    return out, seen


def phase_am_cli(dev, card, work):
    """The AM CLI at the Bayes default (801², 25 m, K = 44, Kl = 20,
    18 days, no pre-spread day): a new run of two chains with a checkpoint,
    then a resume, with the forward kernel's count zeroed just before and
    read just after; exact resume on the card; the initial log likelihood
    through K1 against the plain accumulate; a step's host reads; seconds
    per step.  The store stays in ``work`` for [13].  Returns (launches,
    forwards, seconds per step, per model block, per sweep, launches per
    step, device busy seconds per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import sampler
    from parasitoids_tpu_torch.bayes.store import load_chain, save_chain
    from parasitoids_tpu_torch.ops import day_kernel
    from parasitoids_tpu_torch.parallel.chains import run_chains
    print('[9] AM CLI at the Bayes default (801^2, 18 days, K = 44, '
          'Kl = 20, two chains)')
    meta_keys = {'n_samples', 'burn', 'chains', 'obs_sweeps', 'obs_model',
                 'sampler', 'seed', 'device'}
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(work, 'am')

        def stored():
            with np.load(db + '.npz') as npz, open(db + '.meta.json') as fh:
                return ({k: npz[k] for k in npz.files}, json.load(fh))

        day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
        sampler.FORWARDS = 0
        bayes_run.main(['--new', '20', '10', db, '--chains', '2',
                        '--checkpoint-every', '15', '--seed', '0'],
                       device=dev)
        first, meta = stored()
        dim = first['traces'].shape[-1]
        check(first['traces'].shape == (2, 20, 26) and
              bool(np.isfinite(first['traces']).all()),
              '--new: traces {} finite'.format(first['traces'].shape))
        check(set(meta) == meta_keys and meta['n_samples'] == 20 and
              meta['device'] == 'cuda' and meta['sampler'] == 'am',
              '--new: meta {}'.format(json.dumps(meta)))
        bayes_run.main(['--resume', db, '10'], device=dev)
        torch.cuda.synchronize()
        launches, forwards = day_kernel.LAUNCHES, sampler.FORWARDS
        both, meta = stored()
        check(both['traces'].shape == (2, 30, dim) and
              bool(np.isfinite(both['traces']).all()) and
              np.array_equal(both['traces'][:, :20], first['traces']),
              '--resume: traces {} finite, the first 20 kept'.format(
                  both['traces'].shape))
        check(set(meta) == meta_keys and meta['n_samples'] == 30 and
              meta['burn'] == 10 and meta['obs_sweeps'] == 1,
              '--resume: meta {}'.format(json.dumps(meta)))
        acc = both['state_accepts_m']
        check(bool(np.all(both['state_count'] == 40)) and
              bool(np.all((acc >= 0) & (acc <= 40))),
              'each chain took 40 steps; block proposals accepted: {} and '
              '{}; obs moves accepted: {} and {} of 400'.format(
                  *acc, *both['state_accepts_o']))
        # two chains initialised, two reloaded, and every proposal of the
        # 80 steps whose prior was finite
        check(4 <= forwards <= 4 + 80 and launches == 18 * forwards and
              day_kernel.LAUNCHES_BWD == 0,
              '{} forward launches = 18 x {} forwards (4 + {} of 80 '
              'proposals inside the prior\'s support); no backward launch'
              .format(launches, forwards, forwards - 4))

        # exact resume on the card: some steps in memory, a save, a reload
        setup = bayes_run.build_setup(device=dev)
        cfg = sampler.MCMCConfig(5)
        _, states, _ = load_chain(db, setup)
        states, tr = run_chains(setup, states, sampler.MCMCConfig(3))
        db2 = os.path.join(tmp, 'again')
        save_chain(db2, tr, states)
        _, reloaded, _ = load_chain(db2, setup)
        check(states_equal(states, reloaded),
              'a reloaded state is the state in memory, bit for bit')
        s_a, tr_a = run_chains(setup, states, cfg)
        s_b, tr_b = run_chains(setup, reloaded, cfg)
        torch.cuda.synchronize()
        check(torch.equal(tr_a, tr_b) and states_equal(s_a, s_b),
              '5 steps from the reloaded state bitwise equal to 5 steps in '
              'memory (2 chains)')

        # the initial log likelihood through K1 against the plain
        # accumulate in f64, the f32 plain path's distance beside it
        others = [bayes_run.build_setup([ov], device=dev)
                  for ov in ('use_pallas=False', 'use_f64=True')]
        check(setup.setup.kcfg.pallas and
              not any(s.setup.kcfg.pallas for s in others) and
              others[1].setup.wind_flat.dtype == torch.float64 and
              (setup.setup.kcfg.K, setup.setup.kcfg.K_local, setup.ndays,
               setup.setup.scfg.dom_len) == (44, 20, 18, 801),
              'setups: CUDA kernel, plain torch and plain torch in f64, '
              'K = 44, Kl = 20, 18 days, 801^2')
        ll, ll_plain, ll_64 = [float(sampler.init_chain_state(
            s, sampler.chain_generator(0, 0, dev)).loglik)
            for s in (setup, *others)]
        d = abs(ll - ll_64) / abs(ll_64)
        check(np.isfinite(ll) and d <= AM_LOGLIK_RTOL,
              'initial loglik through K1 {!r}, plain in f64 {!r}: rel diff '
              '{:.3e} <= {:.0e} (plain in f32 {!r}: {:.3e} from f64, {:.3e} '
              'from K1)'.format(ll, ll_64, d, AM_LOGLIK_RTOL, ll_plain,
                                abs(ll_plain - ll_64) / abs(ll_64),
                                abs(ll_plain - ll) / abs(ll)))

        # host reads: none in the sweep, one per block proposal
        state = sampler.unstack_states(s_a)[0]
        n_moves = sampler._n_obs(setup)
        draws = sampler.draw_step(state.key, n_moves, state.m.dtype, dev)

        def sweep():
            with torch.no_grad():
                sampler._obs_sweep(setup, draws.obs_eps, draws.obs_log_u,
                                   state.o, state.prior_o, state.loglik,
                                   state.proj, 1.0, sampler.MCMCConfig(1))
        sweep()             # the first sweep captures the sweep's graph
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            sweep()
        finally:
            torch.cuda.set_sync_debug_mode('default')
        check(True, 'the observation sweep ({} moves) made no synchronizing '
              'call'.format(n_moves))
        n_steps = 4
        (state, _), reads = count_host_reads(
            lambda: sampler.run_mcmc(setup, state,
                                     sampler.MCMCConfig(n_steps)))
        for r in sorted(set(reads)):
            print('  host read x{}: {}'.format(reads.count(r), r))
        check(len(reads) == n_steps, '{} synchronizing calls in {} whole '
              'steps: one per block proposal'.format(len(reads), n_steps))

        # seconds per step and its split, CUDA events on the stream's
        # timeline read after one synchronize at the end
        marks = {'model': [], 'sweep': [], 'step': []}

        def timed_call(fn, key):
            def wrapper(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                marks[key].append((start, end))
                return out
            return wrapper

        real = (sampler._model_proposal, sampler._obs_sweep)
        sampler._model_proposal = timed_call(real[0], 'model')
        sampler._obs_sweep = timed_call(real[1], 'sweep')
        n_timed = 20
        try:
            before = (day_kernel.LAUNCHES, sampler.FORWARDS)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(n_timed):
                state, _ = timed_call(sampler._mcmc_step, 'step')(
                    setup, state, sampler.MCMCConfig(1))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - tic) / n_timed
        finally:
            sampler._model_proposal, sampler._obs_sweep = real
        med = {k: float(np.median([a.elapsed_time(b) for a, b in v])) * 1e-3
               for k, v in marks.items()}
        k1_per_step = (day_kernel.LAUNCHES - before[0]) / n_timed
        check(day_kernel.LAUNCHES - before[0] ==
              18 * (sampler.FORWARDS - before[1]),
              'timed steps: {} forwards in {} steps, 18 K1 launches each'
              .format(sampler.FORWARDS - before[1], n_timed))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = sampler.run_mcmc(setup, state, sampler.MCMCConfig(3))
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        per_step = sum(e.count for e in events) / 3
        busy = sum(e.self_device_time_total for e in events) * 1e-6 / 3
        check(per_step > 0 and busy > 0, 'the profiler saw the card')
        print('  {:.4f} s per AM step per chain (median of {} post-burn '
              'steps, CUDA events; {:.4f} s by the host clock over all): '
              'model block {:.4f} s, observation sweep {:.4f} s; {:.0f} '
              'device launches a step ({:.1f} of them K1), device busy '
              '{:.4f} s a step (idle share {:.3f}); {:.0f} AM steps/hr '
              '({})'.format(med['step'], n_timed, wall, med['model'],
                            med['sweep'], per_step, k1_per_step, busy,
                            1.0 - busy / med['step'],
                            3600.0 / med['step'], card))
    return (launches, forwards, med['step'], med['model'], med['sweep'],
            per_step, busy)


def phase_nuts_cli(dev, card):
    """The NUTS CLI at the Bayes default (801², 25 m, K = 44, Kl = 20,
    18 days, no pre-spread day, plain Poisson, f32): two chains in turn
    from a short MAP fit, with every count zeroed just before and read just
    after; the value and gradient of the NUTS target at the MAP start
    through the kernels against the plain path; an interrupted chain
    resumed from its checkpoint against the chain that never stopped; the
    host reads of a transition; seconds per leapfrog and per transition.
    Returns (K1 launches, K3 launches, value+gradients, seconds per
    leapfrog, seconds per transition per chain, leapfrogs per transition,
    host reads per leapfrog, the run's seconds, device launches and busy
    seconds a leapfrog)."""
    from parasitoids_tpu_torch.bayes import map_fit, nuts
    from parasitoids_tpu_torch.bayes import model as bayes_model
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.ops import day_kernel
    print('[10] NUTS CLI at the Bayes default (801^2, 18 days, K = 44, '
          'Kl = 20, two chains in turn)')
    tic_phase = time.perf_counter()
    burn, draws, depth, map_steps, chains = 8, 4, 4, 10, 2
    print('  cut in depth only: warm-up {} asked (the CLI runs at least 10) '
          '+ {} draws a chain, --max-depth {} (default 6), --init-map-steps '
          '{} (default 200); grid, windows and days not cut'.format(
              burn, draws, depth, map_steps))
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, 'nuts')
        day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
        nuts.VALUE_AND_GRADS = 0
        bayes_model.SKIPPED_FORWARDS = 0
        torch.cuda.synchronize()
        out = bayes_run.main(['--sampler', 'nuts', '--new', str(draws),
                              str(burn), db, '--chains', str(chains),
                              '--init', 'map', '--init-map-steps',
                              str(map_steps), '--max-depth', str(depth),
                              '--checkpoint-every', '3', '--seed', '0'],
                             device=dev)
        torch.cuda.synchronize()
        k1, k3 = day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD
        n_eval = nuts.VALUE_AND_GRADS
        skipped = bayes_model.SKIPPED_FORWARDS
        with np.load(db + '.npz') as npz:
            saved = {k: npz[k] for k in npz.files}
        check(set(saved) == {'traces', 'z_samples', 'step_size', 'inv_mass',
                             'sampler'} and str(saved['sampler']) == 'nuts'
              and saved['traces'].shape == (chains, draws, 26) and
              saved['z_samples'].shape == (chains, draws, 25),
              'trace file: JAX run_nuts keys, traces {}'.format(
                  saved['traces'].shape))
        check(bool(np.isfinite(saved['traces']).all()) and
              bool(np.isfinite(saved['z_samples']).all()),
              'every draw finite')
        check(not os.path.exists(db + '.ckpt.npz') and
              not os.path.exists(db + '.ckpt_durable.npz'),
              'a completed run leaves no checkpoint')
    # the value+gradients: the sampler's own (initial points, step-size
    # search, leapfrogs) and the MAP fit's Adam steps, less any evaluation
    # outside the prior's support (no forward); the MAP fit's last value
    # has no gradient
    n_vg = n_eval + map_steps - skipped
    check(k3 == 18 * n_vg and k1 == 18 * (n_vg + 1),
          'K3 launches {} = 18 x {} value+gradients ({} by the sampler + {} '
          'Adam steps - {} outside the support); K1 launches {} = K3 + 18 '
          '(the MAP fit\'s final value)'.format(k3, n_vg, n_eval, map_steps,
                                              skipped, k1))
    warm = max(burn, 10)
    n_trans = chains * (warm + draws)
    sec = out['seconds']
    leaps = out['n_leapfrog']
    per_leap = sec / max(n_eval, 1)
    per_trans = sec / n_trans
    print('  NUTS: {:.4f} s per leapfrog (the run\'s {:.2f} s over its {} '
          'value+gradients), {:.2f} leapfrogs per draw transition (warm-up '
          'and draws: {:.2f} evaluations per transition), {:.4f} s per '
          'transition per chain; step size {} accept {:.3f}, {} divergences '
          '({})'.format(per_leap, sec, n_eval, float(leaps.mean()),
                        n_eval / n_trans, per_trans,
                        np.array2string(out['step_size'], precision=4),
                        float(out['accept_rate']), int(out['n_divergent']),
                        card))

    # the NUTS target at the MAP start through the kernels, held against
    # the plain path run in f64 with the f32 plain path's distance beside:
    # near the mode the gradient is small, and the two f32 paths stand
    # further apart than [7]'s limits (as [9]'s initial loglik is held)
    setup = bayes_run.build_setup(device=dev)
    plain = bayes_run.build_setup(['use_pallas=False'], device=dev)
    plain64 = bayes_run.build_setup(['use_f64=True'], device=dev)
    check(setup.setup.kcfg.pallas and not plain.setup.kcfg.pallas and
          not plain64.setup.kcfg.pallas and
          plain64.setup.wind_flat.dtype == torch.float64 and
          (setup.setup.kcfg.K, setup.setup.kcfg.K_local, setup.ndays,
           setup.setup.scfg.dom_len) == (44, 20, 18, 801),
          'setups: CUDA kernels, plain torch and plain torch in f64, K = 44, '
          'Kl = 20, 18 days, 801^2')
    z_map = torch.as_tensor(map_fit.map_fit(setup, n_steps=map_steps,
                                            use_sprd=False)['z']).to(dev)
    runs = []
    for s in (setup, plain, plain64):
        zz = z_map.to(s.setup.wind_flat.dtype)
        lp, g = nuts.value_and_grad(nuts.make_transformed_logpdf(s)[0])(zz)
        runs.append((float(lp), g.double().cpu().numpy()))
    v64, g64 = runs[2]

    def distance(v, g):
        return (abs(v - v64) / abs(v64),
                float(np.linalg.norm(g - g64) / np.linalg.norm(g64)),
                float(np.abs(g - g64).max() / np.abs(g64).max()))

    dk, dp = distance(*runs[0]), distance(*runs[1])
    print('  NUTS target at the MAP start: value kernels {!r}, f32 plain {!r}, '
          'f64 plain {!r}; f64 gradient {}'.format(
              runs[0][0], runs[1][0], v64, np.array2string(g64,
                                                           precision=3)))
    check(np.isfinite(runs[0][0]) and np.all(np.isfinite(runs[0][1])) and
          dk[0] <= NUTS_VALUE_RTOL and dk[1] <= NUTS_GRAD_L2_LIMIT and
          dk[2] <= NUTS_GRAD_COMP_LIMIT,
          'NUTS target at the MAP start, kernels against the plain path in '
          'f64: value rel {:.3e} <= {:.0e}, gradient relative L2 {:.3e} <= '
          '{:.0e}, worst component {:.3e} <= {:.0e} of the largest (the f32 '
          'plain path: {:.3e}, {:.3e}, {:.3e})'.format(
              dk[0], NUTS_VALUE_RTOL, dk[1], NUTS_GRAD_L2_LIMIT, dk[2],
              NUTS_GRAD_COMP_LIMIT, *dp))
    del plain, plain64

    # exact resume on the card: one chain from the run's last draw, stopped
    # after its first draw, resumed from the checkpoint of warm-up
    logpdf = nuts.make_transformed_logpdf(setup)[0]
    z0 = torch.as_tensor(saved['z_samples'][:1, -1]).to(dev)
    cfg = nuts.NUTSConfig(num_warmup=4, num_samples=2, max_depth=2,
                          init_step_size=float(out['step_size'][0]))

    def gens():
        return [torch.Generator(device=dev).manual_seed(11)]

    class Stop(Exception):
        pass

    def stop(phase, i, total):
        if (phase, i) == ('sample', 1):
            raise Stop

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'one.ckpt.npz')
        whole = nuts.nuts_sample_stepwise(logpdf, z0, gens(), cfg)
        try:
            nuts.nuts_sample_stepwise(logpdf, z0, gens(), cfg, progress=stop,
                                      checkpoint_path=ckpt,
                                      checkpoint_every=2)
        except Stop:
            pass
        with np.load(ckpt) as d:
            phase = str(d['phase'])
        resumed = nuts.nuts_sample_stepwise(logpdf, z0, gens(), cfg,
                                            checkpoint_path=ckpt,
                                            checkpoint_every=2, resume=True)
    same = all(np.array_equal(whole[k], resumed[k]) for k in
               ('samples', 'logp', 'step_size', 'inv_mass', 'n_leapfrog'))
    check(same and phase == 'warmup',
          'one chain stopped after its first draw and resumed from its '
          'warm-up checkpoint: draws bitwise equal to the chain that never '
          'stopped ({} leapfrogs a draw)'.format(
              whole['n_leapfrog'][0].tolist()))

    # host reads: one per leapfrog, plus one where a gate stops the tree
    lpg = nuts.value_and_grad(logpdf)
    z = z0[0]
    lp, g = lpg(z)
    inv_mass = torch.as_tensor(resumed['inv_mass'][0]).to(dev)
    step = torch.as_tensor(resumed['step_size'][0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    n_leaf = []

    def transitions():
        zz, ll, gg = z, lp, g
        for _ in range(2):
            zz, ll, gg, _, n, _ = nuts._nuts_step(
                lpg, inv_mass, step, 3, zz, ll, gg,
                nuts.draw_transition(gen, zz.shape[0], 3, zz.dtype))
            n_leaf.append(n)

    torch.cuda.synchronize()
    _, reads = count_host_reads(transitions)
    for r in sorted(set(reads)):
        print('  host read x{}: {}'.format(reads.count(r), r))
    per = len(reads) / max(sum(n_leaf), 1)
    check(sum(n_leaf) <= len(reads) <= sum(n_leaf) + 2 and per <= 2.0,
          '{} synchronizing calls in 2 transitions of {} leapfrogs: {:.2f} '
          'per leapfrog (budget 2)'.format(len(reads), n_leaf, per))
    # device launches and busy time a leapfrog, one profiled transition
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_prof = []
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n_prof.append(nuts._nuts_step(
            lpg, inv_mass, step, 2, z, lp, g,
            nuts.draw_transition(gen, z.shape[0], 2, z.dtype))[4])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - tic) / n_prof[0]
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    launches_leap = sum(e.count for e in events) / n_prof[0]
    busy = sum(e.self_device_time_total for e in events) * 1e-6 / n_prof[0]
    check(launches_leap > 0 and busy > 0, 'the profiler saw the card')
    print('  profiled transition of {} leapfrogs: {:.0f} device launches and '
          '{:.4f} s device busy a leapfrog of {:.4f} s (idle share {:.3f}, '
          'the profiler on; {})'.format(n_prof[0], launches_leap, busy, wall,
                                        1.0 - busy / wall, card))
    sec_phase = time.perf_counter() - tic_phase
    print('  phase [10]: {:.1f} s'.format(sec_phase))
    return (k1, k3, n_vg, per_leap, per_trans, float(leaps.mean()), per,
            sec, launches_leap, busy)


def watch_hessian(during):
    """Wrap ``map_fit.hessian_columns`` so that every call appends the
    forward and backward kernel launches made while it ran to ``during``;
    returns the function that undoes the wrap."""
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.ops import day_kernel
    real = map_fit.hessian_columns

    def watched(f, z):
        torch.cuda.synchronize()
        before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        out = real(f, z)
        torch.cuda.synchronize()
        during.append((day_kernel.LAUNCHES - before[0],
                       day_kernel.LAUNCHES_BWD - before[1]))
        return out

    map_fit.hessian_columns = watched

    def undo():
        map_fit.hessian_columns = real
    return undo


def hessian_line(lap):
    d = lap['hess_z'].shape[0]
    return ('Hessian on the plain path in {}: d = {}, {:.2f} s ({:.3f} s a '
            'column), peak {:.2f} GiB allocated'.format(
                lap['precision'], d, lap['seconds'], lap['seconds'] / d,
                lap['peak_bytes'] / 2 ** 30))


def phase_laplace_cli(dev, card):
    """``map_fit.main(['--norm', '--steps', '5'])`` at the MAP CLI default
    (401², 50 m, K = 22, Kl = 10, 18 days, sprd_factor fitted), every count
    zeroed just before and read just after: the Adam steps through K1/K3,
    no launch while the Hessian runs (the f64 plain twin), its symmetry,
    three of its rows (ρ, a σ, an observation slot) against central
    differences of the f64 plain gradient, the positive-definiteness
    verdict and the log evidence.  Returns (launches, the Laplace dict)."""
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import BayesSetup
    from parasitoids_tpu_torch.ops import day_kernel
    print('[11] MAP + Laplace CLI (--norm) at its default (401^2, 18 days, '
          'K = 22, Kl = 10)')
    steps = 5
    during = []
    undo = watch_hessian(during)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, 'map_fit.txt')
            day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
            torch.cuda.synchronize()
            tic = time.perf_counter()
            fit = map_fit.main(['--norm', '--steps', str(steps), '-o', out],
                               device=dev)
            torch.cuda.synchronize()
            sec = time.perf_counter() - tic
            launches = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
            with open(out) as fh:
                report = fh.read().splitlines()
    finally:
        undo()
    lap = fit['laplace']
    check(launches == ((steps + 1) * 18, steps * 18),
          '{} forward and {} backward launches for {} Adam steps of 18 days '
          'and the final value'.format(*launches, steps))
    check(during == [(0, 0)], 'no kernel launch while the Hessian ran')
    H = lap['hess_z']
    check(lap['precision'] == 'float64' and H.shape == (26, 26) and
          bool(np.isfinite(H).all()),
          'the Hessian, (26, 26) and finite, in f64 on the card')
    print('  ' + hessian_line(lap) + ' ({})'.format(card))
    asym = float(np.abs(H - H.T).max() / np.abs(H).max())
    check(asym <= HESS_SYM_LIMIT, 'symmetric: max |H - H^T| / max |H| = '
          '{:.3e} <= {:.0e}'.format(asym, HESS_SYM_LIMIT))
    # rows of the Hessian against central differences of the f64 plain
    # gradient, on the twin the CLI built (the setup's f32 arrays upcast)
    twin = map_fit.plain_twin(BayesSetup(map_fit.map_cli_params(),
                                         device=dev), torch.float64)
    neg, _, _ = map_fit._make_objective(twin, True)
    z = torch.as_tensor(fit['z'], dtype=torch.float64, device=dev)

    def grad(zz):
        return value_and_grad(neg, zz)[1]

    for name, j in (('corr_p (rho)', 8), ('sig_x', 6), ('xi', 15)):
        errs = []
        for h in HESS_FD_STEPS:
            e = torch.zeros_like(z)
            e[j] = h
            fd = (grad(z + e) - grad(z - e)) / (2 * h)
            errs.append(float(np.abs(fd - H[j]).max() / np.abs(H[j]).max()))
        check(min(errs) <= HESS_FD_LIMIT, 'row {} ({}) against central '
              'differences of the f64 gradient: {} at h = {}; the best <= '
              '{:.0e} of its largest entry {:.4g}'.format(
                  j, name, ', '.join('{:.3e}'.format(v) for v in errs),
                  ', '.join('{:.0e}'.format(h) for h in HESS_FD_STEPS),
                  HESS_FD_LIMIT, float(np.abs(H[j]).max())))
    free = lap['free']
    lam = np.linalg.eigvalsh(0.5 * (H + H.T)[np.ix_(free, free)])
    check(free.sum() == 25 and not free[13] and
          lap['hess_pd'] == bool(lam.min() > 0) and
          np.isfinite(lap['log_evidence']) == lap['hess_pd'] and
          report[1].startswith('Laplace log-evidence'),
          'free slots 25 (n_periods pinned); hess_pd {} as the free block\'s '
          'eigenvalues say ({:.4g} to {:.4g}); log evidence {!r}, finite '
          'exactly where the Hessian is positive definite'.format(
              lap['hess_pd'], float(lam.min()), float(lam.max()),
              lap['log_evidence']))
    print('  the CLI took {:.2f} s: 5 Adam steps, the Laplace approximation, '
          'the report ({})'.format(sec, card))
    return launches, lap


def phase_ridge_cli(dev, card):
    """The NUTS CLI with ``--mass ridge`` at the Bayes default (801², 25 m,
    K = 44, Kl = 20, 18 days, no pre-spread day), one chain from a 10-step
    MAP fit, every count zeroed just before and read just after: the
    Hessian on the f64 plain twin with no kernel launch, the whitening
    sidecar, and a run interrupted after its first draw and resumed in
    u-space through the sidecar against the run that never stopped.  The
    interrupted run reuses the first run's warm start: the f64 plain
    accumulate adds atomically on the card, so a second Hessian would
    differ in its last bits.  Returns (K1, K3 launches, the Laplace dict,
    the run's seconds)."""
    from parasitoids_tpu_torch.bayes import map_fit, nuts
    from parasitoids_tpu_torch.bayes import model as bayes_model
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.ops import day_kernel
    print('[12] NUTS CLI --mass ridge at the Bayes default (801^2, 18 days, '
          'K = 44, Kl = 20, one chain)')
    burn, draws, depth, map_steps = 10, 2, 3, 10
    print('  cut in depth only: --init-map-steps {} (default 200), warm-up '
          '{} + {} draws, --max-depth {} (default 6)'.format(
              map_steps, burn, draws, depth))

    def cli(db):
        return ['--sampler', 'nuts', '--mass', 'ridge', '--new', str(draws),
                str(burn), db, '--chains', '1', '--init-map-steps',
                str(map_steps), '--max-depth', str(depth),
                '--checkpoint-every', '2', '--seed', '0']

    warm = []
    real_warm = map_fit.laplace_warm_mass

    def warm_once(*a, **k):
        if not warm:
            warm.append(real_warm(*a, **k))
        fit, inv = warm[0]
        return dict(fit), inv.copy()

    class Stop(Exception):
        pass

    real_sample = nuts.nuts_sample_stepwise

    def stopping(*a, progress=None, **k):
        def wrapped(phase, i, total):
            if (phase, i) == ('sample', 1):
                raise Stop
            progress(phase, i, total)
        return real_sample(*a, progress=wrapped, **k)

    during = []
    undo = watch_hessian(during)
    map_fit.laplace_warm_mass = warm_once
    try:
        with tempfile.TemporaryDirectory() as tmp:
            whole, cut = os.path.join(tmp, 'whole'), os.path.join(tmp, 'cut')
            day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
            nuts.VALUE_AND_GRADS = 0
            bayes_model.SKIPPED_FORWARDS = 0
            torch.cuda.synchronize()
            out = bayes_run.main(cli(whole), device=dev)
            torch.cuda.synchronize()
            k1, k3 = day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD
            n_eval = nuts.VALUE_AND_GRADS
            skipped = bayes_model.SKIPPED_FORWARDS
            check(os.path.exists(whole + '.whiten.npz'),
                  'the whitening sidecar {} is written'.format(
                      os.path.basename(whole) + '.whiten.npz'))
            nuts.nuts_sample_stepwise = stopping
            try:
                bayes_run.main(cli(cut), device=dev)
                stopped = False
            except Stop:
                stopped = True
            finally:
                nuts.nuts_sample_stepwise = real_sample
            check(stopped and os.path.exists(cut + '.ckpt.npz') and
                  os.path.exists(cut + '.whiten.npz'),
                  'a second run stopped after its first draw, leaving its '
                  'checkpoint and sidecar')
            bayes_run.main(['--sampler', 'nuts', '--resume', cut, '0'],
                           device=dev)
            same = []
            for suffix in ('.npz', '.whiten.npz'):
                with np.load(whole + suffix) as a, np.load(cut + suffix) as b:
                    same.append(set(a.files) == set(b.files) and all(
                        np.array_equal(a[k], b[k]) for k in a.files))
                    if suffix == '.npz':
                        traces = a['traces']
            check(all(same) and traces.shape == (1, draws, 26) and
                  bool(np.isfinite(traces).all()),
                  'the run resumed in u-space through its sidecar wrote the '
                  'traces {} and sidecar of the run that never stopped, bit '
                  'for bit'.format(traces.shape))
    finally:
        undo()
        map_fit.laplace_warm_mass = real_warm
    lap = warm[0][0]['laplace']
    check(during == [(0, 0)], 'no kernel launch while the Hessian ran')
    n_vg = n_eval + map_steps - skipped
    check(k3 == 18 * n_vg and k1 == 18 * (n_vg + 1),
          'K3 launches {} = 18 x {} value+gradients ({} by the sampler + {} '
          'Adam steps - {} outside the support); K1 launches {} = K3 + 18'
          .format(k3, n_vg, n_eval, map_steps, skipped, k1))
    check(lap['precision'] == 'float64' and lap['hess_z'].shape == (25, 25),
          'the Hessian in f64, d = 25')
    print('  ' + hessian_line(lap) + ' ({})'.format(card))
    print('  NUTS: {:.2f} s for the warm-up and draws (after the warm '
          'start); step size {}, accept {:.3f}, {} leapfrogs a draw'.format(
              out['seconds'], np.array2string(out['step_size'], precision=4),
              float(out['accept_rate']), out['n_leapfrog'].tolist()))
    return k1, k3, lap, out['seconds']


# the sections of the JAX package's bayes.summary report
# (parasitoids_tpu/bayes/summary.py:128-226)
REPORT_SECTIONS = ['## Posterior', '## Convergence', '## Figures',
                   '## Posterior-predictive p-values',
                   '## Predictive assessment (leave-one-date-out)',
                   '## Prior/likelihood sensitivity (power-scaling)']


def phase_summary_cli(dev, card, work):
    """``bayes.summary`` over [9]'s AM store at the Bayes default (801²,
    ``--draws 8``), the forward kernel's count zeroed just before and read
    just after: 18 K1 launches per ensemble member and no backward; one
    member's projections against a lone ``forward_projections``; every
    section of the JAX report.  Runs in a directory of its own that sees
    the repository's data, so that its figures stay there.  Returns (K1
    launches, members, seconds per member, the report's seconds)."""
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import summary
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.ops import day_kernel
    from parasitoids_tpu_torch.parallel import ensemble
    print('[13] bayes.summary over [9]\'s AM store (801^2, 18 days, K = 44, '
          'Kl = 20, --draws 8)')
    db = os.path.join(work, 'am.npz')
    here = os.path.join(work, 'summary')
    os.makedirs(here)
    os.symlink(os.path.join(ROOT, 'data'), os.path.join(here, 'data'))
    # the ensemble's two entry points, timed on the card and their members
    # counted while the report runs
    timing = {}
    real = {f: getattr(ensemble, f) for f in ('ensemble_projections',
                                              'ensemble_fields')}

    def timed(name):
        def run(setup, thetas, *a, **k):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = real[name](setup, thetas, *a, **k)
            torch.cuda.synchronize()
            sec, n = timing.get(name, (0.0, 0))
            timing[name] = (sec + time.perf_counter() - tic, n + len(thetas))
            return out
        return run

    for name in real:
        setattr(ensemble, name, timed(name))
    os.chdir(here)
    try:
        day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = summary.main([db, '--draws', '8'], device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - tic
        launches = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
    finally:
        os.chdir(ROOT)
        for name, fn in real.items():
            setattr(ensemble, name, fn)
    with open(out) as fh:
        text = fh.read()
    members = sum(n for _, n in timing.values())
    check(launches == (18 * members, 0),
          '{} K1 launches = 18 x {} ensemble members ({}), no K3'.format(
              launches[0], members, ', '.join(
                  '{} {}'.format(k, n) for k, (_, n) in timing.items())))
    sections = [line for line in text.splitlines() if line.startswith('## ')]
    check(sections == REPORT_SECTIONS, 'the report has every section of the '
          'JAX report: ' + '; '.join(s[3:] for s in sections))
    figures = [line for line in text.splitlines()
               if line.startswith('- ') and ('`' in line or 'skipped' in line)]
    print('  figures: ' + ' | '.join(figures))
    setup = bayes_run.build_setup(device=dev)
    with np.load(db) as npz:
        rows = npz['traces'].reshape(-1, npz['traces'].shape[-1])[:2, :15]
    ens = ensemble.ensemble_projections(setup, rows)
    with torch.no_grad():
        lone = setup.forward_projections(_as_model(torch.as_tensor(
            rows[1], device=dev)))
    check(all(torch.equal(a[1], b) for a, b in zip(
        (*ens[0], *ens[1], ens[2]), (*lone[0], *lone[1], lone[2]))),
        'member 1 of an ensemble is a lone forward_projections, bit for bit')
    per = {k: s / n for k, (s, n) in timing.items()}
    sec_member = sum(s for s, _ in timing.values()) / members
    print('  seconds per member: {} ({:.4f} over all {}); the report {:.2f} '
          's ({})'.format(', '.join('{} {:.4f}'.format(k[9:], v)
                                    for k, v in per.items()), sec_member,
                          members, sec, card))
    return launches[0], members, sec_member, sec


# the MAP CLI's small configuration (tests/_torch_parity.py MAP_SMALL): the
# depth at which [17] runs its two complete anneals through the kernels
MAP_SMALL = ['ndays=3', 'domain_info=(10000.0,50)', 'interp_num=2',
             'kernel_rad=6', 'kernel_rad_local=3']


def zero_counts():
    """Every launch and evaluation count of the port set to 0."""
    from parasitoids_tpu_torch.bayes import model, nuts, sampler, vi
    from parasitoids_tpu_torch.ops import day_kernel
    day_kernel.LAUNCHES = day_kernel.LAUNCHES_BWD = 0
    day_kernel.LAUNCHES_BATCHED = sampler.BATCHED_FORWARDS = 0
    sampler.FORWARDS = nuts.VALUE_AND_GRADS = model.SKIPPED_FORWARDS = 0
    vi.VALUE_AND_GRADS = vi.VALUES = 0


def launch_counts():
    """(K1 launches, K3 launches) after the card has finished."""
    from parasitoids_tpu_torch.ops import day_kernel
    torch.cuda.synchronize()
    return day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD


def phase_pt_cli(dev, card, work):
    """The PT CLI at the Bayes default (801², 18 days, K = 44, Kl = 20):
    four replicas, a new run with a checkpoint, then a resume, every count
    zeroed just before and read just after; the store; a reloaded state
    and one more swap round bitwise the state that never stopped; swap
    acceptance, the evidence and seconds per replica step.  Returns (K1
    launches, forwards, seconds per replica step, the phase's seconds)."""
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import sampler, tempering
    from parasitoids_tpu_torch.bayes.store import load_chain, load_extras
    print('[14] PT CLI at the Bayes default (801^2, 18 days, K = 44, '
          'Kl = 20, 4 replicas, swap every 5)')
    tic_phase = time.perf_counter()
    db = os.path.join(work, 'pt')
    zero_counts()
    new = bayes_run.main(['--sampler', 'pt', '--temps', '4', '--swap-every',
                          '5', '--new', '20', '10', db, '--checkpoint-every',
                          '15'], device=dev)
    with np.load(db + '.npz') as npz:
        first = npz['traces']
    res = bayes_run.main(['--sampler', 'pt', '--resume', db, '10'],
                         device=dev)
    k1, k3 = launch_counts()
    forwards = sampler.FORWARDS
    with np.load(db + '.npz') as npz:
        files = set(npz.files)
        traces = npz['traces']
    with open(db + '.meta.json') as fh:
        meta = json.load(fh)
    ex = load_extras(db)
    check({'x_betas', 'x_loglik', 'x_swap_attempts', 'x_swap_accepts',
           'traces', 'state_key', 'state_m'} <= files and
          traces.shape == (1, 30, 26) and first.shape == (1, 20, 26) and
          np.array_equal(traces[:, :20], first) and
          bool(np.isfinite(traces).all()),
          'store: traces {} (the cold chain after 10 burn-in steps, the '
          'first 20 kept on resume), keys {}'.format(
              traces.shape, sorted(k for k in files if k.startswith('x_'))))
    check(np.array_equal(ex['betas'], tempering.power_ladder(4)) and
          ex['loglik'].shape == (4, 40) and
          bool(np.isfinite(ex['loglik']).all()) and
          meta['rounds_done'] == 8 and meta['swap_every'] == 5 and
          meta['sampler'] == 'pt',
          'betas {} (power ladder), loglik {}, rounds_done {}'.format(
              ex['betas'].tolist(), ex['loglik'].shape,
              meta['rounds_done']))
    # 4 replicas initialised, 4 reloaded, and every proposal of the
    # 4 x 40 steps whose prior was finite
    check(8 <= forwards <= 8 + 160 and k1 == 18 * forwards and k3 == 0,
          '{} K1 launches = 18 x {} forwards (8 + {} of 160 proposals inside '
          'the prior\'s support); no K3'.format(k1, forwards, forwards - 8))
    # a reloaded state and one more swap round, against the state the
    # resumed run left in memory
    setup = bayes_run.build_setup(device=dev)
    _, reloaded, _ = load_chain(db, setup)
    check(states_equal(res['states'], reloaded),
          'the reloaded replicas are the replicas in memory, bit for bit')
    cfg = tempering.PTConfig(n_rounds=1, swap_every=5)
    out = [tempering.run_pt(setup, s, ex['betas'], 2, cfg, round_offset=8)
           for s in (res['states'], reloaded)]
    torch.cuda.synchronize()
    check(states_equal(out[0][0], out[1][0]) and
          torch.equal(out[0][1], out[1][1]) and
          torch.equal(out[0][2]['swap_accepts'], out[1][2]['swap_accepts']),
          'one more swap round (4 x 5 steps) from the reloaded replicas '
          'bitwise equal to one from memory')
    ev = res['evidence']
    steps = (new['rounds'] + res['rounds']) * 5 * 4
    sec = (new['seconds'] + res['seconds']) / steps
    print('  swap acceptance by rung {}; TI {:.2f}, stepping-stone {:.2f}, '
          'equilibrated {} (40 steps: not asserted)'.format(
              np.round(res['swap_rates'], 3).tolist(), ev['ti'], ev['ss'],
              ev['equilibrated']))
    sec_phase = time.perf_counter() - tic_phase
    print('  {:.4f} s per replica step ({} replica steps in {:.2f} s, '
          'checkpoints included; {})'.format(
              sec, steps, new['seconds'] + res['seconds'], card))
    print('  phase [14]: {:.1f} s'.format(sec_phase))
    return k1, forwards, sec, sec_phase


def phase_smc(dev, card, work):
    """``run_smc`` at the Bayes default with 8 particles, one move a
    stage: five stages uninterrupted, then a run stopped after stage 3
    through its checkpoint callback, saved as the CLI saves it and resumed
    from that store to stage 5, bitwise the uninterrupted run; resampled
    clones with generators of their own; K1 = 18 × forwards and no K3.
    Returns (K1 launches, forwards, seconds per particle move, the phase's
    seconds)."""
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import sampler, smc
    print('[15] SMC at the Bayes default (801^2, 18 days, 8 particles, one '
          'move a stage, five stages)')
    tic_phase = time.perf_counter()
    setup = bayes_run.build_setup(device=dev)
    cfg = smc.SMCConfig(n_particles=8, n_moves=1, min_accepts=0.0,
                        max_move_rounds=1)
    db = os.path.join(work, 'smc')

    class Stop(Exception):
        pass

    def stop_at(stage, keep, save=False):
        def cb(p):
            if save:
                bayes_run._save_smc(db, p, 0, cfg)
            keep.update(p)
            if p['stage'] == stage:
                raise Stop
        return cb

    zero_counts()
    mono, part, resumed = {}, {}, {}
    tic = time.perf_counter()
    try:
        smc.run_smc(setup, 0, cfg, seed=0, checkpoint=stop_at(5, mono))
    except Stop:
        pass
    torch.cuda.synchronize()
    sec_mono = time.perf_counter() - tic
    try:
        smc.run_smc(setup, 0, cfg, seed=0,
                    checkpoint=stop_at(3, part, save=True))
    except Stop:
        pass
    payload, meta = bayes_run._smc_resume_payload(db, setup)
    try:
        smc.run_smc(setup, None, cfg, seed=0, resume=payload,
                    checkpoint=stop_at(5, resumed))
    except Stop:
        pass
    k1, k3 = launch_counts()
    forwards = sampler.FORWARDS
    check(meta['stage'] == 3 and mono['stage'] == resumed['stage'] == 5,
          'stopped after stage 3 (store stage {}), resumed to stage 5'.format(
              meta['stage']))
    a, b = mono['states'], resumed['states']
    same = (states_equal(a, b) and np.array_equal(mono['logw'],
                                                  resumed['logw']) and
            mono['logz'] == resumed['logz'] and
            mono['log_scale'] == resumed['log_scale'] and
            all(np.array_equal(mono['history'][k], resumed['history'][k])
                for k in mono['history']))
    check(same, 'the run resumed from the store is bitwise the uninterrupted '
          'one at stage 5 (particles, generators, weights, logZ {:.6f}, '
          'history)'.format(mono['logz']))
    h = mono['history']
    keys = {bytes(g.get_state().numpy()) for g in a.key}
    check(bool(np.any(h['resampled'])) and len(keys) == 8,
          'resampled at stages {}; the 8 particles hold 8 distinct '
          'generators'.format((np.flatnonzero(h['resampled']) + 1).tolist()))
    # 8 initial particles for each of the two runs from the prior, 8 in the
    # reload, and every proposal inside the support: 40 + 24 + 16 moves
    check(24 <= forwards <= 24 + 80 and k1 == 18 * forwards and k3 == 0,
          '{} K1 launches = 18 x {} forwards (24 initial or reloaded + {} of '
          '80 proposals inside the prior\'s support); no K3'.format(
              k1, forwards, forwards - 24))
    print('  beta by stage {}'.format(
        ' '.join('{:.3g}'.format(v) for v in h['betas'])))
    print('  ESS by stage {}'.format(
        ' '.join('{:.2f}'.format(v) for v in h['ess'])))
    sec = sec_mono / (8 + 5 * 8)
    sec_phase = time.perf_counter() - tic_phase
    print('  {:.4f} s per particle move (the uninterrupted run: 8 '
          'initial forwards and 40 moves in {:.2f} s; {})'.format(
              sec, sec_mono, card))
    print('  phase [15]: {:.1f} s'.format(sec_phase))
    return k1, forwards, sec, sec_phase


def phase_vi_cli(dev, card, work):
    """The ADVI CLI at the Bayes default: 5 Adam steps of MAP, 10 ELBO
    steps of 2 draws, 32 importance draws, then a resume that appends 8
    draws from the stored q; K3 = 18 × the value+gradients, K1 = K3 +
    18 × the evaluations without a graph.  Returns (K1, K3, seconds per
    ELBO step, the phase's seconds)."""
    from parasitoids_tpu_torch.bayes import model, sampler, vi
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes.store import load_chain
    print('[16] ADVI CLI at the Bayes default (801^2, 18 days, 5 MAP '
          'steps, 10 ELBO steps x 2 draws, 32 importance draws)')
    tic_phase = time.perf_counter()
    db = os.path.join(work, 'vi')
    timing = []
    real = vi.advi

    def timed(*a, **k):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        timing.append(time.perf_counter() - tic)
        return out

    vi.advi = timed
    try:
        zero_counts()
        ev = bayes_run.main(['--sampler', 'vi', '--new', '16', '10', db,
                             '--vi-mc', '2', '--vi-is', '32',
                             '--init-map-steps', '5'], device=dev)
        ev2 = bayes_run.main(['--sampler', 'vi', '--resume', db, '8',
                              '--vi-is', '32'], device=dev)
        k1, k3 = launch_counts()
    finally:
        vi.advi = real
    counts = dict(vg=vi.VALUE_AND_GRADS, values=vi.VALUES,
                  forwards=sampler.FORWARDS, skipped=model.SKIPPED_FORWARDS)
    # k-hat is inf where fewer than five weights exceed PSIS's cutoff (the
    # JAX package's rule): after 10 ELBO steps the weights may span
    # hundreds of nats, so it is held to be a number, not to be finite
    check(all(np.isfinite([e['elbo'], e['logz_is']]).all() and
              not np.isnan(e['khat']) for e in (ev, ev2)),
          'ELBO {:.2f}, IS log Z {:.2f} finite, k-hat {:.3f}; after the '
          'resume {:.2f}, {:.2f}, {:.3f}'.format(
              ev['elbo'], ev['logz_is'], ev['khat'], ev2['elbo'],
              ev2['logz_is'], ev2['khat']))
    setup = bayes_run.build_setup(device=dev)
    traces, _, meta = load_chain(db, setup)
    check(traces.shape == (1, 24, 26) and bool(np.isfinite(traces).all())
          and meta['sampler'] == 'vi' and meta['n_samples'] == 24,
          'the store loads with load_chain: traces {} (16 + 8 drawn from '
          'the stored q)'.format(traces.shape))
    # K3: the 5 Adam steps and the 20 ELBO draws; K1 besides: the MAP
    # fit's final value, the 2 x 32 importance draws, the chain states at
    # the best draw (2) and the reload (1); skipped evaluations (prior not
    # finite) launch nothing
    s = counts['skipped']
    s_grad = 5 + counts['vg'] - k3 // 18
    check(counts['vg'] == 20 and counts['values'] == 64 and
          counts['forwards'] == 3 and k3 % 18 == 0 and k1 % 18 == 0 and
          0 <= s_grad <= s and
          (k1 - k3) // 18 == 1 + 64 + 3 - (s - s_grad),
          'K3 {} = 18 x (5 Adam + {} ELBO draws - {} skipped); K1 {} = K3 '
          '+ 18 x (1 + {} importance draws + {} chain states - {} '
          'skipped)'.format(k3, counts['vg'], s_grad, k1, counts['values'],
                            counts['forwards'], s - s_grad))
    sec = timing[0] / 10
    sec_phase = time.perf_counter() - tic_phase
    print('  {:.4f} s per ELBO step of 2 draws ({:.2f} s for 10; the fit '
          'with its MAP init {:.2f} s; {})'.format(
              sec, timing[0], ev['fit_seconds'], card))
    print('  phase [16]: {:.1f} s'.format(sec_phase))
    return k1, k3, sec, sec_phase


def phase_sbc_and_anneals(dev, card, work):
    """``bayes.sbc`` (AM arm) at the Bayes default, uninterrupted and
    stopped after replicate 1 and resumed through its checkpoint, the ranks
    bitwise equal, K1 only; then at the MAP CLI's small depth, through the
    kernels, a complete SMC anneal by the CLI and ``bayes.cv`` on fold 0.
    Returns (K1 launches of the SBC runs, K1 of the small runs, the SBC's
    seconds, the phase's seconds)."""
    from parasitoids_tpu_torch.bayes import cv, sbc, sampler
    from parasitoids_tpu_torch.bayes import run as bayes_run
    print('[17] bayes.sbc (AM arm, 801^2, 2 replicates x (5 + 10 steps)) '
          'with a checkpoint; SMC to beta = 1 and bayes.cv fold 0 at the '
          'small depth (101^2, 3 days, K = 6)')
    tic_phase = time.perf_counter()
    args = ['--replicates', '2', '--samples', '10', '--burn', '5',
            '--thin', '1']
    ck = os.path.join(work, 'sbc.ckpt.npz')
    zero_counts()
    tic = time.perf_counter()
    full = sbc.main(args + ['-o', os.path.join(work, 'sbc_full')],
                    device=dev)
    torch.cuda.synchronize()
    sec_sbc = time.perf_counter() - tic
    args1 = list(args)
    args1[1] = '1'
    sbc.main(args1 + ['--checkpoint', ck, '-o', os.path.join(work, 'sbc1')],
             device=dev)
    resumed = sbc.main(args + ['--checkpoint', ck, '-o',
                               os.path.join(work, 'sbc2')], device=dev)
    k1, k3 = launch_counts()
    forwards = sampler.FORWARDS
    check(resumed['resumed_at'] == 1 and
          np.array_equal(full['ranks'], resumed['ranks']) and
          np.array_equal(full['truths'], resumed['truths']) and
          full['L'] == 10,
          'stopped after replicate 1 and resumed: ranks {} bitwise those of '
          'the uninterrupted run'.format(full['ranks'].tolist()))
    # 4 replicates run: one simulated dataset and one initial state each,
    # then every proposal inside the support
    check(k1 == 18 * (forwards + 4) and k3 == 0 and forwards >= 4,
          '{} K1 launches = 18 x ({} chain forwards + 4 simulated datasets); '
          'no K3'.format(k1, forwards))
    print('  SBC at 801^2: {:.2f} s for 2 replicates ({})'.format(sec_sbc,
                                                                card))

    # the two complete anneals, at the small depth: at 801^2 the number of
    # stages to beta = 1 is not known in advance
    here = os.path.join(work, 'small')
    os.makedirs(here)
    zero_counts()
    tic = time.perf_counter()
    payload = bayes_run.main(['--sampler', 'smc', '--new', '8', '0',
                              os.path.join(here, 'smc'), '--moves', '1',
                              '--min-accepts', '0', '--max-move-rounds', '1']
                             + MAP_SMALL, device=dev)
    k1_smc, k3_smc = launch_counts()
    sec_smc = time.perf_counter() - tic
    check(payload['beta'] == 1.0 and np.isfinite(payload['logz']) and
          k1_smc > 0 and k3_smc == 0,
          'SMC CLI at the small depth: beta 1 after {} stages, log evidence '
          '{:.2f}; {} K1 launches, no K3 ({:.1f} s)'.format(
              payload['stage'], payload['logz'], k1_smc, sec_smc))
    zero_counts()
    tic = time.perf_counter()
    res = cv.main(['--folds', '0', '--particles', '8', '--moves', '1',
                   '--out', os.path.join(here, 'cv.json')] + MAP_SMALL,
                  device=dev)
    k1_cv, k3_cv = launch_counts()
    sec_cv = time.perf_counter() - tic
    check(len(res['elpd']) == 1 and np.isfinite(res['elpd_total']) and
          np.isfinite(res['logz'][0]) and k1_cv > 0 and k3_cv == 0,
          'bayes.cv fold 0 ({}) at the small depth: elpd {:.3f}, refit '
          'log Z {:.2f}; {} K1 launches, no K3 ({:.1f} s)'.format(
              res['labels'][0], res['elpd_total'], res['logz'][0], k1_cv,
              sec_cv))
    sec_phase = time.perf_counter() - tic_phase
    print('  phase [17]: {:.1f} s'.format(sec_phase))
    return k1, k1_smc + k1_cv, sec_sbc, sec_phase


# the batched ensemble against its in-turn forward: the day accumulates
# take the same node rule (each particle's Genz tier), the local and
# pre-spread blocks the select rule, which differs from Genz's tier by at
# most 20-node against 6/12-node quadrature roundoff; held at the JAX
# package's own tolerance for the two schemes (tests/test_smc.py:356-375)
SCHEME_RTOL, SCHEME_ATOL = 2e-4, 2e-3
BATCHED_RHOS = (0.253, 0.6, 0.9, 0.93, -0.99)   # every Genz tier


def batched_day(setup, m_vecs, day):
    """Day ``day``'s accumulate inputs for the particles ``m_vecs`` (N, 15)
    of a BayesSetup, as its batched forward builds them: (h, mu, idx,
    clip, Dp (N, 3), cell, K, buf_len)."""
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    s = setup.setup
    m = _as_model(m_vecs)
    n_per = torch.round(m.n_periods).to(torch.int64)
    h, mu, idx, clip, _ = day_scatter_inputs(
        s.wind_flat, s.wind_cumsum, day,
        tuple(v.reshape(-1, 1) for v in m.hparams()), m.mu_r.reshape(-1, 1),
        n_per.reshape(-1, 1), s.start_idx if day == 0 else 0, s.kcfg,
        s.rad_dist)
    Dp = torch.stack(m.Dparams(), dim=-1)
    cell = s.rad_dist / s.kcfg.rad_res
    return (h, mu, idx, clip, Dp, cell, s.kcfg.K,
            s.scfg.dom_len + 4 * s.kcfg.K)


def phase_smc_batched(dev, card, rate, work, smc_sec=None):
    """Batched SMC at the Bayes default with [15]'s configuration (8
    particles, one move a stage, five stages, a stop after stage 3 and a
    resume from the command line's store), ``batched=True``: the
    particle-batched kernel against its plain twin on days 0, 9 and 17
    (five particles whose rho takes every Genz tier, two launches
    bitwise equal), each particle's batched projections against its own in-turn
    K1 forward, 18 batched launches a move round and no single one, no
    host read inside a move round, the resume bitwise, seconds per
    particle move batched and in turn, and device busy time a round.
    Returns the kernels line's numbers of the batched entry."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import sampler, smc
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.bayes.priors import (initial_model_params,
                                                    sample_prior_model)
    from parasitoids_tpu_torch.ops import day_kernel
    print('[18] batched SMC at the Bayes default (801^2, 18 days, 8 '
          'particles, one move a stage, five stages, batched=True)')
    tic_phase = time.perf_counter()
    setup = bayes_run.build_setup(device=dev)
    bsetup = setup.with_batched_bvn()
    check(bsetup.setup.kcfg.pallas and bsetup.setup.kcfg.K == 44,
          'the batched setup takes the CUDA kernel at K = 44')
    check_lattice_probe(dev)

    # 1. the batched launch against its plain twin
    m8 = sample_prior_model(torch.Generator().manual_seed(18), 8).to(dev)
    # the checked particles: the model block's initial values, with the
    # flight diffusion varied and rho in every Genz tier
    m5 = torch.as_tensor(np.tile(initial_model_params(),
                                 (len(BATCHED_RHOS), 1)),
                         dtype=torch.float32).to(dev)
    m5[:, 6] += torch.tensor([0.0, 20.0, -15.0, 40.0, 10.0], device=dev)
    m5[:, 8] = (torch.tensor(BATCHED_RHOS, device=dev) + 1.0) / 2.0
    err = {'K1': 0.0, 'K2': 0.0, 'rel': 0.0}
    for day in (0, 9, 17):
        args = batched_day(setup, m5, day)
        buf, loss = day_kernel.accumulate_day_batched(*args)
        again, loss_again = day_kernel.accumulate_day_batched(*args)
        want_buf, want_loss = day_kernel.accumulate_day_batched_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(buf, again) and torch.equal(loss, loss_again),
              'day {:2d}: two batched launches bitwise equal'.format(day))
        for i, rho in enumerate(BATCHED_RHOS):
            branch = 'K2' if abs(rho) > 0.925 else 'K1'
            be = float((buf[i] - want_buf[i]).abs().max())
            le = abs(float(loss[i]) - float(want_loss[i]))
            peak = float(want_buf[i].max())
            e, rel = max(be, le), be / peak
            tol = min(ABS_LIMIT, HI_TOL if branch == 'K2' else BUF_TOL)
            check(np.isfinite(e) and e <= tol and peak > 0 and
                  rel <= REL_LIMIT,
                  'day {:2d} particle {} rho {:+.3f} ({} by its Genz '
                  'tier): max |kernel - plain| = {:.3e} <= {:.0e}; / peak '
                  '{:.3e} <= {:.0e}'.format(day, i, rho, branch, e, tol, rel,
                                            REL_LIMIT))
            err[branch] = max(err[branch], e)
            err['rel'] = max(err['rel'], rel)

    # the launch timed at the main path's shapes: 8 prior particles, day 9
    args = batched_day(setup, m8, 9)
    passes = day_kernel.pass_ms(*args, reps=10)
    timing = dict(ms=median_ms(lambda: day_kernel.accumulate_day_batched(
        *args), 10), plain_ms=median_ms(
            lambda: day_kernel.accumulate_day_batched_plain(*args), 2),
        passes=np.median(passes, axis=0).tolist(),
        kernel_ms=float(np.median(passes.sum(axis=1))))
    h, mu, idx, clip, Dp, cell, K, buf_len = args
    counts = np.sum([forward_counts(h[i], mu[i], tuple(Dp[i]), cell, K,
                                    buf_len)
                     for i in range(8)], axis=0)
    timing['bound_ms'], timing['bound_by'], what = bound(*counts, rate)
    # the single-particle K1 launch on the same days, for the ratio
    one = tuple(a[0] for a in args[:4]) + (tuple(args[4][0]),) + args[5:]
    timing['k1_ms'] = median_ms(lambda: day_kernel.accumulate_day(*one), 10)
    print('  day 9, 8 particles: kernels {:.4f} ms (block_build {:.4f}, '
          'gather {:.4f}, reduce {:.4f}; CUDA events around the kernels '
          'alone, median of 10); wrapper {:.4f} ms ({:.4f} a particle; one '
          'particle\'s K1 launch {:.4f} ms); plain twin {:.4f} ms; bound '
          '{:.4f} ms by {} ({}); bound / kernels {:.3f} ({})'.format(
              timing['kernel_ms'], *timing['passes'], timing['ms'],
              timing['ms'] / 8, timing['k1_ms'], timing['plain_ms'],
              timing['bound_ms'], timing['bound_by'], what,
              timing['bound_ms'] / timing['kernel_ms'], card))

    # 2. each particle's batched forward against its own in-turn K1 one
    with torch.no_grad():
        got = bsetup.forward_projections(_as_model(m8))
        worst = 0.0
        for i in range(8):
            g = torch.cat([t[i].reshape(-1)
                           for t in (*got[0], *got[1], got[2])])
            w = flat_proj(setup.forward_projections(_as_model(m8[i])))
            d = (g - w).abs() - SCHEME_RTOL * w.abs()
            worst = max(worst, float(d.max()))
    check(worst <= SCHEME_ATOL,
          'each particle\'s batched projections within rtol {:.0e} / atol '
          '{:.0e} of its in-turn K1 forward (worst excess over the rtol '
          '{:.3e})'.format(SCHEME_RTOL, SCHEME_ATOL, worst))

    # 3.-5. the anneal: launches a move round, host reads, resume bitwise
    cfg = smc.SMCConfig(n_particles=8, n_moves=1, min_accepts=0.0,
                        max_move_rounds=1)
    db = os.path.join(work, 'smc_batched')
    rounds = []
    real_move = smc._move_prog

    def counted_move(*a, **k):
        before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BATCHED)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = real_move(*a, **k)
        torch.cuda.synchronize()
        rounds.append((day_kernel.LAUNCHES - before[0],
                       day_kernel.LAUNCHES_BATCHED - before[1],
                       time.perf_counter() - tic))
        return out

    class Stop(Exception):
        pass

    def stop_at(stage, keep, save=False):
        def cb(p):
            if save:
                bayes_run._save_smc(db, p, 0, cfg)
            keep.update(p)
            if p['stage'] == stage:
                raise Stop
        return cb

    zero_counts()
    mono, part, resumed = {}, {}, {}
    smc._move_prog = counted_move
    try:
        for keep, stage, save in ((mono, 5, False), (part, 3, True)):
            try:
                smc.run_smc(setup, 0, cfg, seed=0, batched=True,
                            checkpoint=stop_at(stage, keep, save))
            except Stop:
                pass
        payload, meta = bayes_run._smc_resume_payload(db, setup)
        try:
            smc.run_smc(setup, None, cfg, seed=0, resume=payload,
                        batched=True, checkpoint=stop_at(5, resumed))
        except Stop:
            pass
    finally:
        smc._move_prog = real_move
    launches, k1_anneal = day_kernel.LAUNCHES_BATCHED, day_kernel.LAUNCHES
    check(len(rounds) == 10 and all(r[:2] == (0, 18) for r in rounds),
          '{} move rounds, each {} batched launches and {} single ones'
          .format(len(rounds), sorted({r[1] for r in rounds}),
                  sorted({r[0] for r in rounds})))
    check(launches == 18 * 10 == 18 * sampler.BATCHED_FORWARDS,
          '{} batched launches = 18 x {} batched forwards; [15] needs 18 x '
          '8 single launches a round'.format(launches,
                                              sampler.BATCHED_FORWARDS))
    check(mono['stage'] == resumed['stage'] == 5 and meta['stage'] == 3 and
          states_equal(mono['states'], resumed['states']) and
          np.array_equal(mono['logw'], resumed['logw']) and
          mono['logz'] == resumed['logz'] and
          all(np.array_equal(mono['history'][k], resumed['history'][k])
              for k in mono['history']),
          'stopped after stage 3, resumed from the store to stage 5: bitwise '
          'the uninterrupted batched run (logZ {:.6f})'.format(mono['logz']))
    print('  beta by stage {}; acceptance {}'.format(
        ' '.join('{:.3g}'.format(v) for v in mono['history']['betas']),
        np.round(mono['history']['accept'], 3).tolist()))

    # 4. host reads of a move round, then 6. seconds per particle move in
    # turn and batched from the same states, and device busy time a round
    states = mono['states']
    beta = float(np.float32(mono['beta']))
    move = dict(
        batched=lambda st: smc._move_prog(bsetup, st, beta, 1, cfg.obs_scale,
                                          cfg.obs_sweeps, None, None, True),
        inturn=lambda st: smc._move_prog(setup, st, beta, 1, cfg.obs_scale,
                                         cfg.obs_sweeps))
    states = move['batched'](states)
    states, reads = count_host_reads(lambda: move['batched'](states))
    for r in reads:
        print('    host read: ' + r)
    check(not reads, 'a batched move round reads the card {} times'.format(
        len(reads)))
    sec = {'batched': [], 'inturn': []}
    for kind in ('inturn', 'batched', 'batched', 'inturn'):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        states = move[kind](states)
        torch.cuda.synchronize()
        sec[kind].append((time.perf_counter() - tic) / 8)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        states = move['batched'](states)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) * 1e-6
    n_dev = sum(e.count for e in events)
    check(busy > 0, 'the profiler saw the card')
    per_move = {k: float(np.mean(v)) for k, v in sec.items()}
    round_sec = [r[2] for r in rounds]
    print('  {:.4f} s per particle move batched, {:.4f} in turn (the same '
          'states, rounds in turns in-turn/batched/batched/in-turn, host '
          'clock); the anneal\'s batched rounds {:.3f}-{:.3f} s for 8 '
          'particles; [15]\'s in-turn figure {} ({})'.format(
              per_move['batched'], per_move['inturn'], min(round_sec),
              max(round_sec), 'not run' if smc_sec is None else
              '{:.4f} s'.format(smc_sec), card))
    print('  a batched move round: {} device launches, device busy {:.4f} s '
          '(idle share {:.3f})'.format(n_dev, busy,
                                       1.0 - busy / (8 * per_move['batched'])))
    sec_phase = time.perf_counter() - tic_phase
    print('  phase [18]: {:.1f} s'.format(sec_phase))
    return dict(launches=launches, k1=k1_anneal, err=err, timing=timing,
                sec_batched=per_move['batched'], sec_inturn=per_move['inturn'],
                busy=busy, device_launches=n_dev, sec_phase=sec_phase)


def phase_variants(dev, card, work):
    """The remaining forward variants and figures on the card: the forward
    CLI with ``ref_trunc=true`` at 801² (population model; day sums as in
    [5], no kernel launch), ``propagate_prob_logdepth`` with segment 1 and
    3 against ``propagate_prob`` on the Kalbar probability model's
    kernels (tests/test_solver.py's atol 3e-5), and the model-vs-data
    figures and the daily-kernel explorer from card tensors.  Returns
    (the ref_trunc CLI's seconds, the phase's seconds)."""
    from parasitoids_tpu_torch import cli
    from parasitoids_tpu_torch.io.locinfo import LocInfo
    from parasitoids_tpu_torch.models.forward import (build_all_kernels,
                                                      setup_forward)
    from parasitoids_tpu_torch.models.solver import (propagate_prob,
                                                     propagate_prob_logdepth)
    from parasitoids_tpu_torch.ops import day_kernel
    from parasitoids_tpu_torch.viz import compare, explore
    print('[19] ref_trunc CLI, log-depth propagation and figures on the '
          'card (801^2, 18 days)')
    tic_phase = time.perf_counter()
    zero_counts()
    tic = time.perf_counter()
    fields, days = cli.main(argv=['--pop', '--no_plot', '--no_output',
                                  'ref_trunc=True'], device=dev)
    torch.cuda.synchronize()
    sec_trunc = time.perf_counter() - tic
    check(day_kernel.LAUNCHES == 0 and day_kernel.LAUNCHES_BATCHED == 0,
          'ref_trunc CLI: no kernel launch ({} days on the plain accumulate '
          'in {:.2f} s; {})'.format(len(days), sec_trunc, card))
    check(tuple(fields.shape) == (18, 801, 801), 'ref_trunc CLI: fields {}'
          .format(tuple(fields.shape)))
    check_pop_sums(fields.sum(dim=(1, 2)).double().cpu().numpy(), 130000,
                   'ref_trunc CLI')

    pp = kalbar_params(pop=False)
    s = setup_forward(pp, device=dev)
    hp = (pp.lam, *pp.g_params, *pp.f_params)
    kernels, _ = build_all_kernels(
        s.wind_flat, s.wind_cumsum, hp, pp.Dparams, pp.Dlparams, pp.mu_r,
        pp.n_periods, s.rad_dist, 0, s.kcfg, s.ndays)
    seq = propagate_prob(kernels, s.scfg)
    for segment in (1, 3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        got = propagate_prob_logdepth(kernels, s.scfg, segment=segment)
        torch.cuda.synchronize()
        dt = time.perf_counter() - tic
        e = float((got - seq).abs().max())
        check(e <= 3e-5, 'propagate_prob_logdepth segment {}: max |d| '
              'against propagate_prob {:.3e} <= 3e-5 ({:.3f} s)'.format(
                  segment, e, dt))

    p = kalbar_params()
    locinfo = LocInfo(p.dataset, p.coord, p.domain_info)
    dlist = list(range(1, len(days) + 1))
    r2 = compare.grid_r_squared(fields, dlist, p, locinfo)
    check(set(r2['per_day']) and np.isfinite(r2['pooled']),
          'grid_r_squared from the card\'s fields: pooled {:.4f}, by day {}'
          .format(r2['pooled'], {k: round(v, 4)
                                 for k, v in r2['per_day'].items()}))
    before = day_kernel.LAUNCHES
    pmf, loss, _, _ = explore.daily_kernel_field(day_index=9, device=dev)
    torch.cuda.synchronize()
    check(pmf.device.type == 'cuda' and day_kernel.LAUNCHES == before + 1
          and abs(float(pmf.sum()) - 1.0) <= 1e-4,
          'the explorer\'s daily kernel built on the card through one K1 '
          'launch (sum {:.6f}, loss {:.3e})'.format(float(pmf.sum()),
                                                     float(loss)))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print('  figures: matplotlib is not installed on this machine, so '
              'compare_emergence, assess_fit and plot_daily_kernel draw '
              'nothing here (the CPU tests write them)')
    else:
        here = os.path.join(work, 'figures')
        os.makedirs(here, exist_ok=True)
        outs = [compare.compare_emergence(fields, dlist, p, locinfo,
                                          os.path.join(here, 'ce.png')),
                compare.assess_fit(fields, dlist, p, locinfo,
                                   os.path.join(here, 'af.png')),
                explore.plot_daily_kernel(day_index=9, device=dev,
                                          outfile=os.path.join(here,
                                                               'dk.png'))]
        check(all(os.path.getsize(o) > 0 for o in outs),
              'figures written from card tensors: {}'.format(
                  [os.path.basename(o) for o in outs]))
    sec_phase = time.perf_counter() - tic_phase
    print('  phase [19]: {:.1f} s'.format(sec_phase))
    return sec_trunc, day_kernel.LAUNCHES, sec_phase


def sync_all():
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_devices():
    """The devices of [20]'s member meshes: on one card, that card twice;
    on more, the first two.  Returns (member devices, repeated)."""
    if torch.cuda.device_count() == 1:
        return [torch.device('cuda', 0)] * 2, True
    return [torch.device('cuda', i) for i in range(2)], False


def payload_equal(a, b):
    """Two SMC payloads bitwise equal: particles, generators, weights,
    evidence and history."""
    return (states_equal(a['states'], b['states']) and
            np.array_equal(a['logw'], b['logw']) and a['logz'] == b['logz']
            and all(np.array_equal(a['history'][k], b['history'][k])
                    for k in a['history']))


def phase_meshes(dev, card, work):
    """The member meshes on the card at the Bayes default (801², 25 m, 18
    days, T = 1,440, K = 44, Kl = 20), each bitwise its run without a
    mesh: ``run_chains`` (2 chains × 10 steps), a store written from the
    mesh and resumed on it, ``run_pt_sharded`` (2 rungs, 2 rounds), SMC (4
    particles, one stage, in turn and batched) and
    ``ensemble_projections`` (4 draws).  Counts zeroed just before each
    part and read just after.  Returns the launch counts."""
    from parasitoids_tpu_torch.bayes import run as bayes_run
    from parasitoids_tpu_torch.bayes import sampler, smc, tempering
    from parasitoids_tpu_torch.bayes.store import load_chain, save_chain
    from parasitoids_tpu_torch.ops import day_kernel
    from parasitoids_tpu_torch.parallel.chains import (chain_mesh,
                                                       init_chains,
                                                       run_chains)
    from parasitoids_tpu_torch.parallel.ensemble import ensemble_projections
    print('[20] member meshes on the card at the Bayes default (801^2, 18 '
          'days, T = 1440, K = 44, Kl = 20)')
    tic_phase = time.perf_counter()
    member_devs, repeated = mesh_devices()
    print('  {} card(s) visible; member mesh on {}{} ({})'.format(
        torch.cuda.device_count(), ', '.join(str(d) for d in member_devs),
        ': one card named more than once, so the shards run one after the '
        'other on it and no concurrency across cards is measured'
        if repeated else '', card))
    setup = bayes_run.build_setup(device=dev)
    s = setup.setup
    check((s.kcfg.K, s.kcfg.K_local, setup.ndays, s.kcfg.periods,
           2 * s.kcfg.rad_res + 1) == (44, 20, 18, 1440, 801) and
          s.kcfg.pallas, 'the Bayes default on the CUDA kernels: K = 44, '
          'Kl = 20, 18 days, T = 1440, 801^2')

    members = chain_mesh(devices=member_devs)
    zero_counts()
    tic = time.perf_counter()
    st_m, tr_m = run_chains(setup, init_chains(setup, 0, 2),
                            sampler.MCMCConfig(10), mesh=members)
    sync_all()
    sec_chains = time.perf_counter() - tic
    k1_chains, fwd_chains = day_kernel.LAUNCHES, sampler.FORWARDS
    check(k1_chains == 18 * fwd_chains and fwd_chains >= 2,
          'run_chains on the mesh: {} K1 launches = 18 x {} forwards'.format(
              k1_chains, fwd_chains))
    st_r, tr_r = run_chains(setup, init_chains(setup, 0, 2),
                            sampler.MCMCConfig(10))
    check(torch.equal(tr_m, tr_r) and states_equal(st_m, st_r),
          'run_chains, 2 chains x 10 steps on {} devices, bitwise equal to '
          'mesh=None ({:.2f} s on the mesh)'.format(members.size,
                                                    sec_chains))
    db = os.path.join(work, 'mesh_store')
    save_chain(db, tr_m, st_m, meta={'chains': 2})
    _, st_l, _ = load_chain(db, setup)
    zero_counts()
    st_a, tr_a = run_chains(setup, st_m, sampler.MCMCConfig(5), mesh=members)
    st_b, tr_b = run_chains(setup, st_l, sampler.MCMCConfig(5), mesh=members)
    sync_all()
    k1_store = day_kernel.LAUNCHES
    check(torch.equal(tr_a, tr_b) and states_equal(st_a, st_b),
          'a store written from the mesh and resumed on it: 5 more steps '
          'bitwise equal to 5 from memory')

    betas = tempering.power_ladder(2)
    cfg = tempering.PTConfig(n_rounds=2, swap_every=2)
    zero_counts()
    pt_m = tempering.run_pt_sharded(setup, tempering.init_pt_states(
        setup, 1, 2), betas, 3, cfg, members)
    sync_all()
    k1_pt = day_kernel.LAUNCHES
    pt_r = tempering.run_pt(setup, tempering.init_pt_states(setup, 1, 2),
                            betas, 3, cfg)
    check(states_equal(pt_m[0], pt_r[0]) and torch.equal(pt_m[1], pt_r[1])
          and all(torch.equal(pt_m[2][k], pt_r[2][k]) for k in pt_r[2]),
          'run_pt_sharded, 2 rungs x 2 rounds of 2 steps, bitwise equal to '
          'run_pt (swaps accepted {})'.format(
              pt_m[2]['swap_accepts'].tolist()))

    class Stop(Exception):
        pass

    def stage_one(**kw):
        keep = {}

        def cb(p):
            keep.update(p)
            raise Stop
        try:
            smc.run_smc(setup, 4, smc.SMCConfig(
                n_particles=4, n_moves=1, min_accepts=0.0,
                max_move_rounds=1), seed=4, checkpoint=cb, **kw)
        except Stop:
            pass
        return keep

    k1_smc = kb_smc = 0
    for batched in (False, True):
        zero_counts()
        got_p = stage_one(mesh=members, batched=batched)
        sync_all()
        k1_smc += day_kernel.LAUNCHES
        kb_smc += day_kernel.LAUNCHES_BATCHED
        want_p = stage_one(batched=batched)
        if not batched:
            check(payload_equal(got_p, want_p),
                  'SMC in turn, 4 particles to stage 1 on the mesh, bitwise '
                  'equal to the stacked run')
            continue
        # a batch of 2 a shard sums each particle's reductions in another
        # order than the stacked batch of 4 (torch splits a reduction over
        # blocks by its count of outputs), so the batched moves agree to
        # f32 summation order, not bitwise: the same decisions, positions
        # within [18]'s batched-vs-in-turn rtol, and two mesh runs bitwise
        again_p = stage_one(mesh=members, batched=True)
        a, b = got_p['states'], want_p['states']
        dm = float(((a.m - b.m).abs() / b.m.abs().clamp(min=1e-30)).max())
        dll = float((a.loglik - b.loglik).abs().max())
        check(payload_equal(got_p, again_p),
              'SMC batched on the mesh: two runs bitwise equal')
        check(torch.equal(a.accepts_m, b.accepts_m) and
              torch.equal(a.accepts_o, b.accepts_o) and
              np.array_equal(got_p['history']['accept'],
                             want_p['history']['accept']) and
              dm <= BATCHED_MESH_RTOL,
              'SMC batched, 4 particles to stage 1 on the mesh against the '
              'stacked batch: the same acceptances, positions within {:.3e} '
              '<= {:.0e} of theirs (log likelihoods {:.3e} apart; not '
              'bitwise: the batch of 2 a shard sums in another order)'
              .format(dm, BATCHED_MESH_RTOL, dll))
    check(kb_smc == 18 * members.size,
          '{} batched launches for the batched move round on the mesh = 18 '
          'days x {} shards of 2 particles'.format(kb_smc, members.size))

    thetas = torch.cat([st_a.m, st_m.m])
    zero_counts()
    ens_m = ensemble_projections(setup, thetas, mesh=members)
    sync_all()
    k1_ens = day_kernel.LAUNCHES
    ens_r = ensemble_projections(setup, thetas)
    check(k1_ens == 18 * 4 and torch.equal(flat_proj(ens_m),
                                           flat_proj(ens_r)),
          'ensemble_projections, 4 draws on the mesh: {} K1 launches, '
          'bitwise equal to mesh=None'.format(k1_ens))
    sec_phase = time.perf_counter() - tic_phase
    print('  phase [20]: {:.1f} s'.format(sec_phase))
    return {'k1': k1_chains + k1_store + k1_pt + k1_smc + k1_ens,
            'batched': kb_smc, 'repeated': repeated, 'sec_phase': sec_phase}


def profiled(fn, reps):
    """Device kernels, device busy seconds and host launch calls per call
    of ``fn`` over ``reps`` calls under the profiler (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU and
            'Launch' in e.key]
    return (sum(e.count for e in on_card) / reps,
            sum(e.self_device_time_total for e in on_card) * 1e-6 / reps,
            sum(e.count for e in host) / reps)


def in_turns(calls, reps):
    """Median host seconds per call of ``calls['eager']`` and
    ``calls['graph']`` (each ending in a synchronize), ``reps`` calls each
    in the turns eager, graph, graph, eager."""
    secs = {'eager': [], 'graph': []}
    for kind in ('eager', 'graph', 'graph', 'eager'):
        for _ in range(reps):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            calls[kind]()
            torch.cuda.synchronize()
            secs[kind].append(time.perf_counter() - tic)
    return {k: float(np.median(v)) for k, v in secs.items()}


def phase_graphs(dev, card):
    """The evaluation replayed as CUDA graphs (``utils/graphs.py``) at the
    Bayes default (801², 25 m, K = 44, Kl = 20, 18 days): the no-gradient
    forward, the value+gradient (pre-spread day) and the batched forward
    of 8 prior particles, each bitwise its eager run for two parameter
    sets; then, eager against graphed in turns, seconds, device kernels,
    host launch calls and device busy seconds of an AM step, a
    value+gradient (a NUTS leapfrog's evaluation) and a batched SMC move
    round of 8, and every capture's seconds and graph-pool bytes."""
    import copy

    from parasitoids_tpu_torch.bayes import map_fit, sampler, smc
    from parasitoids_tpu_torch.bayes.model import (BayesSetup, _as_model,
                                                   _kalbar_default_params)
    from parasitoids_tpu_torch.bayes.priors import sample_prior_model
    from parasitoids_tpu_torch.ops import day_kernel
    print('[21] the evaluation as CUDA graphs at the Bayes default (801^2, '
          '18 days, K = 44, Kl = 20): graph replay against the eager path')
    tic_phase = time.perf_counter()
    setup = BayesSetup(_kalbar_default_params(), device=dev)
    eager = copy.copy(setup)
    eager._replays_graphs = lambda: False
    check(setup._replays_graphs() and setup.setup.kcfg.K == 44 and
          setup.ndays == 18, 'the setup replays graphs through the day '
          'kernel (K = 44, 18 days); its copy runs eagerly')

    # 1. bitwise, two parameter sets a key
    neg = {k: map_fit._make_objective(s, True)[0]
           for k, s in (('graph', setup), ('eager', eager))}
    _, constrain, _ = map_fit._make_objective(setup, True)
    z0 = map_fit.initial_z(setup, True)
    for i, z in enumerate((z0, z0 + 0.01)):
        m, _, sprd = constrain(z)
        with torch.no_grad():
            a, b = [flat_proj(s.forward_projections(_as_model(m), sprd))
                    for s in (setup, eager)]
        check(torch.equal(a, b), 'parameter set {}: the no-gradient forward '
              'replayed bitwise its eager run ({} projections)'.format(
                  i, a.numel()))
        before = (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD)
        (va, ga), (vb, gb) = [value_and_grad(neg[k], z)
                              for k in ('graph', 'eager')]
        torch.cuda.synchronize()
        check(va == vb and np.array_equal(ga, gb) and
              (day_kernel.LAUNCHES - before[0],
               day_kernel.LAUNCHES_BWD - before[1]) == (36, 36),
              'parameter set {}: the value+gradient replayed bitwise its '
              'eager run (value {!r}, {} components); 18 K1 and 18 K3 '
              'launches each'.format(i, va, ga.size))
    bsetup, beager = setup.with_batched_bvn(), eager.with_batched_bvn()
    for seed in (18, 19):
        m8 = _as_model(sample_prior_model(torch.Generator().manual_seed(seed),
                                          8).to(dev))
        before = day_kernel.LAUNCHES_BATCHED
        with torch.no_grad():
            a, b = [flat_proj(s.forward_projections(m8))
                    for s in (bsetup, beager)]
        check(torch.equal(a, b) and
              day_kernel.LAUNCHES_BATCHED - before == 36,
              'prior draws of seed {}: the batched forward of 8 particles '
              'replayed bitwise its eager run ({} projections; 18 batched '
              'launches each)'.format(seed, a.numel()))

    # 2. eager against graphed: an AM step, a value+gradient, a batched
    # move round of 8
    cfg = smc.SMCConfig(n_particles=8, n_moves=1)
    states = smc.init_smc_particles(eager, 0, 8)
    am = {k: [sampler.init_chain_state(s, sampler.chain_generator(0, 0, dev))]
          for k, s in (('graph', setup), ('eager', eager))}
    moved = {'graph': [states], 'eager': [states]}

    def am_step(kind):
        s = setup if kind == 'graph' else eager
        am[kind][0] = sampler._mcmc_step(s, am[kind][0],
                                         sampler.MCMCConfig(1))[0]

    def move_round(kind):
        s = bsetup if kind == 'graph' else beager
        moved[kind][0] = smc._move_prog(s, moved[kind][0], 0.5, 1,
                                        cfg.obs_scale, cfg.obs_sweeps, None,
                                        None, True)

    paths = {
        'AM step': (am_step, 10),
        'value+gradient (a NUTS leapfrog\'s evaluation)': (
            lambda kind: value_and_grad(neg[kind], z0), 5),
        'batched SMC move round of 8': (move_round, 3)}
    out = {}
    for name, (fn, reps) in paths.items():
        for kind in ('graph', 'eager'):
            fn(kind)                   # a capture comes before the timing
        sec = in_turns({k: (lambda k=k: fn(k)) for k in ('eager', 'graph')},
                       reps)
        prof = {k: profiled(lambda k=k: fn(k), 2) for k in ('eager', 'graph')}
        out[name] = dict(sec=sec, prof=prof)
        for k in ('eager', 'graph'):
            kernels, busy, host = prof[k]
            print('  {}, {}: {:.4f} s (median of {} in turns), {:.0f} device '
                  'kernels, {:.0f} host launch calls, device busy {:.4f} s '
                  '(idle share {:.3f}; {})'.format(
                      name, k, sec[k], 2 * reps, kernels, host, busy,
                      1.0 - busy / sec[k], card))
        print('  {}: graphed / eager {:.3f}'.format(
            name, sec['graph'] / sec['eager']))
    caps = setup.graphs.summary()
    for key, seconds, pool in caps:
        print('  capture {} ({}): {:.3f} s, graph pool {:.1f} MiB'.format(
            key[0][:2], 'gradient' if key[1] else 'no gradient', seconds,
            pool / 2 ** 20))
    sec_phase = time.perf_counter() - tic_phase
    print('  phase [21]: {:.1f} s'.format(sec_phase))
    pick = lambda name, k: out[name]['sec'][k]
    names = list(paths)
    return {
        'sec_per_am_step_801_eager': pick(names[0], 'eager'),
        'sec_per_am_step_801_graphed': pick(names[0], 'graph'),
        'sec_per_value_and_grad_801_eager': pick(names[1], 'eager'),
        'sec_per_value_and_grad_801_graphed': pick(names[1], 'graph'),
        'sec_per_batched_round_of_8_801_eager': pick(names[2], 'eager'),
        'sec_per_batched_round_of_8_801_graphed': pick(names[2], 'graph'),
        'device_busy_sec_eager_graphed': {
            n: [out[n]['prof'][k][1] for k in ('eager', 'graph')]
            for n in names},
        'captures': len(caps),
        'capture_sec_max': max(c[1] for c in caps),
        'graph_pool_bytes': sum(c[2] for c in caps),
        'sec_phase_21': sec_phase}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog='chip_smoke.py')
    ap.add_argument('--only', default=None, metavar='N,N',
                    help='run only these phases (1, 2 and the checks of '
                         'imports always run; 13 needs 9), e.g. 14,15,16,17 '
                         'for the tempered and evidence samplers, 18,19 for '
                         'the batched SMC moves and the forward variants, 20 '
                         'for the meshes, 21 for the evaluation as CUDA '
                         'graphs; no result line')
    args = ap.parse_args(argv)
    only = (None if args.only is None else
            {int(v) for v in args.only.split(',')})
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible to torch', file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as work:
        return run(only, work)


def run(only, work):
    """Every phase (or those of ``only``) with ``work`` as the directory
    that [9]'s store and [13]'s report share."""
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)                     # data/ is addressed repo-relative
    from parasitoids_tpu_torch.ops import _build

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    card = '{} ({})'.format(torch.cuda.get_device_name(0), smi)
    dev = torch.device('cuda', 0)
    print('[1] torch {}, CUDA {}, device {}'.format(
        torch.__version__, torch.version.cuda, card))
    nvcc = subprocess.run([_build.nvcc_path(), '--version'],
                          capture_output=True, text=True, check=True).stdout
    print('  nvcc: ' + nvcc.strip().splitlines()[-1])

    print('[2] build')
    tic = time.perf_counter()
    _build.load('day_kernel')
    print('  day_kernel built and loaded in {:.2f} s'.format(
        time.perf_counter() - tic))
    rate = sfu_rate()
    print('  bounds: {:.4g} exps/s (SFU), {:.3g} f32 FLOP/s, {:.3g} B/s'
          .format(rate, F32_FLOPS_PER_S, HBM_BYTES_PER_S))

    if only is not None:
        return run_some(only, dev, card, rate, work)
    err, timing = phase_kernel_vs_plain(dev, card, rate)
    phase_goldens(dev)
    launches, sec, per_sim = phase_main_path(dev, card)
    bwd_err, bwd_abs, bwd_timing = phase_backward_vs_plain(dev, card, rate)
    sec_v, sec_vg, peak, sec_plain, grad_dv, grad_l2 = \
        phase_posterior_gradient(dev, card)
    map_launches, sec_step, sec_vg_401, gold_dv, gold_l2 = \
        phase_map_cli(dev, card)
    (am_launches, am_forwards, am_step, am_model, am_sweep, am_per_step,
     am_busy) = phase_am_cli(dev, card, work)
    (nuts_k1, nuts_k3, nuts_vg, nuts_leap, nuts_trans, nuts_leaps,
     nuts_reads, nuts_sec, nuts_launches, nuts_busy) = phase_nuts_cli(dev,
                                                                      card)
    lap_launches, lap401 = phase_laplace_cli(dev, card)
    ridge_k1, ridge_k3, lap801, ridge_sec = phase_ridge_cli(dev, card)
    sum_k1, members, sec_member, sec_report = phase_summary_cli(dev, card,
                                                                work)
    pt_k1, pt_forwards, pt_sec, pt_phase = phase_pt_cli(dev, card, work)
    smc_k1, smc_forwards, smc_sec, smc_phase = phase_smc(dev, card, work)
    vi_k1, vi_k3, vi_sec, vi_phase = phase_vi_cli(dev, card, work)
    sbc_k1, small_k1, sbc_sec, p17_phase = phase_sbc_and_anneals(dev, card,
                                                                 work)
    bat = phase_smc_batched(dev, card, rate, work, smc_sec)
    trunc_sec, var_k1, p19_phase = phase_variants(dev, card, work)
    mesh = phase_meshes(dev, card, work)
    graphed = phase_graphs(dev, card)
    check(launches > 0 and min(map_launches) > 0 and am_launches > 0 and
          min(nuts_k1, nuts_k3) > 0 and min(lap_launches) > 0 and
          min(ridge_k1, ridge_k3) > 0 and sum_k1 > 0 and
          min(pt_k1, smc_k1, vi_k1, vi_k3, sbc_k1, small_k1) > 0 and
          bat['launches'] > 0 and var_k1 > 0 and
          min(mesh['k1'], mesh['batched']) > 0,
          'both kernels launched on their main paths, the forward kernel on '
          'the AM path too, both on the NUTS, Laplace and ridge paths, the '
          'forward kernel on the summary, PT, SMC, SBC and CV paths, both '
          'on the ADVI path, the batched forward on the batched SMC path, '
          'the forward and the batched forward on the mesh paths')
    check_imports()

    k1, k2 = timing['K1'], timing['K2']
    k3, k4 = bwd_timing['K3'], bwd_timing['K4']
    kernels = [{
        'name': 'day_accumulate (K1 low-|rho| + K2 high-|rho|)',
        'route': 'cuda',
        'source': 'parasitoids_tpu_torch/csrc/day_kernel.cu',
        'replaces': 'parasitoids_tpu/ops/pallas_kernel.py:157',
        'launches': (launches + nuts_k1 + lap_launches[0] + ridge_k1 +
                     sum_k1 + pt_k1 + smc_k1 + vi_k1 + sbc_k1 + small_k1 +
                     bat['k1'] + var_k1 + mesh['k1']),
        'launches_meshes': mesh['k1'],
        'mesh_repeats_one_card': mesh['repeated'],
        'sec_phase_20': mesh['sec_phase'],
        'launches_smc_batched_init': bat['k1'],
        'launches_explorer': var_k1,
        'launches_main_path': launches, 'launches_nuts_cli': nuts_k1,
        'launches_pt_cli': pt_k1, 'forwards_pt_cli': pt_forwards,
        'sec_per_pt_replica_step_801': pt_sec, 'sec_phase_14': pt_phase,
        'launches_smc': smc_k1, 'forwards_smc': smc_forwards,
        'sec_per_smc_particle_move_801': smc_sec, 'sec_phase_15': smc_phase,
        'launches_vi_cli': vi_k1, 'sec_phase_16': vi_phase,
        'launches_sbc_cli': sbc_k1, 'sec_sbc_2_replicates_801': sbc_sec,
        'launches_small_smc_and_cv': small_k1, 'sec_phase_17': p17_phase,
        'launches_laplace_cli': lap_launches[0],
        'launches_ridge_cli': ridge_k1, 'launches_summary_cli': sum_k1,
        'summary_ensemble_members': members,
        'sec_per_ensemble_member_801': sec_member,
        'sec_summary_report_801': sec_report,
        'launches_per_simulation': per_sim,
        'max_abs_err': max(err['K1'], err['K2']),
        'max_abs_err_k1': err['K1'], 'max_abs_err_k2': err['K2'],
        'max_err_over_peak': err['rel'],
        'ms': k1['ms'], 'ms_constants_packed_once': k1['ms_hoisted'],
        'plain_ms': k1['plain_ms'],
        'kernel_ms': k1['kernel_ms'],
        'block_build_ms': k1['passes'][0], 'gather_ms': k1['passes'][1],
        'reduce_ms': k1['passes'][2],
        'bound_ms': k1['bound_ms'], 'bound_by': k1['bound_by'],
        'library_ms': None,
        'ms_k2': k2['ms'], 'plain_ms_k2': k2['plain_ms'],
        'kernel_ms_k2': k2['kernel_ms'],
        'block_build_ms_k2': k2['passes'][0],
        'gather_ms_k2': k2['passes'][1], 'reduce_ms_k2': k2['passes'][2],
        'bound_ms_k2': k2['bound_ms'], 'bound_by_k2': k2['bound_by'],
        'sec_per_simulation': sec,
        'sec_per_value_and_grad_801': sec_vg,
        'launches_map_cli': map_launches[0],
        'launches_am_cli': am_launches, 'forwards_am_cli': am_forwards,
        'sec_per_am_step_801': am_step,
        'sec_per_am_model_block_801': am_model,
        'sec_per_am_obs_sweep_801': am_sweep,
        'device_launches_per_am_step_801': am_per_step,
        'device_busy_sec_per_am_step_801': am_busy,
        'graph_replay_801': graphed,
    }, {
        'name': 'day_accumulate_bwd (K3 low-|rho| + K4 high-|rho|)',
        'route': 'cuda',
        'source': 'parasitoids_tpu_torch/csrc/day_kernel.cu',
        'replaces': 'parasitoids_tpu/ops/pallas_kernel.py:326',
        'launches': (map_launches[1] + nuts_k3 + lap_launches[1] +
                     ridge_k3 + vi_k3),
        'launches_map_cli': map_launches[1], 'launches_nuts_cli': nuts_k3,
        'launches_vi_cli': vi_k3, 'sec_per_elbo_step_801': vi_sec,
        'launches_laplace_cli': lap_launches[1],
        'launches_ridge_cli': ridge_k3,
        'hessian_precision': lap401['precision'],
        'sec_hessian_401': lap401['seconds'],
        'sec_per_hessian_column_401': lap401['seconds'] / 26,
        'peak_bytes_hessian_401': lap401['peak_bytes'],
        'sec_hessian_801': lap801['seconds'],
        'sec_per_hessian_column_801': lap801['seconds'] / 25,
        'peak_bytes_hessian_801': lap801['peak_bytes'],
        'sec_ridge_cli_801': ridge_sec,
        'max_abs_err': max(bwd_abs.values()),
        'max_err_over_scale_k3': bwd_err['K3'],
        'max_err_over_scale_k4': bwd_err['K4'],
        'ms': k3['ms'], 'ms_constants_packed_once': k3['ms_hoisted'],
        'plain_ms': k3['plain_ms'],
        'kernel_ms': k3['kernel_ms'],
        'block_bwd_ms': k3['passes'][0], 'bwd_reduce_ms': k3['passes'][1],
        'bound_ms': k3['bound_ms'], 'bound_by': k3['bound_by'],
        'library_ms': None,
        'ms_k4': k4['ms'], 'plain_ms_k4': k4['plain_ms'],
        'kernel_ms_k4': k4['kernel_ms'],
        'block_bwd_ms_k4': k4['passes'][0],
        'bwd_reduce_ms_k4': k4['passes'][1],
        'bound_ms_k4': k4['bound_ms'], 'bound_by_k4': k4['bound_by'],
        'sec_per_value_801': sec_v,
        'sec_per_value_and_grad_801': sec_vg,
        'sec_per_value_and_grad_801_plain': sec_plain,
        'peak_bytes_value_and_grad_801': peak,
        'grad_vs_plain_801_rel_l2': grad_l2,
        'value_vs_plain_801_rel': grad_dv,
        'sec_per_value_and_grad_401': sec_vg_401,
        'sec_per_map_step_401': sec_step,
        'golden_value_rel_401': gold_dv,
        'golden_grad_rel_l2_401': gold_l2,
        'nuts_value_and_grads': nuts_vg,
        'sec_per_nuts_leapfrog_801': nuts_leap,
        'sec_per_nuts_transition_per_chain_801': nuts_trans,
        'nuts_leapfrogs_per_draw_801': nuts_leaps,
        'nuts_host_reads_per_leapfrog': nuts_reads,
        'sec_nuts_cli_801': nuts_sec,
        'device_launches_per_nuts_leapfrog_801': nuts_launches,
        'device_busy_sec_per_nuts_leapfrog_801': nuts_busy,
    }, {
        'name': 'day_accumulate particle-batched (K1/K2 by each particle\'s '
                'Genz tier, one launch a day for the population)',
        'route': 'cuda',
        'source': 'parasitoids_tpu_torch/csrc/day_kernel.cu',
        'replaces': 'parasitoids_tpu/ops/pallas_kernel.py:157',
        'launches': bat['launches'] + mesh['batched'], 'particles': 8,
        'launches_meshes': mesh['batched'],
        'max_abs_err': max(bat['err']['K1'], bat['err']['K2']),
        'max_abs_err_k1': bat['err']['K1'],
        'max_abs_err_k2': bat['err']['K2'],
        'max_err_over_peak': bat['err']['rel'],
        'ms': bat['timing']['ms'], 'plain_ms': bat['timing']['plain_ms'],
        'kernel_ms': bat['timing']['kernel_ms'],
        'block_build_ms': bat['timing']['passes'][0],
        'gather_ms': bat['timing']['passes'][1],
        'reduce_ms': bat['timing']['passes'][2],
        'single_particle_k1_ms': bat['timing']['k1_ms'],
        'bound_ms': bat['timing']['bound_ms'],
        'bound_by': bat['timing']['bound_by'],
        'library_ms': None,
        'sec_per_particle_move_batched_801': bat['sec_batched'],
        'sec_per_particle_move_in_turn_801': bat['sec_inturn'],
        'device_busy_sec_per_batched_round_801': bat['busy'],
        'device_launches_per_batched_round_801': bat['device_launches'],
        'sec_phase_18': bat['sec_phase'],
        'sec_ref_trunc_cli_801': trunc_sec, 'sec_phase_19': p19_phase,
    }]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def check_imports():
    check('jax' not in sys.modules, 'no JAX module was imported')
    jax_pkg = sorted(k for k in sys.modules if k == 'parasitoids_tpu' or
                     k.startswith('parasitoids_tpu.'))
    check(not jax_pkg, 'no module of the JAX package was imported {}'.format(
        jax_pkg or ''))


def run_some(only, dev, card, rate, work):
    """The phases of ``only`` alone (a development run): no result line."""
    phases = {
        3: lambda: phase_kernel_vs_plain(dev, card, rate),
        4: lambda: phase_goldens(dev),
        5: lambda: phase_main_path(dev, card),
        6: lambda: phase_backward_vs_plain(dev, card, rate),
        7: lambda: phase_posterior_gradient(dev, card),
        8: lambda: phase_map_cli(dev, card),
        9: lambda: phase_am_cli(dev, card, work),
        10: lambda: phase_nuts_cli(dev, card),
        11: lambda: phase_laplace_cli(dev, card),
        12: lambda: phase_ridge_cli(dev, card),
        13: lambda: phase_summary_cli(dev, card, work),
        14: lambda: phase_pt_cli(dev, card, work),
        15: lambda: phase_smc(dev, card, work),
        16: lambda: phase_vi_cli(dev, card, work),
        17: lambda: phase_sbc_and_anneals(dev, card, work),
        18: lambda: phase_smc_batched(dev, card, rate, work),
        19: lambda: phase_variants(dev, card, work),
        20: lambda: phase_meshes(dev, card, work),
        21: lambda: phase_graphs(dev, card)}
    failed = []
    for n in sorted(only | ({9} if 13 in only else set())):
        tic = time.perf_counter()
        try:
            phases[n]()
        except SmokeError as e:
            failed.append(n)
            print('  FAILED: phase [{}]: {}'.format(n, e))
        print('  phase [{}] took {:.1f} s'.format(n,
                                                 time.perf_counter() - tic))
    check_imports()
    print('partial run of phases {}: no result line; failed: {}'.format(
        sorted(only), failed))
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())

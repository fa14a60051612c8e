"""Multi-day FFT-convolution propagation, PyTorch port of
``parasitoids_tpu/models/solver.py`` (reference CalcSol.py).

Fields stay dense on the device, transforms are real FFTs
(``torch.fft.rfft2``/``irfft2``, cuFFT on CUDA) on a static pad
P ≥ D + rad_res, which is alias-free for every single-kernel convolution
of a domain-limited signal, and the absorbing boundary truncates the field
to the domain every day.  The population model carries each release
cohort as its own field and advances all cohorts with one batched FFT per
day; a leading particle axis on its kernels advances a whole population
in the same transforms.  :func:`propagate_prob_logdepth` is the JAX
module's log-depth variant (prefix products of the day spectra), pure or
with the absorbing boundary every ``segment`` days.  See the JAX module
for the derivations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.daily_kernel import r_small_vals_dense
from ..utils import trace

__all__ = ['SolverConfig', 'signal_fft', 'filter_fft', 'fft_conv_once',
           'propagate_prob', 'propagate_prob_logdepth', 'propagate_pop',
           'next_fast_len']


def next_fast_len(n: int) -> int:
    """Smallest integer >= n of the form 2^k, 3*2^k or 5*2^k — the JAX
    package's rule (chosen from TPU timings), kept so that both packages
    transform the same padded grid (P = 1280 at D = 801).  Choosing P for
    cuFFT is later work."""
    best = 1 << (n - 1).bit_length()
    for odd in (3, 5):
        p = odd
        while p < n:
            p *= 2
        if p < best:
            best = p
    return best


class SolverConfig(NamedTuple):
    dom_len: int     # D = 2*rad_res + 1
    fft_len: int     # P >= D + rad_res for alias-free daily convolution

    @classmethod
    def for_domain(cls, rad_res: int):
        """Alias-free transform size for the daily chain: every daily kernel
        is a centred D x D array (support radius <= rad_res) and the signal
        is domain-limited, so P >= D + rad_res never aliases into the
        domain."""
        D = 2 * rad_res + 1
        return cls(dom_len=D, fft_len=next_fast_len(D + rad_res))


def signal_fft(field, P):
    """Real FFT of a domain field placed at the top-left of the padded
    grid (ref CalcSol.fft2)."""
    D = field.shape[-1]
    return torch.fft.rfft2(F.pad(field, (0, P - D, 0, P - D)))


def filter_fft(kernel, P):
    """Real FFT of an odd-sized kernel, corner-shifted so its centre sits at
    index (0, 0) with wraparound (ref CalcSol.fftconv2)."""
    D = kernel.shape[-1]
    c = D // 2
    shifted = torch.roll(F.pad(kernel, (0, P - D, 0, P - D)), (-c, -c),
                         dims=(-2, -1))
    return torch.fft.rfft2(shifted)


def _irfft(x_hat, P):
    return torch.fft.irfft2(x_hat, s=(P, P))


def fft_conv_once(field, kernel, P):
    """One alias-free FFT convolution of a domain field with a domain-sized
    kernel."""
    D = field.shape[-1]
    out = _irfft(signal_fft(field, P) * filter_fft(kernel, P), P)
    return out[..., :D, :D]


def propagate_prob(kernels, config: SolverConfig):
    """Chain daily kernels into per-day probability fields (ref
    CalcSol.get_solutions).

    Args:
        kernels: (ndays, D, D) daily pmfs; day 0 is the initial spread.
    Returns:
        (ndays, D, D) fields, each thresholded at 1e-8 with the removed mass
        redistributed.
    """
    D, P = config.dom_len, config.fft_len
    # every daily filter transform in one batched FFT
    k_hat = filter_fft(kernels[1:], P)
    out = torch.empty_like(kernels)
    out[0] = kernels[0]
    dom = kernels[0]
    for d in range(1, kernels.shape[0]):
        dom = _irfft(signal_fft(dom, P) * k_hat[d - 1], P)[:D, :D]
        out[d] = r_small_vals_dense(dom, prob_model=True)
    return out


def _prefix_products(x, dim):
    """Inclusive running product of ``x`` along ``dim`` in log depth
    (Hillis–Steele: ⌈log2 n⌉ rounds of elementwise products), the
    counterpart of ``lax.associative_scan(jnp.multiply, ...)``."""
    n = x.shape[dim]
    step = 1
    while step < n:
        head = x.narrow(dim, 0, step)
        x = torch.cat([head, x.narrow(dim, step, n - step) *
                       x.narrow(dim, 0, n - step)], dim=dim)
        step *= 2
    return x


def propagate_prob_logdepth(kernels, config: SolverConfig, segment=None):
    """Log-depth variant of :func:`propagate_prob` (JAX
    ``propagate_prob_logdepth``): day d's field is the initial spread
    times the prefix product of the day spectra, taken in log depth.

    ``segment=None`` (pure mode) absorbs nothing between days: day k
    composes k kernel spectra on a fixed ``2·dom_len − 1`` pad, so once
    the composite spread outgrows it the output aliases, and it agrees
    with the sequential solver only while no mass reaches the pad.
    ``segment=s`` re-imposes the absorbing boundary every ``s`` days: the
    prefix products run within segments on an alias-free pad
    ``next_fast_len(D + s·rad_res)``, and each segment starts from the
    domain-truncated field; ``segment=1`` is :func:`propagate_prob`'s
    physics.  Outputs are thresholded and renormalized per day in both
    modes.
    """
    D = config.dom_len
    n = kernels.shape[0]
    if segment is not None and n == 1:
        return kernels                       # day 0 only: nothing to do
    if segment is None:
        P = max(config.fft_len, next_fast_len(2 * D - 1))
        prefix = _prefix_products(filter_fft(kernels[1:], P), 0)
        sol_hat = signal_fft(kernels[0], P)[None] * prefix
        fields = _irfft(sol_hat, P)[:, :D, :D]
        return torch.cat([kernels[:1],
                          r_small_vals_dense(fields, prob_model=True)])

    # a segment no longer than the chain, so the pad stays sized for the
    # real in-segment support (never pure mode's smaller pad)
    s = int(min(segment, n - 1))
    rad_res = (D - 1) // 2
    P = next_fast_len(D + s * rad_res)
    m = -(-(n - 1) // s)                                  # segments
    pad_days = m * s - (n - 1)
    k_rest = kernels[1:]
    if pad_days:
        # identity kernels (a delta at the centre: an all-ones spectrum)
        # make the segments uniform; their outputs are dropped
        delta = torch.zeros((pad_days, D, D), dtype=kernels.dtype,
                            device=kernels.device)
        delta[:, D // 2, D // 2] = 1.0
        k_rest = torch.cat([k_rest, delta])
    k_hat = filter_fft(k_rest, P).reshape(m, s, P, P // 2 + 1)
    prefix = _prefix_products(k_hat, 1)
    dom = kernels[0]
    out = []
    for seg in range(m):
        # dom: the absorbed (domain-truncated) field at the segment start
        fields = _irfft(signal_fft(dom, P)[None] * prefix[seg], P)[:, :D, :D]
        out.append(fields)
        dom = fields[-1]
    fields = torch.cat(out)[:n - 1]
    return torch.cat([kernels[:1],
                      r_small_vals_dense(fields, prob_model=True)])


def propagate_pop(kernels, r_dur: int, r_number, dist_weights,
                  config: SolverConfig):
    """Expected population fields with multi-day releases (ref
    CalcSol.get_populations): cohort d, released on day d < r_dur, spreads
    with kernels d..n; day n's population is
    ``r_number · Σ_d dist(d+1) · cohort_d(n)``, with not-yet-released mass
    held at the origin.

    Args:
        kernels: (ndays, D, D) daily pmfs; 0..r_dur-1 are release days.  A
            leading particle axis, (N, ndays, D, D), propagates N
            populations in the same batched transforms.
        r_dur: number of release days.  r_number: total wasps released.
        dist_weights: (r_dur,) tensor, emergence distribution.
    Returns:
        (ndays, D, D) expected populations, thresholded at 1e-8, or
        (N, ndays, D, D).
    """
    with trace.span('solver.propagate'):
        return _propagate_pop(kernels, r_dur, r_number, dist_weights, config)


def _propagate_pop(kernels, r_dur, r_number, dist_weights, config):
    """The body of :func:`propagate_pop`."""
    D, P = config.dom_len, config.fft_len
    ndays = kernels.shape[-3]
    lead = kernels.shape[:-3]
    c = D // 2
    dtype, dev = kernels.dtype, kernels.device

    def thresh(x):
        return r_small_vals_dense(x, prob_model=False)

    def weigh(w, cohorts):
        if lead:
            return torch.einsum('r,...rij->...ij', w, cohorts)
        return torch.tensordot(w, cohorts, dims=1)

    out = torch.empty_like(kernels)
    day0 = thresh(kernels[..., 0, :, :]) * (r_number * dist_weights[0])
    day0[..., c, c] += r_number * (1.0 - dist_weights[0])
    out[..., 0, :, :] = day0
    if ndays == 1:
        return out

    # cohort state (..., r_dur, D, D); cohort d activates on day d
    cohorts = torch.zeros(lead + (r_dur, D, D), dtype=dtype, device=dev)
    cohorts[..., 0, :, :] = kernels[..., 0, :, :]
    d_idx = torch.arange(r_dur, device=dev)
    k_hat = filter_fft(kernels[..., 1:, :, :], P)
    for day in range(1, ndays):
        # all cohorts advance with today's kernel (one batched FFT); those
        # not yet released stay zero
        moved = _irfft(signal_fft(cohorts, P) *
                       k_hat[..., day - 1, None, :, :], P)[..., :D, :D]
        # a release day seeds its own cohort with today's spread
        cohorts = torch.where((d_idx == day)[:, None, None],
                              kernels[..., day, None, :, :], moved)
        w = dist_weights * (d_idx <= day).to(dtype)
        pop = thresh(weigh(w, cohorts) * r_number)
        # unreleased mass waits at the origin (ref :236-237,273-274,305-306)
        pop[..., c, c] += r_number * (1.0 - w.sum())
        out[..., day, :, :] = pop
    return out

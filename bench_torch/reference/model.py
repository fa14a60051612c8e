"""Plain reference of the Bayes model: the forward population simulation,
the observation projections and the log posterior, in plain torch.

It restates, operation for operation, what the program computes on its
timed paths (daily dispersal kernels from per-minute bivariate-normal
blocks, the FFT propagation of release cohorts, the projections onto the
observed fields and grid, the Poisson likelihood, the priors and the
unconstrained NUTS target), with no kernel, no graph and no batching.  It
is run in float64 on the card to decide ``correct``; the control runs the
same code in float32 with every matrix product's operands rounded to TF32
(``tf32=True``), the lower precision a later change might be tempted by.

Nothing here imports the program.  The site's data come in as plain
numpy arrays (``site``: wind readings, observation counts, field cells
and dates), and every table the timed path builds from them (packed wind,
prefix sums, projection weights, gather indices) is built here again.
The gradient, where asked for, is autograd through this code, one day at
a time under checkpointing, not the program's closed-form rule.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.special import gammaln, ndtr, xlogy
from torch.utils.checkpoint import checkpoint

SECONDS_PER_DAY = 86400
NEGVAL = 1e-8                   # sparsity threshold of every field
RATE_FLOOR = 1e-12              # floor of a Poisson rate
RESOLVED = 1e-4                 # a rate resolved in float32, of its block's
TWO_PI = 2.0 * math.pi
SQRT_2PI = math.sqrt(TWO_PI)
INCUBATION = np.array([0.05, 0.1, 0.2, 0.3, 0.2, 0.1, 0.05])
MAX_INCUBATION = 25
N_MODEL = 15
N_PERIODS_FIXED = 30.0


def round_tf32(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest even:
    what a matrix product with TF32 on does to its operands.  The gradient
    passes straight through, as through a TF32 product."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    r = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


# ---------------------------------------------------------------------------
# bivariate-normal cell masses (Drezner-Wesolowsky / Genz)
# ---------------------------------------------------------------------------

def genz_branch(abs_rho):
    """0, 1, 2: 6-, 12-, 20-node quadrature below |rho| 0.3, 0.75, 0.925;
    3: the high-|rho| series."""
    return int(abs_rho >= 0.3) + int(abs_rho >= 0.75) + int(abs_rho >= 0.925)


def _nodes(G, like):
    x, w = np.polynomial.legendre.leggauss(G)
    return (torch.as_tensor(x, dtype=like.dtype, device=like.device),
            torch.as_tensor(w, dtype=like.dtype, device=like.device))


def _upper_low(h, k, rho, G, phi_prod):
    x, w = _nodes(G, h)
    hk = h * k
    hs = 0.5 * (h * h + k * k)
    asr = torch.asin(rho)
    total = torch.zeros_like(hk)
    for g in range(G):
        sn = torch.sin(asr * 0.5 * (1.0 + x[g]))
        total = total + w[g] * torch.exp((sn * hk - hs) / (1.0 - sn * sn))
    return total * asr / (2.0 * TWO_PI) + phi_prod


def _upper_high(h, k, rho, G=20):
    x, w = _nodes(G, h)
    sgn = torch.sign(rho)
    k = k * sgn
    hk = h * k
    a_sq = torch.clamp((1.0 - rho) * (1.0 + rho), min=1e-30)
    a = torch.sqrt(a_sq)
    bs = (h - k) ** 2
    c = (4.0 - hk) / 8.0
    d = (12.0 - hk) / 16.0
    asr = -(bs / a_sq + hk) / 2.0
    zero = torch.zeros_like(hk)
    bvn = torch.where(asr > -80.0,
                      a * torch.exp(torch.clamp(asr, -80.0, 0.0)) *
                      (1.0 - c * (bs - a_sq) * (1.0 - d * bs / 5.0) / 3.0 +
                       c * d * a_sq * a_sq / 5.0), zero)
    b = torch.sqrt(torch.where(bs > 1e-30, bs, torch.full_like(bs, 1e-30)))
    term = (torch.exp(torch.clamp(-hk / 2.0, -80.0, 80.0)) * SQRT_2PI *
            ndtr(-b / a) * b * (1.0 - c * bs * (1.0 - d * bs / 5.0) / 3.0))
    bvn = bvn - torch.where(-hk < 80.0, term, zero)
    a_half = a / 2.0
    for g in range(G):
        xs = (a_half * (1.0 + x[g])) ** 2
        rs = torch.sqrt(1.0 - xs)
        asr1 = -(bs / xs + hk) / 2.0
        sp = 1.0 + c * xs * (1.0 + d * xs)
        ep = torch.exp(-hk * (1.0 - rs) / (2.0 * (1.0 + rs))) / rs
        bvn = bvn + torch.where(
            asr1 > -80.0,
            a_half * w[g] * torch.exp(torch.clamp(asr1, -80.0, 0.0)) *
            (ep - sp), zero)
    bvn = -bvn / TWO_PI
    pos = bvn + ndtr(-torch.maximum(h, k))
    neg = -bvn + torch.where(k > h, ndtr(k) - ndtr(h), zero)
    return torch.where(sgn > 0, pos, neg)


def cell_masses(mu, sig_x, sig_y, rho, cell, K, branch):
    """Mass of N(mu, S) in every cell of a (2K+1)² window: ``mu`` (C, 2)
    gives (C, 2K+1, 2K+1), row 0 at +y, column 0 at -x."""
    sig_x = torch.clamp(sig_x, min=1e-8)
    sig_y = torch.clamp(sig_y, min=1e-8)
    rho = torch.clamp(rho, -1 + 1e-6, 1 - 1e-6)
    n = 2 * K + 1
    ar = torch.arange(n + 1, dtype=mu.dtype, device=mu.device)
    xe = ((ar - K - 0.5) * cell - mu[..., 0:1]) / sig_x
    ye = ((K + 0.5 - ar) * cell - mu[..., 1:2]) / sig_y
    h, k = xe[..., None, :], ye[..., :, None]
    if branch == 3:
        U = _upper_high(h, k, rho)
    else:
        phi_prod = ndtr(-xe)[..., None, :] * ndtr(-ye)[..., :, None]
        U = _upper_low(h, k, rho, (6, 12, 20)[branch], phi_prod)
    rect = ((U[..., 1:, :-1] - U[..., 1:, 1:]) -
            (U[..., :-1, :-1] - U[..., :-1, 1:]))
    return torch.clamp(rect, min=0.0)


# ---------------------------------------------------------------------------
# one day's kernel
# ---------------------------------------------------------------------------

def flight_prob(windr, lam, aw, bw, a1, b1, a2, b2):
    """Per-minute take-off probability h = lam (f g + integral_avg)."""
    n = windr.shape[0]
    t = torch.linspace(0.0, 24.0 - 24.0 / n, n, dtype=windr.dtype,
                       device=windr.device)
    f = torch.clamp(torch.sigmoid(b1 * (t - a1)) -
                    torch.sigmoid(b2 * (t - a2)), min=0.0)
    total = f.sum()
    f = torch.where(total > 1e-6, f / torch.clamp(total, min=1e-6),
                    torch.zeros_like(f))
    g = torch.sigmoid(-bw * (windr - aw))
    tv = torch.linspace(1.0, n, n, dtype=windr.dtype, device=windr.device)
    integral = (f * g / tv / torch.clamp(f.max(), min=1e-12) *
                torch.cumsum((1.0 - torch.cumsum(f, 0)) * (f - f * g), 0))
    return lam * (f * g + integral)


class Forward:
    """The population forward of one configuration on one device, in one
    dtype.  ``site`` holds the wind (``wind``: (days, T, 2) readings in
    m/s), and ``cfg`` the sizes (``rad_res``, ``rad_dist``, ``K``,
    ``K_local``, ``ndays``, ``fft_len``, ``r_dur``, ``r_number``,
    ``start_idx``)."""

    def __init__(self, cfg, site, dtype, device, tf32=False, chunk=240):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.tf32, self.chunk = tf32, chunk
        wind = np.asarray(site['wind'], np.float64)
        self.T = wind.shape[1]
        flat = wind.reshape(-1, 2)
        cs = np.concatenate([np.zeros((1, 2)), np.cumsum(flat, axis=0)])
        self.wind = torch.as_tensor(flat, dtype=dtype, device=device)
        self.cumsum = torch.as_tensor(cs, dtype=dtype, device=device)
        # the prefix sums in the configuration's own precision (float32 wind
        # summed as the program sums it), from which each minute's cell is
        # picked (see ``day_inputs``)
        if cfg.get('dtype', 'float32') == 'float64':
            self.cumsum_picked = torch.as_tensor(cs, dtype=torch.float64,
                                                 device=device)
        else:
            flat32 = flat.astype(np.float32)
            cs32 = np.concatenate([np.zeros((1, 2)), np.cumsum(
                flat32, axis=0, dtype=np.float64)]).astype(np.float32)
            self.cumsum_picked = torch.as_tensor(cs32, device=device)
        self.D = 2 * cfg['rad_res'] + 1
        self.cell = cfg['rad_dist'] / cfg['rad_res']

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def day_inputs(self, day, m, start):
        """(h, mu, row, col, outside, clipped) of the minutes of ``day``."""
        c, T, K, R = self.cell, self.T, self.cfg['K'], self.cfg['rad_res']
        dw = self.wind[day * T:(day + 1) * T]
        windr = torch.hypot(dw[:, 0], dw[:, 1])
        h = flight_prob(windr, m['lam'], m['g_aw'], m['g_bw'], m['f_a1'],
                        m['f_b1_p'] + 1.0, m['f_a2'], m['f_b2_p'] + 1.0)
        h = torch.where(torch.arange(T, device=self.device) >= start, h,
                        torch.zeros_like(h))
        n_per = int(torch.clamp(torch.round(m['n_periods']), min=1).item())
        starts = day * T + torch.arange(T, device=self.device)
        ends = torch.clamp(starts + n_per, max=self.wind.shape[0])
        mean = (self.cumsum[ends] - self.cumsum[starts]) / \
            (ends - starts).to(self.dtype)[:, None]
        mu_v = mean * (SECONDS_PER_DAY * (n_per / T)) * m['mu_r']
        off = torch.round(self.mean_as_configured(starts, ends, n_per,
                                                 m['mu_r']) /
                          c).to(self.dtype)
        mu = mu_v - off * c
        col, row = off[:, 0].long(), -off[:, 1].long()
        outside = (row.abs() > R + K) | (col.abs() > R + K)
        clipped = ~outside & ((row.abs() + K > R) | (col.abs() + K > R))
        return h, mu, row, col, outside, clipped

    def mean_as_configured(self, starts, ends, n_per, mu_r):
        """Each minute's mean flight displacement as the configuration's
        arithmetic (float32, or float64 where the configuration runs in
        float64) gives it, from which the cell each minute's block is
        centred on is picked: where a displacement lies within float32
        roundoff of half a cell, float64 would pick the next cell.  So the
        reference centres every block where the configuration does; the
        mass about that centre is in the reference's own dtype."""
        cs = self.cumsum_picked
        counts = (ends - starts).to(cs.dtype)
        mean = (cs[ends] - cs[starts]) / counts[:, None]
        n = torch.full((), float(n_per), dtype=cs.dtype, device=self.device)
        scale = SECONDS_PER_DAY * (n / self.T) * mu_r.detach().to(cs.dtype)
        return mean * scale

    def day_kernel(self, day, m, branches, local):
        """One day's (D, D) dispersal pmf."""
        K, Kl, R, D = (self.cfg['K'], self.cfg['K_local'],
                       self.cfg['rad_res'], self.D)
        start = self.cfg['start_idx'] if day == 0 else 0
        h, mu, row, col, outside, clipped = self.day_inputs(day, m, start)
        n, L = 2 * K + 1, D + 4 * K
        h_in = torch.where(outside, torch.zeros_like(h), h)
        ar = torch.arange(n, device=self.device)
        offs = (ar[:, None] * L + ar[None, :]).reshape(-1)
        top = torch.where(outside, R, R + K + row)
        left = torch.where(outside, R, R + K + col)
        flat_idx = (top * L + left)[:, None] + offs[None, :]
        buf = torch.zeros(L * L, dtype=self.dtype, device=self.device)
        clip_loss = torch.zeros((), dtype=self.dtype, device=self.device)
        for s in range(0, self.T, self.chunk):
            e = min(s + self.chunk, self.T)
            blocks = cell_masses(mu[s:e], m['sig_x'], m['sig_y'],
                                 2.0 * m['corr_p'] - 1.0, self.cell, K,
                                 branches[0])
            buf = buf.index_add(0, flat_idx[s:e].reshape(-1),
                                (blocks * h_in[s:e, None, None]).reshape(-1))
            clip_loss = clip_loss + torch.sum(
                clipped[s:e].to(self.dtype) * h_in[s:e] *
                (1.0 - blocks.sum(dim=(1, 2))))
        buf = buf.reshape(L, L)
        pmf = buf[2 * K:2 * K + D, 2 * K:2 * K + D]
        loss = (buf.sum() - pmf.sum()) + clip_loss + \
            torch.where(outside, h, torch.zeros_like(h)).sum()
        flown = pmf.sum() + loss
        stay = torch.where(flown < 0.99999, 1.0 - flown,
                           torch.zeros_like(flown))
        pmf = pmf + F.pad(stay * local, (R - Kl, R - Kl, R - Kl, R - Kl))
        return sparsify(pmf, prob_model=True)

    def kernels(self, m, grad=False):
        """Every day's pmf, (ndays, D, D); with ``grad`` each day is
        recomputed in the backward (checkpointing) to bound the memory."""
        rho_l = 2.0 * m['corr_l_p'] - 1.0
        branches = (genz_branch(abs(float(2.0 * m['corr_p'].detach() - 1.0))),
                    genz_branch(abs(float(rho_l.detach()))))
        Kl = self.cfg['K_local']
        local = cell_masses(torch.zeros(2, dtype=self.dtype,
                                        device=self.device),
                            m['sig_xl'], m['sig_yl'], rho_l, self.cell, Kl,
                            branches[1])
        names = list(m)
        out = []
        for day in range(self.cfg['ndays']):
            if grad:
                def one(local, *vals, day=day):
                    return self.day_kernel(day, dict(zip(names, vals)),
                                           branches, local)
                out.append(checkpoint(one, local, *m.values(),
                                      use_reentrant=False))
            else:
                out.append(self.day_kernel(day, m, branches, local))
        return torch.stack(out)

    def propagate(self, kernels):
        """Expected populations of the release cohorts, (ndays, D, D)."""
        D, P = self.D, self.cfg['fft_len']
        r_dur, r_number = self.cfg['r_dur'], float(self.cfg['r_number'])
        c = D // 2
        w_all = torch.full((r_dur,), 1.0 / r_dur, dtype=self.dtype,
                           device=self.device)
        centre = torch.zeros((D, D), dtype=self.dtype, device=self.device)
        centre[c, c] = 1.0

        def fft_signal(x):
            return torch.fft.rfft2(F.pad(x, (0, P - D, 0, P - D)))

        def fft_filter(k):
            return torch.fft.rfft2(torch.roll(F.pad(k, (0, P - D, 0, P - D)),
                                              (-c, -c), dims=(-2, -1)))
        out = [sparsify(kernels[0]) * (r_number * w_all[0]) +
               centre * (r_number * (1.0 - w_all[0]))]
        cohorts = [kernels[0]] + [torch.zeros_like(kernels[0])] * (r_dur - 1)
        for day in range(1, kernels.shape[0]):
            k_hat = fft_filter(kernels[day])
            moved = torch.fft.irfft2(fft_signal(torch.stack(cohorts)) * k_hat,
                                     s=(P, P))[:, :D, :D]
            cohorts = [kernels[day] if d == day else moved[d]
                       for d in range(r_dur)]
            w = w_all * (torch.arange(r_dur, device=self.device) <=
                         day).to(self.dtype)
            stacked = torch.stack(cohorts).reshape(r_dur, D * D)
            pop = self.mm(w[None, :], stacked).reshape(D, D) * r_number
            out.append(sparsify(pop) + centre * (r_number * (1.0 - w.sum())))
        return torch.stack(out)

    def fields(self, m, grad=False):
        return self.propagate(self.kernels(m, grad))


def sparsify(field, prob_model=False):
    """Entries under 1e-8 set to 0; a pmf spreads the removed mass over
    the rest."""
    keep = field >= NEGVAL
    kept = torch.where(keep, field, torch.zeros_like(field))
    if prob_model:
        n_keep = keep.sum()
        kept = kept + torch.where(
            keep, (1.0 - kept.sum()) / torch.clamp(n_keep, min=1),
            torch.zeros_like(field))
        kept = torch.where(n_keep > 0, kept, field)
    return kept


# ---------------------------------------------------------------------------
# observations, likelihood, priors
# ---------------------------------------------------------------------------

def emergence_weights(collection_day, obs_cols, ndays):
    """W[day, col]: a wasp present on ``day`` emerging 19-25 days later,
    binned into the observation dates ``obs_cols``."""
    M = np.zeros((ndays, MAX_INCUBATION))
    for day in range(max(collection_day - MAX_INCUBATION, 0),
                     min(collection_day, ndays)):
        max_post = day + MAX_INCUBATION - collection_day
        min_post = max(0, max_post + 1 - INCUBATION.size)
        M[day, min_post:max_post + 1] = INCUBATION[-(max_post - min_post + 1):]
    B = np.zeros((MAX_INCUBATION, len(obs_cols)))
    cols = [int(c) - collection_day for c in obs_cols]
    B[0:cols[0] + 1, 0] = 1.0
    for n, col in enumerate(cols[1:]):
        B[cols[n] + 1:col + 1, n + 1] = 1.0
    return M @ B


def exposure_weights(obs_days, ndays):
    W = np.zeros((ndays, len(obs_days)))
    prev = 0
    for col, d in enumerate(obs_days):
        W[prev:min(d, ndays), col] = 1.0
        prev = d
    return W


def _beta(x, a, b):
    xs = torch.clamp(x, 1e-12, 1 - 1e-12)
    lp = (xlogy(torch.as_tensor(a - 1.0, dtype=x.dtype), xs) +
          xlogy(torch.as_tensor(b - 1.0, dtype=x.dtype), 1 - xs) +
          gammaln(torch.as_tensor(a + b, dtype=x.dtype)) -
          gammaln(torch.as_tensor(a, dtype=x.dtype)) -
          gammaln(torch.as_tensor(b, dtype=x.dtype)))
    return torch.where((x > 0) & (x < 1), lp, torch.full_like(lp, -math.inf))


def _gamma(x, alpha, rate):
    lp = ((alpha - 1.0) * torch.log(torch.clamp(x, min=1e-300)) - rate * x +
          alpha * math.log(rate) - math.lgamma(alpha))
    return torch.where(x > 0, lp, torch.full_like(lp, -math.inf))


def _normal(x, mu, tau):
    sd = 1.0 / math.sqrt(tau)
    return -((x - mu) / sd) ** 2 / 2 - 0.5 * math.log(TWO_PI) - math.log(sd)


def _truncnorm(x, mu, tau, a, b):
    sd = 1.0 / math.sqrt(tau)
    phi = lambda v: 0.5 * math.erfc(-v / math.sqrt(2.0))
    lp = _normal(x, mu, tau) - math.log(phi((b - mu) / sd) -
                                        phi((a - mu) / sd))
    return torch.where((x >= a) & (x <= b), lp, torch.full_like(lp, -math.inf))


def log_prior_model(m):
    lp = _beta(m['lam'], 5.0, 1.0)
    lp = lp + _truncnorm(m['f_a1'], 6.0, 0.3, 0.0, 9.0)
    lp = lp + _truncnorm(m['f_a2'], 20.0, 0.3, 15.0, 24.0)
    lp = lp + _gamma(m['f_b1_p'], 2.0, 1.0) + _gamma(m['f_b2_p'], 2.0, 1.0)
    lp = lp + _gamma(m['g_aw'], 2.2, 1.0) + _gamma(m['g_bw'], 5.0, 1.0)
    lp = lp + _gamma(m['sig_x'], 26.0, 0.15) + _gamma(m['sig_y'], 15.0, 0.15)
    lp = lp + _beta(m['corr_p'], 5.0, 5.0)
    lp = lp + _gamma(m['sig_xl'], 2.0, 0.08) + _gamma(m['sig_yl'], 2.0, 0.14)
    lp = lp + _beta(m['corr_l_p'], 5.0, 5.0)
    lp = lp + _normal(m['mu_r'], 1.0, 1.0)
    k = m['n_periods']
    pois = xlogy(k, torch.full_like(k, 30.0)) - 30.0 - gammaln(k + 1.0)
    return lp + torch.where(k >= 0, pois, torch.full_like(pois, -math.inf))


MODEL_NAMES = ('g_aw', 'g_bw', 'f_a1', 'f_b1_p', 'f_a2', 'f_b2_p', 'sig_x',
               'sig_y', 'corr_p', 'sig_xl', 'sig_yl', 'corr_l_p', 'lam',
               'n_periods', 'mu_r')


def as_model(vec):
    return {n: vec[i] for i, n in enumerate(MODEL_NAMES)}


class Posterior:
    """Projections, likelihood and log posterior of one site.  ``site``
    holds, besides the wind: ``field_cells`` (per sentinel field, (n, 2)
    cells), ``field_areas`` (m²), ``release`` (per release collection: the
    grid cells ``points`` (n, 2), the observation days ``days``, the
    collection day ``collection``, the ``protocol``, the counts ``obs`` and
    the collection effort ``effort``), ``sentinel`` (per collection: days,
    collection day, protocol, counts), ``grid`` (cells, days, counts,
    samples)."""

    def __init__(self, forward: Forward, site):
        self.fwd = forward
        dt, dev = forward.dtype, forward.device
        D, nd = forward.D, forward.cfg['ndays']

        def t(a, dtype=dt):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        def weights(r):
            if r['protocol'] == 'exposure':
                return t(exposure_weights(r['days'], nd))
            return t(emergence_weights(r['collection'], r['days'], nd))

        self.release = [(t([r * D + c for r, c in x['points']], torch.long),
                         weights(x), t(x['obs']), t(x['effort']))
                        for x in site['release']]
        self.field_cells = [t([r * D + c for r, c in cells], torch.long)
                            for cells in site['field_cells']]
        self.sentinel = [(weights(x), t(x['obs'])) for x in site['sentinel']]
        g = site['grid']
        self.grid_cells = t([r * D + c for r, c in g['cells']], torch.long)
        self.grid_days = t(np.minimum(np.asarray(g['days']) - 1, nd - 1),
                           torch.long)
        self.grid_obs, self.grid_samples = t(g['obs']), t(g['samples'])
        self.field_areas = t(site['field_areas'])
        self.min_area = float(min(site['field_areas_all']))
        self.n_sent = len(self.field_cells)

    def projections(self, fields):
        flat = fields.reshape(fields.shape[0], -1)
        mm = self.fwd.mm
        rel = [mm(flat[:, idx].T.contiguous(), W)
               for idx, W, _, _ in self.release]
        tot = torch.stack([flat[:, idx].sum(-1) for idx in self.field_cells])
        sent = [mm(tot, W) for W, _ in self.sentinel]
        grid = flat[self.grid_days][:, self.grid_cells].T
        return rel, sent, grid

    def log_pmfs(self, proj, o):
        """Each observation's log-pmf, flat: release blocks, sentinel
        blocks, grid; and whether it is resolved: a zero count, or an
        expected count at least ``RESOLVED`` of the largest in its block.
        A positive count over a smaller rate scores the log of a rate that
        float32 propagation leaves as roundoff (about 1e-5 of a block's
        scale), so it reads roundoff in any float32 path."""
        rates, data = self._rates(proj, o)
        lp, keep = [], []
        for d, rate in zip(data, rates):
            safe = torch.clamp(rate, min=RATE_FLOOR)
            x = torch.where(d > 0, xlogy(d, safe), torch.zeros_like(safe))
            lp.append((x - rate - gammaln(d + 1.0)).reshape(-1))
            top = rate.abs().max() if rate.numel() else 0.0
            keep.append(((d == 0) | (rate >= RESOLVED * top)).reshape(-1))
        return torch.cat(lp), torch.cat(keep)

    def _rates(self, proj, o):
        rel, sent, grid = proj
        xi, em, gp = o[0], o[1], o[2]
        sp = o[4:4 + self.n_sent]
        rates = [xi * model * (eff * em)[:, None]
                 for model, (_, _, _, eff) in zip(rel, self.release)]
        rates += [xi * model * sp[:, None] for model in sent]
        rates.append(gp * self.grid_samples * grid)
        data = [x[2] for x in self.release] + [x[1] for x in self.sentinel] + \
            [self.grid_obs]
        return rates, data

    def log_likelihood(self, proj, o):
        return self.log_pmfs(proj, o)[0].sum()

    def log_prior_obs(self, o):
        xi, em, gp, A = o[0], o[1], o[2], o[3]
        sp = o[4:4 + self.n_sent]
        lp = _gamma(xi, 1.0, 1.0) + _beta(em, 1.0, 1.0) + _beta(gp, 1.0, 1.0)
        lp = lp + _truncnorm(A, 2500.0, 1.0 / 2500.0, 0.0, self.min_area)
        mean = A / self.field_areas
        alpha = mean * 40.0 / (1.0 - mean)
        xs = torch.clamp(sp, 1e-12, 1 - 1e-12)
        beta = ((alpha - 1.0) * torch.log(xs) + 39.0 * torch.log1p(-xs) +
                gammaln(alpha + 40.0) - gammaln(alpha) - math.lgamma(40.0))
        beta = torch.where((sp > 0) & (sp < 1), beta,
                           torch.full_like(beta, -math.inf))
        sent = torch.where(torch.all(alpha > 0), beta.sum(),
                           torch.full_like(lp, -math.inf))
        return lp + sent

    def log_posterior(self, m_vec, o_vec, grad=False):
        """Log posterior at a model block and an observation vector; -inf
        outside the prior's support, without a forward."""
        m = as_model(m_vec)
        prior = log_prior_model(m) + self.log_prior_obs(o_vec)
        if not math.isfinite(float(prior.detach())):
            return prior
        proj = self.projections(self.fwd.fields(m, grad))
        return prior + self.log_likelihood(proj, o_vec)


# ---------------------------------------------------------------------------
# the unconstrained NUTS target
# ---------------------------------------------------------------------------

def _sig(z):
    return 1.0 / (1.0 + torch.exp(-z))


# per model slot: 'pos' log, 'unit' logit, (lo, hi) scaled logit, None fixed,
# 'id' unbounded
MODEL_MAPS = ('pos', 'pos', (0.0, 9.0), 'pos', (15.0, 24.0), 'pos', 'pos',
              'pos', 'unit', 'pos', 'pos', 'unit', 'unit', None, 'id')


def _inv(kind, z):
    """(theta, |dtheta/dz|) of one unconstrained coordinate."""
    if kind == 'pos':
        v = torch.exp(z)
        return v, v
    if kind == 'id':
        return z, torch.ones_like(z)
    u = _sig(z)
    d = u * (1.0 - u)
    if kind == 'unit':
        return u, d
    lo, hi = kind
    return lo + (hi - lo) * u, d * (hi - lo)


def nuts_target(post: Posterior, z, grad=False):
    """Log posterior at the constrained point of ``z`` plus the log
    Jacobian of the bijections, with n_periods pinned at 30."""
    n_obs = z.shape[0] - N_MODEL
    obs_maps = ['pos', 'unit', 'unit', (0.0, post.min_area)] + \
        ['unit'] * (n_obs - 4)
    m, o, logjac = [], [], 0.0
    for i, kind in enumerate(MODEL_MAPS):
        if kind is None:
            m.append(torch.full_like(z[i], N_PERIODS_FIXED))
            continue
        v, d = _inv(kind, z[i])
        m.append(v)
        logjac = logjac + torch.log(d)
    for j, kind in enumerate(obs_maps):
        v, d = _inv(kind, z[N_MODEL + j])
        o.append(v)
        logjac = logjac + torch.log(d)
    return post.log_posterior(torch.stack(m), torch.stack(o), grad) + logjac


def build(data, dtype, device, tf32=False):
    """The reference of a site: a :class:`Posterior` (its ``fwd`` the
    :class:`Forward`) of ``data`` at ``data['sizes']``, in ``dtype`` on
    ``device``; ``tf32`` rounds every product's operands to TF32 (the
    control)."""
    return Posterior(Forward(data['sizes'], data, dtype, device, tf32=tf32),
                     data)

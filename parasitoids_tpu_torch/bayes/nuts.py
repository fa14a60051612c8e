"""No-U-Turn sampler, PyTorch port of ``parasitoids_tpu/bayes/nuts.py``.

Multinomial NUTS (Hoffman & Gelman 2014, progressive multinomial sampling
as in Stan) with iterative tree building (a checkpoint stack for the
balanced-subtree U-turn checks), Stan-style warm-up (dual-averaging step
size, a diagonal or dense metric from a Welford window), Gibbs-within-NUTS
over the discrete ``n_periods``, and a stepwise sampler with exact
checkpoint and resume.  The math is the JAX module's, term for term.

What differs is where the control flow runs.  JAX compiles a transition
into one ``lax.while_loop`` program; here the loop runs on the host and
every number stays on the device.  The host needs one decision per
leapfrog — whether another leapfrog follows (the subtree neither turned
nor diverged, or the finished tree is not done) — and it takes it from the
*next* evaluation's own read: the next point is formed on the device, and
the decision rides as a ``gate`` in the transfer that the log posterior
makes anyway for its prior and BVN branches (``BayesSetup.log_posterior``).
A transition therefore reads the card once per leapfrog, plus once where
it stops on a gate, and no leapfrog runs masked.  The multinomial and the
subtree choices, the U-turn checks and the adaptation are ``torch.where``
arithmetic on the device.

The random numbers of a transition are an argument (:class:`NUTSDraws`),
drawn from the chain's ``torch.Generator`` by :func:`draw_transition`, so a
test can replay JAX's.  A checkpoint holds the generators' state bytes
(``bayes/store.py`` does the same), and a resumed run continues bit for
bit.

Generic over the target: ``logpdf(z, *args)`` returns a 0-d tensor; a
target that sets ``logpdf.takes_gate = True`` also takes ``gate=`` and
returns None where it reads 0 (:func:`make_transformed_logpdf` does), any
other target has its gate read on its own.
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

__all__ = ['NUTSConfig', 'NUTSDraws', 'GibbsDraws', 'VALUE_AND_GRADS',
           'draw_transition', 'draw_gibbs', 'nuts_sample',
           'nuts_sample_stepwise', 'make_transformed_logpdf',
           'inv_mass_from_hessian', 'psd_clip_covariance',
           'whiten_transform', 'whiten_logpdf', 'value_and_grad']

# value+gradient evaluations made by this module (a gated-off call is not
# one); a run reads it beside ``ops.day_kernel.LAUNCHES``
VALUE_AND_GRADS = 0

_NO_MESH = ('chains sharded over several devices are not ported: ROADMAP '
            'Queue 1 item 16')


def inv_mass_from_hessian(H, lam_floor=1e-2, lam_ceil=1e12, prior_var=None,
                          floor_frac=1e-4):
    """Dense inverse mass matrix (a covariance estimate) from a Hessian of
    the negative log posterior: symmetrized, |eigenvalue| clipped to
    ``[lam_floor, lam_ceil]`` and inverted; with ``prior_var`` (z-space
    prior variances) each eigendirection's variance is floored at
    ``floor_frac`` times its prior-variance projection.  Non-finite input
    gives the identity."""
    if prior_var is None:
        return _spectral_clip(H, lam_floor, lam_ceil, invert=True)
    A = torch.as_tensor(H)
    As = 0.5 * (A + A.T)
    if not bool(torch.isfinite(As).all()):
        return torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    lam, V = torch.linalg.eigh(As)
    c = 1.0 / torch.clamp(lam.abs(), lam_floor, lam_ceil)
    pv = torch.as_tensor(np.asarray(prior_var), dtype=A.dtype).to(A.device)
    c = torch.maximum(c, floor_frac * torch.sum(V ** 2 * pv[:, None], dim=0))
    out = (V * c) @ V.T
    return _or_identity(0.5 * (out + out.T))


def psd_clip_covariance(cov, eig_min=1e-12, eig_max=100.0):
    """Project a covariance estimate onto the PSD cone with eigenvalues
    clipped to ``[eig_min, eig_max]``: the sanitizer for a NUTS inverse
    mass matrix."""
    return _spectral_clip(cov, eig_min, eig_max, invert=False)


def _or_identity(out):
    eye = torch.eye(out.shape[0], dtype=out.dtype, device=out.device)
    return torch.where(torch.isfinite(out).all(), out, eye)


def _spectral_clip(A, lo, hi, invert):
    """Symmetrize, |eigenvalue|-clip to ``[lo, hi]`` (optionally inverting
    the spectrum), re-symmetrize; the identity for non-finite input (which
    ``eigh`` refuses, where JAX's returns NaN)."""
    A = torch.as_tensor(A)
    As = 0.5 * (A + A.T)
    if not bool(torch.isfinite(As).all()):
        return torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    lam, V = torch.linalg.eigh(As)
    lam = torch.clamp(lam.abs(), lo, hi)
    out = (V * (1.0 / lam if invert else lam)) @ V.T
    return _or_identity(0.5 * (out + out.T))


class NUTSConfig(NamedTuple):
    num_warmup: int = 200
    num_samples: int = 200
    max_depth: int = 6
    target_accept: float = 0.8
    init_step_size: float = 0.1
    # a dense metric (the warm-up window's covariance with Stan's
    # shrinkage) instead of the diagonal one
    dense_mass: bool = False
    # Gibbs-within-NUTS (``gibbs_n=`` of the stepwise sampler): the
    # n_periods proposal is a symmetric +/-U{1..n_step} walk
    n_step: int = 1
    # keep the metric at its initial value (identity or ``init_inv_mass``):
    # warm-up adapts the step size only
    fixed_mass: bool = False


class NUTSDraws(NamedTuple):
    """The random numbers of one transition at ``max_depth`` D, in the
    order the JAX step consumes its keys: the momentum's standard normals;
    per depth the direction bit and the log-uniform of the biased subtree
    acceptance; per leaf the log-uniform of the progressive multinomial
    choice (leaf ``i`` of the depth-``j`` subtree at ``2**j - 1 + i``)."""
    momentum: torch.Tensor      # (dim,)
    go_right: torch.Tensor      # (D,) bool
    log_u_tree: torch.Tensor    # (D,)
    log_u_leaf: torch.Tensor    # (2**D - 1,)


class GibbsDraws(NamedTuple):
    """One Gibbs sweep's numbers: the NUTS transition's, then the n move's
    direction, magnitude (1..n_step) and acceptance log-uniform."""
    nuts: NUTSDraws
    go_up: torch.Tensor         # () bool
    mag: torch.Tensor           # () float, an integer in 1..n_step
    log_u: torch.Tensor         # ()


def draw_transition(gen, dim, max_depth, dtype):
    """One transition's :class:`NUTSDraws` from ``gen`` (on its device), in
    two launches."""
    xi = torch.randn(dim, generator=gen, dtype=dtype, device=gen.device)
    u = torch.rand(2 * max_depth + 2 ** max_depth - 1, generator=gen,
                   dtype=dtype, device=gen.device)
    return NUTSDraws(xi, u[:max_depth] < 0.5,
                     torch.log(u[max_depth:2 * max_depth]),
                     torch.log(u[2 * max_depth:]))


def draw_gibbs(gen, dim, max_depth, n_step, dtype):
    """One Gibbs sweep's :class:`GibbsDraws` from ``gen``."""
    nuts = draw_transition(gen, dim, max_depth, dtype)
    u = torch.rand(3, generator=gen, dtype=dtype, device=gen.device)
    mag = torch.clamp(1.0 + torch.floor(u[1] * n_step), max=float(n_step))
    return GibbsDraws(nuts, u[0] < 0.5, mag, torch.log(u[2]))


# ---------------------------------------------------------------------------
# tree machinery
# ---------------------------------------------------------------------------

def _count_trailing_ones(n):
    c = 0
    while n & 1:
        n >>= 1
        c += 1
    return c


def _popcount(n):
    return bin(n).count('1')


def _mv(inv_mass, p):
    """Inverse-metric velocity ``M^-1 p``: diagonal (d,) or dense (d, d)."""
    return inv_mass @ p if inv_mass.dim() == 2 else inv_mass * p


def _sample_momentum(inv_mass, xi):
    """p ~ N(0, M) from standard normals ``xi``.  Dense: with M^-1 = L Lᵀ,
    L^-T xi has covariance M.  A metric that is not positive definite gives
    NaN, as JAX's ``cholesky`` does, without a read of the card."""
    if inv_mass.dim() == 2:
        L, info = torch.linalg.cholesky_ex(inv_mass, check_errors=False)
        L = torch.where(info == 0, L, torch.full_like(L, math.nan))
        return torch.linalg.solve_triangular(L.T, xi[:, None],
                                             upper=True)[:, 0]
    return xi / torch.sqrt(inv_mass)


def _is_turning(inv_mass, p_start, p_end, dz):
    """Hoffman–Gelman U-turn criterion in the metric's geometry."""
    return ((torch.dot(_mv(inv_mass, p_start), dz) <= 0) |
            (torch.dot(_mv(inv_mass, p_end), dz) <= 0))


def _kinetic(inv_mass, p):
    return 0.5 * torch.dot(p, _mv(inv_mass, p))


def _where(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def value_and_grad(logpdf, args=()):
    """``lpg(z, gate=None)``: the detached value and gradient of
    ``logpdf(z, *args)`` from one autograd pass, or None where ``gate``
    reads 0.  A target with ``takes_gate`` reads the gate with its own
    transfer; for any other the gate is read here first."""
    gated = getattr(logpdf, 'takes_gate', False)

    def lpg(z, gate=None):
        global VALUE_AND_GRADS
        if gate is not None and not gated:
            if not bool(gate):
                return None
            gate = None
        zz = z.detach().requires_grad_()
        with torch.enable_grad():
            lp = (logpdf(zz, *args, gate=gate) if gated
                  else logpdf(zz, *args))
            if lp is None:
                return None
            grad, = torch.autograd.grad(lp, zz)
        VALUE_AND_GRADS += 1
        return lp.detach(), grad
    return lpg


class _Leaf(NamedTuple):
    z: torch.Tensor
    p: torch.Tensor
    grad: torch.Tensor


def _leapfrog_point(inv_mass, step, leaf):
    """The position one leapfrog from ``leaf`` and its half-step
    momentum."""
    p_half = leaf.p + 0.5 * step * leaf.grad
    return leaf.z + step * _mv(inv_mass, p_half), p_half


def _nuts_step(lpg, inv_mass, step_size, max_depth, z, lp, grad, draws,
               max_delta=1000.0, decisions=None):
    """One NUTS transition from ``(z, lp, grad)`` with the numbers of
    ``draws``.  Returns ``(z', lp', grad', accept_stat, n_leaf,
    diverged)``; ``n_leaf`` is a host int (the leapfrogs run), the rest
    device tensors.  ``step_size`` is a 0-d tensor.  ``decisions``: an
    optional list that receives ``(log u, threshold)`` of every
    multinomial and subtree choice, for tests that compare choices only
    where they are clear of their threshold."""
    dtype = z.dtype
    neg_inf = torch.full((), -math.inf, dtype=dtype, device=z.device)
    zero = torch.zeros((), dtype=dtype, device=z.device)
    false = torch.zeros((), dtype=torch.bool, device=z.device)
    p0 = _sample_momentum(inv_mass, draws.momentum)
    energy0 = -lp + _kinetic(inv_mass, p0)
    left = right = _Leaf(z, p0, grad)
    prop = (z, lp, grad)
    log_weight, sum_accept, diverged = zero, zero, false
    n_leaf = 0
    gate = None
    for depth in range(max_depth):
        go = draws.go_right[depth]
        step = torch.where(go, step_size, -step_size)
        direction = torch.sign(step)
        cur = _Leaf(*_where(go, right, left))
        # the subtree: progressive multinomial proposal and stacked U-turn
        # checks (even leaves open balanced subtrees, odd leaves close them)
        t_prop, t_logw, t_sum = (cur.z, zero, cur.grad), neg_inf, zero
        t_turn, t_div = false, false
        ckz, ckp = {}, {}
        n_max = 1 << depth
        ended = False
        for i in range(n_max):
            z_new, p_half = _leapfrog_point(inv_mass, step, cur)
            out = lpg(z_new, gate)
            if out is None:        # the gate: turned or diverged, or done
                ended = True
                break
            lp_new, g_new = out
            cur = _Leaf(z_new, p_half + 0.5 * step * g_new, g_new)
            n_leaf += 1
            energy = -lp_new + _kinetic(inv_mass, cur.p)
            delta = energy - energy0
            div = (delta > max_delta) | ~torch.isfinite(energy)
            log_w = torch.where(div, neg_inf, -delta)
            accept = torch.where(torch.isfinite(delta),
                                 torch.clamp(torch.exp(-delta), max=1.0),
                                 zero)
            new_total = torch.logaddexp(t_logw, log_w)
            take = draws.log_u_leaf[n_max - 1 + i] < log_w - new_total
            if decisions is not None:
                decisions.append((draws.log_u_leaf[n_max - 1 + i],
                                  log_w - new_total))
            t_prop = _where(take, (cur.z, lp_new, cur.grad), t_prop)
            idx_max = _popcount(i >> 1)
            if i % 2 == 0:
                ckz[idx_max], ckp[idx_max] = cur.z, cur.p
            else:
                # dz along increasing trajectory time: negated when the
                # subtree grows backward
                for j in range(idx_max - _count_trailing_ones(i) + 1,
                               idx_max + 1):
                    t_turn = t_turn | _is_turning(
                        inv_mass, ckp[j], cur.p, direction * (cur.z - ckz[j]))
            t_logw, t_sum = new_total, t_sum + accept
            t_div = t_div | div
            gate = ~t_turn & ~t_div
        if ended and i == 0:       # the tree was done: no subtree grew
            break
        # the biased progressive acceptance of the subtree's proposal
        ok = ~t_turn & ~t_div
        take = ok & (draws.log_u_tree[depth] < t_logw - log_weight)
        if decisions is not None:
            decisions.append((draws.log_u_tree[depth], t_logw - log_weight))
        prop = _where(take, t_prop, prop)
        left = _Leaf(*_where(go, left, cur))
        right = _Leaf(*_where(go, cur, right))
        done = ~ok | _is_turning(inv_mass, left.p, right.p,
                                 right.z - left.z)
        log_weight = torch.where(ok, torch.logaddexp(log_weight, t_logw),
                                 log_weight)
        sum_accept = sum_accept + t_sum
        diverged = diverged | t_div
        if ended:
            break
        gate = ~done
    accept_stat = sum_accept / max(n_leaf, 1)
    return prop[0], prop[1], prop[2], accept_stat, n_leaf, diverged


# ---------------------------------------------------------------------------
# adaptation
# ---------------------------------------------------------------------------

def _warm_windows(config: NUTSConfig):
    w1 = max(1, int(config.num_warmup * 0.25))   # step-size only
    w2 = max(w1 + 1, int(config.num_warmup * 0.75))  # + Welford window
    return w1, w2


def _find_reasonable_eps(lpg, z, lp, grad, inv_mass, xi, eps0, max_iter=30):
    """Hoffman–Gelman Algorithm 4: double or halve the step size until one
    leapfrog's acceptance ratio crosses 1/2, from the momentum of the
    standard normals ``xi``.  The loop's condition rides on the next
    evaluation's read as its gate.  Returns a 0-d tensor."""
    p = _sample_momentum(inv_mass, xi)
    H0 = -lp + _kinetic(inv_mass, p)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)

    def accept_ratio(eps, gate=None):
        p_half = p + 0.5 * eps * grad
        out = lpg(z + eps * _mv(inv_mass, p_half), gate)
        if out is None:
            return None
        lp1, g1 = out
        H1 = -lp1 + _kinetic(inv_mass, p_half + 0.5 * eps * g1)
        a = torch.exp(torch.clamp(H0 - H1, -50.0, 50.0))
        return torch.where(torch.isfinite(a), a, zero)

    eps = torch.full((), eps0, dtype=z.dtype, device=z.device)
    a = accept_ratio(eps)
    up = a > 0.5            # a too-easy step grows, else it shrinks
    factor = torch.where(up, 2.0, 0.5).to(z.dtype)
    for _ in range(max_iter):
        keep = (torch.where(up, a > 0.5, a < 0.5) & (eps < 50.0) &
                (eps > 1e-7))
        nxt = eps * factor
        a_next = accept_ratio(nxt, keep)
        if a_next is None:
            break
        eps, a = nxt, a_next
    return torch.clamp(eps, 1e-6, 50.0)


class WarmState(NamedTuple):
    """One chain's warm-up carry (the generator is the chain's own)."""
    z: torch.Tensor
    lp: torch.Tensor
    grad: torch.Tensor
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    inv_mass: torch.Tensor
    wf_n: torch.Tensor
    wf_mean: torch.Tensor
    wf_m2: torch.Tensor
    mu: torch.Tensor          # dual-averaging anchor
    i0: torch.Tensor          # adaptation-clock start


def _warmup_init(lpg, z0, gen, config: NUTSConfig, inv_mass0=None):
    dtype, dev, dim = z0.dtype, z0.device, z0.shape[0]
    lp0, grad0 = lpg(z0)
    if inv_mass0 is None:
        inv_mass0 = (torch.eye(dim, dtype=dtype, device=dev)
                     if config.dense_mass
                     else torch.ones(dim, dtype=dtype, device=dev))
    inv_mass0 = torch.as_tensor(inv_mass0, dtype=dtype).to(dev)
    wf_m2 = torch.zeros((dim, dim) if config.dense_mass else (dim,),
                        dtype=dtype, device=dev)
    xi = torch.randn(dim, generator=gen, dtype=dtype, device=gen.device)
    eps0 = _find_reasonable_eps(lpg, z0, lp0, grad0, inv_mass0, xi,
                                config.init_step_size)
    leps = torch.log(eps0)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return WarmState(z0, lp0, grad0, leps, leps, zero, inv_mass0, zero,
                     torch.zeros(dim, dtype=dtype, device=dev), wf_m2,
                     math.log(10.0) + leps, zero)


def _warm_step(lpg, config: NUTSConfig, carry: WarmState, i, draws):
    """One warm-up transition and its dual-averaging / Welford update;
    ``i`` is the transition's index (a host int)."""
    c = carry
    dtype = c.z.dtype
    w1, w2 = _warm_windows(config)
    kappa, gamma, t0 = 0.75, 0.05, 10.0
    step_size = torch.exp(torch.clamp(c.log_eps, -12.0, 4.0))
    z, lp, grad, astat, _, _ = _nuts_step(
        lpg, c.inv_mass, step_size, config.max_depth, c.z, c.lp, c.grad,
        draws)
    # dual averaging on the adaptation clock, which restarts when the
    # metric switches (below)
    t = (i - c.i0) + 1.0
    h_bar = ((1 - 1 / (t + t0)) * c.h_bar +
             (config.target_accept - astat) / (t + t0))
    log_eps = c.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1 - eta) * c.log_eps_bar
    if config.fixed_mass:
        return c._replace(z=z, lp=lp, grad=grad, log_eps=log_eps,
                          log_eps_bar=log_eps_bar, h_bar=h_bar)
    # Welford over the middle window
    in_win = 1.0 if w1 <= i < w2 else 0.0
    wf_n2 = c.wf_n + in_win
    delta = z - c.wf_mean
    wf_mean = c.wf_mean + in_win * delta / torch.clamp(wf_n2, min=1.0)
    if config.dense_mass:
        wf_m2 = c.wf_m2 + in_win * torch.outer(delta, z - wf_mean)
    else:
        wf_m2 = c.wf_m2 + in_win * delta * (z - wf_mean)
    # at window close, switch to the estimated metric and restart the
    # step-size adaptation around the current step size
    if i != w2 - 1:
        return c._replace(z=z, lp=lp, grad=grad, log_eps=log_eps,
                          log_eps_bar=log_eps_bar, h_bar=h_bar, wf_n=wf_n2,
                          wf_mean=wf_mean, wf_m2=wf_m2)
    close = wf_n2 > 2
    if config.dense_mass:
        n = torch.clamp(wf_n2, min=1.0)
        cov = wf_m2 / torch.clamp(wf_n2 - 1.0, min=1.0)
        # Stan's shrinkage toward a scaled identity
        est = ((n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) *
               torch.eye(z.shape[0], dtype=dtype, device=z.device))
    else:
        var = wf_m2 / torch.clamp(wf_n2 - 1.0, min=1.0)
        est = torch.where(var > 1e-10, var, torch.ones_like(var))
    return WarmState(
        z, lp, grad, log_eps,
        torch.where(close, log_eps, log_eps_bar),
        torch.where(close, torch.zeros_like(h_bar), h_bar),
        torch.where(close, est, c.inv_mass), wf_n2, wf_mean, wf_m2,
        torch.where(close, math.log(10.0) + log_eps, c.mu),
        torch.where(close, torch.full_like(c.i0, i + 1), c.i0))


def _warmup_final(carry: WarmState):
    """``(z, lp, grad, step_size, inv_mass)`` after warm-up."""
    return (carry.z, carry.lp, carry.grad,
            torch.exp(torch.clamp(carry.log_eps_bar, -12.0, 4.0)),
            carry.inv_mass)


def _gibbs_fixed_n(logpdf_n, n0, z, gate=None):
    """1-arg warm-up view of a 2-arg Gibbs target at fixed n_periods."""
    n = torch.full((), float(n0), dtype=z.dtype, device=z.device)
    if getattr(logpdf_n, 'takes_gate', False):
        return logpdf_n(z, n, gate=gate)
    return logpdf_n(z, n)


def _gibbs_step(logpdf_n, config, z, n, lp, grad, step_size, inv_mass,
                draws: GibbsDraws):
    """One Gibbs sweep over ``logpdf_n(z, n)``: a NUTS transition on z at
    fixed n, then a Metropolis move of the discrete n (symmetric
    +/-U{1..n_step}; the support n >= 1 by rejection, with the target
    evaluated at the clamped point so no n <= 0 reaches the forward).
    Returns ``(z, n, lp, grad, accept_stat, n_leaf, diverged, n
    accepted)``."""
    z, lp, grad, astat, n_leaf, div = _nuts_step(
        value_and_grad(logpdf_n, (n,)), inv_mass, step_size,
        config.max_depth, z, lp, grad, draws.nuts)
    n_new = n + torch.where(draws.go_up, draws.mag, -draws.mag)
    lp_new, grad_new = value_and_grad(logpdf_n, (torch.clamp(
        n_new, min=1.0),))(z)
    lp_new = torch.where(n_new >= 1.0, lp_new,
                         torch.full_like(lp_new, -math.inf))
    acc = draws.log_u < lp_new - lp
    return (z, torch.where(acc, n_new, n), torch.where(acc, lp_new, lp),
            torch.where(acc, grad_new, grad), astat, n_leaf, div, acc)


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

def nuts_sample(logpdf, z0, gen, config: NUTSConfig, logpdf_args=(),
                init_inv_mass=None):
    """Warm-up and sampling of one chain from ``z0``, drawing from the
    generator ``gen``.  Returns a dict of tensors: ``samples``
    (num_samples, dim), ``logp`` (num_samples,), ``step_size``,
    ``inv_mass``, ``accept_rate``, ``n_divergent``.  ``logpdf_args`` are
    appended to every ``logpdf`` call; with ``config.fixed_mass`` the
    metric stays at ``init_inv_mass``."""
    lpg = value_and_grad(logpdf, tuple(logpdf_args))
    dtype, dim = z0.dtype, z0.shape[0]
    carry = _warmup_init(lpg, z0, gen, config, init_inv_mass)
    for i in range(config.num_warmup):
        carry = _warm_step(lpg, config, carry, i, draw_transition(
            gen, dim, config.max_depth, dtype))
    z, lp, grad, step_size, inv_mass = _warmup_final(carry)
    samples, logps, astats, divs = [], [], [], []
    for _ in range(config.num_samples):
        z, lp, grad, astat, _, div = _nuts_step(
            lpg, inv_mass, step_size, config.max_depth, z, lp, grad,
            draw_transition(gen, dim, config.max_depth, dtype))
        samples.append(z)
        logps.append(lp)
        astats.append(astat)
        divs.append(div)
    empty = torch.zeros(0, dtype=dtype, device=z0.device)
    return {'samples': (torch.stack(samples) if samples else
                        empty.reshape(0, dim)),
            'logp': torch.stack(logps) if logps else empty,
            'step_size': step_size, 'inv_mass': inv_mass,
            'accept_rate': (torch.stack(astats).mean() if astats
                            else empty.sum()),
            'n_divergent': (torch.stack(divs).sum() if divs
                            else torch.zeros((), dtype=torch.int64))}


def _ckpt_save(path, payload):
    """Atomic checkpoint write (tmp + rename)."""
    tmp = path + '.tmp.npz'     # explicit suffix so np.savez appends nothing
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _gen_bytes(gens):
    return np.stack([g.get_state().numpy() for g in gens])


def _set_gens(gens, key_bytes, path):
    for g, b in zip(gens, key_bytes):
        if b.dtype != np.uint8 or b.shape != tuple(g.get_state().shape):
            raise ValueError('{}: the stored generator state does not fit a '
                             'torch generator on {!r}'.format(path,
                                                              g.device.type))
        g.set_state(torch.from_numpy(b.copy()))


def nuts_sample_stepwise(logpdf, z0s, gens, config: NUTSConfig,
                         progress=None, checkpoint_path=None,
                         checkpoint_every=25, resume=False, mesh=None,
                         gibbs_n=None, n0=30.0, logpdf_args=(),
                         steps_per_call=1, init_inv_mass=None,
                         on_checkpoint=None):
    """NUTS over stacked chains (the leading axis of ``z0s``; ``gens`` one
    ``torch.Generator`` per chain, on the chains' device), the chains in
    turn at every transition.  Returns the dict of :func:`nuts_sample` as
    numpy arrays with a leading chain axis, plus ``n_leapfrog`` (chains,
    num_samples).

    ``progress(phase, i, total)`` is called after every group of
    ``steps_per_call`` transitions; checkpoints land on exact transition
    indices, so a run may resume under another ``steps_per_call``, and the
    draws are the same for every value.  ``checkpoint_path`` /
    ``checkpoint_every``: the complete sampler state (warm-up carry or draw
    state, the generators' bytes, the draws so far) goes to an npz
    whenever a group crosses a multiple of ``checkpoint_every``;
    ``resume=True`` continues from it bit for bit (the generators passed in
    are set to the stored state) and a completed run deletes it.
    ``on_checkpoint(phase, i, path)`` runs after every write; its failures
    are printed, never raised.

    ``gibbs_n``: a two-argument target ``logpdf_n(z, n)`` for
    Gibbs-within-NUTS over the discrete ``n_periods``: warm-up adapts at
    fixed ``n0`` (``logpdf=None`` derives that view), each draw is a NUTS
    transition on z and a Metropolis move on n; adds ``n_periods`` and
    ``n_accept_rate``.  ``logpdf_args``: extra arguments of every
    ``logpdf`` call, not checkpointed (a resume passes the same).
    ``init_inv_mass``: per-chain starting metric, (chains, d) or
    (chains, d, d); not checkpointed (the carry holds the metric)."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    gibbs = gibbs_n is not None
    if gibbs and logpdf_args:
        raise ValueError('logpdf_args is not supported with gibbs_n')
    if gibbs and logpdf is None:
        logpdf = partial(_gibbs_fixed_n, gibbs_n, float(n0))
        logpdf.takes_gate = getattr(gibbs_n, 'takes_gate', False)
    gens = list(gens)
    n_chains, dim = z0s.shape
    dtype, dev = z0s.dtype, z0s.device
    lpg = value_and_grad(logpdf, tuple(logpdf_args))
    spc = max(1, int(steps_per_call))
    # the draw transition reads n_step only when gibbs: a plain run's
    # signature records the canonical 1
    n_step = int(config.n_step) if gibbs else 1
    cfg_sig = np.asarray([config.num_warmup, config.num_samples,
                          config.max_depth, n_chains, dim,
                          int(bool(config.dense_mass)), int(gibbs), n_step,
                          int(bool(config.fixed_mass))])
    # default of each optional trailing signature field (appended over
    # time: dense_mass, gibbs, n_step, fixed_mass): an older, shorter
    # signature is a valid continuation iff this run keeps the defaults
    sig_tail_defaults = {5: 0, 6: 0, 7: 1, 8: 0}
    out_keys = ['samples', 'logp', 'astat', 'div', 'nleaf'] + (
        ['ns', 'nacc'] if gibbs else [])
    done_rows = {k: [] for k in out_keys}     # per transition: (chains, ...)
    start_w = start_d = 0
    carries = state = None

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(dev)

    if resume:
        if not (checkpoint_path and os.path.exists(checkpoint_path)):
            raise FileNotFoundError(
                'no NUTS checkpoint at {!r}'.format(checkpoint_path))
        with np.load(checkpoint_path, allow_pickle=False) as d:
            old_sig = d['cfg_sig']
            k = old_sig.shape[0]
            compat = (k < cfg_sig.shape[0]
                      and np.array_equal(old_sig, cfg_sig[:k])
                      and all(int(cfg_sig[j]) == sig_tail_defaults[j]
                              for j in range(k, cfg_sig.shape[0])))
            if not (np.array_equal(old_sig, cfg_sig) or compat):
                raise ValueError(
                    'checkpoint config {} does not match requested {} '
                    '(num_warmup num_samples max_depth chains dim '
                    'dense_mass gibbs n_step fixed_mass)'.format(
                        old_sig.tolist(), cfg_sig.tolist()))
            _set_gens(gens, d['key'], checkpoint_path)
            if str(d['phase']) == 'warmup':
                start_w = int(d['i'])
                carries = [WarmState(*[t(d['w_' + f][c])
                                       for f in WarmState._fields])
                           for c in range(n_chains)]
            else:
                start_w = config.num_warmup
                start_d = int(d['i'])
                state = [{f: t(d[f][c]) for f in
                          ('z', 'lp', 'grad', 'step_size', 'inv_mass') +
                          (('n',) if gibbs else ())}
                         for c in range(n_chains)]
                for key in out_keys:
                    done_rows[key] = list(d[key].swapaxes(0, 1)[:start_d])

    def rows(key, dtype_=np.float32, tail=()):
        if done_rows[key]:
            return np.stack(done_rows[key], axis=1)
        return np.zeros((n_chains, 0) + tail, dtype_)

    def save_warm(i):
        payload = {'phase': 'warmup', 'i': i, 'cfg_sig': cfg_sig,
                   'key': _gen_bytes(gens)}
        for f in WarmState._fields:
            payload['w_' + f] = torch.stack(
                [getattr(c, f) for c in carries]).cpu().numpy()
        _ckpt_save(checkpoint_path, payload)

    def save_draw(i):
        payload = {'phase': 'draw', 'i': i, 'cfg_sig': cfg_sig,
                   'key': _gen_bytes(gens)}
        for f in state[0]:
            payload[f] = torch.stack([s[f] for s in state]).cpu().numpy()
        payload.update(samples=rows('samples', tail=(dim,)),
                       logp=rows('logp'), astat=rows('astat'),
                       div=rows('div', bool), nleaf=rows('nleaf', np.int64))
        if gibbs:
            payload.update(ns=rows('ns'), nacc=rows('nacc', bool))
        _ckpt_save(checkpoint_path, payload)

    def crossed(i0, i1):
        return (i1 // checkpoint_every) > (i0 // checkpoint_every)

    def notify(phase, i):
        if on_checkpoint is None:
            return
        try:
            on_checkpoint(phase, i, checkpoint_path)
        except Exception as e:   # durability must never kill the chain
            print('nuts on_checkpoint failed: {}'.format(e), flush=True)

    if carries is None and state is None:
        inv0 = [None] * n_chains if init_inv_mass is None else [
            torch.as_tensor(np.asarray(init_inv_mass[c]), dtype=dtype).to(dev)
            for c in range(n_chains)]
        carries = [_warmup_init(lpg, z0s[c], gens[c], config, inv0[c])
                   for c in range(n_chains)]
    i = start_w
    while i < config.num_warmup:
        n = min(spc, config.num_warmup - i)
        for j in range(i, i + n):
            carries = [_warm_step(lpg, config, carries[c], j,
                                  draw_transition(gens[c], dim,
                                                  config.max_depth, dtype))
                       for c in range(n_chains)]
        i += n
        if progress is not None:
            progress('warmup', i, config.num_warmup)
        if checkpoint_path and crossed(i - n, i):
            save_warm(i)
            notify('warmup', i)
    if state is None:
        state = []
        for c in carries:
            z, lp, grad, step_size, inv_mass = _warmup_final(c)
            s = dict(z=z, lp=lp, grad=grad, step_size=step_size,
                     inv_mass=inv_mass)
            if gibbs:
                s['n'] = torch.full((), float(n0), dtype=dtype, device=dev)
            state.append(s)

    i = start_d
    while i < config.num_samples:
        n = min(spc, config.num_samples - i)
        new_rows = []
        for _ in range(n):
            row = {k: [] for k in out_keys}
            for c, s in enumerate(state):
                if gibbs:
                    (s['z'], s['n'], s['lp'], s['grad'], astat, n_leaf, div,
                     acc) = _gibbs_step(
                        gibbs_n, config, s['z'], s['n'], s['lp'], s['grad'],
                        s['step_size'], s['inv_mass'], draw_gibbs(
                            gens[c], dim, config.max_depth, n_step, dtype))
                    row['ns'].append(s['n'])
                    row['nacc'].append(acc)
                else:
                    s['z'], s['lp'], s['grad'], astat, n_leaf, div = \
                        _nuts_step(lpg, s['inv_mass'], s['step_size'],
                                   config.max_depth, s['z'], s['lp'],
                                   s['grad'], draw_transition(
                                       gens[c], dim, config.max_depth, dtype))
                row['samples'].append(s['z'])
                row['logp'].append(s['lp'])
                row['astat'].append(astat)
                row['div'].append(div)
                row['nleaf'].append(n_leaf)
            new_rows.append(row)
        # one copy to the host per group of transitions
        for key in out_keys:
            if key == 'nleaf':
                done_rows[key].extend(np.asarray([r[key] for r in new_rows],
                                                 np.int64))
            else:
                done_rows[key].extend(torch.stack(
                    [torch.stack(r[key]) for r in new_rows]).cpu().numpy())
        i += n
        if progress is not None:
            progress('sample', i, config.num_samples)
        if checkpoint_path and crossed(i - n, i):
            save_draw(i)
            notify('draw', i)
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)   # run completed; drop the checkpoint
    astats = rows('astat')
    out = {'samples': rows('samples', tail=(dim,)), 'logp': rows('logp'),
           'step_size': torch.stack([s['step_size'] for s in state]
                                    ).cpu().numpy(),
           'inv_mass': torch.stack([s['inv_mass'] for s in state]
                                   ).cpu().numpy(),
           'accept_rate': (astats.mean() if astats.size else np.float32(0)),
           'n_divergent': rows('div', bool).astype(np.int32).sum(),
           'n_leapfrog': rows('nleaf', np.int64)}
    if gibbs:
        nacc = rows('nacc', bool)
        out['n_periods'] = rows('ns')
        out['n_accept_rate'] = nacc.mean() if nacc.size else np.float32(0)
    return out


# ---------------------------------------------------------------------------
# ridge-aligned reparameterization
# ---------------------------------------------------------------------------

def whiten_transform(cov_z, center):
    """Ridge-aligned linear reparameterization ``z = center + L u`` with
    ``cov_z = L Lᵀ`` (f64 eigendecomposition; L = V·sqrt(λ)).  Returns
    ``(to_z, to_u, L, anchor)``; ``anchor`` marks the pinned
    eigendirections (eigenvalue below 1e-10), which :func:`whiten_logpdf`
    anchors with a standard-normal term."""
    cov = np.asarray(cov_z, np.float64)
    cov = 0.5 * (cov + cov.T)
    lam, V = np.linalg.eigh(cov)
    sd = np.sqrt(np.clip(lam, 1e-12, None))
    anchor = (lam < 1e-10).astype(np.float64)
    L = V * sd                                  # cov = L @ L.T
    Linv = (V / sd).T
    center = np.asarray(center, np.float64)

    def to_z(u):
        return np.asarray(u, np.float64) @ L.T + center

    def to_u(z):
        return (np.asarray(z, np.float64) - center) @ Linv.T

    return to_z, to_u, L, anchor


def whiten_logpdf(logpdf, L, center, gibbs=False, anchor=None,
                  device=None):
    """The u-space target for :func:`whiten_transform`'s map: the z-space
    target at ``z = center + L u`` (the constant log-Jacobian omitted),
    plus ``-u²/2`` on the ``anchor`` coordinates.  ``gibbs=True`` wraps a
    two-argument target ``logpdf(z, n)``.  ``L``, ``center`` and ``anchor``
    become f32 tensors on ``device``."""
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32).to(
        device)
    Lj, cj = f32(L), f32(center)
    aj = None if anchor is None else f32(anchor)
    gated = getattr(logpdf, 'takes_gate', False)

    def logpdf_u(u, *args, gate=None):
        kw = {'gate': gate} if gated else {}
        lp = logpdf(cj + Lj @ u, *args, **kw)
        if lp is None or aj is None:
            return lp
        return lp - 0.5 * torch.sum(aj * u * u)

    logpdf_u.takes_gate = gated
    return logpdf_u


# ---------------------------------------------------------------------------
# parasitoid-model target
# ---------------------------------------------------------------------------

def _derivatives(transforms, z):
    """|dθ_i/dz_i| of the elementwise bijections, formed as JAX's forward
    derivative of the same expressions forms it (``e/(1+e)²`` with
    ``e = exp(-z)`` for the logits)."""
    from .transforms import Interval, Positive, Unit
    out = []
    for t, zi in zip(transforms, z):
        if t is None:
            out.append(torch.zeros_like(zi))
        elif isinstance(t, Positive):
            out.append(torch.exp(zi))
        elif isinstance(t, (Unit, Interval)):
            e = torch.exp(-zi)
            d = e / (1.0 + e) ** 2
            out.append(d * (t.hi - t.lo) if isinstance(t, Interval) else d)
        else:
            out.append(torch.ones_like(zi))
    return torch.stack(out)


def make_transformed_logpdf(setup, use_sprd=False, free_n=False,
                            traced_obs=False):
    """Unconstrained-space log posterior for NUTS over the parasitoid model,
    with the bijections' log-Jacobian (unlike MAP, which optimizes the
    constrained-space posterior).  By default ``n_periods`` is held at 30,
    as the reference's MAP does (Bayes_MAP.py:144-147); ``free_n=True``
    returns ``logpdf(z, n)`` (the Gibbs-within-NUTS target) and
    ``traced_obs=True`` returns ``logpdf(z, obs)``.  Every form takes
    ``gate=`` and reads it with the evaluation's one transfer
    (``takes_gate``).  Returns ``(logpdf, constrain, z0)`` with
    ``constrain(z[, n]) -> (m_vec, o_vec, sprd)`` and ``z0`` the reference
    start (``map_fit.initial_z``)."""
    from .map_fit import _N_PERIODS_SLOT, _make_objective, initial_z
    from .transforms import MODEL_TRANSFORMS, Unit, obs_transforms

    neg_logpost, constrain, _ = _make_objective(
        setup, use_sprd, free_n=free_n, traced_obs=traced_obs)
    transforms = ([None if i == _N_PERIODS_SLOT else t
                   for i, t in enumerate(MODEL_TRANSFORMS)] +
                  list(obs_transforms(setup.n_sent, setup.min_field_area,
                                      setup.obs_model)) +
                  ([Unit()] if use_sprd else []))

    def log_jacobian(z):
        # every theta_i depends on one z_i; the fixed n_periods slot
        # contributes log(1) = 0
        d = _derivatives(transforms, z)
        return torch.sum(torch.log(torch.where(d > 0, d,
                                               torch.ones_like(d))))

    def logpdf(z, *args, gate=None):
        neg = neg_logpost(z, *args, gate=gate)
        return None if neg is None else -neg + log_jacobian(z)

    logpdf.takes_gate = True
    logpdf.log_jacobian = log_jacobian
    return logpdf, constrain, initial_z(setup, use_sprd)

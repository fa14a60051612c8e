"""Adaptive Metropolis MCMC (L4), PyTorch port of
``parasitoids_tpu/bayes/sampler.py`` (reference Bayes_Run.py:484-537).

* the 15 model parameters are block-updated with an adaptive multivariate
  normal proposal: initial covariance ``diag(step_scales²)`` as the
  reference seeds ``AdaptiveMetropolis`` (Bayes_Run.py:188-196,486-487),
  then Haario-style adaptation from streaming chain moments every step
  after a warm-up, with the 2.38²/d optimal scaling and a Robbins–Monro
  scale factor; the discrete ``n_periods`` component is rounded in the
  proposal, as PyMC's AM does for discrete stochastics,
* every block proposal inside the prior's support re-runs the full forward
  simulation (on CUDA through the day kernel),
* observation parameters (xi, em/grid obs probs, A_collected, per-field
  sentinel probs, the variant's extra slot) get individual random-walk
  updates that reuse the cached forward projections.

A step is a Python function on tensors of the setup's device, run under
``torch.no_grad()``: no graph is built.  It reads the card exactly once,
in the model block: the proposal's prior value, which decides on the host
whether the forward runs, comes in the same transfer as the two |ρ| whose
Genz branches the forward's BVNs need (``BayesSetup._branches``).
Accept/reject, the Welford moments, the scale adaptation and the whole
observation sweep are tensor arithmetic with ``torch.where``.  A step's
random numbers come from the chain's own ``torch.Generator`` in two
launches, or from the caller (``draws``), so a test can replay another
stream.  The generator is advanced in place: a :class:`ChainState` is
used up by the step that takes it.

:func:`mcmc_step_batched` is the same transition for N stacked states at
once (the JAX step under ``vmap``): one batched forward for every
particle's proposal on a ``with_batched_bvn`` setup, out-of-support
proposals masked to −inf by a select, and no host read at all.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace
from .model import BayesSetup, _as_model, _as_obs
from .priors import (STEP_SCALES, initial_model_params, initial_obs_params,
                     log_prior_model, log_prior_obs)

__all__ = ['MCMCConfig', 'ChainState', 'StepDraws', 'FORWARDS',
           'BATCHED_FORWARDS', 'chain_generator', 'draw_step',
           'init_chain_state', 'run_mcmc', 'mcmc_step', 'mcmc_step_batched',
           'stack_states', 'unstack_states']

_N_MODEL = 15
_DISCRETE_IDX = 13        # n_periods position in the block
_ADAPT_START = 500        # steps before switching to empirical covariance
_OPT_SCALE = 2.38 ** 2 / _N_MODEL

# forward simulations run so far by this module and by ``store.load_chain``
# (one per chain initialised or reloaded, one per block proposal whose prior
# is finite); a run reads it beside ``ops.day_kernel.LAUNCHES``
FORWARDS = 0
# batched forwards run by ``mcmc_step_batched`` (each advances every
# particle: N forward simulations, one batched launch a day); a run reads
# it beside ``ops.day_kernel.LAUNCHES_BATCHED``
BATCHED_FORWARDS = 0


class MCMCConfig(NamedTuple):
    # no pre-spread (``sprd_factor``) option by design: the reference's
    # MCMC never samples it (Bayes_Run.py:168-175); it is a MAP-only prior
    n_samples: int
    adapt_start: int = _ADAPT_START
    obs_scale: float = 0.05       # relative RW scale for obs parameters
    # Metropolis-within-Gibbs sweeps over the obs block per model-block
    # step.  They reuse the cached projections, so extra sweeps cost little
    # next to the forward simulation, and they shorten the autocorrelation
    # time along the weakly identified xi x obs-prob likelihood ridge.
    obs_sweeps: int = 1


class ChainState(NamedTuple):
    m: torch.Tensor           # (15,) model block
    o: torch.Tensor           # (4 + n_sent + extra,) obs params
    loglik: torch.Tensor      # cached likelihood at (m, o), untempered
    prior_m: torch.Tensor
    prior_o: torch.Tensor
    proj: tuple               # cached forward projections at m
    key: torch.Generator      # the chain's generator, advanced in place
    # streaming moments of the model block (Welford)
    count: torch.Tensor
    mean: torch.Tensor        # (15,)
    m2: torch.Tensor          # (15, 15)
    accepts_m: torch.Tensor
    accepts_o: torch.Tensor
    # log of the global proposal-scale factor, Robbins–Monro-adapted toward
    # the 0.234 optimal acceptance rate once the empirical-covariance phase
    # begins (Andrieu & Thoms 2008 algorithm 4): the role of PyMC AM's
    # ``shrink_if_necessary``
    log_scale: torch.Tensor


class StepDraws(NamedTuple):
    """The random numbers of one step: the block proposal's normals and the
    log of its uniform, then one normal and one log-uniform per coordinate
    move of the observation sweeps."""
    eps: torch.Tensor         # (15,)
    log_u: torch.Tensor       # ()
    obs_eps: torch.Tensor     # (n_obs · obs_sweeps,)
    obs_log_u: torch.Tensor   # (n_obs · obs_sweeps,)


def chain_generator(seed, chain, device):
    """The generator of chain ``chain`` of a run seeded with ``seed``, on
    ``device``: its seed is hashed from both, so chains of one run and
    equal chains of two runs never share a stream."""
    word = np.random.SeedSequence([int(seed), int(chain)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word >> 1))


def draw_step(gen, n_moves, dtype, device):
    """One step's :class:`StepDraws` from ``gen`` in two launches."""
    z = torch.randn(_N_MODEL + n_moves, generator=gen, dtype=dtype,
                    device=device)
    log_u = torch.log(torch.rand(1 + n_moves, generator=gen, dtype=dtype,
                                 device=device))
    return StepDraws(z[:_N_MODEL], log_u[0], z[_N_MODEL:], log_u[1:])


def _n_obs(setup):
    return 4 + setup.n_sent + setup.n_extra_obs


def _forward(setup, m, branches=None):
    global FORWARDS
    FORWARDS += 1
    return setup.forward_projections(m, branches=branches)


@torch.no_grad()
def init_chain_state(setup: BayesSetup, key, m0=None, o0=None,
                     obs_mask=None, obs=None):
    """Evaluate the model at the initial point and build the chain state.
    ``key``: the chain's ``torch.Generator`` on the setup's device
    (:func:`chain_generator`).  ``obs_mask``: optional likelihood mask
    (``BayesSetup.split_point_mask``).  ``obs``: optional observed-data
    structure (``BayesSetup.obs_pytree``)."""
    dtype, dev = setup.setup.wind_flat.dtype, setup.setup.wind_flat.device
    if m0 is None:
        m0 = initial_model_params()
    if o0 is None:
        o0 = initial_obs_params(
            [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
            setup.cell_res ** 2, setup.obs_model)

    def vec(a):
        if torch.is_tensor(a):
            return a.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype).to(dev)

    m0, o0 = vec(m0), vec(o0)
    m = _as_model(m0)
    o = _as_obs(o0, setup.n_sent)
    proj = _forward(setup, m)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return ChainState(
        m=m0, o=o0, loglik=setup.log_likelihood(proj, o, obs_mask, obs),
        prior_m=log_prior_model(m),
        prior_o=log_prior_obs(o, setup.field_areas, setup.min_field_area,
                              setup.obs_model),
        proj=proj, key=key, count=zero.clone(),
        mean=torch.zeros(_N_MODEL, dtype=dtype, device=dev),
        m2=torch.zeros((_N_MODEL, _N_MODEL), dtype=dtype, device=dev),
        accepts_m=zero.clone(), accepts_o=zero.clone(),
        log_scale=zero.clone())


@lru_cache(maxsize=None)
def _seed_cov(dtype, device):
    """``diag(STEP_SCALES²)`` and the adapted covariance's 1e-9 ridge on
    ``device``, made once: a host-to-card copy in the step would wait for
    the card."""
    scales = torch.as_tensor(STEP_SCALES, dtype=dtype).to(device)
    return (torch.diag(scales ** 2),
            1e-9 * torch.eye(_N_MODEL, dtype=dtype, device=device))


def _proposal_chol(state, adapt_start):
    """Cholesky factor of the proposal covariance: seeded diag(scales²),
    switching to the scaled empirical covariance once enough history exists
    (Haario AM).  The switch is a ``torch.where`` on the device's count and
    the factorization does not report back, so nothing waits on the card.
    A covariance that is not positive definite gives NaN, as JAX's
    ``cholesky`` does: the proposal's prior is then not finite and the step
    is rejected, where ``cholesky_ex``'s partly factored matrix would
    propose from a covariance nobody chose."""
    seed, jitter = _seed_cov(state.m.dtype, state.m.device)
    count = state.count[..., None, None]       # stacked states: one each
    emp = state.m2 / torch.clamp(count - 1.0, min=1.0)
    adapted = (_OPT_SCALE * torch.exp(state.log_scale[..., None, None]) *
               emp + jitter)
    cov = torch.where(count >= adapt_start, adapted, seed)
    L, info = torch.linalg.cholesky_ex(cov, check_errors=False)
    return torch.where(info[..., None, None] == 0, L,
                       torch.full_like(L, math.nan))


def _obs_move(setup: BayesSetup, j, z, o_vec, prior_o, ll_cur, proj, beta,
              cfg: MCMCConfig, obs_mask=None, obs=None):
    """Propose a relative-scale random-walk move of observation coordinate
    ``j`` with the standard normal ``z``; returns ``(o_prop, prior_p, ll_p,
    log ratio)``.

    Coordinate ``j`` moves by ``N(0, s(o_j)²)`` with ``s(x) = max(|x|,
    1e-3) · cfg.obs_scale``.  The scale depends on the current state, so
    the proposal is asymmetric and the ratio carries the
    Metropolis–Hastings term ``log q(o|o') − log q(o'|o)``; without it the
    walk's invariant measure picks up a factor of about 1/s(x), which
    biases every observation probability toward 0 and drags xi up the
    xi·p likelihood ridge.

    The likelihood is always evaluated (it is cheap next to a forward) and
    masked to −inf where the proposal's prior is not finite: no branch
    reads the card.  A likelihood that is NaN there (the log of a negative
    rate or dispersion) is masked with it, and a NaN ratio compares false,
    so neither can enter the chain.  Stacked particles (``o_vec`` of
    ``(N, n_obs)``, ``z`` of ``(N,)``) move together.
    """
    s_fwd = torch.clamp(o_vec[..., j].abs(), min=1e-3) * cfg.obs_scale
    step = s_fwd * z
    o_prop = o_vec.clone()          # out of place: o_vec is chain state
    o_prop[..., j] = o_vec[..., j] + step
    s_rev = torch.clamp(o_prop[..., j].abs(), min=1e-3) * cfg.obs_scale
    o_p = _as_obs(o_prop, setup.n_sent)
    prior_p = log_prior_obs(o_p, setup.field_areas, setup.min_field_area,
                            setup.obs_model)
    ll_p = setup.log_likelihood(proj, o_p, obs_mask, obs)
    ll_p = torch.where(torch.isfinite(prior_p), ll_p,
                       torch.full_like(ll_p, -math.inf))
    # the reverse move draws from N(o', s_rev²): the difference of the two
    # log normal densities
    hastings = (torch.log(s_fwd) - torch.log(s_rev)
                + step ** 2 / (2.0 * s_fwd ** 2)
                - step ** 2 / (2.0 * s_rev ** 2))
    ratio = ((prior_p + beta * ll_p) - (prior_o + beta * ll_cur) + hastings)
    return o_prop, prior_p, ll_p, ratio


def _obs_sweep(setup: BayesSetup, obs_eps, obs_log_u, o_vec, prior_o, ll_cur,
               proj, beta, cfg: MCMCConfig, obs_mask=None, obs=None,
               n_sweeps=1):
    """``n_sweeps`` Metropolis-within-Gibbs sweeps over the observation
    block, reusing the cached forward projections (only the rates
    recompute: PyMC's per-stochastic step methods, Bayes_Run.py:486-487).
    ``obs_eps`` and ``obs_log_u`` hold one normal and one log-uniform per
    coordinate move.  Nothing here reads the card.  Returns ``(o_vec,
    prior_o, ll_cur, n_accepts)``.  Stacked particles carry their draws
    on the last axis, ``(N, n_moves)``."""
    n_obs = _n_obs(setup)
    acc_o = torch.zeros_like(prior_o)
    with trace.span('am.obs_sweep'):
        for i in range(n_obs * n_sweeps):
            o_prop, prior_p, ll_p, ratio = _obs_move(
                setup, i % n_obs, obs_eps[..., i], o_vec, prior_o, ll_cur,
                proj, beta, cfg, obs_mask, obs)
            acc = obs_log_u[..., i] < ratio
            o_vec = torch.where(acc[..., None], o_prop, o_vec)
            prior_o = torch.where(acc, prior_p, prior_o)
            ll_cur = torch.where(acc, ll_p, ll_cur)
            acc_o = acc_o + acc.to(acc_o.dtype)
    return o_vec, prior_o, ll_cur, acc_o


def _model_proposal(setup: BayesSetup, state: ChainState, cfg: MCMCConfig,
                    beta, eps, obs_mask=None, obs=None):
    """The block proposal from the normals ``eps`` and its evaluation:
    ``(m_prop, prior, loglik, projections, log ratio)``.  One host read:
    the prior's value with both |ρ| (``BayesSetup._branches``).  Outside
    the prior's support the forward is skipped, the likelihood is −inf and
    the projections are the state's."""
    m_prop_vec = state.m + _proposal_chol(state, cfg.adapt_start) @ eps
    m_prop_vec[_DISCRETE_IDX] = torch.round(m_prop_vec[_DISCRETE_IDX])
    m_prop = _as_model(m_prop_vec)
    prior_prop = log_prior_model(m_prop)
    branches, prior_value = setup._branches(m_prop, prior_prop)
    if math.isfinite(prior_value):
        proj_prop = _forward(setup, m_prop, branches)
        ll_prop = setup.log_likelihood(
            proj_prop, _as_obs(state.o, setup.n_sent), obs_mask, obs)
    else:
        proj_prop = state.proj
        ll_prop = torch.full_like(state.loglik, -math.inf)
    log_ratio = ((prior_prop + beta * ll_prop)
                 - (state.prior_m + beta * state.loglik))
    return m_prop_vec, prior_prop, ll_prop, proj_prop, log_ratio


def _where_tree(cond, new, old):
    """``torch.where`` over a projection tree; ``cond`` is 0-d, or one
    value per stacked particle, ``(N,)``, against leaves ``(N, ...)``."""
    if torch.is_tensor(new):
        if new is old:
            return new
        return torch.where(cond.reshape(cond.shape + (1,) *
                                        (new.ndim - cond.ndim)), new, old)
    return tuple(_where_tree(cond, a, b) for a, b in zip(new, old))


def _accept_and_sweep(setup, state, cfg, beta, draws, m_prop, prior_prop,
                      ll_prop, proj_prop, log_ratio, obs_mask, obs):
    """The rest of an AM transition once the block proposal is evaluated:
    accept or reject it, update the streaming moments and the scale, and
    sweep the observation block.  One state, or stacked particles (every
    field with a leading axis).  Returns the new state."""
    accept = draws.log_u < log_ratio
    m_new = torch.where(accept[..., None], m_prop, state.m)
    proj_new = _where_tree(accept, proj_prop, state.proj)
    ll_new = torch.where(accept, ll_prop, state.loglik)
    prior_m_new = torch.where(accept, prior_prop, state.prior_m)
    accept = accept.to(state.m.dtype)

    # streaming moments over the (post-update) chain position
    count = state.count + 1.0
    delta = m_new - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta[..., :, None] * (m_new - mean)[..., None, :]
    # proposal-scale adaptation toward 0.234 acceptance, active with the
    # empirical covariance (diminishing Robbins–Monro steps)
    gamma = torch.where(
        count >= cfg.adapt_start,
        1.0 / torch.sqrt(torch.clamp(count - cfg.adapt_start + 1.0, min=1.0)),
        torch.zeros_like(count))
    log_scale = state.log_scale + gamma * (accept - 0.234)

    # ---- observation-parameter sweeps (cached projections) -----------
    o_vec, prior_o, ll_cur, acc_sweeps = _obs_sweep(
        setup, draws.obs_eps, draws.obs_log_u, state.o, state.prior_o,
        ll_new, proj_new, beta, cfg, obs_mask, obs, n_sweeps=cfg.obs_sweeps)
    return ChainState(
        m=m_new, o=o_vec, loglik=ll_cur, prior_m=prior_m_new,
        prior_o=prior_o, proj=proj_new, key=state.key, count=count,
        mean=mean, m2=m2, accepts_m=state.accepts_m + accept,
        accepts_o=state.accepts_o + acc_sweeps, log_scale=log_scale)


@torch.no_grad()
def _mcmc_step(setup: BayesSetup, state: ChainState, cfg: MCMCConfig,
               beta=1.0, obs_mask=None, obs=None, draws=None):
    """One AM transition targeting ``prior + beta * loglik``; returns
    ``(new state, trace row)``.

    ``beta`` is the inverse temperature: 1.0 is the posterior (the only
    value the reference's AdaptiveMetropolis targets); ``beta < 1`` tempers
    the likelihood only, so every tempered chain still lives on the prior's
    support.  ``state.loglik`` stays untempered.  ``obs_mask`` and ``obs``
    must be those the chain state was initialised with.  ``draws``: the
    step's :class:`StepDraws`, else drawn from ``state.key``.
    """
    dtype, dev = state.m.dtype, state.m.device
    n_moves = _n_obs(setup) * cfg.obs_sweeps
    with trace.span('am.step', request=True):
        if draws is None:
            draws = draw_step(state.key, n_moves, dtype, dev)
        new_state = _accept_and_sweep(
            setup, state, cfg, beta, draws,
            *_model_proposal(setup, state, cfg, beta, draws.eps, obs_mask,
                             obs),
            obs_mask, obs)
        sample = torch.cat([new_state.m, new_state.o,
                            (new_state.prior_m + new_state.prior_o +
                             new_state.loglik).reshape(1)])
    return new_state, sample


# public alias for a tempering layer (beta-parameterized transition)
mcmc_step = _mcmc_step


@torch.no_grad()
def mcmc_step_batched(setup: BayesSetup, states: ChainState, cfg: MCMCConfig,
                      beta=1.0, obs_mask=None, draws=None):
    """One AM transition of N stacked particles (:func:`stack_states`) at
    once, targeting ``prior + beta * loglik``: the JAX step under
    ``vmap``.  ``setup`` must be a ``with_batched_bvn`` copy, whose
    forward takes every particle's proposal in one batched forward (on
    the card one launch of the particle-batched day kernel a day).

    The forward runs for every particle: a proposal outside the prior's
    support forwards its current position instead (so nothing it computes
    is NaN), and its likelihood is −inf by a select, as JAX's ``lax.cond``
    under ``vmap``.  Nothing here reads the card.  Each particle draws its
    :class:`StepDraws` from its own generator, as in turn; ``draws``: the
    ``(N, ...)``-stacked draws instead.  Returns the new stacked states;
    the generators are advanced in place."""
    global FORWARDS, BATCHED_FORWARDS
    if not setup.setup.kcfg.batched_bvn:
        raise ValueError('mcmc_step_batched needs a with_batched_bvn() '
                         'setup')
    dtype, dev = states.m.dtype, states.m.device
    n = states.m.shape[0]
    n_moves = _n_obs(setup) * cfg.obs_sweeps
    if draws is None:
        draws = StepDraws(*[torch.stack(x) for x in zip(*[
            draw_step(g, n_moves, dtype, dev) for g in states.key])])

    # ---- model block update: one batched forward ----------------------
    m_prop = states.m + (_proposal_chol(states, cfg.adapt_start) @
                         draws.eps[..., None])[..., 0]
    m_prop[..., _DISCRETE_IDX] = torch.round(m_prop[..., _DISCRETE_IDX])
    prior_prop = log_prior_model(_as_model(m_prop))
    inside = torch.isfinite(prior_prop)
    m_fwd = torch.where(inside[:, None], m_prop, states.m)
    FORWARDS += n
    BATCHED_FORWARDS += 1
    proj_prop = setup.forward_projections(_as_model(m_fwd))
    ll_prop = setup.log_likelihood(proj_prop, _as_obs(states.o, setup.n_sent),
                                   obs_mask)
    ll_prop = torch.where(inside, ll_prop, torch.full_like(ll_prop,
                                                           -math.inf))
    log_ratio = ((prior_prop + beta * ll_prop)
                 - (states.prior_m + beta * states.loglik))
    return _accept_and_sweep(setup, states, cfg, beta, draws, m_prop,
                             prior_prop, ll_prop, proj_prop, log_ratio,
                             obs_mask, None)


@torch.no_grad()
def run_mcmc(setup: BayesSetup, state: ChainState, cfg: MCMCConfig,
             obs=None):
    """Advance one chain ``cfg.n_samples`` steps.

    Returns ``(final state, trace)``; the trace is an ``(n_samples, dim)``
    tensor on the setup's device with rows ``[model params (15), obs
    params, log posterior]``, written in place step by step and never read
    here.  ``obs``: optional observed-data structure (``obs_pytree``) in
    place of the setup's dataset."""
    dim = _N_MODEL + _n_obs(setup) + 1
    trace = torch.empty((cfg.n_samples, dim), dtype=state.m.dtype,
                        device=state.m.device)
    for i in range(cfg.n_samples):
        state, sample = _mcmc_step(setup, state, cfg, obs=obs)
        trace[i] = sample
    return state, trace


def stack_states(states):
    """Chain states stacked along a new leading chain axis (tensors
    stacked, the generators as a tuple): the form ``run_chains`` and the
    store take for several chains."""
    def stack(*xs):
        if torch.is_tensor(xs[0]):
            return torch.stack(xs)
        return tuple(stack(*ys) for ys in zip(*xs))

    fields = {f: (tuple(s.key for s in states) if f == 'key'
                  else stack(*[getattr(s, f) for s in states]))
              for f in ChainState._fields}
    return ChainState(**fields)


def unstack_states(stacked):
    """The per-chain states of :func:`stack_states`'s result."""
    def pick(x, i):
        if torch.is_tensor(x):
            return x[i]
        return tuple(pick(y, i) for y in x)

    return [ChainState(**{f: (stacked.key[i] if f == 'key'
                              else pick(getattr(stacked, f), i))
                          for f in ChainState._fields})
            for i in range(len(stacked.key))]

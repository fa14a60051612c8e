"""Adaptive tempered Sequential Monte Carlo (SMC) over the full posterior,
PyTorch port of ``parasitoids_tpu/bayes/smc.py``.

Beyond-reference capability (the reference's only sampler is a single PyMC
AdaptiveMetropolis chain, Bayes_Run.py:484-487): a particle population is
initialized from the exact joint prior (priors.py ``sample_prior_*`` — the
same distributions whose densities the reference evaluates), then annealed
to the posterior through a *data-driven* inverse-temperature path

    0 = beta_0 < beta_1 < ... < beta_S = 1,

where each increment is chosen on the fly so the effective sample size of
the incremental importance weights stays at a target fraction (Del Moral,
Doucet & Jasra 2012 adaptive SMC).  Each stage reweights, resamples
(systematic) when ESS drops below a threshold, and rejuvenates every
particle with ``n_moves`` adaptive-Metropolis transitions targeting the
current tempered posterior — the same ``mcmc_step`` kernel as the AM/PT
samplers, with its proposal covariance retuned each stage from the whole
particle population.

The stage products ``log sum_i W_i exp(delta_s * loglik_i)`` telescope to
the model evidence, a third marginal-likelihood estimator beside parallel
tempering's thermodynamic-integration and stepping-stone estimates
(tempering.py).

Execution: the particles are stacked chain states on the one card.  By
default they advance in turn; with ``batched=True`` (``PARA_SMC_BATCHED=1``
on the command line) every move advances the whole population at once
(``sampler.mcmc_step_batched`` on a ``with_batched_bvn`` setup: one
batched forward, on the card one launch of the particle-batched day
kernel a day, no host read), each particle's day accumulate by its own
Genz tier (the JAX package's batched path takes the select node rule).
The between-stage logic (weights, schedule, resampling, covariance
retune) is host numpy, a copy of the JAX package's, and the same in both
modes, so a resume may switch modes;
each stage reads the population's log likelihoods in one transfer and
each move round its acceptance counts in one.  A resample gives every
particle a generator of its own, derived from its ancestor's state and
its index without advancing the ancestor, so clones move differently and
a resumed run is bitwise a monolithic one.  With a particle mesh
(``mesh=``) each move round shards the particles over its devices: each
shard's particles, in turn or batched, move on its device through the
setup's copy there, and the population gathers back on the lead device,
where the between-stage logic reads it as without a mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .model import BayesSetup
from .priors import STEP_SCALES, sample_prior_model, sample_prior_obs
from .sampler import (ChainState, MCMCConfig, StepDraws, chain_generator,
                      init_chain_state, mcmc_step, mcmc_step_batched,
                      stack_states, unstack_states)

__all__ = ['SMCConfig', 'ess', 'next_beta', 'systematic_resample',
           'init_smc_particles', 'run_smc', 'clone_generator']

# frozen-kernel particle count: moves run with the Welford count pinned far
# past adapt_start, so within a stage the proposal stays the population
# covariance (per-step Robbins-Monro gain ~1/sqrt(_C0 - adapt_start) ~ 0.01)
_C0 = 10_000.0
_ADAPT_START = 500
# shrinkage of the population covariance toward the reference's seed
# diag(step_scales^2) (Bayes_Run.py:188-196): keeps the proposal full-rank
# when the population is small or momentarily degenerate
_SHRINK = 0.1


class SMCConfig(NamedTuple):
    n_particles: int
    n_moves: int = 5            # rejuvenation MCMC steps per move round
    ess_target: float = 0.5     # next beta solves ESS = target * N
    resample_ess: float = 0.5   # resample when ESS/N falls below this
    max_stages: int = 200       # hard cap on annealing stages
    obs_scale: float = 0.05     # as MCMCConfig
    obs_sweeps: int = 1         # as MCMCConfig (ridge-mixing knob)
    # adaptive rejuvenation: repeat ``n_moves``-step move rounds until the
    # average particle has accepted >= ``min_accepts`` jumps this stage
    # (or ``max_move_rounds`` is hit).  Resampling collapses the population
    # onto few genealogies; if the subsequent moves barely accept, the
    # weight-based ESS criterion goes blind to the position degeneracy and
    # the anneal takes giant, badly-supported temperature jumps — spending
    # extra moves exactly where mixing is poor is the standard cure.
    min_accepts: float = 2.0
    max_move_rounds: int = 10


# ----------------------------------------------------------------------
# host-side annealing machinery (pure NumPy; copies of the JAX package's)
# ----------------------------------------------------------------------

# one host-side f64 logsumexp for the whole bayes package (defined in
# tempering.py; re-exported here for the module-local call sites)
from .tempering import logsumexp as _logsumexp  # noqa: E402


def ess(logw):
    """Kish effective sample size of (unnormalized) log weights."""
    return float(np.exp(2.0 * _logsumexp(logw) - _logsumexp(2.0 * np.asarray(
        logw, np.float64))))


def next_beta(beta, loglik, logw, target_ess, tol=1e-10):
    """Largest temperature increment ``delta`` such that the reweighted
    population keeps ``ESS(logw + delta*loglik) >= target_ess``, found by
    bisection (Del Moral et al. 2012 sec. 3.1); capped at ``1 - beta``.

    Returns ``delta`` (> 0).  If even the full remaining step keeps the ESS
    at or above target (e.g. a nearly flat likelihood), the cap is returned
    and the caller lands exactly on beta = 1.
    """
    ll = np.where(np.isfinite(loglik), np.asarray(loglik, np.float64),
                  -1e300)
    cap = 1.0 - beta
    if cap <= 0:
        raise ValueError('beta is already 1')
    if ess(logw + cap * ll) >= target_ess:
        return cap
    lo, hi = 0.0, cap
    while hi - lo > tol * max(1.0, cap):
        mid = 0.5 * (lo + hi)
        if ess(logw + mid * ll) >= target_ess:
            lo = mid
        else:
            hi = mid
    return max(lo, tol)


def systematic_resample(weights, rng):
    """Systematic (stratified single-uniform) resampling: indices ``i`` with
    ``E[count_i] = N * w_i`` and counts off by at most 1 from N*w_i."""
    w = np.asarray(weights, np.float64)
    n = w.shape[0]
    pos = (rng.random() + np.arange(n)) / n
    return np.searchsorted(np.cumsum(w / w.sum()), pos).clip(0, n - 1)


def _population_cov(m, logw):
    """Weighted mean/covariance of the model block, shrunk toward the
    reference's seed proposal diag(step_scales^2)."""
    w = np.exp(np.asarray(logw, np.float64)
               - _logsumexp(logw))
    m = np.asarray(m, np.float64)
    mu = w @ m
    d = m - mu
    cov = (d * w[:, None]).T @ d
    cov = (1.0 - _SHRINK) * cov + _SHRINK * np.diag(
        np.asarray(STEP_SCALES, np.float64) ** 2)
    return mu, cov


# ----------------------------------------------------------------------
# device side: particles in turn on the one card
# ----------------------------------------------------------------------

def clone_generator(ancestor: torch.Generator, i):
    """The generator of particle ``i`` after a resample that drew it from
    ``ancestor``: seeded by a hash of the ancestor's state and ``i``, on
    the ancestor's device, the ancestor itself not advanced (the role of
    JAX's ``fold_in(key, i)``)."""
    state = ancestor.get_state().numpy()
    words = np.frombuffer(state.tobytes() + bytes(-len(state) % 4),
                          np.uint32)
    word = np.random.SeedSequence([*words.tolist(), int(i)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=ancestor.device).manual_seed(
        int(word >> 1))


def init_smc_particles(setup: BayesSetup, key, n, mesh=None, obs_mask=None):
    """``n`` particles drawn from the exact joint prior, with the forward
    model evaluated at each, in turn (stacked ChainState).  ``key``: the
    integer seed of the prior draws (a CPU generator) and of the
    particles' generators (``chain_generator(key, i)``).  With a ``mesh``
    (``n`` must divide over it) each particle is evaluated on its shard's
    device, where its generator stays; the states gather on the lead
    device."""
    from ..parallel.chains import member_devices, to_device
    dev = setup.setup.wind_flat.device
    devs = [dev] * n if mesh is None else member_devices(n, mesh)
    lead = dev if mesh is None else mesh.devices[0]
    gen = torch.Generator().manual_seed(int(key))
    m0s = sample_prior_model(gen, n)
    o0s = sample_prior_obs(gen, setup.field_areas.cpu().numpy(),
                           setup.min_field_area, setup.obs_model, n)
    return stack_states([to_device(init_chain_state(
        setup.on_device(d), chain_generator(key, i, d), m0=m0s[i], o0=o0s[i],
        obs_mask=to_device(obs_mask, d)), lead, generators=False)
        for i, d in enumerate(devs)])


def _move_prog(setup, states, beta, n_moves, obs_scale, obs_sweeps=1,
               obs_mask=None, draws=None, batched=False, mesh=None):
    """``n_moves`` AM transitions at inverse temperature ``beta`` (a host
    float) on every particle: the particles in turn, or with ``batched``
    (``setup`` a ``with_batched_bvn`` copy) all at once for each move.
    ``draws(i, k)``: optional ``StepDraws`` of particle ``i``'s move
    ``k``.  With a ``mesh`` each shard of particles moves on its device
    (the setup's and the mask's copies there) and the population gathers
    back on the lead device."""
    if mesh is not None:
        from ..parallel.chains import (concat_rows, shard_bounds, take_rows,
                                       to_device)
        parts = []
        for d, a, b in shard_bounds(states.m.shape[0], mesh):
            parts.append(_move_prog(
                setup.on_device(d), to_device(take_rows(states, a, b), d),
                beta, n_moves, obs_scale, obs_sweeps,
                to_device(obs_mask, d),
                None if draws is None else
                (lambda i, k, a=a: draws(a + i, k)), batched))
        return concat_rows(parts, mesh.devices[0])
    mcfg = MCMCConfig(n_samples=n_moves, adapt_start=_ADAPT_START,
                      obs_scale=obs_scale, obs_sweeps=obs_sweeps)
    if batched:
        n = states.m.shape[0]
        for k in range(n_moves):
            d = (None if draws is None else StepDraws(*[
                torch.stack(x) for x in zip(*[draws(i, k)
                                              for i in range(n)])]))
            states = mcmc_step_batched(setup, states, mcfg, beta=beta,
                                       obs_mask=obs_mask, draws=d)
        return states
    out = []
    for i, s in enumerate(unstack_states(states)):
        for k in range(n_moves):
            s, _ = mcmc_step(setup, s, mcfg, beta=beta, obs_mask=obs_mask,
                             draws=None if draws is None else draws(i, k))
        out.append(s)
    return stack_states(out)


def _retune(states, mu, cov, log_scale):
    """Pin every particle's proposal to the population covariance: the
    Welford moments are overwritten so ``_proposal_chol`` (sampler.py)
    reconstructs ``cov`` exactly, with the count far enough past
    ``adapt_start`` that within-stage adaptation is negligible.  One copy
    of the host arrays to the device."""
    n = states.m.shape[0]
    dtype, dev = states.m.dtype, states.m.device
    mu = np.broadcast_to(np.asarray(mu, np.float32), tuple(states.m.shape))
    m2 = np.broadcast_to(np.asarray(cov * (_C0 - 1.0), np.float32),
                         tuple(states.m2.shape))
    host = torch.from_numpy(np.concatenate([
        mu.ravel(), m2.ravel(), np.full(n, _C0, np.float32),
        np.full(n, np.float32(log_scale))]))
    flat = host.to(device=dev, dtype=dtype)
    a, b = mu.size, mu.size + m2.size
    return states._replace(
        mean=flat[:a].reshape(states.m.shape),
        m2=flat[a:b].reshape(states.m2.shape), count=flat[b:b + n],
        log_scale=flat[b + n:])


def _resample(states, idx):
    """The particles at ``idx`` (host indices), each with a generator of
    its own derived from its ancestor's (:func:`clone_generator`)."""
    perm = torch.as_tensor(np.asarray(idx, np.int64)).to(states.m.device)

    def take(x):
        if torch.is_tensor(x):
            return x.index_select(0, perm)
        return tuple(take(y) for y in x)

    return ChainState(**{
        f: (tuple(clone_generator(states.key[a], i)
                  for i, a in enumerate(np.asarray(idx)))
            if f == 'key' else take(getattr(states, f)))
        for f in ChainState._fields})


def _host(t):
    return t.detach().cpu().numpy().astype(np.float64)


def run_smc(setup: BayesSetup, key, cfg: SMCConfig, mesh=None, seed=0,
            verbose=False, checkpoint=None, resume=None, obs_mask=None,
            batched=False, draws=None):
    """Anneal a prior particle population to the posterior.

    ``key``: the integer seed of the initial population
    (:func:`init_smc_particles`).  ``seed`` drives the host-side
    resampling stream (stage-keyed, so a checkpointed run resumed
    mid-anneal is bitwise-identical to a monolithic one).
    ``checkpoint(payload)``, if given, is called after every stage with the
    complete annealer state; ``resume`` is such a payload to continue from
    (``key`` is then unused).  ``obs_mask`` (model.py
    ``split_point_mask``) targets a masked likelihood — bayes/cv.py's
    refit folds.  ``batched``: the moves advance every particle at once
    through ``setup.with_batched_bvn()`` (the anneal is unchanged, so a
    resume may switch modes either way).
    ``draws(stage, rnd, i, k)``: optional ``StepDraws`` of particle
    ``i``'s move ``k`` in move round ``rnd`` of ``stage``.

    ``mesh``: the particle mesh (``parallel.chains.chain_mesh``; the
    particle count must divide over it): each move round and the initial
    evaluations run shard by shard on its devices, with exactly the ops
    of ``mesh=None``, so the payload is bitwise the same.

    Returns a payload dict:

    * ``'states'`` — final stacked ChainState (posterior particles),
    * ``'logw'`` — (N,) final unnormalized log weights,
    * ``'beta'`` — final inverse temperature (1.0 on completion),
    * ``'logz'`` — SMC marginal-likelihood estimate
      (= log Z once beta = 1; cross-check against tempering.log_evidence),
    * ``'log_scale'``, ``'stage'`` — kernel-tuning / schedule state,
    * ``'history'`` — dict of per-stage arrays (betas, ess, acceptance,
      resampled flags, logz path).
    """
    N = cfg.n_particles
    if mesh is not None and N % mesh.size:
        raise ValueError('n_particles must divide evenly over the mesh '
                         '({} over {} devices)'.format(N, mesh.size))
    # the initial particles take the in-turn forward, as JAX's do; the
    # moves take the batched one when asked
    move_setup = setup.with_batched_bvn() if batched else setup

    if resume is not None:
        states = resume['states']
        logw = np.asarray(resume['logw'], np.float64)
        beta = float(resume['beta'])
        logz = float(resume['logz'])
        log_scale = float(resume['log_scale'])
        stage = int(resume['stage'])
        hist = {k: list(np.atleast_1d(v))
                for k, v in resume['history'].items()}
    else:
        states = init_smc_particles(setup, key, N, mesh, obs_mask=obs_mask)
        logw = np.zeros(N)
        beta = 0.0
        logz = 0.0
        log_scale = 0.0
        stage = 0
        hist = {'betas': [0.0], 'ess': [float(N)], 'accept': [],
                'resampled': [], 'logz': [0.0]}

    def payload():
        return {'states': states, 'logw': logw, 'beta': beta,
                'logz': logz, 'log_scale': log_scale, 'stage': stage,
                'history': {k: np.asarray(v) for k, v in hist.items()}}

    while beta < 1.0 and stage < cfg.max_stages:
        # one transfer a stage: log likelihoods, acceptance counts and the
        # model blocks of the whole population
        host = _host(torch.cat([states.loglik[:, None],
                                states.accepts_m[:, None], states.m], 1))
        ll, accepts, m_host = host[:, 0], host[:, 1], host[:, 2:]
        ll = np.where(np.isfinite(ll), ll, -1e300)
        # target relative to the CURRENT ESS: carried-over weights may
        # already sit at/below an absolute target, which would pin the
        # bisection at delta ~ 0 and spin stages without progress
        delta = next_beta(beta, ll, logw, cfg.ess_target * ess(logw))
        logw_n = logw - _logsumexp(logw)
        logz += float(_logsumexp(logw_n + delta * ll))
        logw = logw + delta * ll
        beta = 1.0 if delta >= 1.0 - beta else beta + delta

        ne = ess(logw)
        # <= so an exactly-hit target still resamples (the bisection lands
        # on the boundary by construction when ess_target == resample_ess)
        resampled = ne <= cfg.resample_ess * N
        if resampled:
            w = np.exp(logw - _logsumexp(logw))
            idx = systematic_resample(
                w, np.random.default_rng([seed, stage]))
            # clones would otherwise share their ancestor's generator (one
            # object, so one stream whose draws depend on the order the
            # particles advance); each particle gets its own, derived from
            # its ancestor's state and its index
            states = _resample(states, idx)
            accepts, m_host = accepts[idx], m_host[idx]
            logw = np.zeros(N)

        mu, cov = _population_cov(m_host, logw)
        states = _retune(states, mu, cov, log_scale)
        beta32 = float(np.float32(beta))
        acc0 = float(accepts.sum())
        rounds = 0
        while rounds < max(1, cfg.max_move_rounds):
            states = _move_prog(
                move_setup, states, beta32, cfg.n_moves, cfg.obs_scale,
                cfg.obs_sweeps, obs_mask,
                None if draws is None else
                (lambda i, k, s=stage, r=rounds: draws(s, r, i, k)),
                batched, mesh)
            rounds += 1
            per_particle = (float(_host(states.accepts_m).sum())
                            - acc0) / N
            if per_particle >= cfg.min_accepts:
                break
        acc = per_particle / (cfg.n_moves * rounds)
        # between-stage Robbins-Monro on the global proposal scale toward
        # the 0.234 optimum (within-stage adaptation is frozen, see _retune)
        log_scale = float(np.clip(log_scale + 0.7 * (acc - 0.234),
                                  -5.0, 5.0))
        stage += 1
        hist['betas'].append(beta)
        hist['ess'].append(ne)
        hist['accept'].append(acc)
        hist['resampled'].append(bool(resampled))
        hist['logz'].append(logz)
        hist.setdefault('rounds', []).append(rounds)
        if verbose:
            print('  stage {:3d}: beta {:.5f}  ESS {:6.1f}/{}  acc {:.2f} '
                  'x{} rounds  logZ {:+.2f}{}'.format(
                      stage, beta, ne, N, acc, rounds, logz,
                      '  [resampled]' if resampled else ''), flush=True)
        if checkpoint is not None:
            checkpoint(payload())
    if beta < 1.0:
        raise RuntimeError('SMC hit max_stages={} at beta={:.5f}; raise '
                           'max_stages or ess_target'.format(
                               cfg.max_stages, beta))
    return payload()

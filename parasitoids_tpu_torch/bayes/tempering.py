"""Replica-exchange MCMC (parallel tempering), PyTorch port of
``parasitoids_tpu/bayes/tempering.py``.

Beyond-reference capability: the reference's PyMC AdaptiveMetropolis runs a
single chain on the posterior (Bayes_Run.py:484-487) and can stall in a
basin of the 20-parameter landscape; here a ladder of inverse temperatures
``1 = beta_0 > beta_1 > ... > beta_{T-1}`` runs one adaptive-Metropolis
replica per temperature against ``prior + beta * loglik`` (likelihood-only
tempering — every replica keeps the exact prior support), with periodic
even–odd nearest-neighbor state swaps accepted at

    log alpha = (beta_i - beta_j) * (loglik_j - loglik_i),

so hot replicas explore and the cold chain (index 0) is the posterior.

Execution: the replicas advance in turn, as the port's chains do
(``parallel/chains.py``), each step through the ported AM step
(``sampler.mcmc_step(beta=)``); the swap sweep works on the stacked states
with gathers on the device and reads nothing back.  Its uniforms come from
a generator seeded by the run's swap seed and the global round index, so a
run driven in chunks, or resumed from its store, swaps exactly as one
monolithic run.  ``run_pt_sharded`` puts one replica on each device of a
mesh: each advances there, the swap decision is made on the lead device
from the replicas' log likelihoods, and every replica copies both
neighbours' swap fields and keeps the one the decision names (JAX's
``ppermute``), so it is bitwise ``run_pt``.

Replica adaptation state (Haario moments, proposal scale) and each
replica's generator are *not* swapped: each temperature keeps adapting to
its own tempered target, which preserves diminishing adaptation across
exchanges.  The ladder and evidence functions are host numpy, copies of
the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .model import BayesSetup
from .sampler import MCMCConfig, mcmc_step, stack_states, unstack_states

__all__ = ['PTConfig', 'geometric_ladder', 'power_ladder', 'init_pt_states',
           'run_pt', 'run_pt_sharded', 'log_evidence', 'tune_ladder',
           'swap_uniforms']

# chain-state fields exchanged on an accepted swap (position + everything
# cached at that position); adaptation fields stay with the temperature
_SWAP_FIELDS = ('m', 'o', 'loglik', 'prior_m', 'prior_o', 'proj')


class PTConfig(NamedTuple):
    n_rounds: int             # swap rounds
    swap_every: int = 10      # AM steps between swap attempts
    adapt_start: int = 500    # as MCMCConfig
    obs_scale: float = 0.05
    obs_sweeps: int = 1       # as MCMCConfig (ridge-mixing knob)


def geometric_ladder(n_temps, beta_min=0.1):
    """Geometric inverse-temperature ladder from 1.0 down to ``beta_min``."""
    if n_temps < 1:
        raise ValueError('need at least one temperature')
    if n_temps == 1:
        return np.ones(1, np.float32)
    expo = np.arange(n_temps) / (n_temps - 1)
    return np.asarray(beta_min ** expo, np.float32)


def logsumexp(x):
    x = np.asarray(x, np.float64)
    m = np.max(x)
    if not np.isfinite(m):
        return m
    return m + np.log(np.sum(np.exp(x - m)))


def power_ladder(n_temps, power=5.0):
    """Power-law inverse-temperature ladder from 1.0 down to **0.0**.

    ``beta_k = (1 - k/(T-1))^power`` — the standard ladder for marginal-
    likelihood estimation (Xie et al. 2011 recommend power ~3-5): unlike
    ``geometric_ladder`` it reaches the prior (beta = 0), so
    ``log_evidence`` covers the whole [0, 1] path and yields the actual
    model evidence rather than a ratio.  Rungs crowd toward beta = 0,
    where E_beta[loglik] changes fastest.
    """
    if n_temps < 2:
        raise ValueError('an evidence ladder needs at least two rungs')
    frac = 1.0 - np.arange(n_temps) / (n_temps - 1)
    return np.asarray(frac ** power, np.float32)


def log_evidence(betas, logliks, burn=0):
    """Marginal-likelihood estimates from per-replica log-likelihood draws.

    ``betas``: (T,) descending inverse temperatures (as run_pt uses);
    ``logliks``: (T, n_steps) untempered log-likelihood at each replica's
    position per step; ``burn``: steps to drop from the front.

    Returns a dict with two estimators over the ladder span
    [beta_min, 1]:

    * ``'ti'`` — thermodynamic integration (trapezoid over
      ``E_beta[loglik]``), the path-sampling identity
      ``log Z = \\int_0^1 E_beta[loglik] d beta``;
    * ``'ss'`` — stepping-stone (Xie et al. 2011): for each rung,
      ``log r_k = logsumexp((b_hi - b_lo) ll_lo) - log N`` with draws from
      the *colder-in-likelihood* (lower-beta) rung, summed up the ladder —
      unbiased per rung and typically tighter than TI on coarse ladders.

    Both equal ``log Z(posterior) - log Z(beta_min)``; with a ladder that
    reaches beta = 0 (``power_ladder``) that lower state is the prior,
    ``Z(0) = 1``, so the values ARE ``log Z``.  ``'complete'`` in the
    returned dict says whether that holds.  The reference has no evidence
    machinery at all (its only model-comparison number is the MAP AIC,
    Bayes_MAP.py:494-517).

    ``'equilibrated'``: at equilibrium the TI integrand is non-decreasing
    in beta exactly (d/dbeta E_beta[loglik] = Var_beta[loglik] >= 0), so a
    decreasing pair of rung means — beyond Monte-Carlo noise, gauged by the
    rungs' standard errors — is a hard diagnostic that some replica has
    not equilibrated and the estimates are untrustworthy; the offending
    rung indices are in ``'nonmonotone_at'``.
    """
    betas = np.asarray(betas, np.float64)
    ll = np.asarray(logliks, np.float64)[:, burn:]
    if ll.shape[0] != betas.shape[0]:
        raise ValueError('betas/logliks replica-count mismatch')
    if ll.shape[1] < 1:
        raise ValueError('no post-burn draws')
    order = np.argsort(betas)          # ascending for the integration
    b = betas[order]
    ll = ll[order]
    mean_ll = ll.mean(axis=1)
    ti = float(np.trapezoid(mean_ll, b))
    n = ll.shape[1]
    ss = 0.0
    for k in range(len(b) - 1):
        d = b[k + 1] - b[k]
        ss += float(logsumexp(d * ll[k]) - np.log(n))
    # crude per-rung standard error (ignores autocorrelation, so this
    # under-flags rather than over-flags)
    se = ll.std(axis=1) / np.sqrt(n)
    drop = mean_ll[1:] + 3.0 * (se[1:] + se[:-1]) < mean_ll[:-1]
    return {'ti': ti, 'ss': ss,
            'betas': b, 'mean_loglik': mean_ll,
            'equilibrated': bool(not drop.any()),
            'nonmonotone_at': np.flatnonzero(drop),
            'complete': bool(b[0] == 0.0)}


def tune_ladder(betas, swap_rates, kappa=0.5):
    """One Vousden-et-al-style ladder adaptation step toward uniform swap
    acceptance (Vousden, Farr & Mandel 2016, MNRAS 455:1919, eq. 11-12),
    applied on the host between checkpoint chunks during burn-in.

    ``betas``: (T,) descending; endpoints are pinned (beta_0 = 1 and the
    final rung, whether 0 or a geometric beta_min).  ``swap_rates``: (T-1,)
    measured per-adjacent-pair acceptance over the last adaptation window.

    Interior rungs are parameterized by log-beta gaps between *finite*
    rungs; the gap under pair ``j`` is scaled by
    ``exp(kappa * (A_j - mean(A)))`` — a pair accepting more than the
    ladder average gets pulled apart, one accepting less gets pushed
    together, so the fixed point is uniform acceptance across every pair
    (a zero-bottom pair owns no finite gap; its rate steers the others
    through the mean, and at the fixed point it must equal them).  A
    pinned-finite bottom rung is preserved by rescaling the gaps to their
    original total.  Returns the new (T,) ladder.
    """
    betas = np.asarray(betas, np.float64)
    rates = np.asarray(swap_rates, np.float64)
    T = betas.shape[0]
    if T < 3:
        return np.asarray(betas, np.float32)   # nothing interior to move
    if rates.shape[0] != T - 1:
        raise ValueError('need one swap rate per adjacent pair')
    zero_bottom = betas[-1] == 0.0
    fin = betas[:-1] if zero_bottom else betas     # finite rungs
    logb = np.log(fin)
    gaps = -np.diff(logb)                          # (n_fin - 1,) positive
    n_g = gaps.shape[0]
    d = rates[:n_g] - rates.mean()
    gaps = gaps * np.exp(np.clip(kappa * d, -1.0, 1.0))
    if not zero_bottom:
        gaps *= -np.log(betas[-1]) / gaps.sum()    # keep beta_min pinned
    new_logb = np.concatenate([[0.0], -np.cumsum(gaps)])
    new = np.exp(new_logb)
    if zero_bottom:
        new = np.concatenate([new, [0.0]])
    return np.asarray(new, np.float32)


def init_pt_states(setup: BayesSetup, key, n_temps, jitter=0.05):
    """Stacked per-temperature chain states with jittered starts; ``key``
    is the integer seed of ``parallel.chains.init_chains`` (replica ``t``
    gets ``chain_generator(key, t)``)."""
    from ..parallel.chains import init_chains
    return init_chains(setup, key, n_temps, jitter=jitter)


def _advance(setup, state, beta, cfg: PTConfig, draws=None):
    """``swap_every`` tempered AM steps on one replica at inverse
    temperature ``beta`` (a host float).  Returns ``(state, (trace rows
    (swap_every, dim), untempered logliks (swap_every,)))`` on the device.
    ``draws``: the steps' ``sampler.StepDraws``, else the replica's
    generator draws them."""
    mcfg = MCMCConfig(n_samples=cfg.swap_every, adapt_start=cfg.adapt_start,
                      obs_scale=cfg.obs_scale, obs_sweeps=cfg.obs_sweeps)
    rows, lls = [], []
    for i in range(cfg.swap_every):
        state, sample = mcmc_step(setup, state, mcfg, beta=beta,
                                  draws=None if draws is None else draws[i])
        # untempered loglik alongside the position trace: the raw material
        # for log_evidence (TI needs E_beta[loglik] at every rung)
        rows.append(sample)
        lls.append(state.loglik)
    return state, (torch.stack(rows), torch.stack(lls))


def _pairing(rank, parity, T):
    """Even–odd pairing at a swap round: pairs are (p, p+1), (p+2, p+3)...
    ``rank``: an integer tensor of replica indices.

    Returns (is_left, is_right, pair_id) where ``pair_id`` is the index of
    the pair's *left* member (= the adjacent-pair index for diagnostics).
    """
    off = (rank - parity) % 2
    is_left = (off == 0) & (rank + 1 < T) & (rank >= parity)
    is_right = (off == 1) & (rank - 1 >= parity)
    pair_id = torch.clamp(torch.where(is_left, rank, rank - 1), 0,
                          max(T - 2, 0))
    return is_left, is_right, pair_id


def _swap_log_alpha(betas, ll_left, ll_right, pair_id, T):
    """Exchange log-acceptance — the JAX package's operands in its order
    (the stacked and sharded paths there share this function)."""
    b_l = betas[pair_id]
    b_r = betas[torch.clamp(pair_id + 1, max=T - 1)]
    return (b_l - b_r) * (ll_right - ll_left)


def swap_uniforms(swap_seed, rr, n, device):
    """The ``n`` uniforms of global swap round ``rr`` (one per adjacent
    pair) from a generator on ``device`` seeded by ``swap_seed`` and
    ``rr`` alone: a chunked or resumed run draws what a monolithic one
    draws."""
    word = np.random.SeedSequence([int(swap_seed), int(rr), 0x5a]
                                  ).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(word >> 1))
    return torch.rand(n, generator=gen, dtype=torch.float32, device=device)


def _take(x, perm):
    if torch.is_tensor(x):
        return x.index_select(0, perm)
    return tuple(_take(y, perm) for y in x)


def _swap_decision(ll, betas, parity, u):
    """The even–odd swap decision from the replicas' untempered log
    likelihoods ``ll`` (T,): ``(perm, accepts (T-1,), attempts (T-1,))``,
    ``perm[t]`` the replica whose swap fields replica ``t`` takes.
    ``betas``: (T,) f32 tensor on ``ll``'s device; ``u``: (T-1,)
    uniforms, one per adjacent pair.  Nothing is read back."""
    T = betas.shape[0]
    idx = torch.arange(T, device=betas.device)
    is_left, is_right, pair_id = _pairing(idx, parity, T)
    paired = is_left | is_right
    la = _swap_log_alpha(betas, ll[pair_id],
                         ll[torch.clamp(pair_id + 1, max=T - 1)], pair_id, T)
    accept = paired & (torch.log(u[pair_id]) < la)
    partner = torch.clamp(torch.where(is_left, idx + 1, idx - 1), 0, T - 1)
    perm = torch.where(accept, partner, idx)
    # a left member's pair index is its own rank, and the last rank is
    # never a left member: the per-pair counts are the left flags
    acc = (is_left & accept)[:T - 1].to(betas.dtype)
    att = is_left[:T - 1].to(betas.dtype)
    return perm, acc, att


def _swap_sweep_stacked(states, betas, parity, u):
    """One even–odd swap sweep on stacked (T, ...) states by gathers on the
    device.  ``betas``: (T,) f32 tensor on the states' device; ``u``:
    (T-1,) uniforms, one per adjacent pair.  Only ``_SWAP_FIELDS`` move.
    Returns ``(states, accepts (T-1,), attempts (T-1,))``; nothing is read
    back to the host."""
    perm, acc, att = _swap_decision(states.loglik, betas, parity, u)
    states = states._replace(**{f: _take(getattr(states, f), perm)
                                for f in _SWAP_FIELDS})
    return states, acc, att


@torch.no_grad()
def run_pt(setup: BayesSetup, states, betas, swap_seed, cfg: PTConfig,
           round_offset=0, draws=None, swap_u=None):
    """Parallel tempering on the one card: each round advances the
    replicas in turn by ``cfg.swap_every`` tempered AM steps, then makes
    one swap sweep.

    ``states``: stacked ChainState with leading temperature axis matching
    ``betas`` (index 0 must be beta = 1).  Returns
    ``(states, traces (T, n_rounds*swap_every, dim), swap_stats)`` where
    ``traces[0]`` is the posterior (cold) chain and ``swap_stats`` holds
    per-adjacent-pair attempt/accept counts plus the untempered per-replica
    log-likelihood trace (T, n_rounds*swap_every) for ``log_evidence``,
    all tensors on the setup's device.

    ``round_offset`` is the global index of this call's first swap round:
    a run driven in checkpointed chunks (run.py ``--sampler pt``) passes
    the rounds already done, so swap parity and swap randomness continue
    exactly as one monolithic call would.  ``draws(rr, t)``: optional list
    of the ``swap_every`` ``StepDraws`` of replica ``t`` in global round
    ``rr``; ``swap_u(rr)``: optional (T-1,) uniforms of round ``rr``
    (:func:`swap_uniforms` otherwise) — a test replays another stream
    through them.
    """
    betas_np = np.asarray(betas, np.float32)
    T = betas_np.shape[0]
    dev = states.m.device
    betas_t = torch.as_tensor(betas_np).to(dev)
    zero = torch.zeros(max(T - 1, 0), dtype=torch.float32, device=dev)
    att, acc = zero, zero.clone()
    traces, lls = [], []
    for r in range(cfg.n_rounds):
        rr = int(round_offset) + r
        reps, tr, ll = [], [], []
        for t, s in enumerate(unstack_states(states)):
            s, (rows, l) = _advance(setup, s, float(betas_np[t]), cfg,
                                    None if draws is None else draws(rr, t))
            reps.append(s)
            tr.append(rows)
            ll.append(l)
        states = stack_states(reps)
        if T > 1:
            u = (swap_u(rr) if swap_u is not None
                 else swap_uniforms(swap_seed, rr, T - 1, dev))
            states, pa, pt_att = _swap_sweep_stacked(states, betas_t, rr % 2,
                                                     u.to(dev))
            att, acc = att + pt_att, acc + pa
        traces.append(torch.stack(tr))
        lls.append(torch.stack(ll))
    # rounds of (T, swap_every, ...) -> (T, rounds*swap_every, ...)
    dim = states.m.shape[-1] + states.o.shape[-1] + 1
    traces = (torch.cat(traces, dim=1) if traces
              else torch.zeros((T, 0, dim), device=dev))
    lls = torch.cat(lls, dim=1) if lls else torch.zeros((T, 0), device=dev)
    return states, traces, {'swap_attempts': att, 'swap_accepts': acc,
                            'loglik': lls}


def _pick(take_next, nxt, take_prev, prv, own):
    """``nxt`` where ``take_next``, ``prv`` where ``take_prev``, else
    ``own``, over a tree of tensors (0-d conditions)."""
    if torch.is_tensor(own):
        return torch.where(take_next, nxt, torch.where(take_prev, prv, own))
    return tuple(_pick(take_next, a, take_prev, b, c)
                 for a, b, c in zip(nxt, prv, own))


def _swap_step_collective(reps, betas, parity, u):
    """One swap sweep over replicas that each live on a device of their
    own (``reps``, one ``ChainState`` each, in ladder order): the decision
    of :func:`_swap_decision` on ``betas``' device (the lead) from the
    replicas' log likelihoods, then each replica copies both neighbours'
    swap fields to its device unconditionally and keeps the one the
    decision names, as JAX's ``ppermute`` exchange does.  Selections only,
    so the result is bitwise :func:`_swap_sweep_stacked`'s.  Returns
    ``(reps, accepts (T-1,), attempts (T-1,))`` on the lead device."""
    from ..parallel.chains import to_device
    T = len(reps)
    lead = betas.device
    perm, acc, att = _swap_decision(
        torch.stack([r.loglik.to(lead) for r in reps]), betas, parity, u)
    out = []
    for t, r in enumerate(reps):
        dev = r.m.device
        src = perm[t].to(dev)
        fields = {}
        for f in _SWAP_FIELDS:
            own = getattr(r, f)
            nxt = (to_device(getattr(reps[t + 1], f), dev) if t + 1 < T
                   else own)
            prv = to_device(getattr(reps[t - 1], f), dev) if t else own
            fields[f] = _pick(src == t + 1, nxt, src == t - 1, prv, own)
        out.append(r._replace(**fields))
    return out, acc, att


def _sharded_pt_prog(setup, cfg: PTConfig, mesh, T):
    """The one-round program of :func:`run_pt_sharded` on ``mesh`` (one
    device per rung): ``round_fn(reps, betas_np, betas_t, parity, u,
    draws) -> (reps, traces, lls, accepts, attempts)`` advances replica
    ``t`` on device ``t`` through the setup's copy there by
    ``cfg.swap_every`` steps, then swaps (:func:`_swap_step_collective`,
    skipped for one rung); traces and logliks come back stacked on the
    lead device.
    ``draws(t)``: the replica's replayed ``StepDraws`` or None."""
    if mesh.size != T:
        raise ValueError('run_pt_sharded wants one temperature per device '
                         '(got {} temps over {} devices)'.format(T,
                                                                 mesh.size))
    lead = mesh.devices[0]
    setups = [setup.on_device(d) for d in mesh.devices]

    def round_fn(reps, betas_np, betas_t, parity, u, draws):
        out, tr, ll = [], [], []
        for t, r in enumerate(reps):
            r, (rows, lls) = _advance(setups[t], r, float(betas_np[t]), cfg,
                                      draws(t))
            out.append(r)
            tr.append(rows.to(lead))
            ll.append(lls.to(lead))
        if T > 1:
            out, acc, att = _swap_step_collective(out, betas_t, parity, u)
        else:
            acc = att = torch.zeros(0, dtype=torch.float32, device=lead)
        return out, torch.stack(tr), torch.stack(ll), acc, att

    return round_fn


@torch.no_grad()
def run_pt_sharded(setup: BayesSetup, states, betas, swap_seed,
                   cfg: PTConfig, mesh, round_offset=0, draws=None,
                   swap_u=None):
    """Parallel tempering with one replica per device of ``mesh``
    (``parallel.chains.chain_mesh``; a ladder whose length differs from
    the mesh size raises): :func:`run_pt`'s contract, arguments and
    results, bitwise.  Each replica's state and generator live on its
    device and its steps run there; a swap round's uniforms and decision
    are made on the lead device and the swap fields cross between
    neighbouring devices (:func:`_swap_step_collective`).  Traces, the
    swap counts and the returned stacked states gather on the lead device;
    each replica's generator stays on its device."""
    from ..parallel.chains import to_device
    betas_np = np.asarray(betas, np.float32)
    T = betas_np.shape[0]
    run_round = _sharded_pt_prog(setup, cfg, mesh, T)
    lead = mesh.devices[0]
    betas_t = torch.as_tensor(betas_np).to(lead)
    reps = [to_device(s, d)
            for s, d in zip(unstack_states(states), mesh.devices)]
    zero = torch.zeros(max(T - 1, 0), dtype=torch.float32, device=lead)
    att, acc = zero, zero.clone()
    traces, lls = [], []
    for r in range(cfg.n_rounds):
        rr = int(round_offset) + r
        u = None
        if T > 1:
            u = (swap_u(rr) if swap_u is not None
                 else swap_uniforms(swap_seed, rr, T - 1, lead)).to(lead)
        reps, tr, ll, pa, pt_att = run_round(
            reps, betas_np, betas_t, rr % 2, u,
            lambda t: None if draws is None else draws(rr, t))
        if T > 1:
            att, acc = att + pt_att, acc + pa
        traces.append(tr)
        lls.append(ll)
    states = stack_states([to_device(s, lead, generators=False)
                           for s in reps])
    dim = states.m.shape[-1] + states.o.shape[-1] + 1
    traces = (torch.cat(traces, dim=1) if traces
              else torch.zeros((T, 0, dim), device=lead))
    lls = torch.cat(lls, dim=1) if lls else torch.zeros((T, 0), device=lead)
    return states, traces, {'swap_attempts': att, 'swap_accepts': acc,
                            'loglik': lls}

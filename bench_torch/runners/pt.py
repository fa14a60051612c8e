"""Parallel tempering as ``--sampler pt`` runs it, swap rounds back to
back.

The ladder is the mix's (``ladder`` "power": ``tempering.power_ladder``
of ``temps`` rungs and ``ladder_power``, down to beta = 0), and each of
the mix's settings that the configuration file's ``sampler`` group also
states must be the file's outside a rehearsal; the replicas
start as ``--new`` starts them (``tempering.init_pt_states`` with the
run's seed: the reference's initial values jittered by 0.05 in the
unconstrained space), the swap seed is the seed plus 2, as
``bayes/run.run_pt_cli`` makes it, and each round runs
``tempering.run_pt`` with ``PTConfig``'s ``swap_every``, ``adapt_start``
and ``obs_sweeps`` from the mix.  Set-up runs one round, which captures
the forward's and the sweep's graphs, then captures the forward of each
Genz-tier pair of the flight and local |rho| in ``warm_tiers`` that the
hot rungs may cross.  A unit is one ``run_pt`` call of
``rounds_per_unit`` (1) round, carrying the global round index forward,
and counts its ``temps`` x ``swap_every`` replica proposals.

Every round's stacked states, its log-likelihood trace (its last column
is each rung's untempered log likelihood before the swap) and its swap
counts are kept by reference.  The comparison takes a seeded sample of
``compare`` rounds, every replica state of each on its own: the state's
own log likelihood and projections against the float64 reference
(``loglik_gap``, ``proj_gap``, as ``runners/am.py``), and the round's
swap decisions against ``reference/tempering.py``'s rule on the
reference's log likelihoods of the states before the swap
(``swap_mismatch``).  ``unmoved``: 1 where a rung's model block is
still one of the replicas' starts (swaps carry the starts between rungs),
or where a rung's own count of accepted model-block proposals, which
stays with its temperature, is 0: a ladder whose steps, or whose hot
rungs' steps, hand their states back unchanged.
"""

from __future__ import annotations

import math

import numpy as np

from bench_torch import program

EPS32 = 2.0 ** -23


class Runner(program.Base):
    kinds = ('fwd',)

    def __init__(self, ctx):
        from parasitoids_tpu_torch.bayes import tempering as pt
        from parasitoids_tpu_torch.bayes.model import _as_model
        self.ctx, self.pt = ctx, pt
        t = ctx.traffic
        if t['ladder'] != 'power' or int(t['rounds_per_unit']) != 1:
            raise ValueError('the pt runner takes a power ladder and one '
                             'round a unit')
        # a rehearsal cuts the mix, as it cuts the sizes
        sampler = ctx.config.get('sampler', {})
        differ = {k: (t[k], v) for k, v in sampler.items()
                  if k in t and t[k] != v}
        if differ and ctx.rehearse is None:
            raise ValueError('the mix is not the configuration\'s sampler '
                             '(mix, file): {}'.format(differ))
        self.setup = program.build_setup(ctx)
        self.T = int(t['temps'])
        self.betas = pt.power_ladder(self.T, float(t['ladder_power']))
        self.swap_seed = ctx.seed + 2
        self.cfg = pt.PTConfig(n_rounds=1, swap_every=int(t['swap_every']),
                               adapt_start=int(t['adapt_start']),
                               obs_sweeps=int(t['obs_sweeps']))
        self.states = pt.init_pt_states(self.setup, ctx.seed, self.T)
        self.m_starts = self.states.m.clone()
        self.rounds = 0
        self.kept = []
        self.unit()
        with ctx.torch.no_grad():
            for tiers in t.get('warm_tiers', []):
                self.setup.forward_projections(_as_model(program.with_tiers(
                    self.states.m[0], tiers)))
        self.kept = []

    def unit(self):
        rr = self.rounds
        states, _, stats = self.pt.run_pt(
            self.setup, self.states, self.betas, self.swap_seed, self.cfg,
            round_offset=rr)
        self.kept.append((rr, states, stats['loglik'],
                          stats['swap_accepts'], stats['swap_attempts']))
        self.states = states
        self.rounds += 1
        return self.T * self.cfg.swap_every

    def counts(self):
        w = self.ctx.window
        out = self.base_counts(w['counters']['forwards'], w['units'])
        s = self.states
        out['rounds_total'] = self.rounds
        out['betas'] = [float(b) for b in self.betas]
        out['accepts_m'] = s.accepts_m.cpu().tolist()
        acc = att = 0.0
        for _, _, _, a, b in self.kept:
            acc, att = acc + a, att + b
        out['swap_rate'] = (acc / att.clamp(min=1)).cpu().tolist() \
            if self.kept else None
        return out

    def current_params(self, batched=False):
        from parasitoids_tpu_torch.bayes.model import _as_model
        return _as_model(self.states.m[0])

    def work_per_unit(self):
        w = self.ctx.window
        share = w['counters']['forwards'] / max(w['units'], 1)
        ffts = (self.setup.ndays - 1) * (1 + 2 * self.setup.r_dur)
        return {'fwd': share, 'fft': ffts * share}

    def answers(self):
        from parasitoids_tpu_torch.bayes.sampler import unstack_states
        pt, torch = self.pt, self.ctx.torch
        idx = program.pick(self.ctx.seed, len(self.kept),
                           int(self.ctx.traffic['compare']))
        states, rounds = [], []
        for i in idx:
            rr, st, ll, acc, att = self.kept[i]
            reps = unstack_states(st)
            states += [(r.m, r.o, r.loglik, r.proj) for r in reps]
            u = pt.swap_uniforms(self.swap_seed, rr, self.T - 1,
                                 self.ctx.device)
            rounds.append(dict(
                parity=rr % 2, u=u.cpu().double().numpy(),
                before=ll[:, -1].cpu().double().numpy(),
                after=st.loglik.cpu().double().numpy(),
                accepts=acc.cpu().numpy().round().astype(int).tolist(),
                attempts=att.cpu().numpy().round().astype(int).tolist()))
        m, starts = self.states.m, self.m_starts
        at_start = (m[:, None, :] == starts[None, :, :]).all(-1).any()
        never = (self.states.accepts_m == 0).any()
        return {'states': program.chain_states(self.setup, states),
                'rounds': rounds, 'betas': [float(b) for b in self.betas],
                'unmoved': float(bool(at_start) or bool(never))}

    def compare(self, items, refs):
        """``loglik_gap`` and ``proj_gap`` as
        ``program.compare_states``, every replica state of every kept
        round on its own; ``swap_mismatch``: the pairs of the kept rounds
        whose decision differs from :func:`swap_mismatch`'s plain rule."""
        torch = self.ctx.torch
        gaps, unresolved, ref_ll = {}, 0, []
        for m, o, ll, proj, pts in items['states']:
            r_pts, keep, r_proj = program._log_pmfs(refs['ref'], m, o,
                                                    torch.float64)
            r_sum = float(r_pts[keep].sum())
            # the program's log-pmfs where the reference resolves no rate:
            # taken off the program's log likelihood in the gap, and no
            # part of the reference's swap decisions
            off = float(pts[~keep].sum())
            ref_ll.append((r_sum, abs(r_sum), abs(ll - off - r_sum), off))
            answers = {'': (ll - off, proj)}
            for src in ('f32', 'control'):
                if src in refs:
                    c_pts, _, c_proj = program._log_pmfs(refs[src], m, o,
                                                         torch.float32)
                    answers[src] = (float(c_pts[keep].sum()), c_proj)
            for src, (held, a_proj) in answers.items():
                program.add_gap(gaps, 'loglik_gap', src,
                                abs(held - r_sum) / abs(r_sum))
                program.add_gap(gaps, 'proj_gap', src,
                                program.projection_gap(a_proj, r_proj))
            unresolved = max(unresolved, int((~keep).sum()))
        out = program.hold(gaps, program.ill_levels(self.ctx))
        limit = self.ctx.cell.limits['limits']['loglik_gap']
        out.update(swap_mismatch(items, ref_ll, limit))
        out.update({'unmoved': items['unmoved'],
                    'unresolved.count': unresolved})
        return out


def swap_mismatch(items, ref_ll, limit):
    """The kept rounds' swap decisions against the plain rule
    (``reference/tempering.sweep``) on the reference's log likelihoods
    of the states before each swap.

    ``ref_ll``: one ``(reference log likelihood over the observations
    it resolves, its scale, the program's distance from it there, the
    program's log-pmfs at the rest)`` a state, in the order of
    ``items['states']`` (each kept round's rungs in ladder order, after
    its swap).  The states before a swap are those after it in the order
    of the program's own decision, which must also have moved each log
    likelihood of the trace's last column to the rung that took it.  The
    rule runs on the resolved log likelihoods alone; the unresolved
    terms, which the program's decision includes and the reference does
    not know, count as uncertainty.  A pair whose reference margin
    ``|log u - log alpha|`` is within the pair's beta gap times what
    ``limit`` (``loglik_gap``'s, relative) allows each state's log
    likelihood to be off by plus the gap between the two states'
    unresolved terms, plus float32 rounding of the program's rule, is
    left out (``swap_mismatch.excluded``).  ``swap_mismatch``: pairs
    decided or attempted otherwise, and rungs whose state the decision
    does not account for."""
    from bench_torch.reference import tempering as plain
    betas = np.asarray(items['betas'], np.float32).astype(np.float64)
    T = len(betas)
    bad = left_out = compared = accepted = 0
    for k, rnd in enumerate(items['rounds']):
        after = ref_ll[k * T:(k + 1) * T]
        acc, att = rnd['accepts'], rnd['attempts']
        perm = list(range(T))
        for i in range(T - 1):
            if acc[i]:
                perm[i], perm[i + 1] = i + 1, i
        # the program's decision moved each rung's log likelihood
        bad += sum(rnd['after'][t] != rnd['before'][perm[t]]
                   for t in range(T))
        before = [after[perm[t]] for t in range(T)]
        ll = [b[0] for b in before]
        _, r_acc, r_att, margins = plain.sweep(betas, ll, rnd['parity'],
                                               rnd['u'])
        bad += sum(a != b for a, b in zip(att, r_att))
        for i, margin in margins.items():
            err = sum(max(limit * before[j][1], before[j][2])
                      for j in (i, i + 1))
            unresolved = abs(before[i + 1][3] - before[i][3])
            gap = betas[i] - betas[i + 1]
            la = float(plain.log_alpha(betas, ll, i))
            u = rnd['u'][i]
            slack = 4 * EPS32 * (abs(la) + gap * unresolved +
                                 (abs(math.log(u)) if u > 0 else 0.0))
            if margin <= gap * (err + unresolved) + slack:
                left_out += 1
                continue
            compared += 1
            accepted += r_acc[i]
            bad += int(acc[i] != r_acc[i])
    return {'swap_mismatch': float(bad),
            'swap_mismatch.excluded': left_out,
            'swap_pairs.count': compared, 'swap_accepts.count': accepted}

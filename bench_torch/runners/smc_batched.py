"""Batched SMC move rounds at a fixed inverse temperature, back to back.

``n_particles`` particles from ``bayes/smc.init_smc_particles`` (prior
draws from the seed, each evaluated once in set-up on an eager copy of
the setup, which captures no graph) move by ``smc._move_prog`` with
``batched=True`` on ``setup.with_batched_bvn()``: every move one
particle-batched forward for the whole population.  Set-up runs one
round, which captures the batched graph.  A unit is one round of
``n_moves`` moves and counts ``n_moves`` x ``n_particles`` proposals.
The comparison takes every particle after the window, each on its own:
its own log likelihood (the one its last accepted move made) and the
projections of one more batched forward of the whole population through
the timed entry (the graph the window replays).  A particle at which the
plain float32 reference itself departs from the float64 one by more than
the cell's level (an extreme diffusion, whose corner-CDF differences
float32 cannot resolve) is left out of that number and counted.
"""

from __future__ import annotations

import copy

from bench_torch import program


class Runner(program.Base):
    kinds = ('batched',)

    def __init__(self, ctx):
        from parasitoids_tpu_torch.bayes import smc
        self.ctx, self.smc = ctx, smc
        t = ctx.traffic
        self.setup = program.build_setup(ctx)
        self.batched = self.setup.with_batched_bvn()
        eager = copy.copy(self.setup)
        eager._replays_graphs = lambda: False
        self.n = int(t['n_particles'])
        self.beta, self.n_moves = float(t['beta']), int(t['n_moves'])
        self.cfg = smc.SMCConfig(n_particles=self.n, n_moves=self.n_moves)
        self.states = smc.init_smc_particles(eager, ctx.seed, self.n)
        self.unit()
        self.m_start = self.states.m

    def unit(self):
        c = self.cfg
        self.states = self.smc._move_prog(
            self.batched, self.states, self.beta, self.n_moves, c.obs_scale,
            c.obs_sweeps, None, None, True)
        return self.n_moves * self.n

    def counts(self):
        c = self.ctx.window['counters']
        out = self.base_counts(c['batched'] / self.setup.ndays,
                               self.ctx.window['attempts'] * self.n_moves)
        out['accepts_m_mean'] = float(self.states.accepts_m.mean())
        return out

    def current_params(self, batched=False):
        from parasitoids_tpu_torch.bayes.model import _as_model
        return _as_model(self.states.m if batched else self.states.m[0])

    def work_per_unit(self):
        """A proposal is a particle's share of one batched forward."""
        ffts = (self.setup.ndays - 1) * (1 + 2 * self.setup.r_dur)
        return {'batched': 1.0 / self.n, 'fft': ffts}

    def answers(self):
        from parasitoids_tpu_torch.bayes.model import _as_model
        s = self.states
        with self.ctx.torch.no_grad():
            fresh = self.batched.forward_projections(_as_model(s.m))

        def one(proj, i):
            rel, sent, grid = proj
            return (tuple(r[i] for r in rel), tuple(x[i] for x in sent),
                    grid[i])
        states = program.chain_states(
            self.setup, [(s.m[i], s.o[i], s.loglik[i], one(s.proj, i))
                         for i in range(self.n)],
            fresh=[one(fresh, i) for i in range(self.n)])
        moved = not bool(self.ctx.torch.equal(s.m, self.m_start))
        return {'states': states, 'unmoved': float(not moved)}

    def compare(self, items, refs):
        return program.compare_states(self.ctx, items, refs)

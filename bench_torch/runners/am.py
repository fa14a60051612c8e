"""One adaptive-Metropolis chain, chunks of steps back to back.

The chain starts at the reference's initial values
(``sampler.init_chain_state`` with the chain generator of the seed) and
runs ``bayes/sampler.run_mcmc`` with ``MCMCConfig``'s defaults in chunks
of ``chunk`` steps; set-up runs one chunk, which captures the step's
graph, and captures the graph of each Genz-tier pair of the flight and
local |rho| in ``warm_tiers`` that the chain's proposals may cross.  A
unit is one chunk and counts its model-block proposals.  The
state at the end of every chunk is kept by reference (its model block,
observation vector, cached log likelihood and projections); the
comparison takes a seeded sample of them, each on its own.
"""

from __future__ import annotations

from bench_torch import program


def _as_model(vec):
    from parasitoids_tpu_torch.bayes.model import _as_model as as_model
    return as_model(vec)


class Runner(program.Base):
    kinds = ('fwd',)

    def __init__(self, ctx):
        from parasitoids_tpu_torch.bayes import sampler
        self.ctx, self.sampler = ctx, sampler
        t = ctx.traffic
        self.setup = program.build_setup(ctx)
        self.cfg = sampler.MCMCConfig(n_samples=int(t['chunk']))
        self.state = sampler.init_chain_state(
            self.setup, sampler.chain_generator(ctx.seed, 0, ctx.device))
        self.state, _ = sampler.run_mcmc(self.setup, self.state, self.cfg)
        with ctx.torch.no_grad():
            for tiers in t.get('warm_tiers', []):
                self.setup.forward_projections(_as_model(program.with_tiers(
                    self.state.m, tiers)))
        self.m_start = self.state.m
        self.kept = []

    def unit(self):
        self.state, _ = self.sampler.run_mcmc(self.setup, self.state,
                                              self.cfg)
        s = self.state
        self.kept.append((s.m, s.o, s.loglik, s.proj))
        return self.cfg.n_samples

    def counts(self):
        c = self.ctx.window['counters']
        out = self.base_counts(c['forwards'],
                               self.ctx.window['units'])
        out['steps_total'] = float(self.state.count)
        out['accepts_m'] = float(self.state.accepts_m)
        return out

    def current_params(self, batched=False):
        return _as_model(self.state.m)

    def work_per_unit(self):
        w = self.ctx.window
        share = w['counters']['forwards'] / max(w['units'], 1)
        ffts = (self.setup.ndays - 1) * (1 + 2 * self.setup.r_dur)
        return {'fwd': share, 'fft': ffts * share}

    def answers(self):
        idx = program.pick(self.ctx.seed, len(self.kept),
                           int(self.ctx.traffic['compare']))
        states = program.chain_states(self.setup,
                                      [self.kept[i] for i in idx])
        moved = not bool(self.ctx.torch.equal(self.state.m, self.m_start))
        return {'states': states, 'unmoved': float(not moved)}

    def compare(self, items, refs):
        return program.compare_states(self.ctx, items, refs)


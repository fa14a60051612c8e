"""A prior-predictive forecast ensemble, one member at a time.

Members are prior draws of the 15-parameter model block
(``bayes/priors.sample_prior_model`` from the seed): ``pool_draws`` of
them, sorted by the flight |rho|, give a pool of ``pool`` members, one
from each run of equal length of that order (the member within it drawn
from the seed), so every seed's pool holds the same mix of Genz tiers,
in an order drawn from the seed.  A unit is one member through
``parallel/ensemble.ensemble_fields``: every day's population field on
the card (eager, no graph).  The fields of the window's first member
and of the members at a seeded sample of the next ``keep_within``
positions are kept; the comparison takes them: a member's worst day's
:func:`gap` over the days on which the domain still holds ``MIN_SHARE``
of the release, every member on its own.  A member at which the plain
float32 reference itself departs from the float64 one by more than the
cell's level (an extreme diffusion, whose corner-CDF differences float32
cannot resolve) is left out and counted.
"""

from __future__ import annotations

import numpy as np

from bench_torch import program

# days compared: those on which the reference holds at least this share of
# the wasps released; on a day whose wasps have nearly all left the domain,
# float32 roundoff of the earlier days' fields is the field's whole size
MIN_SHARE = 0.01


class Runner(program.Base):
    kinds = ('fwd',)

    def __init__(self, ctx):
        from parasitoids_tpu_torch.bayes.priors import sample_prior_model
        from parasitoids_tpu_torch.parallel import ensemble
        torch = ctx.torch
        self.ctx, self.ensemble = ctx, ensemble
        t = ctx.traffic
        self.setup = program.build_setup(ctx)
        gen = torch.Generator().manual_seed(ctx.seed)
        draws = sample_prior_model(gen, int(t['pool_draws']))
        order = torch.argsort((2.0 * draws[:, 8] - 1.0).abs())
        n = int(t['pool'])
        run = draws.shape[0] // n
        rng = np.random.default_rng([ctx.seed, 1])
        pick = [int(order[i * run + rng.integers(run)]) for i in range(n)]
        self.pool = draws[rng.permutation(pick)].to(ctx.device,
                                                    self.setup.obs_grid.dtype)
        self.keep = {0} | {1 + i for i in program.pick(
            ctx.seed, int(t['keep_within']) - 1, int(t['compare']) - 1)}
        self.kept = {}
        self.i = 0
        self.fields = ensemble.ensemble_fields(self.setup, self.pool[:1])
        ctx.sync()

    def unit(self):
        theta = self.pool[self.i % self.pool.shape[0]]
        self.fields = self.ensemble.ensemble_fields(self.setup, theta[None])
        if self.i in self.keep:
            self.kept[self.i] = (theta, self.fields[0])
        self.i += 1
        return 1

    def counts(self):
        c = self.ctx.window['counters']
        return self.base_counts(c['k1'] / self.setup.ndays,
                                self.ctx.window['units'])

    def current_params(self, batched=False):
        from parasitoids_tpu_torch.bayes.model import _as_model
        return _as_model(self.pool[(self.i - 1) % self.pool.shape[0]])

    def work_per_unit(self):
        ffts = (self.setup.ndays - 1) * (1 + 2 * self.setup.r_dur)
        return {'fwd': 1, 'fft': ffts}

    def answers(self):
        return {'members': [(th.cpu().double().numpy(),
                             f.cpu().double().numpy())
                            for th, f in self.kept.values()]}

    def compare(self, items, refs):
        """``field_gap``: each member's worst day's :func:`program.gap`,
        each member held on its own (:func:`program.hold`).  The float32
        reference and the control, where they ran, make the member's
        fields themselves."""
        from bench_torch.reference.model import as_model
        torch = self.ctx.torch
        ref = refs['ref']
        gaps, days = {}, 99
        for theta, fields in items['members']:
            m = torch.as_tensor(theta, dtype=torch.float64,
                                device=ref.fwd.device)
            with torch.no_grad():
                r = ref.fwd.fields(as_model(m)).cpu().numpy()
                answers = {'': fields}
                for src in ('f32', 'control'):
                    if src in refs:
                        answers[src] = refs[src].fwd.fields(
                            as_model(m.float())).double().cpu().numpy()
            on = r.reshape(r.shape[0], -1).sum(-1) >= MIN_SHARE * \
                self.ctx.sizes['r_number']
            for src, f in answers.items():
                program.add_gap(gaps, 'field_gap', src, max(
                    program.gap(a, b) for a, b, k in zip(f, r, on) if k))
            days = min(days, int(on.sum()))
        out = program.hold(gaps, program.ill_levels(self.ctx))
        out['days_compared.min'] = days
        return out

"""One NUTS chain on the unconstrained log posterior, transitions back to
back.

The target is ``bayes/nuts.make_transformed_logpdf(setup)`` (no
pre-spread day, n_periods pinned, as ``run_nuts`` builds it); the chain
starts at its ``z0`` (the reference's initial values) plus a seeded
jitter (any unconstrained point lies inside the prior's support), with
the identity metric and the step size that ``_find_reasonable_eps``
gives at ``z0`` with the mix's ``step_seed`` (so every seed runs the same
step size), both fixed in set-up.  Set-up also captures the graph of
each Genz-tier pair of the flight and local |rho| in ``warm_tiers``, the
tiers the chain crosses near its start.  A unit is one transition
(``_nuts_step``, the transition ``nuts_sample_stepwise`` runs at every
draw), and it counts the value+gradient evaluations it ran.  Every
evaluation's point, value and gradient is kept by reference; the
comparison takes a seeded sample of ``compare`` finite ones (their
values), the first ``compare_grad`` of them with their gradients, each
on its own.
"""

from __future__ import annotations

import numpy as np

from bench_torch import program


class Runner(program.Base):
    kinds = ('fwd', 'bwd')

    def __init__(self, ctx):
        from parasitoids_tpu_torch.bayes import nuts
        torch = ctx.torch
        self.ctx, self.nuts = ctx, nuts
        t = ctx.traffic
        self.setup = program.build_setup(ctx)
        logpdf, self.constrain, z0 = nuts.make_transformed_logpdf(
            self.setup)
        base = nuts.value_and_grad(logpdf)
        self.points = []

        def lpg(z, gate=None):
            out = base(z, gate)
            if out is not None:
                self.points.append((z, out[0], out[1]))
            return out
        self.lpg = lpg
        self.max_depth = int(t['max_depth'])
        dtype = self.setup.obs_grid.dtype
        z0 = z0.to(dtype)
        # the step size: _find_reasonable_eps at the reference's initial
        # values with the mix's own draw, the same for every seed
        carry = nuts._warmup_init(
            base, z0, torch.Generator(device=ctx.device).manual_seed(
                int(t['step_seed'])), nuts.NUTSConfig(
                max_depth=self.max_depth))
        self.step = torch.exp(carry.log_eps)
        self.inv_mass = carry.inv_mass
        gen = torch.Generator().manual_seed(ctx.seed)
        jitter = t['jitter'] * torch.randn(z0.shape, generator=gen,
                                           dtype=torch.float64)
        self.z = (z0.double().cpu() + jitter).to(ctx.device, dtype)
        self.lp, self.grad = lpg(self.z)
        self.gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        for tiers in t.get('warm_tiers', []):
            u = program.with_tiers(torch.full((15,), 0.5), tiers)
            z = self.z.clone()
            z[8], z[11] = (torch.logit(u[i]).item() for i in (8, 11))
            lpg(z)
        self.points.clear()
        self.z_start = self.z

    def unit(self):
        nuts = self.nuts
        before = nuts.VALUE_AND_GRADS
        self.z, self.lp, self.grad, _, _, _ = nuts._nuts_step(
            self.lpg, self.inv_mass, self.step, self.max_depth, self.z,
            self.lp, self.grad, nuts.draw_transition(
                self.gen, self.z.shape[0], self.max_depth, self.z.dtype))
        return nuts.VALUE_AND_GRADS - before

    def counts(self):
        c = self.ctx.window['counters']
        out = self.base_counts(c['k3'] / self.setup.ndays,
                               c['value_and_grads'])
        out['step_size'] = float(self.step)
        return out

    def current_params(self, batched=False):
        from parasitoids_tpu_torch.bayes.model import _as_model
        m, _, _ = self.constrain(self.z.detach())
        return _as_model(m)

    def work_per_unit(self):
        c = self.ctx.window['counters']
        share = c['k3'] / self.setup.ndays / max(c['value_and_grads'], 1)
        ffts = (self.setup.ndays - 1) * (1 + 2 * self.setup.r_dur)
        return {'fwd': share, 'bwd': share, 'fft': 3 * ffts * share}

    def answers(self):
        torch = self.ctx.torch
        finite = [p for p in self.points
                  if bool(torch.isfinite(p[1]))]
        idx = program.pick(self.ctx.seed, len(finite),
                           int(self.ctx.traffic['compare']))
        out = [tuple(t.detach().cpu().numpy() for t in finite[i])
               for i in idx]
        still = bool(torch.equal(self.z, self.z_start))
        return {'points': out, 'unmoved': float(still),
                'with_grad': int(self.ctx.traffic['compare_grad'])}

    def compare(self, items, refs):
        """``value_gap``: the value's relative gap at each point;
        ``grad_gap``: the gradient's :func:`program.gap` at each of the
        first ``compare_grad`` points; each point held on its own
        (:func:`program.hold`: the worst point that the float32 reference
        does not mark ill-conditioned).  The float32 reference and the
        control, where they ran, evaluate the target themselves."""
        torch = self.ctx.torch
        gaps = {}
        for i, (z, lp, grad) in enumerate(items['points']):
            grad_too = i < items['with_grad']
            r_lp, r_grad = _evaluate(refs['ref'], z, torch.float64,
                                     grad_too)
            answers = {'': (lp, grad)}
            for src in ('f32', 'control'):
                if src in refs:
                    answers[src] = _evaluate(refs[src], z, torch.float32,
                                             grad_too)
            for src, (v, g) in answers.items():
                program.add_gap(gaps, 'value_gap', src,
                                abs(float(v) - r_lp) / abs(r_lp))
                if grad_too:
                    program.add_gap(gaps, 'grad_gap', src,
                                    program.gap(g, r_grad))
        out = program.hold(gaps, program.ill_levels(self.ctx))
        out['unmoved'] = items['unmoved']
        return out


def _evaluate(post, z, dtype, grad):
    """The reference's value of the NUTS target at ``z``, and its gradient
    where ``grad`` (else None)."""
    import torch

    from bench_torch.reference.model import nuts_target
    zz = torch.as_tensor(np.asarray(z), dtype=dtype, device=post.fwd.device)
    if not grad:
        with torch.no_grad():
            return float(nuts_target(post, zz)), None
    zz.requires_grad_()
    with torch.enable_grad():
        v = nuts_target(post, zz, grad=True)
        g, = torch.autograd.grad(v, zz)
    return float(v.detach()), g.double().cpu().numpy()

"""MAP fits as ``map_fit --MAP --starts N --polish M`` runs them, one
optimizer iteration a unit.

The objective is ``bayes/map_fit._make_objective(setup, use_sprd)`` (the
negative log posterior with the Kalbar pre-spread day and ``n_periods``
pinned), and each of the mix's settings that the configuration file's
``map`` group also states must be the file's outside a rehearsal.  The
starts come in ``map_fit_multistart``'s order and rule
(``map_fit.start_points`` on a CPU generator seeded with the run's seed):
the reference's initial values, then ``starts - 1`` prior draws; after
those, ``starts`` more draws from the same generator at a time.  Each fit
runs ``steps`` Adam steps (``map_fit.adam_start``/``adam_step``) at
``learning_rate``, then at most ``polish`` iterations of
``map_fit.LBFGSPolish`` from Adam's end (fewer where its undo or restart
rule ends it), then the next start.  The CLI polishes only the best
start's mode; here every fit is polished, so every fit runs the same mix.
Set-up captures the value+gradient graph of each Genz-tier pair of the
flight and local |rho| in ``warm_tiers``, then runs the first Adam step.
A unit is one Adam step or one L-BFGS iteration, line search included,
and counts its value+gradient evaluations (``map_fit.EVALS``).

Every evaluation's point, value and gradient (as the backward left it,
before the optimizers zero its non-finite components) is kept by
reference, and every Adam step's point, moments and step count before
it, its gradient and its point after.  The comparison walks a seeded
sample of twice ``compare`` evaluations with a finite value.  The first
``compare`` are held by value (``value_gap``, against
``reference/map.terms``) over the observations the reference resolves,
as ``program.compare_states`` holds a chain state's log likelihood: a
positive count over an expected count that float32 reads as roundoff
scores roundoff in any float32 path, so the program's own log-pmfs there
(``BayesSetup.pointwise_loglik`` of the projections its evaluation's
graph gives again) are taken off its value; ``unresolved.count``, shown,
counts the held points with such an observation.  The gradient, which
has no such split, is held at the first ``compare_grad`` points of the
walk at which the reference resolves every observation (``grad_gap``;
at every point where the program runs in float64, the rehearsal's).
It also takes a seeded sample of ``compare_adam`` Adam steps
(``adam_gap``: the step against ``reference/map.adam_update`` from the
program's own gradient and moments), and up to ``compare_fits`` finished
fits (the fit in progress where none finished): ``unmoved`` is 1 where a
fit's end has a reference objective no lower than its start's.
"""

from __future__ import annotations

import numpy as np

from bench_torch import program


class Runner(program.Base):
    kinds = ('fwd', 'bwd')

    def __init__(self, ctx):
        from parasitoids_tpu_torch.bayes import map_fit
        missing = [n for n in ('adam_start', 'adam_step', 'LBFGSPolish',
                               'start_points', 'EVALS')
                   if not hasattr(map_fit, n)]
        if missing:
            raise RuntimeError('the program cannot step a MAP fit: no '
                               'map_fit.{}'.format(missing))
        torch = ctx.torch
        self.ctx, self.mf = ctx, map_fit
        t = ctx.traffic
        fit = ctx.config.get('map', {})
        differ = {k: (t[k], v) for k, v in fit.items()
                  if k in t and t[k] != v}
        if differ and ctx.rehearse is None:
            raise ValueError('the mix is not the configuration\'s MAP fit '
                             '(mix, file): {}'.format(differ))
        self.setup = program.build_setup(ctx)
        self.use_sprd = bool(t['use_sprd'])
        self.n_starts = int(t['starts'])
        self.steps, self.lr = int(t['steps']), float(t['learning_rate'])
        self.polish_steps = int(t['polish'])
        neg, self.constrain, _ = map_fit._make_objective(self.setup,
                                                         self.use_sprd)
        self.points, self.adam, self.fits = [], [], []

        def recorded(z):
            v = neg(z)
            self.points.append([z.detach().clone(), v.detach(), None])
            return v
        self.neg = recorded
        z0 = map_fit.initial_z(self.setup, self.use_sprd)
        for tiers in t.get('warm_tiers', []):
            u = program.with_tiers(torch.full((15,), 0.5), tiers)
            z = z0.clone()
            z[8], z[11] = (torch.logit(u[i]).item() for i in (8, 11))
            neg(z.requires_grad_()).backward()
        self.gen = torch.Generator().manual_seed(ctx.seed)
        self.queue = map_fit.start_points(self.setup, self.use_sprd,
                                          self.gen, self.n_starts)
        self._next_fit()
        self.unit()

    def _hook(self, grad):
        self.points[-1][2] = grad.detach().clone()

    def _next_fit(self):
        if not self.queue:
            # the next starts, all drawn: the reference's values lead the
            # rule's list and are dropped
            self.queue = self.mf.start_points(
                self.setup, self.use_sprd, self.gen, self.n_starts + 1)[1:]
        self.start = self.queue.pop(0)
        self.z, self.opt = self.mf.adam_start(self.start, self.lr)
        self.z.register_hook(self._hook)
        self.polish, self.done = None, 0

    def _end_fit(self, z):
        self.fits.append((self.start, z.detach().clone()))
        self._next_fit()

    def unit(self):
        mf = self.mf
        before = mf.EVALS
        if self.polish is None:
            z, state = self.z, self.opt.state.get(self.z)
            if state:
                prev = (self.adam[-1][5], state['exp_avg'].clone(),
                        state['exp_avg_sq'].clone(), int(state['step']))
            else:
                zero = self.ctx.torch.zeros_like(z)
                prev = (z.detach().clone(), zero, zero, 0)
            mf.adam_step(self.neg, z, self.opt)
            self.adam.append(prev + (z.grad.detach().clone(),
                                     z.detach().clone()))
            self.done += 1
            if self.done == self.steps:
                if self.polish_steps:
                    self.polish = mf.LBFGSPolish(self.neg, z.detach())
                    self.polish.z.register_hook(self._hook)
                    self.done = 0
                else:
                    self._end_fit(z)
        else:
            self.polish.step()
            self.done += 1
            if self.polish.done or self.done == self.polish_steps:
                self._end_fit(self.polish.z)
        return mf.EVALS - before

    def counters(self):
        mf = self.mf
        return dict(super().counters(), map_evals=mf.EVALS,
                    adam_steps=mf.ADAM_STEPS, lbfgs_iters=mf.LBFGS_ITERS)

    def counts(self):
        c = self.ctx.window['counters']
        out = self.base_counts(c['k3'] / self.setup.ndays, c['map_evals'])
        iters = c['adam_steps'] + c['lbfgs_iters']
        out.update(fits_ended=len(self.fits),
                   evals_per_iter=c['map_evals'] / iters if iters else None,
                   lbfgs_evals=c['map_evals'] - c['adam_steps'])
        return out

    def _current_z(self):
        return (self.z if self.polish is None else self.polish.z).detach()

    def current_params(self, batched=False):
        from parasitoids_tpu_torch.bayes.model import _as_model
        m, _, _ = self.constrain(self._current_z())
        return _as_model(m)

    def work_per_unit(self):
        c = self.ctx.window['counters']
        share = c['k3'] / self.setup.ndays / max(c['map_evals'], 1)
        # the propagation steps over every wind day after the pre-spread
        # day: one more step than a run without it
        ffts = self.setup.ndays * (1 + 2 * self.setup.r_dur)
        return {'fwd': share, 'bwd': share, 'fft': 3 * ffts * share}

    def answers(self):
        torch = self.ctx.torch
        t, seed = self.ctx.traffic, self.ctx.seed

        def host(x):
            return x.detach().cpu().double().numpy()
        finite = [p for p in self.points
                  if p[2] is not None and bool(torch.isfinite(p[1]))]
        idx = program.pick(seed, len(finite), 2 * int(t['compare']))
        idx = [idx[i] for i in np.random.default_rng(
            [int(seed), 0x0de4]).permutation(len(idx))]
        points = [tuple(host(x) for x in finite[i]) +
                  (host(self._log_pmfs(finite[i][0])),) for i in idx]
        idx = program.pick(seed, len(self.adam), int(t['compare_adam']))
        adam = [tuple(r if isinstance(r, int) else host(r)
                      for r in self.adam[i]) for i in idx]
        fits = self.fits or [(self.start, self._current_z())]
        idx = program.pick(seed, len(fits), int(t['compare_fits']))
        return {'points': points, 'compare': int(t['compare']),
                'with_grad': int(t['compare_grad']),
                'adam': adam, 'lr': self.lr,
                'fits': [tuple(host(x) for x in fits[i]) for i in idx]}

    def _log_pmfs(self, z):
        """The program's per-observation log-pmfs at ``z``, from the
        projections of the graph its evaluation replayed (the same
        tier-pair key, with the gradient)."""
        from parasitoids_tpu_torch.bayes.model import _as_model, _as_obs
        s = self.setup
        with self.ctx.torch.enable_grad():
            m, o, sprd = self.constrain(z.detach().clone().requires_grad_())
            proj = s.forward_projections(_as_model(m), sprd)
            return s.pointwise_loglik(proj, _as_obs(o, s.n_sent))

    def compare(self, items, refs):
        """``value_gap``: the value's relative gap at each of the first
        ``compare`` points of the sample, over the observations the
        reference resolves there; ``grad_gap``: the whole objective's
        gradient's :func:`program.gap` at each of the first
        ``compare_grad`` points at which it resolves every one (at every
        point where the program runs in float64); each point held on its
        own (:func:`program.hold`), the float32 reference and the control
        evaluating the target themselves where they ran, over the same
        observations.  ``adam_gap``: each kept Adam step's
        :func:`program.gap` to the plain update from the same point,
        gradient and moments.  ``unmoved``: 1 where a kept fit's end has a
        reference objective no lower than its start's."""
        import torch

        from bench_torch.reference import map as plain
        gaps, held, grads, unresolved = {}, 0, 0, 0
        f32 = self.ctx.sizes['dtype'] == 'float32'
        for z, v, g, pts in items['points']:
            value_too = held < items['compare']
            grad_too = grads < items['with_grad']
            if not (value_too or grad_too):
                break
            r_v, r_g, keep = _evaluate(refs['ref'], z, torch.float64,
                                       grad_too)
            whole = keep is None or bool(keep.all())
            grad_too = grad_too and (whole or not f32)
            answers = {}
            if value_too:
                held += 1
                unresolved += not whole
                off = 0.0 if whole else float(pts[~keep.cpu().numpy()].sum())
                answers[''] = (float(v) + off, g)
            elif grad_too:
                answers[''] = (None, g)
            if not answers:
                continue
            grads += grad_too
            for src in ('f32', 'control'):
                if src in refs:
                    answers[src] = _evaluate(refs[src], z, torch.float32,
                                             grad_too, keep)[:2]
            for src, (a_v, a_g) in answers.items():
                if value_too:
                    program.add_gap(gaps, 'value_gap', src,
                                    abs(a_v - r_v) / abs(r_v))
                if grad_too:
                    program.add_gap(gaps, 'grad_gap', src,
                                    program.gap(a_g, r_g))
        for z, m, v, t, g, after in items['adam']:
            want, _, _ = plain.adam_update(*(torch.as_tensor(a) for a in (
                z, g, m, v)), t + 1, items['lr'])
            program.add_gap(gaps, 'adam_gap', '',
                            program.gap(after - z, want.numpy() - z))
        out = program.hold(gaps, program.ill_levels(self.ctx))
        post = refs['ref']

        def objective(z):
            with torch.no_grad():
                return float(plain.objective(post, torch.as_tensor(
                    z, dtype=torch.float64, device=post.fwd.device)))
        ends = [(objective(a), objective(b)) for a, b in items['fits']]
        out['unmoved'] = float(any(e >= s for s, e in ends))
        out.update({'fits.count': len(ends), 'unresolved.count': unresolved})
        return out


def _evaluate(post, z, dtype, grad, keep=None):
    """``(value, gradient, resolved)``: the reference's MAP objective at
    ``z`` over the observations ``keep`` holds (those it resolves itself
    where it is None), the gradient of the whole objective where ``grad``
    (else None), and its own mask of the observations it resolves (None
    outside the prior's support)."""
    import torch

    from bench_torch.reference.map import terms
    zz = torch.as_tensor(np.asarray(z), dtype=dtype, device=post.fwd.device)
    with torch.set_grad_enabled(grad):
        zz.requires_grad_(grad)
        prior, pts, own = terms(post, zz, grad)
        if pts is None:
            held = whole = -prior
        else:
            held = -(prior + pts[own if keep is None else keep].sum())
            whole = -(prior + pts.sum())
        g = torch.autograd.grad(whole, zz)[0].double().cpu().numpy() \
            if grad else None
    return float(held.detach()), g, own

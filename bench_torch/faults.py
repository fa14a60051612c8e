"""Faults planted in the program under test, for the checks that a broken
timed path comes out not correct (``tests/test_faults.py`` on the CPU,
``control.py --fault`` on the card).  Each replaces one function of the
port for the rest of the process:

* ``altered``: every projection and every propagated field scaled by
  1.01 where it is produced (an answer altered);
* ``unchanged``: an AM step, a NUTS transition and an SMC move round
  that return their state unchanged;
* ``half_batch``: the particle-batched forward run on the first half of
  the particles, its projections repeated for the second half;
* ``loglik_altered``: the observation log likelihood that a chain's
  steps and its state keep (``BayesSetup.log_likelihood``) scaled by
  1.01, the projections and the per-observation log-pmfs untouched;
* ``grad_scaled``: the day accumulate's backward (K3/K4 on the card, the
  plain accumulate's gradient on the CPU) scaled by 1.01, the forward
  untouched: a fault that only the gradient shows.
"""

from __future__ import annotations

NAMES = ('altered', 'unchanged', 'half_batch', 'loglik_altered',
         'grad_scaled')
SCALE = 1.01


def plant(name):
    import torch

    from parasitoids_tpu_torch.bayes import model, nuts, sampler, smc
    from parasitoids_tpu_torch.ops import daily_kernel, day_kernel
    from parasitoids_tpu_torch.parallel import ensemble

    if name == 'altered':
        fp = model.BayesSetup.forward_projections

        def altered(self, *a, **k):
            rel, sent, grid = fp(self, *a, **k)
            return (tuple(r * SCALE for r in rel),
                    tuple(s * SCALE for s in sent), grid * SCALE)
        model.BayesSetup.forward_projections = altered
        pp = ensemble.propagate_pop
        ensemble.propagate_pop = lambda *a, **k: pp(*a, **k) * SCALE
    elif name == 'unchanged':
        def still_am(setup, state, cfg, *a, **k):
            row = torch.cat([state.m, state.o, state.loglik.reshape(1)])
            return state, row
        sampler._mcmc_step = still_am
        step = nuts._nuts_step

        def still_nuts(lpg, inv_mass, step_size, max_depth, z, lp, grad,
                       draws, **k):
            out = step(lpg, inv_mass, step_size, max_depth, z, lp, grad,
                       draws)
            return (z, lp, grad) + tuple(out[3:])
        nuts._nuts_step = still_nuts
        smc._move_prog = lambda setup, states, *a, **k: states
    elif name == 'half_batch':
        fb = model.BayesSetup._forward_projections_batched

        def half(self, m, sprd_factor):
            n = m.sig_x.shape[0] // 2
            first = model._as_model(torch.stack(list(m), -1)[:n])
            rel, sent, grid = fb(self, first, sprd_factor)

            def twice(t):
                return torch.cat([t, t], dim=0)
            return (tuple(twice(r) for r in rel),
                    tuple(twice(s) for s in sent), twice(grid))
        model.BayesSetup._forward_projections_batched = half
    elif name == 'loglik_altered':
        ll = model.BayesSetup.log_likelihood
        model.BayesSetup.log_likelihood = (
            lambda self, *a, **k: ll(self, *a, **k) * SCALE)
    elif name == 'grad_scaled':
        bwd = day_kernel._backward

        def scaled(*a, **k):
            return tuple(None if g is None else g * SCALE
                         for g in bwd(*a, **k))
        day_kernel._backward = scaled

        class ScaleGrad(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.clone()

            @staticmethod
            def backward(ctx, g):
                return g * SCALE
        plain = daily_kernel.accumulate_day_plain

        def plain_scaled(*a, **k):
            buf, loss = plain(*a, **k)
            return ScaleGrad.apply(buf), ScaleGrad.apply(loss)
        daily_kernel.accumulate_day_plain = plain_scaled
    else:
        raise ValueError('no fault named {!r}: {}'.format(name, NAMES))

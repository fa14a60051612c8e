"""The plain reference agrees with the port's plain float64 path at 81²
(the rehearsal's cut): daily kernels, fields of every release cohort,
projections, log likelihood, priors, and the NUTS target's value and
gradient (the port's closed-form BVN rule against autograd through the
reference's quadrature)."""

import types

import numpy as np
import pytest
import torch

from bench_torch import program
from bench_torch.reference import model as reference
from bench_torch.reference.model import (as_model, log_prior_model,
                                         nuts_target)

OVERRIDES = {'kalbar': [], 'carnreal': ['dataset=carnreal']}


def build(name):
    from parasitoids_tpu_torch.bayes.run import build_setup
    ov = OVERRIDES[name] + ['domain_info=(4000.0,40)'] + [
        '{}={}'.format(k, v) for k, v in program.REHEARSAL.items()]
    setup = build_setup(ov, device='cpu')
    ctx = types.SimpleNamespace(sizes=program.sizes_of(setup))
    data = program.site_data(ctx, setup)
    return setup, reference.build(data, torch.float64,
                                 torch.device('cpu'))


@pytest.fixture(scope='module', params=sorted(OVERRIDES))
def pair(request):
    return build(request.param)


def draws(n=3, seed=5):
    from parasitoids_tpu_torch.bayes.priors import sample_prior_model
    m = sample_prior_model(torch.Generator().manual_seed(seed), n).double()
    m[:, 8] = torch.tensor([0.55, 0.8, 0.05])[:n]    # |rho| 0.1, 0.6, 0.9
    return m


def test_kernels_and_fields(pair):
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.models.forward import build_all_kernels
    from parasitoids_tpu_torch.models.solver import propagate_pop
    setup, ref = pair
    s = setup.setup
    for vec in draws():
        m = _as_model(vec)
        k, _ = build_all_kernels(
            s.wind_flat, s.wind_cumsum, m.hparams(), m.Dparams(),
            m.Dlparams(), m.mu_r, torch.round(m.n_periods).long(),
            s.rad_dist, s.start_idx, s.kcfg, setup.ndays)
        f = propagate_pop(k, setup.r_dur, setup.r_number,
                          setup.dist_weights, s.scfg)
        k_ref = ref.fwd.kernels(as_model(vec))
        f_ref = ref.fwd.propagate(k_ref)
        assert torch.allclose(k, k_ref, rtol=0, atol=1e-14)
        assert float((f - f_ref).abs().max()) <= 1e-12 * float(
            f_ref.abs().max())


def test_projections_likelihood_and_priors(pair):
    from parasitoids_tpu_torch.bayes.model import _as_model, _as_obs
    from parasitoids_tpu_torch.bayes.priors import (initial_obs_params,
                                                    log_prior_model as lpm,
                                                    log_prior_obs)
    setup, ref = pair
    if not hasattr(ref, 'projections'):
        pytest.skip('no observations')
    o = torch.as_tensor(initial_obs_params(
        [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
        setup.cell_res ** 2), dtype=torch.float64)
    for vec in draws():
        proj = setup.forward_projections(_as_model(vec))
        r_proj = ref.projections(ref.fwd.fields(as_model(vec)))
        # the port rounds its projection weights through float32
        assert program.projection_gap(program.projections_np(proj),
                                      program.projections_np(r_proj)) < 1e-7
        ll = setup.log_likelihood(proj, _as_obs(o, setup.n_sent))
        r_ll = ref.log_likelihood(r_proj, o)
        assert abs(float(ll) - float(r_ll)) <= 1e-7 * abs(float(r_ll))
        prior = lpm(_as_model(vec)) + log_prior_obs(
            _as_obs(o, setup.n_sent), setup.field_areas,
            setup.min_field_area)
        r_prior = log_prior_model(as_model(vec)) + ref.log_prior_obs(o)
        assert float(prior) == pytest.approx(float(r_prior), rel=1e-12)


def test_nuts_target_value_and_gradient():
    from parasitoids_tpu_torch.bayes import nuts
    setup, ref = build('kalbar')
    logpdf, _, z0 = nuts.make_transformed_logpdf(setup)
    lpg = nuts.value_and_grad(logpdf)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        z = z0.double() + 0.05 * torch.randn(z0.shape, generator=gen,
                                             dtype=torch.float64)
        lp, g = lpg(z)
        zz = z.clone().requires_grad_()
        r_lp = nuts_target(ref, zz, grad=True)
        r_g, = torch.autograd.grad(r_lp, zz)
        assert float(lp) == pytest.approx(float(r_lp), rel=1e-7)
        assert np.max(np.abs((g - r_g).numpy())) <= 1e-6 * float(
            r_g.abs().max())

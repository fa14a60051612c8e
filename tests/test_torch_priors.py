"""Port parity of the Bayes layer's building blocks: the priors
(bayes/priors.py), the bijections (bayes/transforms.py) and the three
observation models' log-pmfs (bayes/model.py), against the JAX package on
the same f32 inputs made from a seed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests._torch_parity import torch

from parasitoids_tpu.bayes import model as jmodel
from parasitoids_tpu.bayes import priors as jp
from parasitoids_tpu.bayes import transforms as jt
from parasitoids_tpu_torch.bayes import model as tmodel
from parasitoids_tpu_torch.bayes import priors as tp
from parasitoids_tpu_torch.bayes import transforms as tt

SIZES = [127, 79, 58, 130, 314, 81]         # sentinel fields, cells
CELL_AREA = 25.0 ** 2
AREAS = np.asarray([s * CELL_AREA for s in SIZES], np.float32)
MIN_AREA = min(SIZES) * CELL_AREA
N_POINTS = 20
# (index, value) put out of the prior's support at every fourth point
_BAD_MODEL = [(tp.MODEL_PARAM_NAMES.index('lam'), 1.5),
              (tp.MODEL_PARAM_NAMES.index('sig_x'), -1.0),
              (tp.MODEL_PARAM_NAMES.index('f_a1'), 12.0),
              (tp.MODEL_PARAM_NAMES.index('corr_p'), -0.2),
              (tp.MODEL_PARAM_NAMES.index('n_periods'), -1.0)]
_BAD_OBS = [(0, -0.5), (1, 1.2), (3, 2.0 * MIN_AREA), (5, 1.5), (2, 0.0)]


def _model_points():
    rng = np.random.default_rng(11)
    m0 = tp.initial_model_params()
    pts = [m0]
    for i in range(N_POINTS):
        v = m0 * np.exp(rng.normal(0.0, 0.15, m0.size))
        v[tp.MODEL_PARAM_NAMES.index('n_periods')] = rng.integers(20, 40)
        if i % 4 == 3:
            j, bad = _BAD_MODEL[(i // 4) % len(_BAD_MODEL)]
            v[j] = bad
        pts.append(v)
    return np.asarray(pts, np.float32)


def _obs_points(obs_model):
    rng = np.random.default_rng(12)
    o0 = tp.initial_obs_params(SIZES, CELL_AREA, obs_model)
    pts = [o0]
    for i in range(N_POINTS):
        v = o0 * np.exp(rng.normal(0.0, 0.2, o0.size))
        if i % 4 == 3:
            j, bad = _BAD_OBS[(i // 4) % len(_BAD_OBS)]
            v[j] = bad
        pts.append(v)
    return np.asarray(pts, np.float32)


def _close(got, want, atol=1e-5):
    if np.isinf(want):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


def test_initial_values_and_names_are_the_jax_modules():
    assert tp.MODEL_PARAM_NAMES == jp.MODEL_PARAM_NAMES
    assert tp.OBS_PARAM_NAMES == jp.OBS_PARAM_NAMES
    np.testing.assert_array_equal(tp.STEP_SCALES, jp.STEP_SCALES)
    np.testing.assert_array_equal(tp.initial_model_params(),
                                  jp.initial_model_params())
    for om in ('poisson', 'negbin', 'zip'):
        np.testing.assert_array_equal(
            tp.initial_obs_params(SIZES, CELL_AREA, om),
            jp.initial_obs_params(SIZES, CELL_AREA, om))
        assert tp.obs_extra_names(om) == jp.obs_extra_names(om)


@pytest.mark.parametrize('i', range(N_POINTS + 1))
def test_log_prior_model_matches_jax(i):
    v = _model_points()[i]
    want = float(jp.log_prior_model(jp.ModelParams(*jnp.asarray(v))))
    got = float(tp.log_prior_model(tp.ModelParams(*torch.from_numpy(v))))
    if i % 4 == 0 and i > 0:          # the points put out of support
        assert want == -np.inf
    _close(got, want)


@pytest.mark.parametrize('obs_model', ['poisson', 'negbin', 'zip'])
def test_log_prior_obs_matches_jax(obs_model):
    n = len(SIZES)
    for i, v in enumerate(_obs_points(obs_model)):
        od = v[4 + n] if v.size > 4 + n else 0.0
        want = float(jp.log_prior_obs(
            jp.ObsParams(*jnp.asarray(v[:4]), jnp.asarray(v[4:4 + n]),
                         jnp.asarray(od)),
            jnp.asarray(AREAS), MIN_AREA, obs_model))
        t = torch.from_numpy(v)
        got = float(tp.log_prior_obs(
            tp.ObsParams(*t[:4], t[4:4 + n], torch.as_tensor(od)),
            torch.from_numpy(AREAS), MIN_AREA, obs_model))
        if i % 4 == 0 and i > 0:
            assert want == -np.inf, i
        # sums of f32 gammaln and log-ndtr terms of magnitude up to a few
        # hundred: each package lies within 6e-5 of an f64 evaluation
        _close(got, want, atol=1e-4)


def test_log_prior_gradient_matches_jax():
    # the priors' gradient at the initial values, every model component
    v = tp.initial_model_params().astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jp.log_prior_model(
        jp.ModelParams(*x)))(jnp.asarray(v)))
    t = torch.from_numpy(v).requires_grad_()
    tp.log_prior_model(tp.ModelParams(*t)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_transforms_round_trip_and_match_jax():
    n = len(SIZES)
    pairs = [(tt.MODEL_TRANSFORMS, jt.MODEL_TRANSFORMS,
              tp.initial_model_params())]
    for om in ('poisson', 'negbin', 'zip'):
        pairs.append((tt.obs_transforms(n, MIN_AREA, om),
                      jt.obs_transforms(n, MIN_AREA, om),
                      tp.initial_obs_params(SIZES, CELL_AREA, om)))
    for t_tr, j_tr, vals in pairs:
        assert [type(a).__name__ for a in t_tr] == \
            [type(b).__name__ for b in j_tr]
        v = np.asarray(vals, np.float32)
        z = tt.pack(torch.from_numpy(v), t_tr)
        np.testing.assert_allclose(
            z.numpy(), np.asarray(jt.pack(jnp.asarray(v), j_tr)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tt.unpack(z, t_tr).numpy(), v,
                                   rtol=1e-3)       # f32 logit
        np.testing.assert_allclose(
            tt.unpack(z, t_tr).numpy(),
            np.asarray(jt.unpack(jnp.asarray(z.numpy()), j_tr)),
            rtol=1e-6)


def _counts_and_rates():
    rng = np.random.default_rng(13)
    obs = rng.poisson(2.0, 64).astype(np.float32)
    obs[:8] = 0.0
    rate = rng.gamma(2.0, 1.5, 64).astype(np.float32)
    rate[::9] = 0.0                    # below the 1e-12 floor
    rate[1::13] = 1e-14
    return obs, rate


@pytest.mark.parametrize('name,extra', [('poisson', None), ('negbin', 3.5),
                                        ('zip', 0.2)])
def test_obs_logpmf_and_gradient_match_jax(name, extra):
    obs, rate = _counts_and_rates()
    jfn = getattr(jmodel, name + '_logpmf')
    tfn = getattr(tmodel, name + '_logpmf')

    def jax_total(r):
        args = (jnp.asarray(obs), r) + (() if extra is None
                                        else (jnp.float32(extra),))
        return jfn(*args)

    want = np.asarray(jax_total(jnp.asarray(rate)))
    want_g = np.asarray(jax.grad(lambda r: jax_total(r).sum())(
        jnp.asarray(rate)))
    r = torch.from_numpy(rate).requires_grad_()
    args = (torch.from_numpy(obs), r) + (() if extra is None else
                                         (torch.tensor(extra),))
    got = tfn(*args)
    got.sum().backward()
    assert np.all(np.isfinite(got.detach().numpy()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(r.grad.numpy(), want_g, rtol=2e-6, atol=1e-6)
    if name == 'poisson':
        np.testing.assert_allclose(
            float(tmodel.poisson_loglik(torch.from_numpy(obs),
                                        torch.from_numpy(rate))),
            float(jmodel.poisson_loglik(jnp.asarray(obs),
                                        jnp.asarray(rate))), rtol=2e-6)

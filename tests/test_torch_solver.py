"""Port parity: FFT propagation (models/solver.py), torch against JAX on
the same daily kernels."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests._torch_parity import cohort_loop, t32

from parasitoids_tpu.models import solver as js
from parasitoids_tpu_torch.models import solver as ts


def _kernels(ndays, D, support, seed):
    rng = np.random.default_rng(seed)
    k = np.zeros((ndays, D, D), np.float32)
    c, h = D // 2, support // 2
    k[:, c - h:c + h + 1, c - h:c + h + 1] = rng.uniform(
        0.2, 1.0, (ndays, 2 * h + 1, 2 * h + 1))
    return k / k.sum(axis=(1, 2), keepdims=True)


def test_fft_len_and_config_match_jax():
    for n in range(1, 3000, 37):
        assert ts.next_fast_len(n) == js.next_fast_len(n)
    assert ts.SolverConfig.for_domain(400) == (801, 1280)
    assert tuple(js.SolverConfig.for_domain(60)) == \
        tuple(ts.SolverConfig.for_domain(60))


def test_fft_conv_once_matches_jax():
    a, b = _kernels(2, 33, 15, 1)
    P = ts.SolverConfig.for_domain(16).fft_len
    got = ts.fft_conv_once(t32(a), t32(b), P).numpy()
    want = np.asarray(js.fft_conv_once(jnp.asarray(a), jnp.asarray(b), P))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_propagate_prob_matches_jax():
    # test_solver.py tolerance: atol 2e-5; each day a pmf (1 +- 1e-4)
    kernels = _kernels(6, 41, 13, 2)
    cfg = ts.SolverConfig.for_domain(20)
    got = ts.propagate_prob(t32(kernels), cfg).numpy()
    want = np.asarray(js.propagate_prob(jnp.asarray(kernels),
                                        js.SolverConfig(*cfg)))
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-4)


@pytest.mark.parametrize('r_dur', [1, 5])
def test_propagate_pop_matches_jax(r_dur):
    # test_solver.py:250 tolerance: atol r_number * 2e-6
    kernels = _kernels(8, 41, 7, 3 + r_dur)
    cfg = ts.SolverConfig.for_domain(20)
    r_number = 40000.0
    w = np.random.default_rng(r_dur).uniform(0.5, 1.5, r_dur).astype(
        np.float32)
    w /= w.sum()
    got = ts.propagate_pop(t32(kernels), r_dur, r_number, t32(w),
                           cfg).numpy()
    want = np.asarray(js.propagate_pop(jnp.asarray(kernels), r_dur, r_number,
                                       jnp.asarray(w), js.SolverConfig(*cfg)))
    np.testing.assert_allclose(got, want, atol=r_number * 2e-6)
    # mass held at the origin keeps the day total at r_number while the
    # release ramps up
    np.testing.assert_allclose(got[:r_dur].sum(axis=(1, 2)), r_number,
                               rtol=1e-4)


# ----------------------------------------------------------------------
# propagate_pop's one weighted field against the cohort loop it replaced:
# every release cohort its own field, all advanced every day
# ----------------------------------------------------------------------

def _pop_case(r_dur, lead=(), dtype=torch.float32, seed=0):
    """Kernels (lead + (9, 41, 41)) drifting off the centre, weights
    normalised over ``r_dur`` release days, the solver's pad."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead, dtype=np.int64))
    k = np.stack([_kernels(9, 41, 11, seed + 10 * i) for i in range(n)])
    k = np.roll(k, (3, -2), axis=(-2, -1)).reshape(lead + k.shape[1:])
    w = rng.uniform(0.5, 1.5, r_dur)
    w /= w.sum()
    return (torch.tensor(k, dtype=dtype), torch.tensor(w, dtype=dtype),
            ts.SolverConfig.for_domain(20))


@pytest.mark.parametrize('lead', [(), (3,)])
def test_propagate_pop_one_release_day_is_thecohort_loop(lead):
    # one release day: the cohort is carried unweighted and weighed at the
    # output, so every bit is the cohort loop's, per particle too
    k, w, cfg = _pop_case(1, lead, seed=11)
    got = ts.propagate_pop(k, 1, 130000.0, w, cfg)
    assert torch.equal(got, cohort_loop(k, 1, 130000.0, w, cfg))


@pytest.mark.parametrize('r_dur', [2, 5])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_propagate_pop_weighted_field_matches_thecohort_loop(r_dur, dtype):
    # several release days: the weighted field is the cohorts' sum in exact
    # arithmetic; f32 held at the JAX parity tolerance (atol r_number·2e-6),
    # f64 to 1e-10 of the peak
    r_number = 40000.0
    k, w, cfg = _pop_case(r_dur, dtype=dtype, seed=20 + r_dur)
    got = ts.propagate_pop(k, r_dur, r_number, w, cfg)
    want = cohort_loop(k, r_dur, r_number, w, cfg)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=r_number * 2e-6)
    else:
        gap = (got - want).abs().max().item()
        assert gap <= 1e-10 * want.abs().max().item(), gap
    assert float(want[..., 1:, :, :].sum()) > 0


def test_propagate_pop_gradient_matches_thecohort_loop():
    # f64, five release days: the gradient with respect to the kernels and
    # the emergence weights is the cohort loop's to 1e-9 of its largest
    # entry
    k, w, cfg = _pop_case(5, dtype=torch.float64, seed=31)
    probe = torch.tensor(np.random.default_rng(32).uniform(
        -1, 1, k.shape))

    def grads(propagate):
        kk, ww = k.clone().requires_grad_(), w.clone().requires_grad_()
        loss = (propagate(kk, 5, 40000.0, ww, cfg) * probe).sum()
        return torch.autograd.grad(loss, (kk, ww))

    for got, want in zip(grads(ts.propagate_pop), grads(cohort_loop)):
        gap = (got - want).abs().max().item()
        assert gap <= 1e-9 * want.abs().max().item(), gap


@pytest.mark.parametrize('r_dur', [1, 5])
@pytest.mark.parametrize('lead', [(), (2,)])
def test_transforms_counts_three_a_day_a_population(r_dur, lead):
    # one filter, one forward and one inverse transform a day and
    # population, whatever r_dur (the cohort loop ran 1 + 2·r_dur)
    k, w, cfg = _pop_case(r_dur, lead, seed=41)
    before = ts.TRANSFORMS
    ts.propagate_pop(k, r_dur, 40000.0, w, cfg)
    assert ts.TRANSFORMS - before == 3 * (k.shape[-3] - 1) * (
        lead[0] if lead else 1)
    before = ts.TRANSFORMS
    ts.propagate_pop(k[..., :1, :, :], r_dur, 40000.0, w, cfg)
    assert ts.TRANSFORMS == before

"""Port parity: the observation projections (models/observe.py) against
the JAX ``ObservationOps`` on tests/test_observe.py's Kalbar fields (801²,
18 days), rtol 1e-6; the host precompute (weights, gather indices) bit
for bit; the short-run warning and the release-day rejection."""

import warnings

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp

from tests._torch_parity import torch
from tests.test_observe import DOMAIN, KALBAR_LATLONG, NDAYS

from parasitoids_tpu.io.locinfo import LocInfo
from parasitoids_tpu.models import observe as jo
from parasitoids_tpu_torch.models import observe as to

RTOL = 1e-6


@pytest.fixture(scope='module')
def kalbar():
    """(JAX ops, port ops, fields) at test_observe.py's configuration; the
    fields are that module's seeded blocks, built the same way."""
    li = LocInfo('kalbar', KALBAR_LATLONG, DOMAIN)
    rng = np.random.default_rng(3)
    D = 2 * DOMAIN[1] + 1
    f = np.zeros((NDAYS, D, D), np.float32)
    c = DOMAIN[1]
    for d in range(NDAYS):
        r = 30 + 3 * d
        f[d, c - r:c + r + 1, c - r:c + r + 1] = rng.uniform(
            0, 50, (2 * r + 1, 2 * r + 1))
    return (jo.ObservationOps(li, DOMAIN, NDAYS),
            to.ObservationOps(li, DOMAIN, NDAYS), f)


def test_host_precompute_is_the_jax_modules(kalbar):
    jops, tops, _ = kalbar
    assert len(jops.release_proj) == len(tops.release_proj)
    for j, t in zip(jops.release_proj, tops.release_proj):
        np.testing.assert_array_equal(t.point_rows.numpy(), j.point_rows)
        np.testing.assert_array_equal(t.weights.numpy(),
                                      np.asarray(j.weights, np.float32))
    np.testing.assert_array_equal(tops.sent_cells.numpy(), jops.sent_cells)
    # the port sums each field's contiguous run of cells; the runs are the
    # JAX module's segment ids
    np.testing.assert_array_equal(
        np.repeat(np.arange(tops.n_sent), np.diff(tops.sent_bounds)),
        jops.sent_seg)
    for j, t in zip(jops.sentinel_W, tops.sentinel_W):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j, np.float32))
    np.testing.assert_array_equal(tops.grid_idx.numpy(), jops.grid_idx)
    np.testing.assert_array_equal(tops.grid_days.numpy(), jops.grid_days)
    assert [d for d, _ in tops.card_gathers] == [d for d, _ in
                                                 jops.card_gathers]


@pytest.mark.parametrize('obs_days,ndays', [([3, 7, 12], 10),
                                            ([1, 2, 30], 18)])
def test_weight_builders_match_jax(obs_days, ndays):
    np.testing.assert_array_equal(to._exposure_weights(obs_days, ndays),
                                  jo._exposure_weights(obs_days, ndays))
    np.testing.assert_array_equal(
        to._emergence_weights(obs_days[0], obs_days[1:] + [40], ndays),
        jo._emergence_weights(obs_days[0], obs_days[1:] + [40], ndays))


def test_project_emergence_matches_jax(kalbar):
    jops, tops, f = kalbar
    want_rel, want_sent = jops.project_emergence(jnp.asarray(f))
    got_rel, got_sent = tops.project_emergence(torch.from_numpy(f))
    assert len(got_rel) == len(want_rel) and len(got_sent) == len(want_sent)
    for g, w in zip(got_rel + got_sent, want_rel + want_sent):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_project_grid_matches_jax(kalbar):
    jops, tops, f = kalbar
    got = tops.project_grid(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.project_grid(
        jnp.asarray(f))), rtol=RTOL)


def test_project_card_matches_jax(kalbar):
    jops, tops, f = kalbar
    got = tops.project_card(torch.from_numpy(f))
    want = jops.project_card(jnp.asarray(f))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_projections_are_differentiable(kalbar):
    # the likelihood differentiates through every projection: the gradient
    # of the summed projections is the count of times each cell is read
    # with its weights, the same in both packages
    jops, tops, f = kalbar

    def jax_total(x):
        rel, sent = jops.project_emergence(x)
        return (sum(r.sum() for r in rel) + sum(s.sum() for s in sent)
                + jops.project_grid(x).sum())

    x = torch.from_numpy(f).requires_grad_()
    rel, sent = tops.project_emergence(x)
    (sum(r.sum() for r in rel) + sum(s.sum() for s in sent)
     + tops.project_grid(x).sum()).backward()
    want = np.asarray(jax.grad(jax_total)(jnp.asarray(f)))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=0)


def test_short_run_warns_and_clamps():
    li = LocInfo('demo', (-27.0, 152.0), (2000.0, 25))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        tops = to.ObservationOps(li, (2000.0, 25), 2)   # obs run to day 5
    assert any('truncated' in str(x.message) for x in w)
    assert int(tops.grid_days.max()) <= 1
    assert all(day <= 1 for day, _ in tops.card_gathers)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        jops = jo.ObservationOps(li, (2000.0, 25), 2)
    fields = np.linspace(0, 1, 2 * 51 * 51, dtype=np.float32).reshape(
        2, 51, 51)
    np.testing.assert_allclose(
        tops.project_grid(torch.from_numpy(fields)).numpy(),
        np.asarray(jops.project_grid(jnp.asarray(fields))), rtol=RTOL)


@pytest.mark.filterwarnings('ignore:simulation covers:RuntimeWarning')
def test_release_day_observation_rejected():
    li = LocInfo('demo', (-27.0, 152.0), (2000.0, 25))
    li.grid_obs_datesPR = [pd.Timedelta(days=0)] + li.grid_obs_datesPR[1:]
    with pytest.raises(ValueError, match='release day'):
        to.ObservationOps(li, (2000.0, 25), 4)


def test_exposure_dates_must_increase():
    with pytest.raises(ValueError, match='strictly increasing'):
        to._exposure_weights([3, 3, 5], 10)

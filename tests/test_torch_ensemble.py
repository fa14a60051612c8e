"""Port parity of ``parallel/ensemble.py``: the projections and the fields
of an ensemble of forward simulations, the members in turn, against the
JAX package's ``lax.map`` at the small MAP configuration of
test_bayes_units.py:150-161 (3 days, 10 km / 50 cells, interp 2, K 6,
Kl 3) on four model blocks drawn around a point near the mode.  The
port's forward setup is built from the JAX setup's arrays.  Tolerances
are about ten times the readings noted beside them."""

import numpy as np
import pytest

from tests._torch_parity import MAP_SMALL, NEAR_MODE, torch

from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu.parallel import ensemble as je
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes.model import BayesSetup, _as_model
from parasitoids_tpu_torch.models.forward import setup_from_numpy
from parasitoids_tpu_torch.parallel import ensemble as te

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')


def draws_near_mode(setup, n, seed, sd=0.05):
    """``n`` constrained (model, obs) blocks at ``NEAR_MODE`` plus seeded
    normal noise of ``sd`` in the unconstrained space (no pre-spread day),
    f32 numpy."""
    _, constrain, _ = tm._make_objective(setup, False)
    rng = np.random.default_rng(seed)
    z = (np.asarray(NEAR_MODE, np.float32)
         + sd * rng.standard_normal((n, len(NEAR_MODE))).astype(np.float32))
    with torch.no_grad():
        blocks = [constrain(torch.from_numpy(zz))[:2] for zz in z]
    return (np.stack([m.numpy() for m, _ in blocks]),
            np.stack([o.numpy() for _, o in blocks]))


@pytest.fixture(scope='module')
def setups():
    js = JaxSetup(tm.map_cli_params(MAP_SMALL))
    s = js.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    ts = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                    forward_setup=fs)
    thetas, _ = draws_near_mode(ts, 4, seed=0)
    return js, ts, thetas


def _flat(proj):
    rel, sent, grid = proj
    return np.concatenate([np.asarray(p).reshape(len(grid), -1)
                           for p in (*rel, *sent, grid)], axis=1)


def _close(got, want, rtol, atol_frac):
    """Elementwise within ``rtol`` of each value plus ``atol_frac`` of the
    largest: the f32 FFT propagation leaves roundoff of about 1e-8 of the
    peak in cells that are 0 in f64, different in each package."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - rtol * np.abs(want)
    assert err.max() <= atol_frac * np.abs(want).max(), err.max()


def test_ensemble_projections_match_jax(setups):
    # readings: every difference within 1.6e-7 of the largest value, and
    # within 1e-6 of each value plus 1.3e-8 of the largest
    js, ts, thetas = setups
    got = te.ensemble_projections(ts, thetas)
    want = je.ensemble_projections(js, thetas)
    assert [tuple(g.shape) for g in got[0]] == [w.shape for w in want[0]]
    assert [tuple(g.shape) for g in got[1]] == [w.shape for w in want[1]]
    assert tuple(got[2].shape) == want[2].shape and got[2].shape[0] == 4
    _close(_flat(got), _flat(want), 1e-5, 2e-7)


def test_member_is_one_forward_projections_call(setups):
    # member i is one forward_projections call, bit for bit
    _, ts, thetas = setups
    got = te.ensemble_projections(ts, thetas[:2])
    for i in range(2):
        with torch.no_grad():
            one = ts.forward_projections(_as_model(torch.from_numpy(
                thetas[i])))
        for a, b in zip((*got[0], *got[1], got[2]), (*one[0], *one[1],
                                                     one[2])):
            assert torch.equal(a[i], b)


def test_ensemble_fields_match_jax(setups):
    # readings: every difference within 2.0e-7 of the largest value, and
    # within 1e-6 of each value plus 5.3e-8 of the largest
    js, ts, thetas = setups
    got = te.ensemble_fields(ts, thetas)
    want = np.asarray(je.ensemble_fields(js, thetas))
    assert tuple(got.shape) == want.shape == (4, 3, 101, 101)
    _close(got.numpy(), want, 1e-5, 5e-7)
    # the days kept are those days of the full stack
    some = te.ensemble_fields(ts, thetas, days=[2, 0])
    assert torch.equal(some, got[:, [2, 0]])


def test_ensemble_mesh_is_not_ported(setups):
    # (the name is the test's from before the mesh was ported; it now
    # holds the mesh) members sharded over three devices (four draws: one
    # padded member) and over two, against JAX's sharded ensemble on as
    # many devices, and bitwise the unsharded port
    from parasitoids_tpu.parallel.chains import chain_mesh as jax_mesh
    from parasitoids_tpu_torch.parallel.chains import chain_mesh
    js, ts, thetas = setups
    flat = lambda p: torch.cat([x.reshape(x.shape[0], -1)
                                for x in (*p[0], *p[1], p[2])], 1)
    ref = te.ensemble_projections(ts, thetas)
    for n in (3, 2):
        got = te.ensemble_projections(ts, thetas,
                                      mesh=chain_mesh(devices=['cpu'] * n))
        assert torch.equal(flat(got), flat(ref))
    want = je.ensemble_projections(js, thetas, mesh=jax_mesh(n_devices=3))
    _close(flat(got).numpy(), _flat(want), 1e-5, 2e-7)
    mesh = chain_mesh(devices=['cpu'] * 3)
    fields = te.ensemble_fields(ts, thetas[:2], mesh=mesh, days=[2])
    assert tuple(fields.shape) == (2, 1, 101, 101)
    assert torch.equal(fields, te.ensemble_fields(ts, thetas[:2], days=[2]))


@pytest.mark.parametrize('days', [None, (2, 0)])
def test_member_fields_are_one_population_fields_call(setups, days):
    # member i of ensemble_fields is one BayesSetup.population_fields call,
    # bit for bit, all days or a subset
    _, ts, thetas = setups
    got = te.ensemble_fields(ts, thetas[:2], days=days)
    for i in range(2):
        with torch.no_grad():
            one = ts.population_fields(_as_model(torch.from_numpy(
                thetas[i])), days=days)
        assert torch.equal(got[i], one)


@pytest.mark.parametrize('batched', [False, True])
@pytest.mark.parametrize('sprd', [None, 0.3])
def test_projected_fields_are_forward_projections(setups, sprd, batched):
    # obs_ops over population_fields gives forward_projections' answers
    # bit for bit: with and without a pre-spread day, one parameter set
    # and the particle-batched copy
    _, ts, thetas = setups
    if batched:
        ts = ts.with_batched_bvn()
        m = _as_model(torch.from_numpy(thetas[:3]))
    else:
        m = _as_model(torch.from_numpy(thetas[1]))
    with torch.no_grad():
        fields = ts.population_fields(m, sprd)
        rel, sent = ts.obs_ops.project_emergence(fields)
        grid = ts.obs_ops.project_grid(fields)
        want = ts.forward_projections(m, sprd)
    assert tuple(fields.shape[-3:]) == (3, 101, 101)
    assert fields.ndim == (4 if batched else 3)
    for a, b in zip((*rel, *sent, grid), (*want[0], *want[1], want[2])):
        assert torch.equal(a, b)


def test_graphed_fields_route_gives_the_eager_bits_on_the_cpu(
        setups, monkeypatch):
    # where a setup replays graphs, population_fields hands graphs.evaluate
    # the stacked parameter vector under the key ('fields', branches,
    # days); on CPU tensors evaluate runs the function itself: the eager
    # bits, and nothing captured
    import copy

    from parasitoids_tpu_torch.utils import graphs
    _, ts, thetas = setups
    graphed = copy.copy(ts)
    graphed._replays_graphs = lambda: True
    graphed.graphs = graphs.GraphCache()
    seen = []
    real = graphs.evaluate

    def spy(cache, key, fn, args):
        seen.append((key, [tuple(a.shape) for a in args]))
        return real(cache, key, fn, args)

    monkeypatch.setattr(graphs, 'evaluate', spy)
    m = _as_model(torch.from_numpy(thetas[2]))
    branches, _ = ts._branches(m)
    with torch.no_grad():
        for days in (None, [1]):
            got = te.ensemble_fields(graphed, thetas[2:3], days=days)
            want = ts.population_fields(m, days=days)
            assert torch.equal(got[0], want)
    assert seen == [(('fields', branches, None), [(15,)]),
                    (('fields', branches, (1,)), [(15,)])]
    assert not graphed.graphs.entries

"""The port's one-dispatch evaluation (``utils/graphs.py``) and the
per-evaluation work it needs out of the day loop, on the CPU at the small
MAP configuration (3 days, 10 km / 50 cells, interp 2, K 6, Kl 3):

* the day loop's hoisted pieces (``ops.daily_kernel.day_invariants``: the
  day kernel's packed constants, the local-diffusion block) give the bits
  of the per-day build, for one parameter set and for three particles;
* the pre-spread day's constants are made once per setup and device and
  keep their bits;
* ``BayesSetup._forward_projections_graphed`` (the function that a CUDA
  graph captures: one stacked parameter vector and the pre-spread factor)
  gives the eager path's bits, values and gradients, and its key tells
  apart what a graph cannot share;
* its gradient at map_fit's start stays within test_torch_map.py's JAX
  tolerance.

Replay itself needs the card: ``tests/test_torch_cuda.py -k graph``."""

import ast
import copy
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests._torch_parity import MAP_SMALL, exact_support_mask, torch

from parasitoids_tpu.bayes import map_fit as jm
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import model as tmodel
from parasitoids_tpu_torch.bayes.model import BayesSetup, _as_model
from parasitoids_tpu_torch.bayes.priors import sample_prior_model
from parasitoids_tpu_torch.models import forward as tfwd
from parasitoids_tpu_torch.models.forward import setup_from_numpy
from parasitoids_tpu_torch.ops import daily_kernel as tdk
from parasitoids_tpu_torch.ops import day_kernel
from parasitoids_tpu_torch.utils import graphs

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def setup():
    return BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu')


def _graphed(setup):
    """A copy of ``setup`` whose ``forward_projections`` takes the graphed
    function (on the CPU it runs as it is, with no graph)."""
    new = copy.copy(setup)
    new._replays_graphs = lambda: True
    return new


def _flat(proj):
    return torch.cat([t.reshape(-1) for t in (*proj[0], *proj[1], proj[2])])


def _model_args(setup, m):
    s = setup.setup
    return (s.wind_flat, s.wind_cumsum, m.hparams(), m.Dparams(),
            m.Dlparams(), m.mu_r,
            torch.round(m.n_periods.to(s.wind_flat.dtype)).to(torch.int64),
            s.rad_dist, s.start_idx, s.kcfg, setup.ndays)


def _prior_models(n, seed=4):
    return _as_model(sample_prior_model(torch.Generator().manual_seed(seed),
                                        n))


@pytest.mark.parametrize('batched', [False, True])
def test_hoisted_forward_is_the_per_day_build(setup, batched):
    # build_all_kernels(_batched) makes the constants and the local block
    # once; each day built alone (build_daily_kernel with no invariants,
    # the parent's day loop) gives the same bits
    m = _prior_models(3)
    if not batched:
        m = _as_model(torch.stack(list(m), dim=-1)[0])
    (wf, wc, hp, Dp, Dl, mu_r, n_per, rad_dist, start, kcfg,
     ndays) = _model_args(setup, m)
    if batched:
        pmfs, losses = tfwd.build_all_kernels_batched(*_model_args(setup, m))
        days = [tdk.build_daily_kernel_batched(
            wf, wc, d, hp, Dp, Dl, mu_r, n_per, rad_dist,
            start if d == 0 else 0, kcfg) for d in range(ndays)]
        axis = 1
    else:
        pmfs, losses = tfwd.build_all_kernels(*_model_args(setup, m))
        days = [tdk.build_daily_kernel(
            wf, wc, d, hp, Dp, Dl, mu_r, n_per, rad_dist,
            start if d == 0 else 0, kcfg) for d in range(ndays)]
        axis = 0
    assert pmfs.shape[axis] == ndays == 3
    assert torch.equal(pmfs, torch.stack([p for p, _ in days], dim=axis))
    assert torch.equal(losses, torch.stack([l for _, l in days], dim=axis))


@pytest.mark.parametrize('batched', [False, True])
def test_local_block_is_built_once_per_forward(setup, monkeypatch, batched):
    # the local-diffusion BVN is the same every day: one build a forward
    name = 'bvn_cell_masses_batched' if batched else 'bvn_cell_masses'
    real, calls = getattr(tdk, name), []

    def counted(*args, **kw):
        calls.append(args[4:6])
        return real(*args, **kw)

    monkeypatch.setattr(tdk, name, counted)
    m = _prior_models(3)
    if batched:
        tfwd.build_all_kernels_batched(*_model_args(setup, m))
    else:
        m = _as_model(torch.stack(list(m), dim=-1)[1])
        tfwd.build_all_kernels(*_model_args(setup, m))
    cell = setup.setup.rad_dist / setup.setup.kcfg.rad_res
    assert setup.ndays == 3 and calls == [(cell, setup.setup.kcfg.K_local)]


@pytest.mark.parametrize('select', [False, True])
@pytest.mark.parametrize('rho', [0.253, 0.6, 0.93, -0.99])
def test_packed_constants_once_keep_the_bits(rho, select):
    # the row packed once is each launch's own packing, and the backward's
    # copy with the loss cotangent in its slot is the backward's own
    cpu = torch.device('cpu')
    Dp = torch.tensor([[171.82, 144.58, rho], [120.0, 90.0, -rho / 2]])
    Dp = Dp if select else tuple(Dp[0])
    row = day_kernel.pack_constants(Dp, 25.0, cpu, select=select)
    assert not row.requires_grad
    assert torch.equal(row, day_kernel._pack_constants(Dp, 25.0, cpu,
                                                       select=select))
    if not select:
        ct = torch.tensor(-0.37)
        assert torch.equal(day_kernel._with_ct_loss(row, ct),
                           day_kernel._pack_constants(Dp, 25.0, cpu, ct))


def _old_pre_spread(setup, m, sprd, branches):
    """The pre-spread day as built before its constants were made once per
    setup (a host copy of the drift remainder and of the centre index on
    every call)."""
    import torch.nn.functional as F
    from parasitoids_tpu_torch.ops.bvn import bvn_cell_masses
    res, kcfg = setup.cell_res, setup.setup.kcfg
    D, c = 2 * kcfg.rad_res + 1, kcfg.rad_res
    drift = np.array([-25.0, 15.0])
    dint = np.floor(drift / res).astype(int)
    drem = drift - dint * res
    long_spread = bvn_cell_masses(torch.as_tensor(drem, dtype=torch.float32),
                                  m.sig_x, m.sig_y, m.corr, res, kcfg.K,
                                  branches[0])
    short_spread = bvn_cell_masses(torch.zeros(2), m.sig_xl, m.sig_yl,
                                   m.corr_l, res, kcfg.K_local, branches[1])

    def place(block, row, col):
        n = block.shape[-1]
        row, col = (min(max(int(v), 0), D - n) for v in (row, col))
        return F.pad(block, (col, D - col - n, row, D - row - n))

    field = place(sprd * long_spread, c - int(dint[1]) - kcfg.K,
                  c + int(dint[0]) - kcfg.K)
    field = field + place((1.0 - sprd) * short_spread, c - kcfg.K_local,
                          c - kcfg.K_local)
    centre = torch.tensor([c])
    return field.index_put((centre, centre),
                           torch.clamp(1.0 - field.sum(), min=0.0).reshape(1),
                           accumulate=True)


def test_pre_spread_constants_are_made_once_with_the_same_bits(setup):
    m = _as_model(torch.stack(list(_prior_models(3)), dim=-1)[2])
    branches, _ = setup._branches(m)
    sprd = torch.tensor(0.3)
    got = setup._pre_spread_kernel(m, sprd, branches)
    misses = tmodel._pre_spread_constants.cache_info().misses
    again = setup._pre_spread_kernel(m, sprd, branches)
    assert tmodel._pre_spread_constants.cache_info().misses == misses
    want = _old_pre_spread(setup, m, sprd, branches)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert abs(float(got.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize('use_sprd', [False, True])
def test_graphed_function_is_the_eager_path_bitwise(setup, use_sprd):
    # the function a graph captures (one stacked parameter vector, and
    # the pre-spread factor) gives the eager path's bits, values and every
    # gradient component; on the CPU no graph is made
    graphed = _graphed(setup)
    runs = []
    for s in (setup, graphed):
        neg, constrain, _ = tm._make_objective(s, use_sprd)
        z0 = tm.initial_z(setup, use_sprd)
        out = []
        for z in (z0, z0 + 0.01):
            z = z.clone().requires_grad_()
            v = neg(z)
            v.backward()
            with torch.no_grad():
                m, _, sprd = constrain(z)
                proj = s.forward_projections(_as_model(m), sprd)
            out.append((v.detach(), z.grad, _flat(proj)))
        runs.append(out)
    for (va, ga, pa), (vb, gb, pb) in zip(*runs):
        assert torch.equal(va, vb) and torch.equal(ga, gb)
        assert torch.equal(pa, pb)
    assert not graphed.graphs.entries


def test_graphed_batched_forward_is_the_eager_path_bitwise(setup):
    batched = setup.with_batched_bvn()
    graphed = _graphed(setup).with_batched_bvn()
    m = _prior_models(3, seed=5)
    for sprd in (None, torch.tensor([0.2, 0.3, 0.4])):
        with torch.no_grad():
            a = batched.forward_projections(m, sprd)
            b = graphed.forward_projections(m, sprd)
        assert a[2].shape[0] == 3 and torch.equal(_flat(a), _flat(b))


def test_graph_key_tells_apart_what_a_graph_cannot_share(setup, monkeypatch):
    # the branches, the pre-spread factor given or not, a gradient or not,
    # and the particle count each make a key of its own
    keys = []

    def record(cache, key, fn, args):
        keys.append(graphs.graph_key(key, args))
        return fn(*args)

    monkeypatch.setattr(tmodel.graphs, 'evaluate', record)
    graphed = _graphed(setup)
    mv = torch.stack(list(_prior_models(4, seed=6)), dim=-1)
    m = _as_model(mv[0])
    branches, _ = setup._branches(m)
    other = ((branches[0] + 1) % 4, branches[1])
    sprd = torch.tensor(0.3)
    with torch.no_grad():
        graphed._forward_projections_graphed(m, None, branches)
        graphed._forward_projections_graphed(m, None, branches)
        graphed._forward_projections_graphed(m, None, other)
        graphed._forward_projections_graphed(m, sprd, branches)
    leaf = mv[0].clone().requires_grad_()
    graphed._forward_projections_graphed(_as_model(leaf), None, branches)
    graphed._forward_projections_graphed(_as_model(leaf), sprd, branches)
    with torch.no_grad():
        graphed._forward_projections_graphed(_as_model(leaf), None, branches)
    batched = graphed.with_batched_bvn()
    with torch.no_grad():
        batched._forward_projections_graphed(_as_model(mv[:3]), None)
        batched._forward_projections_graphed(_as_model(mv), None)
        batched._forward_projections_graphed(_as_model(mv), sprd)
    assert keys[0] == keys[1] and keys[0] == keys[6]
    distinct = [keys[i] for i in (0, 2, 3, 4, 5, 7, 8, 9)]
    assert len(set(distinct)) == len(distinct)
    assert [k[1] for k in keys] == [False] * 4 + [True] * 2 + [False] * 4
    assert keys[7][0][:2] == ('batched', 3) and keys[8][0][:2] == (
        'batched', 4)


def test_evaluate_runs_the_function_on_cpu_tensors():
    cache = graphs.GraphCache()
    x = torch.arange(3.0)
    out = graphs.evaluate(cache, ('k',), lambda a: (a * 2, (a + 1,)), [x])
    assert torch.equal(out[0], x * 2) and torch.equal(out[1][0], x + 1)
    assert cache.entries == {} and cache.summary() == []


@pytest.fixture(scope='module')
def jax_pair():
    js = JaxSetup(tm.map_cli_params(MAP_SMALL))
    s = js.setup
    fs = setup_from_numpy(s.wind_flat, s.wind_cumsum, s.days, s.ndays,
                          s.kcfg, s.scfg, s.rad_dist, s.start_idx,
                          s.dist_weights, 'cpu', torch.float32)
    ts = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                    forward_setup=fs)
    ts64 = BayesSetup(tm.map_cli_params(MAP_SMALL), device='cpu',
                      dtype=torch.float64)
    return js, ts, ts64


def test_graphed_gradient_at_the_map_start_matches_jax(jax_pair):
    # the hoisted day loop through the graphed function, value and
    # gradient at map_fit's start (pre-spread day), against JAX at
    # test_torch_map.py's tolerances (its roundoff-rate observations held
    # out of both)
    js, ts, ts64 = jax_pair
    z0 = tm.initial_z(ts, True)
    keep = exact_support_mask(ts64, z0, True)
    jneg, _, _ = jm._make_objective(js.with_held_out(keep), True)
    want_v, want_g = jax.jit(jax.value_and_grad(jneg))(jnp.asarray(z0))
    want_v, want_g = float(want_v), np.asarray(want_g, np.float64)
    neg, _, _ = tm._make_objective(_graphed(ts.with_held_out(keep)), True)
    z = z0.clone().requires_grad_()
    v = neg(z)
    v.backward()
    got_v, got_g = float(v.detach()), z.grad.double().numpy()
    assert np.isfinite(got_v) and np.all(np.isfinite(got_g))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    assert np.linalg.norm(got_g - want_g) <= 1e-4 * np.linalg.norm(want_g)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3,
                               atol=1e-5 * np.abs(want_g).max())


def test_graphs_module_imports_neither_jax_nor_the_jax_package():
    path = os.path.join(ROOT, 'parasitoids_tpu_torch', 'utils', 'graphs.py')
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or '')
    assert names and not [n for n in names if n.split('.')[0] in
                          ('jax', 'jaxlib', 'parasitoids_tpu')]

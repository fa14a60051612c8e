"""Port parity of the forward variants and the host tools: the log-depth
propagation (``propagate_prob_logdepth``, pure and segmented), the
reference's ring truncation (``ring_truncate``) and the forward command
line with ``ref_trunc=true``, the host numpy projections and
``grid_r_squared``, the figures of ``viz.compare``, ``viz.info_plots`` and
``viz.explore``, and the PyMC-2 HDF5 trace migration — each against the
JAX package on the same numpy inputs, at the tolerances of the JAX
package's own tests (tests/test_solver.py, tests/test_daily_kernel.py,
tests/test_viz.py, tests/test_legacy_hdf5.py).
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_parity import t32, torch

from parasitoids_tpu.models import solver as jsolver
from parasitoids_tpu.ops import daily_kernel as jdk
from parasitoids_tpu_torch.models import solver as tsolver
from parasitoids_tpu_torch.ops import daily_kernel as tdk

RNG_SEED = 12


def _random_kernel(rng, D, support):
    k = np.zeros((D, D))
    c, h = D // 2, support // 2
    k[c - h:c + h + 1, c - h:c + h + 1] = rng.uniform(
        0.2, 1.0, (2 * h + 1, 2 * h + 1))
    return (k / k.sum()).astype(np.float32)


def _drift_kernel(rng, D, shift, support):
    k = np.zeros((D, D))
    c, h = D // 2, support // 2
    k[c - h:c + h + 1, c - h + shift:c + h + 1 + shift] = rng.uniform(
        0.2, 1.0, (2 * h + 1, 2 * h + 1))
    return (k / k.sum()).astype(np.float32)


# ----------------------------------------------------------------------
# log-depth propagation (tests/test_solver.py:78-127, atol 3e-5)
# ----------------------------------------------------------------------

@pytest.mark.parametrize('segment', [None, 1, 2, 3])
def test_propagate_prob_logdepth_matches_jax(segment):
    # confined kernels (no boundary interaction): every mode against JAX's
    # and against the sequential solver, a non-dividing segment (3 into 6
    # days' chain of 5) included
    rng = np.random.default_rng(RNG_SEED)
    D, ndays = 31, 6
    kernels = np.stack([_random_kernel(rng, D, 5) for _ in range(ndays)])
    jcfg = jsolver.SolverConfig.for_domain(D // 2)
    tcfg = tsolver.SolverConfig.for_domain(D // 2)
    want = np.asarray(jsolver.propagate_prob_logdepth(
        jnp.asarray(kernels), jcfg, segment=segment))
    got = tsolver.propagate_prob_logdepth(t32(kernels), tcfg,
                                          segment=segment).numpy()
    seq = tsolver.propagate_prob(t32(kernels), tcfg).numpy()
    assert got.shape == (ndays, D, D)
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_allclose(got, seq, atol=3e-5)


def test_propagate_prob_logdepth_at_the_boundary_matches_jax():
    # the drifting chain of test_solver.py: pure mode diverges from the
    # sequential solver where mass re-enters (as JAX's does; its values
    # there are not compared: most mass has left the domain, so the 1e-8
    # cut of a cell flips on roundoff and the renormalization adds ~5e-4
    # to every kept cell), segment=1 absorbs every day and stays the
    # sequential solver's and JAX's
    rng = np.random.default_rng(RNG_SEED + 1)
    D, ndays = 31, 8
    kernels = np.stack([_drift_kernel(rng, D, 2, 9) for _ in range(ndays)])
    tcfg = tsolver.SolverConfig.for_domain(D // 2)
    jcfg = jsolver.SolverConfig.for_domain(D // 2)
    seq = tsolver.propagate_prob(t32(kernels), tcfg).numpy()
    got = tsolver.propagate_prob_logdepth(t32(kernels), tcfg,
                                          segment=1).numpy()
    want = np.asarray(jsolver.propagate_prob_logdepth(
        jnp.asarray(kernels), jcfg, segment=1))
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_allclose(got, seq, atol=3e-5)
    pure = tsolver.propagate_prob_logdepth(t32(kernels), tcfg).numpy()
    jpure = np.asarray(jsolver.propagate_prob_logdepth(jnp.asarray(kernels),
                                                       jcfg))
    assert np.abs(pure[-1] - seq[-1]).max() > 5e-4
    assert np.abs(jpure[-1] - seq[-1]).max() > 5e-4
    np.testing.assert_allclose(pure[:4], jpure[:4], atol=3e-5)
    # day 0 alone: nothing to propagate
    one = t32(kernels[:1])
    assert torch.equal(tsolver.propagate_prob_logdepth(one, tcfg, 2), one)


# ----------------------------------------------------------------------
# the reference's ring truncation
# ----------------------------------------------------------------------

@pytest.mark.parametrize('case', ['centred', 'off_centre', 'boundary'])
def test_ring_truncate_matches_jax(case):
    # a centred block (cut at its 0.999 square), one drifted off centre (a
    # larger square), and a clipped block that never reaches 0.999 (kept
    # whole): exactly JAX's mask, so the values are the same bits
    from parasitoids_tpu_torch.ops.bvn import bvn_cell_masses
    K = 12
    mu = {'centred': (0.0, 0.0), 'off_centre': (30.0, -20.0),
          'boundary': (0.0, 0.0)}[case]
    block = bvn_cell_masses(torch.tensor(mu), 21.1, 10.6, 0.3, 10.0,
                            K).numpy()
    if case == 'boundary':
        block[:, :K] = 0.0
    want = np.asarray(jdk.ring_truncate(jnp.asarray(block), K))
    got = tdk.ring_truncate(t32(block), K).numpy()
    np.testing.assert_array_equal(got, want)
    cut = ((got == 0) & (block > 0)).any()
    assert cut != (case == 'boundary')
    # a stack of blocks: each truncated as alone
    both = tdk.ring_truncate(t32(np.stack([block, block[::-1]])), K)
    np.testing.assert_array_equal(both[0].numpy(), got)


def test_forward_cli_ref_trunc_says_so_and_launches_nothing(capsys):
    # ref_trunc=true on the forward command line: one printed line says
    # the mode, no kernel launch, and the population's day sums as the
    # reference's accounting gives them (start at r_number, decline as
    # mass leaves the domain)
    from parasitoids_tpu_torch import cli
    from parasitoids_tpu_torch.ops import day_kernel
    before = day_kernel.LAUNCHES
    fields, days = cli.main(argv=[
        '--device', 'cpu', '--pop', '--no_plot', '--no_output', 'ndays=3',
        'domain_info=(4000.0,40)', 'interp_num=6', 'kernel_rad=8',
        'kernel_rad_local=3', 'ref_trunc=True'])
    out = capsys.readouterr().out.splitlines()
    assert 'ref_trunc' in out[0]
    assert sum('no CUDA kernel launch' in line for line in out) == 1
    assert day_kernel.LAUNCHES == before
    sums = fields.sum(dim=(1, 2)).numpy()
    assert np.isfinite(sums).all() and sums[0] <= 130000.0 * (1 + 1e-5)
    assert np.all(np.diff(sums) <= 1e-3 * sums[0])


# ----------------------------------------------------------------------
# host projections and the figures (tests/test_viz.py's inputs)
# ----------------------------------------------------------------------

KALBAR_LATLONG = (-27.947131, 152.584171)
DOMAIN = (10000.0, 400)
NDAYS = 18


@pytest.fixture(scope='module')
def locinfo():
    from parasitoids_tpu_torch.io.locinfo import LocInfo
    return LocInfo('kalbar', KALBAR_LATLONG, DOMAIN)


@pytest.fixture(scope='module')
def jlocinfo():
    from parasitoids_tpu.io.locinfo import LocInfo
    return LocInfo('kalbar', KALBAR_LATLONG, DOMAIN)


def _params(mod):
    p = mod.Params()
    p.cmd_line_chg(['--kalbar'])
    p.OUTPUT = False
    p.PLOT = False
    p.domain_info = DOMAIN
    p.maps_key = None          # no satellite fetch in tests
    return p


@pytest.fixture(scope='module')
def viz_params():
    from parasitoids_tpu_torch import config
    return _params(config)


@pytest.fixture(scope='module')
def fields():
    rng = np.random.default_rng(7)
    D = 2 * DOMAIN[1] + 1
    f = np.zeros((NDAYS, D, D), np.float32)
    c = DOMAIN[1]
    for d in range(NDAYS):
        r = 30 + 3 * d
        f[d, c - r:c + r + 1, c - r:c + r + 1] = rng.uniform(
            0, 50, (2 * r + 1, 2 * r + 1))
    return f


def test_host_projections_equal_jax(fields, locinfo, jlocinfo):
    # the numpy variants: the same gathers, products and sentinel sums
    # (np.add.at in cell order) as JAX's, to the bit
    from parasitoids_tpu.models.observe import ObservationOps as JOps
    from parasitoids_tpu_torch.models.observe import ObservationOps as TOps
    jops = JOps(jlocinfo, DOMAIN, NDAYS)
    tops = TOps(locinfo, DOMAIN, NDAYS)
    (jr, js), (tr, tsent) = (jops.project_emergence_np(fields),
                             tops.project_emergence_np(fields))
    for a, b in zip((*tr, *tsent), (*jr, *js)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tops.project_grid_np(fields),
                                  jops.project_grid_np(fields))
    for a, b in zip(tops.project_card_np(fields[:5]),
                    jops.project_card_np(fields[:5])):
        np.testing.assert_array_equal(a, b)
    # and the device projections of the same fields (f32 products)
    trel, tsen = tops.project_emergence(t32(fields))
    for a, b in zip((*trel, *tsen), (*jr, *js)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def test_grid_r_squared_equals_jax(fields, viz_params, locinfo, jlocinfo):
    from parasitoids_tpu import config as jconfig
    from parasitoids_tpu.viz import compare as jcompare
    from parasitoids_tpu_torch.viz import compare as tcompare
    days = list(range(1, NDAYS + 1))
    want = jcompare.grid_r_squared(fields, days, _params(jconfig), jlocinfo)
    got = tcompare.grid_r_squared(t32(fields), days, viz_params, locinfo)
    assert got['per_day'].keys() == want['per_day'].keys()
    for k in want['per_day']:
        np.testing.assert_equal(got['per_day'][k], want['per_day'][k])
    np.testing.assert_equal(got['pooled'], want['pooled'])


@pytest.mark.parametrize('fig', ['compare_emergence', 'assess_fit',
                                 'compare_emergence_3d', 'assess_fit_3d',
                                 'banner'])
def test_compare_figures_are_written(tmp_path, fields, viz_params, locinfo,
                                     fig):
    # test_viz.py's figure cases on the port, from a tensor of fields
    pytest.importorskip('matplotlib')
    from parasitoids_tpu_torch.viz import compare
    out = getattr(compare, fig)(t32(fields), list(range(1, NDAYS + 1)),
                                viz_params, locinfo,
                                outfile=str(tmp_path / (fig + '.png')))
    assert os.path.exists(out) and os.path.getsize(out) > 0


def test_info_plots_and_explore_figures_are_written(tmp_path, viz_params,
                                                    locinfo):
    pytest.importorskip('matplotlib')
    from parasitoids_tpu_torch.viz import explore, info_plots
    outs = [info_plots.info_plot(viz_params, locinfo,
                                 outfile=str(tmp_path / 'info.png')),
            info_plots.sample_locations(viz_params, locinfo,
                                        outfile=str(tmp_path / 's.png')),
            explore.plot_g_wind_prob(outfile=str(tmp_path / 'g.png')),
            explore.plot_f_time_prob(outfile=str(tmp_path / 'f.png')),
            explore.plot_h_flight_prob(outfile=str(tmp_path / 'h.png'))]
    for out in outs:
        assert os.path.exists(out) and os.path.getsize(out) > 0


def test_plot_daily_kernel_is_the_jax_kernel(tmp_path, monkeypatch):
    # the explorer's daily kernel: the port's build_daily_kernel on the
    # CPU, the pmf JAX's explorer plots (test_daily_kernel.py's atol)
    pytest.importorskip('matplotlib')
    from parasitoids_tpu.viz import explore as jexplore
    from parasitoids_tpu_torch.viz import explore
    shown = {}

    def keep(tag):
        def crop(pmf, *a, **k):
            shown[tag] = np.asarray(pmf)
            return real(pmf, *a, **k)
        return crop

    from parasitoids_tpu.viz import plot_result as jpr
    from parasitoids_tpu_torch.viz import plot_result as tpr
    real = tpr.crop_to_support
    kw = dict(domain_info=(3000.0, 60), kernel_rad=10, kernel_rad_local=4,
              interp_num=2)
    monkeypatch.setattr(tpr, 'crop_to_support', keep('port'))
    out = explore.plot_daily_kernel(day_index=1, device='cpu',
                                    outfile=str(tmp_path / 'k.png'), **kw)
    assert os.path.exists(out)
    monkeypatch.setattr(jpr, 'crop_to_support', keep('jax'))
    jexplore.plot_daily_kernel(day_index=1, outfile=str(tmp_path / 'j.png'),
                               **kw)
    np.testing.assert_allclose(shown['port'], shown['jax'], atol=2e-6)


# ----------------------------------------------------------------------
# the PyMC-2 HDF5 migration (tests/test_legacy_hdf5.py's database)
# ----------------------------------------------------------------------

def test_legacy_hdf5_migration_equals_jax(tmp_path):
    h5py = pytest.importorskip('h5py')
    from parasitoids_tpu.io import legacy_hdf5 as jleg
    from parasitoids_tpu_torch.io import legacy_hdf5 as tleg
    rng = np.random.default_rng(0)
    tallied = ['lam', 'f_a1', 'f_a2', 'f_b1', 'f_b2', 'g_aw', 'g_bw',
               'sig_x', 'sig_y', 'corr', 'sig_xl', 'sig_yl', 'corr_l',
               'mu_r', 'n_periods', 'xi', 'em_obs_prob', 'grid_obs_prob',
               'A_collected', 'deviance', 'sent_obs_probs_B',
               'sent_obs_probs_C']
    dtype = np.dtype([(t, np.float64) for t in tallied])
    db = str(tmp_path / 'legacy.hdf5')
    with h5py.File(db, 'w') as f:
        for c in range(2):
            tab = np.zeros(30, dtype)
            for t in tallied:
                tab[t] = (rng.uniform(-1, 1, 30) if t.startswith('corr')
                          else rng.uniform(0.1, 5.0, 30))
            f.create_group('chain{}'.format(c)).create_dataset(
                'PyMCsamples', data=tab)
    a = tleg.migrate_hdf5_trace(db, str(tmp_path / 'port'), ['B', 'C'])
    b = jleg.migrate_hdf5_trace(db, str(tmp_path / 'jax'), ['B', 'C'])
    with np.load(a) as x, np.load(b) as y:
        assert x.files == y.files
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])
    with open(a.replace('.npz', '.meta.json')) as f1, \
            open(b.replace('.npz', '.meta.json')) as f2:
        ma, mb = json.load(f1), json.load(f2)
    assert ma == mb
    tleg.main([db, str(tmp_path / 'cli'), '--sent-ids', 'B,C'])
    with np.load(str(tmp_path / 'cli.npz')) as x, np.load(a) as y:
        np.testing.assert_array_equal(x['traces'], y['traces'])

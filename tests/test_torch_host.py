"""The port's own host layer against the JAX package's: ``Params``, the
wind loader, ``LocInfo``, the saved-run format, the MCMC diagnostics, the
durable commit, the diagnostic plots and the NumPy parts of the curvature
and analysis layers (the Laplace metric's floors, PSIS, WAIC, PSIS-LOO,
power-scaling) are copies, and must give the same values; and the port's
device policy (the card by default, no CPU fallback)."""

import os
import subprocess

import numpy as np
import pandas as pd
import pytest

from tests._torch_parity import torch

from parasitoids_tpu import config as jcfg
from parasitoids_tpu import io as jio
from parasitoids_tpu.io import locinfo as jloc
from parasitoids_tpu.io import save as jsave
from parasitoids_tpu.bayes import diagnostics as jdiag
from parasitoids_tpu.utils import durable as jdurable
from parasitoids_tpu.viz import bayes_plot as jplot
from parasitoids_tpu_torch import cli, config as tcfg, device
from parasitoids_tpu_torch import io as tio
from parasitoids_tpu_torch.bayes import diagnostics as tdiag
from parasitoids_tpu_torch.bayes import map_fit
from parasitoids_tpu_torch.bayes import run as bayes_run
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.io import locinfo as tloc
from parasitoids_tpu_torch.io import save as tsave
from parasitoids_tpu_torch.models import forward as tf
from parasitoids_tpu_torch.utils import durable as tdurable
from parasitoids_tpu_torch.viz import bayes_plot as tplot

pytestmark = [
    pytest.mark.filterwarnings('ignore:wasps advected beyond:RuntimeWarning'),
    pytest.mark.filterwarnings('ignore:simulation covers:RuntimeWarning')]


def _same(a, b, path='value'):
    """Deep equality of the host structures a copy must reproduce."""
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, obj=path)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], '{}[{!r}]'.format(path, k))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, '{}[{}]'.format(path, i))
    else:
        assert a == b or (a != a and b != b), '{}: {!r} != {!r}'.format(
            path, a, b)


@pytest.mark.parametrize('flags', [['--kalbar', '--pop'], ['--carnarvon'],
                                   ['--kalbar', 'ndays=5', 'n_periods=20']])
def test_params_copy_matches(flags):
    want, got = jcfg.Params(), tcfg.Params()
    want.cmd_line_chg(flags)
    got.cmd_line_chg(flags)
    _same(vars(want), vars(got), 'Params')


@pytest.mark.parametrize('site,interp', [('data/kalbar', 2),
                                         ('data/carnarvonearl', 6)])
def test_wind_loader_copy_matches(site, interp):
    want, want_days = jio.get_wind_data(site, interp, '00:00')
    got, got_days = tio.get_wind_data(site, interp, '00:00')
    _same(want, got, 'wind')
    assert list(want_days) == list(got_days)
    np.testing.assert_array_equal(
        jio.pack_wind(want, want_days, ndays=len(want_days)),
        tio.pack_wind(got, got_days, ndays=len(got_days)))


def test_locinfo_copy_matches():
    p = tcfg.Params()
    p.cmd_line_chg(['--kalbar'])
    want = jloc.LocInfo(p.dataset, p.coord, p.domain_info)
    got = tloc.LocInfo(p.dataset, p.coord, p.domain_info)
    assert vars(want).keys() == vars(got).keys()
    _same(vars(want), vars(got), 'LocInfo')


@pytest.mark.parametrize('writer,reader', [(tsave, jsave), (jsave, tsave)])
def test_saved_runs_cross_load(tmp_path, writer, reader):
    rng = np.random.default_rng(3)
    fields = rng.random((3, 21, 21)) * (rng.random((3, 21, 21)) < 0.2)
    p = tcfg.Params()
    p.cmd_line_chg(['--kalbar'])
    out = str(tmp_path / 'run')
    writer.save_run(out, fields, [1, 2, 3], p)
    back, days = reader.load_run(out, 21)
    assert list(days) == [1, 2, 3]
    np.testing.assert_allclose(back, fields, rtol=1e-6)


def _chains(seed, n_chains=3, n=400, dim=26):
    """Seeded AR(1) chains around the initial values: traces that every
    diagnostic has something to say about."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_chains, n, dim))
    for t in range(1, n):
        x[:, t] = 0.9 * x[:, t - 1] + rng.standard_normal((n_chains, dim))
    return x + np.arange(dim) + 0.3 * rng.standard_normal((n_chains, 1, dim))


@pytest.mark.parametrize('seed', [0, 1])
def test_diagnostics_copy_matches(seed):
    x = _chains(seed)
    np.testing.assert_array_equal(tdiag.gelman_rubin(x),
                                  jdiag.gelman_rubin(x))
    np.testing.assert_array_equal(tdiag.gelman_rubin(x[:, :, 0]),
                                  jdiag.gelman_rubin(x[:, :, 0]))
    np.testing.assert_array_equal(tdiag.geweke(x[0, :, 3]),
                                  jdiag.geweke(x[0, :, 3]))
    for n in (3, 12, 400):
        assert tdiag.effective_sample_size(x[1, :n, 2]) == \
            jdiag.effective_sample_size(x[1, :n, 2])
    names = ['p{}'.format(i) for i in range(5)]
    truth = np.arange(5) + 0.5
    assert tdiag.truth_diagnostics(x, names, truth, ('p1', 'p4')) == \
        jdiag.truth_diagnostics(x, names, truth, ('p1', 'p4'))
    # the degenerate cases of R-hat: constant chains that agree, and
    # that disagree
    flat = np.ones((2, 10))
    assert tdiag.gelman_rubin(flat) == jdiag.gelman_rubin(flat) == 1.0
    flat[1] = 2.0
    assert tdiag.gelman_rubin(flat) == jdiag.gelman_rubin(flat) == np.inf
    with pytest.raises(ValueError, match='at least 2 chains'):
        tdiag.gelman_rubin(x[:1])


@pytest.mark.parametrize('mod', [tdurable, jdurable])
def test_durable_copy_commits_only_when_enabled(mod, tmp_path, monkeypatch):
    def git(*args):
        return subprocess.run(['git', *args], cwd=tmp_path, check=True,
                              capture_output=True, text=True).stdout

    git('init', '-q')
    git('config', 'user.email', 'test@example.com')
    git('config', 'user.name', 'test')
    (tmp_path / '.gitignore').write_text('*.npz\n')
    store = tmp_path / 'run.npz'
    store.write_bytes(b'traces')
    paths = [str(store), str(tmp_path / 'missing.json')]
    monkeypatch.delenv('PARA_GIT_COMMIT', raising=False)
    assert not mod.durability_enabled()
    assert mod.commit_artifacts(paths, 'off', cwd=tmp_path) is False
    monkeypatch.setenv('PARA_GIT_COMMIT', '1')
    assert mod.durability_enabled()
    assert mod.commit_artifacts(paths, 'AM checkpoint', cwd=tmp_path) is True
    assert git('log', '--format=%s').split() == ['AM', 'checkpoint']
    assert git('ls-files').split() == ['run.npz']     # force-added
    # nothing new staged: a quiet no-op; nothing existing: the same
    assert mod.commit_artifacts(paths, 'again', cwd=tmp_path) is False
    assert mod.commit_artifacts(paths[1:], 'none', cwd=tmp_path) is False


def test_bayes_plot_copy_matches(tmp_path):
    for width, model in ((26, 'poisson'), (27, 'negbin'), (27, 'zip')):
        assert tplot._param_names(width, model) == \
            jplot._param_names(width, model)
    x = _chains(2, n_chains=2, n=60)
    made = {}
    for name, mod in (('port', tplot), ('jax', jplot)):
        out = str(tmp_path / name)
        written = mod.plot_traces(x, outdir=out, start=5, stop=50,
                                  select=['xi', 'log_posterior'])
        written += [mod.plot_f_g(x, out), mod.plot_sprd_vars(x, out, 10),
                    mod.plot_sent_obs_probs(x, out), mod.plot_other(x, out),
                    mod.plot_pt_ladder([0.0, 0.5, 1.0], x[0, :, :3].T,
                                       [4, 4], [1, 2], burn=5, outdir=out)]
        assert all(os.path.getsize(w) > 0 for w in written)
        made[name] = sorted(os.path.relpath(w, out) for w in written)
    assert made['port'] == made['jax'] and len(made['port']) == 7
    with pytest.raises(ValueError, match='unknown parameter'):
        tplot.plot_traces(x, outdir=str(tmp_path), select=['nope'])


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_pick_device_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    for asked in (None, 'cuda'):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device.pick_device(asked)
    assert device.pick_device('cpu') == torch.device('cpu')


def test_entry_points_raise_without_a_card(monkeypatch):
    # with no card and no device='cpu', nothing falls back to the CPU
    _no_card(monkeypatch)
    p = tcfg.Params()
    p.cmd_line_chg(['--kalbar', 'ndays=2', 'domain_info=(4000.0,40)'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tf.setup_forward(p)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BayesSetup(map_fit.map_cli_params(['ndays=2']))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(argv=['--pop', '--no_plot', '--no_output', 'ndays=2'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        map_fit.main(['--MAP', '--steps', '1', 'ndays=2'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bayes_run.build_setup(['ndays=2'])
    for mode in (['--new', '1', '0', 'unused'], ['--resume', 'unused', '1']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            bayes_run.main(mode + ['ndays=2'])


def test_device_flag_is_read_before_the_params_flags():
    assert cli.split_device(['--pop', '--device', 'cpu', 'ndays=2']) == \
        ('cpu', ['--pop', 'ndays=2'])
    assert cli.split_device(['--device=cpu']) == ('cpu', [])
    assert cli.split_device(['--kalbar']) == ('cuda', ['--kalbar'])
    with pytest.raises(SystemExit):
        cli.split_device(['--device', 'tpu'])


def test_cli_runs_on_the_cpu_with_device_flag(monkeypatch, capsys):
    _no_card(monkeypatch)
    fields, days = cli.main(argv=[
        '--device', 'cpu', '--pop', '--no_plot', '--no_output', 'ndays=2',
        'domain_info=(4000.0,40)', 'interp_num=6', 'kernel_rad=8',
        'kernel_rad_local=3'])
    assert fields.device.type == 'cpu' and fields.shape == (2, 81, 81)
    assert 'on cpu' in capsys.readouterr().out.splitlines()[0]


def test_map_cli_runs_on_the_cpu_with_device_flag(monkeypatch, tmp_path):
    _no_card(monkeypatch)
    out = str(tmp_path / 'map.txt')
    fit = map_fit.main(['--MAP', '--device', 'cpu', '--steps', '1', '-o',
                        out, 'ndays=2', 'domain_info=(10000.0,50)',
                        'interp_num=2', 'kernel_rad=6', 'kernel_rad_local=3'])
    assert fit['losses'].shape == (1,) and np.isfinite(fit['losses']).all()


def test_am_cli_runs_on_the_cpu_with_device_flag(monkeypatch, tmp_path):
    _no_card(monkeypatch)
    db = str(tmp_path / 'am')
    bayes_run.main(['--device', 'cpu', '--new', '2', '1', db, 'ndays=2',
                    'domain_info=(10000.0,50)', 'interp_num=2',
                    'kernel_rad=6', 'kernel_rad_local=3'])
    with np.load(db + '.npz') as npz:
        assert npz['traces'].shape == (1, 2, 26)
        assert np.isfinite(npz['traces']).all()


@pytest.mark.parametrize('prog', ['identify', 'summary', 'predictive', 'loo',
                                  'spread', 'sensitivity', 'sbc', 'cv'])
def test_analysis_clis_raise_without_a_card(prog, monkeypatch):
    # the curvature, analysis and validation command lines take the card
    # unless told --device cpu, as the others do
    import importlib
    _no_card(monkeypatch)
    mod = importlib.import_module('parasitoids_tpu_torch.bayes.' + prog)
    argv = ([] if prog in ('identify', 'sbc', 'cv') else ['unused.npz'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main(argv + ['ndays=2'])


@pytest.mark.parametrize('prog', ['viz.compare', 'viz.info_plots',
                                  'viz.explore'])
def test_figure_clis_raise_without_a_card(prog, monkeypatch):
    # the figure command lines take --device as the others do, and the card
    # unless told --device cpu
    import importlib
    _no_card(monkeypatch)
    mod = importlib.import_module('parasitoids_tpu_torch.' + prog)
    argv = ['unused_run'] if prog == 'viz.compare' else []
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main(argv)


@pytest.mark.parametrize('sampler', ['pt', 'smc', 'vi'])
def test_tempered_and_variational_samplers_raise_without_a_card(
        sampler, monkeypatch):
    _no_card(monkeypatch)
    for mode in (['--new', '1', '0', 'unused'], ['--resume', 'unused', '1']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            bayes_run.main(['--sampler', sampler] + mode + ['ndays=2'])


# ---------------------------------------------------------------------------
# host NumPy copies of the curvature and analysis layers
# ---------------------------------------------------------------------------

def _host_cases():
    """name -> (JAX function, port function, arguments made from a seed)."""
    from parasitoids_tpu.bayes import loo as jloo
    from parasitoids_tpu.bayes import map_fit as jmap
    from parasitoids_tpu.bayes import sensitivity as jsens
    from parasitoids_tpu.bayes import vi as jvi
    from parasitoids_tpu_torch.bayes import loo as tloo
    from parasitoids_tpu_torch.bayes import sensitivity as tsens
    from parasitoids_tpu_torch.bayes import vi as tvi
    rng = np.random.default_rng(11)
    A = rng.standard_normal((6, 6))
    cov = A @ A.T * np.logspace(-8, 2, 6) + 1e-9 * np.eye(6)
    pv = np.abs(rng.standard_normal(6)) * [1, 0, 1, 1, 1, 1]
    B = rng.standard_normal((6, 6))
    H_raw = A @ A.T * 1e4 + B + B.T
    H_np = np.diag(np.abs(rng.standard_normal(6)))
    H_T = H_np + 0.1 * np.eye(6)
    ll = rng.standard_normal((60, 9)) - 3.0 * rng.random(9)
    ll[:, 0] -= 20.0 * rng.random(60) ** 4        # a heavy-tailed column
    other = {'elpd_pointwise': rng.standard_normal(9)}
    x = np.sort(rng.pareto(2.0, 40) + 1e-3)
    draws = rng.standard_normal((80, 3))
    return {
        'regularize_cov_z': (jmap.regularize_cov_z,
                             map_fit.regularize_cov_z, (cov, pv)),
        'blend_prior_metric': (jmap.blend_prior_metric,
                               map_fit.blend_prior_metric,
                               (H_raw, H_np, H_T, pv)),
        'gpd_fit': (jvi.gpd_fit, tvi.gpd_fit, (x,)),
        'psis': (jvi.psis, tvi.psis, (-ll[:, 0],)),
        'waic': (jloo.waic, tloo.waic, (ll,)),
        'psis_loo': (jloo.psis_loo, tloo.psis_loo, (ll,)),
        'loo_compare': (lambda a: jloo.loo_compare(jloo.psis_loo(ll), a),
                        lambda a: tloo.loo_compare(tloo.psis_loo(ll), a),
                        (other,)),
        'cjs_dist': (jsens.cjs_dist, tsens.cjs_dist,
                     (draws[:, 0], 0.3 * draws[:, 1])),
        'powerscale_logweights': (jsens.powerscale_logweights,
                                  tsens.powerscale_logweights,
                                  (ll.sum(axis=1), 1.5)),
        'powerscale_sensitivity': (
            jsens.powerscale_sensitivity, tsens.powerscale_sensitivity,
            (draws, 0.2 * draws[:, 0], np.resize(ll.sum(axis=1), 80),
             ['a', 'b', 'c'])),
    }


def _close(a, b, path):
    """Equal to 1e-12 of each value, recursively over the results'
    dicts, tuples and lists (strings and ints exactly)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], '{}[{!r}]'.format(path, k))
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], str):
        assert a == b, path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, '{}[{}]'.format(path, i))
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-12,
                                   atol=0, err_msg=path)


@pytest.mark.parametrize('name', list(_host_cases()))
def test_curvature_and_analysis_host_copies_match(name):
    jax_fn, port_fn, args = _host_cases()[name]
    _close(port_fn(*args), jax_fn(*args), name)


@pytest.mark.parametrize('mod', ['viz.compare', 'viz.info_plots',
                                 'viz.explore', 'io.legacy_hdf5'])
def test_figure_and_migration_copies_keep_the_originals_interface(mod):
    # the port's copies of the figure modules and of the trace migration
    # offer every public function of the JAX module with its parameters
    # (the explorer's daily kernel adds ``device``); their results are held
    # to JAX's in tests/test_torch_variants.py
    import importlib
    import inspect
    jmod = importlib.import_module('parasitoids_tpu.' + mod)
    tmod = importlib.import_module('parasitoids_tpu_torch.' + mod)
    for name in jmod.__all__:
        want = inspect.signature(getattr(jmod, name)).parameters
        got = dict(inspect.signature(getattr(tmod, name)).parameters)
        if name == 'plot_daily_kernel':
            assert got.pop('device').default is None
        assert list(got) == list(want), name
        assert [p.default for p in got.values()] == \
            [p.default for p in want.values()], name

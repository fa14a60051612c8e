"""Port parity of the whole slice: the three checked-in JAX goldens
reproduced through the port's own loader, kernel build and propagation;
a direct JAX-vs-port ``forward_fields``; the CLI end to end; and the
port's independence from JAX."""

import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_parity import torch
from tests.test_golden import GOLDEN, _run_config

from parasitoids_tpu.io.save import load_run
from parasitoids_tpu.models import forward as jf
from parasitoids_tpu_torch import cli
from parasitoids_tpu_torch.models import forward as tf

pytestmark = [
    pytest.mark.filterwarnings('ignore:wasps advected beyond:RuntimeWarning'),
    # the golden configs set quad_nodes = 12, which neither package reads
    pytest.mark.filterwarnings('ignore:quad_nodes=12 is ignored:UserWarning')]


@pytest.mark.parametrize('name,pop,site,ndays', [
    ('kalbar_prob_tiny', False, '--kalbar', 4),
    ('kalbar_pop_tiny', True, '--kalbar', 4),
    ('carnarvon_pop_tiny', True, '--carnarvon', 7)])
def test_port_reproduces_jax_goldens(name, pop, site, ndays):
    # test_golden.py tolerances: 2e-5 of the peak pointwise, day mass
    # rtol 1e-4, Carnarvon ramp totals rtol 2e-5
    want, want_days = load_run(os.path.join(GOLDEN, name), 201)
    p = _run_config(pop, site=site, ndays=ndays)
    fields, days = tf.simulate(p, device='cpu')
    got = fields.numpy()
    assert list(days) == list(want_days)
    scale = max(want.max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), want.sum(axis=(1, 2)),
                               rtol=1e-4)
    if site == '--carnarvon':
        np.testing.assert_allclose(got.sum(axis=(1, 2))[:3], p.r_number,
                                   rtol=2e-5)


def test_loader_gives_the_jax_bits():
    # the port's own loader hands the kernel builder the same wind, bit for
    # bit, as the JAX loader; its prefix sum (summed in f64, rounded once)
    # is within 4 f32 ulps of the largest partial sum of JAX's f32 cumsum
    p = _run_config(True, site='--carnarvon', ndays=7)
    want = jf.setup_forward(p)
    got = tf.setup_forward(p, device='cpu')
    np.testing.assert_array_equal(got.wind_flat.numpy(),
                                  np.asarray(want.wind_flat))
    want_cs = np.asarray(want.wind_cumsum)
    np.testing.assert_allclose(got.wind_cumsum.numpy(), want_cs, rtol=0,
                               atol=4 * np.spacing(np.abs(want_cs).max()))
    assert (got.ndays, got.start_idx, got.rad_dist) == \
        (want.ndays, want.start_idx, want.rad_dist)
    assert tuple(got.scfg) == tuple(want.scfg)
    assert got.kcfg.K == want.kcfg.K and not got.kcfg.pallas


def test_forward_fields_matches_jax_through_setup_from_numpy():
    # JAX's own setup arrays fed to both packages; 2e-5 of the peak
    p = _run_config(True)
    js = jf.setup_forward(p)
    hp = (p.lam, *p.g_params, *p.f_params)
    want = np.asarray(jf.forward_fields(
        js.wind_flat, js.wind_cumsum, tuple(np.float32(v) for v in hp),
        p.Dparams, p.Dlparams, p.mu_r, jnp.int32(p.n_periods), js.rad_dist,
        jnp.int32(js.start_idx), float(p.r_number),
        jnp.asarray(js.dist_weights, jnp.float32), js.kcfg, js.scfg,
        js.ndays, int(p.r_dur), False))
    ts = tf.setup_from_numpy(np.asarray(js.wind_flat),
                             np.asarray(js.wind_cumsum), js.days, js.ndays,
                             js.kcfg, js.scfg, js.rad_dist, js.start_idx,
                             js.dist_weights, 'cpu', torch.float32)
    got = tf.forward_fields(
        ts.wind_flat, ts.wind_cumsum, hp, p.Dparams, p.Dlparams, p.mu_r,
        p.n_periods, ts.rad_dist, ts.start_idx, float(p.r_number),
        torch.as_tensor(ts.dist_weights, dtype=torch.float32), ts.kcfg,
        ts.scfg, ts.ndays, int(p.r_dur), False).numpy()
    assert got.shape == want.shape == (4, 201, 201)
    np.testing.assert_allclose(got / want.max(), want / want.max(),
                               atol=2e-5)


@pytest.mark.parametrize('nodes,warns', [(16, False), (12, True)])
def test_quad_nodes_other_than_default_warns(nodes, warns):
    # the node count follows |rho|; a set quad_nodes is said to be ignored
    p = _run_config(True)
    p.quad_nodes = nodes
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        tf.setup_forward(p, device='cpu')
    said = [w for w in caught if 'quad_nodes' in str(w.message)]
    assert len(said) == int(warns)


def test_use_pallas_true_on_cpu_raises():
    p = _run_config(True)
    p.use_pallas = True
    with pytest.raises(ValueError, match='CUDA'):
        tf.setup_forward(p, device='cpu')


def test_f64_mode_takes_the_plain_accumulate():
    p = _run_config(False, ndays=2)
    p.use_f64 = True
    p.use_pallas = True          # f64 overrides it, as in the JAX package
    s = tf.setup_forward(p, device='cpu')
    assert s.wind_flat.dtype == torch.float64 and not s.kcfg.pallas
    fields, _ = tf.simulate(p, s)
    assert fields.dtype == torch.float64
    np.testing.assert_allclose(fields.sum(dim=(1, 2)).numpy(), 1.0,
                               atol=1e-4)


def test_cli_end_to_end(tmp_path, capsys):
    out = str(tmp_path / 'run')
    fields, days = cli.main(argv=[
        '--pop', '--no_plot', '--output', 'ndays=3',
        'domain_info=(4000.0,100)', 'interp_num=6', 'kernel_rad=20',
        'kernel_rad_local=6', 'outfile=' + out], device='cpu')
    printed = capsys.readouterr().out
    assert 'plain torch accumulate' in printed.splitlines()[0]
    assert 'Kernel phase' in printed and 'Convolution phase' in printed
    back, back_days = load_run(out, 201)
    assert back_days == list(days) and back.shape == (3, 201, 201)
    np.testing.assert_allclose(back, fields.numpy(), rtol=1e-6)
    assert os.path.exists(out + '.json')


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_does_not_import_jax():
    # every module of the port (its entry points, its own copies of the
    # host layer) loads neither JAX nor any module of the JAX package
    code = ('import sys, parasitoids_tpu_torch, parasitoids_tpu_torch.cli, '
            'parasitoids_tpu_torch.ops.day_kernel, '
            'parasitoids_tpu_torch.bayes.map_fit, '
            'parasitoids_tpu_torch.bayes.model, parasitoids_tpu_torch.io, '
            'parasitoids_tpu_torch.bayes.run, '
            'parasitoids_tpu_torch.bayes.sampler, '
            'parasitoids_tpu_torch.bayes.store, '
            'parasitoids_tpu_torch.bayes.diagnostics, '
            'parasitoids_tpu_torch.parallel.chains, '
            'parasitoids_tpu_torch.utils.durable, '
            'parasitoids_tpu_torch.viz.bayes_plot, '
            'parasitoids_tpu_torch.io.locinfo, '
            'parasitoids_tpu_torch.utils.checks, '
            'parasitoids_tpu_torch.viz.plot_result; '
            'import pkgutil, importlib; '
            'mods = [m.name for m in pkgutil.walk_packages('
            "parasitoids_tpu_torch.__path__, 'parasitoids_tpu_torch.') "
            "if not m.name.endswith('__main__')]; "
            '[importlib.import_module(m) for m in mods]; '
            "assert len(mods) >= 32, mods; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "bad = [k for k in sys.modules if k == 'parasitoids_tpu' or "
            "k.startswith('parasitoids_tpu.')]; "
            "assert not bad, 'the JAX package was imported: %s' % bad")
    subprocess.run([sys.executable, '-c', code], check=True, cwd=ROOT)


def test_port_has_no_import_of_the_jax_package():
    # no line of the port, its smoke run or its profile scripts imports
    # jax, parasitoids_tpu or a module of either; every module of the
    # curvature and analysis layers is among the files read
    pattern = re.compile(
        r'^\s*(from|import)\s+(parasitoids_tpu|jax)(\.|\s|$)')
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(ROOT,
                                                  'parasitoids_tpu_torch'))
             for f in fs if f.endswith('.py')]
    files += [os.path.join(ROOT, 'chip_smoke.py')] + [
        os.path.join(ROOT, 'scripts', f)
        for f in os.listdir(os.path.join(ROOT, 'scripts'))
        if f.startswith(('profile_torch', 'time_day_kernel',
                         'hash_day_kernel', 'compare_torch_gradient'))]
    assert len(files) > 46
    for mod in ('bayes/identify', 'bayes/loo', 'bayes/map_fit',
                'bayes/predictive', 'bayes/sensitivity', 'bayes/spread',
                'bayes/summary', 'bayes/vi', 'parallel/ensemble',
                'utils/graphs'):
        assert os.path.join(ROOT, 'parasitoids_tpu_torch',
                            mod + '.py') in files, mod
    hits = ['{}:{}'.format(os.path.relpath(f, ROOT), i + 1)
            for f in files for i, line in enumerate(open(f))
            if pattern.match(line)]
    assert not hits, hits

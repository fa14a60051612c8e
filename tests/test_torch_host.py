"""The port's own host layer against the JAX package's: ``Params``, the
wind loader, ``LocInfo`` and the saved-run format are copies, and must
give the same values; and the port's device policy (the card by default,
no CPU fallback)."""

import numpy as np
import pandas as pd
import pytest

from tests._torch_parity import torch

from parasitoids_tpu import config as jcfg
from parasitoids_tpu import io as jio
from parasitoids_tpu.io import locinfo as jloc
from parasitoids_tpu.io import save as jsave
from parasitoids_tpu_torch import cli, config as tcfg, device
from parasitoids_tpu_torch import io as tio
from parasitoids_tpu_torch.bayes import map_fit
from parasitoids_tpu_torch.bayes.model import BayesSetup
from parasitoids_tpu_torch.io import locinfo as tloc
from parasitoids_tpu_torch.io import save as tsave
from parasitoids_tpu_torch.models import forward as tf

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

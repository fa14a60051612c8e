"""The port's command line (``parasitoids_tpu_torch.bayes.run``) on the
CPU at the small configuration: ``--new`` / ``--resume`` write the meta
keys and write ``obs_sweeps`` back (test_obs_sweeps_meta.py:19-47),
checkpoints and a resume change no sample, the result is read by the JAX
package's consumers, ``--sampler pt|smc|vi`` run, what stays unported
exits naming its ROADMAP item, and the ``--analyze`` menu answers from
stdin, its ``[e]`` entry with the evidence of a PT or SMC store.  A NUTS run interrupted and
resumed from its transition checkpoint writes the traces of the run that
never stopped."""

import io
import json
import os

import numpy as np
import pytest

from tests._torch_parity import MAP_SMALL

from parasitoids_tpu.bayes import diagnostics as jdiag
from parasitoids_tpu.bayes import run as jrun
from parasitoids_tpu.viz import bayes_plot as jplot
from parasitoids_tpu_torch.bayes import run as trun

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

TINY = list(MAP_SMALL)
CPU = ['--device', 'cpu']


def _meta(db):
    with open(db + '.meta.json') as fh:
        return json.load(fh)


def _traces(db):
    with np.load(db + '.npz') as npz:
        return npz['traces']


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """A two-chain run of 6 samples after 4 of burn-in, resumed for 4
    more, with a checkpoint every 4 steps."""
    db = str(tmp_path_factory.mktemp('am') / 'run')
    trun.main(CPU + ['--new', '6', '4', db, '--chains', '2',
                     '--checkpoint-every', '4', '--seed', '3'] + TINY)
    first = _traces(db)
    trun.main(CPU + ['--resume', db, '4'] + TINY)
    return db, first


def test_new_and_resume_write_the_store(store):
    db, first = store
    assert first.shape == (2, 6, 26)
    traces = _traces(db)
    assert traces.shape == (2, 10, 26) and np.isfinite(traces).all()
    np.testing.assert_array_equal(traces[:, :6], first)
    meta = _meta(db)
    assert meta == {'n_samples': 10, 'burn': 4, 'chains': 2,
                    'obs_sweeps': 1, 'obs_model': 'poisson',
                    'sampler': 'am', 'seed': 3, 'device': 'cpu'}
    with np.load(db + '.npz') as npz:
        assert float(npz['state_count'][0]) == 14.0
        assert npz['state_key'].shape == (2, 5056)


def test_checkpoints_and_resume_change_no_sample(store, tmp_path, capsys):
    # the same seed in one piece, with no checkpoint between: the
    # checkpointed and resumed run of the fixture drew the same samples
    db, _ = store
    whole = str(tmp_path / 'whole')
    trun.main(CPU + ['--new', '10', '4', whole, '--chains', '2', '--seed',
                     '3'] + TINY)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == 'device cpu, accumulate plain torch'
    assert 'checkpoint:' not in out and 'Gelman-Rubin' in out
    np.testing.assert_array_equal(_traces(whole), _traces(db))
    assert _meta(whole)['n_samples'] == 10


def test_store_is_read_by_the_jax_package(store, tmp_path, monkeypatch,
                                          capsys):
    db, _ = store
    traces = _traces(db)
    rhat = jdiag.gelman_rubin(traces[:, :, :15])
    assert rhat.shape == (15,) and not np.isnan(rhat).any()
    monkeypatch.chdir(tmp_path)
    jplot.main([db])
    assert os.path.exists(tmp_path / 'diagnostics' / 'trace_xi.png')
    # the JAX package's --analyze menu over the port's store
    monkeypatch.setattr('sys.stdin', io.StringIO('s\ng\nq\n'))
    jrun.run_analyze(jrun.parser.parse_args(['--analyze', db]))
    out = capsys.readouterr().out
    assert '2 chain(s) x 10 samples x 26 columns' in out
    assert 'wrote diagnostics/gelman-rubin.txt' in out


def test_am_resume_override_written_back(tmp_path, capsys):
    db = str(tmp_path / 'am_run')
    trun.main(CPU + ['--new', '4', '2', db, '--obs-sweeps', '2'] + TINY)
    assert _meta(db)['obs_sweeps'] == 2
    # an override on resume is honored and recorded
    trun.main(CPU + ['--resume', db, '3', '--obs-sweeps', '5',
                     '--checkpoint-every', '2'] + TINY)
    assert 'checkpoint: 2/3 steps done' in capsys.readouterr().out
    assert _meta(db)['obs_sweeps'] == 5
    # a plain resume inherits the recorded value (not the original)
    trun.main(CPU + ['--resume', db, '2'] + TINY)
    meta = _meta(db)
    assert meta['obs_sweeps'] == 5 and meta['n_samples'] == 9
    assert _traces(db).shape == (1, 9, 26)
    # a store of another sampler is refused
    with open(db + '.meta.json', 'w') as fh:
        json.dump(dict(meta, sampler='pt'), fh)
    with pytest.raises(SystemExit, match='--sampler pt'):
        trun.main(CPU + ['--resume', db, '2'] + TINY)


def test_burn_in_checkpoint_holds_no_samples_yet(tmp_path, capsys):
    # a checkpoint inside the burn-in stores an empty trace block and the
    # state; the JAX plots say so instead of failing
    db = str(tmp_path / 'short')
    trun.main(CPU + ['--new', '0', '2', db] + TINY)
    assert 'no posterior draws yet' in capsys.readouterr().out
    assert _traces(db).shape == (1, 0, 26)
    assert _meta(db)['n_samples'] == 0


@pytest.mark.parametrize('sampler,flags', [
    ('pt', ['--temps', '2', '--swap-every', '1']),
    ('smc', ['--ess-target', '0.01', '--moves', '1', '--min-accepts', '0',
             '--max-move-rounds', '1']),
    ('vi', ['--vi-mc', '1', '--vi-is', '4', '--init', 'prior'])])
def test_cli_runs_the_tempered_and_variational_samplers(sampler, flags,
                                                        tmp_path, capsys):
    # --sampler pt|smc|vi are no longer refused: each writes its store
    db = str(tmp_path / sampler)
    trun.main(CPU + ['--sampler', sampler, '--new', '2', '1', db] + flags
              + TINY)
    assert _meta(db)['sampler'] == sampler
    assert np.isfinite(_traces(db)).all()
    assert 'ROADMAP' not in capsys.readouterr().err


def test_obs_sweeps_rejects_nonpositive():
    for bad in ('0', '-1'):
        with pytest.raises(SystemExit):
            trun.parser.parse_args(['--new', '1', '0', 'x', '--obs-sweeps',
                                    bad])


def test_parser_has_the_jax_modules_options():
    # --help reads the same: every option of the JAX module, plus --device,
    # less the one that minute-shards each forward, which the port has not
    def options(parser, minutes=False):
        return {s for a in parser._actions for s in a.option_strings
                if minutes == ('minute-axis' in (a.help or ''))}

    assert len(options(jrun.parser, minutes=True)) == 1
    assert not options(trun.parser, minutes=True)
    assert options(trun.parser) == options(jrun.parser) | {'--device'}
    assert trun.parser.prog == 'parasitoids_tpu_torch.bayes.run'


def test_analyze_menu(store, tmp_path, monkeypatch, capsys):
    db, _ = store
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr('sys.stdin', io.StringIO('s\ng\nr\nx\nq\n'))
    trun.main(['--analyze', db])
    out = capsys.readouterr().out
    assert '2 chain(s) x 10 samples x 26 columns' in out
    assert '"sampler": "am"' in out
    assert 'posterior means (model block):' in out
    assert 'Gelman-Rubin R-hat' in out and 'ESS (g_aw, pooled)' in out
    assert 'wrote diagnostics/gelman-rubin.txt' in out
    assert 'python -m parasitoids_tpu_torch.bayes.run --resume' in out
    assert "unrecognized option 'x'" in out
    assert '[e] log-evidence' not in out
    with open(tmp_path / 'diagnostics' / 'gelman-rubin.txt') as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 25 and lines[0].startswith('g_aw: ')


def test_analyze_plots_and_evidence_entry(store, tmp_path, monkeypatch,
                                          capsys):
    # [p] and [t] go through the port's own copy of viz/bayes_plot.py; a
    # store with tempering extras offers [e], which gives their evidence
    db, _ = store
    with np.load(db + '.npz') as npz:
        payload = {k: npz[k] for k in npz.files}
    pt = str(tmp_path / 'pt')
    np.savez(pt + '.npz', x_betas=np.linspace(0, 1, 3),
             x_loglik=np.zeros((3, 4)), **payload)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr('sys.stdin', io.StringIO(
        'p\nt\nxi mu_r\n2 8\nt\nnope\n\ne\n'))
    trun.main(['--analyze', pt + '.npz'])
    out = capsys.readouterr().out
    assert 'diagnostics written to ./diagnostics/' in out
    assert 'wrote 2 plot(s) to ./diagnostics/' in out
    assert "unknown parameter name(s) ['nope']" in out
    assert '[e] log-evidence' in out and 'item 18' not in out
    # a flat log likelihood over a ladder from 0 to 1: log Z = 0
    assert 'log Z (thermodynamic integration): 0.00' in out
    assert 'log Z (stepping-stone):            0.00' in out
    made = os.listdir(tmp_path / 'diagnostics')
    assert {'trace_xi.png', 'trace_mu_r.png', 'posterior_f_g.png',
            'posterior_sprd.png', 'posterior_sent_obs.png'} <= set(made)


NUTS = ['--sampler', 'nuts', '--max-depth', '3', '--init-map-steps', '3',
        '--seed', '4']


def _interrupt_nuts(monkeypatch, at):
    """Make the next NUTS run stop at ``at`` = (phase, transition)."""
    from parasitoids_tpu_torch.bayes import nuts as tn

    class Stop(Exception):
        pass

    real = tn.nuts_sample_stepwise

    def stopping(*a, progress=None, **k):
        def wrapped(phase, i, total):
            if (phase, i) == at:
                raise Stop
            progress(phase, i, total)
        return real(*a, progress=wrapped, **k)

    monkeypatch.setattr(tn, 'nuts_sample_stepwise', stopping)
    return Stop


@pytest.mark.parametrize('at', [('warmup', 6), ('sample', 2)])
def test_nuts_cli_resume_writes_the_uninterrupted_traces(tmp_path, at,
                                                         monkeypatch,
                                                         capsys):
    whole = str(tmp_path / 'whole')
    trun.main(CPU + NUTS + ['--new', '4', '10', whole, '--chains', '2',
                            '--checkpoint-every', '2'] + TINY)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == 'device cpu, accumulate plain torch'
    assert 'NUTS init: MAP logp' in out and 'NUTS finished' in out
    db = str(tmp_path / 'cut')
    stop = _interrupt_nuts(monkeypatch, at)
    with pytest.raises(stop):
        trun.main(CPU + NUTS + ['--new', '4', '10', db, '--chains', '2',
                                '--checkpoint-every', '2'] + TINY)
    monkeypatch.undo()
    assert os.path.exists(db + '.ckpt.npz')
    # the transient checkpoint is gone: the durable twin takes its place
    os.remove(db + '.ckpt.npz')
    trun.main(CPU + ['--sampler', 'nuts', '--resume', db, '0'] + TINY)
    assert 'restored from durable twin' in capsys.readouterr().out
    with np.load(whole + '.npz') as a, np.load(db + '.npz') as b:
        assert set(a.files) == {'traces', 'z_samples', 'step_size',
                                'inv_mass', 'sampler'}
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a['traces'].shape == (2, 4, 26) and str(a['sampler']) == 'nuts'
        assert np.isfinite(a['traces']).all()
        assert np.all(a['traces'][..., 13] == 30.0)
    for suffix in ('.ckpt.npz', '.ckpt_durable.npz'):
        assert not os.path.exists(db + suffix)


@pytest.mark.parametrize('mass', ['laplace', 'ridge'])
def test_nuts_cli_laplace_and_ridge_metrics(mass, tmp_path, capsys):
    # --mass laplace: a dense metric fixed at the blended Laplace
    # covariance of a MAP fit; --mass ridge: NUTS in that covariance's
    # eigenbasis, the map kept in the <db>.whiten.npz sidecar
    db = str(tmp_path / mass)
    trun.main(CPU + NUTS + ['--mass', mass, '--new', '2', '10', db,
                            '--chains', '2'] + TINY)
    out = capsys.readouterr().out
    assert 'NUTS init: MAP fit (3 steps) + Laplace metric...' in out
    assert 'Laplace Hessian on the plain path in float32, 25 columns' in out
    with np.load(db + '.npz') as npz:
        traces, inv_mass = npz['traces'], npz['inv_mass']
        z = npz['z_samples']
    assert traces.shape == (2, 2, 26) and np.isfinite(traces).all()
    assert inv_mass.shape == (2, 25, 25) and np.isfinite(z).all()
    if mass == 'laplace':
        # warm-up adapted the step size only: the metric is the warm start
        np.testing.assert_array_equal(inv_mass[0], inv_mass[1])
        assert np.linalg.eigvalsh(inv_mass[0].astype(np.float64)).min() > 0
        assert not os.path.exists(db + '.whiten.npz')
    else:
        with np.load(db + '.whiten.npz') as wz:
            assert set(wz.files) == {'L', 'center', 'anchor'}
            L, center = wz['L'], wz['center']
        assert L.shape == (25, 25) and center.shape == (25,)
        # the pinned n_periods slot is the one anchored direction
        assert float(np.load(db + '.whiten.npz')['anchor'].sum()) == 1.0
        assert np.all(traces[..., 13] == 30.0)


def test_nuts_cli_ridge_resumes_through_the_sidecar(tmp_path, monkeypatch,
                                                   capsys):
    # an interrupted --mass ridge run resumes in u-space from its
    # checkpoint and sidecar, and writes the traces of the run that never
    # stopped, bit for bit
    ridge = NUTS + ['--mass', 'ridge']
    whole = str(tmp_path / 'whole')
    trun.main(CPU + ridge + ['--new', '3', '10', whole,
                             '--checkpoint-every', '2'] + TINY)
    db = str(tmp_path / 'cut')
    stop = _interrupt_nuts(monkeypatch, ('sample', 2))
    with pytest.raises(stop):
        trun.main(CPU + ridge + ['--new', '3', '10', db,
                                 '--checkpoint-every', '2'] + TINY)
    monkeypatch.undo()
    capsys.readouterr()
    trun.main(CPU + ['--sampler', 'nuts', '--resume', db, '0'] + TINY)
    assert ('NUTS resume: ridge reparameterization from ' + db +
            '.whiten.npz') in capsys.readouterr().out
    with np.load(whole + '.npz') as a, np.load(db + '.npz') as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with np.load(whole + '.whiten.npz') as a, \
            np.load(db + '.whiten.npz') as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_nuts_cli_gibbs_dense_and_analyze(tmp_path, monkeypatch, capsys):
    db = str(tmp_path / 'gibbs')
    trun.main(CPU + NUTS + ['--new', '3', '10', db, '--gibbs-n',
                            '--dense-mass', '--n-step', '2'] + TINY)
    out = capsys.readouterr().out
    assert 'n_periods Gibbs moves: accept' in out
    with np.load(db + '.npz') as npz:
        assert npz['traces'].shape == (1, 3, 26)
        assert npz['inv_mass'].shape == (1, 25, 25)
        ns = npz['traces'][..., 13]
        assert np.all(ns >= 1) and np.all(ns == np.round(ns))
        z = npz['z_samples']
    # the JAX package's consumers and the port's --analyze read it
    assert jdiag.gelman_rubin(np.concatenate([z, z])[:, :, :15]).shape == (
        15,)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr('sys.stdin', io.StringIO('s\nq\n'))
    trun.main(['--analyze', db])
    out = capsys.readouterr().out
    assert '1 chain(s) x 3 samples x 26 columns' in out
    assert 'posterior means (model block):' in out


@pytest.mark.parametrize('flags,msg', [
    (['--sampler', 'nuts', '--obs-sweeps', '2'], 'only applies to the am')])
def test_nuts_cli_refusals(flags, msg, capsys):
    with pytest.raises(SystemExit) as exc:
        trun.main(CPU + ['--new', '2', '1', 'unused'] + flags + TINY)
    assert exc.value.code == 2 and msg in capsys.readouterr().err
    with pytest.raises(SystemExit, match='no NUTS checkpoint'):
        trun.main(CPU + ['--sampler', 'nuts', '--resume', 'nowhere', '0'] +
                  TINY)


def test_nuts_cli_starts_from_an_am_store(store, tmp_path, capsys):
    # --init <trace>: chain 0's final AM state, with the pre-spread factor
    # at 0.3, is the start; an obs block of another length is refused
    am_db, _ = store
    db = str(tmp_path / 'from_am')
    trun.main(CPU + ['--sampler', 'nuts', '--max-depth', '2', '--init',
                     am_db, '--new', '1', '10', db] + TINY)
    assert 'NUTS init: from trace' in capsys.readouterr().out
    with np.load(db + '.npz') as npz:
        assert npz['traces'].shape == (1, 1, 26)
    with np.load(am_db + '.npz') as npz:
        payload = {k: npz[k] for k in npz.files}
    bad = str(tmp_path / 'bad.npz')
    np.savez(bad, **dict(payload, state_o=payload['state_o'][:, :5]))
    with pytest.raises(SystemExit, match='obs params'):
        trun.main(CPU + ['--sampler', 'nuts', '--init', bad, '--new', '1',
                         '10', db] + TINY)


def _store_with(tmp_path, store, name, meta, **extras):
    """A copy of the AM store with tempering or SMC extras and a meta."""
    db, _ = store
    with np.load(db + '.npz') as npz:
        payload = {k: npz[k] for k in npz.files}
    path = str(tmp_path / name)
    np.savez(path + '.npz', **payload,
             **{'x_' + k: v for k, v in extras.items()})
    with open(path + '.meta.json', 'w') as fh:
        json.dump(meta, fh)
    return path


@pytest.mark.parametrize('case', ['pt', 'pt_interrupted', 'pt_geometric',
                                  'smc', 'smc_partial'])
def test_analyze_evidence_entry(case, store, tmp_path, monkeypatch, capsys):
    # [e] reads a PT store's (T, steps) log likelihoods through
    # tempering.log_evidence and an SMC store's logZ path, as the JAX menu
    # does (parasitoids_tpu/bayes/run.py:1032-1063), and prints the same
    from parasitoids_tpu.bayes.tempering import log_evidence
    rng = np.random.default_rng(0)
    lls = np.stack([rng.normal(mu, 1.0, 12) for mu in (-2.0, -5.0, -9.0)])
    if case.startswith('pt'):
        betas = (np.array([1.0, 0.3, 0.1], np.float32)
                 if case == 'pt_geometric'
                 else np.array([1.0, 0.3, 0.0], np.float32))
        meta = {'sampler': 'pt', 'burn': 4,
                'n_samples': 20 if case == 'pt_interrupted' else 8}
        path = _store_with(tmp_path, store, case, meta, betas=betas,
                           loglik=lls)
    else:
        meta = {'sampler': 'smc',
                'beta': 0.25 if case == 'smc_partial' else 1.0}
        path = _store_with(tmp_path, store, case, meta,
                           logz_path=np.array([0.0, -3.5, -7.25]),
                           betas=np.array([0.0, 0.1, 0.25]))
    monkeypatch.setattr('sys.stdin', io.StringIO('e\nq\n'))
    trun.main(['--analyze', path])
    out = capsys.readouterr().out
    assert '[e] log-evidence' in out
    if case.startswith('pt'):
        ev = log_evidence(betas, lls, burn=4)
        assert 'log Z (thermodynamic integration): {:.2f}'.format(
            ev['ti']) in out
        assert 'log Z (stepping-stone):            {:.2f}'.format(
            ev['ss']) in out
        assert ('run interrupted' in out) == (case == 'pt_interrupted')
        assert ('does not reach beta=0' in out) == (case == 'pt_geometric')
    else:
        assert 'log Z (SMC): -7.25' in out
        assert ('PARTIAL: anneal stopped at beta = 0.250' in out) == (
            case == 'smc_partial')


def test_analyze_offers_no_evidence_for_a_vi_store(store, tmp_path,
                                                   monkeypatch, capsys):
    # a VI store holds neither a (T, steps) loglik nor a logZ path: no [e],
    # as in the JAX menu
    path = _store_with(tmp_path, store, 'vi', {'sampler': 'vi'},
                       mu=np.zeros(24), log_diag=np.zeros(24),
                       logw=np.zeros(8))
    monkeypatch.setattr('sys.stdin', io.StringIO('e\nq\n'))
    trun.main(['--analyze', path])
    out = capsys.readouterr().out
    assert '[e] log-evidence' not in out and "unrecognized option 'e'" in out

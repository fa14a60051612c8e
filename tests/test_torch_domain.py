"""Port parity of the minute-sharded forward (parallel/domain.py) at the
small MAP configuration (3 days, 10 km / 50 cells, interp 2, K 6, Kl 3).

The port's mesh names the CPU eight (or seven) times; JAX's is conftest's
eight virtual CPU devices.  The sharded kernels and their gradient are
held to the port's unsharded builder and to JAX's sharded one at the
tolerances of tests/test_domain.py (kernels atol 2e-6, losses 1e-6,
gradients rtol 5e-4 / atol 1e-6), and a ``with_forward_mesh`` setup's
projections and log posterior to JAX's ``with_forward_mesh`` at those of
test_torch_map.py.  Two sharded runs give the same bits.

One kernel cell of this configuration lies at the 1e-8 sparsity
threshold of ``finish_day``: the port puts 9.9e-9 there and JAX's XLA
path 1.02e-8.  Both take Genz's node count by |ρ| (JAX's
``bvn_cell_masses`` ignores ``G``), so the gap is the order of their f32
arithmetic, and the unsharded builders already disagree by the
renormalized mass there.  The JAX
comparison holds the sharded kernels to 2e-6 everywhere else and asks
that sharding move no other cell across."""

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_parity import MAP_SMALL, exact_support_mask, torch

from parasitoids_tpu.bayes import priors as jp
from parasitoids_tpu.bayes.model import BayesSetup as JaxSetup
from parasitoids_tpu.bayes.sampler import _as_obs as jax_as_obs
from parasitoids_tpu.parallel import domain as jdom
from parasitoids_tpu_torch.bayes import map_fit as tm
from parasitoids_tpu_torch.bayes import priors as tp
from parasitoids_tpu_torch.bayes.model import BayesSetup, _as_model, _as_obs
from parasitoids_tpu_torch.models.forward import (build_all_kernels,
                                                  setup_from_numpy)
from parasitoids_tpu_torch.parallel import domain as tdom

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')


@pytest.fixture(scope='module')
def setups():
    """Both packages' setups (the port's built from JAX's arrays) and the
    port's in f64 for the held-out mask."""
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


def _theta(params, sig_x=None, mu_r=None):
    p = params
    hp = tuple(np.float32(v) for v in (p.lam, *p.g_params, *p.f_params))
    Dp = tuple(np.float32(v) for v in p.Dparams)
    if sig_x is not None:
        Dp = (sig_x,) + Dp[1:]
    return (hp, Dp, tuple(np.float32(v) for v in p.Dlparams),
            np.float32(p.mu_r) if mu_r is None else mu_r,
            int(p.n_periods))


def _port(fs, mesh, *theta):
    args = (fs.wind_flat, fs.wind_cumsum, *theta, fs.rad_dist, fs.start_idx,
            fs.kcfg, fs.ndays)
    if mesh is None:
        return build_all_kernels(*args)
    return tdom.build_all_kernels_sharded(mesh, *args)


def _jax_unsharded(js, hp, Dp, Dlp, mu_r, n_per):
    from parasitoids_tpu.models.forward import build_all_kernels as jbuild
    s = js.setup
    return jbuild(
        s.wind_flat, s.wind_cumsum, tuple(map(jnp.float32, hp)),
        tuple(map(jnp.float32, Dp)), tuple(map(jnp.float32, Dlp)),
        jnp.float32(mu_r), jnp.int32(n_per), s.rad_dist, s.start_idx,
        s.kcfg, s.ndays)


def _jax(js, mesh, hp, Dp, Dlp, mu_r, n_per):
    s = js.setup
    return jdom.build_all_kernels_sharded(
        mesh, s.wind_flat, s.wind_cumsum, tuple(map(jnp.float32, hp)),
        tuple(map(jnp.float32, Dp)), tuple(map(jnp.float32, Dlp)),
        jnp.float32(mu_r), jnp.int32(n_per), s.rad_dist, s.start_idx,
        s.kcfg, s.ndays)


@pytest.mark.parametrize('n_dev', [8, 7])
def test_sharded_kernels_match_unsharded_and_jax(setups, n_dev):
    # 96 minutes a day: 8 shards of 12, or 7 of 14 with two padded minutes
    js, ts, _ = setups
    fs = ts.setup
    theta = _theta(ts.params)
    mesh = tdom.minute_mesh(devices=['cpu'] * n_dev)
    assert mesh.size == n_dev and mesh.shape == {'minutes': n_dev}
    assert mesh.devices == (torch.device('cpu'),) * n_dev
    ref, ref_loss = _port(fs, None, *theta)
    got, got_loss = _port(fs, mesh, *theta)
    again, again_loss = _port(fs, mesh, *theta)
    assert torch.equal(got, again) and torch.equal(got_loss, again_loss)
    assert got.shape == ref.shape == (3, 101, 101)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-6)
    np.testing.assert_allclose(got_loss.numpy(), ref_loss.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy().sum(axis=(1, 2)), 1.0,
                               atol=1e-4)
    want, want_loss = _jax(js, jdom.minute_mesh(n_devices=n_dev), *theta)
    want_ref, _ = _jax_unsharded(js, *theta)
    flips = np.abs(ref.numpy() - np.asarray(want_ref)) > 2e-6
    assert flips.sum() <= 1
    np.testing.assert_array_equal(
        np.abs(got.numpy() - np.asarray(want)) > 2e-6, flips)
    np.testing.assert_allclose(got.numpy()[~flips], np.asarray(want)[~flips],
                               atol=2e-6)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               atol=1e-6)


def test_sharded_gradients_match(setups):
    # d(kernel row moment)/d(sig_x, mu_r) through the shards' backward and
    # the copies to the lead device (the property NUTS and MAP rely on);
    # against JAX on days 0 and 1, where the packages' unsharded kernels
    # agree to 1e-8 (day 2 holds the threshold cell of the docstring)
    import jax
    js, ts, _ = setups
    fs = ts.setup
    mesh = tdom.minute_mesh(devices=['cpu'] * 8)
    hp, Dp, Dlp, mu_r, n_per = _theta(ts.params)
    row_w = torch.arange(101, dtype=torch.float32)

    def port_grad(m, days):
        sx = torch.tensor(Dp[0]).requires_grad_()
        mu = torch.tensor(mu_r).requires_grad_()
        k, _ = _port(fs, m, hp, (sx, Dp[1], Dp[2]), Dlp, mu, n_per)
        torch.sum(k[:days] * row_w[None, :, None]).backward()
        return np.array([float(sx.grad), float(mu.grad)])

    np.testing.assert_allclose(port_grad(mesh, 3), port_grad(None, 3),
                               rtol=5e-4, atol=1e-6)
    jmesh = jdom.minute_mesh()

    def jax_moment(sx, mu):
        k, _ = _jax(js, jmesh, hp, (sx, Dp[1], Dp[2]), Dlp, mu, n_per)
        w = jnp.arange(101, dtype=jnp.float32)[None, :, None]
        return jnp.sum(k[:2] * w)

    want = np.asarray(jax.grad(jax_moment, argnums=(0, 1))(
        jnp.float32(Dp[0]), jnp.float32(mu_r)))
    np.testing.assert_allclose(port_grad(mesh, 2), want, rtol=5e-4,
                               atol=1e-6)


def test_forward_mesh_posterior_matches_jax(setups):
    # a with_forward_mesh setup: its projections against the unsharded
    # port's and JAX's with_forward_mesh, and the log posterior on the
    # scored observations (exact_support_mask) against JAX's
    js, ts, ts64 = setups
    z0 = tm.initial_z(ts, False)
    keep = exact_support_mask(ts64, z0, False)
    tmesh = ts.with_held_out(keep).with_forward_mesh(
        tdom.minute_mesh(devices=['cpu'] * 8))
    jmesh = js.with_held_out(keep).with_forward_mesh(jdom.minute_mesh())
    assert tmesh.forward_mesh.size == 8
    m0 = tp.initial_model_params().astype(np.float32)
    _, constrain, _ = tm._make_objective(ts, False)
    _, o_vec, _ = constrain(z0)
    with torch.no_grad():
        got = tmesh.forward_projections(_as_model(torch.from_numpy(m0)))
        ref = ts.forward_projections(_as_model(torch.from_numpy(m0)))
        lp = float(tmesh.log_posterior(_as_model(torch.from_numpy(m0)),
                                       _as_obs(o_vec, ts.n_sent)))
    want = jmesh.forward_projections(jp.ModelParams(*jnp.asarray(m0)))
    flat = lambda p: np.concatenate([np.ravel(np.asarray(x))
                                     for x in (*p[0], *p[1], p[2])])
    gflat = flat([[x.numpy() for x in got[0]], [x.numpy() for x in got[1]],
                  got[2].numpy()])
    peak = np.abs(flat(want)).max()
    np.testing.assert_allclose(gflat, flat([[x.numpy() for x in ref[0]],
                                            [x.numpy() for x in ref[1]],
                                            ref[2].numpy()]),
                               atol=1e-6 * peak)
    np.testing.assert_allclose(gflat, flat(want), rtol=1e-4,
                               atol=1e-6 * peak)
    jlp = float(jmesh.log_posterior(
        jp.ModelParams(*jnp.asarray(m0)),
        jax_as_obs(jnp.asarray(o_vec.numpy()), js.n_sent)))
    assert np.isfinite(lp)
    np.testing.assert_allclose(lp, jlp, rtol=1e-5)


def test_forward_mesh_copies_and_refusals(setups):
    # every copy carries the mesh, the batched one too; a mesh led by
    # another device, a move of the setup off its lead device and a mesh
    # that names a card torch does not see are refused
    _, ts, _ = setups
    mesh = tdom.minute_mesh(devices=['cpu'] * 2)
    sm = ts.with_forward_mesh(mesh)
    assert ts.forward_mesh is None and sm.forward_mesh is mesh
    assert sm.with_held_out(np.ones(sum(
        int(np.prod(a.shape)) for a in (*ts.obs_release, *ts.obs_sentinel,
                                        ts.obs_grid)), bool)
    ).forward_mesh is mesh
    twin = tm.plain_twin(sm, torch.float64)
    assert twin.forward_mesh is mesh and twin.setup.wind_flat.dtype == \
        torch.float64
    assert sm.with_forward_mesh(None).forward_mesh is None
    assert sm.with_batched_bvn().forward_mesh is mesh
    assert ts.with_batched_bvn().with_forward_mesh(mesh).forward_mesh is mesh
    with pytest.raises(ValueError, match='lead'):
        ts.with_forward_mesh(tdom.minute_mesh(devices=['meta']))
    with pytest.raises(ValueError, match='forward mesh'):
        sm.on_device('meta')
    with pytest.raises(RuntimeError, match='CUDA'):
        tdom.minute_mesh(devices=['cuda', 'cuda'])


def test_batched_forward_on_a_minute_mesh(setups):
    # the particle-batched forward (three particles, each its Genz tier)
    # with every shard's minutes of every particle in one batched
    # accumulate: within test_domain.py's 2e-6 of the unsharded batched
    # kernels, and the projections of a batched copy of a forward-mesh
    # setup those of the unsharded batched copy to f32 summation order
    from parasitoids_tpu_torch.models.forward import build_all_kernels_batched
    _, ts, _ = setups
    fs = ts.setup
    m = torch.from_numpy(np.tile(tp.initial_model_params().astype(
        np.float32), (3, 1)))
    m[:, 6] += torch.tensor([0.0, 30.0, -20.0])
    mm = _as_model(m)
    n_per = torch.round(mm.n_periods).to(torch.int64)
    args = (fs.wind_flat, fs.wind_cumsum, mm.hparams(), mm.Dparams(),
            mm.Dlparams(), mm.mu_r, n_per, fs.rad_dist, fs.start_idx,
            fs.kcfg, fs.ndays)
    mesh = tdom.minute_mesh(devices=['cpu'] * 7)
    ref, ref_loss = build_all_kernels_batched(*args)
    got, got_loss = tdom.build_all_kernels_batched_sharded(mesh, *args)
    assert got.shape == ref.shape == (3, 3, 101, 101)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-6)
    np.testing.assert_allclose(got_loss.numpy(), ref_loss.numpy(),
                               atol=1e-6)
    with torch.no_grad():
        pb = ts.with_forward_mesh(mesh).with_batched_bvn(
        ).forward_projections(mm)
        pr = ts.with_batched_bvn().forward_projections(mm)
    # cells whose expected count is f32 FFT roundoff of the propagation
    # carry noise of about 1e-8 of the largest projection (test_domain.py
    # holds the JAX builders to 1e-6 of it)
    got = (*pb[0], *pb[1], pb[2])
    want = (*pr[0], *pr[1], pr[2])
    peak = max(float(b.abs().max()) for b in want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * peak)

"""Shared helpers of the PyTorch port's parity tests.

Each test feeds the same numpy inputs, made from a seed, to a JAX function
and to its port, and holds the pair to a stated tolerance.  JAX stays on
the CPU (conftest pins it); torch runs two threads per worker because the
suite runs under ``pytest -n 6``.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(2)

# take-off parameters of the JAX kernel tests (lam, aw, bw, a1, b1, a2, b2)
HPARAMS = (1.0, 1.8, 6.0, 7.0, 2.0, 19.0, 2.0)

_WIND = {}


def wind(interp=2, site='data/kalbar', start='00:00'):
    """(flat f32, prefix sum f32, T) of a site's packed wind, numpy; the
    port's prefix sum (``wind_prefix_sum``), fed to both packages."""
    key = (interp, site, start)
    if key not in _WIND:
        from parasitoids_tpu_torch.io import get_wind_data, pack_wind
        from parasitoids_tpu_torch.models.forward import wind_prefix_sum
        wind_data, days = get_wind_data(site, interp, start)
        packed = pack_wind(wind_data, days, ndays=len(days))
        flat = np.asarray(packed.reshape(-1, 2), np.float32)
        _WIND[key] = (flat, wind_prefix_sum(flat), packed.shape[1])
    return _WIND[key]


def t32(a):
    """numpy -> f32 (or int32) CPU tensor, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where torch sees none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (run on the card: '
                    'pytest -m cuda tests/test_torch_cuda.py)')
    return torch.device('cuda', 0)


# the small MAP configuration of test_bayes_units.py:150-161
MAP_SMALL = ('ndays=3', 'domain_info=(10000.0,50)', 'interp_num=2',
             'kernel_rad=6', 'kernel_rad_local=3')


def exact_support_mask(setup64, z, use_sprd):
    """Observations to score in a parity test at the point ``z``: a zero
    count, or an expected count that is positive in f64 (with and without
    the pre-spread day); flat in ``pointwise_loglik`` order.  At the small
    MAP configuration many projections are exactly 0 in f64 but f32 FFT
    roundoff of ~1e-5 in both packages (different roundoff in each); a
    positive count over such a rate makes its log-pmf, and its gradient,
    roundoff.  The parity tests hold those observations out
    (``with_held_out``)."""
    from parasitoids_tpu_torch.bayes import map_fit
    from parasitoids_tpu_torch.bayes.model import _as_model
    _, constrain, _ = map_fit._make_objective(setup64, use_sprd)
    m_vec, _, sprd = constrain(torch.as_tensor(np.asarray(z),
                                               dtype=torch.float64))
    data = (*setup64.obs_release, *setup64.obs_sentinel, setup64.obs_grid)
    positive = None
    for s in ((None, sprd) if use_sprd else (None,)):
        rel, sent, grid = setup64.forward_projections(_as_model(m_vec), s)
        pos = torch.cat([p.reshape(-1) for p in (*rel, *sent, grid)]) > 0
        positive = pos if positive is None else positive & pos
    zero = torch.cat([d.reshape(-1) for d in data]) == 0
    return (zero | positive).numpy()


def support_mask_at(setup64, m_vecs):
    """:func:`exact_support_mask` for packed model blocks (no pre-spread
    day): a zero count, or an expected count that is positive in f64 at
    every block of ``m_vecs``."""
    from parasitoids_tpu_torch.bayes.model import _as_model
    data = (*setup64.obs_release, *setup64.obs_sentinel, setup64.obs_grid)
    keep = torch.cat([d.reshape(-1) for d in data]) == 0
    positive = torch.ones_like(keep)
    for m_vec in m_vecs:
        rel, sent, grid = setup64.forward_projections(_as_model(
            torch.as_tensor(np.asarray(m_vec), dtype=torch.float64)))
        positive &= torch.cat([p.reshape(-1)
                               for p in (*rel, *sent, grid)]) > 0
    return (keep | positive).numpy()


# the fields of a chain state that two packages can be compared on (the
# random key and the cached projections are each package's own)
CHAIN_FIELDS = ('m', 'o', 'loglik', 'prior_m', 'prior_o', 'count', 'mean',
                'm2', 'accepts_m', 'accepts_o', 'log_scale')


def chain_state_arrays(state):
    """``CHAIN_FIELDS`` of either package's ``ChainState`` as numpy."""
    return {f: np.asarray(getattr(state, f)) for f in CHAIN_FIELDS}


def port_chain_state(arrays, setup, gen=None):
    """The port's ``ChainState`` on ``setup``'s device from the
    ``CHAIN_FIELDS`` arrays of a JAX one (``chain_state_arrays``), with
    the projections recomputed by the port's forward and ``gen`` as its
    generator."""
    from parasitoids_tpu_torch.bayes.model import _as_model
    from parasitoids_tpu_torch.bayes.sampler import ChainState
    dtype = setup.setup.wind_flat.dtype
    dev = setup.setup.wind_flat.device
    kw = {f: torch.as_tensor(np.asarray(arrays[f]), dtype=dtype).to(dev)
          for f in CHAIN_FIELDS}
    with torch.no_grad():
        proj = setup.forward_projections(_as_model(kw['m']))
    return ChainState(proj=proj, key=gen, **kw)

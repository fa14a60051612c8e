"""Bayesian model assembly: the log posterior over the full forward
simulation, PyTorch port of ``parasitoids_tpu/bayes/model.py`` (reference
PyMC graph, Bayes_Run.py:199-473).

* :meth:`BayesSetup.forward_projections` — the reference's ``pop_model``
  deterministic: the forward population simulation plus the observation
  projections, re-run for every model-parameter block;
* :meth:`BayesSetup.log_likelihood` — the thinned-Poisson observation
  model (Bayes_Run.py:344-433), or its negative-binomial and
  zero-inflated variants;
* :meth:`BayesSetup.log_posterior` — priors plus likelihood, −inf
  outside the prior's support without running the forward model.

Everything is plain torch on the setup's device and differentiable with
autograd: on CUDA the day loop goes through the hand-written day kernel
and its backward (``ops/day_kernel.py``), and the graph keeps only the
per-minute inputs of each day, so no per-day checkpoint is needed (the
JAX model needs ``jax.checkpoint`` because its XLA path stores the
per-minute lattices).  On the card the evaluation after its host read
replays a captured CUDA graph, gradient included (``utils/graphs.py``,
the counterpart of the JAX model's ``jit``).  The optional Kalbar
pre-wind spread day
(``sprd_factor``, Bayes_Run.py:241-267 and Bayes_MAP.py:200-277)
prepends a mixture of drifted flight spread and local spread.
"""

from __future__ import annotations

import copy
import math
import weakref
from functools import lru_cache, partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.special import gammaln, xlogy

from ..config import Params
from ..device import scalar
from ..io.locinfo import LocInfo
from ..models.forward import (ForwardSetup, build_all_kernels,
                              build_all_kernels_batched,
                              prior_coverage_windows, setup_forward)
from ..models.observe import ObservationOps
from ..models.solver import propagate_pop
from ..ops.bvn import bvn_cell_masses, bvn_cell_masses_batched, genz_branch
from ..utils import graphs, trace
from .priors import ModelParams, ObsParams, log_prior_model, log_prior_obs

__all__ = ['BayesSetup', 'poisson_logpmf', 'poisson_loglik',
           'negbin_logpmf', 'zip_logpmf', 'prior_coverage_windows']

_N_MODEL = 15
_RATE_FLOOR = 1e-12

# evaluations of ``log_posterior`` that returned −inf without running the
# forward because the prior was not finite; a run reads it beside
# ``ops.day_kernel.LAUNCHES`` to account for every launch
SKIPPED_FORWARDS = 0

# each setup's copies on other devices (``BayesSetup.on_device``), kept
# while the setup lives
_ON_DEVICE = weakref.WeakKeyDictionary()


def poisson_logpmf(obs, rate):
    """Elementwise Poisson log-pmfs.  Rates are floored at 1e-12: a zero
    rate under a positive count would give an infinite value and a NaN or
    infinite gradient; the floor keeps a steep finite penalty (about −27.6
    per observed count) and finite gradients."""
    safe_rate = torch.clamp(rate, min=_RATE_FLOOR)
    ll = torch.where(obs > 0, xlogy(obs, safe_rate),
                     torch.zeros_like(safe_rate))
    return ll - rate - gammaln(obs + 1.0)


def poisson_loglik(obs, rate):
    """Sum of independent Poisson log-pmfs (see :func:`poisson_logpmf`)."""
    return torch.sum(poisson_logpmf(obs, rate))


def negbin_logpmf(obs, rate, r):
    """Negative-binomial log-pmfs, mean ``rate`` and dispersion ``r``
    (var = rate + rate²/r), with the 1e-12 rate floor."""
    mu = torch.clamp(rate, min=_RATE_FLOOR)
    lograte = torch.log(r + mu)
    return (gammaln(obs + r) - gammaln(r) - gammaln(obs + 1.0)
            + r * (torch.log(r) - lograte)
            + torch.where(obs > 0, obs * (torch.log(mu) - lograte),
                          torch.zeros_like(mu)))


def zip_logpmf(obs, rate, pi):
    """Zero-inflated-Poisson log-pmfs: with probability ``pi`` the count is
    a structural zero, else Poisson(rate)."""
    pi = torch.clamp(pi, 1e-7, 1.0 - 1e-7)
    lp0 = torch.logaddexp(torch.log(pi),
                          torch.log1p(-pi) + poisson_logpmf(
                              torch.zeros_like(obs), rate))
    lpk = torch.log1p(-pi) + poisson_logpmf(obs, rate)
    return torch.where(obs > 0, lpk, lp0)


def _as_model(vec) -> ModelParams:
    """A packed 15-vector as :class:`ModelParams` of 0-d tensors; an
    ``(N, 15)`` matrix gives ``(N,)`` tensors, one value per particle."""
    return ModelParams(*[vec[..., i] for i in range(_N_MODEL)])


def _as_obs(vec, n_sent) -> ObsParams:
    """A packed obs vector as :class:`ObsParams`; a variant's vector carries
    one extra trailing slot (the NB dispersion or ZIP probability).  An
    ``(N, n_obs)`` matrix gives a leading particle axis on every field."""
    od = vec[..., 4 + n_sent] if vec.shape[-1] > 4 + n_sent else 0.0
    return ObsParams(vec[..., 0], vec[..., 1], vec[..., 2], vec[..., 3],
                     vec[..., 4:4 + n_sent], od)


def _per(v):
    """An observation parameter shaped to broadcast against a particle's
    ``(rows, cols)`` block: ``(N,)`` becomes ``(N, 1, 1)``; a 0-d tensor
    or a number stays as it is."""
    return v[..., None, None] if torch.is_tensor(v) and v.ndim else v


def _moved(x, device):
    """``x`` with every tensor on ``device``: tuples, lists, NamedTuples
    and the observation operators mapped, anything else kept."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        vals = [_moved(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, '_fields') else type(x)(vals)
    if isinstance(x, ObservationOps):
        new = copy.copy(x)
        for k, v in vars(x).items():
            setattr(new, k, _moved(v, device))
        return new
    return x


@lru_cache(maxsize=None)
def _pre_spread_constants(res, c, dtype, device):
    """The pre-spread day's constants for cell side ``res`` and centre
    cell ``c``, made once per setup and device (a host-to-card copy inside
    an evaluation would wait for the card, and cannot be captured): the
    drift's whole-cell offsets (x, y) on the host, its sub-cell remainder
    (m) and the centre index on ``device``."""
    drift = np.array([-25.0, 15.0])
    dint = np.floor(drift / res).astype(int)        # cell offsets (x, y)
    drem = drift - dint * res                        # sub-cell remainder
    return (tuple(int(v) for v in dint),
            torch.as_tensor(drem, dtype=dtype, device=device),
            torch.tensor([c], device=device))


def _kalbar_default_params():
    params = Params()
    params.cmd_line_chg(['--kalbar'])
    params.PLOT = False
    params.OUTPUT = False
    params.PROB_MODEL = False
    params.domain_info = (10000.0, 400)  # Bayes_Run.py:91
    return params


class BayesSetup:
    """Everything needed to evaluate the posterior for one site and domain.

    Args:
        params: run parameters; default the Kalbar population model at
            801² cells of 25 m.  Unset kernel windows take the prior-coverage
            widths.
        sprd_factor: None, or a fixed or initial pre-spread factor.
        dtype, device: of the forward setup (defaults: f32, or f64 under
            ``params.use_f64``; CUDA unless ``device='cpu'`` is given, and
            no CPU fallback).
        forward_setup: a ready :class:`ForwardSetup`, for example from
            ``setup_from_numpy`` of another package's setup arrays, used
            instead of loading the wind again.
    """

    def __init__(self, params: Params | None = None, sprd_factor=None,
                 dtype=None, device=None,
                 forward_setup: ForwardSetup | None = None):
        if params is None:
            params = _kalbar_default_params()
        self.params = params
        self.sprd_factor = sprd_factor
        self.obs_model = getattr(params, 'obs_model', 'poisson')
        self.n_extra_obs = 0 if self.obs_model == 'poisson' else 1
        # optional per-observation 0/1 weights (rel, sent, grid) excluding
        # held-out data from the likelihood (with_held_out)
        self.obs_mask = None
        cell = params.domain_info[0] / params.domain_info[1]
        K, Kl = prior_coverage_windows(cell)
        if params.kernel_rad is None:
            params.kernel_rad = K
        if params.kernel_rad_local is None:
            params.kernel_rad_local = Kl
        self.setup = (forward_setup if forward_setup is not None else
                      setup_forward(params, device=device, dtype=dtype))
        dtype = self.setup.wind_flat.dtype
        device = self.setup.wind_flat.device
        self.locinfo = LocInfo(params.dataset, params.coord,
                               params.domain_info)
        self.ndays = self.setup.ndays
        self.obs_ops = ObservationOps(self.locinfo, params.domain_info,
                                      self.ndays, device, dtype)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        res = params.domain_info[0] / params.domain_info[1]
        cell_area = res * res
        self.cell_res = res
        self.field_areas = dev([self.locinfo.field_sizes[k] * cell_area
                                for k in self.locinfo.sent_ids])
        self.min_field_area = float(
            min(self.locinfo.field_sizes.values()) * cell_area)
        self.n_sent = len(self.locinfo.sent_ids)

        # observed data
        self.obs_sentinel = [dev(a) for a in self.locinfo.sentinel_emerg]
        self.obs_release = [dev(a) for a in self.locinfo.release_emerg]
        self.obs_grid = dev(self.locinfo.grid_obs)
        self.release_effort = [dev(a)
                               for a in self.locinfo.release_collection]
        self.grid_samples = dev(self.locinfo.grid_samples)

        self.dist_weights = dev(self.setup.dist_weights)
        self.r_dur = int(params.r_dur)
        self.r_number = float(params.r_number)
        # captured CUDA graphs of the evaluation (utils/graphs.py), shared
        # by the shallow copies, whose forward is this one's
        self.graphs = graphs.GraphCache()

    # ------------------------------------------------------------------
    def _check_obs(self, rel, sent, grid):
        for got, ref, name in (
                (rel, self.obs_release, 'release'),
                (sent, self.obs_sentinel, 'sentinel'),
                ([grid], [self.obs_grid], 'grid')):
            if len(got) != len(ref) or any(
                    g.shape != r.shape for g, r in zip(got, ref)):
                raise ValueError('observation shapes for {!r} do not match '
                                 'this setup'.format(name))

    def _obs_tensors(self, obs):
        dtype, device = self.obs_grid.dtype, self.obs_grid.device

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        rel = tuple(dev(a) for a in obs['release'])
        sent = tuple(dev(a) for a in obs['sentinel'])
        grid = dev(obs['grid'])
        self._check_obs(rel, sent, grid)
        return rel, sent, grid

    def with_observations(self, obs):
        """Shallow copy of this setup with the observed data replaced (same
        shapes): every precomputation is shared."""
        new = copy.copy(self)
        rel, sent, grid = self._obs_tensors(obs)
        new.obs_release, new.obs_sentinel, new.obs_grid = (list(rel),
                                                           list(sent), grid)
        return new

    def obs_pytree(self, obs):
        """Validate an observation dict (``release``, ``sentinel``,
        ``grid``) against this setup's shapes and return it as the
        ``(rel, sent, grid)`` structure that ``log_likelihood`` and
        ``log_posterior`` take as their ``obs`` argument."""
        return self._obs_tensors(obs)

    def split_point_mask(self, keep_flat):
        """Reshape a flat boolean vector over the pointwise columns (in
        ``pointwise_loglik`` order: release blocks row-major, sentinel
        blocks, grid) into the ``(rel, sent, grid)`` 0/1 weights that
        ``log_likelihood`` takes as ``obs_mask``."""
        keep_flat = np.asarray(keep_flat, bool)
        dtype, device = self.obs_grid.dtype, self.obs_grid.device
        pos = 0
        out = []
        for group in (self.obs_release, self.obs_sentinel, [self.obs_grid]):
            masks = []
            for data in group:
                n = int(np.prod(data.shape))
                masks.append(torch.as_tensor(
                    keep_flat[pos:pos + n].reshape(tuple(data.shape)),
                    dtype=dtype, device=device))
                pos += n
            out.append(masks)
        if pos != keep_flat.shape[0]:
            raise ValueError('keep_flat has {} entries; expected {}'.format(
                keep_flat.shape[0], pos))
        return tuple(out[0]), tuple(out[1]), out[2][0]

    def with_held_out(self, keep_flat):
        """Shallow copy whose ``log_likelihood`` scores only the
        observations where ``keep_flat`` is True (the refit target of
        leave-one-group-out cross-validation)."""
        new = copy.copy(self)
        new.obs_mask = self.split_point_mask(keep_flat)
        return new

    def on_device(self, device):
        """This setup with every tensor on ``device``: itself where it
        lies there already, else a copy made once and kept while this
        setup lives.  A chain, replica, particle or member sharded onto a
        device evaluates its posterior through the copy there."""
        device = torch.device(device)
        if device == self.setup.wind_flat.device:
            return self
        copies = _ON_DEVICE.setdefault(self, {})
        if device not in copies:
            new = copy.copy(self)
            for k, v in vars(self).items():
                setattr(new, k, _moved(v, device))
            copies[device] = new
        return copies[device]

    def with_batched_bvn(self):
        """Shallow copy whose forward simulations take N parameter sets at
        once (the JAX method's ``kcfg._replace(batched_bvn=True)``; each
        particle's day accumulate takes its own Genz tier, the local and
        pre-spread blocks the select node rule): on the card one launch of
        the particle-batched day kernel a day for the whole population, so
        no host read of any ρ (``forward_projections``)."""
        new = copy.copy(self)
        new.setup = self.setup._replace(
            kcfg=self.setup.kcfg._replace(batched_bvn=True))
        return new

    # ------------------------------------------------------------------
    def _branches(self, m: ModelParams, prior=None, gate=None):
        """The Genz branches (``ops.bvn.genz_branch``) of the flight and
        local |ρ| of ``m``, which pick the node count of every BVN of the
        forward on the host, read from the device in one transfer together
        with ``prior`` and ``gate`` when given.  Returns ``(branches, prior
        value or None)``, and the gate's value after them when a gate is
        given."""
        dtype = self.setup.wind_flat.dtype
        device = self.setup.wind_flat.device
        vals = [scalar(m.corr, dtype, device), scalar(m.corr_l, dtype, device)]
        if prior is not None:
            vals.append(prior.to(dtype))
        if gate is not None:
            vals.append(gate.to(dtype))
        with trace.span('model.host_read'):
            got = torch.stack([v.detach() for v in vals]).tolist()
        out = ((genz_branch(abs(got[0])), genz_branch(abs(got[1]))),
               got[2] if prior is not None else None)
        return out if gate is None else out + (got[-1],)

    def _pre_spread_kernel(self, m: ModelParams, sprd_factor,
                           branches=(None, None)):
        """Kalbar pre-wind local-spread kernel (Bayes_Run.py:243-267):
        ``sprd_factor`` of the population drifts with the flight covariance
        around a fixed mean wind displacement, the rest spreads locally.
        Built out of place, so it is differentiable in every parameter.
        ``branches``: see :meth:`_branches`.  With ``batched_bvn`` the
        parameters may be ``(N,)`` tensors (and ``sprd_factor`` too): the
        select node rule, ``(N, D, D)``."""
        res = self.cell_res
        kcfg = self.setup.kcfg
        dtype = self.setup.wind_flat.dtype
        device = self.setup.wind_flat.device
        D = 2 * kcfg.rad_res + 1
        c = kcfg.rad_res
        dint, drem_t, centre = _pre_spread_constants(res, c, dtype, device)
        K, Kl = kcfg.K, kcfg.K_local
        if kcfg.batched_bvn:
            lead = tuple(torch.as_tensor(m.sig_x).shape)
            long_spread = bvn_cell_masses_batched(
                drem_t.expand(lead + (2,)), m.sig_x, m.sig_y, m.corr, res, K)
            short_spread = bvn_cell_masses_batched(
                torch.zeros(lead + (2,), dtype=dtype, device=device),
                m.sig_xl, m.sig_yl, m.corr_l, res, Kl)
        else:
            long_spread = bvn_cell_masses(drem_t, m.sig_x, m.sig_y, m.corr,
                                          res, K, branches[0])
            short_spread = bvn_cell_masses(
                torch.zeros(2, dtype=dtype, device=device), m.sig_xl,
                m.sig_yl, m.corr_l, res, Kl, branches[1])
        sprd = _per(scalar(sprd_factor, dtype, device))

        def place(block, row, col):
            # a block at (row, col) of a zero D x D field; the start is
            # clamped into range as lax.dynamic_update_slice does
            n = block.shape[-1]
            row, col = (min(max(int(v), 0), D - n) for v in (row, col))
            return F.pad(block, (col, D - col - n, row, D - row - n))

        # rows shift by -y drift, cols by +x drift (screen coordinates)
        field = place(sprd * long_spread, c - int(dint[1]) - K,
                      c + int(dint[0]) - K)
        field = field + place((1.0 - sprd) * short_spread, c - Kl, c - Kl)
        if field.ndim > 2:
            rest = torch.clamp(1.0 - field.sum(dim=(-2, -1)), min=0.0)
            return field + F.pad(rest[:, None, None],
                                 (c, D - c - 1, c, D - c - 1))
        return field.index_put(
            (centre, centre),
            torch.clamp(1.0 - field.sum(), min=0.0).reshape(1),
            accumulate=True)

    def forward_projections(self, m: ModelParams, sprd_factor=None,
                            branches=None):
        """Run the population model for a model-parameter block and project
        to observables (the reference ``pop_model``).  ``n_periods`` is
        rounded to the nearest integer before the forward, as the JAX model
        does: a θ of 29.9999 runs a 30-period window.  ``branches``: from
        :meth:`_branches`, which is called here when they are not given.

        On a :meth:`with_batched_bvn` copy every field of ``m`` is an
        ``(N,)`` tensor (``sprd_factor`` a number or ``(N,)``): N
        parameter sets go through one batched forward, every day one
        launch of the particle-batched kernel on the card, with no host
        read, and each projection gains a leading particle axis.

        On the card with the day kernel, the evaluation after its host
        read replays a captured CUDA graph (``utils/graphs.py``; the first
        evaluation of a key captures it), its gradient too; the CPU and
        the plain, ``ref_trunc`` and f64 paths run
        :meth:`_forward_projections_eager`, which gives the same bits."""
        s = self.setup
        if branches is None and not s.kcfg.batched_bvn:
            branches, _ = self._branches(m)
        if not self._replays_graphs():
            return self._forward_projections_eager(m, sprd_factor, branches)
        return self._forward_projections_graphed(m, sprd_factor, branches)

    def _replays_graphs(self):
        """Whether :meth:`forward_projections` and :meth:`population_fields`
        replay captured graphs: on the card, through the day kernel."""
        k = self.setup.kcfg
        return (self.setup.wind_flat.device.type == 'cuda' and k.pallas and
                not k.ref_trunc)

    def _graph_args(self, m: ModelParams, sprd_factor):
        """The arguments of a graphed evaluation: one stacked parameter
        vector, and ``sprd_factor`` where it is given."""
        dtype, dev = self.setup.wind_flat.dtype, self.setup.wind_flat.device
        args = [torch.stack([scalar(v, dtype, dev) for v in m], dim=-1)]
        if sprd_factor is not None:
            args.append(scalar(sprd_factor, dtype, dev))
        return args

    def _forward_projections_graphed(self, m: ModelParams, sprd_factor=None,
                                     branches=None):
        """:meth:`_forward_projections_eager` as a function of one stacked
        parameter vector (and ``sprd_factor``) through
        ``utils.graphs.evaluate``: a replay of the captured graph of its
        key on the card, the function itself on the CPU.  The key holds
        the Genz branches (one parameter set) or the particle count."""
        args = self._graph_args(m, sprd_factor)
        key = ('batched', args[0].shape[0]) if self.setup.kcfg.batched_bvn \
            else ('single', tuple(branches))

        def fn(vec, sprd=None):
            return self._forward_projections_eager(_as_model(vec), sprd,
                                                   branches)
        return graphs.evaluate(self.graphs, key, fn, args)

    def _forward_projections_eager(self, m: ModelParams, sprd_factor=None,
                                   branches=None):
        """:meth:`forward_projections` run eagerly, launch by launch."""
        if self.setup.kcfg.batched_bvn:
            return self._forward_projections_batched(m, sprd_factor)
        if branches is None:
            branches, _ = self._branches(m)
        return self._project(self._fields_eager(m, sprd_factor, branches))

    def _forward_projections_batched(self, m: ModelParams, sprd_factor):
        return self._project(self._fields_eager(m, sprd_factor))

    def _project(self, fields):
        rel, sent = self.obs_ops.project_emergence(fields)
        grid = self.obs_ops.project_grid(fields)
        return tuple(rel), tuple(sent), grid

    def population_fields(self, m: ModelParams, sprd_factor=None,
                          branches=None, days=None, propagate=None):
        """The ``(ndays, D, D)`` expected population fields of the forward
        for a model-parameter block (what :meth:`forward_projections`
        projects), or only ``days`` of them (0-based), so the full stack
        is never returned.  ``sprd_factor``, ``branches``: as
        :meth:`forward_projections`; a pre-spread day is propagated and
        left out of the fields.  ``propagate``: the propagation,
        ``models.solver.propagate_pop`` unless given.

        On the card with the day kernel (:meth:`_replays_graphs`) the
        fields after the host read replay the captured CUDA graph of key
        ``('fields', branches, days)`` (its first call captures it), and
        each result is a clone that the next replay leaves as it is; the
        CPU and the plain, ``ref_trunc`` and f64 paths run
        :meth:`_fields_eager`, which gives the same bits."""
        if branches is None and not self.setup.kcfg.batched_bvn:
            branches, _ = self._branches(m)
        branches = None if branches is None else tuple(branches)
        days = None if days is None else tuple(int(d) for d in days)
        if not self._replays_graphs():
            return self._fields_eager(m, sprd_factor, branches, days,
                                      propagate)

        def fn(vec, sprd=None):
            return self._fields_eager(_as_model(vec), sprd, branches, days,
                                      propagate)
        return graphs.evaluate(self.graphs, ('fields', branches, days), fn,
                               self._graph_args(m, sprd_factor))

    def _fields_eager(self, m: ModelParams, sprd_factor=None, branches=None,
                      days=None, propagate=None):
        """:meth:`population_fields` run eagerly, launch by launch: the
        day loop, the pre-spread day, the propagation.  On a
        :meth:`with_batched_bvn` copy the fields gain a leading particle
        axis."""
        s = self.setup
        propagate = propagate or propagate_pop
        n_per = torch.round(scalar(m.n_periods, s.wind_flat.dtype,
                                   s.wind_flat.device)).to(torch.int64)
        build = (build_all_kernels_batched if s.kcfg.batched_bvn else
                 partial(build_all_kernels, branches=branches))
        kernels, _ = build(
            s.wind_flat, s.wind_cumsum, m.hparams(), m.Dparams(),
            m.Dlparams(), m.mu_r, n_per, s.rad_dist, s.start_idx, s.kcfg,
            self.ndays)
        if sprd_factor is not None:
            pre = self._pre_spread_kernel(m, sprd_factor, branches)
            kernels = torch.cat([pre.unsqueeze(-3), kernels], dim=-3)
        fields = propagate(kernels, self.r_dur, self.r_number,
                           self.dist_weights, s.scfg)
        if sprd_factor is not None:
            fields = fields[..., 1:, :, :]
        if days is not None:
            # day by day: a list index would copy its indices to the card,
            # which a captured graph cannot hold
            fields = torch.stack([fields[..., d, :, :] for d in days],
                                 dim=-3)
        return fields

    # ------------------------------------------------------------------
    def _obs_logpmf(self, data, rate, o: ObsParams):
        """Per-count observation log-pmf under the configured model."""
        if self.obs_model == 'negbin':
            return negbin_logpmf(data, rate, _per(o.od))
        if self.obs_model == 'zip':
            return zip_logpmf(data, rate, _per(o.od))
        return poisson_logpmf(data, rate)

    def _rates(self, projections, o: ObsParams):
        """Rates of the release blocks, sentinel blocks and grid; with a
        leading particle axis where ``o`` has one."""
        rel, sent, grid = projections
        out = [(_per(o.xi) * model *
                (effort * o.em_obs_prob[..., None])[..., :, None])
               for model, effort in zip(rel, self.release_effort)]
        out += [(_per(o.xi) * model * o.sent_obs_probs[..., :, None])
                for model in sent]
        out.append(_per(o.grid_obs_prob) * self.grid_samples * grid)
        return out

    def log_likelihood(self, projections, o: ObsParams, obs_mask=None,
                       obs=None):
        """Observation log likelihood (Bayes_Run.py:344-433).  ``obs_mask``:
        optional ``(rel, sent, grid)`` 0/1 weights (``split_point_mask``),
        else the setup's own mask (``with_held_out``); ``obs``: optional
        ``(rel, sent, grid)`` observed data (``obs_pytree``) in place of
        the setup's.  Projections and ``o`` with a leading particle axis
        give one log likelihood per particle, ``(N,)``."""
        mask = obs_mask if obs_mask is not None else self.obs_mask
        data_rel, data_sent, data_grid = (
            obs if obs is not None
            else (self.obs_release, self.obs_sentinel, self.obs_grid))
        data = list(data_rel) + list(data_sent) + [data_grid]
        weights = ([None] * len(data) if mask is None else
                   list(mask[0]) + list(mask[1]) + [mask[2]])
        dims = (-2, -1) if torch.is_tensor(o.xi) and o.xi.ndim else None
        lp = 0.0
        for d, rate, w in zip(data, self._rates(projections, o), weights):
            ll = self._obs_logpmf(d, rate, o)
            ll = ll if w is None else ll * w
            lp = lp + (torch.sum(ll) if dims is None else ll.sum(dim=dims))
        return lp

    def pointwise_loglik(self, projections, o: ObsParams):
        """Per-observation log-pmfs as one flat vector (release blocks
        row-major, then sentinel blocks, then the grid counts); its sum is
        ``log_likelihood`` up to summation order."""
        data = list(self.obs_release) + list(self.obs_sentinel) + \
            [self.obs_grid]
        return torch.cat([self._obs_logpmf(d, rate, o).reshape(-1)
                          for d, rate in zip(data,
                                             self._rates(projections, o))])

    def log_posterior(self, m: ModelParams, o: ObsParams, sprd_factor=None,
                      obs=None, gate=None):
        """Full joint log posterior; −inf outside the prior's support
        without running the forward model.  One host read per evaluation
        takes the prior's value, which decides that, and the BVN branches
        of the forward.  ``obs``: optional observed-data structure
        (``obs_pytree``) in place of the setup's.  ``gate``: optional 0-d
        tensor read in the same transfer; where it is 0 nothing more runs
        and None is returned (a sampler's decision whether it needs this
        evaluation at all rides on the evaluation's own read)."""
        global SKIPPED_FORWARDS
        prior = log_prior_model(m) + log_prior_obs(
            o, self.field_areas, self.min_field_area, self.obs_model)
        read = self._branches(m, prior, gate)
        branches, prior_value = read[:2]
        if gate is not None and not read[2]:
            return None
        if not math.isfinite(prior_value):
            SKIPPED_FORWARDS += 1
            return prior + torch.full_like(prior, -math.inf)
        proj = self.forward_projections(m, sprd_factor, branches)
        return prior + self.log_likelihood(proj, o, obs=obs)

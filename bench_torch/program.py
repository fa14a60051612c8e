"""What the runners share about the program under test (the PyTorch port,
``parasitoids_tpu_torch``): building a configuration's setup and holding
it to the configuration file, its counters, and the site's data handed to
the plain reference as numpy arrays."""

from __future__ import annotations

import numpy as np

# a rehearsal's cut of every configuration: 160 m cells, 96 minutes a day,
# small windows and the port's float64 path, so that a CPU runs a cell end
# to end in seconds and a sound run reads float64 rounding alone
REHEARSAL = {'interp_num': 2, 'kernel_rad': 6, 'kernel_rad_local': 3,
             'use_f64': True}


def build_setup(ctx):
    """The Bayes setup of the cell's configuration on the run's device:
    ``bayes/run.build_setup`` with the file's overrides.  Outside a
    rehearsal the setup's sizes must be the file's ``sizes``.  A context
    with a ``shared`` dict (the control study's seeds in one process)
    builds it once."""
    from parasitoids_tpu_torch.bayes.run import build_setup as build
    shared = getattr(ctx, 'shared', None)
    if shared is not None and 'setup' in shared:
        ctx.sizes = shared['sizes']
        return shared['setup']
    over = dict(ctx.config['build']['overrides'])
    if ctx.rehearse is not None:
        over.update(REHEARSAL, domain_info='(4000.0,{})'.format(ctx.rehearse))
    setup = build(['{}={}'.format(k, v) for k, v in over.items()],
                  device=ctx.device)
    got = sizes_of(setup)
    if ctx.rehearse is None and got != ctx.config['sizes']:
        raise RuntimeError('the built setup is not the configuration file: '
                           '{} against {}'.format(got, ctx.config['sizes']))
    ctx.sizes = got
    if shared is not None:
        shared.update(setup=setup, sizes=got)
    return setup


def sizes_of(setup):
    s = setup.setup
    return {'rad_dist': float(s.rad_dist), 'rad_res': int(s.kcfg.rad_res),
            'K': int(s.kcfg.K), 'K_local': int(s.kcfg.K_local),
            'ndays': int(setup.ndays), 'minutes': int(s.kcfg.periods),
            'fft_len': int(s.scfg.fft_len), 'r_dur': int(setup.r_dur),
            'r_number': float(setup.r_number),
            'start_idx': int(s.start_idx),
            'dtype': str(s.wind_flat.dtype).replace('torch.', '')}


def launch_counts():
    """The day kernel's launch counters and the samplers' forward and
    value+gradient counters."""
    from parasitoids_tpu_torch.bayes import model, nuts, sampler
    from parasitoids_tpu_torch.ops import day_kernel
    return {'k1': day_kernel.LAUNCHES, 'k3': day_kernel.LAUNCHES_BWD,
            'batched': day_kernel.LAUNCHES_BATCHED,
            'forwards': sampler.FORWARDS,
            'batched_forwards': sampler.BATCHED_FORWARDS,
            'value_and_grads': nuts.VALUE_AND_GRADS,
            'skipped_forwards': model.SKIPPED_FORWARDS}


def graph_counts(setup):
    caps = setup.graphs.summary()
    return {'graph_keys': [str(c[0][:2]) for c in caps],
            'graph_pool_bytes': int(sum(c[2] for c in caps)),
            'capture_s': [round(c[1], 4) for c in caps]}


# a flight or local |rho| inside each Genz tier (6, 12, 20 nodes, series)
TIER_RHO = (0.1, 0.5, 0.85, 0.95)


def with_tiers(vec, tiers):
    """A copy of a model block whose flight and local correlation slots
    (8 and 11, rho = 2 p - 1) put |rho| in the Genz ``tiers``."""
    out = vec.clone()
    out[8] = (TIER_RHO[tiers[0]] + 1.0) / 2.0
    out[11] = (TIER_RHO[tiers[1]] + 1.0) / 2.0
    return out


def site_data(ctx, setup):
    """The site's data for the reference, as numpy arrays: the wind as the
    port's host reader reads it from ``data/``, the observation counts,
    field cells and dates of its ``LocInfo``, and the run's sizes."""
    from parasitoids_tpu_torch.io import get_wind_data
    p = setup.params
    wind_data, days = get_wind_data(*p.get_wind_params())
    wind = np.stack([np.asarray(wind_data[d])[:, :2] for d in days])
    li = setup.locinfo
    area = setup.cell_res ** 2
    rel_idx = getattr(li, 'release_coll_idx', None) or list(
        range(len(li.release_DataFrames)))
    protocols = getattr(li, 'sent_protocols', None) or \
        ['lab'] * len(li.sent_DataFrames)

    def obs_days(frame):
        return [int(d / np.timedelta64(1, 'D'))
                for d in frame['datePR'].unique()]
    release = [dict(points=np.asarray(li.emerg_grids[i]),
                    days=obs_days(frame),
                    collection=int(li.collection_datesPR[rel_idx[i]].days),
                    protocol=protocols[rel_idx[i]],
                    obs=np.asarray(li.release_emerg[i], np.float64),
                    effort=np.asarray(li.release_collection[i], np.float64))
               for i, frame in enumerate(li.release_DataFrames)]
    sentinel = [dict(days=obs_days(frame),
                     collection=int(li.collection_datesPR[i].days),
                     protocol=protocols[i],
                     obs=np.asarray(li.sentinel_emerg[i], np.float64))
                for i, frame in enumerate(li.sent_DataFrames)]
    grid = dict(cells=np.asarray(li.grid_cells),
                days=[int(d.days) for d in li.grid_obs_datesPR],
                obs=np.asarray(li.grid_obs, np.float64),
                samples=np.asarray(li.grid_samples, np.float64))
    return dict(
        sizes=dict(ctx.sizes), wind=wind, release=release, sentinel=sentinel,
        grid=grid,
        field_cells=[np.asarray(li.field_cells[k]) for k in li.sent_ids],
        field_areas=[li.field_sizes[k] * area for k in li.sent_ids],
        field_areas_all=[v * area for v in li.field_sizes.values()])


def projections_np(proj):
    """A projection tree ``(rel, sent, grid)`` as host float64 arrays."""
    rel, sent, grid = proj
    return ([r.detach().double().cpu().numpy() for r in rel],
            [s.detach().double().cpu().numpy() for s in sent],
            grid.detach().double().cpu().numpy())


def pick(seed, n, k):
    """``k`` of ``range(n)`` drawn from ``seed`` (all where k >= n), in
    order."""
    rng = np.random.default_rng([int(seed), 0x5eed])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def gap(answer, ref):
    """The gap between an answer and the reference as a share of the
    reference: the norm of their difference over the reference's norm
    (both 2-norms over every element)."""
    answer, ref = np.asarray(answer, np.float64), np.asarray(ref, np.float64)
    if not ref.size:
        return 0.0
    scale = np.linalg.norm(ref)
    diff = np.linalg.norm(answer - ref)
    return float(diff / scale) if scale else float(diff)


def flat_projections(proj):
    rel, sent, grid = proj
    return np.concatenate([np.ravel(a) for a in list(rel) + list(sent) +
                           [grid]])


def projection_gap(proj, ref_proj):
    """:func:`gap` of every projection together (release blocks, sentinel
    blocks, grid): an array whose own scale is f32 roundoff of the
    fields weighs no more than its counts."""
    return gap(flat_projections(proj), flat_projections(ref_proj))


class Base:
    """What every runner shares: the setup, the counters, the site's data
    for the reference, and the freeing of the program's state."""

    #: the day-accumulate launches a unit runs ('fwd', 'bwd', 'batched')
    kinds = ()

    def counters(self):
        return dict(launch_counts(), captures=len(self.setup.graphs.entries))

    def program_setup(self):
        return self.setup

    def launch_kinds(self):
        return self.kinds

    def site_data(self):
        return site_data(self.ctx, self.setup)

    def free(self):
        """Drop the program's state (its graphs and pools with it) before
        the reference runs on the same card."""
        import gc
        torch = self.ctx.torch
        for name in list(vars(self)):
            if name != 'ctx':
                delattr(self, name)
        gc.collect()
        if self.ctx.device.type == 'cuda':
            torch.cuda.empty_cache()

    def base_counts(self, forwards_run, units_with_forward):
        """The share of units that ran the forward, and the graph pools."""
        w = self.ctx.window
        out = {'forward_share': (forwards_run / units_with_forward
                                 if units_with_forward else None),
               'window_counters': w['counters']}
        out.update(graph_counts(self.setup))
        return out


def chain_states(setup, states, fresh=None):
    """The answers of chain states ``(m, o, loglik, projections)``: host
    arrays, with the program's per-observation log-pmfs of the cached
    projections (``BayesSetup.pointwise_loglik``).  ``loglik`` is the
    state's own log likelihood, as the chain's step made it.  ``fresh``:
    other projections of the same states to compare (one a state) in
    place of the cached ones."""
    from parasitoids_tpu_torch.bayes.model import _as_obs
    out = []
    for i, (m, o, ll, proj) in enumerate(states):
        pts = setup.pointwise_loglik(proj, _as_obs(o, setup.n_sent))
        shown = proj if fresh is None else fresh[i]
        out.append((m.cpu().double().numpy(), o.cpu().double().numpy(),
                    float(ll), projections_np(shown),
                    pts.detach().cpu().double().numpy()))
    return out


def hold(gaps, ill):
    """The compared numbers of per-answer gaps, every answer held on its
    own.  ``gaps``: ``{name: {source: [gap of each answer]}}``, the
    sources ``''`` (the program), ``'f32'`` (the reference in plain
    float32, TF32 off: the answer's own float32 conditioning) and
    ``'control'``.  ``ill``: ``{name: level}`` from the cell's limits; an
    answer at which the float32 reference's gap exceeds the level is
    ill-conditioned and left out of that number, and counted.

    ``<name>``: the program's worst kept answer (None where none is
    kept); ``<name>.control``: the control's worst kept answer;
    ``<name>.median`` (over every answer; ``.control`` too) is compared
    where the cell's limits name it; ``<name>.excluded`` and
    ``<name>.each`` (every answer's gap by source) are shown."""
    out = {}
    for name, by in gaps.items():
        n = len(by[''])
        level = ill.get(name)
        if level is not None and 'f32' not in by:
            raise RuntimeError('{} leaves out ill-conditioned answers but '
                               'the float32 reference did not run'.format(
                                   name))
        keep = [level is None or by['f32'][i] <= level for i in range(n)]
        for src, xs in by.items():
            kept = [x for x, k in zip(xs, keep) if k]
            key = name + ('.' + src if src else '')
            if src in ('', 'control'):
                out[key] = max(kept) if kept else None
            out[name + '.median' + ('.' + src if src else '')] = float(
                np.median(xs))
        out[name + '.excluded'] = n - sum(keep)
        out[name + '.each'] = [
            {src: by[src][i] for src in by} for i in range(n)]
    return out


def ill_levels(ctx):
    """The cell's levels of ill-conditioning (``hold``), which apply to a
    program that runs in float32; a float64 program (the rehearsal's) is
    held at every answer."""
    return ctx.cell.ill if ctx.sizes['dtype'] == 'float32' else {}


def add_gap(gaps, name, src, value):
    gaps.setdefault(name, {}).setdefault(src, []).append(float(value))


def compare_states(ctx, items, refs):
    """Chain states against the reference at the same model block and
    observation vector, each state on its own (:func:`hold`).

    ``loglik_gap``: the state's own log likelihood (the one its chain's
    accept decisions used) against the reference's, over the observations
    the reference resolves (a zero count, or an expected count that is not
    0 in float64: a positive count over a rate that is 0 in float64 scores
    float32 roundoff in the program).  The program's log-pmfs at the
    observations left out (``unresolved.count``, shown) are taken off its
    log likelihood first.  ``proj_gap``: the :func:`gap` of every
    projection together.  The float32 reference and the control, where
    they ran, sum their own log-pmfs over the same observations."""
    torch = ctx.torch
    gaps, unresolved = {}, 0
    for m, o, ll, proj, pts in items['states']:
        r_pts, keep, r_proj = _log_pmfs(refs['ref'], m, o, torch.float64)
        r_sum = float(r_pts[keep].sum())
        answers = {'': (ll - float(pts[~keep].sum()), proj)}
        for src in ('f32', 'control'):
            if src in refs:
                c_pts, _, c_proj = _log_pmfs(refs[src], m, o, torch.float32)
                answers[src] = (float(c_pts[keep].sum()), c_proj)
        for src, (held, a_proj) in answers.items():
            add_gap(gaps, 'loglik_gap', src, abs(held - r_sum) / abs(r_sum))
            add_gap(gaps, 'proj_gap', src, projection_gap(a_proj, r_proj))
        unresolved = max(unresolved, int((~keep).sum()))
    out = hold(gaps, ill_levels(ctx))
    out.update({'unmoved': items['unmoved'], 'unresolved.count': unresolved})
    return out


def _log_pmfs(post, m, o, dtype):
    import torch

    from bench_torch.reference.model import as_model

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=post.fwd.device)
    with torch.no_grad():
        proj = post.projections(post.fwd.fields(as_model(t(m))))
        pts, keep = post.log_pmfs(proj, t(o))
    return (pts.double().cpu().numpy(), keep.cpu().numpy(),
            projections_np(proj))

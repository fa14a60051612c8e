"""What a traced run (``--trace 1``) reads besides the window: a profile
of a short steady stretch of units, CUDA-event timings of the day
accumulate's public entries on the cell's real day inputs, and the least
work of a unit.  Every function is memoised in the run's context, so the
metric readers that share a reading take it once; each returns None where
it has nothing to read (no card, no such work in the cell)."""

from __future__ import annotations

import time

from bench_torch import roofline

TIMED_REPS = 50
NAME_CHARS = 120                 # a kernel's name in the breakdown, cut


def on_card(ctx):
    return ctx.device.type == 'cuda'


def wall_per_unit(ctx):
    """Unprofiled seconds per unit, from the measured window."""
    w = ctx.window
    return w['seconds'] / w['units'] if w['units'] else None


def profile(ctx, runner):
    return ctx.memo('profile', lambda: _profile(ctx, runner)) \
        if on_card(ctx) else None


def _profile(ctx, runner):
    """Units under ``torch.profiler`` (CPU and CUDA activity) until
    ``trace_units`` have run: device busy seconds (the union of the
    device's operations), host launch calls, the busiest device
    operations and the longest idle gaps by what the host was doing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch = ctx.torch
    want = int(ctx.traffic['trace_units'])
    units = attempts = 0
    ctx.sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        while units < want:
            units += runner.unit()
            attempts += 1
        ctx.sync()
        window_s = time.perf_counter() - tic
    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA)
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in events if e.device_type == DeviceType.CPU and
            not e.name.startswith('Activity Buffer')]
    busy_us, gaps, end = 0.0, [], None
    for s, e, _ in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end, s))
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        over = [h for h in host if h[0] <= mid <= h[1]]
        label = max(over, key=lambda h: h[0])[2] if over else 'host idle'
        idle.append([label[:NAME_CHARS], length * 1e-6])
    by_op = {}
    for s, e, name in dev:
        name = name[:NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    launches = sum(1 for h in host if 'Launch' in h[2])
    return {'units': units, 'attempts': attempts, 'busy_s': busy_us * 1e-6,
            'window_s': window_s, 'launches': launches,
            'breakdown': {'device_ops': [list(kv) for kv in top],
                          'idle_gaps': idle}}


def launches_per(ctx, runner, per='units'):
    """Host CUDA launch calls (kernel and graph launches: the profiler's
    host events whose name holds ``Launch``) per unit, or per attempt
    (``per='attempts'``: a unit() call, such as a move round)."""
    prof = profile(ctx, runner)
    if prof is None or not prof[per]:
        return None
    return prof['launches'] / prof[per]


def event_seconds(ctx, fn, reps=TIMED_REPS):
    """Seconds per call of ``fn`` by CUDA events around ``reps`` calls,
    after two warm-up calls."""
    torch = ctx.torch
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


def day_inputs(ctx, setup, m, day):
    """Per-minute accumulate inputs of ``day`` at the parameters ``m``
    (a ModelParams of 0-d tensors, or of (N,) tensors for N sets), built
    by the program's ``ops/daily_kernel`` outside any graph."""
    from parasitoids_tpu_torch.ops.daily_kernel import day_scatter_inputs
    torch = ctx.torch
    s = setup.setup
    batched = m.sig_x.ndim > 0
    col = (lambda v: v.reshape(-1, 1)) if batched else (lambda v: v)
    n_per = torch.round(m.n_periods).to(torch.int64)
    with torch.no_grad():
        h, mu, idx, clip, _ = day_scatter_inputs(
            s.wind_flat, s.wind_cumsum, day, tuple(col(v) for v in
                                                   m.hparams()),
            col(m.mu_r), col(n_per), s.start_idx if day == 0 else 0, s.kcfg,
            s.rad_dist)
    dp = torch.stack([v.to(torch.float32) for v in m.Dparams()], dim=-1)
    return h, mu, idx, clip, dp


def _geometry(setup):
    s = setup.setup
    K = s.kcfg.K
    return s.rad_dist / s.kcfg.rad_res, K, 2 * s.kcfg.rad_res + 1 + 4 * K


def accum_roofline(ctx, runner, kind, day=9):
    """Share of the roofline of one day's accumulate through its public
    entry (``kind``: 'fwd', 'bwd' or 'batched'), in %, at the cell's
    current parameters; None where the cell's unit runs no such launch."""
    if not on_card(ctx) or kind not in runner.launch_kinds():
        return None
    return ctx.memo(('roofline', kind, day),
                    lambda: _accum_roofline(ctx, runner, kind, day))


def _accum_roofline(ctx, runner, kind, day):
    from parasitoids_tpu_torch.ops import day_kernel
    torch = ctx.torch
    setup = runner.program_setup()
    cell, K, L = _geometry(setup)
    m = runner.current_params(batched=(kind == 'batched'))
    h, mu, idx, clip, dp = day_inputs(ctx, setup, m, day)
    if kind == 'batched':
        consts = day_kernel.pack_constants(dp, cell, ctx.device, select=True)

        def call():
            return day_kernel.accumulate_day_batched(h, mu, idx, clip, dp,
                                                     cell, K, L, consts)
        work = roofline.batched_work(h.cpu(), mu.cpu(), dp.cpu().tolist(),
                                     cell, K, L)
    else:
        dparams = tuple(dp.unbind(-1))
        consts = day_kernel.pack_constants(dparams, cell, ctx.device)
        if kind == 'fwd':
            def call():
                return day_kernel.accumulate_day(h, mu, idx, clip, dparams,
                                                 cell, K, L, consts)
            work = roofline.forward_work(h.cpu(), mu.cpu(), dp.tolist(),
                                         cell, K, L)
        else:
            gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
            ct_buf = torch.randn((L, L), generator=gen, device=ctx.device)
            ct_loss = torch.ones((), device=ctx.device)

            def call():
                return day_kernel.accumulate_day_bwd(
                    ct_buf, ct_loss, h, mu, idx, clip, dparams, cell, K, L,
                    consts)
            work = roofline.backward_work(h.cpu(), mu.cpu(), dp.tolist(),
                                          cell, K, L)
    with torch.no_grad():
        sec = event_seconds(ctx, call)
    least, _ = roofline.least_seconds(*work)
    return 100.0 * least / sec


def propagate_ms(ctx, runner):
    """Milliseconds of ``propagate_pop`` on one evaluation's daily
    kernels at the cell's current parameters (CUDA events)."""
    if not on_card(ctx):
        return None
    return ctx.memo('propagate', lambda: _propagate_ms(ctx, runner))


def _propagate_ms(ctx, runner):
    from parasitoids_tpu_torch.models.forward import build_all_kernels
    from parasitoids_tpu_torch.models.solver import propagate_pop
    torch = ctx.torch
    setup = runner.program_setup()
    s = setup.setup
    m = runner.current_params()
    branches, _ = setup._branches(m)
    with torch.no_grad():
        kernels, _ = build_all_kernels(
            s.wind_flat, s.wind_cumsum, m.hparams(), m.Dparams(),
            m.Dlparams(), m.mu_r, torch.round(m.n_periods).to(torch.int64),
            s.rad_dist, s.start_idx, s.kcfg, setup.ndays, branches)
        return 1e3 * event_seconds(ctx, lambda: propagate_pop(
            kernels, setup.r_dur, setup.r_number, setup.dist_weights,
            s.scfg), reps=10)


def unit_mfu(ctx, runner):
    """Least seconds of a unit's counted work at the peaks over its
    unprofiled wall, in %: every day's accumulates at the current
    parameters (forward, backward and batched, as many as a unit runs)
    and the propagation's transforms."""
    if not on_card(ctx):
        return None
    return ctx.memo('mfu', lambda: _unit_mfu(ctx, runner))


def _unit_mfu(ctx, runner):
    setup = runner.program_setup()
    cell, K, L = _geometry(setup)
    per_unit = runner.work_per_unit()
    exps = fp = nbytes = 0.0
    for kind, n in per_unit.items():
        if kind == 'fft' or not n:
            continue
        m = runner.current_params(batched=(kind == 'batched'))
        for day in range(setup.ndays):
            h, mu, _, _, dp = day_inputs(ctx, setup, m, day)
            if kind == 'batched':
                w = roofline.batched_work(h.cpu(), mu.cpu(),
                                          dp.cpu().tolist(), cell, K, L)
            else:
                count = (roofline.forward_work if kind == 'fwd'
                         else roofline.backward_work)
                w = count(h.cpu(), mu.cpu(), dp.tolist(), cell, K, L)
            exps += n * w[0]
            fp += n * w[1]
            nbytes += n * w[2]
    f_fp, f_bytes = roofline.fft_work(per_unit.get('fft', 0),
                                      setup.setup.scfg.fft_len)
    least, _ = roofline.least_seconds(exps, fp + f_fp, nbytes + f_bytes)
    return 100.0 * least / wall_per_unit(ctx)

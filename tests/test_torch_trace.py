"""The span recorder (``utils/trace.py``) and the spans of the port: off,
a span is the shared null context and records nothing; on, it records
names, parents, threads and requests, self times and a bounded list, and
sits in a CPU ``torch.profiler`` trace by its name.  At 81² in float64
one AM step, one NUTS transition and one forecast member give bitwise
the same outputs and module counters with tracing on and off, and record
the expected tree of spans."""

import threading
import time
import types

import pytest
import torch

from parasitoids_tpu_torch.bayes import model, nuts, sampler
from parasitoids_tpu_torch.bayes.priors import sample_prior_model
from parasitoids_tpu_torch.bayes.run import build_setup
from parasitoids_tpu_torch.models import forward
from parasitoids_tpu_torch.ops import day_kernel
from parasitoids_tpu_torch.parallel import ensemble
from parasitoids_tpu_torch.utils import trace

pytestmark = pytest.mark.filterwarnings(
    'ignore:simulation covers:RuntimeWarning')

# 81^2 cells of 100 m, 96 minutes a day, small windows, float64
SMALL = ('domain_info=(4000.0,40)', 'interp_num=2', 'kernel_rad=6',
         'kernel_rad_local=3', 'use_f64=True')


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_span_is_the_null_context_and_records_nothing():
    assert trace.span('a') is trace.NULL
    assert trace.span('b', request=True) is trace.NULL
    with trace.span('a'):
        assert trace.begin('c') is None
    trace.end(None)
    assert trace.records() == []
    assert trace.summary() == {'dropped': 0, 'spans': {}}


def test_on_records_names_parents_threads_and_requests():
    trace.enable()
    seen = {}

    def other_thread():
        with trace.span('worker'):
            seen['ident'] = threading.get_ident()

    with trace.span('outer', request=True):
        with trace.span('inner'):
            pass
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with trace.span('next', request=True):
        pass
    with trace.span('loose'):
        pass
    recs = by_name(trace.records())
    outer, inner = recs['outer'][0], recs['inner'][0]
    worker, nxt, loose = recs['worker'][0], recs['next'][0], recs['loose'][0]
    assert inner.parent == outer.id and outer.parent is None
    # the other thread has its own stack, and joins the request
    assert worker.parent is None and worker.request == outer.request
    assert worker.thread == seen['ident'] != outer.thread
    assert inner.request == outer.request is not None
    assert nxt.request not in (None, outer.request)
    assert loose.request is None
    assert outer.start <= inner.start <= inner.end <= outer.end


def test_nested_request_restores_the_outer_one():
    trace.enable()
    with trace.span('a', request=True):
        with trace.span('b', request=True):
            pass
        with trace.span('c'):
            pass
    recs = by_name(trace.records())
    assert recs['c'][0].request == recs['a'][0].request
    assert recs['b'][0].request != recs['a'][0].request


def test_self_time_is_the_duration_less_what_children_cover():
    # the parent 0-100 ns; children 10-30 and 20-40 overlap, 90-120 runs
    # past the parent's end: covered 30 + 10, self 60 ns
    trace.enable()
    parent = trace.begin('p', t_ns=0, request=True)
    for a, b in ((10, 30), (20, 40), (90, 120)):
        trace.end(trace.begin('c', t_ns=a), t_ns=b)
    trace.end(parent, t_ns=100)
    s = trace.summary()['spans']
    assert s['p']['count'] == 1 and s['c']['count'] == 3
    assert s['p']['total_s'] == pytest.approx(100e-9)
    assert s['p']['self_s'] == pytest.approx(60e-9)
    assert s['c']['total_s'] == pytest.approx(70e-9)
    assert s['c']['self_s'] == pytest.approx(70e-9)
    rid = trace.records()[-1].request
    assert s['c']['by_request'] == {rid: pytest.approx(70e-9)}


def test_end_without_keep_records_nothing_and_pops_the_stack():
    trace.enable()
    with trace.span('outer'):
        trace.end(trace.begin('gone'), keep=False)
        with trace.span('kept'):
            pass
    recs = by_name(trace.records())
    assert 'gone' not in recs
    assert recs['kept'][0].parent == recs['outer'][0].id


def test_the_list_is_bounded_and_drops_are_counted(monkeypatch):
    monkeypatch.setattr(trace, 'LIMIT', 3)
    trace.enable()
    for _ in range(5):
        with trace.span('x'):
            pass
    assert len(trace.records()) == 3
    assert trace.summary()['dropped'] == 2
    trace.clear()
    assert trace.records() == [] and trace.summary()['dropped'] == 0


def test_spans_are_host_events_of_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('outer.span', request=True):
            with trace.span('inner.span'):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert 'outer.span' in names and 'inner.span' in names
    # outside a profile no record_function is entered
    with trace.span('plain'):
        pass
    assert [r.name for r in trace.records()][-1] == 'plain'


# ----------------------------------------------------------------------
# the port's spans at 81^2, float64, on the CPU
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def setup():
    torch.manual_seed(0)
    return build_setup(list(SMALL), device=torch.device('cpu'))


def counters():
    return (day_kernel.LAUNCHES, day_kernel.LAUNCHES_BWD,
            day_kernel.LAUNCHES_BATCHED, sampler.FORWARDS,
            sampler.BATCHED_FORWARDS, nuts.VALUE_AND_GRADS,
            model.SKIPPED_FORWARDS)


def measured(fn, on):
    """``fn()`` with tracing on or off, and the module counters' change."""
    before = counters()
    if on:
        trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, tuple(a - b for a, b in zip(counters(), before))


def am_step(setup, on):
    st = sampler.init_chain_state(
        setup, sampler.chain_generator(11, 0, torch.device('cpu')))
    (new, row), delta = measured(lambda: sampler._mcmc_step(
        setup, st, sampler.MCMCConfig(n_samples=1)), on)
    return [new.m, new.o, new.loglik, row], delta


def nuts_transition(setup, on):
    logpdf, _, z0 = nuts.make_transformed_logpdf(setup)
    lpg = nuts.value_and_grad(logpdf)
    lp, grad = lpg(z0)
    gen = torch.Generator().manual_seed(5)
    draws = nuts.draw_transition(gen, z0.shape[0], 4, z0.dtype)
    out, delta = measured(lambda: nuts._nuts_step(
        lpg, torch.ones(z0.shape[0], dtype=z0.dtype),
        torch.tensor(0.03, dtype=z0.dtype), 4, z0, lp, grad, draws), on)
    return [out[0], out[1], out[2], out[3], torch.tensor(out[4])], delta


def forecast_member(setup, on):
    theta = sample_prior_model(torch.Generator().manual_seed(3), 1)
    fields, delta = measured(lambda: ensemble.ensemble_fields(
        setup, theta.to(torch.float64)), on)
    return [fields], delta


UNITS = {'am': am_step, 'nuts': nuts_transition, 'member': forecast_member}


@pytest.mark.parametrize('kind', sorted(UNITS))
def test_tracing_changes_no_output_and_no_counter(setup, kind):
    off, c_off = UNITS[kind](setup, on=False)
    assert trace.records() == []
    on, c_on = UNITS[kind](setup, on=True)
    assert trace.records()
    assert c_on == c_off
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize('kind', sorted(UNITS))
def test_a_unit_records_its_tree(setup, kind):
    _, delta = UNITS[kind](setup, on=True)
    recs = trace.records()
    named = by_name(recs)
    ids = {r.id: r for r in recs}
    if kind == 'am':
        root, = named['am.step']
        sweep, = named['am.obs_sweep']
        assert sweep.parent == root.id
        read, = named['model.host_read']
        assert ids[read.parent].name == 'am.step'
        n_fwd = delta[3]
        assert len(named.get('forward.day_loop', [])) == n_fwd
    elif kind == 'nuts':
        root, = named['nuts.transition']
        evals = named['nuts.eval']
        assert len(evals) == delta[5] >= 1
        assert all(e.parent == root.id for e in evals)
        # the transition's last call read a gate of 0: a host read and
        # no evaluation, so no nuts.eval span
        assert len(named['model.host_read']) == len(evals) + 1
        assert len(named['forward.day_loop']) >= len(evals)
    else:
        root, = named['ensemble.member']
        loop, = named['forward.day_loop']
        prop, = named['solver.propagate']
        read, = named['model.host_read']
        assert loop.parent == prop.parent == read.parent == root.id
    # every span of the unit belongs to its request; nothing was left open
    assert {r.request for r in recs} == {root.request}
    assert root.parent is None
    assert not any(r.name.startswith('graphs.') for r in recs)
    s = trace.summary()['spans']
    assert s[root.name]['self_s'] <= s[root.name]['total_s']
    assert s[root.name]['by_request'] == {
        root.request: pytest.approx(root.seconds)}


def test_simulate_times_its_phases_on_the_monotonic_clock(setup,
                                                          monkeypatch):
    # a module time without time.time, which can step
    monkeypatch.setattr(forward, 'time', types.SimpleNamespace(
        perf_counter=time.perf_counter))
    timing = {}
    fields, _ = forward.simulate(setup.params, setup.setup, timing=timing)
    assert fields.shape[0] == setup.ndays
    assert timing['kernel_phase'] > 0 and timing['conv_phase'] > 0

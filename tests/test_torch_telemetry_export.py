"""The port's span export and metrics exposition against the JAX package's,
on the CPU.

Against JAX: ``SpanBuffer`` (record, drain, bound, pickling),
``merge_into_recorder`` into each package's ``TraceRecorder`` and
``measure_clock_offset`` over a fake round trip give the same results;
``render_prometheus`` gives the same text for the same registry state, and
the decision gauges the same lines for the same journal.  On the wire: with
``telemetry_spans=True`` a worker process's spans reach the client's trace,
each inside the client's window; with ``False`` none does; ``/metrics``
answers with every live registry and the decision gauges, and a failing
refresh costs nothing.
"""

import os
import pickle
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from petastorm_tpu.benchmark import TraceRecorder as JaxTraceRecorder
from petastorm_tpu.telemetry import decisions as jax_decisions
from petastorm_tpu.telemetry import registry as jax_registry
from petastorm_tpu.telemetry import scrape as jax_scrape
from petastorm_tpu.telemetry import spans as jax_spans

from petastorm_tpu_torch.benchmark import TraceRecorder
from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader
from petastorm_tpu_torch.telemetry import decisions, registry, scrape, spans

from torch_plane_common import write_dataset
from torch_service_common import reap, spawn_worker, wait_for, watched

ROWS = 64
BATCH = 8
_WORKER_SPANS = {'service/decode_split', 'service/serialize', 'service/shm_publish'}


# -- spans -----------------------------------------------------------------------

def _span_calls(seed, n=30):
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(n):
        t0 = float(rng.uniform(0, 100))
        kwargs = {'cid': None if rng.random() < 0.3 else '%d/%d' % (i, int(rng.integers(4)))}
        if rng.random() < 0.5:
            kwargs['rows'] = int(rng.integers(1, 64))
        calls.append(('service/%s' % ['serialize', 'decode_split'][i % 2], t0,
                      t0 + float(rng.uniform(0, 1)), kwargs))
    return calls


def test_the_span_buffer_equals_jax():
    ours, ref = spans.SpanBuffer(max_spans=16), jax_spans.SpanBuffer(max_spans=16)
    for name, t0, t1, kwargs in _span_calls(0):
        ours.span(name, t0, t1, **kwargs)
        ref.span(name, t0, t1, **kwargs)
    assert len(ours) == len(ref) == 16
    assert ours.peek() == ref.peek()
    clone = pickle.loads(pickle.dumps(ours))
    assert clone.peek() == ours.peek() and clone._spans.maxlen == 16
    assert ours.drain() == ref.drain()
    assert len(ours) == 0 and ours.drain() == []
    assert spans.current_buffer() is spans.current_buffer()


@pytest.mark.parametrize('offset', [0.0, 1.25, -3.5])
def test_merge_into_recorder_equals_jax(offset):
    shipped = []
    buf = spans.SpanBuffer()
    for name, t0, t1, kwargs in _span_calls(1):
        buf.span(name, t0, t1, **kwargs)
    shipped = buf.drain()
    ours, ref = TraceRecorder(), JaxTraceRecorder()
    ours._t0 = ref._t0 = 10.0
    assert spans.merge_into_recorder(ours, shipped, clock_offset_s=offset) == \
        jax_spans.merge_into_recorder(ref, shipped, clock_offset_s=offset) == len(shipped)
    assert ours.events == ref.events
    assert spans.merge_into_recorder(ours, shipped, pid=7) == len(shipped)
    assert {e['pid'] for e in ours.events[-len(shipped):]} == {7}
    assert spans.merge_into_recorder(None, shipped) == 0
    assert spans.merge_into_recorder(ours, []) == 0


def test_measure_clock_offset_equals_jax(monkeypatch):
    """A fake round trip on a fake clock: the same offset and RTT."""
    ticks = iter([100.0, 100.5, 200.0, 200.25])
    monkeypatch.setattr(time, 'monotonic', lambda: next(ticks))
    ours = spans.measure_clock_offset(lambda: 40.0)
    ref = jax_spans.measure_clock_offset(lambda: 40.0)
    assert ours == (100.25 - 40.0, 0.5)
    assert ref == (200.125 - 40.0, 0.25)


# -- Prometheus text -----------------------------------------------------------------

def _fill(reg, seed):
    rng = np.random.default_rng(seed)
    for i in range(6):
        reg.counter('rows decoded/%d' % (i % 3)).inc(int(rng.integers(1, 100)))
        reg.gauge('queue-depth.%d' % (i % 2)).set(round(float(rng.uniform(0, 9)), 4))
        for _ in range(5):
            reg.histogram('stage:%d' % (i % 2)).observe(float(rng.uniform(0, 0.2)))
    reg.counter('float_total').inc(0.1234567)


@pytest.mark.parametrize('namespace', ['', 'service_worker', 'odd-name.x'])
def test_render_prometheus_equals_jax(namespace):
    ours, ref = registry.MetricsRegistry(namespace), jax_registry.MetricsRegistry(namespace)
    _fill(ours, 3)
    _fill(ref, 3)
    assert ours.render_prometheus() == ref.render_prometheus()
    assert ours.snapshot() in registry.snapshot_all()


def test_the_decision_gauges_equal_jax(monkeypatch):
    """Each package's only live journal fed the same records: the same
    gauge lines (the last action's age aside, which is the clock's)."""
    monkeypatch.setattr(decisions, '_LIVE', type(decisions._LIVE)())
    monkeypatch.setattr(jax_decisions, '_LIVE', type(jax_decisions._LIVE)())
    journals = decisions.DecisionJournal(), jax_decisions.DecisionJournal()
    for module, journal in zip((decisions, jax_decisions), journals):
        for actor, action, suppressed in (('autoscaler', 'scale_out', False),
                                          ('autoscaler', 'hold', True),
                                          ('tenant_sched', 'quota_refused', True),
                                          ('affinity', 'routed', False)):
            module.record_decision(actor, action, 'r', {}, suppressed=suppressed,
                                   journal=journal)

    def lines(text):
        return [line for line in text.splitlines() if 'age_seconds{' not in line]
    ours, ref = scrape.render_decision_metrics(), jax_scrape.render_decision_metrics()
    assert lines(ours) == lines(ref)
    assert 'petastorm_tpu_decisions_suppressed_total{actor="tenant_sched"} 1' in ours


def test_the_metrics_endpoint_answers():
    reg = registry.MetricsRegistry('scrape_test')
    reg.counter('hits').inc(3)
    journal = decisions.DecisionJournal()
    decisions.record_decision('autoscaler', 'scale_out', 'autoscale_starve_s', {},
                              journal=journal)
    refreshed = []
    server = scrape.start_metrics_server(0, host='127.0.0.1',
                                         refresh=lambda: refreshed.append(1))
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen('http://127.0.0.1:%d/metrics' % port, timeout=10).read()
        text = body.decode()
        assert 'petastorm_tpu_scrape_test_hits 3' in text
        assert 'petastorm_tpu_decisions_actions_total{actor="autoscaler"}' in text
        assert refreshed == [1]
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen('http://127.0.0.1:%d/other' % port, timeout=10)
        assert info.value.code == 404
    finally:
        server.shutdown()
        server.server_close()

    def broken():
        raise RuntimeError('refresh failed')
    assert 'petastorm_tpu_scrape_test_hits 3' in scrape.render_process_metrics(refresh=broken)


# -- spans over the wire -------------------------------------------------------------

@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_spans'), rows=ROWS)


@pytest.mark.parametrize('ship', [True, False])
@watched(90)
def test_worker_spans_reach_the_clients_trace_inside_its_window(url, ship):
    recorder = TraceRecorder()
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=1.5, telemetry_spans=ship,
                           reader_kwargs={'workers_count': 1})
    proc = None
    with Dispatcher(config) as dispatcher:
        try:
            proc = spawn_worker(dispatcher.addr)
            wait_for(lambda: any(w['clock_offset'] is not None
                                 for w in dispatcher._op_workers({})['workers']),
                     30, 'the worker\'s first heartbeat')
            t_start = time.monotonic()
            loader = ServiceDataLoader(dispatcher.addr, BATCH, consumer=0, device='cpu',
                                       trace_recorder=recorder)
            with loader:
                ids = [i for b in loader.iter_host_batches() for i in b['id'].tolist()]
            t_end = time.monotonic()
            diagnostics = loader.reader.diagnostics
        finally:
            reap(proc)
    assert sorted(ids) == list(range(ROWS))
    shipped = [e for e in recorder.events if e['name'] in _WORKER_SPANS]
    waits = [e for e in recorder.events if e['name'] == 'service/split_wait']
    assert len(waits) == ROWS // 16 + 1
    if not ship:
        assert shipped == [] and diagnostics['spans_merged'] == 0
        return
    assert diagnostics['spans_merged'] == len(shipped)
    assert len([e for e in shipped if e['name'] == 'service/decode_split']) == ROWS // 16
    assert {e['pid'] for e in shipped} == {proc.pid}
    labels = [e for e in recorder.events if e.get('ph') == 'M']
    assert [e['pid'] for e in labels] == [proc.pid]
    lo, hi = 1e6 * (t_start - recorder._t0), 1e6 * (t_end - recorder._t0)
    assert all(lo <= e['ts'] and e['ts'] + e['dur'] <= hi for e in shipped), \
        (lo, hi, [(e['ts'], e['dur']) for e in shipped])
    # one host: the chained offset is the two monotonic clocks' (both ~0)
    assert abs(diagnostics['clock_offset_s']) < 0.05
    assert all(abs(v) < 0.05 for v in diagnostics['worker_clock_offsets_s'].values())
    assert os.getpid() != proc.pid

"""The port's flight recorder and health engine
(``petastorm_tpu_torch.telemetry.flight`` and ``.health``) against the JAX
package's, on the CPU.

Every regime of the catalogue is a parametrised case: the reference's own
synthetic deltas (``tests/test_health_diagnose.py``'s ``REGIME_FIXTURES``)
and, for the regimes they leave out, deltas and control-plane metadata built
the same way; ``classify_regime`` and ``health_report`` must give the same
regime, severity, evidence, candidates, component scores and, through
``export_gauges``, gauges, exactly.  ``window_frames`` and
``report_from_frames`` take the same seeded frame lists; ``sweep_dumps``
sweeps two copies of one dump directory alike.  The recorder's own contract
(the ring's bound, the persisted dump's shape, the process singleton and its
kill switch, the span peek that never drains, the owner lock) is held as the
reference's tests hold it.
"""

import copy
import json
import os
import shutil
import time

import numpy as np
import pytest

from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import flight as jax_flight
from petastorm_tpu.telemetry import health as jax_health
from petastorm_tpu.telemetry import registry as jax_registry

from petastorm_tpu_torch import telemetry
from petastorm_tpu_torch.telemetry import flight, health, provenance, registry

from test_health_diagnose import REGIME_FIXTURES, _fixture_delta

#: The regimes the reference's fixtures leave out (and a second route into
#: some that they have), built the same way.
EXTRA_FIXTURES = {
    'fetch-bound (degraded plane)': dict(
        regime='fetch-bound',
        delta=_fixture_delta(counters={'ingest_degraded': 30, 'ingest_fetches': 70})),
    'fetch-bound (stall)': dict(
        regime='fetch-bound', delta=_fixture_delta(hist_sums={'decode': 0.1}),
        stall_pct={'ingest_fetch': 72.0, 'decode': 10.0}),
    'fetch-bound (busy share)': dict(
        regime='fetch-bound',
        delta=_fixture_delta(hist_sums={'ingest_wait': 4.0, 'decode': 0.5})),
    'tenant-starved': dict(
        regime='tenant-starved', delta=_fixture_delta(counters={'cache_hits': 3}),
        meta={'starved_tenants': ['b'], 'pending': 4, 'workers_alive': 2}),
    'control-plane-degraded (restart)': dict(
        regime='control-plane-degraded', delta=_fixture_delta(counters={'ledger_restores': 1})),
    'control-plane-degraded (drains)': dict(
        regime='control-plane-degraded',
        delta=_fixture_delta(counters={'drain_timeouts': 2, 'retry_giveups': 4})),
    'control-plane-degraded (lineage)': dict(
        regime='control-plane-degraded', delta=_fixture_delta(counters={'cache_hits': 1}),
        meta={'ledger_restores': 3, 'failed': 1}),
    'control-flapping': dict(
        regime='control-flapping', delta=_fixture_delta(counters={'cache_hits': 1}),
        meta={'control_flaps': {'autoscaler': 3, 'residency': 1}}),
    'residency-thrash': dict(
        regime='residency-thrash',
        delta=_fixture_delta(counters={'residency_thrash': 20, 'residency_admitted': 30,
                                       'residency_hits': 10})),
    'resident': dict(
        regime='resident',
        delta=_fixture_delta(counters={'residency_hits': 40, 'residency_host_batches': 8,
                                       'residency_admitted': 8})),
    'lease-starved (no live worker)': dict(
        regime='lease-starved', delta=_fixture_delta(),
        meta={'pending': 7, 'workers_alive': 0}),
    'link-bound (degraded plane)': dict(
        regime='link-bound', delta=_fixture_delta(counters={'h2d_degraded': 40,
                                                            'h2d_batches': 60})),
    'decode-bound (busy share)': dict(
        regime='decode-bound',
        delta=_fixture_delta(hist_sums={'decode_split': 6.0, 'serialize': 0.5})),
    'healthy': dict(
        regime='healthy',
        delta=_fixture_delta(counters={'cache_hits': 50}, hist_sums={'decode_split': 0.1})),
    'idle': dict(regime='idle', delta={}),
}

CASES = dict({name: dict(fixture, regime=name) for name, fixture in REGIME_FIXTURES.items()},
             **EXTRA_FIXTURES)


def test_every_regime_of_the_catalogue_has_a_case():
    assert set(health.REGIMES) == set(jax_health.REGIMES) \
        == {case['regime'] for case in CASES.values()}


@pytest.mark.parametrize('name', sorted(CASES))
def test_health_report_equals_jax(name):
    case = CASES[name]
    args = dict(stall_pct=case.get('stall_pct'), meta=copy.deepcopy(case.get('meta')))
    port = health.health_report(copy.deepcopy(case['delta']), window_s=60.0, **args)
    jax = jax_health.health_report(copy.deepcopy(case['delta']), window_s=60.0, **args)
    assert port == jax
    assert port['regime'] == case['regime']
    assert health.classify_regime(case['delta'], **args) == \
        jax_health.classify_regime(case['delta'], **args)
    assert health.degrade_ratios(case['delta']) == jax_health.degrade_ratios(case['delta'])
    assert health.busy_seconds(case['delta']) == jax_health.busy_seconds(case['delta'])
    assert health.format_health_line(port) == jax_health.format_health_line(jax)
    assert health.summarize_stages(case['delta'].get('histograms')) == \
        jax_health.summarize_stages(case['delta'].get('histograms'))
    gauges = []
    for mod, report in ((registry, port), (jax_registry, jax)):
        into = mod.MetricsRegistry('h')
        (health if mod is registry else jax_health).export_gauges(into, report)
        gauges.append(into.snapshot()['gauges'])
    assert gauges[0] == gauges[1]


def _frames(seed, n=12):
    """Frames of a seeded counter-and-histogram history, as a recorder
    makes them (each a cumulative snapshot, 2 s apart)."""
    rng = np.random.default_rng(seed)
    reg = registry.MetricsRegistry('f')
    frames, t = [], 500.0
    for i in range(n):
        reg.counter('cache_hits').inc(int(rng.integers(0, 20)))
        reg.counter('cache_degraded').inc(int(rng.integers(0, 3)))
        for s in rng.exponential(0.05, int(rng.integers(1, 8))):
            reg.histogram(str(rng.choice(['decode', 'h2d_commit', 'ingest_wait']))).observe(s)
        t += float(rng.uniform(1.5, 2.5))
        frames.append({'t_mono': t, 'unix_time': 1.7e9 + t, 'snapshot': reg.snapshot(),
                       'spans': [], 'span_residue': 0})
    return frames


@pytest.mark.parametrize('seed', range(3))
def test_window_frames_and_report_from_frames_equal_jax(seed):
    frames = _frames(seed)
    for seconds in (None, 0.5, 5.0, 9.0, 60.0):
        assert flight.window_frames(frames, seconds) == jax_flight.window_frames(frames, seconds)
        assert health.report_from_frames(frames, window_s=seconds or 60.0) == \
            jax_health.report_from_frames(frames, window_s=seconds or 60.0)
    assert flight.window_frames([], 5.0) == jax_flight.window_frames([], 5.0) == (None, None)
    assert flight.window_frames(frames[:1], 5.0) == jax_flight.window_frames(frames[:1], 5.0)
    assert health.report_from_frames([]) is jax_health.report_from_frames([]) is None


@pytest.fixture
def own_journals(monkeypatch):
    """Fresh process-wide live sets of provenance and decision journals for
    one test: a frame reads every live journal of the process, and journals
    that other test files leave alive in the same worker (with slower
    records) would push this test's own out of the frame's top four."""
    import weakref
    from petastorm_tpu_torch.telemetry import decisions
    monkeypatch.setattr(provenance, '_LIVE', weakref.WeakSet())
    monkeypatch.setattr(decisions, '_LIVE', weakref.WeakSet())
    monkeypatch.setattr(decisions, '_DEFAULT', None, raising=False)


def test_flight_ring_bounds_window_and_frames_carry_worst_and_decisions(own_journals):
    reg = registry.MetricsRegistry('fr')
    journal = provenance.ProvenanceJournal(label='fr')
    journal.seal(provenance.make_record('pool', stages={'decode': [1.0, 1.5]}))
    from petastorm_tpu_torch.telemetry import decisions
    actions = decisions.DecisionJournal(label='fr')
    decisions.record_decision('autoscaler', 'hold', 'autoscale_cooldown_s', {'now': 1.0},
                              suppressed=True, journal=actions)
    recorder = flight.FlightRecorder(interval_s=0.01, max_frames=4, label='t')
    for _ in range(7):
        reg.counter('ticks').inc()
        recorder.tick()
        time.sleep(0.002)
    frames = recorder.frames()
    assert len(frames) == 4
    old, new = recorder.window(60.0)
    assert new['t_mono'] > old['t_mono'] and new['unix_time'] > 0
    delta = registry.snapshot_delta(new['snapshot'], old['snapshot'])
    assert delta['counters']['ticks'] == 3
    assert any(row['latency_ms'] == 500.0 for row in new['provenance_worst'])
    assert new['decisions_recent']
    dump = recorder.dump()
    want = jax_flight.FlightRecorder(label='t').dump()
    assert set(dump) == set(want)
    assert any(j['label'] == 'fr' for j in dump['provenance'])


def test_flight_persist_round_trip_and_owner_lock(tmp_path):
    path = str(tmp_path / 'flight_t_1.json')
    recorder = flight.FlightRecorder(interval_s=0.01, label='t', persist_path=path,
                                     persist_every=2)
    recorder.tick()
    recorder.tick()                 # the periodic persist
    assert os.path.exists(path) and os.path.exists(path + '.owner')
    recorder.tick()
    assert recorder.persist(reason='test') == path
    with open(path) as f:
        dump = json.load(f)
    assert (dump['kind'], dump['label'], dump['reason'], len(dump['frames']), dump['pid']) == \
        ('flight_recorder', 't', 'test', 3, os.getpid())
    old = time.time() - 2 * 24 * 3600
    for name in os.listdir(str(tmp_path)):
        os.utime(str(tmp_path / name), (old, old))
    assert flight.sweep_dumps(str(tmp_path))['swept'] == 0   # the owner lives
    recorder.stop()
    assert not os.path.exists(path + '.owner')
    os.utime(path, (old, old))
    flight.sweep_dumps(str(tmp_path))
    assert os.path.exists(path)     # this pid lives


def test_sweep_dumps_equals_jax(tmp_path):
    """One directory of dumps (dead and live pids, young and old, temporary
    residue, an orphaned owner file, a foreign file) swept by each package
    in a copy of its own: the same counts and the same survivors."""
    old = time.time() - 2 * 24 * 3600
    src = tmp_path / 'src'
    src.mkdir()
    files = {'flight_worker_999999.json': True, 'flight_worker_%d.json' % os.getpid(): True,
             'flight_worker_999998.json': False, 'flight_worker_999997.json.999997.tmp': True,
             'provenance_slo_loader_999995.json': True,
             'flight_gone_999994.json.owner': True, 'notes.txt': True}
    for name, aged in files.items():
        (src / name).write_text('{}')
        if aged:
            os.utime(str(src / name), (old, old))
    results = {}
    for name, mod in (('port', flight), ('jax', jax_flight)):
        where = tmp_path / name
        shutil.copytree(str(src), str(where))
        for f in files:
            if files[f]:
                os.utime(str(where / f), (old, old))
        results[name] = (mod.sweep_dumps(str(where)), sorted(os.listdir(str(where))))
    assert results['port'] == results['jax']
    assert results['port'][0] == {'swept': 3, 'kept': 2, 'tmp_swept': 1}


def test_flight_singleton_and_kill_switch(monkeypatch):
    flight.disable()
    try:
        first = flight.enable(label='one', interval_s=60.0)
        assert first is not None and flight.enable(label='two') is first
        assert flight.get() is first and first.label == 'one'
        assert flight.dump_current()['label'] == 'one'
        flight.disable()
        assert flight.get() is None and flight.dump_current() is None
        monkeypatch.setenv('PETASTORM_TPU_NO_FLIGHT', '1')
        assert flight.enable(label='off') is None
        monkeypatch.delenv('PETASTORM_TPU_NO_FLIGHT')
        monkeypatch.setenv('PETASTORM_TPU_FLIGHT_INTERVAL_S', '7.5')
        assert flight.enable(label='env').interval_s == 7.5
    finally:
        flight.disable()


def test_flight_span_peek_never_drains():
    buffer = telemetry.current_buffer()
    buffer.drain()
    recorder = flight.FlightRecorder(interval_s=60.0)
    t = time.monotonic()
    buffer.span('probe/stage', t - 0.01, t, cid='x')
    frame = recorder.tick()
    assert any(s['name'] == 'probe/stage' for s in frame['spans'])
    assert any(s['name'] == 'probe/stage' for s in buffer.peek())
    assert not any(s['name'] == 'probe/stage' for s in recorder.tick()['spans'])
    buffer.drain()


def test_dump_state_has_the_jax_keys():
    from petastorm_tpu_torch.benchmark.trace import TraceRecorder
    rec = TraceRecorder()
    rec.event('probe', time.monotonic() - 0.01, time.monotonic())
    state = telemetry.dump_state()
    assert set(state) == set(jax_telemetry.dump_state())
    assert any(batch['events'] and batch['origin_monotonic'] == rec._t0
               for batch in state['trace_events'])
    json.dumps(state, default=str)

"""The port's explaining tools (``explain``, ``diagnose``, ``why``, ``top``
under ``petastorm_tpu_torch.telemetry``) and the service's provenance
against the JAX package's, on the CPU.

The same inputs go to both packages' tools and must give equal output:
``diagnose``'s verdicts (JSON and text) for every regime's evidence, for
the other rules, for one flight dump, one crash artifact and one stats
reply; ``explain``'s (``--journal``, ``--step``, ``--worst --json``,
``--flight``, ``--artifact``) on one journal; ``why``'s (filters, ``--json``,
``--check``) on one decision journal; ``top``'s frame of one stats reply.
The one difference allowed is a tag of the reference's history in the
``tenant-starved`` action, which the port does not carry.

The service end to end (one dispatcher, one worker in a process of its own,
a ``ServiceDataLoader``): each split's record comes from the worker's pid
with its pieces, its stages moved onto the client's clock; ``stats()``
carries a health report equal to the reference dispatcher's for the same
heartbeat; ``diagnose``, ``top`` and ``why`` read the live dispatcher, and
the flight dump it persists at exit reads back through ``diagnose
--flight``.  A record that cannot be placed on the client's clock is
dropped.
"""

import contextlib
import copy
import io
import json
import os
import time
import weakref

import numpy as np
import pytest

from petastorm_tpu.telemetry import decisions as jax_decisions
from petastorm_tpu.telemetry import diagnose as jax_diagnose
from petastorm_tpu.telemetry import explain as jax_explain
from petastorm_tpu.telemetry import flight as jax_flight
from petastorm_tpu.telemetry import health as jax_health
from petastorm_tpu.telemetry import top as jax_top
from petastorm_tpu.telemetry import why as jax_why

from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.telemetry import (decisions, diagnose, explain, flight, health,
                                           provenance, registry, top, why)

from test_common import create_test_dataset
from test_torch_decisions import _records
from test_torch_flight_health import CASES
from torch_service_common import reap, spawn_worker, watched, write_raw


def _reference_tag():
    """The phrase that the reference's ``tenant-starved`` action holds and
    the port's does not (a tag of the reference's history)."""
    want = jax_diagnose._REGIME_ACTIONS['tenant-starved']
    got = diagnose._REGIME_ACTIONS['tenant-starved']
    i = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    tag = want[i:i + len(want) - len(got)]
    assert want == got[:i] + tag + got[i:] and tag.strip()
    return tag


_TAG = _reference_tag()


def _normalized(obj):
    return json.loads(json.dumps(obj, sort_keys=True, default=str).replace(_TAG, ''))


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().replace(_TAG, '')


def _same_cli(port_main, jax_main, argv):
    got, want = _run(port_main, argv), _run(jax_main, argv)
    assert got == want
    return got


# -- diagnose -----------------------------------------------------------------------

def _evidence(case, mod_health):
    delta = case['delta']
    meta = copy.deepcopy(case.get('meta') or {})
    report = mod_health.health_report(copy.deepcopy(delta), stall_pct=case.get('stall_pct'),
                                      meta=meta or None)
    return {'source': 'fixture', 'health': report,
            'stages': mod_health.summarize_stages((delta or {}).get('histograms')),
            'counters': dict((delta or {}).get('counters') or {}), 'meta': meta,
            'workers': {'w0': {'cache_degraded': 7, 'cache_hits': 2, 'shm_degraded': 3,
                               'shm_chunks': 9, 'cache_peer_degraded': 4}},
            'tenants': {'a': {'grants_delta': 5, 'weight': 2.0, 'pending': 0},
                        'b': {'grants_delta': 0, 'weight': 1.0, 'pending': 4}},
            'decisions': {'autoscaler': {'actions': 6, 'suppressed': 1,
                                         'last': {'action': 'scale_in', 'worker_id': 'w2',
                                                  'rule': 'autoscale_idle_s', 'age_s': 3.0}}},
            'span_residue': 0, 'reason': None}


@pytest.mark.parametrize('name', sorted(CASES))
def test_diagnose_verdicts_per_regime_equal_jax(name):
    case = CASES[name]
    port = diagnose.diagnose(_evidence(case, health))
    jax = jax_diagnose.diagnose(_evidence(case, jax_health))
    assert _normalized(port) == _normalized(jax)
    assert diagnose.render_report(port) == jax_diagnose.render_report(jax).replace(_TAG, '')
    if case['regime'] not in ('healthy', 'idle', 'resident'):
        assert case['regime'] in [v['id'] for v in port['verdicts']]


def test_diagnose_other_rules_equal_jax():
    """Failed splits, clock drift, span residue, a watchdog's reason, the
    slowest journaled batch, dispatcher restarts and drain timeouts."""
    evidence = {'source': 'fixture', 'health': health.health_report({}), 'stages': {},
                'counters': {}, 'meta': {'failed': 2, 'pending': 0},
                'workers': {'w0': {'clock_drift_ms': 0.1}, 'w3': {'clock_drift_ms': 412.0}},
                'span_residue': 300, 'reason': 'watchdog_timeout',
                'provenance_worst': [{'step': 4, 'latency_ms': 812.5, 'worker_pid': 77,
                                      'piece': '/d/p.parquet:rg3', 'cache': 'decode',
                                      'transport': 'shm'}],
                'control_plane': {'ledger_restores': 3, 'ledger_adoptions': 1,
                                  'ledger_requeues': 2, 'drains': 4, 'drain_timeouts': 1}}
    port = diagnose.diagnose(copy.deepcopy(evidence))
    jax = jax_diagnose.diagnose(copy.deepcopy(evidence))
    assert _normalized(port) == _normalized(jax)
    assert [v['id'] for v in port['verdicts']][:2] == ['failed-splits', 'suite-hang']


def test_diagnose_stats_evidence_equals_jax():
    stats = {'pending': 5, 'leased': 1, 'done': 3, 'failed': 0, 'lease_churn': 2,
             'cache': {'cache_hits': 10, 'cache_misses': 30, 'cache_degraded': 20},
             'shm': {'shm_chunks': 40, 'shm_degraded': 1},
             'cluster_cache': {'cache_remote_hits': 2, 'piece_map': True},
             'stages': {'decode_split': {'count': 4, 'p50_ms': 2.0, 'p99_ms': 8.0}},
             'tenants': {'a': {'grants_delta': 3, 'pending': 2, 'weight': 1.0},
                         'b': {'grants_delta': 0, 'pending': 6, 'weight': 1.0}},
             'workers': {'w0': {'age_s': 1.0}, 'w1': {'age_s': 900.0}}}
    for with_health in (False, True):
        if with_health:
            stats['health'] = health.health_report({'counters': {'cache_degraded': 20,
                                                                 'cache_hits': 10}})
        port = diagnose.evidence_from_stats(copy.deepcopy(stats))
        jax = jax_diagnose.evidence_from_stats(copy.deepcopy(stats))
        assert _normalized(port) == _normalized(jax)
        assert _normalized(diagnose.diagnose(port)) == _normalized(jax_diagnose.diagnose(jax))
    assert port['meta']['starved_tenants'] == ['b'] and port['meta']['workers_alive'] == 1


@pytest.fixture(scope='module')
def journal_files(tmp_path_factory):
    """One loader's journal, a flight dump and a crash artifact of the same
    process state, each a file."""
    with pytest.MonkeyPatch.context() as mp:
        # this module's journals only: the flight dump and the crash artifact
        # carry every live journal of the process, and other test files of
        # the same worker leave theirs alive
        mp.setattr(provenance, '_LIVE', weakref.WeakSet())
        mp.setattr(decisions, '_LIVE', weakref.WeakSet())
        mp.setattr(decisions, '_DEFAULT', None)
        return _journal_files(tmp_path_factory)


def _journal_files(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_tools')
    ds = create_test_dataset('file://' + str(root / 'ds'), num_rows=30, rows_per_rowgroup=5)
    with make_reader(ds.url, schema_fields=['id', 'matrix'], reader_pool_type='thread',
                     workers_count=2, shuffle_row_groups=False, columnar_decode=True) as reader:
        loader = DataLoader(reader, 5, drop_last=False, device='cpu')
        with loader:
            list(loader)
    paths = {name: str(root / ('%s.json' % name)) for name in ('journal', 'flight', 'artifact')}
    assert loader.dump_provenance(paths['journal']) == paths['journal']
    reg = registry.MetricsRegistry('tools')
    recorder = flight.FlightRecorder(interval_s=0.01, label='tools')
    recorder.tick()
    reg.counter('cache_degraded').inc(80)
    reg.counter('cache_misses').inc(20)
    reg.histogram('decode_split').observe(0.05)
    recorder.tick()
    recorder.persist(path=paths['flight'], reason='test')
    from petastorm_tpu_torch import telemetry
    state = telemetry.dump_state()
    state['flight'] = json.load(open(paths['flight']))
    state['trace_events'] = [{'origin_monotonic': 1.0, 'events': [
        {'name': 'data_wait', 'ph': 'X', 'ts': 0, 'dur': 100},
        {'name': 'service/decode_split', 'ph': 'X', 'ts': 0, 'dur': 92}]}]
    state['reason'] = 'exitstatus_1'
    provenance.atomic_json_dump(paths['artifact'], state)
    paths['worst_step'] = loader.provenance.worst(1)[0]['step']
    paths['steps'] = len(loader.provenance)
    return paths


@pytest.mark.parametrize('kind', ['flight', 'artifact'])
def test_diagnose_dumps_equal_jax(journal_files, kind):
    for extra in ([], ['--json'], ['--window', '0.001', '--json']):
        rc, out = _same_cli(diagnose.main, jax_diagnose.main, ['--' + kind, journal_files[kind]]
                            + extra)
        assert rc == 0 and out
    report = json.loads(_run(diagnose.main, ['--' + kind, journal_files[kind], '--json'])[1])
    assert report['verdicts'][0]['id'] in ('cache-degraded', 'decode-bound')
    assert _run(diagnose.main, ['--flight', journal_files['journal'] + '.nope'])[0] == 1


# -- explain --------------------------------------------------------------------------

def test_explain_on_one_journal_equals_jax(journal_files):
    path = journal_files['journal']
    for argv in (['--journal', path], ['--journal', path, '--worst', '2'],
                 ['--journal', path, '--step', str(journal_files['worst_step'])],
                 ['--journal', path, '--worst', '3', '--json'],
                 ['--journal', path, '--step', '0', '--json'],
                 ['--artifact', journal_files['artifact'], '--worst', '2', '--json'],
                 ['--flight', journal_files['flight']],
                 ['--journal', path, '--step', '9999']):
        rc, out = _same_cli(explain.main, jax_explain.main, argv)
    report = json.loads(_run(explain.main, ['--journal', path, '--worst', '1', '--json'])[1])
    record = report['records'][0]
    assert record['pieces'][0]['path'].endswith('.parquet')
    assert record['pieces'][0]['row_group'] is not None
    assert {'decode', 'host_batch'} <= {row['stage'] for row in record['stages']}
    assert report['meta']['steps'] == journal_files['steps']
    assert _run(explain.main, ['--journal', path, '--step', '9999'])[0] == 1


def test_explain_record_and_chain_equal_jax():
    rng = np.random.default_rng(5)
    for i in range(6):
        t = float(rng.uniform(10, 20))
        record = provenance.make_record(
            'service', worker_pid=9, worker_host='h', transport='mixed', cache='decode',
            pieces=[{'index': i, 'path': '/d/x.parquet', 'row_group': i}],
            sched={'policy': 'adaptive', 'early': bool(i % 2), 'predicted_cost': 3.5,
                   'actual_s': 0.25},
            stages={'decode': [t, t + 0.5], 'serialize': [t + 0.1, t + 0.6],
                    'client_buffer': [t + 0.6, t + 0.7], 'zzz': [t + 0.2, t + 0.3]},
            stage_busy_ms={'serialize': 12.5}, tenant='a', step=i, latency_ms=700.0)
        assert explain.explain_record(record) == jax_explain.explain_record(record)
        assert explain.format_chain(record) == jax_explain.format_chain(record)


# -- why ------------------------------------------------------------------------------

@pytest.fixture(scope='module')
def decision_file(tmp_path_factory):
    journal = decisions.DecisionJournal(capacity=64, label='dispatcher')
    for kwargs in _records(4, n=60):
        decisions.record_decision(journal=journal, **kwargs)
    path = str(tmp_path_factory.mktemp('torch_why') / 'decisions.json')
    provenance.atomic_json_dump(path, {'kind': 'flight_recorder', 'frames': [],
                                       'decisions': [journal.dump()]})
    return path


@pytest.mark.parametrize('argv', [[], ['--json'], ['--actor', 'autoscaler'],
                                  ['--worker', 'w1', '--last', '3'], ['--tenant', 't2', '--json'],
                                  ['--rule', 'residency_budget'], ['--check'],
                                  ['--check', '--json'], ['--actor', 'nobody-here']])
def test_why_on_one_decision_journal_equals_jax(decision_file, argv):
    if argv == ['--actor', 'nobody-here']:
        argv = ['--action', 'nobody-here']
    rc, out = _same_cli(why.main, jax_why.main, ['--flight', decision_file] + argv)
    if argv[:1] != ['--action']:
        assert rc in (0, 1) and out
    else:
        assert rc == 1


def test_why_load_filter_related_equal_jax(decision_file):
    state = json.load(open(decision_file))
    port, port_meta = why.load_decisions(copy.deepcopy(state))
    jax, jax_meta = jax_why.load_decisions(copy.deepcopy(state))
    assert port == jax and port_meta == jax_meta
    for kwargs in ({'actor': 'autoscaler'}, {'worker': 'w0'}, {'tenant': 't1'}):
        a, b = why.filter_records(port, **kwargs), jax_why.filter_records(jax, **kwargs)
        assert a == b
        for record in a[-2:]:
            assert why.related_before(port, record) == jax_why.related_before(jax, record)
            assert why.format_decision(record, ref_unix=2e9) == \
                jax_why.format_decision(record, ref_unix=2e9)
    assert why.check_records(port) == jax_why.check_records(jax)


# -- top ------------------------------------------------------------------------------

def test_top_frame_equals_jax():
    stats = {'pending': 3, 'leased': 2, 'done': 9, 'failed': 1, 'lease_churn': 4,
             'health': health.health_report({'counters': {'shm_degraded': 5, 'shm_chunks': 10}}),
             'cache': {'cache_hits': 6, 'cache_misses': 2, 'cache_ram_hits': 4},
             'shm': {'shm_chunks': 10, 'shm_degraded': 5},
             'cluster_cache': {'cache_remote_hits': 1, 'cache_peer_fills': 2},
             'control_plane': {'ledger': True, 'ledger_restores': 1, 'drains': 2},
             'tenants': {'a': {'weight': 1.0, 'pending': 1, 'done': 2, 'grants': 5,
                               'grants_delta': 3},
                         'b': {'weight': 2.0, 'pending': 0, 'done': 4, 'grants': 7,
                               'grants_delta': 1}},
             'autoscale': {'enabled': True, 'scale_outs': 2, 'scale_ins': 1, 'suppressed': 3},
             'decisions': {'autoscaler': {'actions': 3, 'suppressed': 3,
                                          'last': {'action': 'scale_in', 'worker_id': 'w3',
                                                   'age_s': 12.0}},
                           'residency': {'actions': 1, 'suppressed': 0, 'last': None}},
             'stages': {'decode_split': registry.summarize_hist(
                 {'counts': [0] * 10 + [4] + [0] * 33, 'count': 4, 'sum': 0.005})},
             'workers': {'w0': {'rows_per_s': 120.5, 'rows_decoded': 400, 'queue_depth': 2,
                                'shm_chunks': 10, 'age_s': 0.4}}}
    assert top.render_stats(stats, 0.012) == jax_top.render_stats(stats, 0.012)
    assert top.render_stats({}) == jax_top.render_stats({})


# -- the service ----------------------------------------------------------------------

def test_the_client_drops_an_unalignable_record(monkeypatch):
    from petastorm_tpu_torch.service.client import _ServiceConnection
    monkeypatch.delenv('PETASTORM_TPU_NO_PROVENANCE', raising=False)
    conn = _ServiceConnection.__new__(_ServiceConnection)
    conn.clock_offset = None
    conn.worker_offsets = {}
    now = time.monotonic()
    skewed = provenance.make_record('service', stages={'decode': [now + 7200.0, now + 7201.0]})
    assert conn._align_provenance({'provenance': skewed}, 'addr') is None
    near = provenance.make_record('service', stages={'decode': [now - 1.0, now]})
    kept = conn._align_provenance({'provenance': near}, 'addr')
    assert kept is not None and '_received_t' in kept
    # offsets known: the windows move by (client - dispatcher) - (worker - dispatcher)
    conn.clock_offset, conn.worker_offsets = 5.0, {'addr': 2.0}
    moved = provenance.make_record('service', stages={'decode': [now - 4.0, now - 3.5]})
    aligned = conn._align_provenance({'provenance': moved}, 'addr')
    assert aligned['stages']['decode'] == [now - 1.0, now - 0.5]
    assert conn._align_provenance({}, 'addr') is None


def _heartbeat_health(dispatcher_cls, config, rpc_cls):
    """One worker's heartbeat of a decode-bound registry into a dispatcher
    with no real worker; its ``stats``' health."""
    import zmq
    with dispatcher_cls(config, num_pieces=4) as dispatcher:
        context = zmq.Context()
        rpc = rpc_cls(context, dispatcher.addr)
        try:
            reply = rpc.call({'op': 'register_worker', 'data_addr': 'tcp://127.0.0.1:1'})
            reg = registry.MetricsRegistry('service_worker')
            for _ in range(40):
                reg.histogram('decode_split').observe(0.04)
                reg.histogram('serialize').observe(0.002)
            reg.counter('cache_degraded').inc(3)
            reg.counter('cache_hits').inc(40)
            rpc.call({'op': 'heartbeat', 'worker_id': reply['worker_id'],
                      'stats': {'rows_decoded': 100, 'registry': reg.snapshot()}})
            stats = rpc.call({'op': 'stats'})
        finally:
            rpc.close()
            context.term()
    return stats, dispatcher


def test_the_dispatchers_stats_health_equals_jax():
    from petastorm_tpu.service import Dispatcher as JaxDispatcher
    from petastorm_tpu.service import ServiceConfig as JaxServiceConfig
    from petastorm_tpu.service.worker import _Rpc as JaxRpc

    from petastorm_tpu_torch.service import Dispatcher, ServiceConfig
    from petastorm_tpu_torch.service.worker import _Rpc
    port, dispatcher = _heartbeat_health(Dispatcher, ServiceConfig('file:///unused',
                                                                   num_consumers=1), _Rpc)
    jax, _ = _heartbeat_health(JaxDispatcher, JaxServiceConfig('file:///unused',
                                                               num_consumers=1), JaxRpc)
    for stats in (port, jax):
        stats['health'].pop('window_s')
    assert port['health'] == jax['health']
    assert port['health']['regime'] == 'decode-bound'
    assert port['stages'] == jax['stages']
    assert {k: v for k, v in port['tenants']['default'].items()} == \
        {k: v for k, v in jax['tenants']['default'].items()}
    assert 'health_regime_severity' in dispatcher.metrics.render_prometheus()


@watched(120)
def test_the_service_ships_records_and_the_tools_read_the_fleet(tmp_path, monkeypatch):
    """One dispatcher, one worker process, a ``ServiceDataLoader`` on the CPU:
    each batch's record names the worker's pid and a file's row group, with
    its stages on the client's clock; ``stats()['health']`` has a regime;
    ``diagnose``, ``top --once`` and ``why`` read the live dispatcher; its
    flight dump, persisted at exit, reads back through ``diagnose
    --flight`` in both packages alike."""
    from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader
    monkeypatch.delenv('PETASTORM_TPU_NO_PROVENANCE', raising=False)
    monkeypatch.setenv('PETASTORM_TPU_FLIGHT_DIR', str(tmp_path / 'flight'))
    url = write_raw(str(tmp_path / 'raw'), rows=64, group=16)
    config = ServiceConfig(url, num_consumers=1, rowgroups_per_split=1, lease_ttl_s=2.0,
                           reader_kwargs={'workers_count': 1})
    proc = None
    try:
        with Dispatcher(config) as dispatcher:
            proc = spawn_worker(dispatcher.addr)
            t_before = time.monotonic()
            loader = ServiceDataLoader(dispatcher.addr, 16, consumer=0, drop_last=False,
                                       device='cpu')
            ids = []
            with loader:
                for batch in loader:
                    ids.extend(batch['id'].tolist())
            t_after = time.monotonic()
            stats = loader.service_diagnostics()
            rc, out = _run(diagnose.main, ['--dispatcher', dispatcher.addr])
            assert rc == 0 and out.splitlines()[2].startswith(' 1. [')
            rc, out = _run(top.main, ['--dispatcher', dispatcher.addr, '--once'])
            assert rc == 0 and out.splitlines()[1].startswith('splits  pending')
            rc, out = _run(why.main, ['--dispatcher', dispatcher.addr])
            assert rc in (0, 1)
    finally:
        reap(proc)
    assert sorted(ids) == list(range(64))
    records = loader.provenance.records()
    assert len(records) == 4 and [r['step'] for r in records] == [0, 1, 2, 3]
    for record in records:
        assert record['source'] == 'service' and record['worker_pid'] == proc.pid
        assert record['worker_host'] == provenance.host()
        assert record['pieces'][0]['path'].endswith('data.parquet')
        assert record['transport'] in ('shm', 'bytes', 'mixed')
        assert record['sched'] == {'policy': 'fifo'}
        decode = record['stages']['decode']
        assert t_before - 1.0 <= decode[0] <= decode[1] <= t_after + 1.0
        assert {'client_buffer', 'host_batch', 'h2d_dispatch'} <= set(record['stages'])
    assert stats['health']['regime'] in health.REGIMES
    dumps = os.listdir(str(tmp_path / 'flight'))
    path = str(tmp_path / 'flight' / [n for n in dumps if n.startswith('flight_dispatcher_')
                                      and n.endswith('.json')][0])
    assert json.load(open(path))['reason'] == 'dispatcher_exit'
    rc, out = _same_cli(diagnose.main, jax_diagnose.main, ['--flight', path, '--json'])
    assert rc == 0 and json.loads(out)['source'].startswith('flight recorder (dispatcher_fleet')
    frames = json.load(open(path))['frames']
    assert health.report_from_frames(frames) == jax_health.report_from_frames(frames)
    assert flight.window_frames(frames, 5.0) == jax_flight.window_frames(frames, 5.0)
    assert jax_decisions.KILL_SWITCH == decisions.KILL_SWITCH

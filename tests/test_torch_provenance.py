"""The port's per-batch provenance (``petastorm_tpu_torch.telemetry.
provenance``, the pools' records, the loader's journal) against the JAX
package's, on the CPU.

The pure functions (``merge_records``, ``summarize_record``,
``cache_outcome``, ``shift_stages``, ``stage_coverage``, ``record_wall``,
the journal's seal, worst K and eviction, the registry's exemplars through
``snapshot``/``merge_snapshots``/``snapshot_delta``/``summarize_hist``) take
the same numpy-seeded inputs in both packages and must give equal outputs,
exactly.  End to end, both readers run on the same store and seed (the
dummy pool, the thread pool under adaptive dispatch, which delivers in
epoch order, and the process pool), and the records' non-timing fields
(``source``, ``position``, ``pieces``, the ``sched`` keys and policy,
``cache``, ``transport``, ``transfer``) must be equal step by step; timing
fields are compared for presence and order only (each stage window's start
at or before its end).  The kill switch must give the same batches bit for
bit and build nothing, in both packages.
"""

import copy
import json
import os

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax.loader import DataLoader as JaxDataLoader
from petastorm_tpu.telemetry import provenance as jax_prov
from petastorm_tpu.telemetry import registry as jax_registry

from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.telemetry import provenance as prov
from petastorm_tpu_torch.telemetry import registry

from test_common import create_test_dataset
from torch_pool_workers import ArangeWorker
from torch_service_common import drop_hot_tiers

ROWS = 40
ROWS_PER_GROUP = 5      # 8 row groups: one batch each
FIELDS = ['id', 'matrix']


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp('torch_prov')
    return create_test_dataset('file://' + str(path), num_rows=ROWS,
                               rows_per_rowgroup=ROWS_PER_GROUP)


@pytest.fixture(autouse=True)
def provenance_on(monkeypatch):
    monkeypatch.delenv('PETASTORM_TPU_NO_PROVENANCE', raising=False)


# -- the pure functions ------------------------------------------------------------

def _random_record(rng, source='pool'):
    t = float(rng.uniform(100.0, 200.0))
    stages = {}
    for name in rng.choice(['decode', 'ipc', 'release', 'ventilate', 'serialize'],
                           size=int(rng.integers(1, 5)), replace=False):
        t0 = t + float(rng.uniform(0, 1))
        stages[str(name)] = [t0, t0 + float(rng.uniform(0, 0.5))]
    record = {'v': 1, 'source': source, 'stages': stages,
              'worker_pid': int(rng.integers(1, 5)),
              'pieces': [{'index': int(i), 'path': '/d/part_%d.parquet' % (i % 2),
                          'row_group': int(i)} for i in rng.integers(0, 40, int(rng.integers(1, 4)))]}
    for key, choices in (('cache', ['decode', 'ram_hit', 'disk_hit']),
                         ('transport', ['shm', 'bytes', 'inline']),
                         ('worker_host', ['a', 'b']), ('tenant', ['t0', 't1']),
                         ('residency', ['admitted', 'evicted', 'hit'])):
        if rng.uniform() < 0.7:
            record[key] = str(rng.choice(choices))
    if rng.uniform() < 0.6:
        record['sched'] = {'policy': str(rng.choice(['fifo', 'adaptive'])),
                           'early': bool(rng.uniform() < 0.5),
                           'predicted_cost': float(rng.uniform(1, 10)),
                           'actual_s': round(float(rng.uniform(0, 1)), 6)}
    if rng.uniform() < 0.3:
        record['stage_busy_ms'] = {'serialize': round(float(rng.uniform(0, 5)), 3)}
    return record


@pytest.mark.parametrize('seed', range(6))
def test_merge_records_equals_jax(seed):
    rng = np.random.default_rng(seed)
    records = [_random_record(rng) for _ in range(int(rng.integers(0, 6)))]
    assert prov.merge_records(copy.deepcopy(records)) == \
        jax_prov.merge_records(copy.deepcopy(records))


@pytest.mark.parametrize('seed', range(4))
def test_record_arithmetic_equals_jax(seed):
    """``record_wall``, ``stage_coverage``, ``shift_stages`` and
    ``summarize_record`` on the same seeded records."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(8):
        record = _random_record(rng)
        record['step'], record['latency_ms'] = int(rng.integers(0, 50)), float(rng.uniform())
        offset = float(rng.uniform(-5, 5))
        assert prov.record_wall(record) == jax_prov.record_wall(record)
        assert prov.stage_coverage(record) == jax_prov.stage_coverage(record)
        assert prov.shift_stages(record, offset) == jax_prov.shift_stages(record, offset)
        assert prov.summarize_record(record) == jax_prov.summarize_record(record)
    empty = {'stages': {}}
    assert prov.record_wall(empty) == jax_prov.record_wall(empty) == 0.0
    assert prov.stage_coverage(empty) == jax_prov.stage_coverage(empty) == 0.0
    assert prov.summarize_record({}) == jax_prov.summarize_record({})


CACHE_CASES = [
    (None, {'cache_hits': 1}),
    ({'cache_hits': 0, 'cache_ram_hits': 0, 'cache_misses': 0, 'cache_degraded': 0},
     {'cache_hits': 0, 'cache_ram_hits': 0, 'cache_misses': 1, 'cache_degraded': 0}),
    ({'cache_hits': 2}, {'cache_hits': 3}),
    ({'cache_hits': 2, 'cache_ram_hits': 1}, {'cache_hits': 3, 'cache_ram_hits': 2}),
    ({'cache_degraded': 0, 'cache_hits': 0}, {'cache_degraded': 1, 'cache_hits': 1}),
    ({'cache_hits': 4}, {'cache_hits': 4}),
]


@pytest.mark.parametrize('before, after', CACHE_CASES)
def test_cache_outcome_equals_jax(before, after):
    assert prov.cache_outcome(before, after) == jax_prov.cache_outcome(before, after)


def _fill(journal, latencies, t=1000.0):
    for i, latency in enumerate(latencies):
        journal.seal(prov.make_record('pool', position=i, stages={'decode': [t, t + latency]}))


def test_journal_seal_worst_and_eviction_equal_jax():
    """Seal, the worst K past the ring's eviction, ``get`` of an evicted
    step, and the dump's records, on the same seeded latencies."""
    latencies = np.random.default_rng(7).exponential(0.01, 40).tolist()
    port = prov.ProvenanceJournal(capacity=16, worst_k=5, label='t')
    jax = jax_prov.ProvenanceJournal(capacity=16, worst_k=5, label='t')
    _fill(port, latencies)
    _fill(jax, latencies)

    def strip(records):
        return [{k: v for k, v in r.items() if k != 'sealed_unix'} for r in records]
    assert len(port) == len(jax) == 16
    assert strip(port.records()) == strip(jax.records())
    assert strip(port.worst()) == strip(jax.worst())
    worst_step = port.worst(1)[0]['step']
    assert strip([port.get(worst_step)]) == strip([jax.get(worst_step)])
    assert port.get(0) == jax.get(0) or (port.get(0) is None) == (jax.get(0) is None)
    assert port.worst_summary(3) == jax.worst_summary(3)
    dump = port.dump()
    assert dump['kind'] == 'provenance_journal' and dump['steps'] == 40


def test_histogram_exemplars_through_the_snapshot_algebra_equal_jax():
    """Exemplars ride ``snapshot``, re-rank in ``merge_snapshots``, keep
    only the window's in ``snapshot_delta`` and summarize in
    ``summarize_hist`` alike; the registries' own ``merge`` too."""
    rng = np.random.default_rng(11)
    samples = rng.exponential(0.01, 30).tolist()
    snaps = {}
    for name, mod in (('port', registry), ('jax', jax_registry)):
        a, b = mod.MetricsRegistry('a'), mod.MetricsRegistry('b')
        for i, s in enumerate(samples):
            (a if i % 2 else b).histogram('host_batch').observe(
                s, exemplar={'step': i} if i % 3 else None)
            a.counter('n').inc(1)
        old = a.snapshot()
        for i, s in enumerate(samples[:6]):
            a.histogram('host_batch').note_exemplar(s * 10, {'step': 100 + i})
            a.histogram('host_batch').observe(s)
        merged = mod.merge_snapshots([a.snapshot(), b.snapshot()])
        delta = mod.snapshot_delta(a.snapshot(), old)
        into = mod.MetricsRegistry('c')
        into.merge(a.snapshot())
        into.merge(b.snapshot())
        snaps[name] = {'merged': merged, 'delta': delta,
                       'summary': mod.summarize_hist(merged['histograms']['host_batch']),
                       'delta_summary': mod.summarize_hist(delta['histograms']['host_batch']),
                       'into': into.snapshot()['histograms'],
                       'empty_delta': mod.snapshot_delta(None, old),
                       'from_start': mod.snapshot_delta(old, None)}
    assert snaps['port'] == snaps['jax']
    assert snaps['port']['summary']['exemplar']['ref'] == {'step': 105}
    assert len(snaps['port']['merged']['histograms']['host_batch']['exemplars']) \
        == registry.EXEMPLARS_KEPT == jax_registry.EXEMPLARS_KEPT


# -- both readers end to end ---------------------------------------------------------

def _reader_records(make, url, pool, **kwargs):
    """Each row group's record as the reader delivers it (one take after
    each chunk)."""
    out = []
    with make(url, schema_fields=FIELDS, reader_pool_type=pool, workers_count=2,
              shuffle_row_groups=False, columnar_decode=True, **kwargs) as reader:
        for _ in reader:
            out.extend(reader.take_provenance())
    return out


def _loader_run(make, loader_cls, url, pool, loader_kwargs, **reader_kwargs):
    with make(url, schema_fields=FIELDS, reader_pool_type=pool, workers_count=2,
              shuffle_row_groups=False, columnar_decode=True, **reader_kwargs) as reader:
        loader = loader_cls(reader, ROWS_PER_GROUP, drop_last=False, **loader_kwargs)
        with loader:
            batches = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    return batches, loader


def _same_fields(port, jax, position=True):
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        keys = ('source', 'pieces', 'cache', 'transport', 'transfer') + \
            (('position',) if position else ())
        assert {k: p.get(k) for k in keys} == {k: j.get(k) for k in keys}
        assert set(p.get('sched') or {}) == set(j.get('sched') or {})
        assert (p.get('sched') or {}).get('policy') == (j.get('sched') or {}).get('policy')
        assert set(p['stages']) == set(j['stages'])
        for window in p['stages'].values():
            assert window[0] <= window[1]


@pytest.mark.parametrize('pool, scheduling', [('dummy', 'fifo'), ('thread', 'adaptive')])
def test_reader_records_equal_jax(dataset, pool, scheduling):
    kwargs = dict(scheduling=scheduling, ingest='off')
    port = _reader_records(make_reader, dataset.url, pool, **kwargs)
    jax = _reader_records(jax_make_reader, dataset.url, pool, **kwargs)
    _same_fields(port, jax)
    assert [r['position'] for r in port] == list(range(ROWS // ROWS_PER_GROUP))
    assert all(r['worker_pid'] == os.getpid() and r['worker_host'] == prov.host() for r in port)


@pytest.mark.parametrize('pool, scheduling', [('dummy', 'fifo'), ('thread', 'adaptive')])
def test_loader_journals_equal_jax(dataset, pool, scheduling):
    """One sealed record a batch in both loaders (inline delivery), the
    same non-timing fields, and the host_batch p99 exemplar resolving to a
    journaled step that names a file and row group."""
    kwargs = dict(scheduling=scheduling, ingest='off')
    got, port = _loader_run(make_reader, DataLoader, dataset.url, pool,
                            dict(device='cpu', autotune=False), **kwargs)
    want, jax = _loader_run(jax_make_reader, JaxDataLoader, dataset.url, pool,
                            dict(transfer=False, autotune=False), **kwargs)
    assert len(got) == len(want) == len(port.provenance) == len(jax.provenance)
    _same_fields(port.provenance.records(), jax.provenance.records(), position=False)
    assert [r['step'] for r in port.provenance.records()] == list(range(len(got)))
    assert {'decode', 'release', 'host_batch', 'transform', 'h2d_dispatch'} \
        <= set(port.provenance.records()[0]['stages'])
    exemplars = port.metrics.snapshot()['histograms']['host_batch']['exemplars']
    resolved = port.provenance.get(exemplars[-1]['ref']['step'])
    assert resolved['pieces'][0]['path'].endswith('.parquet')
    assert resolved['pieces'][0]['row_group'] is not None


def test_cache_plane_outcomes_equal_jax(dataset, tmp_path):
    """Two passes over ``cache_type='plane'``: the first decodes, the
    second hits, per record, in both packages."""
    try:
        outcomes = {}
        for name, make in (('port', make_reader), ('jax', jax_make_reader)):
            where = str(tmp_path / name)
            outcomes[name] = [[r.get('cache') for r in _reader_records(
                make, dataset.url, 'dummy', scheduling='fifo', ingest='off',
                cache_type='plane', cache_location=where)] for _ in range(2)]
        assert outcomes['port'] == outcomes['jax']
        assert set(outcomes['port'][0]) == {'decode'}
        assert set(outcomes['port'][1]) <= {'ram_hit', 'disk_hit'}
    finally:
        drop_hot_tiers(tmp_path)


def test_process_pool_record_survives_the_trailing_frame(dataset):
    """A child-built record rides the result message's trailing frame: the
    child's pid (not this process's), its transport, its decode and ipc
    windows, and the parent's release, with JAX's fields."""
    got, port = _loader_run(make_reader, DataLoader, dataset.url, 'process',
                            dict(device='cpu'), scheduling='fifo', ingest='off')
    want, jax = _loader_run(jax_make_reader, JaxDataLoader, dataset.url, 'process',
                            dict(transfer=False), scheduling='fifo', ingest='off')
    records = port.provenance.records()
    assert len(records) == len(got) == len(want)
    for record in records:
        assert record['worker_pid'] != os.getpid()
        assert record['worker_host'] == prov.host()
        assert record['transport'] in ('shm', 'bytes')
        assert {'decode', 'ipc', 'release'} <= set(record['stages'])
    assert sorted(r['pieces'][0]['row_group'] for r in records) == \
        sorted(r['pieces'][0]['row_group'] for r in jax.provenance.records())
    assert {r['transport'] for r in records} == {r['transport'] for r in jax.provenance.records()}


@pytest.mark.parametrize('pool', ['dummy', 'process'])
def test_kill_switch_is_bit_identical_and_inert(dataset, monkeypatch, pool):
    """``PETASTORM_TPU_NO_PROVENANCE=1``: the same batches bit for bit as
    with provenance on, no journal and no record, in both packages."""
    runs = {}
    for switch in ('0', '1'):
        monkeypatch.setenv('PETASTORM_TPU_NO_PROVENANCE', switch)
        runs[switch] = (_loader_run(make_reader, DataLoader, dataset.url, pool,
                                    dict(device='cpu'), scheduling='fifo', ingest='off'),
                        _loader_run(jax_make_reader, JaxDataLoader, dataset.url, pool,
                                    dict(transfer=False), scheduling='fifo', ingest='off'))
    for side in (0, 1):
        (on, on_loader), (off, off_loader) = runs['0'][side], runs['1'][side]
        assert len(on) == len(off) == ROWS // ROWS_PER_GROUP
        key = 'id'
        order_on = np.argsort(np.concatenate([b[key] for b in on]))
        order_off = np.argsort(np.concatenate([b[key] for b in off]))
        for field in on[0]:
            a = np.concatenate([b[field] for b in on])[order_on]
            b_ = np.concatenate([b[field] for b in off])[order_off]
            assert a.dtype == b_.dtype
            np.testing.assert_array_equal(a, b_)
        assert on_loader.provenance is not None and len(on_loader.provenance) == len(on)
        assert off_loader.provenance is None
        assert off_loader.reader.take_provenance() == []


class _RecordingSocket(object):
    """The pool's sink socket, keeping every message it receives."""

    def __init__(self, sock):
        self._sock = sock
        self.messages = []

    def recv_multipart(self, *args, **kwargs):
        frames = self._sock.recv_multipart(*args, **kwargs)
        self.messages.append([bytes(f) for f in frames])
        return frames

    def __getattr__(self, name):
        return getattr(self._sock, name)


def test_the_process_pools_framing_is_unchanged_under_the_kill_switch(monkeypatch):
    """Under ``PETASTORM_TPU_NO_PROVENANCE=1`` and no reorder stage a result
    message is ``[tag, payload]``, as without provenance; with it on, the same
    two frames and then the position and the record.  The byte path (an arena
    of one byte) makes the payloads comparable."""
    import pickle
    from petastorm_tpu_torch.workers_pool import EmptyResultError, shm_plane
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator
    monkeypatch.setattr(shm_plane, 'DEFAULT_CAPACITY_BYTES', 1)
    results = {}
    for switch in ('1', '0'):
        monkeypatch.setenv('PETASTORM_TPU_NO_PROVENANCE', switch)
        pool = ProcessPool(workers_count=1)
        ventilator = ConcurrentVentilator(pool.ventilate, [(i,) for i in range(1, 5)])
        pool.start(ArangeWorker, None, ventilator=ventilator)
        pool._sink_socket = sink = _RecordingSocket(pool._sink_socket)
        try:
            while True:
                try:
                    pool.get_results()
                except EmptyResultError:
                    break
        finally:
            pool.stop()
            pool.join()
        results[switch] = ([m for m in sink.messages if m[0] in (b'R', b'A', b'P', b'T')],
                           pool.take_provenance())
    (off, off_records), (on, on_records) = results['1'], results['0']
    assert len(off) == len(on) == 4 and off_records == []
    assert all(len(m) == 2 for m in off) and all(len(m) == 4 for m in on)
    assert [m[:2] for m in on] == off
    assert [pickle.loads(m[2]) for m in on] == [r['position'] for r in on_records] == \
        [0, 1, 2, 3]
    assert all(r['transport'] == 'bytes' and {'decode', 'ipc', 'release'} <= set(r['stages'])
               for r in on_records)


def test_the_ventilator_keeps_no_dispatch_meta_under_the_kill_switch(monkeypatch):
    from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator
    for switch, want in (('1', None), ('0', 'fifo')):
        monkeypatch.setenv('PETASTORM_TPU_NO_PROVENANCE', switch)
        seen = []
        vent = ConcurrentVentilator(ventilate_fn=seen.append, items=[(i,) for i in range(3)],
                                    iterations=1)
        vent.start()
        vent._thread.join(5)
        for item in seen:
            meta = vent.take_dispatch_meta(item.position)
            assert (meta or {}).get('policy') == want
        vent.stop()


# -- the SLO watchdog and the other delivery modes ---------------------------------

def test_slo_watchdog_zero_budget_dumps_the_same_records(tmp_path):
    """A zero budget: every record is a violation, the first dumps the whole
    journal, the rest are rate-limited; the same dump in both packages."""
    latencies = np.random.default_rng(3).exponential(0.01, 6).tolist()
    dumps = {}
    for name, mod in (('port', prov), ('jax', jax_prov)):
        journal = mod.ProvenanceJournal(label='slo')
        counts = registry.MetricsRegistry('slo') if name == 'port' \
            else jax_registry.MetricsRegistry('slo')
        dog = mod.SloWatchdog(journal, 0.0, label='slo', dump_dir=str(tmp_path / name),
                              metrics=counts)
        paths = []
        for i, latency in enumerate(latencies):
            record = journal.seal(mod.make_record('pool', position=i,
                                                  stages={'decode': [10.0, 10.0 + latency]}))
            paths.append(dog.check(record))
        assert dog.violations == len(latencies) == counts.counter('slo_violations').value
        assert paths[0] is not None and paths[1:] == [None] * (len(latencies) - 1)
        with open(paths[0]) as f:
            dump = json.load(f)
        for record in dump['records'] + dump['worst']:
            record.pop('sealed_unix')
        dump.pop('pid')
        dumps[name] = dump
    assert dumps['port'] == dumps['jax']
    assert dumps['port']['violation_step'] == 0 and len(dumps['port']['records']) == 1


def test_host_batches_and_scan_batches_seal_one_record_a_batch(dataset):
    """``iter_host_batches`` and ``scan_batches`` seal one record a batch,
    as the JAX loader's do."""
    with make_reader(dataset.url, schema_fields=FIELDS, reader_pool_type='dummy',
                     shuffle_row_groups=False, columnar_decode=True) as reader:
        loader = DataLoader(reader, ROWS_PER_GROUP, device='cpu', drop_last=False)
        with loader:
            n = len(list(loader.iter_host_batches()))
    assert len(loader.provenance) == n == ROWS // ROWS_PER_GROUP
    assert all('host_batch' in r['stages'] and r['pieces'] for r in loader.provenance.records())
    with make_reader(dataset.url, schema_fields=FIELDS, reader_pool_type='dummy',
                     shuffle_row_groups=False, columnar_decode=True) as reader:
        loader = DataLoader(reader, ROWS_PER_GROUP, device='cpu', drop_last=False)
        with loader:
            chunks = list(loader.scan_batches(lambda c, b: (c, b['id'].sum()), None,
                                              steps_per_call=3))
    assert len(chunks) == 3 and len(loader.provenance) == ROWS // ROWS_PER_GROUP
    assert [r['pieces'][0]['row_group'] for r in loader.provenance.records()] == \
        [0, 1, 2, 3, 4, 5, 6, 7]

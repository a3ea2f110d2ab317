"""The port's data service (``petastorm_tpu_torch.service``) against the JAX
package's, on the CPU.

Against JAX: the same splits from ``build_splits``, the same fingerprint,
chunks serialized by either side read back equal on the other, the ordered
mode's host batches equal to JAX's ``ServiceDataLoader``'s on the same
store (bit for bit after the device dtype rule), and two workers feeding
two consumers give each consumer JAX's row set, every row once.  The port
alone: lease expiry and the attempt cap at the dispatcher, a failing split
raising at the client, resume tokens through pickle, a changed geometry
raising, the shm and byte paths delivering the same, a worker subprocess
SIGKILLed while it holds a lease (every row once, no ``/dev/shm`` residue
of its pid), a SIGTERM drain, ``piece_indices`` on both readers, the shared
fleet's options and entry points working (their own files,
``test_torch_tenancy.py``, ``test_torch_service_ledger.py`` and
``test_torch_cluster_cache.py``, hold them against JAX), and each option
outside the slice raising with its ``ROADMAP.md`` item.

Every test that runs the wire runs under a watchdog of its own (a service
fault fails that test and does not hang the suite); lease TTLs stay at 2 s
or less.
"""

import functools
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.service import Dispatcher as JaxDispatcher
from petastorm_tpu.service import ServiceConfig as JaxServiceConfig
from petastorm_tpu.service import ServiceDataLoader as JaxServiceDataLoader
from petastorm_tpu.service import Worker as JaxWorker
from petastorm_tpu.service.dispatcher import build_splits as jax_build_splits
from petastorm_tpu.service.worker import deserialize_chunk as jax_deserialize_chunk
from petastorm_tpu.service.worker import serialize_chunk as jax_serialize_chunk

from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch.errors import ServiceError
from petastorm_tpu_torch.gpu.transfer import canonical_dtype
from petastorm_tpu_torch.predicates import in_set
from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader, Worker
from petastorm_tpu_torch.service.client import _default_consumer, register_tenant_job
from petastorm_tpu_torch.service.dispatcher import build_splits
from petastorm_tpu_torch.service.worker import deserialize_chunk, serialize_chunk
from petastorm_tpu_torch.workers_pool import shm_plane

from torch_plane_common import write_dataset

ROWS = 96               # 12 row groups of 8: 6 splits of 2
BATCH = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_service'), rows=ROWS)


@pytest.fixture(scope='module')
def raw(tmp_path_factory):
    """Plain Parquet with ~200 kB chunks, above the shm plane's floor (the
    petastorm store's chunks take the byte path by design)."""
    path = tmp_path_factory.mktemp('torch_service_raw')
    n = 192
    img = np.random.default_rng(0).integers(0, 255, (n, 64 * 64 * 3), dtype=np.uint8)
    pq.write_table(pa.table({'id': np.arange(n), 'img': list(img)}),
                   str(path) + '/data.parquet', row_group_size=16)
    return SimpleNamespace(url='file://%s' % path, rows=n)


def watched(timeout_s):
    """Run the test body on a thread and fail it after ``timeout_s``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            errors = []

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — raised on the test's thread
                    errors.append(e)
            thread = threading.Thread(target=body, daemon=True)
            thread.start()
            thread.join(timeout_s)
            if thread.is_alive():
                raise AssertionError('%s wedged for more than %ss' % (fn.__name__, timeout_s))
            if errors:
                raise errors[0]
        return run
    return wrap


def _config(cls, url, num_consumers=1, **overrides):
    overrides.setdefault('rowgroups_per_split', 2)
    overrides.setdefault('lease_ttl_s', 2.0)
    overrides.setdefault('reader_kwargs', {'workers_count': 2})
    return cls(url, num_consumers=num_consumers, **overrides)


def _host_ids(loader):
    with loader:
        return [i for b in loader.iter_host_batches() for i in np.asarray(b['id']).tolist()]


def _canonical(batch):
    """A host batch under the device dtype rule (int64 -> int32, float64 ->
    float32); strings as lists."""
    out = {}
    for key, value in batch.items():
        value = np.asarray(value)
        out[key] = value.tolist() if value.dtype.kind in 'OUS' \
            else value.astype(canonical_dtype(value.dtype))
    return out


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize('pieces,per_split,consumers', [(25, 4, 3), (12, 2, 2), (7, 3, 1),
                                                        (1, 5, 4)])
def test_build_splits_equals_jax(pieces, per_split, consumers):
    got = [s.describe() for s in build_splits(pieces, per_split, consumers)]
    want = [s.describe() for s in jax_build_splits(pieces, per_split, consumers)]
    assert [dict(w, tenant='default') for w in got] == want


def test_config_fingerprint_and_job_equal_jax(url):
    port = _config(ServiceConfig, url, num_consumers=3, rowgroups_per_split=4)
    ref = _config(JaxServiceConfig, url, num_consumers=3, rowgroups_per_split=4)
    assert port.fingerprint(5) == ref.fingerprint(5)
    ref_job = ref.job_info(5)
    assert {k: ref_job[k] for k in port.job_info(5)} == port.job_info(5)


_CHUNKS = {
    'flat': lambda: {'id': np.arange(5), 'name': np.array(['a', 'b', 'c', 'd', 'e']),
                     'x': np.linspace(0, 1, 5, dtype=np.float32)},
    'multi_dim': lambda: {'id': np.arange(3), 'image': np.arange(3 * 4 * 4 * 3, dtype=np.uint8)
                          .reshape(3, 4, 4, 3)},
    'ragged': lambda: {'id': np.arange(2), 'v': np.array([np.arange(2), np.arange(3)],
                                                         dtype=object)},
}


@pytest.mark.parametrize('kind', sorted(_CHUNKS))
@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
def test_chunks_cross_the_wire_both_ways(kind, direction):
    chunk = _CHUNKS[kind]()
    write, read = ((serialize_chunk, jax_deserialize_chunk) if direction == 'port_to_jax'
                   else (jax_serialize_chunk, deserialize_chunk))
    tag, payload = write(chunk)
    assert tag == (b'A' if kind == 'flat' else b'R')
    other_write = jax_serialize_chunk if write is serialize_chunk else serialize_chunk
    assert other_write(chunk)[0] == tag
    back = read(tag, payload)
    assert sorted(back) == sorted(chunk)
    for key, value in chunk.items():
        if value.dtype == object:
            assert [list(v) for v in back[key]] == [list(v) for v in value]
        else:
            assert back[key].tolist() == value.tolist()


def _jax_ordered_batches(url):
    config = _config(JaxServiceConfig, url, reader_kwargs={'workers_count': 1})
    with JaxDispatcher(config) as dispatcher, JaxWorker(dispatcher.addr):
        loader = JaxServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                      drop_last=False, ordered=True)
        with loader:
            return [_canonical(b) for b in loader.iter_host_batches()]


@watched(90)
def test_ordered_mode_equals_jax_batch_for_batch(url):
    want = _jax_ordered_batches(url)
    config = _config(ServiceConfig, url, reader_kwargs={'workers_count': 1})
    with Dispatcher(config) as dispatcher, Worker(dispatcher.addr):
        loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                   drop_last=False, ordered=True, device='cpu')
        with loader:
            got = [_canonical(b) for b in loader.iter_host_batches()]
    assert len(got) == len(want) == ROWS // BATCH
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if isinstance(w[key], list):
                assert g[key] == w[key], key
            else:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    # one consumer, ordered: the dataset's row order
    assert [i for b in got for i in b['id'].tolist()] == list(range(ROWS))


def _two_by_two(config_cls, dispatcher_cls, worker_cls, loader_cls, url, **loader_kwargs):
    config = _config(config_cls, url, num_consumers=2)
    per_consumer = [None, None]
    with dispatcher_cls(config) as dispatcher:
        with worker_cls(dispatcher.addr), worker_cls(dispatcher.addr):
            loaders = [loader_cls(dispatcher.addr, batch_size=BATCH, consumer=c,
                                  drop_last=False, **loader_kwargs) for c in (0, 1)]

            def pump(c):
                per_consumer[c] = _host_ids(loaders[c])
            threads = [threading.Thread(target=pump, args=(c,), daemon=True) for c in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
    return per_consumer


@watched(120)
def test_two_workers_two_consumers_deliver_each_row_once_as_jax(url):
    got = _two_by_two(ServiceConfig, Dispatcher, Worker, ServiceDataLoader, url, device='cpu')
    want = _two_by_two(JaxServiceConfig, JaxDispatcher, JaxWorker, JaxServiceDataLoader, url)
    assert None not in got and None not in want
    assert sorted(got[0] + got[1]) == list(range(ROWS))
    assert not set(got[0]) & set(got[1])
    for c in (0, 1):
        assert sorted(got[c]) == sorted(want[c])


# -- the dispatcher ------------------------------------------------------------

def test_lease_expiry_reassigns_exactly_once(url):
    dispatcher = Dispatcher(_config(ServiceConfig, url, lease_ttl_s=0.2), num_pieces=2)
    w0 = dispatcher._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    w1 = dispatcher._op_register_worker({'data_addr': 'tcp://x:2'})['worker_id']
    split = dispatcher._op_lease({'worker_id': w0})['split']
    assert split['attempt'] == 0
    for _ in range(3):   # heartbeats renew across several TTLs
        time.sleep(0.1)
        dispatcher._op_heartbeat({'worker_id': w0})
        dispatcher._expire_leases()
    assert dispatcher.lease_churn == 0
    time.sleep(0.3)
    dispatcher._expire_leases()
    dispatcher._expire_leases()   # a second sweep must not count again
    assert dispatcher.lease_churn == 1
    again = dispatcher._op_lease({'worker_id': w1})['split']
    assert (again['split_id'], again['attempt']) == (split['split_id'], 1)
    done = {'split_id': split['split_id']}
    assert not dispatcher._op_complete(dict(done, worker_id=w0, attempt=0))['ok']
    assert dispatcher._op_complete(dict(done, worker_id=w1, attempt=1))['ok']
    assert dispatcher._op_complete(dict(done, worker_id=w0, attempt=0))['ok']   # idempotent


def test_heartbeat_renews_only_held_splits(url):
    dispatcher = Dispatcher(_config(ServiceConfig, url, lease_ttl_s=0.2), num_pieces=4)
    w0 = dispatcher._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    a = dispatcher._op_lease({'worker_id': w0})['split']
    b = dispatcher._op_lease({'worker_id': w0})['split']
    time.sleep(0.3)
    dispatcher._op_heartbeat({'worker_id': w0, 'held': [b['split_id']]})
    dispatcher._expire_leases()
    assert dispatcher.lease_churn == 1
    again = dispatcher._op_lease({'worker_id': w0})['split']
    assert (again['split_id'], again['attempt']) == (a['split_id'], 1)


def test_attempt_cap_fails_the_split_terminally(url):
    dispatcher = Dispatcher(_config(ServiceConfig, url, lease_ttl_s=0.05, max_split_attempts=2),
                            num_pieces=2)
    w0 = dispatcher._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    for attempt in (0, 1):
        assert dispatcher._op_lease({'worker_id': w0})['split']['attempt'] == attempt
        time.sleep(0.1)
        dispatcher._expire_leases()
    assert dispatcher._op_lease({'worker_id': w0}) == {'done': True}
    assert dispatcher._op_workers({})['failed_splits'] == [0]
    assert dispatcher._op_stats({})['failed'] == 1


def test_mark_consumed_retires_pending_splits_and_drains_release(url):
    dispatcher = Dispatcher(_config(ServiceConfig, url), num_pieces=8)
    assert dispatcher._op_mark_consumed({'split_ids': [0, 2]})['retired'] == 2
    w0 = dispatcher._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    first = dispatcher._op_lease({'worker_id': w0})['split']
    assert dispatcher._op_release({'worker_id': w0, 'split_id': first['split_id'],
                                   'attempt': 0})['ok']
    leased = set()
    while True:
        reply = dispatcher._op_lease({'worker_id': w0})
        if 'split' not in reply:
            break
        assert reply['split']['attempt'] == 0   # a release keeps the attempt
        leased.add(reply['split']['split_id'])
    assert leased == {1, 3}
    assert dispatcher._op_drain({'worker_id': w0})['ok']
    assert dispatcher._op_lease({'worker_id': w0}) == {'wait': True, 'drain': True}
    assert dispatcher._op_deregister({'worker_id': w0, 'timed_out': True})['ok']
    stats = dispatcher._op_stats({})
    assert (stats['lease_churn'], stats['pending'], stats['control_plane']['drains'],
            stats['control_plane']['drain_timeouts']) == (2, 2, 1, 1)


@watched(60)
def test_a_split_that_never_decodes_raises_at_the_client(url):
    config = _config(ServiceConfig, url, lease_ttl_s=0.3, max_split_attempts=2,
                     reader_kwargs={'predicate': in_set({1}, 'no_such_field')})
    with Dispatcher(config) as dispatcher, Worker(dispatcher.addr):
        loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0, device='cpu')
        with pytest.raises(ServiceError, match='failed every decode attempt'):
            _host_ids(loader)


# -- resume tokens -------------------------------------------------------------

def _service(url, **overrides):
    dispatcher = Dispatcher(_config(ServiceConfig, url, **overrides)).start()
    return dispatcher, Worker(dispatcher.addr).start()


def _shutdown(dispatcher, worker):
    worker.stop()
    worker.join()
    dispatcher.stop()
    dispatcher.join()


@watched(90)
def test_resume_token_round_trips_through_pickle(url):
    dispatcher, worker = _service(url)
    loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0, drop_last=False,
                               device='cpu')
    gen = loader.iter_host_batches()
    consumed = [i for _ in range(3) for i in np.asarray(next(gen)['id']).tolist()]
    state = pickle.loads(pickle.dumps(loader.state_dict()))
    loader.reader.stop()
    loader.reader.join()
    _shutdown(dispatcher, worker)
    assert state['reader']['service']['consumed']
    assert set(state) >= {'version', 'batched', 'reader', 'pending', 'pushback', 'chunks'}
    dispatcher, worker = _service(url)
    try:
        resumed = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, drop_last=False,
                                    resume_state=state, device='cpu')
        rest = _host_ids(resumed)
    finally:
        _shutdown(dispatcher, worker)
    assert sorted(consumed + rest) == list(range(ROWS))


@watched(90)
def test_a_changed_geometry_raises(url):
    dispatcher, worker = _service(url)
    try:
        loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0, device='cpu')
        next(loader.iter_host_batches())
        state = loader.state_dict()
        loader.reader.stop()
        loader.reader.join()
    finally:
        _shutdown(dispatcher, worker)
    dispatcher, worker = _service(url, rowgroups_per_split=3)
    try:
        with pytest.raises(ServiceError, match='different service job'):
            ServiceDataLoader(dispatcher.addr, batch_size=BATCH, resume_state=state,
                              device='cpu')
    finally:
        _shutdown(dispatcher, worker)


# -- delivery paths ------------------------------------------------------------

def _raw_batches(raw, shm):
    config = ServiceConfig(raw.url, rowgroups_per_split=2, lease_ttl_s=2.0, shm=shm,
                           reader_kwargs={'workers_count': 1})
    with Dispatcher(config) as dispatcher:
        with Worker(dispatcher.addr) as worker:
            loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                       ordered=True, drop_last=False, device='cpu')
            with loader:
                batches = [{k: np.array(v) for k, v in b.items()}
                           for b in loader.iter_host_batches()]
                client = loader.service_diagnostics()['client']
            return batches, worker.diagnostics, client


@watched(90)
def test_shm_and_byte_paths_deliver_the_same(raw):
    if not shm_plane.available():
        pytest.skip('no usable /dev/shm on this host')
    via_shm, worker_shm, client_shm = _raw_batches(raw, shm=True)
    via_bytes, worker_bytes, client_bytes = _raw_batches(raw, shm=False)
    assert worker_shm['shm_chunks'] > 0 and client_shm['shm_chunks'] == worker_shm['shm_chunks']
    assert worker_bytes['shm_chunks'] == 0 and client_bytes['byte_chunks'] > 0
    assert len(via_shm) == len(via_bytes) == raw.rows // BATCH
    for a, b in zip(via_shm, via_bytes):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert [i for b in via_shm for i in b['id'].tolist()] == list(range(raw.rows))
    assert shm_plane.residue([os.getpid()]) == set()


@watched(60)
def test_the_loader_moves_service_batches_to_its_device(url):
    dispatcher, worker = _service(url)
    try:
        with ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0, device='cpu',
                               transfer=True) as loader:
            batches = list(loader)
    finally:
        _shutdown(dispatcher, worker)
    assert sorted(i for b in batches for i in b['id'].tolist()) == list(range(ROWS))
    assert all(b['id'].dtype == torch.int32 and b['decimal_like'].dtype == torch.float32
               and b['id'].device.type == 'cpu' for b in batches)


_WORKER_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
from petastorm_tpu_torch.service.worker import Worker
worker = Worker(sys.argv[1])
worker.install_signal_handlers()
worker.run()
assert 'torch' not in sys.modules and 'jax' not in sys.modules
"""


def _spawn_worker(dispatcher_addr):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    return subprocess.Popen([sys.executable, '-c', _WORKER_CHILD, dispatcher_addr, REPO],
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError('timed out waiting for %s' % what)


@watched(120)
def test_a_worker_killed_while_it_holds_a_lease_loses_no_row(raw):
    """The victim serves alone first.  With one credit and room for one
    split the client, which pulls nothing yet, stops granting credits after
    two splits, so the victim holds leases it cannot finish: the SIGKILL
    lands on a held lease by construction.  The survivor then takes the
    expired leases; every row arrives once, the client's sweep removes the
    victim's slabs, and the survivor's SIGTERM drain leaves none."""
    config = ServiceConfig(raw.url, rowgroups_per_split=2, lease_ttl_s=1.0,
                           reader_kwargs={'workers_count': 1})
    with Dispatcher(config) as dispatcher:
        stats = lambda: dispatcher._op_stats({})  # noqa: E731
        victim = _spawn_worker(dispatcher.addr)
        survivor = None
        try:
            _wait_for(lambda: len(stats()['workers']) == 1, 60, 'the victim to register')
            loader = ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                       drop_last=False, queue_splits=1, credits=1,
                                       device='cpu')
            _wait_for(lambda: stats()['done'] >= 1 and stats()['leased'] >= 1, 60,
                      'the victim to stream and hold leases')
            time.sleep(0.3)
            held = stats()
            assert held['leased'] >= 1 and held['done'] + held['leased'] < held['num_splits']
            victim.kill()
            victim.wait(timeout=30)
            survivor = _spawn_worker(dispatcher.addr)
            ids = _host_ids(loader)
            assert sorted(ids) == list(range(raw.rows)), (
                sorted(set(range(raw.rows)) - set(ids))[:8])
            assert stats()['lease_churn'] >= 1
            assert loader.reader.diagnostics['shm_chunks'] > 0
            assert shm_plane.residue([victim.pid]) == set()
            survivor.send_signal(signal.SIGTERM)   # a drain, then a clean exit
            assert survivor.wait(timeout=30) == 0, survivor.stderr.read().decode()[-2000:]
            assert shm_plane.residue([survivor.pid]) == set()
            assert stats()['control_plane']['drains'] == 1
        finally:
            for proc in (victim, survivor):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)


@watched(60)
def test_the_client_records_each_split_wait(url):
    """With a trace recorder the client's wait for each split is a
    ``service/split_wait`` span (one per split, and one for the end of the
    stream); the workers ship no spans."""
    from petastorm_tpu_torch.benchmark import TraceRecorder
    recorder = TraceRecorder()
    dispatcher, worker = _service(url)
    try:
        ids = _host_ids(ServiceDataLoader(dispatcher.addr, batch_size=BATCH, consumer=0,
                                          device='cpu', trace_recorder=recorder))
    finally:
        _shutdown(dispatcher, worker)
    assert sorted(ids) == list(range(ROWS))
    service = [e for e in recorder.events if e['name'].startswith('service/')]
    assert {e['name'] for e in service} == {'service/split_wait'}
    assert len(service) == ROWS // 16 + 1
    assert all(e['pid'] == os.getpid() for e in service)


def test_the_backoff_schedule_widens_and_gives_up():
    from petastorm_tpu_torch.service.backoff import HEARTBEAT_POLICY, jittered
    episode = HEARTBEAT_POLICY.episode()
    delays = []
    while not episode.give_up():
        delays.append(episode.next_delay())
    assert len(delays) == 8
    assert all(0.2 <= d <= min(5.0, 0.2 * 2 ** i) for i, d in enumerate(delays))
    assert all(0.9 <= jittered(1.0, 0.1) <= 1.1 for _ in range(100))


# -- piece_indices on both readers ---------------------------------------------

def _rows(reader):
    with reader:
        return [int(r.id) for r in reader]


@pytest.mark.parametrize('indices', [[0], [3, 1], [11, 0, 5]])
def test_piece_indices_read_those_row_groups_as_jax(url, indices):
    kwargs = dict(piece_indices=indices, reader_pool_type='dummy', shuffle_row_groups=False)
    want = _rows(jax_make_reader(url, scheduling='fifo', ingest='off', **kwargs))
    assert _rows(make_reader(url, **kwargs)) == want
    assert want == [i for g in indices for i in range(8 * g, 8 * g + 8)]
    with make_batch_reader(url, **kwargs) as reader:
        got = [i for chunk in reader for i in chunk.id.tolist()]
    with jax_make_batch_reader(url, scheduling='fifo', ingest='off', **kwargs) as reader:
        assert got == [i for chunk in reader for i in chunk.id.tolist()] == want


@pytest.mark.parametrize('kwargs,match', [(dict(piece_indices=[12]), 'out of range'),
                                          (dict(piece_indices=[0], cur_shard=0, shard_count=2),
                                           'do not compose'),
                                          (dict(piece_indices=[0], filters=[('id', '<', 4)]),
                                           'renumber')])
def test_piece_indices_raise_where_jax_does(url, kwargs, match):
    for factory in (make_reader, make_batch_reader):
        with pytest.raises(ValueError, match=match):
            factory(url, reader_pool_type='dummy', **kwargs)
    with pytest.raises(ValueError, match=match):
        jax_make_reader(url, reader_pool_type='dummy', **kwargs)


# -- outside the slice ---------------------------------------------------------

@pytest.mark.parametrize('field,value', [
    ('autoscale', True), ('autoscale_max_workers', 4), ('scheduling', 'adaptive'),
    ('ingest', 'plane'), ('heartbeat_interval_s', 1.0), ('max_buffered_chunks', 8),
    ('max_inflight_splits', 1), ('telemetry_spans', False), ('reader_factory', 'batch_reader')])
def test_config_options_outside_the_slice_raise(url, field, value):
    with pytest.raises(ValueError, match='ROADMAP.md, Queue A item 7') as info:
        ServiceConfig(url, **{field: value})
    assert field in str(info.value)


#: the shared fleet's options, each with what it needs beside it
_FLEET_OPTIONS = {'cache_plane': dict(cache_plane_dir='/tmp/plane'),
                  'cluster_cache': dict(cache_plane=True, cache_plane_dir='/tmp/plane')}


@pytest.mark.parametrize('field,value', [
    ('cache_plane', True), ('cache_plane_dir', '/tmp/plane'), ('cache_plane_ram_bytes', 1),
    ('cache_plane_disk_bytes', 1), ('cluster_cache', True), ('ledger_path', '/tmp/ledger'),
    ('tenant', 'other'), ('tenant_weight', 2.0), ('max_tenant_jobs', 2),
    ('tenant_shm_quota_bytes', 1), ('tenant_cache_quota_bytes', 1)])
def test_config_options_of_the_shared_fleet_work_as_jax(url, field, value):
    kwargs = dict(_FLEET_OPTIONS.get(field, {}), **{field: value})
    port, ref = ServiceConfig(url, **kwargs), JaxServiceConfig(url, **kwargs)
    assert getattr(port, field) == getattr(ref, field) == value
    assert port.job_info(3) == ref.job_info(3)
    assert port.fingerprint(3) == ref.fingerprint(3)


@watched(60)
def test_tenancy_entry_points_work(url):
    """``register_tenant_job`` adds a tenant's job to a running dispatcher,
    and ``ServiceDataLoader(tenant=)`` consumes it; an unknown tenant raises."""
    config = _config(ServiceConfig, url)
    with Dispatcher(config) as dispatcher:
        job = register_tenant_job(dispatcher.addr, 'other',
                                  {'dataset_url': url, 'rowgroups_per_split': 3})
        assert (job['tenant'], job['split_base'], job['num_splits']) == ('other', 6, 4)
        with Worker(dispatcher.addr):
            loader = ServiceDataLoader(dispatcher.addr, BATCH, tenant='other', device='cpu')
            assert sorted(_host_ids(loader)) == list(range(ROWS))
        with pytest.raises(ServiceError, match='unknown tenant'):
            ServiceDataLoader(dispatcher.addr, BATCH, tenant='nobody', device='cpu')


def test_the_default_consumer_is_zero_without_a_group():
    assert _default_consumer(3) == 0

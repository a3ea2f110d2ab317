"""The port's process pool (ZeroMQ, results over ``/dev/shm``) against its
thread pool and against the JAX package's process pool.

The dataset is the JAX package's ``TestSchema`` (PNG, .npy and zlib .npy
tensors, strings, a nullable scalar), written by the JAX package's writer
with row groups of 50 rows, large enough that every result clears the shm
plane's 32 KiB floor.  With one worker and no row-group shuffle every pool
delivers the row groups in their order, so rows and columnar batches must
be equal bit for bit, dtypes included; with three workers the order is the
workers' completion order and the rows must be the same multiset.
"""

import os
import pickle
import time

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader

from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.workers_pool import shm_plane
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase

from test_common import create_test_dataset

pytestmark = pytest.mark.timeout(180)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp('torch_procds')
    return create_test_dataset('file://' + str(path), num_rows=100, rows_per_rowgroup=50)


def _read(read, url, **kwargs):
    """Everything a reader yields, and the pool's counters and processes
    after ``stop`` and ``join``."""
    reader = read(url, shuffle_row_groups=False, **kwargs)
    with reader:
        items = list(reader)
    pool = getattr(reader, '_pool', None)
    return items, getattr(reader, 'diagnostics', {}), getattr(pool, '_processes', [])


def _assert_same(a, b, tag):
    """Two values equal bit for bit: arrays by dtype, shape and bytes
    (object arrays element by element), NaN equal to NaN."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, \
            (tag, a.dtype, getattr(b, 'dtype', type(b)), a.shape, getattr(b, 'shape', None))
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a, b)):
                _assert_same(x, y, '%s[%d]' % (tag, i))
        else:
            assert a.tobytes() == b.tobytes(), tag
        return
    assert type(a) is type(b), (tag, type(a), type(b))
    assert a == b or (a != a and b != b), (tag, a, b)


def _assert_items_equal(got, want, tag):
    assert len(got) == len(want), (tag, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g._fields == w._fields, (tag, g._fields, w._fields)
        for name in g._fields:
            _assert_same(getattr(g, name), getattr(w, name), '%s item %d %s' % (tag, i, name))


@pytest.mark.parametrize('columnar_decode', [False, True], ids=['rows', 'columnar'])
def test_process_pool_matches_thread_pool_and_jax(dataset, columnar_decode, monkeypatch):
    """One worker, no shuffle: the port's process pool delivers what its
    thread pool and the JAX package's process pool deliver, bit for bit,
    and its results came through the shm plane.  The JAX pool takes its
    byte path, so that its slabs never meet the JAX package's own
    /dev/shm residue checks running beside this test."""
    process, diag, children = _read(make_reader, dataset.url, reader_pool_type='process',
                                    workers_count=1, columnar_decode=columnar_decode)
    thread, _, _ = _read(make_reader, dataset.url, reader_pool_type='thread', workers_count=1,
                         columnar_decode=columnar_decode)
    monkeypatch.setenv('PETASTORM_TPU_NO_SHM', '1')
    jax, _, _ = _read(jax_make_reader, dataset.url, reader_pool_type='process',
                      workers_count=1, columnar_decode=columnar_decode, scheduling='fifo',
                      ingest='off')
    assert len(process) == (2 if columnar_decode else 100)
    _assert_items_equal(process, thread, 'process vs thread')
    _assert_items_equal(process, jax, 'process vs jax process')
    assert diag['items_processed'] == 2 and diag['shm_results'] == 2, diag
    assert diag['worker_pids'] == [p.pid for p in children]
    assert all(p.poll() is not None for p in children)
    assert shm_plane.residue(diag['worker_pids']) == set()


def test_three_workers_deliver_the_same_rows(dataset):
    rows, diag, children = _read(make_reader, dataset.url, reader_pool_type='process',
                                 workers_count=3, num_epochs=2)
    want, _, _ = _read(make_reader, dataset.url, reader_pool_type='thread', workers_count=1,
                       num_epochs=2)
    order = lambda items: sorted(items, key=lambda r: int(r.id))  # noqa: E731
    _assert_items_equal(order(rows), order(want), '3 workers')
    assert diag['items_processed'] == 4 and len(children) == 3
    assert all(p.poll() is not None for p in children)


def test_shm_and_byte_paths_deliver_the_same(dataset, monkeypatch):
    """An arena of one byte sends every result down the byte path, with
    ZeroMQ's copy of the payload and without it (``zmq_copy_buffers``)."""
    by_path = {}
    for label, capacity, copy in (('shm', shm_plane.DEFAULT_CAPACITY_BYTES, True),
                                  ('bytes', 1, True), ('bytes, no copy', 1, False)):
        monkeypatch.setattr(shm_plane, 'DEFAULT_CAPACITY_BYTES', capacity)
        for columnar in (False, True):
            items, diag, _ = _read(make_reader, dataset.url, reader_pool_type='process',
                                   workers_count=1, columnar_decode=columnar,
                                   zmq_copy_buffers=copy)
            by_path[label, columnar] = items
            assert diag['shm_results'] == (2 if label == 'shm' else 0), (label, diag)
    for label in ('bytes', 'bytes, no copy'):
        for columnar in (False, True):
            _assert_items_equal(by_path['shm', columnar], by_path[label, columnar],
                                'shm vs %s, columnar=%s' % (label, columnar))


def _boom(_row):
    raise RuntimeError('process worker boom')


def test_worker_exception_reaches_the_caller_and_shutdown_is_clean(dataset):
    reader = make_reader(dataset.url, transform_spec=TransformSpec(_boom),
                         reader_pool_type='process', workers_count=2)
    with pytest.raises(RuntimeError, match='process worker boom'):
        with reader:
            list(reader)
    assert all(p.poll() is not None for p in reader._pool._processes)
    assert shm_plane.residue(reader.diagnostics['worker_pids']) == set()


def test_unpicklable_transform_raises_at_make_reader(dataset):
    def local_closure(row):
        return row

    with pytest.raises((AttributeError, TypeError, pickle.PicklingError)):
        make_reader(dataset.url, transform_spec=TransformSpec(local_closure),
                    reader_pool_type='process', workers_count=1)


class _NoopWorker(WorkerBase):
    def process(self, *args, **kwargs):
        pass


class _PidWorker(WorkerBase):
    """Publishes the pid of the process that took each item."""

    def process(self, item):
        time.sleep(0.05)
        self.publish_func([os.getpid(), item])


def test_items_spread_over_every_worker():
    """Items ventilated as the pool starts reach every worker, not only the
    first one to connect."""
    from petastorm_tpu_torch.workers_pool import EmptyResultError
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator
    pool = ProcessPool(workers_count=3)
    ventilator = ConcurrentVentilator(pool.ventilate, [(i,) for i in range(9)],
                                      max_ventilation_queue_size=6)
    pool.start(_PidWorker, None, ventilator=ventilator)
    results = []
    try:
        while True:
            try:
                results.append(pool.get_results())
            except EmptyResultError:
                break
    finally:
        pool.stop()
        pool.join()
    assert sorted(item for _, item in results) == list(range(9))
    assert {pid for pid, _ in results} == {p.pid for p in pool._processes}
    assert all(p.poll() is not None for p in pool._processes)
    # every worker took an item, so all but three items are a warm worker's
    assert pool.items_processed == 9 and pool.warm_items == 6
    assert 0 < pool.warm_busy_time < pool.busy_time


def test_worker_exits_when_its_parent_vanishes(tmp_path):
    """A worker whose pool's parent is gone leaves its poll loop instead of
    waiting in recv for a STOP that never comes."""
    import zmq

    from petastorm_tpu_torch.workers_pool.exec_in_new_process import exec_in_new_process
    from petastorm_tpu_torch.workers_pool.process_worker import worker_main

    context = zmq.Context()
    work_addr = 'ipc://%s' % (tmp_path / 'work')
    sink_addr = 'ipc://%s' % (tmp_path / 'sink')
    work = context.socket(zmq.PUSH)
    work.bind(work_addr)
    sink = context.socket(zmq.PULL)
    sink.bind(sink_addr)
    try:
        # above the kernel's default pid_max: no such process
        dead_parent = 2 ** 22 - 1
        payload = pickle.dumps((_NoopWorker, None, work_addr, sink_addr, True, False, 0,
                                dead_parent), protocol=4)
        child = exec_in_new_process(worker_main, payload, 0)
        t0 = time.monotonic()
        assert child.wait(timeout=30) == 0
        assert time.monotonic() - t0 < 25
    finally:
        work.close(0)
        sink.close(0)
        context.term()


def test_sweep_reclaims_a_dead_writers_slab_only():
    """A slab whose writer died is swept; a live writer's is not."""
    arena = shm_plane.ShmArena(capacity_bytes=1 << 20, min_bytes=0)
    try:
        live = arena.allocate(100)[0]
        dead = '%s%d-abcdef-0' % (shm_plane.PREFIX, 2 ** 22 - 1)
        with open(os.path.join(shm_plane.SHM_DIR, dead), 'wb') as f:
            f.write(b'\0' * 64)
        mine = shm_plane.residue([os.getpid()])
        assert live in mine and dead not in mine
        removed = shm_plane.sweep_orphans()
        assert dead in removed and live not in removed
        assert live in shm_plane.residue() and dead not in shm_plane.residue()
    finally:
        arena.stop()
    assert live not in shm_plane.residue()


def test_a_slab_is_reused_only_after_its_views_die():
    arena = shm_plane.ShmArena(capacity_bytes=1 << 20, min_bytes=0)
    try:
        payload = {'x': np.arange(1000, dtype=np.float32)}
        desc = shm_plane.write_columns(arena, payload)
        got = shm_plane.read_payload(desc)
        np.testing.assert_array_equal(got['x'], payload['x'])
        second = shm_plane.write_columns(arena, payload)
        assert second['segment'] != desc['segment']   # the first is still held
        del got
        import gc
        gc.collect()
        third = shm_plane.write_columns(arena, payload)
        assert third['segment'] == desc['segment'] and third['gen'] == desc['gen'] + 1
        shm_plane.release_descriptor(second)
        shm_plane.release_descriptor(third)
    finally:
        arena.stop()

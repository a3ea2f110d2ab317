"""The port's ingest plane (``petastorm_tpu_torch.ingest``) against the JAX
package's, on the CPU.

Case by case as ``tests/test_ingest_plane.py``, with millisecond latencies:
the planner's golden cases (``coalesce``, ``column_chunk_ranges``,
``read_footer``, ``plan_stats`` on one Parquet file, equal to JAX's), the
union plan serving a predicate's two passes and missing outside it,
``SparseFile``; through the readers, delivery with the plane equal to the
synchronous read and to JAX's on the thread and dummy pools (and over the
cold-store emulation), the process pool resolving off, the kill switch,
``'auto'`` on a wrapper whose ``protocol`` is ``'s3'``, a fetch failure
degrading per piece, result-cache hits releasing their prefetched entries;
at the plane's level, the hedge's winner and loser, demand promotion past a
full window, ``close()`` unblocking a checkout, ``set_window`` growing the
fetch pool, the per-worker open-file LRU; and a service worker whose split
readers mount the plane delivering what the JAX worker delivers.
"""

import os
import shutil
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu
from petastorm_tpu import ingest as jax_ingest

from petastorm_tpu_torch import ingest
from petastorm_tpu_torch.fs_utils import LocalFilesystem
from petastorm_tpu_torch.ingest import (IngestMissError, IngestPlane, SparseFile, coalesce,
                                        column_chunk_ranges, read_footer, resolve_ingest)
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.test_util.chaos import FlakyOpenFilesystem
from petastorm_tpu_torch.test_util.emulation import BandwidthLimitedFilesystem

from torch_plane_common import write_dataset
from torch_service_common import watched

ROWS = 96   # 12 row groups of 8


# -- the planner --------------------------------------------------------------------

@pytest.mark.parametrize('ranges,kwargs', [
    ([(0, 10), (10, 10)], dict(merge_gap=0)),
    ([(0, 10), (15, 10)], dict(merge_gap=5)),
    ([(0, 10), (16, 10)], dict(merge_gap=5)),
    ([(30, 5), (0, 10), (10, 0)], dict(merge_gap=0)),
    ([(0, 100)], dict(merge_gap=0, max_range_bytes=40)),
    ([(0, 30), (30, 30)], dict(merge_gap=0, max_range_bytes=40)),
    ([(5, 7), (100, 3), (50, 50), (12, 1)], dict()),
])
def test_coalesce_equals_jax(ranges, kwargs):
    got = coalesce(ranges, **kwargs)
    assert got == jax_ingest.coalesce(ranges, **kwargs)
    assert ingest.plan_stats(ranges, got) == jax_ingest.planner.plan_stats(ranges, got)


def test_coalesce_golden_cases():
    assert coalesce([(0, 10), (10, 10)], merge_gap=0) == [(0, 20)]
    assert coalesce([(0, 10), (15, 10)], merge_gap=5) == [(0, 25)]
    assert coalesce([(0, 10), (16, 10)], merge_gap=5) == [(0, 10), (16, 10)]
    assert coalesce([(30, 5), (0, 10), (10, 0)], merge_gap=0) == [(0, 10), (30, 5)]
    assert coalesce([(0, 100)], merge_gap=0, max_range_bytes=40) == [(0, 40), (40, 40), (80, 20)]
    assert coalesce([(0, 30), (30, 30)], merge_gap=0, max_range_bytes=40) == [(0, 30), (30, 30)]


@pytest.fixture(scope='module')
def parquet_file(tmp_path_factory):
    """Two row groups of 32 rows with an incompressible payload, so that the
    file outgrows the 64 KiB footer tail and a plan can miss."""
    path = str(tmp_path_factory.mktemp('torch_ingest_pq') / 'probe.parquet')
    rng = np.random.default_rng(0)
    pq.write_table(pa.table({
        'idx': pa.array(np.arange(64, dtype=np.int64)),
        'label': pa.array(np.arange(64, dtype=np.int32)),
        'payload': pa.array([rng.integers(0, 256, 8192).astype(np.uint8).tobytes()
                             for _ in range(64)], type=pa.binary())}), path, row_group_size=32)
    return path


@pytest.mark.parametrize('columns', [None, {'idx'}, {'idx', 'payload'}, {'nope'}])
@pytest.mark.parametrize('row_group', [0, 1])
def test_the_footer_and_column_chunk_ranges_equal_jax(parquet_file, columns, row_group):
    size = os.path.getsize(parquet_file)
    with open(parquet_file, 'rb') as handle:
        metadata, tail_offset, tail = read_footer(handle, size)
    with open(parquet_file, 'rb') as handle:
        jax_metadata, jax_offset, jax_tail = jax_ingest.read_footer(handle, size)
    assert (tail_offset, tail) == (jax_offset, jax_tail)
    assert metadata.equals(jax_metadata)
    got = column_chunk_ranges(metadata, row_group, columns)
    assert got == jax_ingest.column_chunk_ranges(jax_metadata, row_group, columns)
    full = column_chunk_ranges(metadata, row_group, None)
    if columns == {'idx'}:
        assert sum(n for _, n in got) < sum(n for _, n in full)
    if columns == {'nope'}:
        assert got == full   # schema drift over-fetches rather than missing pages
    with pytest.raises(ingest.IngestPlanError):
        column_chunk_ranges(metadata, 9, None)


def test_read_footer_refuses_what_is_not_parquet(tmp_path):
    path = tmp_path / 'x.bin'
    path.write_bytes(b'not parquet at all' * 10)
    with open(path, 'rb') as handle, pytest.raises(ingest.IngestPlanError, match='magic'):
        read_footer(handle, os.path.getsize(path))
    with pytest.raises(ingest.IngestPlanError, match='too small'):
        read_footer(None, 4)


def _segments(parquet_file, columns, merge_gap=ingest.planner.DEFAULT_MERGE_GAP):
    size = os.path.getsize(parquet_file)
    with open(parquet_file, 'rb') as handle:
        metadata, tail_offset, tail = read_footer(handle, size)
        segments = {tail_offset: tail}
        for offset, n in coalesce(column_chunk_ranges(metadata, 0, columns), merge_gap):
            handle.seek(offset)
            segments[offset] = handle.read(n)
    return size, segments


def test_a_union_plan_serves_a_predicate_s_two_passes_and_misses_outside(parquet_file):
    size, segments = _segments(parquet_file, {'idx', 'payload'})
    pf = pq.ParquetFile(SparseFile(size, segments))
    direct = pq.ParquetFile(parquet_file)
    for column in ('idx', 'payload'):
        assert pf.read_row_group(0, columns=[column]).equals(
            direct.read_row_group(0, columns=[column]))
    size, tight = _segments(parquet_file, {'idx', 'payload'}, merge_gap=0)
    with pytest.raises(IngestMissError):
        pq.ParquetFile(SparseFile(size, tight)).read_row_group(0, columns=['label'])


def test_sparse_file_reads_as_jax_s():
    segments = {0: b'0123456789', 10: b'abcdefghij'}
    for cls in (SparseFile, jax_ingest.SparseFile):
        sf = cls(20, segments)
        assert sf.seek(-5, 2) == 15 and sf.read() == b'fghij'
        sf.seek(8)
        assert sf.read(4) == b'89ab' and sf.tell() == 12
        assert (sf.readable(), sf.seekable(), sf.writable(), sf.size()) == (True, True, False, 20)
        sf.close()
        assert sf.closed
    miss = SparseFile(20, {0: b'0123456789'})
    miss.seek(5)
    with pytest.raises(IngestMissError):
        miss.read(10)
    assert not isinstance(IngestMissError('x'), OSError)   # never retried as a wire fault


# -- through the readers --------------------------------------------------------------

@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_ingest'), rows=ROWS)


def _read(factory, url, **kwargs):
    kwargs.setdefault('schema_fields', ['id', 'matrix'])
    kwargs.setdefault('shuffle_row_groups', True)
    kwargs.setdefault('seed', 9)
    kwargs.setdefault('num_epochs', 2)
    with factory(url, **kwargs) as reader:
        rows = [(int(r.id), float(np.asarray(r.matrix).sum())) for r in reader]
        return rows, dict(reader.diagnostics)


@pytest.mark.parametrize('pool,workers', [('thread', 4), ('dummy', 1)])
def test_the_plane_delivers_the_synchronous_rows_and_jax_s(url, pool, workers):
    common = dict(reader_pool_type=pool, workers_count=workers, scheduling='adaptive')
    sync, d_sync = _read(make_reader, url, ingest='off', **common)
    plane, d_plane = _read(make_reader, url, ingest='plane', **common)
    want, d_jax = _read(petastorm_tpu.make_reader, url, ingest='plane', **common)
    assert (d_sync['ingest'], d_plane['ingest'], d_jax['ingest']) == ('off', 'plane', 'plane')
    assert plane == sync == want
    assert d_plane['ingest_degraded'] == d_jax['ingest_degraded'] == 0
    keys = ('ingest_fetches', 'ingest_fetch_bytes', 'ingest_gets')
    if pool == 'dummy':
        assert [d_plane[k] for k in keys] == [d_jax[k] for k in keys]
    # on threads a row group dispatched again while its entry is still held
    # shares that fetch: the count depends on timing
    assert 12 <= d_plane['ingest_fetches'] <= 24 and 12 <= d_jax['ingest_fetches'] <= 24


def test_the_plane_over_the_cold_store_emulation_delivers_the_same_rows(url):
    fs = BandwidthLimitedFilesystem(LocalFilesystem(), bps=200e6, cold_latency=0.002,
                                    cold_threshold=1)
    common = dict(workers_count=4, scheduling='adaptive', filesystem=fs, num_epochs=1)
    sync, d_sync = _read(make_reader, url, ingest='off', **common)
    plane, d_plane = _read(make_reader, url, ingest='plane', **common)
    assert plane == sync and sorted(r[0] for r in plane) == list(range(ROWS))
    assert d_sync['ingest'] == 'off'   # 'auto' and 'off': the wrapper's protocol is local
    assert d_plane['ingest_fetches'] == 12 and d_plane['ingest_degraded'] == 0


def test_the_process_pool_resolves_off(url):
    rows, diag = _read(make_reader, url, reader_pool_type='process', workers_count=2,
                       ingest='plane', num_epochs=1, shuffle_row_groups=False)
    assert diag['ingest'] == 'off'
    assert sorted(r[0] for r in rows) == list(range(ROWS))


def test_the_kill_switch_and_auto_on_local_files(url, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_NO_INGEST_PLANE', '1')
    rows, diag = _read(make_reader, url, workers_count=4, ingest='plane', num_epochs=1)
    assert diag['ingest'] == 'off' and 'ingest_fetches' not in diag
    assert resolve_ingest('plane') == jax_ingest.resolve_ingest('plane') == 'off'
    monkeypatch.delenv('PETASTORM_TPU_NO_INGEST_PLANE')
    assert _read(make_reader, url, workers_count=4, num_epochs=1)[1]['ingest'] == 'off'


class _RemoteLooking(object):
    """A delegating wrapper whose ``protocol`` claims an object store (what
    ``'auto'`` reads); the bytes still come from the local disk."""

    protocol = 's3'

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == '_inner':
            raise AttributeError(name)
        return getattr(self._inner, name)


@pytest.mark.parametrize('protocol,in_process', [
    ('s3', True), ('s3', False), ('file', True), (('gcs', 'gs'), True), ((), True),
    (None, True), ('memory', True)])
@pytest.mark.parametrize('mode', ['auto', 'plane', 'off'])
def test_resolve_ingest_equals_jax(protocol, in_process, mode):
    fs = type('Fs', (), {'protocol': protocol})()
    got = resolve_ingest(mode, fs, in_process_pool=in_process)
    assert got == jax_ingest.resolve_ingest(mode, fs, in_process_pool=in_process)
    for module in (ingest, jax_ingest):
        with pytest.raises(ValueError, match='ingest must be one of'):
            module.resolve_ingest('sometimes', fs)


def test_auto_mounts_the_plane_on_an_s3_looking_wrapper(url):
    fs = _RemoteLooking(LocalFilesystem())
    assert resolve_ingest('auto', fs) == 'plane'
    common = dict(workers_count=4, filesystem=fs, scheduling='adaptive', num_epochs=1)
    sync, _ = _read(make_reader, url, ingest='off', **common)
    rows, diag = _read(make_reader, url, **common)
    assert diag['ingest'] == 'plane' and diag['ingest_fetches'] > 0
    assert rows == sync
    with pytest.raises(ValueError, match='ingest must be one of'):
        make_reader(url, ingest='sometimes')


def test_a_fetch_failure_degrades_per_piece(url):
    """The first open of the data file fails (the plane's fetch of that
    piece): the piece reads synchronously, every row arrives, the degrade
    is counted."""
    fs = FlakyOpenFilesystem(LocalFilesystem(), fail_times=1)
    rows, diag = _read(make_reader, url, workers_count=4, filesystem=fs, ingest='plane',
                       scheduling='fifo', num_epochs=1, shuffle_row_groups=False)
    assert sorted(r[0] for r in rows) == list(range(ROWS))
    assert diag['ingest'] == 'plane' and diag['ingest_degraded'] > 0


class _DictCache(object):
    """An in-memory result cache: the second epoch is all hits."""

    def __init__(self):
        self.store = {}
        self.hits = 0

    def get(self, key, fill):
        if key in self.store:
            self.hits += 1
        else:
            self.store[key] = fill()
        return self.store[key]

    def cleanup(self):
        pass


def test_cache_hits_release_their_prefetched_entries(url):
    cache = _DictCache()
    rows, diag = _read(make_reader, url, workers_count=4, ingest='plane',
                       scheduling='adaptive', shuffle_row_groups=False, cache_type=cache)
    assert [r[0] for r in rows] == list(range(ROWS)) * 2
    assert cache.hits >= 12
    assert diag['ingest_occupancy'] == diag['ingest_pending'] == \
        diag['ingest_buffered_bytes'] == 0


# -- the plane itself -------------------------------------------------------------------

class _Piece(object):
    def __init__(self, path, row_group):
        self.path, self.row_group = path, row_group


class _StallFirstOpen(object):
    """The first open of each file hands back a handle whose reads wait on
    ``release`` (a straggling GET); later opens pass through."""

    protocol = 's3'

    def __init__(self, inner, release):
        self._inner = inner
        self._release = release
        self._opened = set()
        self._lock = threading.Lock()

    def open(self, path, mode='rb'):
        handle = self._inner.open(path, mode)
        with self._lock:
            first = path not in self._opened
            self._opened.add(path)
        return _Stalled(handle, self._release) if first else handle

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _Stalled(object):
    def __init__(self, inner, release):
        self._inner = inner
        self._release = release

    def read(self, *args):
        self._release.wait(30)
        return self._inner.read(*args)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_a_hedge_wins_and_its_loser_cancels(parquet_file):
    release = threading.Event()
    journal = __import__('petastorm_tpu_torch.telemetry.decisions',
                         fromlist=['x']).default_journal()
    seq = journal.records()[-1]['seq'] if journal.records() else -1
    plane = IngestPlane(_StallFirstOpen(LocalFilesystem(), release),
                        [_Piece(parquet_file, 0)], fetch_threads=1, hedge_deadline_s=0.05)
    try:
        plane.observe_dispatch((0,))
        pf = plane.checkout(parquet_file, 0)   # blocks, hedges, the hedge wins
        assert pf is not None
        assert pf.read_row_group(0).equals(pq.ParquetFile(parquet_file).read_row_group(0))
        stats = plane.stats
        assert (stats['ingest_hedges'], stats['ingest_hedge_wins'],
                stats['ingest_degraded']) == (1, 1, 0)
        release.set()
        time.sleep(0.1)
        assert plane.stats['ingest_fetches'] == 1   # the loser discards its bytes
        assert plane.metrics.histogram('ingest_wait').count == 1
        assert {s['name'] for s in plane.spans.drain()} >= {'ingest/hedge'}
    finally:
        release.set()
        plane.close()
    actions = [r['action'] for r in journal.records()
               if r['seq'] > seq and r['actor'] == 'hedge']
    assert actions == ['hedge', 'hedge_win'] or actions == ['hedge_win', 'hedge']


def test_demand_promotion_bypasses_a_full_window(parquet_file):
    plane = IngestPlane(LocalFilesystem(), [_Piece(parquet_file, 0), _Piece(parquet_file, 1)],
                        window=2, fetch_threads=1)
    try:
        plane.observe_dispatch((0,))
        plane.observe_dispatch((1,))
        pf = plane.checkout(parquet_file, 1)
        assert pf is not None and pf.read_row_group(1).num_rows == 32
    finally:
        plane.close()


def test_close_unblocks_a_checkout(parquet_file):
    release = threading.Event()
    plane = IngestPlane(_StallFirstOpen(LocalFilesystem(), release), [_Piece(parquet_file, 0)],
                        fetch_threads=1)
    plane.observe_dispatch((0,))
    result = {}
    thread = threading.Thread(target=lambda: result.update(pf=plane.checkout(parquet_file, 0)),
                              daemon=True)
    thread.start()
    time.sleep(0.1)
    plane.close()
    release.set()
    thread.join(10)
    assert not thread.is_alive() and result['pf'] is None


def test_set_window_grows_the_fetch_pool_as_jax_s(parquet_file):
    import fsspec
    counts = []
    for cls, fs in ((IngestPlane, LocalFilesystem()),
                    (jax_ingest.IngestPlane, fsspec.filesystem('file'))):
        plane = cls(fs, [_Piece(parquet_file, 0)], window=4)
        pinned = cls(fs, [_Piece(parquet_file, 0)], window=4, fetch_threads=2)
        try:
            seen = [len(plane._threads)]
            for window in (12, 4, 100, 1):
                plane.set_window(window)
                seen.append((plane.window, len(plane._threads)))
            pinned.set_window(16)
            seen.append((pinned.window, len(pinned._threads)))
        finally:
            plane.close()
            pinned.close()
        counts.append(seen)
    assert counts[0] == counts[1] == [4, (12, 12), (4, 12), (64, 16), (2, 16), (16, 2)]


def test_the_open_file_cache_is_lru_bounded(parquet_file, tmp_path, monkeypatch):
    from petastorm_tpu_torch.arrow_reader_worker import ArrowReaderWorker
    from petastorm_tpu_torch.reader_impl import parquet_worker_base

    class Recording(object):
        protocol = 'file'

        def __init__(self):
            self.handles = []

        def open(self, path, mode='rb'):
            handle = open(path, mode)
            self.handles.append(handle)
            return handle

    monkeypatch.setattr(parquet_worker_base, 'MAX_OPEN_FILES', 2)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / ('f%d.parquet' % i)))
        shutil.copy(parquet_file, paths[-1])
    fs = Recording()
    worker = ArrowReaderWorker(0, lambda *_: None, type('A', (), {'filesystem': fs})())
    for path in paths:
        worker._parquet_file(path)
    assert list(worker._open_files) == paths[-2:]
    assert [h.closed for h in fs.handles] == [True, True, False, False]
    worker._parquet_file(paths[2])   # a hit refreshes recency, no reopen
    assert len(fs.handles) == 4
    worker._parquet_file(paths[0])
    assert paths[3] not in worker._open_files
    worker.shutdown()
    assert all(h.closed for h in fs.handles)


# -- the data service ---------------------------------------------------------------------

def _service_ids(service, url, ingest_mode):
    config = service.ServiceConfig(url, num_consumers=1, rowgroups_per_split=3,
                                   reader_kwargs={'workers_count': 1}, ingest=ingest_mode)
    ids = []
    with service.Dispatcher(config) as dispatcher, service.Worker(dispatcher.addr) as worker:
        kwargs = {} if service is petastorm_tpu.service else dict(device='cpu')
        loader = service.ServiceDataLoader(dispatcher.addr, batch_size=8, consumer=0,
                                           drop_last=False, ordered=True, **kwargs)
        with loader:
            for batch in loader.iter_host_batches():
                ids.extend(np.asarray(batch['id']).tolist())
        fetches = worker.metrics.counter('ingest_fetches').value
    return ids, fetches


@watched(120)
def test_a_service_worker_with_the_plane_delivers_the_jax_worker_s_rows(url):
    import petastorm_tpu.service
    import petastorm_tpu_torch.service as port_service
    got, fetches = _service_ids(port_service, url, 'plane')
    want, jax_fetches = _service_ids(petastorm_tpu.service, url, 'plane')
    assert got == want == list(range(ROWS))
    assert fetches == jax_fetches == 12
    assert _service_ids(port_service, url, 'off') == (got, 0)

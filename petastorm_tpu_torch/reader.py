"""Reader orchestration: ``make_reader`` and ``Reader``.

Counterpart of ``petastorm_tpu/reader.py``: row-group enumeration from the
footer metadata, sharding, row-group shuffling, epochs, the worker pool,
the iterator protocol, the ``columnar_decode`` fast path the loader
consumes, and exact checkpoints: ``state_dict`` (the ventilator's resume
token with the shard topology), ``make_reader(..., resume_state=)``,
``drain_in_flight`` and ``resume_dispatch``.

Cut to what the port holds (each option outside it raises ``ValueError``
naming where it will come): the thread, process and dummy pools, FIFO
scheduling, synchronous reads (no ingest plane), the null cache.  The
shard default is 0 of 1: nothing here probes a multi-host topology.
"""

import numpy as np

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import get_schema, load_row_groups
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path
from petastorm_tpu_torch.py_dict_reader_worker import PyDictReaderWorker, RowWorkerArgs
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers_pool import EmptyResultError, TimeoutWaitingForResultError
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

_LATER = 'a later slice of the port'


def _make_pool(reader_pool_type, workers_count, results_queue_size, zmq_copy_buffers=True):
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count, results_queue_size)
    if reader_pool_type == 'dummy':
        return DummyPool()
    if reader_pool_type == 'process':
        from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
        return ProcessPool(workers_count, results_queue_size, zmq_copy_buffers=zmq_copy_buffers)
    raise ValueError("reader_pool_type must be one of 'thread', 'process', 'dummy'; got %r"
                     % (reader_pool_type,))


def _shard_indices(num_pieces, cur_shard, shard_count):
    """Piece indices of this shard: ``i % shard_count == cur_shard``."""
    if shard_count is None:
        if cur_shard is not None:
            raise ValueError('cur_shard requires shard_count')
        return list(range(num_pieces))
    if cur_shard is None or not 0 <= cur_shard < shard_count:
        raise ValueError('cur_shard must be in [0, %d), got %r' % (shard_count, cur_shard))
    return [i for i in range(num_pieces) if i % shard_count == cur_shard]


def make_reader(dataset_url,
                schema_fields=None,
                reader_pool_type='thread', workers_count=10, results_queue_size=50,
                shuffle_row_groups=True,
                num_epochs=1,
                cur_shard=None, shard_count=None,
                cache_type='null',
                transform_spec=None,
                seed=None, resume_state=None, zmq_copy_buffers=True,
                columnar_decode=False, read_retries=2, retry_backoff_s=0.1,
                scheduling='fifo', ingest='off'):
    """Reader over a petastorm-format dataset (codec-decoded rows).

    Yields namedtuple rows, or with ``columnar_decode=True`` one namedtuple
    of stacked column arrays per row group (the fast path for
    :class:`petastorm_tpu_torch.gpu.DataLoader`).  Argument names and
    defaults follow ``petastorm_tpu.make_reader``; ``scheduling`` and
    ``ingest`` take only the values this slice implements.

    ``reader_pool_type='process'`` decodes in ``workers_count`` processes of
    their own (:class:`~petastorm_tpu_torch.workers_pool.process_pool.ProcessPool`),
    outside this interpreter's lock; results come back through
    ``/dev/shm``.  Its transform must then be picklable (a module-level
    function or callable class): one that is not raises here.
    ``zmq_copy_buffers=False`` sends byte-path results without ZeroMQ's copy.

    ``resume_state`` is a token of :meth:`Reader.state_dict` (or the
    ``'reader'`` entry of a loader's token, the JAX package's included):
    the reader starts at its position.  A token taken under another shard
    topology raises.
    """
    if scheduling != 'fifo':
        raise ValueError("scheduling=%r: only 'fifo' is in this slice; adaptive "
                         "scheduling is %s" % (scheduling, _LATER))
    if ingest != 'off':
        raise ValueError("ingest=%r: only 'off' is in this slice; the async ingest "
                         "plane is %s" % (ingest, _LATER))
    if cache_type not in (None, 'null', 'none'):
        raise ValueError("cache_type=%r: only 'null' is in this slice; the local-disk "
                         "cache and the cache plane are %s" % (cache_type, _LATER))
    fs, path = get_filesystem_and_path(dataset_url)
    stored_schema = get_schema(fs, path)
    schema_view = (stored_schema.create_schema_view(schema_fields)
                   if schema_fields is not None else stored_schema)

    pieces = load_row_groups(fs, path)
    local_indices = _shard_indices(len(pieces), cur_shard, shard_count)
    if not local_indices:
        raise NoDataAvailableError(
            'No row groups to read from %r after sharding' % (dataset_url,))

    worker_args = RowWorkerArgs(
        pieces=pieces, schema_view=schema_view,
        transform_spec=transform_spec, cache=NullCache(),
        columnar_output=columnar_decode, read_retries=read_retries,
        retry_backoff_s=retry_backoff_s)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, zmq_copy_buffers)
    result_schema = transform_schema(schema_view, transform_spec) \
        if transform_spec is not None else schema_view
    # the JAX reader's topology keys, at the values this reader has (no shard
    # permutation, no row-drop partitions)
    topology = {'cur_shard': cur_shard, 'shard_count': shard_count, 'shard_seed': None,
                'shard_scheme': None, 'num_global_pieces': len(pieces), 'drop_partitions': 1,
                'shuffle': bool(shuffle_row_groups)}
    return Reader(pool=pool, worker_args=worker_args,
                  items=[(i,) for i in local_indices], schema=result_schema,
                  shuffle_items=shuffle_row_groups, num_epochs=num_epochs, seed=seed,
                  batched_output=columnar_decode, resume_state=resume_state,
                  topology=topology)


class Reader(object):
    """Iterator over the dataset; owns the pool + ventilator lifecycle."""

    def __init__(self, *, pool, worker_args, items, schema, shuffle_items,
                 num_epochs, seed, topology, batched_output=False, resume_state=None):
        self.schema = schema
        #: True for the columnar path: __next__ yields namedtuples of column
        #: arrays instead of single rows.
        self.batched_output = batched_output
        self._pool = pool
        self._worker_args = worker_args
        self._items = items
        self._shuffle_items = shuffle_items
        self._num_epochs = num_epochs
        self._seed = seed if seed is not None else 0
        self._row_buffer = []
        self._topology = topology
        #: True once iteration reached the end of the stream.
        self.last_row_consumed = False
        start_epoch = start_cursor = 0
        if resume_state is not None:
            if resume_state.get('prologue'):
                raise ValueError('resume_state carries an elastic-reshard prologue: resharding '
                                 'is %s (ROADMAP.md, Queue A item 6)' % _LATER)
            self._check_resume_topology(resume_state)
            # a checkpoint round trip may turn ints into 0-d arrays
            start_epoch = int(resume_state.get('epoch') or 0)
            start_cursor = int(resume_state.get('cursor') or 0)
            if resume_state.get('seed') is not None:
                self._seed = int(resume_state['seed'])
        # Small in-flight window: bounds memory and keeps tokens tight, never
        # starves the workers.
        window = max(2 * self._pool.workers_count, 4)
        self._ventilator = ConcurrentVentilator(
            ventilate_fn=self._pool.ventilate,
            items=self._items,
            iterations=self._num_epochs,
            randomize_item_order=self._shuffle_items,
            random_seed=self._seed,
            max_ventilation_queue_size=max(1, min(len(self._items), window)),
            start_epoch=start_epoch, start_cursor=start_cursor)
        self._pool.start(PyDictReaderWorker, self._worker_args, ventilator=self._ventilator)

    def _check_resume_topology(self, resume_state):
        """A token's position indexes one shard's permutation: under another
        topology it would skip or re-read data, so it raises.  A token
        without topology keys validates nothing."""
        if 'shard_count' not in resume_state:
            return

        def norm(value):
            return None if value is None else int(value)
        mismatched = [key for key in ('cur_shard', 'shard_count', 'num_global_pieces',
                                      'drop_partitions', 'shard_seed')
                      if norm(resume_state.get(key, self._topology[key]))
                      != norm(self._topology[key])]
        if resume_state.get('shard_scheme') != self._topology['shard_scheme']:
            mismatched.append('shard_scheme')
        if bool(resume_state.get('shuffle', self._topology['shuffle'])) \
                != self._topology['shuffle']:
            mismatched.append('shuffle')
        if mismatched:
            raise ValueError('resume_state was taken under a different topology (mismatched: '
                             '%s); resuming it here would skip or re-read data'
                             % ', '.join(mismatched))

    def state_dict(self):
        """The resume position, at row-group granularity, with the shard
        topology (``cur_shard``, ``shard_count``, ``num_global_pieces``,
        ``drop_partitions``, ``shard_seed``, ``shard_scheme``, ``shuffle``)
        and ``num_epochs``: the JAX reader's token.

        For an exact snapshot call :meth:`drain_in_flight` first (a loader's
        ``state_dict`` does): results published and not yet consumed are
        past this position."""
        state = self._ventilator.state_dict()
        state.update(self._topology)
        state['num_epochs'] = self._num_epochs
        return state

    def drain_in_flight(self):
        """Pause dispatch and consume every result in flight; returns them
        (rows, or column batches for a columnar reader) in delivery order.

        Afterwards nothing is outstanding and no published result waits in
        the pool, so :meth:`state_dict` is exact.  It waits only while an
        outstanding item can still complete with dispatch paused
        (``has_deliverable_outstanding``), then sweeps what was published
        before the last ack.  Every array is copied: a process pool's results
        are views of shared-memory slabs.  :meth:`resume_dispatch`
        continues reading."""
        self._ventilator.pause()
        drained = [self.schema.make_namedtuple_from_dict(row) for row in self._row_buffer]
        self._row_buffer = []
        while self._ventilator.has_deliverable_outstanding():
            try:
                drained.extend(self._drained(self._pool.get_results(timeout=0.2)))
            except TimeoutWaitingForResultError:
                continue   # an ack still in flight: check again
            except EmptyResultError:
                self.last_row_consumed = True
                return drained
        try:
            while True:
                drained.extend(self._drained(self._pool.get_results(timeout=0.05)))
        except TimeoutWaitingForResultError:
            pass
        except EmptyResultError:
            self.last_row_consumed = True
        return drained

    def _drained(self, result):
        if self.batched_output:
            return [self.schema.make_namedtuple_from_dict(_owned(result))]
        return [self.schema.make_namedtuple_from_dict(_owned(row)) for row in result]

    def resume_dispatch(self):
        """Resume dispatch after :meth:`drain_in_flight`."""
        self._ventilator.unpause()

    @property
    def num_epochs(self):
        """Epoch repetition count this reader was built with (None: infinite)."""
        return self._num_epochs

    def __iter__(self):
        return self

    def __next__(self):
        if self.batched_output:
            try:
                return self.schema.make_namedtuple_from_dict(self._pool.get_results())
            except EmptyResultError:
                self.last_row_consumed = True
                raise StopIteration from None
        while not self._row_buffer:
            try:
                rows = self._pool.get_results()
            except EmptyResultError:
                self.last_row_consumed = True
                raise StopIteration from None
            self._row_buffer = list(rows)
        return self.schema.make_namedtuple_from_dict(self._row_buffer.pop(0))

    @property
    def diagnostics(self):
        """The pool's counters: the process pool's ``items_processed``,
        ``busy_time``, ``warm_items``, ``warm_busy_time``, ``shm_results``
        and its ``worker_pids``; empty for the other pools."""
        return dict(getattr(self._pool, 'diagnostics', {}))

    def stop(self):
        self._pool.stop()

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()


def _owned(result):
    """``result`` (a dict of cells or columns) with every array copied."""
    return {k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in result.items()}

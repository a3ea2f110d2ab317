"""Reader orchestration: ``make_reader``, ``make_batch_reader`` and ``Reader``.

Counterpart of ``petastorm_tpu/reader.py``: row-group enumeration from the
footer metadata (or, for a plain Parquet store, from the file footers),
``filters`` that prune row groups, sharding (``shard_seed`` permutes the
row groups before the modulo split), row-group shuffling, epochs, the
worker pool, the iterator protocol (``next``, ``reset`` after the last
row), ``num_local_rows``, and exact checkpoints: ``state_dict`` (the
ventilator's resume token with the shard topology), ``resume_state=``
(with an elastic reshard's prologue, :mod:`petastorm_tpu_torch.elastic`),
``drain_in_flight`` and ``resume_dispatch``.  ``piece_indices`` reads
exactly the given global row groups (the data service worker's split).
Work items carry global piece indices and the workers keep the global piece
list, so a prologue can name any row group.

:func:`make_reader` reads a petastorm dataset through the row worker
(codec-decoded rows, or with ``columnar_decode=True`` one namedtuple of
stacked columns per row group; an :class:`~petastorm_tpu_torch.ngram.NGram`
as ``schema_fields`` yields windows ``{offset: namedtuple}`` of
consecutive rows); :func:`make_batch_reader` reads any Parquet
store through :class:`~petastorm_tpu_torch.arrow_reader_worker.ArrowReaderWorker`
(one namedtuple of numpy arrays per row group, the schema inferred when
the store has no petastorm metadata).  Both take a ``predicate``
(:mod:`petastorm_tpu_torch.predicates`), ``filters`` and ``shard_seed``.

Dispatch order and reads, as the JAX readers have them: ``scheduling``
(``'auto'`` resolves to ``'adaptive'`` for a pool of at least 2 workers
over at least 8 row groups, else ``'fifo'``; the adaptive policy launches
predicted-slow row groups early and a reorder stage delivers in epoch
order, :mod:`~petastorm_tpu_torch.workers_pool.scheduling`), ``ingest``
(the async byte-range ingest plane, :mod:`~petastorm_tpu_torch.ingest`;
``'auto'`` stays off on local files and process pools) with
``ingest_window``, and ``filesystem`` (a caller's filesystem object, such
as :class:`~petastorm_tpu_torch.test_util.emulation.BandwidthLimitedFilesystem`
over the local one).  The effective modes are ``reader.scheduling`` and
``reader.ingest``, and both stand in :attr:`Reader.diagnostics`.

``rowgroup_selector`` (:mod:`petastorm_tpu_torch.selectors`) prunes the row
groups through the footer's indexes before ``filters``;
``shuffle_row_drop_partitions`` N makes each row group N work items
``(piece, p)``, item ``p`` delivering rows ``p::N``.  Work items are
``(global piece index, row-drop partition)`` pairs, as in the JAX readers.

Cut to what the port holds.  Each option outside it raises ``ValueError``
naming the ``ROADMAP.md`` item that brings it: local files only (no
``storage_options``, HDFS or object store).  ``cache_type`` takes the null
cache, ``'local-disk'``
(:mod:`~petastorm_tpu_torch.local_disk_cache`) and ``'plane'`` (the cache
plane, :mod:`~petastorm_tpu_torch.cache_plane`, keyed by the data files' and
the decode's fingerprint), as the JAX readers do.  Both readers take the reference's
argument names: an option outside the slice raises ``ValueError`` (never a
``TypeError``) only when it asks for more than its default.  With neither
``cur_shard`` nor ``shard_count`` given, a ``torch.distributed`` group of
more than one rank shards by ``(rank, world)``, as the JAX reader shards by
``(jax.process_index(), jax.process_count())``; otherwise the reader reads
every row group.
"""

import logging
import sys

import numpy as np

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (get_schema, infer_or_load_unischema,
                                                      load_row_groups, read_row_group_byte_sizes,
                                                      read_row_group_num_rows)
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path, get_filesystem_and_path_or_paths
from petastorm_tpu_torch.ingest import IngestPlane, resolve_ingest
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.py_dict_reader_worker import PyDictReaderWorker, RowWorkerArgs
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.unischema import match_unischema_fields
from petastorm_tpu_torch.workers_pool import EmptyResultError, TimeoutWaitingForResultError
from petastorm_tpu_torch.workers_pool import scheduling as sched
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

logger = logging.getLogger(__name__)

_LATER = 'a later slice of the port'
#: Where the host planes this slice refuses are queued.
_HOST_PLANES = 'ROADMAP.md, Queue A item 7'


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


def _refuse_outside_slice(storage_options=None, hdfs_driver='libhdfs'):
    """Raise for each storage option the port does not hold yet;
    ``hdfs_driver`` raises only when it differs from its default."""
    storage = []
    if hdfs_driver != 'libhdfs':
        storage.append('hdfs_driver=%r: HDFS is %s' % (hdfs_driver, _LATER))
    if storage_options is not None:
        storage.append('storage_options: only local files (or a filesystem= object) are in '
                       'this slice; HDFS and object stores are %s' % _LATER)
    if storage:
        raise ValueError('; '.join(storage) + ' (%s, the storage bullet)' % _HOST_PLANES)


def _resolve_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate,
                   cache_extra_settings, plane_context=''):
    """The workers' result cache: the null cache, the local-disk cache, the
    cache plane (keyed under ``plane_context``) or a ``CacheBase`` given."""
    if cache_type in (None, 'null', 'none'):
        return NullCache()
    if cache_type == 'local-disk':
        from petastorm_tpu_torch.local_disk_cache import LocalDiskCache
        return LocalDiskCache(cache_location, cache_size_limit, cache_row_size_estimate,
                              **(cache_extra_settings or {}))
    if cache_type == 'plane':
        from petastorm_tpu_torch.cache_plane import PlaneCache
        return PlaneCache(cache_location, cache_size_limit, context=plane_context,
                          **(cache_extra_settings or {}))
    if hasattr(cache_type, 'get'):
        return cache_type
    raise ValueError("cache_type must be 'null', 'local-disk' or 'plane', got %r"
                     % (cache_type,))


def _plane_context(cache_type, fs, pieces, schema_view, predicate, transform_spec):
    """The cache plane's key prefix: the data files' identity (path, size,
    mtime) and the decode's (columns, predicate, transform).  Computed only
    for ``cache_type='plane'``: it stats every distinct data file."""
    if cache_type != 'plane':
        return ''
    from petastorm_tpu_torch.cache_plane import dataset_fingerprint, spec_token
    return '%s:%s' % (dataset_fingerprint(fs, {p.path for p in pieces}),
                      spec_token(schema_view, predicate, transform_spec))


def _shard_indices(num_pieces, cur_shard, shard_count, shard_seed=None):
    """Piece indices of this shard: ``i % shard_count == cur_shard`` over the
    row groups' order, which ``shard_seed`` first permutes with numpy's
    ``RandomState(shard_seed & 0xffffffff)`` (a pure function of the seed
    across numpy versions; every host must pass the same one)."""
    if shard_count is None:
        if cur_shard is not None:
            raise ValueError('cur_shard requires shard_count')
        return list(range(num_pieces))
    if cur_shard is None or not 0 <= cur_shard < shard_count:
        raise ValueError('cur_shard must be in [0, %d), got %r' % (shard_count, cur_shard))
    order = list(range(num_pieces))
    if shard_seed is not None:
        order = np.random.RandomState(int(shard_seed) & 0xffffffff) \
            .permutation(num_pieces).tolist()
    return [order[i] for i in range(num_pieces) if i % shard_count == cur_shard]


def _default_shard(cur_shard, shard_count):
    """``(cur_shard, shard_count)``, or ``(rank, world)`` of a process group
    of more than one rank when neither is given.  torch is not imported for
    it: a process that has not loaded ``torch.distributed`` has no group."""
    if cur_shard is not None or shard_count is not None:
        return cur_shard, shard_count
    dist = sys.modules.get('torch.distributed')
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return None, None


def _topology(cur_shard, shard_count, shard_seed, num_pieces, shuffle_row_groups,
              drop_partitions=1):
    """The JAX reader's topology keys."""
    return {'cur_shard': cur_shard, 'shard_count': shard_count,
            'shard_seed': None if shard_seed is None else int(shard_seed),
            'shard_scheme': None if shard_seed is None else 'rs-perm-v1',
            'num_global_pieces': num_pieces, 'drop_partitions': int(drop_partitions),
            'shuffle': bool(shuffle_row_groups)}


def _drop_partitions(shuffle_row_drop_partitions):
    n = int(shuffle_row_drop_partitions or 1)
    if n < 1:
        raise ValueError('shuffle_row_drop_partitions must be >= 1, got %r'
                         % (shuffle_row_drop_partitions,))
    return n


def _explicit_piece_indices(piece_indices, num_pieces, cur_shard, shard_count, pruned=False):
    """Validate ``piece_indices=``: positions in the global row-group order,
    which the data service's dispatcher partitions.  Sharding does not
    compose with it and ``filters`` would renumber that order, so both
    raise, as an index out of range does."""
    if cur_shard is not None or shard_count is not None:
        raise ValueError('piece_indices is an explicit row-group assignment; '
                         'cur_shard/shard_count do not compose with it')
    if pruned:
        raise ValueError('piece_indices indexes the full load_row_groups '
                         'order; rowgroup_selector/filters would renumber it')
    indices = [int(i) for i in piece_indices]
    bad = [i for i in indices if not 0 <= i < num_pieces]
    if bad:
        raise ValueError('piece_indices %s out of range [0, %d)' % (bad[:5], num_pieces))
    return indices


def _local_pieces(fs, pieces, filters, stored_schema, cur_shard, shard_count, shard_seed,
                  dataset_url, piece_indices=None, resume_state=None, rowgroup_selector=None,
                  index_path=None):
    """The pieces after ``rowgroup_selector`` (whose ordinals index the full
    row-group order of the store at ``index_path``, so it goes first) and
    ``filters``, this reader's indices into them and its ``(cur_shard,
    shard_count)``: the given ``piece_indices``, else the shard's.  No local
    row group is legal only for a token with a prologue (an elastic reshard
    onto more shards than row groups)."""
    if rowgroup_selector is not None:
        from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
        keep = rowgroup_selector.select_row_groups(get_row_group_indexes(fs, index_path))
        pieces = [p for i, p in enumerate(pieces) if i in keep]
    if filters is not None:
        from petastorm_tpu_torch.etl.rowgroup_filtering import apply_arrow_filters
        pieces = apply_arrow_filters(fs, pieces, filters, stored_schema)
    if piece_indices is not None:
        local_indices = _explicit_piece_indices(
            piece_indices, len(pieces), cur_shard, shard_count,
            pruned=rowgroup_selector is not None or filters is not None)
    else:
        cur_shard, shard_count = _default_shard(cur_shard, shard_count)
        local_indices = _shard_indices(len(pieces), cur_shard, shard_count, shard_seed)
    if not local_indices and 'prologue' not in (resume_state or {}):
        raise NoDataAvailableError(
            'No row groups to read from %r after sharding/selection' % (dataset_url,))
    return pieces, local_indices, cur_shard, shard_count


def make_reader(dataset_url,
                schema_fields=None,
                reader_pool_type='thread', workers_count=10, results_queue_size=50,
                shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                predicate=None, rowgroup_selector=None,
                num_epochs=1,
                cur_shard=None, shard_count=None, shard_seed=None,
                cache_type='null', cache_location=None, cache_size_limit=None,
                cache_row_size_estimate=None, cache_extra_settings=None,
                transform_spec=None, filters=None,
                storage_options=None, filesystem=None, hdfs_driver='libhdfs',
                seed=None, resume_state=None, zmq_copy_buffers=True,
                columnar_decode=False, read_retries=2, retry_backoff_s=0.1,
                piece_indices=None, scheduling='auto', ingest='auto', ingest_window=None):
    """Reader over a petastorm-format dataset (codec-decoded rows).

    Yields namedtuple rows, or with ``columnar_decode=True`` one namedtuple
    of stacked column arrays per row group (the fast path for
    :class:`petastorm_tpu_torch.gpu.DataLoader`).  Argument names and
    defaults follow ``petastorm_tpu.make_reader``; the options this slice
    does not hold raise (see the module docstring).

    ``schema_fields`` is a list of fields or regex strings, or an
    :class:`~petastorm_tpu_torch.ngram.NGram`: then each item is a window
    ``{offset: namedtuple}`` of the fields asked for at that offset, formed
    in the workers from one row group's rows (after the transform), and
    ``columnar_decode=True`` raises.

    ``predicate`` (a :class:`~petastorm_tpu_torch.predicates.PredicateBase`)
    is evaluated in the workers on its own columns first; the other columns
    are decoded for the rows that pass.  ``filters`` (pyarrow's DNF) prune
    row groups by footer statistics and partition values.  ``shard_seed``
    permutes the row groups before ``cur_shard``/``shard_count`` split them.

    ``reader_pool_type='process'`` decodes in ``workers_count`` processes of
    their own (:class:`~petastorm_tpu_torch.workers_pool.process_pool.ProcessPool`),
    outside this interpreter's lock; results come back through
    ``/dev/shm``.  Its transform and predicate must then be picklable (a
    module-level function or callable class): a transform that is not
    raises here.  ``zmq_copy_buffers=False`` sends byte-path results
    without ZeroMQ's copy.

    ``resume_state`` is a token of :meth:`Reader.state_dict` (or the
    ``'reader'`` entry of a loader's token, the JAX package's included):
    the reader starts at its position, after the token's prologue when it
    has one (:func:`petastorm_tpu_torch.elastic.reshard_reader_states`).  A
    token taken under another shard topology raises.

    ``piece_indices`` reads exactly these global row groups (positions in
    the store's row-group order) instead of a shard; ``cur_shard``,
    ``shard_count``, ``rowgroup_selector`` and ``filters`` do not compose
    with it.

    ``rowgroup_selector`` (a :class:`~petastorm_tpu_torch.selectors.
    RowGroupSelectorBase`) keeps the row groups its footer indexes select
    (:func:`~petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index`).
    ``shuffle_row_drop_partitions`` N > 1 reads each row group N times, each
    work item ``(piece, p)`` delivering its rows ``p::N``: an approximate
    row-level shuffle at N times the read cost.

    ``scheduling`` (``'auto'``, ``'fifo'``, ``'adaptive'``) is the dispatch
    order of the row groups: ``'adaptive'`` launches predicted-slow row
    groups early within a bounded window, from an online cost model seeded
    from the row groups' byte sizes, while a reorder stage keeps delivery in
    the epoch order (the same rows in the same order as ``'fifo'`` under the
    dummy pool).  ``'auto'`` picks ``'adaptive'`` for a pool of at least 2
    workers over at least 8 row groups; ``PETASTORM_TPU_NO_ADAPTIVE_SCHED=1``
    forces ``'fifo'``.  ``ingest`` (``'auto'``, ``'plane'``, ``'off'``)
    mounts the async byte-range ingest plane (:mod:`petastorm_tpu_torch.
    ingest`): each dispatched row group's selected column chunks are fetched
    ahead of decode on background threads, at most ``ingest_window`` pieces
    ahead (default 8; a loader's autotuner moves it).  ``'auto'`` mounts it
    only on a filesystem whose ``protocol`` is not local, and never for the
    process pool; ``PETASTORM_TPU_NO_INGEST_PLANE=1`` turns it off.
    ``filesystem`` is an object with the port's filesystem methods (see
    :mod:`petastorm_tpu_torch.fs_utils`), used as it is.
    """
    _refuse_outside_slice(storage_options=storage_options, hdfs_driver=hdfs_driver)
    drop_partitions = _drop_partitions(shuffle_row_drop_partitions)
    ngram = schema_fields if isinstance(schema_fields, NGram) else None
    if columnar_decode and ngram is not None:
        raise ValueError('columnar_decode is incompatible with NGram windows')
    fs, path = get_filesystem_and_path(dataset_url, filesystem)
    stored_schema = get_schema(fs, path)
    if ngram is not None:
        schema_view = stored_schema.create_schema_view(ngram.get_field_names_at_all_timesteps())
        ngram.resolve_regex_field_names(stored_schema)
    elif schema_fields is not None:
        schema_view = stored_schema.create_schema_view(schema_fields)
    else:
        schema_view = stored_schema
    pieces, local_indices, cur_shard, shard_count = _local_pieces(
        fs, load_row_groups(fs, path), filters, stored_schema, cur_shard, shard_count,
        shard_seed, dataset_url, piece_indices, resume_state, rowgroup_selector, path)
    cache = _resolve_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate,
                           cache_extra_settings,
                           plane_context=_plane_context(cache_type, fs, pieces, schema_view,
                                                        predicate, transform_spec))
    worker_args = RowWorkerArgs(
        pieces=pieces, schema_view=schema_view, schema=stored_schema, predicate=predicate,
        transform_spec=transform_spec, cache=cache, ngram=ngram,
        shuffle_row_drop_partitions=drop_partitions,
        columnar_output=columnar_decode, read_retries=read_retries,
        retry_backoff_s=retry_backoff_s, filesystem=fs)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, zmq_copy_buffers)
    result_schema = transform_schema(schema_view, transform_spec) \
        if transform_spec is not None else schema_view
    return Reader(pool=pool, worker_class=PyDictReaderWorker, worker_args=worker_args,
                  items=[(i, p) for i in local_indices for p in range(drop_partitions)],
                  schema=result_schema, ngram=ngram,
                  filesystem=fs, shuffle_items=shuffle_row_groups, num_epochs=num_epochs,
                  seed=seed,
                  result_converter=_ColumnarDictConverter(result_schema)
                  if columnar_decode else None,
                  resume_state=resume_state,
                  topology=_topology(cur_shard, shard_count, shard_seed, len(pieces),
                                     shuffle_row_groups, drop_partitions),
                  scheduling=scheduling, ingest=ingest, ingest_window=ingest_window)


def make_batch_reader(dataset_url_or_urls,
                      schema_fields=None,
                      reader_pool_type='thread', workers_count=10, results_queue_size=50,
                      shuffle_row_groups=True,
                      predicate=None,
                      num_epochs=1,
                      cur_shard=None, shard_count=None, shard_seed=None,
                      cache_type='null', cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None, cache_extra_settings=None,
                      transform_spec=None, filters=None,
                      storage_options=None, filesystem=None, hdfs_driver='libhdfs',
                      seed=None, resume_state=None, zmq_copy_buffers=True,
                      read_retries=2, retry_backoff_s=0.1, piece_indices=None,
                      scheduling='auto', ingest='auto', ingest_window=None,
                      rowgroup_selector=None):
    """Columnar reader over any Parquet store (petastorm metadata optional).

    Yields one namedtuple of numpy arrays per row group: a rectangular list
    column as a 2-D array, a ragged one (or strings) as an object array.
    Argument names and defaults follow ``petastorm_tpu.make_batch_reader``:
    ``dataset_url_or_urls`` is one URL or a list of them (one filesystem);
    the schema is the stored Unischema, or one inferred from the first
    file's arrow schema; ``schema_fields`` are regex strings;
    ``transform_spec.func`` takes and returns a ``pandas.DataFrame`` (and
    may drop rows: :attr:`Reader.transform_may_change_row_count`).
    ``predicate``, ``filters``, ``shard_seed``, ``piece_indices``, the pools,
    the caches, ``resume_state``, ``scheduling``, ``ingest``,
    ``ingest_window`` and ``filesystem`` work as in :func:`make_reader`, and
    so does ``rowgroup_selector`` (an extension: the JAX batch reader has
    none) over a single store whose footer holds the index.  HDFS and
    object-store options raise.
    """
    from petastorm_tpu_torch.arrow_reader_worker import (ArrowReaderWorker, ArrowResultConverter,
                                                         BatchWorkerArgs)
    _refuse_outside_slice(storage_options=storage_options, hdfs_driver=hdfs_driver)
    fs, path_or_paths = get_filesystem_and_path_or_paths(dataset_url_or_urls, filesystem)
    paths = path_or_paths if isinstance(path_or_paths, list) else [path_or_paths]
    stored_schema = infer_or_load_unischema(fs, paths[0])
    if schema_fields is not None:
        if not all(isinstance(f, str) for f in schema_fields):
            raise ValueError('make_batch_reader schema_fields must be regex strings')
        matched = match_unischema_fields(stored_schema, schema_fields)
        schema_view = stored_schema.create_schema_view(matched) if matched else stored_schema
    else:
        schema_view = stored_schema
    pieces = []
    for p in paths:
        pieces.extend(load_row_groups(fs, p))
    if rowgroup_selector is not None and len(paths) != 1:
        raise ValueError('rowgroup_selector reads the index of one store; got %d URLs'
                         % len(paths))
    pieces, local_indices, cur_shard, shard_count = _local_pieces(
        fs, pieces, filters, stored_schema, cur_shard, shard_count, shard_seed,
        dataset_url_or_urls, piece_indices, resume_state, rowgroup_selector, paths[0])
    cache = _resolve_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate,
                           cache_extra_settings,
                           plane_context=_plane_context(cache_type, fs, pieces, schema_view,
                                                        predicate, transform_spec))
    worker_args = BatchWorkerArgs(pieces=pieces, schema_view=schema_view,
                                  transform_spec=transform_spec, predicate=predicate,
                                  cache=cache, read_retries=read_retries,
                                  retry_backoff_s=retry_backoff_s, filesystem=fs)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, zmq_copy_buffers)
    result_schema = transform_schema(schema_view, transform_spec) \
        if transform_spec is not None else schema_view
    return Reader(pool=pool, worker_class=ArrowReaderWorker, worker_args=worker_args,
                  items=[(i, 0) for i in local_indices], schema=result_schema, filesystem=fs,
                  shuffle_items=shuffle_row_groups, num_epochs=num_epochs, seed=seed,
                  result_converter=ArrowResultConverter(result_schema),
                  resume_state=resume_state,
                  topology=_topology(cur_shard, shard_count, shard_seed, len(pieces),
                                     shuffle_row_groups),
                  scheduling=scheduling, ingest=ingest, ingest_window=ingest_window)


class _ColumnarDictConverter(object):
    """A columnar row worker's dict of stacked columns -> a namedtuple."""

    def __init__(self, schema):
        self._schema = schema

    def convert(self, columns):
        return self._schema.make_namedtuple_from_dict(columns)


class Reader(object):
    """Iterator over the dataset; owns the pool + ventilator lifecycle."""

    def __init__(self, *, pool, worker_class, worker_args, items, schema, shuffle_items,
                 num_epochs, seed, topology, result_converter=None, resume_state=None,
                 ngram=None, filesystem=None, scheduling='auto', ingest='auto',
                 ingest_window=None):
        # the requested modes, resolved (with the kill switches) at each
        # _start, so that reset() reads the environment again; checked here
        # so that a typo fails before a thread starts
        sched.resolve_scheduling(scheduling, len(items), pool.workers_count)
        resolve_ingest(ingest, filesystem)
        self._scheduling_requested = scheduling
        self._ingest_requested = ingest
        self._ingest_window = ingest_window
        #: The effective dispatch mode (``'fifo'`` or ``'adaptive'``).
        self.scheduling = None
        #: The effective ingest mode (``'off'`` or ``'plane'``) and the plane.
        self.ingest = None
        self.ingest_plane = None
        #: The adaptive policy's cost model (None under FIFO).
        self.cost_model = None
        self._reorder = None
        self._sched_weights = None
        self.schema = schema
        #: The reader's :class:`~petastorm_tpu_torch.ngram.NGram`, or None:
        #: then each item is ``{offset: namedtuple}``, one namedtuple type
        #: per offset (the fields asked for there).
        self.ngram = ngram
        self._ngram_schemas = (
            {offset: ngram.get_schema_at_timestep(schema, offset) for offset in ngram.fields}
            if ngram is not None else None)
        self._fs = filesystem
        self._num_local_rows = None
        #: True for the columnar and batch paths: __next__ yields namedtuples
        #: of column arrays (``result_converter`` builds one from each
        #: result) instead of single rows.
        self.batched_output = result_converter is not None
        self._result_converter = result_converter
        self._worker_class = worker_class
        self._pool = pool
        self._worker_args = worker_args
        #: the workers' result cache (``worker_args.cache``)
        self._cache = getattr(worker_args, 'cache', None) or NullCache()
        self._items = items
        self._shuffle_items = shuffle_items
        self._num_epochs = num_epochs
        self._seed = seed if seed is not None else 0
        self._row_buffer = []
        self._topology = topology
        #: True once iteration reached the end of the stream.
        self.last_row_consumed = False
        start_epoch = start_cursor = 0
        prologue = ()
        if resume_state is not None:
            self._check_resume_topology(resume_state)
            # a checkpoint round trip may turn ints into 0-d arrays
            start_epoch = int(resume_state.get('epoch') or 0)
            start_cursor = int(resume_state.get('cursor') or 0)
            if resume_state.get('seed') is not None:
                self._seed = int(resume_state['seed'])
            prologue = [(int(i), int(p)) for i, p in (resume_state.get('prologue') or ())]
        self._start(start_epoch, start_cursor, prologue)

    def _start(self, start_epoch=0, start_cursor=0, prologue=()):
        """The ingest plane, the dispatch policy and its reorder stage, a
        ventilator from the given position (its prologue first), and the
        pool started on them."""
        if self.ingest_plane is not None:
            self.ingest_plane.close()
            self.ingest_plane = None
        # the process pool resolves off: the plane's buffers live in this
        # process and cannot cross the workers' pickle boundary
        self.ingest = resolve_ingest(self._ingest_requested, self._fs,
                                     in_process_pool=_in_process(self._pool))
        if self.ingest == 'plane':
            self.ingest_plane = IngestPlane(self._fs, self._worker_args.pieces,
                                            columns=self._ingest_columns(),
                                            registry=getattr(self._pool, 'metrics', None),
                                            window=self._ingest_window)
        self._worker_args.ingest = self.ingest_plane
        # Small in-flight window: bounds memory and keeps tokens tight, never
        # starves the workers.
        window = max(2 * self._pool.workers_count, 4)
        self.scheduling = sched.resolve_scheduling(self._scheduling_requested, len(self._items),
                                                   self._pool.workers_count)
        policy = None
        self._reorder = None
        self.cost_model = None
        if self.scheduling == 'adaptive':
            # An online cost model, seeded from the row groups' byte sizes
            # so that epoch 0 already ranks them; every ack refines it.  The
            # lookahead spans the epoch (clamped): it only chooses the
            # order, while the in-flight bound (undelivered positions, under
            # ack on delivery) bounds memory.  early_limit keeps at least
            # half the pool on the in-order stream.
            self.cost_model = sched.PieceCostModel()
            self.cost_model.seed(self._scheduling_weights())
            policy = sched.AdaptiveDispatchPolicy(
                self.cost_model,
                window=min(sched.MAX_WINDOW, max(sched.MIN_WINDOW, len(self._items))),
                early_limit=max(1, self._pool.workers_count // 2))
            # deeper than FIFO's: a slow piece launched early holds its slot
            # until its delivery turn, so the bound covers a straggler's
            # worth of fast completions (16x the pool, clamped)
            window = min(16 * self._pool.workers_count, max(len(self._items), 1),
                         sched.MAX_INFLIGHT)
            n = max(len(self._items), 1)
            self._reorder = sched.ReorderBuffer(start_position=start_epoch * n + start_cursor,
                                                prologue_count=len(prologue))
        self._ventilator = ConcurrentVentilator(
            ventilate_fn=self._pool.ventilate,
            items=self._items,
            iterations=self._num_epochs,
            randomize_item_order=self._shuffle_items,
            random_seed=self._seed,
            max_ventilation_queue_size=max(1, min(len(self._items) + len(prologue), window)),
            start_epoch=start_epoch, start_cursor=start_cursor, prologue_items=prologue,
            dispatch_policy=policy,
            dispatch_listener=(self.ingest_plane.observe_dispatch
                               if self.ingest_plane is not None else None))
        self._pool.start(self._worker_class, self._worker_args, ventilator=self._ventilator,
                         reorder=self._reorder)

    def _ingest_columns(self):
        """The columns one piece's decode may read: the view's and the
        predicate's (its first pass reads both), which the fetch planner
        restricts ranges to; None (whole row groups) when the predicate
        cannot name its fields."""
        wanted = set(self._worker_args.schema_view.fields)
        predicate = getattr(self._worker_args, 'predicate', None)
        if predicate is not None:
            stored = getattr(self._worker_args, 'schema', None) or self._worker_args.schema_view
            try:
                wanted |= set(predicate.get_fields()) & set(stored.fields)
            except Exception:  # noqa: BLE001 — over-fetching beats a missed page
                return None
        return wanted

    def _scheduling_weights(self):
        """The adaptive scheduler's epoch-0 cost priors, kept across
        reset(): each row group's compressed byte size from one footer
        scan, falling back to row counts past
        :data:`~petastorm_tpu_torch.workers_pool.scheduling.MAX_PRIOR_SCAN_FILES`
        files or when the footers cannot be read."""
        if self._sched_weights is not None:
            return self._sched_weights
        pieces = self._worker_args.pieces
        weights = sched.piece_weights(self._items, pieces)
        local = sorted({item[0] for item in self._items
                        if isinstance(item[0], int) and 0 <= item[0] < len(pieces)})
        paths = {pieces[i].path for i in local}
        if len(paths) > sched.MAX_PRIOR_SCAN_FILES:
            logger.debug('scheduling prior: %d files exceed the footer-scan cap (%d); using '
                         'row counts', len(paths), sched.MAX_PRIOR_SCAN_FILES)
        else:
            try:
                sizes = read_row_group_byte_sizes(self._fs, paths)
                byte_weights = {i: sizes[(pieces[i].path, pieces[i].row_group)] for i in local
                                if (pieces[i].path, pieces[i].row_group) in sizes}
                if byte_weights:
                    weights = byte_weights
            except Exception:  # noqa: BLE001 — priors are best-effort
                logger.debug('row-group byte-size scan failed; cost priors fall back to row '
                             'counts', exc_info=True)
        self._sched_weights = weights
        return weights

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
                             '%s); resuming it here would skip or re-read data.  To move a '
                             'checkpoint across shard counts, map every shard\'s token through '
                             'petastorm_tpu_torch.elastic.reshard_reader_states'
                             % ', '.join(mismatched))

    def state_dict(self):
        """The resume position, at row-group granularity, with the shard
        topology (``cur_shard``, ``shard_count``, ``num_global_pieces``,
        ``drop_partitions``, ``shard_seed``, ``shard_scheme``, ``shuffle``)
        and ``num_epochs``: the JAX reader's token.  While prologue work is
        unprocessed it carries ``'prologue'``, a list of ``(global piece
        index, row-drop partition)`` pairs.  The tokens of every shard reshard onto another
        shard count through :mod:`petastorm_tpu_torch.elastic`.

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
        drained = [self._convert_row(row) for row in self._row_buffer]
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
            # a batch worker's table converts into owned arrays
            return [self._result_converter.convert(
                _owned(result) if isinstance(result, dict) else result)]
        return [self._convert_row(_owned(row)) for row in result]

    def resume_dispatch(self):
        """Resume dispatch after :meth:`drain_in_flight`."""
        self._ventilator.unpause()

    def take_provenance(self):
        """The provenance records of the results delivered since the last
        call, in delivery order: pieces (file and row group), the worker's
        pid and host, the dispatch decision, the cache outcome, the
        transport and the decode/ipc/release windows.  The loader drains
        them each host batch into its journal; empty under
        ``PETASTORM_TPU_NO_PROVENANCE=1``."""
        take = getattr(self._pool, 'take_provenance', None)
        return take() if take is not None else []

    def num_local_rows(self):
        """The rows of this shard's row groups: an upper bound of what one
        epoch yields under a predicate or an NGram (both depend on the
        data).  Counts come from the footer metadata, else from the files'
        footers (read once; the result is kept)."""
        if self._num_local_rows is None:
            total = 0
            unknown = {}
            for idx in sorted({item[0] for item in self._items}):
                piece = self._worker_args.pieces[idx]
                if piece.num_rows >= 0:
                    total += piece.num_rows
                else:
                    unknown.setdefault(piece.path, []).append(piece.row_group)
            self._num_local_rows = total + read_row_group_num_rows(self._fs, unknown)
        return self._num_local_rows

    @property
    def predicate(self):
        """The workers' row predicate, or None (the yield depends on the data)."""
        return self._worker_args.predicate

    @property
    def transform_spec(self):
        """The workers' :class:`~petastorm_tpu_torch.transform.TransformSpec`,
        or None."""
        return self._worker_args.transform_spec

    @property
    def transform_may_change_row_count(self):
        """True when this reader's transform runs on a DataFrame (the batch
        worker), where ``func`` may drop rows; the row worker applies
        ``func`` to each row, one for one."""
        spec = self.transform_spec
        if spec is None or spec.func is None:
            return False
        return getattr(self._worker_class, 'DATAFRAME_TRANSFORM', False)

    @property
    def num_epochs(self):
        """Epoch repetition count this reader was built with (None: infinite)."""
        return self._num_epochs

    def __iter__(self):
        return self

    def __next__(self):
        if self.batched_output:
            try:
                return self._result_converter.convert(self._pool.get_results())
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
        return self._convert_row(self._row_buffer.pop(0))

    def next(self):
        return self.__next__()

    def _convert_row(self, row):
        if self.ngram is not None:
            return {offset: self._ngram_schemas[offset].make_namedtuple_from_dict(cells)
                    for offset, cells in row.items()}
        return self.schema.make_namedtuple_from_dict(row)

    def reset(self):
        """Start again from the first epoch, after the last row was consumed;
        mid-iteration it raises ``NotImplementedError``, as the reference
        does.  The pool is replaced by a new one of its kind."""
        if not self.last_row_consumed:
            raise NotImplementedError('reset() mid-iteration is not supported; consume the '
                                      'reader to its end first')
        self._pool.stop()
        self._pool.join()
        self._pool = _clone_pool(self._pool)
        self._row_buffer = []
        self.last_row_consumed = False
        self._start()

    @property
    def metrics(self):
        """The pool's metrics registry (its ``decode`` histogram is the
        autotuner's skew signal), or None for the process pool."""
        return getattr(self._pool, 'metrics', None)

    @property
    def diagnostics(self):
        """The pool's counters (the process pool's ``items_processed``,
        ``busy_time``, ``warm_items``, ``warm_busy_time``, ``shm_results``
        and its ``worker_pids``; none for the other pools), the result
        cache's (``cache_hits``, ``cache_misses``, ...: this process's view;
        process-pool children count in their own processes), the effective
        ``scheduling`` and ``ingest`` with the plane's counters, the reorder
        stage's ``reorder_pending`` results and ``ventilated_count``."""
        d = dict(getattr(self._pool, 'diagnostics', {}))
        d.update(getattr(self._cache, 'stats', None) or {})
        d['ventilated_count'] = self._ventilator.ventilated_count
        d['scheduling'] = self.scheduling
        d['ingest'] = self.ingest
        if self.ingest_plane is not None:
            d.update(self.ingest_plane.stats)
        d['reorder_pending'] = (self._reorder.pending_results
                                if self._reorder is not None else 0)
        return d

    def stop(self):
        self._pool.stop()
        if self.ingest_plane is not None:
            # after the pool's stop: a worker blocked in a checkout wakes
            # and reads synchronously instead of wedging the join
            self.ingest_plane.close()

    def join(self):
        self._pool.join()
        self._cache.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()


def _owned(result):
    """``result`` (a dict of cells or columns, or an NGram window of such
    dicts) with every array copied."""
    return {k: _owned(v) if isinstance(v, dict) else np.array(v) if isinstance(v, np.ndarray)
            else v for k, v in result.items()}


def _in_process(pool):
    """False for the process pool, whose workers cannot share this
    process's buffers."""
    return type(pool).__name__ != 'ProcessPool'


def _clone_pool(pool):
    """A new, unstarted pool of ``pool``'s kind and size."""
    if isinstance(pool, DummyPool):
        return DummyPool()
    if isinstance(pool, ThreadPool):
        return ThreadPool(pool.workers_count, pool._results_queue.maxsize)
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    if isinstance(pool, ProcessPool):
        return ProcessPool(pool.workers_count, pool.results_queue_size,
                           zmq_copy_buffers=pool._zmq_copy_buffers)
    raise TypeError('Unknown pool type %r' % type(pool))

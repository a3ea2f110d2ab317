"""Device loader: columnar reader batches -> dicts of device tensors.

Counterpart of ``petastorm_tpu/jax/loader.py::DataLoader`` on its columnar
path: the reader's per-row-group column chunks are re-batched with numpy
slicing and concatenation (no per-row Python), optionally mixed through a
windowed shuffling buffer, non-numeric columns are dropped (they cannot
live on the card), and each batch goes to the device through
:class:`~petastorm_tpu_torch.gpu.transfer.TransferPlane` with ``prefetch``
batches in flight.  Batches equal the JAX loader's bit for bit, dtypes
included, for the same reader, seed and batch size.

:class:`InMemDataLoader` reads the dataset once into host memory and serves
shuffled epochs from there; :class:`DeviceInMemDataLoader` keeps that cache
on the device, gathers each batch there, and runs whole epochs through a
step function with :meth:`~DeviceInMemDataLoader.scan_epochs`.  Both give
the JAX loaders' batches bit for bit: the host loader draws its epoch
orders from numpy's ``default_rng(seed)``, the device loader from
:mod:`petastorm_tpu_torch.random` (``jax.random`` reproduced).

:class:`PackedDataLoader` packs a variable-length sequence column of a row
reader into fixed-shape LM batches (:mod:`~petastorm_tpu_torch.gpu.packing`)
and delivers them like :class:`DataLoader`.

The JAX loaders' one-dispatch consumers, :meth:`DataLoader.scan_batches`
(every loader here) and :meth:`DeviceInMemDataLoader.scan_epochs`, replay a
CUDA graph of the step on the card (:mod:`~petastorm_tpu_torch.gpu.graphs`)
and run the step eagerly on the CPU.

``DataLoader`` on row readers (``columnar_decode=False``), ``state_dict``/
resume (``PackedDataLoader.state_dict`` included), autotuning, data echoing,
sharding, ``DiskCachedDataLoader`` and ``ResidentDataLoader`` are later
slices of the port.
"""

import hashlib
import itertools
import logging
from collections import deque

import numpy as np
import torch

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.gpu import graphs
from petastorm_tpu_torch.gpu.packing import StreamPacker
from petastorm_tpu_torch.gpu.transfer import TransferPlane, canonical_dtype, resolve_device

logger = logging.getLogger(__name__)

__all__ = ['DataLoader', 'InMemDataLoader', 'DeviceInMemDataLoader', 'PackedDataLoader']


class DataLoader(object):
    """Iterate device-resident batches (``{field: tensor}``) from a reader
    made with ``make_reader(..., columnar_decode=True)``.

    Args:
        reader: the columnar reader.
        batch_size: rows per batch.
        shuffling_queue_capacity: >0 mixes rows through a buffer of at least
            this many rows (uniform draws, seeded by ``seed``).
        drop_last: drop the trailing partial batch.
        prefetch: batches kept in flight ahead of the consumer.
        device: target device; ``None`` means the card (raises without one).
        seed: shuffling seed.
        transform_fn: applied to each host batch (a dict of numpy arrays)
            before it moves to the device; its result is what moves.
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0, drop_last=True,
                 prefetch=2, device=None, seed=None, transform_fn=None):
        if batch_size <= 0:
            raise ValueError('batch_size must be positive')
        self._check_reader(reader)
        self.device = resolve_device(device)
        self.reader = reader
        self.batch_size = int(batch_size)
        self._shuffle_capacity = shuffling_queue_capacity
        self._drop_last = drop_last
        self._prefetch = max(1, int(prefetch))
        self._seed = seed
        self._transform_fn = transform_fn
        self._warned_fields = set()

    @staticmethod
    def _check_reader(reader):
        if not getattr(reader, 'batched_output', False):
            raise ValueError('DataLoader takes a columnar reader (make_reader(..., '
                             'columnar_decode=True)): its row-reader path is a later slice '
                             'of the port (PackedDataLoader takes row readers)')

    def __iter__(self):
        plane = TransferPlane(self.device, ring_slots=self._prefetch + 2)
        pending = deque()
        for host_batch in self._host_batches():
            if self._transform_fn is not None:
                host_batch = self._transform_fn(host_batch)
            pending.append(plane.put(_filter_numeric(host_batch, self._warned_fields)))
            if len(pending) > self._prefetch:
                yield plane.ready(*pending.popleft())
        while pending:
            yield plane.ready(*pending.popleft())

    def scan_batches(self, step_fn, carry, steps_per_call=8, cuda_graph=None, generators=()):
        """Consume the stream ``steps_per_call`` steps at a time, as the JAX
        loader's ``scan_batches`` does with one ``lax.scan`` dispatch.

        ``step_fn(carry, batch) -> (carry, out)`` sees exactly the batches
        ``__iter__`` would deliver.  Each chunk of ``steps_per_call`` host
        batches is stacked to ``(k, batch, ...)`` and moved to the device
        in one transfer; a ragged tail batch (``drop_last=False``) flushes
        the chunk before it and becomes a chunk of its own.  Yields
        ``(carry, outs)`` per chunk, ``outs`` stacked along a leading axis
        of length k.

        On the card (``cuda_graph`` as :func:`graphs.resolve` reads it) a
        whole chunk, the k steps in order, is one
        :class:`~petastorm_tpu_torch.gpu.graphs.StepGraph`, one for each
        shape of carry and chunk (:func:`graphs.signature`), as JAX compiles
        once for each: its first chunk runs eagerly (the warm-up), its
        second is captured and replayed, every later one replayed.  A ragged
        tail chunk has a shape of its own, so it runs as its graph's eager
        warm-up.  There the carry must be a tree of tensors (dicts, lists,
        tuples; None): a Python number in it raises ``TypeError``.
        ``generators`` are the device generators ``step_fn`` draws from.
        """
        if steps_per_call < 1:
            raise ValueError('steps_per_call must be >= 1')
        graphed = graphs.resolve(cuda_graph, self.device)

        def run_chunk(carry, chunk):
            outs = []
            for i in range(len(next(iter(chunk.values())))):
                carry, out = step_fn(carry, {name: v[i] for name, v in chunk.items()})
                outs.append(out)
            return carry, _stack(outs)

        plane = TransferPlane(self.device, ring_slots=2)
        by_signature = {}   # graphs.signature of (carry, chunk) -> StepGraph

        def put(chunk):
            host = [_filter_numeric(self._transform_fn(b) if self._transform_fn else b,
                                    self._warned_fields) for b in chunk]
            return plane.ready(*plane.put({name: np.stack([b[name] for b in host])
                                           for name in host[0]}))

        def run(carry, chunk):
            stacked = put(chunk)
            if not graphed:
                return run_chunk(carry, stacked)
            key = graphs.signature((carry, stacked))
            if key not in by_signature:
                by_signature[key] = graphs.StepGraph(run_chunk, generators)
            return by_signature[key](carry, stacked)

        chunk = []
        for host_batch in self._host_batches():
            if chunk and _rows(host_batch) != _rows(chunk[0]):
                carry, outs = run(carry, chunk)
                chunk = []
                yield carry, outs
            chunk.append(host_batch)
            if len(chunk) == steps_per_call:
                carry, outs = run(carry, chunk)
                chunk = []
                yield carry, outs
        if chunk:
            yield run(carry, chunk)

    def _host_batches(self):
        return self._columnar_batches()

    def _chunk_source(self):
        for chunk in self.reader:
            yield chunk._asdict() if hasattr(chunk, '_asdict') else dict(chunk)

    def _row_source(self):
        """A row reader's rows as dicts (the JAX loader's ``_row_source``
        without its resume pushback, which comes with ``state_dict``)."""
        for row in self.reader:
            yield row._asdict() if hasattr(row, '_asdict') else dict(row)

    def _columnar_batches(self):
        """Re-batch column chunks: a chunk exactly batch_size long passes
        through; otherwise batches are views across a chunk deque with at
        most one concatenate per batch that straddles chunks."""
        if self._shuffle_capacity > 0:
            yield from self._columnar_batches_shuffled()
            return
        chunks = deque()   # (chunk_dict, start_offset)
        count = 0
        for chunk_dict in self._chunk_source():
            n = len(next(iter(chunk_dict.values())))
            if count == 0 and n == self.batch_size:
                yield chunk_dict
                continue
            chunks.append((chunk_dict, 0))
            count += n
            while count >= self.batch_size:
                yield _take_front(chunks, self.batch_size)
                count -= self.batch_size
        if count and not self._drop_last:
            yield _take_front(chunks, count)

    def _columnar_batches_shuffled(self):
        """Windowed columnar shuffle: uniform draws from a buffer of at least
        ``shuffling_queue_capacity`` rows."""
        rng = np.random.default_rng(self._seed)
        columns = None  # field -> [np.ndarray]
        count = 0
        threshold = max(self.batch_size, self._shuffle_capacity)
        for chunk_dict in self._chunk_source():
            if columns is None:
                columns = {k: [v] for k, v in chunk_dict.items()}
            else:
                for k, v in chunk_dict.items():
                    columns[k].append(v)
            count += len(next(iter(chunk_dict.values())))
            while count >= threshold:
                columns = {k: [np.concatenate(v)] if len(v) > 1 else v
                           for k, v in columns.items()}
                take = rng.permutation(count)[:self.batch_size]
                batch = {k: np.take(v[0], take, axis=0) for k, v in columns.items()}
                keep = np.ones(count, dtype=bool)
                keep[take] = False
                columns = {k: [v[0][keep]] for k, v in columns.items()}
                count -= self.batch_size
                yield batch
        if count and columns:
            columns = {k: np.concatenate(v) if len(v) > 1 else v[0]
                       for k, v in columns.items()}
            order = rng.permutation(count)
            start = 0
            while count - start >= self.batch_size:
                take = order[start:start + self.batch_size]
                yield {k: np.take(v, take, axis=0) for k, v in columns.items()}
                start += self.batch_size
            if count - start > 0 and not self._drop_last:
                take = order[start:]
                yield {k: np.take(v, take, axis=0) for k, v in columns.items()}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.reader.stop()
        self.reader.join()


class PackedDataLoader(DataLoader):
    """Pack the variable-length ``tokens_field`` of a row reader into
    ``(rows_per_batch, max_len)`` LM batches (``tokens``, ``segment_ids``,
    ``positions``: :class:`~petastorm_tpu_torch.gpu.packing.StreamPacker`)
    and deliver them like :class:`DataLoader` (``prefetch``, ``device``,
    ``transform_fn``)::

        with make_reader(url, schema_fields=['tokens']) as reader:
            for batch in PackedDataLoader(reader, 'tokens', max_len=4096,
                                          rows_per_batch=8):
                step(batch['tokens'], batch['segment_ids'], batch['positions'])

    Order comes from the reader (shuffle row groups there):
    ``shuffling_queue_capacity`` is rejected, as are columnar readers.
    With ``drop_last=False`` the final short batch is padded with
    all-padding rows.
    """

    def __init__(self, reader, tokens_field, max_len, rows_per_batch, pad_id=0, open_rows=32,
                 **loader_kwargs):
        if loader_kwargs.get('shuffling_queue_capacity'):
            raise ValueError('PackedDataLoader does not support shuffling_queue_capacity; '
                             'shuffle in the reader (shuffle_row_groups)')
        super().__init__(reader, batch_size=rows_per_batch, **loader_kwargs)
        self._tokens_field = tokens_field
        self._max_len = int(max_len)
        self._pad_id = pad_id
        self._open_rows = int(open_rows)

    @staticmethod
    def _check_reader(reader):
        if getattr(reader, 'batched_output', False):
            raise ValueError('PackedDataLoader needs a row reader (make_reader without '
                             'columnar_decode): a columnar reader yields chunks, not '
                             'per-document sequences')

    def _host_batches(self):
        packer = StreamPacker(self._max_len, self.batch_size, pad_id=self._pad_id,
                              open_rows=self._open_rows, drop_last=self._drop_last)
        for row in self._row_source():
            yield from packer.add(row[self._tokens_field])
        yield from packer.flush()


def _take_front(chunks, size):
    """Pop ``size`` rows off the front of the chunk deque; slices are views,
    concatenation only happens across chunk boundaries."""
    parts = []
    need = size
    while need > 0:
        chunk_dict, start = chunks.popleft()
        n = len(next(iter(chunk_dict.values())))
        take = min(n - start, need)
        parts.append({k: v[start:start + take] for k, v in chunk_dict.items()})
        if take < n - start:
            chunks.appendleft((chunk_dict, start + take))
        need -= take
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _filter_numeric(batch, warned):
    """Drop object/string columns: they cannot live on the device."""
    out = {}
    for name, value in batch.items():
        arr = np.asarray(value)
        if arr.dtype == object or arr.dtype.kind in ('U', 'S'):
            if name not in warned:
                warned.add(name)
                logger.warning('Field %s has non-numeric dtype %s; kept on host '
                               '(excluded from device batch)', name, arr.dtype)
            continue
        out[name] = value
    return out


def _rows(cache):
    return len(next(iter(cache.values())))


def _canonical_row_order(cache):
    """Sort the rows of a ``{field: (N, ...) array}`` cache by a blake2b
    digest of each row over its fields in name order: any pool then yields
    the same sequence (identical rows tie, and are interchangeable)."""
    items = sorted(cache.items())
    digests = []
    for i in range(_rows(cache)):
        h = hashlib.blake2b(digest_size=16)
        for _, column in items:
            h.update(np.ascontiguousarray(column[i]).tobytes())
        digests.append(h.digest())
    idx = np.asarray(sorted(range(len(digests)), key=digests.__getitem__))
    return {name: column[idx] for name, column in cache.items()}


class InMemDataLoader(DataLoader):
    """Reads the dataset once into host memory, then serves ``num_epochs``
    (``None``: endless) epochs from there, reshuffled each epoch with
    ``np.random.default_rng(seed)``.

    The reader must be built with ``num_epochs=1``: epochs repeat here.
    ``drop_last`` applies to each epoch; the cache holds every row.
    ``deterministic_cache_order=True`` sorts the cache into a
    content-defined order (numeric fields only), so the epochs are a pure
    function of the dataset and the seed, whatever the pool's delivery
    order.  Other keyword arguments go to :class:`DataLoader`.
    """

    def __init__(self, reader, batch_size, num_epochs=1, shuffle=True, seed=None,
                 deterministic_cache_order=False, echo=1, resume_state=None, **kwargs):
        if echo != 1:
            raise ValueError('%s does not support echo (epochs serve from an in-memory '
                             'cache; echo addresses decode-bound streaming)'
                             % type(self).__name__)
        if resume_state is not None:
            raise ValueError('%s does not take resume_state yet: resume tokens of the '
                             'in-memory loaders are a later slice of the port'
                             % type(self).__name__)
        reader_epochs = getattr(reader, 'num_epochs', 1)
        if reader_epochs != 1:
            raise ValueError('InMemDataLoader requires a reader built with num_epochs=1 '
                             '(got num_epochs=%r); epoch repetition happens in the loader'
                             % (reader_epochs,))
        super(InMemDataLoader, self).__init__(reader, batch_size, seed=seed, **kwargs)
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._deterministic = bool(deterministic_cache_order)
        self._cache = None

    def _build_cache(self):
        """Read the whole dataset once into ``self._cache`` (``{field: (N, ...)
        array}``); returns it, or None for an empty dataset."""
        if self._cache is None:
            # drop_last applies per epoch, not to the one read that fills the cache
            drop_last, self._drop_last = self._drop_last, False
            try:
                parts = list(super(InMemDataLoader, self)._columnar_batches())
            finally:
                self._drop_last = drop_last
            if not parts:
                return None
            cache = {name: np.concatenate([p[name] for p in parts]) for name in parts[0]}
            if self._deterministic:
                cache = _filter_numeric(cache, self._warned_fields)
                if not cache:
                    raise ValueError('deterministic_cache_order=True requires at least one '
                                     'numeric field (the canonical order hashes numeric '
                                     'row content)')
                cache = _canonical_row_order(cache)
            self._cache = cache
        return self._cache

    def _batch_starts(self, n):
        stop = n - self.batch_size + 1 if self._drop_last else n
        starts = range(0, max(stop, 0), self.batch_size)
        if not starts:
            logger.warning('epoch cache holds %d rows < batch_size=%d with drop_last: no '
                           'batches to serve', n, self.batch_size)
        return starts

    def _columnar_batches(self):
        cache = self._build_cache()
        if cache is None:
            return
        n = _rows(cache)
        starts = self._batch_starts(n)
        if not starts:
            return
        rng = np.random.default_rng(self._seed)
        epoch = 0
        while self._num_epochs is None or epoch < self._num_epochs:
            order = rng.permutation(n) if self._shuffle else np.arange(n)
            for start in starts:
                idx = order[start:start + self.batch_size]
                yield {name: column[idx] for name, column in cache.items()}
            epoch += 1


class DeviceInMemDataLoader(InMemDataLoader):
    """The epoch cache on the device: the dataset is read once, its numeric
    fields are placed on ``device`` in one copy (and the host copy
    released), and every batch is an ``index_select`` there, with no host
    work per step.

    Epoch orders are ``jax.random``'s, reproduced by
    :mod:`petastorm_tpu_torch.random`: ``key = PRNGKey(seed)``, then per
    epoch ``key, sub = split(key)`` and ``permutation(sub, n)``, moved to
    the device once per epoch (``shuffle=False``: the identity).
    ``seed=None`` draws fresh entropy.  ``transform_fn`` and
    ``shuffling_queue_capacity`` are rejected: batches never exist on the
    host.
    """

    def __init__(self, reader, batch_size, num_epochs=1, shuffle=True, seed=None,
                 device=None, **kwargs):
        for unsupported in ('transform_fn', 'shuffling_queue_capacity'):
            if kwargs.pop(unsupported, None):
                raise ValueError('DeviceInMemDataLoader does not support %s' % unsupported)
        super(DeviceInMemDataLoader, self).__init__(
            reader, batch_size, num_epochs=num_epochs, shuffle=shuffle, seed=seed,
            device=device, **kwargs)
        self._dev_cache = None

    def _materialize(self):
        """The device cache (built once), or None for an empty dataset."""
        if self._dev_cache is None:
            if self._build_cache() is None:
                return None
            numeric = _filter_numeric(self._cache, self._warned_fields)
            self._dev_cache = {
                name: torch.from_numpy(np.ascontiguousarray(
                    column, dtype=canonical_dtype(column.dtype))).to(self.device)
                for name, column in numeric.items()}
            self._cache = None   # never read again: release the host copy
        return self._dev_cache

    def _epoch_orders(self, n):
        """Each epoch's row order, an int64 tensor on the device."""
        seed = self._seed if self._seed is not None \
            else int(np.random.default_rng().integers(2 ** 31))
        key = prng.PRNGKey(seed)
        identity = None
        epoch = 0
        while self._num_epochs is None or epoch < self._num_epochs:
            if self._shuffle:
                key, sub = prng.split(key)
                order = torch.from_numpy(prng.permutation(sub, n).astype(np.int64))
                yield order.to(self.device)
            else:
                if identity is None:
                    identity = torch.arange(n, device=self.device)
                yield identity
            epoch += 1

    def __iter__(self):
        cache = self._materialize()
        if cache is None:
            return
        n = _rows(cache)
        starts = self._batch_starts(n)
        if not starts:
            return
        for order in self._epoch_orders(n):
            for start in starts:
                yield _gather(cache, order[start:start + self.batch_size])

    def scan_epochs(self, step_fn, carry, epochs_per_call=1, cuda_graph=None, generators=()):
        """Run the epochs through ``step_fn(carry, batch) -> (carry, out)``,
        ``epochs_per_call`` epochs per yield.

        Yields ``(carry, outs)``: ``outs`` stacks each step's ``out`` (a
        tensor, or a dict of them) on the device along a leading steps
        axis, with a leading epochs axis before it when ``epochs_per_call >
        1`` (a trailing partial group has fewer epochs).  Partial batches
        are always dropped.

        On the card (``cuda_graph`` as :func:`graphs.resolve` reads it) the
        step is the JAX loader's scan body: each epoch's order is copied once
        into a static buffer, and one CUDA graph gathers the batch at a
        device cursor, runs ``step_fn``, writes ``out`` into a static
        ``[steps]`` buffer at the cursor and advances it.  The first step
        runs eagerly (warm-up) and the graph is captured after it; between
        steps the host does nothing but replay.  The yielded carry is the
        graph's static carry, rewritten by the next epoch, and must be a tree
        of tensors (dicts, lists, tuples; None): a Python number in it raises
        ``TypeError``.  ``generators`` are the device generators ``step_fn``
        draws from.  The CPU runs the steps eagerly, one after the other.
        """
        if epochs_per_call < 1:
            raise ValueError('epochs_per_call must be >= 1')
        graphed = graphs.resolve(cuda_graph, self.device)
        cache = self._materialize()
        if cache is None:
            return
        n = _rows(cache)
        steps = n // self.batch_size
        if steps == 0:
            logger.warning('epoch cache holds %d rows < batch_size=%d: no batches to scan',
                           n, self.batch_size)
            return
        if graphed:
            scan = _EpochGraph(cache, n, self.batch_size, steps, step_fn, carry, generators)
        orders = self._epoch_orders(n)
        while True:
            group = list(itertools.islice(orders, epochs_per_call))
            if not group:
                return
            epochs = []
            for order in group:
                if graphed:
                    carry, outs = scan.epoch(order)
                else:
                    outs = []
                    for i in range(steps):
                        idx = order[i * self.batch_size:(i + 1) * self.batch_size]
                        carry, out = step_fn(carry, _gather(cache, idx))
                        outs.append(out)
                    outs = _stack(outs)
                epochs.append(outs)
            yield carry, (epochs[0] if epochs_per_call == 1 else _stack(epochs))


class _EpochGraph(object):
    """:meth:`DeviceInMemDataLoader.scan_epochs` on the card: one step (the
    batch gathered at a device cursor, the user's step, its ``out`` written
    at the cursor, the cursor advanced) captured once and replayed."""

    def __init__(self, cache, n, batch_size, steps, step_fn, carry, generators):
        device = next(iter(cache.values())).device
        self._cache = cache
        self._steps = steps
        self._step_fn = step_fn
        self._order = torch.empty(n, dtype=torch.int64, device=device)
        self._cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self._offsets = torch.arange(batch_size, device=device)
        self._batch_size = batch_size
        self.carry = graphs.tree_map(torch.clone, carry)
        self._outs = None
        self._graph = graphs.StepGraph(self._body, generators)

    def _body(self):
        idx = self._order.index_select(0, self._cursor * self._batch_size + self._offsets)
        carry, out = self._step_fn(self.carry, _gather(self._cache, idx))
        graphs.copy_into(self.carry, carry)
        if self._outs is None:   # the eager first step sizes the [steps] buffers
            self._outs = graphs.tree_map(
                lambda o: o.new_empty((self._steps,) + tuple(o.shape)), out)
        graphs.write_at(self._outs, self._cursor, out)
        self._cursor.add_(1)

    def epoch(self, order):
        """Run one epoch in ``order``; returns ``(carry, outs)``."""
        self._order.copy_(order)
        self._cursor.zero_()
        for _ in range(self._steps):
            self._graph()
        return self.carry, graphs.tree_map(torch.clone, self._outs)


def _gather(cache, idx):
    return {name: column.index_select(0, idx) for name, column in cache.items()}


def _stack(items):
    """Stack like outputs (tensors, or dicts of them) along a new leading axis."""
    if isinstance(items[0], dict):
        return {k: _stack([item[k] for item in items]) for k in items[0]}
    return torch.stack([torch.as_tensor(item) for item in items])

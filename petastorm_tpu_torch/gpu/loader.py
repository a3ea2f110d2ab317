"""Device loader: reader batches -> dicts of device tensors.

Counterpart of ``petastorm_tpu/jax/loader.py::DataLoader``: a columnar
reader's per-row-group column chunks are re-batched with numpy slicing and
concatenation (no per-row Python), optionally mixed through a windowed
shuffling buffer, or a row reader's rows are stacked; non-numeric columns
are dropped (they cannot live on the card), and each batch goes to the
device through :class:`~petastorm_tpu_torch.gpu.transfer.TransferPlane`
with ``prefetch`` batches in flight.  With the plane on (``transfer='auto'``
on the card) a :class:`~petastorm_tpu_torch.gpu.transfer.DispatchPump`
thread pulls, transforms and moves each batch in one coalesced copy, and
the consuming thread only takes finished batches; off, all of it runs on
the consuming thread.  Batches equal the JAX loader's bit for bit, dtypes
included, for the same reader, seed and batch size, either way.
``DataLoader.stats`` holds each stage's seconds, and a trace recorder takes
its spans.

:class:`InMemDataLoader` reads the dataset once into host memory and serves
shuffled epochs from there; :class:`DeviceInMemDataLoader` keeps that cache
on the device, gathers each batch there, and runs whole epochs through a
step function with :meth:`~DeviceInMemDataLoader.scan_epochs`.  Both give
the JAX loaders' batches bit for bit: the host loader draws its epoch
orders from numpy's ``default_rng(seed)``, the device loader from
:mod:`petastorm_tpu_torch.random` (``jax.random`` reproduced).
:class:`DiskCachedDataLoader` decodes once into per-field files on local
disk and streams later epochs from them, files the JAX loader's byte for
byte.

:class:`PackedDataLoader` packs a variable-length sequence column of a row
reader into fixed-shape LM batches (:mod:`~petastorm_tpu_torch.gpu.packing`)
and delivers them like :class:`DataLoader`.

The JAX loaders' one-dispatch consumers, :meth:`DataLoader.scan_batches`
(every loader here) and :meth:`DeviceInMemDataLoader.scan_epochs`, replay a
CUDA graph of the step on the card (:mod:`~petastorm_tpu_torch.gpu.graphs`)
and run the step eagerly on the CPU.

``state_dict``/resume (``DiskCachedDataLoader``'s and the pump's part in it
included), the row readers' shuffling buffer, autotuning, data echoing,
sharding and ``ResidentDataLoader`` are later slices of the port.
"""

import hashlib
import itertools
import json
import logging
import os
import shutil
import time
from collections import deque

import numpy as np
import torch

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.gpu import graphs
from petastorm_tpu_torch.gpu.packing import StreamPacker
from petastorm_tpu_torch.gpu.transfer import (DONE, DispatchPump, TransferPlane, canonical_dtype,
                                              plane_enabled, resolve_device, validate_transfer)
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry

logger = logging.getLogger(__name__)

__all__ = ['DataLoader', 'InMemDataLoader', 'DeviceInMemDataLoader', 'DiskCachedDataLoader',
           'PackedDataLoader']


class DataLoader(object):
    """Iterate device-resident batches (``{field: tensor}``) from a reader.

    Args:
        reader: a columnar reader (``make_reader(..., columnar_decode=True)``),
            whose row-group chunks are re-batched, or a row reader, whose
            rows are stacked.
        batch_size: rows per batch.
        shuffling_queue_capacity: >0 mixes rows through a buffer of at least
            this many rows (uniform draws, seeded by ``seed``); columnar
            readers only (the row readers' shuffling buffer is a later
            slice).
        drop_last: drop the trailing partial batch.
        prefetch: batches kept in flight ahead of the consumer.
        device: target device; ``None`` means the card (raises without one).
        seed: shuffling seed.
        transform_fn: applied to each host batch (a dict of numpy arrays)
            before it moves to the device; its result is what moves.
        trace_recorder: a :class:`~petastorm_tpu_torch.benchmark.TraceRecorder`
            that takes a span for each timed section (``host_batch``,
            ``transform``, ``device_put``) and the plane's ``h2d/*`` spans.
        transfer: the transfer plane (:mod:`~petastorm_tpu_torch.gpu.transfer`):
            ``'auto'`` on the card, ``True`` on (the CPU tests force it so),
            ``False``/``None`` off.  On, a :class:`~petastorm_tpu_torch.gpu.
            transfer.DispatchPump` thread pulls host batches, runs
            ``transform_fn`` and moves each batch to the card in one
            coalesced copy, and the consuming thread only takes finished
            batches; a structure the plane cannot pack moves column by column
            on that thread.  Off, all of it runs on the consuming thread.
        wire_dtypes: the plane's opt-in wire narrowing (``'auto'``: float
            leaves travel as bfloat16; or a ``{field: dtype}`` dict).
        ring_slots: the plane's pinned slabs (default ``prefetch + 1``).
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0, drop_last=True,
                 prefetch=2, device=None, seed=None, transform_fn=None, trace_recorder=None,
                 transfer='auto', wire_dtypes=None, ring_slots=None):
        if batch_size <= 0:
            raise ValueError('batch_size must be positive')
        validate_transfer(transfer)
        if reader is not None:
            self._check_reader(reader)
        self._batched_input = getattr(reader, 'batched_output', False)
        if shuffling_queue_capacity and reader is not None and not self._batched_input:
            raise ValueError('shuffling_queue_capacity on a row reader (its shuffling buffer) '
                             'is a later slice of the port: shuffle row groups in the reader '
                             'or use columnar_decode=True')
        self.device = resolve_device(device)
        self.reader = reader
        self.batch_size = int(batch_size)
        self._shuffle_capacity = shuffling_queue_capacity
        self._drop_last = drop_last
        self._prefetch = max(1, int(prefetch))
        self._seed = seed
        self._transform_fn = transform_fn
        self._warned_fields = set()
        self._trace = trace_recorder
        self._transfer = transfer
        self._wire_dtypes = wire_dtypes
        self._ring_slots = ring_slots
        self._plane = None
        self._pump = None
        # Per-stage wall time: 'host_batch' waits on the decode plane and
        # collates, 'transform' runs the user hook, 'device_put' the put (on
        # the plane: pack, copy dispatch and any ring wait; the h2d_*
        # histograms hold the split).  ``stats`` is a view of these.
        self.metrics = MetricsRegistry('loader')
        self._m_batches = self.metrics.counter('batches')
        self._m_stage = {stage: (self.metrics.counter(stage + '_s'),
                                 self.metrics.histogram(stage))
                         for stage in ('host_batch', 'transform', 'device_put')}

    @staticmethod
    def _check_reader(reader):
        """Subclasses refuse the readers they cannot take."""

    def _observe(self, stage, t0, t1):
        counter, hist = self._m_stage[stage]
        counter.inc(t1 - t0)
        hist.observe(t1 - t0)

    @property
    def stats(self):
        """Seconds spent in each stage and the batches delivered (the JAX
        loader's ``stats``)."""
        return {'host_batch_s': self._m_stage['host_batch'][0].value,
                'transform_s': self._m_stage['transform'][0].value,
                'device_put_s': self._m_stage['device_put'][0].value,
                'batches': int(self._m_batches.value)}

    @property
    def diagnostics(self):
        """The loader's registry (per-stage seconds and p50/p99, the plane's
        ``h2d_*`` counters) merged with the reader's pool diagnostics."""
        out = self.metrics.as_dict()
        out['batches'] = int(out.get('batches', 0))
        if self.reader is not None:
            out.update(getattr(self.reader, 'diagnostics', None) or {})
        return out

    def _transfer_plane(self):
        """The loader's transfer plane (built once, sharing its registry and
        trace recorder), or None when the plane is off."""
        if not plane_enabled(self._transfer, self.device):
            return None
        if self._plane is None:
            ring = self._ring_slots if self._ring_slots is not None else self._prefetch + 1
            self._plane = TransferPlane(self.device, wire_dtypes=self._wire_dtypes,
                                        ring_slots=ring, metrics=self.metrics,
                                        trace_recorder=self._trace)
        return self._plane

    def __iter__(self):
        plane = self._transfer_plane()
        if plane is None:
            return self._iter_inline()
        if self._pump is not None and self._pump.alive:
            # an earlier iteration's thread is still winding down: never
            # share a ring with it
            self._plane = None
            plane = self._transfer_plane()
        return self._iter_pumped(plane)

    def _iter_pumped(self, plane):
        """The plane on: a :class:`DispatchPump` thread pulls, transforms and
        puts; this generator only hands finished batches over."""
        def ship(host_batch):
            t1 = time.monotonic()
            if self._transform_fn is not None:
                host_batch = self._transform_fn(host_batch)
            t2 = time.monotonic()
            numeric = _filter_numeric(host_batch, self._warned_fields)
            shipped = plane.put(numeric)
            degraded = shipped is None
            if degraded:   # a structure the plane cannot pack: column by column
                shipped = plane.put_inline(numeric)
            t3 = time.monotonic()
            self._observe('transform', t1, t2)
            self._observe('device_put', t2, t3)
            self._m_batches.inc()
            if self._trace is not None:
                n = int(self._m_batches.value)
                if self._transform_fn is not None:
                    self._trace.event('transform', t1, t2, batch=n)
                if degraded:
                    # a coalesced put has its h2d/* spans in this window: a
                    # device_put span around them would count the staging
                    # copy as link time
                    self._trace.event('device_put', t2, t3, batch=n)
            return shipped

        pump = DispatchPump(self._timed_pulls(self._host_batches()), ship, self._prefetch,
                            device=self.device)
        self._pump = pump
        pump.start()
        try:
            while True:
                item = pump.get()
                if item is DONE:
                    break
                yield plane.ready(*item)
        finally:
            # an early break or an error: a thread parked in a slow pull is
            # released by reader.stop() in __exit__
            pump.stop(join_timeout_s=0.2)
            if not pump.alive:
                plane.drain()

    def _iter_inline(self):
        """The plane off: pull, transform and put on this thread, one pinned
        buffer and one copy per column."""
        plane = TransferPlane(self.device, ring_slots=self._prefetch + 2, metrics=self.metrics)
        pending = deque()
        batches = self._host_batches()
        while True:
            t0 = time.monotonic()
            try:
                host_batch = next(batches)
            except StopIteration:
                break
            t1 = time.monotonic()
            if self._transform_fn is not None:
                host_batch = self._transform_fn(host_batch)
            t2 = time.monotonic()
            pending.append(plane.put_inline(_filter_numeric(host_batch, self._warned_fields)))
            t3 = time.monotonic()
            self._observe('host_batch', t0, t1)
            self._observe('transform', t1, t2)
            self._observe('device_put', t2, t3)
            self._m_batches.inc()
            if self._trace is not None:
                n = int(self._m_batches.value)
                self._trace.event('host_batch', t0, t1, batch=n)
                if self._transform_fn is not None:
                    self._trace.event('transform', t1, t2, batch=n)
                self._trace.event('device_put', t2, t3, batch=n)
            if len(pending) > self._prefetch:
                yield plane.ready(*pending.popleft())
        while pending:
            yield plane.ready(*pending.popleft())

    def _timed_pulls(self, gen):
        """``gen``'s items, with the wait for each in ``host_batch``."""
        while True:
            t0 = time.monotonic()
            try:
                host_batch = next(gen)
            except StopIteration:
                return
            t1 = time.monotonic()
            self._observe('host_batch', t0, t1)
            if self._trace is not None:
                self._trace.event('host_batch', t0, t1)
            yield host_batch

    def scan_batches(self, step_fn, carry, steps_per_call=8, cuda_graph=None, generators=()):
        """Consume the stream ``steps_per_call`` steps at a time, as the JAX
        loader's ``scan_batches`` does with one ``lax.scan`` dispatch.

        ``step_fn(carry, batch) -> (carry, out)`` sees exactly the batches
        ``__iter__`` would deliver.  Each chunk of ``steps_per_call`` host
        batches is stacked to ``(k, batch, ...)`` and moved to the device
        in one transfer (the plane's coalesced put when it is on, on this
        thread: there is no pump); a ragged tail batch (``drop_last=False``)
        flushes the chunk before it and becomes a chunk of its own.  Yields
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

        plane = self._transfer_plane()
        coalesce = plane is not None
        if not coalesce:
            plane = TransferPlane(self.device, ring_slots=2, metrics=self.metrics)
        by_signature = {}   # graphs.signature of (carry, chunk) -> StepGraph

        def put(chunk):
            t0 = time.monotonic()
            if self._transform_fn is not None:
                chunk = [self._transform_fn(b) for b in chunk]
            t1 = time.monotonic()
            host = [_filter_numeric(b, self._warned_fields) for b in chunk]
            stacked = {name: np.stack([b[name] for b in host]) for name in host[0]}
            shipped = plane.put(stacked) if coalesce else None
            planed = shipped is not None
            if not planed:
                shipped = plane.put_inline(stacked)
            t2 = time.monotonic()
            self._observe('transform', t0, t1)
            self._observe('device_put', t1, t2)
            if self._trace is not None:
                if self._transform_fn is not None:
                    self._trace.event('transform', t0, t1, chunk=len(chunk))
                if not planed:
                    self._trace.event('device_put', t1, t2, chunk=len(chunk))
            return plane.ready(*shipped)

        def run(carry, chunk):
            stacked = put(chunk)
            if not graphed:
                return run_chunk(carry, stacked)
            key = graphs.signature((carry, stacked))
            if key not in by_signature:
                by_signature[key] = graphs.StepGraph(run_chunk, generators)
            return by_signature[key](carry, stacked)

        chunk = []
        for host_batch in self._timed_pulls(self._host_batches()):
            if chunk and _rows(host_batch) != _rows(chunk[0]):
                carry, outs = run(carry, chunk)
                chunk = []
                yield carry, outs
            chunk.append(host_batch)
            self._m_batches.inc()
            if len(chunk) == steps_per_call:
                carry, outs = run(carry, chunk)
                chunk = []
                yield carry, outs
        if chunk:
            yield run(carry, chunk)

    def _host_batches(self):
        return self._columnar_batches() if self._batched_input else self._row_batches()

    def _chunk_source(self):
        for chunk in self.reader:
            yield chunk._asdict() if hasattr(chunk, '_asdict') else dict(chunk)

    def _row_source(self):
        """A row reader's rows as dicts (the JAX loader's ``_row_source``
        without its resume pushback, which comes with ``state_dict``)."""
        for row in self.reader:
            yield row._asdict() if hasattr(row, '_asdict') else dict(row)

    def _row_batches(self):
        """Row readers: stack every ``batch_size`` rows, in reader order."""
        rows = []
        for row in self._row_source():
            rows.append(row)
            if len(rows) == self.batch_size:
                yield _stack_rows(rows)
                rows = []
        if rows and not self._drop_last:
            yield _stack_rows(rows)

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
        pump = self._pump
        if pump is not None:
            # ask the dispatch thread out first; a pull blocked in the reader
            # is released by reader.stop() below
            pump.stop(join_timeout_s=0.5)
        if self.reader is not None:
            self.reader.stop()
            self.reader.join()
        if pump is not None:
            pump.join()
        if self._plane is not None and (pump is None or not pump.alive):
            # only once the dispatch thread is out: it may still use the ring
            self._plane.close()


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


def _stack_rows(rows):
    """Stack row dicts into one batch; a column of strings (or Nones) stays
    an object array (dropped before the device), a None cell among arrays
    becomes zeros, as in the JAX loader."""
    out = {}
    for key in rows[0]:
        cells = [row[key] for row in rows]
        first = next((c for c in cells if c is not None), None)
        if first is None or isinstance(first, (str, bytes)):
            column = np.empty(len(cells), dtype=object)
            column[:] = cells
        else:
            column = np.stack([c if c is not None else np.zeros_like(first) for c in cells])
        out[key] = column
    return out


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
                parts = list(super(InMemDataLoader, self)._host_batches())
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

    def _host_batches(self):
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
            plane = self._transfer_plane()
            # the plane moves the whole cache in one coalesced copy
            self._dev_cache = plane.put_once(numeric) if plane is not None else None
            if self._dev_cache is None:
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


class DiskCachedDataLoader(DataLoader):
    """Decode once, stream every later epoch from local disk.

    Epoch 0 reads through the reader, serves its batches and appends each
    numeric field's rows to ``<field>.bin`` under ``decoded_cache_dir``,
    then writes ``manifest.json`` (``{'version': 1, 'rows', 'fields'}``) and,
    through ``os.replace``, the ``_COMPLETE`` marker.  Later epochs
    ``np.memmap`` the files and serve batches in a
    ``np.random.default_rng(seed)`` permutation per epoch (``shuffle=False``:
    file order), with no Parquet or decode work.  The files are the JAX
    ``DiskCachedDataLoader``'s byte for byte, so either package serves a
    cache the other built.

    The reader must be built with ``num_epochs=1`` (epochs repeat here;
    ``num_epochs=None`` is endless); ``reader=None`` serves a complete cache
    (:meth:`cache_complete`) with no reader at all.  A directory without the
    marker (a build cut short) is removed and built again.
    ``shuffling_queue_capacity`` is refused; ``transform_fn`` runs on every
    served batch, so random augmentation stays fresh per epoch.  Other
    keyword arguments go to :class:`DataLoader`.
    """

    _MANIFEST = 'manifest.json'
    _COMPLETE = '_COMPLETE'

    def __init__(self, reader, batch_size, decoded_cache_dir, num_epochs=1, shuffle=True,
                 seed=None, **kwargs):
        if kwargs.get('shuffling_queue_capacity'):
            raise ValueError('DiskCachedDataLoader shuffles via per-epoch permutation; '
                             'shuffling_queue_capacity is not supported')
        if reader is not None:
            reader_epochs = getattr(reader, 'num_epochs', 1)
            if reader_epochs != 1:
                raise ValueError('DiskCachedDataLoader requires a reader built with '
                                 'num_epochs=1 (got num_epochs=%r); epoch repetition happens '
                                 'in the loader' % (reader_epochs,))
        super(DiskCachedDataLoader, self).__init__(reader, batch_size, seed=seed, **kwargs)
        self._cache_dir = decoded_cache_dir
        self._num_epochs = num_epochs
        self._shuffle = shuffle

    @classmethod
    def cache_complete(cls, decoded_cache_dir):
        """True when ``decoded_cache_dir`` holds a finished cache: a loader
        over it may take ``reader=None``."""
        return os.path.exists(os.path.join(decoded_cache_dir, cls._COMPLETE))

    def _open_cache(self):
        """Every field's file memory-mapped; returns ``(fields, rows)``."""
        with open(os.path.join(self._cache_dir, self._MANIFEST)) as f:
            manifest = json.load(f)
        fields = {name: np.memmap(os.path.join(self._cache_dir, spec['file']),
                                  dtype=np.dtype(spec['dtype']), mode='r',
                                  shape=tuple([manifest['rows']] + spec['shape']))
                  for name, spec in manifest['fields'].items()}
        return fields, manifest['rows']

    def _build_and_serve_epoch0(self):
        """Epoch 0: serve the reader's batches while writing their rows."""
        if os.path.isdir(self._cache_dir):
            shutil.rmtree(self._cache_dir)   # a build cut short: start clean
        os.makedirs(self._cache_dir)
        sinks, specs, rows = {}, {}, 0
        drop_last, self._drop_last = self._drop_last, False   # the cache holds every row
        try:
            for batch in super(DiskCachedDataLoader, self)._host_batches():
                # sorted, as the JAX loader's filter orders a dict
                batch = dict(sorted(_filter_numeric(batch, self._warned_fields).items()))
                for name, value in batch.items():
                    value = np.ascontiguousarray(value)
                    if name not in sinks:
                        specs[name] = {'file': '%s.bin' % name, 'dtype': value.dtype.str,
                                       'shape': list(value.shape[1:])}
                        sinks[name] = open(os.path.join(self._cache_dir, specs[name]['file']),
                                           'wb')
                    elif list(value.shape[1:]) != specs[name]['shape']:
                        raise ValueError('field %r changed shape %r -> %r; the decoded cache '
                                         'requires fixed-shape fields'
                                         % (name, specs[name]['shape'], list(value.shape[1:])))
                    sinks[name].write(memoryview(value))
                n = _rows(batch)
                rows += n
                if n == self.batch_size or not drop_last:
                    yield batch
        finally:
            self._drop_last = drop_last
            for sink in sinks.values():
                sink.close()
        with open(os.path.join(self._cache_dir, self._MANIFEST), 'w') as f:
            json.dump({'version': 1, 'rows': rows, 'fields': specs}, f)
        # the marker is the atomicity boundary: no marker, a rebuild
        tmp = os.path.join(self._cache_dir, self._COMPLETE + '.tmp')
        with open(tmp, 'w') as f:
            f.write('%d rows\n' % rows)
        os.replace(tmp, os.path.join(self._cache_dir, self._COMPLETE))

    def _host_batches(self):
        epoch = 0
        if not self.cache_complete(self._cache_dir):
            if self.reader is None:
                raise ValueError('reader=None serves a COMPLETE cache only; %r has no '
                                 '_COMPLETE marker' % (self._cache_dir,))
            yield from self._build_and_serve_epoch0()
            epoch = 1
            if self._num_epochs is not None and epoch >= self._num_epochs:
                return
        fields, n = self._open_cache()
        if n == 0:
            return
        if self._drop_last and n < self.batch_size:
            logger.warning('decoded cache holds %d rows < batch_size=%d with drop_last: no '
                           'batches to serve', n, self.batch_size)
            return
        rng = np.random.default_rng(self._seed)
        stop = n - self.batch_size + 1 if self._drop_last else n
        while self._num_epochs is None or epoch < self._num_epochs:
            order = rng.permutation(n) if self._shuffle else np.arange(n)
            for start in range(0, max(stop, 0), self.batch_size):
                idx = order[start:start + self.batch_size]
                # fancy indexing a memmap reads just this batch
                yield {name: np.asarray(buf[idx]) for name, buf in fields.items()}
            epoch += 1


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

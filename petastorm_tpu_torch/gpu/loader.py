"""Device loader: reader batches -> dicts of device tensors.

Counterpart of ``petastorm_tpu/jax/loader.py::DataLoader``: a columnar
reader's per-row-group column chunks are re-batched with numpy slicing and
concatenation (no per-row Python), optionally mixed through a windowed
shuffling buffer, or a row reader's rows are stacked (an NGram reader's
windows into a batch of nested dicts, ``{offset: {field: array}}``);
non-numeric leaves are dropped (they cannot live on the card), and with
``echo`` each host batch repeats; each batch goes to the
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

Every loader takes exact checkpoints, as the JAX loaders do:
``state_dict()`` between batches returns a picklable token (the JAX
loader's keys) and a loader built with ``resume_state=token`` over a reader
built with ``resume_state=token['reader']`` yields exactly the batches the
uninterrupted run had not yet yielded (the same order for a seeded dummy
pool, the same rows for the thread and process pools).  The snapshot parks
the dispatch thread, drains the reader's results in flight, and carries the
shuffling buffer, the partial batch, the chunk residue and the batches
already on the card (waited for, then copied back to the host).  A JAX
loader's token resumes the port's loader.

Any reader feeds them: ``make_reader`` (rows, or ``columnar_decode=True``
chunks) or ``make_batch_reader`` over a plain Parquet store (one chunk per
row group; a rectangular list column arrives as a 2-D leaf).
:func:`make_loader` builds the reader and the loader in one call, the JAX
package's ``make_jax_loader``.  String and object columns are dropped with
one warning per field; a ``datetime64`` column raises ``TypeError``, as
``jax.device_put`` does; a nullable int column with nulls arrives as
float32 with NaN (pandas' float64, narrowed), as in the JAX loader.

:class:`ResidentDataLoader` keeps the dataset on the device in its wire
dtypes (:mod:`~petastorm_tpu_torch.gpu.residency`): epoch 0 streams and
admits each batch, later epochs are gathered there, in the JAX loader's
``fold_in`` epoch orders.

With ``sharding=`` (a :class:`~petastorm_tpu_torch.parallel.NamedSharding`,
one process per device) each rank moves only its block of each leaf and the
loader yields global ``DTensor`` arrays, as the JAX loader's
``global_batch_from_local`` does.

``autotune='auto'`` runs the JAX loader's stage autotuner when the reader
dispatches adaptively (:class:`~petastorm_tpu_torch.workers_pool.scheduling.
Autotuner`): once a tuning window has passed it moves the lookahead window,
the ventilator's in-flight bound, this loader's ``prefetch`` and the
ingest plane's readahead window from the measured stage quantiles and an
attached ``StallMonitor``'s wait share, each move a ``sched_*`` gauge in
:attr:`DataLoader.metrics`.  The per-batch latency SLO (``batch_slo_ms``)
needs the provenance journal, which is not ported (ROADMAP.md, Queue A
item 7, the telemetry bullet).
"""

import contextlib
import hashlib
import itertools
import json
import logging
import os
import shutil
import time
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.gpu import graphs, residency
from petastorm_tpu_torch.gpu.packing import StreamPacker
from petastorm_tpu_torch.gpu.transfer import (DONE, DispatchPump, TransferPlane, canonical_dtype,
                                              plane_enabled, resolve_device, validate_transfer)
from petastorm_tpu_torch.reader_impl.shuffling_buffer import (NoopShufflingBuffer,
                                                              RandomShufflingBuffer)
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry

logger = logging.getLogger(__name__)

__all__ = ['DataLoader', 'InMemDataLoader', 'DeviceInMemDataLoader', 'ResidentDataLoader',
           'DiskCachedDataLoader', 'PackedDataLoader', 'make_loader']


class DataLoader(object):
    """Iterate device-resident batches (``{field: tensor}``) from a reader.

    Args:
        reader: a columnar reader (``make_reader(..., columnar_decode=True)``),
            whose row-group chunks are re-batched, or a row reader, whose
            rows are stacked.
        batch_size: rows per batch.
        shuffling_queue_capacity: >0 mixes rows, seeded by ``seed``: a row
            reader's through a
            :class:`~petastorm_tpu_torch.reader_impl.shuffling_buffer.RandomShufflingBuffer`
            of this capacity (draws while it holds more than
            ``min_after_retrieve`` rows), a columnar reader's with uniform
            draws from a buffer of at least this many rows.
        min_after_retrieve: the row buffer's least fill before a draw
            (default ``shuffling_queue_capacity // 2``).
        drop_last: drop the trailing partial batch.
        prefetch: batches kept in flight ahead of the consumer.
        device: target device; ``None`` means the card (raises without one).
        seed: shuffling seed.
        transform_fn: applied to each host batch (a dict of numpy arrays,
            nested for an NGram reader) before it moves to the device; its
            result is what moves.
        echo: data echoing: each host batch repeats ``echo`` times in a
            row, copied dict by dict down the tree, and ``transform_fn``
            runs on each repeat.  A snapshot taken between two repeats
            resumes at the next batch, not at the repeat.
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
        resume_state: a token of :meth:`state_dict` (this loader's class, or
            the JAX package's): the loader serves what it holds first, then
            continues from its reader, which must be built with
            ``resume_state=resume_state['reader']``.
        sharding: a :class:`~petastorm_tpu_torch.parallel.NamedSharding` of a
            mesh of ranks.  ``batch_size`` is then this rank's rows (the
            global batch is ``batch_size`` times the batch axes' size), every
            other dim whole, and each batch is packed and moved as this
            rank's block of each leaf (its columns over a split dim) and
            yielded as global ``DTensor`` arrays
            (:func:`~petastorm_tpu_torch.parallel.global_batch_from_local`);
            ``to_local()`` gives the block.  A dim the spec cannot split
            evenly raises.  Host batches, tokens and ``transform_fn`` see
            the whole rows.
        autotune: the stage autotuner.  ``'auto'`` tunes when the reader
            dispatches adaptively (``reader.scheduling == 'adaptive'``): the
            lookahead window, the in-flight bound, ``prefetch`` and, with an
            ingest plane, its window; ``True`` tunes ``prefetch`` on any
            reader (and the rest on an adaptive one); ``False`` leaves every
            knob where it was set.  A tuning pass runs after a host batch
            once 2 s and 32 new cost-model samples have passed; a
            ``StallMonitor`` given to :meth:`attach_stall_monitor` makes the
            consumer's wait share its prefetch signal.
        batch_slo_ms: the JAX loader's per-batch latency SLO, which needs
            its provenance journal: not ported, so setting it raises.
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0, min_after_retrieve=None,
                 drop_last=True, prefetch=2, device=None, seed=None, transform_fn=None,
                 trace_recorder=None, transfer='auto', wire_dtypes=None, ring_slots=None,
                 resume_state=None, echo=1, sharding=None, autotune='auto', batch_slo_ms=None):
        if batch_size <= 0:
            raise ValueError('batch_size must be positive')
        if echo < 1:
            raise ValueError('echo must be >= 1')
        if autotune not in ('auto', True, False):
            raise ValueError("autotune must be 'auto', True or False; got %r" % (autotune,))
        if batch_slo_ms is not None:
            raise ValueError('batch_slo_ms=%r needs the provenance journal, a later slice of the '
                             'port (ROADMAP.md, Queue A item 7, the telemetry bullet)'
                             % (batch_slo_ms,))
        validate_transfer(transfer)
        if reader is not None:
            self._check_reader(reader)
        self._batched_input = getattr(reader, 'batched_output', False)
        if resume_state is not None and 'batched' in resume_state \
                and bool(resume_state['batched']) != self._batched_input:
            raise ValueError('resume_state came from a %s loader but this reader is %s: its '
                             'buffered data would be misread'
                             % ('columnar' if resume_state['batched'] else 'row',
                                'columnar' if self._batched_input else 'row'))
        # -- exact resume (see state_dict) --
        #: rows or chunks served before the reader's: a token's, then those
        #: a state_dict() drained from the reader
        self._pushback = list((resume_state or {}).get('pushback', []))
        self._resume_state = resume_state
        self._pending = deque()   # (batch, event) on the device, not yet yielded
        self._shuffle_buf = None
        self._partial_rows = []
        self._col_chunks = None
        self._colsh = None
        self.device = resolve_device(device)
        self.reader = reader
        self.batch_size = int(batch_size)
        self._shuffle_capacity = shuffling_queue_capacity
        self._min_after_retrieve = (min_after_retrieve if min_after_retrieve is not None
                                    else shuffling_queue_capacity // 2)
        self._echo = int(echo)
        self._drop_last = drop_last
        self._prefetch = max(1, int(prefetch))
        self._seed = seed
        self._transform_fn = transform_fn
        self._warned_fields = set()
        self._trace = trace_recorder
        self._transfer = transfer
        self._wire_dtypes = wire_dtypes
        self._ring_slots = ring_slots
        self._sharding = sharding
        self._plane = None
        self._pump = None
        self._autotune = autotune
        self._tuner = None
        self._tuner_ventilator = None
        self._knobs = None
        self._stall_monitor = None
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
            numeric = self._block(_filter_numeric(host_batch, self._warned_fields))
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

        pump = DispatchPump(self._timed_pulls(self._echoed_host_batches()), ship,
                            self._prefetch, device=self.device)
        # a token's batches from the card come first, put as they left
        pump.pending.extend(self._restore_pending(plane))
        self._pending = pump.pending
        self._pump = pump
        pump.start()
        try:
            while True:
                item = pump.get()
                if item is DONE:
                    break
                yield self._global(plane.ready(*item))
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
        pending = self._pending = deque(self._restore_pending(plane))
        batches = self._echoed_host_batches()
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
            pending.append(plane.put_inline(
                self._block(_filter_numeric(host_batch, self._warned_fields))))
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
                yield self._global(plane.ready(*pending.popleft()))
        while pending:
            yield self._global(plane.ready(*pending.popleft()))

    def iter_host_batches(self):
        """The host batches ``__iter__`` would move (shuffled, batched,
        ``transform_fn`` applied, a token's residue first), as numpy, with
        no move to the device, as the JAX loader's ``iter_host_batches``.
        Batches a token carried from the device come first and hold only
        their numeric fields."""
        for host_batch in self._take_restored():
            self._m_batches.inc()
            yield host_batch
        for host_batch in self._timed_pulls(self._echoed_host_batches()):
            if self._transform_fn is not None:
                t1 = time.monotonic()
                host_batch = self._transform_fn(host_batch)
                self._observe('transform', t1, time.monotonic())
            self._m_batches.inc()
            yield host_batch

    def _block(self, numeric):
        """This rank's block of each leaf of a host batch (``sharding=``)."""
        return numeric if self._sharding is None else self._sharding.blocks(numeric)

    def _stacked_block(self, stacked):
        """This rank's block of each leaf of a stacked chunk ``(k, rows,
        ...)`` (``sharding=``): the step and row axes whole."""
        if self._sharding is None:
            return stacked

        def cut(x):
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            return x[(slice(None),) + self._sharding.local_index(tuple(x.shape[1:]))]
        return cut(stacked)

    def _global(self, batch):
        """A device batch of blocks as global ``DTensor`` arrays (``sharding=``)."""
        return batch if self._sharding is None else self._sharding.wrap_tree(batch)

    def _take_restored(self):
        """The host batches a token carried from the card (post-transform),
        handed out once."""
        restored = (self._resume_state or {}).get('pending')
        if not restored:
            return []
        self._resume_state = dict(self._resume_state, pending=[])
        return restored

    def _restore_pending(self, plane):
        """The token's batches back on the device: the inline put, which
        gives the bits they had there."""
        return [plane.put_inline(_filter_numeric(b, self._warned_fields))
                for b in self._take_restored()]

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

        With ``sharding=`` each chunk moves this rank's block of each
        stacked leaf (the step axis whole, as the JAX loader's ``P(None,
        *spec)``), still in one transfer, and ``step_fn`` gets each step's
        batch as global ``DTensor`` arrays, as ``__iter__`` yields them.
        """
        if steps_per_call < 1:
            raise ValueError('steps_per_call must be >= 1')
        graphed = graphs.resolve(cuda_graph, self.device)

        def run_chunk(carry, chunk):
            outs = []
            for i in range(_rows(chunk)):
                batch = self._global(graphs.tree_map(lambda v: v[i], chunk))
                carry, out = step_fn(carry, batch)
                outs.append(out)
            return carry, _stack(outs)

        plane = self._transfer_plane()
        coalesce = plane is not None
        if not coalesce:
            plane = TransferPlane(self.device, ring_slots=2, metrics=self.metrics)
        by_signature = {}   # graphs.signature of (carry, chunk) -> StepGraph

        def put(chunk, transformed):
            t0 = time.monotonic()
            if self._transform_fn is not None and not transformed:
                chunk = [self._transform_fn(b) for b in chunk]
            t1 = time.monotonic()
            host = [_filter_numeric(b, self._warned_fields) for b in chunk]
            stacked = self._stacked_block(_stack_rows(host))
            shipped = plane.put(stacked) if coalesce else None
            planed = shipped is not None
            if not planed:
                shipped = plane.put_inline(stacked)
            t2 = time.monotonic()
            self._observe('transform', t0, t1)
            self._observe('device_put', t1, t2)
            if self._trace is not None:
                if self._transform_fn is not None and not transformed:
                    self._trace.event('transform', t0, t1, chunk=len(chunk))
                if not planed:
                    self._trace.event('device_put', t1, t2, chunk=len(chunk))
            return plane.ready(*shipped)

        def run(carry, chunk, transformed=False):
            stacked = put(chunk, transformed)
            if not graphed:
                return run_chunk(carry, stacked)
            key = graphs.signature((carry, stacked))
            if key not in by_signature:
                by_signature[key] = graphs.StepGraph(run_chunk, generators)
            return by_signature[key](carry, stacked)

        # A token's batches from the card come first, one chunk each: they
        # are post-transform and numeric only, so they do not stack with
        # fresh ones.  Every full chunk is run before its yield, so a
        # state_dict() between yields loses nothing.
        self._pending = deque()
        for host_batch in self._take_restored():
            self._m_batches.inc()
            carry, outs = run(carry, [host_batch], transformed=True)
            yield carry, outs
        chunk = []
        for host_batch in self._timed_pulls(self._echoed_host_batches()):
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
        gen = self._columnar_batches() if self._batched_input else self._row_batches()
        gen = self._autotuned(gen)
        if self._trace is not None:
            gen = self._ingest_spans_drained(gen)
        return gen

    def _ingest_spans_drained(self, gen):
        """The reader's ingest plane's ``ingest/fetch`` and ``ingest/hedge``
        spans onto this loader's trace, once per host batch (same process,
        same clock), so a stall can be laid to ``ingest_fetch``."""
        from petastorm_tpu_torch.telemetry.spans import merge_into_recorder
        for batch in gen:
            plane = getattr(self.reader, 'ingest_plane', None)
            if plane is not None:
                merge_into_recorder(self._trace, plane.spans.drain())
            yield batch

    # -- stage autotuning --------------------------------------------------

    def attach_stall_monitor(self, monitor):
        """Give the autotuner the consumer's ``StallMonitor``: its wait share
        over each tuning window is the strongest prefetch signal."""
        self._stall_monitor = monitor
        if self._tuner is not None:
            self._tuner.attach_stall_monitor(monitor)

    def _set_prefetch(self, depth):
        # read per batch by the inline path; a transfer plane's pump takes
        # the new depth at its next iteration
        self._prefetch = max(1, int(depth))

    def _build_autotuner(self):
        """The autotuner, or None (off, or ``'auto'`` over a FIFO reader),
        with live setters bound for the knobs it owns: the adaptive window,
        the in-flight bound, the prefetch and the ingest window.  It is kept
        per ventilator instance: ``reader.reset()`` builds a new ventilator,
        policy and cost model, and a tuner bound to the old ones would
        write into stopped objects."""
        if self._autotune is False or self.reader is None:
            return None
        from petastorm_tpu_torch.workers_pool import scheduling as sched
        ventilator = getattr(self.reader, '_ventilator', None)
        if self._tuner is not None and ventilator is self._tuner_ventilator:
            return self._tuner
        self._tuner = None
        policy = getattr(ventilator, '_policy', None)
        adaptive = bool(getattr(policy, 'adaptive', False))
        if self._autotune == 'auto' and not adaptive:
            return None
        knobs = sched.SchedulerKnobs(
            window=getattr(policy, 'window', sched.MIN_WINDOW),
            max_inflight=getattr(ventilator, 'max_inflight', sched.MIN_INFLIGHT),
            prefetch=self._prefetch)
        if adaptive:
            knobs.bind('window', lambda v, p=policy: setattr(p, 'window', v))
            # the in-flight bound is the reorder depth: only an adaptive
            # reader's to move (a FIFO reader tunes prefetch only)
            if hasattr(ventilator, 'set_max_inflight'):
                knobs.bind('max_inflight', ventilator.set_max_inflight)
        knobs.bind('prefetch', self._set_prefetch)
        ingest_plane = getattr(self.reader, 'ingest_plane', None)
        if ingest_plane is not None:
            knobs.ingest_window = ingest_plane.window
            knobs.bind('ingest_window', ingest_plane.set_window)
        self._knobs = knobs
        # the shrink floor of the in-flight bound scales with the pool: it
        # counts undelivered positions, so below 2x the workers it would
        # idle workers that FIFO's own bound keeps busy
        workers = getattr(getattr(self.reader, '_pool', None), 'workers_count', 0) or 0
        self._tuner = sched.Autotuner(registry=self.metrics,
                                      cost_model=getattr(self.reader, 'cost_model', None),
                                      stall_monitor=self._stall_monitor,
                                      min_inflight=max(sched.MIN_INFLIGHT, 2 * workers))
        if ingest_plane is not None:
            self._tuner.attach_ingest(ingest_plane)
            self.metrics.gauge('sched_ingest_window').set(knobs.ingest_window)
        self._tuner_ventilator = ventilator
        # the starting point, so that the gauges tell the whole story
        self.metrics.gauge('sched_window').set(knobs.window)
        self.metrics.gauge('sched_max_inflight').set(knobs.max_inflight)
        self.metrics.gauge('sched_prefetch').set(knobs.prefetch)
        return self._tuner

    def _autotuned(self, gen):
        tuner = self._build_autotuner()
        if tuner is None:
            return gen
        reader_metrics = getattr(self.reader, 'metrics', None)
        decode_hist = reader_metrics.histogram('decode') if reader_metrics is not None else None
        host_hist = self._m_stage['host_batch'][1]
        put_hist = self._m_stage['device_put'][1]

        def ticked():
            for batch in gen:
                yield batch
                tuner.maybe_tune(self._knobs, decode=decode_hist, host_batch=host_hist,
                                 device_put=put_hist)
        return ticked()

    def _echoed_host_batches(self):
        """The host batches, each repeated ``echo`` times in a row (data
        echoing, for a decode-bound stream).  A repeat copies the dicts of
        the tree, not the arrays: a ``transform_fn`` that rebinds keys runs
        afresh on each, and one that changed arrays in place would change
        every repeat."""
        if self._echo <= 1:
            return self._host_batches()

        def gen():
            for host_batch in self._host_batches():
                yield host_batch
                for _ in range(self._echo - 1):
                    yield _copy_tree(host_batch)
        return gen()

    def _source(self, convert):
        """Pushback items (a token's, then those a snapshot drained) first,
        then the reader's, converted; pushback is checked before every pull
        so that what a snapshot drains keeps its place in the stream."""
        reader_iter = iter(self.reader)
        while True:
            if self._pushback:
                yield self._pushback.pop(0)
                continue
            try:
                item = next(reader_iter)
            except StopIteration:
                if self._pushback:
                    continue
                return
            yield convert(item)

    def _chunk_source(self):
        return self._source(_as_dict)

    def _row_source(self):
        """A row reader's rows as dicts (an NGram window as a dict of dicts)."""
        return self._source(_as_dict)

    def _row_batches(self):
        """Row readers: rows through the shuffling buffer (a FIFO without
        ``shuffling_queue_capacity``), stacked every ``batch_size``.  The
        buffer and the partial batch live on the loader, and each batch is
        detached from them before its yield, where a snapshot may look."""
        if self._shuffle_capacity > 0:
            buffer = RandomShufflingBuffer(self._shuffle_capacity, self._min_after_retrieve,
                                           seed=self._seed)
        else:
            buffer = NoopShufflingBuffer()
        rs = self._resume_state or {}
        if rs.get('shuffle_buffer'):
            buffer.load_state_dict(rs['shuffle_buffer'])
        self._shuffle_buf = buffer
        self._partial_rows = list(rs.get('partial_rows', []))
        bs = self.batch_size
        for row in self._row_source():
            buffer.add_many([row])
            while buffer.can_retrieve():
                self._partial_rows.append(buffer.retrieve())
                if len(self._partial_rows) >= bs:
                    out, self._partial_rows = self._partial_rows[:bs], self._partial_rows[bs:]
                    yield _stack_rows(out)
        buffer.finish()
        while not buffer.finished:
            self._partial_rows.append(buffer.retrieve())
            if len(self._partial_rows) >= bs:
                out, self._partial_rows = self._partial_rows[:bs], self._partial_rows[bs:]
                yield _stack_rows(out)
        if self._partial_rows and not self._drop_last:
            out, self._partial_rows = self._partial_rows, []
            yield _stack_rows(out)

    def _columnar_batches(self):
        """Re-batch column chunks: a chunk exactly batch_size long passes
        through; otherwise batches are views across a chunk deque with at
        most one concatenate per batch that straddles chunks.  The deque
        lives on the loader for snapshots."""
        if self._shuffle_capacity > 0:
            yield from self._columnar_batches_shuffled()
            return
        chunks = self._col_chunks = deque()   # (chunk_dict, start_offset)
        count = 0
        for chunk_dict in (self._resume_state or {}).get('chunks') or ():
            chunks.append((chunk_dict, 0))
            count += _rows(chunk_dict)
        # a token's residue may hold whole batches (a chunk longer than the
        # batch), served before the next chunk as the interrupted run would
        while count >= self.batch_size:
            yield _take_front(chunks, self.batch_size)
            count -= self.batch_size
        for chunk_dict in self._chunk_source():
            n = _rows(chunk_dict)
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
        ``shuffling_queue_capacity`` rows.  Its state (the columns, their
        row count, the generator, and once the stream ended whether the
        remainder is already in its final order) lives in ``self._colsh`` so
        that a snapshot can take it between batches."""
        st = self._colsh = {'rng': np.random.default_rng(self._seed), 'columns': None,
                            'count': 0, 'ordered': False}
        saved = (self._resume_state or {}).get('col_shuffle')
        if saved:
            st['rng'].bit_generator.state = saved['rng_state']
            if saved['columns'] is not None:
                st['columns'] = {k: [v] for k, v in saved['columns'].items()}
                st['count'] = _rows(saved['columns'])
                st['ordered'] = bool(saved.get('ordered', False))
        threshold = max(self.batch_size, self._shuffle_capacity)

        def draws():
            # a snapshot may fall between two draws of one chunk: a restored
            # buffer draws on before it takes the next chunk
            while not st['ordered'] and st['count'] >= threshold:
                columns = {k: np.concatenate(v) if len(v) > 1 else v[0]
                           for k, v in st['columns'].items()}
                take = st['rng'].permutation(st['count'])[:self.batch_size]
                batch = {k: np.take(v, take, axis=0) for k, v in columns.items()}
                keep = np.ones(st['count'], dtype=bool)
                keep[take] = False
                st['columns'] = {k: [v[keep]] for k, v in columns.items()}
                st['count'] -= self.batch_size
                yield batch

        yield from draws()
        for chunk_dict in self._chunk_source():
            if st['columns'] is None:
                st['columns'] = {k: [v] for k, v in chunk_dict.items()}
            else:
                for k, v in chunk_dict.items():
                    st['columns'][k].append(v)
            st['count'] += _rows(chunk_dict)
            yield from draws()
        if not st['count']:
            return
        # The remainder: one permutation, then batches off its front (the
        # rows left stay in st, in that order, for a snapshot).
        columns = {k: np.concatenate(v) if len(v) > 1 else v[0]
                   for k, v in st['columns'].items()}
        if not st['ordered']:
            order = st['rng'].permutation(st['count'])
            columns = {k: np.take(v, order, axis=0) for k, v in columns.items()}
            st['ordered'] = True
        while st['count'] >= self.batch_size or (st['count'] and not self._drop_last):
            size = min(self.batch_size, st['count'])
            batch = {k: v[:size] for k, v in columns.items()}
            columns = {k: v[size:] for k, v in columns.items()}
            st['columns'] = {k: [v] for k, v in columns.items()}
            st['count'] -= size
            yield batch

    # -- exact checkpoints ---------------------------------------------------

    def state_dict(self):
        """An exact snapshot of the stream between two batches; resume with
        ``DataLoader(reader2, batch_size, ..., resume_state=state)`` over
        ``reader2 = make_reader(..., resume_state=state['reader'])``.

        The restored loader yields precisely the batches the uninterrupted
        run had not yet yielded: the same rows always, the same order for a
        seeded dummy pool.  The snapshot parks the dispatch thread, drains
        the reader's results in flight (they are served next, here and after
        a resume), and takes the batches already moved to the card (each
        waited for, then copied to the host), the shuffling buffer with its
        generator, the partial batch and the chunk residue.  The keys are
        the JAX loader's: ``version``, ``batched``, ``reader``, ``pending``,
        ``pushback``, ``partial_rows``, ``shuffle_buffer``, ``chunks``,
        ``col_shuffle``.  Call it from the consuming thread between
        batches; the loader keeps serving afterwards.  The token pickles
        (numpy arrays, dicts; a bfloat16 leaf, which numpy cannot hold, as
        a CPU tensor)."""
        with self._pump_paused():
            return self._state_dict_quiesced()

    @contextmanager
    def _pump_paused(self):
        """Hold the dispatch thread parked around a snapshot: every
        ``state_dict`` of the loaders reads their buffers inside this.  The
        pause counts, so brackets nest; a thread that ended on an error
        raises it here."""
        pump = self._pump
        if pump is None:
            yield
            return
        pump.pause()
        try:
            pump.check()
            yield
        finally:
            pump.resume()

    def _pending_on_host(self):
        """The batches moved to the card and not yet yielded, copied back to
        the host once their copies completed."""
        return [_to_host(batch, event) for batch, event in self._pending]

    def _state_dict_quiesced(self):
        drained = [_as_dict(item) for item in self.reader.drain_in_flight()]
        # A restored loader takes the token's pieces lazily (pending at the
        # first __iter__, buffers at the first host batch): until then a
        # snapshot carries them forward.
        rs = self._resume_state or {}
        iterating = self._shuffle_buf is not None or self._col_chunks is not None \
            or self._colsh is not None
        state = {
            'version': 1,
            'batched': self._batched_input,
            'reader': self.reader.state_dict(),
            'pending': self._pending_on_host() + list(rs.get('pending', [])),
            'pushback': list(self._pushback) + drained,
            'partial_rows': (list(self._partial_rows) if iterating
                             else list(rs.get('partial_rows', []))),
            'shuffle_buffer': (self._shuffle_buf.state_dict() if self._shuffle_buf is not None
                               else rs.get('shuffle_buffer')),
            'chunks': ([{k: v[start:] for k, v in chunk.items()}
                        for chunk, start in self._col_chunks]
                       if self._col_chunks is not None else list(rs.get('chunks', []))),
            'col_shuffle': rs.get('col_shuffle'),
        }
        if self._colsh is not None:
            cols = self._colsh['columns']
            state['col_shuffle'] = {
                'rng_state': self._colsh['rng'].bit_generator.state,
                'columns': None if cols is None else {
                    k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in cols.items()},
                'ordered': self._colsh['ordered'],
            }
        self._pushback.extend(drained)
        self.reader.resume_dispatch()
        return state

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
    all-padding rows.  ``state_dict`` adds the packer's residue (open and
    closed rows) and the packed batches not yet served to the loader's.
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
        self._packer = None
        self._packed_ready = []

    @staticmethod
    def _check_reader(reader):
        if getattr(reader, 'batched_output', False):
            raise ValueError('PackedDataLoader needs a row reader (make_reader without '
                             'columnar_decode): a columnar reader yields chunks, not '
                             'per-document sequences')

    def _host_batches(self):
        packer = StreamPacker(self._max_len, self.batch_size, pad_id=self._pad_id,
                              open_rows=self._open_rows, drop_last=self._drop_last)
        rs = self._resume_state or {}
        if rs.get('packer'):
            packer.load_state_dict(rs['packer'])
        self._packer = packer
        # batches packed and not yet served wait here, where a snapshot
        # between two yields of one add() finds them
        self._packed_ready = list(rs.get('packed_ready', []))
        for row in self._row_source():
            self._packed_ready.extend(packer.add(row[self._tokens_field]))
            while self._packed_ready:
                yield self._packed_ready.pop(0)
        self._packed_ready.extend(packer.flush())
        while self._packed_ready:
            yield self._packed_ready.pop(0)

    def state_dict(self):
        """The loader's snapshot plus the packer's residue and the packed
        batches not yet served, all read inside one pause of the dispatch
        thread (a thread resumed between the two reads could pack rows the
        first read drained and count them twice)."""
        with self._pump_paused():
            state = super().state_dict()
            if self._packer is not None:
                state['packer'] = self._packer.state_dict()
                state['packed_ready'] = list(self._packed_ready)
            else:   # restored, not yet iterated
                rs = self._resume_state or {}
                state['packer'] = rs.get('packer')
                state['packed_ready'] = list(rs.get('packed_ready', []))
            return state


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


def make_loader(dataset_url, batch_size, batched=True, loader_kwargs=None, **reader_kwargs):
    """A reader and a :class:`DataLoader` over it in one call (the JAX
    package's ``make_jax_loader``): ``batched=True`` reads through
    ``make_batch_reader`` (any Parquet store), ``False`` through
    ``make_reader`` (a petastorm dataset, codec-decoded).  ``reader_kwargs``
    go to the reader, ``loader_kwargs`` to the loader (``device``,
    ``transform_fn``, ...).  Use it as a context manager: leaving it stops
    the reader."""
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader
    factory = make_batch_reader if batched else make_reader
    reader = factory(dataset_url, **reader_kwargs)
    try:
        return DataLoader(reader, batch_size, **(loader_kwargs or {}))
    except BaseException:
        reader.stop()
        reader.join()
        raise


def _filter_numeric(batch, warned, path=''):
    """Drop object/string leaves of a batch (a dict, nested dicts for an
    NGram reader's windows): they cannot live on the device; one warning
    per leaf, named by its key (a nested leaf by its path, as
    ``jax.tree_util.keystr`` names it).  A datetime64 or timedelta64 leaf
    raises, as JAX refuses it."""
    out = {}
    for name, value in batch.items():
        if isinstance(value, dict):
            out[name] = _filter_numeric(value, warned, '%s[%r]' % (path, name))
            continue
        key = '%s[%r]' % (path, name) if path else name
        if isinstance(value, torch.Tensor):   # a bfloat16 leaf of a token
            out[name] = value
            continue
        arr = np.asarray(value)
        if arr.dtype.kind in ('M', 'm'):
            raise TypeError('Field %s: dtype %s is not a valid device array type; only numeric '
                            'columns move to the device (convert it in transform_fn)'
                            % (key, arr.dtype))
        if arr.dtype == object or arr.dtype.kind in ('U', 'S'):
            if key not in warned:
                warned.add(key)
                logger.warning('Field %s has non-numeric dtype %s; kept on host '
                               '(excluded from device batch)', key, arr.dtype)
            continue
        out[name] = value
    return out


def _rows(cache):
    """The rows of a batch: the length of its first leaf."""
    first = next(iter(cache.values()))
    return _rows(first) if isinstance(first, dict) else len(first)


def _as_dict(item):
    """A reader's item (a namedtuple or a dict; an NGram window, a dict of
    namedtuples) as dicts all the way down."""
    if hasattr(item, '_asdict'):
        item = item._asdict()
    if isinstance(item, dict):
        return {k: _as_dict(v) for k, v in item.items()}
    return item


def _copy_tree(node):
    """A copy of the dicts of a tree; the leaves are shared."""
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    return node


def _to_host(batch, event):
    """A device batch on the host, once the copy that made it (``event``)
    completed: numpy arrays, and a bfloat16 leaf (which numpy cannot hold)
    as a CPU tensor; either goes back to the device as the same bits."""
    if event is not None:
        event.synchronize()
    out = {}
    for name, tensor in batch.items():
        if isinstance(tensor, dict):
            out[name] = _to_host(tensor, None)
            continue
        tensor = tensor.detach().to('cpu', copy=True)
        out[name] = tensor if tensor.dtype == torch.bfloat16 else tensor.numpy()
    return out


def _stack_rows(rows):
    """Stack row dicts into one batch, recursing into nested dicts (NGram
    windows); a column of strings (or Nones) stays an object array (dropped
    before the device), a None cell among arrays becomes zeros, as in the
    JAX loader."""
    out = {}
    for key in rows[0]:
        cells = [row[key] for row in rows]
        if isinstance(cells[0], dict):
            out[key] = _stack_rows(cells)
            continue
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
    the same sequence (identical rows tie, and are interchangeable).  Each
    row's bytes, its fields' in name order, are one row of a byte matrix and
    take one hash call: the digest of their concatenation is that of the
    fields hashed one after the other."""
    n = _rows(cache)
    rows = np.concatenate([np.ascontiguousarray(column).reshape(n, -1).view(np.uint8)
                           for _, column in sorted(cache.items())], axis=1)
    digests = b''.join(hashlib.blake2b(row, digest_size=16).digest() for row in rows)
    # the digests' byte order as two big-endian words; a stable sort keeps
    # tied rows in cache order, as sorting the digests as bytes does
    words = np.frombuffer(digests, dtype='>u8').reshape(n, 2)
    idx = np.lexsort((words[:, 1], words[:, 0]))
    return {name: column[idx] for name, column in cache.items()}


class _EpochServer(object):
    """Epochs over ``n`` cached rows, each in an order drawn from
    ``np.random.default_rng(seed)`` (``shuffle=False``: row order), and their
    position for an exact token: the in-memory and disk caches'."""

    def _epoch_batches(self, n, epoch, resumed, gather):
        """The batches ``gather(idx)`` of the epochs from ``epoch`` (or the
        token position ``resumed``) to ``num_epochs``; the position, in
        ``self._epoch_pos``, is set before each yield, where a snapshot
        looks."""
        rng = np.random.default_rng(self._seed)
        pos = self._epoch_pos = {'rng': rng, 'epoch': epoch, 'order': None, 'offset': 0}
        if resumed:
            rng.bit_generator.state = resumed['rng_state']
            pos.update(epoch=int(resumed['epoch']), offset=int(resumed['offset']),
                       order=None if resumed['order'] is None else np.asarray(resumed['order']))
        stop = n - self.batch_size + 1 if self._drop_last else n
        while self._num_epochs is None or pos['epoch'] < self._num_epochs:
            if pos['order'] is None:
                pos['order'] = rng.permutation(n) if self._shuffle else np.arange(n)
            order = pos['order']
            for start in range(pos['offset'], max(stop, 0), self.batch_size):
                pos['offset'] = start + self.batch_size
                yield gather(order[start:start + self.batch_size])
            pos.update(epoch=pos['epoch'] + 1, order=None, offset=0)

    def _epoch_token(self, key):
        """The token: the position under ``key``, and the batches already on
        the device."""
        with self._pump_paused():
            pos = self._epoch_pos
            return {'version': 1, 'pending': self._pending_on_host(),
                    key: {'rng_state': pos['rng'].bit_generator.state,
                          'epoch': int(pos['epoch']), 'offset': int(pos['offset']),
                          'order': None if pos['order'] is None else np.asarray(pos['order'])}}


class InMemDataLoader(_EpochServer, DataLoader):
    """Reads the dataset once into host memory, then serves ``num_epochs``
    (``None``: endless) epochs from there, reshuffled each epoch with
    ``np.random.default_rng(seed)``.

    The reader must be built with ``num_epochs=1``: epochs repeat here.
    ``drop_last`` applies to each epoch; the cache holds every row.
    ``deterministic_cache_order=True`` sorts the cache into a
    content-defined order (numeric fields only), so the epochs are a pure
    function of the dataset and the seed, whatever the pool's delivery
    order; it is what makes :meth:`state_dict` exact mid-epoch (a
    pool-ordered cache does not survive a restart, and the token is
    refused without it).  Other keyword arguments go to :class:`DataLoader`.
    """

    #: The entry of this loader's state in its token.
    _TOKEN_KEY = 'inmem_cache'

    def __init__(self, reader, batch_size, num_epochs=1, shuffle=True, seed=None,
                 deterministic_cache_order=False, echo=1, resume_state=None, **kwargs):
        if getattr(reader, 'ngram', None) is not None:
            raise ValueError('InMemDataLoader does not support NGram readers')
        if echo != 1:
            raise ValueError('%s does not support echo (epochs serve from an in-memory '
                             'cache; echo addresses decode-bound streaming)'
                             % type(self).__name__)
        if resume_state is not None and not resume_state.get(self._TOKEN_KEY):
            raise ValueError('resume_state holds no %r entry: it is not a token of %s'
                             % (self._TOKEN_KEY, type(self).__name__))
        reader_epochs = getattr(reader, 'num_epochs', 1)
        if reader_epochs != 1:
            raise ValueError('InMemDataLoader requires a reader built with num_epochs=1 '
                             '(got num_epochs=%r); epoch repetition happens in the loader'
                             % (reader_epochs,))
        super(InMemDataLoader, self).__init__(reader, batch_size, seed=seed,
                                              resume_state=resume_state, **kwargs)
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._deterministic = bool(deterministic_cache_order)
        self._cache = None
        self._epoch_pos = None

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
        resumed = (self._resume_state or {}).get(self._TOKEN_KEY)
        if resumed and not self._deterministic:
            raise ValueError('this resume token needs deterministic_cache_order=True (the '
                             'rebuilt cache must hold the checkpointed row order)')
        yield from self._epoch_batches(
            n, 0, resumed, lambda idx: {name: column[idx] for name, column in cache.items()})

    def state_dict(self):
        """An exact resume token mid-epoch: the generator's state, the epoch,
        its order and the offset in it, and the batches already on the
        device.  It needs ``deterministic_cache_order=True`` and an
        iteration begun; the loader that resumes it is built the same way
        with ``resume_state=token``."""
        if not self._deterministic:
            raise NotImplementedError(
                'the in-memory cache is rebuilt from the reader, whose delivery order depends '
                'on the pool, so a mid-epoch token cannot survive a restart: build the loader '
                'with deterministic_cache_order=True (a content-sorted cache), checkpoint at '
                'epoch boundaries, or use DiskCachedDataLoader')
        if self._epoch_pos is None:
            raise ValueError('state_dict() is supported once iteration has begun; call it '
                             'between batches')
        return self._epoch_token(self._TOKEN_KEY)


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

    :meth:`state_dict` is ``(epochs_done, steps_into_epoch)`` with the
    batch size, ``drop_last`` and the explicit seed the orders derive from;
    a token mid-epoch needs ``deterministic_cache_order=True``.  A loader
    built with the same seed and ``resume_state=token`` continues the
    stream, per step or through :meth:`scan_epochs`.
    """

    _TOKEN_KEY = 'device_inmem'

    def __init__(self, reader, batch_size, num_epochs=1, shuffle=True, seed=None,
                 device=None, **kwargs):
        for unsupported in ('transform_fn', 'shuffling_queue_capacity'):
            if kwargs.pop(unsupported, None):
                raise ValueError('DeviceInMemDataLoader does not support %s' % unsupported)
        super(DeviceInMemDataLoader, self).__init__(
            reader, batch_size, num_epochs=num_epochs, shuffle=shuffle, seed=seed,
            device=device, **kwargs)
        if self._sharding is not None:
            raise ValueError('DeviceInMemDataLoader caches on one device; '
                             'use InMemDataLoader with sharding= for global '
                             'batch assembly')
        self._dev_cache = None
        #: (epochs, steps) skipped at the head of every pass: a token's
        #: position, the same for every pass over the loader
        self._start_epoch = self._start_step = 0
        #: the current pass's position, which state_dict reads
        self._epochs_done = self._steps_into_epoch = 0
        #: drop_last of the run that took the token (None: no token, or one
        #: without the flag): only a drop_last=False pass parks the cursor
        #: at the count of full batches
        self._token_drop_last = None
        resumed = (self._resume_state or {}).get(self._TOKEN_KEY)
        if resumed:
            if seed is None or int(resumed['seed']) != int(seed):
                raise ValueError('the device_inmem resume token was taken with seed=%r; build '
                                 'the loader with that explicit seed (the epoch orders derive '
                                 'from it)' % (resumed['seed'],))
            self._start_epoch = int(resumed['epochs_done'])
            self._start_step = int(resumed.get('steps_into_epoch', 0))
            if resumed.get('drop_last') is not None:
                self._token_drop_last = bool(resumed['drop_last'])
            token_bs = resumed.get('batch_size')
            if self._start_step and token_bs is not None and int(token_bs) != int(batch_size):
                # only a cursor inside an epoch counts batches of one size
                raise ValueError('the device_inmem resume token was taken %d steps into an '
                                 'epoch of batch_size=%d batches; resume with that batch_size '
                                 '(got %d), or checkpoint at an epoch boundary to change it'
                                 % (self._start_step, int(token_bs), int(batch_size)))
            if self._start_step and not self._deterministic:
                raise ValueError('a mid-epoch device_inmem token needs '
                                 'deterministic_cache_order=True: its cursor indexes the cached '
                                 'row order, which only the content-sorted cache reproduces')
            # a snapshot before the first batch re-emits the token's cursor
            self._epochs_done, self._steps_into_epoch = self._start_epoch, self._start_step

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
        """Each epoch's row order, an int64 tensor on the device, from the
        token's epoch on (the earlier epochs' keys are split and skipped)."""
        seed = self._seed if self._seed is not None \
            else int(np.random.default_rng().integers(2 ** 31))
        key = prng.PRNGKey(seed)
        identity = None
        epoch = 0
        while self._num_epochs is None or epoch < self._num_epochs:
            if self._shuffle:
                key, sub = prng.split(key)
                if epoch >= self._start_epoch:
                    order = torch.from_numpy(prng.permutation(sub, n).astype(np.int64))
                    yield order.to(self.device)
            elif epoch >= self._start_epoch:
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
        self._epochs_done, self._steps_into_epoch = self._start_epoch, self._start_step
        skip = self._start_step   # the token's cursor: its first epoch only
        for order in self._epoch_orders(n):
            if skip >= len(starts) and skip:
                raise ValueError('the device_inmem resume token is %d steps into an epoch of '
                                 '%d steps: the dataset or batch geometry changed since the '
                                 'checkpoint' % (skip, len(starts)))
            for j, start in enumerate(starts):
                if j < skip:
                    continue
                batch = _gather(cache, order[start:start + self.batch_size])
                # accounted before the yield: a snapshot taken while the
                # consumer holds an epoch's last batch reads a boundary
                if j + 1 == len(starts):
                    self._epochs_done, self._steps_into_epoch = self._epochs_done + 1, 0
                else:
                    self._steps_into_epoch = j + 1
                yield batch
            skip = 0

    def state_dict(self):
        """The resume token: ``(epochs_done, steps_into_epoch)`` with the batch
        size, ``drop_last`` and the seed.  It needs an explicit ``seed``, and
        mid-epoch ``deterministic_cache_order=True`` (the cursor indexes the
        cached row order, which only the content-sorted cache reproduces
        after a restart; at an epoch boundary any complete cache does)."""
        if self._seed is None:
            raise ValueError('a resume token needs an explicit seed= (the epoch orders must be '
                             'derived again after a restart)')
        if self._steps_into_epoch and not self._deterministic:
            raise ValueError('a mid-epoch checkpoint (%d steps into the epoch) needs '
                             'deterministic_cache_order=True; finish the epoch, or use '
                             'DiskCachedDataLoader' % self._steps_into_epoch)
        return {'version': 1,
                self._TOKEN_KEY: {'epochs_done': int(self._epochs_done),
                                  'steps_into_epoch': int(self._steps_into_epoch),
                                  'batch_size': int(self.batch_size),
                                  'drop_last': bool(self._drop_last), 'seed': int(self._seed)}}

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

        A loader resumed from a mid-epoch token (taken per step, with
        ``deterministic_cache_order=True``) finishes that epoch first, as a
        yield of its remaining ``steps - cursor`` steps (with a leading
        epochs axis of 1 when ``epochs_per_call > 1``), through the same
        graph; a cursor in the ragged tail (all full batches taken, which
        only a ``drop_last=False`` pass can leave) resumes at the next epoch,
        and a cursor past what the geometry allows raises.  Between yields
        :meth:`state_dict` reads epoch boundaries.
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

        def run_epoch(carry, order, start=0):
            if graphed:
                return scan.epoch(order, start)
            outs = []
            for i in range(start, steps):
                idx = order[i * self.batch_size:(i + 1) * self.batch_size]
                carry, out = step_fn(carry, _gather(cache, idx))
                outs.append(out)
            return carry, _stack(outs)

        self._epochs_done, self._steps_into_epoch = self._start_epoch, 0
        orders = self._epoch_orders(n)
        start = self._start_step
        if start:
            ragged_tail = bool(n % self.batch_size) and self._token_drop_last is False
            max_cursor = steps if ragged_tail else steps - 1
            if start > max_cursor:
                raise ValueError('the device_inmem resume token is %d steps into an epoch of %d '
                                 'full batches (at most %d for a token taken with drop_last=%r): '
                                 'the dataset or batch geometry changed since the checkpoint'
                                 % (start, steps, max_cursor, self._token_drop_last))
            first = next(orders, None)
            if first is None:
                return
            self._epochs_done += 1
            if start < steps:
                carry, outs = run_epoch(carry, first, start)
                yield carry, (outs if epochs_per_call == 1
                              else graphs.tree_map(lambda o: o[None], outs))
        while True:
            group = list(itertools.islice(orders, epochs_per_call))
            if not group:
                return
            epochs = []
            for order in group:
                carry, outs = run_epoch(carry, order)
                epochs.append(outs)
            self._epochs_done += len(group)   # a yield is an epoch boundary
            yield carry, (epochs[0] if epochs_per_call == 1 else _stack(epochs))


class ResidentDataLoader(InMemDataLoader):
    """The dataset on the card in its wire dtypes, epoch orders keyed by
    ``(seed, epoch)``, and a batch LRU under ``hbm_budget_bytes``
    (:mod:`~petastorm_tpu_torch.gpu.residency`): the JAX package's
    ``ResidentDataLoader``.

    The dataset is read once into host memory, which is kept.  Epoch 0
    streams: a :class:`~petastorm_tpu_torch.gpu.transfer.DispatchPump`
    thread slices each batch out of the host cache, narrows it to its wire
    dtypes (``wire_dtypes='auto'``: float32 and float64 as bfloat16; None:
    the device dtypes; or a ``{field: dtype}`` dict) into page-locked memory,
    copies it to the card on a stream of its own, admits it into the
    :class:`~petastorm_tpu_torch.gpu.residency.ResidencyTier` and widens it
    back; the training thread only takes finished batches.  Once every row
    is resident, each later epoch is served from the tier, one gather per
    batch on the card, with no host batch.

    Every epoch's order is ``epoch_permutation(seed, epoch, n)``, so every
    epoch delivers ``widen(narrow(rows))`` in the same order whether it
    streams or is served warm: the batches of a loader under
    ``PETASTORM_TPU_NO_RESIDENCY`` (the tier off, narrowing kept), of one
    whose budget cannot hold the dataset (every epoch streams, the LRU
    churns), and of one whose tier is dropped mid-epoch
    (:meth:`drop_resident_tier`: the rest streams) are the same, bit for
    bit, and the JAX loader's.  A dtype outside the wire support matrix
    streams every epoch at full width.  ``seed=None`` draws fresh entropy
    once, at the first iteration; every pass over the loader replays the
    same epochs.

    ``transform_fn`` and ``shuffling_queue_capacity`` are rejected (a warm
    batch never exists on the host).  :meth:`state_dict` is
    ``(epochs_done, steps_into_epoch)`` with the batch size, ``drop_last``
    and the explicit seed, as the JAX loader's token; mid-epoch it needs
    ``deterministic_cache_order=True``.
    """

    _TOKEN_KEY = 'resident'

    def __init__(self, reader, batch_size, num_epochs=1, shuffle=True, seed=None, device=None,
                 wire_dtypes='auto', hbm_budget_bytes=None, **kwargs):
        for unsupported in ('transform_fn', 'shuffling_queue_capacity'):
            if kwargs.get(unsupported):
                raise ValueError('ResidentDataLoader does not support %s' % unsupported)
        if wire_dtypes not in (None, 'auto') and not isinstance(wire_dtypes, dict):
            raise ValueError("wire_dtypes must be None, 'auto', or a {field: dtype} dict "
                             '(got %r)' % (wire_dtypes,))
        super(ResidentDataLoader, self).__init__(
            reader, batch_size, num_epochs=num_epochs, shuffle=shuffle, seed=seed,
            device=device, wire_dtypes=wire_dtypes, **kwargs)
        if self._sharding is not None:
            raise ValueError('ResidentDataLoader caches on one device; use '
                             'InMemDataLoader with sharding= for global '
                             'batch assembly')
        self._budget = hbm_budget_bytes
        self._tier = None
        self._plan = None
        self._identity_order = None
        self._copy_stream = None
        #: every counter and gauge exists from here on, 0 while the tier is off
        self._res_counters = residency.ensure_counters(self.metrics)
        #: drawn at the first iteration, then fixed: every pass replays it
        self._res_seed = None
        self._start_epoch = self._start_step = 0
        self._epochs_done = self._steps_into_epoch = 0
        resumed = (self._resume_state or {}).get(self._TOKEN_KEY)
        if resumed:
            if seed is None or int(resumed['seed']) != int(seed):
                raise ValueError(
                    'resident resume token was taken with seed=%r; rebuild the loader with that '
                    'explicit seed (every epoch order is derived from (seed, epoch))'
                    % (resumed['seed'],))
            self._start_epoch = int(resumed['epochs_done'])
            self._start_step = int(resumed.get('steps_into_epoch', 0))
            token_bs = resumed.get('batch_size')
            if self._start_step and token_bs is not None and int(token_bs) != int(batch_size):
                raise ValueError(
                    'resident resume token was taken %d steps into an epoch of batch_size=%d '
                    'batches; resume with that batch_size (got %d), or checkpoint at an epoch '
                    'boundary to change it' % (self._start_step, int(token_bs), int(batch_size)))
            if self._start_step and not self._deterministic:
                raise ValueError(
                    'mid-epoch resident resume requires deterministic_cache_order=True: the '
                    'step cursor indexes into the cached row order, which only the canonical '
                    'content-sorted cache reproduces across restarts')
            self._epochs_done, self._steps_into_epoch = self._start_epoch, self._start_step

    @property
    def residency_stats(self):
        """The residency counters: every key, whether the tier is on or not."""
        c = self._res_counters
        return {'admitted': int(c.admitted.value),
                'evictions': int(c.evictions.value),
                'hits': int(c.hits.value),
                'bypass': int(c.bypass.value),
                'thrash': int(c.thrash.value),
                'host_batches': int(c.host_batches.value)}

    @property
    def tier(self):
        """The loader's :class:`~petastorm_tpu_torch.gpu.residency.ResidencyTier`
        (None before the first iteration, and with the tier off)."""
        return self._tier

    def drop_resident_tier(self):
        """Release the tier now (to give its HBM to a model that grew, say).
        Safe mid-epoch: the rest of the pass streams from the host cache with
        the same batches."""
        if self._tier is not None:
            self._tier.drop()

    def _epoch_order(self, epoch, n):
        """Epoch ``epoch``'s row order: int64 on the host, the values of the
        JAX loader's int32 order."""
        if not self._shuffle:
            if self._identity_order is None or len(self._identity_order) != n:
                self._identity_order = np.arange(n, dtype=np.int64)
            return self._identity_order
        return residency.epoch_permutation(self._res_seed, epoch, n).astype(np.int64)

    def __iter__(self):
        if self._build_cache() is None:
            return iter(())
        numeric = _filter_numeric(self._cache, self._warned_fields)
        if not numeric:
            return iter(())
        n = _rows(numeric)
        if self._drop_last and n < self.batch_size:
            logger.warning('epoch cache holds %d rows < batch_size=%d with drop_last: no '
                           'batches to serve', n, self.batch_size)
            return iter(())
        # the kill switch turns the tier off, not the narrowing: a killed
        # loader delivers what the tier would
        plan = residency.wire_plan(numeric, self._wire_dtypes)
        cuda = self.device.type == 'cuda'
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        tier = None
        if plan is not None and not residency.killed():
            if self._tier is None:
                streams = (self._copy_stream, torch.cuda.current_stream(self.device)) \
                    if cuda else ()
                self._tier = residency.ResidencyTier(plan, n, self.batch_size, self._budget,
                                                     self._res_counters, device=self.device,
                                                     streams=streams)
            tier = self._tier
        self._plan = plan
        if self._res_seed is None:
            self._res_seed = self._seed if self._seed is not None \
                else int(np.random.default_rng().integers(2 ** 31))
        return self._gen(numeric, n, plan, tier)

    def _gen(self, cache, n, plan, tier):
        self._epochs_done, self._steps_into_epoch = self._start_epoch, self._start_step
        skip = self._start_step   # the token's cursor: its first epoch only
        epoch = self._start_epoch
        while self._num_epochs is None or epoch < self._num_epochs:
            order = self._epoch_order(epoch, n)
            stop = n - self.batch_size + 1 if self._drop_last else n
            starts = list(range(0, max(stop, 0), self.batch_size))
            if skip and skip >= len(starts):
                raise ValueError('resident resume token is %d steps into an epoch of %d steps '
                                 '— the dataset or batch geometry changed since the checkpoint'
                                 % (skip, len(starts)))
            if tier is not None and tier.serving_ok():
                batches = self._resident_epoch(cache, n, plan, tier, order, starts, skip)
            else:
                batches = self._streamed_epoch(cache, n, plan, tier, order, starts, skip)
            for j, batch in batches:
                self._m_batches.inc()
                # accounted before the yield: a snapshot taken while the
                # consumer holds an epoch's last batch reads a boundary
                if j + 1 == len(starts):
                    self._epochs_done, self._steps_into_epoch = self._epochs_done + 1, 0
                else:
                    self._steps_into_epoch = j + 1
                yield batch
            if tier is not None and not tier.fully_resident:
                tier.backfill(cache, plan)
            skip = 0
            epoch += 1

    def _stream_one(self, cache, n, plan, idx):
        """Slice, narrow, move and widen one batch of rows ``idx``: the
        streamed batch, ``widen(narrow(rows))`` as a warm gather gives it.
        Returns the wire tensors on the device beside the batch."""
        t0 = time.monotonic()
        if plan is not None:
            wire = plan.narrow(cache, idx, pin_memory=self.device.type == 'cuda')
        else:
            wire = {name: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[idx],
                                                                dtype=canonical_dtype(v.dtype)))
                    for name, v in cache.items()}
        t1 = time.monotonic()
        if plan is not None:
            wire_dev = plan.to_device(wire, self.device)
            batch = plan.widen(wire_dev)
        else:
            wire_dev = batch = {k: v.to(self.device, non_blocking=True) for k, v in wire.items()}
        t2 = time.monotonic()
        self._observe('host_batch', t0, t1)
        self._observe('device_put', t1, t2)
        self._res_counters.host_batches.inc()
        return wire_dev, batch

    def _streamed_epoch(self, cache, n, plan, tier, order, starts, skip):
        """One epoch through a dispatch thread, which slices, narrows, copies
        (on the loader's copy stream), admits and widens each batch while the
        consumer steps; the consumer's stream waits for each batch's event."""
        bs = self.batch_size
        copy_stream = self._copy_stream

        def source():
            for j, start in enumerate(starts):
                if j >= skip:
                    yield j, order[start:min(start + bs, n)]

        def ship(item):
            j, idx = item
            with torch.cuda.stream(copy_stream) if copy_stream is not None \
                    else contextlib.nullcontext():
                wire_dev, batch = self._stream_one(cache, n, plan, idx)
                if tier is not None:
                    tier.admit(idx, wire_dev)
                event = None
                if copy_stream is not None:
                    event = torch.cuda.Event()
                    event.record(copy_stream)
            return j, batch, event

        pump = DispatchPump(source(), ship, self._prefetch, device=self.device)
        self._pump = pump
        pump.start()
        try:
            while True:
                item = pump.get()
                if item is DONE:
                    return
                j, batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for tensor in batch.values():
                        # made on the copy stream, used on this one
                        tensor.record_stream(stream)
                yield j, batch
        finally:
            pump.stop(join_timeout_s=0.2)

    def _resident_epoch(self, cache, n, plan, tier, order, starts, skip):
        """One warm epoch: the order moved to the card once, then one gather
        per batch.  A tier dropped mid-epoch leaves the rest to stream from
        the host cache, on this thread: the same batches."""
        bs = self.batch_size
        order_dev = torch.from_numpy(order).to(self.device)
        for j, start in enumerate(starts):
            if j < skip:
                continue
            if tier.serving_ok():
                if start + bs <= n:
                    batch = tier.gather(order_dev, start)
                else:   # the ragged tail (drop_last=False)
                    batch = tier.gather_tail(order_dev, start)
            else:
                _, batch = self._stream_one(cache, n, plan, order[start:min(start + bs, n)])
                self._res_counters.bypass.inc()
            yield j, batch

    def state_dict(self):
        """The resume token: ``(epochs_done, steps_into_epoch)`` with the batch
        size, ``drop_last`` and the seed (the JAX loader's keys).  It needs
        an explicit ``seed``, and mid-epoch ``deterministic_cache_order=True``;
        the tier of the loader that resumes it is rebuilt by streaming, with
        the same batches."""
        if self._seed is None:
            raise ValueError('resume needs an explicit seed= (epoch orders must be '
                             're-derivable after restart)')
        if self._steps_into_epoch and not self._deterministic:
            raise ValueError(
                'mid-epoch checkpoint (%d steps into the current epoch) needs '
                'deterministic_cache_order=True — the step cursor indexes into the cached row '
                'order, which a pool-ordered rebuild does not reproduce' % self._steps_into_epoch)
        return {'version': 1,
                self._TOKEN_KEY: {'epochs_done': int(self._epochs_done),
                                  'steps_into_epoch': int(self._steps_into_epoch),
                                  'batch_size': int(self.batch_size),
                                  'drop_last': bool(self._drop_last), 'seed': int(self._seed)}}


class DiskCachedDataLoader(_EpochServer, DataLoader):
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
    keyword arguments go to :class:`DataLoader`.  :meth:`state_dict` is
    exact over a complete cache (the files are the persisted row order),
    whatever pool built it; during the epoch-0 build it raises.
    """

    _MANIFEST = 'manifest.json'
    _COMPLETE = '_COMPLETE'

    def __init__(self, reader, batch_size, decoded_cache_dir, num_epochs=1, shuffle=True,
                 seed=None, **kwargs):
        if kwargs.get('shuffling_queue_capacity'):
            raise ValueError('DiskCachedDataLoader shuffles via per-epoch permutation; '
                             'shuffling_queue_capacity is not supported')
        if reader is not None:
            if getattr(reader, 'ngram', None) is not None:
                raise ValueError('DiskCachedDataLoader does not support NGram readers (windows '
                                 'are not fixed-shape rows)')
            reader_epochs = getattr(reader, 'num_epochs', 1)
            if reader_epochs != 1:
                raise ValueError('DiskCachedDataLoader requires a reader built with '
                                 'num_epochs=1 (got num_epochs=%r); epoch repetition happens '
                                 'in the loader' % (reader_epochs,))
        super(DiskCachedDataLoader, self).__init__(reader, batch_size, seed=seed, **kwargs)
        self._cache_dir = decoded_cache_dir
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._epoch_pos = None   # set once the cache is complete

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
        resumed = (self._resume_state or {}).get('disk_cache')
        if not self.cache_complete(self._cache_dir):
            if resumed:
                raise ValueError('resume_state needs the complete decoded cache; the epoch-0 '
                                 'build was cut short: start again from the beginning')
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
        # fancy indexing a memmap reads just this batch
        yield from self._epoch_batches(
            n, epoch, resumed, lambda idx: {name: np.asarray(buf[idx])
                                            for name, buf in fields.items()})

    def state_dict(self):
        """An exact token over the complete cache: the epoch, its order, the
        offset in it and the generator's state, with the batches already on
        the device.  During the epoch-0 build it raises: checkpoint at the
        epoch boundary instead."""
        if self._epoch_pos is None:
            raise ValueError('state_dict() is supported once the decoded cache is complete '
                             '(from epoch 1 on); during the epoch-0 build checkpoint at the '
                             'epoch boundary instead')
        return self._epoch_token('disk_cache')


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

    def epoch(self, order, start=0):
        """Run one epoch in ``order`` from step ``start`` (a resumed
        cursor: the same graph, its cursor set there); returns ``(carry,
        outs)``, the outs of the steps run."""
        self._order.copy_(order)
        self._cursor.fill_(start)
        for _ in range(start, self._steps):
            self._graph()
        return self.carry, graphs.tree_map(lambda o: o[start:].clone(), self._outs)


def _gather(cache, idx):
    return {name: column.index_select(0, idx) for name, column in cache.items()}


def _stack(items):
    """Stack like outputs (tensors, or dicts of them) along a new leading axis."""
    if isinstance(items[0], dict):
        return {k: _stack([item[k] for item in items]) for k in items[0]}
    return torch.stack([torch.as_tensor(item) for item in items])

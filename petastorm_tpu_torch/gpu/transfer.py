"""Host -> device transfer of loader batches: the transfer plane.

Counterpart of ``petastorm_tpu/jax/transfer.py``.  With the plane on, a
batch (a dict of numpy arrays, nested dicts allowed) reaches the card in
these steps:

1. **coalescing**: every leaf is packed into ONE page-locked (pinned) uint8
   slab of a small ring, at a 64-byte-aligned offset, in the dtype it has
   on the device (the JAX package's rule: int64 -> int32, uint64 -> uint32,
   float64 -> float32, ``jax.dtypes.canonicalize_dtype`` without x64) or,
   opted into with ``wire_dtypes``, narrower on the wire (``'auto'``:
   float32/float64 -> bfloat16, cast on the host by torch with round to
   nearest even, as ml_dtypes rounds; a ``{field: dtype}`` dict names
   fields).  Leaves are laid out in the order ``jax.tree_util`` flattens
   them (sorted keys), so the slab is the JAX plane's byte for byte;
2. one ``non_blocking`` copy of the slab on a dedicated copy stream, so the
   copy of batch N+1 overlaps the step on batch N;
3. on the card the slab is cut back into the batch by slicing and
   ``.view(dtype)``/``.view(shape)``: a leaf that travelled at full width is
   a view of the slab (no kernel), a narrowed one is cast back;
4. an event recorded on the copy stream is what the consumer's stream waits
   on before it touches the batch (:meth:`TransferPlane.ready`), which also
   hands the slab's memory over to that stream (``record_stream``);
5. a ring slab is rewritten only after the copy that last read it finished
   (the wait on its slot's event, the ``h2d/commit`` window).

A batch structure the plane cannot pack **degrades**: :meth:`TransferPlane.put`
returns None and the caller runs :meth:`TransferPlane.put_inline`, one pinned
buffer and one copy per column (the path the loader took before the plane
existed, and takes with the plane off).  It degrades where the JAX plane
does: an empty tree, a zero-size leaf, a dtype that cannot be packed, a
single leaf at full width (coalescing buys nothing), or a slab over
``PETASTORM_TPU_TRANSFER_MAX_STAGING_MB`` (512).  ``h2d_degraded`` counts
these.  ``PETASTORM_TPU_NO_TRANSFER_PLANE`` (any non-empty value) turns the
plane off everywhere; it never turns off the card.

:class:`DispatchPump` is the thread that drives the plane for a loader: it
pulls host batches, runs the transform and the put, and queues device
batches, so that the training thread only pops them.

On the CPU (``device='cpu'``, the tests) the "copy" is a clone of the slab
and the unpack the same slicing and views.  Counters ``h2d_batches``,
``h2d_degraded``, ``h2d_bytes_wire`` and ``h2d_bytes_logical``, histograms
``h2d_stage``, ``h2d_dispatch`` and ``h2d_commit``, and ``h2d/stage``,
``h2d/dispatch`` and ``h2d/commit`` spans into a trace recorder, as the JAX
plane keeps them.  The sharded put of the JAX plane (``_plan_shards``,
``_put_sharded``: one slab segment and one copy per device of one process)
becomes, with one process per device, the loader's: under ``sharding=`` it
packs this rank's block of each leaf into the slab and moves it in one copy
to the rank's card (:class:`~petastorm_tpu_torch.gpu.loader.DataLoader`).
"""

import contextlib
import logging
import os
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch

from petastorm_tpu_torch.telemetry.registry import MetricsRegistry

logger = logging.getLogger(__name__)

__all__ = ['resolve_device', 'canonical_dtype', 'validate_transfer', 'plane_enabled',
           'supported', 'wire_dtype_for', 'TransferPlane', 'DispatchPump', 'pumps_paused',
           'KILL_SWITCH']

#: Set to any non-empty value to keep every loader on the inline put.
KILL_SWITCH = 'PETASTORM_TPU_NO_TRANSFER_PLANE'

#: Slabs above this many bytes degrade to the inline put (a slab is a
#: second host copy of the batch).
MAX_STAGING_BYTES = int(os.environ.get('PETASTORM_TPU_TRANSFER_MAX_STAGING_MB', '512')) << 20

#: Per-leaf slab alignment: keeps every view of the slab aligned.
_ALIGN = 64

#: One put in this many also waits for its copy to land (the ring's waits
#: see only what is left of a copy after a lap of overlap).
_COMMIT_SAMPLE_EVERY = 32

_TRANSFER_MODES = (True, False, None, 'auto')

_CANONICAL = {np.dtype('int64'): np.dtype('int32'),
              np.dtype('uint64'): np.dtype('uint32'),
              np.dtype('float64'): np.dtype('float32')}


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


#: Packable wire dtypes -> their numpy dtype (None: bfloat16, which numpy
#: has no name for and torch casts).
_PACKABLE = {_torch_dtype(np.dtype(name)): np.dtype(name)
             for name in ('bool', 'uint8', 'int8', 'int16', 'int32', 'int64', 'uint16',
                          'uint32', 'uint64', 'float16', 'float32', 'float64')}
_PACKABLE[torch.bfloat16] = None


def resolve_device(device=None):
    """The port's entry points run on the card: ``None`` means ``cuda``, and
    asking for the card where there is none raises.  Pass ``device='cpu'``
    to run on the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; petastorm_tpu_torch runs on the '
                           'card by default: pass device="cpu" to run on the CPU')
    return device


def canonical_dtype(dtype):
    """The dtype a column has on the device (JAX's rule without x64)."""
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


def validate_transfer(transfer):
    """``transfer=`` takes True, False, None or ``'auto'``; a string such as
    ``'off'`` is truthy and would turn the plane on, so it raises."""
    if transfer not in _TRANSFER_MODES:
        raise ValueError("transfer must be True, False, None, or 'auto' (got %r)" % (transfer,))


def plane_enabled(transfer, device=None):
    """Whether a loader with ``transfer=`` on ``device`` uses the plane:
    ``True`` yes (the CPU tests force it so), ``False``/``None`` no,
    ``'auto'`` on the card only (on the CPU the "copy" is a memcpy the
    staging pass cannot hide).  The kill switch wins over everything."""
    validate_transfer(transfer)
    if os.environ.get(KILL_SWITCH):
        return False
    if transfer is True:
        return True
    if not transfer:
        return False
    return torch.device('cuda' if device is None else device).type == 'cuda'


def _wire_of(want):
    """A ``wire_dtypes`` dict value as a torch dtype ('bfloat16', which
    numpy has no name for, included)."""
    if isinstance(want, torch.dtype):
        return want
    if 'bfloat16' in (str(want), getattr(want, '__name__', None)):
        return torch.bfloat16
    return _torch_dtype(np.dtype(want))


def _resolve_wire(name, out_dtype, policy):
    """Wire dtype (torch) of one leaf: its device dtype, or the policy's
    narrower one.  ``'auto'`` narrows floats of 32 bits or more to
    bfloat16; a dict names leaves by their last key."""
    out = _torch_dtype(out_dtype)
    if not policy:
        return out
    if policy == 'auto':
        return torch.bfloat16 if out_dtype.kind == 'f' and out_dtype.itemsize >= 4 else out
    want = policy.get(name)
    return out if want is None else _wire_of(want)


def supported(dtype):
    """The wire support matrix: fixed-width bool, int, uint and float dtypes
    (numpy's or torch's), bfloat16 included; datetime, complex, object and
    string dtypes are not."""
    if isinstance(dtype, torch.dtype):
        return dtype in _PACKABLE
    dtype = np.dtype(dtype)
    return dtype in _PACKABLE.values() or dtype.name == 'bfloat16'


def wire_dtype_for(name, out_dtype, policy):
    """The wire dtype (torch) of the leaf ``name`` whose device dtype is
    ``out_dtype`` under the ``wire_dtypes`` policy: the rule the plane packs
    by, which the resident tier (:mod:`~petastorm_tpu_torch.gpu.residency`)
    stores its rows in."""
    return _resolve_wire(name, np.dtype(out_dtype), policy)


def _leaves(tree, prefix=()):
    """``(path, leaf)`` of a tree of dicts, in insertion order."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    else:
        yield prefix, tree


def _build(paths, values):
    """The tree of dicts with ``values`` at ``paths``."""
    if paths == [()]:
        return values[0]
    out = {}
    for path, value in zip(paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def _signature(pairs):
    return tuple((path, np.shape(leaf), np.asarray(leaf).dtype.str) for path, leaf in pairs)


def _align(n):
    return -(-n // _ALIGN) * _ALIGN


class _Unsupported(Exception):
    """This batch structure cannot ride the plane."""


class _Field(object):
    __slots__ = ('offset', 'nbytes', 'wire', 'wire_np', 'out', 'shape')

    def __init__(self, offset, nbytes, wire, wire_np, out, shape):
        self.offset = offset
        self.nbytes = nbytes
        self.wire = wire         # torch dtype on the wire
        self.wire_np = wire_np   # the same for numpy; None for bfloat16
        self.out = out           # torch dtype on the device
        self.shape = shape


class _Layout(object):
    """Packing plan of one batch structure: each leaf's slab offset, wire
    dtype and device dtype.  Offsets follow the leaves' sorted paths (the
    order ``jax.tree_util`` flattens a dict in); ``fields`` and ``paths``
    follow the batch's own order, which the device batch keeps."""

    def __init__(self, pairs, policy):
        if not pairs:
            raise _Unsupported('empty tree')
        specs = {}
        for path, leaf in pairs:
            arr = np.asarray(leaf)
            if arr.size == 0:
                raise _Unsupported('zero-size leaf %s' % (path,))
            if arr.dtype.kind not in 'biuf':
                raise _Unsupported('leaf %s dtype %s is not wire-packable' % (path, arr.dtype))
            out = canonical_dtype(arr.dtype)
            wire = _resolve_wire(str(path[-1]) if path else '', out, policy)
            if wire not in _PACKABLE:
                raise _Unsupported('wire dtype %s for leaf %s is not packable' % (wire, path))
            specs[path] = (arr.shape, arr.size, out, wire)
        offsets, offset, logical = {}, 0, 0
        for path in sorted(specs):
            shape, size, out, wire = specs[path]
            offset = _align(offset)
            offsets[path] = offset
            offset += size * wire.itemsize
            logical += size * out.itemsize
        self.slab_nbytes = offset
        self.logical_nbytes = logical
        self.paths = [path for path, _ in pairs]
        self.fields = []
        for path in self.paths:
            shape, size, out, wire = specs[path]
            self.fields.append(_Field(offsets[path], size * wire.itemsize, wire, _PACKABLE[wire],
                                      _torch_dtype(out), shape))
        self.narrowed = any(f.wire != f.out for f in self.fields)
        if len(self.fields) == 1 and not self.narrowed:
            # one full-width leaf: the inline put is already one copy
            raise _Unsupported('single full-width leaf')

    def pack(self, leaves, slab):
        """Cast or copy each leaf into its bytes of the uint8 array ``slab``
        (numpy's unsafe casting for the device dtype, torch's round to
        nearest even for bfloat16; both release the interpreter lock)."""
        for field, leaf in zip(self.fields, leaves):
            dst = slab[field.offset:field.offset + field.nbytes]
            if field.wire_np is not None:
                dst.view(field.wire_np).reshape(field.shape)[...] = leaf
                continue
            src = np.asarray(leaf)
            if src.dtype != np.float32 or not src.flags.writeable:
                src = src.astype(np.float32)   # float64 rounds to float32 first, as ml_dtypes
            torch.from_numpy(dst).view(torch.bfloat16).view(field.shape).copy_(
                torch.from_numpy(src))

    def unpack(self, slab):
        """The batch from the slab tensor ``slab`` (on the device): views,
        and a cast back where the wire was narrowed."""
        values = []
        for field in self.fields:
            arr = slab[field.offset:field.offset + field.nbytes]
            if field.wire != torch.uint8:
                arr = arr.view(field.wire)
            arr = arr.view(field.shape)
            if field.wire != field.out:
                arr = arr.to(field.out)
            values.append(arr)
        return _build(self.paths, values)


class TransferPlane(object):
    """Coalescing, narrowing, ring-buffered host -> device transfer for one
    loader (one producer thread at a time).

    :meth:`put` returns ``(batch, event)``, or None when the structure
    degrades (then :meth:`put_inline`); :meth:`ready` hands a batch to the
    consuming stream.  ``wire_dtypes`` as in the module docstring;
    ``ring_slots`` pinned slabs (at least 2) bound the copies in flight;
    ``metrics`` is the registry the counters and histograms go to (a new
    one by default) and ``trace_recorder`` takes the ``h2d/*`` spans.
    """

    def __init__(self, device, wire_dtypes=None, ring_slots=3, metrics=None,
                 trace_recorder=None, max_staging_bytes=None):
        if wire_dtypes not in (None, 'auto') and not isinstance(wire_dtypes, dict):
            raise ValueError("wire_dtypes must be None, 'auto', or a {field: dtype} dict "
                             '(got %r)' % (wire_dtypes,))
        self.device = torch.device(device)
        self._cuda = self.device.type == 'cuda'
        self._policy = wire_dtypes
        nslots = max(2, int(ring_slots))
        self._slabs = [None] * nslots
        self._inflight = [None] * nslots    # the event of the copy that last read a slab
        self._turn = 0
        self._slots = [{'buffers': {}, 'event': None} for _ in range(nslots)]
        self._next = 0
        self._max_staging = MAX_STAGING_BYTES if max_staging_bytes is None \
            else int(max_staging_bytes)
        self._prepared = {}   # signature -> _Layout, or None when it degrades
        self._trace = trace_recorder
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self.metrics = metrics if metrics is not None else MetricsRegistry('transfer')
        self._m_batches = self.metrics.counter('h2d_batches')
        self._m_degraded = self.metrics.counter('h2d_degraded')
        self._m_wire = self.metrics.counter('h2d_bytes_wire')
        self._m_logical = self.metrics.counter('h2d_bytes_logical')
        self._h_stage = self.metrics.histogram('h2d_stage')
        self._h_dispatch = self.metrics.histogram('h2d_dispatch')
        self._h_commit = self.metrics.histogram('h2d_commit')
        #: The outcome of the latest put: ``{'outcome': 'coalesced' |
        #: 'narrowed' | 'degraded', 'stages': {name: [t0, t1]}}``.
        self.last_put = None

    # -- the coalesced put ---------------------------------------------------

    def put(self, tree):
        """Start moving ``tree`` through a ring slab; returns ``(batch,
        event)`` for :meth:`ready` (the event is None on the CPU), or None
        when this structure degrades."""
        pairs = list(_leaves(tree))
        layout = self._prepare(pairs)
        if layout is None:
            self._m_degraded.inc()
            self.last_put = {'outcome': 'degraded'}
            return None
        slot = self._turn % len(self._slabs)
        self._turn += 1
        commit = self._wait_slot(slot)
        slab = self._slot_slab(slot, layout.slab_nbytes)
        t0 = time.monotonic()
        layout.pack([leaf for _, leaf in pairs], slab.numpy())
        t1 = time.monotonic()
        if self._cuda:
            with torch.cuda.stream(self._stream):
                batch = layout.unpack(slab.to(self.device, non_blocking=True))
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            batch, event = layout.unpack(slab.clone()), None
        t2 = time.monotonic()
        self._inflight[slot] = event if self._cuda else True
        self._account(layout, t0, t1, t2)
        if commit is not None:
            self.last_put['stages']['h2d_commit'] = list(commit)
        if event is not None and int(self._m_batches.value) % _COMMIT_SAMPLE_EVERY == 1:
            self._observe_commit(event, 'sample')
        return batch, event

    def put_once(self, tree):
        """One coalesced copy outside the ring, for a whole dataset
        (``DeviceInMemDataLoader``): packed into a transient pageable slab
        and copied on the current stream, so the batch is ready where it is
        returned.  Returns the batch, or None when the structure degrades."""
        pairs = list(_leaves(tree))
        layout = self._prepare(pairs)
        if layout is None:
            self._m_degraded.inc()
            self.last_put = {'outcome': 'degraded'}
            return None
        slab = torch.empty(layout.slab_nbytes, dtype=torch.uint8)
        t0 = time.monotonic()
        layout.pack([leaf for _, leaf in pairs], slab.numpy())
        t1 = time.monotonic()
        batch = layout.unpack(slab.to(self.device) if self._cuda else slab)
        t2 = time.monotonic()
        self._account(layout, t0, t1, t2)
        return batch

    def _account(self, layout, t0, t1, t2):
        self._m_batches.inc()
        self._m_wire.inc(layout.slab_nbytes)
        self._m_logical.inc(layout.logical_nbytes)
        self._h_stage.observe(t1 - t0)
        self._h_dispatch.observe(t2 - t1)
        self.last_put = {'outcome': 'narrowed' if layout.narrowed else 'coalesced',
                         'stages': {'h2d_stage': [t0, t1], 'h2d_dispatch': [t1, t2]}}
        if self._trace is not None:
            self._trace.event('h2d/stage', t0, t1)
            self._trace.event('h2d/dispatch', t1, t2)

    def _prepare(self, pairs):
        sig = _signature(pairs)
        if sig not in self._prepared:
            try:
                layout = _Layout(pairs, self._policy)
                if layout.slab_nbytes > self._max_staging:
                    raise _Unsupported('staging slab %d B exceeds the %d B cap'
                                       % (layout.slab_nbytes, self._max_staging))
            except _Unsupported as e:
                logger.debug('transfer plane degrades for this batch structure: %s', e)
                layout = None
            self._prepared[sig] = layout
        return self._prepared[sig]

    # -- the ring ------------------------------------------------------------

    def _wait_slot(self, slot):
        """Wait until the copy that last read this slot's slab finished;
        returns the wait's window, or None when the slot was free."""
        event = self._inflight[slot]
        if event is None:
            return None
        self._inflight[slot] = None
        return self._observe_commit(event, 'ring')

    def _observe_commit(self, event, kind):
        t0 = time.monotonic()
        if event is not True:
            event.synchronize()
        t1 = time.monotonic()
        self._h_commit.observe(t1 - t0)
        if self._trace is not None:
            self._trace.event('h2d/commit', t0, t1, kind=kind)
        return t0, t1

    def _slot_slab(self, slot, nbytes):
        slab = self._slabs[slot]
        if slab is None or slab.numel() < nbytes:
            slab = self._slabs[slot] = torch.empty(nbytes, dtype=torch.uint8,
                                                   pin_memory=self._cuda)
        return slab[:nbytes]

    # -- the inline put ------------------------------------------------------

    def put_inline(self, host_batch):
        """One pinned buffer of a ring slot and one ``non_blocking`` copy per
        leaf of ``host_batch`` (a dict of numpy arrays, or of CPU tensors
        moved as they are; nested dicts allowed, as :meth:`put` takes),
        narrowed to the device dtype; returns ``(batch, event)`` for
        :meth:`ready` (None on the CPU, where the batch is only narrowed and
        wrapped)."""
        pairs = list(_leaves(host_batch))
        if not self._cuda:
            return _build([path for path, _ in pairs], [
                arr.clone() if isinstance(arr, torch.Tensor) else
                torch.from_numpy(np.asarray(arr).astype(canonical_dtype(arr.dtype)))
                for _, arr in pairs]), None
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot['event'] is not None:
            slot['event'].synchronize()   # the copy that last read this slot is done
        values = []
        with torch.cuda.stream(self._stream):
            for path, arr in pairs:
                if isinstance(arr, torch.Tensor):   # bfloat16, which numpy cannot hold
                    values.append(arr.to(self.device))
                    continue
                arr = np.asarray(arr)
                dtype = canonical_dtype(arr.dtype)
                buf = slot['buffers'].get(path)
                if buf is None or tuple(buf.shape) != arr.shape \
                        or buf.numpy().dtype != dtype:
                    buf = torch.from_numpy(np.empty(arr.shape, dtype)).pin_memory()
                    slot['buffers'][path] = buf
                np.copyto(buf.numpy(), arr, casting='unsafe')
                values.append(buf.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        slot['event'] = event
        return _build([path for path, _ in pairs], values), event

    def ready(self, batch, event):
        """Make the current stream wait for ``batch``'s copy and hand its
        memory over to that stream (a coalesced batch's views share the
        slab's, which they keep alive)."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for _, tensor in _leaves(batch):
                # allocated on the copy stream, used on this one: keep the
                # allocator from reusing the memory before this stream is done
                tensor.record_stream(stream)
        return batch

    # -- teardown ------------------------------------------------------------

    def drain(self):
        """Wait for every copy in flight; the slabs stay for reuse."""
        for i, event in enumerate(self._inflight):
            if event is not None and event is not True:
                event.synchronize()
            self._inflight[i] = None
        for slot in self._slots:
            if slot['event'] is not None:
                slot['event'].synchronize()

    def close(self):
        """Drain the ring and release the staging memory."""
        self.drain()
        self._slabs = [None] * len(self._slabs)
        for slot in self._slots:
            slot['buffers'] = {}


#: What :meth:`DispatchPump.get` returns once the stream has ended.
DONE = object()

#: Every started pump, for :func:`pumps_paused`.
_PUMPS = weakref.WeakSet()


@contextlib.contextmanager
def pumps_paused():
    """Park every live :class:`DispatchPump` for the duration (each pause
    returns once its thread is parked), then resume them: the step graphs
    capture inside this, since a CUDA call of another thread can fail or
    invalidate a capture."""
    # a stopped pump ships nothing more, though its thread may still sit in
    # a pull from a stopped reader: waiting for it could stall the capture
    pumps = [pump for pump in list(_PUMPS) if pump.alive and not pump._stopped]
    for pump in pumps:
        pump.pause()
    try:
        yield
    finally:
        for pump in pumps:
            pump.resume()


class DispatchPump(object):
    """The loader's transfer thread: pulls host batches from ``source`` (an
    iterator used by this thread only), ships each with ``ship`` (transform
    and put) and appends the result to ``pending``, keeping at most
    ``prefetch`` batches there; the consumer takes them with :meth:`get`.
    On the card the thread makes ``device`` its current device.

    ``pause()`` returns once the thread is parked (not touching the source,
    the plane or ``pending``) and counts, so pauses nest; ``resume()``
    undoes one.  ``stop()`` ends the thread; a pull blocked inside the
    reader cannot be interrupted, so the thread is a daemon and exits after
    that pull returns.  An error of the thread is raised by :meth:`get`
    after the batches queued before it.
    """

    def __init__(self, source, ship, prefetch, device=None):
        device = None if device is None else torch.device(device)
        if device is not None and device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())   # the caller's card
        self._device = device
        self._source = source
        self._ship = ship
        self._cap = max(1, int(prefetch))
        self.pending = deque()
        self._cond = threading.Condition()
        self._idle = False
        self._pause = 0
        self._stopped = False
        self._done = False
        self._error = None
        self._thread = threading.Thread(target=self._run, name='petastorm-tpu-torch-h2d-dispatch',
                                        daemon=True)

    def start(self):
        _PUMPS.add(self)
        self._thread.start()
        return self

    def _run(self):
        try:
            if self._device is not None and self._device.type == 'cuda':
                torch.cuda.set_device(self._device)   # this thread's current device
            while True:
                with self._cond:
                    while (self._pause or len(self.pending) >= self._cap) and not self._stopped:
                        self._idle = True
                        self._cond.notify_all()
                        self._cond.wait()
                    self._idle = False
                    if self._stopped:
                        return
                item = next(self._source)   # outside the lock: may block
                with self._cond:
                    if self._stopped:
                        return
                shipped = self._ship(item)
                with self._cond:
                    self.pending.append(shipped)
                    self._cond.notify_all()
        except StopIteration:
            pass
        except BaseException as e:  # noqa: BLE001 — raised by get()
            self._error = e
        finally:
            with self._cond:
                self._done = True
                self._idle = True
                self._cond.notify_all()

    def get(self):
        """The next shipped batch in stream order; the thread's error once
        the queued batches are served; :data:`DONE` at the end."""
        with self._cond:
            while not self.pending and not self._done:
                self._cond.wait()
            if self.pending:
                item = self.pending.popleft()
                self._cond.notify_all()
                return item
            if self._error is not None:
                raise self._error
            return DONE

    def pause(self):
        """Returns once the thread is parked or finished; it then stays so
        until :meth:`resume`."""
        with self._cond:
            self._pause += 1
            self._cond.notify_all()
            while not (self._idle or self._done):
                self._cond.wait()

    def resume(self):
        with self._cond:
            self._pause = max(0, self._pause - 1)
            self._cond.notify_all()

    def check(self):
        """Raise the error the thread ended with, if it did."""
        if self._error is not None:
            raise self._error

    def stop(self, join_timeout_s=2.0):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(join_timeout_s)

    def join(self, timeout_s=2.0):
        self._thread.join(timeout_s)

    @property
    def alive(self):
        return self._thread.is_alive()

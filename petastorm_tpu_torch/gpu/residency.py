"""The device-resident data plane: rows in HBM in their wire dtypes, epoch
orders keyed by ``(seed, epoch)``, and a batch LRU under a byte budget.

Counterpart of ``petastorm_tpu/jax/residency.py``, the plane of
:class:`~petastorm_tpu_torch.gpu.loader.ResidentDataLoader`:

* **the wire-dtype tier**: batches live on the card in the transfer plane's
  wire dtypes (:func:`~petastorm_tpu_torch.gpu.transfer.wire_dtype_for`:
  uint8 stays uint8, float32 rides as bfloat16 under ``'auto'``) and are
  widened back to their device dtypes when served, so HBM holds more rows
  than a full-width device cache.  Every epoch delivers
  ``widen(narrow(rows))``, streamed or served from the tier;
* **epoch orders**: :func:`epoch_permutation` is
  ``permutation(fold_in(PRNGKey(seed), epoch), n)``
  (:mod:`petastorm_tpu_torch.random`, ``jax.random`` reproduced), a pure
  function of the pair, so a resident epoch equals the streamed one and a
  resume token needs only ``(epochs_done, steps_into_epoch)``.  The order
  is computed on the host in numpy (JAX computes it on the device);
* **the batch LRU**: :class:`ResidencyTier` holds per-field slabs of
  ``(capacity,) + row_shape`` rows in the wire dtype.  Each admitted batch
  takes a contiguous slot range, one LRU entry; an admission that does not
  fit evicts the oldest entries (a thrash).  A write is an in-place
  ``copy_`` into the slot range.  Once every row is resident, a warm batch
  is one ``index_select`` of the slot map and one per field, then the cast
  back to the device dtype: no host batch at all.

Degrades as the JAX plane does: ``PETASTORM_TPU_NO_RESIDENCY`` (any
non-empty value) turns the tier off and the loader streams every epoch,
narrowing kept; a dtype outside the wire support matrix makes
:func:`wire_plan` return None and the loader streams at full width; a budget
below the dataset keeps admitting (the LRU churns) and never serves warm.

Each admission that allocates, each bypass and each drop is a record of
the decision journal (actor ``residency``, rule ``residency_budget``, with
the allocator's state before it, which ``why --check`` replays), and
:meth:`ResidencyTier.admit` returns the outcome the loader's provenance
record carries.  ``donation_supported`` and the shared
``place_once``/``device_cache_valid`` helpers of the JAX module are not
here: torch writes in place without donation, and the device cache places
its rows itself.
"""

import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.gpu.transfer import canonical_dtype, supported, wire_dtype_for
from petastorm_tpu_torch.telemetry import decisions as _decisions

__all__ = ['KILL_SWITCH', 'COUNTER_NAMES', 'GAUGE_NAMES', 'killed', 'epoch_key',
           'epoch_permutation', 'WirePlan', 'wire_plan', 'estimate_budget', 'ResidencyCounters',
           'ensure_counters', 'ResidencyTier']

#: Set to any non-empty value to turn the resident tier off: the loader then
#: streams every epoch (still narrowed on the wire).
KILL_SWITCH = 'PETASTORM_TPU_NO_RESIDENCY'

#: Counters made at construction, so a loader's registry holds all of them
#: even with the tier off.
COUNTER_NAMES = (
    'residency_admitted',
    'residency_evictions',
    'residency_hits',
    'residency_bypass',
    'residency_thrash',
    'residency_host_batches',
)

GAUGE_NAMES = (
    'residency_rows',
    'residency_bytes',
    'residency_budget_bytes',
)


def killed():
    """True when the ``PETASTORM_TPU_NO_RESIDENCY`` kill switch is set."""
    return bool(os.environ.get(KILL_SWITCH))


# -- epoch orders -------------------------------------------------------------

def epoch_key(seed, epoch):
    """The key of one epoch, ``fold_in(PRNGKey(seed), epoch)``."""
    return prng.fold_in(prng.PRNGKey(int(seed)), int(epoch))


def epoch_permutation(seed, epoch, n):
    """The order of ``n`` rows in epoch ``epoch`` under ``seed``: int32, the
    JAX plane's element for element."""
    return prng.permutation(epoch_key(seed, epoch), int(n))


# -- the wire plan --------------------------------------------------------------

#: Field alignment in a narrowed batch's buffer: keeps every view aligned.
_ALIGN = 64


class _Narrowed(dict):
    """``{field: tensor}`` of views of one uint8 ``buffer``."""

    __slots__ = ('buffer',)


class _WireField(object):
    __slots__ = ('wire', 'wire_np', 'out', 'row_shape', 'row_nbytes')

    def __init__(self, wire, out, row_shape):
        self.wire = wire             # torch dtype in the tier and on the wire
        self.wire_np = None if wire == torch.bfloat16 else torch.empty(0, dtype=wire).numpy().dtype
        self.out = out               # torch dtype delivered (the device dtype)
        self.row_shape = row_shape
        self.row_nbytes = int(np.prod(row_shape, dtype=np.int64)) * wire.itemsize


class WirePlan(object):
    """Per-field wire and device dtypes of a flat dict of ``(N, ...)`` arrays,
    fields in name order.  :meth:`narrow` casts host rows to the wire dtypes
    (numpy's cast; bfloat16 through float32 with torch's round to nearest
    even, as ml_dtypes rounds) into one buffer, :meth:`to_device` moves that
    buffer in one copy, and :meth:`widen` casts device tensors back.  The
    widening is exact, so a batch served from the tier equals the same rows
    streamed."""

    def __init__(self, fields, wire_row_nbytes, logical_row_nbytes):
        self.fields = fields
        self.wire_row_nbytes = wire_row_nbytes
        self.logical_row_nbytes = logical_row_nbytes
        self.narrowed = any(f.wire != f.out for f in fields.values())

    def narrow(self, host_rows, idx=None, pin_memory=False):
        """``{field: CPU tensor}`` of the host rows (the rows ``idx`` of each
        column, when given) in their wire dtypes: views of one uint8 buffer,
        each field at a 64-byte-aligned offset, page-locked with
        ``pin_memory``."""
        first = np.asarray(host_rows[next(iter(self.fields))])
        rows = len(first) if idx is None else len(idx)
        spans, total = [], 0
        for f in self.fields.values():
            spans.append((total, rows * f.row_nbytes))
            total += -(-rows * f.row_nbytes // _ALIGN) * _ALIGN
        buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pin_memory)
        out = _Narrowed()
        out.buffer = buf
        for (name, f), (offset, nbytes) in zip(self.fields.items(), spans):
            dst = buf[offset:offset + nbytes].view(f.wire).view((rows,) + f.row_shape)
            src = np.asarray(host_rows[name])
            if f.wire == torch.bfloat16:
                src = src if idx is None else src[idx]
                dst.copy_(torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32)))
            elif idx is not None and src.dtype == f.wire_np:
                # gathered straight into the buffer ('clip': no bounds
                # buffering; every index is a row of the column)
                np.take(src, idx, axis=0, out=dst.numpy(), mode='clip')
            else:
                np.copyto(dst.numpy(), src if idx is None else src[idx], casting='unsafe')
            out[name] = dst
        return out

    @staticmethod
    def to_device(wire, device):
        """The batch :meth:`narrow` made, on ``device``: its buffer in one
        ``non_blocking`` copy, cut into the same views there."""
        moved = wire.buffer.to(device, non_blocking=True)
        if moved is wire.buffer:
            return wire
        out = {}
        for name, t in wire.items():
            offset = t.storage_offset() * t.element_size()
            out[name] = moved[offset:offset + t.nbytes].view(t.dtype).view(t.shape)
        return out

    def widen(self, wire_dev):
        """The batch in its device dtypes (the wire tensors themselves where
        nothing narrows)."""
        if not self.narrowed:
            return wire_dev
        return {name: wire_dev[name].to(f.out) for name, f in self.fields.items()}


def wire_plan(tree, policy):
    """The :class:`WirePlan` of a flat dict of host arrays under the
    ``wire_dtypes`` policy, or None when the batch cannot ride the tier: an
    empty dict, a leaf of no rows axis, or a dtype (on the host or on the
    wire) outside the support matrix."""
    if not tree:
        return None
    fields = {}
    wire_row = logical_row = 0
    for name in sorted(tree):
        arr = np.asarray(tree[name])
        if arr.ndim < 1 or not supported(arr.dtype):
            return None
        out = canonical_dtype(arr.dtype)
        wire = wire_dtype_for(name, out, policy)
        if not supported(wire):
            return None
        field = fields[name] = _WireField(wire, torch.from_numpy(np.empty(0, out)).dtype,
                                          tuple(arr.shape[1:]))
        wire_row += field.row_nbytes
        logical_row += field.row_nbytes // wire.itemsize * out.itemsize
    return WirePlan(fields, wire_row, logical_row)


def estimate_budget(tree, policy='auto'):
    """Bytes a row takes on the wire and at full width, and ``hbm_ratio``:
    how many more rows the tier holds per byte than a full-width device
    cache (1.0 when nothing narrows).  None where :func:`wire_plan` is."""
    plan = wire_plan(tree, policy)
    if plan is None:
        return None
    return {
        'wire_bytes_per_row': plan.wire_row_nbytes,
        'logical_bytes_per_row': plan.logical_row_nbytes,
        'hbm_ratio': (float(plan.logical_row_nbytes) / plan.wire_row_nbytes
                      if plan.wire_row_nbytes else 1.0),
        'narrowed': plan.narrowed,
    }


# -- metrics --------------------------------------------------------------------

class ResidencyCounters(object):
    """The residency counters and gauges of a registry."""

    def __init__(self, metrics):
        self.admitted = metrics.counter('residency_admitted')
        self.evictions = metrics.counter('residency_evictions')
        self.hits = metrics.counter('residency_hits')
        self.bypass = metrics.counter('residency_bypass')
        self.thrash = metrics.counter('residency_thrash')
        self.host_batches = metrics.counter('residency_host_batches')
        self.rows = metrics.gauge('residency_rows')
        self.bytes = metrics.gauge('residency_bytes')
        self.budget = metrics.gauge('residency_budget_bytes')


def ensure_counters(metrics):
    """Make every residency counter and gauge (all 0 while the tier is off)."""
    return ResidencyCounters(metrics)


# -- the tier -------------------------------------------------------------------

class ResidencyTier(object):
    """Rows on the card in their wire dtypes, under a byte budget, with a
    batch LRU (see the module docstring).

    ``plan`` is the dataset's :class:`WirePlan`, ``n_rows`` its rows,
    ``budget_bytes`` the bytes the slabs may take (None: the whole dataset),
    ``counters`` its :class:`ResidencyCounters`.  Admission, backfill and
    :meth:`drop` may run on different threads (the loader's transfer thread
    admits while the training thread may drop): one lock orders them.  On
    the card every slab is marked used by ``streams`` (the loader's copy
    stream and its consumer's), so that its memory is not reused before the
    work either queued on it is done."""

    def __init__(self, plan, n_rows, batch_size, budget_bytes, counters, device=None,
                 streams=()):
        self._plan = plan
        self._n = int(n_rows)
        self._bs = int(batch_size)
        self._device = torch.device('cpu' if device is None else device)
        self._streams = tuple(streams)
        row_bytes = max(1, plan.wire_row_nbytes)
        if budget_bytes is None:
            self._capacity = self._n
        else:
            self._capacity = min(self._n, max(0, int(budget_bytes) // row_bytes))
        self._c = counters
        counters.budget.set(int(budget_bytes) if budget_bytes is not None
                            else self._capacity * row_bytes)
        self._lock = threading.Lock()
        self._slabs = None
        self._entries = OrderedDict()   # seq -> (slot, rows, row ids)
        self._seq = 0
        self._free = []                 # released (slot, rows) ranges
        self._bump = 0
        self._slot_of_row = np.full(self._n, -1, dtype=np.int32)
        self._resident = 0              # rows with a slot, kept as they change
        self._slot_map_dev = None
        self._dropped = False

    @property
    def capacity_rows(self):
        return self._capacity

    @property
    def can_hold_dataset(self):
        return self._capacity >= self._n

    @property
    def resident_rows(self):
        return self._resident

    @property
    def fully_resident(self):
        return (not self._dropped and self._slabs is not None
                and self.resident_rows == self._n)

    @property
    def dropped(self):
        return self._dropped

    @property
    def slabs(self):
        """``{field: tensor}`` of the slabs (None before the first admission
        and after :meth:`drop`)."""
        return self._slabs

    def serving_ok(self):
        """Whether warm batches can be gathered now: every row resident."""
        return self.fully_resident

    # -- slots ------------------------------------------------------------------

    def _ensure_slabs(self):
        if self._slabs is not None:
            return
        self._slabs = {name: torch.zeros((self._capacity,) + f.row_shape, dtype=f.wire,
                                         device=self._device)
                       for name, f in self._plan.fields.items()}
        for slab in self._slabs.values():
            for stream in self._streams:
                slab.record_stream(stream)

    def _alloc(self, rows):
        """A free range of exactly ``rows`` slots, else the bump pointer's; None
        when neither fits."""
        for i, (slot, free_rows) in enumerate(self._free):
            if free_rows == rows:
                del self._free[i]
                return slot
        if self._bump + rows <= self._capacity:
            slot = self._bump
            self._bump += rows
            return slot
        return None

    def _evict_lru(self):
        _, (slot, rows, row_ids) = self._entries.popitem(last=False)
        # only this entry's rows can point into its range (ranges never
        # overlap), and of those a row admitted again elsewhere since keeps
        # its newer slot
        slots = self._slot_of_row[row_ids]
        gone = row_ids[(slots >= slot) & (slots < slot + rows)]
        self._slot_of_row[gone] = -1
        self._resident -= len(gone)
        self._free.append((slot, rows))
        self._slot_map_dev = None
        self._c.evictions.inc()

    def _update_gauges(self):
        rows = self.resident_rows
        self._c.rows.set(rows)
        self._c.bytes.set(rows * self._plan.wire_row_nbytes)

    # -- admission --------------------------------------------------------------

    def admit(self, row_ids, wire_dev):
        """Admit one batch (``{field: tensor}`` on the card, wire dtypes) of the
        dataset rows ``row_ids``.  Returns ``'admitted'`` (it fit, or its rows
        were all resident already: nothing written), ``'evicted'`` (it
        displaced the oldest entries: a thrash) or ``'bypass'`` (the tier is
        dropped, or the batch exceeds the whole budget)."""
        row_ids = np.array(row_ids)   # kept with its entry
        rows = len(row_ids)
        with self._lock:
            if self._dropped or rows == 0 or rows > self._capacity:
                self._c.bypass.inc()
                _decisions.record_decision(
                    'residency', 'bypass', 'residency_budget',
                    {'rows': rows, 'capacity': self._capacity, 'dropped': bool(self._dropped)},
                    suppressed=True)
                return 'bypass'
            if (self._slot_of_row[row_ids] >= 0).all():
                # a warm re-sight allocates and displaces nothing: no record
                # (it would flood the journal every warm batch)
                return 'admitted'
            # the allocator's state before the evictions, from which the
            # decision's replay derives the outcome
            inputs = {'rows': rows, 'capacity': self._capacity, 'bump': self._bump,
                      'free_rows': [r for _, r in self._free],
                      'entry_rows': [r for _, r, _ in self._entries.values()]}
            self._ensure_slabs()
            evicted = False
            slot = self._alloc(rows)
            while slot is None and self._entries:
                self._evict_lru()
                evicted = True
                slot = self._alloc(rows)
            if slot is None:
                self._c.bypass.inc()
                _decisions.record_decision('residency', 'bypass', 'residency_budget', inputs,
                                           suppressed=True)
                return 'bypass'
            self._write(slot, rows, wire_dev)
            self._entries[self._seq] = (slot, rows, row_ids)
            self._seq += 1
            self._resident += int((self._slot_of_row[row_ids] < 0).sum())
            self._slot_of_row[row_ids] = np.arange(slot, slot + rows, dtype=np.int32)
            self._slot_map_dev = None
            self._c.admitted.inc()
            if evicted:
                self._c.thrash.inc()
            self._update_gauges()
            outcome = 'evicted' if evicted else 'admitted'
            _decisions.record_decision('residency', outcome, 'residency_budget', inputs,
                                       slot=slot)
            return outcome

    def _write(self, slot, rows, wire_dev):
        """Copy the batch into its slot range in place, on the current stream."""
        for name, slab in self._slabs.items():
            slab[slot:slot + rows].copy_(wire_dev[name])

    def backfill(self, cache, plan):
        """Admit every row no delivery brought (``drop_last`` never streams the
        ragged tail; a resumed pass never streams the batches it skipped), so
        that the next epoch can be served warm.  Only when the budget holds
        the whole dataset: a smaller one would evict as fast as it fills.
        Runs on the current stream, each batch copied as it is narrowed."""
        if self._dropped or not self.can_hold_dataset:
            return
        missing = np.flatnonzero(self._slot_of_row < 0)
        for i in range(0, len(missing), self._bs):
            idx = missing[i:i + self._bs]
            self.admit(idx, plan.to_device(plan.narrow(cache, idx), self._device))

    # -- warm batches -----------------------------------------------------------

    def _slot_map(self):
        """The slot of every row, int64 on the card; copied again only after
        the map changed."""
        if self._slot_map_dev is None:
            self._slot_map_dev = torch.from_numpy(
                self._slot_of_row.astype(np.int64)).to(self._device)
        return self._slot_map_dev

    def _take(self, idx):
        slots = torch.index_select(self._slot_map(), 0, idx)
        self._c.hits.inc()
        return {name: torch.index_select(self._slabs[name], 0, slots).to(f.out)
                for name, f in self._plan.fields.items()}

    def gather(self, order_dev, start):
        """The full batch at ``start`` of the epoch order ``order_dev`` (int64
        on the card): one slice, one ``index_select`` of the slot map and one
        per field, and the cast to the device dtypes."""
        return self._take(order_dev[start:start + self._bs])

    def gather_tail(self, order_dev, start):
        """The ragged last batch of an epoch (``drop_last=False``)."""
        return self._take(order_dev[start:])

    # -- teardown ---------------------------------------------------------------

    def drop(self):
        """Release the tier; the loader streams from then on.  Safe mid-epoch
        and more than once; the live entries count as evictions."""
        with self._lock:
            if self._dropped:
                return
            _decisions.record_decision(
                'residency', 'drop', 'residency_budget',
                {'entries': len(self._entries), 'resident_rows': self._resident,
                 'capacity': self._capacity})
            if self._slabs is not None and self._entries:
                self._c.evictions.inc(len(self._entries))
            self._slabs = None
            self._entries.clear()
            self._free = []
            self._bump = 0
            self._slot_of_row[:] = -1
            self._resident = 0
            self._slot_map_dev = None
            self._dropped = True
            self._update_gauges()

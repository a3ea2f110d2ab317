"""The async byte-range ingest plane: prefetch in dispatch order.

Counterpart of ``petastorm_tpu/ingest/plane.py``.  A reader worker reading
a cold store pays every first-byte latency on a decode worker's clock; this
plane moves that wait off it:

* **dispatch-ordered readahead**: the ventilator's ``dispatch_listener``
  feeds each dispatched work item (FIFO, or the adaptive policy's
  early-launch order) into a bounded prefetch window; fetch threads walk
  that order, so bytes land just before their piece is decoded.  The
  window is the autotuner's ``ingest_window`` knob
  (:mod:`petastorm_tpu_torch.workers_pool.scheduling`).
* **coalesced range reads**: each piece's fetch is planned from footer
  metadata (the selected columns' chunks, :mod:`~petastorm_tpu_torch.
  ingest.planner`), merged into bounded reads and handed to pyarrow as an
  in-memory :class:`~petastorm_tpu_torch.ingest.planner.SparseFile`.
* **request hedging**: a checkout blocked past an adaptive quantile
  deadline launches one hedge fetch on a fresh handle; the first reply
  wins, and the loser stops between ranges.
* **degrade matrix**: ``PETASTORM_TPU_NO_INGEST_PLANE=1`` turns the plane
  off everywhere; ``'auto'`` stays off on local filesystems (the port's
  :class:`~petastorm_tpu_torch.fs_utils.LocalFilesystem` has protocol
  ``'file'``) and for process-pool readers; any fetch, plan or decode
  failure falls back, for that piece, to the synchronous read
  (``ingest_degraded``).  Delivery is the same in every mode.

Telemetry: spans ``ingest/fetch`` and ``ingest/hedge`` into the plane's own
:class:`~petastorm_tpu_torch.telemetry.spans.SpanBuffer` (the loader drains
them into its trace recorder), histograms ``ingest_fetch`` (fetch wall) and
``ingest_wait`` (decode blocked on a fetch, the autotuner's signal),
counters ``ingest_fetches``, ``ingest_fetch_bytes``, ``ingest_gets``,
``ingest_degraded``, ``ingest_hedges``, ``ingest_hedge_wins``, and the
decision journal's ``hedge`` records.
"""

import logging
import os
import threading
import time
from collections import OrderedDict, deque

import pyarrow.parquet as pq

from petastorm_tpu_torch.ingest import planner as _planner
from petastorm_tpu_torch.telemetry import decisions as _decisions
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
from petastorm_tpu_torch.telemetry.spans import SpanBuffer
from petastorm_tpu_torch.workers_pool.scheduling import (DEFAULT_INGEST_WINDOW,
                                                         MAX_INGEST_WINDOW,
                                                         MIN_INGEST_WINDOW)

logger = logging.getLogger(__name__)

__all__ = ['IngestPlane', 'resolve_ingest', 'KILL_SWITCH', 'INGEST_MODES']

KILL_SWITCH = 'PETASTORM_TPU_NO_INGEST_PLANE'

INGEST_MODES = ('auto', 'plane', 'off')

#: fsspec protocols where first-byte latency is page-cache cheap — the
#: plane would only add buffer copies, so ``'auto'`` stays off.
_LOCAL_PROTOCOLS = ('file', 'local', 'memory')

#: Completed-fetch samples needed before the adaptive hedge deadline
#: arms (hedging off a handful of timings would hedge the warmup).
HEDGE_MIN_SAMPLES = 8
#: deadline = max(floor, HEDGE_FACTOR * p95 of observed fetch wall).
HEDGE_QUANTILE = 0.95
HEDGE_FACTOR = 3.0
HEDGE_MIN_DEADLINE_S = 0.25

#: A checkout blocked this long gives up on the plane entirely and
#: degrades to the synchronous path (the fetch, when it eventually
#: lands, is discarded) — the plane must never wedge an epoch.
CHECKOUT_TIMEOUT_S = 60.0

#: Parsed footers kept per plane (path-keyed LRU): fetch planning for
#: later row groups of an already-seen file costs zero I/O.
FOOTER_CACHE_FILES = 64

DEFAULT_MAX_BUFFER_BYTES = 256 << 20

# entry states
_QUEUED, _FETCHING, _READY, _FAILED = range(4)


def resolve_ingest(mode, filesystem=None, in_process_pool=True):
    """``'auto'``/``'plane'``/``'off'`` -> the effective mode.

    The kill switch (``PETASTORM_TPU_NO_INGEST_PLANE=1``) wins over
    everything, including an explicit ``'plane'`` — production incident
    response needs "the plane is definitely off" without argument
    archaeology.  ProcessPool readers resolve off even when explicit:
    the plane's buffers live in the parent and cannot cross the worker
    pickle boundary.  ``'auto'`` additionally turns off on
    local/memory-protocol filesystems, where pyarrow's mmap path already
    beats any buffer copy — delegating wrappers (fault injection, tests)
    inherit their inner protocol, so only storage that actually pays
    first-byte latency gets the plane by default.
    """
    if mode not in INGEST_MODES:
        raise ValueError("ingest must be one of %s; got %r"
                         % (', '.join(repr(m) for m in INGEST_MODES), mode))
    if os.environ.get(KILL_SWITCH) == '1':
        return 'off'
    if mode == 'off' or not in_process_pool:
        return 'off'
    if mode == 'plane':
        return 'plane'
    protocol = getattr(filesystem, 'protocol', None)
    if isinstance(protocol, (tuple, list)):
        protocol = protocol[0] if protocol else None
    if protocol is None or protocol in _LOCAL_PROTOCOLS:
        return 'off'
    return 'plane'


class _Entry(object):
    """One planned piece's fetch state.  All fields except ``done`` are
    read/written under the plane lock; ``done`` is additionally read
    lock-free by in-flight fetches as their cooperative cancel flag."""

    __slots__ = ('key', 'state', 'refs', 'event', 'segments', 'size',
                 'started', 'hedged', 'failures', 'demanded', 'done',
                 'nbytes', 'error', 'admitted')

    def __init__(self, key):
        self.key = key
        self.state = _QUEUED
        self.refs = 1
        self.event = threading.Event()
        self.segments = None
        self.size = 0
        self.started = None
        self.hedged = False
        self.failures = 0
        self.demanded = False
        self.done = False
        self.nbytes = 0
        self.error = None
        #: True once a fetch thread popped this entry off the pending
        #: queue (it then counts against the window occupancy).
        self.admitted = False


class IngestPlane(object):
    """The fetch pump: see module docstring.

    ``pieces`` is the reader's GLOBAL piece list (work items carry
    global indices); ``columns`` the union of selected + predicate
    column names (``None`` = fetch whole row groups).  ``registry``
    receives the histograms/counters (defaults to a private registry).
    """

    def __init__(self, filesystem, pieces, columns=None, registry=None,
                 window=None, fetch_threads=None,
                 max_buffer_bytes=DEFAULT_MAX_BUFFER_BYTES,
                 merge_gap=_planner.DEFAULT_MERGE_GAP,
                 max_range_bytes=_planner.DEFAULT_MAX_RANGE_BYTES,
                 hedge_deadline_s=None,
                 checkout_timeout_s=CHECKOUT_TIMEOUT_S):
        self._fs = filesystem
        self._pieces = list(pieces)
        self._columns = frozenset(columns) if columns is not None else None
        self._merge_gap = int(merge_gap)
        self._max_range_bytes = int(max_range_bytes)
        self._max_buffer_bytes = int(max_buffer_bytes)
        self._hedge_deadline_s = hedge_deadline_s
        self._checkout_timeout_s = float(checkout_timeout_s)
        self.window = min(MAX_INGEST_WINDOW,
                          max(MIN_INGEST_WINDOW,
                              int(window or DEFAULT_INGEST_WINDOW)))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = deque()      # keys in dispatch order, not yet fetching
        self._entries = {}           # key -> _Entry (QUEUED..FAILED)
        self._occupancy = 0          # entries FETCHING or READY (window term)
        self._buffered_bytes = 0     # READY segment bytes held
        self._footers = OrderedDict()  # path -> (metadata, size, off, tail)
        self._durations = deque(maxlen=128)  # completed fetch walls (hedging)
        self._stopped = False
        self._listener_dead = False
        #: Spans buffer of this plane instance (like the cache plane's):
        #: the loader drains it into its trace recorder per batch;
        #: bare readers keep it for local inspection.
        self.spans = SpanBuffer()
        self.metrics = registry if registry is not None \
            else MetricsRegistry('ingest')
        self._m_fetch = self.metrics.histogram('ingest_fetch')
        self._m_wait = self.metrics.histogram('ingest_wait')
        self._c_fetches = self.metrics.counter('ingest_fetches')
        self._c_bytes = self.metrics.counter('ingest_fetch_bytes')
        self._c_gets = self.metrics.counter('ingest_gets')
        self._c_degraded = self.metrics.counter('ingest_degraded')
        self._c_hedges = self.metrics.counter('ingest_hedges')
        self._c_hedge_wins = self.metrics.counter('ingest_hedge_wins')
        # Per-plan gap/waste accounting: what the columns occupy vs what
        # the coalesced GETs transfer, registered here so it rides every
        # snapshot.
        self._c_plan_needed = self.metrics.counter('ingest_plan_needed_bytes')
        self._c_plan_waste = self.metrics.counter('ingest_plan_waste_bytes')
        self._g_waste_pct = self.metrics.gauge('ingest_plan_waste_pct')
        #: explicit fetch_threads pins the pool size; otherwise it
        #: tracks the window (set_window grows it) — a widened window
        #: with a frozen thread pool could not raise fetch concurrency,
        #: which is the only thing widening it is FOR.
        self._fetch_threads_pinned = fetch_threads is not None
        self._threads = []
        self._hedge_threads = []
        self._spawn_fetch_threads(int(fetch_threads) if fetch_threads
                                  else min(max(self.window, 2), 16))

    def _spawn_fetch_threads(self, target):
        """Grow the fetch pool to ``target`` threads (never shrinks —
        surplus threads just wait on the condition, costing nothing)."""
        for i in range(len(self._threads), max(1, int(target))):
            thread = threading.Thread(target=self._fetch_loop,
                                      name='ingest-fetch-%d' % i, daemon=True)
            thread.start()
            self._threads.append(thread)

    # -- dispatch feed -------------------------------------------------------

    def observe_dispatch(self, item):
        """Ventilator ``dispatch_listener``: one dispatched work item.
        Accepts ``VentilatedItem`` or a bare ``(piece_index, ...)``
        tuple; anything unmappable is ignored (those pieces simply take
        the synchronous path)."""
        args = getattr(item, 'args', item)
        try:
            index = args[0]
        except (TypeError, IndexError, KeyError):
            return
        if not isinstance(index, int) or not 0 <= index < len(self._pieces):
            return
        piece = self._pieces[index]
        key = (piece.path, piece.row_group)
        with self._cond:
            if self._stopped:
                return
            entry = self._entries.get(key)
            if entry is not None:
                # a second drop-partition (or epoch overlap) of the same
                # row group: one fetch serves every checkout
                entry.refs += 1
                return
            self._entries[key] = _Entry(key)
            self._pending.append(key)
            self._cond.notify()

    # -- fetch pump ----------------------------------------------------------

    def _admissible_key(self):
        """Caller holds the lock: the next key a fetch thread may take,
        or None.  Demanded keys (a decode worker is already blocked on
        them) bypass the window; everything else honors the window and
        byte bound."""
        for key in self._pending:
            if self._entries[key].demanded:
                return key
        if not self._pending:
            return None
        if self._occupancy >= self.window \
                or self._buffered_bytes >= self._max_buffer_bytes:
            return None
        return self._pending[0]

    def _fetch_loop(self):
        while True:
            with self._cond:
                key = self._admissible_key()
                while not self._stopped and key is None:
                    self._cond.wait()
                    key = self._admissible_key()
                if self._stopped:
                    return
                self._pending.remove(key)
                entry = self._entries[key]
                if entry.done:
                    # abandoned while still queued: the abandoning
                    # checkout's final ref removes it; don't resurrect
                    continue
                entry.state = _FETCHING
                entry.started = time.monotonic()
                entry.admitted = True
                self._occupancy += 1
            self._fetch(entry, hedge=False)

    def _footer(self, path, handle):
        with self._lock:
            cached = self._footers.get(path)
            if cached is not None:
                self._footers.move_to_end(path)
                return cached
        size = self._fs.size(path)
        found = _planner.read_footer(handle, size) + (int(size),)
        with self._lock:
            self._footers[path] = found
            while len(self._footers) > FOOTER_CACHE_FILES:
                self._footers.popitem(last=False)
        return found

    def _fetch(self, entry, hedge):
        """One fetch attempt (primary or hedge) for ``entry``: open a
        handle, plan from the (cached) footer, read the coalesced
        ranges.  First completed attempt wins; the loser notices
        ``entry.done`` between ranges and abandons."""
        path, row_group = entry.key
        t0 = time.monotonic()
        segments = None
        error = None
        nbytes = 0
        ngets = 0
        size = 0
        handle = None
        plan = None
        try:
            # No `with`: delegating wrapper handles (fault injection,
            # emulation) routinely lack __enter__, and implicit special
            # method lookup bypasses their __getattr__.
            handle = self._fs.open(path, 'rb')
            metadata, tail_offset, tail, size = self._footer(path, handle)
            raw_ranges = _planner.column_chunk_ranges(metadata, row_group,
                                                      self._columns)
            ranges = _planner.coalesce(raw_ranges, self._merge_gap,
                                       self._max_range_bytes)
            plan = _planner.plan_stats(raw_ranges, ranges)
            segments = {tail_offset: tail}
            for offset, length in ranges:
                if entry.done or self._stopped:
                    segments = None   # lost the race / shutdown
                    break
                handle.seek(offset)
                segments[offset] = _planner.read_exact(handle, length)
                nbytes += length
                ngets += 1
        except Exception as e:  # noqa: BLE001 — any failure degrades per piece
            segments, error = None, e
        finally:
            if handle is not None:
                try:
                    handle.close()
                except Exception as e:  # noqa: BLE001 — best-effort teardown
                    logger.debug('ingest fetch handle close failed for %r: '
                                 '%s', path, e)
        t1 = time.monotonic()
        self.spans.span('ingest/hedge' if hedge else 'ingest/fetch', t0, t1,
                        cid='%s:%d' % (path, row_group))
        won = failed = False
        with self._cond:
            if self._entries.get(entry.key) is entry and not entry.done:
                if segments is not None:
                    entry.segments = segments
                    entry.size = size
                    entry.nbytes = sum(len(v) for v in segments.values())
                    entry.state = _READY
                    entry.done = True
                    self._buffered_bytes += entry.nbytes
                    won = True
                else:
                    entry.failures += 1
                    attempts = 2 if entry.hedged else 1
                    if entry.failures >= attempts:
                        # every launched attempt failed: the piece
                        # degrades to the synchronous path
                        entry.state = _FAILED
                        entry.error = error
                        entry.done = True
                        failed = True
            if entry.done:
                entry.event.set()
                self._cond.notify_all()
        if won:
            with self._lock:
                self._durations.append(t1 - t0)
            self._m_fetch.observe(t1 - t0)
            self._c_fetches.inc()
            self._c_bytes.inc(nbytes)
            self._c_gets.inc(ngets)
            if plan is not None:
                self._c_plan_needed.inc(plan['needed_bytes'])
                self._c_plan_waste.inc(plan['waste_bytes'])
                needed = self._c_plan_needed.value
                waste = self._c_plan_waste.value
                fetched = needed + waste
                self._g_waste_pct.set(
                    round(100.0 * waste / fetched, 2) if fetched else 0.0)
            if hedge:
                self._c_hedge_wins.inc()
                _decisions.record_decision(
                    'hedge', 'hedge_win', 'hedge_deadline_s',
                    {'won': True, 'wall_s': t1 - t0},
                    row_group=entry.key[1])
        elif failed:
            self._c_degraded.inc()
            logger.debug('ingest fetch failed for row group %d of %r '
                         '(degrading to the synchronous path): %s',
                         row_group, path, error)

    # -- hedging -------------------------------------------------------------

    def hedge_deadline_s(self):
        """Seconds a blocked checkout waits before hedging, or None
        while unarmed (explicit ``hedge_deadline_s`` wins; the adaptive
        deadline needs :data:`HEDGE_MIN_SAMPLES` completed fetches)."""
        if self._hedge_deadline_s is not None:
            return float(self._hedge_deadline_s)
        with self._lock:
            samples = sorted(self._durations)
        if len(samples) < HEDGE_MIN_SAMPLES:
            return None
        q95 = samples[min(len(samples) - 1,
                          int(round(HEDGE_QUANTILE * (len(samples) - 1))))]
        return max(HEDGE_MIN_DEADLINE_S, HEDGE_FACTOR * q95)

    def _launch_hedge(self, entry):
        """Launch the one hedge fetch; True when it actually launched
        (the caller journals the decision with its deadline inputs)."""
        with self._cond:
            if entry.done or entry.hedged or entry.state != _FETCHING \
                    or self._stopped:
                return False
            entry.hedged = True
        self._c_hedges.inc()
        thread = threading.Thread(target=self._fetch, args=(entry, True),
                                  name='ingest-hedge', daemon=True)
        thread.start()
        with self._lock:
            # prune finished hedges: the list exists only so close()
            # can join LIVE ones — unbounded growth on a hedging-heavy
            # job would be a slow leak
            self._hedge_threads = [t for t in self._hedge_threads
                                   if t.is_alive()]
            self._hedge_threads.append(thread)
        return True

    # -- decode-side checkout ------------------------------------------------

    def checkout(self, path, row_group):
        """The prefetched piece as a ``pq.ParquetFile`` over in-memory
        bytes, or None (not planned / failed / plane stopping) — the
        caller then takes the synchronous path.  Blocks while the fetch
        is in flight; a block past the hedge deadline launches one
        hedge, and a block past ``checkout_timeout_s`` abandons the
        piece entirely (``ingest_degraded``)."""
        key = (path, row_group)
        with self._cond:
            entry = self._entries.get(key)
            if entry is None or self._stopped:
                return None
            if entry.state == _QUEUED and not entry.demanded:
                # decode is already asking: bypass the window so a full
                # readahead buffer can never deadlock the demand path
                entry.demanded = True
                self._cond.notify_all()
        waited = self._wait_ready(entry)
        if waited is not None:
            self._m_wait.observe(waited)
        with self._cond:
            if self._entries.get(key) is not entry:
                return None   # raced with another checkout's final ref
            entry.refs -= 1
            ready = entry.state == _READY
            segments, size = entry.segments, entry.size
            if entry.refs <= 0 and entry.state in (_READY, _FAILED):
                self._remove_entry_locked(key, entry)
                self._cond.notify_all()
        if not ready or self._stopped:
            return None
        return pq.ParquetFile(_planner.SparseFile(size, segments))

    def _remove_entry_locked(self, key, entry):
        """Caller holds the lock: drop ``entry`` and undo exactly the
        accounting it holds — pending membership for never-admitted
        entries, window occupancy for admitted ones, buffered bytes for
        READY ones."""
        del self._entries[key]
        if entry.admitted:
            self._occupancy -= 1
        else:
            try:
                self._pending.remove(key)
            except ValueError:
                pass
        if entry.state == _READY:
            self._buffered_bytes -= entry.nbytes

    def _wait_ready(self, entry):
        """Block until ``entry.done`` (hedging + abandoning en route).
        Returns the blocked seconds, or None when the entry was already
        done (no wait — the readahead did its job)."""
        if entry.event.is_set():
            return None
        start = time.monotonic()
        give_up_at = start + self._checkout_timeout_s
        while True:
            deadline = self.hedge_deadline_s()
            hedge_at = None
            if deadline is not None and not entry.hedged:
                # a still-QUEUED entry deadlines from NOW (hedging an
                # unstarted fetch is meaningless; demand promotion is
                # already pulling it forward)
                base = entry.started
                hedge_at = (base if base is not None
                            else time.monotonic()) + deadline
            now = time.monotonic()
            next_wake = min(give_up_at, hedge_at) \
                if hedge_at is not None else give_up_at
            if hedge_at is None and not entry.hedged:
                # the adaptive deadline may ARM mid-wait (other fetches
                # completing their 8th sample): re-evaluate periodically
                # instead of sleeping to the 60 s give-up — the blocked
                # straggler is exactly the fetch hedging exists for
                next_wake = min(next_wake, now + HEDGE_MIN_DEADLINE_S)
            if entry.event.wait(max(0.0, next_wake - now)):
                return time.monotonic() - start
            now = time.monotonic()
            if hedge_at is not None and now >= hedge_at:
                if self._launch_hedge(entry):
                    with self._lock:
                        samples = len(self._durations)
                    _decisions.record_decision(
                        'hedge', 'hedge', 'hedge_deadline_s',
                        {'blocked_s': deadline + (now - hedge_at),
                         'deadline_s': deadline,
                         'explicit': self._hedge_deadline_s is not None,
                         'samples': samples},
                        row_group=entry.key[1])
            if now >= give_up_at:
                # abandon: degrade this checkout to the sync path; the
                # in-flight fetch discards its bytes when it lands
                with self._cond:
                    if self._entries.get(entry.key) is entry \
                            and not entry.done:
                        entry.done = True
                        entry.state = _FAILED
                        entry.event.set()
                        self._cond.notify_all()
                        self._c_degraded.inc()
                        _decisions.record_decision(
                            'hedge', 'abandon', 'checkout_timeout_s',
                            {'blocked_s': now - start,
                             'timeout_s': self._checkout_timeout_s},
                            row_group=entry.key[1])
                return time.monotonic() - start

    def discard(self, path, row_group):
        """Release one dispatch ref WITHOUT consuming the buffer — the
        decode side satisfied this work item elsewhere (a result-cache
        hit never reads Parquet at all).  On the last ref the entry is
        dropped, freeing its window slot/bytes and cooperatively
        cancelling any in-flight fetch; without this, a warm epoch's
        cache hits would leak their prefetched entries until the window
        wedged full."""
        key = (path, row_group)
        with self._cond:
            entry = self._entries.get(key)
            if entry is None:
                return
            entry.refs -= 1
            if entry.refs > 0:
                return
            entry.done = True   # in-flight fetch sees this and discards
            entry.event.set()
            self._remove_entry_locked(key, entry)
            self._cond.notify_all()

    def degraded(self, error=None):
        """Count a decode-side ingest failure (a fetched buffer that
        could not serve the read — plan miss, parse error); the caller
        falls back to the synchronous path."""
        self._c_degraded.inc()
        if error is not None:
            logger.debug('ingest buffer failed at decode (degrading to the '
                         'synchronous path): %s', error)

    # -- knobs / introspection -----------------------------------------------

    def set_window(self, window):
        """Live readahead-window bound (the autotuner's ``ingest_window``
        knob).  Unless an explicit ``fetch_threads`` pinned the pool,
        the fetch pool grows with the window — otherwise widening it
        could never raise fetch concurrency."""
        with self._cond:
            if self._stopped:
                return
            self.window = min(MAX_INGEST_WINDOW,
                              max(MIN_INGEST_WINDOW, int(window)))
            if not self._fetch_threads_pinned:
                self._spawn_fetch_threads(min(self.window, 16))
            self._cond.notify_all()

    @property
    def wait_seconds(self):
        """Cumulative seconds decode spent blocked on fetches — the
        autotuner's grow signal (hidden latency waits nowhere)."""
        return self._m_wait.sum

    @property
    def fetch_count(self):
        return self._c_fetches.value

    @property
    def stats(self):
        with self._lock:
            occupancy, buffered = self._occupancy, self._buffered_bytes
            pending = len(self._pending)
        return {
            'ingest_window': self.window,
            'ingest_pending': pending,
            'ingest_occupancy': occupancy,
            'ingest_buffered_bytes': buffered,
            'ingest_fetches': self._c_fetches.value,
            'ingest_fetch_bytes': self._c_bytes.value,
            'ingest_gets': self._c_gets.value,
            'ingest_degraded': self._c_degraded.value,
            'ingest_hedges': self._c_hedges.value,
            'ingest_hedge_wins': self._c_hedge_wins.value,
            'ingest_plan_needed_bytes': self._c_plan_needed.value,
            'ingest_plan_waste_bytes': self._c_plan_waste.value,
            'ingest_plan_waste_pct': self._g_waste_pct.value,
        }

    def hedge_state(self):
        """How the hedge decision currently stands."""
        return {'deadline_s': self.hedge_deadline_s(),
                'explicit': self._hedge_deadline_s is not None,
                'samples': len(self._durations),
                'hedges': self._c_hedges.value,
                'hedge_wins': self._c_hedge_wins.value}

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        """Stop the pump; unblock every checkout (they degrade to the
        synchronous path without counting) and join the fetch threads."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            for entry in self._entries.values():
                entry.done = True
                entry.event.set()
            self._cond.notify_all()
        for thread in self._threads:
            thread.join(timeout=5.0)
        for thread in self._hedge_threads:
            thread.join(timeout=1.0)

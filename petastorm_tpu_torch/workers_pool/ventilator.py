"""Work injection: owns the item list, shuffling, epochs, backpressure, and
the resume token.

Counterpart of ``petastorm_tpu/workers_pool/ventilator.py`` with FIFO
dispatch inline: items go out in the epoch permutation order, front to
back, each wrapped in a :class:`VentilatedItem` with its global position
(``epoch * len(items) + index``), which the pools hand back to
:meth:`ConcurrentVentilator.processed_item` once the item's results are
published.  The position of the oldest item not fully processed is the
resume token ``{epoch, cursor, seed}``; the per-epoch order is a pure
function of ``(seed, epoch)``, so a ventilator started from a token
dispatches exactly the work the interrupted one had left.  ``pause`` and
:meth:`~ConcurrentVentilator.has_deliverable_outstanding` let a reader
drain its in-flight work for an exact snapshot.

An elastic reshard (:mod:`petastorm_tpu_torch.elastic`) hands a reader
**prologue** work: items inherited from another shard topology, dispatched
once, in list order and unshuffled, before any epoch.  Prologue positions
are negative (``index - len(prologue)``), so the oldest-position math
orders them before every epoch position, and a token taken while prologue
work is outstanding carries the items not yet processed under
``'prologue'``.

Dispatch order is pluggable: the default
:class:`~petastorm_tpu_torch.workers_pool.scheduling.FifoDispatchPolicy`
walks the epoch permutation front to back; the adaptive policy launches
predicted-slow pieces early within a bounded window.  Either way the token
stays the oldest position not fully processed.  Under the adaptive policy
the pools ack a position when its results are *delivered* (the reorder
stage, :class:`~petastorm_tpu_torch.workers_pool.scheduling.ReorderBuffer`),
so the in-flight bound counts undelivered positions; the last free slot
then always goes to the delivery frontier, or nothing could ever ack.
A ``dispatch_listener`` sees every item in the actual dispatch order, just
before the pool does (the ingest plane's readahead feed).
"""

import logging
import threading
import time

import numpy as np

from petastorm_tpu_torch.workers_pool import VentilatedItem
from petastorm_tpu_torch.workers_pool.scheduling import FifoDispatchPolicy

logger = logging.getLogger(__name__)

#: A bound on the dispatch meta kept for positions not yet delivered.
_DISPATCH_META_ENTRIES = 4096


def epoch_order(items, shuffle, seed, epoch):
    """Canonical per-epoch work-item order: a pure function of
    ``(seed, epoch)``, identical to the JAX package's."""
    if not shuffle:
        return list(items)
    rng = np.random.default_rng((seed, epoch))
    return [items[i] for i in rng.permutation(len(items))]


class ConcurrentVentilator(object):
    """Feeds ``items`` (argument tuples of the worker's ``process``) to
    ``ventilate_fn`` as :class:`VentilatedItem` across ``iterations`` epochs
    from a background thread, keeping at most ``max_ventilation_queue_size``
    items un-acked in flight (acks arrive via :meth:`processed_item`).

    ``iterations=None`` repeats forever.  ``randomize_item_order`` reshuffles
    deterministically every epoch from ``(random_seed, epoch)``.
    ``start_epoch``/``start_cursor`` start from a resume token's position;
    ``prologue_items`` go out first, before that position's epoch.  With no
    ``items`` the ventilator serves its prologue and completes.
    ``dispatch_policy`` picks the order within an epoch (FIFO by default);
    ``dispatch_listener(item)`` is called with each :class:`VentilatedItem`
    before the pool sees it, and is disabled, never fatal, when it raises.
    Backpressure, pause and stop all wait on one condition variable.
    """

    def __init__(self, ventilate_fn, items, iterations=1,
                 randomize_item_order=False, random_seed=0,
                 max_ventilation_queue_size=None, start_epoch=0, start_cursor=0,
                 prologue_items=None, dispatch_policy=None, dispatch_listener=None):
        if iterations is not None and iterations <= 0:
            raise ValueError('iterations must be positive or None, got %r' % (iterations,))
        self._ventilate_fn = ventilate_fn
        self._dispatch_listener = dispatch_listener
        self._items = list(items)
        self._iterations = iterations
        self._randomize = randomize_item_order
        self._seed = random_seed if random_seed is not None else 0
        self._max_inflight = max_ventilation_queue_size or max(2 * len(self._items), 1)
        self._policy = dispatch_policy or FifoDispatchPolicy()
        self._prologue = [tuple(item) for item in (prologue_items or ())]
        self._prologue_cursor = 0   # the next prologue item to dispatch
        self._start_epoch = int(start_epoch)   # the token's position while prologue runs
        self._start_cursor = int(start_cursor)
        self._epoch = int(start_epoch)
        #: the oldest undispatched index of the epoch (the policy's; under
        #: adaptive dispatch it lags the frontier until the gap fills)
        self._cursor = int(start_cursor)
        self._inflight_count = 0
        #: position -> work item, dispatched and not yet acked (kept so an
        #: ack feeds the cost model by piece index)
        self._outstanding = {}
        #: position -> the policy's decision for it, popped at delivery
        #: (:meth:`take_dispatch_meta`); bounded, oldest dropped first
        self._dispatch_meta = {}
        self.ventilated_count = 0
        self._completed = threading.Event()
        self._paused = False
        self._stop_requested = False
        self._cond = threading.Condition()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, name='ventilator', daemon=True)
        self._thread.start()

    def _dispatch(self, pick):
        """Wait until dispatch is allowed, then take the next item with
        ``pick()`` (a :class:`VentilatedItem`, or None once its part of the
        work is done) and hand it over; False when stopped.  Waiting and
        picking under one lock is what makes pause() exact: once it
        returns, an item is outstanding or undispatched.

        A saturated bound is honoured only while the delivery frontier is
        dispatched (an ack can still arrive): when out-of-order dispatch
        left the frontier undispatched and the bound then shrank under the
        in-flight count (:meth:`set_max_inflight`), waiting would deadlock
        under ack-on-delivery, so the bound is overdrawn by exactly one
        dispatch, which the policy's force-oldest rule sends to the
        frontier."""
        with self._cond:
            while not self._stop_requested and \
                    (self._paused or (self._inflight_count >= self._max_inflight
                                      and self._frontier_dispatched())):
                self._cond.wait()
            if self._stop_requested:
                return False
            out = pick()
            if out is None:
                return None
            self._outstanding[out.position] = out.args
            self._inflight_count += 1
            self.ventilated_count += 1
        self._notify_listener(out)
        self._ventilate_fn(out)
        return True

    def _frontier_dispatched(self):
        """Caller holds the lock.  True while the oldest position not yet
        fully processed is outstanding (delivery can progress without a new
        dispatch)."""
        if not self._outstanding:
            return False
        return min(self._outstanding) < self._oldest_undispatched_position()

    def _pick_prologue(self):
        j, P = self._prologue_cursor, len(self._prologue)
        if j >= P:
            return None
        self._prologue_cursor = j + 1
        return VentilatedItem(j - P, self._prologue[j])

    def _pick_epoch(self):
        # The last free slot goes to the delivery frontier: under
        # ack-on-delivery a saturated window must hold the position delivery
        # waits on, or no ack ever frees a slot.
        force_oldest = self._inflight_count >= self._max_inflight - 1
        picked = self._policy.next(force_oldest=force_oldest)
        if picked is None:
            return None
        position, item = picked
        self._cursor = self._policy.oldest_undispatched_idx()
        meta = dict(getattr(self._policy, 'last_dispatch_meta', None) or {'policy': 'fifo'})
        meta['t_dispatch'] = time.monotonic()
        self._dispatch_meta[position] = meta
        while len(self._dispatch_meta) > _DISPATCH_META_ENTRIES:
            self._dispatch_meta.pop(next(iter(self._dispatch_meta)))
        return VentilatedItem(position, item)

    def _run(self):
        while True:
            out = self._dispatch(self._pick_prologue)
            if out is False:
                return
            if out is None:
                break
        n = len(self._items)
        while n and (self._iterations is None or self._epoch < self._iterations):
            with self._cond:
                epoch, cursor = self._epoch, self._cursor
            order = epoch_order(self._items, self._randomize, self._seed, epoch)
            self._policy.begin_epoch(order, epoch * n, cursor)
            while True:
                out = self._dispatch(self._pick_epoch)
                if out is False:
                    return
                if out is None:
                    break
            with self._cond:
                self._epoch += 1
                self._cursor = 0
        self._completed.set()

    def _notify_listener(self, out):
        if self._dispatch_listener is None:
            return
        try:
            self._dispatch_listener(out)
        except Exception:  # noqa: BLE001 — an advisory feed, never fatal
            logger.exception('dispatch_listener raised; disabling it (readahead degrades, '
                             'delivery unaffected)')
            self._dispatch_listener = None

    def take_dispatch_meta(self, position):
        """Pop the dispatch decision recorded for ``position`` (None when it
        aged out of the bounded map or came from the prologue)."""
        with self._cond:
            return self._dispatch_meta.pop(position, None)

    def processed_item(self, position=None, elapsed=None):
        """Ack one item, by its position, once its results are published
        (delivered, under a reorder stage); ``elapsed``, its decode seconds,
        feeds the dispatch policy's cost model."""
        item = None
        with self._cond:
            if position is not None:
                item = self._outstanding.pop(position, None)
            self._inflight_count = max(0, self._inflight_count - 1)
            self._cond.notify_all()
        if item is not None and elapsed is not None:
            # outside the dispatch lock: the cost model has its own
            self._policy.observe(item, elapsed)

    def set_max_inflight(self, bound):
        """The live in-flight bound (the autotuner's reorder-depth knob)."""
        with self._cond:
            self._max_inflight = max(1, int(bound))
            self._cond.notify_all()

    @property
    def max_inflight(self):
        return self._max_inflight

    def _oldest_undispatched_position(self):
        """Caller holds the lock: the global position dispatched next
        (negative inside the prologue), the one copy of the position math
        the token, the backpressure and the drain share."""
        P = len(self._prologue)
        if self._prologue_cursor < P:
            return self._prologue_cursor - P
        return self._epoch * max(len(self._items), 1) + self._cursor

    def state_dict(self):
        """The resume token: the oldest position not fully processed.

        Items after it that completed are read again on resume unless the
        caller drained them first (``Reader.drain_in_flight``).  While
        prologue work is not fully processed the token also carries
        ``'prologue'``, the prologue items from the oldest unprocessed one
        on, and its epoch and cursor are the position the regular epochs
        start from."""
        n = max(len(self._items), 1)
        P = len(self._prologue)
        with self._cond:
            oldest = self._oldest_undispatched_position()
            if self._outstanding:
                oldest = min(oldest, min(self._outstanding))
            if oldest < 0:
                return {'epoch': self._start_epoch, 'cursor': self._start_cursor,
                        'seed': self._seed, 'prologue': list(self._prologue[oldest + P:])}
        return {'epoch': oldest // n, 'cursor': oldest % n, 'seed': self._seed}

    def pause(self):
        """Stop dispatching; items in flight keep processing.  Once this
        returns, every item is outstanding or will not dispatch until
        :meth:`unpause`."""
        with self._cond:
            self._paused = True

    def unpause(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def has_outstanding(self):
        with self._cond:
            return bool(self._outstanding)

    def has_deliverable_outstanding(self):
        """True while an outstanding item sits before the dispatch frontier,
        so it can still complete with dispatch paused: the drain's loop
        condition (under FIFO dispatch every outstanding item does)."""
        with self._cond:
            return bool(self._outstanding) and \
                min(self._outstanding) < self._oldest_undispatched_position()

    def completed(self):
        """True once every item of every iteration has been ventilated."""
        return self._completed.is_set()

    def stop(self):
        with self._cond:
            self._stop_requested = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()

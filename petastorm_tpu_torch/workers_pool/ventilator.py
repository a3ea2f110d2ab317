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
drain its in-flight work for an exact snapshot.  The adaptive scheduler
and elastic-reshard prologues are not ported (the reader refuses a token
that carries a ``prologue``).
"""

import threading

import numpy as np

from petastorm_tpu_torch.workers_pool import VentilatedItem


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
    ``start_epoch``/``start_cursor`` start from a resume token's position.
    Backpressure, pause and stop all wait on one condition variable.
    """

    def __init__(self, ventilate_fn, items, iterations=1,
                 randomize_item_order=False, random_seed=0,
                 max_ventilation_queue_size=None, start_epoch=0, start_cursor=0):
        if iterations is not None and iterations <= 0:
            raise ValueError('iterations must be positive or None, got %r' % (iterations,))
        self._ventilate_fn = ventilate_fn
        self._items = list(items)
        self._iterations = iterations
        self._randomize = randomize_item_order
        self._seed = random_seed if random_seed is not None else 0
        self._max_inflight = max_ventilation_queue_size or max(2 * len(self._items), 1)
        self._epoch = int(start_epoch)
        self._cursor = int(start_cursor)   # the next index of the epoch to dispatch
        self._inflight_count = 0
        #: position -> work item, dispatched and not yet acked
        self._outstanding = {}
        self._completed = threading.Event()
        self._paused = False
        self._stop_requested = False
        self._cond = threading.Condition()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, name='ventilator', daemon=True)
        self._thread.start()

    def _run(self):
        n = len(self._items)
        while n and (self._iterations is None or self._epoch < self._iterations):
            order = epoch_order(self._items, self._randomize, self._seed, self._epoch)
            while True:
                with self._cond:
                    if self._cursor >= n:
                        self._epoch += 1
                        self._cursor = 0
                        break
                    # waiting and picking under one lock is what makes pause()
                    # exact: once it returns, an item is outstanding or undispatched
                    while not self._stop_requested and \
                            (self._paused or self._inflight_count >= self._max_inflight):
                        self._cond.wait()
                    if self._stop_requested:
                        return
                    position = self._epoch * n + self._cursor
                    item = order[self._cursor]
                    self._cursor += 1
                    self._outstanding[position] = item
                    self._inflight_count += 1
                self._ventilate_fn(VentilatedItem(position, item))
        self._completed.set()

    def processed_item(self, position=None):
        """Ack one item, by its position, once its results are published."""
        with self._cond:
            if position is not None:
                self._outstanding.pop(position, None)
            self._inflight_count = max(0, self._inflight_count - 1)
            self._cond.notify_all()

    def _oldest_undispatched_position(self):
        """Caller holds the lock: the global position dispatched next, the
        one copy of the position math the token and the drain share."""
        return self._epoch * max(len(self._items), 1) + self._cursor

    def state_dict(self):
        """The resume token: the oldest position not fully processed.

        Items after it that completed are read again on resume unless the
        caller drained them first (``Reader.drain_in_flight``)."""
        n = max(len(self._items), 1)
        with self._cond:
            oldest = self._oldest_undispatched_position()
            if self._outstanding:
                oldest = min(oldest, min(self._outstanding))
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

"""Work injection: owns the item list, shuffling, epochs, and backpressure.

Counterpart of ``petastorm_tpu/workers_pool/ventilator.py`` with FIFO
dispatch inline: items go out in the epoch permutation order, front to
back.  The adaptive scheduler (``scheduling.py``), elastic-reshard
prologues, pause/drain for exact checkpoints and the resume token are later
slices of the port.
"""

import threading

import numpy as np


def epoch_order(items, shuffle, seed, epoch):
    """Canonical per-epoch work-item order: a pure function of
    ``(seed, epoch)``, identical to the JAX package's."""
    if not shuffle:
        return list(items)
    rng = np.random.default_rng((seed, epoch))
    return [items[i] for i in rng.permutation(len(items))]


class ConcurrentVentilator(object):
    """Feeds ``items`` (argument tuples of the worker's ``process``) to
    ``ventilate_fn`` across ``iterations`` epochs from a background thread,
    keeping at most ``max_ventilation_queue_size`` items un-acked in flight
    (acks arrive via :meth:`processed_item`).

    ``iterations=None`` repeats forever.  ``randomize_item_order`` reshuffles
    deterministically every epoch from ``(random_seed, epoch)``.
    """

    def __init__(self, ventilate_fn, items, iterations=1,
                 randomize_item_order=False, random_seed=0,
                 max_ventilation_queue_size=None):
        if iterations is not None and iterations <= 0:
            raise ValueError('iterations must be positive or None, got %r' % (iterations,))
        self._ventilate_fn = ventilate_fn
        self._items = list(items)
        self._iterations = iterations
        self._randomize = randomize_item_order
        self._seed = random_seed if random_seed is not None else 0
        self._max_inflight = max_ventilation_queue_size or max(2 * len(self._items), 1)
        self._inflight_count = 0
        self._completed = threading.Event()
        self._stop_requested = threading.Event()
        self._cond = threading.Condition()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, name='ventilator', daemon=True)
        self._thread.start()

    def _run(self):
        epoch = 0
        while self._iterations is None or epoch < self._iterations:
            for item in epoch_order(self._items, self._randomize, self._seed, epoch):
                with self._cond:
                    while not self._stop_requested.is_set() \
                            and self._inflight_count >= self._max_inflight:
                        self._cond.wait()
                    if self._stop_requested.is_set():
                        return
                    self._inflight_count += 1
                self._ventilate_fn(*item)
            epoch += 1
        self._completed.set()

    def processed_item(self):
        with self._cond:
            self._inflight_count = max(0, self._inflight_count - 1)
            self._cond.notify()

    def completed(self):
        """True once every item of every iteration has been ventilated."""
        return self._completed.is_set()

    def stop(self):
        with self._cond:
            self._stop_requested.set()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()

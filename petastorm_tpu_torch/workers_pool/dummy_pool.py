"""Synchronous in-caller-thread pool: deterministic ordering for tests/debug.

Counterpart of ``petastorm_tpu/workers_pool/dummy_pool.py``: work items run
lazily inside ``get_results``, one at a time, in ventilation order.
"""

import time
from collections import deque

from petastorm_tpu_torch.workers_pool import EmptyResultError, TimeoutWaitingForResultError


class DummyPool(object):
    def __init__(self):
        # Always synchronous; the attribute is the uniform pool-sizing surface.
        self.workers_count = 1
        self._pending = deque()
        self._results = deque()
        self._worker = None
        self._ventilator = None
        self._stopped = False
        self.items_processed = 0
        self.busy_time = 0.0
        self._started_at = None
        self._stopped_at = None

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        self._worker = worker_class(0, self._results.append, worker_setup_args)
        self._started_at = time.monotonic()
        self._ventilator = ventilator
        if ventilator is not None:
            ventilator.start()

    def ventilate(self, *args):
        self._pending.append(args)

    def get_results(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._results:
            if self._pending:
                started = time.monotonic()
                self._worker.process(*self._pending.popleft())
                self.items_processed += 1
                self.busy_time += time.monotonic() - started
                if self._ventilator is not None:
                    self._ventilator.processed_item()
            elif self._ventilator is not None and not self._ventilator.completed():
                # The ventilator thread may still be filling us; spin briefly
                # but honor the timeout.
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutWaitingForResultError(
                        'no results within %ss (ventilator idle)' % timeout)
                time.sleep(0.001)
            else:
                raise EmptyResultError()
        return self._results.popleft()

    @property
    def diagnostics(self):
        """The JAX dummy pool's: items, queue depths, decode seconds and
        their share of the wall time since ``start`` (to ``stop``)."""
        end = self._stopped_at if self._stopped_at is not None else time.monotonic()
        wall = (end - self._started_at) if self._started_at else 0.0
        return {'pool': 'dummy', 'items_processed': self.items_processed,
                'pending': len(self._pending), 'results_ready': len(self._results),
                'decode_busy_s': round(self.busy_time, 4),
                'decode_utilization': round(self.busy_time / wall, 4) if wall else 0.0}

    def stop(self):
        if self._stopped_at is None:
            self._stopped_at = time.monotonic()
        self._stopped = True
        if self._ventilator is not None:
            self._ventilator.stop()
        if self._worker is not None:
            self._worker.shutdown()

    def join(self):
        if not self._stopped:
            raise RuntimeError('join() called before stop()')

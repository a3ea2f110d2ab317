"""Synchronous in-caller-thread pool: deterministic ordering for tests/debug.

Counterpart of ``petastorm_tpu/workers_pool/dummy_pool.py``: work items run
lazily inside ``get_results``, one at a time, in ventilation order, each
acked by its position after its results are published.  An out-of-order
dispatch policy still needs the reorder stage here
(:class:`~petastorm_tpu_torch.workers_pool.scheduling.ReorderBuffer`) to
deliver in epoch order; each item's decode seconds ride its ack into the
policy's cost model.  With provenance on (read at ``start``) each result is
paired with its record at publish, as in the thread pool, and
:meth:`DummyPool.take_provenance` hands the delivered ones over.
"""

import os
import time
from collections import deque

from petastorm_tpu_torch.telemetry import provenance
from petastorm_tpu_torch.telemetry.provenance import Provenanced
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
from petastorm_tpu_torch.workers_pool import (EmptyResultError, TimeoutWaitingForResultError,
                                              unpack_item)


class DummyPool(object):
    def __init__(self):
        # Always synchronous; the attribute is the uniform pool-sizing surface.
        self.workers_count = 1
        self._pending = deque()
        self._results = deque()
        self._worker = None
        self._ventilator = None
        self._reorder = None
        self._position = None
        self._stopped = False
        self.metrics = MetricsRegistry('dummy_pool')
        self._m_items = self.metrics.counter('items_processed')
        self._m_busy = self.metrics.counter('decode_busy_s')
        self._m_decode = self.metrics.histogram('decode')
        self._started_at = None
        self._stopped_at = None
        #: records of the delivered results, in delivery order
        self.provenance_out = deque(maxlen=256)
        self._prov_on = False
        self._worker_setup_args = None
        self._prov_ctx = None   # (started, item_args, cache_before) of the item

    def start(self, worker_class, worker_setup_args=None, ventilator=None, reorder=None):
        self._worker = worker_class(0, self._publish, worker_setup_args)
        self._started_at = time.monotonic()
        self._ventilator = ventilator
        self._reorder = reorder
        self._position = None
        self._prov_on = provenance.enabled()
        self._worker_setup_args = worker_setup_args
        if ventilator is not None:
            ventilator.start()

    def _publish(self, result):
        if self._prov_on and self._prov_ctx is not None:
            started, item_args, cache_before = self._prov_ctx
            now = time.monotonic()
            record = provenance.make_record(
                'pool', position=self._position, worker_pid=os.getpid(),
                worker_host=provenance.host(),
                pieces=provenance.piece_info(self._worker_setup_args, item_args),
                cache=provenance.cache_outcome(cache_before,
                                               provenance.cache_stats(self._worker_setup_args)),
                transport='inline', stages={'decode': [started, now]})
            record['_staged_t'] = now
            result = Provenanced(result, record)
        if self._reorder is not None and self._position is not None:
            self._reorder.add(self._position, result)
            return
        self._results.append(result)

    def ventilate(self, *args):
        self._pending.append(args)

    def get_results(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._results:
            if self._pending:
                position, args = unpack_item(self._pending.popleft())
                self._position = position
                started = time.monotonic()
                if self._prov_on:
                    self._prov_ctx = (started, args,
                                      provenance.cache_stats(self._worker_setup_args))
                sleep_before = getattr(self._worker, 'retry_sleep_s', 0.0)
                try:
                    self._worker.process(*args)
                finally:
                    self._position = None
                    self._prov_ctx = None
                slept = getattr(self._worker, 'retry_sleep_s', 0.0) - sleep_before
                elapsed = max(0.0, time.monotonic() - started - slept)
                self._m_items.inc()
                self._m_busy.inc(elapsed)
                self._m_decode.observe(elapsed)
                if self._reorder is not None and position is not None:
                    # ack on delivery: release publishes in epoch order, then acks
                    self._reorder.release(position, elapsed, self._results.append,
                                          self._ventilator)
                elif self._ventilator is not None:
                    self._ventilator.processed_item(position, elapsed)
            elif self._ventilator is not None and not self._ventilator.completed():
                # The ventilator thread may still be filling us; spin briefly
                # but honor the timeout (a paused ventilator never completes,
                # and a reader's drain probes with short timeouts).
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutWaitingForResultError(
                        'no results within %ss (ventilator idle or paused)' % timeout)
                time.sleep(0.001)
            else:
                raise EmptyResultError()
        result = self._results.popleft()
        if isinstance(result, Provenanced):
            self.provenance_out.append(provenance.finalize_delivery(result.record,
                                                                    self._ventilator))
            result = result.result
        return result

    def take_provenance(self):
        """The records of the results delivered since the last call, in
        delivery order (none under the kill switch)."""
        out = list(self.provenance_out)
        self.provenance_out.clear()
        return out

    @property
    def items_processed(self):
        return self._m_items.value

    @property
    def busy_time(self):
        return self._m_busy.value

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

"""Default pool: N python threads; pyarrow, zlib and cv2 release the GIL, so
decode scales across host cores.

Counterpart of ``petastorm_tpu/workers_pool/thread_pool.py``: input queue +
bounded results queue, worker exceptions re-raised in the caller, acks
flowing back to the ventilator.  Without a reorder stage, delivery is in
completion order, and each item is acked by its position once its results
are published (the order a reader's drain for an exact snapshot relies
on).  With one (:class:`~petastorm_tpu_torch.workers_pool.scheduling.
ReorderBuffer`, the adaptive scheduler's) a worker's results stage by
position and are published, then acked, in epoch order.  Each item's
decode time goes to a metrics registry, which :attr:`ThreadPool.diagnostics`
reads (``decode_utilization`` is the share of the workers' wall time spent
decoding), and rides the ack into the dispatch policy's cost model.  With
provenance on (read at ``start``), each result is paired at publish with its
record (piece, pid, host, cache outcome, decode window), stamped at delivery
(:func:`~petastorm_tpu_torch.telemetry.provenance.finalize_delivery`) and
handed to the reader by :meth:`ThreadPool.take_provenance`.
"""

import os
import queue
import sys
import threading
import time
import traceback
from collections import deque

from petastorm_tpu_torch.telemetry import provenance
from petastorm_tpu_torch.telemetry.provenance import Provenanced
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry, ms
from petastorm_tpu_torch.workers_pool import (DEFAULT_TIMEOUT_S, EmptyResultError,
                                              TimeoutWaitingForResultError, unpack_item)

_SENTINEL = object()


class _WorkerError(object):
    """Exception captured in a worker thread, travelling the results queue."""

    def __init__(self, exc, tb_str):
        self.exc = exc
        self.tb_str = tb_str


class ThreadPool(object):
    def __init__(self, workers_count=10, results_queue_size=50):
        self.workers_count = workers_count
        self._input_queue = queue.Queue()
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._threads = []
        self._workers = []
        self._ventilator = None
        #: the reorder stage, or None (completion-order delivery)
        self._reorder = None
        #: keeps two workers' released runs from interleaving on the queue
        self._flush_lock = threading.Lock()
        self._tls = threading.local()   # each worker thread's current position
        self._stop_event = threading.Event()
        self._inflight_lock = threading.Lock()
        self._inflight = 0  # ventilated but not yet fully processed
        self.metrics = MetricsRegistry('thread_pool')
        self._m_items = self.metrics.counter('items_processed')
        self._m_busy = self.metrics.counter('decode_busy_s')
        self._m_decode = self.metrics.histogram('decode')
        self._started_at = None
        self._stopped_at = None
        #: records of the delivered results, in delivery order
        self.provenance_out = deque(maxlen=256)
        self._prov_on = False
        self._worker_setup_args = None

    def start(self, worker_class, worker_setup_args=None, ventilator=None, reorder=None):
        self._ventilator = ventilator
        self._reorder = reorder
        self._prov_on = provenance.enabled()
        self._worker_setup_args = worker_setup_args
        self._started_at = time.monotonic()
        for worker_id in range(self.workers_count):
            worker = worker_class(worker_id, self._publish, worker_setup_args)
            self._workers.append(worker)
            thread = threading.Thread(target=self._worker_loop, args=(worker,),
                                      name='reader-worker-%d' % worker_id, daemon=True)
            self._threads.append(thread)
            thread.start()
        if ventilator is not None:
            ventilator.start()

    def ventilate(self, *args):
        with self._inflight_lock:
            self._inflight += 1
        self._input_queue.put(args)

    def _publish(self, result):
        # With a reorder stage a positioned result waits for every earlier
        # position; the worker loop's finally releases it.  A worker's error
        # never passes here: it goes to the queue directly.
        position = getattr(self._tls, 'position', None)
        record = self._make_record(position)
        if record is not None:
            result = Provenanced(result, record)
        if self._reorder is not None and position is not None:
            self._reorder.add(position, result)
            return
        self._put_result(result)

    def _make_record(self, position):
        """The record of the result being published, built at publish (the
        item's decode work for it is done), so that delivery pairs it
        exactly."""
        if not self._prov_on:
            return None
        now = time.monotonic()
        started = getattr(self._tls, 'prov_started', None)
        record = provenance.make_record(
            'pool', position=position, worker_pid=os.getpid(), worker_host=provenance.host(),
            pieces=provenance.piece_info(self._worker_setup_args,
                                         getattr(self._tls, 'item_args', None)),
            cache=provenance.cache_outcome(getattr(self._tls, 'cache_before', None),
                                           provenance.cache_stats(self._worker_setup_args)),
            transport='inline',
            stages={'decode': [started, now]} if started is not None else {})
        record['_staged_t'] = now
        return record

    def _put_result(self, result):
        # Bounded put that stays responsive to stop(): a worker blocked on a
        # full results queue must not deadlock teardown.
        while not self._stop_event.is_set():
            try:
                self._results_queue.put(result, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker_loop(self, worker):
        try:
            while not self._stop_event.is_set():
                try:
                    item = self._input_queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is _SENTINEL:
                    break
                position, args = unpack_item(item)
                self._tls.position = position
                started = time.monotonic()
                if self._prov_on:
                    # the item's start, its arguments (the piece) and the
                    # cache's counters before it (a cache shared by the
                    # threads can blur the difference)
                    self._tls.prov_started = started
                    self._tls.item_args = args
                    self._tls.cache_before = provenance.cache_stats(self._worker_setup_args)
                sleep_before = getattr(worker, 'retry_sleep_s', 0.0)
                try:
                    worker.process(*args)
                except Exception as e:  # noqa: BLE001 — travels to the caller
                    self._put_result(_WorkerError(e, traceback.format_exc()))
                finally:
                    # retry back-off sleeps are waiting, not decoding
                    slept = getattr(worker, 'retry_sleep_s', 0.0) - sleep_before
                    elapsed = max(0.0, time.monotonic() - started - slept)
                    self._tls.position = None
                    self._m_items.inc()
                    self._m_busy.inc(elapsed)
                    self._m_decode.observe(elapsed)
                    with self._inflight_lock:
                        self._inflight -= 1
                    if self._reorder is not None and position is not None:
                        # ack on delivery: release publishes each run in
                        # epoch order, then acks it
                        with self._flush_lock:
                            self._reorder.release(position, elapsed, self._put_result,
                                                  self._ventilator)
                    elif self._ventilator is not None:
                        # after the publish: a drain that sees no item
                        # outstanding finds every result queued
                        self._ventilator.processed_item(position, elapsed)
        finally:
            # The owning thread closes its own worker's files: closing them
            # from another thread could unmap a file mid-read.
            worker.shutdown()

    def get_results(self, timeout=DEFAULT_TIMEOUT_S):
        """Next result; EmptyResultError once the ventilator completed, no
        item is in flight and the queues are empty."""
        while True:
            try:
                result = self._results_queue.get(timeout=0.05)
            except queue.Empty:
                if self._all_done():
                    raise EmptyResultError()
                timeout -= 0.05
                if timeout <= 0:
                    raise TimeoutWaitingForResultError(
                        'No results within timeout; worker threads alive: %d'
                        % sum(t.is_alive() for t in self._threads))
                continue
            if isinstance(result, _WorkerError):
                sys.stderr.write(result.tb_str)
                raise result.exc
            if isinstance(result, Provenanced):
                self.provenance_out.append(
                    provenance.finalize_delivery(result.record, self._ventilator))
                result = result.result
            return result

    def take_provenance(self):
        """The records of the results delivered since the last call, in
        delivery order (none under the kill switch)."""
        out = list(self.provenance_out)
        self.provenance_out.clear()
        return out

    def _all_done(self):
        if self._ventilator is not None and not self._ventilator.completed():
            return False
        with self._inflight_lock:
            inflight = self._inflight
        return inflight == 0 and self._input_queue.empty() and self._results_queue.empty() \
            and (self._reorder is None or self._reorder.empty())

    @property
    def items_processed(self):
        return self._m_items.value

    @property
    def busy_time(self):
        return self._m_busy.value

    @property
    def diagnostics(self):
        """The JAX thread pool's: items, queue depths, decode seconds, the
        share of the workers' wall time spent decoding (to ``stop``), and
        each item's decode p50/p99."""
        end = self._stopped_at if self._stopped_at is not None else time.monotonic()
        wall = (end - self._started_at) if self._started_at else 0.0
        return {
            'pool': 'thread',
            'workers_count': self.workers_count,
            'items_processed': self.items_processed,
            'inflight': self._inflight,
            'input_qsize': self._input_queue.qsize(),
            'results_qsize': self._results_queue.qsize(),
            'decode_busy_s': round(self.busy_time, 4),
            'decode_utilization': round(
                self.busy_time / (wall * self.workers_count), 4) if wall else 0.0,
            'decode_p50_ms': ms(self._m_decode.quantile(0.5)),
            'decode_p99_ms': ms(self._m_decode.quantile(0.99)),
        }

    def stop(self):
        if self._stopped_at is None:
            self._stopped_at = time.monotonic()
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stop_event.set()
        for _ in self._threads:
            self._input_queue.put(_SENTINEL)

    def join(self):
        for thread in self._threads:
            thread.join()
        for worker in self._workers:
            worker.shutdown()  # idempotent; covers never-started threads

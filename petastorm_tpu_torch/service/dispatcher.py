"""Control plane of the data service.

Counterpart of ``petastorm_tpu/service/dispatcher.py``, cut to its
single-tenant core.  The dispatcher never touches row data.  It enumerates
the dataset's row groups once, cuts them into splits
(``ServiceConfig.rowgroups_per_split`` consecutive groups each, split ``i``
owned by consumer ``i % num_consumers``), and serves short pickled RPCs on
one REP socket:

  ``register_worker`` a worker announces its data-plane address -> worker_id
  ``clock``           a bare clock handshake
  ``heartbeat``       liveness and metrics; renews the leases the worker holds
  ``lease``           hand out one pending split under a TTL lease
  ``complete``        a worker finished a split (its client acked it)
  ``mark_consumed``   a resuming client retires the splits its token holds
  ``drain``           ask one worker to drain (through its next heartbeat reply)
  ``release``         a draining worker hands back a split it never started
  ``deregister``      a drained worker leaves
  ``job`` / ``workers`` / ``stats``  discovery and metrics
  ``stop``            remote shutdown

Lease expiry is the failure path: a worker that stops heartbeating has its
leases returned to the pending queue (attempt + 1) on the next turn of the
serve loop, exactly once.  A split is always in exactly one of pending,
leased, done or failed; a split whose lease expired ``max_split_attempts``
times is failed, which the clients see on their discovery poll.  A late
``complete`` from a worker presumed dead is rejected once the split moved
on.  Exactly-once delivery is finished on the client (whole-split commit,
dedupe by split id).

Not ported here (``ROADMAP.md``, Queue A item 7): the durable ledger,
tenancy, the autoscaler, the materializer hand-off, cache-affinity routing,
the decision journal and the flight recorder.
"""

import collections
import logging
import pickle
import threading
import time

logger = logging.getLogger(__name__)

_PENDING, _LEASED, _DONE, _FAILED = 'pending', 'leased', 'done', 'failed'


class Split(object):
    """One leasable unit of decode work: consecutive row-group indices."""

    __slots__ = ('split_id', 'indices', 'consumer', 'attempt', 'state', 'worker_id',
                 'lease_expires')

    def __init__(self, split_id, indices, consumer):
        self.split_id = split_id
        self.indices = list(indices)
        self.consumer = consumer
        self.attempt = 0
        self.state = _PENDING
        self.worker_id = None
        self.lease_expires = 0.0

    def describe(self):
        return {'split_id': self.split_id, 'indices': list(self.indices),
                'consumer': self.consumer, 'attempt': self.attempt}


def build_splits(num_pieces, rowgroups_per_split, num_consumers):
    """Cut ``num_pieces`` row groups into :class:`Split` objects.

    Consecutive grouping keeps each split's reads sequential on disk; the
    consumer of a split is its index modulo ``num_consumers``, so consumers
    own disjoint, covering sets."""
    splits = []
    for start in range(0, num_pieces, rowgroups_per_split):
        sid = len(splits)
        indices = range(start, min(start + rowgroups_per_split, num_pieces))
        splits.append(Split(sid, indices, sid % num_consumers))
    return splits


class Dispatcher(object):
    """Serve the control plane of one job, on a thread::

        config = ServiceConfig('file:///data/train', num_consumers=2)
        with Dispatcher(config, bind='tcp://127.0.0.1:*') as d:
            ...  # workers and clients connect to d.addr

    ``bind`` may end in ``:*`` (or ``:0``) to take a free TCP port; the
    address is then ``.addr``.  ``trace_recorder`` (a
    :class:`~petastorm_tpu_torch.benchmark.TraceRecorder`) gets an instant
    for every lease grant, expiry and completion.
    """

    def __init__(self, config, bind='tcp://127.0.0.1:*', num_pieces=None, trace_recorder=None):
        self._config = config
        self._bind = bind
        self._trace = trace_recorder
        if num_pieces is None:
            num_pieces = _count_row_groups(config.dataset_url)
        if num_pieces < 1:
            raise ValueError('dataset %r has no row groups' % (config.dataset_url,))
        self._num_pieces = int(num_pieces)
        self._splits = build_splits(num_pieces, config.rowgroups_per_split,
                                    config.num_consumers)
        self._pending = collections.deque(self._splits)
        self._job = config.job_info(len(self._splits))
        self._workers = {}   # worker_id -> {'addr', 'last_heartbeat', 'stats', 'draining'}
        self._next_worker_id = 0
        self.lease_churn = 0
        #: graceful drains completed, and those that overran their deadline
        self.drains = 0
        self.drain_timeouts = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._started = threading.Event()
        self.addr = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._serve, name='service-dispatcher',
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10) or self.addr is None:
            raise RuntimeError('dispatcher failed to bind %r' % (self._bind,))
        return self

    def stop(self):
        self._stop.set()

    def join(self):
        if self._thread is not None:
            self._thread.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()

    # -- serve loop ----------------------------------------------------------

    def _serve(self):
        import zmq

        context = zmq.Context()
        socket = context.socket(zmq.REP)
        try:
            if self._bind.startswith('tcp') and self._bind.endswith((':*', ':0')):
                base = self._bind.rsplit(':', 1)[0]
                self.addr = '%s:%d' % (base, socket.bind_to_random_port(base))
            else:
                socket.bind(self._bind)
                self.addr = self._bind
        except Exception:
            socket.close(0)
            context.term()
            self._started.set()   # unblock start(); addr stays None
            raise
        self._started.set()
        poller = zmq.Poller()
        poller.register(socket, zmq.POLLIN)
        try:
            while not self._stop.is_set():
                self._expire_leases()
                if not dict(poller.poll(100)):
                    continue
                raw = socket.recv()
                try:
                    request = pickle.loads(raw)
                    if not isinstance(request, dict):
                        raise TypeError('expected dict, got %s' % type(request).__name__)
                except Exception as e:  # noqa: BLE001 — a malformed peer costs one error reply
                    socket.send(pickle.dumps({'error': 'malformed request: %s: %s'
                                              % (type(e).__name__, e)}, protocol=4))
                    continue
                try:
                    reply = self._dispatch(request)
                except Exception as e:  # noqa: BLE001 — reply, never let the serve thread die
                    logger.exception('dispatcher RPC %r failed', request.get('op'))
                    reply = {'error': '%s: %s' % (type(e).__name__, e)}
                socket.send(pickle.dumps(reply, protocol=4))
                if request.get('op') == 'stop':
                    break
        finally:
            socket.close(0)
            context.term()

    # -- lease bookkeeping ---------------------------------------------------

    def _expire_leases(self):
        now = time.monotonic()
        with self._lock:
            for split in self._splits:
                if split.state == _LEASED and split.lease_expires < now:
                    self._requeue(split)
                    logger.warning('lease on split %d expired (attempt now %d)',
                                   split.split_id, split.attempt)
                    if self._trace is not None:
                        self._trace.instant('service/lease_expired', split=split.split_id)

    def _requeue(self, split):
        """A lease its worker walked away from (caller holds the lock):
        attempt + 1, back to the queue, or failed at the attempt cap."""
        split.worker_id = None
        split.attempt += 1
        self.lease_churn += 1
        if split.attempt >= self._config.max_split_attempts:
            logger.error('split %d failed %d lease attempts; marking failed',
                         split.split_id, split.attempt)
            split.state = _FAILED
        else:
            split.state = _PENDING
            self._pending.append(split)

    def _dispatch(self, request):
        handler = getattr(self, '_op_' + str(request.get('op')), None)
        if handler is None:
            return {'error': 'unknown op %r' % (request.get('op'),)}
        return handler(request)

    # -- RPC handlers --------------------------------------------------------

    def _op_register_worker(self, request):
        with self._lock:
            worker_id = 'w%d' % self._next_worker_id
            self._next_worker_id += 1
            self._workers[worker_id] = {'addr': request['data_addr'],
                                        'last_heartbeat': time.monotonic(),
                                        'stats': {}, 'draining': False}
        logger.info('registered worker %s at %s', worker_id, request['data_addr'])
        return {'worker_id': worker_id, 'job': self._job}

    def _op_clock(self, request):
        return {'t_mono': time.monotonic()}

    def _op_heartbeat(self, request):
        worker_id = request['worker_id']
        # ``held``: the split ids the worker still claims.  Renewing only
        # those lets a split it abandoned (a decode error) expire while the
        # worker lives; a heartbeat without the field renews all of them.
        held = request.get('held')
        if held is not None:
            held = {int(s) for s in held}
        now = time.monotonic()
        with self._lock:
            worker = self._workers.get(worker_id)
            if worker is None:
                return {'ok': False, 'error': 'unknown worker %r' % worker_id}
            worker['last_heartbeat'] = now
            if request.get('stats'):
                worker['stats'] = dict(request['stats'])
            if request.get('draining'):
                worker['draining'] = True
            for split in self._splits:
                if split.state == _LEASED and split.worker_id == worker_id \
                        and (held is None or split.split_id in held):
                    split.lease_expires = now + self._config.lease_ttl_s
            draining = bool(worker['draining'])
        return {'ok': True, 'drain': draining}

    def _op_lease(self, request):
        worker_id = request['worker_id']
        # ``consumers``: the consumers with a live subscriber on the worker.
        # Leasing only their splits keeps a worker from decoding for an
        # absent host (its chunks would fill the worker's send buffer).
        consumers = request.get('consumers')
        if consumers is not None:
            consumers = {int(c[1]) if isinstance(c, (list, tuple)) else int(c)
                         for c in consumers}
        with self._lock:
            if worker_id not in self._workers:
                return {'error': 'unknown worker %r' % worker_id}
            self._workers[worker_id]['last_heartbeat'] = time.monotonic()
            if self._workers[worker_id]['draining']:
                return {'wait': True, 'drain': True}
            chosen, skipped = None, []
            while self._pending:
                split = self._pending.popleft()
                if split.state != _PENDING:
                    continue   # retired by mark_consumed while queued
                if consumers is not None and split.consumer not in consumers:
                    skipped.append(split)
                    continue
                chosen = split
                break
            self._pending.extend(skipped)
            if chosen is not None:
                chosen.state = _LEASED
                chosen.worker_id = worker_id
                chosen.lease_expires = time.monotonic() + self._config.lease_ttl_s
                if self._trace is not None:
                    self._trace.instant('service/lease_grant', split=chosen.split_id,
                                        worker=worker_id, attempt=chosen.attempt)
                return {'split': chosen.describe(), 'ttl': self._config.lease_ttl_s}
            if all(s.state in (_DONE, _FAILED) for s in self._splits):
                return {'done': True}
            return {'wait': True}

    def _op_complete(self, request):
        worker_id, split_id = request['worker_id'], int(request['split_id'])
        with self._lock:
            split = self._splits[split_id]
            if split.state == _DONE:
                return {'ok': True}   # idempotent (a duplicate delivery)
            if split.state != _LEASED or split.worker_id != worker_id \
                    or split.attempt != request.get('attempt', split.attempt):
                # the lease moved on: this completion has no standing
                return {'ok': False}
            split.state = _DONE
            split.worker_id = None
            if self._trace is not None:
                self._trace.instant('service/split_done', split=split_id, worker=worker_id)
        return {'ok': True}

    def _op_mark_consumed(self, request):
        """A resuming client holds these splits' rows already (its token
        committed them): retire the pending ones so that no worker decodes
        them again.  A split already streaming stays leased; the client
        drops the duplicate."""
        retired = 0
        with self._lock:
            for split_id in request['split_ids']:
                split = self._splits[int(split_id)]
                if split.state == _PENDING:
                    split.state = _DONE
                    retired += 1
        return {'ok': True, 'retired': retired}

    def _op_drain(self, request):
        """Mark one worker draining; it learns on its next heartbeat reply
        or lease refusal, finishes or hands back its splits and leaves."""
        with self._lock:
            worker = self._workers.get(request['worker_id'])
            if worker is None:
                return {'ok': False, 'error': 'unknown worker %r' % request['worker_id']}
            worker['draining'] = True
        return {'ok': True}

    def _op_release(self, request):
        """A draining worker hands back a split it leased and never started:
        back to the front of the queue, its attempt count intact."""
        worker_id, split_id = request['worker_id'], int(request['split_id'])
        with self._lock:
            split = self._splits[split_id]
            if split.state != _LEASED or split.worker_id != worker_id \
                    or split.attempt != request.get('attempt', split.attempt):
                return {'ok': False}
            split.state = _PENDING
            split.worker_id = None
            self._pending.appendleft(split)
            if self._trace is not None:
                self._trace.instant('service/lease_released', split=split_id, worker=worker_id)
        return {'ok': True}

    def _op_deregister(self, request):
        """A drained worker leaves.  ``timed_out=True``: its drain deadline
        passed with splits in flight, which requeue at once (attempt + 1),
        as after a lease expiry."""
        worker_id = request['worker_id']
        with self._lock:
            if self._workers.pop(worker_id, None) is None:
                return {'ok': False}
            self.drains += 1
            if request.get('timed_out'):
                self.drain_timeouts += 1
            for split in self._splits:
                if split.state == _LEASED and split.worker_id == worker_id:
                    self._requeue(split)
        logger.info('worker %s deregistered', worker_id)
        return {'ok': True}

    def _op_job(self, request):
        return {'job': self._job}

    def _op_workers(self, request):
        stale = 3.0 * self._config.lease_ttl_s
        now = time.monotonic()
        with self._lock:
            workers = [{'worker_id': wid, 'addr': w['addr'],
                        'alive': (now - w['last_heartbeat']) < stale,
                        'pid': w['stats'].get('pid')}
                       for wid, w in sorted(self._workers.items())]
            # failed splits ride on the discovery poll: a waiting client raises
            failed = sorted(s.split_id for s in self._splits if s.state == _FAILED)
        return {'workers': workers, 'failed_splits': failed}

    def _op_stats(self, request):
        stale = 3.0 * self._config.lease_ttl_s
        with self._lock:
            states = collections.Counter(s.state for s in self._splits)
            now = time.monotonic()
            workers = {wid: dict(w['stats'], age_s=round(now - w['last_heartbeat'], 3))
                       for wid, w in self._workers.items()}
            alive = sum(1 for w in self._workers.values()
                        if (now - w['last_heartbeat']) < stale)
            draining = sum(1 for w in self._workers.values() if w['draining'])

        def total(keys):
            return {key: sum(int(w.get(key, 0)) for w in workers.values()) for key in keys}
        control = {'drains': self.drains, 'drain_timeouts': self.drain_timeouts,
                   'workers_draining': draining, 'workers_alive': alive}
        control.update(total(('retry_attempts', 'retry_giveups')))
        return {
            'num_splits': len(self._splits),
            'pending': states[_PENDING],
            'leased': states[_LEASED],
            'done': states[_DONE],
            'failed': states[_FAILED],
            'lease_churn': self.lease_churn,
            'shm': total(('shm_chunks', 'shm_degraded')),
            'control_plane': control,
            'stages': _merged_stages([w.get('registry') for w in workers.values()]),
            'workers': {wid: {k: v for k, v in row.items() if k != 'registry'}
                        for wid, row in workers.items()},
        }

    def _op_stop(self, request):
        self._stop.set()
        return {'ok': True}


def _merged_stages(snapshots):
    """Fleet-wide stage latencies: the workers' histogram snapshots added
    bucket by bucket (the buckets are fixed log2), then each stage's count
    and p50/p99 in ms."""
    from petastorm_tpu_torch.telemetry.registry import hist_quantile, ms
    merged = {}
    for snap in snapshots:
        for name, hist in ((snap or {}).get('histograms') or {}).items():
            into = merged.setdefault(name, {'counts': [0] * len(hist['counts']), 'sum': 0.0,
                                            'count': 0})
            into['counts'] = [a + b for a, b in zip(into['counts'], hist['counts'])]
            into['sum'] += hist['sum']
            into['count'] += hist['count']
    return {name: {'count': hist['count'], 'p50_ms': ms(hist_quantile(hist, 0.5)),
                   'p99_ms': ms(hist_quantile(hist, 0.99))}
            for name, hist in merged.items()}


def _count_row_groups(dataset_url):
    """The dataset's row-group count, the one dataset fact the control
    plane needs (workers enumerate the same footer metadata, so indices
    agree)."""
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths

    fs, path_or_paths = get_filesystem_and_path_or_paths(dataset_url)
    paths = path_or_paths if isinstance(path_or_paths, list) else [path_or_paths]
    return sum(len(load_row_groups(fs, p)) for p in paths)

"""Decode worker of the data service: leases splits, decodes them, streams
chunks to the clients.

Counterpart of ``petastorm_tpu/service/worker.py``.  Each leased split
becomes a short-lived reader over exactly that split's row groups
(``piece_indices=``): ``make_reader(..., columnar_decode=True)`` for a
petastorm store, ``make_batch_reader`` for plain Parquet.  The port's decode plane (pools, codecs, retries,
predicates, transforms) runs unchanged, in a process of its own.

Threads:

* the **event loop** owns every ZeroMQ socket: a ROUTER data socket the
  clients subscribe to, and a REQ control socket to the dispatcher
  (register, lease, heartbeat, complete).  Heartbeats renew the leases the
  worker still holds; their loss (the process died) is the failure signal.
* the **decode thread** turns splits into serialized chunks (Arrow IPC for
  a flat table, pickle otherwise: the process pool's two wire formats)
  through a bounded queue, which pauses decode when clients stop granting
  credits.  A consumer that proved it shares this host's ``/dev/shm`` (a
  probe named in its subscribe) gets shm descriptors instead
  (:func:`~petastorm_tpu_torch.workers_pool.shm_plane.write_columns`), a
  chunk falling back to bytes when the arena is full or the chunk is under
  the plane's floor.

Delivery is credit-based: a subscriber grants a chunk budget and renews it
as it pulls chunks off its socket; ``end`` markers ride free.  A split is
done only once its client acked the whole split; then the worker reports
``complete``.  A worker killed before the ack leaves the split leased, the
lease expires and the split is reassigned: at-least-once streaming, which
the client's whole-split dedupe makes exactly-once.  SIGTERM (through
:meth:`Worker.install_signal_handlers`) or the dispatcher's ``drain`` makes
the worker hand back the splits it has not started, finish the rest and
deregister.

One worker serves every tenant of the fleet: a split carries its tenant,
whose job the worker fetches at its first lease (``job`` RPC) and whose
reader arguments it reads with; subscriptions and send queues are per
``(tenant, consumer)``.  A tenant's ``tenant_shm_quota_bytes`` bounds its
outstanding shm bytes (refunded at the split's ack): past it a chunk takes
the byte path; its ``tenant_cache_quota_bytes`` bounds what it fills into
the cache plane: past it its splits decode without the plane.  Neither
stalls.

With the job's ``cache_plane`` each split reader runs with
``cache_type='plane'``; with ``cluster_cache`` the worker advertises its
plane's digests on its heartbeats, streams a split its plane holds whole
without a reader (``cache_remote_hits``), fetches the entries a peer holds
from that peer before decoding (``cache_peer_fills``; a failed fetch,
``cache_peer_degraded``, decodes), and answers its peers' ``fetch``
messages on its data socket.  ``cache_plane_dir=`` points this worker at a
plane of its own (co-hosted workers standing for separate hosts).

``max_inflight_splits`` bounds the leases a worker holds, and
``max_buffered_chunks`` the serialized chunks that wait for credits before
decode pauses; the job's ``reader_factory`` forces the split reader or lets
the worker probe the dataset once per tenant.  With the job's
``telemetry_spans`` each split's stage spans (``service/decode_split``,
``service/serialize``, ``service/shm_publish``,
``service/serve_cached_split``) ride its ``end`` header; a client places them
on its own timeline with the clock offsets of the handshakes: the worker's
offset to the dispatcher, from its registration and each heartbeat, travels
on its heartbeats.  The heartbeats also carry the process's decision
journal (its quota refusals).  The chaos seams (``rpc.request`` in
:meth:`_Rpc.call`, ``worker.chunk`` on byte-path frames, ``worker.decode``
per split, :mod:`~petastorm_tpu_torch.test_util.chaos`) are inert unless a
fault spec is armed.

This module and what it imports load neither torch nor JAX: a worker
process needs no card.  Each split reader takes the job's ``scheduling``
and ``ingest`` (explicit ``reader_kwargs`` win); a reader with the ingest
plane folds the plane's counters and histograms into the worker's registry
and ships its ``ingest/*`` spans on the split's ``end`` header.  Not ported
here (``ROADMAP.md``, Queue A item 7, the telemetry bullet): provenance
records.
"""

import logging
import os
import pickle
import queue
import threading
import time
import traceback
from collections import deque

import numpy as np
# Imported with this module, on the importing thread: pyarrow.parquet
# imported first on a thread that then exits (the cluster cache's identity
# build) leaves later concurrent row-group reads of the process to crash.
import pyarrow.parquet  # noqa: F401

from petastorm_tpu_torch.errors import ServiceError, ServiceRpcTimeoutError
from petastorm_tpu_torch.service import backoff, tenancy
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
from petastorm_tpu_torch.test_util import chaos

logger = logging.getLogger(__name__)

#: Leases a worker holds at once (the reference's default).
MAX_INFLIGHT_SPLITS = 3
#: A worker's decode pauses once this many serialized chunks wait for
#: credits (the reference's default).
MAX_BUFFERED_CHUNKS = 32
#: The spans of one split its ``end`` header carries at most.
_MAX_SPANS_PER_SPLIT = 2048

_DEFAULT_RPC_TIMEOUT_S = 20.0


class _Rpc(object):
    """A REQ-socket RPC client with a timeout.  A REQ socket wedges when a
    reply never comes, so on a timeout the socket is rebuilt and the caller
    may simply retry."""

    def __init__(self, context, addr, timeout_s=_DEFAULT_RPC_TIMEOUT_S):
        import zmq
        self._zmq = zmq
        self._context = context
        self._addr = addr
        self.timeout_s = timeout_s
        self._socket = None
        self._connect()

    def _connect(self):
        self._socket = self._context.socket(self._zmq.REQ)
        self._socket.setsockopt(self._zmq.LINGER, 0)
        self._socket.connect(self._addr)

    def call(self, request, timeout_s=None, raw=False):
        """The reply; an error reply raises :class:`ServiceError` unless
        ``raw`` is set."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        # the chaos seam: a dropped request looks as a lost one does, a
        # timeout on a rebuilt socket, without the wait
        if chaos.inject('rpc.request', op=request.get('op')) == 'drop':
            self._socket.close(0)
            self._connect()
            raise ServiceRpcTimeoutError('chaos: dropped %r to %s'
                                         % (request.get('op'), self._addr))
        self._socket.send(pickle.dumps(request, protocol=4))
        if not self._socket.poll(int(timeout_s * 1000)):
            self._socket.close(0)
            self._connect()
            raise ServiceRpcTimeoutError('no reply from %s to %r within %.1fs'
                                         % (self._addr, request.get('op'), timeout_s))
        reply = pickle.loads(self._socket.recv())
        if not raw and isinstance(reply, dict) and reply.get('error'):
            raise ServiceError('%s rejected %r: %s' % (self._addr, request.get('op'),
                                                       reply['error']))
        return reply

    def close(self):
        if self._socket is not None:
            self._socket.close(0)
            self._socket = None


def serialize_chunk(chunk):
    """A dict of arrays -> ``(tag, payload)``: Arrow IPC (``b'A'``) for a
    flat table, pickle (``b'R'``) for multi-dimensional or ragged columns,
    which an Arrow table does not hold losslessly.  The Arrow payload is
    the ``pa.Buffer`` itself (ZeroMQ sends it without a copy)."""
    import pyarrow as pa

    from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer

    flat = all(isinstance(v, np.ndarray) and v.ndim == 1 and v.dtype != np.dtype(object)
               for v in chunk.values())
    if flat:
        try:
            table = pa.table({k: pa.array(v) for k, v in chunk.items()})
            return b'A', ArrowTableSerializer().serialize(table)
        except pa.ArrowInvalid:
            pass
    return b'R', pickle.dumps(chunk, protocol=4)


def deserialize_chunk(tag, payload):
    """The inverse of :func:`serialize_chunk`: a dict of numpy arrays."""
    from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer

    if tag == b'A':
        table = ArrowTableSerializer().deserialize(payload)
        return {name: table.column(name).to_numpy(zero_copy_only=False)
                for name in table.column_names}
    if tag == b'R':
        return pickle.loads(payload)
    raise ValueError('unknown chunk frame tag %r' % (tag,))


class Worker(object):
    """One decode worker, run on a thread (:meth:`start`) or as the body of
    a process (:meth:`run`).

    Args:
        dispatcher_addr: the dispatcher's REP endpoint.
        data_bind: where this worker's ROUTER data socket binds;
            ``tcp://host:*`` takes a free port (the address is advertised
            to the dispatcher, where clients find it).
        advertise_host: the host published in place of the bind host; a
            wildcard bind host is unroutable from other machines, and
            without this the worker publishes ``socket.gethostname()``.
        max_inflight_splits: leases held at once.
        max_buffered_chunks: serialized chunks waiting for credits before
            decode pauses.
        cache_plane_dir: this worker's cache plane directory in place of the
            job's (the plane is a host's asset; co-hosted workers standing
            for separate hosts each take their own).
    """

    def __init__(self, dispatcher_addr, data_bind='tcp://127.0.0.1:*', advertise_host=None,
                 max_inflight_splits=MAX_INFLIGHT_SPLITS, max_buffered_chunks=MAX_BUFFERED_CHUNKS,
                 cache_plane_dir=None):
        self._dispatcher_addr = dispatcher_addr
        self._data_bind = data_bind
        self._advertise_host = advertise_host
        if int(max_inflight_splits) < 1 or int(max_buffered_chunks) < 1:
            raise ValueError('max_inflight_splits and max_buffered_chunks must be >= 1')
        self._max_inflight = int(max_inflight_splits)
        self._max_buffered = int(max_buffered_chunks)
        #: (this clock - the dispatcher's), an EWMA over the handshakes of the
        #: registration and each heartbeat, its drift since the first, and the
        #: last handshake's round trip
        self.clock_offset = None
        self.clock_drift_ms = 0.0
        self.clock_rtt_ms = None
        self._clock_offset_initial = None
        self._stop = threading.Event()
        #: set by :meth:`drain`, SIGTERM or a dispatcher ``drain``: stop
        #: leasing, hand back unstarted splits, finish the rest, deregister
        self._drain = threading.Event()
        self.drained = False
        self.drain_timed_out = False
        self._thread = None
        self._t_start = None
        self._decode_out = None
        self.worker_id = None
        self.data_addr = None
        self._ready = threading.Event()
        #: the worker's counters; the whole snapshot rides every heartbeat,
        #: and the dispatcher's ``stats`` adds the fleet's up
        self.metrics = MetricsRegistry('service_worker')
        self._m_rows = self.metrics.counter('rows_decoded')
        self._m_splits = self.metrics.counter('splits_decoded')
        self._m_shm_chunks = self.metrics.counter('shm_chunks')
        self._m_byte_chunks = self.metrics.counter('byte_chunks')
        self._m_decode_hist = self.metrics.histogram('decode_split')
        self._m_serialize_hist = self.metrics.histogram('serialize')
        self._m_shm_pub_hist = self.metrics.histogram('shm_publish')
        self._m_retry = {key: self.metrics.counter(key)
                         for key in ('retry_attempts', 'retry_giveups')}
        #: the shm result plane (None when the job or host disables it);
        #: written by the decode thread only
        self._arena = None
        #: (tenant, consumer) -> True when its subscribe proved it shares
        #: /dev/shm
        self._shm_consumers = {}
        #: the split readers' cache counters, summed
        self._m_cache = {key: self.metrics.counter(key)
                         for key in ('cache_hits', 'cache_misses', 'cache_evictions',
                                     'cache_ram_hits', 'cache_degraded')}
        #: pieces served from the plane without a reader, entries fetched
        #: from a peer, and fetches that failed (the split then decodes)
        self._m_cluster = {key: self.metrics.counter(key)
                           for key in ('cache_remote_hits', 'cache_peer_fills',
                                       'cache_peer_degraded')}
        self._m_serve_hist = self.metrics.histogram('serve_cached_split')
        #: the cluster cache's state when the job has it (owned by run())
        self._cluster = None
        self._cache_plane_dir = cache_plane_dir
        self._zmq_context = None
        self._fetcher = None
        self._default_job = None
        #: tenant -> its job_info, the default tenant's from the
        #: registration, the others' fetched at their first lease
        self._tenant_jobs = {}
        #: tenant -> its reader factory (datasets differ per job)
        self._reader_factories = {}
        #: per-tenant budgets: outstanding shm bytes, refunded at the ack;
        #: bytes filled into the cache plane
        self._shm_quota = tenancy.QuotaLedger(label='shm')
        self._cache_quota = tenancy.QuotaLedger(label='cache')
        #: (split_id, attempt) -> shm bytes charged, refunded at its ack,
        #: replay or decode error
        self._shm_split_bytes = {}
        #: tenants whose cache budget is spent (for the worker's life)
        self._cache_over_budget = set()
        self._m_quota = {key: self.metrics.counter(key)
                         for key in ('shm_quota_degraded', 'cache_quota_degraded')}

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Run the worker on a daemon thread (a worker in the caller's
        process)."""
        self._thread = threading.Thread(target=self.run, name='service-worker', daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=30) or self.worker_id is None:
            raise RuntimeError('worker failed to register with %r' % (self._dispatcher_addr,))
        return self

    def stop(self):
        self._stop.set()

    def drain(self):
        """Begin a graceful drain: no new leases, the splits never started
        handed back (``release``, attempt intact), the rest streamed and
        acked, then ``deregister``.  Past the job's ``drain_timeout_s`` the
        worker deregisters as timed out and the dispatcher requeues what it
        held.  Safe from any thread and from a signal handler."""
        self._drain.set()

    def install_signal_handlers(self):
        """SIGTERM -> :meth:`drain` (the main thread only, by the standard
        library's rule)."""
        import signal

        def on_sigterm(signum, frame):
            logger.info('SIGTERM: draining worker %s', self.worker_id)
            self.drain()

        signal.signal(signal.SIGTERM, on_sigterm)

    def join(self):
        if self._thread is not None:
            self._thread.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()

    # -- main loop -----------------------------------------------------------

    def run(self):
        import zmq

        from petastorm_tpu_torch.workers_pool import shm_plane

        context = zmq.Context()
        data = context.socket(zmq.ROUTER)
        data.setsockopt(zmq.LINGER, 0)
        data.set_hwm(0)   # credits bound the data in flight, not the HWM
        if self._data_bind.startswith('tcp') and self._data_bind.endswith((':*', ':0')):
            base = self._data_bind.rsplit(':', 1)[0]
            self.data_addr = '%s:%d' % (base, data.bind_to_random_port(base))
        else:
            data.bind(self._data_bind)
            self.data_addr = self._data_bind
        self.data_addr = self._advertised(self.data_addr)
        rpc = _Rpc(context, self._dispatcher_addr)
        decode_in = queue.Queue()
        decode_out = queue.Queue(maxsize=self._max_buffered)
        self._decode_out = decode_out
        decode_thread = None
        try:
            t_reg0 = time.monotonic()
            reply = rpc.call({'op': 'register_worker', 'data_addr': self.data_addr})
            self._update_clock(reply.get('t_mono'), t_reg0, time.monotonic())
            self.worker_id = reply['worker_id']
            job = reply['job']
            if self._cache_plane_dir is not None:
                job = dict(job, cache_plane_dir=self._cache_plane_dir)
            # a reply later than a lease TTL finds the leases gone anyway:
            # past it, rebuild the socket and retry (a request in flight
            # when the dispatcher died gets no reply at all)
            rpc.timeout_s = min(_DEFAULT_RPC_TIMEOUT_S, max(1.0, float(job['lease_ttl_s'])))
            # the registration's job is the default tenant's
            self._adopt_tenant_job(job)
            self._default_job = job
            from petastorm_tpu_torch.service import cluster
            if cluster.enabled(job):
                self._cluster = cluster.ClusterWorkerState(job)
            self._zmq_context = context
            if job.get('shm', True) and shm_plane.available():
                self._arena = shm_plane.ShmArena(
                    capacity_bytes=job.get('shm_capacity_bytes', shm_plane.DEFAULT_CAPACITY_BYTES))
            self._t_start = time.monotonic()
            self._ready.set()
            decode_thread = threading.Thread(target=self._decode_loop,
                                             args=(job, decode_in, decode_out),
                                             name='service-worker-decode', daemon=True)
            decode_thread.start()
            self._event_loop(zmq, data, rpc, job, decode_in, decode_out)
        finally:
            self._ready.set()   # unblock start() on an early failure
            decode_in.put(None)
            if decode_thread is not None:
                # unstick a decode blocked on the bounded output queue
                while decode_thread.is_alive():
                    try:
                        decode_out.get_nowait()
                    except queue.Empty:
                        decode_thread.join(timeout=0.05)
            if self._arena is not None:
                # after the decode thread: a clean shutdown leaves no slab
                self._arena.stop()
            rpc.close()
            data.close(0)
            context.term()

    #: the weight of each new handshake in the clock offset's EWMA
    _CLOCK_EWMA_ALPHA = 0.2

    def _update_clock(self, t_mono, t0, t1):
        """Fold one handshake (the reply's ``t_mono`` against the local send
        and receive times) into the offset and its drift."""
        if t_mono is None:
            return
        self.clock_rtt_ms = round(1e3 * (t1 - t0), 3)
        estimate = (t0 + t1) / 2.0 - float(t_mono)
        if self.clock_offset is None:
            self._clock_offset_initial = estimate
            self.clock_offset = round(estimate, 6)
            return
        alpha = self._CLOCK_EWMA_ALPHA
        ewma = (1.0 - alpha) * self.clock_offset + alpha * estimate
        self.clock_offset = round(ewma, 6)
        self.clock_drift_ms = round(1e3 * (ewma - self._clock_offset_initial), 3)

    # -- the tenants' jobs --------------------------------------------------

    def _adopt_tenant_job(self, job):
        """Enter one tenant's job_info and arm its quota budgets."""
        tenant = str(job.get('tenant') or tenancy.DEFAULT_TENANT)
        self._tenant_jobs[tenant] = job
        self._shm_quota.set_budget(tenant, job.get('tenant_shm_quota_bytes'))
        self._cache_quota.set_budget(tenant, job.get('tenant_cache_quota_bytes'))
        return tenant

    def _job_for(self, split):
        """The split's tenant's job_info (the default job for a split
        without a tenant)."""
        return self._tenant_jobs.get(self._split_tenant(split)) or self._default_job

    def _fetch_tenant_job(self, rpc, tenant):
        """Fetch and adopt an unknown tenant's job; False when the RPC fails
        (the caller hands the split back rather than decode it wrong)."""
        if tenant in self._tenant_jobs:
            return True
        try:
            job = rpc.call({'op': 'job', 'tenant': tenant})['job']
        except ServiceError as e:
            logger.warning('job fetch for tenant %r failed: %s', tenant, e)
            return False
        if self._cache_plane_dir is not None:
            job = dict(job, cache_plane_dir=self._cache_plane_dir)
        self._adopt_tenant_job(job)
        logger.info('adopted tenant %r job (%s)', tenant, job.get('dataset_url'))
        return True

    @staticmethod
    def _split_tenant(split):
        return str(split.get('tenant') or tenancy.DEFAULT_TENANT)

    def _refund_shm_quota(self, split):
        """Return a split's outstanding shm bytes to its tenant's budget (its
        ack came, or its stream was abandoned)."""
        nbytes = self._shm_split_bytes.pop((int(split['split_id']), int(split['attempt'])), 0)
        if nbytes:
            self._shm_quota.refund(self._split_tenant(split), nbytes)

    def _count_retry(self, episode):
        """Count one heartbeat retry; an exhausted episode counts one
        ``retry_giveups`` and a fresh episode begins."""
        episode = episode or backoff.HEARTBEAT_POLICY.episode()
        self._m_retry['retry_attempts'].inc()
        if episode.give_up():
            self._m_retry['retry_giveups'].inc()
            episode = backoff.HEARTBEAT_POLICY.episode()
        return episode

    def _advertised(self, addr):
        """The address published to the dispatcher: a wildcard bind host is
        replaced by something routable."""
        scheme, rest = addr.split('://', 1)
        host, port = rest.rsplit(':', 1)
        if self._advertise_host is not None:
            host = self._advertise_host
        elif host in ('0.0.0.0', '*', '::'):
            import socket
            host = socket.gethostname()
            logger.warning('data_bind host is unroutable from other machines; advertising %r '
                           'instead (pass advertise_host to override)', host)
        return '%s://%s:%s' % (scheme, host, port)

    def _event_loop(self, zmq, data, rpc, job, decode_in, decode_out):
        from petastorm_tpu_torch.workers_pool import shm_plane

        heartbeat_every = max(0.2, job['lease_ttl_s'] / 3.0)
        lease_probe_every = min(1.0, max(0.05, job['lease_ttl_s'] / 10.0))
        next_heartbeat = next_lease_probe = 0.0
        hb_retry = None
        draining = False
        drain_deadline = None
        subscribers = {}      # (tenant, consumer) -> identity
        credits = {}          # identity -> chunks it may still be sent
        sendq = {}            # (tenant, consumer) -> deque of (header, payload or None)
        inflight = {}         # split_id -> split, leased and not yet acked
        awaiting_ack = {}     # (split_id, attempt) -> split, streamed
        ack_deadline = {}     # (split_id, attempt) -> monotonic deadline
        ack_timeout = 3.0 * job['lease_ttl_s']
        decoding = set()      # split ids queued or decoding

        def replay(key):
            """Decode again a split streamed and never acked: its frames
            went to an identity that is gone, or the ack was lost."""
            split = awaiting_ack.pop(key, None)
            ack_deadline.pop(key, None)
            if split is not None and split['split_id'] not in decoding:
                # the abandoned stream's shm bytes go back before the
                # decode charges them again
                self._refund_shm_quota(split)
                decoding.add(split['split_id'])
                decode_in.put(split)

        poller = zmq.Poller()
        poller.register(data, zmq.POLLIN)
        while not self._stop.is_set():
            now = time.monotonic()
            # 1. the clients' messages: subscribe, credit, ack, resend
            if dict(poller.poll(20)):
                while True:
                    try:
                        identity, raw = data.recv_multipart(zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    msg = pickle.loads(raw)
                    kind = msg.get('type')
                    if kind == 'subscribe':
                        # a subscribe without a tenant is the default tenant's
                        ckey = (str(msg.get('tenant') or tenancy.DEFAULT_TENANT),
                                int(msg['consumer']))
                        previous = subscribers.get(ckey)
                        if previous is not None and previous != identity:
                            # the consumer reconnected under a new identity:
                            # what went to the old one is gone, replay it
                            credits.pop(previous, None)
                            for key in [k for k, s in awaiting_ack.items()
                                        if (self._split_tenant(s), s['consumer']) == ckey]:
                                replay(key)
                        subscribers[ckey] = identity
                        credits[identity] = int(msg.get('credits', 8))
                        # the client names a probe file in its /dev/shm:
                        # seeing it proves the two share the plane
                        self._shm_consumers[ckey] = self._arena is not None \
                            and shm_plane.probe_exists(msg.get('shm_probe'))
                    elif kind == 'credit':
                        if identity in credits:
                            credits[identity] += int(msg.get('n', 1))
                    elif kind == 'fetch':
                        # a peer asks for one plane entry by digest: answered
                        # here, outside the credits (a bounded mmap copy)
                        from petastorm_tpu_torch.service import cluster
                        state = self._cluster
                        plane = state.identity.plane if state is not None and state.ready() \
                            else None
                        data.send_multipart(cluster.fetch_reply(identity, msg, plane,
                                                                arena=self._arena))
                    elif kind == 'ack':
                        key = (int(msg['split']), int(msg['attempt']))
                        split = awaiting_ack.pop(key, None)
                        ack_deadline.pop(key, None)
                        if split is not None:
                            inflight.pop(split['split_id'], None)
                            self._refund_shm_quota(split)
                            try:
                                rpc.call({'op': 'complete', 'worker_id': self.worker_id,
                                          'split_id': split['split_id'],
                                          'attempt': split['attempt']})
                            except ServiceError as e:
                                logger.warning('complete(%d) failed: %s', split['split_id'], e)
                    elif kind == 'resend':
                        # the client lost chunks of this stream and dropped
                        # its partial buffer: decode and stream it again
                        replay((int(msg['split']), int(msg['attempt'])))
            # 1b. a drain begins: hand back every split still queued for
            # decode (never started); the rest finish through acks
            if not draining and self._drain.is_set():
                draining = True
                drain_deadline = now + float(job.get('drain_timeout_s', 30.0))
                while True:
                    try:
                        item = decode_in.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:   # run()'s stop sentinel outranks the drain
                        decode_in.put(None)
                        break
                    inflight.pop(item['split_id'], None)
                    decoding.discard(item['split_id'])
                    try:
                        rpc.call({'op': 'release', 'worker_id': self.worker_id,
                                  'split_id': item['split_id'], 'attempt': item['attempt']})
                    except ServiceError:
                        pass   # the lease expires instead
            # 2. decoded chunks into the consumers' send queues, while fewer
            # than max_buffered_chunks wait for credits: the rest stay in
            # the bounded decode_out, which pauses the decode thread
            while sum(len(q) for q in sendq.values()) < self._max_buffered:
                try:
                    item = decode_out.get_nowait()
                except queue.Empty:
                    break
                kind, split = item[0], item[1]
                ckey = (self._split_tenant(split), split['consumer'])
                if kind == 'chunk':
                    _, _, seq, tag, payload = item
                    header = {'type': 'chunk', 'split': split['split_id'],
                              'attempt': split['attempt'], 'seq': seq, 'tag': tag}
                    sendq.setdefault(ckey, deque()).append((header, payload))
                elif kind == 'end':
                    _, _, nchunks, nrows, spans = item
                    decoding.discard(split['split_id'])
                    # the split's spans, on this worker's clock
                    header = {'type': 'end', 'split': split['split_id'],
                              'attempt': split['attempt'], 'chunks': nchunks, 'rows': nrows,
                              'spans': spans}
                    sendq.setdefault(ckey, deque()).append((header, None))
                    key = (split['split_id'], split['attempt'])
                    awaiting_ack[key] = split
                    ack_deadline[key] = time.monotonic() + ack_timeout
                else:   # a decode error: the lease expires and moves on
                    decoding.discard(split['split_id'])
                    inflight.pop(split['split_id'], None)
                    self._refund_shm_quota(split)
                    logger.error('decode of split %d failed:\n%s', split['split_id'], item[2])
            # 3. flush the send queues under credit control
            for ckey, q in sendq.items():
                identity = subscribers.get(ckey)
                if identity is None:
                    continue
                while q:
                    header, payload = q[0]
                    if header['type'] == 'chunk':
                        if credits.get(identity, 0) < 1:
                            break
                        # the chaos seam, on byte-path frames only (a second
                        # shm descriptor would release its slab twice).  A
                        # dropped chunk keeps its credit: the client's count
                        # at 'end' asks for the split again
                        action = chaos.inject('worker.chunk', split=header['split'],
                                              seq=header['seq']) \
                            if header['tag'] != b'S' else None
                        if action != 'drop':
                            credits[identity] -= 1
                            frames = [identity, pickle.dumps(header, protocol=4), payload]
                            data.send_multipart(frames)
                            if action == 'dup':
                                data.send_multipart(frames)
                    else:
                        data.send_multipart([identity, pickle.dumps(header, protocol=4)])
                    q.popleft()
            # 3b. acks that never came: replay to the current subscriber
            for key in [k for k, d in ack_deadline.items() if now > d]:
                split = awaiting_ack.get(key)
                if split is None or subscribers.get((self._split_tenant(split),
                                                     split['consumer'])) is None:
                    ack_deadline[key] = now + ack_timeout
                    continue
                logger.warning('split %d attempt %d un-acked for %.0fs; replaying',
                               key[0], key[1], ack_timeout)
                replay(key)
            # 4. heartbeat: renews the leases this worker still claims
            if now >= next_heartbeat:
                try:
                    t_hb0 = time.monotonic()
                    request = {'op': 'heartbeat', 'worker_id': self.worker_id,
                               'stats': self.heartbeat_stats(), 'held': list(inflight)}
                    if draining:
                        request['draining'] = True
                    # the cluster cache's advertisement: the digest set when
                    # it changed, the piece map until the dispatcher has it
                    sent_pieces = False
                    if self._cluster is not None:
                        fields = self._cluster.heartbeat_fields()
                        sent_pieces = 'piece_digests' in fields
                        request.update(fields)
                    reply = rpc.call(request)
                    if self._cluster is not None:
                        if sent_pieces and reply.get('ok'):
                            self._cluster.advertised_pieces = True
                        if reply.get('need_piece_digests'):
                            self._cluster.advertised_pieces = False
                    if reply.get('drain'):
                        self._drain.set()
                    self._update_clock(reply.get('t_mono'), t_hb0, time.monotonic())
                    hb_retry = None
                    next_heartbeat = now + backoff.jittered(heartbeat_every, 0.1)
                except ServiceRpcTimeoutError:
                    logger.warning('heartbeat to %s timed out', self._dispatcher_addr)
                    hb_retry = self._count_retry(hb_retry)
                    # never slower than the healthy cadence: the leases
                    # would expire while the worker waits
                    next_heartbeat = now + min(heartbeat_every, hb_retry.next_delay())
                except ServiceError:
                    # the dispatcher lost this registration: register again
                    try:
                        reply = rpc.call({'op': 'register_worker', 'data_addr': self.data_addr})
                        logger.warning('re-registered with %s as %s (was %s)',
                                       self._dispatcher_addr, reply['worker_id'],
                                       self.worker_id)
                        self.worker_id = reply['worker_id']
                        if self._cluster is not None:
                            self._cluster.reset_advertisement()
                        hb_retry = None
                        # beat at once under the new id: its held claims let
                        # a dispatcher restored from its ledger adopt the
                        # leases before they expire
                        next_heartbeat = now
                    except ServiceError:
                        hb_retry = self._count_retry(hb_retry)
                        next_heartbeat = now + min(heartbeat_every, hb_retry.next_delay())
            # 4b. the drain ends once nothing is in flight or buffered, or
            # at its deadline (then the dispatcher requeues the rest)
            if draining:
                idle = not inflight and decode_out.empty() and not any(sendq.values())
                if idle or now > drain_deadline:
                    self.drain_timed_out = not idle
                    try:
                        rpc.call({'op': 'deregister', 'worker_id': self.worker_id,
                                  'timed_out': not idle})
                    except ServiceError:
                        pass   # the heartbeats stop; the leases expire instead
                    self.drained = True
                    break
            # 5. lease more work, only for the (tenant, consumer) pairs
            # subscribed here; a draining worker takes nothing new
            if not draining and subscribers and len(inflight) < self._max_inflight \
                    and now >= next_lease_probe:
                try:
                    reply = rpc.call({'op': 'lease', 'worker_id': self.worker_id,
                                      'consumers': [list(k) for k in sorted(subscribers)]})
                except ServiceError:
                    reply = {'wait': True}
                if reply.get('drain'):
                    self._drain.set()
                split = reply.get('split')
                if split and reply.get('holders'):
                    split['holders'] = reply['holders']   # the peer-fill hints
                if split and self._fetch_tenant_job(rpc, self._split_tenant(split)):
                    inflight[split['split_id']] = split
                    decoding.add(split['split_id'])
                    decode_in.put(split)
                else:
                    if split:   # its tenant's job did not come: hand it back
                        try:
                            rpc.call({'op': 'release', 'worker_id': self.worker_id,
                                      'split_id': split['split_id'],
                                      'attempt': split['attempt']})
                        except ServiceError:
                            pass   # the lease expires instead
                    next_lease_probe = now + lease_probe_every

    # -- decode --------------------------------------------------------------

    def _resolve_factory(self, job):
        """The job's ``reader_factory``: ``'reader'`` (the codec reader,
        columnar output) or ``'batch_reader'``; ``'auto'`` probes the
        dataset, a petastorm store getting the codec reader and plain
        Parquet the batch reader.  Resolved once per tenant."""
        from petastorm_tpu_torch.errors import MetadataError
        from petastorm_tpu_torch.reader import make_batch_reader, make_reader

        def codec_reader(url, **kwargs):
            return make_reader(url, columnar_decode=True, **kwargs)

        choice = job.get('reader_factory', 'auto')
        if choice == 'reader':
            return codec_reader
        if choice == 'batch_reader':
            return make_batch_reader
        try:
            reader = codec_reader(job['dataset_url'], num_epochs=1, piece_indices=[0],
                                  shuffle_row_groups=False, **job['reader_kwargs'])
        except MetadataError:
            return make_batch_reader
        reader.stop()
        reader.join()
        return codec_reader

    def _reader_kwargs(self, job):
        """A split reader's arguments: the job's dispatch policy and ingest
        mode (``'auto'`` still resolves to FIFO on a split too small to
        reorder, and to no plane on local files); with the job's
        ``cache_plane`` it looks each row group up in the plane first
        (explicit settings in ``reader_kwargs`` win); a tenant over its
        cache budget reads without the plane."""
        kwargs = dict(job['reader_kwargs'])
        kwargs.setdefault('scheduling', job.get('scheduling', 'auto'))
        kwargs.setdefault('ingest', job.get('ingest', 'auto'))
        tenant = str(job.get('tenant') or tenancy.DEFAULT_TENANT)
        if tenant in self._cache_over_budget and 'cache_type' not in kwargs:
            self._m_quota['cache_quota_degraded'].inc()
            return kwargs
        if job.get('cache_plane') and 'cache_type' not in kwargs:
            kwargs['cache_type'] = 'plane'
            kwargs.setdefault('cache_location', job['cache_plane_dir'])
            kwargs.setdefault('cache_size_limit', job.get('cache_plane_disk_bytes'))
            extra = dict(kwargs.get('cache_extra_settings') or {})
            extra.setdefault('ram_bytes', job.get('cache_plane_ram_bytes'))
            kwargs['cache_extra_settings'] = extra
        return kwargs

    def _serialize_split_chunk(self, split, chunk, cid, spans):
        """``(tag, payload)`` of one chunk: shm descriptors (``b'S'``) for a
        consumer on this host, else (or when the arena refuses, the chunk is
        under the plane's floor, or its tenant's shm budget would pass) the
        byte framing.  Its ``service/shm_publish`` or ``service/serialize``
        span, correlated by ``cid``, goes on ``spans``."""
        t0 = time.monotonic()
        tenant = self._split_tenant(split)
        if self._arena is not None and self._shm_consumers.get((tenant, split['consumer'])):
            nbytes = sum(int(getattr(v, 'nbytes', 0)) for v in chunk.values())
            if not self._shm_quota.charge(tenant, nbytes):
                self._m_quota['shm_quota_degraded'].inc()
            else:
                from petastorm_tpu_torch.workers_pool import shm_plane
                desc = shm_plane.write_columns(self._arena, chunk)
                if desc is not None:
                    key = (int(split['split_id']), int(split['attempt']))
                    self._shm_split_bytes[key] = self._shm_split_bytes.get(key, 0) + nbytes
                    t1 = time.monotonic()
                    self._m_shm_chunks.inc()
                    self._m_shm_pub_hist.observe(t1 - t0)
                    spans.append(_span('service/shm_publish', t0, t1, cid))
                    return b'S', pickle.dumps(desc, protocol=4)
                self._shm_quota.refund(tenant, nbytes)
        tag, payload = serialize_chunk(chunk)
        t1 = time.monotonic()
        self._m_byte_chunks.inc()
        self._m_serialize_hist.observe(t1 - t0)
        spans.append(_span('service/serialize', t0, t1, cid))
        return tag, payload

    def _accumulate_cache_stats(self, reader):
        """Fold one split reader's plane counters (a plane per split: its
        totals are the split's) into the worker's."""
        cache = getattr(reader, '_cache', None)
        stats = getattr(cache, 'stats', None)
        if not stats:
            return
        for key, counter in self._m_cache.items():
            counter.inc(int(stats.get(key, 0)))
        plane_metrics = getattr(cache, 'metrics', None)
        if plane_metrics is not None:
            self.metrics.merge({'histograms': plane_metrics.snapshot()['histograms']})

    def _accumulate_ingest_stats(self, reader):
        """Fold one split reader's ingest-plane activity into the worker's
        registry: its counters, and its ``ingest_fetch``/``ingest_wait``
        histograms for the fleet's ``stages`` rollup."""
        plane = getattr(reader, 'ingest_plane', None)
        if plane is None:
            return
        for name, value in plane.stats.items():
            if name in ('ingest_fetches', 'ingest_fetch_bytes', 'ingest_gets',
                        'ingest_degraded', 'ingest_hedges', 'ingest_hedge_wins'):
                self.metrics.counter(name).inc(int(value))
        self.metrics.merge({'histograms': {
            name: hist for name, hist in plane.metrics.snapshot()['histograms'].items()
            if name.startswith('ingest_')}})

    def _cluster_chunks(self, split):
        """The cluster cache's try at a leased split: fetch from the holders
        the lease named each entry the local plane misses, then look the
        whole split up locally.  The chunks, or None when the split cannot be
        served from the plane (nothing has been emitted then, and the reader
        path runs, helped by whatever was fetched).  Never raises."""
        from petastorm_tpu_torch.service import cluster
        state = self._cluster
        if state is None or not state.ready():
            return None
        identity = state.identity
        try:
            indices = split['indices']
            holders = split.get('holders') or {}
            filled = []
            for digest in identity.missing_digests(indices):
                addrs = holders.get(cluster.cdigest(digest)) or ()
                if not addrs:
                    continue   # nobody holds it: a cold decode, no counter
                if self._fetcher is None:
                    self._fetcher = cluster.PeerFetcher(self._zmq_context)
                blob = None
                for i, addr in enumerate(addrs):
                    if i:
                        self._m_retry['retry_attempts'].inc()
                    blob = self._fetcher.fetch(addr, digest)
                    if blob is not None:
                        break
                if blob is None:
                    self._m_retry['retry_giveups'].inc()
                if blob is not None and identity.plane.publish_blob(digest, blob):
                    self._m_cluster['cache_peer_fills'].inc()
                    filled.append(digest)
                else:
                    self._m_cluster['cache_peer_degraded'].inc()
            if filled:
                state.note_published(filled)
            chunks = identity.serve_chunks(indices)
            if chunks is not None:
                self._m_cluster['cache_remote_hits'].inc(len(identity.split_digests(indices)))
            return chunks
        except Exception:  # noqa: BLE001 — the cluster cache degrades, never blocks
            logger.warning('cluster cache: split %s degraded to a direct decode',
                           split.get('split_id'), exc_info=True)
            return None

    def _stream(self, split, chunks, decode_out, spans):
        """Serialize and queue a split's chunks; their count, rows and
        bytes."""
        seq = rows = out_bytes = 0
        for chunk in chunks:
            tag, payload = self._serialize_split_chunk(
                split, chunk, '%d/%d' % (split['split_id'], seq), spans)
            rows += len(next(iter(chunk.values())))
            out_bytes += len(payload)
            decode_out.put(('chunk', split, seq, tag, payload))
            seq += 1
        return seq, rows, out_bytes

    def _decode_loop(self, job, decode_in, decode_out):
        try:
            while True:
                split = decode_in.get()
                if split is None:
                    return
                self._decode_split(job, split, decode_out)
        finally:
            # the fetch sockets die with this thread, before run()'s
            # context.term(), which would wait on them
            fetcher, self._fetcher = self._fetcher, None
            if fetcher is not None:
                fetcher.close()

    def _decode_split(self, job, split, decode_out):
        """Decode (or serve from the cache) one leased split into
        ``decode_out``: its chunks, then its end with its spans when the
        registration ``job`` ships them."""
        t0 = time.monotonic()
        spans = []
        try:
            # the chaos seam: a decode's delay, or its failure (the lease
            # then expires and moves)
            chaos.inject('worker.decode', split=split['split_id'])
            tenant = self._split_tenant(split)
            tjob = self._job_for(split) if self._tenant_jobs else job
            # a split of the registration job's dataset may be served from
            # the plane without a reader (the cluster identity is of it)
            chunks = None
            if tjob.get('dataset_url') == job.get('dataset_url'):
                chunks = self._cluster_chunks(split)
            if chunks is not None:
                seq, rows, _ = self._stream(split, chunks, decode_out, spans)
                name = 'service/serve_cached_split'
                t1 = time.monotonic()
                self._m_serve_hist.observe(t1 - t0)
            else:
                factory = self._reader_factories.get(tenant)
                if factory is None:
                    factory = self._reader_factories[tenant] = self._resolve_factory(tjob)
                reader = factory(tjob['dataset_url'], piece_indices=split['indices'],
                                 num_epochs=1, shuffle_row_groups=False,
                                 **self._reader_kwargs(tjob))
                with reader:
                    seq, rows, out_bytes = self._stream(
                        split, (item._asdict() if hasattr(item, '_asdict') else dict(item)
                                for item in reader), decode_out, spans)
                name = 'service/decode_split'
                t1 = time.monotonic()
                self._m_decode_hist.observe(t1 - t0)
                # the split's chunk bytes stand for what it filled into the
                # plane; the charge that passes the budget turns the tenant's
                # later readers plane-less
                if tjob.get('cache_plane') and tenant not in self._cache_over_budget \
                        and self._cache_quota.budget(tenant) is not None \
                        and not self._cache_quota.charge(tenant, out_bytes):
                    self._cache_over_budget.add(tenant)
                    logger.warning('tenant %r cache-plane budget exhausted; its readers '
                                   'decode without the plane', tenant)
                self._accumulate_cache_stats(reader)
                self._accumulate_ingest_stats(reader)
                # the split's plane is this split's fetches, exactly
                ingest_spans = getattr(getattr(reader, 'ingest_plane', None), 'spans', None)
                if ingest_spans is not None:
                    spans.extend(ingest_spans.drain())
                if self._cluster is not None and self._cluster.ready() \
                        and tjob.get('dataset_url') == job.get('dataset_url'):
                    self._cluster.note_published(
                        self._cluster.identity.split_digests(split['indices']))
            spans.append(_span(name, t0, t1, str(split['split_id']), rows=rows))
            # counted before the split's end is queued: a heartbeat sent
            # after its client got the split carries it
            self._m_rows.inc(rows)
            self._m_splits.inc()
            decode_out.put(('end', split, seq, rows,
                            spans[-_MAX_SPANS_PER_SPLIT:] if job.get('telemetry_spans', True)
                            else []))
        except Exception:  # noqa: BLE001 — shipped to the event loop
            decode_out.put(('error', split, traceback.format_exc()))

    # -- metrics -------------------------------------------------------------

    @property
    def diagnostics(self):
        """This worker's counters, also shipped on every heartbeat."""
        elapsed = (time.monotonic() - self._t_start) if self._t_start else 0.0
        rows = int(self._m_rows.value)
        out = {
            'rows_decoded': rows,
            'splits_decoded': int(self._m_splits.value),
            'rows_per_s': round(rows / elapsed, 1) if elapsed > 0 else 0.0,
            'queue_depth': self._decode_out.qsize() if self._decode_out is not None else 0,
            'shm_chunks': int(self._m_shm_chunks.value),
            'byte_chunks': int(self._m_byte_chunks.value),
            'shm_degraded': int(self._arena.degraded) if self._arena is not None else 0,
            'retry_attempts': int(self._m_retry['retry_attempts'].value),
            'retry_giveups': int(self._m_retry['retry_giveups'].value),
            'shm_quota_degraded': int(self._m_quota['shm_quota_degraded'].value),
            'cache_quota_degraded': int(self._m_quota['cache_quota_degraded'].value),
            'draining': bool(self._drain.is_set()),
        }
        out.update({key: int(c.value) for key, c in self._m_cache.items()})
        out.update({key: int(c.value) for key, c in self._m_cluster.items()})
        return out

    def heartbeat_stats(self):
        """The heartbeat's payload: :attr:`diagnostics`, the registry's
        snapshot (its histograms add up fleet-wide at the dispatcher), the
        clock offset with its drift and round trip, the process's
        decision-journal payload and the pid."""
        from petastorm_tpu_torch.telemetry import decisions
        return dict(self.diagnostics, registry=self.metrics.snapshot(),
                    clock_offset=self.clock_offset, clock_drift_ms=self.clock_drift_ms,
                    clock_rtt_ms=self.clock_rtt_ms,
                    decisions=decisions.heartbeat_payload(), pid=os.getpid())


def _span(name, t0, t1, cid, **args):
    """One span of this thread, a flat dict that crosses the wire."""
    span = {'name': name, 't0': t0, 't1': t1, 'pid': os.getpid(),
            'tid': threading.get_ident(), 'cid': cid}
    if args:
        span['args'] = args
    return span

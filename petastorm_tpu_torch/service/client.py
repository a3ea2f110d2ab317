"""The data service's client: :class:`ServiceDataLoader`.

Counterpart of ``petastorm_tpu/service/client.py``.  A peer of :class:`petastorm_tpu_torch.gpu.DataLoader`
whose reader is the service instead of a local decode pool: the connection
subscribes to every registered decode worker (rotated by consumer index so
that hosts spread their first pulls), pulls serialized chunks under
credit-based backpressure, and commits whole splits:

* a split's chunks buffer until the worker's ``end`` marker: a worker that
  dies mid-split leaves a partial buffer that is dropped, never half a
  split delivered;
* a complete split is acked to its worker (which only then reports
  ``complete``) and deduped by split id, so a split streamed again after a
  lease moved is delivered exactly once;
* ``ordered=True`` releases splits in ascending split id; the default
  releases them as workers finish.  Rows within a split follow the
  worker's split reader, so a fully fixed order also needs
  ``reader_kwargs={'workers_count': 1}`` in the job's config.

Resume follows the loaders' contract, ``state_dict()`` -> ``resume_state=``:
the service part of the token is the set of split ids this consumer
committed, its tenant and the partition geometry's fingerprint.  Resuming
against a fresh service run retires those splits at the dispatcher, and the
loader restores the residue below a split (partial batches, buffered
chunks) as the local loaders do.

On a shared fleet, :func:`register_tenant_job` adds a tenant's job to a
running dispatcher (waiting out an admission refusal with backoff) and
``ServiceDataLoader(tenant=...)`` consumes it.  The client rides through a
dispatcher outage: its discovery polls back off and retry, and a dispatcher
restarted from its ledger serves the rest of the epoch; a split such a
dispatcher retired before the restart, which this connection holds no token
for, raises rather than waits.

With a ``trace_recorder`` each wait for a split is a ``service/split_wait``
span, and the spans the workers ship on a split's ``end`` header merge into
the same trace on this process's clock: the discovery poll is a clock
handshake with the dispatcher (an EWMA of the offset), and each worker's
offset to the dispatcher comes with the poll's reply.  A split's provenance
record (the ``end`` header's) is moved onto this clock the same way and
journaled by the loader, its ``client_buffer`` stage the split's wait in
this client; a record that cannot be placed (no offsets yet from a worker
on another clock) is dropped, not journaled with a made-up latency.
"""

import logging
import os
import pickle
import queue
import sys
import threading
import time

from petastorm_tpu_torch.errors import ServiceError
from petastorm_tpu_torch.gpu.loader import DataLoader
from petastorm_tpu_torch.service import backoff, tenancy
from petastorm_tpu_torch.service.worker import _Rpc, deserialize_chunk
from petastorm_tpu_torch.telemetry import provenance
from petastorm_tpu_torch.telemetry.spans import merge_into_recorder

logger = logging.getLogger(__name__)


class _ServiceConnection(object):
    """One consumer's connection: dispatcher RPCs and a DEALER per worker."""

    def __init__(self, dispatcher_addr, consumer=None, resume=None, ordered=False,
                 queue_splits=4, credits=None, rpc_timeout_s=20.0, trace_recorder=None,
                 tenant=None):
        import zmq

        self._zmq = zmq
        self._dispatcher_addr = dispatcher_addr
        #: the tenant whose job this connection consumes; None asks for the
        #: dispatcher's own job
        self.tenant = None if tenant is None else str(tenant)
        self._context = zmq.Context()
        self._rpc_timeout_s = rpc_timeout_s
        #: a TraceRecorder: each wait for a split is a span in it, and the
        #: workers' spans merge into it
        self._trace = trace_recorder
        #: (this clock - the dispatcher's), an EWMA over the discovery polls
        self.clock_offset = None
        #: worker data address -> (its clock - the dispatcher's)
        self.worker_offsets = {}
        self._labeled_pids = set()
        #: the workers' spans merged into the trace
        self.spans_merged = 0
        self._shm_probe = None
        try:
            self._init(consumer, resume or {}, ordered, queue_splits, credits)
        except Exception:
            from petastorm_tpu_torch.workers_pool import shm_plane
            shm_plane.remove_probe(self._shm_probe)
            self._context.term()
            raise

    def _init(self, consumer, resume, ordered, queue_splits, credits):
        from petastorm_tpu_torch.workers_pool import shm_plane

        rpc = _Rpc(self._context, self._dispatcher_addr, timeout_s=self._rpc_timeout_s)
        try:
            request = {'op': 'job'}
            if self.tenant is not None:
                request['tenant'] = self.tenant
            self.job = rpc.call(request)['job']
        finally:
            rpc.close()
        # the job's own tenant: subscribes and tokens carry it
        self.tenant = str(self.job.get('tenant') or tenancy.DEFAULT_TENANT)
        if consumer is None:
            consumer = _default_consumer(self.job['num_consumers'])
        if not 0 <= consumer < self.job['num_consumers']:
            raise ServiceError('consumer must be in [0, %d), got %r'
                               % (self.job['num_consumers'], consumer))
        self.consumer = int(consumer)
        # the geometry first: a foreign token's split ids index another
        # partition, and mark_consumed would retire live splits of this job
        _check_resume_geometry(resume, self)
        self._credits = int(credits if credits is not None else self.job['credits'])
        self._ordered = bool(ordered)
        # a tenant's splits start at its split_base; the consumer shard is
        # over the job's own index
        base = int(self.job.get('split_base', 0))
        self._my_splits = [base + i for i in range(self.job['num_splits'])
                           if i % self.job['num_consumers'] == self.consumer]
        # same-host delivery: a probe file in /dev/shm whose sight proves to
        # a worker that its descriptors map here
        if self.job.get('shm', True) and shm_plane.available():
            try:
                self._shm_probe = shm_plane.make_probe()
            except OSError as e:
                logger.warning('cannot create the shm probe (%s); delivery takes the byte path',
                               e)
        self.shm_chunks = 0
        self.byte_chunks = 0
        self.retry_attempts = 0
        self.consumed = set(int(s) for s in resume.get('consumed') or ())
        unknown = self.consumed - set(self._my_splits)
        if unknown:
            raise ServiceError('resume token holds split ids %s that do not belong to '
                               'consumer %d of this job' % (sorted(unknown)[:5], self.consumer))
        if self.consumed:
            rpc = _Rpc(self._context, self._dispatcher_addr, timeout_s=self._rpc_timeout_s)
            try:
                rpc.call({'op': 'mark_consumed', 'split_ids': sorted(self.consumed)})
            finally:
                rpc.close()
        #: complete splits for the reader: (split_id, [chunk dicts], record or
        #: None).  Bounded:
        #: a full queue stops the receiver reading its sockets, which stops
        #: the credits, which stalls the workers.
        self._ready = queue.Queue(maxsize=max(1, int(queue_splits)))
        self._error = None
        self._ended = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop, name='service-client-recv',
                                        daemon=True)
        self._thread.start()

    # -- consumption (the reader's thread) -----------------------------------

    def next_split(self):
        """The next complete split not yet delivered, ``(split_id, chunks,
        record)``;
        None at the end of the stream.  A receive loop that failed raises
        here.  With a trace recorder the wait is a ``service/split_wait``
        span."""
        t_wait = time.monotonic()
        item = self._next_split()
        if self._trace is not None:
            self._trace.event('service/split_wait', t_wait, time.monotonic())
        return item

    def _next_split(self):
        while True:
            if self._ended.is_set() and self._ready.empty():
                if self._error is not None:
                    raise ServiceError('service receive loop died: %s: %s'
                                       % (type(self._error).__name__, self._error))
                return None
            try:
                return self._ready.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return None

    def drain_ready(self):
        """Every split buffered here now (the service's part of a loader's
        exact snapshot)."""
        drained = []
        while True:
            try:
                drained.append(self._ready.get_nowait())
            except queue.Empty:
                return drained

    def commit(self, split_id):
        self.consumed.add(int(split_id))

    def stop(self):
        self._stop.set()

    def join(self):
        self._thread.join()
        self._context.term()

    # -- receive loop --------------------------------------------------------

    def _recv_loop(self):
        from petastorm_tpu_torch.workers_pool import shm_plane

        zmq = self._zmq
        rpc = _Rpc(self._context, self._dispatcher_addr, timeout_s=self._rpc_timeout_s)
        sockets = {}            # worker data addr -> DEALER
        addr_of = {}            # DEALER -> worker data addr (whose spans)
        poller = zmq.Poller()
        buffers = {}            # (split_id, attempt) -> {seq: (tag, payload)}
        received = set(self.consumed)
        remaining = set(self._my_splits) - received
        held = {}               # ordered mode: complete splits awaiting their turn
        order = [sid for sid in self._my_splits if sid not in received]
        next_refresh = 0.0
        discovery_retry = None
        try:
            while remaining and not self._stop.is_set():
                now = time.monotonic()
                if now >= next_refresh:
                    try:
                        t_rpc0 = time.monotonic()
                        reply = rpc.call({'op': 'workers'})
                        self._update_clocks(reply, t_rpc0, time.monotonic())
                        workers = reply['workers']
                        discovery_retry = None
                        next_refresh = now + backoff.jittered(1.0, 0.2)
                    except ServiceError:
                        workers, reply = [], {}
                        discovery_retry = discovery_retry or backoff.DISCOVERY_POLICY.episode()
                        self.retry_attempts += 1
                        next_refresh = now + discovery_retry.next_delay()
                    failed = set(reply.get('failed_splits') or ()) & remaining
                    if failed:
                        raise ServiceError('split(s) %s of consumer %d failed every decode '
                                           'attempt at the dispatcher'
                                           % (sorted(failed)[:5], self.consumer))
                    stale = set(reply.get('retired_splits') or ()) & remaining
                    if stale:
                        # a dispatcher restored from its ledger retired these
                        # before the restart; they will not stream again
                        raise ServiceError('split(s) %s of consumer %d were delivered and '
                                           'retired before this dispatcher restarted (restored '
                                           'ledger): resume with the matching token, or point '
                                           'the dispatcher at a fresh ledger_path for a fresh '
                                           'epoch' % (sorted(stale)[:5], self.consumer))
                    # consumer c starts its pulls at worker c % W
                    if workers:
                        c = self.consumer % len(workers)
                        workers = workers[c:] + workers[:c]
                    for worker in workers:
                        addr = worker['addr']
                        if addr in sockets:
                            continue
                        sock = self._context.socket(zmq.DEALER)
                        sock.setsockopt(zmq.LINGER, 0)
                        sock.set_hwm(0)
                        sock.connect(addr)
                        sock.send(pickle.dumps({'type': 'subscribe', 'consumer': self.consumer,
                                                'tenant': self.tenant,
                                                'credits': self._credits,
                                                'shm_probe': self._shm_probe}, protocol=4))
                        sockets[addr] = sock
                        addr_of[sock] = addr
                        poller.register(sock, zmq.POLLIN)
                for sock in dict(poller.poll(100)):
                    while True:
                        try:
                            frames = sock.recv_multipart(zmq.NOBLOCK)
                        except zmq.Again:
                            break
                        header = pickle.loads(frames[0])
                        sid, attempt = int(header['split']), int(header['attempt'])
                        if header['type'] == 'chunk':
                            # the credit goes back at once: chunks in flight
                            # stay within the window; backpressure comes from
                            # this loop blocking on a full ready queue
                            sock.send(pickle.dumps({'type': 'credit', 'n': 1}, protocol=4))
                            if sid in received:
                                # a duplicate stream; a dropped shm descriptor
                                # must still return its slab
                                if header['tag'] == b'S':
                                    shm_plane.release_descriptor(pickle.loads(frames[1]))
                                continue
                            if header['tag'] == b'S':
                                # map now: the arrays are views of the slab,
                                # which returns to its writer when they die
                                try:
                                    chunk = shm_plane.read_payload(pickle.loads(frames[1]))
                                except shm_plane.SegmentVanishedError:
                                    continue   # the count at 'end' asks for a resend
                                self.shm_chunks += 1
                                buffers.setdefault((sid, attempt), {})[int(header['seq'])] = \
                                    ('shm', chunk)
                                continue
                            buffers.setdefault((sid, attempt), {})[int(header['seq'])] = \
                                (header['tag'], frames[1])
                        elif header['type'] == 'end':
                            if sid in received:
                                # a duplicate stream: ack again so that the
                                # worker's bookkeeping settles
                                sock.send(pickle.dumps({'type': 'ack', 'split': sid,
                                                        'attempt': attempt}, protocol=4))
                                continue
                            parts = buffers.get((sid, attempt), {})
                            if len(parts) != int(header['chunks']):
                                # chunks lost: no ack (the worker would report
                                # rows we never got); ask for the split again
                                logger.warning('split %d attempt %d: %d/%d chunks; requesting '
                                               'a resend', sid, attempt, len(parts),
                                               int(header['chunks']))
                                buffers.pop((sid, attempt), None)
                                sock.send(pickle.dumps({'type': 'resend', 'split': sid,
                                                        'attempt': attempt}, protocol=4))
                                continue
                            sock.send(pickle.dumps({'type': 'ack', 'split': sid,
                                                    'attempt': attempt}, protocol=4))
                            self._merge_worker_spans(header, addr_of.get(sock))
                            record = self._align_provenance(header, addr_of.get(sock))
                            chunks = []
                            for i in sorted(parts):
                                tag, payload = parts[i]
                                if tag == 'shm':
                                    chunks.append(payload)
                                else:
                                    self.byte_chunks += 1
                                    chunks.append(deserialize_chunk(tag, payload))
                            received.add(sid)
                            remaining.discard(sid)
                            for key in [k for k in buffers if k[0] == sid]:
                                del buffers[key]
                            if self._ordered:
                                held[sid] = (chunks, record)
                                while order and order[0] in held:
                                    nxt = order.pop(0)
                                    self._put((nxt,) + held.pop(nxt))
                            else:
                                self._put((sid, chunks, record))
        except Exception as e:  # noqa: BLE001 — raised again in next_split
            self._error = e
        finally:
            self._ended.set()
            rpc.close()
            # a clean end: the last ack may still sit in ZeroMQ's queue, and
            # a zero-linger close would drop it
            linger_ms = 0 if self._stop.is_set() else 1000
            for sock in sockets.values():
                sock.close(linger_ms)
            shm_plane.remove_probe(self._shm_probe)
            if self._shm_probe is not None:
                # the slabs of a writer killed with descriptors in flight
                shm_plane.sweep_orphans()

    #: the weight of each new poll in the clock offset's EWMA
    _CLOCK_EWMA_ALPHA = 0.2

    def _update_clocks(self, reply, t0, t1):
        """Fold the discovery poll's handshake into :attr:`clock_offset`, and
        take each worker's offset from its reply."""
        if reply.get('t_mono') is not None:
            estimate = (t0 + t1) / 2.0 - float(reply['t_mono'])
            alpha = self._CLOCK_EWMA_ALPHA
            self.clock_offset = estimate if self.clock_offset is None \
                else (1.0 - alpha) * self.clock_offset + alpha * estimate
        for worker in reply.get('workers') or ():
            if worker.get('clock_offset') is not None:
                self.worker_offsets[worker['addr']] = float(worker['clock_offset'])

    def _merge_worker_spans(self, header, addr):
        """Put a split's worker spans on this process's timeline, shifted by
        the chained offsets ((client - dispatcher) - (worker - dispatcher));
        0 until both are known (right between processes of one host, whose
        monotonic clocks agree)."""
        spans = header.get('spans')
        if not spans or self._trace is None:
            return
        shift = 0.0
        worker_offset = self.worker_offsets.get(addr)
        if self.clock_offset is not None and worker_offset is not None:
            shift = self.clock_offset - worker_offset
        pid = spans[0].get('pid')
        if pid is not None and pid not in self._labeled_pids:
            self._labeled_pids.add(pid)
            if pid != os.getpid():   # a worker thread of this process shares its track
                self._trace.set_process_label(pid, 'service worker %s' % (addr or '?'))
        self.spans_merged += merge_into_recorder(self._trace, spans, clock_offset_s=shift)

    def _align_provenance(self, header, addr):
        """The split's record with its stage windows moved onto this
        process's clock (the chained offsets of
        :meth:`_merge_worker_spans`), stamped with its receipt.  A latency
        is computed from these windows, so a record still far from this
        client's present after the shift (a worker on another host whose
        offset has not arrived) is dropped: journaled, it would carry the
        hosts' boot skew as its latency.  A worker on this host shares the
        clock and passes unshifted."""
        record = header.get('provenance')
        if record is None or not provenance.enabled():
            return None
        now = time.monotonic()
        worker_offset = self.worker_offsets.get(addr)
        if self.clock_offset is not None and worker_offset is not None:
            record = provenance.shift_stages(record, self.clock_offset - worker_offset)
        stages = record.get('stages') or {}
        latest = max((w[1] for w in stages.values()), default=now)
        if abs(now - latest) > 60.0:
            return None
        record['_received_t'] = now
        return record

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._ready.put(item, timeout=0.2)
                return
            except queue.Full:
                continue


def register_tenant_job(dispatcher_addr, tenant, config_kwargs, weight=1.0, rpc_timeout_s=20.0,
                        max_wait_s=120.0):
    """Register ``tenant``'s job on a running dispatcher: its splits join the
    fleet's, served by every registered worker under the fair-share
    schedule.  ``config_kwargs`` are :class:`~petastorm_tpu_torch.service.
    config.ServiceConfig`'s keywords (``dataset_url`` at least).

    A refusal at the admission cap (``max_tenant_jobs``) carries
    ``retry_after_s``: this waits it out with jittered backoff for up to
    ``max_wait_s``, then raises :class:`ServiceError`; any other refusal
    (the tenant registered already, a bad config) raises at once.  Returns
    the job's ``job_info`` (``split_base``, ``num_splits``, ...), which a
    :class:`ServiceDataLoader` with ``tenant=`` consumes."""
    import zmq

    context = zmq.Context()
    try:
        rpc = _Rpc(context, dispatcher_addr, timeout_s=rpc_timeout_s)
        try:
            deadline = time.monotonic() + max_wait_s
            while True:
                reply = rpc.call({'op': 'register_job', 'tenant': str(tenant),
                                  'weight': float(weight), 'config': dict(config_kwargs)},
                                 raw=True)
                if isinstance(reply, dict) and reply.get('job') is not None:
                    return reply['job']
                error = (reply or {}).get('error', 'malformed reply')
                retry_after = (reply or {}).get('retry_after_s')
                if retry_after is None:
                    raise ServiceError('dispatcher %s refused tenant %r job: %s'
                                       % (dispatcher_addr, tenant, error))
                delay = backoff.jittered(float(retry_after), 0.25)
                if time.monotonic() + delay > deadline:
                    raise ServiceError('dispatcher %s still refusing tenant %r job after %.0fs '
                                       '(%s): raise max_tenant_jobs or retire a finished job'
                                       % (dispatcher_addr, tenant, max_wait_s, error))
                time.sleep(delay)
        finally:
            rpc.close()
    finally:
        context.term()


def _default_consumer(num_consumers):
    """This training host's index: the ``torch.distributed`` rank modulo
    ``num_consumers`` in a group of more than one rank, else 0 (torch is not
    imported for it: a process that has not loaded ``torch.distributed`` has
    no group)."""
    dist = sys.modules.get('torch.distributed')
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank() % num_consumers
    return 0


class ServiceReader(object):
    """A reader over a service connection: the surface
    :class:`~petastorm_tpu_torch.gpu.DataLoader` uses (iteration,
    ``batched_output``, ``stop``/``join``, ``drain_in_flight``,
    ``resume_dispatch``, ``state_dict``), yielding column chunk dicts.  A
    split is committed the moment its chunks enter the loader: from then on
    the loader's own snapshot carries what it has not yielded, which makes
    the combined token exact."""

    batched_output = True
    ngram = None
    num_epochs = 1

    def __init__(self, connection):
        self._conn = connection
        self._current = []
        #: the records of the splits adopted since the loader last took them
        self._pending_provenance = []
        self.last_row_consumed = False

    @property
    def job(self):
        return self._conn.job

    @property
    def consumer(self):
        return self._conn.consumer

    def __iter__(self):
        return self

    def __next__(self):
        while not self._current:
            item = self._conn.next_split()
            if item is None:
                self.last_row_consumed = True
                raise StopIteration
            split_id, chunks, record = item
            self._conn.commit(split_id)
            self._current = list(chunks)
            self._adopt_provenance(record)
        return self._current.pop(0)

    def _adopt_provenance(self, record):
        """Keep a split's record as its chunks enter the loader, with its
        ``client_buffer`` stage (receipt until now)."""
        if record is None:
            return
        received = record.pop('_received_t', None)
        now = time.monotonic()
        if received is not None and now > received:
            record.setdefault('stages', {})['client_buffer'] = [received, now]
        self._pending_provenance.append(record)
        del self._pending_provenance[:-64]

    def take_provenance(self):
        """The records of the splits adopted since the last call (the
        surface ``Reader.take_provenance`` has)."""
        out = list(self._pending_provenance)
        self._pending_provenance = []
        return out

    def drain_in_flight(self):
        drained = list(self._current)
        self._current = []
        for split_id, chunks, record in self._conn.drain_ready():
            self._conn.commit(split_id)
            self._adopt_provenance(record)
            drained.extend(chunks)
        return drained

    def resume_dispatch(self):
        pass   # dispatch is remote; nothing was paused

    def state_dict(self):
        return {'service': {
            'version': 1,
            'consumer': self._conn.consumer,
            'tenant': self._conn.tenant,
            'consumed': sorted(self._conn.consumed),
            'num_splits': self._conn.job['num_splits'],
            'num_consumers': self._conn.job['num_consumers'],
            'fingerprint': self._conn.job['fingerprint'],
        }}

    @property
    def diagnostics(self):
        return {'shm_chunks': self._conn.shm_chunks, 'byte_chunks': self._conn.byte_chunks,
                'retry_attempts': self._conn.retry_attempts,
                'spans_merged': self._conn.spans_merged,
                'clock_offset_s': self._conn.clock_offset,
                'worker_clock_offsets_s': dict(self._conn.worker_offsets)}

    def stop(self):
        self._conn.stop()

    def join(self):
        self._conn.join()


class ServiceDataLoader(DataLoader):
    """A :class:`~petastorm_tpu_torch.gpu.DataLoader` fed by the data service.

    The loader's keywords (``batch_size``, ``transform_fn``, ``drop_last``,
    ``prefetch``, ``device``, ``sharding``, ``shuffling_queue_capacity``,
    ``seed``, ``transfer``, ``echo``, ``trace_recorder``, ``resume_state``)
    work as there, with the service in place of the reader, plus:

    Args:
        dispatcher_addr: the dispatcher's endpoint (``tcp://host:port``).
        consumer: this host's consumer shard; default the
            ``torch.distributed`` rank modulo ``num_consumers`` in a group
            of more than one rank, else 0.
        ordered: release splits in split-id order instead of as they
            complete.
        queue_splits / credits / rpc_timeout_s: the client's flow control;
            ``credits`` defaults to the job's window.
        tenant: the tenant whose job to consume on a shared fleet (register
            it first with :func:`register_tenant_job`); None consumes the
            dispatcher's own job, or the resume token's tenant's.

    Resume tokens round-trip through ``state_dict()``, the committed split
    ids in place of the ventilator's position.
    """

    def __init__(self, dispatcher_addr, batch_size, consumer=None, ordered=False,
                 queue_splits=4, credits=None, rpc_timeout_s=20.0, resume_state=None,
                 tenant=None, **kwargs):
        svc = ((resume_state or {}).get('reader') or {}).get('service') or {}
        if svc and consumer is None:
            consumer = svc.get('consumer')
        if svc and tenant is None:
            tenant = svc.get('tenant')
        connection = _ServiceConnection(dispatcher_addr, consumer=consumer, resume=svc,
                                        ordered=ordered, queue_splits=queue_splits,
                                        credits=credits, rpc_timeout_s=rpc_timeout_s,
                                        trace_recorder=kwargs.get('trace_recorder'),
                                        tenant=tenant)
        try:
            super(ServiceDataLoader, self).__init__(ServiceReader(connection), batch_size,
                                                    resume_state=resume_state, **kwargs)
        except Exception:
            connection.stop()
            connection.join()
            raise

    def service_diagnostics(self):
        """The fleet's metrics (the dispatcher's ``stats``): split states,
        lease churn, each worker's rows/s and shm against byte chunks, and
        this client's own shm and byte chunk counts under ``'client'``.
        Also after the loader closed."""
        import zmq
        conn = self.reader._conn
        context = zmq.Context()   # its own: the loader may have closed the connection's
        try:
            rpc = _Rpc(context, conn._dispatcher_addr, timeout_s=conn._rpc_timeout_s)
            try:
                stats = rpc.call({'op': 'stats'})
            finally:
                rpc.close()
        finally:
            context.term()
        stats['client'] = self.reader.diagnostics
        return stats


def _check_resume_geometry(svc, connection):
    """A token's split ids index one partition geometry: a token of another
    (dataset, split size, consumer count) raises, as the readers'
    topology check does."""
    if not svc:
        return
    mismatches = [key for key, current in (
        ('fingerprint', connection.job['fingerprint']),
        ('num_splits', connection.job['num_splits']),
        ('num_consumers', connection.job['num_consumers']),
        ('consumer', connection.consumer),
        ('tenant', connection.tenant))
        if svc.get(key) is not None and svc[key] != current]
    if mismatches:
        raise ServiceError('resume token was taken under a different service job '
                           '(mismatched: %s): its split ids do not index this partition '
                           'geometry' % ', '.join(mismatches))

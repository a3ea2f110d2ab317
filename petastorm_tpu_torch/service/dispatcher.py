"""Control plane of the data service.

Counterpart of ``petastorm_tpu/service/dispatcher.py``.  The dispatcher
never touches row data.  It enumerates each job's row groups once, cuts
them into splits (``ServiceConfig.rowgroups_per_split`` consecutive groups
each; split ``i`` of a job owned by its consumer ``i % num_consumers``),
and serves short pickled RPCs on one REP socket:

  ``register_worker`` a worker announces its data-plane address -> worker_id
  ``register_job``    another tenant's job joins the fleet
  ``clock``           a bare clock handshake
  ``heartbeat``       liveness, metrics, cache digests; renews the leases
                      the worker holds (and adopts restored ones it claims)
  ``lease``           hand out one pending split under a TTL lease
  ``complete``        a worker finished a split (its client acked it)
  ``mark_consumed``   a resuming client retires the splits its token holds
  ``drain``           ask one worker to drain (through its next heartbeat reply)
  ``release``         a draining worker hands back a split it never started
  ``deregister``      a drained worker leaves
  ``job`` / ``workers`` / ``stats``  discovery and metrics (``job`` per tenant)
  ``stop``            remote shutdown

Lease expiry is the failure path: a worker that stops heartbeating has its
leases returned to their tenant's pending queue (attempt + 1) on the next
turn of the serve loop, exactly once.  A split is always in exactly one of
pending, leased, done or failed; a split whose lease expired
``max_split_attempts`` times is failed, which the clients see on their
discovery poll.  A late ``complete`` from a worker presumed dead is
rejected once the split moved on.  Exactly-once delivery is finished on the
client (whole-split commit, dedupe by split id).

Tenants (:mod:`~petastorm_tpu_torch.service.tenancy`): the constructor's
config is the default tenant's job; ``register_job`` appends another
tenant's splits to the global split-id space at ``split_base``.  A lease
picks the tenant first (weighted deficit round-robin over the tenants with
a split for the asking worker), then the split within it.

The ledger (``ledger_path``, :mod:`~petastorm_tpu_torch.service.ledger`)
persists every transition: a restarted dispatcher keeps done splits done
and attempt counts, rebuilds the tenant table, and restores leased splits
as orphan leases, which a re-registering worker's ``held`` claim adopts,
or which requeue with their attempt intact after one TTL.

The cluster cache (``cluster_cache``, :mod:`~petastorm_tpu_torch.service.cluster`):
workers advertise the digests their plane holds; the dispatcher keeps the
directory, prefers a split's holder when it leases, keeps a held split
back from a cold worker for at most ``_AFFINITY_DEFER_S`` (never a split
requeued by an expiry), and names the holders in the lease reply for peer
fill.  The directory is advisory: a stale entry costs one deferral.

The autoscaler (``autoscale``, :mod:`~petastorm_tpu_torch.service.autoscaler`)
ticks in the serve loop: it observes the split states and the live workers
under the lock and acts outside it, spawning workers through its launcher or
draining the worker with the least cache coverage.  Every decision of the
dispatcher's control laws (the autoscaler, the tenant scheduler, affinity
routing) is a record of its journal
(:class:`~petastorm_tpu_torch.telemetry.decisions.DecisionJournal`), which
the ledger persists; ``stats`` rolls it up with the workers' journals, and
the ``decisions`` RPC returns it whole.  Registration, heartbeats, ``clock``
and ``workers`` replies carry the dispatcher's ``time.monotonic()``: the
clock handshakes that put the workers' spans on a client's timeline.

The fleet's flight recorder (:attr:`Dispatcher.flight`) ticks in the serve
loop over the fleet snapshot (the workers' heartbeat registries merged,
with the split states, lease churn, the control plane's counters and each
tenant's grants) and is persisted when the loop exits (under
``PETASTORM_TPU_FLIGHT_DIR``).  ``stats`` carries the fleet's health
(:func:`~petastorm_tpu_torch.telemetry.health.health_report` over the
current snapshot against the ring's frame about 60 s back), whose scores
are also gauges of :attr:`Dispatcher.metrics`; each tenant's row gains its
grants in that window (``grants_delta``), and each stage the one summary
(:func:`~petastorm_tpu_torch.telemetry.registry.summarize_hist`).

With a :class:`~petastorm_tpu_torch.materialize.MaterializeController`
attached (:meth:`Dispatcher.attach_materializer`), an autoscaler's scale-in
victim is first offered to it for one bounded warming pass: its drain is
deferred until the pass ends or ``DRAIN_WARM_DEADLINE_S`` passes, and
``materialize_handoffs`` counts the victims handed over.
"""

import collections
import dataclasses
import logging
import pickle
import threading
import time

from petastorm_tpu_torch.service import tenancy as _tenancy
from petastorm_tpu_torch.telemetry import decisions as _decisions
from petastorm_tpu_torch.telemetry import health
from petastorm_tpu_torch.telemetry.flight import (FlightRecorder, default_persist_path,
                                                  window_frames)
from petastorm_tpu_torch.telemetry.registry import (MetricsRegistry, merge_snapshots,
                                                    snapshot_delta, summarize_hist)

logger = logging.getLogger(__name__)

_PENDING, _LEASED, _DONE, _FAILED = 'pending', 'leased', 'done', 'failed'

#: Cache-affinity leasing, bounded: it may reorder pending work, never delay
#: it without bound.  The pending splits one lease call looks at:
_AFFINITY_SCAN = 64
#: a worker holds a split when it advertises this share of its digests:
_AFFINITY_MIN_COVERAGE = 0.5
#: and a split another live worker holds is kept back from a cold worker
#: for at most this long (and a fifth of the lease TTL).  A split requeued
#: by an expiry (attempt > 0) is never kept back.
_AFFINITY_DEFER_S = 2.0


class Split(object):
    """One leasable unit of decode work: consecutive row-group indices of
    one tenant's job."""

    __slots__ = ('split_id', 'indices', 'consumer', 'attempt', 'state', 'worker_id',
                 'lease_expires', 'affinity_defer_until', 'tenant')

    def __init__(self, split_id, indices, consumer, tenant=_tenancy.DEFAULT_TENANT):
        self.split_id = split_id
        self.indices = list(indices)
        self.consumer = consumer
        self.tenant = tenant
        self.attempt = 0
        self.state = _PENDING
        self.worker_id = None
        self.lease_expires = 0.0
        #: the end of this split's affinity window (set at its first
        #: deferral, cleared at its grant)
        self.affinity_defer_until = None

    def describe(self):
        return {'split_id': self.split_id, 'indices': list(self.indices),
                'consumer': self.consumer, 'attempt': self.attempt, 'tenant': self.tenant}


def build_splits(num_pieces, rowgroups_per_split, num_consumers, split_base=0,
                 tenant=_tenancy.DEFAULT_TENANT):
    """Cut ``num_pieces`` row groups into :class:`Split` objects.

    Consecutive grouping keeps each split's reads sequential on disk.  The
    ids start at ``split_base`` (a tenant's slice of the global id space);
    the consumer of a split is its index within its job modulo
    ``num_consumers``, so each job's consumers own disjoint, covering sets."""
    splits = []
    for start in range(0, num_pieces, rowgroups_per_split):
        local = len(splits)
        indices = range(start, min(start + rowgroups_per_split, num_pieces))
        splits.append(Split(split_base + local, indices, local % num_consumers, tenant=tenant))
    return splits


class Dispatcher(object):
    """Serve the control plane of one fleet, on a thread::

        config = ServiceConfig('file:///data/train', num_consumers=2)
        with Dispatcher(config, bind='tcp://127.0.0.1:*') as d:
            ...  # workers and clients connect to d.addr

    ``bind`` may end in ``:*`` (or ``:0``) to take a free TCP port; the
    address is then ``.addr``.  ``trace_recorder`` (a
    :class:`~petastorm_tpu_torch.benchmark.TraceRecorder`) gets an instant
    for every lease grant, expiry and completion.  With
    ``config.ledger_path`` the constructor takes the ledger's owner lock
    (:class:`~petastorm_tpu_torch.service.ledger.LedgerHeldError` when a
    live dispatcher holds it) and restores from it.  With ``config.autoscale``
    the autoscaler acts through ``launcher`` (a
    :class:`~petastorm_tpu_torch.service.autoscaler.WorkerLauncher`; None:
    worker processes of the command line).
    """

    def __init__(self, config, bind='tcp://127.0.0.1:*', num_pieces=None, trace_recorder=None,
                 launcher=None):
        from petastorm_tpu_torch.service import cluster as _cluster
        self._config = config
        self._bind = bind
        self._trace = trace_recorder
        if num_pieces is None:
            num_pieces = _count_row_groups(config.dataset_url)
        if num_pieces < 1:
            raise ValueError('dataset %r has no row groups' % (config.dataset_url,))
        self._num_pieces = int(num_pieces)
        self._splits = build_splits(num_pieces, config.rowgroups_per_split,
                                    config.num_consumers, tenant=config.tenant)
        self._job = config.job_info(len(self._splits))
        # the constructor's config is the default tenant's job
        self._default_tenant = config.tenant
        self._tenants = _tenancy.TenantRegistry(max_jobs=config.max_tenant_jobs)
        self._scheduler = _tenancy.TenantScheduler()
        default_job = _tenancy.TenantJob(config.tenant, config.tenant_weight, config, self._job,
                                         split_base=0, num_splits=len(self._splits),
                                         num_pieces=self._num_pieces,
                                         registered_t=time.monotonic())
        default_job.pending = collections.deque(self._splits)
        self._tenants.admit(default_job)
        self._workers = {}   # worker_id -> {'addr', 'last_heartbeat', 'stats', 'draining'}
        self._next_worker_id = 0
        self.lease_churn = 0
        #: graceful drains completed, and those that overran their deadline
        self.drains = 0
        self.drain_timeouts = 0
        # -- the cluster cache's directory (advisory) --
        #: worker_id -> the compact digests its plane holds
        self._worker_digests = {}
        #: global piece index -> compact digest, from the first worker whose
        #: identity resolved
        self._piece_digests = None
        #: workers whose piece map had the wrong length: declined for good
        self._piece_digests_declined = set()
        self._cluster_on = bool(self._job.get('cluster_cache')) and not _cluster.killed()
        #: leases granted to a worker holding the split, and lease calls
        #: answered 'wait' because every scanned split was kept back
        self.affinity_routed = 0
        self.affinity_deferrals = 0
        # -- the ledger --
        #: restarts of this ledger's lineage, orphan leases adopted by held
        #: claims, orphans requeued with their attempt intact
        self.ledger_restores = 0
        self.ledger_adoptions = 0
        self.ledger_requeues = 0
        self._ledger = None
        self._ledger_dirty = False
        #: data address -> digests restored from the ledger, until that
        #: worker registers again
        self._ledger_digests_by_addr = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._started = threading.Event()
        self.addr = None
        #: the fleet's flight recorder: its frames are fleet snapshots, ticked
        #: by the serve loop; two frames subtract into the window ``stats``'
        #: health reads
        self.flight = FlightRecorder(source=self._fleet_snapshot, label='dispatcher_fleet',
                                     persist_path=default_persist_path('dispatcher'))
        #: the health gauges, for a scrape of the dispatcher's process
        self.metrics = MetricsRegistry('dispatcher')
        # the journal of the dispatcher's control laws: a record marks the
        # ledger dirty, so the next serve-loop turn persists it
        self._decisions = _decisions.DecisionJournal(label='dispatcher')
        self._decisions.on_record = lambda rec: self._ledger_mark()
        self._scheduler.decisions = self._decisions
        self.autoscaler = None
        if config.autoscale:
            from petastorm_tpu_torch.service import autoscaler as _autoscaler
            if launcher is None:
                launcher = _autoscaler.SubprocessWorkerLauncher()
            self.autoscaler = _autoscaler.Autoscaler(config, launcher)
            self.autoscaler.decisions = self._decisions
        # scale-in victims offered to an attached materializer for one
        # bounded warming pass before their drain
        self._materializer = None
        self._deferred_drains = {}   # victim worker id -> drain deadline
        self.materialize_handoffs = 0
        if config.ledger_path:
            from petastorm_tpu_torch.service.ledger import DispatcherLedger
            self._ledger = DispatcherLedger(config.ledger_path).acquire()
            self._restore_from_ledger(self._ledger.load())
            # the file names this incarnation before any worker registers
            self._ledger_save(force=True)

    # -- the durable ledger --------------------------------------------------

    def _restore_from_ledger(self, state):
        """Apply a loaded snapshot, or cold-start on any mismatch: another
        partition geometry, a tenant table that does not rebuild, a split
        list of another length."""
        from petastorm_tpu_torch.service import ledger as _ledger_mod
        from petastorm_tpu_torch.service.config import ServiceConfig
        if state is None:
            return
        if state.get('fingerprint') != self._job['fingerprint']:
            logger.warning('ledger %s was written under another partition geometry '
                           '(fingerprint mismatch); cold start', self._ledger.path)
            return
        # the tenant table (version 2) first, staged: any rejection
        # cold-starts whole; a version 1 file has none
        staged, base = [], len(self._splits)
        for entry in state.get('tenants') or ():
            try:
                cfg = ServiceConfig(**_tenancy.config_from_jsonable(entry['config']))
                tenant = str(entry['tenant'])
                if int(entry['split_base']) != base:
                    raise ValueError('split_base %r, expected %d' % (entry['split_base'], base))
                splits = build_splits(int(entry['num_pieces']), cfg.rowgroups_per_split,
                                      cfg.num_consumers, split_base=base, tenant=tenant)
                if len(splits) != int(entry['num_splits']):
                    raise ValueError('rebuilt %d splits, recorded %d'
                                     % (len(splits), entry['num_splits']))
            except Exception as e:  # noqa: BLE001 — rejected whole
                logger.warning('ledger %s tenant table undecodable (%s: %s); cold start',
                               self._ledger.path, type(e).__name__, e)
                return
            job = _tenancy.TenantJob(tenant, float(entry.get('weight', 1.0)), cfg,
                                     dict(cfg.job_info(len(splits)), split_base=base),
                                     split_base=base, num_splits=len(splits),
                                     num_pieces=int(entry['num_pieces']),
                                     registered_t=time.monotonic())
            staged.append((job, splits))
            base += len(splits)
        if len(staged) + 1 > self._tenants.max_jobs:
            logger.warning('ledger %s holds %d tenant jobs, over max_tenant_jobs=%d; cold start',
                           self._ledger.path, len(staged) + 1, self._tenants.max_jobs)
            return
        if int(state.get('num_splits', -1)) != base:
            logger.warning('ledger %s was written under another partition geometry '
                           '(num_splits mismatch); cold start', self._ledger.path)
            return
        try:
            records = _ledger_mod.decode_splits(state['splits'])
        except (KeyError, TypeError, ValueError) as e:
            logger.warning('ledger %s has undecodable split records (%s); cold start',
                           self._ledger.path, e)
            return
        if len(records) != base:
            logger.warning('ledger %s holds %d split records for a %d-split job; cold start',
                           self._ledger.path, len(records), base)
            return
        for job, splits in staged:
            self._splits.extend(splits)
            self._tenants.admit(job)
        now = time.monotonic()
        restored = collections.Counter()
        for split, (split_state, attempt) in zip(self._splits, records):
            split.attempt = attempt
            restored[split_state] += 1
            if split_state in (_DONE, _FAILED):
                split.state = split_state
            elif split_state == _LEASED:
                # an orphan lease: a re-registering worker's held claim
                # adopts it; unclaimed it requeues attempt intact
                split.state = _LEASED
                split.worker_id = None
                split.lease_expires = now + self._config.lease_ttl_s
        for job in self._tenants.jobs():
            job.pending = collections.deque(
                s for s in self._splits[job.split_base:job.split_base + job.num_splits]
                if s.state == _PENDING)
        self._ledger_digests_by_addr = {
            str(addr): {str(d) for d in digests}
            for addr, digests in (state.get('worker_digests') or {}).items()}
        pieces = state.get('piece_digests')
        if self._cluster_on and pieces and len(pieces) == self._num_pieces:
            self._piece_digests = [str(d) for d in pieces]
        # the dead incarnation's decisions come back as they were
        if state.get('decisions'):
            self._decisions.restore(state['decisions'])
        self.ledger_restores = int(state.get('restores', 0)) + 1
        logger.info('ledger %s restored (restart #%d): %d done / %d leased (orphaned) / %d '
                    'pending / %d failed splits, %d worker digest sets', self._ledger.path,
                    self.ledger_restores, restored[_DONE], restored[_LEASED],
                    restored[_PENDING], restored[_FAILED], len(self._ledger_digests_by_addr))

    def _ledger_state(self):
        """The snapshot the ledger saves: the reference's keys (the caller
        does not hold the lock)."""
        from petastorm_tpu_torch.service import ledger as _ledger_mod
        decisions = self._decisions.dump()   # under the journal's own lock
        with self._lock:
            digests = {self._workers[wid]['addr']: sorted(held)
                       for wid, held in self._worker_digests.items() if wid in self._workers}
            for addr, held in self._ledger_digests_by_addr.items():
                digests.setdefault(addr, sorted(held))
            # every tenant but the default (the constructor's config)
            tenants = [{'tenant': job.tenant, 'weight': job.weight,
                        'split_base': job.split_base, 'num_splits': job.num_splits,
                        'num_pieces': job.num_pieces,
                        'config': _tenancy.config_to_jsonable(dataclasses.asdict(job.config))}
                       for job in self._tenants.jobs() if job.split_base > 0]
            return {
                'fingerprint': self._job['fingerprint'],
                'dataset_url': self._config.dataset_url,
                'num_splits': len(self._splits),
                'splits': _ledger_mod.encode_splits(self._splits),
                'worker_digests': digests,
                'piece_digests': self._piece_digests,
                'tenants': tenants,
                'decisions': decisions,
                'restores': self.ledger_restores,
                'saved_unix': time.time(),
            }

    def _ledger_save(self, force=False):
        """Persist when dirty (a serve-loop turn), or now (``force``)."""
        if self._ledger is None or not (force or self._ledger_dirty):
            return
        self._ledger_dirty = False
        if self._ledger.save(self._ledger_state()) is None:
            self._ledger_dirty = True   # ENOSPC and the like: the next turn retries

    def _ledger_mark(self):
        if self._ledger is not None:
            self._ledger_dirty = True

    def _ledger_done(self, split_id):
        """The write-ahead record of a retiring transition: a journal line
        before the reply, a snapshot on the next serve-loop turn."""
        if self._ledger is not None:
            self._ledger.append({'op': 'done', 'split': int(split_id)})
            self._ledger_dirty = True

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
            if self._ledger is not None:
                self._ledger.release()
            self._started.set()   # unblock start(); addr stays None
            raise
        self._started.set()
        poller = zmq.Poller()
        poller.register(socket, zmq.POLLIN)
        try:
            from petastorm_tpu_torch.test_util import chaos
            while not self._stop.is_set():
                self._expire_leases()
                # lease grants and expiries reach the ledger within a turn
                self._ledger_save()
                # one fleet frame an interval, from the loop that runs anyway
                self.flight.maybe_tick()
                # observe under the lock, act outside it
                self._autoscale_tick()
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
                # the chaos seam: a REP socket may not drop a reply (it would
                # wedge), so the fault here is a delay; lost requests are
                # injected on the callers' side ('rpc.request')
                chaos.inject('dispatcher.rpc', op=request.get('op'))
                try:
                    reply = self._dispatch(request)
                except Exception as e:  # noqa: BLE001 — reply, never let the serve thread die
                    logger.exception('dispatcher RPC %r failed', request.get('op'))
                    reply = {'error': '%s: %s' % (type(e).__name__, e)}
                socket.send(pickle.dumps(reply, protocol=4))
                if request.get('op') == 'stop':
                    break
        finally:
            # the ring is the postmortem (when a flight directory is set)
            self.flight.persist(reason='dispatcher_exit')
            self.flight.stop()
            if self.autoscaler is not None:
                # the workers it spawned do not outlive the control plane
                self.autoscaler.close()
            if self._ledger is not None:
                # the last snapshot; the file stays for the next incarnation
                self._ledger_save(force=True)
                self._ledger.release()
            socket.close(0)
            context.term()

    def _fleet_snapshot(self):
        """The fleet's snapshot, the flight recorder's frame source: the
        workers' heartbeat registries merged (cumulative, so two frames
        subtract), the split states and live workers as gauges, and as
        counters the lease churn, the control plane's traffic, each tenant's
        grants (``tenant_grants:<tenant>``) and the autoscaler's actions."""
        with self._lock:
            snaps = [w['stats'].get('registry') for w in self._workers.values()]
            states = collections.Counter(s.state for s in self._splits)
            alive = len(self._workers)
            grants = {job.tenant: job.grants for job in self._tenants.jobs()}
        merged = merge_snapshots(snaps)
        merged['gauges'].update({'splits_pending': states[_PENDING],
                                 'splits_leased': states[_LEASED],
                                 'splits_done': states[_DONE],
                                 'splits_failed': states[_FAILED],
                                 'workers_registered': alive})
        counters = merged['counters']
        counters['lease_churn'] = self.lease_churn
        counters['cache_affinity_routed'] = self.affinity_routed
        counters['ledger_restores'] = self.ledger_restores
        counters['drains'] = self.drains
        counters['drain_timeouts'] = self.drain_timeouts
        counters['materialize_handoffs'] = self.materialize_handoffs
        for tenant, n in grants.items():
            counters['tenant_grants:%s' % tenant] = n
        if self.autoscaler is not None:
            counters['autoscale_outs'] = self.autoscaler.scale_outs
            counters['autoscale_ins'] = self.autoscaler.scale_ins
        return merged

    # -- the autoscaler ------------------------------------------------------

    #: A scale-in victim offered to the materializer warms for at most this
    #: long before its drain goes ahead regardless (the hand-off must never
    #: turn a scale-in into none).
    DRAIN_WARM_DEADLINE_S = 30.0

    def attach_materializer(self, controller):
        """Attach a :class:`~petastorm_tpu_torch.materialize.MaterializeController`:
        scale-in victims get one bounded warming pass (through the
        controller's lease protocol) before their drain."""
        self._materializer = controller

    def _drain_worker(self, victim):
        with self._lock:
            worker = self._workers.get(victim)
            if worker is not None:
                worker['draining'] = True

    def _tick_deferred_drains(self, now):
        """Drain the victims whose warming pass ended (or ran out of time)."""
        materializer = self._materializer
        for victim, deadline in list(self._deferred_drains.items()):
            ready = now >= deadline
            if not ready:
                try:
                    ready = materializer is None or materializer.drain_ready(victim)
                except Exception:  # noqa: BLE001 — the hand-off is best-effort
                    ready = True
            if ready:
                del self._deferred_drains[victim]
                self._drain_worker(victim)
                logger.info('autoscaler draining worker %s (warming pass done)', victim)

    def _autoscale_tick(self):
        """One evaluation of the control law: the observation taken under the
        lock, the spawn or the drain done outside it."""
        if self.autoscaler is None or not self.autoscaler.enabled:
            return
        stale = 3.0 * self._config.lease_ttl_s
        now = time.monotonic()
        self._tick_deferred_drains(now)
        with self._lock:
            states = collections.Counter(s.state for s in self._splits)
            alive = [wid for wid, w in sorted(self._workers.items())
                     if not w.get('draining') and (now - w['last_heartbeat']) < stale]
            held = collections.Counter(s.worker_id for s in self._splits
                                       if s.state == _LEASED and s.worker_id is not None)
            free_slots = sum(max(0, self._config.max_inflight_splits - held[wid])
                             for wid in alive)
            coverage = {wid: len(self._worker_digests.get(wid, ())) for wid in alive}
        action = self.autoscaler.maybe_tick({
            'pending': states[_PENDING], 'leased': states[_LEASED], 'alive': alive,
            'free_slots': free_slots, 'coverage': coverage, 'dispatcher_addr': self.addr},
            now=now)
        if action and action[0] == 'scale_in':
            victim = action[1]
            materializer = self._materializer
            if materializer is not None and victim not in self._deferred_drains:
                offered = False
                try:
                    offered = materializer.offer_drain_candidate(
                        victim, deadline_s=self.DRAIN_WARM_DEADLINE_S)
                except Exception:  # noqa: BLE001 — the hand-off is best-effort
                    logger.warning('materialize drain hand-off for %s failed', victim,
                                   exc_info=True)
                if offered:
                    self._deferred_drains[victim] = now + self.DRAIN_WARM_DEADLINE_S
                    self.materialize_handoffs += 1
                    logger.info('autoscaler victim %s offered to the materializer for one '
                                'warming pass before its drain', victim)
                    return
            self._drain_worker(victim)
            logger.info('autoscaler draining worker %s (least cache coverage)', victim)

    # -- lease bookkeeping ---------------------------------------------------

    def _pending_for(self, split):
        """The split's tenant's pending deque (caller holds the lock); the
        default job's when its tenant is gone, so a requeue never drops work."""
        job = self._tenants.get(split.tenant) or self._tenants.get(self._default_tenant)
        return job.pending

    def _expire_leases(self):
        now = time.monotonic()
        with self._lock:
            for split in self._splits:
                if split.state == _LEASED and split.lease_expires < now:
                    if split.worker_id is None:
                        # a restored orphan nobody claimed: the restart was
                        # not a worker's failure, so the attempt stays
                        logger.info('restored lease on split %d unclaimed; requeueing at '
                                    'attempt %d', split.split_id, split.attempt)
                        split.state = _PENDING
                        self._pending_for(split).append(split)
                        self.ledger_requeues += 1
                        self._ledger_mark()
                        continue
                    self._requeue(split)
                    logger.warning('lease on split %d expired (attempt now %d)',
                                   split.split_id, split.attempt)
                    if self._trace is not None:
                        self._trace.instant('service/lease_expired', split=split.split_id)

    def _requeue(self, split):
        """A lease its worker walked away from (caller holds the lock):
        attempt + 1, back to its tenant's queue, or failed at the cap."""
        split.worker_id = None
        split.attempt += 1
        self.lease_churn += 1
        self._ledger_mark()
        if split.attempt >= self._config.max_split_attempts:
            logger.error('split %d failed %d lease attempts; marking failed',
                         split.split_id, split.attempt)
            split.state = _FAILED
        else:
            split.state = _PENDING
            self._pending_for(split).append(split)

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
            # the directory restored from the ledger, by the data address
            held = self._ledger_digests_by_addr.pop(request['data_addr'], None)
            if held:
                self._worker_digests[worker_id] = set(held)
        logger.info('registered worker %s at %s', worker_id, request['data_addr'])
        # the registration is the worker's first clock handshake
        return {'worker_id': worker_id, 'job': self._job, 't_mono': time.monotonic()}

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
            # the digest set replaces wholesale (workers ship it on change);
            # the piece map is per job, the first valid one wins
            if request.get('cache_digests') is not None:
                self._worker_digests[worker_id] = {str(d) for d in request['cache_digests']}
            pieces = request.get('piece_digests')
            if self._cluster_on and pieces and self._piece_digests is None:
                pieces = [str(d) for d in pieces]
                if len(pieces) == self._num_pieces:
                    self._piece_digests = pieces
                    self._ledger_mark()
                elif worker_id not in self._piece_digests_declined:
                    self._piece_digests_declined.add(worker_id)
                    logger.warning('worker %s advertised %d piece digests for a %d-piece job; '
                                   'declining its map', worker_id, len(pieces),
                                   self._num_pieces)
            need_pieces = (self._cluster_on and self._piece_digests is None
                           and worker_id not in self._piece_digests_declined)
            for split in self._splits:
                if split.state != _LEASED:
                    continue
                if split.worker_id == worker_id and (held is None or split.split_id in held):
                    split.lease_expires = now + self._config.lease_ttl_s
                elif split.worker_id is None and held is not None and split.split_id in held:
                    # a restored orphan the worker still holds resumes under
                    # its new id, attempt intact: nothing decodes again
                    split.worker_id = worker_id
                    split.lease_expires = now + self._config.lease_ttl_s
                    self.ledger_adoptions += 1
                    self._ledger_mark()
                    logger.info('worker %s re-claimed restored lease on split %d (attempt %d)',
                                worker_id, split.split_id, split.attempt)
            draining = bool(worker['draining'])
        # each heartbeat is a clock handshake again (the worker's offset
        # follows drift)
        return {'ok': True, 't_mono': time.monotonic(), 'need_piece_digests': need_pieces,
                'drain': draining}

    # -- cache affinity (callers hold the lock) ------------------------------

    def _split_cdigests(self, split):
        """The compact digests of a split's pieces, None before a piece map."""
        if self._piece_digests is None:
            return None
        job = self._tenants.get(split.tenant)
        if job is not None and job.split_base > 0 \
                and job.config.dataset_url != self._config.dataset_url:
            return None   # the piece map is of the default job's dataset
        return [self._piece_digests[i] for i in split.indices]

    def _coverage(self, split, worker_id):
        """The share of the split's digests the worker advertises, or None."""
        held = self._worker_digests.get(worker_id)
        digests = self._split_cdigests(split)
        if not held or not digests:
            return None
        return sum(1 for d in digests if d in held) / float(len(digests))

    def _live(self, worker_id, now):
        worker = self._workers.get(worker_id)
        return worker is not None \
            and now - worker['last_heartbeat'] < 3.0 * self._config.lease_ttl_s

    def _alive_holder(self, split, exclude_worker):
        """Another live worker holding the split (the deferral's test)."""
        digests = self._split_cdigests(split)
        if not digests:
            return None
        now = time.monotonic()
        for wid, held in self._worker_digests.items():
            if wid != exclude_worker and self._live(wid, now) and \
                    sum(1 for d in digests if d in held) >= _AFFINITY_MIN_COVERAGE * len(digests):
                return wid
        return None

    def _split_holders(self, split, exclude_worker):
        """compact digest -> [data address, ...] of live peers holding it: the
        lease reply's peer-fill hints."""
        digests = self._split_cdigests(split)
        if not digests:
            return None
        now = time.monotonic()
        holders = {}
        for wid, held in self._worker_digests.items():
            if wid == exclude_worker or not self._live(wid, now):
                continue
            for digest in digests:
                if digest in held:
                    holders.setdefault(digest, []).append(self._workers[wid]['addr'])
        return holders or None

    def _choose_pending(self, job, worker_id, consumers):
        """Pop the split of tenant ``job``'s queue to lease to ``worker_id``
        (None: nothing now).  FIFO; with directory evidence it prefers, within
        a bounded scan, a split the requester holds, and keeps a split another
        live worker holds back from a cold requester for a bounded window."""
        pending = job.pending
        affinity = (self._cluster_on and self._piece_digests is not None
                    and bool(self._worker_digests))
        window, skipped = [], []
        limit = _AFFINITY_SCAN if affinity else 1
        while pending and len(window) < limit:
            split = pending.popleft()
            if split.state != _PENDING:
                continue   # retired by mark_consumed while queued
            if consumers is not None and split.consumer not in consumers:
                skipped.append(split)
                continue
            window.append(split)
        chosen, routed = None, False
        if affinity:
            for split in window:
                coverage = self._coverage(split, worker_id)
                if coverage is not None and coverage >= _AFFINITY_MIN_COVERAGE:
                    chosen, routed = split, True
                    _decisions.record_decision(
                        'affinity', 'routed', 'affinity_min_coverage',
                        {'coverage': coverage, 'min_coverage': _AFFINITY_MIN_COVERAGE,
                         'scanned': len(window)},
                        worker_id=worker_id, split_id=split.split_id, tenant=job.tenant,
                        journal=self._decisions)
                    break
        if chosen is None:
            now = time.monotonic()
            defer_s = min(_AFFINITY_DEFER_S, self._config.lease_ttl_s / 5.0)
            for split in window:
                if affinity and split.attempt == 0 and self._alive_holder(split, worker_id):
                    if split.affinity_defer_until is None:
                        split.affinity_defer_until = now + defer_s
                    if now < split.affinity_defer_until:
                        continue   # inside its holder's window
                    _decisions.record_decision(
                        'affinity', 'deferral_exhausted', 'affinity_defer_s',
                        {'waited_s': defer_s + now - split.affinity_defer_until,
                         'defer_s': defer_s},
                        worker_id=worker_id, split_id=split.split_id, tenant=job.tenant,
                        journal=self._decisions)
                chosen = split
                break
            if chosen is None and window:
                self.affinity_deferrals += 1
                # nothing granted because every scanned split is in a holder's
                # window: a suppressed non-action
                _decisions.record_decision(
                    'affinity', 'deferred', 'affinity_defer_s',
                    {'waited_s': max(0.0, defer_s + now - min(
                        s.affinity_defer_until for s in window
                        if s.affinity_defer_until is not None)),
                     'defer_s': defer_s, 'scanned': len(window)},
                    suppressed=True, worker_id=worker_id, tenant=job.tenant,
                    journal=self._decisions)
        # the rest of the window back to the front, in order; consumer
        # mismatches to the back
        for split in reversed([s for s in window if s is not chosen]):
            pending.appendleft(split)
        pending.extend(skipped)
        return chosen, routed

    @staticmethod
    def _parse_lease_consumers(consumers):
        """``consumers`` from the wire -> {tenant: {consumer, ...}}, or None
        (no filter).  Workers send ``[[tenant, consumer], ...]``; a bare int
        is the default tenant's consumer."""
        if consumers is None:
            return None
        by_tenant = {}
        for entry in consumers:
            if isinstance(entry, (list, tuple)):
                tenant, consumer = entry
            else:
                tenant, consumer = _tenancy.DEFAULT_TENANT, entry
            by_tenant.setdefault(str(tenant), set()).add(int(consumer))
        return by_tenant

    def _op_lease(self, request):
        worker_id = request['worker_id']
        # the (tenant, consumer) pairs with a live subscriber on the worker:
        # a worker decodes for no absent host (its chunks would fill the
        # worker's send buffer)
        by_tenant = self._parse_lease_consumers(request.get('consumers'))
        with self._lock:
            if worker_id not in self._workers:
                return {'error': 'unknown worker %r' % worker_id}
            self._workers[worker_id]['last_heartbeat'] = time.monotonic()
            if self._workers[worker_id]['draining']:
                return {'wait': True, 'drain': True}
            # the scheduler picks the tenant, the affinity scan the split; a
            # tenant whose every candidate is kept back gets its debit back
            chosen, routed, tried = None, False, set()
            while chosen is None:
                eligible = [j for j in self._tenants.jobs()
                            if j.tenant not in tried and j.pending
                            and (by_tenant is None or j.tenant in by_tenant)]
                tenant = self._scheduler.pick(eligible)
                if tenant is None:
                    break
                job = self._tenants.get(tenant)
                chosen, routed = self._choose_pending(
                    job, worker_id, None if by_tenant is None else by_tenant.get(tenant))
                if chosen is None:
                    self._scheduler.refund(tenant)
                    tried.add(tenant)
                else:
                    job.grants += 1
            if chosen is not None:
                chosen.state = _LEASED
                chosen.worker_id = worker_id
                chosen.lease_expires = time.monotonic() + self._config.lease_ttl_s
                chosen.affinity_defer_until = None
                self._ledger_mark()
                if routed:
                    self.affinity_routed += 1
                holders = self._split_holders(chosen, worker_id) if self._cluster_on else None
                if self._trace is not None:
                    self._trace.instant('service/lease_grant', split=chosen.split_id,
                                        worker=worker_id, attempt=chosen.attempt)
                reply = {'split': chosen.describe(), 'ttl': self._config.lease_ttl_s}
                if holders:
                    reply['holders'] = holders
                return reply
            # 'done' covers the tenants this worker serves only
            relevant = [j for j in self._tenants.jobs()
                        if by_tenant is None or j.tenant in by_tenant]
            if relevant and all(s.state in (_DONE, _FAILED) for j in relevant
                                for s in self._splits[j.split_base:j.split_base + j.num_splits]):
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
                return {'ok': False}   # the lease moved on
            split.state = _DONE
            split.worker_id = None
            if self._trace is not None:
                self._trace.instant('service/split_done', split=split_id, worker=worker_id)
        # written ahead: the record exists before the worker hears 'ok'
        self._ledger_done(split_id)
        return {'ok': True}

    def _op_mark_consumed(self, request):
        """A resuming client holds these splits' rows already (its token
        committed them): retire the pending ones so that no worker decodes
        them again.  A split already streaming stays leased; the client
        drops the duplicate."""
        retired = []
        with self._lock:
            for split_id in request['split_ids']:
                split = self._splits[int(split_id)]
                if split.state == _PENDING:
                    split.state = _DONE
                    retired.append(split.split_id)
        for split_id in retired:
            self._ledger_done(split_id)
        return {'ok': True, 'retired': len(retired)}

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
        back to the front of its tenant's queue, its attempt count intact."""
        worker_id, split_id = request['worker_id'], int(request['split_id'])
        with self._lock:
            split = self._splits[split_id]
            if split.state != _LEASED or split.worker_id != worker_id \
                    or split.attempt != request.get('attempt', split.attempt):
                return {'ok': False}
            split.state = _PENDING
            split.worker_id = None
            self._pending_for(split).appendleft(split)
            self._ledger_mark()
            if self._trace is not None:
                self._trace.instant('service/lease_released', split=split_id, worker=worker_id)
        return {'ok': True}

    def _op_deregister(self, request):
        """A drained worker leaves.  ``timed_out=True``: its drain deadline
        passed with splits in flight, which requeue at once (attempt + 1),
        as after a lease expiry."""
        worker_id = request['worker_id']
        with self._lock:
            self._worker_digests.pop(worker_id, None)
            if self._workers.pop(worker_id, None) is None:
                return {'ok': False}
            self.drains += 1
            if request.get('timed_out'):
                self.drain_timeouts += 1
            for split in self._splits:
                if split.state == _LEASED and split.worker_id == worker_id:
                    self._requeue(split)
        logger.info('worker %s deregistered', worker_id)
        self._ledger_save(force=True)
        return {'ok': True}

    def _op_job(self, request):
        tenant = request.get('tenant')
        if tenant is None:
            return {'job': self._job}
        with self._lock:
            job = self._tenants.get(str(tenant))
            if job is None:
                return {'error': 'unknown tenant %r (registered: %s)'
                                 % (tenant, ', '.join(self._tenants.tenants()))}
            return {'job': dict(job.job_info)}

    def _op_register_job(self, request):
        """Register another tenant's job on this fleet: its splits join the
        global id space at ``split_base = len(splits)``.  Past
        ``max_tenant_jobs`` the refusal carries ``retry_after_s``."""
        from petastorm_tpu_torch.service.config import ServiceConfig
        tenant = str(request['tenant'])
        weight = float(request.get('weight', 1.0))
        kwargs = dict(request.get('config') or {})
        kwargs['tenant'] = tenant
        kwargs['tenant_weight'] = weight
        try:
            config = ServiceConfig(**kwargs)
            num_pieces = _count_row_groups(config.dataset_url)
        except Exception as e:  # noqa: BLE001 — a bad registration gets an error reply
            return {'error': 'tenant %r registration rejected: %s' % (tenant, e)}
        with self._lock:
            if tenant in self._tenants:
                return {'error': 'tenant %r is already registered (one job per tenant id)'
                                 % tenant}
            base = len(self._splits)
            splits = build_splits(num_pieces, config.rowgroups_per_split, config.num_consumers,
                                  split_base=base, tenant=tenant)
            job_info = dict(config.job_info(len(splits)), split_base=base)
            job = _tenancy.TenantJob(tenant, weight, config, job_info, split_base=base,
                                     num_splits=len(splits), num_pieces=num_pieces,
                                     registered_t=time.monotonic())
            refusal = self._tenants.admit(job)
            if refusal is not None:
                return refusal
            self._splits.extend(splits)
            job.pending = collections.deque(splits)
            self._ledger_mark()
        logger.info('registered tenant %r: %d splits at base %d (weight %.2f)', tenant,
                    len(splits), base, weight)
        self._ledger_save(force=True)
        return {'job': job_info}

    def _op_workers(self, request):
        stale = 3.0 * self._config.lease_ttl_s
        now = time.monotonic()
        with self._lock:
            # clock_offset: (the worker's clock - ours), from its heartbeats;
            # a client chains it with its own offset to place the worker's
            # spans on its timeline
            workers = [{'worker_id': wid, 'addr': w['addr'],
                        'alive': (now - w['last_heartbeat']) < stale,
                        'clock_offset': w['stats'].get('clock_offset'),
                        'pid': w['stats'].get('pid')}
                       for wid, w in sorted(self._workers.items())]
            # failed splits ride on the discovery poll: a waiting client raises
            failed = sorted(s.split_id for s in self._splits if s.state == _FAILED)
            # a restored dispatcher also names the done splits: a client
            # without the token that retired them raises instead of waiting
            done = (sorted(s.split_id for s in self._splits if s.state == _DONE)
                    if self.ledger_restores else None)
        # the discovery poll is the client's clock handshake
        reply = {'workers': workers, 'failed_splits': failed, 't_mono': time.monotonic()}
        if done is not None:
            reply['retired_splits'] = done
        return reply

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
            cluster = {'cache_affinity_routed': self.affinity_routed,
                       'affinity_deferrals': self.affinity_deferrals,
                       'directory_workers': len(self._worker_digests),
                       'directory_digests': len(set().union(*self._worker_digests.values()))
                       if self._worker_digests else 0,
                       'piece_map': self._piece_digests is not None}
        # the health window: the current fleet snapshot against the ring's
        # frame about 60 s back (with one frame, that frame), so the report
        # is current even on a dispatcher younger than one tick
        self.flight.maybe_tick()
        frames = self.flight.frames()
        baseline = window_frames(frames, 60.0)[0] or (frames[-1] if frames else None)
        delta = snapshot_delta(self._fleet_snapshot(),
                               baseline['snapshot'] if baseline else None)
        grant_deltas = {name.split(':', 1)[1]: value
                        for name, value in (delta.get('counters') or {}).items()
                        if name.startswith('tenant_grants:')}
        with self._lock:
            deficits = self._scheduler.deficits()
            tenants = {}
            for job in self._tenants.jobs():
                span = collections.Counter(
                    s.state for s in self._splits[job.split_base:job.split_base + job.num_splits])
                tenants[job.tenant] = {
                    'weight': job.weight, 'split_base': job.split_base,
                    'num_splits': job.num_splits, 'pending': span[_PENDING],
                    'leased': span[_LEASED], 'done': span[_DONE], 'failed': span[_FAILED],
                    'grants': job.grants, 'grants_delta': int(grant_deltas.get(job.tenant, 0)),
                    'deficit': round(deficits.get(job.tenant, 0.0), 3)}

        def total(keys):
            return {key: sum(int(w.get(key, 0)) for w in workers.values()) for key in keys}
        cluster.update(total(('cache_remote_hits', 'cache_peer_fills', 'cache_peer_degraded')))
        control = {'ledger': self._ledger is not None, 'ledger_restores': self.ledger_restores,
                   'ledger_adoptions': self.ledger_adoptions,
                   'ledger_requeues': self.ledger_requeues,
                   'ledger_saves': self._ledger.saves if self._ledger is not None else 0,
                   'drains': self.drains, 'drain_timeouts': self.drain_timeouts,
                   'workers_draining': draining, 'workers_alive': alive}
        control.update(total(('retry_attempts', 'retry_giveups')))
        if self.autoscaler is not None:
            autoscale = self.autoscaler.snapshot()
        else:
            from petastorm_tpu_torch.service import autoscaler as _autoscaler
            autoscale = {'enabled': False, 'killed': _autoscaler.killed(), 'scale_outs': 0,
                         'scale_ins': 0, 'actions': 0, 'suppressed': 0, 'last_action': None}
        # the dispatcher's journal by actor, with the workers' heartbeat
        # payloads added in (a worker's last action aged by its heartbeat's age)
        decisions = self._decisions.summary()
        for row in workers.values():
            for actor, wrow in ((row.get('decisions') or {}).get('summary') or {}).items():
                agg = decisions.setdefault(actor, {'actions': 0, 'suppressed': 0, 'last': None})
                agg['actions'] += int(wrow.get('actions', 0))
                agg['suppressed'] += int(wrow.get('suppressed', 0))
                last = wrow.get('last')
                if last is not None:
                    last = dict(last, age_s=round(last.get('age_s', 0.0) + row.get('age_s', 0.0),
                                                  1))
                    if agg['last'] is None or last['age_s'] < agg['last'].get('age_s', 0.0):
                        agg['last'] = last
        # a tenant with pending work and no grant in the window while another
        # was granted: the fleet moves, not for it
        fleet_moving = any(row['grants_delta'] > 0 for row in tenants.values())
        starved = sorted(tid for tid, row in tenants.items()
                         if row['pending'] > 0 and row['grants_delta'] == 0 and fleet_moving)
        meta = {'pending': states[_PENDING], 'leased': states[_LEASED],
                'failed': states[_FAILED], 'workers_alive': alive,
                'ledger_restores': self.ledger_restores, 'drain_timeouts': self.drain_timeouts,
                'retry_giveups': control['retry_giveups'], 'starved_tenants': starved,
                'tenant_count': len(tenants),
                'control_flaps': self._decisions.opposing_actions(60.0)}
        fleet_health = health.health_report(
            delta, meta=meta,
            window_s=(time.monotonic() - baseline['t_mono']) if baseline else None)
        health.export_gauges(self.metrics, fleet_health)
        merged = merge_snapshots([w.get('registry') for w in workers.values()])
        return {
            'num_splits': len(self._splits),
            'pending': states[_PENDING],
            'leased': states[_LEASED],
            'done': states[_DONE],
            'failed': states[_FAILED],
            'lease_churn': self.lease_churn,
            'cache': total(('cache_hits', 'cache_misses', 'cache_evictions', 'cache_ram_hits',
                            'cache_degraded', 'cache_quota_degraded')),
            'shm': total(('shm_chunks', 'shm_degraded', 'shm_quota_degraded', 'byte_chunks')),
            'cluster_cache': cluster,
            'control_plane': control,
            'tenants': tenants,
            'autoscale': autoscale,
            'decisions': decisions,
            'stages': {name: summarize_hist(hist) for name, hist in merged['histograms'].items()},
            'health': fleet_health,
            'workers': {wid: {k: v for k, v in row.items() if k != 'registry'}
                        for wid, row in workers.items()},
        }

    def _op_decisions(self, request):
        """The dispatcher's journal whole, and each worker's heartbeat payload
        (its summary and newest records)."""
        with self._lock:
            worker_payloads = {wid: w['stats'].get('decisions')
                               for wid, w in self._workers.items()
                               if w['stats'].get('decisions')}
        return {'journal': self._decisions.dump(), 'workers': worker_payloads}

    def _op_stop(self, request):
        self._stop.set()
        return {'ok': True}


def _count_row_groups(dataset_url):
    """The dataset's row-group count, the one dataset fact the control
    plane needs (workers enumerate the same footer metadata, so indices
    agree)."""
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths

    fs, path_or_paths = get_filesystem_and_path_or_paths(dataset_url)
    paths = path_or_paths if isinstance(path_or_paths, list) else [path_or_paths]
    return sum(len(load_row_groups(fs, p)) for p in paths)

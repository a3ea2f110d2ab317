"""The materialization job controller: warm a dataset ahead of demand.

Counterpart of ``petastorm_tpu/materialize/controller.py``.  The controller
owns one dataset's warming job end to end:

* **decode identity**: :class:`~petastorm_tpu_torch.service.cluster.
  ClusterCacheIdentity` resolves the job's pieces, plane context and
  per-piece digests without a reader; the warmer runs the consumer's own
  worker class (:class:`~petastorm_tpu_torch.py_dict_reader_worker.
  PyDictReaderWorker` or :class:`~petastorm_tpu_torch.arrow_reader_worker.
  ArrowReaderWorker`) standalone with a capturing result cache, so a warm
  entry is what a consumer's miss would have published, bit for bit: the
  same keys, the same post-transform values, the same ``encode_entry``
  bytes.  A row-drop job decodes and publishes once per partition.
* **lease protocol**: the dispatcher's split leases over pieces.
  :meth:`lease` grants with a TTL and burns an attempt, an expired lease
  requeues, ``max_piece_attempts`` poisons a piece to failed; scale-in
  victims (:meth:`offer_drain_candidate`) and :meth:`run` share one queue
  without warming a piece twice.
* **durable progress**: the service's snapshot and journal ledger under
  ``kind='materialize_ledger'``; :meth:`complete` appends its journal line
  before the in-memory transition, so a SIGKILLed controller restarts with
  every finished piece finished and its attempts intact.  A ledger written
  under another decode identity (the plane context's token) cold-starts.
* **eviction-aware admission**: every publish asks
  :meth:`~petastorm_tpu_torch.cache_plane.plane.CachePlane.admit_publish`
  first; a publish whose LRU victims include an entry read within
  ``hot_window_s`` is refused (counted, recorded as a ``materialize``
  decision, the piece left pending with its attempt refunded).

:func:`derive_candidates` ranks dataset roots by the cold decodes the
provenance journals recorded.  Nothing here loads torch: the controller
runs in the dispatcher, in a spawned child and beside the decode workers.
"""

import hashlib
import logging
import os
import threading
import time

from petastorm_tpu_torch.telemetry import decisions as _decisions

logger = logging.getLogger(__name__)

__all__ = ['MaterializeController', 'MATERIALIZE_LEDGER_KIND', 'derive_candidates',
           'wire_digests']

MATERIALIZE_LEDGER_KIND = 'materialize_ledger'

#: One full ledger snapshot per this many completes (the journal covers
#: the gap, as for the dispatcher's ledger).
_SAVE_EVERY = 16

_PENDING, _LEASED, _DONE, _FAILED = 'p', 'l', 'd', 'f'


class _CaptureCache(object):
    """The warmer's result cache: always fills, and keeps key -> the
    post-transform value the consumer would have handed ``encode_entry``."""

    def __init__(self):
        self.values = {}

    def get(self, key, fill_func):
        value = fill_func()
        self.values[key] = value
        return value

    def cleanup(self):
        self.values.clear()


class MaterializeController(object):
    """One dataset's warming job.

    The arguments follow the service's job dict
    (:meth:`ClusterCacheIdentity.build` takes them as they are):
    ``dataset_url`` and ``reader_kwargs`` pin the decode identity,
    ``cache_plane_dir`` is the plane the fleet reads.  ``ledger_path=None``
    runs without durability; ``throttle_s`` stretches the window between a
    decode and its publish (the chaos harness's kill target).
    ``wire_policy`` (``'auto'``, a ``{field: dtype}`` map, or None) also
    publishes each columnar piece's wire entry
    (:mod:`~petastorm_tpu_torch.materialize.transcode`).  Construction never
    raises on a job it cannot warm: ``identity`` stays None and :meth:`run`
    says why.
    """

    def __init__(self, dataset_url, cache_plane_dir, reader_kwargs=None, ledger_path=None,
                 cache_plane_disk_bytes=None, cache_plane_ram_bytes=None, reader_factory='auto',
                 wire_policy='auto', hot_window_s=300.0, lease_ttl_s=30.0,
                 max_piece_attempts=3, throttle_s=0.0):
        from petastorm_tpu_torch.service.cluster import ClusterCacheIdentity
        self.dataset_url = dataset_url
        self._job = {'dataset_url': dataset_url,
                     'reader_kwargs': dict(reader_kwargs or {}),
                     'reader_factory': reader_factory,
                     'cache_plane_dir': cache_plane_dir,
                     'cache_plane_disk_bytes': cache_plane_disk_bytes,
                     'cache_plane_ram_bytes': cache_plane_ram_bytes}
        self._wire_policy = wire_policy
        self._hot_window_s = float(hot_window_s)
        self._lease_ttl_s = float(lease_ttl_s)
        self._max_piece_attempts = int(max_piece_attempts)
        self.throttle_s = float(throttle_s)
        self._lock = threading.Lock()
        self._init_metrics()
        self.identity = ClusterCacheIdentity.build(self._job)
        self._piece_state = []       # piece index -> [state code, attempt]
        self._leases = {}            # piece index -> (worker id, expiry)
        self._drain_passes = {}      # worker id -> its warming pass's thread
        self.resumed_pieces = 0
        self._completes_since_save = 0
        self._ledger = None
        if self.identity is not None:
            self._piece_state = [[_PENDING, 0] for _ in range(self.identity.num_pieces)]
            self._context_token = hashlib.blake2b(
                self.identity.plane.context.encode('utf-8', 'replace'),
                digest_size=8).hexdigest()
            if ledger_path:
                self._attach_ledger(ledger_path)

    # -- telemetry -----------------------------------------------------------

    def _init_metrics(self):
        from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
        self.metrics = MetricsRegistry('materialize')
        self._m_runs = self.metrics.counter('materialize_runs')
        self._m_warmed = self.metrics.counter('materialize_pieces_warmed')
        self._m_resumed = self.metrics.counter('materialize_pieces_resumed')
        self._m_failed = self.metrics.counter('materialize_pieces_failed')
        self._m_refused = self.metrics.counter('materialize_admission_refused')
        self._m_bytes = self.metrics.counter('materialize_published_bytes')
        self._m_wire = self.metrics.counter('materialize_wire_published')
        self._m_wire_skipped = self.metrics.counter('materialize_wire_skipped')
        self._m_drain_passes = self.metrics.counter('materialize_drain_passes')

    # -- the durable ledger --------------------------------------------------

    def _attach_ledger(self, path):
        """Acquire, then restore or cold-start.  A ledger held by another
        live controller turns durability off for this one (warming is an
        optimization), it does not raise."""
        from petastorm_tpu_torch.service.ledger import (DispatcherLedger, LedgerHeldError,
                                                        decode_splits)
        ledger = DispatcherLedger(path, kind=MATERIALIZE_LEDGER_KIND)
        try:
            ledger.acquire()
        except LedgerHeldError:
            logger.warning('materialize: ledger %s held by a live controller; running '
                           'without durability', path)
            return
        self._ledger = ledger
        state = ledger.load()
        if not state:
            self._save_ledger()
            return
        if state.get('context') != self._context_token \
                or not isinstance(state.get('splits'), list) \
                or len(state['splits']) != len(self._piece_state):
            logger.warning('materialize: ledger %s was written under another decode identity '
                           'or geometry; cold start', path)
            self._save_ledger()
            return
        try:
            decoded = decode_splits(state['splits'])
        except (ValueError, KeyError, TypeError):
            logger.warning('materialize: ledger %s splits undecodable; cold start', path)
            self._save_ledger()
            return
        for i, (restored, attempt) in enumerate(decoded):
            if restored == 'done':
                self._piece_state[i] = [_DONE, attempt]
                self.resumed_pieces += 1
                self._m_resumed.inc()
            elif restored == 'failed':
                self._piece_state[i] = [_FAILED, attempt]
            else:
                # pending and leased both requeue with their attempts: the
                # controller's death was not the piece's failure
                self._piece_state[i] = [_PENDING, attempt]
        logger.info('materialize: ledger %s restored %d/%d pieces done', path,
                    self.resumed_pieces, len(self._piece_state))

    def _save_ledger(self):
        if self._ledger is None:
            return
        with self._lock:
            splits = [list(rec) for rec in self._piece_state]
        self._ledger.save({'context': self._context_token, 'dataset_url': self.dataset_url,
                           'splits': splits})
        self._completes_since_save = 0

    # -- the lease protocol --------------------------------------------------

    def _expire_leases_locked(self, now):
        for index, (_, expires) in list(self._leases.items()):
            if expires < now:
                del self._leases[index]
                # the attempt stays burned: the poison ceiling bounds a
                # piece that keeps crashing its warmer
                self._piece_state[index][0] = _PENDING

    def lease(self, worker_id, n=1, skip=()):
        """Grant up to ``n`` pending piece indices to ``worker_id`` with a
        TTL, burning one attempt each; a piece at the attempt ceiling is
        poisoned to failed instead."""
        from petastorm_tpu_torch import materialize
        if materialize.killed():
            return []
        now = time.monotonic()
        granted = []
        with self._lock:
            self._expire_leases_locked(now)
            for index, rec in enumerate(self._piece_state):
                if len(granted) >= n:
                    break
                if rec[0] != _PENDING or index in skip:
                    continue
                if rec[1] >= self._max_piece_attempts:
                    rec[0] = _FAILED
                    self._m_failed.inc()
                    _decisions.record_decision(
                        'materialize', 'poison_piece', 'max_piece_attempts',
                        {'attempts': rec[1], 'max_attempts': self._max_piece_attempts},
                        piece=index)
                    continue
                rec[0] = _LEASED
                rec[1] += 1
                self._leases[index] = (worker_id, now + self._lease_ttl_s)
                granted.append(index)
        return granted

    def complete(self, worker_id, index):
        """Retire one warmed piece: the journal line first, so that a kill
        between the two re-runs nothing."""
        if self._ledger is not None:
            self._ledger.append({'op': 'done', 'split': int(index)})
        with self._lock:
            self._piece_state[index][0] = _DONE
            self._leases.pop(index, None)
        self._m_warmed.inc()
        self._completes_since_save += 1
        if self._completes_since_save >= _SAVE_EVERY:
            self._save_ledger()

    def release(self, worker_id, index, burn_attempt=True):
        """Return a lease unfinished; ``burn_attempt=False`` refunds the
        grant's attempt (the piece was fine, the environment refused it)."""
        with self._lock:
            rec = self._piece_state[index]
            if rec[0] == _LEASED:
                rec[0] = _PENDING
                if not burn_attempt:
                    rec[1] = max(0, rec[1] - 1)
            self._leases.pop(index, None)

    def fail(self, worker_id, index):
        """A decode failure: requeue (the ceiling poisons a piece that keeps
        failing)."""
        self.release(worker_id, index, burn_attempt=True)
        self._m_failed.inc()

    def pending_count(self):
        with self._lock:
            return sum(1 for rec in self._piece_state
                       if rec[0] == _PENDING and rec[1] < self._max_piece_attempts)

    # -- warming -------------------------------------------------------------

    def _make_worker(self):
        """One standalone reader worker (the consumer's decode path) and its
        capturing cache, per pass: passes run concurrently (the run loop
        and drain passes) and a worker's Parquet handles are its own."""
        identity = self.identity
        capture = _CaptureCache()
        if identity.kind == 'columns':
            from petastorm_tpu_torch.py_dict_reader_worker import (PyDictReaderWorker,
                                                                   RowWorkerArgs)
            args = RowWorkerArgs(pieces=identity.pieces, schema_view=identity.schema_view,
                                 schema=identity.stored_schema,
                                 transform_spec=identity.transform_spec,
                                 predicate=identity.predicate, cache=capture,
                                 shuffle_row_drop_partitions=identity.drop_partitions,
                                 columnar_output=True, filesystem=identity.fs)
            worker = PyDictReaderWorker(0, lambda _result: None, args)
        else:
            from petastorm_tpu_torch.arrow_reader_worker import ArrowReaderWorker, BatchWorkerArgs
            args = BatchWorkerArgs(pieces=identity.pieces, schema_view=identity.schema_view,
                                   transform_spec=identity.transform_spec,
                                   predicate=identity.predicate, cache=capture,
                                   filesystem=identity.fs)
            worker = ArrowReaderWorker(0, lambda _result: None, args)
        return worker, capture

    def _decode_piece(self, index, worker, capture):
        """Decode one piece through the consumer's path: ``[(digest,
        cache_key, value), ...]``, one per row-drop partition."""
        identity = self.identity
        digests = identity.piece_digests(index)
        capture.values.clear()
        items = []
        if identity.kind == 'columns':
            from petastorm_tpu_torch.py_dict_reader_worker import piece_cache_key
            for part in range(identity.drop_partitions):
                key = piece_cache_key(identity.pieces[index], identity.schema_view,
                                      identity.transform_spec, part) + ':c'
                worker.process(index, part)
                items.append((digests[part], key, capture.values[key]))
        else:
            from petastorm_tpu_torch.arrow_reader_worker import piece_cache_key
            key = piece_cache_key(identity.pieces[index], identity.schema_view,
                                  identity.transform_spec)
            worker.process(index)
            items.append((digests[0], key, capture.values[key]))
        return items

    def _publish(self, digest, blob):
        """An admission-gated publish: 'published', 'present', 'refused' or
        'degraded'."""
        plane = self.identity.plane
        if plane.has_digest(digest):
            return 'present'
        admitted, estimate = plane.admit_publish(len(blob), self._hot_window_s)
        inputs = {'nbytes': len(blob), 'hot_window_s': self._hot_window_s,
                  'admitted': admitted,
                  'fits': estimate.get('fits') if estimate else None,
                  'victim_newest_age_s': estimate.get('victim_newest_age_s')
                  if estimate else None}
        if not admitted:
            self._m_refused.inc()
            _decisions.record_decision('materialize', 'refuse_publish', 'hot_window_s', inputs,
                                       suppressed=True, digest=digest)
            return 'refused'
        if not plane.publish_blob(digest, blob):
            return 'degraded'
        self._m_bytes.inc(len(blob))
        _decisions.record_decision('materialize', 'published', 'hot_window_s', inputs,
                                   digest=digest)
        return 'published'

    def _warm_piece(self, index, worker, capture):
        """Decode and publish one piece (its raw entry per partition, then
        the wire sibling): 'done', 'refused' or 'failed'."""
        from petastorm_tpu_torch.cache_plane.plane import encode_entry
        from petastorm_tpu_torch.materialize.transcode import (verify_wire_identity,
                                                               wire_entry, wire_key)
        try:
            items = self._decode_piece(index, worker, capture)
        except Exception as e:  # noqa: BLE001 — a bad piece must not stop the job
            logger.warning('materialize: decode of piece %d failed (%s: %s)', index,
                           type(e).__name__, e)
            return 'failed'
        if self.throttle_s:
            time.sleep(self.throttle_s)   # the chaos kill window: decoded, unpublished
        for digest, key, value in items:
            try:
                blob = encode_entry(value)
            except Exception as e:  # noqa: BLE001 — unencodable: skip the piece
                logger.warning('materialize: cannot encode piece %d (%s)', index, e)
                return 'failed'
            outcome = self._publish(digest, blob)
            if outcome == 'refused':
                return 'refused'
            if outcome == 'degraded':
                return 'failed'
            # the wire sibling: columnar pieces only; one skipped is covered
            # by the raw entry
            if self._wire_policy and self.identity.kind == 'columns' \
                    and isinstance(value, dict) and value:
                entry = wire_entry(value, self._wire_policy)
                if entry is None or not verify_wire_identity(value, entry, self._wire_policy):
                    self._m_wire_skipped.inc()
                    continue
                wdigest = self.identity.plane.digest(wire_key(key, self._wire_policy))
                try:
                    wblob = encode_entry(entry)
                except Exception:  # noqa: BLE001 — the wire copy is optional
                    self._m_wire_skipped.inc()
                    continue
                if self._publish(wdigest, wblob) == 'published':
                    self._m_wire.inc()
                else:
                    self._m_wire_skipped.inc()
        return 'done'

    def _warm_loop(self, worker_id, deadline=None, max_pieces=None):
        """Lease, warm and complete until nothing is pending, the deadline
        or ``max_pieces``: the engine of :meth:`run` and of drain passes."""
        worker, capture = self._make_worker()
        warmed = failed = refused_count = 0
        refused = set()
        try:
            while max_pieces is None or warmed + failed < max_pieces:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                granted = self.lease(worker_id, 1, skip=refused)
                if not granted:
                    break
                index = granted[0]
                outcome = self._warm_piece(index, worker, capture)
                if outcome == 'done':
                    self.complete(worker_id, index)
                    warmed += 1
                elif outcome == 'refused':
                    # the plane is hotter than this job: pending with its
                    # attempt refunded for a cooler run, skipped in this pass
                    self.release(worker_id, index, burn_attempt=False)
                    refused.add(index)
                    refused_count += 1
                else:
                    self.fail(worker_id, index)
                    failed += 1
        finally:
            try:
                worker.shutdown()
            except Exception:  # noqa: BLE001 — handle-cache teardown only
                pass
        return {'warmed': warmed, 'failed': failed, 'refused': refused_count}

    def run(self, max_pieces=None, worker_id='controller'):
        """Warm the whole dataset (or up to ``max_pieces``) on the calling
        thread; the job's summary.  Never raises for a piece's failure."""
        from petastorm_tpu_torch import materialize
        if materialize.killed():
            return {'ok': False, 'reason': 'kill_switch'}
        if self.identity is None:
            return {'ok': False, 'reason': 'identity_unavailable'}
        self._m_runs.inc()
        t0 = time.monotonic()
        pass_stats = self._warm_loop(worker_id, max_pieces=max_pieces)
        self._save_ledger()
        summary = self.summary()
        summary.update(pass_stats)
        summary['elapsed_s'] = round(time.monotonic() - t0, 3)
        self.last_summary = summary
        return summary

    def summary(self):
        with self._lock:
            states = [rec[0] for rec in self._piece_state]
        return {'ok': True, 'total_pieces': len(states), 'done': states.count(_DONE),
                'pending': states.count(_PENDING), 'failed_pieces': states.count(_FAILED),
                'resumed': self.resumed_pieces, 'wire_published': self._m_wire.value,
                'admission_refused': self._m_refused.value,
                'published_bytes': self._m_bytes.value}

    # -- the autoscaler's hand-off: scale-in victims warm before they drain --

    def offer_drain_candidate(self, worker_id, deadline_s=30.0):
        """A scale-in victim's capacity, offered for one bounded warming
        pass before its drain: True when a pass started (or runs already),
        and the dispatcher then defers the drain until :meth:`drain_ready`;
        False (nothing pending, the kill switch, a job it cannot warm)
        means drain now."""
        from petastorm_tpu_torch import materialize
        if materialize.killed() or self.identity is None or not self.pending_count():
            return False
        with self._lock:
            thread = self._drain_passes.get(worker_id)
            if thread is not None and thread.is_alive():
                return True
            deadline = time.monotonic() + float(deadline_s)
            thread = threading.Thread(target=self._drain_pass, args=(worker_id, deadline),
                                      daemon=True, name='materialize-drain-%s' % worker_id)
            self._drain_passes[worker_id] = thread
        thread.start()
        return True

    def drain_ready(self, worker_id):
        """True once the worker's warming pass (if any) has ended: the
        dispatcher's gate for its deferred drain."""
        thread = self._drain_passes.get(worker_id)
        return thread is None or not thread.is_alive()

    def _drain_pass(self, worker_id, deadline):
        self._m_drain_passes.inc()
        try:
            self._warm_loop(worker_id, deadline=deadline)
            self._save_ledger()
        except Exception:  # noqa: BLE001 — a failed pass must still release the drain
            logger.warning('materialize: drain warming pass for %s died', worker_id,
                           exc_info=True)

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        for thread in list(self._drain_passes.values()):
            thread.join(timeout=5.0)
        self._save_ledger()
        if self._ledger is not None:
            self._ledger.release()
            self._ledger = None

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()


def wire_digests(identity, index, policy='auto'):
    """The full plane digests of one piece's wire entries (none for a batch
    job: wire entries are columnar only), as
    :meth:`ClusterCacheIdentity.piece_digests` gives the raw ones."""
    from petastorm_tpu_torch.materialize.transcode import wire_key
    if identity is None or identity.kind != 'columns':
        return []
    from petastorm_tpu_torch.py_dict_reader_worker import piece_cache_key
    return [identity.plane.digest(wire_key(
                piece_cache_key(identity.pieces[index], identity.schema_view,
                                identity.transform_spec, part) + ':c', policy))
            for part in range(identity.drop_partitions)]


def derive_candidates(journals=None, top_k=4):
    """Warming candidates from observed access: the dataset roots that
    sealed provenance records name, ranked by how much cold decoding the
    consumers paid there (cache outcome ``decode`` or ``degraded``), each
    with its tenants.  ``journals=None`` reads every live journal of the
    process.

    ``[{'root', 'records', 'cold', 'pieces', 'tenants'}, ...]``, coldest
    first; roots with no cold record are left out."""
    from petastorm_tpu_torch.telemetry import provenance
    if journals is None:
        journals = provenance.journals()
    by_root = {}
    for journal in journals:
        try:
            records = journal.records()
        except Exception as exc:  # noqa: BLE001 — candidates are advisory
            logger.warning('materialize: skipping unreadable provenance journal (%s: %s)',
                           type(exc).__name__, exc)
            continue
        for record in records:
            if not isinstance(record, dict):
                continue
            pieces = [piece for piece in (record.get('pieces') or ())
                      if isinstance(piece, dict)]
            roots = {os.path.dirname(str(piece.get('path'))) for piece in pieces
                     if piece.get('path')}
            cold = record.get('cache') in ('decode', 'degraded')
            tenant = record.get('tenant')
            for root in roots:
                agg = by_root.setdefault(root, {'root': root, 'records': 0, 'cold': 0,
                                                'pieces': set(), 'tenants': {}})
                agg['records'] += 1
                agg['cold'] += int(cold)
                agg['pieces'].update((piece.get('path'), piece.get('row_group'))
                                     for piece in pieces
                                     if os.path.dirname(str(piece.get('path'))) == root)
                if tenant:
                    agg['tenants'][tenant] = agg['tenants'].get(tenant, 0) + 1
    out = []
    for agg in by_root.values():
        if not agg['cold']:
            continue
        agg['pieces'] = len(agg['pieces'])
        out.append(agg)
    out.sort(key=lambda a: (-a['cold'], -a['records'], a['root']))
    return out[:top_k]

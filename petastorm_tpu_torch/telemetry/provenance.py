"""Per-batch provenance: where a delivered batch came from and where its
time went.

Counterpart of ``petastorm_tpu/telemetry/provenance.py``.  Every delivered
batch carries a compact, JSON-able record: the row groups that fed it (file,
row group, piece index), the worker process that decoded them (pid and
host), the dispatch decision (FIFO or adaptive, early launch, predicted and
actual cost), the cache's answer (RAM or disk hit, remote hit, peer fill,
decode, degraded), the transport that carried it (shm descriptor or bytes),
the path that moved it to the device (coalesced, narrowed, inline,
degraded) and the ``time.monotonic()`` windows of its stages (ventilate,
decode, serialize, ipc, release, host_batch, transform, h2d stage, dispatch
and commit), on the consumer's clock.

Records ride the frames the data path already has: a process pool's result
message gains a trailing record frame beside its position frame, a service
split's ``end`` header a ``provenance`` field, and the in-process pools pair
each record with its result at publish (:class:`Provenanced`).  The loader
merges a batch's records (:func:`merge_records`) with its own stage windows
and seals the result into its bounded :class:`ProvenanceJournal`; its stage
histograms keep tail exemplars (``{'step': N}``) into the journal.  A
:class:`SloWatchdog` dumps the whole journal when a batch passes its
latency budget, and ``python -m petastorm_tpu_torch.telemetry.explain``
renders the chain of any journaled batch.

``PETASTORM_TPU_NO_PROVENANCE=1`` turns every producer off: no record is
built or shipped, and delivery is the same bit for bit (a record rides next
to the data, never in it, and nothing waits on one).  Nothing here loads
torch.
"""

import json
import os
import threading
import time
import weakref
from collections import deque

__all__ = ['enabled', 'host', 'make_record', 'merge_records', 'shift_stages', 'piece_info',
           'pieces_for_indices', 'cache_stats', 'cache_outcome', 'finalize_delivery',
           'record_wall', 'atomic_json_dump', 'stage_coverage', 'Provenanced',
           'ProvenanceJournal', 'SloWatchdog', 'journals', 'dump_journals', 'worst_summaries',
           'summarize_record']

#: A record rides the data path's frames, so each of its lists is bounded.
MAX_PIECES_PER_RECORD = 32
MAX_WORKERS_PER_RECORD = 8

#: Every live journal of the process: what flight frames and crash dumps
#: carry.
_LIVE = weakref.WeakSet()


def enabled():
    """The kill switch, read at each call (each reader, pool and loader
    reads it when it starts)."""
    return os.environ.get('PETASTORM_TPU_NO_PROVENANCE', '') in ('', '0')


def atomic_json_dump(path, state):
    """The one write of a crash artifact (journal, SLO dump, flight dump):
    a temporary file replaced into place, removed on failure, every error
    swallowed (an artifact is best effort).  Returns the path, or None."""
    tmp = None
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = '%s.%d.tmp' % (path, os.getpid())
        with open(tmp, 'w') as f:
            json.dump(state, f, default=str)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — a failed artifact beats a dead process
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None


_HOST = None


def host():
    """This process's host name, looked up once."""
    global _HOST
    if _HOST is None:
        import socket
        try:
            _HOST = socket.gethostname()
        except OSError:
            _HOST = 'unknown'
    return _HOST


def make_record(source, position=None, worker_pid=None, worker_host=None, pieces=None,
                sched=None, cache=None, transport=None, transfer=None, stages=None, **extra):
    """One record (a plain dict; None fields left out).  ``stages`` maps a
    stage name to ``[t0, t1]`` on the producer's ``time.monotonic()``
    clock; a consumer on another clock moves them with :func:`shift_stages`."""
    record = {'v': 1, 'source': source}
    for key, value in (('position', position), ('worker_pid', worker_pid),
                       ('worker_host', worker_host), ('pieces', pieces), ('sched', sched),
                       ('cache', cache), ('transport', transport), ('transfer', transfer)):
        if value is not None:
            record[key] = value
    record['stages'] = dict(stages or {})
    record.update({k: v for k, v in extra.items() if v is not None})
    return record


def piece_info(worker_args, item_args, limit=MAX_PIECES_PER_RECORD):
    """``[{'index', 'path', 'row_group'}]`` of a reader's work item; None
    for a worker without a ``pieces`` list."""
    pieces = getattr(worker_args, 'pieces', None)
    if pieces is None or not item_args:
        return None
    try:
        index = int(item_args[0])
        piece = pieces[index]
    except (TypeError, ValueError, IndexError, KeyError):
        return None
    return [{'index': index, 'path': getattr(piece, 'path', None),
             'row_group': getattr(piece, 'row_group', None)}][:limit]


def pieces_for_indices(worker_args, indices, limit=MAX_PIECES_PER_RECORD):
    """Piece infos of global piece indices (a service split); an index
    alone where the piece list is not at hand (a split served from the
    cache without a reader)."""
    out = []
    pieces = getattr(worker_args, 'pieces', None) or ()
    for index in list(indices)[:limit]:
        entry = {'index': int(index)}
        try:
            piece = pieces[int(index)]
            entry['path'] = getattr(piece, 'path', None)
            entry['row_group'] = getattr(piece, 'row_group', None)
        except (TypeError, ValueError, IndexError, KeyError):
            pass
        out.append(entry)
    return out or None


def cache_stats(worker_args):
    """A copy of the worker cache's counters (the cache plane's ``stats``)
    for :func:`cache_outcome`; None for a cache without them."""
    stats = getattr(getattr(worker_args, 'cache', None), 'stats', None)
    return dict(stats) if stats else None


def cache_outcome(before, after):
    """One work item's cache outcome from the counters before and after it;
    None when no cache took part."""
    if not before or not after:
        return None
    delta = {key: int(after.get(key, 0)) - int(before.get(key, 0))
             for key in ('cache_hits', 'cache_ram_hits', 'cache_misses', 'cache_degraded')}
    if delta['cache_degraded'] > 0:
        return 'degraded'
    if delta['cache_ram_hits'] > 0:
        return 'ram_hit'
    if delta['cache_hits'] > 0:
        return 'disk_hit'
    if delta['cache_misses'] > 0:
        return 'decode'
    return None


def shift_stages(record, offset_s):
    """A copy of ``record`` with every stage window moved by ``offset_s``
    (producer clock to consumer clock, the sign of
    ``spans.merge_into_recorder``'s)."""
    if not offset_s:
        return record
    out = dict(record)
    out['stages'] = {name: [t0 + offset_s, t1 + offset_s]
                     for name, (t0, t1) in (record.get('stages') or {}).items()}
    return out


def merge_records(records):
    """The records of one delivered batch (several chunks or row groups may
    feed it) as one: pieces concatenate (bounded), each stage's windows
    unite (least start, greatest end), an outcome shared by all records
    stays and a split one reads ``'mixed'``; ``sched`` merges field by
    field (the one policy or ``'mixed'``, any early launch, the largest
    costs)."""
    records = [r for r in records if r]
    if not records:
        return make_record('local')
    merged = make_record(records[0].get('source', 'local'))
    pieces = []
    worker_pids = []
    scheds = []
    for record in records:
        for piece in record.get('pieces') or ():
            if len(pieces) < MAX_PIECES_PER_RECORD:
                pieces.append(piece)
        pid = record.get('worker_pid')
        if pid is not None and pid not in worker_pids \
                and len(worker_pids) < MAX_WORKERS_PER_RECORD:
            worker_pids.append(pid)
        if isinstance(record.get('sched'), dict):
            scheds.append(record['sched'])
        for name, busy in (record.get('stage_busy_ms') or {}).items():
            mine = merged.setdefault('stage_busy_ms', {})
            mine[name] = round(mine.get(name, 0.0) + busy, 3)
        for name, window in (record.get('stages') or {}).items():
            mine = merged['stages'].get(name)
            merged['stages'][name] = (list(window) if mine is None else
                                      [min(mine[0], window[0]), max(mine[1], window[1])])
        for key in ('cache', 'transport', 'transfer', 'worker_host', 'tenant', 'residency'):
            value = record.get(key)
            if value is None:
                continue
            current = merged.get(key)
            if current is None:
                merged[key] = value
            elif current != value:
                merged[key] = 'mixed'
    if scheds:
        policies = {s.get('policy') for s in scheds}
        merged['sched'] = {'policy': policies.pop() if len(policies) == 1 else 'mixed'}
        if any('early' in s for s in scheds):
            merged['sched']['early'] = any(s.get('early') for s in scheds)
        for key in ('predicted_cost', 'actual_s'):
            values = [s[key] for s in scheds if s.get(key) is not None]
            if values:
                merged['sched'][key] = max(values)
    if worker_pids:
        merged['worker_pid'] = worker_pids[0]
        if len(worker_pids) > 1:
            merged['worker_pids'] = worker_pids
    if pieces:
        merged['pieces'] = pieces
    return merged


def finalize_delivery(record, ventilator=None):
    """The delivering pool's stamp: the ``release`` stage (staged or
    published until now: the queue and reorder wait) and the ventilator's
    dispatch decision for the record's position, with the ``ventilate``
    stage (dispatch until decode starts)."""
    now = time.monotonic()
    staged = record.pop('_staged_t', None)
    stages = record.setdefault('stages', {})
    if staged is not None and now > staged:
        stages['release'] = [staged, now]
    position = record.get('position')
    take = getattr(ventilator, 'take_dispatch_meta', None)
    meta = take(position) if (take is not None and position is not None) else None
    if meta:
        t_dispatch = meta.pop('t_dispatch', None)
        if t_dispatch is not None:
            decode = stages.get('decode')
            end = decode[0] if decode else now
            if end > t_dispatch:
                stages['ventilate'] = [t_dispatch, end]
        decode = stages.get('decode')
        if decode is not None:
            meta.setdefault('actual_s', round(decode[1] - decode[0], 6))
        record['sched'] = meta
    return record


def record_wall(record):
    """A record's delivery wall in seconds: its earliest stage start to its
    latest stage end (0.0 without stages)."""
    stages = record.get('stages') or {}
    if not stages:
        return 0.0
    t0 = min(w[0] for w in stages.values())
    t1 = max(w[1] for w in stages.values())
    return max(0.0, t1 - t0)


def stage_coverage(record):
    """The share of a record's wall inside at least one of its stages (the
    union of the windows over the wall)."""
    stages = record.get('stages') or {}
    wall = record_wall(record)
    if not wall:
        return 0.0
    union = []
    for start, end in sorted(stages.values()):
        if union and start <= union[-1][1]:
            union[-1] = (union[-1][0], max(union[-1][1], end))
        else:
            union.append((start, end))
    covered = sum(end - start for start, end in union)
    return min(1.0, covered / wall)


class Provenanced(object):
    """A result and its record, travelling together through an in-process
    pool's queues, so that delivery pairs each result with exactly its
    record."""

    __slots__ = ('result', 'record')

    def __init__(self, result, record):
        self.result = result
        self.record = record


class ProvenanceJournal(object):
    """A consumer's bounded journal of sealed records.

    :meth:`seal` stamps the delivered batch's ``step`` (counting from 0),
    ``latency_ms`` (:func:`record_wall`) and ``sealed_unix``, appends the
    record to a ring of ``capacity`` and keeps the ``worst_k`` slowest
    records past the ring's eviction, so the run's slowest batch stays
    explainable.  Thread-safe: a dispatch thread seals while the flight
    recorder's thread peeks.
    """

    def __init__(self, capacity=512, worst_k=8, label=None):
        self._records = deque(maxlen=int(capacity))
        self._worst = []          # [(latency_ms, record)], ascending
        self._worst_k = int(worst_k)
        self._step = 0
        self.label = label
        self._lock = threading.Lock()
        _LIVE.add(self)

    def __getstate__(self):
        return {'capacity': self._records.maxlen, 'worst_k': self._worst_k,
                'label': self.label, 'records': self.records(), 'worst': self.worst()}

    def __setstate__(self, state):
        self.__init__(state['capacity'], state['worst_k'], state['label'])
        self._records.extend(state['records'])
        self._worst = sorted(((r.get('latency_ms', 0.0), r) for r in state['worst']),
                             key=lambda pair: pair[0])
        self._step = max((r.get('step', -1) for r in state['records']), default=-1) + 1

    def seal(self, record):
        """Stamp and journal one delivered batch's record; returns it."""
        with self._lock:
            record['step'] = self._step
            self._step += 1
            record['latency_ms'] = round(1e3 * record_wall(record), 3)
            record['sealed_unix'] = round(time.time(), 3)
            self._records.append(record)
            self._worst.append((record['latency_ms'], record))
            self._worst.sort(key=lambda pair: pair[0])
            del self._worst[:-self._worst_k]
        return record

    def get(self, step):
        """The record of delivered batch ``step``, or None once it left both
        the ring and the worst K."""
        with self._lock:
            for record in self._records:
                if record.get('step') == step:
                    return record
            for _, record in self._worst:
                if record.get('step') == step:
                    return record
        return None

    def records(self):
        with self._lock:
            return list(self._records)

    def worst(self, k=None):
        """The worst K records, slowest first."""
        with self._lock:
            worst = [record for _, record in reversed(self._worst)]
        return worst if k is None else worst[:int(k)]

    def worst_summary(self, k=3):
        """The worst K as :func:`summarize_record` lines (what a flight
        frame carries)."""
        return [summarize_record(record) for record in self.worst(k)]

    def __len__(self):
        with self._lock:
            return len(self._records)

    def dump(self):
        """The JSON-able dump ``explain --journal`` reads."""
        return {'kind': 'provenance_journal', 'pid': os.getpid(), 'label': self.label,
                'steps': self._step, 'records': self.records(), 'worst': self.worst()}

    def persist(self, path):
        """:meth:`dump` written atomically; the path, or None."""
        return atomic_json_dump(path, self.dump())


def summarize_record(record):
    """The one compact summary of a record, which flight frames, diagnose's
    slow-batch rule and every worst-K surface print."""
    piece = (record.get('pieces') or [{}])[0]
    return {
        'step': record.get('step'),
        'latency_ms': record.get('latency_ms'),
        'worker_pid': record.get('worker_pid'),
        'piece': ('%s:rg%s' % (piece.get('path'), piece.get('row_group'))
                  if piece.get('path') is not None else piece.get('index')),
        'cache': record.get('cache'),
        'transport': record.get('transport'),
    }


def journals():
    """Every live journal of this process."""
    return list(_LIVE)


def dump_journals():
    """The dumps of every live journal (crash artifacts, flight dumps)."""
    return [journal.dump() for journal in journals()]


def worst_summaries(k=4):
    """The worst K summaries over every live journal (what flight frames
    carry)."""
    out = []
    for journal in journals():
        out.extend(journal.worst_summary(k))
    out.sort(key=lambda row: -(row.get('latency_ms') or 0.0))
    return out[:int(k)]


class SloWatchdog(object):
    """A per-batch latency budget: a sealed record over it counts a
    violation (``slo_violations`` in ``metrics``) and dumps the whole
    journal, every batch's chain and not the violation's alone, to
    ``provenance_slo_<label>_<pid>.json`` under ``dump_dir`` (default
    ``PETASTORM_TPU_FLIGHT_DIR``; no directory, no dump).  At most one dump
    each ``min_interval_s``."""

    def __init__(self, journal, budget_s, label=None, dump_dir=None, min_interval_s=30.0,
                 metrics=None):
        self.journal = journal
        self.budget_s = float(budget_s)
        self.label = label or 'loader'
        self._dump_dir = dump_dir
        self._min_interval_s = float(min_interval_s)
        self._last_dump = 0.0
        self.violations = 0
        self._m_violations = metrics.counter('slo_violations') if metrics is not None else None

    def _dump_path(self):
        directory = self._dump_dir or os.environ.get('PETASTORM_TPU_FLIGHT_DIR')
        if not directory:
            return None
        return os.path.join(directory, 'provenance_slo_%s_%d.json' % (self.label, os.getpid()))

    def check(self, record):
        """Called on each sealed record; the dump's path when a violation was
        dumped, else None.  Never raises."""
        latency_ms = record.get('latency_ms') or 0.0
        if latency_ms <= 1e3 * self.budget_s:
            return None
        self.violations += 1
        if self._m_violations is not None:
            self._m_violations.inc()
        now = time.monotonic()
        if now - self._last_dump < self._min_interval_s:
            return None
        self._last_dump = now
        path = self._dump_path()
        if path is None:
            return None
        state = self.journal.dump()
        state['violation_step'] = record.get('step')
        state['budget_ms'] = round(1e3 * self.budget_s, 3)
        state['reason'] = 'slo_violation'
        return atomic_json_dump(path, state)

"""The control plane's decision journal: every autonomous action explains
itself.

Counterpart of ``petastorm_tpu/telemetry/decisions.py``, whole: the same
records, the same dump format (a dump written by either package restores in
the other) and the same replay rules.  Seven control laws of the system act
without a human in the loop (the fleet autoscaler, tenant scheduling and
quotas, cache-affinity lease routing, the materializer's admission, ingest
hedging, the scheduler's autotuner and the device-residency LRU); each
records here the **named rule** that fired and a snapshot of the inputs it
read, one compact JSON-able record per decision::

    {'actor': 'autoscaler', 'action': 'scale_in', 'rule': 'autoscale_idle_s',
     'inputs': {'pending': 0, 'leased': 0, 'alive': [...], 'idle_s': 31.0,
                'threshold_s': 30.0, 'coverage': {...}},
     'suppressed': False, 'worker_id': 'w3',
     'seq': 17, 't_mono': ..., 'unix_time': ..., 'cooldown_until': ...}

A suppressed non-action is a record too (``suppressed=True``): a cooldown
that vetoed a scale-out, a quota refusal.  Everything goes through one seam,
:func:`record_decision`.  Records ride the channels that exist: a worker's
heartbeat carries its process journal's payload (:func:`heartbeat_payload`)
to the dispatcher's rollup, and the dispatcher's own journal persists
through its ledger, so a restart keeps its history.

:func:`replay_decision` re-runs a record's input snapshot through a pure
re-statement of its control law and flags a record whose replay disagrees:
the code drifted from its own inputs, or the snapshot lies.  The rules of
the planes the port does not hold yet are here too: they are pure functions
on dicts, and a record another process wrote replays the same here.

Kill switch: ``PETASTORM_TPU_NO_DECISIONS=1`` makes :func:`record_decision`
a no-op returning None.  Every control law has decided before it records,
so the switch changes no delivery.  Standard library only.
"""

import os
import threading
import time
import weakref

__all__ = ['KILL_SWITCH', 'enabled', 'ACTORS', 'CATALOGUE', 'RECORD_REQUIRED_KEYS',
           'DecisionJournal', 'record_decision', 'default_journal', 'journals',
           'dump_journals', 'heartbeat_payload', 'recent_summaries', 'summarize_decision',
           'replay_decision', 'REPLAYS']

KILL_SWITCH = 'PETASTORM_TPU_NO_DECISIONS'


def enabled():
    """False when ``PETASTORM_TPU_NO_DECISIONS`` vetoes journaling."""
    return os.environ.get(KILL_SWITCH, '') in ('', '0')


#: The instrumented control laws.
ACTORS = ('autoscaler', 'tenant_sched', 'affinity', 'materialize', 'hedge', 'autotuner',
          'residency')

#: actor -> the actions and rules it may record.  A rule is the name of the
#: threshold of the control law that fired.
CATALOGUE = {
    'autoscaler': {
        'actions': ('scale_out', 'scale_in', 'hold'),
        'rules': ('autoscale_starve_s', 'autoscale_idle_s', 'autoscale_cooldown_s'),
    },
    'tenant_sched': {
        'actions': ('pick', 'refund', 'quota_refused'),
        'rules': ('wdrr_deficit', 'wdrr_refund', 'quota_budget'),
    },
    'affinity': {
        'actions': ('routed', 'deferred', 'deferral_exhausted'),
        'rules': ('affinity_min_coverage', 'affinity_defer_s'),
    },
    'materialize': {
        'actions': ('published', 'refuse_publish', 'poison_piece'),
        'rules': ('hot_window_s', 'max_piece_attempts'),
    },
    'hedge': {
        'actions': ('hedge', 'hedge_win', 'abandon'),
        'rules': ('hedge_deadline_s', 'checkout_timeout_s'),
    },
    'autotuner': {
        'actions': ('grow', 'shrink', 'hold'),
        'rules': ('skew_ratio_floor', 'wait_frac_floor', 'delivery_jitter',
                  'ingest_wait_grow_s', 'no_evidence_hold'),
    },
    'residency': {
        'actions': ('admitted', 'evicted', 'bypass', 'drop'),
        'rules': ('residency_budget',),
    },
}

#: Keys every record carries, whatever its actor.
RECORD_REQUIRED_KEYS = ('actor', 'action', 'rule', 'inputs', 'suppressed', 'seq', 't_mono',
                        'unix_time')

#: The ring's bound: at <= 1 Hz per actor, tens of minutes of history.
DEFAULT_CAPACITY = 256

#: The last real (not suppressed) record of each (actor, action) outlives
#: the ring: "when did this controller last act" survives a storm of holds.
_NOTABLE_CAP = 32


class DecisionJournal(object):
    """A bounded ring of decision records, the last real action of each
    (actor, action) kept past the ring, per-actor counters, and a JSON-able
    :meth:`dump` that :meth:`restore` takes back (the shape the dispatcher's
    ledger persists).  ``on_record``, when set, is called after each record,
    outside the journal's lock (the dispatcher marks its ledger dirty
    there).  Pickles by content."""

    def __init__(self, capacity=DEFAULT_CAPACITY, label=None):
        self.capacity = int(capacity)
        self.label = label
        self.on_record = None
        self._lock = threading.Lock()
        self._records = []
        self._notable = {}        # (actor, action) -> last real record
        self._counts = {}         # actor -> {'actions': n, 'suppressed': n}
        self._seq = 0
        self._restores = 0
        _LIVE.add(self)

    def record(self, actor, action, rule, inputs, suppressed=False, cooldown_until=None,
               **extra):
        """Append one record and return it (a plain dict)."""
        rec = dict(extra)
        rec.update({
            'actor': actor,
            'action': action,
            'rule': rule,
            'inputs': inputs,
            'suppressed': bool(suppressed),
            't_mono': time.monotonic(),
            'unix_time': time.time(),
        })
        if cooldown_until is not None:
            rec['cooldown_until'] = cooldown_until
        with self._lock:
            rec['seq'] = self._seq
            self._seq += 1
            self._records.append(rec)
            del self._records[:-self.capacity]
            counts = self._counts.setdefault(actor, {'actions': 0, 'suppressed': 0})
            counts['suppressed' if suppressed else 'actions'] += 1
            if not suppressed:
                self._notable[(actor, action)] = rec
                while len(self._notable) > _NOTABLE_CAP:
                    self._notable.pop(next(iter(self._notable)))
        hook = self.on_record
        if hook is not None:
            try:
                hook(rec)
            except Exception:  # noqa: BLE001 — a diagnostic never takes its host down
                pass
        return rec

    # -- reading -------------------------------------------------------------

    def records(self):
        with self._lock:
            return list(self._records)

    def last(self, actor, suppressed=None):
        """The newest record of ``actor`` (``suppressed`` filters when set):
        the ring first, then the kept real actions."""
        with self._lock:
            for rec in reversed(self._records):
                if rec['actor'] != actor:
                    continue
                if suppressed is not None and rec['suppressed'] != suppressed:
                    continue
                return rec
            if suppressed in (None, False):
                best = None
                for (a, _), rec in self._notable.items():
                    if a == actor and (best is None or rec['seq'] > best['seq']):
                        best = rec
                return best
        return None

    def counts(self):
        with self._lock:
            return {actor: dict(c) for actor, c in self._counts.items()}

    def summary(self, now=None):
        """Per actor: its action and suppression counts and its last real
        action with its age."""
        now = time.monotonic() if now is None else now
        out = {}
        with self._lock:
            notable = dict(self._notable)
            counts = {actor: dict(c) for actor, c in self._counts.items()}
        for actor, c in counts.items():
            best = None
            for (a, _), rec in notable.items():
                if a == actor and (best is None or rec['seq'] > best['seq']):
                    best = rec
            row = dict(c)
            row['last'] = summarize_decision(best, now=now) if best else None
            out[actor] = row
        return out

    def dump(self):
        """The ring, the kept real actions, the counters and the identity,
        JSON-able."""
        with self._lock:
            return {
                'kind': 'decision_journal',
                'pid': os.getpid(),
                'label': self.label,
                'seq': self._seq,
                'restores': self._restores,
                'records': list(self._records),
                'notable': [rec for rec in self._notable.values()],
                'counts': {actor: dict(c) for actor, c in self._counts.items()},
            }

    def restore(self, state):
        """Take back a :meth:`dump` (the dispatcher's restart).  The records
        come back as they were: the same seq, inputs and monotonic stamps
        (of the dead process's clock; ``unix_time`` orders across restarts).
        Never raises: a corrupt section loses history, not the dispatcher.
        Returns whether it restored."""
        if not isinstance(state, dict) or state.get('kind') != 'decision_journal':
            return False
        try:
            records = [dict(r) for r in state.get('records') or () if isinstance(r, dict)]
            notable = [dict(r) for r in state.get('notable') or () if isinstance(r, dict)]
            counts = {str(a): {'actions': int(c.get('actions', 0)),
                               'suppressed': int(c.get('suppressed', 0))}
                      for a, c in (state.get('counts') or {}).items() if isinstance(c, dict)}
            seq = int(state.get('seq', len(records)))
        except (TypeError, ValueError, AttributeError):
            return False
        with self._lock:
            self._records = records[-self.capacity:]
            self._notable = {(r.get('actor'), r.get('action')): r for r in notable}
            self._counts = counts
            self._seq = max(seq, self._seq)
            self._restores = int(state.get('restores', 0) or 0) + 1
        return True

    def opposing_actions(self, window_s=60.0, now=None):
        """Per actor, the pairs of opposing real actions inside the window
        (scale_out and scale_in, admitted and evicted): a controller that
        did both is oscillating."""
        now = time.monotonic() if now is None else now
        horizon = now - float(window_s)
        opposing = {'autoscaler': ('scale_out', 'scale_in'),
                    'residency': ('admitted', 'evicted')}
        tally = {}
        with self._lock:
            recent = [r for r in self._records if not r['suppressed'] and r['t_mono'] >= horizon]
        for actor, (a, b) in opposing.items():
            na = sum(1 for r in recent if r['actor'] == actor and r['action'] == a)
            nb = sum(1 for r in recent if r['actor'] == actor and r['action'] == b)
            pairs = min(na, nb)
            if pairs:
                tally[actor] = pairs
        return tally

    # -- pickling, by content ------------------------------------------------

    def __getstate__(self):
        state = self.dump()
        state['capacity'] = self.capacity
        return state

    def __setstate__(self, state):
        self.__init__(capacity=state.get('capacity', DEFAULT_CAPACITY), label=state.get('label'))
        self.restore(state)
        self._restores = int(state.get('restores', 0) or 0)


def summarize_decision(record, now=None):
    """A compact reference to one record (identity and age, never the
    inputs), for bounded channels."""
    if record is None:
        return None
    now = time.monotonic() if now is None else now
    out = {'actor': record.get('actor'),
           'action': record.get('action'),
           'rule': record.get('rule'),
           'suppressed': record.get('suppressed'),
           'seq': record.get('seq'),
           'age_s': round(max(0.0, now - record.get('t_mono', now)), 1)}
    for key in ('worker_id', 'tenant'):
        if record.get(key) is not None:
            out[key] = record[key]
    return out


# -- the process's journals ----------------------------------------------------

_LIVE = weakref.WeakSet()
_DEFAULT = None
_DEFAULT_PID = None
_DEFAULT_LOCK = threading.Lock()


def default_journal(label=None):
    """The process's journal, made at first use and anew after a fork.  A
    control law with no journal of its own records here; the dispatcher
    passes its ledger-persisted journal instead."""
    global _DEFAULT, _DEFAULT_PID
    pid = os.getpid()
    with _DEFAULT_LOCK:
        if _DEFAULT is None or _DEFAULT_PID != pid:
            _DEFAULT = DecisionJournal(label=label or 'proc')
            _DEFAULT_PID = pid
        return _DEFAULT


def record_decision(actor, action, rule, inputs, suppressed=False, cooldown_until=None,
                    journal=None, **extra):
    """The one seam every control law records through.  Returns the record,
    or None under the kill switch.  The caller has decided (and acted)
    already: this call only remembers."""
    if not enabled():
        return None
    target = journal if journal is not None else default_journal()
    return target.record(actor, action, rule, inputs, suppressed=suppressed,
                         cooldown_until=cooldown_until, **extra)


def journals():
    """Every live journal of this process."""
    return [j for j in _LIVE]


def dump_journals():
    """A :meth:`DecisionJournal.dump` of every live journal."""
    return [j.dump() for j in journals()]


def heartbeat_payload(k=8):
    """What a worker's heartbeat carries: the process journal's per-actor
    summary and its newest ``k`` full records."""
    journal = default_journal()
    return {'summary': journal.summary(), 'recent': journal.records()[-int(k):]}


def recent_summaries(k=6, now=None):
    """The newest ``k`` compact references across every live journal."""
    now = time.monotonic() if now is None else now
    recent = []
    for journal in journals():
        recent.extend(journal.records()[-k:])
    recent.sort(key=lambda r: (r.get('t_mono', 0.0), r.get('seq', 0)))
    return [summarize_decision(r, now=now) for r in recent[-k:]]


# -- the replay ----------------------------------------------------------------
#
# One pure function per rule, stating the control law again over the
# record's input snapshot alone.  Each returns the fields it expects
# ('action' always; 'worker_id' or 'tenant' where the law also picks a victim
# or a winner); replay_decision compares them with the record.  Written apart
# from the live code on purpose: a shared helper would make the check
# tautological.

REPLAYS = {}


def _replay(rule):
    def register(fn):
        REPLAYS[rule] = fn
        return fn
    return register


@_replay('autoscale_starve_s')
def _replay_starve(inputs):
    starved = (int(inputs.get('pending', 0)) > 0
               and (not inputs.get('alive') or int(inputs.get('free_slots', 0)) == 0))
    ripe = float(inputs.get('starve_s', 0.0)) >= float(inputs.get('threshold_s', 0.0))
    want = min(int(inputs.get('step', 1)),
               int(inputs.get('max_workers', 0)) - len(inputs.get('alive') or ()))
    cooled = float(inputs.get('cooldown_remaining_s', 0.0)) <= 0.0
    if starved and ripe and want > 0 and cooled:
        return {'action': 'scale_out'}
    return {'action': 'hold'}


@_replay('autoscale_idle_s')
def _replay_idle(inputs):
    alive = list(inputs.get('alive') or ())
    idle = int(inputs.get('pending', 0)) == 0 and int(inputs.get('leased', 0)) == 0 and alive
    ripe = float(inputs.get('idle_s', 0.0)) >= float(inputs.get('threshold_s', 0.0))
    roomy = len(alive) > int(inputs.get('min_workers', 0))
    cooled = float(inputs.get('cooldown_remaining_s', 0.0)) <= 0.0
    if not (idle and ripe and roomy and cooled):
        return {'action': 'hold'}
    coverage = inputs.get('coverage') or {}
    victim = min(alive, key=lambda wid: (coverage.get(wid, 0), wid))
    return {'action': 'scale_in', 'worker_id': victim}


@_replay('autoscale_cooldown_s')
def _replay_cooldown(inputs):
    if float(inputs.get('cooldown_remaining_s', 0.0)) > 0.0 or int(inputs.get('want', 1)) <= 0:
        return {'action': 'hold'}
    return {'action': inputs.get('wanted', 'hold')}


@_replay('wdrr_deficit')
def _replay_wdrr(inputs):
    eligible = list(inputs.get('eligible') or ())
    if not eligible:
        return {'action': 'pick', 'tenant': None}
    if len(eligible) == 1:
        return {'action': 'pick', 'tenant': eligible[0]['tenant']}
    clamp = float(inputs.get('deficit_clamp', 8.0))
    total = sum(float(e.get('weight', 1.0)) for e in eligible) or float(len(eligible))
    best, best_deficit = None, None
    for entry in eligible:
        share = (float(entry.get('weight', 1.0)) / total) if total else 1.0 / len(eligible)
        deficit = float(entry.get('deficit', 0.0)) + share
        deficit = max(-clamp, min(clamp, deficit))
        if best is None or deficit > best_deficit:
            best, best_deficit = entry, deficit
    return {'action': 'pick', 'tenant': best['tenant']}


@_replay('wdrr_refund')
def _replay_refund(inputs):
    return {'action': 'refund'}


@_replay('quota_budget')
def _replay_quota(inputs):
    budget = inputs.get('budget')
    refused = budget is not None and \
        int(inputs.get('used', 0)) + int(inputs.get('nbytes', 0)) > int(budget)
    return {'action': 'quota_refused' if refused else 'pick'}


@_replay('affinity_min_coverage')
def _replay_affinity(inputs):
    if float(inputs.get('coverage', 0.0)) >= float(inputs.get('min_coverage', 0.5)):
        return {'action': 'routed'}
    return {'action': 'deferred'}


@_replay('affinity_defer_s')
def _replay_affinity_exhausted(inputs):
    if float(inputs.get('waited_s', 0.0)) >= float(inputs.get('defer_s', 0.0)):
        return {'action': 'deferral_exhausted'}
    return {'action': 'deferred'}


@_replay('hot_window_s')
def _replay_hot_window(inputs):
    fits = inputs.get('fits')
    if fits is not None:
        newest = inputs.get('victim_newest_age_s')
        admitted = bool(fits) or newest is None \
            or float(newest) >= float(inputs.get('hot_window_s', 300.0))
    else:
        # no eviction estimate in the snapshot: the recorded verdict is all
        # there is
        admitted = bool(inputs.get('admitted'))
    return {'action': 'published' if admitted else 'refuse_publish'}


@_replay('max_piece_attempts')
def _replay_poison(inputs):
    if int(inputs.get('attempts', 0)) >= int(inputs.get('max_attempts', 0)):
        return {'action': 'poison_piece'}
    return {'action': 'published'}


@_replay('hedge_deadline_s')
def _replay_hedge(inputs):
    if inputs.get('won'):
        # an outcome (the hedge's fetch landed first), not a threshold
        return {'action': 'hedge_win'}
    deadline = inputs.get('deadline_s')
    if deadline is None:
        return {'action': 'hold'}
    if float(inputs.get('blocked_s', 0.0)) >= float(deadline):
        return {'action': 'hedge'}
    return {'action': 'hold'}


@_replay('checkout_timeout_s')
def _replay_abandon(inputs):
    if float(inputs.get('blocked_s', 0.0)) >= float(inputs.get('timeout_s', 0.0)):
        return {'action': 'abandon'}
    return {'action': 'hold'}


@_replay('skew_ratio_floor')
def _replay_skew(inputs):
    ratio = inputs.get('skew_ratio')
    if ratio is None:
        return {'action': 'hold'}
    if float(ratio) >= float(inputs.get('floor', 8.0)):
        return {'action': 'grow'}
    return {'action': 'shrink'}


@_replay('wait_frac_floor')
def _replay_wait_frac(inputs):
    if float(inputs.get('wait_frac', 0.0)) > float(inputs.get('floor', 0.1)):
        return {'action': 'grow'}
    return {'action': 'shrink'}


@_replay('delivery_jitter')
def _replay_jitter(inputs):
    jitter = float(inputs.get('hb_p99', 0.0)) \
        > float(inputs.get('slow_factor', 4.0)) * float(inputs.get('dp_p99', 0.0))
    return {'action': 'grow' if jitter else 'shrink'}


@_replay('ingest_wait_grow_s')
def _replay_ingest_wait(inputs):
    if float(inputs.get('d_wait_s', 0.0)) > float(inputs.get('grow_s', 0.05)):
        return {'action': 'grow'}
    if int(inputs.get('d_fetches', 0)) > 0:
        return {'action': 'shrink'}
    return {'action': 'hold'}


@_replay('no_evidence_hold')
def _replay_no_evidence(inputs):
    return {'action': 'hold'}


@_replay('residency_budget')
def _replay_residency(inputs):
    if 'rows' not in inputs:
        return None   # a 'drop' record carries no allocator snapshot
    rows = int(inputs['rows'])
    capacity = int(inputs.get('capacity', 0))
    if inputs.get('dropped') or rows == 0 or rows > capacity:
        return {'action': 'bypass'}
    # the allocator over the snapshot before the admission: a free segment
    # of the exact size, else bump allocation, evicting the least recently
    # used entries (their segments do not coalesce) until the batch fits or
    # the tier is empty
    free = [int(r) for r in inputs.get('free_rows') or ()]
    entries = [int(r) for r in inputs.get('entry_rows') or ()]
    bump = int(inputs.get('bump', 0))

    def _fits():
        nonlocal bump
        if rows in free:
            free.remove(rows)
            return True
        if bump + rows <= capacity:
            bump += rows
            return True
        return False

    evicted = False
    ok = _fits()
    while not ok and entries:
        free.append(entries.pop(0))
        evicted = True
        ok = _fits()
    if not ok:
        return {'action': 'bypass'}
    return {'action': 'evicted' if evicted else 'admitted'}


def replay_knob_step(inputs):
    """The autotuner's clamped step: ``max(lo, min(hi, round(current *
    factor)))``, or None without the inputs."""
    current = inputs.get('current')
    factor = inputs.get('factor')
    if current is None or factor is None:
        return None
    expected = int(round(int(current) * float(factor)))
    lo, hi = inputs.get('lo'), inputs.get('hi')
    if lo is not None:
        expected = max(int(lo), expected)
    if hi is not None:
        expected = min(int(hi), expected)
    return expected


def replay_decision(record):
    """Replay one record's input snapshot through its pure control law.

    Returns ``{'rule', 'seq', 'actor', 'verdict', 'recorded', 'replayed'}``;
    the verdict is ``'match'`` (every replayed field agrees),
    ``'divergent'`` (the law disagrees with what the code did) or
    ``'unchecked'`` (no replay for the rule, or an unusable snapshot).
    """
    rule = record.get('rule')
    fn = REPLAYS.get(rule)
    result = {'rule': rule, 'seq': record.get('seq'), 'actor': record.get('actor')}
    if fn is None or not isinstance(record.get('inputs'), dict):
        result.update(verdict='unchecked', recorded=None, replayed=None)
        return result
    inputs = record['inputs']
    try:
        expected = fn(inputs)
    except Exception as e:  # noqa: BLE001 — an unreplayable snapshot is a verdict
        result.update(verdict='unchecked', recorded=None,
                      replayed='replay raised %s: %s' % (type(e).__name__, e))
        return result
    if expected is None:
        result.update(verdict='unchecked', recorded=None, replayed=None)
        return result
    recorded = {key: record.get(key) for key in expected}
    divergent = any(recorded.get(key) != value for key, value in expected.items())
    # an autotuner's knob record also pins the clamped arithmetic
    if not divergent and record.get('actor') == 'autotuner' and record.get('new') is not None:
        want = replay_knob_step(inputs)
        if want is not None and int(record['new']) != want:
            divergent = True
            expected = dict(expected, new=want)
            recorded = dict(recorded, new=record.get('new'))
    result.update(verdict='divergent' if divergent else 'match', recorded=recorded,
                  replayed=expected)
    return result

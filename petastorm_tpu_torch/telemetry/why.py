"""``why`` — why did the control plane do that?

Counterpart of ``petastorm_tpu/telemetry/why.py`` (``petastorm-tpu-why``),
run as ``python -m petastorm_tpu_torch.telemetry.why``.

``explain`` reconstructs where a *batch* came from; this tool answers
the control-plane question: **why did an autonomous controller act (or
refuse to act)?**  It reads decision journals from any of
the artifacts that carry one —

* a **live dispatcher** (``--dispatcher tcp://host:port``): the
  ``decisions`` RPC returns the dispatcher's ledger-persisted journal
  plus the newest worker-side records from heartbeats;
* a **flight-recorder dump** (``--flight path.json``): its top level
  carries every live journal of the dumping process;
* a **watchdog artifact** (``--artifact path.json``): the
  ``telemetry.dump_state()`` shape (a crash dump of a process);

— and renders, per decision, the named rule that fired, the input
snapshot the rule read, and the preceding *related* decisions (same
actor / worker / tenant) as a causal timeline.  Suppressed non-actions
(cooldown vetoes, quota refusals, hot-window publish refusals) are
first-class — "why did nothing happen" is a query too::

    $ petastorm-tpu-why --dispatcher tcp://dispatch:7777 --worker w3
    $ petastorm-tpu-why --flight flight_dispatcher_112.json --tenant teamA
    $ petastorm-tpu-why --artifact telemetry_dump.json --actor materialize
    $ petastorm-tpu-why --flight dump.json --check

``--check`` runs the determinism cross-check instead: every ingested
record's input snapshot is replayed through the pure re-statement of
its control law (:func:`decisions.replay_decision`) and divergence is
flagged — a record whose replay disagrees means the code drifted from
its own inputs, which is a bug.

Exit codes: 0 report produced (``--check``: no divergence), 1 input
unreachable/unparseable, no matching decision, or ``--check`` found a
divergent record, 2 usage error.  Nothing here loads torch.
"""

import argparse
import json
import sys
import time

from petastorm_tpu_torch.telemetry import decisions

__all__ = ['load_decisions', 'filter_records', 'related_before',
           'format_decision', 'check_records', 'main']

#: Inputs rendered inline; bulky snapshot members (tables, coverage
#: maps) are summarised to their sizes in the one-line form.
_INLINE_INPUT_CAP = 8


def load_decisions(state):
    """Every decision record reachable in an artifact dict, sorted by
    ``(unix_time, seq)``, plus ingest metadata.  Accepts journal dumps,
    the dispatcher ``decisions`` RPC reply, flight dumps, and watchdog
    artifacts; raises ValueError when no journal is present."""
    journals = []
    extra = []  # (origin, record) pairs outside any journal dump
    kind = state.get('kind')
    if kind == 'decision_journal':
        journals = [state]
    elif isinstance(state.get('journal'), dict) \
            and state['journal'].get('kind') == 'decision_journal':
        # Live-dispatcher reply: the dispatcher's own journal plus the
        # newest worker records relayed through heartbeats.
        journals = [state['journal']]
        for wid, payload in (state.get('workers') or {}).items():
            for rec in (payload or {}).get('recent') or ():
                if isinstance(rec, dict):
                    extra.append(('heartbeat/%s' % wid, rec))
    elif kind == 'flight_recorder':
        journals = list(state.get('decisions') or [])
    else:  # telemetry.dump_state artifact (or a flight dump inside it)
        journals = list(state.get('decisions') or [])
        flight = state.get('flight')
        if flight:
            journals.extend(flight.get('decisions') or [])
    records = []
    seen = set()
    restores = 0
    for journal in journals:
        origin = '%s/%s' % (journal.get('label') or 'journal',
                            journal.get('pid'))
        restores = max(restores, int(journal.get('restores', 0) or 0))
        # The ring first, then the rarest-K survivors (real actions that
        # outlived ring eviction) — dedup by (origin, seq).
        for rec in list(journal.get('records') or ()) + \
                list(journal.get('notable') or ()):
            if not isinstance(rec, dict):
                continue
            key = (origin, rec.get('seq'))
            if key in seen:
                continue
            seen.add(key)
            records.append(dict(rec, journal=origin))
    for origin, rec in extra:
        key = (origin, rec.get('seq'))
        if key not in seen:
            seen.add(key)
            records.append(dict(rec, journal=origin))
    if not records:
        raise ValueError(
            'no decision journal in this artifact — was the producing '
            'run started with %s=1?' % decisions.KILL_SWITCH)
    # unix_time is the only clock comparable across processes and
    # restarts (monotonic stamps die with their process).
    records.sort(key=lambda r: (r.get('unix_time', 0.0), r.get('seq', 0)))
    meta = {'journals': sorted({r['journal'] for r in records}),
            'actors': sorted({r.get('actor') for r in records
                              if r.get('actor')}),
            'restores': restores,
            'total': len(records)}
    return records, meta


def _mentions_worker(record, worker_id):
    if record.get('worker_id') == worker_id:
        return True
    # The autoscaler's scale_out records carry ``spawned`` as a COUNT
    # (the ids only exist once the workers register themselves); a
    # list-shaped value names explicit ids.
    spawned = record.get('spawned')
    return isinstance(spawned, (list, tuple)) and worker_id in spawned


def filter_records(records, actor=None, action=None, rule=None,
                   worker=None, tenant=None):
    """The records a why-question selects.  ``worker`` matches records
    that acted ON that worker (drain victim, spawn, affinity route);
    ``tenant`` matches grants/refunds/refusals charged to it."""
    out = records
    if actor is not None:
        out = [r for r in out if r.get('actor') == actor]
    if action is not None:
        out = [r for r in out if r.get('action') == action]
    if rule is not None:
        out = [r for r in out if r.get('rule') == rule]
    if worker is not None:
        out = [r for r in out if _mentions_worker(r, worker)]
    if tenant is not None:
        out = [r for r in out if r.get('tenant') == tenant]
    return out


def related_before(records, record, k=4):
    """The newest-k records preceding ``record`` that share its actor,
    worker, or tenant — the causal timeline: the cooldown hold before a
    scale-out, the deferrals before a deferral_exhausted route."""
    key = (record.get('unix_time', 0.0), record.get('seq', 0))
    related = []
    for other in records:
        if other is record:
            continue
        if (other.get('unix_time', 0.0), other.get('seq', 0)) >= key:
            continue
        if other.get('actor') == record.get('actor') \
                or (record.get('worker_id') is not None
                    and _mentions_worker(other, record['worker_id'])) \
                or (record.get('tenant') is not None
                    and other.get('tenant') == record.get('tenant')):
            related.append(other)
    return related[-k:]


def _fmt_value(value):
    if isinstance(value, float):
        return '%.6g' % value
    if isinstance(value, (list, tuple)) and len(value) > 4:
        return '[%d items]' % len(value)
    if isinstance(value, dict) and len(value) > 4:
        return '{%d keys}' % len(value)
    return json.dumps(value, default=str) \
        if isinstance(value, (dict, list)) else str(value)


def _fmt_inputs(inputs):
    if not isinstance(inputs, dict):
        return str(inputs)
    items = sorted(inputs.items())
    shown = ['%s=%s' % (k, _fmt_value(v))
             for k, v in items[:_INLINE_INPUT_CAP]]
    if len(items) > _INLINE_INPUT_CAP:
        shown.append('(+%d more)' % (len(items) - _INLINE_INPUT_CAP))
    return ' '.join(shown)


def _age(record, ref_unix):
    t = record.get('unix_time')
    if t is None:
        return '?'
    return 't-%.1fs' % max(0.0, ref_unix - t)


def format_decision(record, ref_unix=None, brief=False):
    """One record -> human-readable line(s).  ``brief`` is the one-line
    timeline form; the full form adds the input snapshot."""
    ref_unix = time.time() if ref_unix is None else ref_unix
    subject = ''
    spawned = record.get('spawned')
    if record.get('worker_id') is not None:
        subject = ' %s' % record['worker_id']
    elif isinstance(spawned, (list, tuple)) and spawned:
        subject = ' %s' % ','.join(str(w) for w in spawned)
    elif spawned:
        subject = ' %d worker(s)' % spawned
    elif record.get('tenant') is not None:
        subject = ' tenant %s' % record['tenant']
    head = '#%s [%s] %s%s — rule %s%s  (%s, %s)' % (
        record.get('seq'), record.get('actor'), record.get('action'),
        subject, record.get('rule'),
        ' SUPPRESSED' if record.get('suppressed') else '',
        record.get('journal', '?'), _age(record, ref_unix))
    if brief:
        return head
    lines = [head,
             '    inputs: %s' % _fmt_inputs(record.get('inputs'))]
    if record.get('cooldown_until') is not None:
        lines.append('    cooldown_until: %s (monotonic)'
                     % record['cooldown_until'])
    return '\n'.join(lines)


def check_records(records):
    """Determinism cross-check over every record: replay each input
    snapshot through the pure control law.  Returns ``(counts,
    divergent)`` where counts maps verdict -> n."""
    counts = {'match': 0, 'divergent': 0, 'unchecked': 0}
    divergent = []
    for record in records:
        verdict = decisions.replay_decision(record)
        counts[verdict['verdict']] += 1
        if verdict['verdict'] == 'divergent':
            divergent.append({'record': record, 'verdict': verdict})
    return counts, divergent


def _poll_dispatcher(addr, timeout_s):
    import zmq

    from petastorm_tpu_torch.service.worker import _Rpc
    context = zmq.Context()
    rpc = _Rpc(context, addr, timeout_s=timeout_s)
    try:
        return rpc.call({'op': 'decisions'})
    finally:
        rpc.close()
        context.term()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-why', description=__doc__.split('\n\n')[0])
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument('--dispatcher',
                        help='live dispatcher endpoint (tcp://host:port)')
    source.add_argument('--flight',
                        help='flight-recorder dump file (JSON)')
    source.add_argument('--artifact',
                        help='telemetry.dump_state() dump file '
                             '(JSON)')
    parser.add_argument('--actor', choices=decisions.ACTORS,
                        help='only this control law')
    parser.add_argument('--action',
                        help='only this action (e.g. scale_in, '
                             'refuse_publish)')
    parser.add_argument('--rule', help='only decisions this rule made')
    parser.add_argument('--worker',
                        help='why was this worker drained/spawned/routed-to')
    parser.add_argument('--tenant',
                        help='why did this tenant get its grants/refusals')
    parser.add_argument('--last', type=int, default=5,
                        help='explain the newest K matching decisions '
                             '(default 5)')
    parser.add_argument('--check', action='store_true',
                        help='replay every matching record through the '
                             'pure control law and flag divergence')
    parser.add_argument('--json', action='store_true',
                        help='emit the report as JSON')
    parser.add_argument('--rpc-timeout', type=float, default=10.0)
    args = parser.parse_args(argv)

    source_name = args.dispatcher or args.flight or args.artifact
    try:
        if args.dispatcher:
            state = _poll_dispatcher(args.dispatcher, args.rpc_timeout)
        else:
            with open(source_name) as f:
                state = json.load(f)
        records, meta = load_decisions(state)
    except Exception as e:  # noqa: BLE001 — report, exit nonzero
        print('cannot ingest %s: %s: %s'
              % (source_name, type(e).__name__, e), file=sys.stderr)
        return 1

    matching = filter_records(records, actor=args.actor,
                              action=args.action, rule=args.rule,
                              worker=args.worker, tenant=args.tenant)
    # Age reference: live mode uses the wall clock; a file dump uses its
    # own newest stamp (ages then read "seconds before the dump").
    ref_unix = (time.time() if args.dispatcher
                else max((r.get('unix_time', 0.0) for r in records),
                         default=0.0))

    if args.check:
        counts, divergent = check_records(matching)
        if args.json:
            print(json.dumps(
                {'meta': meta, 'counts': counts,
                 'divergent': [d['verdict'] for d in divergent]},
                sort_keys=True, default=str))
        else:
            print('petastorm-tpu-why --check — %s: %d match, '
                  '%d divergent, %d unchecked (of %d)'
                  % (source_name, counts['match'], counts['divergent'],
                     counts['unchecked'], len(matching)))
            for item in divergent:
                print('DIVERGENT ' + format_decision(item['record'],
                                                     ref_unix))
                print('    recorded: %s' % item['verdict']['recorded'])
                print('    replayed: %s' % item['verdict']['replayed'])
        return 1 if divergent else 0

    chosen = matching[-max(1, args.last):]
    if not chosen:
        print('no decision matches that question (%d records from %s; '
              'actors: %s) — aged out of the %d-deep ring?'
              % (meta['total'], ', '.join(meta['journals']),
                 ', '.join(meta['actors']), decisions.DEFAULT_CAPACITY),
              file=sys.stderr)
        return 1

    if args.json:
        rows = []
        for record in chosen:
            rows.append({'record': record,
                         'related': related_before(records, record)})
        print(json.dumps({'meta': meta, 'decisions': rows},
                         sort_keys=True, default=str))
        return 0

    print('petastorm-tpu-why — %s (%d decision(s) match, of %d from %s%s)'
          % (source_name, len(matching), meta['total'],
             ', '.join(meta['journals']),
             '; survived %d restart(s)' % meta['restores']
             if meta['restores'] else ''))
    for record in chosen:
        print(format_decision(record, ref_unix))
        related = related_before(records, record)
        if related:
            print('  preceding related decisions:')
            for other in related:
                print('    %s' % format_decision(other, ref_unix,
                                                 brief=True))
    return 0


if __name__ == '__main__':
    sys.exit(main())

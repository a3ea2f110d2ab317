"""``explain`` — reconstruct the causal chain of a batch.

Counterpart of ``petastorm_tpu/telemetry/explain.py`` (``petastorm-tpu-explain``),
run as ``python -m petastorm_tpu_torch.telemetry.explain``.

``diagnose`` says *what regime* the fleet is in; this tool answers the
per-batch question: **where did batch N come from and where did its
latency go?**  It reads a provenance journal from any of the
artifacts that carry one —

* a **journal dump** (``--journal path.json``): written by
  ``DataLoader.dump_provenance(path)`` or auto-dumped by the per-batch
  SLO watchdog (``provenance_slo_<label>_<pid>.json`` under
  ``PETASTORM_TPU_FLIGHT_DIR``);
* a **flight-recorder dump** (``--flight path.json``): the bounded ring
  a process persisted — its top level carries every live journal, and
  frames carry the rolling worst-K summaries;
* a **watchdog artifact** (``--artifact path.json``): the
  ``telemetry.dump_state()`` shape (a crash dump of a process);

— and renders, per record, the full chain: the stage timeline
(ventilate → decode → serialize → IPC → release → h2d
stage/dispatch/commit) with durations and share of the batch wall, the
producing worker (pid + host), the actual rowgroups (file + rowgroup),
the scheduling decision (FIFO vs early-launched, predicted vs actual
cost), and the cache / transport / transfer outcomes::

    $ petastorm-tpu-explain --journal journal.json --worst 3
    $ petastorm-tpu-explain --flight flight_trainer_112.json --step 41
    $ petastorm-tpu-explain --artifact telemetry_dump.json --json

Exit codes: 0 report produced, 1 input unreachable/unparseable or the
requested step unknown, 2 usage error.  Nothing here loads torch.
"""

import argparse
import json
import sys

from petastorm_tpu_torch.telemetry import provenance

__all__ = ['load_records', 'explain_record', 'format_chain', 'main']


def load_records(state):
    """Every provenance record reachable in an artifact dict, plus its
    journal metadata.  Accepts journal dumps, flight dumps, and watchdog
    artifacts; raises ValueError when no journal is present."""
    kind = state.get('kind')
    if kind == 'provenance_journal':
        journals = [state]
    elif kind == 'flight_recorder':
        journals = list(state.get('provenance') or [])
    else:  # telemetry.dump_state artifact (or a flight dump inside it)
        journals = list(state.get('provenance') or [])
        flight = state.get('flight')
        if flight:
            journals.extend(flight.get('provenance') or [])
    records = {}
    for journal in journals:
        origin = '%s/%s' % (journal.get('label') or 'journal',
                            journal.get('pid'))
        for record in list(journal.get('records') or ()) + \
                list(journal.get('worst') or ()):
            step = record.get('step')
            if step is None:
                continue
            record = dict(record, journal=origin)
            # Journals number steps independently, so an artifact
            # carrying several (two loaders, dump_state) can collide on
            # a step — keep EVERY record per step (a worst-list entry
            # duplicating a ring entry of the same journal dedups).
            bucket = records.setdefault(step, [])
            if record not in bucket:
                bucket.append(record)
    if not records:
        raise ValueError(
            'no provenance journal in this artifact — was the producing '
            'run started with PETASTORM_TPU_NO_PROVENANCE=1?')
    meta = {'steps': max((j.get('steps') or 0) for j in journals),
            'labels': sorted({j.get('label') for j in journals
                              if j.get('label')}),
            'violation_step': state.get('violation_step'),
            'budget_ms': state.get('budget_ms')}
    return records, meta


#: Chain rendering order — the pipeline's causal order; unknown stage
#: names sort after these, by start time.
_STAGE_ORDER = ('ventilate', 'decode', 'cache_fill', 'serve_cached',
                'serialize', 'ipc', 'release', 'client_buffer',
                'host_batch', 'transform', 'h2d_stage', 'h2d_dispatch',
                'h2d_commit')


def explain_record(record):
    """One record -> a JSON-able explanation dict (the ``--json`` row
    shape): ordered stages with offsets/durations/percent-of-wall, the
    coverage fraction, and the identity fields."""
    stages = record.get('stages') or {}
    busy_ms = record.get('stage_busy_ms') or {}
    wall_s = provenance.record_wall(record)
    origin = min((w[0] for w in stages.values()), default=0.0)
    rows = []
    order = {name: i for i, name in enumerate(_STAGE_ORDER)}
    for name, (t0, t1) in sorted(
            stages.items(),
            key=lambda kv: (order.get(kv[0], len(order)), kv[1][0])):
        # Stages recorded as per-chunk spans interleaved with another
        # stage ship a summed BUSY time next to the envelope window
        # (service serialize / cache_fill): the duration column reports
        # busy — the envelope alone would claim most of the split wall.
        dur = busy_ms.get(name, round(1e3 * (t1 - t0), 3))
        row = {
            'stage': name,
            'start_ms': round(1e3 * (t0 - origin), 3),
            'dur_ms': dur,
            'pct_of_wall': (round(100.0 * dur / (1e3 * wall_s), 1)
                            if wall_s else None),
        }
        if name in busy_ms:
            row['envelope_ms'] = round(1e3 * (t1 - t0), 3)
        rows.append(row)
    return {
        'step': record.get('step'),
        'journal': record.get('journal'),
        'tenant': record.get('tenant'),
        'latency_ms': record.get('latency_ms'),
        'coverage_pct': round(100.0 * provenance.stage_coverage(record), 1),
        'source': record.get('source'),
        'worker_pid': record.get('worker_pid'),
        'worker_pids': record.get('worker_pids'),
        'worker_host': record.get('worker_host'),
        'pieces': record.get('pieces'),
        'sched': record.get('sched'),
        'cache': record.get('cache'),
        'transport': record.get('transport'),
        'transfer': record.get('transfer'),
        'stages': rows,
    }


def format_chain(record):
    """Human-readable causal chain of one record."""
    info = explain_record(record)
    lines = ['step %s — %s ms wall — worker pid %s%s%s%s'
             % (info['step'], info['latency_ms'], info['worker_pid'],
                (' @ %s' % info['worker_host']
                 if info['worker_host'] else ''),
                # Cost attribution: a shared fleet's tail
                # batch names the tenant that paid for it.
                (' [tenant %s]' % info['tenant']
                 if info['tenant'] else ''),
                (' [journal %s]' % info['journal']
                 if info['journal'] else ''))]
    pieces = info['pieces'] or []
    if pieces:
        head = pieces[0]
        named = ('%s:rg%s' % (head.get('path'), head.get('row_group'))
                 if head.get('path') is not None
                 else 'piece %s' % head.get('index'))
        extra = ' (+%d more)' % (len(pieces) - 1) if len(pieces) > 1 else ''
        lines.append('  pieces:    %s%s' % (named, extra))
    sched = info['sched']
    if sched and isinstance(sched, dict):
        bits = [str(sched.get('policy'))]
        if sched.get('early'):
            bits.append('early-launched')
        if sched.get('predicted_cost') is not None:
            bits.append('predicted cost %.6g (relative)'
                        % sched['predicted_cost'])
        if sched.get('actual_s') is not None:
            bits.append('actual %.3fs' % sched['actual_s'])
        lines.append('  scheduling: %s' % ', '.join(bits))
    outcomes = '  '.join('%s %s' % (key, info[key])
                         for key in ('cache', 'transport', 'transfer')
                         if info[key] is not None)
    if outcomes:
        lines.append('  %s' % outcomes)
    lines.append('  %-14s %10s %10s %8s'
                 % ('stage', 'start_ms', 'dur_ms', '% wall'))
    for row in info['stages']:
        lines.append('  %-14s %10.3f %10.3f %8s'
                     % (row['stage'], row['start_ms'], row['dur_ms'],
                        row['pct_of_wall']))
    lines.append('  coverage: %.1f%% of wall inside recorded stages'
                 % info['coverage_pct'])
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-explain',
        description=__doc__.split('\n\n')[0])
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument('--journal',
                        help='provenance journal dump '
                             '(DataLoader.dump_provenance / SLO watchdog '
                             'artifact)')
    source.add_argument('--flight',
                        help='flight-recorder dump file (JSON)')
    source.add_argument('--artifact',
                        help='telemetry.dump_state() dump file '
                             '(JSON)')
    parser.add_argument('--step', type=int, default=None,
                        help='explain this delivered-batch index')
    parser.add_argument('--worst', type=int, default=3,
                        help='explain the K slowest journaled batches '
                             '(default 3; ignored with --step)')
    parser.add_argument('--json', action='store_true',
                        help='emit the explanations as JSON')
    args = parser.parse_args(argv)

    path = args.journal or args.flight or args.artifact
    try:
        with open(path) as f:
            records, meta = load_records(json.load(f))
    except Exception as e:  # noqa: BLE001 — report, exit nonzero
        print('cannot ingest %s: %s: %s' % (path, type(e).__name__, e),
              file=sys.stderr)
        return 1

    if args.step is not None:
        chosen = records.get(args.step)
        if not chosen:
            print('step %d is not in this journal (it holds %d records '
                  'over %s sealed steps — aged out of the ring and the '
                  'worst-K?)' % (args.step, len(records), meta['steps']),
                  file=sys.stderr)
            return 1
        if len(chosen) > 1:
            # Step numbers collide across independently-numbered
            # journals: print every match, each labeled with its
            # journal, instead of silently picking one.
            print('note: step %d exists in %d journals — all shown'
                  % (args.step, len(chosen)), file=sys.stderr)
    else:
        ranked = sorted((r for bucket in records.values() for r in bucket),
                        key=lambda r: -(r.get('latency_ms') or 0.0))
        chosen = ranked[:max(1, args.worst)]

    if args.json:
        print(json.dumps({'meta': meta,
                          'records': [explain_record(r) for r in chosen]},
                         sort_keys=True, default=str))
        return 0
    header = 'petastorm-tpu-explain — %s (%d journaled record(s)' \
             % (path, len(records))
    if meta.get('violation_step') is not None:
        header += '; SLO violation at step %s, budget %s ms' \
                  % (meta['violation_step'], meta.get('budget_ms'))
    print(header + ')')
    for record in chosen:
        print(format_chain(record))
    return 0


if __name__ == '__main__':
    sys.exit(main())

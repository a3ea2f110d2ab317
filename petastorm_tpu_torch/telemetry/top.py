"""``top`` — live fleet introspection for the data service.

Counterpart of ``petastorm_tpu/telemetry/top.py`` (``petastorm-tpu-top``),
run as ``python -m petastorm_tpu_torch.telemetry.top``.

Polls the dispatcher's ``stats`` RPC and renders, per refresh: split
progress (pending/leased/done/failed + lease churn), the fleet cache and
shm rollups (hit and degrade rates), fleet-merged stage latencies
(p50/p99 per stage, from the workers' heartbeat registry snapshots), and
one row per worker (rows/s, queue depth, shm/cache traffic, heartbeat
age).  The same numbers any scraper can lift via
``MetricsRegistry.render_prometheus()`` — this is the zero-setup
terminal view::

    petastorm-tpu-top --dispatcher tcp://dispatch:7777           # live
    petastorm-tpu-top --dispatcher tcp://dispatch:7777 --once --json

``--once`` prints a single snapshot and exits (scriptable); ``--json``
emits the raw stats reply instead of the table.  Nothing here loads
torch.
"""

import argparse
import json
import sys
import time

__all__ = ['render_stats', 'main']


def _rate(hits, misses):
    total = hits + misses
    return '%5.1f%%' % (100.0 * hits / total) if total else '    -'


#: Past-tense phrasing for the autoscale/decisions "last" column.
_ACTION_PHRASES = {'scale_in': 'drained', 'scale_out': 'spawned',
                   'routed': 'routed', 'published': 'published',
                   'evicted': 'evicted', 'admitted': 'admitted'}


def _last_decision_phrase(row):
    """'drained w3 42s ago' from one actor's decision-journal summary
    row (``DecisionJournal.summary()`` shape), or None."""
    last = (row or {}).get('last')
    if not last:
        return None
    action = _ACTION_PHRASES.get(last.get('action'), last.get('action'))
    subject = last.get('worker_id') or last.get('tenant')
    age = last.get('age_s')
    return '%s%s%s' % (action,
                       ' %s' % subject if subject else '',
                       ' %.0fs ago' % age if age is not None else '')


def render_stats(stats, elapsed_s=None):
    """One text frame from a dispatcher ``stats`` reply."""
    from petastorm_tpu_torch.telemetry.health import format_health_line
    lines = []
    lines.append(
        'splits  pending %-5d leased %-5d done %-5d failed %-5d '
        'lease_churn %d'
        % (stats.get('pending', 0), stats.get('leased', 0),
           stats.get('done', 0), stats.get('failed', 0),
           stats.get('lease_churn', 0)))
    # Derived fleet health: regime + per-component scores from
    # the dispatcher's flight-ring window — the interpreted line above
    # the raw numbers.  `petastorm-tpu-diagnose` expands it to verdicts.
    if stats.get('health') is not None:
        lines.append(format_health_line(stats['health']))
    cache = stats.get('cache') or {}
    shm = stats.get('shm') or {}
    lines.append(
        'cache   hit %s  ram_hit %-7d degraded %-7d evictions %d'
        % (_rate(cache.get('cache_hits', 0), cache.get('cache_misses', 0)),
           cache.get('cache_ram_hits', 0), cache.get('cache_degraded', 0),
           cache.get('cache_evictions', 0)))
    # shm_degraded counts ARENA refusals only (arena full / no /dev/shm);
    # byte-path chunks for size or cross-host locality reasons increment
    # neither counter, so no "% zero-copy" claim is honest here.
    lines.append(
        'shm     chunks %-7d arena_refusals %d'
        % (shm.get('shm_chunks', 0), shm.get('shm_degraded', 0)))
    cluster = stats.get('cluster_cache')
    if cluster:
        # Cluster cache tier: pieces served straight from a
        # plane (no reader), entries fetched from peers instead of
        # re-decoded, fetches that degraded, and warm lease routes.
        lines.append(
            'cluster remote_hits %-7d peer_fills %-5d peer_degraded %-5d '
            'affinity_routed %d'
            % (cluster.get('cache_remote_hits', 0),
               cluster.get('cache_peer_fills', 0),
               cluster.get('cache_peer_degraded', 0),
               cluster.get('cache_affinity_routed', 0)))
    control = stats.get('control_plane') or {}
    if control.get('ledger') or control.get('drains') \
            or control.get('drain_timeouts') \
            or control.get('retry_attempts') \
            or control.get('retry_giveups'):
        # Crash-survivable control plane: ledger lineage,
        # drain traffic, and the fleet's backoff-retry counters.
        lines.append(
            'control ledger %-3s restores %-3d adoptions %-3d drains '
            '%-3d timeouts %-3d retries %d (giveups %d)'
            % ('on' if control.get('ledger') else 'off',
               control.get('ledger_restores', 0),
               control.get('ledger_adoptions', 0),
               control.get('drains', 0),
               control.get('drain_timeouts', 0),
               control.get('retry_attempts', 0),
               control.get('retry_giveups', 0)))
    tenants = stats.get('tenants') or {}
    if len(tenants) > 1:
        # Multi-tenant serving tier: one row per job sharing
        # this fleet — pending depth, windowed grant share, weight.  A
        # single-tenant fleet keeps the classic (table-free) frame.
        grant_total = sum(int(row.get('grants_delta', 0) or 0)
                          for row in tenants.values())
        lines.append('tenants (%d):' % len(tenants))
        lines.append('  %-12s %6s %8s %8s %7s %7s %9s'
                     % ('tenant', 'weight', 'pending', 'done', 'grants',
                        'g/win', 'share'))
        for tid in sorted(tenants):
            row = tenants[tid]
            delta = int(row.get('grants_delta', 0) or 0)
            share = ('%5.1f%%' % (100.0 * delta / grant_total)
                     if grant_total else '    -')
            lines.append('  %-12s %6.1f %8s %8s %7s %7d %9s'
                         % (tid[:12], float(row.get('weight', 1.0) or 1.0),
                            row.get('pending', '-'), row.get('done', '-'),
                            row.get('grants', '-'), delta, share))
    decision_rows = stats.get('decisions') or {}
    autoscale = stats.get('autoscale') or {}
    if autoscale.get('enabled') or autoscale.get('killed') \
            or autoscale.get('actions'):
        # Decision journal: the bare action name alone aged
        # badly — "last scale_in" with no when/who reads as current long
        # after the fleet settled.  Prefer the journal's last real
        # autoscaler record: action + victim/spawn + age.
        last = _last_decision_phrase(decision_rows.get('autoscaler')) \
            or autoscale.get('last_action') or '-'
        lines.append(
            'autoscale %-8s outs %-3d ins %-3d suppressed %-3d last %s'
            % ('killed' if autoscale.get('killed')
               else ('on' if autoscale.get('enabled') else 'off'),
               autoscale.get('scale_outs', 0), autoscale.get('scale_ins', 0),
               autoscale.get('suppressed', 0), last))
    if decision_rows:
        # One line per control law that has decided anything: action and
        # suppression totals plus the last real action with its age — a
        # wedged controller (all suppressions, stale last action) is
        # visible at a glance.  `petastorm-tpu-why` expands any of these.
        bits = []
        for actor in sorted(decision_rows):
            row = decision_rows[actor] or {}
            phrase = _last_decision_phrase(row) or '-'
            bits.append('%s %d/%d %s'
                        % (actor, row.get('actions', 0),
                           row.get('suppressed', 0), phrase))
        lines.append('decisions (acted/suppressed): %s' % '  '.join(bits))
    stages = stats.get('stages') or {}
    if stages:
        # The dispatcher built these with telemetry.summarize_hist — the
        # same canonical summary `diagnose` prints, so the two tools can
        # never show different numbers for the same snapshot.
        lines.append('stage latencies (fleet-merged log2 histograms):')
        lines.append('  %-14s %10s %10s %10s %10s'
                     % ('stage', 'count', 'p50_ms', 'p99_ms', 'max_ms'))
        for name in sorted(stages):
            stage = stages[name]
            lines.append('  %-14s %10d %10s %10s %10s'
                         % (name, stage.get('count', 0),
                            stage.get('p50_ms'), stage.get('p99_ms'),
                            stage.get('max_ms')))
    workers = stats.get('workers') or {}
    lines.append('workers (%d):' % len(workers))
    lines.append('  %-6s %9s %8s %6s %9s %9s %8s %7s'
                 % ('id', 'rows/s', 'rows', 'queue', 'shm_chunk',
                    'shm_degr', 'cache_hit', 'age_s'))
    for wid in sorted(workers):
        w = workers[wid]
        lines.append('  %-6s %9s %8s %6s %9s %9s %8s %7s'
                     % (wid, w.get('rows_per_s', '-'),
                        w.get('rows_decoded', '-'),
                        w.get('queue_depth', '-'),
                        w.get('shm_chunks', '-'),
                        w.get('shm_degraded', '-'),
                        w.get('cache_hits', '-'),
                        w.get('age_s', '-')))
    if elapsed_s is not None:
        lines.append('(stats rpc took %.0f ms)' % (1e3 * elapsed_s))
    return '\n'.join(lines)


def _poll(addr, timeout_s):
    import zmq

    from petastorm_tpu_torch.service.worker import _Rpc
    context = zmq.Context()
    rpc = _Rpc(context, addr, timeout_s=timeout_s)
    try:
        t0 = time.monotonic()
        stats = rpc.call({'op': 'stats'})
        return stats, time.monotonic() - t0
    finally:
        rpc.close()
        context.term()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-top', description=__doc__.split('\n\n')[0])
    parser.add_argument('--dispatcher', required=True,
                        help='dispatcher endpoint (tcp://host:port)')
    parser.add_argument('--interval', type=float, default=2.0,
                        help='refresh period in seconds (live mode)')
    parser.add_argument('--once', action='store_true',
                        help='print one snapshot and exit')
    parser.add_argument('--json', action='store_true',
                        help='emit the raw stats reply as JSON')
    parser.add_argument('--rpc-timeout', type=float, default=10.0)
    args = parser.parse_args(argv)

    while True:
        try:
            stats, elapsed = _poll(args.dispatcher, args.rpc_timeout)
        except Exception as e:  # noqa: BLE001 — report, exit nonzero
            print('cannot reach dispatcher at %s: %s'
                  % (args.dispatcher, e), file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(stats, sort_keys=True, default=str))
        else:
            if not args.once:
                sys.stdout.write('\x1b[2J\x1b[H')  # clear, home
            print('petastorm-tpu-top  %s  %s' % (args.dispatcher,
                                                 time.strftime('%H:%M:%S')))
            print(render_stats(stats, elapsed))
        if args.once:
            return 0
        sys.stdout.flush()
        time.sleep(max(0.2, args.interval))


if __name__ == '__main__':
    sys.exit(main())

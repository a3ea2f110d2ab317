"""``diagnose`` — ranked, actionable verdicts for a fleet.

Counterpart of ``petastorm_tpu/telemetry/diagnose.py``
(``petastorm-tpu-diagnose``), run as
``python -m petastorm_tpu_torch.telemetry.diagnose``.

``top`` shows the numbers; this tool reads them.  It ingests any of the
three observability artifacts the plane produces —

* a **live fleet** (``--dispatcher tcp://host:port``): one ``stats``
  RPC, whose reply now carries the dispatcher's fleet health report;
* a **flight-recorder dump** (``--flight path.json``): the bounded ring
  a process persisted before dying (``telemetry/flight.py``);
* a **test-suite watchdog artifact** (``--artifact path.json``): the
  ``telemetry.dump_state()`` file a process writes on hang
  or failure (registries + trace timelines + flight frames);

— normalizes them into one evidence dict, runs the verdict rules, and
prints a ranked report: *what is wrong, how bad, which knob to turn*::

    $ petastorm-tpu-diagnose --dispatcher tcp://dispatch:7777
    petastorm-tpu-diagnose — live fleet tcp://dispatch:7777
     1. [crit] decode-bound — decode active for 94% of the stalled time;
        fleet decode_split p99 41.0 ms vs delivery p99 2.0 ms
        -> raise workers_count / add service decode workers; enable the
           epoch-cache plane (cache_plane=True) ...

Each rule is held against the reference's on the same synthetic regime
inputs (``tests/test_torch_diagnose_tools.py``).  Nothing here loads torch.
Exit codes: 0 verdicts produced (including a clean bill of health),
1 input unreachable/unparseable, 2 usage error.
"""

import argparse
import json
import sys
import time

from petastorm_tpu_torch.telemetry import health as _health
from petastorm_tpu_torch.telemetry.registry import merge_snapshots, snapshot_delta
from petastorm_tpu_torch.telemetry.spans import attribute_stalls

__all__ = ['diagnose', 'run_rules', 'evidence_from_stats',
           'evidence_from_flight', 'evidence_from_artifact',
           'render_report', 'main']

_SEVERITY_RANK = {'crit': 3, 'warn': 2, 'info': 1, 'ok': 0}

#: The knob each regime verdict recommends.
_REGIME_ACTIONS = {
    'decode-bound': (
        'raise workers_count / add service decode workers; enable the '
        'epoch-cache plane (cache_plane=True) so repeat epochs serve '
        'warm instead of re-decoding'),
    'link-bound': (
        "enable the transfer plane (transfer='auto' off-CPU), narrow "
        "wire dtypes (wire_dtypes='auto'), deepen ring_slots/prefetch "
        'so transfer overlaps the step'),
    'lease-starved': (
        'add decode workers and verify they register + heartbeat '
        '(petastorm-tpu-top worker rows); check dispatcher logs for '
        'lease churn; smaller rowgroups_per_split shortens fill time'),
    'cache-degraded': (
        'check cache_plane_dir writability, tier caps '
        '(cache_plane_ram_bytes / cache_plane_disk_bytes) and /dev/shm '
        'headroom — the plane is refusing work, every refused piece '
        're-decodes at full cost'),
    'cluster-cache-degraded': (
        'the fleet is re-decoding a dataset a peer already holds '
        'decoded: peer fetches are failing back to direct decode — '
        'check worker data-endpoint reachability between hosts '
        '(advertise_host / firewalls), that '
        'PETASTORM_TPU_NO_CLUSTER_CACHE is not set on part of the '
        'fleet, and plane tier caps (a full plane cannot accept '
        'peer-filled entries)'),
    'shm-degraded': (
        'raise the shm arena capacity or /dev/shm size; a slow consumer '
        'pinning slabs also fills the arena — check client drain rate'),
    'skew-bound': (
        "enable the adaptive out-of-order scheduler (scheduling="
        "'adaptive' on make_reader / ServiceConfig): slow pieces launch "
        'early and fast pieces backfill the stall window — adding '
        'workers would idle just the same; '
        'PETASTORM_TPU_NO_ADAPTIVE_SCHED=1 is the kill switch'),
    'tenant-starved': (
        'the shared fleet is granting leases to other tenants while '
        'this one starves: raise the starved tenant\'s '
        'weight (register_tenant_job(weight=)), check whether its '
        'splits are being affinity-deferred onto one saturated worker, '
        'and whether a per-tenant quota is degrading its every chunk; '
        'if the whole fleet is saturated, add workers (or enable the '
        'autoscaler) instead of re-dividing them'),
    'control-plane-degraded': (
        'the control plane itself is the fault domain: if the '
        'dispatcher is restarting, read its logs/ledger lineage for the '
        'crash cause (the ledger keeps delivery exactly-once through '
        'restarts, but every restart pauses lease traffic); if drains '
        'are timing out, raise drain_timeout_s past the real in-flight '
        'split time or shrink rowgroups_per_split; if retry_giveups is '
        'climbing fleet-wide, workers are exhausting retry budgets '
        'against the dispatcher (heartbeat backoff episodes) or whole '
        'holder lists are failing peer fetches — check the dispatcher '
        'endpoint and peer data-plane reachability before adding '
        'capacity'),
    'control-flapping': (
        'an autonomous controller is oscillating — opposing actions '
        '(scale_out/scale_in, admit/evict) inside one window pay both '
        'transition costs and deliver neither steady state: widen the '
        "actor's hysteresis (autoscale_cooldown_s, the autoscale_idle_s "
        'vs autoscale_starve_s gap, hbm_budget_bytes vs working set); '
        'petastorm-tpu-why --actor <actor> names each rule that fired '
        'and the inputs it read'),
    'fetch-bound': (
        'cold-read I/O is on the critical path: deepen the ingest '
        "readahead (ingest_window on make_reader, or let the DataLoader "
        'autotuner move it), check that the ingest plane is actually on '
        "(ingest='auto' stays off on local filesystems; "
        'PETASTORM_TPU_NO_INGEST_PLANE=1 kills it), and if '
        'ingest_degraded is climbing, root-cause the fetch failures — '
        'every degraded piece pays object-store first-byte latency on a '
        'decode worker'),
}

#: |clock_drift_ms| above this breaks cross-process span ordering at
#: log2-bucket resolution.
CLOCK_DRIFT_WARN_MS = 50.0


# -- evidence extraction ------------------------------------------------------

def evidence_from_stats(stats, source='live fleet'):
    """Normalize a dispatcher ``stats`` reply (the live-fleet input)."""
    workers = stats.get('workers') or {}
    meta = {key: stats.get(key, 0) for key in
            ('pending', 'leased', 'done', 'failed', 'lease_churn')}
    # Registered is not alive: the dispatcher never forgets a worker, so
    # count rows whose heartbeat is recent (the reply's `age_s`) — a
    # fully-crashed fleet must read as 0 here or lease starvation is
    # unreachable.  Only the health FALLBACK below reads this; a modern
    # reply ships the dispatcher's own (lease-ttl-aware) health report.
    meta['workers_alive'] = sum(
        1 for row in workers.values()
        if isinstance(row.get('age_s'), (int, float))
        and row['age_s'] < 60.0)
    # Fair-share evidence: re-derive the dispatcher's
    # starved-tenant signal from its per-tenant rollup (pending work +
    # zero grants while the rest of the fleet was granted) so the
    # health FALLBACK below can classify tenant-starved too.
    tenants = stats.get('tenants') or {}
    fleet_moving = any(int(row.get('grants_delta', 0) or 0) > 0
                       for row in tenants.values())
    meta['starved_tenants'] = sorted(
        tid for tid, row in tenants.items()
        if int(row.get('pending', 0) or 0) > 0
        and int(row.get('grants_delta', 0) or 0) == 0 and fleet_moving)
    meta['tenant_count'] = len(tenants)
    counters = {}
    counters.update(stats.get('cache') or {})
    counters.update(stats.get('shm') or {})
    # Cluster tier rollup: only the COUNTER fields (the rollup also
    # carries directory metadata booleans no health rule reads).
    counters.update({k: v for k, v in
                     (stats.get('cluster_cache') or {}).items()
                     if isinstance(v, int)})
    report = stats.get('health')
    if report is None:
        report = _health.health_report(
            {'counters': counters, 'histograms': {}}, meta=meta)
    return {
        'source': source,
        'stages': stats.get('stages') or {},
        'counters': counters,
        'stall_pct': None,
        'meta': meta,
        'workers': workers,
        'health': report,
        'span_residue': None,
        'reason': None,
        # Crash-survivable control plane rollup: ledger
        # lineage, drain traffic, fleet retry counters — the restart /
        # drain-timeout rules read it.
        'control_plane': stats.get('control_plane') or {},
        # Multi-tenant serving tier: per-tenant grant/queue
        # rollup + the autoscaler's action counters.
        'tenants': tenants,
        'autoscale': stats.get('autoscale') or {},
        # Decision-journal rollup: per-actor action /
        # suppression counts + last real action — the control-flapping
        # verdict cites the actual journaled decision from it.
        'decisions': stats.get('decisions') or {},
    }


def evidence_from_flight(dump, window_s=None, stall_pct=None):
    """Normalize a flight-recorder dump (one process's bounded ring).
    One windowing pass (``flight.window_frames``) feeds BOTH the
    stage/counter evidence and the health report, so they can never
    describe different windows."""
    from petastorm_tpu_torch.telemetry.flight import window_frames
    frames = dump.get('frames') or []
    if not frames:
        raise ValueError('flight dump has no frames')
    old, newest = window_frames(frames, window_s)
    delta = snapshot_delta(newest.get('snapshot'),
                           old.get('snapshot') if old else None)
    measured = (newest['t_mono'] - old['t_mono']) if old else None
    label = dump.get('label') or 'pid %s' % dump.get('pid')
    return {
        'source': 'flight recorder (%s, %d frames)' % (label, len(frames)),
        'stages': _health.summarize_stages(delta.get('histograms')),
        'counters': dict(delta.get('counters') or {}),
        'stall_pct': stall_pct,
        'meta': {},
        'workers': {},
        'health': _health.health_report(delta, stall_pct=stall_pct,
                                        window_s=measured),
        'span_residue': newest.get('span_residue'),
        'reason': dump.get('reason'),
        # Per-batch provenance: the newest frame's rolling
        # worst-K summaries — the refs the slow-batch rule cites.
        'provenance_worst': newest.get('provenance_worst'),
    }


def evidence_from_artifact(artifact, window_s=None):
    """Normalize a watchdog artifact (``telemetry.dump_state``
    shape: ``registries`` + ``trace_events`` + ``span_residue`` +
    ``flight``), the postmortem input.  Flight frames (when the dumping
    process had the recorder on) give windowed deltas; the trace
    timelines give span-level stall attribution — joined, they are the
    strongest evidence this tool sees."""
    stall = _best_stall_breakdown(artifact.get('trace_events') or [])
    flight = artifact.get('flight')
    if flight and flight.get('frames'):
        evidence = evidence_from_flight(flight, window_s=window_s,
                                        stall_pct=stall)
    else:
        merged = merge_snapshots(artifact.get('registries') or [])
        evidence = {
            'stages': _health.summarize_stages(merged.get('histograms')),
            'counters': dict(merged.get('counters') or {}),
            'stall_pct': stall, 'meta': {}, 'workers': {},
            'health': _health.health_report(merged, stall_pct=stall),
            'span_residue': None,
        }
    evidence['source'] = 'watchdog artifact (reason: %s)' % (
        artifact.get('reason'),)
    evidence['reason'] = artifact.get('reason')
    if evidence.get('span_residue') is None:
        evidence['span_residue'] = len(artifact.get('span_residue') or ())
    if not evidence.get('provenance_worst'):
        # Artifact-level journals (telemetry.dump_state ships them in
        # full): summarize their worst records with the SAME canonical
        # shape flight frames carry (provenance.summarize_record), so
        # both ingestion paths cite a slow batch identically.
        from petastorm_tpu_torch.telemetry.provenance import summarize_record
        worst = [summarize_record(record)
                 for journal in artifact.get('provenance') or ()
                 for record in (journal.get('worst') or ())[:3]]
        worst.sort(key=lambda row: -(row.get('latency_ms') or 0.0))
        evidence['provenance_worst'] = worst[:4] or None
    return evidence


def _best_stall_breakdown(trace_batches):
    """attribute_stalls per recorder batch (mixing batches would mix
    monotonic origins); keep the breakdown covering the most wait."""
    best, best_wait = None, 0.0
    for batch in trace_batches:
        if isinstance(batch, dict):
            events = batch.get('events') or []
        else:
            events = batch
        breakdown = attribute_stalls(events)
        if breakdown and breakdown['total_wait_s'] > best_wait:
            best, best_wait = breakdown['pct'], breakdown['total_wait_s']
    return best


# -- verdict rules ------------------------------------------------------------

def _stage_p99(stages, names):
    vals = [stages[n].get('p99_ms') for n in names
            if n in stages and stages[n].get('p99_ms') is not None]
    return max(vals) if vals else None


def _regime_verdicts(evidence):
    """One verdict per health candidate, enriched with the canonical
    stage numbers so the report reads like the example verdicts the
    rules were specified against."""
    report = evidence.get('health') or {}
    stages = evidence.get('stages') or {}
    verdicts = []
    for candidate in report.get('candidates', ()):
        regime = candidate['regime']
        action = _REGIME_ACTIONS.get(regime)
        if action is None:
            continue
        evidence_bits = [candidate['evidence']]
        if regime == 'decode-bound':
            decode = _stage_p99(stages, ('decode_split', 'decode',
                                         'cache_fill', 'host_batch'))
            delivery = _stage_p99(stages, ('serialize', 'shm_publish'))
            if decode is not None:
                evidence_bits.append(
                    'fleet decode p99 %s ms vs delivery p99 %s ms'
                    % (decode, delivery if delivery is not None else '-'))
            exemplar = _stage_exemplar(stages, ('decode_split', 'decode',
                                                'host_batch'))
            if exemplar is not None:
                # Tail exemplar: the p99 is not anonymous —
                # it names a journaled batch petastorm-tpu-explain can
                # reconstruct.
                evidence_bits.append(
                    'p99 exemplar: journal step %s (%s ms) — '
                    'petastorm-tpu-explain --step %s names its '
                    'file/rowgroup/worker'
                    % (exemplar['ref'].get('step'), exemplar.get('ms'),
                       exemplar['ref'].get('step')))
        elif regime == 'link-bound':
            link = _stage_p99(stages, ('h2d_commit', 'h2d_dispatch',
                                       'device_put'))
            stage = _stage_p99(stages, ('h2d_stage',))
            if link is not None or stage is not None:
                evidence_bits.append(
                    'h2d (link) p99 %s ms vs h2d_stage (host copy) '
                    'p99 %s ms' % (link, stage))
        elif regime == 'fetch-bound':
            wait = _stage_p99(stages, ('ingest_wait',))
            fetch = _stage_p99(stages, ('ingest_fetch',))
            if wait is not None or fetch is not None:
                evidence_bits.append(
                    'decode blocked on fetches p99 %s ms vs fetch wall '
                    'p99 %s ms' % (wait, fetch))
        elif regime == 'skew-bound':
            for name in ('decode', 'decode_split'):
                stage = stages.get(name)
                if stage and stage.get('p99_ms') is not None:
                    evidence_bits.append(
                        '%s p50 %s ms vs p99 %s ms over %d items'
                        % (name, stage.get('p50_ms'), stage.get('p99_ms'),
                           stage.get('count', 0)))
                    break
        elif regime == 'cluster-cache-degraded':
            worker = _worst_worker(evidence, 'cache_peer_degraded')
            if worker:
                evidence_bits.append(
                    'worst worker %s: cache_peer_degraded %d — its '
                    'misses name entries a live peer advertises but '
                    'cannot deliver' % (worker[0], worker[1]))
        elif regime == 'cache-degraded':
            worker = _worst_worker(evidence, 'cache_degraded')
            if worker:
                evidence_bits.append(
                    'worst worker %s: cache_degraded %d with %d hits '
                    '(a plane silently OFF keeps degrading while hits '
                    'look plausible)' % worker)
        elif regime == 'tenant-starved':
            rows = evidence.get('tenants') or {}
            granted = sorted(
                (tid for tid, row in rows.items()
                 if int(row.get('grants_delta', 0) or 0) > 0),
                key=lambda t: -int(rows[t].get('grants_delta', 0) or 0))
            if granted:
                top = granted[0]
                evidence_bits.append(
                    'meanwhile tenant %r took %d grant(s) this window '
                    '(weight %.1f)'
                    % (top, int(rows[top].get('grants_delta', 0) or 0),
                       float(rows[top].get('weight', 1.0) or 1.0)))
        elif regime == 'control-flapping':
            # Cite the actual journaled decision, not just the pair
            # count: the flapping actor's last real action with its
            # rule, subject, and age.
            rows = evidence.get('decisions') or {}
            for actor in sorted(rows):
                if actor not in candidate['evidence']:
                    continue
                last = (rows[actor] or {}).get('last')
                if last:
                    subject = last.get('worker_id') or last.get('tenant')
                    evidence_bits.append(
                        'last journaled %s action: %s%s (rule %s, '
                        '%.0fs ago) — petastorm-tpu-why --actor %s '
                        'replays the timeline'
                        % (actor, last.get('action'),
                           ' %s' % subject if subject else '',
                           last.get('rule'),
                           float(last.get('age_s', 0.0) or 0.0), actor))
                break
        elif regime == 'shm-degraded':
            worker = _worst_worker(evidence, 'shm_degraded')
            if worker:
                evidence_bits.append('worst worker %s: shm_degraded %d '
                                     '(shm_chunks %d)'
                                     % (worker[0], worker[1],
                                        (evidence.get('workers') or {})
                                        .get(worker[0], {})
                                        .get('shm_chunks', 0)))
        verdicts.append({
            'id': regime,
            'severity': 'crit' if candidate['severity'] >= 0.75 else 'warn',
            'score': candidate['severity'],
            'summary': regime,
            'evidence': '; '.join(evidence_bits),
            'action': action,
        })
    return verdicts


def _stage_exemplar(stages, names):
    """The first tail exemplar carried by one of the named stage
    summaries (``summarize_hist`` attaches them when the source
    histogram recorded any), with a usable ``ref``."""
    for name in names:
        exemplar = (stages.get(name) or {}).get('exemplar')
        if exemplar and isinstance(exemplar.get('ref'), dict):
            return exemplar
    return None


def _worst_worker(evidence, key):
    rows = evidence.get('workers') or {}
    worst = None
    for wid, row in rows.items():
        value = int(row.get(key, 0) or 0)
        if value > 0 and (worst is None or value > worst[1]):
            worst = (wid, value, int(row.get('cache_hits', 0) or 0))
    return worst


def rule_failed_splits(evidence):
    failed = int((evidence.get('meta') or {}).get('failed', 0) or 0)
    if not failed:
        return None
    return {
        'id': 'failed-splits', 'severity': 'crit', 'score': 1.0,
        'summary': '%d split(s) terminally failed' % failed,
        'evidence': 'the dispatcher exhausted max_split_attempts on '
                    'them; consumers of those splits raise ServiceError',
        'action': 'inspect worker logs for the decode error (poisoned '
                  'row group, bad codec); fix or filter the data, then '
                  'restart the job',
    }


def rule_clock_drift(evidence):
    rows = evidence.get('workers') or {}
    drifting = {wid: row['clock_drift_ms'] for wid, row in rows.items()
                if abs(row.get('clock_drift_ms') or 0.0)
                >= CLOCK_DRIFT_WARN_MS}
    if not drifting:
        return None
    worst = max(drifting.items(), key=lambda kv: abs(kv[1]))
    return {
        'id': 'clock-drift', 'severity': 'warn',
        'score': min(1.0, abs(worst[1]) / 1000.0),
        'summary': 'worker clock drift up to %.0f ms (%s)' % (worst[1],
                                                              worst[0]),
        'evidence': 'EWMA offset moved vs the registration handshake on '
                    '%d worker(s): %s' % (len(drifting), sorted(drifting)),
        'action': 'cross-process span alignment is unreliable past the '
                  'log2 bucket resolution on the affected timelines; '
                  'trust counters/histograms, re-run the job for traces',
    }


def rule_span_residue(evidence):
    residue = evidence.get('span_residue')
    if not residue or residue < 64:
        return None
    return {
        'id': 'span-residue', 'severity': 'info',
        'score': min(1.0, residue / 4096.0),
        'summary': '%d spans recorded but never drained' % residue,
        'evidence': 'the process span buffer holds completed spans no '
                    'ack/heartbeat channel shipped',
        'action': 'an instrumented subsystem runs without its return '
                  'channel (bounded, so harmless — but its telemetry is '
                  'invisible upstream)',
    }


def rule_watchdog_reason(evidence):
    reason = evidence.get('reason')
    if not reason or not str(reason).startswith('watchdog'):
        return None
    return {
        'id': 'suite-hang', 'severity': 'crit', 'score': 1.0,
        'summary': 'artifact written by the suite watchdog (%s)' % reason,
        'evidence': 'the run hung past the watchdog window; the stderr '
                    'thread dump names the wedged frame, this artifact '
                    'holds the telemetry trajectory before it',
        'action': 'read the faulthandler stacks next to this artifact; '
                  'the regime verdicts below say what the data plane was '
                  'doing as it hung',
    }


def rule_slow_batches(evidence):
    """Per-batch provenance: when the input carries a
    journal's rolling worst-K, name the slowest batch and point at
    ``petastorm-tpu-explain`` — the per-batch causal chain is stronger
    evidence than any aggregate."""
    worst = evidence.get('provenance_worst')
    if not worst:
        return None
    head = worst[0]
    detail = ', '.join(
        '%s=%s' % (key, head[key])
        for key in ('worker_pid', 'piece', 'cache', 'transport')
        if head.get(key) is not None)
    return {
        'id': 'slow-batch-provenance', 'severity': 'info',
        'score': min(1.0, (head.get('latency_ms') or 0.0) / 10000.0),
        'summary': 'slowest journaled batch: step %s at %s ms'
                   % (head.get('step'), head.get('latency_ms')),
        'evidence': 'rolling worst-K from the provenance journal: %s'
                    % (detail or 'no identity fields recorded'),
        'action': 'petastorm-tpu-explain --step %s against this '
                  'artifact reconstructs the full causal chain (stages, '
                  'worker, file + rowgroup, scheduling decision)'
                  % head.get('step'),
    }


def rule_dispatcher_restarts(evidence):
    """The ledger lineage counts every control-plane restart
    of this job.  One restart is survivable news (that is what the
    ledger is FOR); a repeat offender is a crash loop."""
    control = evidence.get('control_plane') or {}
    restarts = int(control.get('ledger_restores', 0) or 0)
    if not restarts:
        return None
    adopted = int(control.get('ledger_adoptions', 0) or 0)
    requeued = int(control.get('ledger_requeues', 0) or 0)
    return {
        'id': 'dispatcher-restarts',
        'severity': 'crit' if restarts >= 3 else 'warn',
        'score': min(1.0, 0.3 + 0.2 * restarts),
        'summary': 'dispatcher restarted %d time(s) (ledger lineage)'
                   % restarts,
        'evidence': 'restore reconciliation: %d orphan lease(s) '
                    'resumed by re-registering workers, %d requeued '
                    'attempt-intact' % (adopted, requeued),
        'action': 'delivery stayed exactly-once through the ledger '
                  'restore, but every restart pauses lease traffic — '
                  'find the crash cause in the dispatcher logs; a '
                  'climbing count means a crash loop, not bad luck',
    }


def rule_drain_timeouts(evidence):
    """A drain that overran its deadline left splits to
    requeue (attempt+1) — the graceful scale-in path is not actually
    graceful at this drain_timeout_s."""
    control = evidence.get('control_plane') or {}
    timeouts = int(control.get('drain_timeouts', 0) or 0)
    if not timeouts:
        return None
    drains = int(control.get('drains', 0) or 0)
    return {
        'id': 'drain-timeout', 'severity': 'warn',
        'score': min(1.0, 0.4 + 0.2 * timeouts),
        'summary': 'worker drain timed out %d time(s) (of %d drains)'
                   % (timeouts, drains),
        'evidence': 'the worker deregistered with splits still in '
                    'flight; the dispatcher requeued them at attempt+1',
        'action': 'raise drain_timeout_s past the real worst-case '
                  'in-flight split time (decode + stream + client ack), '
                  'or shrink rowgroups_per_split so splits finish '
                  'faster; orchestrators must set '
                  'terminationGracePeriod above drain_timeout_s',
    }


_RULES = (rule_failed_splits, rule_watchdog_reason, rule_clock_drift,
          rule_span_residue, rule_slow_batches, rule_dispatcher_restarts,
          rule_drain_timeouts)


def run_rules(evidence):
    """Every applicable verdict, ranked most severe first; never empty —
    a clean fleet gets an explicit bill of health (verdict id
    ``healthy``), because "no output" is indistinguishable from a broken
    tool."""
    verdicts = _regime_verdicts(evidence)
    for rule in _RULES:
        verdict = rule(evidence)
        if verdict is not None:
            verdicts.append(verdict)
    verdicts.sort(key=lambda v: (_SEVERITY_RANK.get(v['severity'], 0),
                                 v['score']), reverse=True)
    if not any(v['severity'] in ('crit', 'warn') for v in verdicts):
        report = evidence.get('health') or {}
        verdicts.insert(0, {
            'id': report.get('regime', 'healthy'), 'severity': 'ok',
            'score': 0.0,
            'summary': report.get('regime', 'healthy'),
            'evidence': report.get('regime_evidence',
                                   'no signal above threshold'),
            'action': 'nothing to do',
        })
    return verdicts


def diagnose(evidence):
    """Evidence dict -> full report dict (the ``--json`` shape)."""
    return {'source': evidence.get('source'),
            'health': evidence.get('health'),
            'verdicts': run_rules(evidence)}


def render_report(report):
    lines = ['petastorm-tpu-diagnose — %s' % report.get('source')]
    health = report.get('health')
    if health:
        lines.append(_health.format_health_line(health))
    for i, verdict in enumerate(report['verdicts'], 1):
        lines.append('%2d. [%s] %s — %s'
                     % (i, verdict['severity'], verdict['summary'],
                        verdict['evidence']))
        lines.append('      -> %s' % verdict['action'])
    return '\n'.join(lines)


# -- CLI ----------------------------------------------------------------------

def _poll_stats(addr, timeout_s):
    import zmq

    from petastorm_tpu_torch.service.worker import _Rpc
    context = zmq.Context()
    rpc = _Rpc(context, addr, timeout_s=timeout_s)
    try:
        return rpc.call({'op': 'stats'})
    finally:
        rpc.close()
        context.term()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-diagnose',
        description=__doc__.split('\n\n')[0])
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument('--dispatcher',
                        help='live fleet: dispatcher endpoint '
                             '(tcp://host:port)')
    source.add_argument('--flight',
                        help='flight-recorder dump file (JSON)')
    source.add_argument('--artifact',
                        help='telemetry.dump_state() dump file '
                             '(JSON)')
    parser.add_argument('--window', type=float, default=60.0,
                        help='delta window in seconds for ring inputs')
    parser.add_argument('--json', action='store_true',
                        help='emit the report as JSON')
    parser.add_argument('--rpc-timeout', type=float, default=10.0)
    args = parser.parse_args(argv)

    try:
        if args.dispatcher:
            t0 = time.monotonic()
            stats = _poll_stats(args.dispatcher, args.rpc_timeout)
            evidence = evidence_from_stats(
                stats, source='live fleet %s (stats rpc %.0f ms)'
                % (args.dispatcher, 1e3 * (time.monotonic() - t0)))
        elif args.flight:
            with open(args.flight) as f:
                evidence = evidence_from_flight(json.load(f),
                                                window_s=args.window)
        else:
            with open(args.artifact) as f:
                evidence = evidence_from_artifact(json.load(f),
                                                  window_s=args.window)
    except Exception as e:  # noqa: BLE001 — report, exit nonzero
        print('cannot ingest input: %s: %s' % (type(e).__name__, e),
              file=sys.stderr)
        return 1
    report = diagnose(evidence)
    if args.json:
        print(json.dumps(report, sort_keys=True, default=str))
    else:
        print(render_report(report))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Health: raw telemetry in, regimes and scores out.

Counterpart of ``petastorm_tpu/telemetry/health.py``.  The registries and
spans say what happened; this module says what is wrong and which knob
fixes it.  Its input is a window's snapshot delta
(``registry.snapshot_delta`` over flight-recorder frames, or a cumulative
snapshot without history), optionally with the consumer's stall
attribution (``spans.attribute_stalls``'s ``pct``) and the control plane's
state (split states, live workers, starved tenants, flapping actors).  Each
threshold is a named constant and each classification carries its
evidence.

Regime catalogue (``classify_regime``):

* ``decode-bound``   — stall time (or stage busy time) dominated by
  rowgroup decode / cache fill.  Knobs: ``workers_count``, more service
  workers, the epoch-cache plane.
* ``link-bound``     — dominated by host->device transfer (``h2d``) or
  its host-side staging copy (``h2d_stage``; the evidence names which).
  Knobs: transfer plane, wire narrowing, deeper ring / prefetch.
* ``lease-starved``  — the client waited while NO pipeline stage was
  active (true starvation), or no live worker can lease pending splits.
  Knobs: add workers, check the dispatcher, smaller splits.
* ``cache-degraded`` — the epoch-cache plane is refusing work (full /
  unwritable / unencodable): hits may still look plausible while every
  miss re-decodes.  Knobs: plane dir, tier caps, /dev/shm headroom.
* ``cluster-cache-degraded`` — the CLUSTER cache tier's peer fetches
  are failing (``cache_peer_degraded`` vs ``cache_peer_fills`` +
  ``cache_remote_hits``): the fleet is re-decoding a dataset a peer
  already holds decoded.  Knobs: peer data-endpoint reachability, the
  ``PETASTORM_TPU_NO_CLUSTER_CACHE`` kill switch, plane tier caps.
* ``shm-degraded``   — the zero-copy result plane is falling back to
  the byte path (arena full, /dev/shm unusable).  Knobs: arena
  capacity, /dev/shm size, consumer drain rate.
* ``fetch-bound``    — cold-read I/O is on the critical path: decode
  measurably blocks on in-flight ingest fetches (``ingest_wait``
  dominating stage time, or the ``ingest_fetch`` stall component), or
  the ingest plane is degrading to synchronous reads
  (``ingest_degraded`` vs ``ingest_fetches``).  Knobs: a deeper
  ``ingest_window``, more fetch threads, request hedging; a degrading
  plane wants the fetch failures root-caused (the kill switch
  ``PETASTORM_TPU_NO_INGEST_PLANE`` is the incident lever).
* ``skew-bound``     — per-item decode latency is heavily skewed
  (p99/p50 over the scheduler's ``SKEW_RATIO_FLOOR``) while workers show
  idle gaps (``meta['decode_utilization']`` under
  :data:`SKEW_UTILIZATION_CEIL`,
  or the consumer stalls on decode): a few slow pieces head-of-line
  block the epoch while the rest of the pool idles.  Knob:
  ``scheduling='adaptive'`` (the out-of-order scheduler) —
  more workers would idle just the same.
* ``tenant-starved``  — a tenant with pending work took ZERO lease
  grants over a window in which the shared fleet granted to others
 : the fair-share schedule is being defeated (weight 0-ish
  share, affinity monopolization, or an over-quota tenant whose splits
  never finish).  Knobs: the tenant's weight, ``max_tenant_jobs``,
  per-tenant quotas, more workers.
* ``control-plane-degraded`` — the control plane itself is the fault
  domain: the dispatcher restarted inside the window
  (``ledger_restores`` climbing), worker drains overran their deadline
  (``drain_timeouts``), or control-plane retries are exhausting their
  backoff budgets fleet-wide (``retry_giveups``).  Data still flows
  (the ledger + reconciliation exist so it does), but every one of
  these is a restart/scale-in event away from an outage.  Knobs: the
  dispatcher's crash loop (why is it restarting?), ``drain_timeout_s``
  vs real in-flight split time, dispatcher reachability.
* ``control-flapping`` — an autonomous controller is oscillating
 : the decision journal shows opposing real actions from the
  same actor inside one window (autoscaler scale_out+scale_in pairs,
  residency admit+evict pairs at the LRU).  Each flap pays both
  transition costs and delivers neither steady state.  Knobs: widen the
  actor's hysteresis (``autoscale_cooldown_s``, ``autoscale_idle_s`` vs
  ``autoscale_starve_s`` gap, ``hbm_budget_bytes``);
  ``petastorm-tpu-why --actor autoscaler`` names the rules that fired.
* ``residency-thrash`` — the device-resident tier's admissions are
  displacing live entries (``residency_thrash`` vs admissions + hits):
  the HBM budget is smaller than the working set, so every epoch streams
  AND churns the tier for no warm payoff.  Knobs:
  ``hbm_budget_bytes``, a narrower ``wire_dtypes`` policy, smaller
  per-host shard; the kill switch ``PETASTORM_TPU_NO_RESIDENCY`` is
  the incident lever.
* ``resident``      — the healthy-variant label: the window's
  batches were served from the device-resident tier (``residency_hits``
  at or above host deliveries) with nothing degraded — the loader is on
  the zero-host-batch warm path.
* ``healthy`` / ``idle`` — nothing above threshold / no traffic at all.
"""


import math

from petastorm_tpu_torch.telemetry.registry import hist_quantile, snapshot_delta, summarize_hist
# the module, not the name: the scheduler imports the telemetry package
from petastorm_tpu_torch.workers_pool import scheduling as _scheduling

__all__ = ['classify_regime', 'health_report', 'report_from_frames',
           'export_gauges', 'busy_seconds', 'degrade_ratios', 'REGIMES']

REGIMES = ('decode-bound', 'link-bound', 'lease-starved', 'cache-degraded',
           'cluster-cache-degraded', 'shm-degraded', 'skew-bound',
           'fetch-bound', 'tenant-starved', 'control-plane-degraded',
           'control-flapping', 'residency-thrash', 'resident', 'healthy',
           'idle')

#: Histogram name -> pipeline component.  Names from every registry the
#: fleet merges: service workers (decode_split/serialize/shm_publish),
#: ProcessPool children (decode), the cache plane (cache_fill), loaders
#: (host_batch/device_put) and the transfer plane (h2d_*).
STAGE_COMPONENTS = {
    'decode_split': 'decode', 'decode': 'decode', 'cache_fill': 'decode',
    'host_batch': 'decode',
    'serialize': 'delivery', 'shm_publish': 'delivery',
    'device_put': 'link', 'h2d_dispatch': 'link', 'h2d_commit': 'link',
    'h2d_stage': 'link_stage',
    # ingest_wait, NOT ingest_fetch: fetch time itself is supposed to be
    # busy (that's the overlap working) — only decode BLOCKED on a fetch
    # evidences the fetch-bound regime.
    'ingest_wait': 'ingest',
}

#: attribute_stalls component -> regime it evidences.
_STALL_REGIMES = {
    'decode': 'decode-bound', 'cache_fill': 'decode-bound',
    'h2d': 'link-bound', 'h2d_stage': 'link-bound',
    'lease_wait': 'lease-starved',
    'ingest_fetch': 'fetch-bound',
}

#: A stall component below this share of the wait does not name a regime.
STALL_PCT_FLOOR = 25.0
#: Degrade counters below this share of their plane's traffic stay quiet.
DEGRADE_RATIO_FLOOR = 0.02
#: Busy-share classification (counters-only fallback) needs at least
#: this much measured stage time in the window to say anything.
MIN_BUSY_S = 0.25
#: ...and the dominant component must hold at least this share.
BUSY_SHARE_FLOOR = 0.6
#: Per-item decode p99/p50 at or above SKEW_RATIO_FLOOR (imported from
#: the scheduler — ONE threshold: what diagnose calls skew-bound must be
#: exactly what the autotuner treats as skew) reads as cost skew.
#: ...but skew only names the regime when workers also show idle gaps:
#: pool decode_utilization at or below this (all-busy skew is just
#: decode-bound — add workers; idle skew needs reordering).
SKEW_UTILIZATION_CEIL = 0.6
#: ...and enough samples that the quantile ratio means something.
SKEW_MIN_COUNT = 16
#: Opposing decision pairs (scale_out+scale_in, admit+evict) from ONE
#: actor in one window before the control plane reads as flapping.  One
#: pair is a legitimate correction (burst arrived, burst drained); two
#: is an oscillation.
CONTROL_FLAP_FLOOR = 2


def busy_seconds(delta):
    """Seconds each pipeline component was measurably busy in the window
    (histogram ``sum`` fields, grouped by :data:`STAGE_COMPONENTS`)."""
    out = {}
    for name, hist in (delta.get('histograms') or {}).items():
        component = STAGE_COMPONENTS.get(name)
        if component is not None:
            out[component] = out.get(component, 0.0) + float(
                hist.get('sum', 0.0))
    return out


def degrade_ratios(delta):
    """Degrade share per degradable plane, or None where the plane saw
    no traffic at all (no evidence either way)."""
    counters = delta.get('counters') or {}

    def ratio(degraded_key, traffic_keys):
        degraded = int(counters.get(degraded_key, 0))
        traffic = degraded + sum(int(counters.get(k, 0))
                                 for k in traffic_keys)
        return (degraded / traffic) if traffic else None

    return {
        'cache': ratio('cache_degraded', ('cache_hits', 'cache_misses')),
        'shm': ratio('shm_degraded',
                     ('shm_chunks', 'shm_results')),
        'link': ratio('h2d_degraded', ('h2d_batches',)),
        # Cluster tier: traffic = what flowed between planes
        # (remote hits + peer fills); degraded = fetches that fell back
        # to a full re-decode of entries a live peer holds.
        'cluster': ratio('cache_peer_degraded',
                         ('cache_peer_fills', 'cache_remote_hits')),
        # Ingest plane: degraded = pieces that fell back to a
        # synchronous cold read (fetch/plan failure, abandoned checkout)
        # — each one puts first-byte latency back on a decode worker.
        'ingest': ratio('ingest_degraded', ('ingest_fetches',)),
        # Resident tier: "degraded" = admissions that had to
        # displace a live entry (thrash); traffic = everything the tier
        # did this window (admissions + warm hits).
        'residency': ratio('residency_thrash',
                           ('residency_admitted', 'residency_hits')),
    }


def classify_regime(delta, stall_pct=None, meta=None):
    """Ranked ``[(severity 0..1, regime, evidence), ...]`` (best first;
    empty when nothing clears its floor).  Span-level stall attribution
    is the strongest evidence; degrade counters and control-plane state
    rank by their measured share; busy shares are the counters-only
    fallback (weaker: stages overlap the step, so share != stall)."""
    candidates = []
    counters = (delta.get('counters') or {}) if delta else {}

    # 1. degrade counters: a silently-OFF plane outranks a slow stage at
    # the same share — it is invisible to every latency number.  A
    # degrading transfer plane (h2d falling back to inline puts) is a
    # link problem, so it claims the link-bound regime directly.
    ratios = degrade_ratios(delta or {})
    for plane, counter_name, regime in (
            ('cache', 'cache_degraded', 'cache-degraded'),
            ('cluster', 'cache_peer_degraded', 'cluster-cache-degraded'),
            ('shm', 'shm_degraded', 'shm-degraded'),
            ('link', 'h2d_degraded', 'link-bound'),
            ('ingest', 'ingest_degraded', 'fetch-bound'),
            ('residency', 'residency_thrash', 'residency-thrash')):
        ratio = ratios.get(plane)
        if ratio is not None and ratio >= DEGRADE_RATIO_FLOOR:
            degraded = counters.get(counter_name, 0)
            candidates.append((
                min(1.0, 0.4 + ratio),
                regime,
                '%s %d = %.0f%% of %s-plane traffic this window'
                % (counter_name, degraded, 100.0 * ratio, plane)))

    # 1b. decode-latency skew with idle workers: a handful of
    # slow pieces serializing the epoch is a SCHEDULING problem — it
    # must outrank the decode-bound busy-share reading at heavy skew,
    # because the decode-bound knob (more workers) cannot fix it.
    skew = _decode_skew(delta)
    if skew is not None:
        ratio, hist_name = skew
        utilization = (meta or {}).get('decode_utilization')
        idle_evidence = None
        if utilization is not None and utilization <= SKEW_UTILIZATION_CEIL:
            idle_evidence = ('pool decode_utilization %.2f'
                             % float(utilization))
        elif stall_pct and float(stall_pct.get('decode', 0.0) or 0.0) \
                >= STALL_PCT_FLOOR:
            idle_evidence = ('consumer stalled on decode %.0f%% of waits'
                            % float(stall_pct['decode']))
        if ratio >= _scheduling.SKEW_RATIO_FLOOR and idle_evidence is not None:
            candidates.append((
                min(1.0, 0.6 + math.log2(ratio) / 16.0),
                'skew-bound',
                '%s p99/p50 = %.0fx with %s'
                % (hist_name, ratio, idle_evidence)))

    # 2. span-level stall attribution (the strongest stage evidence).
    if stall_pct:
        by_regime = {}
        for component, regime in _STALL_REGIMES.items():
            pct = float(stall_pct.get(component, 0.0) or 0.0)
            if pct > by_regime.get(regime, (0.0, None))[0]:
                by_regime[regime] = (pct, component)
        for regime, (pct, component) in by_regime.items():
            if pct >= STALL_PCT_FLOOR:
                candidates.append((
                    min(1.0, pct / 100.0), regime,
                    '%s active for %.0f%% of the stalled time (span '
                    'attribution)' % (component, pct)))

    # 3. counters-only fallback: stage busy shares from histogram sums.
    elif delta:
        busy = busy_seconds(delta)
        total = sum(busy.values())
        if total >= MIN_BUSY_S:
            component, seconds = max(busy.items(), key=lambda kv: kv[1])
            share = seconds / total
            regime = {'decode': 'decode-bound', 'link': 'link-bound',
                      'link_stage': 'link-bound',
                      'ingest': 'fetch-bound'}.get(component)
            if regime is not None and share >= BUSY_SHARE_FLOOR:
                candidates.append((
                    0.8 * share, regime,
                    '%s holds %.0f%% of %.1fs measured stage time '
                    '(busy-share fallback; no span attribution in '
                    'this window)' % (component, 100.0 * share, total)))

    # 4. control-plane starvation: pending work no live worker can take.
    if meta:
        pending = int(meta.get('pending', 0) or 0)
        alive = meta.get('workers_alive')
        if pending > 0 and alive == 0:
            candidates.append((
                0.95, 'lease-starved',
                '%d split(s) pending with 0 live workers' % pending))
        # 4a. per-tenant starvation on a shared fleet: the
        # dispatcher names tenants whose pending work took zero grants
        # in a window where OTHER tenants were granted — the fleet
        # moved, just never for them, so this is a fairness fault, not
        # the all-stop lease-starved regime above.
        starved = list(meta.get('starved_tenants') or ())
        if starved:
            candidates.append((
                min(1.0, 0.75 + 0.05 * len(starved)),
                'tenant-starved',
                'tenant(s) %s have pending splits but took 0 lease '
                'grants this window while the rest of the fleet was '
                'granted' % ', '.join(repr(t) for t in starved[:4])))

    # 4b. control-plane degradation.  All three triggers
    # read the WINDOWED counter delta, like every other regime — a
    # drain that timed out on day 1 must not classify the fleet
    # degraded forever (the fleet snapshot carries ledger_restores /
    # drain_timeouts from the dispatcher and retry_giveups from the
    # merged worker registries, so all three window cleanly).
    window_restarts = int(counters.get('ledger_restores', 0) or 0)
    if window_restarts >= 1:
        candidates.append((
            min(1.0, 0.5 + 0.2 * window_restarts),
            'control-plane-degraded',
            'dispatcher restarted %d time(s) in this window '
            '(ledger_restores delta)' % window_restarts))
    drain_timeouts = int(counters.get('drain_timeouts', 0) or 0)
    if drain_timeouts > 0:
        candidates.append((
            min(1.0, 0.4 + 0.2 * drain_timeouts),
            'control-plane-degraded',
            '%d worker drain(s) overran drain_timeout_s in this window '
            'and left splits to requeue' % drain_timeouts))
    # Floor of 3: one giveup is routinely a single stale peer-fetch
    # hint (all advertised holders missing one digest — the cluster
    # tier calls that advisory); a dead dispatcher produces a steady
    # giveup stream from every worker's heartbeat episodes.
    giveups = int(counters.get('retry_giveups', 0) or 0)
    if giveups >= 3:
        candidates.append((
            min(1.0, 0.3 + 0.1 * giveups),
            'control-plane-degraded',
            '%d retry episode(s) exhausted their budget in this window '
            '(retry_giveups: heartbeat backoff or all-holders-failed '
            'peer fetches)' % giveups))
    # 4c. control flapping: opposing real actions from one
    # controller inside the journal's window — the decision journal is
    # the only evidence source here (bare counters cannot order the
    # actions in time).  The dispatcher ships
    # ``DecisionJournal.opposing_actions()`` in the stats meta.
    flaps = (meta or {}).get('control_flaps') or {}
    for actor, pairs in sorted(flaps.items()):
        pairs = int(pairs or 0)
        if pairs >= CONTROL_FLAP_FLOOR:
            candidates.append((
                min(1.0, 0.45 + 0.15 * pairs),
                'control-flapping',
                '%s made %d opposing action pair(s) inside one window '
                '(decision journal) — oscillating, paying both '
                'transition costs' % (actor, pairs)))
    if meta:
        # Cumulative lineage from the stats meta, crash-LOOP floor: a
        # restarted dispatcher carries a FRESH flight ring, so its own
        # restarts never show in its windowed delta — the ledger
        # lineage is the only place a repeat offender is visible.
        restarts = int(meta.get('ledger_restores', 0) or 0)
        if restarts >= 2:
            candidates.append((
                min(1.0, 0.4 + 0.15 * restarts),
                'control-plane-degraded',
                'dispatcher restarted %d times over this job (ledger '
                'lineage) — a control-plane crash loop' % restarts))

    candidates.sort(key=lambda c: c[0], reverse=True)
    return candidates


def _decode_skew(delta):
    """(p99/p50 ratio, histogram name) of the busiest per-item decode
    histogram in the window, or None without enough signal."""
    best = None
    for name in ('decode', 'decode_split'):
        hist = (delta or {}).get('histograms', {}).get(name)
        if not hist or int(hist.get('count', 0)) < SKEW_MIN_COUNT:
            continue
        p50 = hist_quantile(hist, 0.5)
        p99 = hist_quantile(hist, 0.99)
        if not p50 or p99 is None:
            continue
        ratio = p99 / p50
        if best is None or ratio > best[0]:
            best = (ratio, name)
    return best


def health_report(delta, stall_pct=None, meta=None, window_s=None):
    """One health verdict over a windowed delta.

    Returns::

        {'window_s': ..., 'regime': 'decode-bound',
         'regime_severity': 0.92, 'regime_evidence': '...',
         'candidates': [{'regime', 'severity', 'evidence'}, ...],
         'components': {'cache': {'score': 100.0, 'evidence': ...}, ...}}

    Component scores are 0 (dead) .. 100 (healthy); a component with no
    traffic and no evidence is omitted rather than scored.  ``regime``
    is ``healthy`` when no candidate clears its floor, ``idle`` when the
    window additionally shows no stage activity at all.
    """
    delta = delta or {}
    counters = delta.get('counters') or {}
    candidates = classify_regime(delta, stall_pct=stall_pct, meta=meta)
    components = {}

    if stall_pct:
        for component, keys in (('decode', ('decode', 'cache_fill')),
                                ('link', ('h2d', 'h2d_stage')),
                                ('ingest', ('ingest_fetch',)),
                                ('control', ('lease_wait',))):
            pct = max(float(stall_pct.get(k, 0.0) or 0.0) for k in keys)
            components[component] = {
                'score': round(max(0.0, 100.0 - pct), 1),
                'evidence': 'active/starved for %.0f%% of stalled time'
                            % pct,
            }
    ratios = degrade_ratios(delta)
    for plane in ('cache', 'cluster', 'shm', 'link', 'ingest', 'residency'):
        ratio = ratios.get(plane)
        if ratio is None:
            continue
        entry = {
            'score': round(100.0 * (1.0 - min(1.0, 2.0 * ratio)), 1),
            'evidence': '%.1f%% of traffic degraded' % (100.0 * ratio),
        }
        current = components.get(plane)
        if current is None:
            components[plane] = entry
        elif entry['score'] < current['score']:
            # e.g. 'link': a degrading transfer plane can be sicker than
            # its stall share says — keep the worst score, both stories.
            current['score'] = entry['score']
            current['evidence'] = '%s; %s' % (entry['evidence'],
                                              current['evidence'])
    if meta:
        failed = int(meta.get('failed', 0) or 0)
        if failed:
            entry = components.setdefault(
                'control', {'score': 100.0, 'evidence': ''})
            entry['score'] = min(entry['score'], 10.0)
            entry['evidence'] = ('%d split(s) terminally failed; %s'
                                 % (failed, entry['evidence'])).rstrip('; ')

    busy = busy_seconds(delta)
    hits = int(counters.get('residency_hits', 0) or 0)
    if candidates:
        severity, regime, evidence = candidates[0]
    elif not busy and not sum(counters.values()):
        severity, regime, evidence = 0.0, 'idle', 'no activity in window'
    elif hits and hits >= int(counters.get('residency_host_batches', 0) or 0):
        # Healthy-variant label: the window was served from
        # the device-resident tier — zero-host-batch warm path.
        severity, regime, evidence = 0.0, 'resident', (
            '%d batch(es) served from the device-resident tier this '
            'window (vs %d streamed from host); nothing degraded'
            % (hits, int(counters.get('residency_host_batches', 0) or 0)))
    else:
        severity, regime, evidence = 0.0, 'healthy', (
            'no degrade ratio or stall component above threshold')
    return {
        'window_s': round(window_s, 1) if window_s is not None else None,
        'regime': regime,
        'regime_severity': round(severity, 2),
        'regime_evidence': evidence,
        'candidates': [{'regime': r, 'severity': round(s, 2), 'evidence': e}
                       for s, r, e in candidates],
        'components': components,
    }


def report_from_frames(frames, window_s=60.0, stall_pct=None, meta=None):
    """Health over the last ``window_s`` of flight-recorder frames
    (``flight.window_frames`` picks the baseline — the ONE windowing
    rule).  One frame reads as a delta-from-start; zero frames returns
    None."""
    if not frames:
        return None
    from petastorm_tpu_torch.telemetry.flight import window_frames
    old, newest = window_frames(frames, window_s)
    delta = snapshot_delta(newest.get('snapshot'),
                           old.get('snapshot') if old else None)
    measured = (newest['t_mono'] - old['t_mono']) if old else None
    return health_report(delta, stall_pct=stall_pct, meta=meta,
                         window_s=measured if measured else window_s)


def export_gauges(registry, report):
    """Write a report's scores into ``health_<component>`` gauges (plus
    ``health_regime_severity``) so any existing
    ``MetricsRegistry.render_prometheus()`` scrape carries them."""
    if report is None:
        return
    for component, entry in report.get('components', {}).items():
        registry.gauge('health_%s' % component).set(entry['score'])
    registry.gauge('health_regime_severity').set(
        report.get('regime_severity', 0.0))


def summarize_stages(histograms):
    """Canonical per-stage summary table for a snapshot's histograms —
    the dispatcher ``stats`` / ``top`` / ``diagnose`` shared shape
    (one :func:`registry.summarize_hist` per stage)."""
    return {name: summarize_hist(hist)
            for name, hist in (histograms or {}).items()}


def format_health_line(report):
    """One-line rendering for ``top`` and the status CLI."""
    if not report:
        return 'health  (no data)'
    parts = ['health  %s' % report['regime']]
    if report['regime'] not in ('healthy', 'idle'):
        parts.append('(sev %.2f: %s)' % (report['regime_severity'],
                                         report['regime_evidence']))
    scores = '  '.join('%s %s' % (c, _fmt_score(e['score']))
                       for c, e in sorted(
                           report.get('components', {}).items()))
    if scores:
        parts.append('| ' + scores)
    return ' '.join(parts)


def _fmt_score(score):
    return '%d' % round(score) if score is not None else '-'

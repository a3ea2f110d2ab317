"""Named counters, gauges and latency histograms under one lock.

Counterpart of ``petastorm_tpu/telemetry/registry.py``: the Prometheus
text of every live registry (:meth:`MetricsRegistry.render_prometheus`,
:func:`snapshot_all`), and the snapshot algebra the fleet rollups, the
flight recorder and the health engine compute with: a snapshot is a plain
dict, :meth:`MetricsRegistry.merge` and :func:`merge_snapshots` add
snapshots, :func:`snapshot_delta` subtracts two of one source, and
:func:`summarize_hist` is the one summary of a histogram every surface
prints.  Histograms use fixed log2 buckets over microseconds: bucket ``i``
counts observations in ``[2**i, 2**(i+1))`` us, so merging is addition, and
a quantile is the upper bound of the bucket it falls in.  The hot path is
one lock and one add.

A histogram keeps **tail exemplars**: its :data:`EXEMPLARS_KEPT` slowest
observations given a ref (``observe(s, exemplar={'step': N})``, or
:meth:`Histogram.note_exemplar` after the fact) keep it, so a p99 resolves
to the provenance-journal step of the batch behind it.  Exemplars ride the
snapshots and re-rank on a merge (the worst K are kept, not added).
"""

import bisect
import math
import threading
import weakref

__all__ = ['MetricsRegistry', 'Counter', 'Gauge', 'Histogram', 'hist_quantile', 'ms',
           'snapshot_all', 'merge_snapshots', 'snapshot_delta', 'summarize_hist']

#: log2 buckets over microseconds: 1 us .. ~2.4 hours; index 0 takes the
#: sub-microsecond observations, the last one the tail.
BUCKETS = 44

#: Tail exemplars kept by each histogram: the slowest observations that
#: carried a ref.
EXEMPLARS_KEPT = 4

#: Every live registry: what a scrape of the process renders.
_LIVE = weakref.WeakSet()


def ms(seconds):
    """Seconds -> milliseconds at 3 decimals; None stays None."""
    return None if seconds is None else round(seconds * 1e3, 3)


class Counter(object):
    """Monotonic accumulator (int or float)."""

    __slots__ = ('_lock', 'value')

    def __init__(self, lock):
        self._lock = lock
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n


class Gauge(object):
    """Last-write-wins sample (rows resident, bytes held, ...)."""

    __slots__ = ('_lock', 'value')

    def __init__(self, lock):
        self._lock = lock
        self.value = 0

    def set(self, v):
        with self._lock:
            self.value = v


class Histogram(object):
    """Fixed log2-bucket latency histogram of seconds, with its tail
    exemplars (``{'bucket', 'seconds', 'ref'}``, ascending by seconds)."""

    __slots__ = ('_lock', 'counts', 'sum', 'count', 'exemplars')

    def __init__(self, lock):
        self._lock = lock
        self.counts = [0] * BUCKETS
        self.sum = 0.0
        self.count = 0
        self.exemplars = []

    def observe(self, seconds, exemplar=None):
        index = _bucket(seconds)
        with self._lock:
            self.counts[index] += 1
            self.sum += seconds
            self.count += 1
            if exemplar is not None:
                self._note_exemplar_locked(index, seconds, exemplar)

    def note_exemplar(self, seconds, ref):
        """Attach a tail exemplar to an observation counted earlier (the
        loader observes each stage, then seals the batch's record and
        learns its step)."""
        with self._lock:
            self._note_exemplar_locked(_bucket(seconds), seconds, ref)

    def _note_exemplar_locked(self, index, seconds, ref):
        self.exemplars.append({'bucket': index, 'seconds': round(seconds, 6), 'ref': ref})
        self.exemplars.sort(key=lambda e: e['seconds'])
        del self.exemplars[:-EXEMPLARS_KEPT]

    def quantile(self, q):
        """Upper bound (seconds) of the bucket quantile ``q`` falls in; None
        when empty."""
        return hist_quantile({'counts': self.counts, 'count': self.count}, q)


class MetricsRegistry(object):
    """Get-or-create instruments by name: the same name returns the same
    instrument, so a loader and its transfer plane share one registry."""

    def __init__(self, namespace=''):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}
        _LIVE.add(self)

    def _get(self, table, name, factory):
        with self._lock:
            instrument = table.get(name)
            if instrument is None:
                instrument = table[name] = factory(self._lock)
            return instrument

    def counter(self, name):
        return self._get(self._counters, name, Counter)

    def gauge(self, name):
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name):
        return self._get(self._histograms, name, Histogram)

    def snapshot(self):
        """Plain-dict copy of every instrument."""
        with self._lock:
            return {
                'namespace': self.namespace,
                'counters': {k: c.value for k, c in self._counters.items()},
                'gauges': {k: g.value for k, g in self._gauges.items()},
                'histograms': {k: _hist_dict(h) for k, h in self._histograms.items()},
            }

    def merge(self, snapshot):
        """Add a :meth:`snapshot` of another registry into this one: counters
        and histograms (bucket by bucket) add, gauges take its values, the
        exemplars re-rank."""
        if not snapshot:
            return
        for name, value in (snapshot.get('counters') or {}).items():
            self.counter(name).inc(value)
        for name, value in (snapshot.get('gauges') or {}).items():
            self.gauge(name).set(value)
        for name, hist in (snapshot.get('histograms') or {}).items():
            mine = self.histogram(name)
            with self._lock:
                for i, n in enumerate(hist.get('counts', ())):
                    if i < BUCKETS:
                        mine.counts[i] += n
                mine.sum += hist.get('sum', 0.0)
                mine.count += hist.get('count', 0)
                if hist.get('exemplars'):
                    mine.exemplars = _merge_exemplars([mine.exemplars, hist['exemplars']])

    def as_dict(self):
        """Flat view: counters and gauges by name, and ``<hist>_count``,
        ``<hist>_p50_ms`` and ``<hist>_p99_ms`` for each histogram."""
        snap = self.snapshot()
        out = dict(snap['counters'])
        out.update(snap['gauges'])
        for name, hist in snap['histograms'].items():
            out[name + '_count'] = hist['count']
            for label, q in (('p50', 0.5), ('p99', 0.99)):
                out['%s_%s_ms' % (name, label)] = ms(hist_quantile(hist, q))
        return out

    def render_prometheus(self):
        """The Prometheus text exposition of every instrument, the
        reference's: the namespace becomes the metric prefix after
        ``petastorm_tpu_``, and a histogram's buckets are cumulative with
        their upper bounds in seconds."""
        snap = self.snapshot()
        prefix = 'petastorm_tpu_'
        if snap['namespace']:
            prefix += _sanitize(snap['namespace']) + '_'
        lines = []
        for kind in ('counter', 'gauge'):
            for name, value in sorted(snap[kind + 's'].items()):
                metric = prefix + _sanitize(name)
                lines += ['# TYPE %s %s' % (metric, kind), '%s %s' % (metric, _fmt(value))]
        for name, hist in sorted(snap['histograms'].items()):
            metric = prefix + _sanitize(name) + '_seconds'
            lines.append('# TYPE %s histogram' % metric)
            cumulative = 0
            for i, n in enumerate(hist['counts']):
                cumulative += n
                if n:
                    lines.append('%s_bucket{le="%g"} %d' % (metric, (2.0 ** (i + 1)) / 1e6,
                                                            cumulative))
            lines.append('%s_bucket{le="+Inf"} %d' % (metric, hist['count']))
            lines.append('%s_sum %s' % (metric, _fmt(hist['sum'])))
            lines.append('%s_count %d' % (metric, hist['count']))
        return '\n'.join(lines) + '\n'


def _bucket(seconds):
    us = seconds * 1e6
    return 0 if us < 1.0 else min(BUCKETS - 1, int(math.log2(us)))


def _hist_dict(hist):
    """A histogram's snapshot; ``exemplars`` only when it has some, so an
    exemplar-free snapshot keeps its old shape."""
    out = {'counts': list(hist.counts), 'sum': hist.sum, 'count': hist.count}
    if hist.exemplars:
        out['exemplars'] = list(hist.exemplars)
    return out


def _merge_exemplars(exemplar_lists):
    """The worst :data:`EXEMPLARS_KEPT` of several exemplar lists, ascending
    by seconds: exemplars are refs, so a merge re-ranks them."""
    merged = [e for exemplars in exemplar_lists for e in exemplars or ()]
    merged.sort(key=lambda e: e.get('seconds', 0.0))
    return merged[-EXEMPLARS_KEPT:]


def _sanitize(name):
    return ''.join(c if (c.isalnum() or c == '_') else '_' for c in name)


def _fmt(value):
    if isinstance(value, float):
        return repr(round(value, 6))
    return str(value)


def snapshot_all():
    """A :meth:`MetricsRegistry.snapshot` of every live registry."""
    return [r.snapshot() for r in list(_LIVE)]


def merge_snapshots(snapshots):
    """The fleet rollup of several snapshots: counters and histogram buckets
    add, gauges take the last value, exemplars re-rank.  Stateless: the
    dispatcher merges the workers' current heartbeat snapshots again at
    every call, so nothing counts twice."""
    merged = {'namespace': 'fleet', 'counters': {}, 'gauges': {}, 'histograms': {}}
    for snap in snapshots:
        if not snap:
            continue
        for name, value in (snap.get('counters') or {}).items():
            merged['counters'][name] = merged['counters'].get(name, 0) + value
        for name, value in (snap.get('gauges') or {}).items():
            merged['gauges'][name] = value
        for name, hist in (snap.get('histograms') or {}).items():
            mine = merged['histograms'].setdefault(
                name, {'counts': [0] * BUCKETS, 'sum': 0.0, 'count': 0})
            for i, n in enumerate(hist.get('counts', ())):
                if i < BUCKETS:
                    mine['counts'][i] += n
            mine['sum'] += hist.get('sum', 0.0)
            mine['count'] += hist.get('count', 0)
            if hist.get('exemplars'):
                mine['exemplars'] = _merge_exemplars([mine.get('exemplars'), hist['exemplars']])
    return merged


def hist_quantile(hist, q):
    """Quantile (seconds) of a histogram snapshot dict: the upper bound of
    the bucket it falls in; None when empty."""
    count = hist.get('count', 0)
    if not count:
        return None
    rank = max(1, int(math.ceil(q * count)))
    cumulative = []
    total = 0
    for n in hist['counts']:
        total += n
        cumulative.append(total)
    index = bisect.bisect_left(cumulative, rank)
    return (2.0 ** (index + 1)) / 1e6


def summarize_hist(hist):
    """The one summary of a histogram snapshot every surface prints (the
    dispatcher's ``stats``, ``top``, ``diagnose``): ``{'count', 'p50_ms',
    'p99_ms', 'max_ms'}``, quantiles and the maximum as bucket upper bounds,
    plus ``exemplar`` (the worst observation's ref and ms) when the
    histogram kept any."""
    count = int(hist.get('count', 0) or 0)
    out = {'count': count,
           'p50_ms': ms(hist_quantile(hist, 0.5)),
           'p99_ms': ms(hist_quantile(hist, 0.99)),
           'max_ms': None}
    counts = hist.get('counts') or ()
    for i in range(len(counts) - 1, -1, -1):
        if counts[i]:
            out['max_ms'] = ms((2.0 ** (i + 1)) / 1e6)
            break
    exemplars = hist.get('exemplars')
    if exemplars:
        worst = exemplars[-1]
        out['exemplar'] = {'ref': worst.get('ref'), 'ms': ms(worst.get('seconds'))}
    return out


def snapshot_delta(new, old):
    """``new - old`` for two snapshots of one cumulative source: counters
    and histogram buckets subtract, gauges take ``new``'s values.  A negative
    difference clamps to zero (a restarted worker's counters start again:
    "no progress seen" is the honest reading), and the exemplars kept are
    those that appeared in the window.  ``old=None`` gives ``new`` (the delta
    since the process started)."""
    if not new:
        return merge_snapshots([])
    if not old:
        return merge_snapshots([new])
    out = {'namespace': new.get('namespace', ''), 'counters': {},
           'gauges': dict(new.get('gauges') or {}), 'histograms': {}}
    old_counters = old.get('counters') or {}
    for name, value in (new.get('counters') or {}).items():
        out['counters'][name] = max(0, value - old_counters.get(name, 0))
    old_hists = old.get('histograms') or {}
    for name, hist in (new.get('histograms') or {}).items():
        prev = old_hists.get(name) or {}
        prev_counts = prev.get('counts') or ()
        counts = [max(0, n - (prev_counts[i] if i < len(prev_counts) else 0))
                  for i, n in enumerate(hist.get('counts') or ())]
        out['histograms'][name] = {
            'counts': counts,
            'sum': max(0.0, hist.get('sum', 0.0) - prev.get('sum', 0.0)),
            'count': max(0, hist.get('count', 0) - prev.get('count', 0)),
        }
        fresh = [e for e in hist.get('exemplars') or () if e not in (prev.get('exemplars') or ())]
        if fresh:
            out['histograms'][name]['exemplars'] = fresh
    return out

"""Named counters and latency histograms under one lock.

Counterpart of ``petastorm_tpu/telemetry/registry.py``, cut to what the
transfer plane, the loader and the thread pool use (its gauges, merging
across processes, exemplars and Prometheus text are not ported).  Histograms use fixed log2 buckets over microseconds: bucket ``i``
counts observations in ``[2**i, 2**(i+1))`` us, and a quantile is the upper
bound of the bucket it falls in.  The hot path is one lock and one add.
"""

import bisect
import math
import threading

__all__ = ['MetricsRegistry', 'Counter', 'Histogram', 'hist_quantile', 'ms']

#: log2 buckets over microseconds: 1 us .. ~2.4 hours; index 0 takes the
#: sub-microsecond observations, the last one the tail.
BUCKETS = 44


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


class Histogram(object):
    """Fixed log2-bucket latency histogram of seconds."""

    __slots__ = ('_lock', 'counts', 'sum', 'count')

    def __init__(self, lock):
        self._lock = lock
        self.counts = [0] * BUCKETS
        self.sum = 0.0
        self.count = 0

    def observe(self, seconds):
        us = seconds * 1e6
        index = 0 if us < 1.0 else min(BUCKETS - 1, int(math.log2(us)))
        with self._lock:
            self.counts[index] += 1
            self.sum += seconds
            self.count += 1

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
        self._histograms = {}

    def _get(self, table, name, factory):
        with self._lock:
            instrument = table.get(name)
            if instrument is None:
                instrument = table[name] = factory(self._lock)
            return instrument

    def counter(self, name):
        return self._get(self._counters, name, Counter)

    def histogram(self, name):
        return self._get(self._histograms, name, Histogram)

    def snapshot(self):
        """Plain-dict copy of every instrument."""
        with self._lock:
            return {
                'namespace': self.namespace,
                'counters': {k: c.value for k, c in self._counters.items()},
                'histograms': {k: {'counts': list(h.counts), 'sum': h.sum, 'count': h.count}
                               for k, h in self._histograms.items()},
            }

    def as_dict(self):
        """Flat view: counters by name, and ``<hist>_count``,
        ``<hist>_p50_ms`` and ``<hist>_p99_ms`` for each histogram."""
        snap = self.snapshot()
        out = dict(snap['counters'])
        for name, hist in snap['histograms'].items():
            out[name + '_count'] = hist['count']
            for label, q in (('p50', 0.5), ('p99', 0.99)):
                out['%s_%s_ms' % (name, label)] = ms(hist_quantile(hist, q))
        return out


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

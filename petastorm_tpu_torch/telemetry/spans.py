"""Spans across process boundaries, and the attribution of a consumer's
data wait to them.

Counterpart of ``petastorm_tpu/telemetry/spans.py``.  A process that works
for another (a service worker) records its spans into a bounded
:class:`SpanBuffer` or a list, each keyed by a correlation id (``split/seq``
for a service chunk), and ships them on the frames its data already travels
on (a split's ``end`` header).  The receiving process merges them into its
:class:`~petastorm_tpu_torch.benchmark.TraceRecorder`
(:func:`merge_into_recorder`) shifted by the clock offset between the two
processes, which :func:`measure_clock_offset` estimates from one round trip.
A span is a flat dict::

    {'name': 'service/serialize', 't0': <monotonic s>, 't1': <monotonic s>,
     'pid': 1234, 'tid': <thread ident>, 'cid': '7/3'}

``time.monotonic()`` is shared by the processes of one host and arbitrary
between hosts; the service chains the client's offset to the dispatcher with
each worker's offset to the dispatcher.

The ``data_wait`` windows a
:class:`~petastorm_tpu_torch.benchmark.StallMonitor` records are intersected
with the spans of each component (decode, IPC, the transfer's link and its
staging copy, ...), on any thread, so a wait on the training thread is
split by what the other threads and processes were doing meanwhile
(:func:`attribute_stalls`).  Standard library only.
"""

import os
import threading
import time
from collections import deque

__all__ = ['SpanBuffer', 'current_buffer', 'merge_into_recorder', 'measure_clock_offset',
           'attribute_stalls', 'STALL_COMPONENTS']


class SpanBuffer(object):
    """A bounded buffer of a process's completed spans.  :meth:`drain` hands
    them to the channel that ships them and empties the buffer; a buffer
    nobody drains keeps the latest ``max_spans``."""

    def __init__(self, max_spans=4096):
        self._spans = deque(maxlen=int(max_spans))
        self._lock = threading.Lock()

    # a buffer belongs to its process: pickled, it carries its pending spans
    def __getstate__(self):
        return {'spans': self.peek(), 'maxlen': self._spans.maxlen}

    def __setstate__(self, state):
        self.__init__(state['maxlen'])
        self._spans.extend(state['spans'])

    def span(self, name, t0, t1, cid=None, **args):
        ev = {'name': name, 't0': t0, 't1': t1, 'pid': os.getpid(),
              'tid': threading.get_ident()}
        if cid is not None:
            ev['cid'] = str(cid)
        if args:
            ev['args'] = args
        with self._lock:
            self._spans.append(ev)

    def drain(self):
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def peek(self):
        with self._lock:
            return list(self._spans)

    def __len__(self):
        return len(self._spans)


_BUFFER = None
_BUFFER_PID = None
_BUFFER_LOCK = threading.Lock()


def current_buffer():
    """The process's span buffer, made anew after a fork (a child never
    drains its parent's spans).  For a process with one draining channel;
    a part that several drainers share keeps its own :class:`SpanBuffer`."""
    global _BUFFER, _BUFFER_PID
    pid = os.getpid()
    with _BUFFER_LOCK:
        if _BUFFER is None or _BUFFER_PID != pid:
            _BUFFER = SpanBuffer()
            _BUFFER_PID = pid
        return _BUFFER


def merge_into_recorder(recorder, spans, clock_offset_s=0.0, pid=None):
    """Append span dicts of another process to a ``TraceRecorder``.
    ``clock_offset_s`` is (this clock - theirs), added to their times.  The
    recording thread's ident is kept, so concurrent threads of one process
    land on tracks of their own.  Returns the number merged."""
    if recorder is None or not spans:
        return 0
    for span in spans:
        args = dict(span.get('args') or {})
        if span.get('cid') is not None:
            args['cid'] = span['cid']
        recorder.event(span['name'], span['t0'] + clock_offset_s, span['t1'] + clock_offset_s,
                       pid=pid if pid is not None else span.get('pid'), tid=span.get('tid'),
                       **args)
    return len(spans)


def measure_clock_offset(call):
    """One clock handshake: ``call()`` returns the other process's
    ``time.monotonic()`` (a round trip).  Returns ``(local - remote,
    rtt_s)``: the offset from the round trip's midpoint, wrong by at most
    half the round trip."""
    t0 = time.monotonic()
    remote = call()
    t1 = time.monotonic()
    return (t0 + t1) / 2.0 - float(remote), t1 - t0


#: Component -> span names that evidence it.  Parallel stages can overlap
#: the same wait, so the percentages may sum past 100.
STALL_COMPONENTS = {
    'decode': ('service/decode_split', 'pool/process'),
    'ipc': ('service/serialize', 'service/shm_publish', 'pool/publish'),
    'cache_fill': ('cache/fill',),
    # the link (the inline put, the plane's dispatch and commit waits)
    # apart from the host's staging copy into the slab
    'h2d': ('device_put', 'h2d/dispatch', 'h2d/commit'),
    'h2d_stage': ('h2d/stage',),
    'ingest_fetch': ('ingest/fetch', 'ingest/hedge'),
}

#: Spans that cover a whole wait by construction: only the part of them no
#: component covers counts, as ``lease_wait`` (starvation).
_WAIT_WRAPPERS = ('service/split_wait', 'service/lease_wait')


def attribute_stalls(events, wait_name='data_wait'):
    """Split the ``wait_name`` time of Chrome-trace ``events`` by component.

    Returns ``{'total_wait_s': ..., 'pct': {component: pct, ...,
    'lease_wait': pct, 'other': pct}, 'top': component}``, or None when no
    wait spans exist.  ``other`` is the wait no span accounts for.
    """
    waits = _intervals(events, (wait_name,))
    if not waits:
        return None
    total = sum(e - s for s, e in waits)
    if total <= 0.0:
        return None
    pct = {}
    covered = []
    for component, names in STALL_COMPONENTS.items():
        overlap = _clip(_intervals(events, names), waits)
        covered.extend(overlap)
        pct[component] = round(100.0 * sum(e - s for s, e in overlap) / total, 2)
    stage_union = _union(covered)
    starved = _subtract(_clip(_intervals(events, _WAIT_WRAPPERS), waits), stage_union)
    pct['lease_wait'] = round(100.0 * sum(e - s for s, e in starved) / total, 2)
    accounted = _union(stage_union + starved)
    uncovered = total - sum(e - s for s, e in accounted)
    pct['other'] = round(100.0 * max(0.0, uncovered) / total, 2)
    top = max(pct, key=pct.get)
    return {'total_wait_s': round(total / 1e6, 4), 'pct': pct, 'top': top}


def _intervals(events, names):
    """Merged [start, end) us intervals of the named 'X' spans."""
    return _union([(ev['ts'], ev['ts'] + ev['dur']) for ev in events
                   if ev.get('ph') == 'X' and ev.get('name') in names])


def _union(ivals):
    out = []
    for start, end in sorted(ivals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _clip(ivals, windows):
    """Merged intervals intersected with merged windows."""
    out = []
    for start, end in ivals:
        for w0, w1 in windows:
            lo, hi = max(start, w0), min(end, w1)
            if hi > lo:
                out.append((lo, hi))
    return _union(out)


def _subtract(ivals, holes):
    """Merged intervals minus merged holes."""
    out = []
    for start, end in ivals:
        cursor = start
        for h0, h1 in holes:
            if h1 <= cursor or h0 >= end:
                continue
            if h0 > cursor:
                out.append((cursor, h0))
            cursor = max(cursor, h1)
            if cursor >= end:
                break
        if cursor < end:
            out.append((cursor, end))
    return out

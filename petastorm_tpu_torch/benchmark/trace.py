"""Chrome-trace timeline of the data path.

Counterpart of ``petastorm_tpu/benchmark/trace.py``.  The loader's
``stats`` are totals; a :class:`TraceRecorder` keeps the same sections as
spans, one per batch and thread, and dumps them in the Chrome Trace Event
format for ``chrome://tracing`` or Perfetto::

    rec = TraceRecorder()
    loader = DataLoader(reader, batch_size=64, trace_recorder=rec)
    monitor = StallMonitor(trace_recorder=rec)
    for batch in monitor.wrap(loader):
        train_step(batch)
    rec.dump('timeline.json')

Spans: ``host_batch`` (the wait on the decode plane), ``transform`` (the
user hook), ``device_put`` (an inline put) and the transfer plane's
``h2d/stage``, ``h2d/dispatch`` and ``h2d/commit`` from the loaders, and
``data_wait`` and ``step`` from ``StallMonitor.wrap``.  With the transfer
plane on, the loader's spans lie on the dispatch thread's track and the
monitor's on the training thread's.
"""

import json
import os
import threading
import time
import weakref
from collections import deque

__all__ = ['TraceRecorder', 'all_recorder_events']

#: Every live recorder, for a crash dump (``telemetry.dump_state``).
_LIVE = weakref.WeakSet()


class TraceRecorder(object):
    """Bounded, thread-safe recorder of Chrome Trace Event spans; the ring
    keeps the last ``max_events``."""

    def __init__(self, max_events=100_000):
        self._events = deque(maxlen=int(max_events))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()   # the trace's origin
        _LIVE.add(self)

    def event(self, name, t_start_s, t_end_s, pid=None, tid=None, **args):
        """Record one complete span; times are ``time.monotonic()`` seconds.
        ``pid``/``tid`` override the recording process and thread."""
        ev = {
            'name': name,
            'ph': 'X',
            'ts': round(1e6 * (t_start_s - self._t0), 1),
            'dur': round(1e6 * max(0.0, t_end_s - t_start_s), 1),
            'pid': os.getpid() if pid is None else pid,
            'tid': threading.get_ident() if tid is None else tid,
        }
        if args:
            ev['args'] = args
        with self._lock:
            self._events.append(ev)

    def set_process_label(self, pid, label):
        """Name a pid's track (a metadata 'M' event)."""
        with self._lock:
            self._events.append({'name': 'process_name', 'ph': 'M', 'pid': pid, 'tid': 0,
                                 'args': {'name': str(label)}})

    def instant(self, name, **args):
        """Record a point-in-time marker (epoch boundary, checkpoint, ...)."""
        ev = {
            'name': name,
            'ph': 'i',
            's': 't',   # thread-scoped
            'ts': round(1e6 * (time.monotonic() - self._t0), 1),
            'pid': os.getpid(),
            'tid': threading.get_ident(),
        }
        if args:
            ev['args'] = args
        with self._lock:
            self._events.append(ev)

    @property
    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()

    def dump(self, path):
        """Write ``{"traceEvents": [...]}`` (the Chrome/Perfetto JSON object
        form); returns the number of events."""
        events = self.events
        with open(path, 'w') as f:
            json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)
        return len(events)


def all_recorder_events():
    """Each live recorder's events with its monotonic origin (``ts`` is
    relative to it: ``origin_monotonic + ts / 1e6`` puts every event back on
    the process clock)."""
    return [{'origin_monotonic': recorder._t0, 'events': recorder.events}
            for recorder in list(_LIVE)]

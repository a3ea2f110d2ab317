"""Always-on flight recorder: the minutes before a failure, per process.

Counterpart of ``petastorm_tpu/telemetry/flight.py``.  Every other surface
is current state; this one keeps the trajectory: a bounded ring of periodic
**frames**, each the merged snapshot of every live registry of the process
(``registry.merge_snapshots``), the spans that ended since the last frame,
the worst provenance summaries and the newest decisions, stamped with both
clocks.  Two frames subtract into a window's delta
(``registry.snapshot_delta``, over :func:`window_frames`), the input of the
health engine (:mod:`~petastorm_tpu_torch.telemetry.health`) and of
``diagnose``.

A frame is one merge and one span peek every ``interval_s`` (2 s) on a
daemon thread: nothing rides the data path.  With a ``persist_path`` the
ring overwrites one JSON file every ``persist_every`` frames (a temporary
file replaced into place), so a process killed with SIGKILL leaves its last
periodic write behind; :meth:`FlightRecorder.persist` writes on demand.
The recorder peeks the span buffer and never drains it: the spans belong to
their return channel.  While it persists, the recorder holds a shared
``flock`` on ``<dump>.owner`` for its lifetime, which :func:`sweep_dumps`
probes to tell a live owner's dump from a dead one's.

:func:`enable` arms one recorder per process (a fork gets a fresh one): the
loaders, the service workers.  The dispatcher keeps its own instance whose
source is the fleet's merged heartbeat snapshots.
``PETASTORM_TPU_NO_FLIGHT=1`` turns :func:`enable` off;
``PETASTORM_TPU_FLIGHT_DIR`` names the directory of the dumps and
``PETASTORM_TPU_FLIGHT_INTERVAL_S`` the interval.  Nothing here loads
torch.
"""

import fcntl
import os
import re
import threading
import time

from petastorm_tpu_torch.telemetry import decisions, provenance
from petastorm_tpu_torch.telemetry.registry import merge_snapshots, snapshot_all
from petastorm_tpu_torch.telemetry.spans import current_buffer
from petastorm_tpu_torch.workers_pool.shm_plane import flock_probe_unlink, pid_alive

__all__ = ['FlightRecorder', 'window_frames', 'enable', 'get', 'disable', 'dump_current',
           'default_persist_path', 'sweep_dumps']


def window_frames(frames, seconds=None):
    """The one windowing rule of every consumer: ``(baseline, newest)`` of a
    frame list.  ``newest`` is the last frame; ``baseline`` the newest frame
    at or behind the ``seconds`` horizon (the oldest when the ring is
    younger than the window; the first with ``seconds=None``), or None
    with fewer than two frames.  ``(None, None)`` for no frames."""
    if not frames:
        return None, None
    newest = frames[-1]
    if len(frames) == 1:
        return None, newest
    if seconds is None:
        return frames[0], newest
    horizon = newest['t_mono'] - float(seconds)
    baseline = frames[0]
    for frame in frames[:-1]:
        if frame['t_mono'] <= horizon:
            baseline = frame
        else:
            break
    return baseline, newest


#: About 8 minutes of history at the default interval.
DEFAULT_INTERVAL_S = 2.0
DEFAULT_MAX_FRAMES = 240

#: The spans one frame keeps at most.
_MAX_SPANS_PER_FRAME = 256


class FlightRecorder(object):
    """A bounded ring of periodic telemetry frames.

    Args:
        interval_s: seconds between frames.
        max_frames: the ring's bound (the oldest frames go first).
        source: a callable returning a merged registry snapshot; default the
            merge of every live registry of the process (the dispatcher
            passes its fleet merge).
        label: the tag of the dumps (``'trainer'``, ``'service_worker'``).
        persist_path: the file the ring overwrites every ``persist_every``
            frames and at :meth:`persist`.

    Tick it with :meth:`start` (a daemon thread) or by calling
    :meth:`maybe_tick` from a loop the process runs anyway (the
    dispatcher's serve loop).
    """

    def __init__(self, interval_s=None, max_frames=None, source=None, label=None,
                 persist_path=None, persist_every=8):
        self.interval_s = float(interval_s if interval_s is not None else DEFAULT_INTERVAL_S)
        self.max_frames = int(max_frames if max_frames is not None else DEFAULT_MAX_FRAMES)
        self.label = label
        self.persist_path = persist_path
        self.persist_every = max(1, int(persist_every))
        self._source = source
        self._frames = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._last_tick = 0.0
        self._span_watermark = 0.0
        self._ticks = 0
        self._owner_fd = None
        self._started_monotonic = time.monotonic()
        self._started_unix = time.time()

    # -- recording -----------------------------------------------------------

    def tick(self):
        """Record one frame; a failure drops the frame, never the process."""
        try:
            frame = self._build_frame()
        except Exception:  # noqa: BLE001 — diagnostics are best effort
            return None
        with self._lock:
            self._frames.append(frame)
            del self._frames[:-self.max_frames]
            self._ticks += 1
            ticks = self._ticks
        self._last_tick = time.monotonic()
        if self.persist_path and ticks % self.persist_every == 0:
            self.persist(reason='periodic')
        return frame

    def maybe_tick(self):
        """Tick when ``interval_s`` passed since the last frame."""
        if time.monotonic() - self._last_tick >= self.interval_s:
            return self.tick()
        return None

    def _build_frame(self):
        snapshot = self._source() if self._source is not None \
            else merge_snapshots(snapshot_all())
        # the spans that ended since the last frame; the buffer stays whole
        pending = current_buffer().peek()
        fresh = [s for s in pending if s.get('t1', 0.0) > self._span_watermark]
        if fresh:
            self._span_watermark = max(s['t1'] for s in fresh)
        frame = {'t_mono': time.monotonic(), 'unix_time': time.time(), 'snapshot': snapshot,
                 'spans': fresh[-_MAX_SPANS_PER_FRAME:], 'span_residue': len(pending)}
        # compact refs in the bounded ring; the whole journals ride dump()
        worst = provenance.worst_summaries()
        if worst:
            frame['provenance_worst'] = worst
        recent = decisions.recent_summaries()
        if recent:
            frame['decisions_recent'] = recent
        return frame

    # -- the thread ------------------------------------------------------------

    def start(self):
        """Start the daemon tick thread (once).  Everything it touches is
        imported here, on the arming thread."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name='telemetry-flight', daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self):
        """Stop ticking and release the owner lock and its file (an unlocked
        ``.owner`` would read as a dead owner and get this live dump swept)."""
        self._stop.set()
        with self._lock:
            fd, self._owner_fd = self._owner_fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
            if self.persist_path:
                try:
                    os.unlink(self.persist_path + '.owner')
                except OSError:
                    pass

    # -- reading ---------------------------------------------------------------

    def frames(self):
        with self._lock:
            return list(self._frames)

    def window(self, seconds=None):
        """:func:`window_frames` over the ring."""
        return window_frames(self.frames(), seconds)

    def dump(self):
        """The ring, the process's identity, and the whole provenance and
        decision journals, JSON-able."""
        return {
            'kind': 'flight_recorder',
            'pid': os.getpid(),
            'label': self.label,
            'interval_s': self.interval_s,
            'started_monotonic': self._started_monotonic,
            'started_unix': self._started_unix,
            'frames': self.frames(),
            'provenance': provenance.dump_journals(),
            'decisions': decisions.dump_journals(),
        }

    def _hold_owner(self, path):
        """Take the lifetime shared flock on ``<path>.owner`` (once): the
        liveness signal :func:`sweep_dumps` probes.  The kernel releases it
        on any death, SIGKILL included; the dump's own inode changes at
        every replace, hence the separate file."""
        with self._lock:
            if self._owner_fd is not None or self._stop.is_set():
                return
        fd = None
        try:
            fd = os.open(path + '.owner', os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
            with self._lock:
                if self._stop.is_set():
                    raise OSError('recorder stopped during owner setup')
                self._owner_fd = fd
        except OSError:
            # an unlocked sidecar would read as "owner gone": remove it
            # (its name is this process's, never another's)
            if fd is not None:
                os.close(fd)
                try:
                    os.unlink(path + '.owner')
                except OSError:
                    pass
            self._owner_fd = None

    def persist(self, path=None, reason=None):
        """:meth:`dump` written atomically; the path, or None on any
        failure (persistence is best effort)."""
        path = path or self.persist_path
        if not path:
            return None
        try:
            state = self.dump()
            if reason is not None:
                state['reason'] = reason
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._hold_owner(path)
        except Exception:  # noqa: BLE001 — a failed artifact beats a dead process
            return None
        return provenance.atomic_json_dump(path, state)


# -- the dump directory's hygiene ---------------------------------------------

#: ``flight_<label>_<pid>.json`` and the SLO watchdog's
#: ``provenance_slo_<label>_<pid>.json``, and their ``.owner`` files.
_DUMP_NAME = re.compile(r'^(?:flight|provenance_slo)_.+_(\d+)\.json(?P<owner>\.owner)?$')

#: Temporary files of writers killed mid-write, of this naming scheme only:
#: the sweep never touches another program's ``*.tmp``.
_TMP_NAME = re.compile(r'^(?:flight|provenance_slo)_.+\.json\.\d+\.tmp$')

#: A dump younger than this is never swept (a process that died a minute
#: ago is when its dump is read).
DEFAULT_SWEEP_MIN_AGE_S = 24 * 3600.0


def sweep_dumps(directory=None, min_age_s=DEFAULT_SWEEP_MIN_AGE_S):
    """Remove the flight and SLO dumps under ``directory`` (default
    ``PETASTORM_TPU_FLIGHT_DIR``) that are older than ``min_age_s`` and whose
    owner is gone: its ``.owner`` file's flock is free, or, without one, its
    pid is dead.  Stale temporary files go under the same age rule.
    Returns ``{'swept', 'kept', 'tmp_swept'}``; never raises."""
    directory = directory or os.environ.get('PETASTORM_TPU_FLIGHT_DIR')
    result = {'swept': 0, 'kept': 0, 'tmp_swept': 0}
    if not directory or not os.path.isdir(directory):
        return result
    now = time.time()
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return result
    for name in names:
        path = os.path.join(directory, name)
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            continue   # gone meanwhile (a sweep beside this one)
        if age < min_age_s:
            if _DUMP_NAME.match(name):
                result['kept'] += 1
            continue
        if name.endswith('.tmp'):
            if _TMP_NAME.match(name) and flock_probe_unlink(path):
                result['tmp_swept'] += 1
            continue
        match = _DUMP_NAME.match(name)
        if not match:
            continue
        if match.group('owner'):
            # an owner file whose dump is gone already
            if flock_probe_unlink(path):
                result['swept'] += 1
            continue
        owner = path + '.owner'
        if os.path.exists(owner):
            if not flock_probe_unlink(owner):
                result['kept'] += 1   # its owner lives
                continue
        elif pid_alive(int(match.group(1))):
            result['kept'] += 1
            continue
        try:
            os.unlink(path)
            result['swept'] += 1
        except OSError:
            result['kept'] += 1
    return result


# -- the process's recorder -----------------------------------------------------

_RECORDER = None
_RECORDER_PID = None
_SINGLETON_LOCK = threading.Lock()


def _disabled_by_env():
    return os.environ.get('PETASTORM_TPU_NO_FLIGHT', '') not in ('', '0')


def default_persist_path(label=None):
    """``flight_<label>_<pid>.json`` under ``PETASTORM_TPU_FLIGHT_DIR``, or
    None when it is not set."""
    directory = os.environ.get('PETASTORM_TPU_FLIGHT_DIR')
    if not directory:
        return None
    return os.path.join(directory, 'flight_%s_%d.json' % (label or 'proc', os.getpid()))


def enable(label=None, interval_s=None, persist_path=None, source=None):
    """Arm (or return) the process's recorder: the first caller's label and
    interval win.  None under ``PETASTORM_TPU_NO_FLIGHT=1``.  The first
    recorder of a process that persists sweeps its directory of old dead
    owners' dumps."""
    global _RECORDER, _RECORDER_PID
    if _disabled_by_env():
        return None
    pid = os.getpid()
    with _SINGLETON_LOCK:
        if _RECORDER is None or _RECORDER_PID != pid:
            env_interval = os.environ.get('PETASTORM_TPU_FLIGHT_INTERVAL_S')
            if interval_s is None and env_interval:
                try:
                    interval_s = float(env_interval)
                except ValueError:
                    interval_s = None
            if persist_path is None:
                persist_path = default_persist_path(label)
            if persist_path is not None:
                try:
                    sweep_dumps(os.path.dirname(persist_path))
                except Exception:  # noqa: BLE001 — hygiene is best effort
                    pass
            _RECORDER = FlightRecorder(interval_s=interval_s, label=label,
                                       persist_path=persist_path, source=source)
            _RECORDER_PID = pid
            _RECORDER.start()
        return _RECORDER


def get():
    """The process's live recorder, or None."""
    with _SINGLETON_LOCK:
        if _RECORDER is not None and _RECORDER_PID == os.getpid():
            return _RECORDER
        return None


def disable():
    """Stop and forget the process's recorder."""
    global _RECORDER, _RECORDER_PID
    with _SINGLETON_LOCK:
        if _RECORDER is not None:
            _RECORDER.stop()
        _RECORDER = None
        _RECORDER_PID = None


def dump_current():
    """The process recorder's dump, or None (what ``dump_state`` carries)."""
    recorder = get()
    return recorder.dump() if recorder is not None else None

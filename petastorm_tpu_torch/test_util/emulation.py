"""Deterministic cold-store emulation for tests and measurements.

Counterpart of ``petastorm_tpu/test_util/emulation.py``:
:class:`BandwidthLimitedFilesystem` wraps a filesystem so that every binary
read streams chunk by chunk paying ``bytes/bps`` of GIL-released sleep, and
files of at least ``cold_threshold`` bytes also pay ``cold_latency`` once per
open handle before its first read (a cold-tier GET round trip).  It is the
harness of the ingest plane's and the adaptive scheduler's tests, of the
chaos harness's ``fetch_latency_spike`` scenario and of ``chip_smoke.py``'s
``phase_ingest``.
"""

import time

__all__ = ['BandwidthLimitedFilesystem']


#: Emulated reads stream in 256 KiB chunks, each followed by its share
#: of the bandwidth sleep — like a real remote filesystem.  One giant
#: read-then-sleep would be wrong twice over: no cold store returns
#: 10 MB in a single burst, and the undivided Python-level read of that
#: burst holds the GIL long enough to starve every other worker thread.
_BW_CHUNK = 262144


class _BandwidthLimitedFile(object):
    """Delegating file handle whose reads stream chunk by chunk, each
    chunk paying ``len(chunk)/bps`` of sleep — a GIL-released wait,
    exactly like a real network/cold-storage read.  ``cold_latency``
    is paid once, before the handle's first read: the cold-tier
    GET/recall round trip."""

    def __init__(self, inner, bps, cold_latency=0.0):
        self._f = inner
        self._bps = bps
        self._pending_latency = cold_latency

    def read(self, n=-1):
        if self._pending_latency:
            latency, self._pending_latency = self._pending_latency, 0.0
            time.sleep(latency)
        out = []
        remaining = n
        while remaining != 0:
            take = _BW_CHUNK if remaining < 0 else min(_BW_CHUNK, remaining)
            data = self._f.read(take)
            if not data:
                break
            out.append(data)
            time.sleep(len(data) / self._bps)
            if remaining > 0:
                remaining -= len(data)
        return b''.join(out)

    def __getattr__(self, name):
        if name == '_f':  # mid-unpickle: not yet restored
            raise AttributeError(name)
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()


class BandwidthLimitedFilesystem(object):
    """Delegating filesystem wrapper emulating cold-storage bandwidth: every
    binary read sleeps ``bytes/bps``.  It makes row groups
    *fetch-dominated* — the latency parallelizes across worker/fetch
    threads like a real remote filesystem, independent of host core
    count (the cold-filesystem skew the adaptive scheduler exists for,
    reproduced deterministically).  ``inner`` is any filesystem with the
    port's methods (:class:`~petastorm_tpu_torch.fs_utils.LocalFilesystem`);
    the wrapper delegates every other attribute, ``protocol`` among them.

    ``cold_latency``: additionally, files of at least ``cold_threshold``
    bytes pay this many seconds once per open handle before their first
    read — a cold-object GET/recall round trip.  Size-gated so only the
    heavy objects read as cold-tier residents (small hot files stay
    bandwidth-limited only), which is how object stores actually tier.
    """

    def __init__(self, inner, bps, cold_latency=0.0, cold_threshold=1 << 20):
        self._inner = inner
        self._bps = float(bps)
        self._cold_latency = float(cold_latency)
        self._cold_threshold = int(cold_threshold)

    def open(self, path, mode='rb', **kwargs):
        handle = self._inner.open(path, mode, **kwargs)
        if 'r' in mode and 'b' in mode:
            latency = 0.0
            if self._cold_latency:
                try:
                    if self._inner.size(path) >= self._cold_threshold:
                        latency = self._cold_latency
                except Exception:  # noqa: BLE001 — emulation is best-effort
                    pass
            return _BandwidthLimitedFile(handle, self._bps, latency)
        return handle

    def __getattr__(self, name):
        if name == '_inner':  # mid-unpickle: not yet restored
            raise AttributeError(name)
        return getattr(self._inner, name)

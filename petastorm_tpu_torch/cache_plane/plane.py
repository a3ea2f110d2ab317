"""The tiered cache plane: mmap'd entry files, a hot shm tier, single-flight.

Counterpart of ``petastorm_tpu/cache_plane/plane.py`` (its fill spans and
decision records are not ported).  Background publishers (the
materialization plane) ask :meth:`CachePlane.admit_publish` first.
One published entry (``<digest>.cpe``) is::

    magic(8) | header_len(8) | pickled header | pad to 64 | payload

byte for byte the reference's, so either package reads the other's
entries.  The payload is raw column bytes (``columns``), an Arrow IPC
stream (``arrow``) or a pickle; a lookup rebuilds the value as read-only
views over one ``mmap`` per entry file, kept for the process's lifetime.

The filesystem is the coordination plane between processes:

* **publish** is a tmp file and ``os.replace``: a reader sees a whole
  entry or none; a SIGKILLed writer leaves a ``.tmp.<pid>.*`` file whose
  flock died with it, which :meth:`Tier.sweep` reclaims;
* **get-or-fill** is single-flight per key: the first process takes an
  exclusive flock on ``<digest>.lock`` and decodes, the others poll the
  published path, for at most ``fill_wait_s`` (or until the holder dies),
  then decode directly.  A full or unwritable plane decodes directly too:
  the plane never blocks an epoch;
* **reclaim** (LRU past a tier's byte cap) runs under a per-tier flock.

Standard library, numpy and pyarrow only: the decode workers import it.
"""

import fcntl
import hashlib
import logging
import mmap
import os
import pickle
import struct
import threading
import time
import uuid

import numpy as np

from petastorm_tpu_torch.cache import CacheBase
from petastorm_tpu_torch.workers_pool.shm_plane import align as _align
from petastorm_tpu_torch.workers_pool.shm_plane import flock_probe_unlink
from petastorm_tpu_torch.workers_pool.shm_plane import pid_alive as _pid_alive

logger = logging.getLogger(__name__)

__all__ = ['MISS', 'CachePlane', 'PlaneCache', 'Tier', 'encode_entry', 'decode_entry',
           'sweep_residue', 'CorruptEntryError']

#: A lookup's miss (a cached value may itself be None: a predicate-empty
#: row group).
MISS = object()

_MAGIC = b'PSTPUCP1'
ENTRY_SUFFIX = '.cpe'
LOCK_SUFFIX = '.lock'
#: The hot tiers' directories in /dev/shm (apart from the result plane's
#: ``pstpu_torch_`` slabs, which its sweep would otherwise take for slabs).
SHM_CACHE_PREFIX = 'pstpu-torch-cache-'
DEFAULT_DISK_CAPACITY = 4 << 30
DEFAULT_RAM_CAPACITY = 128 << 20

#: root -> monotonic time of this process's last construction-time sweep
#: (the service builds a plane per split: no listdir per split).
_LAST_SWEEP = {}
#: root -> (monotonic, measured total bytes): seeds a new Tier's eviction
#: estimate without a scan of every entry.
_SEED_TOTALS = {}


# -- entry encode/decode ------------------------------------------------------

def encode_entry(value):
    """``value`` -> one contiguous ``bytearray`` (the published file body):
    a ``pa.Table`` as an Arrow IPC stream; a dict of arrays as raw column
    bytes at aligned offsets (object, datetime and structured columns in one
    pickled blob after them); anything else pickled."""
    import pyarrow as pa
    header, parts = None, None
    if isinstance(value, pa.Table):
        from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
        header = {'kind': 'arrow'}
        parts = [ArrowTableSerializer().serialize(value)]
    raw = None
    if isinstance(value, dict) and value and all(isinstance(v, np.ndarray)
                                                 for v in value.values()):
        raw, rest = {}, {}
        for key, col in value.items():
            # raw bytes must round-trip through dtype.str alone
            if not col.dtype.hasobject and col.dtype.kind not in 'mMV' \
                    and col.dtype.names is None:
                raw[key] = np.ascontiguousarray(col)
            else:
                rest[key] = col
        parts = list(raw.values())
        if rest:
            parts.append(pickle.dumps(rest, protocol=4))
    if header is None and raw is None:
        header = {'kind': 'pickle'}
        parts = [pickle.dumps(value, protocol=4)]
    offset = 0
    placed = []
    for part in parts:
        offset = _align(offset)
        placed.append((offset, part))
        offset += memoryview(part).nbytes
    if header is None:
        header = {'kind': 'columns',
                  'columns': [(k, off, col.shape, col.dtype.str)
                              for (k, col), (off, _) in zip(raw.items(), placed)],
                  'extra': ((placed[-1][0], memoryview(placed[-1][1]).nbytes)
                            if rest else None)}
    header_bytes = pickle.dumps(header, protocol=4)
    base = _align(16 + len(header_bytes))
    blob = bytearray(base + offset)
    blob[:8] = _MAGIC
    struct.pack_into('<Q', blob, 8, len(header_bytes))
    blob[16:16 + len(header_bytes)] = header_bytes
    out = np.frombuffer(blob, np.uint8)
    for off, part in placed:
        view = memoryview(part)
        if view.nbytes == 0:
            continue
        data = np.frombuffer(view.cast('B'), np.uint8)
        np.copyto(out[base + off:base + off + data.nbytes], data)
    return blob


class CorruptEntryError(ValueError):
    """An entry file fails its structural checks (the atomic publish never
    makes one); a lookup counts it a miss and unlinks it."""


def decode_entry(buf):
    """The cached value from an entry's bytes; arrays are views of ``buf``
    (read-only when the mapping is)."""
    view = memoryview(buf)
    if len(view) < 16 or bytes(view[:8]) != _MAGIC:
        raise CorruptEntryError('bad cache entry magic')
    header_len = struct.unpack_from('<Q', view, 8)[0]
    if 16 + header_len > len(view):
        raise CorruptEntryError('truncated cache entry header')
    try:
        header = pickle.loads(view[16:16 + header_len])
    except Exception as e:  # noqa: BLE001 — any unpickle failure is corruption
        raise CorruptEntryError('undecodable cache entry header: %s' % e)
    payload = view[_align(16 + header_len):]
    kind = header['kind']
    if kind == 'arrow':
        from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
        return ArrowTableSerializer().deserialize(payload)
    if kind == 'columns':
        out = {}
        for key, off, shape, dtype_str in header['columns']:
            dtype = np.dtype(dtype_str)
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            flat = payload[off:off + count * dtype.itemsize]
            out[key] = np.frombuffer(flat, dtype=dtype, count=count).reshape(shape)
        if header.get('extra'):
            off, n = header['extra']
            try:
                out.update(pickle.loads(payload[off:off + n]))
            except Exception as e:  # noqa: BLE001
                raise CorruptEntryError('undecodable cache entry extra blob: %s' % e)
        return out
    if kind == 'pickle':
        try:
            return pickle.loads(payload)
        except Exception as e:  # noqa: BLE001
            raise CorruptEntryError('undecodable cache entry payload: %s' % e)
    raise CorruptEntryError('unknown cache entry kind %r' % (kind,))


# -- one tier -----------------------------------------------------------------

class Tier(object):
    """One directory of entry files under a byte cap, reclaimed LRU."""

    def __init__(self, root, capacity_bytes, label):
        self.root = root
        self.capacity_bytes = int(capacity_bytes)
        self.label = label
        self.evictions = 0
        self.store_failures = 0
        # The eviction scan runs only when the last measured total plus what
        # this process published since could pass the cap; the total is
        # seeded from the directory at the first store.
        self._last_known_total = None
        self._bytes_since_check = 0
        os.makedirs(root, exist_ok=True)
        #: digest -> (mmap, (inode, size)): the persistent read mappings
        self._mappings = {}
        self._lock = threading.Lock()

    # a Tier crosses the process pool's boundary inside the worker args;
    # mappings and locks stay per process
    def __getstate__(self):
        state = self.__dict__.copy()
        state['_mappings'] = {}
        del state['_lock']
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def entry_path(self, digest):
        return os.path.join(self.root, digest + ENTRY_SUFFIX)

    def _mapping_for(self, path, digest):
        st = os.stat(path)   # FileNotFoundError: a miss
        with self._lock:
            cached = self._mappings.get(digest)
            if cached is not None and cached[1] == (st.st_ino, st.st_size):
                return cached[0]
            fd = os.open(path, os.O_RDONLY)
            try:
                mapping = mmap.mmap(fd, st.st_size, access=mmap.ACCESS_READ)
            finally:
                os.close(fd)
            if cached is not None:
                try:
                    cached[0].close()
                except BufferError:
                    pass   # live views keep the old pages
            if len(self._mappings) >= 256:
                self._gc_mappings()
            self._mappings[digest] = (mapping, (st.st_ino, st.st_size))
            return mapping

    def _gc_mappings(self):
        for digest in [d for d in self._mappings if not os.path.exists(self.entry_path(d))]:
            mapping, _ = self._mappings.pop(digest)
            try:
                mapping.close()
            except BufferError:
                pass

    def lookup(self, digest):
        """The value, as views over the cached mapping, or ``MISS``."""
        path = self.entry_path(digest)
        try:
            value = decode_entry(self._mapping_for(path, digest))
        except (FileNotFoundError, ValueError, OSError) as e:
            if not isinstance(e, FileNotFoundError):
                logger.warning('%s tier: dropping corrupt entry %s (%s)', self.label, digest, e)
                try:
                    os.unlink(path)
                except OSError:
                    pass
            return MISS
        try:
            os.utime(path)   # the LRU touch
        except OSError:
            pass
        return value

    def store(self, digest, blob):
        """Publish ``blob`` atomically; False (the cap, ENOSPC) degrades."""
        nbytes = len(blob)
        if nbytes + 4096 > self.capacity_bytes:
            self.store_failures += 1
            return False
        tmp = os.path.join(self.root, '.tmp.%d.%s' % (os.getpid(), uuid.uuid4().hex[:8]))
        try:
            fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            try:
                # the writer's liveness for sweep(): the kernel drops it at
                # any death; held through the rename (the lock is the file's)
                try:
                    fcntl.flock(fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
                except OSError:
                    pass
                view = memoryview(blob)
                while len(view):   # os.write may write short
                    view = view[os.write(fd, view):]
                os.replace(tmp, self.entry_path(digest))
            finally:
                os.close(fd)
        except OSError as e:
            self.store_failures += 1
            logger.debug('%s tier: store of %s failed (%s)', self.label, digest, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        if self._last_known_total is None:
            seeded = _SEED_TOTALS.get(self.root)
            if seeded is not None and time.monotonic() - seeded[0] < 30.0:
                self._last_known_total = seeded[1] + nbytes
            else:
                self._last_known_total = self.usage()[1]
                _SEED_TOTALS[self.root] = (time.monotonic(), self._last_known_total)
        else:
            self._bytes_since_check += nbytes
        if self._last_known_total + self._bytes_since_check > self.capacity_bytes:
            self._evict_if_needed()
        return True

    def _evict_if_needed(self):
        """Unlink the least recently used entries past the cap, under the
        tier's evict flock; a flock held elsewhere means another process is
        reclaiming: skip."""
        guard = os.path.join(self.root, '.evict' + LOCK_SUFFIX)
        try:
            fd = os.open(guard, os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            return
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return
            entries, total = [], 0
            for name in os.listdir(self.root):
                if not name.endswith(ENTRY_SUFFIX):
                    continue
                full = os.path.join(self.root, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                entries.append((st.st_atime, st.st_size, full))
                total += st.st_size
            self._bytes_since_check = 0
            if total > self.capacity_bytes:
                for _, size, full in sorted(entries):
                    try:
                        os.unlink(full)
                    except OSError:
                        continue
                    try:   # the key's single-flight lock goes with it
                        os.unlink(full[:-len(ENTRY_SUFFIX)] + LOCK_SUFFIX)
                    except OSError:
                        pass
                    self.evictions += 1
                    total -= size
                    if total <= self.capacity_bytes:
                        break
            self._last_known_total = total
            _SEED_TOTALS[self.root] = (time.monotonic(), total)
        finally:
            os.close(fd)

    def eviction_estimate(self, nbytes):
        """What storing ``nbytes`` more would evict: a read-only dry run of
        :meth:`_evict_if_needed`'s walk (the same listdir, the same atime
        order, the same cap arithmetic), so that a background publisher can
        ask whether a publish evicts anything and how recently its youngest
        victim was read.  ``{'fits', 'victims', 'victim_bytes',
        'victim_newest_age_s', 'total_bytes'}``; an unlistable tier reports
        a fit (the store then degrades on its own terms)."""
        nbytes = int(nbytes)
        entries, total = [], 0
        try:
            names = os.listdir(self.root)
        except OSError:
            names = []
        for name in names:
            if not name.endswith(ENTRY_SUFFIX):
                continue
            try:
                st = os.stat(os.path.join(self.root, name))
            except OSError:
                continue
            entries.append((st.st_atime, st.st_size))
            total += st.st_size
        report = {'fits': True, 'victims': 0, 'victim_bytes': 0,
                  'victim_newest_age_s': None, 'total_bytes': total}
        over = total + nbytes - self.capacity_bytes
        if over <= 0:
            return report
        report['fits'] = False
        now = time.time()
        for atime, size in sorted(entries):   # oldest access first
            report['victims'] += 1
            report['victim_bytes'] += size
            age = max(0.0, now - atime)
            if report['victim_newest_age_s'] is None or age < report['victim_newest_age_s']:
                report['victim_newest_age_s'] = age
            over -= size
            if over <= 0:
                break
        return report

    def sweep(self):
        """Unlink crash residue; returns the names removed: tmp files of
        dead writers (pid, then the flock probe), and single-flight lock
        files with no entry that are an hour old and unlocked (a store that
        degraded leaves one)."""
        removed = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return removed
        now = time.time()
        for name in names:
            full = os.path.join(self.root, name)
            if name.startswith('.tmp.'):
                try:
                    pid = int(name.split('.')[2])
                except (IndexError, ValueError):
                    pid = None
                if pid is not None and _pid_alive(pid):
                    continue
            elif name.endswith(LOCK_SUFFIX) and not name.startswith('.evict'):
                entry = full[:-len(LOCK_SUFFIX)] + ENTRY_SUFFIX
                try:
                    if os.path.exists(entry) or now - os.stat(full).st_mtime < 3600:
                        continue
                except OSError:
                    continue
            else:
                continue
            if flock_probe_unlink(full):
                removed.append(name)
        return removed

    def usage(self):
        """``(entry count, total bytes)`` of the published entries."""
        count = total = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0, 0
        for name in names:
            if name.endswith(ENTRY_SUFFIX):
                try:
                    total += os.stat(os.path.join(self.root, name)).st_size
                    count += 1
                except OSError:
                    pass
        return count, total

    def clear(self):
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if name.endswith((ENTRY_SUFFIX, LOCK_SUFFIX)) or name.startswith('.tmp.'):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass


# -- the plane ----------------------------------------------------------------

def default_ram_dir(disk_root):
    """The hot tier's directory, derived from the disk root: every process
    sharing a disk tier lands on one /dev/shm directory."""
    digest = hashlib.blake2b(os.path.abspath(disk_root).encode(), digest_size=6).hexdigest()
    return os.path.join('/dev/shm', SHM_CACHE_PREFIX + digest)


class CachePlane(object):
    """A hot shm tier over a disk tier, with single-flight get-or-fill.

    Args:
        disk_dir: the disk tier's directory, shared across processes.
        disk_capacity_bytes / ram_capacity_bytes: each tier's byte cap.
            ``ram_capacity_bytes=0`` turns the hot tier off, as does a
            /dev/shm the process cannot use.
        context: the prefix mixed into every digest (the fingerprint of
            :mod:`~petastorm_tpu_torch.cache_plane.fingerprint`).
        fill_wait_s: how long a miss waits on another process's fill of the
            same key before it decodes directly.
    """

    def __init__(self, disk_dir, disk_capacity_bytes=DEFAULT_DISK_CAPACITY,
                 ram_capacity_bytes=DEFAULT_RAM_CAPACITY, ram_dir=None, context='',
                 fill_wait_s=30.0):
        if not disk_dir:
            raise ValueError("cache_location is required for cache_type='plane'")
        try:
            self.disk = Tier(disk_dir, disk_capacity_bytes or DEFAULT_DISK_CAPACITY, 'disk')
        except OSError as e:
            logger.warning('cache plane: disk tier %r unavailable (%s); serving every request '
                           'uncached', disk_dir, e)
            self.disk = None
        self.ram = None
        from petastorm_tpu_torch.workers_pool import shm_plane
        if self.disk is not None and ram_capacity_bytes and shm_plane.available():
            try:
                self.ram = Tier(ram_dir or default_ram_dir(disk_dir), ram_capacity_bytes, 'ram')
            except OSError as e:
                logger.warning('cache plane: hot tier unavailable (%s); disk only', e)
        self.context = context
        self.fill_wait_s = float(fill_wait_s)
        self._init_metrics()
        self._promote_backoff_until = 0.0
        now = time.monotonic()
        for tier in self._tiers():
            if now - _LAST_SWEEP.get(tier.root, -1e9) >= 30.0:
                _LAST_SWEEP[tier.root] = now
                tier.sweep()

    def _init_metrics(self):
        from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
        self.metrics = MetricsRegistry('cache_plane')
        self._m_hits = self.metrics.counter('cache_hits')
        self._m_ram_hits = self.metrics.counter('cache_ram_hits')
        self._m_misses = self.metrics.counter('cache_misses')
        self._m_sf_hits = self.metrics.counter('cache_single_flight_hits')
        self._m_degraded = self.metrics.counter('cache_degraded')
        self._m_fill = self.metrics.histogram('cache_fill')

    # a PlaneCache rides the worker args across the process pool: the
    # instruments hold a process-local lock, so their values travel
    def __getstate__(self):
        state = {k: v for k, v in self.__dict__.items()
                 if k != 'metrics' and not k.startswith('_m_')}
        state['_counts'] = self.stats
        return state

    def __setstate__(self, state):
        counts = state.pop('_counts', {})
        self.__dict__.update(state)
        self._init_metrics()
        for key, value in counts.items():
            self.metrics.counter(key).inc(value)

    def _tiers(self):
        return [t for t in (self.ram, self.disk) if t is not None]

    def digest(self, key):
        return hashlib.blake2b(('%s|%s' % (self.context, key)).encode('utf-8', 'replace'),
                               digest_size=16).hexdigest()

    def _ram_store_gated(self, digest, blob):
        """A hot-tier store behind the thrash gates: an entry over 1/8 of the
        tier never enters, and a store that evicted backs the hot tier off
        for 30 s."""
        if self.ram is None or len(blob) * 8 > self.ram.capacity_bytes \
                or time.monotonic() < self._promote_backoff_until:
            return
        before = self.ram.evictions
        self.ram.store(digest, blob)
        if self.ram.evictions > before:
            self._promote_backoff_until = time.monotonic() + 30.0

    def _lookup(self, digest, promote=True):
        if self.ram is not None:
            value = self.ram.lookup(digest)
            if value is not MISS:
                self._m_ram_hits.inc()
                return value
        value = self.disk.lookup(digest)
        if value is not MISS and promote and self.ram is not None \
                and time.monotonic() >= self._promote_backoff_until:
            try:
                with self.disk._lock:
                    mapping = self.disk._mappings[digest][0]
                    blob = (bytes(memoryview(mapping))
                            if len(mapping) * 8 <= self.ram.capacity_bytes else None)
                if blob is not None:
                    self._ram_store_gated(digest, blob)
            except (KeyError, ValueError, OSError):
                pass
        return value

    def get_or_fill(self, key, fill):
        """Hit either tier, or decode once across processes, or degrade to a
        direct decode: never block past ``fill_wait_s``, never raise from
        the plane into the decode path."""
        if self.disk is None:
            self._m_degraded.inc()
            self._m_misses.inc()
            return self._timed_fill(fill)
        digest = self.digest(key)
        value = self._lookup(digest)
        if value is not MISS:
            self._m_hits.inc()
            return value
        lock_path = os.path.join(self.disk.root, digest + LOCK_SUFFIX)
        lock_fd = None
        try:
            try:
                lock_fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
            except OSError:
                self._m_degraded.inc()
                self._m_misses.inc()
                return self._timed_fill(fill)
            try:
                fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(lock_fd)
                lock_fd = None
                # another process fills this key: poll the published path,
                # the holder's death (its flock goes) being the other exit
                deadline = time.monotonic() + self.fill_wait_s
                while time.monotonic() < deadline:
                    value = self._lookup(digest)
                    if value is not MISS:
                        self._m_hits.inc()
                        self._m_sf_hits.inc()
                        return value
                    try:
                        lock_fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
                    except OSError:
                        break
                    try:
                        fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except OSError:
                        os.close(lock_fd)
                        lock_fd = None
                        time.sleep(0.02)
                if lock_fd is None:
                    self._m_degraded.inc()
                    self._m_misses.inc()
                    return self._timed_fill(fill)
            value = self._lookup(digest)   # the previous holder may have published
            if value is not MISS:
                self._m_hits.inc()
                self._m_sf_hits.inc()
                return value
            self._m_misses.inc()
            value = self._timed_fill(fill)
            try:
                blob = encode_entry(value)
            except Exception as e:  # noqa: BLE001 — unencodable: serve uncached
                logger.warning('cache plane: cannot encode the entry of %r (%s); serving it '
                               'uncached', key, e)
                self._m_degraded.inc()
                return value
            if not self.disk.store(digest, blob):
                self._m_degraded.inc()
            self._ram_store_gated(digest, blob)
            return value
        finally:
            if lock_fd is not None:
                os.close(lock_fd)   # drops the flock

    def _timed_fill(self, fill):
        t0 = time.monotonic()
        try:
            return fill()
        finally:
            self._m_fill.observe(time.monotonic() - t0)

    # -- by digest: the cluster cache's surface -------------------------------

    def has_digest(self, digest):
        return any(os.path.exists(tier.entry_path(digest)) for tier in self._tiers())

    def lookup_digest(self, digest, promote=False):
        """The value of ``digest`` (``MISS`` when absent): no fill, no lock."""
        if self.disk is None:
            return MISS
        return self._lookup(digest, promote=promote)

    def entry_blob(self, digest):
        """An entry's published bytes, or None: what a peer fetch ships."""
        for tier in self._tiers():
            try:
                return bytes(memoryview(tier._mapping_for(tier.entry_path(digest), digest)))
            except (OSError, ValueError):
                continue
        return None

    def publish_blob(self, digest, blob):
        """Publish an encoded entry under ``digest`` (a peer fill) through the
        same atomic store and hot-tier gates as a fill; False degrades."""
        if self.disk is None:
            return False
        try:
            if not self.disk.store(digest, blob):
                return False
            self._ram_store_gated(digest, blob)
            return True
        except Exception:  # noqa: BLE001 — the plane never raises
            logger.warning('cache plane: publish_blob(%s) failed', digest, exc_info=True)
            return False

    def admit_publish(self, nbytes, hot_window_s=300.0):
        """Eviction-aware admission for background publishers (the
        materialization plane): refuse a publish whose LRU victims on the
        disk tier include an entry read within ``hot_window_s``, so that
        warming never evicts traffic hotter than what it brings.  Consumer
        publishes (``get_or_fill``, peer fill) stay unconditional: a
        consumer's miss is demand.  ``(admitted, estimate)``, the estimate
        :meth:`Tier.eviction_estimate`'s (None without a disk tier)."""
        if self.disk is None:
            return False, None
        try:
            estimate = self.disk.eviction_estimate(nbytes)
        except Exception:  # noqa: BLE001 — the plane never raises
            logger.warning('cache plane: admit_publish estimate failed', exc_info=True)
            return True, None
        if estimate['fits']:
            return True, estimate
        newest = estimate['victim_newest_age_s']
        return newest is None or newest >= float(hot_window_s), estimate

    def held_digests(self):
        """Every published entry's digest, in either tier."""
        out = set()
        for tier in self._tiers():
            try:
                names = os.listdir(tier.root)
            except OSError:
                continue
            out.update(name[:-len(ENTRY_SUFFIX)] for name in names if name.endswith(ENTRY_SUFFIX))
        return out

    @property
    def hits(self):
        return self._m_hits.value

    @property
    def misses(self):
        return self._m_misses.value

    @property
    def degraded(self):
        return self._m_degraded.value

    @property
    def evictions(self):
        return sum(t.evictions for t in self._tiers())

    @property
    def stats(self):
        """The counters readers and the service workers report."""
        return {'cache_hits': self.hits, 'cache_misses': self.misses,
                'cache_evictions': self.evictions, 'cache_ram_hits': self._m_ram_hits.value,
                'cache_single_flight_hits': self._m_sf_hits.value,
                'cache_degraded': self.degraded}

    def sweep(self):
        removed = []
        for tier in self._tiers():
            removed.extend(tier.sweep())
        return removed

    def clear(self):
        for tier in self._tiers():
            tier.clear()


class PlaneCache(CacheBase):
    """What ``cache_type='plane'`` resolves to: a :class:`CacheBase` over a
    :class:`CachePlane`.  The context carries the dataset's and the decode's
    fingerprint, so readers of different transforms, or of a rewritten
    dataset, share one directory safely."""

    def __init__(self, path, size_limit_bytes=None, ram_bytes=None, context='', cleanup=False,
                 fill_wait_s=30.0, **_compat_kwargs):
        self.plane = CachePlane(
            path, disk_capacity_bytes=size_limit_bytes or DEFAULT_DISK_CAPACITY,
            ram_capacity_bytes=DEFAULT_RAM_CAPACITY if ram_bytes is None else ram_bytes,
            context=context, fill_wait_s=fill_wait_s)
        self._cleanup_on_exit = bool(cleanup)

    def get(self, key, fill_cache_func):
        return self.plane.get_or_fill(str(key), fill_cache_func)

    @property
    def stats(self):
        return self.plane.stats

    @property
    def metrics(self):
        return self.plane.metrics

    def cleanup(self):
        if self._cleanup_on_exit:
            self.plane.clear()


def sweep_residue(disk_dir=None):
    """Reclaim crash residue on the host: dead writers' tmp files in
    ``disk_dir`` and its hot tier, in every other ``pstpu-torch-cache-*`` hot
    tier, and the result plane's orphaned slabs.  Returns ``{'removed':
    [...], 'shm_slabs': [...]}``."""
    from petastorm_tpu_torch.workers_pool import shm_plane
    roots = []
    if disk_dir and os.path.isdir(disk_dir):
        roots.append(('disk', disk_dir))
        ram_root = default_ram_dir(disk_dir)
        if os.path.isdir(ram_root):
            roots.append(('ram', ram_root))
    try:
        for name in os.listdir(shm_plane.SHM_DIR):
            full = os.path.join(shm_plane.SHM_DIR, name)
            if name.startswith(SHM_CACHE_PREFIX) and os.path.isdir(full) \
                    and full not in [r for _, r in roots]:
                roots.append(('ram', full))
    except OSError:
        pass
    removed = []
    for label, root in roots:
        for name in Tier(root, 1, label).sweep():
            removed.append(os.path.join(root, name))
    slabs = shm_plane.sweep_orphans() if shm_plane.available() else []
    return {'removed': removed, 'shm_slabs': slabs}

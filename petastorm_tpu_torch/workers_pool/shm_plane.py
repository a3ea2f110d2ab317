"""Zero-copy shared-memory result plane for the process pool.

Counterpart of ``petastorm_tpu/workers_pool/shm_plane.py`` (its metrics
registry is not ported).  A result that crosses the
process boundary on the byte path is serialized, copied into a ZeroMQ send
buffer, copied again on receipt and deserialized.  Here the writer puts the
payload in a ``/dev/shm`` segment and ships only a descriptor (segment name,
generation, offsets, shapes, dtypes) over the pool's sink socket; the
consumer maps the segment and builds numpy views (or an Arrow
``BufferReader``) over the mapping.

Segments are **slabs, reused across payloads**: first-touch page faults on
a fresh mapping cost far more than the copy, so the writer keeps every slab
open for its arena's lifetime and the consumer caches one ``mmap`` per slab
name.  The release protocol rides inside the slab, an 8-byte generation
counter at offset 0:

* the writer stamps each payload with the slab's increasing generation and
  holds the slab busy until the header catches up;
* the consumer releases the slab by writing the payload's generation into
  the header, from a ``weakref.finalize`` on the mapped base array, that
  is when the last view of the payload dies (or at once, through
  :func:`release_descriptor`, for a payload dropped unmapped).

A full arena makes :meth:`ShmArena.allocate` return ``None``: the caller
degrades that message to the byte path and never blocks.
:meth:`ShmArena.stop` unlinks every slab, so a clean shutdown leaves no
``/dev/shm`` entry; :func:`sweep_orphans` reclaims the slabs of a writer
that died without unlinking them.  The data service's clients prove that
they share a worker's ``/dev/shm`` with a probe file (:func:`make_probe`,
:func:`probe_exists`, :func:`remove_probe`).  Slabs carry this package's own prefix
(:data:`PREFIX`), so neither package's sweep touches the other's.
"""

import errno
import fcntl
import mmap
import os
import pickle
import struct
import threading
import uuid
import weakref

import numpy as np

from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer

SHM_DIR = '/dev/shm'
PREFIX = 'pstpu_torch_'
DEFAULT_CAPACITY_BYTES = 256 << 20
#: Payloads below this stay on the byte path: a descriptor round trip and a
#: slab lease cost more than ZeroMQ takes to move them.
MIN_SHM_BYTES = 32 << 10
#: Slab header: one little-endian uint64, the highest released generation.
#: Payloads start at this offset, 64-byte aligned for the numpy views.
_HEADER_BYTES = 64
#: Payload alignment inside a slab: keeps every view cache-line aligned.
ALIGNMENT = 64


def available():
    """Can this process use the plane: a writable ``/dev/shm`` and
    ``multiprocessing.shared_memory``."""
    try:
        from multiprocessing import shared_memory  # noqa: F401
    except ImportError:
        return False
    return os.path.isdir(SHM_DIR) and os.access(SHM_DIR, os.W_OK)


def pid_alive(pid):
    """Liveness of ``pid`` in this pid namespace (``PermissionError``: it
    exists and belongs to someone else).  A pid of another namespace reads
    dead: :func:`flock_probe_unlink` settles that case."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def align(offset, alignment=ALIGNMENT):
    """``offset`` rounded up to a multiple of ``alignment`` (a power of 2)."""
    return (offset + alignment - 1) & ~(alignment - 1)


def flock_probe_unlink(path):
    """Unlink ``path`` if its owner's lifetime flock is gone; returns
    whether it was removed.

    Writers hold a shared flock on every slab for its lifetime, which the
    kernel drops at any death (SIGKILL too), so an exclusive lock that can
    be taken means the owner is gone, even in another pid namespace.  Every
    failure (file gone, lock held, unlink race) returns False."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return False
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return False
        os.unlink(path)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def _unregister_tracker(raw_name):
    """Detach the resource tracker from a slab this module manages: it
    would race the protocol and warn of leaks at the writer's exit."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(raw_name, 'shared_memory')
    except Exception:  # noqa: BLE001 — the tracker's internals vary by version
        pass


# -- writer side --------------------------------------------------------------

class _Slab(object):
    __slots__ = ('name', 'size', 'shm', 'gen', 'inflight')

    def __init__(self, name, size, shm):
        self.name = name
        self.size = size          # payload capacity (header excluded)
        self.shm = shm            # the writer's persistent mapping
        self.gen = 0              # generation of the current or last payload
        self.inflight = False

    def released(self):
        return struct.unpack_from('<Q', self.shm.buf, 0)[0] >= self.gen


class ShmArena(object):
    """Writer-side slab pool, bounded by ``capacity_bytes``.

    One arena per writer process (allocation takes no lock).
    :meth:`allocate` leases a free slab, creating one while under the
    capacity; the consumer returns it by writing the payload's generation
    into the slab header.  A full arena returns ``None`` and counts the
    refusal in :attr:`degraded`.
    """

    def __init__(self, capacity_bytes=DEFAULT_CAPACITY_BYTES, min_bytes=MIN_SHM_BYTES):
        self.capacity_bytes = int(capacity_bytes)
        self.min_bytes = int(min_bytes)
        self._prefix = '%s%d-%s-' % (PREFIX, os.getpid(), uuid.uuid4().hex[:6])
        self._seq = 0
        self._slabs = []
        #: allocate() refusals: messages that went the byte path.
        self.degraded = 0

    def reap(self):
        """Free every slab whose header caught up with its generation."""
        for slab in self._slabs:
            if slab.inflight and slab.released():
                slab.inflight = False

    def _total_bytes(self):
        return sum(s.size + _HEADER_BYTES for s in self._slabs)

    def _unlink_slab(self, slab):
        self._slabs.remove(slab)
        try:
            slab.shm.close()
        except BufferError:
            pass  # a view of a payload is still alive in this process
        try:
            os.unlink(os.path.join(SHM_DIR, slab.name))
        except OSError:
            pass

    def _create_slab(self, nbytes):
        # Make room by retiring free slabs too small for this payload;
        # never a busy one.
        while self._total_bytes() + nbytes + _HEADER_BYTES > self.capacity_bytes:
            free = [s for s in self._slabs if not s.inflight and s.size < nbytes]
            if not free:
                return None
            self._unlink_slab(min(free, key=lambda s: s.size))
        from multiprocessing import shared_memory
        name = '%s%d' % (self._prefix, self._seq)
        self._seq += 1
        try:
            shm = shared_memory.SharedMemory(name=name, create=True,
                                             size=nbytes + _HEADER_BYTES)
        except OSError:  # /dev/shm full: degrade
            return None
        _unregister_tracker(shm._name)
        try:
            # ftruncate on tmpfs is sparse: writing into a nearly full
            # /dev/shm would SIGBUS the writer.  fallocate turns exhaustion
            # into an ENOSPC here, where the caller can degrade.
            os.posix_fallocate(shm._fd, 0, nbytes + _HEADER_BYTES)
        except OSError:
            try:
                shm.close()
            except BufferError:
                pass
            try:
                os.unlink(os.path.join(SHM_DIR, name))
            except OSError:
                pass
            return None
        try:
            # The writer's liveness token for sweep_orphans: a shared lock
            # held for the slab's lifetime (SharedMemory keeps its fd open).
            fcntl.flock(shm._fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
        except OSError:
            pass
        struct.pack_into('<Q', shm.buf, 0, 0)
        slab = _Slab(name, nbytes, shm)
        self._slabs.append(slab)
        return slab

    def allocate(self, nbytes):
        """Lease a slab with ``nbytes`` of payload room, or ``None`` to
        degrade.  Returns ``(name, generation, payload_memoryview)``: the
        caller writes the payload into the view and ships the name and
        generation in its descriptor."""
        nbytes = max(1, int(nbytes))
        self.reap()
        free = [s for s in self._slabs if not s.inflight and s.size >= nbytes]
        slab = min(free, key=lambda s: s.size) if free else self._create_slab(nbytes)
        if slab is None:
            self.degraded += 1
            return None
        slab.gen += 1
        slab.inflight = True
        payload = memoryview(slab.shm.buf)[_HEADER_BYTES:_HEADER_BYTES + nbytes]
        return slab.name, slab.gen, payload

    def stop(self):
        """Unlink every slab.  A consumer holding views keeps the pages
        through its mapping; descriptors still queued go with the names."""
        for slab in list(self._slabs):
            self._unlink_slab(slab)


def _copy_into(view, parts):
    """Copy ``parts`` (buffer-protocol objects) to aligned offsets of
    ``view``; returns ``[(offset, nbytes), ...]``."""
    base = np.frombuffer(view, np.uint8)
    spans = []
    offset = 0
    for part in parts:
        raw = np.frombuffer(memoryview(part).cast('B'), np.uint8)
        offset = align(offset)
        np.copyto(base[offset:offset + raw.nbytes], raw)
        spans.append((offset, raw.nbytes))
        offset += raw.nbytes
    return spans


def _oob_size(parts):
    total = 0
    for part in parts:
        total = align(total) + memoryview(part).nbytes
    return total


def write_pickled(arena, obj, serializer=None):
    """Pickle ``obj`` with protocol-5 out-of-band buffers into a slab.

    The small in-band head travels in the descriptor; the raw array buffers
    are copied once into the slab.  Returns the descriptor, or ``None``
    when the payload is too small for a slab or the arena is full."""
    serializer = serializer or PickleSerializer()
    try:
        head, parts = serializer.serialize_oob(obj)
    except BufferError:  # a non-contiguous out-of-band buffer: byte path
        return None
    total = _oob_size(parts)
    if total < arena.min_bytes:
        return None
    lease = arena.allocate(total)
    if lease is None:
        return None
    name, gen, view = lease
    spans = _copy_into(view, parts)
    return {'v': 1, 'kind': 'pickle5', 'segment': name, 'gen': gen,
            'head': head, 'buffers': spans}


def write_table(arena, table, serializer=None):
    """Arrow-IPC-write ``table`` straight into a slab; ``None`` degrades."""
    serializer = serializer or ArrowTableSerializer()
    size = serializer.serialized_size(table)
    if size < arena.min_bytes:
        return None
    lease = arena.allocate(size)
    if lease is None:
        return None
    name, gen, view = lease
    serializer.serialize_into(table, view)
    return {'v': 1, 'kind': 'arrow', 'segment': name, 'gen': gen, 'size': size}


def write_columns(arena, chunk):
    """A dict of ndarrays as per-column descriptors in one slab.

    Columns that export the buffer protocol are copied raw and described as
    ``(key, offset, shape, dtype)``; the rest (object, datetime64 and
    timedelta64 dtypes, values that are no arrays) ride as one pickled blob
    at the end of the slab.  ``None`` degrades."""
    raw_cols, rest = {}, {}
    for key, value in chunk.items():
        if isinstance(value, np.ndarray) and not value.dtype.hasobject \
                and value.dtype.kind not in 'mM':
            raw_cols[key] = np.ascontiguousarray(value)
        else:
            rest[key] = value
    extra = pickle.dumps(rest, protocol=4) if rest else b''
    parts = list(raw_cols.values()) + ([extra] if extra else [])
    total = _oob_size(parts)
    if total < arena.min_bytes:
        return None
    lease = arena.allocate(total)
    if lease is None:
        return None
    name, gen, view = lease
    spans = _copy_into(view, parts)
    columns = [(key, span[0], col.shape, col.dtype.str)
               for (key, col), span in zip(raw_cols.items(), spans)]
    return {'v': 1, 'kind': 'columns', 'segment': name, 'gen': gen,
            'columns': columns, 'extra': spans[-1] if extra else None}


# -- consumer side ------------------------------------------------------------

class SegmentVanishedError(OSError):
    """The slab was unlinked before this consumer mapped it (its writer
    stopped or died, or a sweep reclaimed it): the payload is lost."""


#: name -> mmap, cached for the consumer's lifetime (a fresh mapping pays
#: its page faults again).  _cache_gc() drops mappings whose slab files are
#: gone once the cache grows past a bound.
_MAPPINGS = {}
_MAPPINGS_LOCK = threading.Lock()
_MAPPINGS_GC_AT = 128


def _cache_gc():
    for name in [n for n in _MAPPINGS if not os.path.exists(os.path.join(SHM_DIR, n))]:
        mapping = _MAPPINGS.pop(name)
        try:
            mapping.close()
        except BufferError:
            pass  # views are alive; the map goes with them


def _cached_mapping(name):
    with _MAPPINGS_LOCK:
        mapping = _MAPPINGS.get(name)
        if mapping is not None:
            return mapping
        if len(_MAPPINGS) >= _MAPPINGS_GC_AT:
            _cache_gc()
        path = os.path.join(SHM_DIR, name)
        try:
            fd = os.open(path, os.O_RDWR)
        except OSError as e:
            if e.errno == errno.ENOENT:
                raise SegmentVanishedError(
                    errno.ENOENT, 'shm slab %r vanished before it was mapped' % name)
            raise
        try:
            mapping = mmap.mmap(fd, os.fstat(fd).st_size)
        finally:
            os.close(fd)
        _MAPPINGS[name] = mapping
        return mapping


def _write_release(name, gen):
    """Stamp ``gen`` into the slab header: the release the writer's
    ``reap`` looks for.  pread/pwrite on a fresh fd, so it works for a
    descriptor never mapped; a slab already unlinked is a no-op."""
    try:
        fd = os.open(os.path.join(SHM_DIR, name), os.O_RDWR)
    except OSError:
        return
    try:
        # Never roll the header back: a late release of an older generation
        # must not free a slab that holds a newer payload.
        current = struct.unpack('<Q', os.pread(fd, 8, 0))[0]
        if gen > current:
            os.pwrite(fd, struct.pack('<Q', gen), 0)
    except OSError:
        pass
    finally:
        os.close(fd)


class MappedSegment(object):
    """Consumer-side view of one descriptor's payload.

    :attr:`base` spans the whole slab and every payload view slices it, so
    numpy's base chain keeps it, and the cached mmap, alive.  A
    ``weakref.finalize`` on ``base`` writes the payload's generation into
    the header when the last view dies: the release of the protocol."""

    def __init__(self, desc):
        mapping = _cached_mapping(desc['segment'])
        self.base = np.frombuffer(mapping, np.uint8)
        weakref.finalize(self.base, _write_release, desc['segment'], desc['gen'])

    def view(self, offset, nbytes):
        start = _HEADER_BYTES + offset
        return self.base[start:start + nbytes]

    def ndarray(self, offset, shape, dtype_str):
        dtype = np.dtype(dtype_str)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        flat = self.view(offset, count * dtype.itemsize)
        return np.frombuffer(flat, dtype=dtype, count=count).reshape(shape)


def read_payload(desc):
    """Map a descriptor and rebuild its payload zero-copy.  Raises
    :class:`SegmentVanishedError` when the slab is gone."""
    seg = MappedSegment(desc)
    kind = desc['kind']
    if kind == 'pickle5':
        return PickleSerializer().deserialize_oob(
            desc['head'], [seg.view(off, n) for off, n in desc['buffers']])
    if kind == 'arrow':
        return ArrowTableSerializer().deserialize(seg.view(0, desc['size']))
    if kind == 'columns':
        chunk = {key: seg.ndarray(off, tuple(shape), dtype_str)
                 for key, off, shape, dtype_str in desc['columns']}
        if desc.get('extra'):
            off, n = desc['extra']
            chunk.update(pickle.loads(seg.view(off, n)))
        return chunk
    raise ValueError('unknown shm descriptor kind %r' % (kind,))


def release_descriptor(desc):
    """Release a descriptor without mapping it: the slab returns to its
    writer's free pool."""
    try:
        _write_release(desc['segment'], desc['gen'])
    except (KeyError, TypeError):
        pass


# -- reclamation --------------------------------------------------------------

def sweep_orphans():
    """Unlink the slabs of writers that died without unlinking them.

    Scans ``/dev/shm`` for ``PREFIX<pid>-...`` entries whose writer is dead:
    pid liveness first, then :func:`flock_probe_unlink`.  Live writers'
    slabs are untouched.  Returns the names removed."""
    removed = []
    try:
        entries = os.listdir(SHM_DIR)
    except OSError:
        return removed
    for entry in entries:
        if not entry.startswith(PREFIX):
            continue
        try:
            pid = int(entry[len(PREFIX):].split('-', 1)[0])
        except ValueError:
            continue
        if pid_alive(pid):
            continue
        if flock_probe_unlink(os.path.join(SHM_DIR, entry)):
            removed.append(entry)
    return removed


def residue(pids=None):
    """This package's slabs now in ``/dev/shm``; with ``pids``, only those
    written by these processes (a pool's workers, say: other pools on the
    host create and unlink slabs of their own meanwhile)."""
    try:
        entries = os.listdir(SHM_DIR)
    except OSError:
        return set()
    if pids is None:
        return {f for f in entries if f.startswith(PREFIX)}
    prefixes = tuple('%s%d-' % (PREFIX, pid) for pid in pids)
    return {f for f in entries if f.startswith(prefixes)}


# -- same-host probes (the data service) ---------------------------------------

#: name -> held fd of this process's live probes (the shared flock on the fd
#: is the liveness signal a sweep from another pid namespace respects)
_PROBE_FDS = {}


def make_probe():
    """Create a data-service client's same-host probe file; returns its name.

    A worker that can see the name shares this process's ``/dev/shm``, the
    one signal that both the zero-copy mapping and the header release work
    between the two processes.  The fd stays open with a shared flock until
    :func:`remove_probe`."""
    name = '%s%d-probe-%s' % (PREFIX, os.getpid(), uuid.uuid4().hex[:6])
    fd = os.open(os.path.join(SHM_DIR, name), os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
    try:
        fcntl.flock(fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
    except OSError:
        pass
    _PROBE_FDS[name] = fd
    return name


def probe_exists(name):
    """A worker's check of a client's probe (held to this package's prefix,
    so that a subscribe cannot make the worker stat arbitrary paths)."""
    return (isinstance(name, str) and name.startswith(PREFIX) and '/' not in name
            and os.path.exists(os.path.join(SHM_DIR, name)))


def remove_probe(name):
    if not name:
        return
    fd = _PROBE_FDS.pop(name, None)
    if fd is not None:
        try:
            os.close(fd)
        except OSError:
            pass
    try:
        os.unlink(os.path.join(SHM_DIR, name))
    except OSError:
        pass

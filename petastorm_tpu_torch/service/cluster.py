"""The cluster cache: the cache plane as an asset of the whole fleet.

Counterpart of ``petastorm_tpu/service/cluster.py``.  The plane
(:mod:`petastorm_tpu_torch.cache_plane`) stops at the host; here decoded
entries flow between workers, by three mechanisms, each best-effort (the
data plane never blocks on them):

* **affinity**: workers advertise the digests their plane holds (compact
  prefixes riding the heartbeats); the dispatcher keeps a directory and
  prefers leasing a split to a worker that holds it;
* **remote hits**: a worker whose leased split its plane holds whole
  streams the entries over the chunk protocol without building a reader
  (:meth:`ClusterCacheIdentity.serve_chunks`);
* **peer fill**: a local miss a peer holds is fetched as the entry's
  encoded bytes over a bounded fetch on the peer's data socket
  (:class:`PeerFetcher`, :func:`fetch_reply`) and published verbatim through
  the plane's atomic publish: equal to the peer's bit for bit.

A digest names (data files' identity x decode identity x piece), so an entry
is valid on any host or none.  :class:`ClusterCacheIdentity` computes a
split's digests without a reader: the same schema view, pieces, transform,
predicate and plane context a split reader would use, with the reader
workers' own ``piece_cache_key``.  ``PETASTORM_TPU_NO_CLUSTER_CACHE=1`` or
``ServiceConfig(cluster_cache=False)`` turns it off.  Nothing here loads
torch: the decode workers import it.
"""

import logging
import os
import pickle
import threading
import time

# Imported here, on the importing thread: pyarrow.parquet imported first on
# a thread that then exits (the identity's build thread) leaves later
# concurrent row-group reads of the process to crash.
import pyarrow.parquet  # noqa: F401

logger = logging.getLogger(__name__)

__all__ = ['KILL_ENV', 'ClusterCacheIdentity', 'ClusterWorkerState', 'PeerFetcher',
           'fetch_reply', 'cdigest', 'enabled', 'killed']

KILL_ENV = 'PETASTORM_TPU_NO_CLUSTER_CACHE'

#: The control plane's digests: the first 48 bits (the directory is advisory,
#: the data plane checks the full digest).
CDIGEST_LEN = 12

#: A peer fetch waits at most this long before the split decodes directly.
FETCH_TIMEOUT_S = 8.0

#: A fetched entry larger than this degrades (on both sides of the fetch).
FETCH_MAX_BYTES = 256 << 20


def killed():
    return bool(os.environ.get(KILL_ENV))


def enabled(job):
    """Is the cluster cache on for this job in this process?"""
    return bool(job.get('cluster_cache')) and bool(job.get('cache_plane')) and not killed()


def cdigest(digest):
    """A full entry digest -> the control plane's compact one."""
    return digest[:CDIGEST_LEN]


class ClusterCacheIdentity(object):
    """A worker's decode identity of one job: the pieces, the plane, and the
    cache digest of each piece's work items (one per row-drop partition) as
    a split reader would compute them.  Built by :meth:`build` from the
    footers (no decode, no pool); None when the job's reader arguments fall
    outside what it understands (the plane then works as before, without
    the cluster cache).  It keeps the decode's inputs (``fs``,
    ``stored_schema``, ``schema_view``, ``transform_spec``, ``predicate``),
    from which the materialization plane builds the consumer's own
    worker."""

    def __init__(self, plane, pieces, item_digests, converter, kind, drop_partitions=1):
        #: the worker's CachePlane over the job's plane directory
        self.plane = plane
        self._pieces = pieces
        #: piece index -> [its full digest per row-drop partition]
        self._item_digests = item_digests
        self._converter = converter
        self._kind = kind   # 'columns' (the codec reader) or 'batch' (Arrow)
        self._drop_partitions = int(drop_partitions)
        self.fs = None
        self.stored_schema = None
        self.schema_view = None
        self.transform_spec = None
        self.predicate = None

    @classmethod
    def build(cls, job):
        """The job's identity, or None (logged, never raised)."""
        try:
            return cls._build(job)
        except Exception as e:  # noqa: BLE001 — the cluster cache is an optimization
            logger.warning('cluster cache: identity unavailable for %r (%s: %s); running '
                           'without it', job.get('dataset_url'), type(e).__name__, e)
            return None

    @classmethod
    def _build(cls, job):
        from petastorm_tpu_torch.cache_plane import PlaneCache
        from petastorm_tpu_torch.errors import MetadataError
        from petastorm_tpu_torch.etl.dataset_metadata import (get_schema,
                                                              infer_or_load_unischema,
                                                              load_row_groups)
        from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
        from petastorm_tpu_torch.reader import _plane_context
        from petastorm_tpu_torch.transform import transform_schema
        from petastorm_tpu_torch.unischema import match_unischema_fields

        kwargs = dict(job.get('reader_kwargs') or {})
        if not _supported_kwargs(kwargs):
            logger.info('cluster cache: reader_kwargs %s outside what it understands; off',
                        sorted(kwargs))
            return None
        schema_fields = kwargs.get('schema_fields')
        if schema_fields is not None and not all(isinstance(f, str) for f in schema_fields):
            return None   # NGram selections
        predicate = kwargs.get('predicate')
        transform_spec = kwargs.get('transform_spec')
        drop_partitions = max(1, int(kwargs.get('shuffle_row_drop_partitions') or 1))
        fs, path_or_paths = get_filesystem_and_path_or_paths(job['dataset_url'],
                                                             kwargs.get('filesystem'))
        paths = path_or_paths if isinstance(path_or_paths, list) else [path_or_paths]
        # the worker's choice of reader, without its probe reader
        factory = job.get('reader_factory', 'auto')
        kind = 'batch'
        if factory in ('auto', 'reader'):
            try:
                stored_schema = get_schema(fs, paths[0])
                kind = 'columns'
            except MetadataError:
                if factory == 'reader':
                    raise
        if kind == 'batch':
            if drop_partitions != 1:
                return None   # the batch reader has no row-drop axis
            stored_schema = infer_or_load_unischema(fs, paths[0])
            matched = (match_unischema_fields(stored_schema, schema_fields)
                       if schema_fields is not None else None)
            schema_view = stored_schema.create_schema_view(matched) if matched \
                else stored_schema
        else:
            schema_view = (stored_schema.create_schema_view(schema_fields)
                           if schema_fields is not None else stored_schema)
            from petastorm_tpu_torch.py_dict_reader_worker import columnar_fast_path
            if not columnar_fast_path(transform_spec):
                return None   # a per-row func caches rows, not the published columns
        pieces = []
        for p in paths:
            pieces.extend(load_row_groups(fs, p))
        if not pieces:
            return None
        context = _plane_context('plane', fs, pieces, schema_view, predicate, transform_spec)
        plane = PlaneCache(job['cache_plane_dir'],
                           size_limit_bytes=job.get('cache_plane_disk_bytes'),
                           ram_bytes=job.get('cache_plane_ram_bytes'), context=context).plane
        if plane.disk is None:
            return None
        if kind == 'columns':
            from petastorm_tpu_torch.py_dict_reader_worker import piece_cache_key
            from petastorm_tpu_torch.reader import _ColumnarDictConverter
            item_digests = [[plane.digest(piece_cache_key(p, schema_view, transform_spec, part)
                                          + ':c') for part in range(drop_partitions)]
                            for p in pieces]
        else:
            from petastorm_tpu_torch.arrow_reader_worker import (ArrowResultConverter,
                                                                 piece_cache_key)
            item_digests = [[plane.digest(piece_cache_key(p, schema_view, transform_spec))]
                            for p in pieces]
        result_schema = (transform_schema(schema_view, transform_spec)
                         if transform_spec is not None else schema_view)
        converter = (_ColumnarDictConverter(result_schema) if kind == 'columns'
                     else ArrowResultConverter(result_schema))
        identity = cls(plane, pieces, item_digests, converter, kind, drop_partitions)
        identity.fs = fs
        identity.stored_schema = stored_schema
        identity.schema_view = schema_view
        identity.transform_spec = transform_spec
        identity.predicate = predicate
        return identity

    @property
    def num_pieces(self):
        return len(self._pieces)

    @property
    def pieces(self):
        return self._pieces

    @property
    def kind(self):
        return self._kind

    @property
    def drop_partitions(self):
        return self._drop_partitions

    def piece_digests(self, index):
        """The full digests of one piece's work items, one per row-drop
        partition: what the materialization plane publishes under."""
        return list(self._item_digests[int(index)])

    def piece_cdigests(self):
        """The compact digest of each global piece: what a worker advertises
        once per job, so that the dispatcher maps any split to the directory
        (a piece of several row-drop partitions advertises its first's)."""
        return [cdigest(parts[0]) for parts in self._item_digests]

    def split_digests(self, indices):
        """The full digests of a split's pieces, in delivery order."""
        out = []
        for i in indices:
            out.extend(self._item_digests[int(i)])
        return out

    def missing_digests(self, indices):
        """The split's digests with no local entry: what peer fill fetches."""
        return [d for d in self.split_digests(indices) if not self.plane.has_digest(d)]

    def serve_chunks(self, indices):
        """The split's chunk dicts straight from the local plane, or None when
        any piece misses (every lookup happens before the first chunk, so an
        eviction meanwhile cannot tear a split).  The cached values are
        post-transform and go through the reader's own result converter: what
        the split reader would deliver."""
        from petastorm_tpu_torch.cache_plane.plane import MISS
        values = []
        for i in indices:
            for digest in self._item_digests[int(i)]:
                value = self.plane.lookup_digest(digest)
                if value is MISS:
                    return None
                values.append(value)
        chunks = []
        for value in values:
            if value is None:
                continue   # a predicate-empty piece publishes nothing
            if self._kind == 'columns':
                if not len(next(iter(value.values()), ())):
                    continue
            elif value.num_rows == 0:
                continue
            chunks.append(self._converter.convert(value)._asdict())
        return chunks


def _supported_kwargs(kwargs):
    """Reader arguments the identity understands: anything that renumbers the
    pieces (``rowgroup_selector``, ``filters``) or changes what a piece caches
    turns the cluster cache off, as in the JAX package."""
    if kwargs.get('rowgroup_selector') is not None or kwargs.get('filters') is not None:
        return False
    return kwargs.get('cache_type', 'plane') == 'plane'


# -- peer fetch ---------------------------------------------------------------

def fetch_reply(identity_frame, request, plane, arena=None):
    """The reply frames ``[identity, header, payload]`` to one ``fetch``: the
    entry's bytes, or an shm descriptor of them for a requester that proved it
    shares this host's /dev/shm; ``ok=False`` with no payload for an entry
    absent or too large."""
    digest = str(request.get('digest', ''))
    blob = plane.entry_blob(digest) if plane is not None and digest else None
    if blob is None or len(blob) > FETCH_MAX_BYTES:
        header = {'type': 'fetched', 'digest': digest, 'ok': False}
        return [identity_frame, pickle.dumps(header, protocol=4), b'']
    tag, payload = b'B', blob
    if arena is not None:
        import numpy as np

        from petastorm_tpu_torch.workers_pool import shm_plane
        if shm_plane.probe_exists(request.get('shm_probe')):
            desc = shm_plane.write_columns(arena, {'blob': np.frombuffer(blob, np.uint8)})
            if desc is not None:
                tag, payload = b'S', pickle.dumps(desc, protocol=4)
    header = {'type': 'fetched', 'digest': digest, 'ok': True, 'tag': tag, 'nbytes': len(blob)}
    return [identity_frame, pickle.dumps(header, protocol=4), payload]


class PeerFetcher(object):
    """Bounded fetches from peers' data sockets: one DEALER per peer, owned by
    one thread.  :meth:`fetch` returns the entry's bytes or None (a timeout,
    a dead peer, an absent or oversized entry); a socket that timed out is
    rebuilt at the next fetch from that peer."""

    def __init__(self, context, timeout_s=None):
        import zmq

        from petastorm_tpu_torch.workers_pool import shm_plane
        self._zmq = zmq
        self._context = context
        self._timeout_s = float(FETCH_TIMEOUT_S if timeout_s is None else timeout_s)
        self._sockets = {}
        self._probe = None
        if shm_plane.available():
            try:
                self._probe = shm_plane.make_probe()
            except OSError:
                pass   # the byte path only

    def _socket(self, addr):
        sock = self._sockets.get(addr)
        if sock is None:
            sock = self._context.socket(self._zmq.DEALER)
            sock.setsockopt(self._zmq.LINGER, 0)
            sock.connect(addr)
            self._sockets[addr] = sock
        return sock

    def _drop(self, addr):
        sock = self._sockets.pop(addr, None)
        if sock is not None:
            sock.close(0)

    def fetch(self, addr, digest):
        """The entry's bytes from the peer at ``addr``, or None."""
        from petastorm_tpu_torch.workers_pool import shm_plane
        try:
            sock = self._socket(addr)
            sock.send(pickle.dumps({'type': 'fetch', 'digest': digest,
                                    'shm_probe': self._probe}, protocol=4))
            deadline = time.monotonic() + self._timeout_s
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not sock.poll(max(1, int(remaining * 1000))):
                    self._drop(addr)
                    if self._probe is not None:
                        # the peer may have died with our reply's slab in flight
                        shm_plane.sweep_orphans()
                    return None
                frames = sock.recv_multipart()
                header = pickle.loads(frames[0])
                if header.get('type') != 'fetched' or header.get('digest') != digest:
                    continue   # a stale reply of an earlier exchange
                if not header.get('ok'):
                    return None
                if header.get('tag') == b'S':
                    try:
                        blob = shm_plane.read_payload(pickle.loads(frames[1]))['blob'].tobytes()
                    except shm_plane.SegmentVanishedError:
                        return None
                elif header.get('tag') == b'B':
                    blob = bytes(frames[1])
                else:
                    return None
                return blob if len(blob) <= FETCH_MAX_BYTES else None
        except Exception:  # noqa: BLE001 — a failed fetch degrades
            self._drop(addr)
            return None

    def close(self):
        from petastorm_tpu_torch.workers_pool import shm_plane
        for addr in list(self._sockets):
            self._drop(addr)
        shm_plane.remove_probe(self._probe)
        self._probe = None


class ClusterWorkerState(object):
    """What a worker keeps for the cluster cache: the identity, built on a
    thread of its own (a footer scan must not delay registration), and the
    advertised digests."""

    #: list the plane's tiers for the advertisement at most this often;
    #: digests published here are folded in at once
    DIGEST_REFRESH_S = 5.0

    def __init__(self, job):
        self.identity = None
        self._job = job
        # the decode thread adds published digests while the event loop
        # snapshots the set for a heartbeat
        self._known_lock = threading.Lock()
        self._known = set()
        self._known_at = 0.0
        self._advertised = None
        self.advertised_pieces = False
        self._thread = threading.Thread(target=self._build, daemon=True,
                                        name='cluster-cache-identity')
        self._thread.start()

    def _build(self):
        self.identity = ClusterCacheIdentity.build(self._job)

    def ready(self):
        return self.identity is not None

    def wait_ready(self, timeout_s):
        """Wait for the identity's build; whether it resolved."""
        self._thread.join(timeout_s)
        return self.ready()

    def heartbeat_fields(self):
        """The fields of this heartbeat: the compact digest set when it
        changed since it was last sent, and the piece map until the
        dispatcher has it."""
        fields = {}
        identity = self.identity
        if identity is None:
            return fields
        now = time.monotonic()
        if now - self._known_at >= self.DIGEST_REFRESH_S:
            self._known_at = now
            try:
                listed = {cdigest(d) for d in identity.plane.held_digests()}
                with self._known_lock:
                    self._known = listed
            except Exception:  # noqa: BLE001 — the advertisement is advisory
                pass
        with self._known_lock:
            current = frozenset(self._known)
        if current != self._advertised:
            self._advertised = current
            fields['cache_digests'] = sorted(current)
        if not self.advertised_pieces:
            fields['piece_digests'] = identity.piece_cdigests()
        return fields

    def note_published(self, digests):
        """Fold digests just published (decoded or peer-filled) into the
        advertised set."""
        fresh = [cdigest(d) for d in digests]
        with self._known_lock:
            self._known.update(fresh)

    def reset_advertisement(self):
        """The dispatcher restarted: the next heartbeat sends everything."""
        self._advertised = None
        self.advertised_pieces = False

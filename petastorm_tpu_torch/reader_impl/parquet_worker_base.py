"""Shared base for the decode workers: a per-worker LRU-bounded cache of open
ParquetFile handles, the ingest plane's checkout seam, and per-row-group
retry with exponential backoff.

Counterpart of ``petastorm_tpu/reader_impl/parquet_worker_base.py``.  The
port's :class:`~petastorm_tpu_torch.fs_utils.LocalFilesystem` (or none)
reads through pyarrow's memory map; any other filesystem a caller gave the
reader (a wrapper such as the cold-store emulation) is read through its
``open``.  When the reader mounts the ingest plane
(:mod:`petastorm_tpu_torch.ingest`), a piece is decoded from the plane's
prefetched bytes, and any failure there falls back to the synchronous read
of that piece.
"""

import logging
import time
from collections import OrderedDict

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import PoisonedRowGroupError
from petastorm_tpu_torch.fs_utils import LocalFilesystem
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase

logger = logging.getLogger(__name__)

#: Per-worker bound on cached ParquetFile handles (least recently read
#: evicted + closed).
MAX_OPEN_FILES = 32

#: Exceptions treated as transient I/O failures.
TRANSIENT_IO_ERRORS = (OSError, EOFError, TimeoutError)

#: Permanent decode failures (corrupt row group): no retry, but the error
#: still carries the piece identity.
CORRUPT_DATA_ERRORS = (pa.ArrowInvalid,)

#: OSError subclasses that are permanent conditions.
PERMANENT_IO_ERRORS = (FileNotFoundError, PermissionError, IsADirectoryError,
                       NotADirectoryError)


class ParquetWorkerBase(WorkerBase):
    """File-handle caching + retry; subclasses implement the decode logic."""

    def __init__(self, worker_id, publish_func, args):
        super(ParquetWorkerBase, self).__init__(worker_id, publish_func, args)
        self._a = args
        self._open_files = OrderedDict()   # path -> (handle or None, ParquetFile), LRU
        #: seconds slept in retry back-off, which the pools take out of an
        #: item's decode time
        self.retry_sleep_s = 0.0
        self._ingest_claimed = False

    def _parquet_file(self, path):
        entry = self._open_files.get(path)
        if entry is None:
            fs = getattr(self._a, 'filesystem', None)
            if fs is None or type(fs) is LocalFilesystem:
                # Local files: pyarrow mmaps the path natively.
                entry = (None, pq.ParquetFile(path, memory_map=True))
            else:
                # A caller's filesystem (a wrapper, an emulation): its reads
                # must go through its handle.
                handle = fs.open(path, 'rb')
                entry = (handle, pq.ParquetFile(handle))
            self._open_files[path] = entry
            while len(self._open_files) > MAX_OPEN_FILES:
                self._evict_file(next(iter(self._open_files)))
        else:
            self._open_files.move_to_end(path)
        return entry[1]

    def _read_piece(self, piece, read_fn):
        """``read_fn(parquet_file)`` over the ingest plane's prefetched bytes
        of ``piece`` when the plane holds them, else (and after any failure
        there) over the cached handle: the plane changes where the bytes
        waited, never what is decoded."""
        plane = getattr(self._a, 'ingest', None)
        if plane is not None:
            # this work item's dispatch ref is consumed by the checkout
            self._ingest_claimed = True
            pf = plane.checkout(piece.path, piece.row_group)
            if pf is not None:
                try:
                    return read_fn(pf)
                except Exception as e:  # noqa: BLE001 — degrade, then read again
                    plane.degraded(e)
                finally:
                    try:
                        pf.close()
                    except Exception as e:  # noqa: BLE001 — buffer teardown
                        logger.debug('closing an ingest buffer failed: %s', e)
        return read_fn(self._parquet_file(piece.path))

    def _ingest_scope(self, piece):
        """Context of one work item's read: the ingest plane's dispatch ref
        of ``piece`` is consumed exactly once, by the checkout in
        :meth:`_read_piece` or, when a result-cache hit skipped the read, by
        a discard here (else a warm epoch's prefetched entries would fill
        the readahead window for good)."""
        worker = self

        class _Scope(object):
            def __enter__(self):
                worker._ingest_claimed = False
                return self

            def __exit__(self, *exc):
                plane = getattr(worker._a, 'ingest', None)
                if plane is not None and not worker._ingest_claimed:
                    plane.discard(piece.path, piece.row_group)

        return _Scope()

    def _evict_file(self, path):
        """Drop a possibly-wedged cached handle so the next attempt reopens."""
        entry = self._open_files.pop(path, None)
        if entry is not None:
            try:
                (entry[0] or entry[1]).close()
            except Exception as e:  # noqa: BLE001 — handle may already be broken
                logger.debug('closing cached handle for %s failed: %s', path, e)

    def shutdown(self):
        for path in list(self._open_files):
            self._evict_file(path)

    def _read_with_retry(self, piece, read_fn):
        """Run ``read_fn(parquet_file)`` for ``piece`` (through
        :meth:`_read_piece`), retrying transient I/O errors ``read_retries``
        times with exponential backoff."""
        retries = self._a.read_retries
        backoff = self._a.retry_backoff_s
        attempt = 0
        while True:
            try:
                return self._read_piece(piece, read_fn)
            except CORRUPT_DATA_ERRORS as e:
                self._evict_file(piece.path)
                raise PoisonedRowGroupError(piece.path, piece.row_group,
                                            attempt + 1, e) from e
            except TRANSIENT_IO_ERRORS as e:
                self._evict_file(piece.path)
                if isinstance(e, PERMANENT_IO_ERRORS):
                    raise
                attempt += 1
                if attempt > retries:
                    raise PoisonedRowGroupError(piece.path, piece.row_group,
                                                attempt, e) from e
                delay = backoff * (2 ** (attempt - 1))
                logger.warning(
                    'Transient read failure on row group %d of %r '
                    '(attempt %d/%d, retrying in %.2fs): %s',
                    piece.row_group, piece.path, attempt, retries + 1, delay, e)
                self.retry_sleep_s += delay
                time.sleep(delay)

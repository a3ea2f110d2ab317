"""Shared base for the decode workers: a per-worker LRU-bounded cache of open
ParquetFile handles, plus per-row-group retry with exponential backoff.

Counterpart of ``petastorm_tpu/reader_impl/parquet_worker_base.py`` on
local files (memory-mapped); the ingest-plane checkout seam is a later
slice.
"""

import logging
import time
from collections import OrderedDict

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import PoisonedRowGroupError
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
        self._open_files = OrderedDict()   # path -> ParquetFile, LRU

    def _parquet_file(self, path):
        pf = self._open_files.get(path)
        if pf is None:
            # Local files: pyarrow mmaps the path natively.
            pf = self._open_files[path] = pq.ParquetFile(path, memory_map=True)
            while len(self._open_files) > MAX_OPEN_FILES:
                self._evict_file(next(iter(self._open_files)))
        else:
            self._open_files.move_to_end(path)
        return pf

    def _evict_file(self, path):
        """Drop a possibly-wedged cached handle so the next attempt reopens."""
        pf = self._open_files.pop(path, None)
        if pf is not None:
            try:
                pf.close()
            except Exception as e:  # noqa: BLE001 — handle may already be broken
                logger.debug('closing cached handle for %s failed: %s', path, e)

    def shutdown(self):
        for path in list(self._open_files):
            self._evict_file(path)

    def _read_with_retry(self, piece, read_fn):
        """Run ``read_fn(parquet_file)`` for ``piece``, retrying transient I/O
        errors ``read_retries`` times with exponential backoff."""
        retries = self._a.read_retries
        backoff = self._a.retry_backoff_s
        attempt = 0
        while True:
            try:
                return read_fn(self._parquet_file(piece.path))
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
                time.sleep(delay)

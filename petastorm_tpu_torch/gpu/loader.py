"""Device loader: columnar reader batches -> dicts of device tensors.

Counterpart of ``petastorm_tpu/jax/loader.py::DataLoader`` on its columnar
path: the reader's per-row-group column chunks are re-batched with numpy
slicing and concatenation (no per-row Python), optionally mixed through a
windowed shuffling buffer, non-numeric columns are dropped (they cannot
live on the card), and each batch goes to the device through
:class:`~petastorm_tpu_torch.gpu.transfer.TransferPlane` with ``prefetch``
batches in flight.  Batches equal the JAX loader's bit for bit, dtypes
included, for the same reader, seed and batch size.

Row readers (``columnar_decode=False``), ``state_dict``/resume, autotuning,
data echoing, ``scan_batches``, sharding and the other loader classes are
later slices of the port.
"""

import logging
from collections import deque

import numpy as np

from petastorm_tpu_torch.gpu.transfer import TransferPlane, resolve_device

logger = logging.getLogger(__name__)

__all__ = ['DataLoader']


class DataLoader(object):
    """Iterate device-resident batches (``{field: tensor}``) from a reader
    made with ``make_reader(..., columnar_decode=True)``.

    Args:
        reader: the columnar reader.
        batch_size: rows per batch.
        shuffling_queue_capacity: >0 mixes rows through a buffer of at least
            this many rows (uniform draws, seeded by ``seed``).
        drop_last: drop the trailing partial batch.
        prefetch: batches kept in flight ahead of the consumer.
        device: target device; ``None`` means the card (raises without one).
        seed: shuffling seed.
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0, drop_last=True,
                 prefetch=2, device=None, seed=None):
        if batch_size <= 0:
            raise ValueError('batch_size must be positive')
        if not getattr(reader, 'batched_output', False):
            raise ValueError('DataLoader takes a columnar reader (make_reader(..., '
                             'columnar_decode=True)); row readers are a later slice of '
                             'the port')
        self.device = resolve_device(device)
        self.reader = reader
        self.batch_size = int(batch_size)
        self._shuffle_capacity = shuffling_queue_capacity
        self._drop_last = drop_last
        self._prefetch = max(1, int(prefetch))
        self._seed = seed
        self._warned_fields = set()

    def __iter__(self):
        plane = TransferPlane(self.device, ring_slots=self._prefetch + 2)
        pending = deque()
        for host_batch in self._columnar_batches():
            pending.append(plane.put(_filter_numeric(host_batch, self._warned_fields)))
            if len(pending) > self._prefetch:
                yield plane.ready(*pending.popleft())
        while pending:
            yield plane.ready(*pending.popleft())

    def _chunk_source(self):
        for chunk in self.reader:
            yield chunk._asdict() if hasattr(chunk, '_asdict') else dict(chunk)

    def _columnar_batches(self):
        """Re-batch column chunks: a chunk exactly batch_size long passes
        through; otherwise batches are views across a chunk deque with at
        most one concatenate per batch that straddles chunks."""
        if self._shuffle_capacity > 0:
            yield from self._columnar_batches_shuffled()
            return
        chunks = deque()   # (chunk_dict, start_offset)
        count = 0
        for chunk_dict in self._chunk_source():
            n = len(next(iter(chunk_dict.values())))
            if count == 0 and n == self.batch_size:
                yield chunk_dict
                continue
            chunks.append((chunk_dict, 0))
            count += n
            while count >= self.batch_size:
                yield _take_front(chunks, self.batch_size)
                count -= self.batch_size
        if count and not self._drop_last:
            yield _take_front(chunks, count)

    def _columnar_batches_shuffled(self):
        """Windowed columnar shuffle: uniform draws from a buffer of at least
        ``shuffling_queue_capacity`` rows."""
        rng = np.random.default_rng(self._seed)
        columns = None  # field -> [np.ndarray]
        count = 0
        threshold = max(self.batch_size, self._shuffle_capacity)
        for chunk_dict in self._chunk_source():
            if columns is None:
                columns = {k: [v] for k, v in chunk_dict.items()}
            else:
                for k, v in chunk_dict.items():
                    columns[k].append(v)
            count += len(next(iter(chunk_dict.values())))
            while count >= threshold:
                columns = {k: [np.concatenate(v)] if len(v) > 1 else v
                           for k, v in columns.items()}
                take = rng.permutation(count)[:self.batch_size]
                batch = {k: np.take(v[0], take, axis=0) for k, v in columns.items()}
                keep = np.ones(count, dtype=bool)
                keep[take] = False
                columns = {k: [v[0][keep]] for k, v in columns.items()}
                count -= self.batch_size
                yield batch
        if count and columns:
            columns = {k: np.concatenate(v) if len(v) > 1 else v[0]
                       for k, v in columns.items()}
            order = rng.permutation(count)
            start = 0
            while count - start >= self.batch_size:
                take = order[start:start + self.batch_size]
                yield {k: np.take(v, take, axis=0) for k, v in columns.items()}
                start += self.batch_size
            if count - start > 0 and not self._drop_last:
                take = order[start:]
                yield {k: np.take(v, take, axis=0) for k, v in columns.items()}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.reader.stop()
        self.reader.join()


def _take_front(chunks, size):
    """Pop ``size`` rows off the front of the chunk deque; slices are views,
    concatenation only happens across chunk boundaries."""
    parts = []
    need = size
    while need > 0:
        chunk_dict, start = chunks.popleft()
        n = len(next(iter(chunk_dict.values())))
        take = min(n - start, need)
        parts.append({k: v[start:start + take] for k, v in chunk_dict.items()})
        if take < n - start:
            chunks.appendleft((chunk_dict, start + take))
        need -= take
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _filter_numeric(batch, warned):
    """Drop object/string columns: they cannot live on the device."""
    out = {}
    for name, value in batch.items():
        arr = np.asarray(value)
        if arr.dtype == object or arr.dtype.kind in ('U', 'S'):
            if name not in warned:
                warned.add(name)
                logger.warning('Field %s has non-numeric dtype %s; kept on host '
                               '(excluded from device batch)', name, arr.dtype)
            continue
        out[name] = value
    return out

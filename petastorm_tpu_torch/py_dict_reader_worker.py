"""Row-path decode worker: one work item = one row group.

Counterpart of ``petastorm_tpu/py_dict_reader_worker.py``: per-cell codec
decode, the TransformSpec, and the ``columnar_output`` path that publishes
one dict of stacked column arrays per row group (the columns are stacked
here, in the worker pool, so the consumer thread does no per-row work).
There a static-shape column decodes whole through the native decode plane
where it can, and a declared resize (``ResizeImages``) fuses into the
decode.  Predicates, NGram windows, row-drop partitions and hive partition
columns are later slices.  Nothing here imports ``torch``: the process
pool's children unpickle this module's worker.
"""

from dataclasses import dataclass, field as dataclass_field

import numpy as np

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.reader_impl.parquet_worker_base import ParquetWorkerBase


@dataclass
class RowWorkerArgs:
    """Immutable per-reader setup shared by all workers."""
    pieces: list                  # list[RowGroupPiece]
    schema_view: object           # selected fields of the stored Unischema (codec source)
    transform_spec: object = None
    cache: object = dataclass_field(default_factory=NullCache)
    #: Publish one dict of stacked column arrays per row group instead of a
    #: list of row dicts.
    columnar_output: bool = False
    #: Transient-I/O retries per row group before PoisonedRowGroupError.
    read_retries: int = 2
    retry_backoff_s: float = 0.1


def piece_cache_key(piece, schema_view, transform_spec):
    """Result-cache key of one piece: cached payloads are post-transform, so
    the key carries the transform's identity."""
    cache_key = '%s:%d:0:%s' % (piece.path, piece.row_group,
                                ','.join(sorted(schema_view.fields)))
    token = transform_spec.cache_token if transform_spec is not None else None
    if token:
        cache_key += ':t{%s}' % token
    return cache_key


def columnar_fast_path(transform_spec):
    """True when the columnar worker decodes whole columns (no transform
    func, or one the decode fuses, as ``ResizeImages``'); False sends each
    row group through the per-row path, as an opaque func must."""
    ts = transform_spec
    return ts is None or ts.func is None or bool(getattr(ts, 'columnar_fusable', False))


class PyDictReaderWorker(ParquetWorkerBase):

    def process(self, piece_index):
        piece = self._a.pieces[piece_index]
        cache_key = piece_cache_key(piece, self._a.schema_view, self._a.transform_spec)
        if self._a.columnar_output and columnar_fast_path(self._a.transform_spec):
            # True columnar decode: no intermediate row dicts.
            columns = self._a.cache.get(
                cache_key + ':c',
                lambda: self._read_with_retry(piece, lambda pf: self._load_columns(pf, piece)))
            if columns and len(next(iter(columns.values()))) > 0:
                self.publish_func(columns)
            return
        rows = self._a.cache.get(
            cache_key, lambda: self._read_with_retry(piece, lambda pf: self._load_rows(pf, piece)))
        if rows:
            self.publish_func(_stack_columnar(rows) if self._a.columnar_output else rows)

    # -- columnar path --------------------------------------------------------

    def _resize_target(self, name):
        """(h, w) of a field the transform's declared resize covers."""
        ts = self._a.transform_spec
        if ts is None or not getattr(ts, 'columnar_fusable', False):
            return None
        return ts.resize_targets.get(name)

    def _load_columns(self, pf, piece):
        """Decode a row group column-wise into stacked arrays."""
        names = sorted(self._a.schema_view.fields)
        table = pf.read_row_group(piece.row_group, columns=names)
        out = {}
        for name in names:
            f = self._a.schema_view.fields[name]
            column = table.column(name)
            target = self._resize_target(name)
            codec = f.codec_or_default
            shape = f.shape if f.shape is not None else ()
            channels = tuple(shape[2:]) if len(shape) > 2 else ()
            if target is not None and hasattr(codec, 'decode_batch_into_resized') \
                    and column.null_count == 0 and all(s is not None for s in channels):
                # Fused decode and resize: the batch takes the declared
                # target's shape, so wildcard-shape images decode whole too.
                dst = np.empty((len(column),) + tuple(target) + channels, dtype=f.numpy_dtype)
                try:
                    if not codec.decode_batch_into_resized(f, column, dst):
                        for i, cell in enumerate(column.to_pylist()):
                            codec.decode_resized_into(f, cell, dst[i])
                except Exception as e:
                    raise DecodeFieldError('Failed to decode+resize field %r: %s'
                                           % (name, e)) from e
                out[name] = dst
                continue
            if f.codec is None and not f.nullable:
                # Native scalar column: vectorized arrow -> numpy.
                arr = column.to_numpy(zero_copy_only=False)
                if np.dtype(f.numpy_dtype).kind not in ('U', 'S', 'O'):
                    arr = arr.astype(f.numpy_dtype, copy=False)
                out[name] = arr
                continue
            static = all(s is not None for s in shape) and \
                np.dtype(f.numpy_dtype).kind not in ('U', 'S', 'O')
            if static and shape and column.null_count == 0:
                # Preallocated batch: the whole column in one native call
                # (pointers into the Arrow buffers, no per-cell bytes), else
                # each cell straight into its (i, ...) slice, with no
                # np.stack pass.
                dst = np.empty((len(column),) + tuple(shape), dtype=f.numpy_dtype)
                try:
                    if not codec.decode_batch_into(f, column, dst):
                        for i, c in enumerate(column.to_pylist()):
                            codec.decode_into(f, c, dst[i])
                except Exception as e:
                    raise DecodeFieldError('Failed to decode field %r: %s' % (name, e)) from e
                out[name] = dst
                continue
            try:
                decoded = [codec.decode(f, c) if c is not None else None
                           for c in column.to_pylist()]
            except Exception as e:
                raise DecodeFieldError('Failed to decode field %r: %s' % (name, e)) from e
            out[name] = _stack_cells_np(decoded)
        # Declared resizes that could not fuse (nullable cells, codecs
        # without a fused decode): resized after decode, so ResizeImages
        # holds on every branch.
        for name in out:
            target = self._resize_target(name)
            if target is None:
                continue
            batch = out[name]
            if batch.dtype == object or (batch.ndim >= 3
                                         and tuple(batch.shape[1:3]) != tuple(target)):
                out[name] = _resize_cells(batch, target)
        return out

    # -- row path -------------------------------------------------------------

    def _load_rows(self, pf, piece):
        columns = sorted(self._a.schema_view.fields)
        table = pf.read_row_group(piece.row_group, columns=columns)
        cols = {name: table.column(name).to_pylist() for name in columns}
        rows = [{name: self._decode_cell(name, cols[name][i]) for name in columns}
                for i in range(table.num_rows)]
        if self._a.transform_spec is not None and self._a.transform_spec.func is not None:
            rows = [self._a.transform_spec.func(r) for r in rows]
        return rows

    def _decode_cell(self, name, value):
        f = self._a.schema_view.fields[name]
        if value is None:
            return value
        try:
            return f.codec_or_default.decode(f, value)
        except Exception as e:
            raise DecodeFieldError('Failed to decode field %r: %s' % (name, e)) from e


def _resize_cells(batch, target):
    """Each cell of a decoded batch (an ndarray, or an object array of
    variable-size cells) resized to ``target`` (h, w)."""
    from petastorm_tpu_torch.codecs import resize_image_cell
    h, w = target
    return _stack_cells_np([resize_image_cell(a, h, w) for a in batch])


def _stack_columnar(rows):
    """List of decoded row dicts -> dict of (N, ...) arrays (strings/None ->
    1-D object arrays)."""
    return {name: _stack_cells_np([r[name] for r in rows]) for name in rows[0]}


def _stack_cells_np(cells):
    first = next((c for c in cells if c is not None), None)
    if isinstance(first, np.ndarray):
        try:
            return np.stack([c if c is not None else np.zeros_like(first)
                             for c in cells])
        except ValueError:  # ragged shapes (wildcard dims)
            pass
    elif first is not None and not isinstance(first, (str, bytes)):
        arr = np.asarray(cells)
        if arr.dtype != object:
            return arr
    obj = np.empty(len(cells), dtype=object)
    obj[:] = cells
    return obj

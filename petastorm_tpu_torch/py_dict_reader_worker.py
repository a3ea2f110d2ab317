"""Row-path decode worker: one work item = one row group.

Counterpart of ``petastorm_tpu/py_dict_reader_worker.py``: per-cell codec
decode, the TransformSpec, and the ``columnar_output`` path that publishes
one dict of stacked column arrays per row group (the columns are stacked
here, in the worker pool, so the consumer thread does no per-row work).
There a static-shape column decodes whole through the native decode plane
where it can, and a declared resize (``ResizeImages``) fuses into the
decode.  A predicate is read and evaluated first, on its own columns, and
the other columns are decoded for the rows that pass (on the row path; the
columnar path masks them), as the JAX package's worker does; hive partition
values are injected where the view asks for them.  With an NGram
(``RowWorkerArgs.ngram``) each row group's rows, decoded and transformed,
are formed into windows ``{offset: row}`` before they are published, so a
window never spans row groups; NGram never takes the columnar path.
Row-drop partitions are a later slice.  Nothing here imports ``torch``:
the process pool's children unpickle this module's worker.
"""

from dataclasses import dataclass, field as dataclass_field

import numpy as np

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.codecs import NdarrayCodec
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.reader_impl.parquet_worker_base import ParquetWorkerBase


@dataclass
class RowWorkerArgs:
    """Immutable per-reader setup shared by all workers."""
    pieces: list                  # list[RowGroupPiece]
    schema_view: object           # selected fields of the stored Unischema (codec source)
    transform_spec: object = None
    cache: object = dataclass_field(default_factory=NullCache)
    #: The stored Unischema, whose fields a predicate may read beyond the
    #: view (None: the view).
    schema: object = None
    predicate: object = None
    #: An :class:`~petastorm_tpu_torch.ngram.NGram` with its fields resolved:
    #: publish its windows of each row group's rows.
    ngram: object = None
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

    def __init__(self, worker_id, publish_func, args):
        super(PyDictReaderWorker, self).__init__(worker_id, publish_func, args)
        self._stored = args.schema if args.schema is not None else args.schema_view
        #: Each field by name, the stored schema's first (a predicate may
        #: read fields beyond the view); read per cell on the row path.
        self._fields = dict(args.schema_view.fields)
        self._fields.update(self._stored.fields)

    def process(self, piece_index, _row_drop_partition=0):
        """Decode one row group and publish it (the second argument, an
        elastic prologue's row-drop partition, is always 0 here)."""
        piece = self._a.pieces[piece_index]
        cache_key = piece_cache_key(piece, self._a.schema_view, self._a.transform_spec)
        columnar = self._a.columnar_output and self._a.ngram is None
        if columnar and columnar_fast_path(self._a.transform_spec):
            # True columnar decode: no intermediate row dicts.
            columns = self._a.cache.get(
                cache_key + ':c',
                lambda: self._read_with_retry(piece, lambda pf: self._load_columns(pf, piece)))
            if columns and len(next(iter(columns.values()), ())) > 0:
                self.publish_func(columns)
            return
        rows = self._a.cache.get(
            cache_key, lambda: self._read_with_retry(piece, lambda pf: self._load_rows(pf, piece)))
        if self._a.ngram is not None:
            rows = self._a.ngram.form_sequences(rows, self._a.schema_view)
        if rows:
            self.publish_func(_stack_columnar(rows) if columnar else rows)

    # -- columnar path --------------------------------------------------------

    def _resize_target(self, name):
        """(h, w) of a field the transform's declared resize covers."""
        ts = self._a.transform_spec
        if ts is None or not getattr(ts, 'columnar_fusable', False):
            return None
        return ts.resize_targets.get(name)

    def _predicate_fields(self):
        fields = set(self._a.predicate.get_fields())
        first_pass = sorted(fields & set(self._stored.fields))
        if not first_pass:
            raise ValueError('Predicate fields %s not in schema' % sorted(fields))
        return fields, first_pass

    def _partition_cells(self, piece, present):
        """``(key, value)`` of each hive partition key the view asks for and
        ``present`` lacks: the directory's value, as the field's dtype."""
        for key, value in piece.partition_values:
            if key in self._a.schema_view.fields and key not in present:
                dtype = np.dtype(self._fields[key].numpy_dtype)
                yield key, value if dtype.kind in ('U', 'S', 'O') else dtype.type(value)

    def _load_columns(self, pf, piece):
        """A row group decoded column-wise into stacked arrays: the
        predicate's columns first, then the rest, masked; then the
        partition values."""
        wanted = set(self._a.schema_view.fields) - _injected(pf, piece)
        predicate = self._a.predicate
        mask = None
        out = {}
        if predicate is not None:
            _, pred_fields = self._predicate_fields()
            pred_cols = self._decode_columns(pf, piece, pred_fields)
            num_rows = len(next(iter(pred_cols.values())))
            mask = np.fromiter(
                (predicate.do_include({n: pred_cols[n][i] for n in pred_fields})
                 for i in range(num_rows)), dtype=bool, count=num_rows)
            if not mask.any():
                return None
            out.update((n, pred_cols[n][mask]) for n in pred_fields if n in wanted)
            remaining = sorted(wanted - set(pred_fields))
        else:
            remaining = sorted(wanted)
        for name, arr in self._decode_columns(pf, piece, remaining).items():
            out[name] = arr[mask] if mask is not None else arr
        for key, cell in list(self._partition_cells(piece, out)):
            out[key] = np.full(len(next(iter(out.values()))), cell,
                               dtype=object if isinstance(cell, str) else None)
        return out

    def _decode_columns(self, pf, piece, names):
        """The columns ``names`` of a row group, each decoded whole."""
        if not names:
            return {}
        table = pf.read_row_group(piece.row_group, columns=list(names))
        out = {}
        for name in names:
            f = self._fields.get(name)
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
        wanted = set(self._a.schema_view.fields) - _injected(pf, piece)
        predicate = self._a.predicate
        if predicate is not None:
            predicate_fields, first_pass = self._predicate_fields()
            table = pf.read_row_group(piece.row_group, columns=first_pass)
            columns = {name: table.column(name).to_pylist() for name in first_pass}
            decoded = [{name: self._decode_cell(name, columns[name][i]) for name in first_pass}
                       for i in range(table.num_rows)]
            mask = [predicate.do_include(values) for values in decoded]
            if not any(mask):
                return []
            rows = [dict(v) for v, keep in zip(decoded, mask) if keep]
            # the other columns, decoded for the rows that pass only
            remaining = sorted(wanted - predicate_fields)
            if remaining:
                rest = pf.read_row_group(piece.row_group, columns=remaining)
                rest_cols = {name: rest.column(name).to_pylist() for name in remaining}
                kept = [i for i, keep in enumerate(mask) if keep]
                for row, i in zip(rows, kept):
                    for name in remaining:
                        row[name] = self._decode_cell(name, rest_cols[name][i])
            extra = predicate_fields - wanted   # read for the predicate only
            if extra:
                rows = [{k: v for k, v in r.items() if k not in extra} for r in rows]
        else:
            columns = sorted(wanted)
            table = pf.read_row_group(piece.row_group, columns=columns)
            cols = {name: self._decoded_cells(name, table.column(name)) for name in columns}
            rows = [{name: cols[name][i] for name in columns} for i in range(table.num_rows)]
        for key, cell in self._partition_cells(piece, wanted):
            for r in rows:
                r[key] = cell
        if self._a.transform_spec is not None and self._a.transform_spec.func is not None:
            rows = [self._a.transform_spec.func(r) for r in rows]
        return rows

    def _decoded_cells(self, name, column):
        """A column's cells decoded, each as :meth:`_decode_cell` gives it: a
        native numeric scalar column through one arrow -> numpy conversion,
        a static-shape ``NdarrayCodec`` column (exact bytes, so the same
        arrays) in one whole-column native call (each cell a row of the
        batch) where the library holds the function, any other column cell
        by cell (images among them: the native decoders are not cv2's)."""
        f = self._fields.get(name)
        if f is not None and column.null_count == 0:
            dtype = np.dtype(f.numpy_dtype)
            if f.codec is None and dtype.kind in 'biuf':
                return column.to_numpy(zero_copy_only=False).astype(dtype, copy=False)
            shape = f.shape if f.shape is not None else ()
            if isinstance(f.codec, NdarrayCodec) and shape \
                    and all(s is not None for s in shape) and dtype.kind in 'biuf':
                dst = np.empty((len(column),) + tuple(shape), dtype=dtype)
                try:
                    done = f.codec.decode_batch_into(f, column, dst)
                except Exception as e:
                    raise DecodeFieldError('Failed to decode field %r: %s' % (name, e)) from e
                if done:
                    return dst
        return [self._decode_cell(name, cell) for cell in column.to_pylist()]

    def _decode_cell(self, name, value):
        f = self._fields.get(name)
        if value is None or f is None:
            return value
        try:
            return f.codec_or_default.decode(f, value)
        except Exception as e:
            raise DecodeFieldError('Failed to decode field %r: %s' % (name, e)) from e


def _injected(pf, piece):
    """The partition keys of ``piece`` that its file does not store: they
    come from the directory names, not from a read."""
    physical = set(pf.schema_arrow.names)
    return {key for key, _ in piece.partition_values if key not in physical}


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

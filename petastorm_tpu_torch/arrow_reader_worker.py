"""Batch-path decode worker: one row group -> one Arrow table.

Counterpart of ``petastorm_tpu/arrow_reader_worker.py``: whole-row-group
reads of a plain Parquet store (no codecs), a predicate evaluated on its
own columns first and applied as a mask, hive partition columns injected,
and the pandas ``TransformSpec`` at DataFrame level (where ``func`` may drop
rows).  :class:`ArrowResultConverter` turns each table into a namedtuple of
numpy arrays on the consuming side.  Nothing here imports ``torch``: the
process pool's children unpickle this module's worker, and their tables
come back through ``/dev/shm``.
"""

from dataclasses import dataclass, field as dataclass_field

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.reader_impl.parquet_worker_base import ParquetWorkerBase

__all__ = ['BatchWorkerArgs', 'ArrowReaderWorker', 'ArrowResultConverter', 'piece_cache_key']


@dataclass
class BatchWorkerArgs:
    """Immutable per-reader setup shared by all workers."""
    pieces: list                  # list[RowGroupPiece]
    schema_view: object           # the selected fields of the (inferred) Unischema
    transform_spec: object = None
    predicate: object = None
    cache: object = dataclass_field(default_factory=NullCache)
    #: Transient-I/O retries per row group before PoisonedRowGroupError.
    read_retries: int = 2
    retry_backoff_s: float = 0.1
    #: The reader's filesystem: None or the port's local one read through
    #: the memory map, any other through its ``open``.
    filesystem: object = None
    #: The reader's :class:`~petastorm_tpu_torch.ingest.IngestPlane`, or None.
    ingest: object = None


def piece_cache_key(piece, schema_view, transform_spec):
    """Result-cache key of one batch-path row group: the payload is
    post-transform, so the key carries the transform's identity."""
    cache_key = '%s:%d:batch:%s' % (piece.path, piece.row_group,
                                    ','.join(sorted(schema_view.fields)))
    token = transform_spec.cache_token if transform_spec is not None else None
    if token:
        cache_key += ':t{%s}' % token
    return cache_key


class ArrowReaderWorker(ParquetWorkerBase):

    #: ``TransformSpec.func`` runs on a DataFrame here and may drop rows
    #: (read by ``Reader.transform_may_change_row_count``).
    DATAFRAME_TRANSFORM = True

    def process(self, piece_index, _row_drop_partition=0):
        piece = self._a.pieces[piece_index]
        cache_key = piece_cache_key(piece, self._a.schema_view, self._a.transform_spec)
        # the retries wrap the read only: an error out of the user's
        # transform surfaces as itself, not as a corrupt row group; the
        # scope hands the ingest plane's entry back on a cache hit
        with self._ingest_scope(piece):
            table = self._a.cache.get(
                cache_key,
                lambda: self._apply_transform(
                    self._read_with_retry(piece, lambda pf: self._load_table(pf, piece))))
        if table is not None and table.num_rows > 0:
            self.publish_func(table)

    def _load_table(self, pf, piece):
        physical = set(pf.schema_arrow.names)
        wanted = [n for n in self._a.schema_view.fields if n in physical]
        predicate = self._a.predicate
        if predicate is not None:
            pred_fields = sorted(set(predicate.get_fields()) & physical)
            if not pred_fields:
                raise ValueError('Predicate fields %s not present in files'
                                 % sorted(predicate.get_fields()))
            pred_table = pf.read_row_group(piece.row_group, columns=pred_fields)
            cols = {n: pred_table.column(n).to_pylist() for n in pred_fields}
            mask = np.array([predicate.do_include({n: cols[n][i] for n in pred_fields})
                             for i in range(pred_table.num_rows)], dtype=bool)
            if not mask.any():
                return None
            table = pf.read_row_group(piece.row_group, columns=wanted)
            table = table.filter(pa.array(mask))
        else:
            table = pf.read_row_group(piece.row_group, columns=wanted)
        # hive partition values as constant columns, where the view asks
        for key, value in piece.partition_values:
            if key in self._a.schema_view.fields and key not in table.column_names:
                dtype = np.dtype(self._a.schema_view.fields[key].numpy_dtype)
                cast = value if dtype.kind in ('U', 'S', 'O') else dtype.type(value)
                table = table.append_column(key, pa.array([cast] * table.num_rows))
        return table

    def _apply_transform(self, table):
        spec = self._a.transform_spec
        if table is None or spec is None:
            return table
        df = table.to_pandas()
        if spec.func is not None:
            df = spec.func(df)
        for name in spec.removed_fields:
            if name in df.columns:
                df = df.drop(columns=[name])
        if spec.selected_fields is not None:
            df = df[list(spec.selected_fields)]
        return pa.Table.from_pandas(df, preserve_index=False)


class ArrowResultConverter(object):
    """An Arrow table -> a namedtuple of numpy arrays (one batch per row
    group), each array owned and writable: a process pool's table is a
    view of a shared-memory slab, which a copied batch no longer pins."""

    def __init__(self, schema):
        self._schema = schema

    def convert(self, table):
        out = {}
        for name in self._schema.fields:
            if name in table.column_names:
                out[name] = _column_to_numpy(table.column(name).combine_chunks())
        return self._schema.make_namedtuple_from_dict(out)


def _column_to_numpy(column):
    """A rectangular list column -> a 2-D array, a ragged one (or one with
    nulls) -> a 1-D object array of arrays, strings and binaries -> an
    object array; else ``to_numpy`` (a nullable int column with nulls comes
    out as float64 with NaN, as in pandas)."""
    ctype = column.type
    if pa.types.is_list(ctype) or pa.types.is_large_list(ctype):
        pylist = column.to_pylist()
        arrays = [np.asarray(x) if x is not None else None for x in pylist]
        shapes = {a.shape for a in arrays if a is not None}
        if len(shapes) == 1 and None not in pylist:
            return np.stack(arrays)
        out = np.empty(len(arrays), dtype=object)
        out[:] = arrays
        return out
    if pa.types.is_string(ctype) or pa.types.is_large_string(ctype) \
            or pa.types.is_binary(ctype) or pa.types.is_large_binary(ctype):
        return np.asarray(column.to_pylist(), dtype=object)
    arr = column.to_numpy(zero_copy_only=False)
    # a zero-copy view is read-only and may pin a shared-memory slab
    return arr if arr.flags.writeable else arr.copy()

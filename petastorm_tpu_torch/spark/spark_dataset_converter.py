"""A DataFrame materialized once to cached Parquet, read back through the
batch reader into the port's loader.

Counterpart of ``petastorm_tpu/spark/spark_dataset_converter.py`` for
pandas frames: :func:`make_pandas_converter` writes the frame (float64
narrowed to float32, array cells as Arrow lists) under a parent cache
directory, keyed by a content hash over its values, its schema and the
materialization settings, so the same frame and settings reuse one copy
(and name the same cache as the JAX package's converter does); a
:class:`SparkDatasetConverter` is the handle: ``len()``,
``cache_dir_url``, ``make_loader`` (the JAX converter's
``make_jax_loader``: a :class:`~petastorm_tpu_torch.gpu.DataLoader` over
``make_batch_reader``, used as a context manager) and ``delete``.  Cache
directories still registered at interpreter exit are removed.

``make_spark_converter`` (pyspark is not installed) and the JAX converter's
TensorFlow and host-torch consumers (``make_tf_dataset``,
``make_torch_dataloader``) raise ``ValueError``: ROADMAP.md, Queue A item 7.
"""

import atexit
import hashlib
import logging
import threading
import uuid

from petastorm_tpu_torch.fs_utils import get_filesystem_and_path

__all__ = ['SparkDatasetConverter', 'make_pandas_converter', 'make_spark_converter']

logger = logging.getLogger(__name__)

_CACHED_CONVERTERS = {}
_CACHE_LOCK = threading.Lock()
_NOT_PORTED = '%s is not in the port yet (ROADMAP.md, Queue A item 7)'


class CachedDataFrameMeta(object):
    """Bookkeeping for one materialized DataFrame."""

    def __init__(self, df_plan_hash, cache_dir_url, row_count, parquet_row_group_size_bytes):
        self.df_plan_hash = df_plan_hash
        self.cache_dir_url = cache_dir_url
        self.row_count = row_count
        self.parquet_row_group_size_bytes = parquet_row_group_size_bytes


class SparkDatasetConverter(object):
    """Handle to a materialized (cached) Parquet copy of a DataFrame."""

    PARENT_CACHE_DIR_URL_CONF = 'petastorm.spark.converter.parentCacheDirUrl'

    def __init__(self, cache_dir_url, dataset_size):
        self.cache_dir_url = cache_dir_url
        self.dataset_size = dataset_size

    def __len__(self):
        return self.dataset_size

    def make_loader(self, batch_size=32, num_epochs=None, workers_count=None, cur_shard=None,
                    shard_count=None, loader_kwargs=None, **petastorm_reader_kwargs):
        """A :class:`~petastorm_tpu_torch.gpu.DataLoader` over
        ``make_batch_reader`` of the cached Parquet; leaving it as a context
        manager stops the reader.  ``loader_kwargs`` go to the loader
        (``device``, ``transform_fn``, ...), the rest to the reader."""
        from petastorm_tpu_torch.gpu.loader import make_loader
        kwargs = dict(petastorm_reader_kwargs)
        if workers_count is not None:
            kwargs['workers_count'] = workers_count
        return make_loader(self.cache_dir_url, batch_size, batched=True,
                           loader_kwargs=loader_kwargs, num_epochs=num_epochs,
                           cur_shard=cur_shard, shard_count=shard_count, **kwargs)

    def make_tf_dataset(self, *args, **kwargs):
        raise ValueError(_NOT_PORTED % 'make_tf_dataset (a TensorFlow consumer)')

    def make_torch_dataloader(self, *args, **kwargs):
        raise ValueError(_NOT_PORTED % 'make_torch_dataloader (the host-torch consumer; '
                                       'make_loader is the port\'s device loader)')

    def delete(self):
        """Delete the cached Parquet files and forget this frame."""
        fs, path = get_filesystem_and_path(self.cache_dir_url)
        try:
            fs.rm(path, recursive=True)
        except FileNotFoundError:
            pass
        with _CACHE_LOCK:
            for key, meta in list(_CACHED_CONVERTERS.items()):
                if meta.cache_dir_url == self.cache_dir_url:
                    del _CACHED_CONVERTERS[key]


def make_spark_converter(df, *args, **kwargs):
    raise ValueError(_NOT_PORTED % 'make_spark_converter (pyspark)')


def _get_or_materialize(cache_key, parent_cache_dir_url, row_group_size_bytes, materialize_fn):
    """The registered converter of ``cache_key``, or a new one whose
    directory ``materialize_fn(cache_dir_url) -> row_count`` writes.  Of
    two callers racing on one key, the loser deletes its copy."""
    with _CACHE_LOCK:
        cached = _CACHED_CONVERTERS.get(cache_key)
    if cached is not None:
        return SparkDatasetConverter(cached.cache_dir_url, cached.row_count)
    cache_dir_url = '%s/%s' % (parent_cache_dir_url.rstrip('/'), uuid.uuid4().hex)
    row_count = materialize_fn(cache_dir_url)
    meta = CachedDataFrameMeta(cache_key, cache_dir_url, row_count, row_group_size_bytes)
    with _CACHE_LOCK:
        winner = _CACHED_CONVERTERS.setdefault(cache_key, meta)
    if winner is not meta:
        try:
            fs, path = get_filesystem_and_path(cache_dir_url)
            fs.rm(path, recursive=True)
        except Exception:  # noqa: BLE001 — the losing copy's removal is best effort
            logger.warning('Failed to remove raced cache dir %s', cache_dir_url)
        return SparkDatasetConverter(winner.cache_dir_url, winner.row_count)
    return SparkDatasetConverter(cache_dir_url, row_count)


def make_pandas_converter(df, parent_cache_dir_url, parquet_row_group_size_bytes=32 << 20,
                          compression_codec=None, dtype='float32'):
    """Materialize the pandas frame ``df`` to Parquet under
    ``parent_cache_dir_url`` (once per content hash) and return its
    :class:`SparkDatasetConverter`.  ``dtype='float32'`` narrows float64
    columns and float64 array cells; row groups hold about
    ``parquet_row_group_size_bytes`` each."""
    import numpy as np
    import pandas as pd
    import pyarrow as pa
    import pyarrow.parquet as pq

    if dtype == 'float32':
        def narrow(a):
            return a.astype(np.float32) \
                if isinstance(a, np.ndarray) and a.dtype == np.float64 else a
        for name in df.columns:
            if df[name].dtype == np.float64:
                df = df.assign(**{name: df[name].astype(np.float32)})
            elif df[name].dtype == object:
                df = df.assign(**{name: df[name].map(narrow)})

    # The key covers the values, the schema (names, dtypes) and the
    # materialization settings: frames that differ in any of them must not
    # share a copy.
    def cell_key(v):
        if isinstance(v, np.ndarray):
            return v.tobytes()
        if isinstance(v, (list, tuple)):
            return repr(v)
        return v

    hasher = hashlib.sha1()
    hasher.update(repr([parent_cache_dir_url, parquet_row_group_size_bytes,
                        compression_codec, list(df.columns),
                        [str(t) for t in df.dtypes]]).encode('utf-8'))
    for name in df.columns:
        col = df[name]
        if col.dtype == object:
            col = col.map(cell_key)
        hasher.update(pd.util.hash_pandas_object(col, index=False).values.tobytes())
    content_hash = hasher.hexdigest()

    def materialize(cache_dir_url):
        fs, path = get_filesystem_and_path(cache_dir_url)
        fs.makedirs(path, exist_ok=True)
        columns = {}
        for name in df.columns:
            has_arrays = df[name].dtype == object and any(
                isinstance(c, np.ndarray) for c in df[name])
            if has_arrays:  # array cells -> Arrow lists (None cells -> null)
                columns[name] = pa.array(
                    [c.ravel().tolist() if isinstance(c, np.ndarray) else None
                     for c in df[name]])
            else:
                columns[name] = pa.array(df[name])
        table = pa.table(columns)
        row_bytes = max(1, table.nbytes // max(1, table.num_rows))
        with fs.open(path + '/part_00000.parquet', 'wb') as out:
            pq.write_table(table, out,
                           row_group_size=max(1, parquet_row_group_size_bytes // row_bytes),
                           compression=compression_codec or 'snappy')
        return len(df)

    return _get_or_materialize(content_hash, parent_cache_dir_url,
                               parquet_row_group_size_bytes, materialize)


@atexit.register
def _cleanup_cache_dirs():
    """Remove the cache directories still registered at interpreter exit."""
    with _CACHE_LOCK:
        metas = list(_CACHED_CONVERTERS.values())
        _CACHED_CONVERTERS.clear()
    for meta in metas:
        try:
            fs, path = get_filesystem_and_path(meta.cache_dir_url)
            fs.rm(path, recursive=True)
        except Exception:  # noqa: BLE001 — best effort at exit
            logger.warning('Failed to remove converter cache dir %s', meta.cache_dir_url)

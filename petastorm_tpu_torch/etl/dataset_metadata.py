"""Dataset footer metadata: write-side stamping, read-side loading.

Counterpart of ``petastorm_tpu/etl/dataset_metadata.py``: the footer keys
are byte-identical, so a dataset written by either package reads in the
other.  The pickled Unischema names its classes by module; the unpickler
here maps upstream petastorm's and the JAX package's module names onto
this package (the Spark SQL types of an upstream footer become stubs when
pyspark is absent), and the JAX package resolves this package's names by
import.

Cut to this slice: the read side (``get_schema``, ``load_row_groups``
over petastorm datasets and plain Parquet stores, hive ``key=value``
directories included, and ``infer_or_load_unischema`` for the batch
reader) and a streaming :class:`DatasetWriter` of one file.  Spark
materialization, multi-file and multi-host writes, the writer's encode
thread pool and the footer scans of the adaptive scheduler are later
slices.
"""

import io
import json
import logging
import pickle
import posixpath
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import suppress
from dataclasses import dataclass

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path
from petastorm_tpu_torch.unischema import Unischema, encode_row

logger = logging.getLogger(__name__)

UNISCHEMA_KEY = b'dataset-toolkit.unischema.v1'
ROW_GROUPS_PER_FILE_KEY = b'dataset-toolkit.num_row_groups_per_file.v1'
#: Per-file list of per-row-group ROW counts (the JAX package's extension).
ROW_GROUP_ROW_COUNTS_KEY = b'petastorm-tpu.rowgroup_row_counts.v1'

_COMMON_METADATA = '_common_metadata'
#: Row-group size of the writer when no row count is given.
_ROWGROUP_BYTES = 32 << 20


@dataclass(frozen=True)
class RowGroupPiece:
    """One unit of read work: a single row group of a single file."""
    path: str            # filesystem path of the parquet file
    row_group: int       # row-group ordinal within the file
    num_rows: int = -1   # row count when known from metadata (-1 = unknown)
    partition_values: tuple = ()  # ((key, value), ...) from hive directories


# -- pickle compatibility ----------------------------------------------------

#: Module paths of pickled Unischemas -> this package's.  Upstream petastorm
#: writes ``petastorm.*``, the JAX package ``petastorm_tpu.*``; the rename
#: happens before any import, so neither package is ever loaded.
_MODULE_RENAMES = {
    'petastorm.unischema': 'petastorm_tpu_torch.unischema',
    'petastorm.codecs': 'petastorm_tpu_torch.codecs',
    'petastorm_tpu.unischema': 'petastorm_tpu_torch.unischema',
    'petastorm_tpu.codecs': 'petastorm_tpu_torch.codecs',
}

_PYSPARK_TYPES = 'pyspark.sql.types'

_pyspark_stub_cache = {}


def _pyspark_stub(module, name):
    """A stand-in for a pyspark class named by an upstream pickle
    (``ScalarCodec._spark_type`` holds Spark SQL type instances): footers
    are written on Spark clusters, and hosts that read them rarely have
    pyspark.  It instantiates under any pickle protocol, takes BUILD state,
    and answers ``typeName`` as pyspark's class does, which is all that
    ``ScalarCodec.__setstate__`` reads to recover the arrow type."""
    key = (module, name)
    if key not in _pyspark_stub_cache:
        @classmethod
        def type_name(cls):
            return cls.__name__[:-4].lower() if cls.__name__.endswith('Type') \
                else cls.__name__.lower()

        _pyspark_stub_cache[key] = type(name, (object,), {
            '__module__': module,
            '__init__': lambda self, *a, **kw: None,
            'typeName': type_name,
            '__repr__': lambda self: '%s()' % type(self).__name__,
        })
    return _pyspark_stub_cache[key]


class _CompatUnpickler(pickle.Unpickler):
    """Unpickles Unischemas written by upstream petastorm or the JAX package
    by mapping their module paths onto this package's copies; the
    ``pyspark.sql.types`` classes resolve to pyspark's when it is installed
    and to stubs when it is not.  Any other module resolves as it is, so an
    unknown one still fails."""

    def find_class(self, module, name):
        if module == _PYSPARK_TYPES or module.startswith(_PYSPARK_TYPES + '.'):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return _pyspark_stub(module, name)
        return super().find_class(_MODULE_RENAMES.get(module, module), name)


def _loads_schema(blob):
    return _CompatUnpickler(io.BytesIO(blob)).load()


# -- filesystem helpers ------------------------------------------------------

def _list_parquet_files(fs, path):
    """All data files under ``path``, excluding metadata/hidden files."""
    if fs.isfile(path):
        return [path]
    return sorted(f for f in fs.find(path) if not _is_metadata_or_hidden(f))


def _is_metadata_or_hidden(path):
    base = posixpath.basename(path)
    return base.startswith('_') or base.startswith('.') or base.endswith('.crc')


def _partition_values_for(path, root):
    """The hive ``key=value`` directory partition values of ``path`` below
    ``root``, outermost first."""
    rel = path[len(root):].lstrip('/')
    values = []
    for part in rel.split('/')[:-1]:
        if '=' in part:
            key, _, value = part.partition('=')
            values.append((key, value))
    return tuple(values)


# -- write side --------------------------------------------------------------

class DatasetWriter(object):
    """Streaming Spark-free dataset writer.

    Encodes row dicts through the schema's codecs and writes one Parquet
    file, a row group every ``rows_per_rowgroup`` rows (or every 32 MB of
    encoded cells when None), then stamps the footer metadata::

        with DatasetWriter(url, MySchema, rows_per_rowgroup=64) as w:
            for row in rows:
                w.write(row)
    """

    def __init__(self, dataset_url, schema, rows_per_rowgroup=None):
        self._schema = schema
        self._arrow_schema = schema.as_arrow_schema()
        self._rows_per_rowgroup = rows_per_rowgroup
        # Snappy, except for JPEG/PNG cells: already compressed, they gain
        # nothing from it but CPU burned on every read.
        from petastorm_tpu_torch.codecs import CompressedImageCodec
        self._compression = {name: 'NONE' if isinstance(f.codec, CompressedImageCodec)
                             else 'snappy' for name, f in schema.fields.items()}
        self._fs, self._path = get_filesystem_and_path(dataset_url)
        self._buffer = []
        self._buffer_nbytes = 0
        self._writer = None
        self._sink = None
        self._closed = False

    def write_many(self, rows):
        """:meth:`write` each row of an iterable."""
        for row in rows:
            self.write(row)

    def write(self, row_dict):
        """Encode and buffer one row; may flush a row group."""
        encoded = encode_row(self._schema, row_dict)
        self._buffer.append(encoded)
        self._buffer_nbytes += sum(len(v) if isinstance(v, (bytes, bytearray)) else 8
                                   for v in encoded.values() if v is not None)
        if self._rows_per_rowgroup is not None:
            ready = len(self._buffer) >= self._rows_per_rowgroup
        else:
            ready = self._buffer_nbytes >= _ROWGROUP_BYTES
        if ready:
            self._flush_rowgroup()

    def _flush_rowgroup(self):
        rows = self._buffer
        if not rows:
            return
        table = pa.table(
            {name: pa.array([row.get(name) for row in rows],
                            type=self._arrow_schema.field(name).type)
             for name in self._schema.fields},
            schema=self._arrow_schema)
        if self._writer is None:
            self._open_file()
        self._writer.write_table(table)  # one write_table call == one row group
        self._buffer = []
        self._buffer_nbytes = 0

    def _close_current_file(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def _open_file(self):
        self._fs.makedirs(self._path, exist_ok=True)
        self._sink = self._fs.open(posixpath.join(self._path, 'part_00000.parquet'), 'wb')
        self._writer = pq.ParquetWriter(self._sink, self._arrow_schema,
                                        compression=self._compression)

    def close(self):
        if self._closed:
            return
        try:
            self._flush_rowgroup()
        except BaseException:
            self._abort()
            raise
        self._close_current_file()
        self._closed = True
        _write_common_metadata(self._fs, self._path, self._schema)

    def _abort(self):
        """Teardown after a failed write: no footer is stamped, so a partial
        dataset never reads as valid."""
        self._buffer = []
        self._buffer_nbytes = 0
        try:
            with suppress(Exception):
                self._close_current_file()
        finally:
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if exc_type is None:
            self.close()
        else:
            self._abort()


def _collect_rowgroup_counts(fs, path, files):
    def count(f):
        with fs.open(f, 'rb') as handle:
            md = pq.ParquetFile(handle).metadata
            return (posixpath.relpath(f, path), md.num_row_groups,
                    [md.row_group(i).num_rows for i in range(md.num_row_groups)])

    with ThreadPoolExecutor(max_workers=min(16, max(1, len(files)))) as pool:
        scanned = list(pool.map(count, files))
    return ({rel: n for rel, n, _ in scanned},
            {rel: rows for rel, _, rows in scanned})


def _write_common_metadata(fs, path, schema):
    """Write ``_common_metadata`` carrying the pickled Unischema, the per-file
    row-group counts and the per-row-group row counts."""
    files = _list_parquet_files(fs, path)
    counts, row_counts = _collect_rowgroup_counts(fs, path, files)
    if files:
        with fs.open(files[0], 'rb') as handle:
            arrow_schema = pq.ParquetFile(handle).schema_arrow
    else:
        arrow_schema = schema.as_arrow_schema()
    metadata = dict(arrow_schema.metadata or {})
    metadata[UNISCHEMA_KEY] = pickle.dumps(schema, protocol=4)
    metadata[ROW_GROUPS_PER_FILE_KEY] = json.dumps(counts).encode('utf-8')
    metadata[ROW_GROUP_ROW_COUNTS_KEY] = json.dumps(row_counts).encode('utf-8')
    with fs.open(posixpath.join(path, _COMMON_METADATA), 'wb') as out:
        pq.write_metadata(arrow_schema.with_metadata(metadata), out)


# -- read side ---------------------------------------------------------------

def _read_common_metadata(fs, path):
    meta_path = posixpath.join(path, _COMMON_METADATA)
    if not fs.exists(meta_path):
        return None
    with fs.open(meta_path, 'rb') as handle:
        return pq.read_schema(handle)


def get_schema(fs, path):
    """Load the pickled Unischema from the dataset footer; raises
    :class:`MetadataError` when absent."""
    arrow_schema = _read_common_metadata(fs, path)
    if arrow_schema is None or not arrow_schema.metadata \
            or UNISCHEMA_KEY not in arrow_schema.metadata:
        raise MetadataError(
            'Dataset at %r has no petastorm metadata (missing %s footer key); '
            'write it with DatasetWriter' % (path, UNISCHEMA_KEY))
    return _loads_schema(arrow_schema.metadata[UNISCHEMA_KEY])


def infer_or_load_unischema(fs, path):
    """The stored Unischema when the dataset has one, else one inferred
    from the first data file's arrow schema (scalar and list columns), as
    for a plain Parquet store."""
    try:
        return get_schema(fs, path)
    except MetadataError:
        pass
    except Exception as e:  # noqa: BLE001 — an unreadable pickle: infer instead
        logger.warning('Failed to unpickle stored Unischema (%s); inferring from '
                       'arrow schema instead', e)
    files = _list_parquet_files(fs, path)
    if not files:
        raise MetadataError('No parquet files found under %r' % (path,))
    with fs.open(files[0], 'rb') as handle:
        arrow_schema = pq.ParquetFile(handle).schema_arrow
    return Unischema.from_arrow_schema(arrow_schema)


def read_row_group_num_rows(fs, file_row_groups):
    """The rows of ``{path: [row_group, ...]}``, from the files' footers
    (read in a thread pool)."""
    def scan(item):
        path, row_groups = item
        with fs.open(path, 'rb') as handle:
            md = pq.ParquetFile(handle).metadata
            return sum(md.row_group(i).num_rows for i in row_groups)

    if not file_row_groups:
        return 0
    with ThreadPoolExecutor(max_workers=min(16, len(file_row_groups))) as pool:
        return sum(pool.map(scan, file_row_groups.items()))


def load_row_groups(fs, path):
    """Enumerate all row-group pieces of the dataset: from the footer's
    per-file row-group counts when present (no file footer opened),
    otherwise (a plain Parquet store) by scanning file footers in a thread
    pool; each piece carries its hive partition values."""
    files = _list_parquet_files(fs, path)
    if not files:
        raise MetadataError('No parquet files found under %r' % (path,))

    counts = row_counts = None
    arrow_schema = _read_common_metadata(fs, path)
    if arrow_schema is not None and arrow_schema.metadata \
            and ROW_GROUPS_PER_FILE_KEY in arrow_schema.metadata:
        counts = json.loads(arrow_schema.metadata[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))
        if ROW_GROUP_ROW_COUNTS_KEY in arrow_schema.metadata:
            row_counts = json.loads(
                arrow_schema.metadata[ROW_GROUP_ROW_COUNTS_KEY].decode('utf-8'))

    pieces = []
    if counts is not None:
        present = {posixpath.relpath(f, path): f for f in files}
        for rel, n in sorted(counts.items()):
            full = present.get(rel)
            if full is None:
                logger.warning('File %r in footer metadata is missing on disk; skipping', rel)
                continue
            parts = _partition_values_for(full, path)
            per_rg = (row_counts or {}).get(rel)
            per_rg = per_rg if per_rg is not None and len(per_rg) == int(n) else None
            pieces.extend(
                RowGroupPiece(full, i, per_rg[i] if per_rg else -1, parts)
                for i in range(int(n)))
        return pieces

    lock = threading.Lock()

    def scan(f):
        with fs.open(f, 'rb') as handle:
            md = pq.ParquetFile(handle).metadata
            found = [RowGroupPiece(f, i, md.row_group(i).num_rows,
                                   _partition_values_for(f, path))
                     for i in range(md.num_row_groups)]
        with lock:
            pieces.extend(found)

    with ThreadPoolExecutor(max_workers=min(16, len(files))) as pool:
        list(pool.map(scan, files))
    pieces.sort(key=lambda p: (p.path, p.row_group))
    return pieces

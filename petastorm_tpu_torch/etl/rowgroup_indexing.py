"""Inverted indexes over row groups, built once and kept in the footer.

Counterpart of ``petastorm_tpu/etl/rowgroup_indexing.py`` (upstream
petastorm's ``build_rowgroup_index`` and ``get_row_group_indexes``) with its
footer key ``dataset-toolkit.rowgroups_index.v1``: the value is a zlib'd
pickle of ``{index_name: indexer}``.  An index pickled by the JAX package
names ``petastorm_tpu.etl.rowgroup_indexers``, an upstream one
``petastorm.etl.rowgroup_indexers``; :func:`get_row_group_indexes` reads
them with an unpickler that maps those paths (and this package's) onto
:mod:`~petastorm_tpu_torch.etl.rowgroup_indexers` and refuses every other
global but the containers and numpy scalars a value may be, so reading an
index imports nothing else.  This package writes its own class path.  Read
at reader start by :mod:`petastorm_tpu_torch.selectors`.  No torch.
"""

import io
import pickle
import posixpath
import zlib
from concurrent.futures import ThreadPoolExecutor

import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import DecodeFieldError, MetadataError
from petastorm_tpu_torch.etl import rowgroup_indexers
from petastorm_tpu_torch.etl.dataset_metadata import (_COMMON_METADATA, _read_common_metadata,
                                                      get_schema, load_row_groups)
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path

__all__ = ['ROWGROUPS_INDEX_KEY', 'build_rowgroup_index', 'get_row_group_indexes']

ROWGROUPS_INDEX_KEY = b'dataset-toolkit.rowgroups_index.v1'

#: The indexer modules an index may name, each read as this package's.
_INDEXER_MODULES = ('petastorm.etl.rowgroup_indexers', 'petastorm_tpu.etl.rowgroup_indexers',
                    'petastorm_tpu_torch.etl.rowgroup_indexers')

#: The other globals an index's pickle may hold: its containers and the
#: numpy scalars an indexed value decodes to.
_ALLOWED = {('collections', 'defaultdict'), ('builtins', 'set'), ('builtins', 'frozenset'),
            ('__builtin__', 'set'), ('__builtin__', 'frozenset'), ('_codecs', 'encode'),
            ('numpy', 'dtype'),
            ('numpy.core.multiarray', 'scalar'), ('numpy._core.multiarray', 'scalar')}


class _IndexUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _INDEXER_MODULES and name in rowgroup_indexers.__all__:
            return getattr(rowgroup_indexers, name)
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError('a row-group index may not name the global %s.%s'
                                     % (module, name))


def _loads_index(blob):
    return _IndexUnpickler(io.BytesIO(zlib.decompress(blob))).load()


def _decode_row(row, schema):
    """The cells of an encoded row decoded through their fields' codecs."""
    decoded = {}
    for name, value in row.items():
        field = schema.fields.get(name)
        if field is None:
            continue
        if value is None:
            decoded[name] = None
            continue
        try:
            decoded[name] = field.codec_or_default.decode(field, value)
        except Exception as e:
            raise DecodeFieldError('Failed to decode field %r: %s' % (name, e)) from e
    return decoded


def build_rowgroup_index(dataset_url, spark_context=None, indexers=None, storage_options=None,
                         filesystem=None):
    """Scan the dataset once, feed every row group through ``indexers`` and
    keep the pickled index map in the footer; returns the map.
    ``spark_context`` is taken for the reference's signature and unused
    (the scan runs on a thread pool); ``storage_options`` other than None
    raises (local files only)."""
    if not indexers:
        raise ValueError('indexers must be a non-empty list')
    if storage_options is not None:
        raise ValueError('storage_options: only local files (or a filesystem= object) are in '
                         'this slice; HDFS and object stores are a later slice of the port '
                         '(ROADMAP.md, Queue A item 7, the storage bullet)')
    fs, path = get_filesystem_and_path(dataset_url, filesystem)
    schema = get_schema(fs, path)
    pieces = load_row_groups(fs, path)
    needed = sorted({name for ix in indexers for name in ix.get_field_names()})
    missing = [n for n in needed if n not in schema.fields]
    if missing:
        raise ValueError('Indexed fields %s not in schema' % missing)

    def scan(ordinal_piece):
        ordinal, piece = ordinal_piece
        with fs.open(piece.path, 'rb') as f:
            table = pq.ParquetFile(f).read_row_group(piece.row_group, columns=needed)
        return ordinal, [_decode_row(r, schema) for r in table.to_pylist()]

    with ThreadPoolExecutor(max_workers=8) as pool:
        for ordinal, rows in pool.map(scan, enumerate(pieces)):
            for indexer in indexers:
                indexer.build_index(rows, ordinal)
    index_map = {ix.index_name: ix for ix in indexers}
    _write_footer_key(fs, path, ROWGROUPS_INDEX_KEY,
                      zlib.compress(pickle.dumps(index_map, protocol=4)))
    return index_map


def get_row_group_indexes(fs, path):
    """The footer's ``{index_name: indexer}`` map, as this package's
    indexers."""
    arrow_schema = _read_common_metadata(fs, path)
    if arrow_schema is None or not arrow_schema.metadata \
            or ROWGROUPS_INDEX_KEY not in arrow_schema.metadata:
        raise MetadataError('Dataset at %r has no row-group index (footer key %s); run '
                            'build_rowgroup_index first' % (path, ROWGROUPS_INDEX_KEY))
    return _loads_index(arrow_schema.metadata[ROWGROUPS_INDEX_KEY])


def _write_footer_key(fs, path, key, value):
    arrow_schema = _read_common_metadata(fs, path)
    if arrow_schema is None:
        raise MetadataError('Dataset at %r has no _common_metadata' % (path,))
    metadata = dict(arrow_schema.metadata or {})
    metadata[key] = value
    with fs.open(posixpath.join(path, _COMMON_METADATA), 'wb') as out:
        pq.write_metadata(arrow_schema.with_metadata(metadata), out)

"""The layout rewrite job: re-shard a hot dataset to zero waste.

Counterpart of ``petastorm_tpu/materialize/rewrite.py``.  The ingest
plane's coalesced range plans (:mod:`petastorm_tpu_torch.ingest.planner`)
fetch waste bytes when a layout interleaves unselected columns between
selected ones, or when row groups are sized against the split geometry.
:func:`rewrite_layout` copies a dataset's stored cells through
:func:`write_rows` into a new dataset whose row groups match the requested
geometry and whose files hold only the selected columns; :func:`layout_stats`
is the before and after evidence, and the trigger (``waste_pct``).

:func:`write_rows` is the one row sink of every offline write: one
:class:`~petastorm_tpu_torch.etl.dataset_metadata.DatasetWriter`
configuration, so two jobs given the same rows and geometry write the same
layout.  No torch.
"""

import logging

logger = logging.getLogger(__name__)

__all__ = ['write_rows', 'layout_stats', 'rewrite_layout']


def write_rows(output_url, schema, rows, rows_per_rowgroup=None, rowgroup_size_mb=None,
               rows_per_file=None, storage_options=None, filesystem=None,
               compression='snappy', encoded=False):
    """Stream ``rows`` (an iterable of row dicts) into a new dataset; the
    count of rows written.  ``encoded=True``: the rows hold their cells in
    stored form already (:meth:`DatasetWriter.write_encoded`)."""
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
    count = 0

    def counted():
        nonlocal count
        for row in rows:
            count += 1
            yield row

    kwargs = {}
    if rows_per_rowgroup is not None:
        kwargs['rows_per_rowgroup'] = rows_per_rowgroup
    elif rowgroup_size_mb is not None:
        kwargs['rowgroup_size_mb'] = rowgroup_size_mb
    with DatasetWriter(output_url, schema, rows_per_file=rows_per_file,
                       compression=compression, storage_options=storage_options,
                       filesystem=filesystem, **kwargs) as writer:
        if encoded:
            for row in counted():
                writer.write_encoded(row)
        else:
            writer.write_many(counted())
    return count


def layout_stats(dataset_url, columns=None, storage_options=None, filesystem=None,
                 merge_gap=None, max_range_bytes=None):
    """The gap and waste accounting of a dataset's current layout as the
    ingest plane would plan it: per row group, the raw column-chunk ranges
    of the selected ``columns`` against the coalesced reads, summed over the
    dataset through :func:`~petastorm_tpu_torch.ingest.planner.plan_stats`.

    ``{'files', 'row_groups', 'rows', 'needed_bytes', 'fetched_bytes',
    'waste_bytes', 'waste_pct', 'requests', 'rows_per_row_group'}``."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.ingest import planner

    if storage_options is not None:
        raise ValueError('storage_options: only local files (or a filesystem= object) are in '
                         'this slice; HDFS and object stores are a later slice of the port '
                         '(ROADMAP.md, Queue A item 7, the storage bullet)')
    merge_gap = planner.DEFAULT_MERGE_GAP if merge_gap is None else int(merge_gap)
    max_range_bytes = planner.DEFAULT_MAX_RANGE_BYTES if max_range_bytes is None \
        else int(max_range_bytes)
    columns = set(columns) if columns is not None else None
    fs, path_or_paths = get_filesystem_and_path_or_paths(dataset_url, filesystem)
    paths = path_or_paths if isinstance(path_or_paths, list) else [path_or_paths]
    files = []
    for p in paths:
        files.extend(sorted({piece.path for piece in load_row_groups(fs, p)}))

    totals = {'files': 0, 'row_groups': 0, 'rows': 0, 'needed_bytes': 0, 'fetched_bytes': 0,
              'waste_bytes': 0, 'requests': 0}
    group_rows = []
    for path in files:
        with fs.open(path, 'rb') as handle:
            metadata = pq.ParquetFile(handle).metadata
        totals['files'] += 1
        for rg in range(metadata.num_row_groups):
            raw = planner.column_chunk_ranges(metadata, rg, columns)
            plan = planner.plan_stats(raw, planner.coalesce(raw, merge_gap, max_range_bytes))
            totals['row_groups'] += 1
            rows = metadata.row_group(rg).num_rows
            totals['rows'] += rows
            group_rows.append(rows)
            for key in ('needed_bytes', 'fetched_bytes', 'waste_bytes', 'requests'):
                totals[key] += plan[key]
    totals['waste_pct'] = (round(100.0 * totals['waste_bytes'] / totals['fetched_bytes'], 2)
                           if totals['fetched_bytes'] else 0.0)
    totals['rows_per_row_group'] = {
        'min': min(group_rows) if group_rows else 0,
        'max': max(group_rows) if group_rows else 0,
        'mean': round(float(sum(group_rows)) / len(group_rows), 1) if group_rows else 0.0}
    return totals


def _partition_cell(field, value):
    """A hive directory's value as the cell of a scalar field of its dtype."""
    import numpy as np
    dtype = np.dtype(field.numpy_dtype) if field is not None else np.dtype(object)
    return value if dtype.kind in ('U', 'S', 'O') else dtype.type(value).item()


def _stored_rows(fs, path, schema, selected, predicate):
    """The rows of a petastorm store in its row-group order, each cell as
    stored (no codec runs on it), the selected fields only; a predicate
    decodes its own fields to decide a row.  Hive partition values the view
    asks for and the file lacks come from the directory names."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    pred_fields = sorted(set(predicate.get_fields()) & set(schema.fields)) \
        if predicate is not None else []
    if predicate is not None and not pred_fields:
        raise ValueError('Predicate fields %s not in schema' % sorted(predicate.get_fields()))
    handles, files = [], {}
    try:
        for piece in load_row_groups(fs, path):
            pf = files.get(piece.path)
            if pf is None:
                handles.append(fs.open(piece.path, 'rb'))
                pf = files[piece.path] = pq.ParquetFile(handles[-1])
            physical = set(pf.schema_arrow.names)
            wanted = [n for n in dict.fromkeys(selected + pred_fields) if n in physical]
            table = pf.read_row_group(piece.row_group, columns=wanted)
            injected = {k: _partition_cell(schema.fields.get(k), v)
                        for k, v in piece.partition_values if k not in physical}
            for row in table.to_pylist():
                row.update(injected)
                if predicate is not None:
                    cells = {}
                    for name in pred_fields:
                        field, value = schema.fields[name], row.get(name)
                        cells[name] = value if value is None or name in injected \
                            else field.codec_or_default.decode(field, value)
                    if not predicate.do_include(cells):
                        continue
                yield {name: row.get(name) for name in selected}
    finally:
        for handle in handles:
            handle.close()


def rewrite_layout(source_url, output_url, rows_per_rowgroup, columns=None, predicate=None,
                   overwrite=False, storage_options=None, reader_kwargs=None):
    """Re-shard ``source_url`` into ``output_url`` with row groups of
    ``rows_per_rowgroup`` rows, keeping only ``columns`` (None: all) and the
    rows ``predicate`` keeps.

    The cells are copied as stored, in the store's row-group order, through
    :func:`write_rows` (the JAX package's rewrite decodes each row through
    its reader and encodes it again, which changes a lossy codec's cells:
    here a JPEG image decodes to the same pixels before and after).
    ``reader_kwargs`` is the JAX signature's and raises when given: no
    reader runs.  A summary with :func:`layout_stats` of the selected
    columns before and after."""
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path
    from petastorm_tpu_torch.unischema import Unischema

    if storage_options is not None:
        raise ValueError('storage_options: only local files (or a filesystem= object) are in '
                         'this slice; HDFS and object stores are a later slice of the port '
                         '(ROADMAP.md, Queue A item 7, the storage bullet)')
    if reader_kwargs:
        raise ValueError('rewrite_layout copies the stored cells and runs no reader; '
                         'reader_kwargs %s would not be read' % sorted(reader_kwargs))
    fs, target_path = get_filesystem_and_path(output_url)
    if fs.exists(target_path) and fs.find(target_path):
        if not overwrite:
            raise ValueError('target %r exists; pass overwrite=True' % (output_url,))
        fs.rm(target_path, recursive=True)
    source_fs, source_path = get_filesystem_and_path(source_url)
    stored_schema = get_schema(source_fs, source_path)
    schema = stored_schema.create_schema_view(list(columns)) if columns is not None \
        else stored_schema
    schema = Unischema(stored_schema.name, list(schema.fields.values()))
    selected = list(schema.fields)

    before = layout_stats(source_url, columns=selected)
    rows = write_rows(output_url, schema,
                      _stored_rows(source_fs, source_path, stored_schema, selected, predicate),
                      rows_per_rowgroup=int(rows_per_rowgroup), encoded=True)
    after = layout_stats(output_url, columns=selected)
    summary = {'rows': rows, 'rows_per_rowgroup': int(rows_per_rowgroup), 'columns': selected,
               'output_url': output_url, 'before': before, 'after': after,
               'waste_bytes_saved': before['waste_bytes'] - after['waste_bytes']}
    logger.info('rewrite_layout: %d rows -> %s; waste %d -> %d bytes (%.1f%% -> %.1f%%)',
                rows, output_url, before['waste_bytes'], after['waste_bytes'],
                before['waste_pct'], after['waste_pct'])
    return summary

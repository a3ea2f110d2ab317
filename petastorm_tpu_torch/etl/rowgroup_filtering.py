"""``filters=`` support: prune row groups by Parquet statistics and hive
partition values before any data I/O.

Counterpart of ``petastorm_tpu/etl/rowgroup_filtering.py``: the DNF filter
expressions are evaluated against each row group's min/max footer
statistics and exactly against its partition values, when the reader is
built.  The prune is conservative: a kept row group may still hold rows
that do not match (a predicate filters rows).

Filter format (pyarrow-compatible DNF): ``[(col, op, value), ...]`` (ANDed)
or ``[[...], [...]]`` (OR of ANDs); ops: ``= == != < > <= >= in not in``.
"""


import pyarrow.parquet as pq

__all__ = ['apply_arrow_filters']


def apply_arrow_filters(fs, pieces, filters, schema):
    if not filters:
        return pieces
    dnf = _normalize_dnf(filters)
    stats = _StatisticsReader(fs)
    return [p for p in pieces if _piece_matches(p, dnf, stats)]


def _normalize_dnf(filters):
    if not isinstance(filters, list) or not filters:
        raise ValueError('filters must be a non-empty list')
    if isinstance(filters[0], tuple):
        return [filters]
    return filters


class _StatisticsReader(object):
    """Caches per-file parquet metadata; returns {column: (min, max, has_nulls)}."""

    def __init__(self, fs):
        self._fs = fs
        self._cache = {}

    def row_group_stats(self, path, row_group):
        md = self._cache.get(path)
        if md is None:
            with self._fs.open(path, 'rb') as f:
                md = pq.ParquetFile(f).metadata
            self._cache[path] = md
        rg = md.row_group(row_group)
        stats = {}
        for i in range(rg.num_columns):
            col = rg.column(i)
            s = col.statistics
            if s is not None and s.has_min_max:
                stats[col.path_in_schema] = (s.min, s.max)
        return stats


def _piece_matches(piece, dnf, stats_reader):
    partition_values = dict(piece.partition_values)
    stats = None
    for conjunction in dnf:
        ok = True
        for col, op, value in conjunction:
            if col in partition_values:
                if not _evaluate_exact(partition_values[col], op, value):
                    ok = False
                    break
                continue
            if stats is None:
                stats = stats_reader.row_group_stats(piece.path, piece.row_group)
            rng = stats.get(col)
            if rng is None:
                continue  # no statistics: cannot prune, keep conservative
            if not _range_may_match(rng, op, value):
                ok = False
                break
        if ok:
            return True
    return False


def _evaluate_exact(actual, op, value):
    # Hive partition values are strings on disk; coerce the string to the
    # comparand's type (or the type of a set element for in/not-in).
    template = next(iter(value), None) if isinstance(value, (list, set, tuple)) else value
    value_cast = _coerce_like(template, actual) if template is not None else actual
    if op in ('=', '=='):
        return value_cast == value
    if op == '!=':
        return value_cast != value
    if op == '<':
        return value_cast < value
    if op == '>':
        return value_cast > value
    if op == '<=':
        return value_cast <= value
    if op == '>=':
        return value_cast >= value
    if op == 'in':
        return value_cast in value
    if op == 'not in':
        return value_cast not in value
    raise ValueError('Unsupported filter op %r' % (op,))


def _coerce_like(template, actual):
    try:
        return type(template)(actual)
    except (TypeError, ValueError):
        return actual


def _range_may_match(rng, op, value):
    lo, hi = rng
    try:
        if op in ('=', '=='):
            return lo <= value <= hi
        if op == '!=':
            return not (lo == value == hi)
        if op == '<':
            return lo < value
        if op == '>':
            return hi > value
        if op == '<=':
            return lo <= value
        if op == '>=':
            return hi >= value
        if op == 'in':
            return any(lo <= v <= hi for v in value)
        if op == 'not in':
            return not all(lo == v == hi for v in value)
    except TypeError:
        return True  # incomparable types: keep conservative
    raise ValueError('Unsupported filter op %r' % (op,))

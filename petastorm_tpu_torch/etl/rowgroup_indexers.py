"""Indexers: scan decoded rows into ``value -> {row-group ordinals}`` maps.

Counterpart of ``petastorm_tpu/etl/rowgroup_indexers.py`` (upstream
petastorm's ``SingleFieldIndexer``).  The attribute names are the JAX
package's, so that an index pickled by either package reads in the other
(:func:`~petastorm_tpu_torch.etl.rowgroup_indexing.get_row_group_indexes`
maps the class paths); an upstream index's ``_column_name`` is taken as the
field.  Standard library only.
"""

from collections import defaultdict

__all__ = ['SingleFieldIndexer', 'FieldNotPresentError']


class FieldNotPresentError(ValueError):
    pass


class SingleFieldIndexer(object):
    """An inverted index over one field: ``value -> {row-group ordinals}``."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._index_field = index_field
        self._index_data = defaultdict(set)

    @property
    def index_name(self):
        return self._index_name

    @property
    def index_field(self):
        return self._index_field

    def get_field_names(self):
        """The fields this indexer reads (the scan reads only these)."""
        return [self._index_field]

    def build_index(self, decoded_rows, piece_ordinal):
        if not decoded_rows:
            return
        for row in decoded_rows:
            if self._index_field not in row:
                raise FieldNotPresentError(
                    'Field %r not present while indexing' % (self._index_field,))
            value = row[self._index_field]
            if value is not None:
                self._index_data[value].add(piece_ordinal)

    def indexed_values(self):
        return list(self._index_data.keys())

    def get_row_group_indexes(self, value_key=None):
        if value_key is None:
            out = set()
            for groups in self._index_data.values():
                out |= groups
            return out
        return self._index_data.get(value_key, set())

    def __getstate__(self):
        # a plain dict in the footer blob, as the JAX package pickles it
        state = self.__dict__.copy()
        state['_index_data'] = dict(self._index_data)
        return state

    def __setstate__(self, state):
        state = dict(state)
        if '_index_field' not in state and '_column_name' in state:
            state['_index_field'] = state.pop('_column_name')   # an upstream index
        self.__dict__.update(state)
        self._index_data = defaultdict(set, self._index_data)

"""Row-group selectors: pruning at reader start through the stored indexes.

Counterpart of ``petastorm_tpu/selectors.py`` (upstream petastorm's
``RowGroupSelectorBase``, ``SingleIndexSelector``, ``IntersectIndexSelector``
and ``UnionIndexSelector``): set algebra over row-group ordinal sets of the
footer's inverted indexes
(:mod:`~petastorm_tpu_torch.etl.rowgroup_indexing`), evaluated before any
data is read.  Pass one as ``make_reader(..., rowgroup_selector=...)``.
Standard library only.
"""

__all__ = ['RowGroupSelectorBase', 'SingleIndexSelector', 'IntersectIndexSelector',
           'UnionIndexSelector']


class RowGroupSelectorBase(object):
    def get_index_names(self):
        """The names of the footer indexes this selector reads."""
        raise NotImplementedError()

    def select_row_groups(self, index_dict):
        """``index_dict``: ``{index_name: indexer}``; the set of selected
        row-group ordinals."""
        raise NotImplementedError()


class SingleIndexSelector(RowGroupSelectorBase):
    """The row groups holding any of ``values_list`` by one index."""

    def __init__(self, index_name, values_list):
        self._index_name = index_name
        self._values = list(values_list)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, index_dict):
        indexer = index_dict.get(self._index_name)
        if indexer is None:
            raise ValueError('Dataset has no index named %r (available: %s)'
                             % (self._index_name, sorted(index_dict)))
        out = set()
        for value in self._values:
            out |= indexer.get_row_group_indexes(value)
        return out


class _CompositeSelector(RowGroupSelectorBase):
    def __init__(self, selectors):
        self._selectors = list(selectors)
        if not self._selectors:
            raise ValueError('selector list must be non-empty')

    def get_index_names(self):
        return [name for s in self._selectors for name in s.get_index_names()]


class IntersectIndexSelector(_CompositeSelector):
    """The row groups every child selector selects."""

    def select_row_groups(self, index_dict):
        result = None
        for selector in self._selectors:
            groups = selector.select_row_groups(index_dict)
            result = groups if result is None else (result & groups)
        return result


class UnionIndexSelector(_CompositeSelector):
    """The row groups any child selector selects."""

    def select_row_groups(self, index_dict):
        result = set()
        for selector in self._selectors:
            result |= selector.select_row_groups(index_dict)
        return result

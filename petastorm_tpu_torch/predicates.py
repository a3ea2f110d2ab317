"""Row-level predicates evaluated inside reader workers with column pruning.

Counterpart of ``petastorm_tpu/predicates.py``, copied whole: a worker
first reads only the ``get_fields()`` columns, evaluates ``do_include`` per
row, then reads the remaining columns for the rows that pass (see
:mod:`petastorm_tpu_torch.py_dict_reader_worker` and
:mod:`petastorm_tpu_torch.arrow_reader_worker`).  ``in_pseudorandom_split``
puts every value in the JAX package's bucket (md5 of its ``str``).

Distinct from ``filters=``, which prune row groups by footer statistics and
partition values when the reader is built
(:mod:`petastorm_tpu_torch.etl.rowgroup_filtering`).  Nothing here imports
torch: the process pool's children unpickle predicates.
"""

import hashlib

__all__ = ['PredicateBase', 'in_set', 'in_intersection', 'in_negate',
           'in_lambda', 'in_pseudorandom_split', 'in_reduce']


class PredicateBase(object):
    def get_fields(self):
        """Field names needed to evaluate the predicate (read first)."""
        raise NotImplementedError()

    def do_include(self, values):
        """``values``: dict of the ``get_fields()`` columns for one row."""
        raise NotImplementedError()


class in_set(PredicateBase):
    """Keep rows whose ``predicate_field`` value is in ``inclusion_values``."""

    def __init__(self, inclusion_values, predicate_field):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        return values[self._predicate_field] in self._inclusion_values


class in_intersection(PredicateBase):
    """Keep rows where any element of a (list-valued) field intersects
    ``inclusion_values``."""

    def __init__(self, inclusion_values, predicate_field):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        value = values[self._predicate_field]
        try:
            return bool(self._inclusion_values.intersection(value))
        except TypeError:
            return value in self._inclusion_values


class in_negate(PredicateBase):
    """Logical NOT of another predicate."""

    def __init__(self, predicate):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)


class in_reduce(PredicateBase):
    """Combine predicates with a reduction (e.g. ``all``/``any``).

    Parity: ``petastorm/predicates.py :: in_reduce``.
    """

    def __init__(self, predicate_list, reduce_func):
        self._predicates = list(predicate_list)
        self._reduce_func = reduce_func

    def get_fields(self):
        fields = set()
        for p in self._predicates:
            fields |= set(p.get_fields())
        return fields

    def do_include(self, values):
        return self._reduce_func([p.do_include(values) for p in self._predicates])


class in_lambda(PredicateBase):
    """Arbitrary user function over the named fields."""

    def __init__(self, predicate_fields, predicate_func, state_arg=None):
        self._fields = list(predicate_fields)
        self._func = predicate_func
        self._state_arg = state_arg

    def get_fields(self):
        return set(self._fields)

    def do_include(self, values):
        if self._state_arg is not None:
            return self._func(values, self._state_arg)
        return self._func(values)


class in_pseudorandom_split(PredicateBase):
    """Deterministic hash-based dataset split (e.g. train/val).

    ``fraction_list`` are bucket sizes summing to <= 1.0;
    ``subset_index`` selects the bucket; the hash of ``predicate_field``'s
    value places each row in a bucket — stable across runs and processes.
    """

    def __init__(self, fraction_list, subset_index, predicate_field):
        if not 0 <= subset_index < len(fraction_list):
            raise ValueError('subset_index %d out of range for %d fractions'
                             % (subset_index, len(fraction_list)))
        self._fractions = list(fraction_list)
        self._subset_index = subset_index
        self._predicate_field = predicate_field
        lo = sum(self._fractions[:subset_index])
        hi = lo + self._fractions[subset_index]
        self._lo, self._hi = lo, hi

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        value = values[self._predicate_field]
        digest = hashlib.md5(str(value).encode('utf-8')).hexdigest()
        fraction = int(digest[:16], 16) / float(1 << 64)
        return self._lo <= fraction < self._hi

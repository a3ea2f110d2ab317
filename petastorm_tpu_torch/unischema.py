"""Unischema: a single-source-of-truth schema with numpy and pyarrow
projections.

Counterpart of ``petastorm_tpu/unischema.py`` without its JAX projection
(``field_shape_dtype_struct``) and its Spark projections.
:meth:`Unischema.from_arrow_schema` infers a schema from a plain Parquet
store's arrow schema for the batch reader.  Instances pickle exactly as the
JAX package's do, so footers written by either package read in the other.
"""

import re
from collections import OrderedDict, namedtuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import ScalarCodec, _arrow_type_for_numpy

__all__ = [
    'Unischema',
    'UnischemaField',
    'encode_row',
    'insert_explicit_nulls',
    'match_unischema_fields',
]


_DEFAULT_SCALAR_CODECS = {}  # dtype.str -> ScalarCodec (see codec_or_default)


class UnischemaField(namedtuple('UnischemaField', ['name', 'numpy_dtype', 'shape', 'codec', 'nullable'])):
    """A single field: ``(name, numpy_dtype, shape, codec, nullable)``.

    ``shape`` is a tuple; ``None`` entries are wildcard dimensions.
    ``codec=None`` means "native scalar column" and implies ``shape == ()``.
    """

    __slots__ = ()

    def __new__(cls, name, numpy_dtype, shape=(), codec=None, nullable=False):
        if shape is None:
            shape = ()
        shape = tuple(shape)
        if codec is None and len(shape) > 0:
            raise ValueError('Field %r has non-scalar shape %r but no codec' % (name, shape))
        return super(UnischemaField, cls).__new__(cls, name, numpy_dtype, shape, codec, nullable)

    @property
    def codec_or_default(self):
        """Effective codec: an inferred ``ScalarCodec`` when ``codec is None``
        (cached per dtype: this is read per cell in the decode path)."""
        if self.codec is not None:
            return self.codec
        dtype = np.dtype(self.numpy_dtype)
        codec = _DEFAULT_SCALAR_CODECS.get(dtype.str)
        if codec is None:
            codec = _DEFAULT_SCALAR_CODECS[dtype.str] = ScalarCodec(dtype)
        return codec

    def __eq__(self, other):
        if not isinstance(other, UnischemaField):
            return NotImplemented
        return (self.name == other.name
                and np.dtype(self.numpy_dtype) == np.dtype(other.numpy_dtype)
                and self.shape == other.shape
                and self.codec == other.codec
                and self.nullable == other.nullable)

    def __ne__(self, other):
        result = self.__eq__(other)
        return result if result is NotImplemented else not result

    def __hash__(self):
        return hash((self.name, np.dtype(self.numpy_dtype).str, self.shape, self.nullable))


class Unischema(object):
    """An ordered collection of :class:`UnischemaField`: attribute access per
    field, ``create_schema_view``, namedtuple row types, arrow projection."""

    def __init__(self, name, fields):
        self._name = name
        self._fields = OrderedDict((f.name, f) for f in sorted(fields, key=lambda f: f.name))
        self._namedtuple = None

    def __getattr__(self, item):
        fields = self.__dict__.get('_fields')
        if fields is not None and item in fields:
            return fields[item]
        raise AttributeError('Schema %r has no field %r' % (self.__dict__.get('_name'), item))

    @property
    def fields(self):
        return self._fields

    @property
    def name(self):
        return self._name

    def create_schema_view(self, fields):
        """Sub-schema selection: ``fields`` mixes :class:`UnischemaField`
        instances and regex strings (full-matched against field names)."""
        frozen = []
        patterns = []
        for f in fields:
            if isinstance(f, UnischemaField):
                if f.name not in self._fields:
                    raise ValueError('Field %r does not belong to schema %r' % (f.name, self._name))
                frozen.append(f)
            elif isinstance(f, str):
                patterns.append(f)
            else:
                raise ValueError('create_schema_view accepts UnischemaField or str, got %r' % (f,))
        matched = match_unischema_fields(self, patterns) if patterns else []
        view_fields = {f.name: f for f in matched}
        view_fields.update({f.name: f for f in frozen})
        return Unischema('%s_view' % self._name, list(view_fields.values()))

    def make_namedtuple(self, **kwargs):
        """A row of this schema's namedtuple type."""
        return self._get_namedtuple()(**kwargs)

    def make_namedtuple_from_dict(self, row):
        return self._get_namedtuple()(**{k: row.get(k) for k in self._fields})

    def _get_namedtuple(self):
        if self.__dict__.get('_namedtuple') is None:
            self._namedtuple = namedtuple(self._name, list(self._fields))
        return self._namedtuple

    def __setstate__(self, state):
        # An upstream pickle's state: ``_name``, ``_fields`` and one
        # attribute per field, with no namedtuple cache.
        self.__dict__.update(state)
        self.__dict__.setdefault('_namedtuple', None)
        if not isinstance(self.__dict__.get('_fields'), OrderedDict):
            self.__dict__['_fields'] = OrderedDict(self.__dict__.get('_fields') or {})

    def as_arrow_schema(self):
        """Storage projection: one pyarrow field per Unischema field, typed by
        the field codec's storage type."""
        return pa.schema([
            pa.field(f.name, f.codec_or_default.arrow_dtype(), nullable=bool(f.nullable))
            for f in self._fields.values()
        ])

    @classmethod
    def from_arrow_schema(cls, arrow_schema, omit_unsupported_fields=True):
        """A scalar Unischema inferred from a plain Parquet store's arrow
        schema (the batch reader's path): a list column becomes a ``(None,)``
        field of its value type, string, binary and decimal columns object
        fields, timestamps and dates ``datetime64[ns]``; a column of another
        type is omitted (or raises, with ``omit_unsupported_fields=False``)."""
        fields = []
        for arrow_field in arrow_schema:
            np_dtype = _numpy_dtype_for_arrow(arrow_field.type)
            if np_dtype is None:
                if omit_unsupported_fields:
                    continue
                raise ValueError('Unsupported arrow type %r for field %r'
                                 % (arrow_field.type, arrow_field.name))
            if pa.types.is_list(arrow_field.type) or pa.types.is_large_list(arrow_field.type):
                fields.append(UnischemaField(arrow_field.name, np_dtype, (None,),
                                             codec=_PassthroughListCodec(np_dtype),
                                             nullable=arrow_field.nullable))
            else:
                fields.append(UnischemaField(arrow_field.name, np_dtype, (),
                                             codec=None, nullable=arrow_field.nullable))
        return cls('inferred', fields)

    def __str__(self):
        return 'Unischema(%s, %s)' % (self._name, list(self._fields))

    __repr__ = __str__

    def __eq__(self, other):
        return (isinstance(other, Unischema)
                and list(self._fields.values()) == list(other._fields.values()))

    def __hash__(self):
        return hash(tuple(self._fields))

    def __reduce__(self):
        # Stable pickling independent of the lazily-built namedtuple cache.
        return (self.__class__, (self._name, list(self._fields.values())))


class _PassthroughListCodec(object):
    """The codec of an inferred list column (batch path): cells are arrow
    lists, decoded to arrays of the value type."""

    def __init__(self, np_dtype):
        self._np_dtype = np.dtype(np_dtype)

    def encode(self, unischema_field, value):
        return np.asarray(value, dtype=self._np_dtype).tolist()

    def decode(self, unischema_field, value):
        return np.asarray(value, dtype=self._np_dtype)

    def arrow_dtype(self):
        return pa.list_(_arrow_type_for_numpy(self._np_dtype))

    def __eq__(self, other):
        return isinstance(other, _PassthroughListCodec) and self._np_dtype == other._np_dtype

    def __hash__(self):
        return hash(('_PassthroughListCodec', self._np_dtype.str))


def _numpy_dtype_for_arrow(arrow_type):
    """The numpy dtype of an arrow column's values, or None when it has
    none."""
    try:
        if pa.types.is_list(arrow_type) or pa.types.is_large_list(arrow_type):
            return _numpy_dtype_for_arrow(arrow_type.value_type)
        if pa.types.is_string(arrow_type) or pa.types.is_large_string(arrow_type) \
                or pa.types.is_binary(arrow_type) or pa.types.is_large_binary(arrow_type) \
                or pa.types.is_decimal(arrow_type):
            return np.dtype('O')
        if pa.types.is_timestamp(arrow_type) or pa.types.is_date(arrow_type):
            return np.dtype('datetime64[ns]')
        return np.dtype(arrow_type.to_pandas_dtype())
    except (NotImplementedError, TypeError):
        return None


def match_unischema_fields(schema, field_regex):
    """Schema fields whose names full-match any of ``field_regex``."""
    if isinstance(field_regex, str):
        field_regex = [field_regex]
    compiled = [re.compile(p) for p in field_regex]
    return [f for name, f in schema.fields.items()
            if any(c.fullmatch(name) for c in compiled)]


def insert_explicit_nulls(unischema, row_dict):
    """Set each nullable field missing from ``row_dict`` to None, in place;
    a missing field that is not nullable raises.  Returns ``row_dict``."""
    for name, field in unischema.fields.items():
        if name not in row_dict or row_dict[name] is None:
            if field.nullable:
                row_dict[name] = None
            else:
                raise ValueError('Field %r is not nullable but is missing from the row' % (name,))
    return row_dict


def encode_row(unischema, row_dict):
    """Encode a ``{field: numpy value}`` dict to storable cells (the
    dataset writer's per-row step)."""
    unknown = set(row_dict.keys()) - set(unischema.fields.keys())
    if unknown:
        raise ValueError('Rows contain fields not in schema %r: %s' % (unischema.name, sorted(unknown)))
    encoded = {}
    for name, field in unischema.fields.items():
        if name not in row_dict or row_dict[name] is None:
            if not field.nullable:
                raise ValueError('Field %r is not nullable but got None' % (name,))
            encoded[name] = None
        else:
            value = row_dict[name]
            # Shape compliance at write time: a wrong-shape cell would encode
            # fine and poison the fixed-shape columnar decode at read time.
            if field.shape and isinstance(value, np.ndarray):
                ok = (value.ndim == len(field.shape)
                      and all(exp is None or exp == got
                              for exp, got in zip(field.shape, value.shape)))
                if not ok:
                    raise ValueError(
                        'Field %r expects shape %r, got %r'
                        % (name, field.shape, value.shape))
            encoded[name] = field.codec_or_default.encode(field, value)
    return encoded

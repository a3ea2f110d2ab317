"""Unischema: a single-source-of-truth schema with numpy and pyarrow
projections.

Counterpart of ``petastorm_tpu/unischema.py`` without its JAX projection
(``field_shape_dtype_struct``), its Spark projections and the inferred
list codec of the batch reader (a later slice).  Instances pickle exactly as
the JAX package's do, so footers written by either package read in the
other.
"""

import re
from collections import OrderedDict, namedtuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import ScalarCodec

__all__ = [
    'Unischema',
    'UnischemaField',
    'encode_row',
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

    def make_namedtuple_from_dict(self, row):
        return self._get_namedtuple()(**{k: row.get(k) for k in self._fields})

    def _get_namedtuple(self):
        if self._namedtuple is None:
            self._namedtuple = namedtuple(self._name, list(self._fields))
        return self._namedtuple

    def as_arrow_schema(self):
        """Storage projection: one pyarrow field per Unischema field, typed by
        the field codec's storage type."""
        return pa.schema([
            pa.field(f.name, f.codec_or_default.arrow_dtype(), nullable=bool(f.nullable))
            for f in self._fields.values()
        ])

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


def match_unischema_fields(schema, field_regex):
    """Schema fields whose names full-match any of ``field_regex``."""
    if isinstance(field_regex, str):
        field_regex = [field_regex]
    compiled = [re.compile(p) for p in field_regex]
    return [f for name, f in schema.fields.items()
            if any(c.fullmatch(name) for c in compiled)]


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

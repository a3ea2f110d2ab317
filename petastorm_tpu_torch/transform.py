"""User preprocessing pushed into reader workers.

Counterpart of ``petastorm_tpu/transform.py``: ``TransformSpec`` and
``transform_schema``.  The declarative ``ResizeImages`` (fused into the
native decode plane) comes with that plane in a later slice.  The transform
runs in the decode workers, off the training thread; on the row path
``func`` gets a ``dict``.
"""

from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['TransformSpec', 'transform_schema']


class TransformSpec(object):
    """Describes a worker-side transform and its effect on the schema.

    ``func``: ``dict -> dict`` per row.  ``edit_fields``: list of
    ``UnischemaField`` (or 4/5-tuples ``(name, numpy_dtype, shape, [codec,]
    nullable)``) added/modified by func.  ``removed_fields``: field names
    func drops.  (The JAX package's ``selected_fields`` projection is a later
    slice.)
    """

    def __init__(self, func=None, edit_fields=None, removed_fields=None):
        self.func = func
        self.edit_fields = [self._normalize(f) for f in (edit_fields or [])]
        self.removed_fields = list(removed_fields or [])

    @property
    def cache_token(self):
        """Identity of this transform inside result-cache keys (worker caches
        store post-transform payloads)."""
        if self.func is None and not self.removed_fields:
            return None
        func_id = None if self.func is None else '%s.%s' % (
            getattr(self.func, '__module__', '?'),
            getattr(self.func, '__qualname__',
                    getattr(self.func, '__name__', repr(self.func))))
        return 'f=%s;e=%s;r=%s' % (
            func_id, sorted(f.name for f in self.edit_fields), sorted(self.removed_fields))

    @staticmethod
    def _normalize(field):
        if isinstance(field, UnischemaField):
            return field
        if isinstance(field, (tuple, list)):
            if len(field) == 4:
                name, dtype, shape, nullable = field
                shape = tuple(shape) if shape is not None else ()
                codec = None if shape == () else _default_tensor_codec()
                return UnischemaField(name, dtype, shape, codec, nullable)
            if len(field) == 5:
                return UnischemaField(*field)
        raise ValueError('edit_fields entries must be UnischemaField or 4/5-tuples, got %r' % (field,))


def _default_tensor_codec():
    from petastorm_tpu_torch.codecs import NdarrayCodec
    return NdarrayCodec()


def transform_schema(schema, transform_spec):
    """The post-transform schema, computed without running ``func``."""
    removed = set(transform_spec.removed_fields)
    fields = {name: f for name, f in schema.fields.items() if name not in removed}
    for f in transform_spec.edit_fields:
        fields[f.name] = f
    return Unischema(schema.name + '_transformed', list(fields.values()))

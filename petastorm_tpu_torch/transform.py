"""User preprocessing pushed into reader workers.

Counterpart of ``petastorm_tpu/transform.py``: ``TransformSpec``, the
declarative ``ResizeImages`` (fused into the native decode plane) and
``transform_schema``.  The transform runs in the decode workers, off the
training thread; on the row path ``func`` gets a ``dict``, on the batch
path (``make_batch_reader``) a ``pandas.DataFrame``.  Under the process
pool it must be picklable: a module-level function or callable class.
"""

from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['TransformSpec', 'ResizeImages', 'transform_schema']


class TransformSpec(object):
    """Describes a worker-side transform and its effect on the schema.

    ``func``: ``dict -> dict`` per row on the row path, ``DataFrame ->
    DataFrame`` on the batch path (where it may drop rows).
    ``edit_fields``: list of ``UnischemaField`` (or 4/5-tuples ``(name,
    numpy_dtype, shape, [codec,] nullable)``) added/modified by func.
    ``removed_fields``: field names func drops.  ``selected_fields``: the
    fields kept after func (None keeps all).
    """

    def __init__(self, func=None, edit_fields=None, removed_fields=None, selected_fields=None):
        self.func = func
        self.edit_fields = [self._normalize(f) for f in (edit_fields or [])]
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None

    @property
    def cache_token(self):
        """Identity of this transform inside result-cache keys (worker caches
        store post-transform payloads)."""
        if self.func is None and not self.removed_fields and self.selected_fields is None:
            return None
        func_id = None if self.func is None else '%s.%s' % (
            getattr(self.func, '__module__', '?'),
            getattr(self.func, '__qualname__',
                    getattr(self.func, '__name__', repr(self.func))))
        return 'f=%s;e=%s;r=%s;s=%s' % (
            func_id, sorted(f.name for f in self.edit_fields), sorted(self.removed_fields),
            None if self.selected_fields is None else sorted(self.selected_fields))

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

    def schema_edit_fields(self, schema):
        """The fields this transform adds or changes in ``schema``."""
        return self.edit_fields


class ResizeImages(TransformSpec):
    """Declared image resize, which the columnar decode fuses.

    ``ResizeImages({'image': (224, 224)})`` does what a ``TransformSpec``
    whose func cv2-resizes the named fields does (``codecs.resize_image_cell``),
    but because the intent is declared, the columnar path keeps decoding
    whole columns: the image column decodes straight into a batch of the
    target shape through the native fused decode and resize, where an
    opaque ``func`` sends every row through Python.  The native path is
    within a couple of LSB of the cv2 path where the source decodes full
    size (reductions up to 2x, upscales); inside
    ``native.disabled()`` the two are equal bit for bit.  Target shapes
    reach the reader's schema.
    """

    def __init__(self, fields, removed_fields=None, selected_fields=None):
        self.resize_targets = {name: (int(hw[0]), int(hw[1])) for name, hw in dict(fields).items()}
        super(ResizeImages, self).__init__(func=self._resize_func, removed_fields=removed_fields,
                                           selected_fields=selected_fields)
        #: The func is exactly the declared resize: the columnar decode may
        #: fuse it instead of going row by row.
        self.columnar_fusable = True

    @property
    def cache_token(self):
        # The targets determine the payload, whichever path decoded it.
        return 'rz=%s;r=%s;s=%s' % (
            sorted(self.resize_targets.items()), sorted(self.removed_fields),
            None if self.selected_fields is None else sorted(self.selected_fields))

    def _resize_func(self, row):
        from petastorm_tpu_torch.codecs import resize_image_cell
        if hasattr(row, 'columns'):   # a DataFrame (the batch path)
            row = row.copy()
            for name, (h, w) in self.resize_targets.items():
                if name in row.columns:
                    row[name] = [resize_image_cell(a, h, w) for a in row[name]]
            return row
        out = dict(row)
        for name, (h, w) in self.resize_targets.items():
            if name in out:
                out[name] = resize_image_cell(out[name], h, w)
        return out

    def schema_edit_fields(self, schema):
        derived = []
        for name, (h, w) in self.resize_targets.items():
            base = schema.fields.get(name)
            if base is None or not base.shape:
                # A fully wildcard field (shape None): its rank and channels
                # are unknown, so it keeps its wildcard declaration.
                continue
            shape = (h, w) + tuple(base.shape[2:]) if len(base.shape) > 2 else (h, w)
            derived.append(UnischemaField(name, base.numpy_dtype, shape, base.codec,
                                          base.nullable))
        return list(self.edit_fields) + derived


def _default_tensor_codec():
    from petastorm_tpu_torch.codecs import NdarrayCodec
    return NdarrayCodec()


def transform_schema(schema, transform_spec):
    """The post-transform schema, computed without running ``func``."""
    removed = set(transform_spec.removed_fields)
    fields = {name: f for name, f in schema.fields.items() if name not in removed}
    for f in transform_spec.schema_edit_fields(schema):
        fields[f.name] = f
    selected = transform_spec.selected_fields
    if selected is not None:
        missing = set(selected) - set(fields)
        if missing:
            raise ValueError('selected_fields not in post-transform schema: %s' % sorted(missing))
        fields = {name: f for name, f in fields.items() if name in selected}
    return Unischema(schema.name + '_transformed', list(fields.values()))

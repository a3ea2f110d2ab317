"""Cell-level codecs: encode numpy values into Parquet-storable cells and back.

Counterpart of ``petastorm_tpu/codecs.py``: the scalar, ndarray,
compressed-ndarray and compressed-image codecs.  A static-shape column
decodes whole through the native decode plane (:mod:`petastorm_tpu_torch.native`)
where the library holds the codec's function, and cell by cell through
numpy and cv2 otherwise.  The Spark projections are left out.

Codecs are pickled into the dataset footer, so their instance state is the
JAX package's byte for byte: a dataset written by either package reads in
the other (``etl/dataset_metadata.py`` maps the module names).
"""

import io
import zlib

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.errors import DecodeFieldError

__all__ = [
    'DataframeColumnCodec',
    'ScalarCodec',
    'NdarrayCodec',
    'CompressedNdarrayCodec',
    'CompressedImageCodec',
    'resize_image_cell',
]


def resize_image_cell(arr, h, w):
    """The one resize every Python path uses (``ResizeImages``' row
    function, the columnar fallback, ``decode_resized_into``): cv2.resize
    INTER_LINEAR, with the trailing 1-channel dim cv2 drops restored.  The
    native fused path approximates it (see
    :func:`petastorm_tpu_torch.native.jpeg_decode_resize_batch`)."""
    import cv2
    if arr is None or not isinstance(arr, np.ndarray) or arr.shape[:2] == (h, w):
        return arr
    out = cv2.resize(arr, (w, h), interpolation=cv2.INTER_LINEAR)
    if arr.ndim == 3 and arr.shape[2] == 1:
        out = out[:, :, None]
    return out


class DataframeColumnCodec(object):
    """Abstract codec: value <-> storable cell."""

    def encode(self, unischema_field, value):
        raise NotImplementedError()

    def decode(self, unischema_field, value):
        raise NotImplementedError()

    def decode_into(self, unischema_field, value, dst):
        """Decode straight into a preallocated array slice ``dst``.

        The columnar decode path preallocates one ``(N, *shape)`` array per
        row group and hands each cell its ``batch[i]`` view; the default
        decodes then copies."""
        decoded = np.asarray(self.decode(unischema_field, value))
        if decoded.shape != dst.shape:
            # np.copyto would broadcast a (6,) cell over a (5, 6) slice.
            raise DecodeFieldError(
                'Field %r cell has shape %r, schema expects %r'
                % (unischema_field.name, decoded.shape, dst.shape))
        np.copyto(dst, decoded, casting='same_kind')

    def decode_batch_into(self, unischema_field, cells, dst):
        """Whole-column decode into ``dst`` (``cells``: a pyarrow binary
        column or a list of bytes); False sends the caller to the per-cell
        path."""
        return False

    def arrow_dtype(self):
        """pyarrow storage type of the encoded cell."""
        raise NotImplementedError()

    def __eq__(self, other):
        # Exact type match: a subclass may produce incompatible bytes.
        return type(other) is type(self) and self.__dict__ == other.__dict__

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((self.__class__.__name__, tuple(sorted(self.__dict__.items()))))


# -- scalar ------------------------------------------------------------------

_NUMPY_TO_ARROW = {
    np.dtype('bool'): pa.bool_(),
    np.dtype('int8'): pa.int8(),
    np.dtype('uint8'): pa.uint8(),
    np.dtype('int16'): pa.int16(),
    np.dtype('uint16'): pa.uint16(),
    np.dtype('int32'): pa.int32(),
    np.dtype('uint32'): pa.uint32(),
    np.dtype('int64'): pa.int64(),
    np.dtype('uint64'): pa.uint64(),
    np.dtype('float16'): pa.float16(),
    np.dtype('float32'): pa.float32(),
    np.dtype('float64'): pa.float64(),
}


def _arrow_type_for_numpy(np_dtype):
    np_dtype = np.dtype(np_dtype)
    if np_dtype in _NUMPY_TO_ARROW:
        return _NUMPY_TO_ARROW[np_dtype]
    if np_dtype.kind in ('U', 'S') or np_dtype == np.dtype(object):
        return pa.string()
    if np_dtype.kind == 'M':  # datetime64
        return pa.timestamp('ns')
    raise TypeError('No arrow mapping for numpy dtype %r' % (np_dtype,))


#: Spark SQL type class name -> arrow storage type (``DecimalType`` takes its
#: precision and scale from the instance).
_SPARK_TO_ARROW = {
    'BooleanType': pa.bool_(),
    'ByteType': pa.int8(),
    'ShortType': pa.int16(),
    'IntegerType': pa.int32(),
    'LongType': pa.int64(),
    'FloatType': pa.float32(),
    'DoubleType': pa.float64(),
    'StringType': pa.string(),
    'BinaryType': pa.binary(),
    'DateType': pa.date32(),
    'TimestampType': pa.timestamp('ns'),
}


class ScalarCodec(DataframeColumnCodec):
    """Stores a scalar natively in its Parquet column.

    Accepts a numpy dtype / dtype name, a ``pyarrow.DataType`` or a Spark SQL
    type instance (pyspark's, or the stub an upstream footer unpickles into
    without pyspark), normalized to a pyarrow storage type.
    """

    def __init__(self, storage_type):
        self._arrow_type = self._normalize(storage_type)

    def __setstate__(self, state):
        # An upstream petastorm pickle holds {'_spark_type': <Spark SQL type>}.
        if '_arrow_type' not in state and '_spark_type' in state:
            state = {'_arrow_type': self._normalize(state['_spark_type'])}
        self.__dict__.update(state)

    @staticmethod
    def _normalize(storage_type):
        if isinstance(storage_type, pa.DataType):
            return storage_type
        # a Spark SQL type, duck-typed so that pyspark stays optional
        type_name = type(storage_type).__name__
        if hasattr(storage_type, 'typeName'):
            if type_name in _SPARK_TO_ARROW:
                return _SPARK_TO_ARROW[type_name]
            if type_name == 'DecimalType':
                # Spark's defaults are precision 10, scale 0
                return pa.decimal128(getattr(storage_type, 'precision', 10),
                                     getattr(storage_type, 'scale', 0))
        return _arrow_type_for_numpy(storage_type)

    def encode(self, unischema_field, value):
        # 0-d arrays / numpy scalars -> python scalars so pyarrow builds a
        # native column.
        if isinstance(value, np.ndarray):
            if value.ndim != 0:
                raise ValueError('ScalarCodec can only encode scalars; field %r got shape %r'
                                 % (unischema_field.name, value.shape))
            value = value.item()
        if isinstance(value, np.generic):
            value = value.item()
        return value

    def decode(self, unischema_field, value):
        dtype = np.dtype(unischema_field.numpy_dtype)
        if dtype.kind == 'S':
            return value if isinstance(value, bytes) else str(value).encode('utf-8')
        if dtype.kind == 'U':
            return value if isinstance(value, str) else str(value)
        if dtype == np.dtype(object):
            return value
        return dtype.type(value)

    def arrow_dtype(self):
        return self._arrow_type

    def __eq__(self, other):
        return isinstance(other, ScalarCodec) and self._arrow_type == other._arrow_type

    def __hash__(self):
        return hash(('ScalarCodec', str(self._arrow_type)))


# -- ndarray -----------------------------------------------------------------

class NdarrayCodec(DataframeColumnCodec):
    """numpy array <-> ``np.save`` bytes in a binary Parquet cell."""

    def encode(self, unischema_field, value):
        expected = np.dtype(unischema_field.numpy_dtype)
        if value.dtype != expected:
            raise ValueError('Field %r expects dtype %r, got %r'
                             % (unischema_field.name, expected, value.dtype))
        memfile = io.BytesIO()
        np.save(memfile, value)
        return memfile.getvalue()

    def decode(self, unischema_field, value):
        # allow_pickle=False: cells are untrusted input at read time.
        arr = np.ascontiguousarray(np.load(io.BytesIO(value), allow_pickle=False))
        expected = np.dtype(unischema_field.numpy_dtype)
        if arr.dtype != expected and arr.dtype.kind == 'V' \
                and arr.dtype.itemsize == expected.itemsize:
            # Extension dtypes ride through np.save as raw void bytes; the
            # schema knows the real dtype, so restore it (zero-copy view).
            arr = arr.view(expected)
        return arr

    def decode_batch_into(self, unischema_field, cells, dst):
        """The whole column in one native call (a header check and a memcpy
        per cell); False for what the library leaves to ``np.load``
        (extension dtypes, other shapes, Fortran order)."""
        from petastorm_tpu_torch import native
        return native.npy_copy_batch(cells, dst)

    def arrow_dtype(self):
        return pa.binary()


class CompressedNdarrayCodec(NdarrayCodec):
    """``NdarrayCodec`` + zlib, for sparse or compressible tensors."""

    def encode(self, unischema_field, value):
        return zlib.compress(super(CompressedNdarrayCodec, self).encode(unischema_field, value))

    def decode(self, unischema_field, value):
        return super(CompressedNdarrayCodec, self).decode(unischema_field,
                                                          zlib.decompress(value))

    def decode_batch_into(self, unischema_field, cells, dst):
        """The whole column inflated and unpacked in one native call."""
        from petastorm_tpu_torch import native
        return native.zlib_npy_decompress_batch(cells, dst)


# -- images ------------------------------------------------------------------

class CompressedImageCodec(DataframeColumnCodec):
    """PNG/JPEG-compressed image cells via OpenCV.

    3-channel arrays are RGB in memory and are swapped to/from OpenCV's BGR
    at the codec boundary.  cv2 releases the GIL during imencode/imdecode,
    so the thread pool scales.
    """

    def __init__(self, image_codec='png', quality=80):
        if image_codec not in ('png', 'jpeg', 'jpg'):
            raise ValueError('image_codec must be png or jpeg, got %r' % (image_codec,))
        self._image_codec = '.' + image_codec
        self._quality = int(quality)

    @property
    def image_codec(self):
        return self._image_codec[1:]

    @property
    def quality(self):
        return self._quality

    def encode(self, unischema_field, value):
        import cv2
        expected = np.dtype(unischema_field.numpy_dtype)
        if value.dtype != expected:
            raise ValueError('Field %r expects dtype %r, got %r'
                             % (unischema_field.name, expected, value.dtype))
        allowed = (np.uint8,) if self._image_codec in ('.jpg', '.jpeg') else (np.uint8, np.uint16)
        if value.dtype not in [np.dtype(d) for d in allowed]:
            raise ValueError('%s codec supports dtypes %s; field %r is %r (cv2 would silently '
                             'cast to uint8)' % (self.image_codec, [np.dtype(d).name for d in allowed],
                                                 unischema_field.name, value.dtype))
        if value.ndim == 3 and value.shape[2] == 3:
            value = value[:, :, ::-1]  # RGB -> BGR for cv2
        if self._image_codec in ('.jpg', '.jpeg'):
            params = [int(cv2.IMWRITE_JPEG_QUALITY), self._quality]
            ext = '.jpg'
        else:
            params = []
            ext = '.png'
        ok, encoded = cv2.imencode(ext, value, params)
        if not ok:
            raise ValueError('cv2.imencode failed for field %r' % (unischema_field.name,))
        return encoded.tobytes()

    @staticmethod
    def _imdecode(unischema_field, value):
        """BGR-ordered cv2 decode of one cell.  IMREAD_UNCHANGED keeps the
        alpha plane of (H, W, 4) fields."""
        import cv2
        arr = cv2.imdecode(np.frombuffer(value, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise DecodeFieldError('cv2.imdecode failed for field %r' % (unischema_field.name,))
        return arr

    def decode(self, unischema_field, value):
        import cv2
        arr = self._imdecode(unischema_field, value)
        if arr.ndim == 3 and arr.shape[2] == 3:
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        shape = unischema_field.shape
        if (shape is not None and arr.ndim + 1 == len(shape) and shape[-1] == 1
                and arr.shape == tuple(shape[:-1])):
            # Grayscale decodes 2-D; a field declared (H, W, 1) gets the
            # declared rank on every path.
            arr = arr.reshape(shape)
        return np.ascontiguousarray(arr.astype(unischema_field.numpy_dtype, copy=False))

    def decode_batch_into(self, unischema_field, cells, dst):
        """The whole column decoded natively, straight to RGB or grayscale
        in the batch (no BGR intermediate, no per-image Python)."""
        from petastorm_tpu_torch import native
        if self._image_codec in ('.jpg', '.jpeg'):
            return native.jpeg_decode_batch(cells, dst)
        return native.png_decode_batch(cells, dst)

    def decode_batch_into_resized(self, unischema_field, cells, dst):
        """Fused whole-column decode and resize: images of any size land as
        exactly ``dst[i]``-shaped ones (see
        :func:`petastorm_tpu_torch.native.jpeg_decode_resize_batch` for its
        accuracy against :func:`resize_image_cell`).  False: the caller
        resizes cell by cell."""
        from petastorm_tpu_torch import native
        if self._image_codec in ('.jpg', '.jpeg'):
            return native.jpeg_decode_resize_batch(cells, dst)
        return native.png_decode_resize_batch(cells, dst)

    def decode_resized_into(self, unischema_field, value, dst):
        """Per-cell form of the fused path: a full decode and
        :func:`resize_image_cell` into ``dst``."""
        arr = resize_image_cell(self.decode(unischema_field, value), dst.shape[0], dst.shape[1])
        if arr.ndim == 2 and dst.ndim == 3:
            arr = arr[:, :, None]
        elif arr.ndim == 3 and arr.shape[2] == 1 and dst.ndim == 2:
            arr = arr[:, :, 0]
        np.copyto(dst, arr, casting='same_kind')

    def decode_into(self, unischema_field, value, dst):
        import cv2
        arr = self._imdecode(unischema_field, value)
        if arr.ndim == 3 and arr.shape[2] == 3:
            if arr.shape == dst.shape and arr.dtype == dst.dtype and dst.flags['C_CONTIGUOUS']:
                # Fused BGR->RGB + batch placement: one pass.
                cv2.cvtColor(arr, cv2.COLOR_BGR2RGB, dst=dst)
                return
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        if (arr.ndim + 1 == dst.ndim and dst.shape[-1] == 1
                and arr.shape == dst.shape[:-1]):
            arr = arr.reshape(dst.shape)  # grayscale (H, W) -> (H, W, 1)
        if arr.shape != dst.shape:
            raise DecodeFieldError(
                'Field %r image decoded to shape %r, schema expects %r'
                % (unischema_field.name, arr.shape, dst.shape))
        np.copyto(dst, arr, casting='same_kind')

    def arrow_dtype(self):
        return pa.binary()

"""ctypes bindings of the native decode plane (``csrc/pt_decode.cc``).

Counterpart of ``petastorm_tpu/native/__init__.py``.  The library is built
with g++ at first use into ``build/petastorm_tpu_torch/`` (beside the flash
kernels' libraries), and again whenever the source is newer than it or it
does not load on this host; a failed build raises with the compiler's
output.  Each library family is
guarded in the source: a host without libjpeg's or libpng's headers builds
a library without those functions, :func:`capabilities` lists what it
holds, and a decode whose function is absent returns False, the codecs'
"not this column" answer that sends the caller to the cv2 or ``np.load``
path.  :func:`disabled` is the one way to take that path on purpose.

Every batch function returns True when the library decoded the whole batch
into ``dst``; False leaves ``dst`` undefined and the caller decodes cell by
cell.  :data:`calls` counts the batches each function decoded.  Nothing
here imports ``torch``: the process pool's children load this module.
"""

import collections
import contextlib
import ctypes
import os
import re
import subprocess
import threading

import numpy as np
import pyarrow as pa

__all__ = ['capabilities', 'disabled', 'get_lib', 'library_path', 'calls',
           'jpeg_decode_batch', 'jpeg_decode_resize_batch', 'png_decode_batch',
           'png_decode_resize_batch', 'zlib_npy_decompress_batch', 'npy_copy_batch']

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, 'csrc', 'pt_decode.cc')
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'petastorm_tpu_torch')
_SO = os.path.join(_BUILD_DIR, 'libpt_decode.so')
_CXXFLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
#: PT_HAVE_* macro of the source -> the library it links.
_FAMILIES = {'PT_HAVE_JPEG': '-ljpeg', 'PT_HAVE_PNG': '-lpng', 'PT_HAVE_ZLIB': '-lz'}

_IMAGE_ARGS = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_NPY_ARGS = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
             ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
#: Every function the source defines, and its argument types.
_SYMBOLS = {
    'pt_jpeg_decode_batch': _IMAGE_ARGS,
    'pt_jpeg_decode_resize_batch': _IMAGE_ARGS,
    'pt_png_decode_batch': _IMAGE_ARGS,
    'pt_png_decode_resize_batch': _IMAGE_ARGS,
    'pt_zlib_npy_decompress_batch': _NPY_ARGS,
    'pt_npy_copy_batch': _NPY_ARGS,
}

_lock = threading.Lock()
_lib = None
_force_disabled = False
_calls_lock = threading.Lock()
#: Function name (without ``pt_``) -> batches the library decoded whole.
calls = collections.Counter()


@contextlib.contextmanager
def disabled():
    """Take the cv2 and ``np.load`` paths while the context is active, as
    if the library held no function (for comparisons in one process)."""
    global _force_disabled
    prev = _force_disabled
    _force_disabled = True
    try:
        yield
    finally:
        _force_disabled = prev


def library_path():
    return _SO


def _families():
    """The PT_HAVE_* macros the compiler sets for the source (1: headers
    found), from one preprocessor pass."""
    proc = subprocess.run(['g++', '-std=c++17', '-E', '-dM', _SRC], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError('native decode plane: g++ -E failed on %s:\n%s'
                           % (_SRC, proc.stderr[-4000:]))
    found = dict(re.findall(r'#define (PT_HAVE_\w+) (\d)', proc.stdout))
    return {name: found.get(name) == '1' for name in _FAMILIES}


def _build():
    """Compile ``_SO``: to a file of this process, then renamed into place,
    so that processes building at once never load a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    libs = [flag for name, flag in _FAMILIES.items() if _families()[name]]
    tmp = '%s.%d.tmp' % (_SO, os.getpid())
    cmd = ['g++'] + _CXXFLAGS + ['-o', tmp, _SRC] + libs
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError('native decode plane: build failed (%s):\n%s'
                               % (' '.join(cmd), proc.stderr[-4000:]))
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    lib = ctypes.CDLL(_SO)
    for name, argtypes in _SYMBOLS.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return lib


def get_lib():
    """The loaded library, built first if it is missing, older than its
    source or unloadable here; None inside :func:`disabled`.  Raises when
    the build fails."""
    global _lib
    if _force_disabled:
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                _build()
                _lib = _load()
            else:
                try:
                    _lib = _load()
                except OSError:
                    # Built on another host, against libraries this one lacks.
                    _build()
                    _lib = _load()
        return _lib


def capabilities():
    """The functions the library holds (``pt_`` names, in source order)."""
    lib = get_lib()
    if lib is None:
        return []
    return [name for name in _SYMBOLS if getattr(lib, name, None) is not None]


def _function(name):
    lib = get_lib()
    return None if lib is None else getattr(lib, name, None)


def _call(name, fn, *args):
    rc = fn(*args)
    if rc == 0:
        with _calls_lock:
            calls[name[3:]] += 1
    return rc == 0


def _arrow_ptr_arrays(column):
    """pyarrow binary (Chunked)Array -> (char**, size_t*, keepalive) that
    point into the Arrow buffers (no per-cell ``bytes`` copies); None for
    nulls or another type.  ``keepalive`` holds the chunks: they must
    outlive the C call."""
    chunks = column.chunks if isinstance(column, pa.ChunkedArray) else [column]
    ptr_parts, len_parts = [], []
    for chunk in chunks:
        if chunk.null_count:
            return None
        if pa.types.is_binary(chunk.type):
            off_dtype = np.int32
        elif pa.types.is_large_binary(chunk.type):
            off_dtype = np.int64
        else:
            return None
        _, offsets_buf, data_buf = chunk.buffers()
        # A sliced chunk shares its parent's buffers; chunk.offset shifts the
        # window into the offsets.
        offs = np.frombuffer(offsets_buf, dtype=off_dtype, count=len(chunk) + 1,
                             offset=chunk.offset * np.dtype(off_dtype).itemsize
                             ).astype(np.uint64)
        ptr_parts.append(data_buf.address + offs[:-1])
        len_parts.append(np.diff(offs))
    ptrs = np.ascontiguousarray(np.concatenate(ptr_parts))
    lens = np.ascontiguousarray(np.concatenate(len_parts))
    return (ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_char_p)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
            (ptrs, lens, chunks))


def _marshal_cells(cells, expected_n):
    """Cells (list of bytes, or a pyarrow binary column) -> (char**,
    size_t*, n, keepalive); None when they cannot go native.  A count other
    than ``expected_n``, the batch's rows, must never reach the C loop (it
    would write past ``dst``)."""
    if len(cells) != expected_n:
        return None
    if isinstance(cells, (list, tuple)):
        if any(c is None for c in cells):
            return None
        n = len(cells)
        ptrs = (ctypes.c_char_p * n)(*cells)
        lens = (ctypes.c_size_t * n)(*[len(c) for c in cells])
        return ptrs, lens, n, cells
    if isinstance(cells, (pa.Array, pa.ChunkedArray)):
        marshalled = _arrow_ptr_arrays(cells)
        if marshalled is None:
            return None
        ptrs, lens, keep = marshalled
        return ptrs, lens, len(cells), keep
    return None


def _image_batch_call(name, cells, dst):
    """Shared body of the image functions: dst must be a C-contiguous
    uint8 batch of shape (N, H, W, 1 or 3) or (N, H, W)."""
    fn = _function(name)
    if fn is None or dst.dtype != np.uint8 or not dst.flags['C_CONTIGUOUS']:
        return False
    if dst.ndim == 4 and dst.shape[3] in (1, 3):
        h, w, c = dst.shape[1], dst.shape[2], dst.shape[3]
    elif dst.ndim == 3:
        h, w, c = dst.shape[1], dst.shape[2], 1
    else:
        return False
    marshalled = _marshal_cells(cells, len(dst))
    if marshalled is None:
        return False
    ptrs, lens, n, keep = marshalled
    ok = _call(name, fn, ptrs, lens, n, dst.ctypes.data_as(ctypes.c_void_p), h, w, c)
    del keep
    return ok


def jpeg_decode_batch(cells, dst):
    """Decode JPEG cells of exactly dst's (H, W) into the uint8 batch,
    straight to RGB (or grayscale)."""
    return _image_batch_call('pt_jpeg_decode_batch', cells, dst)


def jpeg_decode_resize_batch(cells, dst):
    """Fused decode and resize: JPEGs of any size land as exactly (H, W)
    images, decoded at the coarsest DCT scale that still covers (H, W) and
    resampled bilinearly on cv2.resize's INTER_LINEAR grid.  Within a couple
    of LSB of cv2's decode + resize where the source decodes full size (at
    most 2x reductions, upscales); the DCT-scaled decode of 4x and larger
    reductions is anti-aliased and differs by more."""
    return _image_batch_call('pt_jpeg_decode_resize_batch', cells, dst)


def png_decode_batch(cells, dst):
    """Decode 8-bit PNG cells of exactly dst's (H, W); 16-bit sources, alpha
    and a channel mismatch are rejected (False)."""
    return _image_batch_call('pt_png_decode_batch', cells, dst)


def png_decode_resize_batch(cells, dst):
    """PNG form of :func:`jpeg_decode_resize_batch`: a full decode and the
    same bilinear resample, with :func:`png_decode_batch`'s rejections."""
    return _image_batch_call('pt_png_decode_resize_batch', cells, dst)


def _npy_batch_call(name, cells, dst):
    """Shared body of the .npy functions: renders the header prefix
    ``np.save`` writes for dst's dtype and cell shape (np.lib.format's key
    order is fixed), so the C side rejects any other cell."""
    fn = _function(name)
    if fn is None or not dst.flags['C_CONTIGUOUS'] or dst.dtype.hasobject:
        return False
    cell_bytes = dst[0].nbytes if len(dst) else 0
    if cell_bytes == 0:
        return False
    expected = ("{'descr': %r, 'fortran_order': False, 'shape': %r,"
                % (dst.dtype.str, tuple(dst.shape[1:]))).encode('latin1')
    marshalled = _marshal_cells(cells, len(dst))
    if marshalled is None:
        return False
    ptrs, lens, n, keep = marshalled
    ok = _call(name, fn, ptrs, lens, n, dst.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_size_t(cell_bytes), expected, ctypes.c_size_t(len(expected)))
    del keep
    return ok


def zlib_npy_decompress_batch(cells, dst):
    """Inflate and unpack zlib(.npy) cells (``CompressedNdarrayCodec``)
    into the (N, ...) batch."""
    return _npy_batch_call('pt_zlib_npy_decompress_batch', cells, dst)


def npy_copy_batch(cells, dst):
    """Check and copy raw .npy cells (``NdarrayCodec``) into the (N, ...)
    batch: one header check and one memcpy per cell."""
    return _npy_batch_call('pt_npy_copy_batch', cells, dst)

"""The port's native decode plane (``petastorm_tpu_torch/csrc/pt_decode.cc``,
bound by ``petastorm_tpu_torch/native.py``) against the JAX package's
(``petastorm_tpu/native``) on the same bytes.

Both libraries compile the same code against the same system libraries, so
every batch must be equal bit for bit, and a rejected batch must name the
same cell.  JPEG decode is also held within 1 LSB of cv2 (the JAX package's
own bound: system libjpeg and cv2's bundled one may round their IDCTs
differently).  ``ResizeImages`` through the port's columnar reader must
equal the JAX package's columnar reader bit for bit, and inside
``native.disabled()`` the port's columnar and row paths must be equal bit
for bit (both run cv2).  The JAX package's native plane builds at first
use too; its tests require it, and so do these.
"""

import ctypes
import os
import shutil
import time

import cv2
import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu.native as jax_native
from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.etl.dataset_metadata import DatasetWriter as JaxDatasetWriter
from petastorm_tpu.transform import ResizeImages as JaxResizeImages

import petastorm_tpu_torch.train_lm as lm
from petastorm_tpu_torch import codecs, native, unischema
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.transform import ResizeImages, transform_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = (40, 56)
#: Source sizes of the resize datasets: reductions of at most 2x and
#: upscales, where the fused path decodes full size.
SIZES = [(48, 64), (80, 96), (32, 32), (64, 100)]


def _image(rng, h, w, c=3):
    """Smooth gradient plus 8x8 blocks: compresses like a photograph."""
    base = np.linspace(0, 255, h * w * c, dtype=np.float32).reshape(h, w, c)
    jig = rng.integers(0, 50, (h // 8 + 1, w // 8 + 1, c)).repeat(8, 0).repeat(8, 1)[:h, :w]
    img = np.clip(base + jig, 0, 255).astype(np.uint8)
    return img if c == 3 else img[:, :, 0]


def _encode(img, ext):
    bgr = img[:, :, ::-1] if img.ndim == 3 else img
    params = [int(cv2.IMWRITE_JPEG_QUALITY), 90] if ext == '.jpg' else []
    ok, enc = cv2.imencode(ext, bgr, params)
    assert ok
    return enc.tobytes()


def _npy(arr, compressed):
    codec = codecs.CompressedNdarrayCodec() if compressed else codecs.NdarrayCodec()
    return codec.encode(unischema.UnischemaField('x', arr.dtype, arr.shape, codec, False), arr)


def test_library_is_the_ports_own_build():
    lib = native.get_lib()
    assert lib._name == os.path.join(REPO, 'build', 'petastorm_tpu_torch', 'libpt_decode.so')
    assert native.library_path() == lib._name
    assert os.path.realpath(lib._name) != os.path.realpath(jax_native._SO)
    families = native._families()
    expected = [name for name in native._SYMBOLS
                if ('jpeg' not in name or families['PT_HAVE_JPEG'])
                and ('png' not in name or families['PT_HAVE_PNG'])
                and ('zlib' not in name or families['PT_HAVE_ZLIB'])]
    assert native.capabilities() == expected
    assert jax_native.get_lib() is not None


def _image_case(kind, rng):
    """(port function, JAX function, cells, dst shape) of one image case."""
    gray = kind.endswith('gray')
    c = 1 if gray else 3
    ext = '.jpg' if kind.startswith('jpeg') else '.png'
    if 'resize' in kind:
        imgs = [_image(rng, *SIZES[i % len(SIZES)], c=c) for i in range(6)]
        shape = (6,) + TARGET + (() if gray else (3,))
    else:
        imgs = [_image(rng, 24, 40, c=c) for _ in range(6)]
        shape = (6, 24, 40) + (() if gray else (3,))
    name = '%s_decode%s_batch' % (kind.split('_')[0], '_resize' if 'resize' in kind else '')
    return getattr(native, name), getattr(jax_native, name), [_encode(i, ext) for i in imgs], \
        shape


@pytest.mark.parametrize('kind', ['jpeg', 'jpeg_gray', 'png', 'png_gray', 'jpeg_resize',
                                  'jpeg_resize_gray', 'png_resize'])
@pytest.mark.parametrize('container', ['list', 'arrow'])
def test_image_batches_equal_the_jax_native_plane(kind, container):
    port_fn, jax_fn, cells, shape = _image_case(kind, np.random.default_rng(len(kind)))
    if container == 'arrow':
        cells = pa.chunked_array([pa.array(cells[:4], pa.binary()),
                                  pa.array(cells[4:], pa.binary())])
    got, want = np.zeros(shape, np.uint8), np.ones(shape, np.uint8)
    assert port_fn(cells, got) and jax_fn(cells, want)
    assert got.tobytes() == want.tobytes()
    if kind in ('jpeg', 'jpeg_gray'):
        field = unischema.UnischemaField('image', np.uint8, shape[1:],
                                         codecs.CompressedImageCodec('jpeg'), False)
        for cell, img in zip(cells, got):
            cv2_img = field.codec.decode(field, cell.as_py() if container == 'arrow' else cell)
            assert np.abs(img.astype(int) - cv2_img.astype(int)).max() <= 1


@pytest.mark.parametrize('compressed', [False, True], ids=['npy', 'zlib_npy'])
@pytest.mark.parametrize('dtype', ['int32', 'float32', '>f8', 'uint8'])
def test_npy_batches_equal_the_jax_native_plane(compressed, dtype):
    rng = np.random.default_rng(1)
    arrays = [(rng.standard_normal((5, 7)) * 100).astype(dtype) for _ in range(5)]
    cells = pa.array([_npy(a, compressed) for a in arrays], pa.binary())
    name = 'zlib_npy_decompress_batch' if compressed else 'npy_copy_batch'
    got, want = np.zeros((5, 5, 7), dtype), np.ones((5, 5, 7), dtype)
    assert getattr(native, name)(cells, got) and getattr(jax_native, name)(cells, want)
    assert got.tobytes() == want.tobytes() == np.stack(arrays).astype(dtype).tobytes()


def _rc(module, symbol, cells, dst, *extra):
    """The C function's return code for ``cells`` into ``dst`` (the index
    + 1 of the first rejected cell)."""
    ptrs, lens, n, keep = module._marshal_cells(cells, len(dst))
    rc = getattr(module.get_lib(), symbol)(ptrs, lens, n, dst.ctypes.data_as(ctypes.c_void_p),
                                           *extra)
    del keep
    return rc


def _npy_extra(dst):
    hdr = ("{'descr': %r, 'fortran_order': False, 'shape': %r,"
           % (dst.dtype.str, tuple(dst.shape[1:]))).encode('latin1')
    return ctypes.c_size_t(dst[0].nbytes), hdr, ctypes.c_size_t(len(hdr))


def _rejection_cases():
    rng = np.random.default_rng(2)
    jpg = [_encode(_image(rng, 24, 40), '.jpg') for _ in range(3)]
    png = [_encode(_image(rng, 24, 40), '.png') for _ in range(3)]
    mat = np.arange(12, dtype=np.float32).reshape(3, 4)
    f3x4 = np.zeros((3, 3, 4), np.float32)
    cases = {
        'jpeg wrong dims': ('pt_jpeg_decode_batch',
                            [jpg[0], _encode(_image(rng, 20, 40), '.jpg'), jpg[2]],
                            np.zeros((3, 24, 40, 3), np.uint8)),
        'jpeg gray into rgb': ('pt_jpeg_decode_batch',
                               [jpg[0], jpg[1], _encode(_image(rng, 24, 40, 1), '.jpg')],
                               np.zeros((3, 24, 40, 3), np.uint8)),
        'png 16-bit': ('pt_png_decode_batch',
                       [png[0], cv2.imencode('.png', rng.integers(0, 65535, (24, 40, 3),
                                                                  dtype=np.uint16))[1].tobytes(),
                        png[2]], np.zeros((3, 24, 40, 3), np.uint8)),
        'png resize alpha': ('pt_png_decode_resize_batch',
                             [png[0], png[1],
                              _encode(np.dstack([_image(rng, 24, 40)] * 2)[:, :, :4], '.png')],
                             np.zeros((3,) + TARGET + (3,), np.uint8)),
        'npy fortran order': ('pt_npy_copy_batch',
                              [_npy(mat, False), _npy(np.asfortranarray(mat), False),
                               _npy(mat, False)], f3x4),
        'npy size mismatch': ('pt_npy_copy_batch',
                              [_npy(mat, False), _npy(mat, False), _npy(mat[:2], False)], f3x4),
        'npy other shape': ('pt_npy_copy_batch',
                            [_npy(mat, False), _npy(mat.reshape(2, 6), False), _npy(mat, False)],
                            f3x4),
        'npy garbage': ('pt_npy_copy_batch', [_npy(mat, False), b'\x00bogus', _npy(mat, False)],
                        f3x4),
        'zlib fortran order': ('pt_zlib_npy_decompress_batch',
                               [_npy(mat, True), _npy(np.asfortranarray(mat), True),
                                _npy(mat, True)], f3x4),
        'zlib size mismatch': ('pt_zlib_npy_decompress_batch',
                               [_npy(mat, True), _npy(mat, True), _npy(mat[:1], True)], f3x4),
    }
    return cases


REJECTIONS = _rejection_cases()


@pytest.mark.parametrize('case', sorted(REJECTIONS))
def test_rejections_name_the_same_cell(case):
    symbol, cells, dst = REJECTIONS[case]
    extra = _npy_extra(dst) if 'npy' in symbol else \
        (dst.shape[1], dst.shape[2], dst.shape[3] if dst.ndim == 4 else 1)
    got = _rc(native, symbol, cells, dst.copy(), *extra)
    want = _rc(jax_native, symbol, cells, dst.copy(), *extra)
    assert got == want and got in (2, 3), (got, want)


def _write_images(url, ext, schema_of):
    u, c = schema_of
    schema = u.Unischema('VarImages', [
        u.UnischemaField('id', np.int64, (), None, False),
        u.UnischemaField('image', np.uint8, (None, None, 3), c.CompressedImageCodec(ext, 90),
                         False)])
    writer = DatasetWriter if u is unischema else JaxDatasetWriter
    rng = np.random.default_rng(3)
    with writer(url, schema, rows_per_rowgroup=4) as w:
        for i in range(12):
            w.write({'id': np.int64(i), 'image': _image(rng, *SIZES[i % len(SIZES)])})
    return url


def _columnar(read, url, spec, **kwargs):
    with read(url, transform_spec=spec, columnar_decode=True, shuffle_row_groups=False,
              reader_pool_type='dummy', **kwargs) as reader:
        batches = list(reader)
    return np.concatenate([b.id for b in batches]), np.concatenate([b.image for b in batches])


@pytest.mark.parametrize('ext', ['jpeg', 'png'])
def test_resize_images_columnar_reader_equals_jax(tmp_path, ext):
    """The fused decode and resize through the port's columnar reader gives
    the JAX package's columnar reader's batches bit for bit, on a dataset
    written by either package, through the native function."""
    for writer, schema_of in (('port', (unischema, codecs)), ('jax', (jax_unischema, jax_codecs))):
        url = _write_images('file://%s/%s_%s' % (tmp_path, writer, ext), ext, schema_of)
        before = native.calls['%s_decode_resize_batch' % ext]
        ids, images = _columnar(make_reader, url, ResizeImages({'image': TARGET}))
        assert native.calls['%s_decode_resize_batch' % ext] == before + 3
        jax_ids, jax_images = _columnar(jax_make_reader, url, JaxResizeImages({'image': TARGET}),
                                        scheduling='fifo', ingest='off')
        assert ids.tolist() == jax_ids.tolist() == list(range(12))
        assert images.dtype == jax_images.dtype == np.uint8
        assert images.shape == jax_images.shape == (12,) + TARGET + (3,)
        assert images.tobytes() == jax_images.tobytes()


def test_resize_images_paths_agree(tmp_path):
    """Inside ``native.disabled()`` the columnar reader's resize and the row
    path's are the same cv2 resize, bit for bit; the fused native path is
    within 2 LSB of them; the schema takes the target shape."""
    url = _write_images('file://%s/ds' % tmp_path, 'jpeg', (unischema, codecs))
    spec = ResizeImages({'image': TARGET})
    with make_reader(url, transform_spec=spec, shuffle_row_groups=False,
                     reader_pool_type='dummy') as reader:
        rows = {int(r.id): r.image for r in reader}
        assert reader.schema.fields['image'].shape == TARGET + (3,)
    ids, fused = _columnar(make_reader, url, spec)
    with native.disabled():
        assert native.capabilities() == []
        cv2_ids, cv2_images = _columnar(make_reader, url, spec)
    assert ids.tolist() == cv2_ids.tolist() == sorted(rows)
    assert cv2_images.tobytes() == np.stack([rows[i] for i in ids]).tobytes()
    assert np.abs(fused.astype(int) - cv2_images.astype(int)).max() <= 2
    schema = transform_schema(reader.schema, ResizeImages({'image': (8, 8)}))
    assert schema.fields['image'].shape == (8, 8, 3)


def test_token_columns_decode_natively_and_equal_jax(tmp_path):
    """L1's ``tokens`` column (NdarrayCodec, static 1024) through the
    columnar reader: one native call per row group, the JAX reader's
    batches bit for bit, and the same batches inside ``disabled()``."""
    url = lm.write_token_dataset('file://%s/tokens' % tmp_path, num_docs=64)
    before = native.calls['npy_copy_batch']
    ids, tokens = _tokens(make_reader, url)
    assert native.calls['npy_copy_batch'] == before + 2
    with native.disabled():
        cv_ids, np_tokens = _tokens(make_reader, url)
    assert native.calls['npy_copy_batch'] == before + 2
    jax_ids, jax_tokens = _tokens(jax_make_reader, url, scheduling='fifo', ingest='off')
    assert ids.tolist() == cv_ids.tolist() == jax_ids.tolist() == list(range(64))
    assert tokens.dtype == jax_tokens.dtype == np.int32 and tokens.shape == (64, 1024)
    assert tokens.tobytes() == np_tokens.tobytes() == jax_tokens.tobytes()


def _tokens(read, url, **kwargs):
    with read(url, columnar_decode=True, shuffle_row_groups=False, reader_pool_type='dummy',
              **kwargs) as reader:
        batches = list(reader)
    return (np.concatenate([b.doc_id for b in batches]),
            np.concatenate([b.tokens for b in batches]))


def test_builds_at_first_use_again_when_stale_and_raises_when_it_fails(tmp_path, monkeypatch):
    src = tmp_path / 'pt_decode.cc'
    shutil.copy(native._SRC, src)
    so = tmp_path / 'build' / 'libpt_decode.so'
    monkeypatch.setattr(native, '_SRC', str(src))
    monkeypatch.setattr(native, '_BUILD_DIR', str(so.parent))
    monkeypatch.setattr(native, '_SO', str(so))
    monkeypatch.setattr(native, '_lib', None)
    lib = native.get_lib()
    assert lib._name == str(so) and native.capabilities()
    built = os.path.getmtime(so)
    future = time.time() + 60
    os.utime(src, (future, future))
    monkeypatch.setattr(native, '_lib', None)
    native.get_lib()
    assert os.path.getmtime(so) > built
    assert not [f for f in os.listdir(so.parent) if f.endswith('.tmp')]
    with open(src, 'a') as f:
        f.write('\nthis is not C++;\n')
    os.utime(src, (future + 60, future + 60))
    monkeypatch.setattr(native, '_lib', None)
    with pytest.raises(RuntimeError, match='build failed'):
        native.get_lib()
    assert not [f for f in os.listdir(so.parent) if f.endswith('.tmp')]

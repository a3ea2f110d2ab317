"""The port's reader + loader against the JAX package's, on small JPEG
Parquet datasets.

Same dataset, reader arguments (dummy pool, FIFO scheduling, no ingest
plane, the same TransformSpec function), seed and batch size: the batches
must be equal bit for bit, dtypes included (the JAX side applies its
canonical dtypes at ``device_put``: int64 -> int32, float64 -> float32; the
port applies the same rule in its transfer).  The JAX side runs with its
native decode plane disabled, so both decode JPEGs through cv2.  Each
dataset is written once by each package's writer, and each is read by both
packages: a dataset written by either reads in the other.
"""

import cv2
import numpy as np
import pyarrow as pa
import pytest
import torch

import petastorm_tpu.native
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.etl.dataset_metadata import DatasetWriter as JaxDatasetWriter
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec

from petastorm_tpu_torch import codecs, unischema
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.transform import TransformSpec

HW = (16, 16)
ROWS = 44


def _schema(u, c):
    return u.Unischema('ImagenetSchema', [
        u.UnischemaField('noun_id', np.str_, (), c.ScalarCodec(pa.string()), False),
        u.UnischemaField('image', np.uint8, (None, None, 3), c.CompressedImageCodec('jpeg'),
                         False),
        u.UnischemaField('idx', np.int64, (), None, False),
        u.UnischemaField('weight', np.float64, (), None, False),
    ])


def _rows():
    rng = np.random.default_rng(0)
    for i in range(ROWS):
        hw = [HW, (20, 24), (12, 18)][i % 3]
        img = cv2.resize(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8), (hw[1], hw[0]))
        yield {'noun_id': 'n%08d' % rng.integers(0, 50), 'image': img,
               'idx': np.int64(i), 'weight': np.float64(rng.uniform())}


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    """{writer: url} for a dataset written by each package."""
    root = tmp_path_factory.mktemp('torch_loader')
    urls = {}
    for name, writer, schema in (
            ('port', DatasetWriter, _schema(unischema, codecs)),
            ('jax', JaxDatasetWriter, _schema(jax_unischema, jax_codecs))):
        urls[name] = 'file://%s/%s' % (root, name)
        with writer(urls[name], schema, rows_per_rowgroup=8) as w:
            for row in _rows():
                w.write(row)
    return urls


def _fix_row(row):
    """The JAX example's transform (resize + noun_id -> int32 label)."""
    row = dict(row)
    img = row.pop('image')
    if img.shape[:2] != HW:
        img = cv2.resize(img, (HW[1], HW[0]))
    row['image'] = img
    row['label'] = np.int32(hash(row.pop('noun_id')) % 1000)
    return row


def _spec(cls):
    return cls(_fix_row, edit_fields=[('image', np.uint8, HW + (3,), False),
                                      ('label', np.int32, (), False)],
               removed_fields=['noun_id'])


CASES = {
    # the main path's fields through the transform
    'transform': dict(fields=['image', 'noun_id'], transform=True),
    # raw scalar columns: int64/float64 narrowed, the string dropped
    'scalars': dict(fields=['idx', 'weight', 'noun_id'], transform=False),
}


def _jax_batches(url, case, shuffle, seed, capacity, batch_size):
    reader = jax_make_reader(url, schema_fields=case['fields'], reader_pool_type='dummy',
                             scheduling='fifo', ingest='off', columnar_decode=True,
                             shuffle_row_groups=shuffle, seed=seed,
                             transform_spec=_spec(JaxTransformSpec) if case['transform'] else None)
    with petastorm_tpu.native.disabled():
        with JaxDataLoader(reader, batch_size, shuffling_queue_capacity=capacity,
                           seed=seed, drop_last=False) as loader:
            return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _port_batches(url, case, shuffle, seed, capacity, batch_size, pool='dummy'):
    reader = make_reader(url, schema_fields=case['fields'], reader_pool_type=pool,
                         workers_count=3, columnar_decode=True, shuffle_row_groups=shuffle,
                         seed=seed,
                         transform_spec=_spec(TransformSpec) if case['transform'] else None)
    with DataLoader(reader, batch_size, shuffling_queue_capacity=capacity, seed=seed,
                    drop_last=False, device='cpu') as loader:
        batches = list(loader)
    for b in batches:
        assert all(isinstance(v, torch.Tensor) and v.device.type == 'cpu' for v in b.values())
    return [{k: v.numpy() for k, v in b.items()} for b in batches]


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('shuffle,capacity', [(False, 0), (True, 0), (True, 20)])
def test_batches_equal_jax_bit_for_bit(datasets, writer, case, shuffle, capacity):
    args = (datasets[writer], CASES[case], shuffle, 7, capacity, 10)
    want = _jax_batches(*args)
    got = _port_batches(*args)
    assert len(got) == len(want) == -(-ROWS // 10)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    if case == 'scalars':
        assert got[0]['idx'].dtype == np.int32 and got[0]['weight'].dtype == np.float32
        assert 'noun_id' not in got[0]
        order = np.concatenate([b['idx'] for b in got])
        assert sorted(order) == list(range(ROWS))
        assert (list(order) == list(range(ROWS))) == (not shuffle)


def test_thread_pool_delivers_the_same_rows(datasets):
    """The thread pool delivers in completion order: the same rows as the
    dummy pool, in some order."""
    case = CASES['scalars']
    got = _port_batches(datasets['port'], case, True, 3, 0, 8, pool='thread')
    want = _port_batches(datasets['port'], case, True, 3, 0, 8)
    key = lambda batches: sorted(zip(*(np.concatenate([b[k] for b in batches])  # noqa: E731
                                       for k in ('idx', 'weight'))))
    assert key(got) == key(want)


def test_unsupported_options_name_the_later_slice(datasets):
    url = datasets['port']
    for kwargs in (dict(scheduling='adaptive'), dict(ingest='plane')):
        with pytest.raises(ValueError, match='later slice'):
            make_reader(url, **kwargs)


def test_a_loader_over_the_local_disk_cache_repeats_its_batches(datasets, tmp_path):
    """``cache_type='local-disk'``: the second epoch's batches come from the
    cache and equal the first's and the JAX loader's under its own cache."""
    case = CASES['scalars']
    epochs = []
    for _ in range(2):
        reader = make_reader(datasets['port'], schema_fields=case['fields'],
                             reader_pool_type='dummy', columnar_decode=True,
                             shuffle_row_groups=False, cache_type='local-disk',
                             cache_location=str(tmp_path / 'port'))
        with DataLoader(reader, 10, drop_last=False, device='cpu') as loader:
            epochs.append([{k: v.numpy() for k, v in b.items()} for b in loader])
    assert reader.diagnostics['cache_hits'] == 6
    reader = jax_make_reader(datasets['port'], schema_fields=case['fields'],
                             reader_pool_type='dummy', columnar_decode=True,
                             shuffle_row_groups=False, scheduling='fifo', ingest='off',
                             cache_type='local-disk', cache_location=str(tmp_path / 'jax'))
    with JaxDataLoader(reader, 10, drop_last=False) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    for got in epochs:
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)

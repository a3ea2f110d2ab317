"""The port's in-memory loaders and its copy of ``jax.random`` against the
JAX package's.

``petastorm_tpu_torch.random.permutation`` must equal
``jax.random.permutation`` element for element through the ``split`` chain
of ``DeviceInMemDataLoader._epoch_orders``, at sizes that take one sort
round (n <= 1625) and two.  ``InMemDataLoader`` and
``DeviceInMemDataLoader`` (``device='cpu'``) must deliver the JAX loaders'
batches bit for bit, dtypes included, for the same dataset, reader
arguments (dummy pool, FIFO scheduling, no ingest plane, cv2 decode), seed
and batch size; with ``deterministic_cache_order=True`` the port reads
through an 8-thread pool.
"""

import cv2
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax

import petastorm_tpu.native
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import DeviceInMemDataLoader as JaxDeviceInMemDataLoader
from petastorm_tpu.jax import InMemDataLoader as JaxInMemDataLoader
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec

from petastorm_tpu_torch import codecs, random, unischema
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.gpu import DeviceInMemDataLoader, InMemDataLoader
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.transform import TransformSpec

HW = (16, 16)
ROWS = 44
BATCH = 10


@pytest.mark.parametrize('n', [1, 7, 512, 1625, 1626, 5000])
@pytest.mark.parametrize('seed', [0, 17, 2 ** 31 - 1])
def test_permutation_matches_jax(seed, n):
    key, port_key = jax.random.PRNGKey(seed), random.PRNGKey(seed)
    np.testing.assert_array_equal(port_key, np.asarray(key))
    for _ in range(3):   # the first three epochs of _epoch_orders
        key, sub = jax.random.split(key)
        port_key, port_sub = random.split(port_key)
        np.testing.assert_array_equal(port_sub, np.asarray(sub))
        want = np.asarray(jax.random.permutation(sub, n))
        got = random.permutation(port_sub, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _schema():
    return unischema.Unischema('ImagenetSchema', [
        unischema.UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(pa.string()),
                                 False),
        unischema.UnischemaField('image', np.uint8, (None, None, 3),
                                 codecs.CompressedImageCodec('jpeg'), False),
        unischema.UnischemaField('idx', np.int64, (), None, False),
        unischema.UnischemaField('weight', np.float64, (), None, False),
    ])


@pytest.fixture(scope='module')
def dataset_url(tmp_path_factory):
    url = 'file://%s/ds' % tmp_path_factory.mktemp('torch_inmem')
    rng = np.random.default_rng(0)
    with DatasetWriter(url, _schema(), rows_per_rowgroup=8) as writer:
        for i in range(ROWS):
            hw = [HW, (20, 24), (12, 18)][i % 3]
            img = cv2.resize(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8), (hw[1], hw[0]))
            writer.write({'noun_id': 'n%08d' % rng.integers(0, 50), 'image': img,
                          'idx': np.int64(i), 'weight': np.float64(rng.uniform())})
    return url


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
    'transform': dict(fields=['image', 'noun_id', 'idx'], transform=True),
    # raw scalar columns: int64/float64 narrowed, the string dropped
    'scalars': dict(fields=['idx', 'weight', 'noun_id'], transform=False),
}


def _jax_batches(url, case, loader_cls, **kwargs):
    reader = jax_make_reader(url, schema_fields=case['fields'], reader_pool_type='dummy',
                             scheduling='fifo', ingest='off', columnar_decode=True,
                             num_epochs=1, seed=3,
                             transform_spec=_spec(JaxTransformSpec) if case['transform']
                             else None)
    with petastorm_tpu.native.disabled():
        with loader_cls(reader, BATCH, **kwargs) as loader:
            return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _port_reader(url, case, pool='dummy', num_epochs=1):
    return make_reader(url, schema_fields=case['fields'], reader_pool_type=pool,
                       workers_count=8, columnar_decode=True, num_epochs=num_epochs, seed=3,
                       transform_spec=_spec(TransformSpec) if case['transform'] else None)


def _port_batches(url, case, loader_cls, pool='dummy', **kwargs):
    with loader_cls(_port_reader(url, case, pool), BATCH, device='cpu', **kwargs) as loader:
        batches = list(loader)
    for b in batches:
        assert all(isinstance(v, torch.Tensor) and v.device.type == 'cpu' for v in b.values())
    return [{k: v.numpy() for k, v in b.items()} for b in batches]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


LOADERS = {'host': (InMemDataLoader, JaxInMemDataLoader),
           'device': (DeviceInMemDataLoader, JaxDeviceInMemDataLoader)}


@pytest.mark.parametrize('drop_last', [True, False])
@pytest.mark.parametrize('shuffle', [True, False])
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('loader', sorted(LOADERS))
def test_inmem_batches_equal_jax_bit_for_bit(dataset_url, loader, case, shuffle, drop_last):
    port_cls, jax_cls = LOADERS[loader]
    kwargs = dict(num_epochs=3, shuffle=shuffle, seed=7, drop_last=drop_last)
    want = _jax_batches(dataset_url, CASES[case], jax_cls, **kwargs)
    got = _port_batches(dataset_url, CASES[case], port_cls, **kwargs)
    per_epoch = ROWS // BATCH if drop_last else -(-ROWS // BATCH)
    assert len(want) == 3 * per_epoch
    _assert_equal(got, want)
    assert 'noun_id' not in got[0] and got[0]['idx'].dtype == np.int32
    epochs = [np.concatenate([b['idx'] for b in got[e * per_epoch:(e + 1) * per_epoch]])
              for e in range(3)]
    if not drop_last:   # every row once per epoch
        assert all(sorted(e) == list(range(ROWS)) for e in epochs)
    assert (epochs[0].tolist() == epochs[1].tolist()) == (not shuffle)


@pytest.mark.parametrize('loader', sorted(LOADERS))
def test_deterministic_cache_order_under_a_thread_pool(dataset_url, loader):
    """The content-sorted cache makes the port's 8-thread pool (completion
    order) give the JAX loader's batches from a dummy pool."""
    port_cls, jax_cls = LOADERS[loader]
    kwargs = dict(num_epochs=2, seed=11, deterministic_cache_order=True)
    want = _jax_batches(dataset_url, CASES['transform'], jax_cls, **kwargs)
    got = _port_batches(dataset_url, CASES['transform'], port_cls, pool='thread', **kwargs)
    _assert_equal(got, want)


@pytest.mark.parametrize('epochs_per_call', [1, 3])
def test_scan_epochs_matches_jax(dataset_url, epochs_per_call):
    """Five epochs: yields of one epoch (steps axis only), or groups of three
    then a trailing group of two (epochs axis first); the same per-step
    outputs and carry as the JAX loader's lax.scan."""
    case = CASES['scalars']

    def jax_step(carry, batch):
        return carry + batch['idx'].sum(), batch['idx']

    def port_step(carry, batch):
        return carry + batch['idx'].sum(), {'idx': batch['idx'], 'weight': batch['weight']}

    reader = jax_make_reader(dataset_url, schema_fields=case['fields'],
                             reader_pool_type='dummy', scheduling='fifo', ingest='off',
                             columnar_decode=True, num_epochs=1, seed=3)
    with petastorm_tpu.native.disabled():
        with JaxDeviceInMemDataLoader(reader, BATCH, num_epochs=5, seed=17) as loader:
            want = [(np.asarray(c), np.asarray(o)) for c, o in loader.scan_epochs(
                jax_step, jax.numpy.int32(0), donate_carry=False,
                epochs_per_call=epochs_per_call)]
    with DeviceInMemDataLoader(_port_reader(dataset_url, case), BATCH, num_epochs=5, seed=17,
                               device='cpu') as loader:
        got = list(loader.scan_epochs(port_step, torch.tensor(0, dtype=torch.int32),
                                      epochs_per_call=epochs_per_call))
    steps = ROWS // BATCH
    shapes = [(steps,)] * 5 if epochs_per_call == 1 else [(3, steps), (2, steps)]
    assert [tuple(outs['idx'].shape[:-1]) for _, outs in got] == shapes
    assert [tuple(outs['weight'].shape) for _, outs in got] == [s + (BATCH,) for s in shapes]
    assert len(got) == len(want)
    for (carry, outs), (want_carry, want_idx) in zip(got, want):
        assert int(carry) == int(want_carry)
        np.testing.assert_array_equal(outs['idx'].numpy(), want_idx)


def test_device_cache_is_placed_once_and_the_host_copy_released(dataset_url):
    case = CASES['scalars']
    with DeviceInMemDataLoader(_port_reader(dataset_url, case), BATCH, num_epochs=1,
                               shuffle=False, device='cpu') as loader:
        first = [b['idx'] for b in loader]
        cache = loader._dev_cache
        assert loader._cache is None and sorted(cache) == ['idx', 'weight']
        assert cache['idx'].dtype == torch.int32 and cache['weight'].dtype == torch.float32
        second = [b['idx'] for b in loader]
        assert loader._dev_cache is cache
    assert torch.equal(torch.cat(first), cache['idx'][:ROWS // BATCH * BATCH])
    assert sorted(cache['idx'].tolist()) == list(range(ROWS))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_unsupported_arguments_are_rejected(dataset_url):
    case = CASES['scalars']
    for num_epochs in (None, 2):
        with _port_reader(dataset_url, case, num_epochs=num_epochs) as reader:
            for cls in (InMemDataLoader, DeviceInMemDataLoader):
                with pytest.raises(ValueError, match='num_epochs=1'):
                    cls(reader, BATCH, device='cpu')
    with _port_reader(dataset_url, case) as reader:
        for kwargs in (dict(transform_fn=lambda b: b), dict(shuffling_queue_capacity=20)):
            with pytest.raises(ValueError, match='does not support'):
                DeviceInMemDataLoader(reader, BATCH, device='cpu', **kwargs)
        for cls in (InMemDataLoader, DeviceInMemDataLoader):
            with pytest.raises(ValueError, match='resume_state'):
                cls(reader, BATCH, device='cpu', resume_state={'version': 1})
            with pytest.raises(ValueError, match='echo'):
                cls(reader, BATCH, device='cpu', echo=2)
        loader = DeviceInMemDataLoader(reader, BATCH, device='cpu')
        with pytest.raises(ValueError, match='epochs_per_call'):
            next(loader.scan_epochs(lambda c, b: (c, None), 0, epochs_per_call=0))


def test_hbm_cache_training_needs_a_full_batch(dataset_url):
    from petastorm_tpu_torch.train import train
    with pytest.raises(ValueError, match='fewer rows than batch_size=64'):
        train(dataset_url, steps=1, batch_size=64, image_hw=HW, device='cpu', hbm_cache=True)

"""Shared by the transfer-plane, disk-cache and trace tests of the port: a
small dataset of numeric, image, tensor and string fields written by the
port's writer, and readers over it from each package with the same
arguments (dummy pool, no row-group shuffle, FIFO scheduling, no ingest
plane), so both deliver the same rows in the same order."""

import numpy as np
import pyarrow as pa
import torch

from petastorm_tpu import make_reader as jax_make_reader

from petastorm_tpu_torch import codecs, unischema
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.reader import make_reader

ROWS = 64
ROWS_PER_GROUP = 8


def write_dataset(url, rows=ROWS, seed=0):
    u, c = unischema, codecs
    schema = u.Unischema('PlaneSchema', [
        u.UnischemaField('id', np.int64, (), None, False),
        u.UnischemaField('id2', np.int32, (), None, False),
        u.UnischemaField('image_png', np.uint8, (16, 32, 3), c.CompressedImageCodec('png'),
                         False),
        u.UnischemaField('matrix', np.float32, (8, 4), c.NdarrayCodec(), False),
        u.UnischemaField('decimal_like', np.float64, (), None, False),
        u.UnischemaField('embedding', np.float32, (32,), c.CompressedNdarrayCodec(), False),
        u.UnischemaField('sensor_name', np.str_, (), c.ScalarCodec(pa.string()), False),
    ])
    rng = np.random.default_rng(seed)
    with DatasetWriter(url, schema, rows_per_rowgroup=ROWS_PER_GROUP) as w:
        for i in range(rows):
            w.write({'id': np.int64(i), 'id2': np.int32(i % 5),
                     'image_png': rng.integers(0, 255, (16, 32, 3), dtype=np.uint8),
                     'matrix': rng.standard_normal((8, 4)).astype(np.float32),
                     'decimal_like': np.float64(i / 3.0),
                     'embedding': rng.standard_normal(32).astype(np.float32),
                     'sensor_name': 'sensor_%d' % (i % 3)})
    return url


def port_reader(url, columnar, **kwargs):
    kwargs.setdefault('reader_pool_type', 'dummy')
    kwargs.setdefault('shuffle_row_groups', False)
    return make_reader(url, columnar_decode=columnar, **kwargs)


def jax_reader(url, columnar, **kwargs):
    kwargs.setdefault('reader_pool_type', 'dummy')
    kwargs.setdefault('shuffle_row_groups', False)
    return jax_make_reader(url, columnar_decode=columnar, scheduling='fifo', ingest='off',
                           **kwargs)


def to_numpy(batch):
    """A device batch (port tensors or JAX arrays, nested dicts) as numpy."""
    if isinstance(batch, dict):
        return {k: to_numpy(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.cpu().numpy()
    return np.asarray(batch)


def assert_batches_equal(got, want):
    """Same number of batches, same keys, dtypes and values, bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = to_numpy(g), to_numpy(w)
        assert sorted(g) == sorted(w)
        for key in w:
            if isinstance(w[key], dict):
                assert_batches_equal([g[key]], [w[key]])
                continue
            assert g[key].dtype == w[key].dtype, (key, g[key].dtype, w[key].dtype)
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)

"""The port's ``DiskCachedDataLoader`` against the JAX package's, on the CPU.

Same dataset, reader arguments (dummy pool, no row-group shuffle), seed and
batch size: epoch 0 (served while the cache is written) and the later
epochs (served from the memory-mapped files) must equal the JAX loader's
batches bit for bit, the cache files must be the JAX loader's byte for
byte, and each package's loader serves the other's cache with
``reader=None``.
"""

import os

import numpy as np
import pytest

import petastorm_tpu.native
from petastorm_tpu.jax import DiskCachedDataLoader as JaxDiskCachedDataLoader

from petastorm_tpu_torch.gpu import DiskCachedDataLoader

from torch_plane_common import (ROWS, assert_batches_equal, jax_reader, port_reader, to_numpy,
                                write_dataset)

BATCH = 16
EPOCHS = 3


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_disk_cache'))


def _jax_run(reader, cache_dir, **kwargs):
    with petastorm_tpu.native.disabled():
        with JaxDiskCachedDataLoader(reader, BATCH, decoded_cache_dir=str(cache_dir),
                                     transfer=True, **kwargs) as loader:
            return [to_numpy(b) for b in loader]


def _port_run(reader, cache_dir, **kwargs):
    kwargs.setdefault('transfer', True)
    with DiskCachedDataLoader(reader, BATCH, decoded_cache_dir=str(cache_dir), device='cpu',
                              **kwargs) as loader:
        return list(loader)


@pytest.mark.parametrize('columnar', [True, False])
@pytest.mark.parametrize('shuffle', [True, False])
def test_epochs_equal_jax(url, tmp_path, columnar, shuffle):
    kwargs = dict(num_epochs=EPOCHS, shuffle=shuffle, seed=5)
    want = _jax_run(jax_reader(url, columnar), tmp_path / 'jax', **kwargs)
    got = _port_run(port_reader(url, columnar), tmp_path / 'port', **kwargs)
    assert len(got) == len(want) == EPOCHS * ROWS // BATCH
    assert_batches_equal(got, want)
    per_epoch = ROWS // BATCH
    ids = [np.concatenate([to_numpy(b)['id'] for b in got[e * per_epoch:(e + 1) * per_epoch]])
           for e in range(EPOCHS)]
    assert all(sorted(i.tolist()) == list(range(ROWS)) for i in ids)
    assert (ids[1].tolist() != ids[2].tolist()) == shuffle


def test_pumped_equals_inline(url, tmp_path):
    kwargs = dict(num_epochs=2, seed=1)
    pumped = _port_run(port_reader(url, True), tmp_path / 'a', **kwargs)
    inline = _port_run(port_reader(url, True), tmp_path / 'b', transfer=False, **kwargs)
    assert_batches_equal(pumped, inline)


def test_cache_files_equal_jax_and_each_serves_the_other(url, tmp_path):
    jax_dir, port_dir = tmp_path / 'jax', tmp_path / 'port'
    _jax_run(jax_reader(url, True), jax_dir, num_epochs=1)
    _port_run(port_reader(url, True), port_dir, num_epochs=1)
    names = sorted(os.listdir(str(jax_dir)))
    assert names == sorted(os.listdir(str(port_dir)))
    assert {'manifest.json', '_COMPLETE', 'id.bin', 'image_png.bin'} <= set(names)
    assert 'sensor_name.bin' not in names
    for name in names:
        assert (jax_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    assert DiskCachedDataLoader.cache_complete(str(jax_dir))
    # each package over the other's cache, with no reader at all
    kwargs = dict(num_epochs=2, seed=9)
    port_on_jax = _port_run(None, jax_dir, **kwargs)
    jax_on_port = _jax_run(None, port_dir, **kwargs)
    assert len(port_on_jax) == 2 * ROWS // BATCH
    assert_batches_equal(port_on_jax, jax_on_port)


def test_a_partial_build_is_rebuilt(url, tmp_path):
    cache = tmp_path / 'partial'
    cache.mkdir()
    (cache / 'id.bin').write_bytes(b'garbage')   # no _COMPLETE marker
    with pytest.raises(ValueError, match='COMPLETE'):
        _port_run(None, cache)
    got = _port_run(port_reader(url, True), cache, num_epochs=2)
    ids = np.concatenate([to_numpy(b)['id'] for b in got])
    assert len(ids) == 2 * ROWS and sorted(ids[:ROWS].tolist()) == list(range(ROWS))
    assert (cache / 'id.bin').stat().st_size == ROWS * 8


def test_refusals(url, tmp_path):
    reader = port_reader(url, True, num_epochs=2)
    try:
        with pytest.raises(ValueError, match='num_epochs=1'):
            DiskCachedDataLoader(reader, BATCH, decoded_cache_dir=str(tmp_path / 'c'),
                                 device='cpu')
        with pytest.raises(ValueError, match='shuffling_queue_capacity'):
            DiskCachedDataLoader(reader, BATCH, decoded_cache_dir=str(tmp_path / 'c'),
                                 shuffling_queue_capacity=8, device='cpu')
    finally:
        reader.stop()
        reader.join()

"""The port's ``DataLoader.scan_batches`` and ``PackedDataLoader.scan_batches``
against the JAX loaders' (one ``lax.scan`` dispatch per chunk).

On the CPU the port runs each chunk's steps eagerly; the chunking, the
stacking, the ragged tail chunk and the carry must be the JAX loader's.  Both
sides read the same dataset through a dummy pool with FIFO scheduling (the
JAX side with its native decode plane disabled), so the batches are equal
bit for bit (``tests/test_torch_loader.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import petastorm_tpu.native
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.jax import PackedDataLoader as JaxPackedDataLoader

from petastorm_tpu_torch import codecs, unischema
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.gpu import DataLoader, PackedDataLoader
from petastorm_tpu_torch.reader import make_reader

ROWS = 64


@pytest.fixture(scope='module')
def ids_url(tmp_path_factory):
    """64 rows of ``id`` (int64) and ``name`` (a string the loaders drop),
    8 rows per row group."""
    import pyarrow as pa
    url = 'file://%s' % tmp_path_factory.mktemp('scan_ids')
    schema = unischema.Unischema('Ids', [
        unischema.UnischemaField('id', np.int64, (), None, False),
        unischema.UnischemaField('name', np.str_, (), codecs.ScalarCodec(pa.string()), False)])
    with DatasetWriter(url, schema, rows_per_rowgroup=8) as writer:
        for i in range(ROWS):
            writer.write({'id': np.int64(i), 'name': 'row%d' % i})
    return url


@pytest.fixture(scope='module')
def docs_url(tmp_path_factory):
    """48 documents of 4 to 29 tokens (test_packing.py's), 8 per row group;
    returns ``(url, total tokens)``."""
    url = 'file://%s' % tmp_path_factory.mktemp('scan_docs')
    schema = unischema.Unischema('Docs', [
        unischema.UnischemaField('tokens', np.int32, (None,), codecs.NdarrayCodec(), False)])
    rng = np.random.default_rng(0)
    total = 0
    with DatasetWriter(url, schema, rows_per_rowgroup=8) as writer:
        for _ in range(48):
            tokens = np.arange(1, 1 + rng.integers(4, 30), dtype=np.int32)
            total += len(tokens)
            writer.write({'tokens': tokens})
    return url, total


def _jax_scan(loader, step, carry, k):
    with petastorm_tpu.native.disabled():
        return [jax.tree.map(np.asarray, (c, o))
                for c, o in loader.scan_batches(step, carry, steps_per_call=k,
                                                donate_carry=False)]


@pytest.mark.parametrize('shuffle', [False, True])
@pytest.mark.parametrize('steps_per_call', [1, 3, 4])
def test_scan_batches_matches_jax(ids_url, shuffle, steps_per_call):
    """Batch 10 over 64 rows with drop_last=False: 6 full batches and a
    ragged one of 4, which flushes the chunk before it and is a chunk of its
    own; per chunk the same outs (stacked on a leading axis) and carry as
    the JAX loader's lax.scan."""
    def jax_step(carry, batch):
        return carry + batch['id'].sum(), batch['id']

    def port_step(carry, batch):
        return carry + batch['id'].sum(), batch['id']

    reader_kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=shuffle, seed=5,
                         columnar_decode=True)
    with jax_make_reader(ids_url, scheduling='fifo', ingest='off', **reader_kwargs) as reader:
        want = _jax_scan(JaxDataLoader(reader, batch_size=10, drop_last=False), jax_step,
                         jnp.int32(0), steps_per_call)
    with make_reader(ids_url, **reader_kwargs) as reader:
        loader = DataLoader(reader, batch_size=10, drop_last=False, device='cpu')
        got = list(loader.scan_batches(port_step, torch.tensor(0, dtype=torch.int32),
                                       steps_per_call=steps_per_call))
    full = 6 // steps_per_call
    lengths = [steps_per_call] * full + ([6 % steps_per_call] if 6 % steps_per_call else []) + [1]
    assert [tuple(outs.shape) for _, outs in got] == \
        [(k, 10 if i < len(lengths) - 1 else 4) for i, k in enumerate(lengths)]
    assert len(got) == len(want)
    for (carry, outs), (want_carry, want_outs) in zip(got, want):
        assert int(carry) == int(want_carry)
        np.testing.assert_array_equal(outs.numpy(), want_outs)
    assert int(got[-1][0]) == ROWS * (ROWS - 1) // 2
    assert sorted(torch.cat([o.reshape(-1) for _, o in got]).tolist()) == list(range(ROWS))


def test_packed_scan_batches_matches_jax(docs_url):
    """PackedDataLoader inherits scan_batches: packed batches go through k
    steps per chunk, every token packed once (test_packing.py's case), with
    the JAX loader's carry and outs chunk by chunk."""
    url, total = docs_url

    def jax_step(carry, batch):
        return carry + (batch['segment_ids'] > 0).sum(), batch['tokens'].max()

    def port_step(carry, batch):
        return carry + (batch['segment_ids'] > 0).sum(), batch['tokens'].max()

    kwargs = dict(max_len=64, rows_per_batch=4, drop_last=False)
    with jax_make_reader(url, shuffle_row_groups=False, reader_pool_type='dummy') as reader:
        want = _jax_scan(JaxPackedDataLoader(reader, 'tokens', **kwargs), jax_step,
                         jnp.int32(0), 2)
    with make_reader(url, shuffle_row_groups=False, reader_pool_type='dummy') as reader:
        loader = PackedDataLoader(reader, 'tokens', device='cpu', **kwargs)
        got = list(loader.scan_batches(port_step, torch.tensor(0, dtype=torch.int32),
                                       steps_per_call=2))
    assert len(got) == len(want) > 1
    for (carry, outs), (want_carry, want_outs) in zip(got, want):
        assert int(carry) == int(want_carry)
        np.testing.assert_array_equal(outs.numpy(), want_outs)
    assert int(got[-1][0]) == total


def test_scan_batches_applies_transform_fn_per_batch(ids_url):
    """transform_fn sees each host batch before stacking, as in __iter__."""
    seen = []

    def double(batch):
        seen.append(len(batch['id']))
        return dict(batch, id=batch['id'] * 2)

    with make_reader(ids_url, reader_pool_type='dummy', shuffle_row_groups=False,
                     columnar_decode=True) as reader:
        loader = DataLoader(reader, batch_size=16, transform_fn=double, device='cpu')
        outs = [o for _, o in loader.scan_batches(lambda c, b: (c, b['id']), None,
                                                  steps_per_call=3)]
    assert seen == [16] * 4 and [tuple(o.shape) for o in outs] == [(3, 16), (1, 16)]
    assert torch.cat([o.reshape(-1) for o in outs]).tolist() == [2 * i for i in range(ROWS)]


def test_scan_batches_rejects_bad_arguments(ids_url):
    with make_reader(ids_url, reader_pool_type='dummy', columnar_decode=True) as reader:
        loader = DataLoader(reader, batch_size=8, device='cpu')
        with pytest.raises(ValueError, match='steps_per_call'):
            next(loader.scan_batches(lambda c, b: (c, b['id']), None, steps_per_call=0))
        with pytest.raises(ValueError, match='cuda_graph=True needs the card'):
            next(loader.scan_batches(lambda c, b: (c, b['id']), None, cuda_graph=True))

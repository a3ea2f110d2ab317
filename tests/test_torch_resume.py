"""Exact data checkpoints of the port against the JAX package's, on the CPU.

The port's ``RandomShufflingBuffer`` draws the JAX buffer's order; the
port's ``DataLoader`` over a row reader with ``shuffling_queue_capacity``
gives the JAX loader's batches bit for bit.  Then the cases of
``tests/test_loader_resume.py``, each with the transfer plane on
(``transfer=True``: the dispatch thread, batches in flight on the ring)
and off: a token taken after k batches, pickled, resumes fresh reader and
loader objects to exactly the batches the uninterrupted run had left (the
same order on the seeded dummy pool, the same rows on the thread and
process pools).  A JAX loader's token resumes the port's loader to the JAX
run's remaining batches, and the port's tokens have the JAX tokens' keys.
The reference's weighted-sampling case has no counterpart in the port (no
``WeightedSamplingReader``) and is left out.
"""

import pickle
import time

import numpy as np
import pytest
import torch

import petastorm_tpu.native
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.jax import DeviceInMemDataLoader as JaxDeviceInMemDataLoader
from petastorm_tpu.reader_impl.shuffling_buffer import \
    RandomShufflingBuffer as JaxRandomShufflingBuffer

from petastorm_tpu_torch.gpu import (DataLoader, DeviceInMemDataLoader, DiskCachedDataLoader,
                                     InMemDataLoader, PackedDataLoader)
from petastorm_tpu_torch.gpu.transfer import TransferPlane
from petastorm_tpu_torch.reader_impl.shuffling_buffer import (NoopShufflingBuffer,
                                                              RandomShufflingBuffer)

from torch_plane_common import (ROWS, assert_batches_equal, jax_reader, port_reader, to_numpy,
                                write_dataset)

BATCH = 10
TRANSFER = [False, True]


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_resume'))


def _reader(url, pool='dummy', columnar=False, **kwargs):
    kwargs.setdefault('num_epochs', 2)
    kwargs.setdefault('shuffle_row_groups', True)
    kwargs.setdefault('seed', 7)
    if pool != 'dummy':
        kwargs.setdefault('workers_count', 3)
    return port_reader(url, columnar, reader_pool_type=pool, **kwargs)


def _ids(batch):
    return to_numpy(batch)['id'].tolist()


def _uninterrupted(url, loader_kwargs, pool='dummy', columnar=False, cls=DataLoader,
                   batch_size=BATCH):
    with cls(_reader(url, pool, columnar), batch_size, device='cpu', **loader_kwargs) as loader:
        return [to_numpy(b) for b in loader]


def _interrupted(url, k, loader_kwargs, pool='dummy', columnar=False, cls=DataLoader,
                 batch_size=BATCH):
    """k batches, the token (through pickle), and the reader abandoned."""
    reader = _reader(url, pool, columnar)
    loader = cls(reader, batch_size, device='cpu', **loader_kwargs)
    it = iter(loader)
    consumed = [to_numpy(next(it)) for _ in range(k)]
    state = pickle.loads(pickle.dumps(loader.state_dict()))
    it.close()
    reader.stop()
    reader.join()
    return consumed, state


def _resumed(url, state, loader_kwargs, pool='dummy', columnar=False, cls=DataLoader,
             batch_size=BATCH):
    reader = _reader(url, pool, columnar, resume_state=state['reader'])
    with cls(reader, batch_size, device='cpu', resume_state=state, **loader_kwargs) as loader:
        return [to_numpy(b) for b in loader]


def _all_ids(batches):
    return sorted(i for b in batches for i in b['id'].tolist())


# -- the shuffling buffer and the row path against the JAX package ----------

@pytest.mark.parametrize('capacity,min_after', [(8, 4), (24, 12), (100, 99)])
def test_random_shuffling_buffer_draws_the_jax_order(capacity, min_after):
    items = list(range(200))
    port = RandomShufflingBuffer(capacity, min_after, seed=3)
    ref = JaxRandomShufflingBuffer(capacity, min_after, seed=3)
    got, want = [], []
    for buf, out in ((port, got), (ref, want)):
        for i in items:
            buf.add_many([i])
            while buf.can_retrieve():
                out.append(buf.retrieve())
                if len(out) == 70:   # a snapshot mid-stream, restored into a new buffer
                    state = pickle.loads(pickle.dumps(buf.state_dict()))
                    fresh = type(buf)(capacity, min_after, seed=99)
                    fresh.load_state_dict(state)
                    buf.__dict__.update(fresh.__dict__)
        buf.finish()
        while not buf.finished:
            out.append(buf.retrieve())
    assert got == want and sorted(got) == items and got != items


def test_noop_shuffling_buffer_is_fifo_and_round_trips():
    buf = NoopShufflingBuffer()
    buf.add_many([1, 2, 3])
    assert buf.retrieve() == 1
    fresh = NoopShufflingBuffer()
    fresh.load_state_dict(buf.state_dict())
    fresh.finish()
    assert [fresh.retrieve(), fresh.retrieve()] == [2, 3] and fresh.finished


@pytest.mark.parametrize('transfer', TRANSFER)
@pytest.mark.parametrize('capacity', [0, 24])
def test_row_reader_batches_equal_jax_bit_for_bit(url, capacity, transfer):
    kwargs = dict(num_epochs=2, shuffle_row_groups=True, seed=7)
    with petastorm_tpu.native.disabled():
        with JaxDataLoader(jax_reader(url, False, **kwargs), BATCH,
                           shuffling_queue_capacity=capacity, seed=5, drop_last=False,
                           transfer=False) as loader:
            want = [to_numpy(b) for b in loader]
    with DataLoader(port_reader(url, False, **kwargs), BATCH, shuffling_queue_capacity=capacity,
                    seed=5, drop_last=False, device='cpu', transfer=transfer) as loader:
        got = list(loader)
    assert len(got) == -(-2 * ROWS // BATCH)
    assert_batches_equal(got, want)


# -- the resume cases of tests/test_loader_resume.py -------------------------

@pytest.mark.parametrize('transfer', TRANSFER)
@pytest.mark.parametrize('pool', ['dummy', 'thread', 'process'])
def test_multiset_exactness_across_pools(url, pool, transfer):
    """consumed + resumed holds every row exactly twice (2 epochs), with
    rows in flight in the pool at the snapshot."""
    kwargs = dict(seed=5, shuffling_queue_capacity=24, drop_last=False, transfer=transfer)
    consumed, state = _interrupted(url, 3, kwargs, pool)
    resumed = _resumed(url, state, kwargs, pool)
    assert _all_ids(consumed + resumed) == sorted(list(range(ROWS)) * 2)


@pytest.mark.parametrize('transfer', TRANSFER)
@pytest.mark.parametrize('capacity', [0, 24])
def test_exact_order_for_seeded_dummy_pool(url, capacity, transfer):
    """Batch for batch the uninterrupted run's remainder, every field."""
    kwargs = dict(seed=5, shuffling_queue_capacity=capacity, transfer=transfer)
    full = _uninterrupted(url, kwargs)
    for k in (1, 3):
        consumed, state = _interrupted(url, k, kwargs)
        assert_batches_equal(consumed, full[:k])
        assert_batches_equal(_resumed(url, state, kwargs), full[k:])


@pytest.mark.parametrize('transfer', TRANSFER)
def test_checkpoint_then_keep_training(url, transfer):
    kwargs = dict(seed=5, shuffling_queue_capacity=24, transfer=transfer)
    full = _uninterrupted(url, kwargs)
    with DataLoader(_reader(url), BATCH, device='cpu', **kwargs) as loader:
        it = iter(loader)
        got = [to_numpy(next(it)) for _ in range(3)]
        loader.state_dict()
        got.extend(to_numpy(b) for b in it)
    assert_batches_equal(got, full)


@pytest.mark.parametrize('transfer', TRANSFER)
@pytest.mark.parametrize('capacity', [0, 20])
@pytest.mark.parametrize('batch_size', [3, BATCH])
def test_columnar_reader_resume(url, capacity, transfer, batch_size):
    """The chunk residue (and with a shuffle, its columns and generator)
    rides the token; cut at every batch, also in the shuffle's remainder.
    Batches of 3 rows from row groups of 8 leave residues that hold whole
    batches, which a resume serves before the next chunk."""
    kwargs = dict(seed=5, shuffling_queue_capacity=capacity, drop_last=False, transfer=transfer)
    run = dict(columnar=True, batch_size=batch_size)
    full = _uninterrupted(url, kwargs, **run)
    for k in range(1, len(full)):
        consumed, state = _interrupted(url, k, kwargs, **run)
        assert_batches_equal(consumed + _resumed(url, state, kwargs, **run), full)


class _SeqReader(object):
    """Dataset rows as variable-length sequences (len = id % 13 + 1),
    forwarding the reader's checkpoint protocol."""

    num_epochs = 1
    batched_output = False

    def __init__(self, inner):
        self._inner = inner

    @staticmethod
    def _to_seq(row):
        rid = int(row.id)
        return {'tokens': np.full(rid % 13 + 1, rid, np.int32)}

    def __iter__(self):
        return (self._to_seq(row) for row in self._inner)

    def drain_in_flight(self):
        return [self._to_seq(r) for r in self._inner.drain_in_flight()]

    def resume_dispatch(self):
        self._inner.resume_dispatch()

    def state_dict(self):
        return self._inner.state_dict()

    def stop(self):
        self._inner.stop()

    def join(self):
        self._inner.join()


@pytest.mark.parametrize('transfer', TRANSFER)
def test_packed_loader_resume(url, transfer):
    """The packer's residue survives: consumed + resumed packed batches equal
    the uninterrupted run's, batch for batch."""
    def build(resume=None):
        reader = _SeqReader(port_reader(url, False, num_epochs=1,
                                        resume_state=(resume or {}).get('reader')))
        return reader, PackedDataLoader(reader, 'tokens', max_len=16, rows_per_batch=4,
                                        drop_last=False, resume_state=resume, device='cpu',
                                        transfer=transfer)

    _, loader = build()
    with loader:
        full = [to_numpy(b) for b in loader]
    for k in (1, 2, 5):
        reader, loader = build()
        it = iter(loader)
        consumed = [to_numpy(next(it)) for _ in range(k)]
        state = pickle.loads(pickle.dumps(loader.state_dict()))
        assert 'packer' in state and 'packed_ready' in state
        it.close()
        reader.stop()
        reader.join()
        _, loader2 = build(resume=state)
        with loader2:
            resumed = [to_numpy(b) for b in loader2]
        assert_batches_equal(consumed + resumed, full)


@pytest.mark.parametrize('transfer', TRANSFER)
def test_disk_cached_loader_exact_resume(url, tmp_path, transfer):
    """(epoch, offset, order, generator) over the complete cache: exact,
    whatever pool built it; refused during the epoch-0 build."""
    cache = str(tmp_path / 'dcache')

    def build(resume=None):
        reader = port_reader(url, False, reader_pool_type='thread', workers_count=3,
                             num_epochs=1)
        return DiskCachedDataLoader(reader, BATCH, decoded_cache_dir=cache, num_epochs=3,
                                    seed=11, resume_state=resume, device='cpu',
                                    transfer=transfer)

    with build() as loader:
        it = iter(loader)
        next(it)
        with pytest.raises(ValueError, match='epoch-0 build'):
            loader.state_dict()
        list(it)
    with build() as loader:
        twin = [to_numpy(b) for b in loader]
    for k in (2, 9):
        with build() as loader:
            it = iter(loader)
            consumed = [to_numpy(next(it)) for _ in range(k)]
            state = pickle.loads(pickle.dumps(loader.state_dict()))
        with build(resume=state) as loader2:
            resumed = [to_numpy(b) for b in loader2]
        assert_batches_equal(consumed + resumed, twin)


@pytest.mark.parametrize('transfer', TRANSFER)
def test_state_dict_before_first_batch_preserves_restored_state(url, transfer):
    kwargs = dict(seed=5, shuffling_queue_capacity=24, drop_last=False, transfer=transfer)
    full = _uninterrupted(url, kwargs)
    consumed, state = _interrupted(url, 3, kwargs)
    reader = _reader(url, resume_state=state['reader'])
    loader = DataLoader(reader, BATCH, device='cpu', resume_state=state, **kwargs)
    state2 = pickle.loads(pickle.dumps(loader.state_dict()))
    reader.stop()
    reader.join()
    assert_batches_equal(consumed + _resumed(url, state2, kwargs), full)


@pytest.mark.parametrize('transfer', TRANSFER)
def test_inmem_deterministic_exact_resume(url, transfer):
    """The content-sorted cache: a token taken over a thread pool's cache
    resumes over a dummy pool's, exactly."""
    def build(pool, resume=None):
        reader = port_reader(url, False, reader_pool_type=pool, workers_count=3,
                             shuffle_row_groups=pool == 'thread', num_epochs=1)
        return InMemDataLoader(reader, BATCH, num_epochs=3, seed=11,
                               deterministic_cache_order=True, resume_state=resume,
                               device='cpu', transfer=transfer)

    with build('thread') as loader:
        full = [to_numpy(b) for b in loader]
    assert len(full) == 3 * (ROWS // BATCH)
    with build('thread') as loader:
        it = iter(loader)
        consumed = [to_numpy(next(it)) for _ in range(8)]
        state = pickle.loads(pickle.dumps(loader.state_dict()))
    with build('dummy', resume=state) as loader2:
        resumed = [to_numpy(b) for b in loader2]
    assert_batches_equal(consumed + resumed, full)


def test_inmem_without_deterministic_order_refuses(url):
    with InMemDataLoader(port_reader(url, False, num_epochs=1), BATCH, device='cpu') as loader:
        next(iter(loader))
        with pytest.raises(NotImplementedError, match='deterministic_cache_order'):
            loader.state_dict()
    token = {'version': 1, 'inmem_cache': {'rng_state': None, 'epoch': 0, 'offset': 10,
                                           'order': None}}
    with InMemDataLoader(port_reader(url, False, num_epochs=1), BATCH, device='cpu',
                         resume_state=token) as loader:
        with pytest.raises(ValueError, match='deterministic_cache_order'):
            next(iter(loader))


def _device_inmem(url, resume=None, pool='dummy', batch_size=BATCH, **kwargs):
    kwargs.setdefault('num_epochs', 3)
    kwargs.setdefault('seed', 23)
    reader = port_reader(url, False, reader_pool_type=pool, num_epochs=1)
    return DeviceInMemDataLoader(reader, batch_size, resume_state=resume, device='cpu',
                                 **kwargs)


def _scan(loader, **kwargs):
    return [outs.numpy() for _, outs in loader.scan_epochs(
        lambda c, b: (c, b['id']), torch.zeros((), dtype=torch.int32), **kwargs)]


@pytest.mark.parametrize('transfer', TRANSFER)
def test_device_inmem_epoch_boundary_resume(url, transfer):
    """(epochs_done, seed) determine the continuation; mid-epoch without the
    content-sorted cache is refused; a boundary token takes another batch
    size; a wrong seed is refused."""
    with _device_inmem(url, transfer=transfer) as loader:
        full = [_ids(b) for b in loader]
    steps = ROWS // BATCH
    with _device_inmem(url, transfer=transfer) as loader:
        it = iter(loader)
        consumed = [_ids(next(it)) for _ in range(steps)]
        state = pickle.loads(pickle.dumps(loader.state_dict()))
        next(it)
        with pytest.raises(ValueError, match='deterministic_cache_order'):
            loader.state_dict()
    with _device_inmem(url, resume=state, transfer=transfer) as loader2:
        assert consumed + [_ids(b) for b in loader2] == full
    with _device_inmem(url, resume=state, batch_size=BATCH * 2, drop_last=False) as loader3:
        rows = sorted(i for b in loader3 for i in _ids(b))
    assert rows == sorted(list(range(ROWS)) * 2)
    with pytest.raises(ValueError, match='seed'):
        _device_inmem(url, resume=state, seed=99)


def test_device_inmem_scan_epochs_resume(url):
    """A token between scan_epochs yields (epoch boundaries) resumes the
    remaining epochs exactly."""
    with _device_inmem(url, seed=31) as loader:
        full = np.concatenate(_scan(loader))
    with _device_inmem(url, seed=31) as loader:
        gen = loader.scan_epochs(lambda c, b: (c, b['id']), torch.zeros((), dtype=torch.int32))
        first = [next(gen)[1].numpy()]
        state = loader.state_dict()
        gen.close()
    assert state['device_inmem']['epochs_done'] == 1
    with _device_inmem(url, resume=state, seed=31) as loader2:
        rest = _scan(loader2)
    np.testing.assert_array_equal(np.concatenate(first + rest), full)


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_device_inmem_mid_epoch_resume_deterministic(url, pool):
    """A mid-epoch token over the content-sorted cache: the per-step
    continuation on another pool, a snapshot before the first batch, the
    batch-size check, and scan_epochs finishing the partial epoch first."""
    kwargs = dict(seed=47, deterministic_cache_order=True)
    with _device_inmem(url, **kwargs) as loader:
        full = [_ids(b) for b in loader]
    steps = ROWS // BATCH
    cut = steps + 2
    with _device_inmem(url, **kwargs) as loader:
        it = iter(loader)
        consumed = [_ids(next(it)) for _ in range(cut)]
        state = pickle.loads(pickle.dumps(loader.state_dict()))
    assert state['device_inmem']['steps_into_epoch'] == 2
    with _device_inmem(url, resume=state, pool=pool, **kwargs) as loader2:
        assert loader2.state_dict()['device_inmem']['steps_into_epoch'] == 2
        assert consumed + [_ids(b) for b in loader2] == full
    reader = port_reader(url, False, num_epochs=1)
    with pytest.raises(ValueError, match='batch_size'):
        DeviceInMemDataLoader(reader, BATCH + 1, num_epochs=3, resume_state=state,
                              device='cpu', **kwargs)
    with _device_inmem(url, resume=state, **kwargs) as loader3:
        groups = _scan(loader3)
    assert [g.shape[0] for g in groups] == [steps - 2, steps]
    assert np.concatenate(groups).reshape(-1, BATCH).tolist() == full[cut:]


def test_device_inmem_scan_epochs_mid_epoch_grouped_resume(url):
    kwargs = dict(seed=53, deterministic_cache_order=True)
    steps = ROWS // BATCH
    with _device_inmem(url, **kwargs) as loader:
        full = [_ids(b) for b in loader]
    with _device_inmem(url, **kwargs) as loader:
        it = iter(loader)
        next(it)
        next(it)
        state = loader.state_dict()
    with _device_inmem(url, resume=state, **kwargs) as loader2:
        groups = _scan(loader2, epochs_per_call=2)
    assert [g.shape for g in groups] == [(1, steps - 2, BATCH), (2, steps, BATCH)]
    assert np.concatenate([g.reshape(-1, BATCH) for g in groups]).tolist() == full[2:]


def test_device_inmem_scan_epochs_ragged_tail_token_resumes_next_epoch(url):
    steps = ROWS // BATCH
    assert ROWS % BATCH
    kwargs = dict(num_epochs=2, seed=59, deterministic_cache_order=True)
    with _device_inmem(url, **kwargs) as loader:
        base = _scan(loader)
    with _device_inmem(url, drop_last=False, **kwargs) as loader:
        it = iter(loader)
        for _ in range(steps):
            next(it)
        state = loader.state_dict()
    assert state['device_inmem']['steps_into_epoch'] == steps
    with _device_inmem(url, resume=state, **kwargs) as loader2:
        groups = _scan(loader2)
    assert [g.shape for g in groups] == [(steps, BATCH)]
    np.testing.assert_array_equal(groups[0], base[1])


def _forged(steps_into_epoch, batch_size=BATCH, seed=61, **extra):
    return {'version': 1, 'device_inmem': dict(epochs_done=0, steps_into_epoch=steps_into_epoch,
                                               batch_size=batch_size, seed=seed, **extra)}


@pytest.mark.parametrize('batch_size,cursor', [(BATCH, 50), (8, 8)])
def test_device_inmem_scan_epochs_rejects_geometry_changed_token(url, batch_size, cursor):
    reader = port_reader(url, False, num_epochs=1)
    with DeviceInMemDataLoader(reader, batch_size, num_epochs=2, seed=61,
                               deterministic_cache_order=True, device='cpu',
                               resume_state=_forged(cursor, batch_size)) as loader:
        with pytest.raises(ValueError, match='geometry'):
            _scan(loader)


@pytest.mark.parametrize('token_drop_last', [True, False, None])
def test_device_inmem_scan_epochs_ragged_cursor_honors_token_drop_last(url, token_drop_last):
    """A cursor at the full-batch count resumes at the next epoch only for
    a token that records drop_last=False; drop_last=True or no flag raise."""
    steps = ROWS // BATCH
    extra = {} if token_drop_last is None else {'drop_last': token_drop_last}
    with _device_inmem(url, resume=_forged(steps, seed=67, **extra), num_epochs=2, seed=67,
                       deterministic_cache_order=True) as loader:
        if token_drop_last is False:
            assert [g.shape for g in _scan(loader)] == [(steps, BATCH)]
        else:
            with pytest.raises(ValueError, match='drop_last'):
                _scan(loader)


def test_device_inmem_mid_epoch_token_requires_deterministic(url):
    with pytest.raises(ValueError, match='deterministic_cache_order'):
        _device_inmem(url, resume=_forged(3, seed=47), seed=47)
    with pytest.raises(ValueError, match='resume_state'):
        _device_inmem(url, resume={'version': 1, 'pending': []})


# -- the JAX package's tokens and the port's ----------------------------------

@pytest.mark.parametrize('columnar,capacity', [(False, 0), (False, 24), (True, 0), (True, 20)])
def test_a_jax_token_resumes_the_port(url, columnar, capacity):
    """A token the JAX loader took (dummy pool, default dtypes) resumes the
    port's loader to the JAX run's remaining batches; both packages' tokens
    (the loader's and its reader's) have the same keys."""
    kwargs = dict(num_epochs=2, shuffle_row_groups=True, seed=7)
    loader_kwargs = dict(shuffling_queue_capacity=capacity, seed=5, drop_last=False)
    with petastorm_tpu.native.disabled():
        with JaxDataLoader(jax_reader(url, columnar, **kwargs), BATCH, transfer=False,
                           **loader_kwargs) as loader:
            full = [to_numpy(b) for b in loader]
        reader = jax_reader(url, columnar, **kwargs)
        loader = JaxDataLoader(reader, BATCH, transfer=False, **loader_kwargs)
        it = iter(loader)
        consumed = [to_numpy(next(it)) for _ in range(3)]
        jax_state = pickle.loads(pickle.dumps(loader.state_dict()))
        reader.stop()
        reader.join()
    assert_batches_equal(consumed, full[:3])
    port = port_reader(url, columnar, resume_state=jax_state['reader'], **kwargs)
    with DataLoader(port, BATCH, device='cpu', resume_state=jax_state,
                    **loader_kwargs) as loader:
        assert_batches_equal([to_numpy(b) for b in loader], full[3:])
    _, port_state = _interrupted(url, 3, dict(loader_kwargs, transfer=True), columnar=columnar)
    assert sorted(port_state) == sorted(jax_state)
    assert sorted(port_state['reader']) == sorted(jax_state['reader'])


def test_a_jax_device_inmem_token_resumes_the_port(url):
    kwargs = dict(num_epochs=3, seed=47, deterministic_cache_order=True)
    with petastorm_tpu.native.disabled():
        with JaxDeviceInMemDataLoader(jax_reader(url, False, num_epochs=1), BATCH,
                                      **kwargs) as loader:
            it = iter(loader)
            for _ in range(8):
                next(it)
            jax_state = pickle.loads(pickle.dumps(loader.state_dict()))
    with _device_inmem(url, **kwargs) as loader:
        full = [_ids(b) for b in loader]
    with _device_inmem(url, resume=jax_state, **kwargs) as loader:
        assert [_ids(b) for b in loader] == full[8:]


def test_a_foreign_topology_token_raises(url):
    state = _reader(url).state_dict()
    for key, value in (('num_global_pieces', 3), ('shuffle', False), ('shard_count', 2)):
        with pytest.raises(ValueError, match='topology'):
            _reader(url, resume_state=dict(state, **{key: value}))
    # a prologue (an elastic reshard's) is read first, then the epochs
    with _reader(url, resume_state=dict(state, prologue=[(3, 0), (0, 0)])) as reader:
        rows = [int(r.id) for r in reader]
    with _reader(url) as reader:
        full = [int(r.id) for r in reader]
    assert rows == list(range(24, 32)) + list(range(8)) + full


# -- what the snapshot takes from the card ------------------------------------

def test_a_bfloat16_leaf_goes_back_as_the_same_bits():
    from petastorm_tpu_torch.gpu.loader import _filter_numeric, _to_host
    batch = {'x': torch.randn(4, 3).to(torch.bfloat16), 'y': torch.arange(4, dtype=torch.int32)}
    host = pickle.loads(pickle.dumps(_to_host(batch, None)))
    assert isinstance(host['x'], torch.Tensor) and isinstance(host['y'], np.ndarray)
    back, _ = TransferPlane('cpu').put_inline(_filter_numeric(host, set()))
    assert back['x'].dtype == torch.bfloat16 and torch.equal(back['x'], batch['x'])
    assert torch.equal(back['y'], batch['y'])


def test_narrowed_wire_batches_in_flight_resume_exactly(url):
    """Under wire_dtypes='auto' the batches in flight were narrowed to
    bfloat16 on the wire and cast back: the token carries them as they were
    on the device, and the resumed stream equals the uninterrupted one."""
    kwargs = dict(transfer=True, wire_dtypes='auto', prefetch=3)
    full = _uninterrupted(url, kwargs, columnar=True)
    assert full[0]['matrix'].dtype == np.float32
    consumed, state = _interrupted(url, 2, kwargs, columnar=True)
    assert len(state['pending']) >= 1
    assert_batches_equal(consumed + _resumed(url, state, kwargs, columnar=True), full)


def test_a_pump_error_raises_from_the_snapshot(url):
    calls = []

    def transform(batch):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError('transform failed')
        return batch

    reader = _reader(url)
    with DataLoader(reader, BATCH, device='cpu', transfer=True, prefetch=1,
                    transform_fn=transform) as loader:
        it = iter(loader)
        next(it)
        deadline = time.monotonic() + 10
        while loader._pump.alive and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match='transform failed'):
            loader.state_dict()

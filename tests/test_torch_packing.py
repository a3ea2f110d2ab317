"""The port's sequence packing and ``PackedDataLoader`` against the JAX
package's: the host packers bit for bit (values and dtypes), the device
helpers on the same numpy inputs (masks and targets exactly, dense packed
attention within 2e-5 in fp32), and the loader's batches bit for bit on
one dataset read in one order (dummy pool, row groups unshuffled)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import PackedDataLoader as JaxPackedDataLoader
from petastorm_tpu.jax import packing as jax_packing

from petastorm_tpu_torch.gpu import PackedDataLoader, packing
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.train_lm import write_var_token_dataset


def _docs(seed, n=40, lo=1, hi=60, dtypes=(np.int32,)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, rng.integers(lo, hi)).astype(dtypes[i % len(dtypes)])
            for i in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            g_arr = g[key].numpy() if isinstance(g[key], torch.Tensor) else g[key]
            w_arr = np.asarray(w[key])
            assert g_arr.dtype == w_arr.dtype, (key, g_arr.dtype, w_arr.dtype)
            np.testing.assert_array_equal(g_arr, w_arr, err_msg=key)


@pytest.mark.parametrize('max_len', [60, 64, 128])
def test_pack_sequences_matches_jax(max_len):
    docs = _docs(0, dtypes=(np.int32, np.int16))
    _assert_batches_equal([packing.pack_sequences(docs, max_len, pad_id=7)],
                          [jax_packing.pack_sequences(docs, max_len, pad_id=7)])
    for bad in ([], [np.zeros(max_len + 1, np.int32)], [np.zeros((2, 2), np.int32)]):
        with pytest.raises(ValueError):
            packing.pack_sequences(bad, max_len)


@pytest.mark.parametrize('drop_last', [False, True])
@pytest.mark.parametrize('rows_per_batch,open_rows,pad_id', [(4, 32, 0), (3, 2, 5), (1, 1, 0)])
def test_pack_stream_matches_jax(rows_per_batch, open_rows, pad_id, drop_last):
    """Mixed dtypes (the sticky promotion), exactly-full rows and a short
    tail padded with all-padding rows."""
    docs = _docs(1, n=50, lo=1, hi=65, dtypes=(np.int16, np.int32, np.int64))
    docs[7] = np.arange(64, dtype=np.int32)     # an exactly-full row
    kwargs = dict(pad_id=pad_id, open_rows=open_rows, drop_last=drop_last)
    got = list(packing.pack_stream(iter(docs), 64, rows_per_batch, **kwargs))
    want = list(jax_packing.pack_stream(iter(docs), 64, rows_per_batch, **kwargs))
    _assert_batches_equal(got, want)
    assert got and all(b['tokens'].shape == (rows_per_batch, 64) for b in got)


def test_stream_packer_state_dict_round_trip_mid_stream():
    """Snapshot the port's packer mid-stream, restore it into a fresh port
    packer and into a JAX packer: the rest of the stream packs the same as
    the uninterrupted JAX packer's."""
    docs = _docs(2, n=60, hi=40, dtypes=(np.int32, np.int64))
    jax_ref = jax_packing.StreamPacker(64, 3, open_rows=4)
    packer = packing.StreamPacker(64, 3, open_rows=4)
    want, got_head = [], []
    for seq in docs[:25]:
        want.extend(jax_ref.add(seq))
        got_head.extend(packer.add(seq))
    state = packer.state_dict()
    want_state = jax_ref.state_dict()
    assert state['dtype'] == want_state['dtype']
    assert [room for room, _ in state['open']] == [room for room, _ in want_state['open']]
    for seqs, want_seqs in zip([s for _, s in state['open']] + state['closed'],
                               [s for _, s in want_state['open']] + want_state['closed']):
        _assert_batches_equal([dict(enumerate(seqs))], [dict(enumerate(want_seqs))])
    restored = packing.StreamPacker(64, 3, open_rows=4)
    restored.load_state_dict(state)
    jax_restored = jax_packing.StreamPacker(64, 3, open_rows=4)
    jax_restored.load_state_dict(state)
    got, got_jax = list(got_head), list(got_head)
    for seq in docs[25:]:
        want.extend(jax_ref.add(seq))
        got.extend(restored.add(seq))
        got_jax.extend(jax_restored.add(seq))
    want.extend(jax_ref.flush())
    got.extend(restored.flush())
    got_jax.extend(jax_restored.flush())
    _assert_batches_equal(got, want)
    _assert_batches_equal(got_jax, want)


def _packed(seed, max_len=48):
    return packing.pack_sequences(_docs(seed, n=6, lo=3, hi=30), max_len)


@pytest.mark.parametrize('causal', [False, True])
def test_segment_mask_matches_jax(causal):
    seg = _packed(3)['segment_ids']
    seg_kv = np.roll(seg, 5, axis=1)
    want = np.asarray(jax_packing.segment_mask(seg, seg_kv, causal=causal))
    got = packing.segment_mask(torch.tensor(seg), torch.tensor(seg_kv), causal=causal)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_next_token_targets_matches_jax_for_numpy_and_tensors():
    batch = _packed(4)
    tokens, seg = batch['tokens'], batch['segment_ids']
    want_t, want_w = (np.asarray(a) for a in jax_packing.next_token_targets(
        jnp.asarray(tokens), jnp.asarray(seg)))
    np_t, np_w = packing.next_token_targets(tokens, seg)
    assert isinstance(np_t, np.ndarray) and np_w.dtype == np.float32
    t_t, t_w = packing.next_token_targets(torch.tensor(tokens), torch.tensor(seg))
    assert isinstance(t_t, torch.Tensor) and t_w.dtype == torch.float32
    for t, w in ((np_t, np_w), (t_t.numpy(), t_w.numpy())):
        np.testing.assert_array_equal(t, want_t)
        np.testing.assert_array_equal(w, want_w)


@pytest.mark.parametrize('causal', [False, True])
def test_packed_attention_matches_jax(causal):
    """fp32, real packer output with padding rows at every row's tail:
    within 2e-5, and the padding rows exactly 0 on both sides."""
    seg = _packed(5)['segment_ids']
    b, s = seg.shape
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((b, s, 2, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_packing.packed_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                                   jnp.asarray(seg), causal=causal))
    got = packing.packed_attention(*(torch.tensor(a) for a in (q, k, v)), torch.tensor(seg),
                                   causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert (got.numpy()[seg == 0] == 0).all() and (want[seg == 0] == 0).all()


@pytest.fixture(scope='module')
def var_token_url(tmp_path_factory):
    """The packed example's dataset, cut to 96 documents (2 row groups)."""
    url = 'file://%s' % tmp_path_factory.mktemp('var_tokens')
    return write_var_token_dataset(url, num_docs=96)


def _jax_batches(url, transform_fn=None, **kwargs):
    with jax_make_reader(url, schema_fields=['tokens'], num_epochs=1, reader_pool_type='dummy',
                         shuffle_row_groups=False) as reader:
        loader = JaxPackedDataLoader(reader, 'tokens', transform_fn=transform_fn, **kwargs)
        return [jax.tree.map(np.asarray, b) for b in loader]


def _port_batches(url, transform_fn=None, **kwargs):
    with make_reader(url, schema_fields=['tokens'], num_epochs=1, reader_pool_type='dummy',
                     shuffle_row_groups=False) as reader:
        loader = PackedDataLoader(reader, 'tokens', transform_fn=transform_fn, device='cpu',
                                  **kwargs)
        return list(loader)


@pytest.mark.parametrize('drop_last', [True, False])
@pytest.mark.parametrize('max_len,rows_per_batch', [(512, 4), (600, 3)])
def test_packed_loader_matches_jax(var_token_url, max_len, rows_per_batch, drop_last):
    kwargs = dict(max_len=max_len, rows_per_batch=rows_per_batch, drop_last=drop_last,
                  prefetch=2)
    got, want = _port_batches(var_token_url, **kwargs), _jax_batches(var_token_url, **kwargs)
    _assert_batches_equal(got, want)
    if not drop_last:
        tail = got[-1]['segment_ids'].numpy()
        assert tail.shape == (rows_per_batch, max_len) and (tail[:, -1] == 0).all()


def test_packed_loader_applies_transform_fn_as_jax_does(var_token_url):
    """``transform_fn`` sees each packed host batch (numpy) before transfer,
    its result is what moves (new keys included), and non-numeric keys it
    adds stay behind."""
    def make_transform(log):
        def transform(batch):
            log.append({k: np.array(v) for k, v in batch.items()})
            return dict(batch, real=(batch['segment_ids'] > 0).sum(axis=1).astype(np.int64),
                        note=np.array(['x'] * len(batch['tokens'])))
        return transform

    got_log, want_log = [], []
    kwargs = dict(max_len=512, rows_per_batch=4, drop_last=False)
    got = _port_batches(var_token_url, make_transform(got_log), **kwargs)
    want = _jax_batches(var_token_url, make_transform(want_log), **kwargs)
    _assert_batches_equal(got_log, want_log)
    _assert_batches_equal(got, want)
    assert 'note' not in got[0] and got[0]['real'].dtype == torch.int32


def test_packed_loader_rejections(var_token_url):
    with make_reader(var_token_url, num_epochs=1, reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError, match='shuffling_queue_capacity'):
            PackedDataLoader(reader, 'tokens', 64, 4, shuffling_queue_capacity=8, device='cpu')
    with make_reader(var_token_url, num_epochs=1, reader_pool_type='dummy',
                     columnar_decode=True) as reader:
        with pytest.raises(ValueError, match='row reader'):
            PackedDataLoader(reader, 'tokens', 64, 4, device='cpu')

"""Elastic resharding (``petastorm_tpu_torch.elastic``) against the JAX
package's ``elastic``, on the CPU.

Tokens: for the same JAX-made tokens, ``reshard_reader_states``,
``reshard_loader_states`` and ``reshard_weighted_states`` return exactly
JAX's tokens at (K, M) in (2, 3), (3, 2), (2, 1) and (1, 4); a port reader
resumed from such a token yields the JAX reader's rows bit for bit on the
dummy pool, and a port reader part-way through its prologue gives JAX's
token.  Delivery: resharded loader checkpoints deliver every row exactly
``num_epochs`` times on the dummy pool and lose none on threads (row,
columnar and batch readers, ``shard_seed``, more shards than row groups,
exhausted tokens, the per-host ``TrainStateManager`` flow), and a batch in
flight re-enters another loader with the device dtypes.  Errors: the port
raises where JAX does.  Data are compared exactly.
"""

import pickle
from collections import Counter

import numpy as np
import pytest
import torch

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.elastic import reshard_loader_states as jax_reshard_loader_states
from petastorm_tpu.elastic import reshard_reader_states as jax_reshard_reader_states
from petastorm_tpu.elastic import reshard_weighted_states as jax_reshard_weighted_states
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.weighted_sampling_reader import WeightedSamplingReader

from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch import reshard_loader_states, reshard_reader_states
from petastorm_tpu_torch.checkpoint import TrainStateManager
from petastorm_tpu_torch.elastic import reshard_weighted_states
from petastorm_tpu_torch.gpu import DataLoader

from torch_plane_common import to_numpy, write_dataset

ROWS = 96            # 12 row groups of 8
GROUP = 8
EPOCHS = 2
SHARDINGS = [(2, 3), (3, 2), (2, 1), (1, 4)]
KW = dict(num_epochs=EPOCHS, shuffle_row_groups=True, seed=11, reader_pool_type='dummy')


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_elastic'), rows=ROWS)


def _jax_reader(url, shard, count, columnar=False, **kwargs):
    kwargs = dict(KW, **kwargs)
    return jax_make_reader(url, cur_shard=shard, shard_count=count, columnar_decode=columnar,
                           scheduling='fifo', ingest='off', **kwargs)


def _reader(url, shard, count, columnar=False, **kwargs):
    return make_reader(url, cur_shard=shard, shard_count=count, columnar_decode=columnar,
                       **dict(KW, **kwargs))


def _id(row):
    return int(row.id if hasattr(row, 'id') else row['id'])


def _reader_tokens(make, url, k, **kwargs):
    """K readers, shard s having taken 7 (s + 1) rows, each drained then
    snapshotted; returns the rows taken and the tokens."""
    consumed, states = [], []
    for s in range(k):
        reader = make(url, s, k, **kwargs)
        for _ in range((s + 1) * 7):
            consumed.append(_id(next(reader)))
        consumed.extend(_id(r) for r in reader.drain_in_flight())
        states.append(reader.state_dict())
        reader.stop()
        reader.join()
    return consumed, states


def _deep_equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) \
            and all(_deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) \
            and all(_deep_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and bool(np.all(a == b))
    return type(a) is type(b) and a == b


# -- tokens against JAX --------------------------------------------------------

@pytest.mark.parametrize('k,m', SHARDINGS)
def test_reshard_reader_states_returns_jax_tokens(url, k, m):
    _, states = _reader_tokens(_jax_reader, url, k)
    states = pickle.loads(pickle.dumps(states))
    assert reshard_reader_states(states, m) == jax_reshard_reader_states(states, m)


def _jax_loader_states(url, k, columnar):
    states = []
    for s in range(k):
        reader = _jax_reader(url, s, k, columnar=columnar)
        loader = JaxDataLoader(reader, batch_size=5, prefetch=2)
        it = iter(loader)
        for _ in range(2 + s):
            next(it)
        states.append(loader.state_dict())
        loader.__exit__(None, None, None)
    return pickle.loads(pickle.dumps(states))


@pytest.mark.parametrize('k,m', SHARDINGS)
@pytest.mark.parametrize('columnar', [False, True])
def test_reshard_loader_states_returns_jax_tokens(url, k, m, columnar):
    states = _jax_loader_states(url, k, columnar)
    assert any(s['pending'] or s['pushback'] or s['partial_rows'] or s['chunks'] for s in states)
    assert _deep_equal(reshard_loader_states(states, m), jax_reshard_loader_states(states, m))


@pytest.mark.parametrize('k,m', SHARDINGS)
def test_reshard_weighted_states_returns_jax_tokens(url, k, m):
    states = []
    for s in range(k):
        mixer = WeightedSamplingReader([_jax_reader(url, s, k), _jax_reader(url, s, k, seed=3)],
                                       [0.7, 0.3], seed=s, exhaust='drop')
        for _ in range(5):
            next(mixer)
        mixer.drain_in_flight()
        states.append(mixer.state_dict())
        mixer.stop()
        mixer.join()
    states = pickle.loads(pickle.dumps(states))
    # the constituents' seeds differ (11 and 3); each source reshards alone
    assert _deep_equal(reshard_weighted_states(states, m, seed=9),
                       jax_reshard_weighted_states(states, m, seed=9))


def _rows_as_numpy(reader):
    with reader:
        return [{k: np.asarray(v) for k, v in row._asdict().items()} for row in reader]


@pytest.mark.parametrize('k,m', SHARDINGS)
def test_a_resumed_port_reader_yields_the_jax_rows(url, k, m):
    consumed, states = _reader_tokens(_jax_reader, url, k)
    tokens = jax_reshard_reader_states(states, m)
    after = []
    for shard, token in enumerate(tokens):
        want = _rows_as_numpy(_jax_reader(url, shard, m, resume_state=token))
        got = _rows_as_numpy(_reader(url, shard, m, resume_state=token))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        after.extend(int(r['id']) for r in got)
    assert Counter(consumed) + Counter(after) == Counter({i: EPOCHS for i in range(ROWS)})


@pytest.mark.parametrize('taken,left', [(1, 2), (9, 1), (17, 0)])
def test_a_token_taken_inside_the_prologue_is_jax_token(url, taken, left):
    """A token taken while prologue items are in flight names the prologue
    from the oldest one not processed on; once the prologue is processed,
    the token is a plain epoch position.  Port and JAX readers agree."""
    _, states = _reader_tokens(_reader, url, 2)
    # fixed positions: how far the ventilator ran ahead of the drain, and so
    # each token's cursor, depends on thread timing
    states[0].update(epoch=0, cursor=4)
    states[1].update(epoch=0, cursor=5)
    token = reshard_reader_states(states, 1)[0]
    assert len(token['prologue']) == 3
    got = []
    for make in (_reader, _jax_reader):
        reader = make(url, 0, 1, resume_state=token)
        for _ in range(taken):
            next(reader)
        got.append(reader.state_dict())
        reader.stop()
        reader.join()
    assert got[0] == got[1]
    assert got[0].get('prologue', []) == token['prologue'][len(token['prologue']) - left:]


# -- delivery --------------------------------------------------------------------

def _port_loader_round(url, k, m, pool='dummy', columnar=False, transfer=False, **loader_kw):
    kwargs = dict(reader_pool_type=pool)
    if pool != 'dummy':
        kwargs['workers_count'] = 2
    consumed, states = [], []
    for s in range(k):
        loader = DataLoader(_reader(url, s, k, columnar=columnar, **kwargs), batch_size=5,
                            prefetch=2, device='cpu', transfer=transfer, **loader_kw)
        it = iter(loader)
        for _ in range(2 + s):
            consumed.extend(to_numpy(next(it))['id'].tolist())
        states.append(pickle.loads(pickle.dumps(loader.state_dict())))
        loader.__exit__(None, None, None)
    after = []
    for shard, state in enumerate(reshard_loader_states(states, m)):
        reader = _reader(url, shard, m, columnar=columnar, resume_state=state['reader'],
                         **kwargs)
        with DataLoader(reader, batch_size=5, prefetch=2, drop_last=False, device='cpu',
                        transfer=transfer, resume_state=state, **loader_kw) as loader:
            after.extend(i for b in loader for i in to_numpy(b)['id'].tolist())
    return Counter(consumed) + Counter(after)


@pytest.mark.parametrize('k,m', SHARDINGS)
@pytest.mark.parametrize('columnar,transfer', [(False, False), (True, True)])
def test_a_resharded_loader_checkpoint_is_exact_on_the_dummy_pool(url, k, m, columnar, transfer):
    assert _port_loader_round(url, k, m, columnar=columnar, transfer=transfer) \
        == Counter({i: EPOCHS for i in range(ROWS)})


@pytest.mark.parametrize('columnar', [False, True])
def test_a_resharded_shuffling_loader_is_exact(url, columnar):
    assert _port_loader_round(url, 2, 3, columnar=columnar, shuffling_queue_capacity=12,
                              seed=5) == Counter({i: EPOCHS for i in range(ROWS)})


def test_a_resharded_loader_loses_nothing_on_threads(url):
    total = _port_loader_round(url, 2, 3, pool='thread', transfer=True)
    assert all(total[i] >= EPOCHS for i in range(ROWS)), total


def test_a_batch_in_flight_enters_another_loader_in_device_dtypes(url):
    loader = DataLoader(_reader(url, 0, 1), batch_size=5, prefetch=3, device='cpu',
                        transfer=True)
    it = iter(loader)
    first = next(it)
    state = loader.state_dict()
    loader.__exit__(None, None, None)
    assert state['pending']
    token = reshard_loader_states([state], 2)
    moved = token[1]['pending'][0] if token[1]['pending'] else token[0]['pending'][0]
    owner = 1 if token[1]['pending'] else 0
    with DataLoader(_reader(url, owner, 2, resume_state=token[owner]['reader']), batch_size=5,
                    device='cpu', resume_state=token[owner]) as again:
        batch = next(iter(again))
    assert batch['id'].dtype == torch.int32 and batch['decimal_like'].dtype == torch.float32
    assert batch['id'].device.type == 'cpu'
    assert batch['id'].tolist() == np.asarray(moved['id']).tolist()
    assert first['id'].dtype == batch['id'].dtype


def test_a_batch_reader_reshards(url):
    consumed, states = [], []
    for s in range(2):
        reader = make_batch_reader(url, cur_shard=s, shard_count=2, **KW)
        for _ in range(1 + s):
            consumed.extend(next(reader).id.tolist())
        for chunk in reader.drain_in_flight():
            consumed.extend(chunk.id.tolist())
        states.append(reader.state_dict())
        reader.stop()
        reader.join()
    tokens = reshard_reader_states(states, 3)
    for shard, token in enumerate(tokens):
        with make_batch_reader(url, cur_shard=shard, shard_count=3, resume_state=token,
                               **KW) as reader:
            got = [i for chunk in reader for i in chunk.id.tolist()]
        with jax_make_batch_reader(url, cur_shard=shard, shard_count=3, resume_state=token,
                                   scheduling='fifo', ingest='off', **KW) as reader:
            assert got == [i for chunk in reader for i in chunk.id.tolist()]
        consumed.extend(got)
    assert Counter(consumed) == Counter({i: EPOCHS for i in range(ROWS)})


def test_shard_seed_reshards(url):
    consumed, states = _reader_tokens(_reader, url, 2, shard_seed=42)
    assert all(s['shard_seed'] == 42 and s['shard_scheme'] == 'rs-perm-v1' for s in states)
    tokens = reshard_reader_states(states, 3)
    assert tokens == jax_reshard_reader_states(states, 3)
    for shard, token in enumerate(tokens):
        assert token['shard_seed'] == 42
        with _reader(url, shard, 3, shard_seed=42, resume_state=token) as reader:
            consumed.extend(_id(r) for r in reader)
    assert Counter(consumed) == Counter({i: EPOCHS for i in range(ROWS)})
    with pytest.raises(ValueError, match='shard_seed'):
        reshard_reader_states([states[0], dict(states[1], shard_seed=7)], 3)


def test_more_shards_than_row_groups(url):
    consumed, states = _reader_tokens(_reader, url, 2, num_epochs=1)
    tokens = reshard_reader_states(states, 16)   # 12 row groups
    for shard, token in enumerate(tokens):
        with _reader(url, shard, 16, num_epochs=1, resume_state=token) as reader:
            consumed.extend(_id(r) for r in reader)
    assert Counter(consumed) == Counter({i: 1 for i in range(ROWS)})


def test_exhausted_tokens_reshard_to_nothing(url):
    readers = [_reader(url, s, 2, num_epochs=1) for s in range(2)]
    for reader in readers:
        list(reader)
    states = [r.state_dict() for r in readers]
    for reader in readers:
        reader.stop()
        reader.join()
    tokens = reshard_reader_states(states, 2)
    assert tokens == jax_reshard_reader_states(states, 2)
    assert all(t['epoch'] == 1 and not t['prologue'] for t in tokens)


def test_the_per_host_train_state_manager_flow(url, tmp_path):
    consumed = []
    for s in range(2):
        loader = DataLoader(_reader(url, s, 2), batch_size=5, prefetch=2, device='cpu')
        it = iter(loader)
        for _ in range(2 + s):
            consumed.extend(to_numpy(next(it))['id'].tolist())
        with TrainStateManager(tmp_path / ('host_%d' % s), async_save=False) as mgr:
            mgr.save(10, {'w': torch.zeros(2)}, data_state=loader.state_dict(), force=True)
        loader.__exit__(None, None, None)
    states = []
    for s in range(2):
        step, model_state, token = TrainStateManager.restore_latest_from(tmp_path / ('host_%d' % s))
        assert step == 10 and torch.equal(model_state['w'], torch.zeros(2))
        states.append(token)
    after = []
    for shard, state in enumerate(reshard_loader_states(states, 3)):
        reader = _reader(url, shard, 3, resume_state=state['reader'])
        with DataLoader(reader, batch_size=5, drop_last=False, device='cpu',
                        resume_state=state) as loader:
            after.extend(i for b in loader for i in to_numpy(b)['id'].tolist())
    assert Counter(consumed) + Counter(after) == Counter({i: EPOCHS for i in range(ROWS)})


# -- errors where JAX raises ---------------------------------------------------

def _idle_states(url, k=2, **kwargs):
    readers = [_reader(url, s, k, **kwargs) for s in range(k)]
    states = [r.state_dict() for r in readers]
    for reader in readers:
        reader.stop()
        reader.join()
    return states


@pytest.mark.parametrize('case', ['missing_shard', 'zero_shards', 'bare_token',
                                  'duplicate_shard', 'num_epochs', 'topology'])
def test_validation_raises_as_jax(url, case):
    states = _idle_states(url)
    bare = {'epoch': 0, 'cursor': 0, 'seed': 0}
    args, match = {
        'missing_shard': ((states[:1], 2), 'every shard'),
        'zero_shards': ((states, 0), 'new_shard_count'),
        'bare_token': (([bare, bare], 2), 'topology'),
        'duplicate_shard': (([states[0], dict(states[1], cur_shard=0)], 2), 'duplicate'),
        'num_epochs': (([states[0], dict(states[1], num_epochs=5)], 2), 'num_epochs'),
        'topology': (([states[0], dict(states[1], num_global_pieces=3)], 2), 'topology'),
    }[case]
    for reshard in (reshard_reader_states, jax_reshard_reader_states):
        with pytest.raises(ValueError, match=match):
            reshard(*args)


def test_a_foreign_token_raises(url):
    token = _idle_states(url)[0]
    with pytest.raises(ValueError, match='reshard_reader_states'):
        make_reader(url, cur_shard=0, shard_count=4, reader_pool_type='dummy',
                    resume_state=token)


def test_a_batched_state_on_a_row_loader_raises(url):
    with make_reader(url, reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError, match='columnar loader'):
            DataLoader(reader, batch_size=4, device='cpu',
                       resume_state={'batched': True, 'pushback': []})


def test_divergent_seeds_raise(url):
    states = [_idle_states(url, seed=s + 1)[s] for s in range(2)]
    for reshard in (reshard_reader_states, jax_reshard_reader_states):
        with pytest.raises(ValueError, match='seed'):
            reshard(states, 3)


def test_ngram_loader_states_and_bare_tokens_raise(url):
    state = {'version': 1, 'batched': False, 'reader': _idle_states(url, k=1)[0],
             'pushback': [{0: {'id': 1}, 1: {'id': 2}}], 'pending': []}
    for reshard in (reshard_loader_states, jax_reshard_loader_states):
        with pytest.raises(ValueError, match='NGram'):
            reshard([state], 2)
        with pytest.raises(ValueError, match='not a DataLoader state'):
            reshard([state['reader']], 2)

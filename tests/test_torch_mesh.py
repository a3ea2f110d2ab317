"""The port's mesh helpers and ``DataLoader(sharding=)`` at 4 ranks against
the JAX package's.

Four spawned ranks of a gloo group (``tests/torch_dist_ranks.py``) run
``petastorm_tpu_torch.parallel`` and the loader; the JAX side runs in this
process on the 8 virtual CPU devices (``tests/conftest.py``).  Rank ``r``
sits at row-major coordinate ``r`` of the mesh, as JAX's device ``r`` of
``np.array(devices[:4]).reshape(shape)`` does.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import petastorm_tpu.parallel.mesh as jax_mesh
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.parallel import epoch_steps as jax_epoch_steps
from petastorm_tpu.parallel import make_mesh as jax_make_mesh

from petastorm_tpu_torch.parallel import epoch_steps
from petastorm_tpu_torch.train_lm import write_token_dataset

from torch_dist_ranks import _labels, run_ranks

WORLD = 4
BATCH = 2
BATCHES = 3
BAD_MESHES = ({'data': 3}, {'a': -1, 'b': -1}, {'data': 3, 'seq': -1})
#: (mesh axes, spec) of global_batch_from_local, each against JAX's index map
ASSEMBLY = (({'data': 2, 'seq': 2}, ('data', 'seq')),
            ({'data': 2, 'seq': 2}, ('data',)),
            ({'data': 2, 'seq': 2}, (('data', 'seq'),)),
            ({'data': 2, 'seq': 2}, (None, 'seq', None)),
            ({'data': 4}, ('data',)),
            ({'data': 1, 'seq': 4}, ('data', 'seq')))


def _jax_mesh(axes):
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(tuple(axes.values())),
                tuple(axes))


def _jax_spec(spec):
    return P(*spec)


def _global_array():
    return np.random.default_rng(3).standard_normal((8, 12, 4)).astype(np.float64)


def _assembly_payload():
    """Per case and rank, the rows JAX's index map gives the rank's device on
    dim 0, every other dim whole: what the rank holds locally."""
    g = _global_array()
    out = []
    for axes, spec in ASSEMBLY:
        index_map = NamedSharding(_jax_mesh(axes), _jax_spec(spec)) \
            .addressable_devices_indices_map(g.shape)
        devices = list(np.array(jax.devices()[:WORLD]))
        out.append((axes, spec, [g[index_map[d][0]] for d in devices]))
    return out


@pytest.fixture(scope='module')
def token_url(tmp_path_factory):
    return write_token_dataset('file://%s' % tmp_path_factory.mktemp('mesh_tokens'),
                               num_docs=256)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, token_url):
    payload = dict(bad_meshes=BAD_MESHES, assembly=_assembly_payload(), url=token_url,
                   batch=BATCH, batches=BATCHES)
    return run_ranks(tmp_path_factory.mktemp('mesh_ranks'), WORLD, 'mesh_cases', payload)


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_make_mesh_errors_carry_the_reference_texts(ranks):
    want = [_jax_error(lambda s=shape: jax_make_mesh(s, devices=jax.devices()[:WORLD]))
            for shape in BAD_MESHES]
    for result in ranks:
        assert result['errors'] == want
        assert result['minus_one'] == (2, 2)


@pytest.mark.parametrize('case', range(len(ASSEMBLY)))
def test_global_batch_blocks_follow_the_jax_index_map(ranks, case):
    axes, spec = ASSEMBLY[case]
    g = _global_array()
    arr = jax.device_put(g.astype(np.float32),
                         NamedSharding(_jax_mesh(axes), _jax_spec(spec)))
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for rank, result in enumerate(ranks):
        shape, block, dtype = result['blocks'][case]
        assert shape == g.shape
        assert dtype == 'torch.float32'     # float64 -> float32, as JAX's
        np.testing.assert_array_equal(block, shards[jax.devices()[rank]])


def test_host_helpers(ranks):
    for rank, result in enumerate(ranks):
        assert result['host_shard_info'] == (rank, WORLD)
        assert result['min_over_hosts'] == 3


def test_the_default_shard_is_the_rank(ranks, token_url):
    for rank, result in enumerate(ranks):
        assert result['default_shard'] == (rank, WORLD)
    counts = []
    for r in range(WORLD):
        with jax_make_reader(token_url, reader_pool_type='dummy', cur_shard=r,
                             shard_count=WORLD) as reader:
            counts.append(jax_epoch_steps(reader, BATCH))
    for result in ranks:
        assert result['epoch_steps'] == min(counts)


def test_epoch_steps_refusals_carry_the_reference_texts(ranks, monkeypatch):
    class Stub(object):
        ngram = predicate = None
        transform_may_change_row_count = False

        def num_local_rows(self):
            return 10

    for attr, value in (('ngram', object()), ('predicate', object()),
                        ('transform_may_change_row_count', True)):
        stub = Stub()
        setattr(stub, attr, value)
        assert _jax_error(lambda: epoch_steps(stub, 2)) \
            == _jax_error(lambda: jax_epoch_steps(stub, 2))
    assert epoch_steps(Stub(), 3, drop_last=False) == 4     # one rank: the ragged batch counts
    monkeypatch.setattr(jax_mesh.jax, 'process_count', lambda: WORLD)
    want = _jax_error(lambda: jax_epoch_steps(Stub(), 3, drop_last=False))
    for result in ranks:
        assert result['drop_last_false'] == want


def _jax_loader_blocks(url, data_size, seq_size, transform, cur):
    """The JAX loader's batches over shard ``cur`` of ``data_size``, each
    leaf's shard on the device at seq position j of a (1, seq_size) mesh."""
    mesh = Mesh(np.array(jax.devices()[:seq_size]).reshape(1, seq_size), ('data', 'seq'))
    spec = P('data', 'seq') if seq_size > 1 else P('data')
    reader = jax_make_reader(url, reader_pool_type='dummy', columnar_decode=True, seed=1,
                             cur_shard=cur, shard_count=data_size)
    out = []
    with reader:
        loader = JaxDataLoader(reader, BATCH, transform_fn=transform,
                               sharding=NamedSharding(mesh, spec))
        for batch in loader:
            out.append({k: (v.shape, [np.asarray(s.data) for s in
                                      sorted(v.addressable_shards, key=lambda s: s.device.id)])
                        for k, v in batch.items()})
            if len(out) == BATCHES:
                break
    return out


@pytest.mark.parametrize('label', ['data_seq inline', 'data_seq plane', 'data inline'])
def test_sharded_loader_blocks_equal_the_jax_loader_bit_for_bit(ranks, token_url, label):
    data_size, seq_size = (4, 1) if label == 'data inline' else (2, 2)
    transform = None if label == 'data inline' else _labels
    want = {cur: _jax_loader_blocks(token_url, data_size, seq_size, transform, cur)
            for cur in range(data_size)}
    for rank, result in enumerate(ranks):
        cur, j = divmod(rank, seq_size)
        got = result['loader'][label]
        assert len(got) == BATCHES
        for step, (g, w) in enumerate(zip(got, want[cur])):
            assert sorted(g) == sorted(w)
            for name, (shape, block, dtype) in g.items():
                jax_shape, jax_blocks = w[name]
                assert shape == (jax_shape[0] * data_size,) + tuple(jax_shape[1:])
                assert block.dtype == jax_blocks[j].dtype, (name, dtype)
                np.testing.assert_array_equal(block, jax_blocks[j],
                                              err_msg='%s step %d %s' % (label, step, name))


def test_sharded_loader_refusals(ranks):
    for result in ranks:
        assert 'cannot split dim 1 of size 1023 into 2 equal parts' in result['indivisible']
        assert result['cache_refusals'] == {
            'DeviceInMemDataLoader': 'DeviceInMemDataLoader caches on one device; use '
                                     'InMemDataLoader with sharding= for global batch assembly',
            'ResidentDataLoader': 'ResidentDataLoader caches on one device; use '
                                  'InMemDataLoader with sharding= for global batch assembly'}


def test_without_a_group(tmp_path):
    """No group up in this process: one rank, no mesh, and the sequence-split
    strategies refuse to run."""
    import torch.distributed as dist

    import petastorm_tpu_torch.train_lm as lm
    from petastorm_tpu_torch import parallel
    assert not dist.is_initialized()
    assert parallel.host_shard_info() == (0, 1)
    assert parallel.min_over_hosts(7) == 7
    parallel.sync_hosts()
    with pytest.raises(RuntimeError, match='make_mesh needs the process group'):
        parallel.make_mesh({'data': 1})
    with pytest.raises(ValueError, match='needs a store_path every rank shares'):
        parallel.init_distributed('cpu', None, 0, 2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match='start the process group first'):
        lm.train_lm('file:///nowhere', 1, strategy='ring', device='cpu')
    with pytest.raises(ValueError, match='block_k only applies to the ring strategy'):
        lm.train_lm('file:///nowhere', 1, strategy='flash', block_k=64, device='cpu')

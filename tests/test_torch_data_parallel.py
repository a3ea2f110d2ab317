"""The image example's data-parallel path at 2 ranks against the JAX
example's step over the sharded global batch.

Two spawned ranks of a gloo group (``tests/torch_dist_ranks.py``) run
``petastorm_tpu_torch.train.train`` (ResNet-50 at full depth, 10 classes,
64x64 PNG images, fp32, global batch 4, 3 steps) from flax parameters
carried across by ``convert``, each reading its own shard of the row groups
in order and recording the rows its step takes.  In this process:

* JAX's example step (flax ``ResNet50``, ``optax.sgd(momentum=0.9)``,
  BatchNorm in train mode) runs over the same global batches placed with
  ``data_parallel_sharding(make_mesh({'data': 2}))`` on two virtual CPU
  devices, with the same crops and flips: the port's draws for the global
  batch (its generator, seed 17), applied by JAX's pad, ``dynamic_slice``
  and ``where``.  As in ``test_torch_resnet.py::test_resnet50_sgd_step_matches_optax``
  the reference runs in float64; the losses, the parameters and the
  running statistics are held to that test's 2e-4 (absolute).
* The port's own one-device ``train`` runs on a store holding the same
  global batches in order: its losses, parameters and statistics equal
  the world-2 run's within the same 2e-4 (absolute).  Both are fp32 runs
  that add in other orders (convolution gradients over 2 rows then over
  the ranks, BatchNorm sums over the ranks); after 3 steps the largest gap
  is 1.2e-4, in the stem's kernel.
* One BatchNorm on two halves (global statistics) against one on the
  whole: outputs, input gradients, scale and bias gradients and running
  statistics within 1e-5.
* ``scan_batches(sharding=)``: each rank's stacked blocks equal the JAX
  loader's over the same shard bit for bit, and ``train(scan_steps=2)`` at
  world 2 takes the streaming run's first steps bit for bit.
* Without a group, ``train`` issues no collective.
* ``--hbm-cache`` at world 2 and an indivisible global batch refuse.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.jax import augment as jax_augment
from petastorm_tpu.models.resnet import ResNet50 as JaxResNet50
from petastorm_tpu.parallel import data_parallel_sharding as jax_data_parallel_sharding
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec

import petastorm_tpu_torch.train as image_train
from petastorm_tpu_torch import codecs, unischema
from petastorm_tpu_torch.convert import resnet_params_from_flax
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.models.resnet import BatchNorm

from torch_dist_ranks import ordered_image_training, run_ranks

WORLD = 2
HW = (64, 64)
BATCH = 4              # the global batch
STEPS = 3
ROWS, ROWS_PER_GROUP = 48, 6
SCAN_K, SCAN_CHUNKS = 2, 2
ATOL = 2e-4            # test_resnet50_sgd_step_matches_optax's
SELF_ATOL = ATOL
BN_ATOL = 1e-5


def _schema():
    u = unischema
    return u.Unischema('DataParallelImages', [
        u.UnischemaField('noun_id', np.int64, (), None, False),
        u.UnischemaField('image', np.uint8, HW + (3,), codecs.CompressedImageCodec('png'), False),
    ])


def _write(url, images, noun_ids):
    with DatasetWriter(url, _schema(), rows_per_rowgroup=ROWS_PER_GROUP) as writer:
        for image, noun_id in zip(images, noun_ids):
            writer.write({'noun_id': np.int64(noun_id), 'image': image})
    return url


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """PNG rows (lossless: a store rewritten from decoded rows decodes to
    the same pixels) with noun ids 0..9, whose labels ``hash(noun_id) %
    1000`` are the ids themselves."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (ROWS,) + HW + (3,), dtype=np.uint8)
    url = 'file://%s' % tmp_path_factory.mktemp('dp_images')
    return _write(url, images, rng.integers(0, 10, ROWS))


@pytest.fixture(scope='module')
def flax_start():
    """flax ResNet50(num_classes=10) variables with noise on the params (so
    the zero-initialised BN scales carry signal), as numpy."""
    variables = jax.jit(lambda k, x: JaxResNet50(num_classes=10).init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,), jnp.float32))
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape)
                          .astype(np.float32), variables['params'])
    return params, jax.tree.map(np.asarray, variables['batch_stats'])


def _port_state(flax_start):
    return {k: v.numpy() for k, v in resnet_params_from_flax(*flax_start).items()}


@pytest.fixture(scope='module')
def bn_case():
    rng = np.random.default_rng(4)
    c = 8
    return dict(x=rng.standard_normal((4, c, 6, 6)).astype(np.float32) * 2 + 0.5,
                ct=rng.standard_normal((4, c, 6, 6)).astype(np.float32),
                state={'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
                       'bias': rng.normal(0, 0.1, c).astype(np.float32),
                       'running_mean': rng.normal(0, 0.1, c).astype(np.float32),
                       'running_var': rng.uniform(0.5, 1.5, c).astype(np.float32)})


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, store, flax_start, bn_case):
    payload = dict(url=store, steps=STEPS, batch=BATCH, hw=HW, state=_port_state(flax_start),
                   bn=bn_case, scan_k=SCAN_K, scan_chunks=SCAN_CHUNKS)
    return run_ranks(tmp_path_factory.mktemp('dp_ranks'), WORLD, 'data_parallel_cases', payload)


def _global_batches(ranks):
    """The global batch of each step: the ranks' rows in rank order."""
    return [{k: np.concatenate([r['batches'][i][k] for r in ranks]) for k in ('image', 'label')}
            for i in range(STEPS)]


def _draws():
    """The port's crop offsets and flips of each step, drawn for the global
    batch from its augment generator (seed 17), in its order."""
    g = torch.Generator().manual_seed(17)
    span = HW[0] + 8 - HW[0] + 1
    out = []
    for _ in range(STEPS):
        tops = torch.randint(0, span, (BATCH,), generator=g).numpy()
        lefts = torch.randint(0, span, (BATCH,), generator=g).numpy()
        flips = (torch.rand(BATCH, generator=g) < 0.5).numpy()
        out.append((tops, lefts, flips))
    return out


@pytest.fixture(scope='module')
def jax_run(ranks, flax_start):
    """The JAX example's train step over each global batch, sharded over a
    {'data': 2} mesh, in float64, from the same start and draws."""
    batches = _global_batches(ranks)
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
        params, stats = f64(flax_start[0]), f64(flax_start[1])
        model = JaxResNet50(num_classes=10, dtype=jnp.float64)
        tx = optax.sgd(0.1, momentum=0.9)
        opt_state = tx.init(params)
        sharding = jax_data_parallel_sharding(
            jax_make_mesh({'data': WORLD}, devices=jax.devices()[:WORLD]))

        @jax.jit
        def train_step(params, batch_stats, opt_state, images, labels, tops, lefts, flips):
            padded = jnp.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)))
            images = jax.vmap(lambda img, t, l: jax.lax.dynamic_slice(
                img, (t, l, 0), HW + (3,)))(padded, tops, lefts)
            images = jnp.where(flips[:, None, None, None], images[:, :, ::-1, :], images)
            images = jax_augment.normalize(images, dtype=jnp.float32)

            def loss_fn(p):
                logits, mutated = model.apply({'params': p, 'batch_stats': batch_stats},
                                              images, train=True, mutable=['batch_stats'])
                loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
                return loss, mutated['batch_stats']

            (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), new_stats, new_opt, loss

        losses = []
        for batch, (tops, lefts, flips) in zip(batches, _draws()):
            placed = [jax.device_put(a, sharding) for a in
                      (batch["image"], batch["label"], tops.astype(np.int64),
                       lefts.astype(np.int64), flips)]
            params, stats, opt_state, loss = train_step(params, stats, opt_state, *placed)
            losses.append(float(loss))
        return dict(losses=losses, state=resnet_params_from_flax(
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)))


def test_world_two_trains_as_the_jax_example_step(ranks, jax_run):
    """Losses, every parameter and every running statistic after 3 steps,
    on both ranks, against the JAX example's sharded step."""
    for result in ranks:
        assert result['data_ranks'] == WORLD
        np.testing.assert_allclose(result['losses'], jax_run['losses'], atol=ATOL, rtol=0)
        assert set(result['state']) == set(jax_run['state'])
        for name, want in jax_run['state'].items():
            np.testing.assert_allclose(result['state'][name], want.numpy(), atol=ATOL, rtol=0,
                                       err_msg=name)


def test_the_ranks_read_their_shards_and_end_equal(ranks):
    """Each rank took its own rows (its shard of the row groups) and both
    end with the same parameters and running statistics, bit for bit."""
    for i in range(STEPS):
        assert not np.array_equal(ranks[0]['batches'][i]['image'],
                                  ranks[1]['batches'][i]['image'])
        assert ranks[0]['batches'][i]['image'].shape == (BATCH // WORLD,) + HW + (3,)
    assert ranks[0]['losses'] == ranks[1]['losses']
    for name, value in ranks[0]['state'].items():
        np.testing.assert_array_equal(value, ranks[1]['state'][name], err_msg=name)


def test_world_two_equals_world_one_on_the_global_batch(ranks, flax_start, tmp_path,
                                                         monkeypatch):
    """The port's one-device step on the concatenated global batches (a
    store holding them in order) equals its world-2 step, augmentation
    included."""
    batches = _global_batches(ranks)
    url = _write('file://%s' % tmp_path, np.concatenate([b['image'] for b in batches]),
                 np.concatenate([b['label'] for b in batches]))
    ordered_image_training(dict(state=_port_state(flax_start)), monkeypatch.setattr)
    one = image_train.train(url, STEPS, batch_size=BATCH, image_hw=HW, device='cpu',
                            workers_count=1, model_kwargs=dict(num_classes=10,
                                                               dtype=torch.float32))
    assert one['data_ranks'] == 1
    np.testing.assert_allclose(ranks[0]['losses'], one['losses'], atol=SELF_ATOL, rtol=0)
    for name, value in one['model'].state_dict().items():
        np.testing.assert_allclose(ranks[0]['state'][name], value.numpy(), atol=SELF_ATOL,
                                   rtol=0, err_msg=name)


def test_batchnorm_on_two_halves_equals_one_on_the_whole(ranks, bn_case):
    norm = BatchNorm(bn_case['x'].shape[1], torch.float32)
    norm.load_state_dict({k: torch.tensor(v) for k, v in bn_case['state'].items()})
    x = torch.tensor(bn_case['x'], requires_grad=True)
    y = norm(x)
    (y * torch.tensor(bn_case['ct'])).sum().backward()
    half = x.shape[0] // WORLD
    for rank, result in enumerate(ranks):
        rows = slice(rank * half, (rank + 1) * half)
        got = result['bn']
        for name, want in (('y', y[rows]), ('dx', x.grad[rows]), ('dscale', norm.scale.grad),
                           ('dbias', norm.bias.grad), ('running_mean', norm.running_mean),
                           ('running_var', norm.running_var)):
            np.testing.assert_allclose(got[name], want.detach().numpy(), atol=BN_ATOL, rtol=0,
                                       err_msg='%s rank %d' % (name, rank))


def _jax_fix_row(row):
    row = dict(row)
    row['label'] = np.int32(hash(row.pop('noun_id')) % 1000)
    return row


def test_sharded_scan_batches_blocks_equal_the_jax_loader(ranks, store):
    """Each rank's stacked chunks (k steps of its rows) equal the JAX
    loader's ``scan_batches`` over the same shard, bit for bit."""
    mesh = Mesh(np.array(jax.devices()[:1]), ('data',))
    spec = JaxTransformSpec(_jax_fix_row, edit_fields=[('label', np.int32, (), False)],
                            removed_fields=['noun_id'])
    for rank, result in enumerate(ranks):
        reader = jax_make_reader(store, schema_fields=['image', 'noun_id'], transform_spec=spec,
                                 columnar_decode=True, reader_pool_type='dummy',
                                 shuffle_row_groups=False, num_epochs=1, scheduling='fifo',
                                 ingest='off', cur_shard=rank, shard_count=WORLD)
        want = []
        with reader:
            loader = JaxDataLoader(reader, BATCH // WORLD,
                                   sharding=NamedSharding(mesh, P('data')))
            for _, outs in loader.scan_batches(lambda c, b: (c, b), None,
                                               steps_per_call=SCAN_K, donate_carry=False):
                want.append({k: np.asarray(v) for k, v in outs.items()})
                if len(want) == SCAN_CHUNKS:
                    break
        assert len(result['scan']) == SCAN_CHUNKS
        for got, w in zip(result['scan'], want):
            assert sorted(got) == sorted(w) == ['image', 'label']
            for name in w:
                assert got[name].dtype == w[name].dtype
                assert got[name].shape == (SCAN_K, BATCH // WORLD) + w[name].shape[2:]
                np.testing.assert_array_equal(got[name], w[name], err_msg=name)


def test_refusals_at_world_two(ranks):
    for result in ranks:
        assert 'single-device' in result['refusals']['hbm_cache']
        assert 'shard per host on pods' in result['refusals']['hbm_cache']
        assert result['refusals']['indivisible'] == (
            'batch_size 3 is the global batch: it must divide over the 2 ranks of the data '
            'axis')


def test_scan_steps_on_the_mesh_take_the_streaming_steps(ranks):
    """``--scan-steps 2`` at world 2: the same rows per rank and the same
    losses as the streaming run's first two steps, bit for bit (both eager
    on the CPU)."""
    for result in ranks:
        scan = result['scan_run']
        assert len(scan['losses']) == SCAN_K
        assert scan['losses'] == result['losses'][:SCAN_K]
        for got, want in zip(scan['batches'], result['batches']):
            for name in ('image', 'label'):
                np.testing.assert_array_equal(got[name], want[name])


def test_without_a_group_no_collective_runs(store, monkeypatch):
    """No process group: the one-device path, which calls no collective."""
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError('a collective ran without a group')

    for name in ('all_reduce', 'all_gather', 'all_to_all_single', 'batch_isend_irecv',
                 'reduce_scatter_tensor'):
        monkeypatch.setattr(dist, name, refuse)
    assert not dist.is_initialized()
    result = image_train.train(store, 2, batch_size=2, image_hw=(32, 32), device='cpu',
                               workers_count=1, model_name='vit',
                               model_kwargs=dict(d_model=32, num_heads=2, num_layers=1,
                                                 d_ff=64, num_classes=10))
    assert result['data_ranks'] == 1 and len(result['losses']) == 2
    assert np.all(np.isfinite(result['losses']))

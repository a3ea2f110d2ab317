"""The MNIST example on the port against the JAX package, on the CPU.

``models/mlp.py``: a flax MLP's parameters through ``mlp_params_from_flax``
give the flax logits within 1e-6 (fp32).  Five Adam steps on the same
batches give optax's losses within 1e-5 (fp32 rounding: the two reach the
same formula in another order of operations) and its parameters within
2e-5, 2 % of one Adam step at lr 1e-3 (a gradient element near Adam's eps
makes the normalised step sensitive to its last bits).  The slice as a
whole: ``train_mnist.train``'s batches on the dummy pool equal the JAX
example's loader's (row reader, shuffling buffer of 2048 seeded by the
epoch) bit for bit, and its command line reproduces the example's
checkpoint story (``tests/test_examples_smoke.py::test_mnist``) and resumes
mid-epoch to the uninterrupted run's batches and parameters.
"""

import hashlib

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import petastorm_tpu.native
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.models.mlp import MLP as FlaxMLP

from petastorm_tpu_torch import train_mnist
from petastorm_tpu_torch.convert import mlp_params_from_flax
from petastorm_tpu_torch.models.mlp import MLP

ROWS = 640   # 5 steps of 128


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return train_mnist.write_mnist_dataset(
        'file://%s' % tmp_path_factory.mktemp('torch_mnist'), ROWS)


def _flax_params():
    params = FlaxMLP().init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28)))['params']
    return params, jax.tree.map(np.asarray, params)


def test_mlp_logits_equal_flax():
    params, np_params = _flax_params()
    model = MLP()
    model.load_state_dict(mlp_params_from_flax(np_params))
    images = np.random.default_rng(0).integers(0, 256, (16, 28, 28), dtype=np.uint8)
    want = np.asarray(FlaxMLP().apply({'params': params}, images))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _optax_losses(params, batches):
    tx = optax.adam(1e-3)
    state = tx.init(params)

    @jax.jit
    def step(p, s, x, y):
        def loss_fn(p):
            logits = FlaxMLP().apply({'params': p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    losses = []
    for x, y in batches:
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return losses, params


def _port_losses(np_params, batches):
    model = MLP()
    model.load_state_dict(mlp_params_from_flax(np_params))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for x, y in batches:
        loss = F.cross_entropy(model(torch.from_numpy(np.array(x))),
                               torch.from_numpy(np.array(y)).long())
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, model


def _assert_adam_parity(params, np_params, batches):
    want_losses, want_params = _optax_losses(params, batches)
    got_losses, model = _port_losses(np_params, batches)
    np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=1e-5)
    want = mlp_params_from_flax(jax.tree.map(np.asarray, want_params))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_adam_steps_equal_optax():
    params, np_params = _flax_params()
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, 256, (32, 28, 28), dtype=np.uint8), rng.integers(0, 10, 32))
               for _ in range(5)]
    _assert_adam_parity(params, np_params, batches)


def test_the_slice_equals_the_jax_example(url):
    """train_mnist's batches (dummy pool) are the JAX example's loader's,
    bit for bit, and five Adam steps on them match optax's."""
    got = []
    train_mnist.train(url, epochs=1, device='cpu', reader_pool_type='dummy',
                      on_batch=lambda step, batch: got.append(
                          {k: v.numpy().copy() for k, v in batch.items()}))
    reader = jax_make_reader(url, num_epochs=1, reader_pool_type='dummy', scheduling='fifo',
                             ingest='off')
    with petastorm_tpu.native.disabled():
        with JaxDataLoader(reader, batch_size=128, shuffling_queue_capacity=2048, seed=0,
                           transfer=False) as loader:
            want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    assert len(got) == len(want) == ROWS // 128
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert sorted(np.concatenate([b['idx'] for b in got]).tolist()) == list(range(ROWS))
    params, np_params = _flax_params()
    _assert_adam_parity(params, np_params, [(b['image'], b['digit']) for b in want])


def test_main_reproduces_the_example_checkpoint_story(tmp_path, capsys):
    url = 'file://' + str(tmp_path / 'mnist')
    train_mnist.main(['--write-rows', '256', '--dataset-url', url, '--epochs', '1',
                      '--device', 'cpu'])
    assert 'final accuracy' in capsys.readouterr().out
    ck = str(tmp_path / 'ck')
    args = ['--dataset-url', url, '--device', 'cpu', '--checkpoint-dir', ck]
    train_mnist.main(args + ['--epochs', '1', '--save-every', '1'])
    assert 'final accuracy' in capsys.readouterr().out
    result = train_mnist.main(args + ['--epochs', '1'])
    out = capsys.readouterr().out
    assert 'resumed at step' in out and 'already covers all 1 epochs' in out
    assert result['steps_run'] == 0 and np.isnan(result['final_accuracy'])
    result = train_mnist.main(args + ['--epochs', '2'])
    out = capsys.readouterr().out
    assert 'resumed at step' in out and 'epoch 1:' in out and result['steps_run'] == 2


def _digests(record):
    def on_batch(step, batch):
        h = hashlib.sha256()
        for key in sorted(batch):
            h.update(batch[key].numpy().tobytes())
        record.append((step, h.hexdigest(), batch['idx'].tolist()))
    return on_batch


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_a_mid_epoch_stop_resumes_exactly(url, tmp_path, pool):
    """Stopped after step 2 (its checkpoint written), a fresh run over the
    same directory trains on exactly the batches the uninterrupted run had
    left: on the dummy pool the same batches (sha256) and final parameters
    bit for bit; on 4 threads, the example's pool, every row once."""
    kwargs = dict(epochs=1, device='cpu', reader_pool_type=pool)
    full = []
    whole = train_mnist.train(url, on_batch=_digests(full), **kwargs)
    ck = str(tmp_path / 'ck')
    first, rest = [], []
    cut = train_mnist.train(url, checkpoint_dir=ck, save_every=2, stop_after_step=2,
                            on_batch=_digests(first), **kwargs)
    assert cut['steps_run'] == 3 and cut['global_step'] == 3
    resumed = train_mnist.train(url, checkpoint_dir=ck, save_every=2, on_batch=_digests(rest),
                                **kwargs)
    assert resumed['resumed_at'] == 2 and [s for s, _, _ in rest] == [3, 4]
    idx = sorted(i for _, _, ids in first + rest for i in ids)
    assert idx == sorted(i for _, _, ids in full for i in ids) == list(range(ROWS))
    if pool == 'dummy':
        assert [d for _, d, _ in first + rest] == [d for _, d, _ in full]
        assert cut['losses'] + resumed['losses'] == whole['losses']
        for name, value in whole['model'].state_dict().items():
            assert torch.equal(resumed['model'].state_dict()[name], value), name

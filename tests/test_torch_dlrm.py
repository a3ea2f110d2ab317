"""The port's DLRM, Adagrad and Criteo trainer against the JAX package's,
on the CPU.

Flax parameters carried over by ``convert.dlrm_params_from_flax`` give
the flax model's logits (bf16 within the ResNet and ViT tests' 3e-2; a
model configured in fp32 within 1e-5, so that a wrong formula cannot hide
in the bf16 tolerance) and gradients (fp32 per tensor; bf16 against the
model's largest gradient).  The port's ``Adagrad`` with
``binary_cross_entropy_with_logits`` follows ``optax.adagrad`` with
``sigmoid_binary_cross_entropy`` step by step within fp32 rounding (1e-5
on the loss after 5 steps).  ``train_dlrm.train`` over a store of three
row groups gives the losses of the same loop written with the JAX
package's batch reader, loader, flax DLRM and optax.  The command line
mirrors ``tests/test_examples_smoke.py::test_criteo_dlrm``.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow.parquet as pq
import pytest
import torch
import torch.nn.functional as F

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.models.dlrm import DLRM as FlaxDLRM

from petastorm_tpu_torch import train_dlrm
from petastorm_tpu_torch.convert import dlrm_params_from_flax
from petastorm_tpu_torch.models.dlrm import DLRM
from petastorm_tpu_torch.optim import Adagrad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCABS = [40 + 7 * i for i in range(26)]
B = 64


def _example_module(name):
    """A module of ``examples/criteo`` (the JAX example's own code)."""
    path = os.path.join(REPO, 'examples', 'criteo', name + '.py')
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location('criteo_' + name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
    return module


def _inputs(seed=0, vocabs=VOCABS, batch=B):
    rng = np.random.default_rng(seed)
    dense = np.log1p(rng.lognormal(0, 1, (batch, 13))).astype(np.float32)
    # repeated ids: the tables' gradients sum over duplicates
    cats = np.stack([rng.integers(0, min(v, 9), batch) for v in vocabs], 1).astype(np.int32)
    label = rng.integers(0, 2, batch).astype(np.float32)
    return dense, cats, label


def _pair(dtype, vocabs=VOCABS):
    flax_model = FlaxDLRM(vocab_sizes=vocabs, dtype=jnp.bfloat16 if dtype == 'bf16'
                          else jnp.float32)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 13)),
                                jnp.zeros((1, len(vocabs)), jnp.int32))
    model = DLRM(vocabs, dtype=torch.bfloat16 if dtype == 'bf16' else torch.float32)
    model.load_state_dict(dlrm_params_from_flax(jax.tree.map(np.asarray, variables['params'])))
    return flax_model, variables, model


#: (compute dtype, tolerance on logits and on gradients relative to their max)
TOLERANCES = {'bf16': 3e-2, 'fp32': 1e-5}


@pytest.mark.parametrize('dtype', ['bf16', 'fp32'])
def test_logits_and_gradients_equal_flax(dtype):
    tol = TOLERANCES[dtype]
    flax_model, variables, model = _pair(dtype)
    dense, cats, label = _inputs()

    def loss_fn(params):
        logits = flax_model.apply({'params': params}, dense, cats)
        return optax.sigmoid_binary_cross_entropy(logits, label).mean(), logits

    (_, want_logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables['params'])
    logits = model(torch.from_numpy(dense), torch.from_numpy(cats))
    assert logits.dtype == torch.float32 and logits.shape == (B,)
    want_logits = np.asarray(want_logits)
    assert np.abs(logits.detach().numpy() - want_logits).max() <= tol * max(
        1.0, np.abs(want_logits).max())
    F.binary_cross_entropy_with_logits(logits, torch.from_numpy(label)).backward()
    want = dlrm_params_from_flax(jax.tree.map(np.asarray, grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    # fp32: each tensor against its own largest entry; bf16: against the
    # model's largest gradient, since a bf16 sum of cancelling terms (the
    # last bias's, over the batch) rounds off by a share of its own size
    model_scale = max(float(w.abs().max()) for w in want.values())
    for name, g in got.items():
        scale = float(want[name].abs().max()) if dtype == 'fp32' else model_scale
        assert float((g - want[name]).abs().max()) <= tol * max(scale, 1e-3), name


def test_bottom_mlp_must_end_at_embedding_dim():
    with pytest.raises(ValueError, match='embedding_dim'):
        DLRM(VOCABS, embedding_dim=8)
    with pytest.raises(ValueError, match='embedding_dim'):
        FlaxDLRM(vocab_sizes=VOCABS, embedding_dim=8).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 13)), jnp.zeros((1, 26), jnp.int32))


def test_interaction_order_is_jnp_triu_indices():
    iu, ju = np.asarray(jnp.triu_indices(27, k=1)[0]), np.asarray(jnp.triu_indices(27, k=1)[1])
    model = DLRM(VOCABS)
    np.testing.assert_array_equal(model.pair_index.numpy(), iu * 27 + ju)


def test_adagrad_is_optax_adagrad():
    """The accumulator starts at 0.1, eps sits inside the root: one tensor
    through 5 updates of random gradients, within fp32 rounding."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) * 10.0 ** -i for i in range(5)]
    tx = optax.adagrad(1e-2)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Adagrad([tp], lr=1e-2)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(opt.state[tp]['sum_of_squares'].numpy(),
                               np.asarray(state[0].sum_of_squares), rtol=1e-6)
    assert set(opt.state[tp]) == {'sum_of_squares'}   # no host-side step count


@pytest.mark.parametrize('dtype', ['bf16', 'fp32'])
def test_five_steps_equal_optax(dtype):
    flax_model, variables, model = _pair(dtype)
    dense, cats, label = _inputs(2)
    tx = optax.adagrad(1e-3)
    params, state = variables['params'], tx.init(variables['params'])
    opt = Adagrad(model.parameters(), lr=1e-3)
    want, got = [], []
    for _ in range(5):
        def loss_fn(p):
            return optax.sigmoid_binary_cross_entropy(
                flax_model.apply({'params': p}, dense, cats), label).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
        loss = F.binary_cross_entropy_with_logits(
            model(torch.from_numpy(dense), torch.from_numpy(cats)), torch.from_numpy(label))
        opt.zero_grad()
        loss.backward()
        opt.step()
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    final = dlrm_params_from_flax(jax.tree.map(np.asarray, params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope='module')
def criteo_url(tmp_path_factory):
    """The example's generator: 3 row groups of 256 rows."""
    url = 'file://%s' % tmp_path_factory.mktemp('criteo')
    return train_dlrm.generate_criteo_parquet(url, rows_count=768, rows_per_group=256)


def test_generator_writes_the_examples_store(criteo_url, tmp_path):
    ref = _example_module('generate_criteo_parquet')
    assert (ref.NUM_DENSE, ref.NUM_CATEGORICAL, ref.VOCAB_SIZES) == \
        (train_dlrm.NUM_DENSE, train_dlrm.NUM_CATEGORICAL, train_dlrm.VOCAB_SIZES)
    ref.generate_criteo_parquet('file://%s' % tmp_path, rows_count=768, rows_per_group=256)
    got = pq.read_table(criteo_url[len('file://'):] + '/data.parquet')
    want = pq.read_table(str(tmp_path / 'data.parquet'))
    assert got.equals(want) and pq.ParquetFile(str(tmp_path / 'data.parquet')) \
        .metadata.num_row_groups == 3


def _jax_loop(url, params, batch_size, epochs=1):
    """The example's loop with the JAX package's reader (dummy pool, no
    shuffle), loader (its ``pack_columns``), flax DLRM and optax."""
    pack_columns = _example_module('jax_example').pack_columns
    model = FlaxDLRM(vocab_sizes=train_dlrm.VOCAB_SIZES)
    tx = optax.adagrad(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        def loss_fn(p):
            logits = model.apply({'params': p}, batch['dense'], batch['cats'])
            return optax.sigmoid_binary_cross_entropy(logits, batch['label']).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(epochs):
        reader = jax_make_batch_reader(url, num_epochs=1, reader_pool_type='dummy',
                                       shuffle_row_groups=False, scheduling='fifo', ingest='off')
        with JaxDataLoader(reader, batch_size=batch_size, transform_fn=pack_columns,
                           transfer=False) as loader:
            for batch in loader:
                params, opt_state, loss = step(params, opt_state, batch)
                losses.append(float(loss))
    return losses


@pytest.mark.parametrize('scan_steps,transfer', [(0, False), (0, True), (2, False)])
def test_train_equals_the_jax_loop_loss_by_loss(criteo_url, scan_steps, transfer):
    """Batches of 96 over row groups of 256 (batches straddle row groups),
    two epochs: the same losses within fp32 rounding of the loss."""
    variables = FlaxDLRM(vocab_sizes=train_dlrm.VOCAB_SIZES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 13)), jnp.zeros((1, 26), jnp.int32))
    want = _jax_loop(criteo_url, variables['params'], 96, epochs=2)
    result = train_dlrm.train(
        criteo_url, epochs=2, batch_size=96, scan_steps=scan_steps, device='cpu',
        transfer=transfer, reader_kwargs=dict(reader_pool_type='dummy', shuffle_row_groups=False),
        params=dlrm_params_from_flax(jax.tree.map(np.asarray, variables['params'])))
    assert len(result['losses']) == len(want) == 16
    np.testing.assert_allclose(result['losses'], want, rtol=0, atol=1e-5)
    assert [e['steps'] for e in result['epochs_run']] == [8, 8]
    assert result['device'] == 'cpu' and not result['cuda_graph']


def test_main_runs_the_examples_flags(tmp_path, capsys):
    """``tests/test_examples_smoke.py::test_criteo_dlrm`` for the port: the
    generator, one epoch at batch 256, then ``--scan-steps 2``."""
    url = 'file://%s' % (tmp_path / 'criteo')
    result = train_dlrm.main(['--dataset-url', url, '--write-rows', '2048', '--epochs', '1',
                              '--batch-size', '256', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'loss=' in out and 'stall_pct' in out
    assert result['epochs_run'][0]['steps'] == 8 and np.isfinite(result['losses']).all()
    result = train_dlrm.main(['--dataset-url', url, '--epochs', '1', '--batch-size', '256',
                              '--scan-steps', '2', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'loss=' in out and 'fused scan' in out
    assert len(result['losses']) == 8


def test_the_step_needs_the_card_unless_asked(monkeypatch, criteo_url):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_dlrm.train(criteo_url)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_dlrm.main(['--dataset-url', criteo_url])

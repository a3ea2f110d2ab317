"""The sequence-parallel long-context loop as a whole: the port's
``train_lm`` at 2 ranks against the JAX example's train step.

Two spawned ranks of a gloo group (``tests/torch_dist_ranks.py``) run
``train_lm`` with ring and Ulysses attention on meshes ``{'data': 1,
'seq': 2}`` and ``{'data': 2, 'seq': 1}``, at a small width in fp32, from
flax parameters carried across by ``convert.transformer_lm_params_from_flax``.
The global batches they read (their blocks put back together) go through
``examples/long_context/jax_example.py``'s ``train_step`` (a
``TransformerLM`` with ``make_attn_fn(mesh, strategy)`` and remat, the
next-token cross entropy, ``optax.adamw(3e-4)``) on two of the 8 virtual CPU
devices: the first loss and the parameters after 2 steps must agree within
1e-4 (the key bias, whose exact gradient is 0, within AdamW's two steps: see
``_assert_params_close``).  The port's own one-device flash run over the same
rows must agree too.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from petastorm_tpu.models.transformer import TransformerLM as JaxLM, make_attn_fn

import petastorm_tpu_torch.train_lm as lm
from petastorm_tpu_torch.convert import transformer_lm_params_from_flax

from torch_dist_ranks import run_ranks

#: The L1 model cut to a small width (vocabulary and length are the dataset's).
CONFIG = dict(d_model=32, num_heads=4, num_layers=1, d_ff=64)
STEPS, BATCH = 2, 2
#: name -> (strategy, seq_shards, block_k)
RUNS = {'ring seq 2': ('ring', 2, None),
        'ring seq 2 block_k 384': ('ring', 2, 384),
        'ulysses seq 2': ('ulysses', 2, None),
        'ring data 2': ('ring', 1, None),
        'ulysses data 2': ('ulysses', 1, None)}
TOL = 1e-4
#: jax_example.py's optax.adamw(3e-4)
LR = 3e-4


def _jax_model(mesh=None, strategy='dense', block_k=None):
    attn = make_attn_fn(mesh, strategy, head_axis=None, block_k=block_k)
    return JaxLM(vocab_size=lm.VOCAB, max_seq_len=lm.SEQ_LEN, dtype=jnp.float32,
                 attn_fn=attn, remat=True, **CONFIG)


@pytest.fixture(scope='module')
def flax_params():
    return _jax_model().init(jax.random.PRNGKey(0),
                             jnp.zeros((1, lm.SEQ_LEN), jnp.int32))['params']


@pytest.fixture(scope='module')
def token_url(tmp_path_factory):
    return lm.write_token_dataset('file://%s' % tmp_path_factory.mktemp('sp_tokens'),
                                  num_docs=64)


def _port_params(flax_params):
    return {k: v.numpy() for k, v in transformer_lm_params_from_flax(flax_params).items()}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, token_url, flax_params):
    payload = dict(config=CONFIG, params=_port_params(flax_params), url=token_url,
                   steps=STEPS, batch=BATCH,
                   runs=[(name,) + run for name, run in RUNS.items()])
    return run_ranks(tmp_path_factory.mktemp('sp_ranks'), 2, 'sequence_parallel_cases',
                     payload)


def _global_tokens(ranks, name):
    """Each step's global batch, the ranks' blocks put back in mesh order."""
    by_coord = {r[name]['coord']: r[name]['tokens'] for r in ranks}
    data = 1 + max(i for i, _ in by_coord)
    seq = 1 + max(j for _, j in by_coord)
    return [np.concatenate([np.concatenate([by_coord[(i, j)][step] for j in range(seq)], axis=1)
                            for i in range(data)], axis=0) for step in range(STEPS)]


def _jax_run(flax_params, mesh_shape, strategy, block_k, batches):
    """jax_example.py's train_step on the mesh, over ``batches``."""
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(mesh_shape), ('data', 'seq'))
    model = _jax_model(mesh, strategy, block_k)
    tx = optax.adamw(3e-4)

    @jax.jit
    def train_step(params, opt_state, tokens):
        def loss_fn(p):
            logits = model.apply({'params': p}, tokens)
            labels = jnp.roll(tokens, -1, axis=1)
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_opt, loss

    params, opt_state, losses = flax_params, tx.init(flax_params), []
    for tokens in batches:
        tokens = jax.device_put(tokens, NamedSharding(mesh, P('data', 'seq')))
        params, opt_state, loss = train_step(params, opt_state, tokens)
        losses.append(float(loss))
    return losses, _port_params(params)


@pytest.mark.parametrize('name', list(RUNS))
def test_train_lm_matches_the_jax_example_step(ranks, flax_params, name):
    strategy, seq_shards, block_k = RUNS[name]
    runs = [r[name] for r in ranks]
    assert runs[0]['mesh'] == {'data': 2 // seq_shards, 'seq': seq_shards}
    assert sorted(r['coord'] for r in runs) == sorted(
        (i, j) for i in range(2 // seq_shards) for j in range(seq_shards))
    assert runs[0]['losses'] == runs[1]['losses']          # the all-reduced loss
    for key, value in runs[0]['params'].items():           # replicas stay replicas
        np.testing.assert_array_equal(runs[1]['params'][key], value, err_msg=key)
    batches = _global_tokens(ranks, name)
    assert batches[0].shape == (BATCH, lm.SEQ_LEN)
    losses, params = _jax_run(flax_params, (2 // seq_shards, seq_shards), strategy, block_k,
                              batches)
    np.testing.assert_allclose(runs[0]['losses'][0], losses[0], rtol=TOL, atol=TOL)
    _assert_params_close(runs[0]['params'], params)


def _assert_params_close(got, want):
    """Every parameter within TOL, but the key bias within the most AdamW
    moves a parameter in STEPS steps: its exact gradient is 0 (a constant
    added to every key leaves each softmax row unchanged), so each side's
    fp32 gradient is rounding noise of 1e-9 or less, which Adam divides by
    its own magnitude (+ eps 1e-8) and turns into a step of up to the
    learning rate in a direction of its own (as in
    ``tests/test_torch_lm.py::test_loss_gradients_and_adamw_step_match_flax_float64``)."""
    assert set(got) == set(want)
    d = CONFIG['d_model']
    for key, value in want.items():
        if key.endswith('attn.qkv.bias'):
            key_bias = slice(d, 2 * d)
            np.testing.assert_allclose(got[key][key_bias], value[key_bias], rtol=0,
                                       atol=STEPS * LR, err_msg=key)
            got_rest, value = np.delete(got[key], np.r_[key_bias]), np.delete(value,
                                                                              np.r_[key_bias])
            np.testing.assert_allclose(got_rest, value, rtol=TOL, atol=TOL, err_msg=key)
            continue
        np.testing.assert_allclose(got[key], value, rtol=TOL, atol=TOL, err_msg=key)


def test_the_one_device_flash_run_reads_and_learns_the_same(ranks, token_url, flax_params,
                                                            monkeypatch):
    """No group: the port's flash path on one device, one decode thread,
    over the rows the seq-split runs read."""
    import torch
    monkeypatch.setattr(lm, 'LONG_CONTEXT_LM', dict(lm.LONG_CONTEXT_LM, **CONFIG,
                                                    compute_dtype=torch.float32))
    params = {k: torch.tensor(v) for k, v in _port_params(flax_params).items()}
    seeded_model, check_batch = lm._model, lm._check_batch

    def model_from_params(config, **kwargs):
        model = seeded_model(config, **kwargs)
        model.load_state_dict(params)
        return model

    seen = []

    def record_batch(tokens, device, devices):
        seen.append(tokens.numpy())
        check_batch(tokens, device, devices)

    monkeypatch.setattr(lm, '_model', model_from_params)
    monkeypatch.setattr(lm, '_check_batch', record_batch)
    result = lm.train_lm(token_url, STEPS, batch_size=BATCH, strategy='flash', device='cpu',
                         workers_count=1)
    assert result['mesh'] is None
    assert len(seen) == STEPS
    for got, want in zip(seen, _global_tokens(ranks, 'ring seq 2')):
        np.testing.assert_array_equal(got, want)
    ring = ranks[0]['ring seq 2']
    np.testing.assert_allclose(result['losses'], ring['losses'], rtol=TOL, atol=TOL)
    _assert_params_close({k: v.numpy() for k, v in result['model'].state_dict().items()},
                         ring['params'])

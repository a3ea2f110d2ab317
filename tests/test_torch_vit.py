"""The port's ViT and transformer modules against the JAX package's flax
modules, with the flax parameters carried across by
``petastorm_tpu_torch.convert``.

Both sides run their flash attention (JAX: Pallas kernels in interpret
mode; port: the kernels' plain versions on the CPU).  Tolerances: fp32
logits and activations 1e-4 (different summation orders only); fp32
gradients and parameters after SGD steps 1e-5 absolute + 1e-4 relative;
bf16 logits 5e-2, because the two frameworks round bf16 intermediates at
different points (XLA fuses elementwise chains in fp32 and rounds once,
PyTorch rounds after each op) and bf16 keeps 8 mantissa bits (2^-8 =
0.0039 relative per rounding) through two blocks.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.models import transformer as jax_tf
from petastorm_tpu.models.vit import ViT as JaxViT

from petastorm_tpu_torch.convert import (attention_params_from_flax, block_params_from_flax,
                                         vit_params_from_flax)
from petastorm_tpu_torch.models.transformer import Attention, Block, RMSNorm
from petastorm_tpu_torch.models.vit import ViT
from petastorm_tpu_torch.ops import flash_attention

TINY = dict(patch_size=8, d_model=32, num_heads=2, num_layers=2, d_ff=64)
DTYPES = {'float32': (jnp.float32, torch.float32), 'bfloat16': (jnp.bfloat16, torch.bfloat16)}


def _params(module, x, seed):
    """flax init, then perturbed so zero-initialized biases, cls token and
    unit norm scales carry signal too; returned as numpy."""
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)


def _images(seed, n=3, hw=16):
    return np.random.default_rng(seed).uniform(0, 1, (n, hw, hw, 3)).astype(np.float32)


def _vit_pair(dtype_name, pool, seed=0, remat=False):
    jdt, tdt = DTYPES[dtype_name]
    x = _images(seed)
    jax_model = JaxViT(num_classes=10, dtype=jdt, pool=pool, remat=remat, **TINY)
    params = _params(jax_model, x, seed)
    model = ViT(10, image_hw=(16, 16), compute_dtype=tdt, pool=pool, remat=remat, **TINY)
    model.load_state_dict(vit_params_from_flax(params))
    return jax_model, params, model, x


@pytest.mark.parametrize('pool', ['mean', 'cls'])
@pytest.mark.parametrize('dtype_name,tol', [('float32', 1e-4), ('bfloat16', 5e-2)])
def test_vit_logits_match_jax(dtype_name, tol, pool):
    jax_model, params, model, x = _vit_pair(dtype_name, pool)
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(x)))
    got = model(torch.tensor(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=tol)


def test_vit_gradients_and_sgd_steps_match_jax():
    """Same loss gradients, then the same parameters after two SGD steps
    with momentum 0.9 (optax.sgd vs torch.optim.SGD)."""
    jax_model, params, model, x = _vit_pair('float32', 'mean', seed=1)
    labels = np.array([3, 7, 1], np.int32)

    def loss_fn(p):
        logits = jax_model.apply({'params': p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    tx = optax.sgd(0.1, momentum=0.9)
    opt_state = tx.init(params)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    named = dict(model.named_parameters())
    for step in range(2):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)

        opt.zero_grad()
        got_loss = F.cross_entropy(model(torch.tensor(x)), torch.tensor(labels).long())
        got_loss.backward()
        np.testing.assert_allclose(float(got_loss.detach()), float(loss), atol=1e-5, rtol=1e-4)
        if step == 0:
            want_grads = vit_params_from_flax(jax.tree.map(np.asarray, grads))
            assert set(want_grads) == set(named)
            for name, want in want_grads.items():
                np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                                           atol=1e-5, rtol=1e-4, err_msg=name)
        opt.step()
    for name, want in vit_params_from_flax(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_allclose(named[name].detach().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize('dtype_name', ['float32', 'bfloat16'])
def test_rmsnorm_matches_flax_including_dtype(dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    params = _params(jax_tf.RMSNorm(), x, 2)
    want = jax_tf.RMSNorm().apply({'params': params}, jnp.asarray(x, jdt))
    norm = RMSNorm(32)
    norm.load_state_dict({'scale': torch.tensor(params['scale'])})
    got = norm(torch.tensor(x).to(tdt))
    # a bf16 input gives an fp32 output on both sides (fp32 scale promotes)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('causal', [False, True])
def test_attention_matches_flax(causal):
    x = np.random.default_rng(3).standard_normal((2, 12, 32)).astype(np.float32)
    jax_attn = jax_tf.Attention(num_heads=2, dtype=jnp.float32, causal=causal)
    params = _params(jax_attn, x, 3)
    want = np.asarray(jax_attn.apply({'params': params}, jnp.asarray(x)))
    attn = Attention(32, 2, torch.float32, causal=causal)
    attn.load_state_dict(attention_params_from_flax(params))
    np.testing.assert_allclose(attn(torch.tensor(x)).detach().numpy(), want,
                               atol=1e-4, rtol=1e-4)


def test_block_matches_flax():
    x = np.random.default_rng(4).standard_normal((2, 12, 32)).astype(np.float32)
    jax_block = jax_tf.Block(num_heads=2, d_ff=64, dtype=jnp.float32, causal=False)
    params = _params(jax_block, x, 4)
    want = np.asarray(jax_block.apply({'params': params}, jnp.asarray(x)))
    block = Block(32, 2, 64, torch.float32, causal=False)
    block.load_state_dict(block_params_from_flax(params))
    np.testing.assert_allclose(block(torch.tensor(x)).detach().numpy(), want,
                               atol=1e-4, rtol=1e-4)


def test_vit_rejects_bad_inputs():
    model = ViT(10, image_hw=(16, 16), **TINY)
    with pytest.raises(ValueError):
        model(torch.zeros(1, 24, 16, 3))
    with pytest.raises(ValueError):
        ViT(10, image_hw=(20, 16), **TINY)
    with pytest.raises(ValueError):
        ViT(10, image_hw=(16, 16), pool='max', **TINY)


@pytest.mark.parametrize('pool', ['mean', 'cls'])
def test_vit_remat_logits_and_gradients_match_jax_remat(pool):
    """``ViT(remat=True)`` against flax's ``nn.remat(Block)`` ViT: fp32
    logits 1e-4, loss gradients 1e-5 absolute + 1e-4 relative."""
    jax_model, params, model, x = _vit_pair('float32', pool, seed=5, remat=True)
    labels = np.array([3, 7, 1], np.int32)

    def loss_fn(p):
        logits = jax_model.apply({'params': p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (loss, want_logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    logits = model(torch.tensor(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=1e-4,
                               rtol=1e-4)
    got_loss = F.cross_entropy(logits, torch.tensor(labels).long())
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), atol=1e-5, rtol=1e-4)
    named = dict(model.named_parameters())
    for name, want in vit_params_from_flax(jax.tree.map(np.asarray, grads)).items():
        np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def _logits_and_grads(model, x, labels):
    logits = model(torch.tensor(x))
    F.cross_entropy(logits, torch.tensor(labels).long()).backward()
    return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize('dtype_name', ['float32', 'bfloat16'])
def test_vit_remat_equals_no_remat_bit_for_bit(dtype_name):
    """The same weights with and without remat: the recomputed forward is
    the same computation, so logits and gradients are equal bit for bit."""
    _, _, plain, x = _vit_pair(dtype_name, 'mean', seed=6)
    remat = ViT(10, image_hw=(16, 16), compute_dtype=DTYPES[dtype_name][1], remat=True, **TINY)
    remat.load_state_dict(plain.state_dict())
    labels = np.array([0, 9, 4], np.int32)
    want_logits, want_grads = _logits_and_grads(plain, x, labels)
    got_logits, got_grads = _logits_and_grads(remat, x, labels)
    assert torch.equal(got_logits, want_logits)
    assert set(got_grads) == set(want_grads)
    for name, grad in want_grads.items():
        assert torch.equal(got_grads[name], grad), name


def test_vit_remat_runs_the_attention_forward_twice_per_block():
    calls = []

    def counting_attn(q, k, v, causal):
        calls.append(torch.is_grad_enabled())
        return flash_attention(q, k, v, causal=causal)

    x = torch.tensor(_images(7))
    model = ViT(10, image_hw=(16, 16), compute_dtype=torch.float32, attn_fn=counting_attn,
                remat=True, **TINY)
    model(x).sum().backward()
    assert len(calls) == 2 * TINY['num_layers']
    calls.clear()
    with torch.no_grad():   # no gradients: nothing to recompute
        model(x)
    assert len(calls) == TINY['num_layers']


def test_vit_params_from_flax_carries_a_remat_model():
    """flax's ``nn.remat(Block)`` keeps the ``block_%d`` names: a remat
    ViT's parameters are the plain one's, and ``vit_params_from_flax``
    loads them into ``ViT(remat=True)`` unchanged."""
    x = jnp.asarray(_images(8))
    trees = [JaxViT(num_classes=10, dtype=jnp.float32, remat=remat, **TINY).init(
        jax.random.PRNGKey(8), x)['params'] for remat in (False, True)]
    assert jax.tree.structure(trees[0]) == jax.tree.structure(trees[1])
    converted = [vit_params_from_flax(jax.tree.map(np.asarray, t)) for t in trees]
    assert set(converted[0]) == set(converted[1])
    for name, value in converted[0].items():
        assert torch.equal(converted[1][name], value), name
    model = ViT(10, image_hw=(16, 16), compute_dtype=torch.float32, remat=True, **TINY)
    model.load_state_dict(converted[1])

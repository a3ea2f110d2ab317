"""The port's ``TransformerLM`` against the JAX package's flax model, with
the flax parameters carried across by
``petastorm_tpu_torch.convert.transformer_lm_params_from_flax``.

Both sides run the same attention strategy (JAX: the Pallas kernels in
interpret mode, or the dense reference; port: the kernels' plain versions
on the CPU, or its dense reference).  Tolerances: fp32 logits 1e-4
(summation order only); bf16 logits 3e-2 absolute and relative, since the
logits are a bf16 product (one bf16 ulp is 2^-8 relative) and the two
frameworks round bf16 intermediates at different points.  The training
step is held to flax + optax in float64, at 1e-5 absolute and 1e-4
relative: XLA's fp32 gradients on the CPU are themselves further than
that from float64 (see ``test_torch_resnet.py``).
"""

import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.jax import packing as jax_packing
from petastorm_tpu.models import transformer as jax_tf

from petastorm_tpu_torch.convert import transformer_lm_params_from_flax
from petastorm_tpu_torch.gpu import packing
from petastorm_tpu_torch.models.transformer import (TransformerLM, make_attn_fn, rope,
                                                    rope_cos_sin)

#: vocab 64, d_model 32, 4 heads (head_dim 8), 2 layers, sequences of 64.
TINY = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=64)
DTYPES = {'float32': (jnp.float32, torch.float32, 1e-4),
          'bfloat16': (jnp.bfloat16, torch.bfloat16, 3e-2)}
#: name -> TransformerLM keyword arguments beyond TINY
VARIANTS = {'mha': {}, 'gqa': dict(num_kv_heads=2), 'rope': dict(pos_embed='rope'),
            'gqa_rope': dict(num_kv_heads=2, pos_embed='rope')}


def _tokens(seed, b=2, s=64):
    return np.random.default_rng(seed).integers(0, TINY['vocab_size'], (b, s)).astype(np.int32)


def _params(module, tokens, seed):
    """flax init, perturbed so zero biases and unit norm scales carry
    signal too; returned as numpy fp32."""
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))['params']
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)


def _pair(variant, dtype_name='float32', strategy='flash', seed=0, remat=False):
    jdt, tdt, _ = DTYPES[dtype_name]
    kw = dict(TINY, **VARIANTS[variant])
    tokens = _tokens(seed)
    jax_model = jax_tf.TransformerLM(dtype=jdt, attn_fn=jax_tf.make_attn_fn(None, strategy),
                                     **kw)
    params = _params(jax_model, tokens, seed)
    model = TransformerLM(compute_dtype=tdt, attn_fn=make_attn_fn(None, strategy), remat=remat,
                          **kw)
    model.load_state_dict(transformer_lm_params_from_flax(params))
    return jax_model, params, model, tokens


def _packed_batch(seed, max_len=64):
    """A real packer batch: documents of 5..40 tokens, first-fit-decreasing,
    so every row ends in padding (segment 0)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, TINY['vocab_size'], rng.integers(5, 41)).astype(np.int32)
            for _ in range(5)]
    batch = packing.pack_sequences(docs, max_len)
    assert (batch['segment_ids'][:, -1] == 0).all()
    return batch


def _lm_logits(strategy, variant, dtype_name):
    """(port, flax) logits on the same tokens and carried weights."""
    jax_model, params, model, tokens = _pair(variant, dtype_name, strategy)
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(tokens)))
    return model(torch.tensor(tokens)), want


def _packed_lm_logits(attn, dtype_name):
    """(port, flax) logits of a packed batch, with its segment ids and
    per-document positions."""
    jdt, tdt, _ = DTYPES[dtype_name]
    batch = _packed_batch(1)
    tokens, seg, pos = batch['tokens'], batch['segment_ids'], batch['positions']
    if attn == 'packed_attention':
        jax_attn = functools.partial(jax_packing.packed_attention, segment_ids=jnp.asarray(seg))
        attn_fn = functools.partial(packing.packed_attention, segment_ids=torch.tensor(seg))
    else:
        jax_attn = jax_tf.make_attn_fn(None, attn, segment_ids=jnp.asarray(seg))
        attn_fn = make_attn_fn(None, attn, segment_ids=torch.tensor(seg))
    jax_model = jax_tf.TransformerLM(dtype=jdt, attn_fn=jax_attn, **TINY)
    params = _params(jax_model, tokens, 1)
    want = np.asarray(jax_model.apply({'params': params}, jnp.asarray(tokens),
                                      positions=jnp.asarray(pos)))
    model = TransformerLM(compute_dtype=tdt, **TINY)
    model.load_state_dict(transformer_lm_params_from_flax(params))
    return model(torch.tensor(tokens), positions=torch.tensor(pos), attn_fn=attn_fn), want


@pytest.mark.parametrize('dtype_name', ['float32', 'bfloat16'])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
@pytest.mark.parametrize('strategy', ['flash', 'dense'])
def test_lm_logits_match_flax(strategy, variant, dtype_name):
    got, want = _lm_logits(strategy, variant, dtype_name)
    tol = DTYPES[dtype_name][2]
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == (2, 64, TINY['vocab_size'])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize('dtype_name', ['float32', 'bfloat16'])
@pytest.mark.parametrize('attn', ['flash', 'dense', 'packed_attention'])
def test_packed_lm_logits_match_flax(attn, dtype_name):
    """Segment ids and per-document positions from a real packed batch."""
    got, want = _packed_lm_logits(attn, dtype_name)
    tol = DTYPES[dtype_name][2]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize('variant', ['mha', 'gqa_rope'])
def test_remat_gives_the_gradients_of_no_remat(variant):
    """``remat=True`` recomputes each block in the backward pass, through
    the flash op's forward a second time; the gradients stay the same."""
    grads = []
    for remat in (False, True):
        _, _, model, tokens = _pair(variant, seed=2, remat=remat)
        tokens = torch.tensor(tokens).long()
        logits = model(tokens)
        F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                        torch.roll(tokens, -1, dims=1).reshape(-1)).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=1e-7, rtol=1e-6,
                                   msg=name)


def test_remat_runs_the_attention_forward_twice_per_layer():
    calls = []

    def counting_attn(q, k, v, causal):
        calls.append(torch.is_grad_enabled())
        return make_attn_fn(None, 'dense')(q, k, v, causal=causal)

    _, _, model, tokens = _pair('mha', seed=3, remat=True)
    model(torch.tensor(tokens), attn_fn=counting_attn).sum().backward()
    assert len(calls) == 2 * TINY['num_layers']


@pytest.mark.parametrize('variant', ['mha', 'gqa_rope'])
def test_loss_gradients_and_adamw_step_match_flax_float64(variant):
    """The long-context example's step: cross entropy against
    ``roll(tokens, -1)``, meaned, and ``optax.adamw(3e-4)`` as
    ``torch.optim.AdamW(3e-4, weight_decay=1e-4)``.  Loss and gradients are
    held to flax in float64 with dense attention; the port runs fp32 with
    its flash op.  The AdamW step is held to optax in float64 applied to
    the port's own gradients: Adam divides each gradient by its magnitude,
    so on gradients that are 0 in exact arithmetic (the key bias's: a
    constant added to every key leaves the softmax unchanged) fp32 noise
    of 1e-9 moves a parameter by up to the learning rate."""
    _, params, model, tokens = _pair(variant, seed=4)
    kw = dict(TINY, **VARIANTS[variant])
    with jax.enable_x64(True):
        jax_model = jax_tf.TransformerLM(dtype=jnp.float64,
                                         attn_fn=jax_tf.make_attn_fn(None, 'dense'), **kw)

        def loss_fn(p):
            logits = jax_model.apply({'params': p}, jnp.asarray(tokens))
            labels = jnp.roll(jnp.asarray(tokens), -1, axis=1)
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
        loss, grads = float(loss), jax.tree.map(np.asarray, grads)

    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    named = dict(model.named_parameters())
    t = torch.tensor(tokens).long()
    with jax.enable_x64(True):
        tx = optax.adamw(3e-4)
        ref = {n: jnp.asarray(p.detach().numpy(), jnp.float64) for n, p in named.items()}
        opt_state = tx.init(ref)
        for step in range(2):
            opt.zero_grad()
            logits = model(t)
            got = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  torch.roll(t, -1, dims=1).reshape(-1), reduction='none').mean()
            got.backward()
            if step == 0:
                np.testing.assert_allclose(float(got.detach()), loss, atol=1e-5, rtol=1e-4)
                want_grads = transformer_lm_params_from_flax(grads)
                assert set(want_grads) == set(named)
                for name, want in want_grads.items():
                    np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                                               atol=1e-5, rtol=1e-4, err_msg=name)
            port_grads = {n: jnp.asarray(p.grad.numpy(), jnp.float64) for n, p in named.items()}
            updates, opt_state = tx.update(port_grads, opt_state, ref)
            ref = optax.apply_updates(ref, updates)
            opt.step()
            for name, want in ref.items():
                np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(want),
                                           atol=1e-5, rtol=1e-4, err_msg=name)


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 7)).astype(np.int32)
    want = np.asarray(jax_tf.rope(jnp.asarray(x), jnp.asarray(pos)))
    got = rope(torch.tensor(x), torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert rope(torch.tensor(x).bfloat16(), torch.tensor(pos)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match='even head_dim'):
        rope_cos_sin(torch.tensor(pos), 15)


def test_make_attn_fn_strategies():
    for strategy in ('ring', 'ulysses'):
        with pytest.raises(ValueError, match='needs a mesh'):
            make_attn_fn(None, strategy)
    with pytest.raises(ValueError, match='unknown'):
        make_attn_fn(object(), 'sparse')
    seg = torch.tensor(_packed_batch(0)['segment_ids'])
    q, k, v = (torch.randn(len(seg), 64, 2, 8, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    flash = make_attn_fn(None, 'flash', segment_ids=seg)
    dense = make_attn_fn(None, 'dense', segment_ids=seg)
    torch.testing.assert_close(flash(q, k, v, causal=True), dense(q, k, v, causal=True),
                               atol=2e-5, rtol=2e-5)


def test_lm_rejects_bad_configurations():
    with pytest.raises(ValueError, match='pos_embed'):
        TransformerLM(pos_embed='alibi', **TINY)
    with pytest.raises(ValueError, match='num_kv_heads'):
        TransformerLM(num_kv_heads=3, **TINY)


def _bf16_operands(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((64, 32)).astype(np.float32),
            rng.standard_normal((32, 48)).astype(np.float32),
            rng.standard_normal(48).astype(np.float32),
            (rng.standard_normal(100000) * 2).astype(np.float32),
            [rng.standard_normal((2, 64, 4, 8)).astype(np.float32) for _ in range(3)])


def _fused_bias_dense(self, x):
    """``Dense.forward`` with the bias fused into the product."""
    dt = self.compute_dtype
    return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _xla_gelu(x, approximate='tanh'):
    """``jax.nn.gelu(x, approximate=True)`` as XLA computes it: each op
    rounded to x's dtype, the constants too."""
    assert approximate == 'tanh'
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _fused_softmax_attention(q, k, v, causal=False, scale=None, segment_ids=None):
    """``full_attention`` with its scale kept in fp32 and PyTorch's fused
    softmax."""
    from petastorm_tpu_torch.ops.flash_attention import NEG_INF
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sc = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    if causal:
        sc = torch.where(torch.tril(torch.ones(q.shape[1], q.shape[1], dtype=torch.bool)),
                         sc, NEG_INF)
    if segment_ids is not None:
        seg = segment_ids
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        sc = torch.where(same[:, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    if segment_ids is not None:
        p = torch.where((segment_ids != 0)[:, None, :, None], p, 0.0)
    return torch.einsum('bhqk,bkhd->bqhd', p, v)


def _rounding_points(seed=0):
    """bf16 results of a ``Dense``, gelu and the dense causal reference
    attention: flax's, the port's, and an alternative that rounds
    elsewhere (a fused bias; XLA's op-by-op gelu; an fp32 scale and a fused
    softmax)."""
    import flax.linen as flax_nn
    from petastorm_tpu.parallel.ring_attention import full_attention as jax_full_attention
    from petastorm_tpu_torch.models.transformer import Dense
    from petastorm_tpu_torch.ops.flash_attention import full_attention

    x, kernel, bias, act, qkv = _bf16_operands(seed)
    bf = lambda a: torch.tensor(a).bfloat16()  # noqa: E731
    as_np = lambda t: t.detach().float().numpy()  # noqa: E731
    out = {}
    want = flax_nn.Dense(48, dtype=jnp.bfloat16).apply(
        {'params': {'kernel': kernel, 'bias': bias}}, jnp.asarray(x))
    dense = Dense(32, 48, torch.bfloat16)
    dense.load_state_dict({'weight': torch.tensor(kernel.T), 'bias': torch.tensor(bias)})
    out['dense'] = (np.asarray(want.astype(jnp.float32)), as_np(dense(torch.tensor(x))),
                    as_np(_fused_bias_dense(dense, torch.tensor(x))))
    want = jax.nn.gelu(jnp.asarray(act, jnp.bfloat16))
    out['gelu'] = (np.asarray(want.astype(jnp.float32)),
                   as_np(F.gelu(bf(act), approximate='tanh')), as_np(_xla_gelu(bf(act))))
    want = jax_full_attention(*(jnp.asarray(a, jnp.bfloat16) for a in qkv), causal=True)
    q, k, v = (bf(a) for a in qkv)
    out['attention'] = (np.asarray(want.astype(jnp.float32)),
                        as_np(full_attention(q, k, v, causal=True)),
                        as_np(_fused_softmax_attention(q, k, v, causal=True)))
    return out


@pytest.mark.parametrize('op', ['dense', 'attention'])
def test_bf16_rounding_points_match_flax_bit_for_bit(op):
    """In bf16 the port rounds where XLA rounds at the two points the
    logits' tolerance needs (see ``__main__``): a ``Dense`` rounds its
    product before the bias add, the dense reference rounds its scale to
    bf16 and runs ``jax.nn.softmax`` op by op."""
    want, got, _ = _rounding_points()[op]
    np.testing.assert_array_equal(got, want)


def test_fused_gelu_is_within_the_bf16_tolerance_of_flax():
    """The port keeps PyTorch's fused gelu, which rounds once where XLA
    rounds each op: elementwise within the bf16 tolerance of flax's."""
    want, got, xla = _rounding_points()['gelu']
    tol = DTYPES['bfloat16'][2]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(xla, want)


#: rounding point -> the patch that swaps in its alternative
ALTERNATIVES = {
    'dense: fused bias': ('petastorm_tpu_torch.models.transformer.Dense.forward',
                          _fused_bias_dense),
    'gelu: op by op (XLA)': ('torch.nn.functional.gelu', _xla_gelu),
    'attention: fp32 scale, fused softmax': (
        'petastorm_tpu_torch.models.transformer.full_attention', _fused_softmax_attention),
}


def _bf16_logit_shares():
    """The largest share of the bf16 tolerance over every bf16 case of
    the two logits tests, and the case it is in."""
    tol = DTYPES['bfloat16'][2]
    shares = {}
    for strategy in ('flash', 'dense'):
        for variant in sorted(VARIANTS):
            shares['%s/%s' % (strategy, variant)] = _lm_logits(strategy, variant, 'bfloat16')
    for attn in ('flash', 'dense', 'packed_attention'):
        shares['packed/' + attn] = _packed_lm_logits(attn, 'bfloat16')
    shares = {case: float(np.max(np.abs(got.detach().numpy() - want) / (tol + tol * np.abs(want))))
              for case, (got, want) in shares.items()}
    worst = max(shares, key=shares.get)
    return shares[worst], worst


if __name__ == '__main__':
    from unittest import mock
    # How far each rounding point's alternative sits from flax (CPU): in
    # elements of the op alone, and as the bf16 logits' largest share of
    # their 3e-2 tolerance (over 1 fails the logits tests).
    for name, (want, got, alt) in _rounding_points().items():
        print('%-9s port: %d of %d elements differ from flax; alternative: %d'
              % (name, int((got != want).sum()), want.size, int((alt != want).sum())))
    print('%-38s share %.3f (%s)' % (('port as it is',) + _bf16_logit_shares()))
    for name, (target, alternative) in ALTERNATIVES.items():
        with mock.patch(target, alternative):
            print('%-38s share %.3f (%s)' % ((name,) + _bf16_logit_shares()))

"""The port's KV-cache generation and sampler against the JAX package's.

``petastorm_tpu_torch.models.decoding.generate`` runs a model whose flax
parameters were carried across by ``convert``, on fp32 models (greedy and
sampled tokens must be the same token for token, so the logits must not
round differently at bf16's coarse grid).  ``petastorm_tpu_torch.random``'s
``categorical`` must pick what ``jax.random.categorical`` picks for the
same key and logits.  JAX's prefill runs its Pallas forward in interpret
mode, the port's the kernel's plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.models import decoding as jax_decoding
from petastorm_tpu.models import transformer as jax_tf

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.convert import transformer_lm_params_from_flax
from petastorm_tpu_torch.models import decoding
from petastorm_tpu_torch.models.transformer import TransformerLM

#: vocab 61, d_model 32, 4 heads, 2 layers, a 32-position cache
TINY = dict(vocab_size=61, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=32)
VARIANTS = {'mha': {}, 'gqa_rope': dict(num_kv_heads=2, pos_embed='rope')}


def _pair(variant, seed=7):
    kw = dict(TINY, **VARIANTS[variant])
    jax_model = jax_tf.TransformerLM(dtype=jnp.float32, **kw)
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))['params']
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    model = TransformerLM(compute_dtype=torch.float32, **kw)
    model.load_state_dict(transformer_lm_params_from_flax(params))
    return jax_model, params, model


def _prompt(seed, b=2, length=5):
    return np.random.default_rng(seed).integers(0, TINY['vocab_size'], (b, length)).astype(
        np.int32)


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_greedy_generate_matches_jax(variant):
    jax_model, params, model = _pair(variant)
    prompt = _prompt(0)
    want = np.asarray(jax_decoding.generate(jax_model, params, jnp.asarray(prompt), 8))
    got = decoding.generate(model, torch.tensor(prompt), 8)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_matches_stepwise_full_forward():
    """Cached decoding picks the tokens a full forward over the growing
    prefix picks."""
    _, _, model = _pair('gqa_rope')
    prompt = torch.tensor(_prompt(1)).long()
    got = decoding.generate(model, prompt, 6)
    seq = prompt
    with torch.no_grad():
        for t in range(6):
            nxt = model(seq)[:, -1].argmax(dim=-1)
            assert torch.equal(got[:, t].long(), nxt), 'diverged at step %d' % t
            seq = torch.cat([seq, nxt[:, None]], dim=1)


@pytest.mark.parametrize('knobs', [dict(temperature=0.8, top_p=0.95),
                                   dict(temperature=1.3, top_k=5),
                                   dict(temperature=0.7, top_k=10, top_p=0.9),
                                   dict(temperature=1.0, eos_id=3, pad_id=0)])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_sampled_generate_matches_jax(variant, knobs):
    jax_model, params, model = _pair(variant)
    prompt = _prompt(2, length=8)
    for seed in (0, 5):
        want = np.asarray(jax_decoding.generate(jax_model, params, jnp.asarray(prompt), 12,
                                                rng=jax.random.PRNGKey(seed), **knobs))
        got = decoding.generate(model, torch.tensor(prompt), 12, rng=prng.PRNGKey(seed),
                                **knobs)
        np.testing.assert_array_equal(got.numpy(), want)


def _per_token_generate(model, prompt, max_new, temperature, rng, top_k=None, top_p=None):
    """The token loop drawing each token's key and Gumbel noise as it goes
    (``categorical`` under ``split(key)``), with the cache written at host
    positions: the reference for ``generate``'s noise drawn up front."""
    b, length = prompt.shape
    with torch.no_grad():
        cache = model.init_cache(b)
        logits = model(prompt, positions=torch.arange(length).expand(b, length),
                       cache=cache)[:, -1]
        key, tokens = rng, []
        for t in range(length, length + max_new):
            key, sub = prng.split(key)
            truncated = decoding._truncate_logits(logits / temperature, top_k, top_p)
            token = prng.categorical(sub, truncated)
            tokens.append(token)
            logits = model(token[:, None], positions=torch.full((b, 1), t), cache=cache)[:, 0]
    return torch.stack(tokens, dim=1).to(torch.int32)


@pytest.mark.parametrize('knobs', [dict(temperature=0.8, top_p=0.95),
                                   dict(temperature=1.3, top_k=5)])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_noise_drawn_up_front_picks_what_per_token_draws_pick(variant, knobs):
    _, _, model = _pair(variant)
    prompt = torch.tensor(_prompt(8, length=6)).long()
    for seed in (1, 2, 3):
        want = _per_token_generate(model, prompt, 10, rng=prng.PRNGKey(seed), **knobs)
        got = decoding.generate(model, prompt, 10, rng=prng.PRNGKey(seed), **knobs)
        assert torch.equal(got, want)


def test_one_token_steps_write_at_the_device_position():
    """A one-token step writes the cache at ``position`` (a device tensor)
    and advances it with ``index``; a prefill sets it."""
    _, _, model = _pair('mha')
    prompt = torch.tensor(_prompt(9)).long()
    with torch.no_grad():
        cache = model.init_cache(2)
        model(prompt, positions=torch.arange(5).expand(2, 5), cache=cache)
        assert [(c.index, int(c.position)) for c in cache] == [(5, 5)] * len(cache)
        before = [c.key.clone() for c in cache]
        model(prompt[:, :1], positions=torch.full((2, 1), 5), cache=cache)
    for c, k in zip(cache, before):
        assert (c.index, int(c.position)) == (6, 6)
        assert torch.equal(c.key[:, :5], k[:, :5]) and not torch.equal(c.key[:, 5], k[:, 5])
        assert torch.equal(c.key[:, 6:], k[:, 6:])


def test_eos_pads_the_rest_of_the_row():
    _, _, model = _pair('mha')
    prompt = torch.tensor(_prompt(3))
    free = decoding.generate(model, prompt, 10)
    eos = int(free[0, 2])
    got = decoding.generate(model, prompt, 10, eos_id=eos, pad_id=60)
    first = int((got[0] == eos).nonzero()[0])
    assert first <= 2 and (got[0, first + 1:] == 60).all()


@pytest.mark.parametrize('top_k,top_p', [(1, None), (3, None), (None, 1e-9), (None, 0.5),
                                         (3, 0.5), (None, None), (7, 1.0)])
def test_truncate_logits_matches_jax_on_ties(top_k, top_p):
    """Tied logits: selection is by sort position, the lower index first."""
    rng = np.random.default_rng(4)
    logits = np.stack([np.zeros(7), rng.integers(0, 3, 7), rng.standard_normal(7)]).astype(
        np.float32)
    want = np.asarray(jax_decoding._truncate_logits(jnp.asarray(logits), top_k, top_p))
    got = decoding._truncate_logits(torch.tensor(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('shape', [(5,), (3, 7), (2, 1024), (4, 4096)])
@pytest.mark.parametrize('seed', [0, 17, 2 ** 31 - 1])
def test_categorical_matches_jax(seed, shape):
    """Same key, same logits: the same indices; the uniforms under them bit
    for bit."""
    logits = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    got = prng.categorical(prng.PRNGKey(seed), torch.tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.random.uniform(key, shape, minval=tiny))
    got_u = prng.uniform(prng.PRNGKey(seed), shape, minval=tiny)
    assert got_u.dtype == np.float32
    np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))
    np.testing.assert_allclose(prng.gumbel(prng.PRNGKey(seed), shape).numpy(),
                               np.asarray(jax.random.gumbel(key, shape)), rtol=1e-6, atol=1e-6)


def test_chunked_prefill_matches_single_prefill():
    """A multi-token call on a warm cache honours the cached history: an
    8-token prefill in one call, and in chunks of 5 and 3, give the same
    logits for the last 3 positions and the same caches."""
    _, _, model = _pair('gqa_rope')
    prompt = torch.tensor(_prompt(5, length=8)).long()
    pos = torch.arange(8).expand(2, 8)
    with torch.no_grad():
        full_cache = model.init_cache(2)
        full = model(prompt, positions=pos, cache=full_cache)
        cache = model.init_cache(2)
        model(prompt[:, :5], positions=pos[:, :5], cache=cache)
        tail = model(prompt[:, 5:], positions=pos[:, 5:], cache=cache)
    torch.testing.assert_close(tail, full[:, 5:], atol=2e-5, rtol=2e-5)
    for a, c in zip(full_cache, cache):
        assert a.index == c.index == 8
        torch.testing.assert_close(a.key, c.key, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(a.value, c.value, atol=2e-5, rtol=2e-5)


def test_decode_with_rope_needs_positions():
    _, _, model = _pair('gqa_rope')
    cache = model.init_cache(2)
    x = torch.zeros(2, 1, TINY['d_model'])
    with pytest.raises(ValueError, match='explicit positions'):
        model.blocks[0].attn(x, cache=cache[0])


def test_generate_validates_its_arguments():
    _, _, model = _pair('mha')
    prompt = torch.tensor(_prompt(6))
    for kwargs, match in ((dict(max_new_tokens=28), 'max_seq_len'),
                          (dict(max_new_tokens=2, temperature=0.5), 'rng'),
                          (dict(max_new_tokens=2, top_k=3), 'temperature'),
                          (dict(max_new_tokens=2, temperature=1.0, rng=prng.PRNGKey(0),
                                top_k=0), 'top_k'),
                          (dict(max_new_tokens=2, temperature=1.0, rng=prng.PRNGKey(0),
                                top_p=1.5), 'top_p')):
        with pytest.raises(ValueError, match=match):
            decoding.generate(model, prompt, **kwargs)
    with pytest.raises(ValueError, match='batch, len'):
        decoding.generate(model, prompt[0], 2)


if __name__ == '__main__':
    # How often the Gumbel noise differs from XLA's in the last bit (CPU).
    for seed in (0, 17, 2 ** 31 - 1):
        shape = (4, 4096)
        got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
        print('seed %d: %d of %d Gumbel values differ from XLA\'s, by at most %.3g'
              % (seed, int((got != want).sum()), got.size, float(np.abs(got - want).max())))

"""The port's beam search and speculative decoding against the JAX
package's, and the cache primitives they run on.

Small fp32 models (flax parameters carried across by ``convert``) so that
tokens must be equal token for token; beam scores are held within 1e-5
(fp32 sums of log-probs, summed in other orders).  JAX's prefill runs its
Pallas forward in interpret mode, the port's the kernel's plain version.
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
from petastorm_tpu_torch.models.transformer import TransformerLM, reorder_cache, rewind_cache

#: vocab 61, d_model 32, 4 heads, 2 layers, a 32-position cache
TINY = dict(vocab_size=61, d_model=32, num_heads=4, num_layers=2, d_ff=64, max_seq_len=32)
VARIANTS = {'mha': {}, 'gqa': dict(num_kv_heads=2), 'rope': dict(pos_embed='rope')}
#: the JAX tests' bad draft: one layer, d_model 16, at flax's initial weights
DRAFT = dict(vocab_size=61, d_model=16, num_heads=2, num_layers=1, d_ff=32, max_seq_len=32)
SCORE_ATOL = 1e-5


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


def _draft():
    jax_model = jax_tf.TransformerLM(dtype=jnp.float32, **DRAFT)
    params = jax_model.init(jax.random.PRNGKey(99), jnp.zeros((1, 4), jnp.int32))['params']
    model = TransformerLM(compute_dtype=torch.float32, **DRAFT)
    model.load_state_dict(transformer_lm_params_from_flax(jax.tree.map(np.asarray, params)))
    return jax_model, params, model


def _prompt(seed, b=2, length=5):
    return np.random.default_rng(seed).integers(0, TINY['vocab_size'], (b, length)).astype(
        np.int32)


@pytest.mark.parametrize('length_penalty', [1.0, 0.6])
@pytest.mark.parametrize('with_eos', [False, True])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_beam_search_matches_jax(variant, with_eos, length_penalty):
    jax_model, params, model = _pair(variant)
    prompt = _prompt(0)
    kw = dict(num_beams=4, length_penalty=length_penalty)
    if with_eos:
        # a token the free search emits early, so that beams finish
        free, _ = decoding.beam_search(model, torch.tensor(prompt), 8, num_beams=4)
        kw.update(eos_id=int(free[0, 1]), pad_id=60)
    want_tokens, want_scores = jax_decoding.beam_search(jax_model, params, jnp.asarray(prompt),
                                                        8, **kw)
    tokens, scores = decoding.beam_search(model, torch.tensor(prompt), 8, **kw)
    assert tokens.dtype == torch.int32 and tokens.shape == (2, 8)
    assert scores.dtype == torch.float32 and scores.shape == (2,)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=SCORE_ATOL, rtol=0)
    if with_eos:
        row = tokens[0].tolist()
        if kw['eos_id'] in row:   # after its eos a beam emits pad
            assert set(row[row.index(kw['eos_id']) + 1:]) <= {60}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_beam_of_one_is_greedy_generate(variant):
    _, _, model = _pair(variant)
    prompt = torch.tensor(_prompt(1))
    tokens, scores = decoding.beam_search(model, prompt, 10, num_beams=1)
    assert torch.equal(tokens, decoding.generate(model, prompt, 10))
    assert bool((scores < 0).all())


def test_beam_scores_are_the_sequences_log_probs():
    """No eos: every beam's score is its tokens' summed log-prob under a
    full forward, over ``max_new ** length_penalty``."""
    _, _, model = _pair('mha')
    prompt = torch.tensor(_prompt(2)).long()
    tokens, scores = decoding.beam_search(model, prompt, 6, num_beams=3, length_penalty=0.6)
    with torch.no_grad():
        seq = torch.cat([prompt, tokens.long()], dim=1)
        logp = torch.log_softmax(model(seq)[:, prompt.shape[1] - 1:-1], dim=-1)
        total = logp.gather(2, tokens.long()[:, :, None])[:, :, 0].sum(dim=1)
    torch.testing.assert_close(scores, total / 6 ** 0.6, atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize('perfect', [False, True])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_greedy_speculative_matches_jax_and_greedy_generate(variant, perfect):
    jax_model, params, model = _pair(variant)
    jax_draft, draft_params, draft = ((jax_model, params, model) if perfect else _draft())
    prompt = _prompt(3)
    want = np.asarray(jax_decoding.speculative_generate(
        jax_model, params, jax_draft, draft_params, jnp.asarray(prompt), 9, draft_len=3))
    stats = {}
    got = decoding.speculative_generate(model, draft, torch.tensor(prompt), 9, draft_len=3,
                                        stats=stats)
    assert got.dtype == torch.int32 and got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), decoding.generate(model, torch.tensor(prompt),
                                                                 9).numpy())
    # 8 tokens after the first: a perfect draft takes 2 rounds of 4, a bad one up to 8 of 1
    assert stats['host_syncs'] == stats['rounds']
    assert stats['rounds'] + stats['accepted'] >= 8
    if perfect:
        assert stats['rounds'] == 2 and stats['accepted'] == 6


@pytest.mark.parametrize('perfect', [False, True])
@pytest.mark.parametrize('variant', ['mha', 'rope'])
def test_sampled_speculative_matches_jax_under_the_same_key(variant, perfect):
    jax_model, params, model = _pair(variant)
    jax_draft, draft_params, draft = ((jax_model, params, model) if perfect else _draft())
    prompt = _prompt(4)
    for seed in (0, 3):
        want = np.asarray(jax_decoding.speculative_generate(
            jax_model, params, jax_draft, draft_params, jnp.asarray(prompt), 10, draft_len=3,
            temperature=0.8, rng=jax.random.PRNGKey(seed)))
        got = decoding.speculative_generate(model, draft, torch.tensor(prompt), 10, draft_len=3,
                                            temperature=0.8, rng=prng.PRNGKey(seed))
        np.testing.assert_array_equal(got.numpy(), want)


def _raises_like_jax(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_search_validation_raises_the_jax_errors():
    jax_model, params, model = _pair('mha')
    jax_draft, draft_params, draft = _draft()
    ok = _prompt(5)
    for prompt, kw in ((ok[0], dict(max_new_tokens=4)),
                       (ok, dict(max_new_tokens=4, draft_len=0)),
                       (ok, dict(max_new_tokens=4, temperature=0.5)),
                       (ok, dict(max_new_tokens=25, draft_len=3)),
                       (np.zeros((1, 30), np.int32), dict(max_new_tokens=1, draft_len=2))):
        _raises_like_jax(
            lambda prompt=prompt, kw=kw: jax_decoding.speculative_generate(
                jax_model, params, jax_draft, draft_params, jnp.asarray(prompt), **kw),
            lambda prompt=prompt, kw=kw: decoding.speculative_generate(
                model, draft, torch.tensor(prompt), **kw))
    short = TransformerLM(compute_dtype=torch.float32, **dict(DRAFT, max_seq_len=12))
    short_jax = jax_tf.TransformerLM(dtype=jnp.float32, **dict(DRAFT, max_seq_len=12))
    _raises_like_jax(
        lambda: jax_decoding.speculative_generate(jax_model, params, short_jax, draft_params,
                                                  jnp.asarray(ok), 6, draft_len=2),
        lambda: decoding.speculative_generate(model, short, torch.tensor(ok), 6, draft_len=2))
    for prompt, kw in ((ok[0], dict(max_new_tokens=4)),
                       (ok, dict(max_new_tokens=4, num_beams=0)),
                       (ok, dict(max_new_tokens=28))):
        _raises_like_jax(
            lambda prompt=prompt, kw=kw: jax_decoding.beam_search(
                jax_model, params, jnp.asarray(prompt), **kw),
            lambda prompt=prompt, kw=kw: decoding.beam_search(model, torch.tensor(prompt), **kw))


def _prefilled(model, prompt, length):
    b = prompt.shape[0]
    cache = model.init_cache(b)
    with torch.no_grad():
        model(prompt[:, :length], positions=torch.arange(length).expand(b, length), cache=cache)
    return cache


@pytest.mark.parametrize('variant', ['gqa', 'rope'])
def test_a_chunk_at_the_device_position_equals_jax_at_the_host_index(variant):
    """A 3-token chunk on a warm cache of 5 writes at ``position`` (device)
    what JAX's warm chunked prefill writes at its host index, and gives its
    logits."""
    jax_model, params, model = _pair(variant)
    prompt = _prompt(6, length=8)
    b = prompt.shape[0]
    dec = jax_model.clone(decode=True)
    shapes = jax.eval_shape(lambda: dec.init(jax.random.PRNGKey(0), jnp.asarray(prompt[:, :1]),
                                             positions=jnp.zeros((b, 1), jnp.int32)))['cache']
    jax_cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (b, 8))
    for lo, hi in ((0, 5), (5, 8)):
        want, mutated = dec.apply({'params': params, 'cache': jax_cache},
                                  jnp.asarray(prompt[:, lo:hi]),
                                  positions=jnp.asarray(pos[:, lo:hi]), mutable=['cache'])
        jax_cache = mutated['cache']
    t_prompt = torch.tensor(prompt).long()
    cache = _prefilled(model, t_prompt, 5)
    with torch.no_grad():
        got = model(t_prompt[:, 5:], positions=torch.tensor(pos[:, 5:]).long(), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    for i, layer in enumerate(cache):
        assert layer.index == 8 and int(layer.position) == 8
        want_layer = jax_cache['block_%d' % i]['attn']
        np.testing.assert_allclose(layer.key.numpy(), np.asarray(want_layer['key']),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(layer.value.numpy(), np.asarray(want_layer['value']),
                                   atol=2e-5, rtol=2e-5)


def test_rewind_then_rewrite_equals_a_fresh_run():
    """Write a wrong 3-token chunk at 5, roll the device position back to 5
    (the host index left behind), write the right chunk: logits and the
    cache's first 8 positions are those of one 8-token prefill."""
    _, _, model = _pair('rope')
    prompt = torch.tensor(_prompt(7, length=8)).long()
    pos = torch.arange(8).expand(2, 8)
    with torch.no_grad():
        fresh = model.init_cache(2)
        want = model(prompt, positions=pos, cache=fresh)
        cache = _prefilled(model, prompt, 5)
        model(torch.flip(prompt[:, 5:], dims=[0]), positions=pos[:, 5:], cache=cache)
        rewind_cache(cache, torch.tensor([5]))
        assert [(c.index, int(c.position)) for c in cache] == [(8, 5)] * len(cache)
        for c in cache:
            c.index = 5
        got = model(prompt[:, 5:], positions=pos[:, 5:], cache=cache)
    torch.testing.assert_close(got, want[:, 5:], atol=2e-5, rtol=2e-5)
    for a, c in zip(fresh, cache):
        torch.testing.assert_close(c.key[:, :8], a.key[:, :8], atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(c.value[:, :8], a.value[:, :8], atol=2e-5, rtol=2e-5)


def test_reorder_cache_permutes_rows_in_place():
    _, _, model = _pair('gqa')
    prompt = torch.tensor(_prompt(8, b=3)).long()
    cache = _prefilled(model, prompt, 5)
    before = [(c.key.clone(), c.value.clone(), c.key.data_ptr(), c.value.data_ptr())
              for c in cache]
    rows = torch.tensor([2, 2, 0])
    reorder_cache(cache, rows)
    for c, (key, value, kp, vp) in zip(cache, before):
        assert torch.equal(c.key, key[rows]) and torch.equal(c.value, value[rows])
        assert (c.key.data_ptr(), c.value.data_ptr()) == (kp, vp)

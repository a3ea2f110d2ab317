"""Autoregressive generation for ``TransformerLM`` with a static KV cache.

Counterpart of ``petastorm_tpu/models/decoding.py`` (``generate`` and the
helpers it runs on).  The per-layer cache is a fixed ``[batch,
max_seq_len, kv_heads, head_dim]`` buffer (``TransformerLM.init_cache``);
the prompt is one prefill forward (causal ``attn_fn`` over the prompt, the
flash kernels by default), then each new token is one forward of a single
position against the cache.  The JAX package runs the token loop as one
``lax.scan``; on the card the port captures one token step (pick the token,
then the one-position forward, which writes the cache at its device
position) as a CUDA graph and replays it once per token, with a step counter
on the device (:mod:`petastorm_tpu_torch.gpu.graphs`); the CPU, and the
card with ``cuda_graph=False``, run the same step eagerly.  Sampling draws
its keys and Gumbel noise with :mod:`petastorm_tpu_torch.random`
(``jax.random`` reproduced), so the same key picks the same tokens::

    tokens = decoding.generate(model, prompt, max_new_tokens=64)

``beam_search`` and ``speculative_generate`` are a later slice of the port.
"""

import torch

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.gpu import graphs

__all__ = ['generate']


def _prefill(model, prompt):
    """A fresh cache and one causal forward over the prompt at positions
    ``0..L-1``; returns ``(cache, last_logits)``."""
    b, prompt_len = prompt.shape
    cache = model.init_cache(b, prompt.device)
    positions = torch.arange(prompt_len, device=prompt.device).expand(b, prompt_len)
    logits = model(prompt, positions=positions, cache=cache)
    return cache, logits[:, -1]


def _truncate_logits(logits, top_k, top_p):
    """Mask ``[b, vocab]`` logits to the top-k set and/or the top-p nucleus,
    by sort position (ties at the threshold keep the lower index, as
    ``lax.top_k`` orders them); masked entries are ``finfo.min``."""
    b, vocab = logits.shape
    if (top_k is None or top_k >= vocab) and (top_p is None or top_p >= 1.0):
        return logits
    neg_inf = torch.finfo(logits.dtype).min
    k = top_k if (top_k is not None and top_k < vocab) else vocab
    # a stable descending sort keeps equal logits in index order
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    keep = torch.ones_like(vals, dtype=torch.bool)
    if top_p is not None and top_p < 1.0:
        # softmax over the kept slice is the distribution sampling sees;
        # keep sorted position j iff the mass before it is < top_p
        probs = torch.softmax(vals, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    masked = torch.full_like(logits, neg_inf)
    return masked.scatter_(1, idx, torch.where(keep, vals, neg_inf))


def generate(model, prompt, max_new_tokens, temperature=0.0, rng=None, top_k=None,
             top_p=None, eos_id=None, pad_id=0, cuda_graph=None):
    """Generate ``max_new_tokens`` continuations of ``prompt`` ``[b, L]``.

    Returns ``[b, max_new_tokens]`` int32 tokens on the model's device.
    ``temperature=0`` is greedy argmax; ``temperature > 0`` samples with
    ``rng`` (a key from :func:`petastorm_tpu_torch.random.PRNGKey`,
    required), optionally truncated to the ``top_k`` highest logits and/or
    the ``top_p`` nucleus; the key is split once per token, as the JAX
    package splits it, and every token's Gumbel noise is drawn up front
    (``[max_new_tokens, b, vocab]`` float32, moved to the device in one
    copy).  With ``eos_id`` set, a row that emits it emits ``pad_id`` from
    then on.  ``L + max_new_tokens`` must fit ``model.max_seq_len`` (the
    cache's size).  ``cuda_graph``: ``None`` replays a captured token step
    on the card and runs it eagerly on the CPU; ``False`` runs it eagerly on
    the card too.
    """
    device = model.embed.embedding.device
    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.int64)
    if prompt.dim() != 2:
        raise ValueError('prompt must be [batch, len], got %r' % (tuple(prompt.shape),))
    b, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > model.max_seq_len:
        raise ValueError('prompt+new = %d exceeds max_seq_len %d' % (total, model.max_seq_len))
    if temperature > 0 and rng is None:
        raise ValueError('temperature > 0 needs an rng key')
    if (top_k is not None or top_p is not None) and temperature <= 0:
        raise ValueError('top_k/top_p only apply when temperature > 0')
    if top_k is not None and top_k < 1:
        raise ValueError('top_k must be >= 1')
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError('top_p must be in (0, 1]')
    graphed = graphs.resolve(cuda_graph, device)
    noise = None
    if temperature > 0:
        key, subs = rng, []
        for _ in range(max_new_tokens):
            key, sub = prng.split(key)
            subs.append(sub)
        noise = prng.gumbel_stack(subs, (b, model.vocab_size), device)

    with torch.no_grad():
        cache, last_logits = _prefill(model, prompt)
        # The token loop's state, updated in place (a captured step's
        # static buffers): the logits to pick from, the step counter,
        # which rows are done, and the tokens.
        logits = last_logits.contiguous()
        step = torch.zeros(1, dtype=torch.int64, device=device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        tokens = torch.zeros(b, max_new_tokens, dtype=torch.int64, device=device)

        def emit():
            """Pick this step's token from ``logits`` and store it."""
            if noise is None:
                token = torch.argmax(logits, dim=-1)
            else:
                # jax.random.categorical under this step's key: the
                # Gumbel-max trick with the step's noise
                truncated = _truncate_logits(logits / temperature, top_k, top_p)
                token = torch.argmax(noise.index_select(0, step)[0] + truncated, dim=-1)
            if eos_id is not None:
                token = torch.where(done, pad_id, token)
                done.logical_or_(token == eos_id)
            tokens.index_copy_(1, step, token[:, None])
            return token

        def token_step():
            token = emit()
            positions = (step + prompt_len).expand(b, 1)
            logits.copy_(model(token[:, None], positions=positions, cache=cache)[:, 0])
            step.add_(1)

        forwards = max_new_tokens - 1   # the last token needs no forward
        if graphed and forwards > 0:
            token_step = graphs.StepGraph(token_step, range_name='decode_step')
        for _ in range(forwards):
            token_step()
        if max_new_tokens > 0:
            emit()
    return tokens.to(torch.int32)

"""Autoregressive generation for ``TransformerLM`` with a static KV cache.

Counterpart of ``petastorm_tpu/models/decoding.py``: ``generate``,
``beam_search`` and ``speculative_generate``.  The per-layer cache is a fixed ``[batch,
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
    tokens, scores = decoding.beam_search(model, prompt, 64, num_beams=4)
    tokens = decoding.speculative_generate(model, draft, prompt, 64, draft_len=4)

``beam_search`` and ``speculative_generate`` run the same way: one captured
step per token (beam search) or per round (speculative decoding), replayed
on the card, each writing the cache at its device position
(:func:`~petastorm_tpu_torch.models.transformer.reorder_cache` and
:func:`~petastorm_tpu_torch.models.transformer.rewind_cache` re-order and
roll it back in place).
"""

import torch

from petastorm_tpu_torch import random as prng
from petastorm_tpu_torch.gpu import graphs
from petastorm_tpu_torch.models.transformer import reorder_cache, rewind_cache

__all__ = ['generate', 'beam_search', 'speculative_generate']


def _as_prompt(model, prompt):
    """``prompt`` as an int64 ``[batch, len]`` tensor on the model's device."""
    prompt = torch.as_tensor(prompt).to(device=model.embed.embedding.device, dtype=torch.int64)
    if prompt.dim() != 2:
        raise ValueError('prompt must be [batch, len], got %r' % (tuple(prompt.shape),))
    return prompt


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
    prompt = _as_prompt(model, prompt)
    device = prompt.device
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


def speculative_generate(model, draft_model, prompt, max_new_tokens, draft_len=4,
                         temperature=0.0, rng=None, cuda_graph=None, stats=None):
    """Speculative decoding: ``draft_model`` proposes ``draft_len`` tokens a
    round, ``model`` verifies them in one forward of ``draft_len + 1``
    positions against its cache, and the accepted prefix plus one
    correction token are emitted.  Returns ``[b, max_new_tokens]`` int32
    tokens on the model's device.

    ``temperature=0`` is greedy: the tokens of greedy :func:`generate` up to
    argmax ties (the verify forward sums in another order than a one-token
    step).  ``temperature > 0`` (``rng`` required) is speculative sampling:
    a draft is accepted with probability ``min(1, p_t / p_d)`` and the
    first rejection resamples from the normalized residual ``max(p_t - p_d,
    0)``, so the tokens follow the model's own distribution at that
    temperature.  Each round emits the batch's shortest accepted prefix
    plus one token, and rolls both caches back to it.  Both models'
    ``max_seq_len`` must hold ``L + max_new_tokens + draft_len``.

    The key chain is the JAX package's and does not depend on what is
    accepted (each round splits ``(key, draft, accept, resample)`` and the
    draft key into ``draft_len + 1``), so every round's draws, for up to
    ``max_new_tokens - 1`` rounds, are made on the host up front and moved
    to the device in one copy each; a round selects its own by a round
    counter on the device.  The same key gives the JAX function's tokens.

    Loop control: the JAX function is one ``lax.while_loop`` whose round
    count depends on the data.  Here one round (draft steps, verify,
    acceptance, emission and the rollback) is one captured step on the card
    (``cuda_graph`` as in :func:`generate`), and after each round the host
    reads the number of tokens emitted, one device sync a round, and stops
    once it reaches ``max_new_tokens``; no round runs past the end.
    ``stats``, a dict if given, receives ``rounds``, ``accepted`` (drafts
    accepted in all) and ``host_syncs``.
    """
    prompt = _as_prompt(model, prompt)
    device = prompt.device
    if draft_len < 1:
        raise ValueError('draft_len must be >= 1')
    if temperature > 0 and rng is None:
        raise ValueError('temperature > 0 needs an rng key')
    sampled = temperature > 0
    b, prompt_len = prompt.shape
    k = int(draft_len)
    for name, m in (('model', model), ('draft_model', draft_model)):
        if prompt_len + max_new_tokens + k > m.max_seq_len:
            raise ValueError('%s: prompt+new+draft_len = %d exceeds max_seq_len %d'
                             % (name, prompt_len + max_new_tokens + k, m.max_seq_len))
    graphed = graphs.resolve(cuda_graph, device)
    most_rounds = max(max_new_tokens - 1, 0)   # each round emits at least one token
    vocab = model.vocab_size
    key = rng if rng is not None else prng.PRNGKey(0)
    if sampled:
        key, first = prng.split(key)
        draft_keys, accept_keys, resample_keys = [], [], []
        for _ in range(most_rounds):
            key, k_draft, k_accept, k_resample = prng.split(key, 4)
            # the last draft step only fills the cache: its draw goes unused
            draft_keys.extend(prng.split(k_draft, k + 1)[:k])
            accept_keys.append(k_accept)
            resample_keys.append(k_resample)
        if most_rounds:
            draft_noise = prng.gumbel_stack(draft_keys, (b, vocab), device).view(
                most_rounds, k, b, vocab)
            resample_noise = prng.gumbel_stack(resample_keys, (b, vocab), device)
            accept_u = torch.from_numpy(prng.uniform_stack(accept_keys, (b, k))).to(device)

    with torch.no_grad():
        t_cache, t_logits = _prefill(model, prompt)
        d_cache, _ = _prefill(draft_model, prompt)
        if sampled:
            c = prng.categorical(first, t_logits / temperature)
        else:
            c = torch.argmax(t_logits, dim=-1)
        # The loop's state, updated in place (a captured round's static
        # buffers): the emitted tokens, how many, the last one (consumed
        # next round) and the round counter.
        buf = torch.zeros(b, max_new_tokens + k + 1, dtype=torch.int64, device=device)
        buf[:, 0] = c
        emitted = torch.ones(1, dtype=torch.int64, device=device)
        r = torch.zeros(1, dtype=torch.int64, device=device)
        slots = torch.arange(k + 1, device=device)

        def round_step():
            pos = emitted + (prompt_len - 1)     # the position c is consumed at
            # 1. k + 1 draft steps: the last writes the cache entry of the
            #    last proposal, its own token is not needed
            token, drafts, q_probs = c, [], []
            for j in range(k + 1):
                logits = draft_model(token[:, None], positions=(pos + j).expand(b, 1),
                                     cache=d_cache)[:, 0]
                if j == k:
                    break
                if sampled:
                    scaled = logits / temperature
                    noise = draft_noise.index_select(0, r)[0, j]
                    token = torch.argmax(noise + scaled, dim=-1)
                    q_probs.append(torch.softmax(scaled, dim=-1))
                else:
                    token = torch.argmax(logits, dim=-1)
                drafts.append(token)
            drafts = torch.stack(drafts, dim=1)                         # [b, k]
            # 2. verify [c, d1..dk] in one forward at the device positions
            chunk = torch.cat([c[:, None], drafts], dim=1)
            logits = model(chunk, positions=(pos + slots).expand(b, k + 1), cache=t_cache)
            # 3. the accepted prefix, cut at the batch minimum, and the
            #    correction token
            padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            if sampled:
                p_t = torch.softmax(logits / temperature, dim=-1)         # [b, k+1, V]
                q = torch.stack(q_probs, dim=1)                          # [b, k, V]
                p_at_d = p_t[:, :k].gather(2, drafts[:, :, None])[:, :, 0]
                q_at_d = q.gather(2, drafts[:, :, None])[:, :, 0]
                accept = accept_u.index_select(0, r)[0] * q_at_d < p_at_d
                # each row's first rejection (k: all accepted)
                a_r = torch.argmin(torch.cat([accept.long(), torch.zeros_like(padded[:, :1])],
                                             dim=1), dim=1)
                a = a_r.min().view(1)
                # the residual at the cut; with a == k there is no draft
                # there and it is p_t itself: the all-accepted bonus token
                q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
                p_t_a = p_t.index_select(1, a)[:, 0]
                res = torch.clamp_min(p_t_a - q_pad.index_select(1, a)[:, 0], 0.0)
                res = torch.where(res.sum(-1, keepdim=True) > 0, res, p_t_a)
                resampled = torch.argmax(resample_noise.index_select(0, r)[0]
                                         + torch.log(res + 1e-30), dim=-1)
                # rows that accepted past the cut emit their accepted draft
                correction = torch.where(a_r > a, padded.index_select(1, a)[:, 0], resampled)
            else:
                preds = torch.argmax(logits, dim=-1)                     # [b, k+1]
                match = (preds[:, :k] == drafts).all(dim=0)              # [k]
                a = torch.argmin(torch.cat([match.long(), torch.zeros_like(match[:1],
                                                                           dtype=torch.int64)]))
                a = a.view(1)
                correction = preds.index_select(1, a)[:, 0]
            # 4. emit d1..d_a, then the correction (what lies past it is
            #    overwritten by later rounds or cut off at the end)
            emit = torch.where(slots < a, padded,
                               torch.where(slots == a, correction[:, None], 0))
            buf.index_copy_(1, emitted + slots, emit)
            # 5. roll both caches back to the accepted position
            new_pos = pos + a + 1
            rewind_cache(t_cache, new_pos)
            rewind_cache(d_cache, new_pos)
            emitted.add_(a + 1)
            c.copy_(correction)
            r.add_(1)

        if graphed and most_rounds:
            round_step = graphs.StepGraph(round_step, range_name='speculative_round')
        rounds, done = 0, 1
        while done < max_new_tokens:
            round_step()
            rounds += 1
            done = int(emitted)   # the round's one host sync
            # the host's count of the rolled-back position (see KVCache)
            for layer in t_cache + d_cache:
                layer.index = prompt_len + done - 1
    if stats is not None:
        stats.update(rounds=rounds, accepted=done - 1 - rounds, host_syncs=rounds)
    return buf[:, :max_new_tokens].to(torch.int32)


def beam_search(model, prompt, max_new_tokens, num_beams=4, eos_id=None, pad_id=0,
                length_penalty=1.0, cuda_graph=None):
    """Beam search: the ``num_beams`` likeliest continuations of each
    prompt row, returning the best.

    Returns ``(tokens [b, max_new_tokens] int32, scores [b] float32)`` on
    the model's device; a score is the beam's sum of token log-probs over
    ``length ** length_penalty``, its length counted per beam.  The prompt
    is prefilled once at batch ``b`` and its cache rows repeated for the
    beams, which fold into the batch (``b * num_beams`` rows through the
    model); at the start only beam 0 is live.  Each token step picks the
    ``num_beams`` best of every beam's continuations (a stable descending
    sort: equal scores in index order, as ``lax.top_k`` returns them; with
    ``eos_id`` set, finished beams make many equal candidates), re-orders
    every layer's cache rows to the surviving beams' parents in place, and
    runs one position forward.  With ``eos_id`` set a finished beam emits
    ``pad_id`` at no cost.  The path is rebuilt by a walk back over the
    parents.  ``L + max_new_tokens`` must fit ``model.max_seq_len``.  On the
    card the token step is one captured step replayed per token
    (``cuda_graph`` as in :func:`generate`).
    """
    prompt = _as_prompt(model, prompt)
    device = prompt.device
    if num_beams < 1:
        raise ValueError('num_beams must be >= 1')
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > model.max_seq_len:
        raise ValueError('prompt+new = %d exceeds max_seq_len %d'
                         % (prompt_len + max_new_tokens, model.max_seq_len))
    graphed = graphs.resolve(cuda_graph, device)
    k, vocab = num_beams, model.vocab_size
    neg_inf = torch.finfo(torch.float32).min
    with torch.no_grad():
        cache, last_logits = _prefill(model, prompt)
        for layer in cache:   # every prompt row once per beam
            layer.key = layer.key.repeat_interleave(k, dim=0)
            layer.value = layer.value.repeat_interleave(k, dim=0)
        # The token loop's state, updated in place (a captured step's static
        # buffers).
        log_probs = torch.log_softmax(last_logits.float(), dim=-1).repeat_interleave(k, dim=0)
        scores = torch.full((b, k), neg_inf, device=device)
        scores[:, 0] = 0.0
        done = torch.zeros(b, k, dtype=torch.bool, device=device)
        lengths = torch.zeros(b, k, dtype=torch.int64, device=device)
        step = torch.zeros(1, dtype=torch.int64, device=device)
        tokens = torch.zeros(max_new_tokens, b, k, dtype=torch.int64, device=device)
        parents = torch.zeros_like(tokens)
        pad_only = torch.full((vocab,), neg_inf, device=device)
        pad_only[pad_id] = 0.0
        first_row = torch.arange(b, device=device)[:, None] * k

        def select():
            """Pick and record this step's beams; returns their parents."""
            cand = log_probs.view(b, k, vocab) + scores[:, :, None]
            if eos_id is not None:
                cand = torch.where(done[:, :, None], scores[:, :, None] + pad_only, cand)
            top, idx = torch.sort(cand.view(b, k * vocab), dim=1, descending=True, stable=True)
            top, idx = top[:, :k], idx[:, :k]
            parent, token = idx // vocab, idx % vocab
            if eos_id is not None:
                parent_done = done.gather(1, parent)
                done.copy_(parent_done | (token == eos_id))
                token = torch.where(parent_done, pad_id, token)
                # a beam's length counts its real tokens, its eos included
                lengths.copy_(lengths.gather(1, parent) + (~parent_done).long())
            else:
                lengths.add_(1)
            scores.copy_(top)
            tokens.index_copy_(0, step, token[None])
            parents.index_copy_(0, step, parent[None])
            return token, parent

        def token_step():
            token, parent = select()
            reorder_cache(cache, (first_row + parent).view(-1))
            positions = (step + prompt_len).expand(b * k, 1)
            logits = model(token.view(b * k, 1), positions=positions, cache=cache)[:, 0]
            log_probs.copy_(torch.log_softmax(logits.float(), dim=-1))
            step.add_(1)

        forwards = max_new_tokens - 1   # the last token needs no forward
        if graphed and forwards > 0:
            token_step = graphs.StepGraph(token_step, range_name='beam_step')
        for _ in range(forwards):
            token_step()
        if max_new_tokens > 0:
            select()
        # Walk the parents back from the last step: the cache was re-ordered
        # in place, the recorded tokens were not.
        beam = torch.arange(k, device=device).repeat(b, 1)
        path = torch.zeros(b, k, max_new_tokens, dtype=torch.int64, device=device)
        for t in reversed(range(max_new_tokens)):
            path[:, :, t] = tokens[t].gather(1, beam)
            beam = parents[t].gather(1, beam)
        final = scores / lengths.clamp(min=1).float() ** length_penalty
        best = torch.argmax(final, dim=1)
        best_tokens = path.gather(1, best[:, None, None].expand(b, 1, max_new_tokens))[:, 0]
        return best_tokens.to(torch.int32), final.gather(1, best[:, None])[:, 0]

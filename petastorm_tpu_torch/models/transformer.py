"""Transformer building blocks and the decoder-only ``TransformerLM``.

Counterpart of ``petastorm_tpu/models/transformer.py`` as ``nn.Module``s:
``RMSNorm``, ``Attention`` (multi-head or grouped-query, optional RoPE, an
optional KV cache for decoding), ``Block``, ``Embed``, ``TransformerLM``
and ``make_attn_fn``.  The numbers follow the flax modules at every dtype
boundary:

* Parameters are fp32.  A ``Dense`` with ``compute_dtype=bf16`` casts its
  input, weight and bias to bf16 and multiplies in bf16 (flax
  ``Dense(dtype=bf16)``); the cast is explicit, never autocast.
* ``RMSNorm`` returns ``(x * rsqrt(var + eps)).astype(x.dtype) * scale``
  with an fp32 ``scale``: a bf16 input gives an fp32 output, as under
  JAX's type promotion.
* ``Embed`` (flax ``nn.Embed(dtype=bf16)``) looks rows up in the table
  cast to bf16, so a bf16 token plus a bf16 learned position gives a bf16
  residual stream; its ``attend`` (the tied head) is a bf16 product with
  the table's transpose, which ``TransformerLM`` casts to fp32.
* A ``Dense`` rounds its product to bf16 before it adds the bias, as flax
  does (a bias fused into the product would be added before the one
  rounding).  flax ``nn.gelu`` is the tanh approximation; PyTorch's fused
  ``F.gelu`` rounds once where XLA rounds each op, which the bf16 logits'
  tolerance absorbs (``tests/test_torch_lm.py`` measures each rounding
  point's share of it).

Weights are stored in PyTorch's layouts (``Dense.weight`` is ``[out, in]``);
``petastorm_tpu_torch.convert`` maps flax parameter trees onto them.

Decoding keeps its cache as explicit state: :meth:`TransformerLM.init_cache`
makes one :class:`KVCache` per layer, and a forward given ``cache=``
writes the new keys and values into it in place.  A multi-token call on a
fresh cache (its host ``index`` 0) is the prefill; every later call, one
token or a chunk, writes and masks at the cache's device ``position``, so
that it can be captured in a CUDA graph and replayed
(``models.decoding``).  Choosing between the two (``lax.cond`` in the JAX
package) reads the host index and costs no device sync.
:func:`rewind_cache` rolls the device position back (speculative
decoding's rollback) and :func:`reorder_cache` re-orders the cache's rows
(beam search), both in place.  Ring and Ulysses attention
(:func:`make_attn_fn` with a mesh) run over ``parallel/``.

Tensor parallelism: :func:`param_shardings` gives the JAX package's
Megatron specs (:func:`megatron_spec_fn`) for each parameter, stated on
the flax leaf ``convert`` carries it from, and
:func:`petastorm_tpu_torch.parallel.place` puts the model on a mesh with
them.  A placed ``Dense`` is column-parallel (its input through
``collectives.copy_to``, its outputs this rank's) or row-parallel (its
partial product summed over the model axis by ``collectives.reduce_from``,
the bias added once after), ``Attention`` runs on this rank's heads (the
flash kernels on local blocks), and ``Embed`` looks up this rank's
vocabulary rows, masks the rest and sums over the axis; its ``attend``
gathers the logits.  Unplaced, every module runs as above.
"""

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.ops import flash_attention
from petastorm_tpu_torch.ops.flash_attention import NEG_INF, full_attention
from petastorm_tpu_torch.parallel.collectives import copy_to, gather_from, reduce_from

__all__ = ['Dense', 'RMSNorm', 'Attention', 'Block', 'Embed', 'KVCache', 'TransformerLM',
           'lecun_normal_', 'rope', 'rope_cos_sin', 'make_attn_fn', 'rewind_cache',
           'reorder_cache', 'param_shardings', 'megatron_spec_fn']


def lecun_normal_(tensor, fan_in, generator=None):
    """flax's default kernel init: truncated normal (2 std) with variance
    ``1 / fan_in``."""
    # 0.8796... is the std of a unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std, generator=generator)


def rope_cos_sin(positions, head_dim, base=10000.0):
    """RoPE tables for ``positions`` ``[b, s]``: fp32 cos and sin, each
    ``[b, s, 1, head_dim / 2]``, computed once for q and k."""
    if head_dim % 2:
        raise ValueError('RoPE needs an even head_dim, got %d' % head_dim)
    half = head_dim // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device)
                     / half)
    angles = positions[:, :, None].float() * freqs            # [b, s, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rope(x, positions=None, base=10000.0, cos_sin=None):
    """Rotary position embedding, GPT-NeoX split halves, on ``x``
    ``[batch, seq, heads, head_dim]`` at ``positions`` ``[batch, seq]`` (or
    a precomputed ``cos_sin``); returns x's dtype."""
    if cos_sin is None:
        cos_sin = rope_cos_sin(positions, x.shape[-1], base)
    cos, sin = cos_sin
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class Dense(nn.Module):
    """``y = x W^T + b`` computed in ``compute_dtype`` from fp32 parameters.

    ``tp`` (set by ``parallel.place``) is ``None``, ``('column', axis)``
    (this rank's output features) or ``('row', axis)`` (this rank's input
    features; the partial products, of ``compute_dtype`` values in fp32, are
    summed over ``axis`` and rounded to ``compute_dtype`` once)."""

    def __init__(self, in_features, out_features, compute_dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.tp = None
        lecun_normal_(self.weight, in_features, generator)

    def forward(self, x):
        dt = self.compute_dtype
        kind, axis = self.tp or (None, None)
        if kind == 'column':
            x = copy_to(x, axis)
        if kind == 'row':
            # the partial products of dt values summed in fp32 over the axis,
            # then rounded once, as the whole product is
            y = reduce_from(F.linear(x.to(dt).float(), self.weight.to(dt).float()), axis).to(dt)
        else:
            # the product rounds to dt before the bias is added, as in flax (a
            # fused bias would add it before the one rounding)
            y = F.linear(x.to(dt), self.weight.to(dt))
        return y + self.bias.to(dt)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        # x * rsqrt(...) promotes to fp32, rounds back to x's dtype, and the
        # fp32 scale promotes the result to fp32 again (flax's numbers).
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


class Embed(nn.Module):
    """flax ``nn.Embed(num_embeddings, features, dtype=compute_dtype)``: an
    fp32 table initialised ``N(0, 1 / features)``.

    ``tp`` (set by ``parallel.place``) is ``None`` or ``(axis, first row)``:
    the table holds this rank's rows of the vocabulary."""

    def __init__(self, num_embeddings, features, compute_dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.tp = None
        with torch.no_grad():
            self.embedding.normal_(0.0, features ** -0.5, generator=generator)

    def forward(self, ids):
        table = self.embedding.to(self.compute_dtype)
        if self.tp is None:
            return F.embedding(ids, table)
        axis, first = self.tp
        rows = table.shape[0]
        local = ids - first
        outside = (local < 0) | (local >= rows)
        found = F.embedding(local.clamp(0, rows - 1), table).masked_fill(outside[..., None], 0)
        return reduce_from(found, axis)

    def attend(self, x):
        """``x @ table^T`` in ``compute_dtype``."""
        dt = self.compute_dtype
        if self.tp is None:
            return F.linear(x.to(dt), self.embedding.to(dt))
        axis = self.tp[0]
        return gather_from(F.linear(copy_to(x, axis).to(dt), self.embedding.to(dt)), axis, -1)


class KVCache(object):
    """One layer's decode cache: ``key`` and ``value`` buffers ``[batch,
    max_len, kv_heads, head_dim]``, ``position``, the next position to
    write (an int64 tensor of one element on the device), and ``index``,
    the host's count of it.  Forward passes given the cache update both in
    place.  Writes go to ``position``; ``index`` tells a fresh cache (0)
    from a warm one and bounds each write to the buffer.  A replayed
    capture advances ``position`` at every replay and ``index`` only once,
    at capture, and :func:`rewind_cache` moves ``position`` alone: a caller
    that replays or rewinds keeps ``index`` in step itself where it needs
    the bound (the decoding functions check their whole length up front,
    as the JAX package's do)."""

    def __init__(self, batch, max_len, kv_heads, head_dim, dtype, device):
        self.key = torch.zeros(batch, max_len, kv_heads, head_dim, dtype=dtype, device=device)
        self.value = torch.zeros_like(self.key)
        self.index = 0
        self.position = torch.zeros(1, dtype=torch.int64, device=device)


class Attention(nn.Module):
    """Self-attention: projections to q, k, v ``[batch, seq, heads,
    head_dim]``, ``attn_fn`` over them, and an output projection.

    ``num_kv_heads=None`` is multi-head attention with a fused ``qkv``
    projection; a divisor of ``num_heads`` is grouped-query attention with
    separate ``q`` and ``kv`` projections (k and v are repeated to the
    query heads before ``attn_fn``; the cache keeps ``num_kv_heads``).
    ``pos_mode='rope'`` rotates q and k by ``positions`` before attention.

    Placed by ``parallel.place`` over a model axis, it runs
    ``local_heads`` query heads and ``local_kv_heads`` kv heads; where the
    axis cannot split the kv heads (MQA) every rank computes all of them,
    keeps those its query heads read (``kv_select``: the axis, the first
    and the count) and sums their gradient over the axis.
    """

    def __init__(self, d_model, num_heads, compute_dtype=torch.bfloat16,
                 attn_fn=flash_attention, causal=True, generator=None, *,
                 num_kv_heads=None, pos_mode=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError('d_model %d not divisible by %d heads' % (d_model, num_heads))
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError('num_heads %d not divisible by num_kv_heads %d'
                             % (num_heads, num_kv_heads))
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.num_kv_heads = num_kv_heads
        self.local_heads = num_heads
        self.local_kv_heads = num_kv_heads or num_heads
        self.kv_select = None
        self.attn_fn = attn_fn
        self.causal = causal
        self.pos_mode = pos_mode
        if num_kv_heads is None:
            # flax DenseGeneral((3, heads, head_dim)): the 3*d_model outputs
            # are ordered (qkv, head, head_dim).
            self.qkv = Dense(d_model, 3 * d_model, compute_dtype, generator)
        else:
            self.q = Dense(d_model, d_model, compute_dtype, generator)
            # flax DenseGeneral((2, kv_heads, head_dim))
            self.kv = Dense(d_model, 2 * num_kv_heads * self.head_dim, compute_dtype, generator)
        # flax DenseGeneral(d_model, axis=(-2, -1)) over (heads, head_dim).
        self.out = Dense(d_model, d_model, compute_dtype, generator)

    def forward(self, x, positions=None, cache=None, attn_fn=None):
        """``cache`` (a :class:`KVCache`) switches to decoding;
        ``attn_fn`` overrides the module's for this call."""
        b, s, _ = x.shape
        hd = self.head_dim
        if self.num_kv_heads is None:
            q, k, v = self.qkv(x).view(b, s, 3, self.local_heads, hd).unbind(dim=2)
        else:
            q = self.q(x).view(b, s, self.local_heads, hd)
            kv = self.kv(x)
            if self.kv_select is None:
                k, v = kv.view(b, s, 2, self.local_kv_heads, hd).unbind(dim=2)
            else:
                axis, first, count = self.kv_select
                k, v = copy_to(kv, axis).view(b, s, 2, self.num_kv_heads, hd).narrow(
                    3, first, count).unbind(dim=2)
        if self.pos_mode == 'rope':
            if positions is None:
                if cache is not None:
                    # arange(seq) would rotate every one-token step at
                    # position 0: demand real positions.
                    raise ValueError('decode mode with RoPE requires explicit positions')
                positions = torch.arange(s, device=x.device).expand(b, s)
            cs = rope_cos_sin(positions, hd)
            q, k = rope(q, cos_sin=cs), rope(k, cos_sin=cs)
        attn_fn = attn_fn or self.attn_fn
        if cache is not None:
            out = self._decode_step(q, k, v, cache, attn_fn)
        else:
            k, v = self._expand_kv(k, v)
            out = attn_fn(q, k, v, causal=self.causal)
        return self.out(out.reshape(b, s, -1))

    def _expand_kv(self, k, v):
        """Repeat KV heads to the query head count (a no-op for MHA)."""
        if k.shape[2] == self.local_heads:
            return k, v
        g = self.local_heads // k.shape[2]
        return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)

    def _decode_step(self, q, k, v, cache, attn_fn):
        """Attention against the static KV cache, written in place.

        A multi-token call on a fresh cache (index 0) is a prefill: causal
        ``attn_fn`` over the prompt alone.  Every other call, a one-token
        step or a chunk on a warm cache, writes at the device positions
        ``position + arange(seq)`` (``index_copy_``) and attends the whole
        buffer masked by them (:meth:`_attend_cache`): no host integer
        reaches the device, so the call can be captured and replayed at a
        position that moves (speculative decoding verifies its chunk where
        the last round's rollback left it).
        """
        seq = q.shape[1]
        i = cache.index
        if i + seq > cache.key.shape[1]:
            raise ValueError('cache holds %d positions; writing %d at %d'
                             % (cache.key.shape[1], seq, i))
        cache.index = i + seq
        if i == 0 and seq > 1:
            cache.key[:, :seq] = k.to(cache.key.dtype)
            cache.value[:, :seq] = v.to(cache.value.dtype)
            cache.position.fill_(seq)
            k, v = self._expand_kv(k, v)
            return attn_fn(q, k, v, causal=True)
        q_pos = cache.position + torch.arange(seq, device=q.device)
        cache.key.index_copy_(1, q_pos, k.to(cache.key.dtype))
        cache.value.index_copy_(1, q_pos, v.to(cache.value.dtype))
        cache.position.add_(seq)
        return self._attend_cache(q, cache.key, cache.value, q_pos)

    @staticmethod
    def _attend_cache(q, ck, cv, q_pos):
        """Attend the cache buffer at absolute query positions ``q_pos``,
        grouped against the unexpanded KV heads, in fp32."""
        b, seq, h, hd = q.shape
        max_len, h_kv = ck.shape[1], ck.shape[2]
        q_g = q.float().reshape(b, seq, h_kv, h // h_kv, hd)
        scores = torch.einsum('bqkgd,blkd->bkgql', q_g, ck.float()) * hd ** -0.5
        mask = torch.arange(max_len, device=q.device)[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum('bkgql,blkd->bqkgd', probs, cv.float())
        return out.reshape(b, seq, h, hd).to(q.dtype)


class Block(nn.Module):
    """Pre-norm transformer block: ``x + attn(ln1(x))``, then
    ``x + ffw_out(gelu(ffw_in(ln2(x))))``."""

    def __init__(self, d_model, num_heads, d_ff, compute_dtype=torch.bfloat16,
                 attn_fn=flash_attention, causal=True, generator=None, *,
                 num_kv_heads=None, pos_mode=None):
        super().__init__()
        self.ln1 = RMSNorm(d_model)
        self.attn = Attention(d_model, num_heads, compute_dtype, attn_fn, causal, generator,
                              num_kv_heads=num_kv_heads, pos_mode=pos_mode)
        self.ln2 = RMSNorm(d_model)
        self.ffw_in = Dense(d_model, d_ff, compute_dtype, generator)
        self.ffw_out = Dense(d_ff, d_model, compute_dtype, generator)

    def forward(self, x, positions=None, cache=None, attn_fn=None):
        x = x + self.attn(self.ln1(x), positions, cache, attn_fn)
        h = F.gelu(self.ffw_in(self.ln2(x)), approximate='tanh')
        return x + self.ffw_out(h)


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens ``[batch, seq]`` -> fp32 logits ``[batch,
    seq, vocab]``, with a tied output head.

    ``pos_embed`` is ``'learned'`` (a table of ``max_seq_len`` rows added to
    the token embedding) or ``'rope'``; ``num_kv_heads`` selects
    grouped-query attention; ``remat=True`` recomputes each block in the
    backward pass (``torch.utils.checkpoint``, non-reentrant), which runs
    its attention forward twice.  ``generator`` seeds the initial weights.
    """

    def __init__(self, vocab_size, d_model=512, num_heads=8, num_layers=6, d_ff=2048,
                 max_seq_len=2048, compute_dtype=torch.bfloat16, attn_fn=flash_attention,
                 remat=False, num_kv_heads=None, pos_embed='learned', generator=None):
        super().__init__()
        if pos_embed not in ('learned', 'rope'):
            raise ValueError("pos_embed must be 'learned' or 'rope', got %r" % (pos_embed,))
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.pos_mode = pos_embed
        self.embed = Embed(vocab_size, d_model, compute_dtype, generator)
        if pos_embed == 'learned':
            self.pos_embed = Embed(max_seq_len, d_model, compute_dtype, generator)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, d_ff, compute_dtype, attn_fn, True, generator,
                  num_kv_heads=num_kv_heads,
                  pos_mode='rope' if pos_embed == 'rope' else None)
            for _ in range(num_layers))
        self.ln_f = RMSNorm(d_model)

    def init_cache(self, batch, device=None):
        """A fresh decode cache, one :class:`KVCache` per layer, of
        ``max_seq_len`` positions in ``compute_dtype``, holding this rank's
        kv heads."""
        device = device if device is not None else self.embed.embedding.device
        attn = self.blocks[0].attn
        return [KVCache(batch, self.max_seq_len, attn.local_kv_heads, attn.head_dim,
                        self.compute_dtype, device) for _ in self.blocks]

    def forward(self, tokens, positions=None, cache=None, attn_fn=None):
        """``positions`` ``[batch, seq]`` overrides the row-absolute
        ``arange`` (packed documents pass theirs, restarting at 0);
        ``cache`` (from :meth:`init_cache`) decodes; ``attn_fn`` overrides
        the blocks' attention for this call (e.g. one bound to a packed
        batch's segment ids)."""
        x = self.embed(tokens)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        if self.pos_mode == 'learned':
            x = x + self.pos_embed(positions)
        for i, block in enumerate(self.blocks):
            layer_cache = None if cache is None else cache[i]
            if self.remat and layer_cache is None and torch.is_grad_enabled():
                # No RNG state to stash: the blocks draw no random numbers,
                # and a stash would read the card's generator state inside
                # the CUDA-graph capture of the train step.
                x = checkpoint(block, x, positions, None, attn_fn, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, positions, layer_cache, attn_fn)
        x = self.ln_f(x)
        return self.embed.attend(x).float()


def rewind_cache(cache, position):
    """Roll every layer of ``cache`` (a list of :class:`KVCache`) back to
    ``position``, a one-element int64 tensor on the cache's device, copied
    in place so that a captured step can roll back to a position it
    computed: the counterpart of the JAX package's
    ``decoding._set_cache_index``.  The entries at and past it stay, stale:
    attention masks them by position and later writes overwrite them.
    ``index`` is left as it is (see :class:`KVCache`)."""
    for layer in cache:
        layer.position.copy_(position)


def reorder_cache(cache, rows):
    """Re-order every layer's key and value rows (the batch axis) by
    ``rows``, an int64 tensor on the cache's device, in place: the buffers
    stay the same tensors, so that a captured step keeps its static
    buffers (beam search follows each surviving beam's parent)."""
    for layer in cache:
        layer.key.copy_(layer.key.index_select(0, rows))
        layer.value.copy_(layer.value.index_select(0, rows))


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _spec_for(path, model_axis):
    """The Megatron spec of the flax leaf at ``path`` (a tuple of flax
    keys), in flax axes: the JAX package's rule, leaf by leaf."""
    names = list(path)
    leaf = names[-1] if names else ''
    parent = names[-2] if len(names) > 1 else ''
    if parent in ('embed', 'pos_embed'):
        return (model_axis, None)               # vocab/position sharded
    if parent == 'qkv':
        # kernel [d_model, 3, heads, head_dim]: shard heads
        return (None, None, model_axis, None) if leaf == 'kernel' \
            else (None, model_axis, None)       # bias [3, heads, head_dim]
    if parent == 'q':
        # GQA query proj: kernel [d_model, heads, head_dim]
        return (None, model_axis, None) if leaf == 'kernel' else (model_axis, None)
    if parent == 'kv':
        # GQA kv proj: kernel [d_model, 2, kv_heads, head_dim]; param_shardings
        # falls back to replication where the axis does not divide kv_heads
        return (None, None, model_axis, None) if leaf == 'kernel' \
            else (None, model_axis, None)
    if parent == 'out':
        # kernel [heads, head_dim, d_model]: shard input heads
        return (model_axis, None, None) if leaf == 'kernel' else (None,)
    if parent == 'ffw_in':
        return (None, model_axis) if leaf == 'kernel' else (model_axis,)
    if parent == 'ffw_out':
        return (model_axis, None) if leaf == 'kernel' else (None,)
    return ()                                   # norms & everything else: replicated


def megatron_spec_fn(model_axis='model'):
    """The Megatron rules as a ``path -> spec`` callable (``path``: a tuple
    of flax keys): the ``base_spec_fn`` of
    :func:`petastorm_tpu_torch.parallel.fsdp_shardings` (FSDP x TP)."""
    return functools.partial(_spec_for, model_axis=model_axis)


def param_shardings(model, mesh, model_axis='model'):
    """``{parameter name: NamedSharding}`` for a port ``TransformerLM`` (or
    ``ViT``, whose blocks are the same) over ``mesh``: each parameter gets
    the JAX package's spec for the flax leaf ``convert`` carries it from,
    and a leaf whose dim the axis cannot divide (MQA's ``kv_heads=1``, an
    odd vocabulary) is replicated.  Place them with
    :func:`petastorm_tpu_torch.parallel.place`."""
    from petastorm_tpu_torch.convert import flax_leaves
    from petastorm_tpu_torch.parallel.mesh import NamedSharding, axis_size
    leaves = flax_leaves(model)
    if model_axis not in mesh.mesh_dim_names:
        return {name: NamedSharding(mesh, ()) for name in leaves}
    size = axis_size(mesh, model_axis)
    out = {}
    for name, leaf in leaves.items():
        spec = _spec_for(leaf.path, model_axis)
        if any(axis == model_axis and dim % size for dim, axis in zip(leaf.shape, spec)):
            spec = ()
        out[name] = NamedSharding(mesh, spec)
    return out


def make_attn_fn(mesh=None, strategy='flash', seq_axis='seq', batch_axis='data',
                 head_axis='model', block_k=None, segment_ids=None, causal=True):
    """The attention for a (mesh, strategy) pair: the JAX package's
    ``make_attn_fn``.

    ``'flash'`` (the hand-written kernels) and ``'dense'`` (the O(seq^2)
    reference) need no mesh.  ``'ring'`` rotates K/V around ``seq_axis``
    (``block_k`` chunks each hop's score tile) and ``'ulysses'`` trades the
    sequence for heads with all-to-alls and runs the flash kernels locally
    (:mod:`petastorm_tpu_torch.parallel.ring_attention`); both need a
    ``mesh`` and take this rank's blocks ``[batch, seq_local, heads,
    head_dim]``.  ``segment_ids`` (``[batch, seq]``, or this rank's
    ``[batch, seq_local]`` under ring and Ulysses; 0 = padding) restricts
    attention to packed-row segments under every strategy.  ``causal`` is
    fixed here for ring and Ulysses, and a call asking for the other
    masking raises.
    """
    from petastorm_tpu_torch.parallel import make_ring_attention, make_ulysses_attention
    packed = segment_ids is not None
    if strategy == 'flash':
        return (functools.partial(flash_attention, segment_ids=segment_ids)
                if packed else flash_attention)
    if strategy == 'dense':
        return (functools.partial(full_attention, segment_ids=segment_ids)
                if packed else full_attention)
    if mesh is None:
        raise ValueError('strategy %r needs a mesh' % (strategy,))
    if strategy == 'ring':
        fn, _ = make_ring_attention(mesh, seq_axis=seq_axis, batch_axis=batch_axis,
                                    head_axis=head_axis, causal=causal, block_k=block_k,
                                    packed=packed)
    elif strategy == 'ulysses':
        fn, _ = make_ulysses_attention(mesh, seq_axis=seq_axis, batch_axis=batch_axis,
                                       head_axis=head_axis, causal=causal,
                                       attn_fn=flash_attention, packed=packed)
    else:
        raise ValueError('unknown attention strategy %r' % (strategy,))
    return functools.partial(_check_curried_causal, fn, segment_ids, causal)


def _check_curried_causal(fn, segment_ids, curried_causal, q, k, v, causal=True):
    # ring and Ulysses fix causal at construction; a caller asking for other
    # masking (an encoder calling a causal-curried wrapper) must hear of it
    if causal != curried_causal:
        raise ValueError(
            'attn_fn was built with causal=%s but called with causal=%s - '
            'pass causal=%s to make_attn_fn' % (curried_causal, causal, causal))
    if segment_ids is not None:
        return fn(q, k, v, segment_ids)
    return fn(q, k, v)

"""Transformer building blocks: ``RMSNorm``, ``Attention`` (multi-head, no
decode cache) and ``Block``.

Counterpart of ``petastorm_tpu/models/transformer.py`` as ``nn.Module``s.
The numbers follow the flax modules at every dtype boundary:

* Parameters are fp32.  A ``Dense`` with ``compute_dtype=bf16`` casts its
  input, weight and bias to bf16 and multiplies in bf16 (flax
  ``Dense(dtype=bf16)``); the cast is explicit, never autocast.
* ``RMSNorm`` returns ``(x * rsqrt(var + eps)).astype(x.dtype) * scale``
  with an fp32 ``scale``: a bf16 input gives an fp32 output, as under
  JAX's type promotion.
* flax ``nn.gelu`` is the tanh approximation.

Weights are stored in PyTorch's layouts (``Dense.weight`` is ``[out, in]``);
``petastorm_tpu_torch.convert`` maps flax parameter trees onto them.
Grouped-query attention, RoPE, the decode cache and ``TransformerLM`` are a
later slice of the port.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.ops import flash_attention

__all__ = ['Dense', 'RMSNorm', 'Attention', 'Block', 'lecun_normal_']


def lecun_normal_(tensor, fan_in, generator=None):
    """flax's default kernel init: truncated normal (2 std) with variance
    ``1 / fan_in``."""
    # 0.8796... is the std of a unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """``y = x W^T + b`` computed in ``compute_dtype`` from fp32 parameters."""

    def __init__(self, in_features, out_features, compute_dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.weight, in_features, generator)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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


class Attention(nn.Module):
    """Multi-head self-attention: a fused qkv projection, ``attn_fn`` over
    ``[batch, seq, heads, head_dim]``, and an output projection."""

    def __init__(self, d_model, num_heads, compute_dtype=torch.bfloat16,
                 attn_fn=flash_attention, causal=True, generator=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError('d_model %d not divisible by %d heads' % (d_model, num_heads))
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.attn_fn = attn_fn
        self.causal = causal
        # flax DenseGeneral((3, heads, head_dim)): the 3*d_model outputs are
        # ordered (qkv, head, head_dim).
        self.qkv = Dense(d_model, 3 * d_model, compute_dtype, generator)
        # flax DenseGeneral(d_model, axis=(-2, -1)) over (heads, head_dim).
        self.out = Dense(d_model, d_model, compute_dtype, generator)

    def forward(self, x):
        b, s, d_model = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)        # each [b, s, h, hd]
        out = self.attn_fn(q, k, v, causal=self.causal)
        return self.out(out.reshape(b, s, d_model))


class Block(nn.Module):
    """Pre-norm transformer block: ``x + attn(ln1(x))``, then
    ``x + ffw_out(gelu(ffw_in(ln2(x))))``."""

    def __init__(self, d_model, num_heads, d_ff, compute_dtype=torch.bfloat16,
                 attn_fn=flash_attention, causal=True, generator=None):
        super().__init__()
        self.ln1 = RMSNorm(d_model)
        self.attn = Attention(d_model, num_heads, compute_dtype, attn_fn, causal, generator)
        self.ln2 = RMSNorm(d_model)
        self.ffw_in = Dense(d_model, d_ff, compute_dtype, generator)
        self.ffw_out = Dense(d_ff, d_model, compute_dtype, generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.ffw_in(self.ln2(x)), approximate='tanh')
        return x + self.ffw_out(h)

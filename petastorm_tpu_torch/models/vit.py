"""Vision Transformer (ViT-S/16 by default) over NHWC images.

Counterpart of ``petastorm_tpu/models/vit.py`` as an ``nn.Module``: a
stride-``patch`` convolution embeds patches, learned position embeddings
are added, ``num_layers`` encoder ``Block``s run with ``causal=False``
attention (the flash kernels by default), a final ``RMSNorm``, mean or
class-token pooling, and an fp32 ``head``.  Everything up to ``ln_f`` runs
in ``compute_dtype`` (bf16 by default) from fp32 parameters.

``remat=True`` (flax ``nn.remat(Block)``) recomputes each block in the
backward pass instead of keeping its activations: less device memory for a
second forward through each block, its attention included.

The blocks are ``models.transformer``'s, so its tensor-parallel rules
apply unchanged: ``param_shardings`` and ``megatron_spec_fn`` are
re-exported here, as the JAX package's ``models/vit.py`` does.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.models.transformer import (Block, Dense, RMSNorm, lecun_normal_,
                                                    megatron_spec_fn, param_shardings)
from petastorm_tpu_torch.ops import flash_attention

__all__ = ['ViT', 'param_shardings', 'megatron_spec_fn']


class ViT(nn.Module):
    """images ``[batch, H, W, C]`` -> logits ``[batch, num_classes]`` (fp32).

    ``image_hw`` fixes the patch grid (and so the position table's length).
    ``remat=True`` runs each block under ``torch.utils.checkpoint`` when
    gradients are on.  ``generator`` seeds the initial weights.
    """

    def __init__(self, num_classes, image_hw=(224, 224), channels=3, patch_size=16,
                 d_model=384, num_heads=6, num_layers=12, d_ff=1536,
                 compute_dtype=torch.bfloat16, attn_fn=flash_attention, pool='mean',
                 remat=False, generator=None):
        super().__init__()
        h, w = image_hw
        if h % patch_size or w % patch_size:
            raise ValueError('image %dx%d not divisible by patch_size %d'
                             % (h, w, patch_size))
        if pool not in ('mean', 'cls'):
            raise ValueError("pool must be 'mean' or 'cls', got %r" % (pool,))
        self.image_hw = (h, w)
        self.patch_size = patch_size
        self.d_model = d_model
        self.compute_dtype = compute_dtype
        self.pool = pool
        self.remat = remat
        self.patch_embed = nn.Conv2d(channels, d_model, patch_size, stride=patch_size)
        lecun_normal_(self.patch_embed.weight, channels * patch_size * patch_size, generator)
        with torch.no_grad():
            self.patch_embed.bias.zero_()
        n = (h // patch_size) * (w // patch_size)
        if pool == 'cls':
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
            n += 1
        self.pos_embed = nn.Parameter(torch.empty(1, n, d_model))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, d_ff, compute_dtype, attn_fn, causal=False,
                  generator=generator)
            for _ in range(num_layers))
        self.ln_f = RMSNorm(d_model)
        self.head = Dense(d_model, num_classes, torch.float32, generator)

    def forward(self, images):
        if images.dim() != 4:
            raise ValueError('expected [batch, H, W, C], got %r' % (tuple(images.shape),))
        if tuple(images.shape[1:3]) != self.image_hw:
            raise ValueError('image %r does not match the model\'s image_hw %r'
                             % (tuple(images.shape[1:3]), self.image_hw))
        dt = self.compute_dtype
        x = images.to(dt).permute(0, 3, 1, 2)                       # NCHW for conv2d
        # flax Conv(padding='SAME') at stride == kernel == patch pads nothing.
        x = F.conv2d(x, self.patch_embed.weight.to(dt), self.patch_embed.bias.to(dt),
                     stride=self.patch_size)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                             # [b, n_patches, d]
        if self.pool == 'cls':
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, self.d_model), x], dim=1)
        x = x + self.pos_embed.to(dt)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                # no RNG state to stash, as in TransformerLM: the blocks draw
                # no random numbers, and a stash would read the card's
                # generator state inside the CUDA-graph capture of the step
                x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        x = x[:, 0] if self.pool == 'cls' else x.mean(dim=1)
        return self.head(x.float())

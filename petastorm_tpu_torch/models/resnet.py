"""ResNet-50 over NHWC images, in flax's numerics.

Counterpart of ``petastorm_tpu/models/resnet.py`` (``BottleneckBlock``,
``ResNet50``) as ``nn.Module``s.  Inside, activations are NCHW tensors in
``channels_last`` memory: the permute of the NHWC batch already is that
layout.  Where flax and PyTorch differ, the port follows flax:

* **'SAME' padding** is XLA's: ``total = max((ceil(in / s) - 1) * s + k - in,
  0)``, ``total // 2`` before and the rest after.  A 3x3 stride-2 conv on an
  even input pads (0, 1), which torch's symmetric ``padding=1`` does not
  reproduce (same shape, other numbers).
* **BatchNorm** (momentum 0.9, epsilon 1e-5) normalizes in fp32 with the
  batch's statistics over (N, H, W) computed as flax computes them
  (``use_fast_variance``): ``E[x]`` and ``max(0, E[x^2] - E[x]^2)``, the
  *biased* variance.  It returns the compute dtype and writes
  ``0.9 ra + 0.1 stat`` into the running statistics (``nn.BatchNorm2d``
  writes the unbiased variance).  Eval mode normalizes with the running
  statistics.  Under data parallelism (:func:`sync_batch_norm`) the
  statistics are those of the global batch, as flax's under ``jax.jit``
  over a global array: fp32 sums of x and x^2 summed over the data axis in
  one differentiable all-reduce of 2C floats per BatchNorm (its backward
  sums the cotangents, since every rank's loss reads every rank's
  activations through them), and the running statistics, updated from
  them, stay equal on every rank.
* Convolutions have no bias and cast their fp32 weights to the compute
  dtype with their input; the head averages over H and W (fp32
  accumulation, result in the compute dtype) and is an fp32 ``Dense``.

Weights come from an explicit ``torch.Generator``: conv kernels and the
head lecun normal (flax's default), BN scales ones and biases zeros, and
the last BN of each block starts with a zero scale.
``petastorm_tpu_torch.convert.resnet_params_from_flax`` carries flax
parameters and batch statistics across.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.transformer import Dense, lecun_normal_
from petastorm_tpu_torch.parallel.collectives import all_reduce

__all__ = ['same_padding', 'Conv', 'BatchNorm', 'BottleneckBlock', 'ResNet50',
           'sync_batch_norm']

#: (filters, blocks) of the four stages.
STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))
#: The BatchNorms' momentum and epsilon, fixed by the flax model.
MOMENTUM = 0.9
EPS = 1e-5


def same_padding(size, kernel, stride):
    """XLA's 'SAME' padding of one spatial axis: ``(before, after)``."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free 2D convolution in ``dtype`` from an fp32 OIHW weight.

    ``padding`` is ``'SAME'`` or explicit ``((top, bottom), (left, right))``.
    """

    def __init__(self, in_channels, out_channels, kernel, stride=1, padding='SAME',
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        lecun_normal_(self.weight, in_channels * kernel * kernel, generator)

    def forward(self, x):
        if self.padding == 'SAME':
            pads = [same_padding(size, self.kernel, self.stride) for size in x.shape[2:]]
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        weight = self.weight.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), weight, None, self.stride, padding)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over NCHW.

    ``stats_axis`` (:func:`sync_batch_norm`): the data axis whose ranks'
    rows make up the batch the statistics are taken over; ``None``, this
    rank's rows."""

    def __init__(self, features, dtype=torch.bfloat16, zero_scale=False):
        super().__init__()
        self.dtype = dtype
        self.stats_axis = None
        self.scale = nn.Parameter(torch.zeros(features) if zero_scale else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        xf = x.float()
        if self.training:
            # flax's _compute_stats (use_fast_variance): fp32 E[x] and
            # max(0, E[x^2] - E[x]^2) over (N, H, W), the biased variance.
            axis = self.stats_axis
            if axis is None:
                mean = xf.mean(dim=(0, 2, 3))
                var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0.0)
            else:
                n = xf.shape[0] * xf.shape[2] * xf.shape[3] * axis.size
                sums = all_reduce(torch.stack([xf.sum(dim=(0, 2, 3)),
                                               xf.square().sum(dim=(0, 2, 3))]), axis)
                mean = sums[0] / n
                var = (sums[1] / n - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
                self.running_var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + EPS) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride ``strides``) -> 1x1 (``4 * filters``), a BN after
    each, and a projected (1x1 conv + BN) or identity shortcut."""

    def __init__(self, in_channels, filters, strides=1, projection=False,
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        out = 4 * filters
        self.conv0 = Conv(in_channels, filters, 1, dtype=dtype, generator=generator)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, strides, dtype=dtype, generator=generator)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, out, 1, dtype=dtype, generator=generator)
        self.bn2 = BatchNorm(out, dtype, zero_scale=True)
        self.projection = projection
        if projection:
            self.proj = Conv(in_channels, out, 1, strides, dtype=dtype, generator=generator)
            self.proj_bn = BatchNorm(out, dtype)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = self.proj_bn(self.proj(x)) if self.projection else x
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """images ``[batch, H, W, 3]`` -> logits ``[batch, num_classes]`` (fp32).

    ``dtype`` is the compute dtype (parameters and BN statistics stay
    fp32); ``generator`` seeds the initial weights.
    """

    def __init__(self, num_classes=1000, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(3, 64, 7, 2, ((3, 3), (3, 3)), dtype, generator)
        self.stem_bn = BatchNorm(64, dtype)
        blocks = []
        channels = 64
        for i, (filters, count) in enumerate(STAGES):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(channels, filters, strides, projection=(j == 0),
                                              dtype=dtype, generator=generator))
                channels = 4 * filters
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(channels, num_classes, torch.float32, generator)

    def forward(self, images):
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError('expected [batch, H, W, 3], got %r' % (tuple(images.shape),))
        x = images.to(self.dtype).permute(0, 3, 1, 2)      # NCHW, channels_last memory
        x = F.relu(self.stem_bn(self.stem(x)))
        x = F.max_pool2d(x, 3, 2, 1)                       # -inf padding, as flax's
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)).float())


def sync_batch_norm(model, axis):
    """Take every BatchNorm's statistics of ``model`` over the global batch
    split along ``axis`` (a data axis, :class:`~petastorm_tpu_torch.parallel.SeqAxis`);
    an axis of one rank (or ``None``) keeps the local statistics and issues
    no collective.  Returns ``model``."""
    stats_axis = axis if axis is not None and axis.size > 1 else None
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.stats_axis = stats_axis
    return model

"""Device-side image augmentation on NHWC batches.

Counterpart of ``petastorm_tpu/jax/augment.py`` (``normalize``,
``random_crop``, ``random_flip_left_right``).  Each random op is split in
two: an inner function that takes its offsets or mask (:func:`crop_at`,
:func:`flip_where`) and so is exactly comparable with the JAX op fed the
same draws, and a wrapper that draws them from a ``torch.Generator`` on the
images' device.  The loader's uint8 batches go in as they are; normalization
comes last and returns floats.
"""

import functools

import torch
import torch.nn.functional as F

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'normalize', 'crop_at', 'random_crop',
           'flip_where', 'random_flip_left_right']

#: ImageNet channel statistics in 0..255 scale.
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16):
    """Channel-wise ``(x - mean) / std`` in fp32, returned as ``dtype``;
    ``mean``/``std`` are in the input's scale (0..255 for uint8 batches)."""
    x = images if images.is_floating_point() else images.float()
    mean = _channel_constant(tuple(map(float, mean)), images.device)
    std = _channel_constant(tuple(map(float, std)), images.device)
    return ((x - mean) / std).to(dtype)


@functools.lru_cache(maxsize=None)
def _channel_constant(values, device):
    """``values`` as an fp32 tensor on ``device``, made once per device: a
    tensor built from host values each step is a copy from pageable memory,
    after which the host waits for the device."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def crop_at(images, tops, lefts, crop_hw, padding=0):
    """Crop ``images`` (NHWC) per sample at ``(tops[i], lefts[i])`` of the
    image zero-padded by ``padding`` on each spatial side.  Offsets are
    clamped into range, as ``jax.lax.dynamic_slice`` clamps them."""
    ch, cw = crop_hw
    if padding:
        images = F.pad(images, (0, 0, padding, padding, padding, padding))
    n, h, w, _ = images.shape
    if ch > h or cw > w:
        raise ValueError('crop %r larger than padded image %r' % (tuple(crop_hw), (h, w)))
    tops = tops.to(images.device).long().clamp(0, h - ch)
    lefts = lefts.to(images.device).long().clamp(0, w - cw)
    rows = tops[:, None] + torch.arange(ch, device=images.device)     # [n, ch]
    cols = lefts[:, None] + torch.arange(cw, device=images.device)    # [n, cw]
    batch = torch.arange(n, device=images.device)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def random_crop(images, crop_hw, padding=0, generator=None):
    """Per-sample uniform random crop after zero-padding by ``padding``."""
    ch, cw = crop_hw
    n, h, w, _ = images.shape
    h, w = h + 2 * padding, w + 2 * padding
    if ch > h or cw > w:
        raise ValueError('crop %r larger than padded image %r' % (tuple(crop_hw), (h, w)))
    tops = torch.randint(0, h - ch + 1, (n,), generator=generator, device=images.device)
    lefts = torch.randint(0, w - cw + 1, (n,), generator=generator, device=images.device)
    return crop_at(images, tops, lefts, crop_hw, padding)


def flip_where(images, mask):
    """Flip left-right the samples of ``images`` (NHWC) where ``mask``."""
    mask = mask.to(device=images.device, dtype=torch.bool)
    return torch.where(mask[:, None, None, None], images.flip(2), images)


def random_flip_left_right(images, prob=0.5, generator=None):
    """Per-sample horizontal flip with probability ``prob``."""
    mask = torch.rand(images.shape[0], generator=generator, device=images.device) < prob
    return flip_where(images, mask)

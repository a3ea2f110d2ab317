"""Device-side image augmentation on NHWC batches.

Counterpart of ``petastorm_tpu/jax/augment.py``: ``normalize``,
``center_crop``, ``random_crop``, ``random_flip_left_right``,
``random_brightness``, ``random_contrast``, ``random_saturation``,
``color_jitter``, ``random_cutout``, ``mixup``, ``cutmix`` and
``mixup_loss``.  Each random op is split in two: an inner function that
takes its draws (:func:`crop_at`, :func:`flip_where`,
:func:`adjust_brightness`, :func:`adjust_contrast`,
:func:`adjust_saturation`, :func:`cutout_at`, :func:`mixup_with`,
:func:`cutmix_with`) and so is exactly comparable with the JAX op fed the
same draws, and a wrapper that draws them from a ``torch.Generator`` on the
images' device.  The loader's uint8 batches go in as they are; the color
ops, mixup and cutmix return fp32 in the 0..255 scale, and normalization
comes last and returns floats.

Every draw comes from the caller's generator on the device, so that a
captured step that registers the generator (``graphs.StepGraph(...,
generators=[g])``) draws anew at each replay.  Two draws have no such
PyTorch call and are made from the generator's uniforms and normals
instead: a permutation is the ``argsort`` of float64 uniforms
(:func:`random_permutation`; ``torch.randperm`` cannot be captured), and
Beta(a, a) is ``X / (X + Y)`` of two Gamma(a) draws by Marsaglia and
Tsang's method, with a fixed number of candidates in place of its
rejection loop (:func:`sample_beta`; ``torch.distributions.Beta`` draws
through ``torch._standard_gamma``, which takes no generator).
"""

import functools
import math

import torch
import torch.nn.functional as F

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'normalize', 'center_crop', 'crop_at',
           'random_crop', 'flip_where', 'random_flip_left_right', 'adjust_brightness',
           'random_brightness', 'adjust_contrast', 'random_contrast', 'adjust_saturation',
           'random_saturation', 'color_jitter', 'cutout_at', 'random_cutout',
           'random_permutation', 'sample_beta', 'mixup_with', 'mixup', 'cutmix_with', 'cutmix',
           'mixup_loss']

#: ImageNet channel statistics in 0..255 scale.
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def _as_float(images):
    """uint8 -> fp32 in 0..255; float inputs pass through unchanged."""
    return images if images.is_floating_point() else images.float()


def normalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16):
    """Channel-wise ``(x - mean) / std`` in fp32, returned as ``dtype``;
    ``mean``/``std`` are in the input's scale (0..255 for uint8 batches)."""
    x = _as_float(images)
    mean = _channel_constant(tuple(map(float, mean)), images.device)
    std = _channel_constant(tuple(map(float, std)), images.device)
    return ((x - mean) / std).to(dtype)


@functools.lru_cache(maxsize=None)
def _channel_constant(values, device):
    """``values`` as an fp32 tensor on ``device``, made once per device: a
    tensor built from host values each step is a copy from pageable memory,
    after which the host waits for the device."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def center_crop(images, crop_hw):
    """Static center crop of NHWC ``images`` to ``crop_hw = (ch, cw)``."""
    ch, cw = crop_hw
    h, w = images.shape[1], images.shape[2]
    if ch > h or cw > w:
        raise ValueError('crop %r larger than image %r' % (tuple(crop_hw), (h, w)))
    top, left = (h - ch) // 2, (w - cw) // 2
    return images[:, top:top + ch, left:left + cw, :]


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


def _draws(n, block):
    """How many samples to draw for, and the slice of them ``images`` takes:
    ``block`` is ``(global batch, first row)`` when ``images`` is one
    rank's rows of a global batch (every rank draws for the whole batch, as
    the JAX package draws one value per image of its global array, and keeps
    its own)."""
    if block is None:
        return n, slice(0, n)
    total, first = block
    return total, slice(first, first + n)


def random_crop(images, crop_hw, padding=0, generator=None, block=None):
    """Per-sample uniform random crop after zero-padding by ``padding``;
    ``block`` as in :func:`_draws`."""
    ch, cw = crop_hw
    n, h, w, _ = images.shape
    h, w = h + 2 * padding, w + 2 * padding
    if ch > h or cw > w:
        raise ValueError('crop %r larger than padded image %r' % (tuple(crop_hw), (h, w)))
    total, rows = _draws(n, block)
    tops = torch.randint(0, h - ch + 1, (total,), generator=generator, device=images.device)
    lefts = torch.randint(0, w - cw + 1, (total,), generator=generator, device=images.device)
    return crop_at(images, tops[rows], lefts[rows], crop_hw, padding)


def flip_where(images, mask):
    """Flip left-right the samples of ``images`` (NHWC) where ``mask``."""
    mask = mask.to(device=images.device, dtype=torch.bool)
    return torch.where(mask[:, None, None, None], images.flip(2), images)


def random_flip_left_right(images, prob=0.5, generator=None, block=None):
    """Per-sample horizontal flip with probability ``prob``; ``block`` as in
    :func:`_draws`."""
    total, rows = _draws(images.shape[0], block)
    mask = torch.rand(total, generator=generator, device=images.device) < prob
    return flip_where(images, mask[rows])


def _per_sample(values, images):
    """Per-sample draws ``[n]`` as fp32 ``[n, 1, 1, 1]`` on the images' device."""
    return values.to(device=images.device, dtype=torch.float32).view(-1, 1, 1, 1)


def _uniform(n, low, high, generator, device):
    return torch.empty(n, device=device).uniform_(low, high, generator=generator)


def adjust_brightness(images, delta):
    """``clip(x + delta * 255, 0, 255)`` with ``delta[i]`` sample i's draw
    from ``U(-max_delta, max_delta)``; fp32."""
    return torch.clamp(_as_float(images) + _per_sample(delta, images) * 255.0, 0.0, 255.0)


def random_brightness(images, max_delta=0.125, generator=None):
    """Additive brightness jitter, ``delta ~ U(-max_delta, max_delta)`` per
    sample (in the 0..1 scale); fp32 in 0..255, clipped."""
    return adjust_brightness(images, _uniform(images.shape[0], -max_delta, max_delta,
                                              generator, images.device))


def adjust_contrast(images, factor):
    """``clip((x - mean) * factor + mean, 0, 255)`` per sample, with each
    sample's fp32 mean over its pixels and channels; fp32."""
    x = _as_float(images)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((x - mean) * _per_sample(factor, images) + mean, 0.0, 255.0)


def random_contrast(images, lower=0.8, upper=1.2, generator=None):
    """Per-sample contrast, ``factor ~ U(lower, upper)``."""
    return adjust_contrast(images, _uniform(images.shape[0], lower, upper, generator,
                                            images.device))


def adjust_saturation(images, factor):
    """Blend each sample with its Rec.601 grey image, ``clip(grey + (x -
    grey) * factor, 0, 255)``; fp32."""
    x = _as_float(images)
    grey = 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
    return torch.clamp(grey + (x - grey) * _per_sample(factor, images), 0.0, 255.0)


def random_saturation(images, lower=0.8, upper=1.2, generator=None):
    """Per-sample saturation, ``factor ~ U(lower, upper)``."""
    return adjust_saturation(images, _uniform(images.shape[0], lower, upper, generator,
                                              images.device))


def color_jitter(images, brightness=0.125, contrast=0.2, saturation=0.2, generator=None):
    """Brightness, then contrast, then saturation jitter, each per sample."""
    x = random_brightness(images, brightness, generator)
    x = random_contrast(x, 1.0 - contrast, 1.0 + contrast, generator)
    return random_saturation(x, 1.0 - saturation, 1.0 + saturation, generator)


def cutout_at(images, cy, cx, size, fill=0.0):
    """Fill one ``size x size`` square per sample, centred at ``(cy[i],
    cx[i])`` and clipped at the image's borders, with ``fill`` (in the
    images' dtype); the rest is unchanged."""
    n, h, w, _ = images.shape
    half = size // 2
    cy = cy.to(images.device).long().view(n, 1, 1)
    cx = cx.to(images.device).long().view(n, 1, 1)
    ys = torch.arange(h, device=images.device).view(1, h, 1)
    xs = torch.arange(w, device=images.device).view(1, 1, w)
    inside = ((ys >= cy - half) & (ys < cy + (size - half))
              & (xs >= cx - half) & (xs < cx + (size - half)))
    return images.masked_fill(inside[..., None], fill)


def random_cutout(images, size, fill=0.0, generator=None):
    """Cutout (DeVries and Taylor 2017): one random ``size x size`` square
    per sample, its centre uniform over the image."""
    n, h, w, _ = images.shape
    cy = torch.randint(0, h, (n,), generator=generator, device=images.device)
    cx = torch.randint(0, w, (n,), generator=generator, device=images.device)
    return cutout_at(images, cy, cx, size, fill)


def random_permutation(n, generator=None, device=None):
    """A uniform permutation of ``0..n-1`` (int64) drawn on ``device``: the
    stable ``argsort`` of ``n`` float64 uniforms from ``generator``."""
    u = torch.rand(n, generator=generator, device=device, dtype=torch.float64)
    return torch.argsort(u, stable=True)


#: Marsaglia and Tsang's candidates per Gamma draw.  Each is accepted with
#: probability at least 0.95 for the shapes used (a + 1 >= 1), so all of
#: them fail with probability below 0.05 ** 16 (2e-21); the first is then
#: taken.
GAMMA_CANDIDATES = 16


def _log_gamma_sample(alpha, shape, generator, device):
    """``log`` of Gamma(alpha, 1) draws of ``shape`` (float64): Marsaglia and
    Tsang (2000) at shape ``alpha + 1`` over :data:`GAMMA_CANDIDATES`
    candidates, the first accepted kept, times ``U ** (1 / alpha)`` (their
    boost, which brings Gamma(alpha + 1) to Gamma(alpha) for any alpha)."""
    d = alpha + 1.0 - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    cand = (GAMMA_CANDIDATES,) + tuple(shape)
    z = torch.randn(cand, generator=generator, device=device, dtype=torch.float64)
    u = torch.rand(cand, generator=generator, device=device, dtype=torch.float64)
    v = (1.0 + c * z) ** 3
    log_v = torch.log(torch.clamp_min(v, 1e-300))
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * log_v)
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)   # 0 when none is
    log_gamma = math.log(d) + log_v.gather(0, first)[0]
    boost = torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float64)
    return log_gamma + torch.log(boost) / alpha


def sample_beta(alpha, beta, shape=(), generator=None, device=None):
    """Beta(alpha, beta) draws of ``shape`` (fp32) on ``device`` from
    ``generator``'s normals and uniforms: ``X / (X + Y)`` for ``X ~
    Gamma(alpha)``, ``Y ~ Gamma(beta)``, as ``sigmoid(log X - log Y)`` in
    float64 (small shapes make draws far below fp32's range)."""
    log_x = _log_gamma_sample(float(alpha), shape, generator, device)
    log_y = _log_gamma_sample(float(beta), shape, generator, device)
    return torch.sigmoid(log_x - log_y).float()


def mixup_with(images, labels, lam, perm):
    """Mixup fed its draws: ``lam * x + (1 - lam) * x[perm]`` (fp32) with
    ``lam`` a scalar; returns ``(mixed, labels, labels[perm], lam)``."""
    x = _as_float(images)
    perm = perm.to(images.device).long()
    lam = torch.as_tensor(lam, dtype=torch.float32, device=images.device)
    return lam * x + (1.0 - lam) * x[perm], labels, labels[perm.to(labels.device)], lam


def mixup(images, labels, alpha=0.2, generator=None):
    """Batch mixup (Zhang et al. 2018): each sample convex-combined with a
    shuffled partner, ``lam ~ Beta(alpha, alpha)`` shared by the batch.
    Returns ``(mixed_images, labels_a, labels_b, lam)``; train with
    :func:`mixup_loss`."""
    lam = sample_beta(alpha, alpha, generator=generator, device=images.device)
    perm = random_permutation(images.shape[0], generator, images.device)
    return mixup_with(images, labels, lam, perm)


def cutmix_with(images, labels, lam0, perm, cy, cx):
    """CutMix fed its draws: the box of side ``int(sqrt(1 - lam0) * h)`` by
    ``int(sqrt(1 - lam0) * w)`` centred at ``(cy, cx)`` (scalars), clipped
    to the image, is pasted from ``x[perm]``.  Returns ``(mixed, labels,
    labels[perm], lam)`` with ``lam = 1 - area / (h * w)`` of the clipped
    box, in fp32."""
    x = _as_float(images)
    _, h, w, _ = x.shape
    dev = images.device
    perm = perm.to(dev).long()
    ratio = torch.sqrt(1.0 - torch.as_tensor(lam0, dtype=torch.float32, device=dev))
    cut_h = (ratio * h).to(torch.int32)
    cut_w = (ratio * w).to(torch.int32)
    cy = torch.as_tensor(cy, device=dev).to(torch.int32)
    cx = torch.as_tensor(cx, device=dev).to(torch.int32)
    y0 = torch.clamp(cy - cut_h // 2, 0, h)
    y1 = torch.clamp(cy + cut_h // 2, 0, h)
    x0 = torch.clamp(cx - cut_w // 2, 0, w)
    x1 = torch.clamp(cx + cut_w // 2, 0, w)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    mixed = torch.where(inside[None, :, :, None], x[perm], x)
    lam = 1.0 - ((y1 - y0) * (x1 - x0)).float() / float(h * w)
    return mixed, labels, labels[perm.to(labels.device)], lam


def cutmix(images, labels, alpha=1.0, generator=None):
    """CutMix (Yun et al. 2019): a random box pasted from a shuffled
    partner, ``lam0 ~ Beta(alpha, alpha)``, its centre uniform over the
    image; the label weight is the kept area.  Returns ``(mixed_images,
    labels_a, labels_b, lam)``."""
    n, h, w, _ = images.shape
    dev = images.device
    lam0 = sample_beta(alpha, alpha, generator=generator, device=dev)
    perm = random_permutation(n, generator, dev)
    cy = torch.randint(0, h, (), generator=generator, device=dev)
    cx = torch.randint(0, w, (), generator=generator, device=dev)
    return cutmix_with(images, labels, lam0, perm, cy, cx)


def mixup_loss(logits, labels_a, labels_b, lam):
    """The convex cross-entropy of :func:`mixup` / :func:`cutmix` targets:
    ``mean(lam * ce(labels_a) + (1 - lam) * ce(labels_b))``, each ``ce``
    optax's ``softmax_cross_entropy_with_integer_labels``."""
    la = F.cross_entropy(logits, labels_a.long(), reduction='none')
    lb = F.cross_entropy(logits, labels_b.long(), reduction='none')
    return (lam * la + (1.0 - lam) * lb).mean()

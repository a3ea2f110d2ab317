"""The port's device augment ops against ``petastorm_tpu.jax.augment``.

The random ops are compared through their inner halves: the offsets and
masks that the JAX key draws (the same ``jax.random`` calls its ops make)
are fed to ``crop_at`` / ``flip_where``, and the results must be equal bit
for bit.  ``normalize`` computes ``(x - mean) / std`` in fp32 on both sides:
equal within one fp32 rounding (rtol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.jax import augment as jax_augment

from petastorm_tpu_torch.gpu import augment


def _images(seed, shape=(5, 12, 10, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize('padding', [0, 4])
def test_crop_at_matches_jax_random_crop(padding):
    images = _images(0)
    key = jax.random.PRNGKey(3)
    crop = (8, 6)
    want = np.asarray(jax_augment.random_crop(key, jnp.asarray(images), crop, padding=padding))
    # the draws jax's random_crop makes from this key
    n, h, w = images.shape[0], images.shape[1] + 2 * padding, images.shape[2] + 2 * padding
    kt, kl = jax.random.split(key)
    tops = np.asarray(jax.random.randint(kt, (n,), 0, h - crop[0] + 1))
    lefts = np.asarray(jax.random.randint(kl, (n,), 0, w - crop[1] + 1))
    got = augment.crop_at(torch.tensor(images), torch.tensor(tops), torch.tensor(lefts), crop,
                          padding=padding)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_at_clamps_offsets_like_dynamic_slice():
    images = _images(1)
    got = augment.crop_at(torch.tensor(images), torch.tensor([-3, 0, 99, 2, 4]),
                          torch.tensor([0, 99, -1, 1, 4]), (8, 6))
    want = np.stack([images[i, t:t + 8, l:l + 6] for i, (t, l) in
                     enumerate([(0, 0), (0, 4), (4, 0), (2, 1), (4, 4)])])
    np.testing.assert_array_equal(got.numpy(), want)


def test_flip_where_matches_jax_random_flip():
    images = _images(2, (16, 6, 7, 3))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_augment.random_flip_left_right(key, jnp.asarray(images)))
    mask = np.asarray(jax.random.bernoulli(key, 0.5, (16,)))
    assert 0 < mask.sum() < 16
    got = augment.flip_where(torch.tensor(images), torch.tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_normalize_matches_jax(dtype):
    images = _images(3)
    want = jax_augment.normalize(jnp.asarray(images), dtype=getattr(jnp, dtype))
    got = augment.normalize(torch.tensor(images), dtype=getattr(torch, dtype))
    assert str(got.dtype) == 'torch.' + dtype
    rtol = 1e-6 if dtype == 'float32' else 2 ** -8   # bf16: one rounding of the fp32 value
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=1e-6)


def test_normalize_makes_its_constants_once_per_device():
    """The mean/std tensors are built on the first call for a device and
    reused after it (building them each step would make the host wait for
    the card), and custom statistics still apply."""
    images = torch.tensor(_images(2))
    augment.normalize(images)
    before = augment._channel_constant.cache_info()
    augment.normalize(images)
    after = augment._channel_constant.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 2
    got = augment.normalize(images, mean=[1, 2, 3], std=(2.0, 4.0, 8.0), dtype=torch.float32)
    want = (images.float() - torch.tensor([1.0, 2.0, 3.0])) / torch.tensor([2.0, 4.0, 8.0])
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_random_wrappers_draw_from_the_generator():
    """Same generator seed -> same draws; offsets stay in range; a flip
    probability of 0 or 1 is deterministic."""
    images = torch.tensor(_images(4, (32, 12, 10, 3)))
    a = augment.random_crop(images, (12, 10), padding=4,
                            generator=torch.Generator().manual_seed(9))
    b = augment.random_crop(images, (12, 10), padding=4,
                            generator=torch.Generator().manual_seed(9))
    assert a.shape == (32, 12, 10, 3) and torch.equal(a, b)
    assert not torch.equal(a, images)   # some sample moved
    assert torch.equal(augment.random_flip_left_right(images, prob=0.0), images)
    assert torch.equal(augment.random_flip_left_right(images, prob=1.0), images.flip(2))
    with pytest.raises(ValueError):
        augment.random_crop(images, (30, 10))


def _float_images(seed, shape=(6, 12, 10, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


#: Color ops, mixup and cutmix against JAX on the 0..255 scale: the
#: per-sample means and the blends sum in other orders (fp32 ulps at 255
#: are 1.5e-5).
COLOR_ATOL = 1e-4


@pytest.mark.parametrize('crop', [(12, 10), (8, 6), (5, 9)])
def test_center_crop_matches_jax(crop):
    images = _images(5)
    want = np.asarray(jax_augment.center_crop(jnp.asarray(images), crop))
    np.testing.assert_array_equal(augment.center_crop(torch.tensor(images), crop).numpy(), want)
    with pytest.raises(ValueError, match='larger'):
        augment.center_crop(torch.tensor(images), (13, 10))


@pytest.mark.parametrize('uint8', [True, False])
@pytest.mark.parametrize('op', ['brightness', 'contrast', 'saturation'])
def test_color_ops_match_jax_fed_the_same_draws(op, uint8):
    images = _images(6) if uint8 else _float_images(6)
    n = images.shape[0]
    key = jax.random.PRNGKey(11)
    if op == 'brightness':
        want = jax_augment.random_brightness(key, jnp.asarray(images), 0.3)
        draw = jax.random.uniform(key, (n, 1, 1, 1), minval=-0.3, maxval=0.3)
        got = augment.adjust_brightness(torch.tensor(images), torch.tensor(np.asarray(draw)))
    else:
        jax_op = getattr(jax_augment, 'random_' + op)
        want = jax_op(key, jnp.asarray(images), 0.5, 1.7)
        draw = jax.random.uniform(key, (n, 1, 1, 1), minval=0.5, maxval=1.7)
        got = getattr(augment, 'adjust_' + op)(torch.tensor(images),
                                               torch.tensor(np.asarray(draw)).flatten())
    assert got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=COLOR_ATOL, rtol=0)


def _color64(op, x, draw):
    """A color op in float64 (numpy) on ``x`` with per-sample ``draw``."""
    x = np.asarray(x, np.float64)
    d = np.asarray(draw, np.float64).reshape(-1, 1, 1, 1)
    if op == 'brightness':
        y = x + d * 255.0
    elif op == 'contrast':
        mean = x.mean(axis=(1, 2, 3), keepdims=True)
        y = (x - mean) * d + mean
    else:
        grey = 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
        y = grey + (x - grey) * d
    return np.clip(y, 0.0, 255.0)


def test_color_jitter_matches_jax_fed_the_same_draws():
    """Brightness, contrast, saturation in that order, each stage fed the
    JAX chain's previous stage: the port within ``COLOR_ATOL`` of the stage
    computed in float64, and of JAX's stage within ``COLOR_ATOL`` plus JAX's
    own distance from float64 (its fp32 per-sample mean is off by up to
    4.6e-4 on a float input, which moves the contrast stage by 1.2e-4); the
    whole chain within three times that (one per op)."""
    images = _images(7)
    n = images.shape[0]
    key = jax.random.PRNGKey(12)
    want = jax_augment.color_jitter(key, jnp.asarray(images), 0.2, 0.3, 0.4)
    kb, kc, ks = jax.random.split(key, 3)
    stages = [jnp.asarray(images), jax_augment.random_brightness(kb, jnp.asarray(images), 0.2)]
    stages.append(jax_augment.random_contrast(kc, stages[-1], 0.7, 1.3))
    stages.append(jax_augment.random_saturation(ks, stages[-1], 0.6, 1.4))
    np.testing.assert_array_equal(np.asarray(stages[-1]), np.asarray(want))
    draws = [np.asarray(jax.random.uniform(kk, (n, 1, 1, 1), minval=lo, maxval=hi)).flatten()
             for kk, lo, hi in ((kb, -0.2, 0.2), (kc, 0.7, 1.3), (ks, 0.6, 1.4))]
    x, budget = torch.tensor(images), 0.0
    for name, draw, before, after in zip(('brightness', 'contrast', 'saturation'), draws,
                                         stages, stages[1:]):
        op = getattr(augment, 'adjust_' + name)
        stage = op(torch.tensor(np.asarray(before)), torch.tensor(draw)).numpy()
        exact = _color64(name, before, draw)
        np.testing.assert_allclose(stage, exact, atol=COLOR_ATOL, rtol=0)
        jax_err = float(np.abs(np.asarray(after) - exact).max())
        np.testing.assert_allclose(stage, np.asarray(after), atol=COLOR_ATOL + jax_err, rtol=0)
        budget += COLOR_ATOL + jax_err
        x = op(x, torch.tensor(draw))
    np.testing.assert_allclose(x.numpy(), np.asarray(want), atol=budget, rtol=0)


@pytest.mark.parametrize('size,fill,uint8', [(4, 0.0, True), (5, 0.0, False), (7, 9.0, True)])
def test_cutout_at_matches_jax_random_cutout(size, fill, uint8):
    images = _images(8, (9, 12, 10, 3)) if uint8 else _float_images(8, (9, 12, 10, 3))
    n, h, w = images.shape[:3]
    key = jax.random.PRNGKey(13)
    want = np.asarray(jax_augment.random_cutout(key, jnp.asarray(images), size, fill))
    ky, kx = jax.random.split(key)
    cy = np.asarray(jax.random.randint(ky, (n, 1, 1), 0, h)).flatten()
    cx = np.asarray(jax.random.randint(kx, (n, 1, 1), 0, w)).flatten()
    got = augment.cutout_at(torch.tensor(images), torch.tensor(cy), torch.tensor(cx), size, fill)
    assert got.dtype == torch.tensor(images).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('alpha', [0.2, 0.8])
def test_mixup_with_matches_jax_fed_the_same_draws(alpha):
    images = _images(9, (8, 6, 5, 3))
    labels = np.arange(8, dtype=np.int32) * 3
    key = jax.random.PRNGKey(14)
    want = jax_augment.mixup(key, jnp.asarray(images), jnp.asarray(labels), alpha)
    k_lam, k_perm = jax.random.split(key)
    lam = np.asarray(jax.random.beta(k_lam, alpha, alpha))
    perm = np.asarray(jax.random.permutation(k_perm, 8))
    got = augment.mixup_with(torch.tensor(images), torch.tensor(labels), torch.tensor(lam),
                             torch.tensor(perm))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=COLOR_ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize('alpha,seed', [(1.0, 15), (0.3, 16), (1.0, 17)])
def test_cutmix_with_matches_jax_fed_the_same_draws(alpha, seed):
    images = _float_images(10, (7, 16, 12, 3))
    labels = np.arange(7, dtype=np.int32) + 100
    n, h, w = images.shape[:3]
    key = jax.random.PRNGKey(seed)
    want = jax_augment.cutmix(key, jnp.asarray(images), jnp.asarray(labels), alpha)
    k_lam, k_perm, ky, kx = jax.random.split(key, 4)
    draws = (jax.random.beta(k_lam, alpha, alpha), jax.random.permutation(k_perm, n),
             jax.random.randint(ky, (), 0, h), jax.random.randint(kx, (), 0, w))
    got = augment.cutmix_with(torch.tensor(images), torch.tensor(labels),
                              *(torch.tensor(np.asarray(d)) for d in draws))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[3].dtype == torch.float32
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_cutmix_lam_is_the_kept_area():
    """Every image a constant of its own: the pixels that changed are the
    pasted box, and ``lam`` is one minus their share."""
    n, h, w = 6, 20, 14
    images = torch.arange(n, dtype=torch.float32).view(n, 1, 1, 1).expand(n, h, w, 3).clone()
    labels = torch.arange(n)
    areas = set()
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        mixed, _, labels_b, lam = augment.cutmix(images, labels, 1.0, generator=g)
        # one box for the whole batch (a sample paired with itself does not change)
        box = (mixed != images)[..., 0].any(dim=0)
        partner = labels_b.float().view(n, 1, 1, 1).expand_as(images)
        assert torch.equal(mixed, torch.where(box[None, :, :, None], partner, images))
        assert abs(float(lam) - (1.0 - float(box.sum()) / (h * w))) < 1e-6
        areas.add(int(box.sum()))
    assert len(areas) > 4


def test_mixup_loss_matches_optax():
    """The JAX op is two ``optax.softmax_cross_entropy_with_integer_labels``."""
    rng = np.random.default_rng(18)
    logits = (rng.standard_normal((9, 13)) * 3).astype(np.float32)
    la, lb = rng.integers(0, 13, 9).astype(np.int32), rng.integers(0, 13, 9).astype(np.int32)
    for lam in (0.0, 0.37, 1.0):
        want = jax_augment.mixup_loss(jnp.asarray(logits), jnp.asarray(la), jnp.asarray(lb),
                                      jnp.float32(lam))
        got = augment.mixup_loss(torch.tensor(logits), torch.tensor(la), torch.tensor(lb),
                                 torch.tensor(lam, dtype=torch.float32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def _draw_all(seed):
    """Each random wrapper once, in order, from one generator."""
    images = torch.tensor(_images(19, (16, 12, 10, 3)))
    labels = torch.arange(16)
    g = torch.Generator().manual_seed(seed)
    return [augment.random_brightness(images, generator=g),
            augment.random_contrast(images, generator=g),
            augment.random_saturation(images, generator=g),
            augment.color_jitter(images, generator=g),
            augment.random_cutout(images, 5, generator=g)] + \
        list(augment.mixup(images, labels, 0.4, generator=g)) + \
        list(augment.cutmix(images, labels, 1.0, generator=g))


def test_new_wrappers_repeat_under_a_seed_and_differ_across_seeds():
    a, b, c = _draw_all(21), _draw_all(21), _draw_all(22)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    differ = [not torch.equal(x, y) for x, y in zip(a, c)]
    # the labels_a of mixup and cutmix are the labels themselves
    assert differ == [True] * 6 + [False, True, True] + [True, False, True, True]


@pytest.mark.parametrize('alpha', [0.2, 0.8, 1.0, 2.5])
def test_beta_draws_have_the_beta_mean_and_variance(alpha):
    """20,000 draws of Beta(alpha, alpha) from a seeded generator: mean 1/2
    within 5 standard errors, variance 1 / (4 (2 alpha + 1)) within 5 %, and
    a two-sample Kolmogorov-Smirnov test against as many of scipy's Beta
    draws (seeded), rounded to fp32 as the port's are (at alpha 0.2 about
    2 % of them round to 1.0), that does not reject."""
    from scipy import stats
    n = 20000
    x = augment.sample_beta(alpha, alpha, (n,), generator=torch.Generator().manual_seed(23))
    assert x.dtype == torch.float32 and float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    x = x.double().numpy()
    var = 1.0 / (4.0 * (2 * alpha + 1))
    assert abs(x.mean() - 0.5) < 5 * np.sqrt(var / n)
    assert abs(x.var() / var - 1.0) < 0.05
    ref = stats.beta(alpha, alpha).rvs(n, random_state=np.random.default_rng(24))
    assert stats.ks_2samp(x, ref.astype(np.float32).astype(np.float64)).pvalue > 1e-3


def test_random_permutation_is_a_permutation_and_repeats_under_a_seed():
    perms = [augment.random_permutation(50, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert perms[0].dtype == torch.int64
    assert torch.equal(torch.sort(perms[0])[0], torch.arange(50))
    assert torch.equal(perms[0], perms[1]) and not torch.equal(perms[0], perms[2])

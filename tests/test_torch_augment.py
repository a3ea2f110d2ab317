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

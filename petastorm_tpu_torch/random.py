"""The part of ``jax.random`` the in-memory loaders use, bit for bit.

``PRNGKey(seed)``, ``split(key)`` and ``permutation(key, n)`` compute what
JAX 0.9.0 computes for them with the default threefry2x32 generator and
``jax_threefry_partitionable=True``, in numpy ``uint32``: the epoch orders
of :class:`~petastorm_tpu_torch.gpu.loader.DeviceInMemDataLoader` are then
the JAX loader's, element for element.  Counterparts in ``jax/_src``:
``prng.threefry_seed``, ``prng._threefry_split_foldlike``,
``prng._threefry_random_bits_partitionable``, ``prng._threefry2x32_lowering``
and ``random._shuffle``.  A key is a ``uint32`` array of shape ``(2,)``.
"""

import numpy as np

__all__ = ['PRNGKey', 'split', 'random_bits', 'permutation', 'threefry2x32']

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    ``key``; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over='ignore'):   # uint32 arithmetic wraps, as in XLA
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(n):
    """``iota_2x32_shape((n,))``: the high and low words of 0..n-1."""
    counts = np.arange(n, dtype=np.uint64)
    return (counts >> np.uint64(32)).astype(np.uint32), counts.astype(np.uint32)


def PRNGKey(seed):  # noqa: N802 (jax.random's name)
    """The raw key of an integer seed as ``jax.random.PRNGKey`` builds it
    with 64-bit mode off (JAX's default): a zero high word and the seed
    modulo 2^32 as the low word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)``: ``num`` new keys, shape ``(num, 2)``."""
    bits0, bits1 = threefry2x32(key, *_counters(num))
    return np.stack([bits0, bits1], axis=1)


def random_bits(key, n):
    """``n`` uniform 32-bit words: ``jax.random.bits(key, (n,), uint32)``."""
    bits0, bits1 = threefry2x32(key, *_counters(n))
    return bits0 ^ bits1


def permutation(key, n):
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int32) shuffled by
    rounds of a stable sort on fresh 32-bit keys; the number of rounds,
    ``ceil(3 ln n / ln(2^32 - 1))``, is JAX's."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind='stable')]
    return x

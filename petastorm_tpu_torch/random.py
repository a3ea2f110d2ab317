"""The part of ``jax.random`` the in-memory loaders use, bit for bit.

``PRNGKey(seed)``, ``split(key)``, ``fold_in(key, data)`` and
``permutation(key, n)`` compute what JAX 0.9.0 computes for them with the
default threefry2x32 generator and ``jax_threefry_partitionable=True``, in
numpy ``uint32``: the epoch orders of
:class:`~petastorm_tpu_torch.gpu.loader.DeviceInMemDataLoader` (a chain of
``split``) and of :class:`~petastorm_tpu_torch.gpu.loader.ResidentDataLoader`
(``fold_in`` of the epoch) are then the JAX loaders', element for element.
Counterparts in ``jax/_src``: ``prng.threefry_seed``,
``prng._threefry_split_foldlike``, ``prng._threefry_fold_in``,
``prng._threefry_random_bits_partitionable``, ``prng._threefry2x32_lowering``
and ``random._shuffle``.  A key is a ``uint32`` array of shape ``(2,)``.

``uniform``, ``gumbel`` and ``categorical`` (float32) are what
``random._uniform``, ``random._gumbel`` in its default ``mode='low'``
(``jax_high_dynamic_range_gumbel`` is off) and ``random.categorical``
compute: the sampler of ``models.decoding.generate``.  The random words and
the uniforms are the JAX package's bit for bit; the logarithms of the
Gumbel noise run in torch on the logits' device and may differ from XLA's
in the last bit, which moves no sample short of an exact tie.
"""

import numpy as np
import torch

__all__ = ['PRNGKey', 'split', 'fold_in', 'random_bits', 'permutation', 'threefry2x32', 'uniform',
           'uniform_stack', 'gumbel', 'gumbel_stack', 'categorical']

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    ``key``; returns the two output words.  The key's two words may be
    arrays that broadcast against the counters (many keys at once)."""
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


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the key of ``data`` (taken modulo
    2^32) under ``key``, ``threefry2x32(key, [0], [data])``."""
    bits0, bits1 = threefry2x32(key, np.zeros(1, np.uint32),
                                np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([bits0, bits1])


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


def uniform(key, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under exponent 0 give a float in [1, 2), minus 1,
    scaled to [minval, maxval) in float32."""
    return uniform_stack([key], shape, minval, maxval)[0]


#: Random words :func:`uniform_stack` computes in one pass: many keys a pass,
#: in arrays that stay in the CPU's cache.
_WORDS_PER_PASS = 1 << 16


def uniform_stack(keys, shape=(), minval=0.0, maxval=1.0):
    """``[uniform(key, shape, minval, maxval) for key in keys]`` stacked on
    a new leading axis, the threefry rounds run over many keys at once."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    per_pass = max(1, _WORDS_PER_PASS // max(n, 1))
    bits = np.empty((len(keys), n), np.uint32)
    for i in range(0, len(keys), per_pass):
        chunk = keys[i:i + per_pass]
        bits0, bits1 = threefry2x32((chunk[:, :1], chunk[:, 1:]), *_counters(n))
        bits[i:i + per_pass] = bits0 ^ bits1
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape((len(keys),) + shape)


def gumbel(key, shape=(), device='cpu'):
    """``jax.random.gumbel(key, shape, float32)`` in JAX's default
    ``mode='low'``: ``-log(-log(u))`` of ``u = uniform(key, shape,
    minval=finfo(float32).tiny)``, as a float32 tensor on ``device``."""
    return gumbel_stack([key], shape, device)[0]


def gumbel_stack(keys, shape=(), device='cpu'):
    """``[gumbel(key, shape) for key in keys]`` stacked on a new leading
    axis, with the uniforms moved to ``device`` in one copy."""
    u = uniform_stack(keys, shape, minval=np.finfo(np.float32).tiny, maxval=1.0)
    return -torch.log(-torch.log(torch.from_numpy(u).to(device)))


def categorical(key, logits, axis=-1):
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max trick,
    ``argmax(gumbel(key, logits.shape) + logits)`` over ``axis`` (the first
    index wins a tie, as in ``jnp.argmax``).  ``logits`` is a float32
    tensor; returns int64 indices on its device."""
    if logits.dtype != torch.float32:
        raise TypeError('categorical takes float32 logits, got %s' % (logits.dtype,))
    return torch.argmax(gumbel(key, logits.shape, logits.device) + logits, dim=axis)

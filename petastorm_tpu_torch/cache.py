"""Row-group result cache interface.

Counterpart of ``petastorm_tpu/cache.py``: the interface and the null
cache (``cache_type='null'``).  The local-disk cache is
:mod:`petastorm_tpu_torch.local_disk_cache`, the cache plane
:mod:`petastorm_tpu_torch.cache_plane`.
"""


class CacheBase(object):
    def get(self, key, fill_cache_func):
        """Return the cached value for ``key``, computing and storing it via
        ``fill_cache_func()`` on a miss."""
        raise NotImplementedError()

    def cleanup(self):
        """Release resources / delete backing storage if owned."""


class NullCache(CacheBase):
    """No caching: always calls ``fill_cache_func``."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()

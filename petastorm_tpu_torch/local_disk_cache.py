"""A size-limited LRU row-group result cache on local disk.

Counterpart of ``petastorm_tpu/local_disk_cache.py``: one pickle file per
key (named by the key's SHA-1, as the reference names them), LRU eviction by
access time once ``size_limit`` is passed, atomic publish.  Repeated epochs
over slow storage pay the decode once.  Safe for the threads of one process;
processes sharing a path get best-effort behaviour (atomic renames, an
eviction race costs a decode).
"""

import hashlib
import os
import pickle
import threading

from petastorm_tpu_torch.cache import CacheBase


class LocalDiskCache(CacheBase):
    def __init__(self, path, size_limit_bytes, expected_row_size_bytes=None, shards=None,
                 cleanup=False, **_compat_kwargs):
        """``expected_row_size_bytes``, ``shards`` and the other keywords are the
        reference's tuning knobs, accepted and unused."""
        if path is None:
            raise ValueError("cache_location is required for cache_type='local-disk'")
        self._path = path
        self._size_limit = size_limit_bytes or (1 << 30)
        self._cleanup_on_exit = cleanup
        self._lock = threading.Lock()
        #: lookups served from disk, and those that had to decode
        self.hits = 0
        self.misses = 0
        os.makedirs(path, exist_ok=True)

    # crosses the process pool's boundary inside the worker args
    def __getstate__(self):
        state = self.__dict__.copy()
        del state['_lock']
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _key_path(self, key):
        return os.path.join(self._path, hashlib.sha1(str(key).encode('utf-8')).hexdigest() + '.pkl')

    def get(self, key, fill_cache_func):
        key_path = self._key_path(key)
        try:
            with open(key_path, 'rb') as f:
                value = pickle.load(f)
            os.utime(key_path)   # the LRU touch
            with self._lock:
                self.hits += 1
            return value
        except (FileNotFoundError, EOFError, pickle.UnpicklingError):
            pass
        with self._lock:
            self.misses += 1
        value = fill_cache_func()
        tmp_path = key_path + '.tmp.%d' % os.getpid()
        with open(tmp_path, 'wb') as f:
            pickle.dump(value, f, protocol=4)
        os.replace(tmp_path, key_path)
        self._evict_if_needed()
        return value

    @property
    def stats(self):
        return {'cache_hits': self.hits, 'cache_misses': self.misses}

    def _evict_if_needed(self):
        with self._lock:
            entries, total = [], 0
            for name in os.listdir(self._path):
                if not name.endswith('.pkl'):
                    continue
                full = os.path.join(self._path, name)
                try:
                    st = os.stat(full)
                except FileNotFoundError:
                    continue
                entries.append((st.st_atime, st.st_size, full))
                total += st.st_size
            if total <= self._size_limit:
                return
            for _, size, full in sorted(entries):   # the oldest access first
                try:
                    os.remove(full)
                except FileNotFoundError:
                    continue
                total -= size
                if total <= self._size_limit:
                    break

    def cleanup(self):
        if not self._cleanup_on_exit:
            return
        for name in os.listdir(self._path):
            if name.endswith('.pkl'):
                try:
                    os.remove(os.path.join(self._path, name))
                except FileNotFoundError:
                    pass

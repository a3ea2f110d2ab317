"""The tiered epoch-cache plane: decoded row groups shared across processes.

Counterpart of ``petastorm_tpu/cache_plane/``.  Every epoch after the first
pays the Parquet read and the decode again unless something keeps the
decoded result.  The plane keeps it for every process of the host: a hot
tier in ``/dev/shm`` over an mmap'd disk tier under an LRU byte cap, with
atomic publish, keyed by a content fingerprint (the data files' identity
and the decode's: columns, predicate, transform), so that a rewritten
dataset or a changed transform misses instead of serving stale rows.

* ``make_reader(..., cache_type='plane', cache_location=DIR)`` (and
  ``make_batch_reader``): the readers' workers look a row group up first.
* ``ServiceConfig(cache_plane=True, cache_plane_dir=DIR)``: the data
  service's decode workers share one plane, and with ``cluster_cache`` the
  fleet shares entries across hosts (:mod:`petastorm_tpu_torch.service.cluster`).
"""

from petastorm_tpu_torch.cache_plane.fingerprint import dataset_fingerprint, spec_token
from petastorm_tpu_torch.cache_plane.plane import CachePlane, PlaneCache, sweep_residue

__all__ = ['CachePlane', 'PlaneCache', 'dataset_fingerprint', 'spec_token', 'sweep_residue']

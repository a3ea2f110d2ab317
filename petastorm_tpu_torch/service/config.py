"""Configuration of the data service: one :class:`ServiceConfig` per job.

Counterpart of ``petastorm_tpu/service/config.py``.  A job is the dataset,
how its row-group list is cut into splits, how splits map onto consumers,
the control-plane timing (lease TTL) and the data-plane flow control (the
credit window).  The dispatcher
owns the config; workers and clients fetch what they need over the ``job``
RPC, so every process agrees on one partition geometry.

The port holds the service's single-tenant core.  The fields of the planes
it does not hold yet (the cache plane and the cluster cache, the durable
ledger, tenancy, the autoscaler, adaptive scheduling, the ingest plane, the
command line's worker knobs, the workers' span export, and a reader chosen
by hand) keep the reference's names and defaults, and raise ``ValueError``
naming their ``ROADMAP.md`` item when set away from their defaults.  A worker heartbeats
every third of ``lease_ttl_s`` (the reference's default cadence) and holds
the worker module's fixed lease and buffer bounds.
"""

import dataclasses
import hashlib

#: Where the service planes this slice refuses are queued.
_LATER_ITEM = 'ROADMAP.md, Queue A item 7'

#: field -> its default: the options outside the single-tenant core
_OUTSIDE_CORE = {
    'cache_plane': False, 'cache_plane_dir': None, 'cache_plane_ram_bytes': None,
    'cache_plane_disk_bytes': None, 'ledger_path': None, 'tenant': 'default',
    'tenant_weight': 1.0, 'max_tenant_jobs': 8, 'tenant_shm_quota_bytes': None,
    'tenant_cache_quota_bytes': None, 'autoscale': False, 'autoscale_min_workers': 1,
    'autoscale_max_workers': 8, 'autoscale_step': 1, 'autoscale_cooldown_s': 10.0,
    'autoscale_starve_s': 3.0, 'autoscale_idle_s': 30.0, 'scheduling': 'auto',
    'ingest': 'auto', 'heartbeat_interval_s': None, 'max_buffered_chunks': 32,
    'max_inflight_splits': 3, 'telemetry_spans': True, 'reader_factory': 'auto',
}


@dataclasses.dataclass
class ServiceConfig:
    """A job's description and the dispatcher's, workers' and clients' knobs.

    Args:
        dataset_url: the dataset every decode worker reads: a petastorm
            store (``make_reader`` with ``columnar_decode=True``) or plain
            Parquet (``make_batch_reader``).
        num_consumers: consuming training hosts.  Split ``i`` belongs to
            consumer ``i % num_consumers``, the modulo contract of the
            readers' sharding.
        rowgroups_per_split: consecutive row groups per split, the unit of
            lease, reassignment and exactly-once delivery (a client commits
            whole splits).
        lease_ttl_s: a lease its worker's heartbeats did not renew within
            this window is reassigned.
        max_split_attempts: a split whose lease expired this many times is
            marked failed, and its clients raise ``ServiceError``.
        credits: a client's credit window, in chunks; it grants one back
            for each chunk it pulls off its socket.
        reader_kwargs: picklable keyword arguments of each split's reader
            (``workers_count``, ``transform_spec``, ...).
        shm: same-host delivery through the shared-memory plane; a chunk
            falls back to bytes when the arena is full, the chunk is under
            the plane's floor or the consumer is on another host.
        shm_capacity_bytes: a worker's shm bytes written and not yet mapped.
        drain_timeout_s: how long a draining worker may finish its splits
            before it deregisters anyway (the rest requeue).

    The remaining fields (``cache_plane*``, ``cluster_cache``,
    ``ledger_path``, ``tenant`` and ``tenant_*``, ``max_tenant_jobs``,
    ``autoscale*``, ``scheduling``, ``ingest``, ``heartbeat_interval_s``,
    ``max_buffered_chunks``, ``max_inflight_splits``, ``telemetry_spans``,
    ``reader_factory``) are the reference's; set away from their defaults they raise.
    """

    dataset_url: str
    num_consumers: int = 1
    rowgroups_per_split: int = 2
    lease_ttl_s: float = 10.0
    max_split_attempts: int = 5
    heartbeat_interval_s: float = None
    credits: int = 8
    max_buffered_chunks: int = 32
    max_inflight_splits: int = 3
    reader_factory: str = 'auto'
    reader_kwargs: dict = dataclasses.field(default_factory=dict)
    shm: bool = True
    shm_capacity_bytes: int = 256 << 20
    cache_plane: bool = False
    cache_plane_dir: str = None
    cache_plane_ram_bytes: int = None
    cache_plane_disk_bytes: int = None
    cluster_cache: bool = None
    scheduling: str = 'auto'
    ingest: str = 'auto'
    telemetry_spans: bool = True
    ledger_path: str = None
    drain_timeout_s: float = 30.0
    tenant: str = 'default'
    tenant_weight: float = 1.0
    max_tenant_jobs: int = 8
    tenant_shm_quota_bytes: int = None
    tenant_cache_quota_bytes: int = None
    autoscale: bool = False
    autoscale_min_workers: int = 1
    autoscale_max_workers: int = 8
    autoscale_step: int = 1
    autoscale_cooldown_s: float = 10.0
    autoscale_starve_s: float = 3.0
    autoscale_idle_s: float = 30.0

    def __post_init__(self):
        refused = sorted(name for name, default in _OUTSIDE_CORE.items()
                         if getattr(self, name) != default)
        if self.cluster_cache:
            refused.append('cluster_cache')
        if refused:
            raise ValueError('%s: the cache plane, the cluster cache, the durable ledger, '
                             'tenancy, the autoscaler, adaptive scheduling, the ingest plane, '
                             'the command line\'s worker knobs, the workers\' span export '
                             'and a reader chosen by hand are a later slice of the port (%s)'
                             % (', '.join(refused), _LATER_ITEM))
        self.cluster_cache = False
        if self.num_consumers < 1:
            raise ValueError('num_consumers must be >= 1')
        if self.rowgroups_per_split < 1:
            raise ValueError('rowgroups_per_split must be >= 1')
        if self.lease_ttl_s <= 0:
            raise ValueError('lease_ttl_s must be positive')
        if self.max_split_attempts < 1:
            raise ValueError('max_split_attempts must be >= 1')
        if self.credits < 1:
            raise ValueError('credits must be >= 1')
        if self.shm_capacity_bytes < 1:
            raise ValueError('shm_capacity_bytes must be positive')
        if self.drain_timeout_s <= 0:
            raise ValueError('drain_timeout_s must be positive')

    def fingerprint(self, num_splits):
        """The identity of the partition geometry a resume token indexes:
        the reference's, so that a token's ``consumed`` split ids are
        checked against the same (dataset, split size, consumer count,
        split count)."""
        key = '%s|%d|%d|%d' % (self.dataset_url, self.num_consumers,
                               self.rowgroups_per_split, num_splits)
        return hashlib.blake2b(key.encode(), digest_size=8).hexdigest()

    def job_info(self, num_splits):
        """What workers and clients need, shippable over the wire."""
        return {
            'dataset_url': self.dataset_url,
            'num_consumers': int(self.num_consumers),
            'num_splits': int(num_splits),
            'rowgroups_per_split': int(self.rowgroups_per_split),
            'lease_ttl_s': float(self.lease_ttl_s),
            'credits': int(self.credits),
            'reader_kwargs': dict(self.reader_kwargs),
            'shm': bool(self.shm),
            'shm_capacity_bytes': int(self.shm_capacity_bytes),
            'drain_timeout_s': float(self.drain_timeout_s),
            'fingerprint': self.fingerprint(num_splits),
            'tenant': self.tenant,
        }

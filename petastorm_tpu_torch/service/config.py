"""Configuration of the data service: one :class:`ServiceConfig` per job.

Counterpart of ``petastorm_tpu/service/config.py``.  A job is the dataset,
how its row-group list is cut into splits, how splits map onto consumers,
the control-plane timing (lease TTL) and the data-plane flow control (the
credit window), its tenant on a shared fleet with its fair-share weight and
quotas, the dispatcher's durable ledger, and the cache plane with the
cluster cache.  The dispatcher owns the config; workers and clients fetch
what they need over the ``job`` RPC, so every process agrees on one
partition geometry.

The fields of the planes the port does not hold yet (adaptive scheduling and
the ingest plane) keep the reference's names and defaults, and raise
``ValueError`` naming their ``ROADMAP.md`` item when set away from their
defaults.  ``PETASTORM_TPU_NO_CLUSTER_CACHE=1`` turns the cluster cache off
wherever it is read, and ``PETASTORM_TPU_NO_AUTOSCALE=1`` the autoscaler.
"""

import dataclasses
import hashlib

#: Where the planes the port does not hold yet are queued.
_LATER_ITEM = 'ROADMAP.md, Queue A item 7'

#: field -> its default: the options of the planes not ported yet
_OUTSIDE_SLICE = {'scheduling': 'auto', 'ingest': 'auto'}


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
        cache_plane: every worker's split readers run with
            ``cache_type='plane'`` over ``cache_plane_dir`` (required), so a
            split decoded once is served from the plane by any worker of the
            host in later epochs; the lease is the decode-ownership grant of
            its row groups.  ``cache_plane_ram_bytes`` and
            ``cache_plane_disk_bytes`` cap the tiers (None: 128 MiB and 4 GiB).
        cluster_cache: the fleet shares its planes' entries
            (:mod:`~petastorm_tpu_torch.service.cluster`): workers advertise
            their digests, the dispatcher leases with cache affinity, a
            worker streams a split its plane holds whole without a reader,
            and fetches from a peer what the peer holds.  Defaults to
            ``cache_plane``; needs it.
        ledger_path: the dispatcher's durable ledger
            (:mod:`~petastorm_tpu_torch.service.ledger`): a dispatcher
            restarted on it keeps done splits done and attempt counts, and
            adopts the leases its workers still hold.  A ledger of another
            partition geometry is ignored whole.
        tenant: the tenant this config's job registers under.  The
            dispatcher's own config is the default tenant's job; others join
            through :func:`~petastorm_tpu_torch.service.client.register_tenant_job`.
        tenant_weight: the fair share of lease grants among tenants with
            pending splits.
        max_tenant_jobs: the cap on concurrent tenant jobs; a registration
            past it is refused with a retry hint.
        tenant_shm_quota_bytes: a tenant's outstanding shm bytes on each
            worker (None: unlimited); past it its chunks take the byte path.
        tenant_cache_quota_bytes: the bytes a tenant may fill into each
            worker's cache plane (None: unlimited); past it its splits
            decode without the plane.

        heartbeat_interval_s: a worker's heartbeat cadence; None is a third
            of ``lease_ttl_s``.  The workers beat at that third, as the
            reference's do.
        max_buffered_chunks / max_inflight_splits: a worker's bounds, its
            serialized chunks waiting for credits and the leases it holds;
            set on each worker (``Worker(max_inflight_splits=...)``, the
            command line's flags).  The dispatcher counts the free lease
            slots of the autoscaler with ``max_inflight_splits``.
        reader_factory: ``'auto'`` (each worker probes the dataset once per
            tenant: a petastorm store gets ``make_reader``, plain Parquet
            ``make_batch_reader``), ``'reader'`` or ``'batch_reader'``.
        telemetry_spans: workers ship each split's stage spans on its
            ``end`` header, which a client with a ``trace_recorder`` merges
            into its trace on its own clock.
        autoscale: the dispatcher runs the closed-loop autoscaler
            (:mod:`~petastorm_tpu_torch.service.autoscaler`): it spawns
            workers (``Dispatcher(launcher=)``, by default as processes of
            the command line) when leases starve and drains the worker with
            the least cache coverage when the fleet idles.
        autoscale_min_workers / autoscale_max_workers: the clamp of the live
            fleet.
        autoscale_step: workers spawned per scale-out.
        autoscale_cooldown_s: no action for this long after any action.
        autoscale_starve_s: how long pending splits starve (no free lease
            slot on a live worker) before a scale-out.
        autoscale_idle_s: how long the fleet idles (nothing pending or
            leased) before a scale-in.

    ``scheduling`` and ``ingest`` are the reference's; set away from
    ``'auto'`` they raise.
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
        refused = sorted(name for name, default in _OUTSIDE_SLICE.items()
                         if getattr(self, name) != default)
        if refused:
            raise ValueError('%s: adaptive scheduling and the ingest plane are a later slice '
                             'of the port (%s)' % (', '.join(refused), _LATER_ITEM))
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
        if self.reader_factory not in ('auto', 'reader', 'batch_reader'):
            raise ValueError("reader_factory must be 'auto', 'reader' or 'batch_reader', got %r"
                             % (self.reader_factory,))
        if self.shm_capacity_bytes < 1:
            raise ValueError('shm_capacity_bytes must be positive')
        if self.cache_plane and not self.cache_plane_dir:
            raise ValueError('cache_plane=True requires cache_plane_dir')
        if self.cluster_cache is None:
            self.cluster_cache = bool(self.cache_plane)
        if self.cluster_cache and not self.cache_plane:
            raise ValueError('cluster_cache=True requires cache_plane=True (the cluster tier '
                             'shares the plane entries)')
        if self.drain_timeout_s <= 0:
            raise ValueError('drain_timeout_s must be positive')
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError('tenant must be a non-empty string')
        if self.tenant_weight <= 0:
            raise ValueError('tenant_weight must be positive')
        if self.max_tenant_jobs < 1:
            raise ValueError('max_tenant_jobs must be >= 1')
        if self.autoscale:
            if self.autoscale_min_workers < 0:
                raise ValueError('autoscale_min_workers must be >= 0')
            if self.autoscale_max_workers < max(1, self.autoscale_min_workers):
                raise ValueError('autoscale_max_workers must be >= max(1, autoscale_min_workers)')
            if self.autoscale_step < 1:
                raise ValueError('autoscale_step must be >= 1')
            if self.autoscale_cooldown_s < 0 or self.autoscale_starve_s < 0 \
                    or self.autoscale_idle_s < 0:
                raise ValueError('autoscale timings must be >= 0')
        if self.heartbeat_interval_s is None:
            self.heartbeat_interval_s = self.lease_ttl_s / 3.0

    def fingerprint(self, num_splits):
        """The identity of the partition geometry a resume token indexes:
        the reference's, so that a token's ``consumed`` split ids are
        checked against the same (dataset, split size, consumer count,
        split count)."""
        key = '%s|%d|%d|%d' % (self.dataset_url, self.num_consumers,
                               self.rowgroups_per_split, num_splits)
        return hashlib.blake2b(key.encode(), digest_size=8).hexdigest()

    def job_info(self, num_splits):
        """What workers and clients need, shippable over the wire: the
        reference's keys (the dispatcher overlays ``split_base`` when it
        registers a tenant's job)."""
        return {
            'dataset_url': self.dataset_url,
            'num_consumers': int(self.num_consumers),
            'num_splits': int(num_splits),
            'rowgroups_per_split': int(self.rowgroups_per_split),
            'lease_ttl_s': float(self.lease_ttl_s),
            'credits': int(self.credits),
            'reader_factory': self.reader_factory,
            'reader_kwargs': dict(self.reader_kwargs),
            'shm': bool(self.shm),
            'shm_capacity_bytes': int(self.shm_capacity_bytes),
            'cache_plane': bool(self.cache_plane),
            'cache_plane_dir': self.cache_plane_dir,
            'cache_plane_ram_bytes': self.cache_plane_ram_bytes,
            'cache_plane_disk_bytes': self.cache_plane_disk_bytes,
            'cluster_cache': bool(self.cluster_cache),
            'scheduling': self.scheduling,
            'ingest': self.ingest,
            'telemetry_spans': bool(self.telemetry_spans),
            'drain_timeout_s': float(self.drain_timeout_s),
            'fingerprint': self.fingerprint(num_splits),
            'tenant': self.tenant,
            'tenant_weight': float(self.tenant_weight),
            'split_base': 0,
            'tenant_shm_quota_bytes': self.tenant_shm_quota_bytes,
            'tenant_cache_quota_bytes': self.tenant_cache_quota_bytes,
        }

"""Tenancy: several training jobs on one decode fleet, with fair shares
and quotas.

Counterpart of ``petastorm_tpu/service/tenancy.py``:

* :class:`TenantJob`: one registered job, its tenant id, fair-share
  weight, config and ``job_info``, and its slice of the dispatcher's global
  split-id space (tenant N's splits start at ``split_base``), so that every
  split-addressed RPC (``complete``, ``release``, ``mark_consumed``, the
  heartbeats' ``held``) works unchanged across tenants;
* :class:`TenantRegistry`: the job table in registration order, with an
  admission cap; past it a registration is refused with ``retry_after_s``;
* :class:`TenantScheduler`: weighted deficit round-robin over the tenants
  with pending splits.  Each eligible tenant accrues its weight share of a
  grant, the one with the largest deficit wins and pays a whole grant, and
  deficits are clamped to +/- 8 grants.  With one tenant it always picks
  that tenant with no bookkeeping, so the single-tenant schedule is
  unchanged;
* :class:`QuotaLedger`: per-tenant byte budgets (the shm arena, the cache
  plane).  A charge past the budget is refused and the caller degrades (the
  byte path, a decode without the plane): never a stall, never an error.

The reference records every scheduler pick, refund and quota refusal in its
decision journal; the port does not hold that journal yet (``ROADMAP.md``,
Queue A item 7, the telemetry bullet) and records none.  Nothing here owns
a thread or a socket, and nothing loads torch: the decode workers import it.
"""

import json
import threading
import warnings

__all__ = ['DEFAULT_TENANT', 'ADMISSION_RETRY_S', 'TenantJob', 'TenantRegistry',
           'TenantScheduler', 'QuotaLedger', 'config_to_jsonable', 'config_from_jsonable']

#: The tenant of a tenant-less client, worker, config or ledger.
DEFAULT_TENANT = 'default'

#: The retry hint of a registration refused at the admission cap.
ADMISSION_RETRY_S = 1.0

#: Deficits are clamped to +/- this many grants: a tenant absent for an hour
#: does not bank an hour of the fleet.
_DEFICIT_CLAMP = 8.0


def config_to_jsonable(config_kwargs):
    """A JSON-safe copy of a ``ServiceConfig``'s fields for the ledger: a
    value JSON cannot hold is dropped with a warning (a ``reader_kwargs``
    entry alone where only it fails)."""
    out = {}
    for key, value in dict(config_kwargs).items():
        try:
            json.dumps(value)
        except (TypeError, ValueError):
            if key == 'reader_kwargs' and isinstance(value, dict):
                kept = {}
                for rk, rv in value.items():
                    try:
                        json.dumps(rv)
                        kept[rk] = rv
                    except (TypeError, ValueError):
                        warnings.warn('tenant config reader_kwargs[%r] is not '
                                      'JSON-serializable; dropped from the ledger '
                                      'snapshot (restored jobs re-resolve it)' % rk)
                out[key] = kept
            else:
                warnings.warn('tenant config field %r is not JSON-serializable; '
                              'dropped from the ledger snapshot' % key)
        else:
            out[key] = value
    return out


def config_from_jsonable(data):
    """The ``ServiceConfig`` fields a ledger snapshot stored."""
    return dict(data or {})


class TenantJob(object):
    """One registered job.  ``pending`` is the tenant's own deque of splits
    (the dispatcher owns it); ``grants`` counts its lease grants."""

    __slots__ = ('tenant', 'weight', 'config', 'job_info', 'split_base', 'num_splits',
                 'num_pieces', 'pending', 'grants', 'registered_t')

    def __init__(self, tenant, weight, config, job_info, split_base, num_splits, num_pieces=0,
                 registered_t=0.0):
        self.tenant = tenant
        self.weight = float(weight)
        self.config = config
        self.job_info = job_info
        self.split_base = int(split_base)
        self.num_splits = int(num_splits)
        self.num_pieces = int(num_pieces)
        self.pending = None
        self.grants = 0
        self.registered_t = registered_t

    def describe(self):
        return {'tenant': self.tenant, 'weight': self.weight, 'split_base': self.split_base,
                'num_splits': self.num_splits, 'grants': self.grants}


class TenantRegistry(object):
    """The tenant jobs in registration order (the scheduler's tie-break, so
    the schedule is deterministic), at most ``max_jobs`` of them."""

    def __init__(self, max_jobs=8):
        self.max_jobs = int(max_jobs)
        self._jobs = {}

    def __len__(self):
        return len(self._jobs)

    def __contains__(self, tenant):
        return tenant in self._jobs

    def get(self, tenant):
        return self._jobs.get(tenant)

    def jobs(self):
        return list(self._jobs.values())

    def tenants(self):
        return list(self._jobs)

    def admit(self, job):
        """Admit ``job``, or return a refusal dict (never raises); a refusal
        at the cap carries ``retry_after_s``."""
        if job.tenant in self._jobs:
            return {'error': 'tenant %r is already registered (one job per tenant id)'
                             % job.tenant}
        if len(self._jobs) >= self.max_jobs:
            return {'error': 'admission refused: %d concurrent tenant job(s) is the cap '
                             '(max_tenant_jobs=%d)' % (len(self._jobs), self.max_jobs),
                    'retry_after_s': ADMISSION_RETRY_S}
        self._jobs[job.tenant] = job
        return None

    def evict(self, tenant):
        return self._jobs.pop(tenant, None)


class TenantScheduler(object):
    """Weighted deficit round-robin over tenants, one :meth:`pick` per lease
    grant: over a long run each tenant's share of the grants converges to its
    weight's share of the tenants eligible together."""

    def __init__(self):
        self._deficit = {}

    def pick(self, eligible):
        """One tenant id of ``eligible`` (jobs in registration order), ties to
        the earliest; None when empty."""
        eligible = list(eligible)
        if not eligible:
            return None
        if len(eligible) == 1:
            return eligible[0].tenant
        total = sum(j.weight for j in eligible) or float(len(eligible))
        best, best_deficit = None, None
        for job in eligible:
            share = (job.weight / total) if total else (1.0 / len(eligible))
            deficit = self._deficit.get(job.tenant, 0.0) + share
            deficit = max(-_DEFICIT_CLAMP, min(_DEFICIT_CLAMP, deficit))
            self._deficit[job.tenant] = deficit
            if best is None or deficit > best_deficit:
                best, best_deficit = job, deficit
        self._deficit[best.tenant] = best_deficit - 1.0
        return best.tenant

    def refund(self, tenant):
        """Undo a pick's debit: the tenant yielded no grant (every pending
        split of it was kept back), and keeps its credit."""
        if tenant in self._deficit:
            self._deficit[tenant] = min(_DEFICIT_CLAMP, self._deficit[tenant] + 1.0)

    def forget(self, tenant):
        self._deficit.pop(tenant, None)

    def deficits(self):
        return dict(self._deficit)


class QuotaLedger(object):
    """Per-tenant outstanding bytes of one resource plane.  A budget of None
    is unlimited; a charge that would pass the budget is refused (the caller
    degrades), so the outstanding bytes never exceed it.  Thread-safe: a
    worker charges at publish and refunds at the ack."""

    def __init__(self, default_budget=None, label=None):
        self._lock = threading.Lock()
        self._default = default_budget
        self._budgets = {}
        self._used = {}
        self.refusals = 0
        #: the plane it guards ('shm' or 'cache')
        self.label = label

    def set_budget(self, tenant, budget_bytes):
        with self._lock:
            self._budgets[tenant] = budget_bytes

    def budget(self, tenant):
        with self._lock:
            return self._budgets.get(tenant, self._default)

    def used(self, tenant):
        with self._lock:
            return self._used.get(tenant, 0)

    def charge(self, tenant, nbytes):
        """Charge and return True within the budget; False (refused) past it."""
        nbytes = int(nbytes)
        with self._lock:
            budget = self._budgets.get(tenant, self._default)
            used = self._used.get(tenant, 0)
            if budget is not None and used + nbytes > budget:
                self.refusals += 1
                return False
            self._used[tenant] = used + nbytes
            return True

    def refund(self, tenant, nbytes):
        with self._lock:
            self._used[tenant] = max(0, self._used.get(tenant, 0) - int(nbytes))

    def snapshot(self):
        with self._lock:
            return {'used': dict(self._used), 'budgets': dict(self._budgets),
                    'refusals': self.refusals}

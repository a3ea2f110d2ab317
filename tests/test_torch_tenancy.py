"""The port's tenancy (``petastorm_tpu_torch.service.tenancy`` and its wiring
in the dispatcher, the worker and the client) against the JAX package's, on
the CPU.

Against JAX, with the same inputs from a numpy seed: the weighted deficit
round-robin's picks (refunds and the clamp included) and deficits, the
admission cap's refusal and retry hint, the quota ledger's charges,
refunds and refusals, ``config_to_jsonable``, and the two dispatchers'
grants, split for split, for the same registrations and lease calls.  The
single-tenant ``job`` reply is unchanged.  On the wire: two tenants served
by one worker subprocess each get JAX's reader's rows, every row once, and
a tenant over its shm quota gets the same rows over the byte path while
the other tenant's chunks go through /dev/shm.  Every wire test runs under
a watchdog of its own.
"""

import threading
import warnings

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.service import Dispatcher as JaxDispatcher
from petastorm_tpu.service import ServiceConfig as JaxServiceConfig
from petastorm_tpu.service import tenancy as jax_tenancy

from petastorm_tpu_torch.errors import ServiceError
from petastorm_tpu_torch.service import (Dispatcher, ServiceConfig, ServiceDataLoader, Worker,
                                         register_tenant_job, tenancy)

from torch_plane_common import write_dataset
from torch_service_common import host_ids, reap, spawn_worker, wait_for, watched, write_raw

ROWS = 96     # 12 row groups of 8: 6 splits of 2
BATCH = 8


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_tenancy'), rows=ROWS)


def _jobs(module, weights):
    return [module.TenantJob('t%d' % i, w, config=None, job_info=None, split_base=0,
                             num_splits=0) for i, w in enumerate(weights)]


# -- the scheduler, the registry, the quota ledger -----------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_scheduler_picks_equal_jax(seed):
    """A seeded sequence of eligible sets, with a refund now and then and
    stretches where a tenant sits out long enough to reach the clamp: the
    same tenant each pick, and the same deficits after."""
    rng = np.random.default_rng(seed)
    weights = rng.uniform(0.5, 4.0, 4).round(2).tolist()
    ours, ref = tenancy.TenantScheduler(), jax_tenancy.TenantScheduler()
    our_jobs, ref_jobs = _jobs(tenancy, weights), _jobs(jax_tenancy, weights)
    picks = []
    for step in range(400):
        # tenant 0 sits out steps 100-199: the others' credit hits the clamp
        mask = rng.random(4) < 0.7
        if 100 <= step < 200:
            mask[0] = False
        eligible = [i for i in range(4) if mask[i]]
        got = ours.pick([our_jobs[i] for i in eligible])
        want = ref.pick([ref_jobs[i] for i in eligible])
        assert got == want, step
        if got is not None and rng.random() < 0.15:
            ours.refund(got)
            ref.refund(want)
        picks.append(got)
        assert ours.deficits() == pytest.approx(ref.deficits(), abs=0), step
    assert max(abs(v) for v in ours.deficits().values()) <= 8.0
    assert len(set(p for p in picks if p)) == 4


def test_one_tenant_is_always_picked_without_bookkeeping():
    ours, ref = tenancy.TenantScheduler(), jax_tenancy.TenantScheduler()
    for _ in range(5):
        assert ours.pick(_jobs(tenancy, [3.0])) == ref.pick(_jobs(jax_tenancy, [3.0])) == 't0'
    assert ours.deficits() == ref.deficits() == {}
    assert ours.pick([]) is ref.pick([]) is None


def test_the_admission_cap_refuses_as_jax():
    ours, ref = tenancy.TenantRegistry(max_jobs=2), jax_tenancy.TenantRegistry(max_jobs=2)
    for name in ('a', 'b', 'c', 'a'):
        got = ours.admit(tenancy.TenantJob(name, 1.0, None, None, 0, 0))
        want = ref.admit(jax_tenancy.TenantJob(name, 1.0, None, None, 0, 0))
        assert got == want, name
    assert got['error'].startswith('tenant')
    assert ours.tenants() == ref.tenants() == ['a', 'b']
    refusal = ours.admit(tenancy.TenantJob('z', 1.0, None, None, 0, 0))
    assert refusal['retry_after_s'] == jax_tenancy.ADMISSION_RETRY_S == 1.0


def test_the_quota_ledger_charges_and_refunds_as_jax():
    rng = np.random.default_rng(5)
    ours, ref = tenancy.QuotaLedger(label='shm'), jax_tenancy.QuotaLedger(label='shm')
    for t, budget in (('a', 1000), ('b', None), ('c', 0)):
        ours.set_budget(t, budget)
        ref.set_budget(t, budget)
    for _ in range(300):
        t = ('a', 'b', 'c', 'd')[int(rng.integers(4))]
        n = int(rng.integers(0, 400))
        if rng.random() < 0.6:
            assert ours.charge(t, n) == ref.charge(t, n)
        else:
            ours.refund(t, n)
            ref.refund(t, n)
        assert ours.used(t) == ref.used(t)
        assert ours.budget(t) == ref.budget(t)
    assert ours.snapshot() == ref.snapshot()
    assert ours.snapshot()['refusals'] > 0
    assert ours.used('a') <= 1000


def _not_json():
    pass


def test_config_to_jsonable_equals_jax():
    kwargs = {'dataset_url': 'file:///x', 'tenant': 't', 'tenant_weight': 2.5,
              'reader_kwargs': {'workers_count': 2, 'transform_spec': _not_json},
              'odd': object()}
    with warnings.catch_warnings(record=True) as ours_warned:
        warnings.simplefilter('always')
        got = tenancy.config_to_jsonable(kwargs)
    with warnings.catch_warnings(record=True) as ref_warned:
        warnings.simplefilter('always')
        want = jax_tenancy.config_to_jsonable(kwargs)
    assert got == want == {'dataset_url': 'file:///x', 'tenant': 't', 'tenant_weight': 2.5,
                           'reader_kwargs': {'workers_count': 2}}
    assert [str(w.message) for w in ours_warned] == [str(w.message) for w in ref_warned]
    assert tenancy.config_from_jsonable(got) == jax_tenancy.config_from_jsonable(want)


# -- the dispatcher ------------------------------------------------------------

def _tenant_config(url, **overrides):
    return dict({'dataset_url': url, 'rowgroups_per_split': 2, 'num_consumers': 1,
                 'lease_ttl_s': 2.0, 'reader_kwargs': {'workers_count': 1}}, **overrides)


def test_the_dispatchers_grant_the_same_splits_as_jax(url):
    """Three tenants (weights 2, 1, 3; the last with two consumers) and one
    worker's lease calls, some with a (tenant, consumer) filter, some
    completed: the same split ids, in the same order, then the same rollups."""
    dispatchers = []
    for config_cls, cls in ((ServiceConfig, Dispatcher), (JaxServiceConfig, JaxDispatcher)):
        d = cls(config_cls(url, rowgroups_per_split=2, lease_ttl_s=2.0, tenant_weight=2.0,
                           reader_kwargs={'workers_count': 1}))
        for tenant, weight, extra in (('b', 1.0, {}), ('c', 3.0, {'num_consumers': 2})):
            reply = d._op_register_job({'tenant': tenant, 'weight': weight,
                                        'config': _tenant_config(url, **extra)})
            assert 'job' in reply, reply
        dispatchers.append(d)
    grants = []
    filters = [None, [['default', 0], ['c', 1]], [['b', 0]], None, [['c', 0], ['b', 0]]]
    for d in dispatchers:
        worker = d._op_register_worker({'data_addr': 'tcp://w:1'})['worker_id']
        seq = []
        for i in range(20):
            request = {'op': 'lease', 'worker_id': worker}
            consumers = filters[i % len(filters)]
            if consumers is not None:
                request['consumers'] = consumers
            reply = d._op_lease(request)
            split = reply.get('split')
            seq.append(None if split is None else (split['split_id'], split['tenant'],
                                                   split['consumer']))
            if split is not None and i % 3 == 0:
                d._op_complete({'worker_id': worker, 'split_id': split['split_id'],
                                'attempt': split['attempt']})
        grants.append(seq)
    assert grants[0] == grants[1]
    assert len({g[1] for g in grants[0] if g}) == 3
    ours, ref = (d._op_stats({})['tenants'] for d in dispatchers)
    assert ours == {t: {k: row[k] for k in ours[t]} for t, row in ref.items()}
    for tenant in ('b', 'c'):
        assert dispatchers[0]._op_job({'tenant': tenant})['job'] == \
            {k: v for k, v in dispatchers[1]._op_job({'tenant': tenant})['job'].items()}
    assert 'unknown tenant' in dispatchers[0]._op_job({'tenant': 'nobody'})['error']
    refusal = dispatchers[0]._op_register_job({'tenant': 'b', 'config': _tenant_config(url)})
    assert 'already registered' in refusal['error']


def test_the_single_tenant_job_reply_is_unchanged(url):
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0)
    ref = JaxServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0)
    d, jd = Dispatcher(config), JaxDispatcher(ref)
    assert d._op_job({})['job'] == config.job_info(6) == jd._op_job({})['job']
    assert [s.split_id for s in d._splits] == list(range(6))
    assert all(s.tenant == 'default' for s in d._splits)
    row = d._op_stats({})['tenants']
    assert list(row) == ['default'] and row['default']['split_base'] == 0 \
        and row['default']['deficit'] == 0.0
    worker = d._op_register_worker({'data_addr': 'tcp://w:1'})['worker_id']
    jworker = jd._op_register_worker({'data_addr': 'tcp://w:1'})['worker_id']
    for _ in range(7):
        assert d._op_lease({'worker_id': worker, 'consumers': [0]}) == \
            {k: v for k, v in jd._op_lease({'worker_id': jworker, 'consumers': [0]}).items()}


@watched(60)
def test_registration_waits_out_the_cap_then_raises(url):
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0, max_tenant_jobs=1)
    with Dispatcher(config) as dispatcher:
        with pytest.raises(ServiceError, match='still refusing'):
            register_tenant_job(dispatcher.addr, 'b', _tenant_config(url), max_wait_s=1.5)
        with pytest.raises(ServiceError, match='rejected'):
            register_tenant_job(dispatcher.addr, 'c', {'dataset_url': url, 'credits': 0})


# -- on the wire ---------------------------------------------------------------

def _jax_ids(url):
    with jax_make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                         scheduling='fifo', ingest='off') as reader:
        return sorted(int(r.id) for r in reader)


def _drain_tenants(addr, tenants, **loader_kwargs):
    """Each tenant's loader pulled on a thread of its own, at once."""
    ids, errors, loaders = {}, [], {}

    def pump(tenant):
        try:
            loaders[tenant] = ServiceDataLoader(addr, BATCH, consumer=0, tenant=tenant,
                                                drop_last=False, queue_splits=1, credits=2,
                                                device='cpu', **loader_kwargs)
            ids[tenant] = host_ids(loaders[tenant])
        except Exception as e:  # noqa: BLE001 — raised on the test's thread
            errors.append((tenant, e))
    threads = [threading.Thread(target=pump, args=(t,), daemon=True) for t in tenants]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(90)
        assert not thread.is_alive(), 'a tenant\'s delivery wedged'
    assert not errors, errors
    return ids, loaders


@watched(120)
def test_two_tenants_on_one_worker_process_get_the_jax_rows(url):
    """Tenant 'default' and tenant 'burst' (weight 3) drain one worker
    subprocess at once: each gets the JAX reader's row set, every row once,
    and the rollups count every split of both done."""
    config = ServiceConfig(url, rowgroups_per_split=2, lease_ttl_s=2.0,
                           reader_kwargs={'workers_count': 1})
    with Dispatcher(config) as dispatcher:
        worker = spawn_worker(dispatcher.addr)
        try:
            job = register_tenant_job(dispatcher.addr, 'burst', _tenant_config(url), weight=3.0)
            assert job['split_base'] == 6 and job['tenant'] == 'burst'
            wait_for(lambda: dispatcher._op_stats({})['workers'], 60, 'the worker to register')
            ids, loaders = _drain_tenants(dispatcher.addr, ('default', 'burst'))
            want = _jax_ids(url)
            assert sorted(ids['default']) == sorted(ids['burst']) == want == list(range(ROWS))
            stats = dispatcher._op_stats({})
            rows = stats['tenants']
            assert rows['default']['done'] == rows['burst']['done'] == 6
            assert rows['burst']['grants'] >= 6 and rows['default']['grants'] >= 6
            token = loaders['burst'].state_dict()['reader']['service']
            assert token['tenant'] == 'burst' and token['consumed'] == list(range(6, 12))
        finally:
            reap(worker)


@watched(90)
def test_an_over_quota_tenant_takes_the_byte_path(tmp_path):
    """Tenant 'b' has an shm quota below one chunk: its chunks all take the
    byte path and it gets the same rows as tenant 'default', whose chunks go
    through /dev/shm; the worker counts each refusal."""
    raw = write_raw(str(tmp_path / 'raw'))
    config = ServiceConfig(raw, rowgroups_per_split=2, lease_ttl_s=2.0,
                           reader_kwargs={'workers_count': 1})
    with Dispatcher(config) as dispatcher:
        worker = Worker(dispatcher.addr).start()
        try:
            register_tenant_job(dispatcher.addr, 'b',
                                _tenant_config(raw, tenant_shm_quota_bytes=1 << 10))
            ids, loaders = _drain_tenants(dispatcher.addr, ('default', 'b'))
            a, b = (loaders[t].reader.diagnostics for t in ('default', 'b'))
            wait_for(lambda: dispatcher._op_stats({})['shm']['shm_quota_degraded']
                     == b['byte_chunks'], 30, 'the worker\'s counters')
        finally:
            worker.stop()
            worker.join()
    assert sorted(ids['default']) == sorted(ids['b']) == list(range(96))
    assert a['shm_chunks'] == 6 and a['byte_chunks'] == 0, a
    assert b['shm_chunks'] == 0 and b['byte_chunks'] == 6, b

"""The port's durable dispatcher ledger (``petastorm_tpu_torch.service.ledger``
and the dispatcher's restore) against the JAX package's, on the CPU.

Against JAX: the split codec; the file through the version gate, each
package loading the other's file; the owner lock, exclusive across both
packages; and a ledger written by either package's dispatcher (two tenants,
done, leased, retried and pending splits, the cluster cache's directory)
restoring in the other's to the same split states, attempts, tenant table
and directory.  The JAX dispatcher writes its decision journal under
``decisions``; the port keeps none, writes the key empty and ignores it on
restore.  The port alone: a restart keeps done splits and attempt counts,
an orphan lease is adopted by a held claim or requeues unclaimed with its
attempt intact, another geometry cold-starts, the write-ahead journal
replays and a torn tail line is skipped, and a SIGKILLed subprocess
dispatcher restarted on its ledger finishes the epoch with every row once
and no done split decoded again.  Every wire test runs under a watchdog.
"""

import json
import os
import threading
import time

import pytest

from petastorm_tpu.service import Dispatcher as JaxDispatcher
from petastorm_tpu.service import ServiceConfig as JaxServiceConfig
from petastorm_tpu.service.ledger import DispatcherLedger as JaxLedger
from petastorm_tpu.service.ledger import LedgerHeldError as JaxLedgerHeldError
from petastorm_tpu.service.ledger import decode_splits as jax_decode_splits
from petastorm_tpu.service.ledger import encode_splits as jax_encode_splits

from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader, Worker
from petastorm_tpu_torch.service.ledger import (DispatcherLedger, LedgerHeldError,
                                                decode_splits, encode_splits)

from torch_plane_common import write_dataset
from torch_service_common import (free_tcp_addr, reap, spawn_dispatcher, wait_for, watched)

ROWS = 96     # 12 row groups of 8: 6 splits of 2
BATCH = 8


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_ledger'), rows=ROWS)


def _kwargs(url, tmp_path, **overrides):
    kwargs = dict(dataset_url=url, rowgroups_per_split=2, lease_ttl_s=2.0,
                  reader_kwargs={'workers_count': 1},
                  ledger_path=str(tmp_path / 'ledger.json'))
    kwargs.update(overrides)
    return kwargs


def _port(url, tmp_path, **overrides):
    return Dispatcher(ServiceConfig(**_kwargs(url, tmp_path, **overrides)))


def _jax(url, tmp_path, **overrides):
    return JaxDispatcher(JaxServiceConfig(**_kwargs(url, tmp_path, **overrides)))


# -- the codec, the file, the lock ---------------------------------------------

def test_the_split_codec_equals_jax(url, tmp_path):
    ours = _port(url, tmp_path, ledger_path=None)._splits
    ref = _jax(url, tmp_path, ledger_path=None)._splits
    for splits in (ours, ref):
        splits[0].state, splits[0].attempt = 'done', 0
        splits[1].state, splits[1].attempt = 'leased', 2
        splits[3].state, splits[3].attempt = 'failed', 5
    records = json.loads(json.dumps(encode_splits(ours)))
    assert records == jax_encode_splits(ref)
    assert decode_splits(records) == jax_decode_splits(records) == [
        ('done', 0), ('leased', 2), ('pending', 0), ('failed', 5), ('pending', 0),
        ('pending', 0)]
    with pytest.raises(KeyError):
        decode_splits([['z', 0]])


def test_the_file_round_trips_through_the_version_gate(tmp_path):
    path = str(tmp_path / 'l.json')
    ledger = DispatcherLedger(path).acquire()
    try:
        assert ledger.load() is None
        assert ledger.save({'fingerprint': 'f', 'splits': [['p', 0]]}) == path
        state = ledger.load()
        assert (state['kind'], state['version'], ledger.saves) == ('dispatcher_ledger', 2, 1)
        assert JaxLedger(path).load() == state    # the reference reads the port's file
        for body in ('{"kind": "other"}', 'not json',
                     '{"kind": "dispatcher_ledger", "version": 3, "splits": []}'):
            with open(path, 'w') as f:
                f.write(body)
            assert ledger.load() is None and JaxLedger(path).load() is None, body
        with open(path, 'w') as f:   # version 1 (single-tenant) still loads
            json.dump({'kind': 'dispatcher_ledger', 'version': 1, 'splits': []}, f)
        assert ledger.load()['version'] == 1
    finally:
        ledger.release()


def test_the_owner_lock_is_exclusive_across_both_packages(tmp_path):
    path = str(tmp_path / 'l.json')
    owner = DispatcherLedger(path).acquire()
    try:
        with pytest.raises(LedgerHeldError):
            DispatcherLedger(path).acquire()
        with pytest.raises(JaxLedgerHeldError):
            JaxLedger(path).acquire()
    finally:
        owner.release()
    assert not os.path.exists(path + '.owner')
    ref = JaxLedger(path).acquire()
    try:
        with pytest.raises(LedgerHeldError):
            DispatcherLedger(path).acquire()
    finally:
        ref.release()


# -- restarts ------------------------------------------------------------------

def test_a_restart_keeps_done_splits_and_attempts(url, tmp_path):
    d1 = _port(url, tmp_path, lease_ttl_s=0.3)
    w0 = d1._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    a = d1._op_lease({'worker_id': w0})['split']
    b = d1._op_lease({'worker_id': w0})['split']
    assert d1._op_complete({'worker_id': w0, 'split_id': a['split_id'], 'attempt': 0})['ok']
    time.sleep(0.4)
    d1._op_heartbeat({'worker_id': w0, 'held': []})
    d1._expire_leases()
    assert d1._splits[b['split_id']].attempt == 1
    d1._ledger_save(force=True)
    d1._ledger.release()   # its death: the flock dies with the process
    d2 = _port(url, tmp_path, lease_ttl_s=0.3)
    try:
        assert d2.ledger_restores == 1
        assert d2._splits[a['split_id']].state == 'done'
        assert d2._splits[b['split_id']].attempt == 1
        stats = d2._op_stats({})
        assert stats['done'] == 1 and stats['control_plane']['ledger_restores'] == 1
    finally:
        d2._ledger.release()


@pytest.mark.parametrize('claimed', [True, False])
def test_an_orphan_lease_is_adopted_or_requeues_with_its_attempt(url, tmp_path, claimed):
    d1 = _port(url, tmp_path, lease_ttl_s=0.3)
    w0 = d1._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    split = d1._op_lease({'worker_id': w0})['split']
    d1._splits[split['split_id']].attempt = 2
    d1._ledger_save(force=True)
    d1._ledger.release()
    d2 = _port(url, tmp_path, lease_ttl_s=0.3)
    try:
        restored = d2._splits[split['split_id']]
        assert restored.state == 'leased' and restored.worker_id is None
        if claimed:
            w1 = d2._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
            assert d2._op_heartbeat({'worker_id': w1, 'held': [split['split_id']]})['ok']
            assert (restored.worker_id, restored.attempt, d2.ledger_adoptions) == (w1, 2, 1)
            assert d2._op_complete({'worker_id': w1, 'split_id': split['split_id'],
                                    'attempt': 2})['ok']
            assert restored.state == 'done'
        else:
            time.sleep(0.4)
            d2._expire_leases()
            assert (restored.state, restored.attempt) == ('pending', 2)
            assert (d2.ledger_requeues, d2.lease_churn) == (1, 0)
    finally:
        d2._ledger.release()


def test_another_geometry_cold_starts(url, tmp_path):
    d1 = _port(url, tmp_path)
    w0 = d1._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    split = d1._op_lease({'worker_id': w0})['split']
    assert d1._op_complete({'worker_id': w0, 'split_id': split['split_id'], 'attempt': 0})['ok']
    d1._ledger_save(force=True)
    d1._ledger.release()
    d2 = _port(url, tmp_path, rowgroups_per_split=4)
    try:
        assert d2.ledger_restores == 0 and all(s.state == 'pending' for s in d2._splits)
    finally:
        d2._ledger.release()


def test_the_journal_replays_ahead_of_the_snapshot(url, tmp_path):
    d1 = _port(url, tmp_path)
    w0 = d1._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    split = d1._op_lease({'worker_id': w0})['split']
    d1._ledger_save(force=True)   # the last snapshot: still leased
    assert d1._op_complete({'worker_id': w0, 'split_id': split['split_id'], 'attempt': 0})['ok']
    journal = tmp_path / 'ledger.json.journal'
    assert journal.read_text().strip()
    d1._ledger.release()   # dies before the next snapshot
    d2 = _port(url, tmp_path)
    try:
        assert d2._splits[split['split_id']].state == 'done'
        assert journal.read_text() == ''   # the restore's snapshot absorbed it
    finally:
        d2._ledger.release()


def test_a_torn_journal_line_is_skipped(tmp_path):
    path = str(tmp_path / 'l.json')
    ledger = DispatcherLedger(path).acquire()
    try:
        ledger.save({'fingerprint': 'f', 'splits': [['p', 0], ['p', 0]]})
        assert ledger.append({'op': 'done', 'split': 0})
        with open(path + '.journal', 'a') as f:
            f.write('{"op": "done", "spl')
        assert ledger.journal_lines() == 2
        state = ledger.load()
        assert state['splits'] == [['d', 0], ['p', 0]]
        assert JaxLedger(path).load()['splits'] == state['splits']
    finally:
        ledger.release()


# -- across the packages -------------------------------------------------------

def _history(d, plane_dir):
    """Two tenants and a worker's history: leases, completions, an expiry,
    a worker's digests."""
    reply = d._op_register_job({'tenant': 'burst', 'weight': 3.0, 'config': dict(
        dataset_url=d._config.dataset_url, rowgroups_per_split=4, lease_ttl_s=2.0,
        reader_kwargs={'workers_count': 1})})
    assert reply['job']['split_base'] == 6, reply
    w0 = d._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    d._op_heartbeat({'worker_id': w0, 'cache_digests': ['aa', 'bb']})
    leased = [d._op_lease({'worker_id': w0})['split'] for _ in range(6)]
    for split in leased[:3]:
        assert d._op_complete({'worker_id': w0, 'split_id': split['split_id'],
                               'attempt': split['attempt']})['ok']
    with d._lock:
        d._splits[leased[3]['split_id']].lease_expires = 0.0
    d._expire_leases()   # attempt 1, back to pending
    d._ledger_save(force=True)
    d._ledger.release()


def _restored(d):
    return {'splits': [(s.split_id, s.tenant, s.state, s.attempt, s.worker_id)
                       for s in d._splits],
            'tenants': [(j.tenant, j.weight, j.split_base, j.num_splits, j.num_pieces,
                         [s.split_id for s in j.pending]) for j in d._tenants.jobs()],
            'digests': dict(d._ledger_digests_by_addr), 'restores': d.ledger_restores}


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_a_ledger_restores_across_the_packages(url, tmp_path, direction):
    """One side's dispatcher writes the ledger; the other's restores it to
    the same split states, attempts, tenant table (the burst tenant at base
    6, weight 3) and directory as the writer's own restore."""
    plane = str(tmp_path / 'plane')
    extra = dict(cache_plane=True, cache_plane_dir=plane)
    writer, reader = (_jax, _port) if direction == 'jax_to_port' else (_port, _jax)
    _history(writer(url, tmp_path, **extra), plane)
    state = JaxLedger(str(tmp_path / 'ledger.json')).load()
    assert 'decisions' in state
    if direction == 'port_to_jax':
        assert state['decisions'] == {}
    restored = {}
    for name, factory in (('reader', reader), ('writer', writer)):
        d = factory(url, tmp_path, **extra)
        restored[name] = _restored(d)
        d._ledger.release()
    got, want = restored['reader'], restored['writer']
    assert got['splits'] == want['splits']
    assert got['tenants'] == want['tenants']
    assert got['digests'] == {'tcp://x:1': {'aa', 'bb'}}
    states = [s[2] for s in got['splits']]
    assert states.count('done') == 3 and states.count('leased') == 2
    assert [s[3] for s in got['splits']].count(1) == 1
    assert [t[0] for t in got['tenants']] == ['default', 'burst']
    assert got['restores'] == 1 and want['restores'] == 2


# -- a dispatcher killed mid-epoch ----------------------------------------------

@watched(150)
def test_a_sigkilled_dispatcher_restarted_on_its_ledger_finishes_the_epoch(url, tmp_path):
    """A dispatcher subprocess on a fixed address, SIGKILLed once the client
    holds some splits, restarted on the same address and ledger: the epoch
    ends with every row once, and no split done before the kill (as the
    ledger recorded it) is decoded again."""
    addr = free_tcp_addr()
    kwargs = _kwargs(url, tmp_path)
    proc = spawn_dispatcher(addr, kwargs)
    worker = Worker(addr).start()
    decoded, lock = [], threading.Lock()
    decode_split = worker._decode_split

    def recording(job, split, decode_out):
        with lock:
            decoded.append((split['split_id'], time.monotonic()))
        return decode_split(job, split, decode_out)
    worker._decode_split = recording
    restarted = None
    try:
        loader = ServiceDataLoader(addr, BATCH, consumer=0, drop_last=False, queue_splits=1,
                                   credits=2, rpc_timeout_s=2.0, device='cpu')
        ids = []
        with loader:
            batches = loader.iter_host_batches()
            for _ in range(4):   # two splits' rows
                ids.extend(next(batches)['id'].tolist())
            wait_for(lambda: 'd' in [c for c, _ in JaxLedger(kwargs['ledger_path']).load()
                                     ['splits']], 30, 'a split recorded done')
            proc.kill()
            proc.wait(timeout=30)
            t_kill = time.monotonic()
            done_before = {i for i, (code, _) in enumerate(
                DispatcherLedger(kwargs['ledger_path']).load()['splits']) if code == 'd'}
            restarted = spawn_dispatcher(addr, kwargs)
            for batch in batches:
                ids.extend(batch['id'].tolist())
        assert sorted(ids) == list(range(ROWS))
        redecoded = sorted(i for i, t in decoded if t > t_kill and i in done_before)
        assert done_before and not redecoded, (done_before, redecoded)
        final = DispatcherLedger(kwargs['ledger_path']).load()
        assert final['restores'] == 1
        assert 'f' not in [code for code, _ in final['splits']]
    finally:
        worker.stop()
        worker.join()
        reap(proc, restarted)

"""The port's cluster cache (``petastorm_tpu_torch.service.cluster`` and its
wiring in the dispatcher and the worker) against the JAX package's, on the
CPU.

Against JAX: ``ClusterCacheIdentity``'s digests are a real port reader's
plane digests and JAX's identity's, on a petastorm store and on plain
Parquet, and serving them gives the reader's chunks; the two dispatchers
route the same leases under the same directory.  The port alone: affinity
prefers the holder and keeps a held split back from a cold worker only
within its bound; an expired lease goes to the first worker that asks;
without a directory (or under the kill switch) leasing is plain FIFO; a peer
fetch round-trips an entry, reports a missing one and times out on a dead
peer; a warm worker serves its splits from its plane while a cold joiner
fetches from it, with no miss; and a peer SIGKILLed before the joiner's
fetches costs a bounded timeout each, after which the split decodes.  The
tests wait on counters with deadlines, never on sleeps; every wire test
runs under a watchdog.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import zmq

from petastorm_tpu.service import Dispatcher as JaxDispatcher
from petastorm_tpu.service import ServiceConfig as JaxServiceConfig
from petastorm_tpu.service import cluster as jax_cluster

from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch.cache_plane import CachePlane
from petastorm_tpu_torch.cache_plane.plane import encode_entry
from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader, Worker
from petastorm_tpu_torch.service import cluster
from petastorm_tpu_torch.service import dispatcher as dispatcher_mod
from petastorm_tpu_torch.workers_pool import shm_plane

from torch_plane_common import write_dataset
from torch_service_common import (drop_hot_tiers, host_ids, reap, spawn_worker, wait_for, watched,
                                  write_raw)

ROWS = 64          # 8 row groups of 8: 4 splits of 2
PIECES = 8


@pytest.fixture(autouse=True)
def _no_hot_tier_left(tmp_path):
    yield
    drop_hot_tiers(tmp_path)


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_cluster'), rows=ROWS)


def _kwargs(url, plane_dir, **overrides):
    kwargs = dict(rowgroups_per_split=2, lease_ttl_s=2.0, reader_kwargs={'workers_count': 1},
                  cache_plane=True, cache_plane_dir=plane_dir)
    kwargs.update(overrides)
    return kwargs


def _job(cls, url, plane_dir, **overrides):
    return cls(url, **_kwargs(url, plane_dir, **overrides)).job_info(PIECES // 2)


# -- the identity --------------------------------------------------------------

@pytest.mark.parametrize('store', ['petastorm', 'plain'])
def test_identity_digests_equal_a_real_reader_and_jax(url, tmp_path, store):
    plane_dir = str(tmp_path / 'plane')
    data = url if store == 'petastorm' else write_raw(str(tmp_path / 'raw'), rows=64, group=8)
    identity = cluster.ClusterCacheIdentity.build(_job(ServiceConfig, data, plane_dir))
    ref = jax_cluster.ClusterCacheIdentity.build(_job(JaxServiceConfig, data, plane_dir))
    assert identity is not None and identity.num_pieces == ref.num_pieces == PIECES
    assert identity.kind == ('columns' if store == 'petastorm' else 'batch')
    assert identity.split_digests(range(PIECES)) == ref.split_digests(range(PIECES))
    assert identity.piece_cdigests() == ref.piece_cdigests()
    indices = [0, 1, 2]
    assert len(identity.missing_digests(indices)) == 3 and identity.serve_chunks(indices) is None
    factory = make_reader if store == 'petastorm' else make_batch_reader
    extra = dict(columnar_decode=True) if store == 'petastorm' else {}
    with factory(data, piece_indices=indices, shuffle_row_groups=False, workers_count=1,
                 cache_type='plane', cache_location=plane_dir, **extra) as reader:
        expected = [item._asdict() for item in reader]
    assert identity.missing_digests(indices) == []
    served = identity.serve_chunks(indices)
    assert len(served) == len(expected) == 3
    for got, want in zip(served, expected):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def test_the_kill_switch_and_unsupported_arguments_turn_it_off(url, tmp_path, monkeypatch):
    job = _job(ServiceConfig, url, str(tmp_path / 'p'))
    assert cluster.enabled(job)
    assert cluster.ClusterCacheIdentity.build(
        dict(job, reader_kwargs={'filters': [('id', '<', 4)]})) is None
    monkeypatch.setenv(cluster.KILL_ENV, '1')
    assert not cluster.enabled(job) and not jax_cluster.enabled(job)
    assert not Dispatcher(ServiceConfig(url, **_kwargs(url, str(tmp_path / 'p'))))._cluster_on


# -- lease routing -------------------------------------------------------------

def _fake_fleet(config_cls, dispatcher_cls, url, plane_dir):
    """A dispatcher and two workers: w0 holds every piece, w1 none."""
    d = dispatcher_cls(config_cls(url, **_kwargs(url, plane_dir)), num_pieces=PIECES)
    w0 = d._op_register_worker({'data_addr': 'tcp://127.0.0.1:4441'})['worker_id']
    w1 = d._op_register_worker({'data_addr': 'tcp://127.0.0.1:4442'})['worker_id']
    digests = ['d%011d' % i for i in range(PIECES)]
    d._op_heartbeat({'worker_id': w0, 'piece_digests': digests, 'cache_digests': digests})
    d._op_heartbeat({'worker_id': w1, 'cache_digests': []})
    return d, w0, w1


def _lapse(d):
    for split in d._splits:
        if split.affinity_defer_until is not None:
            split.affinity_defer_until = time.monotonic() - 0.01


def test_affinity_prefers_the_holder_and_defers_within_its_bound(url, tmp_path):
    replies = []
    for config_cls, dispatcher_cls in ((ServiceConfig, Dispatcher),
                                       (JaxServiceConfig, JaxDispatcher)):
        d, w0, w1 = _fake_fleet(config_cls, dispatcher_cls, url, str(tmp_path / 'p'))
        t0 = time.monotonic()
        first = d._op_lease({'worker_id': w1})      # cold and first: kept waiting
        window = max(s.affinity_defer_until or 0 for s in d._splits) - t0
        warm = d._op_lease({'worker_id': w0})       # the holder gets its split
        _lapse(d)
        late = d._op_lease({'worker_id': w1})       # past the window: granted, with hints
        replies.append((first, warm, late, d.affinity_routed, d.affinity_deferrals))
        assert first == {'wait': True} and d.affinity_deferrals == 1
        assert warm['split']['split_id'] == 0 and 'holders' not in warm
        assert 0 < window <= min(dispatcher_mod._AFFINITY_DEFER_S, 2.0 / 5.0) + 0.05
        assert late['split']['split_id'] == 1
        assert all(a == ['tcp://127.0.0.1:4441'] for a in late['holders'].values())
    assert replies[0] == replies[1]


def test_an_expired_lease_goes_to_the_first_worker_without_deferral(url, tmp_path):
    d, w0, w1 = _fake_fleet(ServiceConfig, Dispatcher, url, str(tmp_path / 'p'))
    split_id = d._op_lease({'worker_id': w0})['split']['split_id']
    split = d._splits[split_id]
    split.lease_expires = time.monotonic() - 1.0
    d._expire_leases()
    assert (split.state, split.attempt) == ('pending', 1)
    reply = d._op_lease({'worker_id': w1})
    assert reply['split']['split_id'] == split_id and reply.get('holders')
    assert d.affinity_deferrals == 0


def test_without_a_directory_leasing_is_plain_fifo(url, tmp_path):
    for kwargs in ({}, {'cluster_cache': False}):
        d = Dispatcher(ServiceConfig(url, **_kwargs(url, str(tmp_path / 'p'), **kwargs)),
                       num_pieces=PIECES)
        w0 = d._op_register_worker({'data_addr': 'tcp://127.0.0.1:4443'})['worker_id']
        granted = [d._op_lease({'worker_id': w0}) for _ in range(3)]
        assert [g['split']['split_id'] for g in granted] == [0, 1, 2]
        assert not any('holders' in g for g in granted)
        assert (d.affinity_routed, d.affinity_deferrals) == (0, 0)


# -- peer fetch ----------------------------------------------------------------

def _peer(plane, stop, addrs):
    """A bare peer: a ROUTER answering fetches with ``fetch_reply``."""
    context = zmq.Context()
    sock = context.socket(zmq.ROUTER)
    sock.setsockopt(zmq.LINGER, 0)
    addrs.append('tcp://127.0.0.1:%d' % sock.bind_to_random_port('tcp://127.0.0.1'))
    try:
        while not stop.is_set():
            if sock.poll(50):
                identity, raw = sock.recv_multipart()
                sock.send_multipart(cluster.fetch_reply(identity, pickle.loads(raw), plane))
    finally:
        sock.close(0)
        context.term()


@watched(60)
def test_a_peer_fetch_round_trips_reports_missing_and_times_out(tmp_path):
    plane = CachePlane(str(tmp_path / 'p'), ram_capacity_bytes=0)
    blob = bytes(encode_entry({'x': np.arange(32)}))
    digest = plane.digest('probe-key')
    assert plane.publish_blob(digest, blob) and plane.entry_blob(digest) == blob
    stop, addrs = threading.Event(), []
    peer = threading.Thread(target=_peer, args=(plane, stop, addrs), daemon=True)
    peer.start()
    wait_for(lambda: addrs, 30, 'the peer to bind')
    context = zmq.Context()
    fetcher = cluster.PeerFetcher(context, timeout_s=5.0)
    dead = cluster.PeerFetcher(context, timeout_s=0.3)
    try:
        assert fetcher.fetch(addrs[0], digest) == blob
        assert fetcher.fetch(addrs[0], 'f' * 32) is None
        t0 = time.monotonic()
        assert dead.fetch('tcp://127.0.0.1:1', 'a' * 32) is None
        assert time.monotonic() - t0 < 3.0
    finally:
        fetcher.close()
        dead.close()
        stop.set()
        peer.join(5)
        context.term()


# -- on the wire ---------------------------------------------------------------

def _stats(dispatcher):
    return dispatcher._op_stats({})


def _primed(dispatcher, digests=PIECES):
    rollup = _stats(dispatcher)['cluster_cache']
    return rollup['piece_map'] and rollup['directory_digests'] >= digests


def _epoch(url, shared_dir, worker_dirs, wait_primed=False):
    """One epoch of a fleet of in-process workers (each over its plane),
    once every worker's identity resolved (and, asked, once the directory
    holds every piece); the rows and each worker's counters."""
    config = ServiceConfig(url, **_kwargs(url, shared_dir))
    with Dispatcher(config) as dispatcher:
        workers = [Worker(dispatcher.addr, cache_plane_dir=p).start() for p in worker_dirs]
        try:
            for w in workers:
                wait_for(lambda w=w: w._cluster is not None and w._cluster.wait_ready(0.1),
                         30, 'a worker\'s cluster identity')
            if wait_primed:
                wait_for(lambda: _primed(dispatcher), 30, 'the directory')
            ids = host_ids(ServiceDataLoader(dispatcher.addr, 8, consumer=0, drop_last=False,
                                             device='cpu'))
            diags = [w.diagnostics for w in workers]
        finally:
            for w in workers:
                w.stop()
            for w in workers:
                w.join()
    return ids, diags


@watched(120)
def test_a_warm_worker_serves_hits_while_a_cold_joiner_fetches(url, tmp_path, monkeypatch):
    plane_a, plane_b = str(tmp_path / 'planeA'), str(tmp_path / 'planeB')
    ids, diags = _epoch(url, plane_a, [plane_a])
    assert sorted(ids) == list(range(ROWS)) and diags[0]['cache_misses'] == PIECES
    # the window zeroed: the cold joiner takes held splits at once and fills
    monkeypatch.setattr(dispatcher_mod, '_AFFINITY_DEFER_S', 0.0)
    ids, diags = _epoch(url, plane_a, [plane_b, plane_a], wait_primed=True)
    assert sorted(ids) == list(range(ROWS))
    total = {key: sum(d[key] for d in diags)
             for key in ('cache_remote_hits', 'cache_peer_fills', 'cache_peer_degraded',
                         'cache_misses', 'splits_decoded')}
    assert total['cache_misses'] == 0 and total['cache_peer_degraded'] == 0
    assert total['cache_remote_hits'] == PIECES and total['splits_decoded'] == PIECES // 2
    b = diags[0]
    assert b['cache_peer_fills'] == 2 * b['splits_decoded']
    if b['splits_decoded']:
        assert any(name.endswith('.cpe') for name in os.listdir(plane_b))


@watched(150)
def test_a_peer_sigkilled_before_the_fetch_degrades_to_a_decode(url, tmp_path, monkeypatch):
    plane_a, plane_b = str(tmp_path / 'planeA'), str(tmp_path / 'planeB')
    ids, _ = _epoch(url, plane_a, [plane_a])
    assert sorted(ids) == list(range(ROWS))
    monkeypatch.setattr(cluster, 'FETCH_TIMEOUT_S', 0.3)
    config = ServiceConfig(url, **_kwargs(url, plane_a))
    with Dispatcher(config) as dispatcher:
        holder = spawn_worker(dispatcher.addr, cache_plane_dir=plane_a)
        try:
            wait_for(lambda: _primed(dispatcher), 60, 'the holder\'s advertisement')
            joiner = Worker(dispatcher.addr, cache_plane_dir=plane_b).start()
            try:
                assert joiner._cluster.wait_ready(30)
                # the directory names the holder for 3 TTLs after its death
                holder.kill()
                holder.wait(timeout=30)
                ids = host_ids(ServiceDataLoader(dispatcher.addr, 8, consumer=0,
                                                 drop_last=False, device='cpu'))
                diag = joiner.diagnostics
            finally:
                joiner.stop()
                joiner.join()
        finally:
            reap(holder)
    assert sorted(ids) == list(range(ROWS))
    assert diag['cache_peer_degraded'] > 0 and diag['cache_peer_fills'] == 0
    assert diag['cache_misses'] > 0
    assert shm_plane.residue([holder.pid, os.getpid()]) == set()
    assert not [n for n in os.listdir(plane_b) if n.startswith('.tmp.')]

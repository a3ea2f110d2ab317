"""The port's autoscaler (``petastorm_tpu_torch.service.autoscaler``) against
the JAX package's, on the CPU, and on a dispatcher.

The same observations on an injected clock, given to the port's and the JAX
``Autoscaler`` with recording launchers: the same actions, launcher calls,
counters, snapshots and decision records, over starvation, idleness, the
cooldown, the min and max clamps, a failing spawn and the kill switch.  Then
a dispatcher with ``autoscale=True`` and a launcher that starts in-thread
port workers: it scales out while one worker with one lease slot starves,
delivers every row once, and when the fleet idles drains the worker with the
least cache coverage, down to the minimum.
"""

import threading
import time

import pytest

from petastorm_tpu.service import ServiceConfig as JaxServiceConfig
from petastorm_tpu.service import autoscaler as jax_autoscaler
from petastorm_tpu.telemetry import decisions as jax_decisions

from petastorm_tpu_torch.service import Dispatcher, ServiceConfig, ServiceDataLoader, Worker
from petastorm_tpu_torch.service import autoscaler
from petastorm_tpu_torch.telemetry import decisions

from torch_plane_common import write_dataset
from torch_service_common import wait_for, watched

ROWS = 192    # 24 row groups of 8: 24 splits of 1
BATCH = 8


def _launcher(base, fail_after=None):
    class Recording(base):
        def __init__(self):
            self.calls = []

        def spawn(self, dispatcher_addr):
            if fail_after is not None and \
                    len([c for c in self.calls if c[0] == 'spawn']) >= fail_after:
                self.calls.append(('spawn_failed', dispatcher_addr))
                raise OSError('no more workers')
            self.calls.append(('spawn', dispatcher_addr))
            return len(self.calls)

        def notify_drain(self, worker_id):
            self.calls.append(('drain', worker_id))

        def close(self):
            self.calls.append(('close',))
    return Recording()


_STARVING = {'pending': 4, 'leased': 2, 'alive': ['w0'], 'free_slots': 0, 'coverage': {},
             'dispatcher_addr': 'tcp://x:1'}
_IDLE = {'pending': 0, 'leased': 0, 'alive': ['w0', 'w1', 'w2'], 'free_slots': 9,
         'coverage': {'w0': 5, 'w1': 0, 'w2': 2}, 'dispatcher_addr': 'tcp://x:1'}
_BUSY = dict(_STARVING, free_slots=2)


def _ticks(*parts):
    """(observation, now) pairs: each part a (observation, [times]) pair."""
    return [(obs, t) for obs, times in parts for t in times]


#: name -> (config overrides, ticks, fail spawns after, kill switch)
CASES = {
    'starvation': ({}, _ticks((_STARVING, [0.0, 0.5, 1.0, 2.5, 3.0]), (_BUSY, [4.0]),
                              (_STARVING, [5.0, 9.0])), None, False),
    'idleness': ({}, _ticks((_IDLE, [0.0, 5.0, 10.5, 12.0, 16.0, 30.0]),
                            (dict(_IDLE, alive=['w0', 'w2']), [41.0, 52.0])), None, False),
    'cooldown': ({'autoscale_cooldown_s': 20.0},
                 _ticks((_STARVING, [0.0, 2.5, 4.0, 6.5, 10.0]), (_IDLE, [12.0, 23.0, 30.0]),
                        (_STARVING, [31.0, 34.0, 44.0])), None, False),
    'max_clamp': ({'autoscale_max_workers': 2},
                  _ticks((dict(_STARVING, alive=['w0', 'w1']), [0.0, 3.0, 7.0]),
                         (_STARVING, [8.0, 11.0, 14.0])), None, False),
    'min_clamp': ({'autoscale_min_workers': 2},
                  _ticks((_IDLE, [0.0, 11.0, 17.0]), (dict(_IDLE, alive=['w0', 'w2']),
                                                      [30.0, 45.0, 60.0])), None, False),
    'failing_spawn': ({}, _ticks((_STARVING, [0.0, 2.5, 8.0, 11.0, 17.0])), 1, False),
    'kill_switch': ({}, _ticks((_STARVING, [0.0, 2.5, 9.0]), (_IDLE, [20.0, 40.0])), None,
                    True),
}


def _config(cls, **overrides):
    kwargs = dict(dataset_url='file:///dev/null', autoscale=True, autoscale_min_workers=1,
                  autoscale_max_workers=4, autoscale_step=2, autoscale_cooldown_s=5.0,
                  autoscale_starve_s=2.0, autoscale_idle_s=10.0)
    kwargs.update(overrides)
    return cls(**kwargs)


def _stable(record):
    return {k: v for k, v in record.items() if k not in ('t_mono', 'unix_time')}


@pytest.mark.parametrize('case', sorted(CASES))
def test_the_action_stream_equals_jax(case, monkeypatch):
    overrides, ticks, fail_after, kill = CASES[case]
    if kill:
        monkeypatch.setenv(autoscaler.KILL_SWITCH, '1')
    runs = []
    for mod, config_cls, journal_cls in (
            (autoscaler, ServiceConfig, decisions.DecisionJournal),
            (jax_autoscaler, JaxServiceConfig, jax_decisions.DecisionJournal)):
        launcher = _launcher(mod.WorkerLauncher, fail_after)
        scaler = mod.Autoscaler(_config(config_cls, **overrides), launcher, now=0.0)
        scaler.decisions = journal_cls(label='dispatcher')
        actions = [scaler.maybe_tick(obs, now=now) for obs, now in ticks]
        scaler.close()
        runs.append({'actions': actions, 'calls': launcher.calls,
                     'snapshot': scaler.snapshot(), 'last_action_t': scaler.last_action_t,
                     'records': [_stable(r) for r in scaler.decisions.records()]})
    ours, ref = runs
    assert ours == ref
    acted = [a for a in ours['actions'] if a]
    if case == 'kill_switch':
        assert not acted and ours['snapshot']['killed'] and not ours['snapshot']['enabled']
        assert ours['records'] == []
    elif case in ('starvation', 'idleness', 'failing_spawn'):
        assert acted, ours
    if case in ('cooldown', 'max_clamp'):
        assert ours['snapshot']['suppressed'] >= 1
    if case == 'idleness':
        assert acted[0] == ('scale_in', 'w1')   # the least coverage
    if case == 'failing_spawn':
        assert ('spawn_failed', 'tcp://x:1') in ours['calls']
    for record in ours['records']:
        assert decisions.replay_decision(record)['verdict'] == 'match', record


# -- on a dispatcher -------------------------------------------------------------

class _ThreadLauncher(autoscaler.WorkerLauncher):
    """Starts port workers on threads of this process, one lease slot each.
    A spawn does not wait for the registration: the dispatcher's thread
    calls it, and serves the registration after."""

    def __init__(self):
        self.workers, self.drains = [], []

    def spawn(self, dispatcher_addr):
        worker = Worker(dispatcher_addr, max_inflight_splits=1)
        worker._thread = threading.Thread(target=worker.run, daemon=True)
        worker._thread.start()
        self.workers.append(worker)
        return len(self.workers)

    def notify_drain(self, worker_id):
        self.drains.append(worker_id)

    def close(self):
        for worker in self.workers:
            worker.stop()
        for worker in self.workers:
            worker.join()


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_autoscaler'), rows=ROWS)


@watched(90)
def test_a_dispatcher_scales_out_on_starvation_and_drains_the_least_covered(url):
    launcher = _ThreadLauncher()
    config = ServiceConfig(url, rowgroups_per_split=1, lease_ttl_s=1.5, max_inflight_splits=1,
                           reader_kwargs={'workers_count': 1}, autoscale=True,
                           autoscale_min_workers=1, autoscale_max_workers=3, autoscale_step=1,
                           autoscale_cooldown_s=0.5, autoscale_starve_s=0.3,
                           autoscale_idle_s=1.0)
    alive_during = []
    with Dispatcher(config, launcher=launcher) as dispatcher:
        first = Worker(dispatcher.addr, max_inflight_splits=1).start()
        try:
            loader = ServiceDataLoader(dispatcher.addr, BATCH, consumer=0, device='cpu',
                                       queue_splits=1, credits=1)
            ids = []
            with loader:
                for batch in loader.iter_host_batches():
                    ids.extend(batch['id'].tolist())
                    alive_during.append(len(dispatcher._op_workers({})['workers']))
                    time.sleep(0.3)   # a slow consumer: the one lease slot starves
            assert sorted(ids) == list(range(ROWS))
            snap = dispatcher._op_stats({})['autoscale']
            assert snap['scale_outs'] >= 1 and snap['enabled'], snap
            assert max(alive_during) >= 2
            # the first worker holds cache digests: an idle fleet drains the
            # others first
            with dispatcher._lock:
                dispatcher._worker_digests[first.worker_id] = {'aa', 'bb'}
            wait_for(lambda: dispatcher.autoscaler.scale_ins >= 1, 30, 'a scale-in')
            assert launcher.drains[0] != first.worker_id
            wait_for(lambda: len(dispatcher._op_workers({})['workers']) == 1, 30,
                     'the fleet drained to its minimum')
            assert [w['worker_id'] for w in dispatcher._op_workers({})['workers']] == \
                [first.worker_id]
            records = dispatcher._op_decisions({})['journal']['records']
            autoscale = [r for r in records if r['actor'] == 'autoscaler' and not r['suppressed']]
            assert {r['action'] for r in autoscale} == {'scale_out', 'scale_in'}
            assert all(decisions.replay_decision(r)['verdict'] == 'match' for r in autoscale)
            stats = dispatcher._op_stats({})
            assert stats['decisions']['autoscaler']['actions'] == len(autoscale)
        finally:
            first.stop()
            first.join()
    # the dispatcher's exit closed the launcher: every worker it spawned ended
    assert all(not (w._thread and w._thread.is_alive()) for w in launcher.workers)
    assert all(w.drained for w in launcher.workers)

"""The port's chaos plane (``petastorm_tpu_torch.test_util.chaos``) against the
JAX package's, on the CPU.

Against JAX: the seam registry and the scenario catalogue; ``ChaosState``
fires the same sequence of actions for the same spec and salt, per seam and
action; an ``error`` action outside the error seams, or an unknown action,
is refused by both; the flaky filesystems fail the same opens and reads;
``make_chaos_dataset`` writes the same store, and ``DeliveryDigest`` and
``direct_read_digest`` give the same digests on it.  End to end through the
port's runner at its default store, each under a watchdog: ``autoscale_storm``
(this port's autoscaler, its actions within the damping bound),
``message_dup`` (the ``worker.chunk`` seam, at least one injection) and
``fetch_latency_spike`` (the cold-store emulation under every split reader,
its reads slowed), every invariant true; ``materialize_kill`` through
``run_matrix``, the controller killed and resumed.
The kills of the runner go by phases read from the dispatcher, never by
sleeps; ``message_drop`` runs on the card's host (``chip_smoke.py``).
"""

import json
import os
import pickle

import numpy as np
# on this thread: pyarrow.parquet imported first on a watched test's thread,
# which then exits, leaves later row-group reads of the process to crash
import pyarrow.parquet  # noqa: F401
import pytest

from petastorm_tpu.test_util import chaos as jax_chaos

from petastorm_tpu_torch.test_util import chaos

from torch_service_common import watched


def test_the_catalogue_equals_jax():
    assert chaos.SEAMS == jax_chaos.SEAMS
    assert chaos._ACTIONS == jax_chaos._ACTIONS and chaos._ERROR_SEAMS == jax_chaos._ERROR_SEAMS

    def specs(catalogue):   # the summaries are prose
        return {name: {k: v for k, v in scenario.items() if k != 'summary'}
                for name, scenario in catalogue.items()}
    assert specs(chaos.SCENARIOS) == specs(jax_chaos.SCENARIOS)
    assert chaos.SMOKE_SCENARIOS == jax_chaos.SMOKE_SCENARIOS
    assert chaos.PHASES == jax_chaos.PHASES
    assert (chaos.CHAOS_ENV, chaos.CHAOS_SALT_ENV, chaos.CHAOS_COUNTS_ENV) == \
        (jax_chaos.CHAOS_ENV, jax_chaos.CHAOS_SALT_ENV, jax_chaos.CHAOS_COUNTS_ENV)
    assert chaos.ported_scenarios() == list(jax_chaos.SCENARIOS)


_CASES = [(seam, action) for seam in chaos.SEAMS for action in ('drop', 'dup', 'delay', 'error')
          if action != 'error' or seam in chaos._ERROR_SEAMS]


@pytest.mark.parametrize('seam,action', _CASES)
@pytest.mark.parametrize('salt', [0, 3])
def test_fire_gives_jax_s_sequence(seam, action, salt):
    """A seeded spec of two faults at one seam (one limited to some ops, one
    with a budget), fired 200 times with seeded contexts: the same action or
    exception each time, and the same counts."""
    spec = {'seed': 11, 'faults': [
        {'seam': seam, 'action': action, 'p': 0.3, 'ops': ['lease', 'heartbeat'],
         'delay_s': 0.0},
        {'seam': seam, 'action': 'drop' if action != 'drop' else 'dup', 'p': 0.2, 'max': 7}]}
    ours, ref = chaos.ChaosState(spec, salt=salt), jax_chaos.ChaosState(spec, salt=salt)
    rng = np.random.default_rng(salt)
    ops = ('lease', 'heartbeat', 'workers', 'complete')
    seq = []
    for _ in range(200):
        ctx = {'op': ops[int(rng.integers(len(ops)))]}
        fired = []
        for state, error in ((ours, chaos.ChaosInjectedError),
                             (ref, jax_chaos.ChaosInjectedError)):
            try:
                fired.append(state.fire(seam, dict(ctx)))
            except error:
                fired.append('raised')
        assert fired[0] == fired[1], (ctx, fired)
        seq.append(fired[0])
    assert ours.counts == ref.counts and ours.fired() == ref.fired() > 0
    assert ours.fire('no.such.seam', {}) is None
    assert len(set(seq)) >= 2


def test_error_outside_the_error_seams_and_unknown_actions_are_refused():
    for module in (chaos, jax_chaos):
        for seam in ('rpc.request', 'dispatcher.rpc', 'worker.chunk'):
            with pytest.raises(ValueError, match='only injectable'):
                module.ChaosState({'faults': [{'seam': seam, 'action': 'error'}]})
        with pytest.raises(ValueError, match='action must be one of'):
            module.ChaosState({'faults': [{'seam': 'worker.chunk', 'action': 'explode'}]})


def test_activate_inject_and_the_counts_dump(tmp_path, monkeypatch):
    assert chaos.active() is None and chaos.inject('worker.chunk') is None
    monkeypatch.setenv(chaos.CHAOS_SALT_ENV, '5')
    state = chaos.activate({'seed': 1, 'faults': [{'seam': 'worker.chunk', 'action': 'dup'}]})
    try:
        assert chaos.active() is state and state.rng.random() == \
            jax_chaos.ChaosState({'seed': 1}, salt=5).rng.random()
        assert chaos.inject('worker.chunk', split=1) == 'dup'
        state.dump_counts(str(tmp_path / 'counts'))
    finally:
        chaos.deactivate()
    assert chaos.inject('worker.chunk') is None
    with open(str(tmp_path / ('counts.%d.json' % os.getpid()))) as f:
        assert json.load(f) == {'worker.chunk/dup': 1}


class _Opener(object):
    def __init__(self):
        self.opened = []

    def open(self, path, *args, **kwargs):
        self.opened.append(path)
        return _Reads()

    def exists(self, path):
        return True


class _Reads(object):
    def read(self, *args):
        return b'x'


def test_the_flaky_filesystems_fail_as_jax_s():
    for kind in ('flaky_open', 'flaky_read'):
        outcomes = []
        for module in (chaos, jax_chaos):
            fs = module.FILESYSTEM_FAULTS[kind](_Opener(), fail_times=2)
            fs = pickle.loads(pickle.dumps(fs))   # rides make_reader's pickling
            seen = []
            for path in ('/d/part-0.parquet', '/d/_common_metadata', '/d/part-0.parquet',
                         '/d/part-0.parquet', '/d/part-1.parquet'):
                try:
                    seen.append(fs.open(path).read())
                except OSError:
                    seen.append('failed')
            outcomes.append((seen, fs.exists('/d')))
        assert outcomes[0] == outcomes[1]
        assert outcomes[0][0].count('failed') == 3
    assert [chaos.is_data_file(p) for p in ('a/x.parquet', 'a/_x.parquet', 'a/x.json')] == \
        [True, False, False]


def test_the_digests_equal_jax(tmp_path):
    url, rows = chaos.make_chaos_dataset(str(tmp_path / 'port'), rows=40, seed=3)
    jax_url, jax_rows = jax_chaos.make_chaos_dataset(str(tmp_path / 'jax'), rows=40, seed=3)
    with open(url[len('file://'):] + '/data.parquet', 'rb') as a, \
            open(jax_url[len('file://'):] + '/data.parquet', 'rb') as b:
        assert a.read() == b.read()
    assert rows == jax_rows == 40
    want = jax_chaos.direct_read_digest(jax_url)
    assert chaos.direct_read_digest(url) == want
    rng = np.random.default_rng(0)
    chunks = [{'id': np.arange(i, i + 8, dtype=np.int64),
               'payload': rng.integers(0, 255, (8, 16), dtype=np.uint8)} for i in range(0, 40, 8)]
    ours, ref = chaos.DeliveryDigest(), jax_chaos.DeliveryDigest()
    for chunk in chunks[::-1]:
        ours.update(chunk)
    for chunk in chunks:
        ref.update(chunk)
    assert ours.hexdigest() == ref.hexdigest() and ours.rows == 40


@pytest.mark.parametrize('name', ['autoscale_storm', 'message_dup', 'fetch_latency_spike'])
@watched(150)
def test_a_scenario_end_to_end_keeps_every_invariant(name, tmp_path):
    url, rows = chaos.make_chaos_dataset(str(tmp_path / 'dataset'))
    report = chaos.run_scenario(name, url, rows, str(tmp_path))
    assert report['ok'], chaos.render_report([report])
    checks = report['checks']
    assert checks['exactly_once'] == checks['digest'] == checks['zero_residue'] == 'ok'
    if name == 'autoscale_storm':
        # whether a short epoch starves over two of the law's 1 Hz ticks is
        # timing: the scenario's invariant is the damping bound
        auto = report['autoscale']
        assert auto['actions'] <= auto['bound'] == 6, auto
        assert checks['autoscale_damped'].startswith('ok')
    elif name == 'fetch_latency_spike':
        # no injected fault: the emulation's cold opens slow every split
        assert not report['injections'], report['injections']
    else:
        assert report['injections'].get('worker.chunk/dup', 0) >= 1, report['injections']
    assert report['digest'] == jax_chaos.direct_read_digest(url)


@watched(240)
def test_materialize_kill_runs_through_the_matrix(tmp_path):
    """The materialization drill through the port's matrix, on the store
    both packages write alike: the controller SIGKILLed mid-publish leaves no
    torn entry, its restart resumes from the ledger, and a plane-cached
    consumer delivers the direct read's digest with no decode miss."""
    url, rows = chaos.make_chaos_dataset(str(tmp_path / 'dataset'), seed=13)
    reports, ok = chaos.run_matrix(['materialize_kill'], dataset_url=url, rows=rows,
                                   workdir=str(tmp_path), seed=13)
    (report,) = reports
    assert ok and report['ok'], chaos.render_report(reports)
    checks = report['checks']
    for name in ('zero_torn_entries', 'ledger_progress', 'resume', 'digest',
                 'served_from_plane', 'zero_residue'):
        assert checks[name].startswith('ok'), (name, checks)
    summary = report['restart_summary']
    assert summary['resumed'] >= 1 and summary['done'] == summary['total_pieces'] == rows // 4
    assert summary['warmed'] == summary['total_pieces'] - summary['resumed']
    assert report['digest'] == jax_chaos.direct_read_digest(url)

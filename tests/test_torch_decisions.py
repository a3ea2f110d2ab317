"""The port's decision journal (``petastorm_tpu_torch.telemetry.decisions``)
against the JAX package's, on the CPU.

The same seeded records through ``record_decision`` give the same records
and the same ``summarize_decision`` (the time stamps and the pid aside); a
dump written by either journal restores in the other (and pickles by
content); ``heartbeat_payload`` is the same; every replay rule gives the same
verdict and fields on the same seeded snapshots; the kill switch turns both
seams off.
"""

import pickle

import numpy as np
import pytest

from petastorm_tpu.telemetry import decisions as jax_decisions

from petastorm_tpu_torch.telemetry import decisions

#: what depends on the clock or the process
_VOLATILE = ('t_mono', 'unix_time', 'pid')


def _stable(record):
    return {k: v for k, v in record.items() if k not in _VOLATILE}


def _records(seed, n=40):
    """Seeded record arguments: every actor, action and rule of the
    catalogue, some suppressed, some with a worker or a tenant."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        actor = decisions.ACTORS[int(rng.integers(len(decisions.ACTORS)))]
        entry = decisions.CATALOGUE[actor]
        extra = {}
        if rng.random() < 0.5:
            extra['worker_id'] = 'w%d' % int(rng.integers(4))
        if rng.random() < 0.5:
            extra['tenant'] = 't%d' % int(rng.integers(3))
        out.append(dict(actor=actor, action=entry['actions'][int(rng.integers(
            len(entry['actions'])))], rule=entry['rules'][int(rng.integers(len(entry['rules'])))],
            inputs={'x': int(rng.integers(100)), 'y': round(float(rng.random()), 3)},
            suppressed=bool(rng.random() < 0.3),
            cooldown_until=None if rng.random() < 0.5 else round(float(rng.random()), 3),
            **extra))
    return out


def test_the_catalogue_equals_jax():
    assert decisions.ACTORS == jax_decisions.ACTORS
    assert decisions.CATALOGUE == jax_decisions.CATALOGUE
    assert decisions.RECORD_REQUIRED_KEYS == jax_decisions.RECORD_REQUIRED_KEYS
    assert decisions.KILL_SWITCH == jax_decisions.KILL_SWITCH
    assert sorted(decisions.REPLAYS) == sorted(jax_decisions.REPLAYS)


@pytest.mark.parametrize('seed', [0, 1])
def test_records_and_summaries_equal_jax(seed):
    """The same calls of ``record_decision`` into a small ring of each: the
    same records, ring eviction, kept real actions, counts, summaries,
    ``last`` and flapping tally."""
    ours = decisions.DecisionJournal(capacity=16, label='x')
    ref = jax_decisions.DecisionJournal(capacity=16, label='x')
    for kwargs in _records(seed):
        got = decisions.record_decision(journal=ours, **kwargs)
        want = jax_decisions.record_decision(journal=ref, **kwargs)
        assert _stable(got) == _stable(want)
        now = got['t_mono'] + 2.5
        assert decisions.summarize_decision(got, now=now) == \
            jax_decisions.summarize_decision(dict(want, t_mono=got['t_mono']), now=now)
    assert [_stable(r) for r in ours.records()] == [_stable(r) for r in ref.records()]
    assert len(ours.records()) == 16
    assert ours.counts() == ref.counts()
    for actor in decisions.ACTORS:
        for suppressed in (None, False, True):
            a, b = ours.last(actor, suppressed), ref.last(actor, suppressed)
            assert (a is None) == (b is None)
            if a is not None:
                assert _stable(a) == _stable(b)

    def summary(journal):
        return {actor: dict(row, last=row['last'] and {k: v for k, v in row['last'].items()
                                                      if k != 'age_s'})
                for actor, row in journal.summary().items()}
    assert summary(ours) == summary(ref)
    assert ours.opposing_actions(window_s=3600) == ref.opposing_actions(window_s=3600)


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
def test_a_dump_restores_in_the_other_package(direction):
    writer_mod, reader_mod = (decisions, jax_decisions) if direction == 'port_to_jax' \
        else (jax_decisions, decisions)
    writer = writer_mod.DecisionJournal(capacity=32, label='dispatcher')
    for kwargs in _records(3, n=50):
        writer_mod.record_decision(journal=writer, **kwargs)
    dump = pickle.loads(pickle.dumps(writer.dump()))
    reader = reader_mod.DecisionJournal(label='dispatcher')
    assert reader.restore(dump)
    assert reader.records() == writer.records()
    assert reader.counts() == writer.counts()
    again = reader.dump()
    assert again['restores'] == 1 and again['seq'] == 50
    assert again['notable'] == dump['notable']
    # a record after the restore continues the sequence
    rec = reader_mod.record_decision('autoscaler', 'hold', 'autoscale_cooldown_s', {},
                                     journal=reader)
    assert rec['seq'] == 50
    # a corrupt section loses history, never raises
    assert not reader_mod.DecisionJournal().restore({'kind': 'decision_journal', 'seq': 'x'})
    assert not reader_mod.DecisionJournal().restore({'kind': 'other'})


def test_a_journal_pickles_by_content():
    journal = decisions.DecisionJournal(capacity=8, label='p')
    for kwargs in _records(4, n=10):
        decisions.record_decision(journal=journal, **kwargs)
    clone = pickle.loads(pickle.dumps(journal))
    assert clone.records() == journal.records() and clone.capacity == 8
    assert clone.dump()['restores'] == journal.dump()['restores'] == 0


def test_the_heartbeat_payload_equals_jax(monkeypatch):
    """The process journals of both packages, made afresh, fed the same
    records: the same heartbeat payload and recent summaries."""
    monkeypatch.setattr(decisions, '_DEFAULT', None)
    monkeypatch.setattr(jax_decisions, '_DEFAULT', None)
    for kwargs in _records(5, n=12):
        decisions.record_decision(**kwargs)
        jax_decisions.record_decision(**kwargs)
    ours, ref = decisions.heartbeat_payload(k=5), jax_decisions.heartbeat_payload(k=5)
    assert [_stable(r) for r in ours['recent']] == [_stable(r) for r in ref['recent']]
    assert len(ours['recent']) == 5
    strip = {actor: dict(row, last=row['last'] and {k: v for k, v in row['last'].items()
                                                    if k != 'age_s'})
             for actor, row in ours['summary'].items()}
    assert strip == {actor: dict(row, last=row['last'] and {
        k: v for k, v in row['last'].items() if k != 'age_s'})
        for actor, row in ref['summary'].items()}
    assert decisions.default_journal() in decisions.journals()
    assert len(decisions.recent_summaries(k=3)) == 3


def test_the_kill_switch_turns_both_seams_off(monkeypatch):
    monkeypatch.setenv(decisions.KILL_SWITCH, '1')
    journal = decisions.DecisionJournal()
    assert not decisions.enabled() and not jax_decisions.enabled()
    assert decisions.record_decision('autoscaler', 'hold', 'autoscale_cooldown_s', {},
                                     journal=journal) is None
    assert journal.records() == []
    monkeypatch.setenv(decisions.KILL_SWITCH, '0')
    assert decisions.enabled() and jax_decisions.enabled()


# -- the replay ----------------------------------------------------------------

def _alive(rng):
    return ['w%d' % i for i in range(int(rng.integers(0, 4)))]


def _inputs(rule, rng):
    """A seeded snapshot of the fields ``rule``'s law reads."""
    f = lambda lo, hi: round(float(rng.uniform(lo, hi)), 3)  # noqa: E731
    i = lambda lo, hi: int(rng.integers(lo, hi))  # noqa: E731
    if rule == 'autoscale_starve_s':
        return {'pending': i(0, 3), 'alive': _alive(rng), 'free_slots': i(0, 2),
                'starve_s': f(0, 2), 'threshold_s': f(0, 2), 'step': i(1, 3),
                'max_workers': i(1, 5), 'cooldown_remaining_s': f(-1, 1)}
    if rule == 'autoscale_idle_s':
        alive = _alive(rng)
        return {'pending': i(0, 2), 'leased': i(0, 2), 'alive': alive, 'idle_s': f(0, 5),
                'threshold_s': f(0, 5), 'min_workers': i(0, 3),
                'coverage': {w: i(0, 3) for w in alive}, 'cooldown_remaining_s': f(-1, 1)}
    if rule == 'autoscale_cooldown_s':
        return {'cooldown_remaining_s': f(-1, 1), 'want': i(-1, 2),
                'wanted': ['scale_out', 'scale_in'][i(0, 2)]}
    if rule == 'wdrr_deficit':
        return {'eligible': [{'tenant': 't%d' % k, 'weight': f(0.5, 3),
                              'deficit': f(-9, 9)} for k in range(i(0, 4))],
                'deficit_clamp': 8.0}
    if rule == 'wdrr_refund':
        return {'deficit': f(-8, 8)}
    if rule == 'quota_budget':
        return {'nbytes': i(0, 100), 'used': i(0, 100),
                'budget': None if rng.random() < 0.2 else i(0, 150), 'plane': 'shm'}
    if rule == 'affinity_min_coverage':
        return {'coverage': f(0, 1), 'min_coverage': 0.5, 'scanned': i(1, 9)}
    if rule == 'affinity_defer_s':
        return {'waited_s': f(0, 1), 'defer_s': f(0, 1)}
    if rule == 'hot_window_s':
        return {'fits': [None, True, False][i(0, 3)], 'admitted': bool(i(0, 2)),
                'victim_newest_age_s': None if rng.random() < 0.3 else f(0, 600),
                'hot_window_s': 300.0}
    if rule == 'max_piece_attempts':
        return {'attempts': i(0, 5), 'max_attempts': i(1, 5)}
    if rule == 'hedge_deadline_s':
        return {'won': bool(rng.random() < 0.2), 'blocked_s': f(0, 1),
                'deadline_s': None if rng.random() < 0.2 else f(0, 1)}
    if rule == 'checkout_timeout_s':
        return {'blocked_s': f(0, 2), 'timeout_s': f(0, 2)}
    if rule == 'skew_ratio_floor':
        return {'skew_ratio': None if rng.random() < 0.2 else f(0, 16), 'floor': 8.0,
                'current': i(1, 16), 'factor': [0.5, 2.0][i(0, 2)], 'lo': 1, 'hi': 16}
    if rule == 'wait_frac_floor':
        return {'wait_frac': f(0, 0.3), 'floor': 0.1, 'current': i(1, 16), 'factor': 2.0,
                'lo': 1, 'hi': 8}
    if rule == 'delivery_jitter':
        return {'hb_p99': f(0, 10), 'dp_p99': f(0, 3), 'slow_factor': 4.0}
    if rule == 'ingest_wait_grow_s':
        return {'d_wait_s': f(0, 0.1), 'grow_s': 0.05, 'd_fetches': i(0, 3)}
    if rule == 'no_evidence_hold':
        return {}
    if rule == 'residency_budget':
        if rng.random() < 0.15:
            return {'dropped': True}
        return {'rows': i(0, 40), 'capacity': i(10, 64), 'dropped': bool(rng.random() < 0.1),
                'free_rows': [i(1, 20) for _ in range(i(0, 3))],
                'entry_rows': [i(1, 20) for _ in range(i(0, 4))], 'bump': i(0, 40)}
    raise AssertionError('no generator for rule %r' % rule)


def _actor_of(rule):
    return next(a for a, e in decisions.CATALOGUE.items() if rule in e['rules'])


@pytest.mark.parametrize('rule', sorted(jax_decisions.REPLAYS))
def test_replays_equal_jax(rule):
    """Seeded snapshots of the rule, each with a recorded action drawn from
    its actor's vocabulary (so matches and divergences both occur): the same
    verdict, recorded and replayed fields."""
    rng = np.random.default_rng(sum(map(ord, rule)))
    actor = _actor_of(rule)
    verdicts = set()
    for seq in range(60):
        record = {'actor': actor, 'rule': rule, 'seq': seq, 'inputs': _inputs(rule, rng),
                  'action': decisions.CATALOGUE[actor]['actions'][int(rng.integers(
                      len(decisions.CATALOGUE[actor]['actions'])))],
                  'worker_id': 'w%d' % int(rng.integers(3)),
                  'tenant': 't%d' % int(rng.integers(3))}
        if actor == 'autotuner':
            record['new'] = int(rng.integers(1, 17))
        got, want = decisions.replay_decision(record), jax_decisions.replay_decision(record)
        assert got == want, (record, got, want)
        verdicts.add(got['verdict'])
    if rule not in ('wdrr_refund', 'no_evidence_hold'):
        assert 'divergent' in verdicts, verdicts
    assert verdicts - {'unchecked'}, verdicts


def test_replay_of_an_unknown_rule_or_a_bad_snapshot_is_unchecked():
    for record in ({'rule': 'nope', 'inputs': {}}, {'rule': 'wdrr_refund', 'inputs': None},
                   {'rule': 'autoscale_starve_s', 'inputs': {'pending': 'x'}}):
        assert decisions.replay_decision(record) == jax_decisions.replay_decision(record)
        assert decisions.replay_decision(record)['verdict'] == 'unchecked'

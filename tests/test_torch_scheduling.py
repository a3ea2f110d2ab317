"""The port's adaptive scheduling (``petastorm_tpu_torch.workers_pool.
scheduling``, the ventilator's dispatch policies, the pools' reorder stage,
the readers' ``scheduling=`` and the loader's autotuner) against the JAX
package's, on the CPU.

Case by case as ``tests/test_scheduling.py``: the same seeded inputs go
through both packages' functions and must give the same values.  The cost
model's seeding and EWMA; each policy's dispatch sequence (slow pieces
first, uniform costs in epoch order, the lag bound, the early limit, a
resumed cursor) with its dispatch meta; the ``ReorderBuffer``'s releases
with prologues and empty positions; the autotuner's knob values and
decision records after the same histograms (its clamps, its rate limit,
the stall monitor's baseline, the cost-model fallback, the no-evidence
hold, the in-flight floor, the ingest window); the ventilator's token under
out-of-order acks, its resume, its pause, the frontier's liveness after a
shrink and the ack's decode seconds reaching the cost model.  Through the
readers: ``'auto'`` resolves as JAX's on default arguments (the port once
resolved FIFO there) and delivers JAX's rows in JAX's order; adaptive
delivery equals FIFO's on the thread, dummy and process pools; the resume
token round trip; the kill switch; the in-flight bound; the footer-scan
cap.  Through the loader: the ``sched_*`` gauges, the tuner rebound after
``reset()``, ``autotune=True`` on FIFO tuning the prefetch only.
"""

import threading
import time

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.telemetry import decisions as jax_decisions
from petastorm_tpu.telemetry import MetricsRegistry as JaxRegistry
from petastorm_tpu.workers_pool import scheduling as jax_sched

from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.telemetry import decisions
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
from petastorm_tpu_torch.workers_pool import VentilatedItem
from petastorm_tpu_torch.workers_pool import scheduling as sched
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator, epoch_order

ROWS = 96   # 12 row groups of 8


@pytest.fixture(scope='module')
def skewed(tmp_path_factory):
    """12 row groups of 8 rows whose decode cost is skewed by row width
    (every fourth group 20,000 floats a row), written by the JAX writer."""
    from petastorm_tpu.codecs import NdarrayCodec
    from petastorm_tpu.etl.dataset_metadata import DatasetWriter
    from petastorm_tpu.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path_factory.mktemp('torch_sched') / 'ds')
    schema = Unischema('Sched', [UnischemaField('idx', np.int64, (), None, False),
                                 UnischemaField('vec', np.float32, (None,), NdarrayCodec(),
                                                False)])
    rng = np.random.default_rng(0)
    with DatasetWriter(url, schema, rows_per_rowgroup=8) as w:
        w.write_many({'idx': np.int64(i),
                      'vec': rng.standard_normal(20000 if (i // 8) % 4 == 0 else 64)
                      .astype(np.float32)} for i in range(ROWS))
    return url


def _ids(factory, url, **kwargs):
    kwargs.setdefault('schema_fields', ['idx'])
    with factory(url, **kwargs) as reader:
        return [int(row.idx) for row in reader], reader.scheduling


# -- item 0: 'auto' on default arguments ----------------------------------------

def test_auto_on_default_arguments_resolves_and_delivers_as_jax(skewed):
    """``make_reader(url, workers_count=4)`` with every other argument at its
    default, over 12 row groups: both readers dispatch adaptively and
    deliver the same rows in the same order (the port once resolved FIFO
    there and delivered in completion order)."""
    got, ours = _ids(make_reader, skewed, workers_count=4)
    want, theirs = _ids(petastorm_tpu.make_reader, skewed, workers_count=4)
    assert ours == theirs == 'adaptive'
    assert got == want and sorted(got) == list(range(ROWS))
    with make_batch_reader(skewed, workers_count=4) as reader, \
            jax_make_batch_reader(skewed, workers_count=4) as jax_reader:
        assert reader.scheduling == jax_reader.scheduling == 'adaptive'
        assert [int(i) for b in reader for i in b.idx] == \
            [int(i) for b in jax_reader for i in b.idx]


@pytest.mark.parametrize('mode,items,workers', [
    ('auto', 8, 2), ('auto', 7, 8), ('auto', 100, 1), ('auto', 12, 4), ('fifo', 12, 4),
    ('adaptive', 1, 1), ('adaptive', 12, 4)])
@pytest.mark.parametrize('kill', [False, True])
def test_resolve_scheduling_equals_jax(mode, items, workers, kill, monkeypatch):
    if kill:
        monkeypatch.setenv('PETASTORM_TPU_NO_ADAPTIVE_SCHED', '1')
    got = sched.resolve_scheduling(mode, items, workers)
    assert got == jax_sched.resolve_scheduling(mode, items, workers)
    assert got == 'fifo' if kill else True
    for module in (sched, jax_sched):
        with pytest.raises(ValueError, match='scheduling must be one of'):
            module.resolve_scheduling('sometimes', items, workers)


def test_the_constants_equal_jax():
    for name in ('SCHEDULING_MODES', 'MIN_ITEMS_FOR_ADAPTIVE', 'MIN_WINDOW', 'MAX_WINDOW',
                 'MIN_INFLIGHT', 'MAX_INFLIGHT', 'MIN_PREFETCH', 'MAX_PREFETCH',
                 'MIN_INGEST_WINDOW', 'MAX_INGEST_WINDOW', 'DEFAULT_INGEST_WINDOW',
                 'INGEST_WAIT_GROW_S', 'SKEW_RATIO_FLOOR', 'MAX_PRIOR_SCAN_FILES',
                 'SLOW_FACTOR'):
        assert getattr(sched, name) == getattr(jax_sched, name), name


# -- the cost model ---------------------------------------------------------------

def _cost_model_trace(module, seed):
    rng = np.random.default_rng(seed)
    model = module.PieceCostModel(alpha=float(rng.uniform(0.1, 0.9)))
    model.seed({i: float(rng.integers(1, 1000)) for i in range(16)})
    out = [[model.predict(i) for i in range(20)]]
    for _ in range(40):
        model.observe(int(rng.integers(0, 18)), float(rng.exponential(0.05)))
        out.append([model.predict(i) for i in range(20)])
    return out, model.observations, model.skew_ratio(), model.skew_ratio(min_pieces=100)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_cost_model_seeding_and_ewma_equal_jax(seed):
    assert _cost_model_trace(sched, seed) == _cost_model_trace(jax_sched, seed)


def test_cost_model_seeding_orders_and_ewma_overrides():
    model = sched.PieceCostModel()
    model.seed({0: 10, 1: 1000, 2: 50})
    assert model.predict(1) > model.predict(2) > model.predict(0)
    assert model.predict(99) >= 0.0
    model = sched.PieceCostModel(alpha=0.5)
    model.seed({0: 1000, 1: 1})
    for _ in range(6):
        model.observe(0, 0.001)
        model.observe(1, 0.5)
    assert model.predict(1) > model.predict(0) and model.observations == 12


# -- the dispatch policies --------------------------------------------------------

POLICY_CASES = {
    'slow_first': (dict(window=8), lambda i: 1000 if i == 5 else 10, 12, 0, 0),
    'uniform': (dict(window=8), lambda i: 10.0 + 0.01 * (i % 3), 24, 0, 0),
    'lag_bound': (dict(window=6), lambda i: 1 if i == 0 else 100 + i, 40, 0, 0),
    'every_seventh': (dict(window=8), lambda i: 1000 if i % 7 == 0 else 10, 30, 0, 0),
    'early_limit': (dict(window=16, early_limit=2), lambda i: 500 if i % 3 == 0 else 5, 30, 0, 0),
    'resumed': (dict(window=4), lambda i: 10 * (i % 5) + 1, 10, 10, 7),
    'unseeded': (dict(window=4), None, 10, 0, 0),
}


def _policy_sequence(module, case, force_every=0):
    kwargs, cost, n, base, start = POLICY_CASES[case]
    model = module.PieceCostModel()
    if cost is not None:
        model.seed({i: cost(i) for i in range(n)})
    policy = module.AdaptiveDispatchPolicy(model, **kwargs)
    policy.begin_epoch([(i, 0) for i in range(n)], base, start)
    out = []
    while True:
        nxt = policy.next(force_oldest=bool(force_every) and len(out) % force_every == 0)
        if nxt is None:
            return out
        out.append((nxt, dict(policy.last_dispatch_meta), policy.oldest_undispatched_idx()))


@pytest.mark.parametrize('case', sorted(POLICY_CASES))
@pytest.mark.parametrize('force_every', [0, 3])
def test_adaptive_dispatch_sequence_equals_jax(case, force_every):
    got = _policy_sequence(sched, case, force_every)
    assert got == _policy_sequence(jax_sched, case, force_every)
    _, _, n, base, start = POLICY_CASES[case]
    assert sorted(p for (p, _), _, _ in got) == list(range(base + start, base + n))


def test_adaptive_dispatch_properties():
    seq = [p for (p, _), _, _ in _policy_sequence(sched, 'slow_first')]
    assert seq[0] == 5
    assert [p for (p, _), _, _ in _policy_sequence(sched, 'uniform')] == list(range(24))
    rank = {p: r for r, ((p, _), _, _) in enumerate(_policy_sequence(sched, 'lag_bound'))}
    assert all(rank[p] - p <= 12 for p in range(40))


def test_fifo_dispatch_sequence_equals_jax():
    def run(module):
        policy = module.FifoDispatchPolicy()
        policy.begin_epoch(list('abcdefg'), 14, 2)
        out = []
        while True:
            nxt = policy.next()
            if nxt is None:
                return out, policy.oldest_undispatched_idx()
            out.append(nxt)
    assert run(sched) == run(jax_sched) == ([(16, 'c'), (17, 'd'), (18, 'e'), (19, 'f'),
                                             (20, 'g')], 7)


def test_adaptive_policy_predicts_once_per_piece_per_epoch():
    class Counting(sched.PieceCostModel):
        calls = 0

        def predict(self, piece):
            Counting.calls += 1
            return super().predict(piece)

    model = Counting()
    model.seed({i: (1000 if i % 7 == 0 else 10) for i in range(30)})
    policy = sched.AdaptiveDispatchPolicy(model, window=8)
    policy.begin_epoch([(i, 0) for i in range(30)], 0, 0)
    while policy.next() is not None:
        pass
    assert Counting.calls == 30


# -- the reorder buffer -----------------------------------------------------------

def _reorder_trace(module, seed, start, prologue):
    rng = np.random.default_rng(seed)
    positions = list(range(-prologue, 0)) + list(range(start, start + 12))
    buf = module.ReorderBuffer(start_position=start, prologue_count=prologue)
    out = []
    for position in rng.permutation(positions).tolist():
        for k in range(int(rng.integers(0, 3))):   # 0 results: a predicate dropped the group
            buf.add(position, (position, k))
        out.append((buf.complete(position, position * 0.01), buf.pending_results,
                    buf.pending_positions, buf.empty()))
    return out


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
@pytest.mark.parametrize('start,prologue', [(0, 0), (24, 0), (10, 2), (0, 3)])
def test_reorder_buffer_releases_equal_jax(seed, start, prologue):
    got = _reorder_trace(sched, seed, start, prologue)
    assert got == _reorder_trace(jax_sched, seed, start, prologue)
    released = [run for step, _, _, _ in got for run in step]
    assert [p for p, _, _ in released] == sorted(p for p, _, _ in released)
    assert got[-1][3]   # every position released in the end


def test_reorder_buffer_release_publishes_then_acks():
    log = []

    class Vent(object):
        def processed_item(self, position, elapsed):
            log.append(('ack', position, elapsed))

    buf = sched.ReorderBuffer(start_position=0, prologue_count=1)
    buf.add(0, 'epoch')
    buf.release(0, 0.2, lambda r: log.append(('pub', r)), Vent())
    assert log == []
    buf.add(-1, 'prologue')
    buf.release(-1, 0.1, lambda r: log.append(('pub', r)), Vent())
    assert log == [('pub', 'prologue'), ('ack', -1, 0.1), ('pub', 'epoch'), ('ack', 0, 0.2)]


# -- the autotuner ----------------------------------------------------------------

class _Hist(object):
    def __init__(self, p50, p99, count=100):
        self._q = {0.5: p50, 0.99: p99}
        self.count = count

    def quantile(self, q):
        return self._q[q]


class _Monitor(object):
    def __init__(self, wait_time=0.0, step_time=0.0):
        self.wait_time = wait_time
        self.step_time = step_time


class _Plane(object):
    def __init__(self):
        self.wait_seconds = 0.0
        self.fetch_count = 0
        self.window = 8

    def set_window(self, window):
        self.window = int(window)


def _tune_skew(tuner, knobs, step, env):
    tuner.tune(knobs, decode=_Hist(0.001, 0.5), host_batch=_Hist(0.01, 0.5),
               device_put=_Hist(0.001, 0.002))


def _tune_flat(tuner, knobs, step, env):
    tuner.tune(knobs, decode=_Hist(0.01, 0.012), host_batch=_Hist(0.001, 0.002),
               device_put=_Hist(0.001, 0.002))


def _tune_no_put(tuner, knobs, step, env):
    tuner.tune(knobs, decode=_Hist(0.01, 0.012), host_batch=_Hist(0.01, 0.02))


def _tune_monitor(tuner, knobs, step, env):
    if step % 3 == 1:
        env['monitor'].wait_time += 10.0
    env['monitor'].step_time += 1.0
    tuner.tune(knobs)


def _tune_cost_model(tuner, knobs, step, env):
    if step == 2:
        for piece in range(16):
            env['model'].observe(piece, 50.0 if piece == 0 else 1.0)
    tuner.tune(knobs)


def _tune_ingest(tuner, knobs, step, env):
    plane = env['plane']
    plane.fetch_count += 10 if step % 4 else 0
    plane.wait_seconds += 1.0 if step % 3 == 0 else 0.0
    tuner.tune(knobs)


#: name -> (Autotuner kwargs, knobs, one step, steps); ``monitor``,
#: ``model`` and ``plane`` in the kwargs are made per package
TUNER_CASES = {
    'skew_clamps': (dict(), dict(window=32, max_inflight=8, prefetch=2), _tune_skew, 20),
    'flat_shrinks': (dict(), dict(window=256, max_inflight=128, prefetch=8), _tune_flat, 40),
    'no_delivery_signal': (dict(), dict(window=32, max_inflight=16, prefetch=8),
                           _tune_no_put, 5),
    'inflight_floor': (dict(min_inflight=20), dict(window=64, max_inflight=128, prefetch=2),
                       _tune_flat, 40),
    'stall_monitor': (dict(monitor=True), dict(window=32, max_inflight=8, prefetch=2),
                      _tune_monitor, 9),
    'cost_model_fallback': (dict(model=True), dict(window=32, max_inflight=16, prefetch=2),
                            _tune_cost_model, 5),
    'ingest_window': (dict(plane=True), dict(ingest_window=8), _tune_ingest, 12),
}


def _tuner_trace(module, registry_cls, decisions_module, case, interval_s=0.0):
    kwargs, knob_kwargs, step_fn, steps = TUNER_CASES[case]
    env = {'monitor': _Monitor(wait_time=100.0, step_time=1.0),
           'model': module.PieceCostModel(), 'plane': _Plane()}
    registry = registry_cls('tune')
    tuner_kwargs = {k: v for k, v in kwargs.items() if k == 'min_inflight'}
    if kwargs.get('monitor'):
        tuner_kwargs['stall_monitor'] = env['monitor']
    if kwargs.get('model'):
        tuner_kwargs['cost_model'] = env['model']
    tuner = module.Autotuner(registry=registry, interval_s=interval_s, min_observations=0,
                             **tuner_kwargs)
    knobs = module.SchedulerKnobs(**knob_kwargs)
    if kwargs.get('plane'):
        knobs.bind('ingest_window', env['plane'].set_window)
        tuner.attach_ingest(env['plane'])
    journal = decisions_module.default_journal()
    seq = journal.records()[-1]['seq'] if journal.records() else -1
    trace = []
    for step in range(steps):
        step_fn(tuner, knobs, step, env)
        trace.append((knobs.window, knobs.max_inflight, knobs.prefetch, knobs.ingest_window,
                      env['plane'].window))
    gauges = {name: registry.gauge(name).value for name in
              ('sched_window', 'sched_max_inflight', 'sched_prefetch', 'sched_ingest_window')}
    records = [(r['actor'], r['action'], r['rule'], r.get('knob'), r.get('new'),
                r['suppressed'], decisions_module.replay_decision(r)['verdict'])
               for r in journal.records() if r['seq'] > seq and r['actor'] == 'autotuner']
    return trace, gauges, registry.counter('sched_adjust_total').value, records


@pytest.mark.parametrize('case', sorted(TUNER_CASES))
def test_autotuner_knobs_and_records_equal_jax(case):
    got = _tuner_trace(sched, MetricsRegistry, decisions, case)
    assert got == _tuner_trace(jax_sched, JaxRegistry, jax_decisions, case)
    trace, gauges, _, records = got
    window, inflight, prefetch, ingest_window, _ = trace[-1]
    assert sched.MIN_WINDOW <= window <= sched.MAX_WINDOW
    assert inflight <= sched.MAX_INFLIGHT and prefetch <= sched.MAX_PREFETCH
    assert sched.MIN_INGEST_WINDOW <= ingest_window <= sched.MAX_INGEST_WINDOW
    # every record replays through its control law to what it recorded
    assert all(verdict == 'match' for *_, verdict in records), records


def test_autotuner_outcomes():
    trace, gauges, adjusted, _ = _tuner_trace(sched, MetricsRegistry, decisions, 'skew_clamps')
    assert trace[-1][0] == sched.MAX_WINDOW and gauges['sched_window'] == sched.MAX_WINDOW
    assert adjusted > 0
    trace = _tuner_trace(sched, MetricsRegistry, decisions, 'flat_shrinks')[0]
    assert trace[-1][0] < sched.MAX_WINDOW and trace[-1][2] == sched.MIN_PREFETCH
    assert _tuner_trace(sched, MetricsRegistry, decisions, 'inflight_floor')[0][-1][1] == 20
    assert _tuner_trace(sched, MetricsRegistry, decisions,
                        'no_delivery_signal')[0][-1][2] == sched.MAX_PREFETCH
    # the monitor's lifetime totals are the baseline: the first window holds
    trace = _tuner_trace(sched, MetricsRegistry, decisions, 'stall_monitor')[0]
    assert trace[0][2] == 2 and trace[1][2] == 4
    # no signal holds the ordering knobs; the ack-fed skew alone widens them
    trace = _tuner_trace(sched, MetricsRegistry, decisions, 'cost_model_fallback')[0]
    assert trace[1][:2] == (32, 16) and trace[-1][0] > 32 and trace[-1][1] > 16
    trace = _tuner_trace(sched, MetricsRegistry, decisions, 'ingest_window')[0]
    assert trace[0][3] == 12 and trace[0][4] == 12


@pytest.mark.parametrize('case', ['skew_clamps', 'stall_monitor'])
def test_autotuner_rate_limit_equals_jax(case):
    got = _tuner_trace(sched, MetricsRegistry, decisions, case, interval_s=3600.0)
    assert got == _tuner_trace(jax_sched, JaxRegistry, jax_decisions, case, interval_s=3600.0)
    trace = got[0]
    assert all(t == trace[0] for t in trace)   # one pass, then nothing inside the window


def test_maybe_tune_waits_for_fresh_observations():
    model = sched.PieceCostModel()
    tuner = sched.Autotuner(interval_s=0.0, min_observations=4, cost_model=model)
    knobs = sched.SchedulerKnobs(window=32, max_inflight=8, prefetch=2)
    assert not tuner.maybe_tune(knobs, decode=_Hist(0.001, 0.5))
    for piece in range(4):
        model.observe(piece, 0.1)
    assert tuner.maybe_tune(knobs, decode=_Hist(0.001, 0.5))


# -- the ventilator -----------------------------------------------------------------

class Sink(object):
    """Collects ventilated items; acks them on demand, in any order."""

    def __init__(self):
        self.items = []
        self._lock = threading.Lock()
        self.vent = None

    def __call__(self, item):
        assert isinstance(item, VentilatedItem)
        with self._lock:
            self.items.append(item)

    def take(self):
        with self._lock:
            pending, self.items = self.items, []
        return pending

    def ack(self, pending):
        for item in pending:
            self.vent.processed_item(item.position)
        return [i.args for i in pending]


def _make(items, **kwargs):
    sink = Sink()
    sink.vent = ConcurrentVentilator(ventilate_fn=sink, items=items, **kwargs)
    return sink.vent, sink


def _wait_items(sink, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with sink._lock:
            if len(sink.items) >= n:
                return
        time.sleep(0.002)
    raise AssertionError('never saw %d ventilated items' % n)


def _drain(vent, sink, timeout=5.0):
    out = []
    deadline = time.monotonic() + timeout
    while not vent.completed():
        out.extend(sink.ack(sink.take()))
        assert time.monotonic() < deadline, 'the ventilator did not complete'
        time.sleep(0.001)
    return out + sink.ack(sink.take())


def test_token_is_the_oldest_outstanding_under_out_of_order_acks():
    vent, sink = _make(list(range(10)), iterations=1, max_ventilation_queue_size=6)
    vent.start()
    _wait_items(sink, 6)
    pending = sink.take()
    for pos in (5, 4, 3, 2, 0):
        vent.processed_item(pos)
    time.sleep(0.1)
    assert (vent.state_dict()['epoch'], vent.state_dict()['cursor']) == (0, 1)
    vent.processed_item(1)
    time.sleep(0.1)
    assert vent.state_dict()['cursor'] >= 6
    assert {i.position for i in pending} == set(range(6))
    vent.stop()


def test_a_resumed_ventilator_dispatches_the_suffix():
    items = list(range(12))
    vent, sink = _make(items, iterations=1, randomize_item_order=True, random_seed=3,
                       max_ventilation_queue_size=5)
    vent.start()
    _wait_items(sink, 5)
    pending = sink.take()
    oldest = min(i.position for i in pending)
    for item in pending:
        if item.position != oldest:
            vent.processed_item(item.position)
    token = vent.state_dict()
    vent.stop()
    assert token['cursor'] == oldest
    vent2, sink2 = _make(items, iterations=1, randomize_item_order=True,
                         random_seed=token['seed'], start_epoch=token['epoch'],
                         start_cursor=token['cursor'])
    vent2.start()
    resumed = _drain(vent2, sink2)
    vent2.stop()
    assert resumed == epoch_order(items, True, 3, 0)[oldest:]


def test_pause_holds_and_unpause_resumes():
    vent, sink = _make(list(range(30)), iterations=1, max_ventilation_queue_size=4)
    vent.start()
    _wait_items(sink, 4)
    vent.pause()
    sink.ack(sink.take())
    time.sleep(0.1)
    assert sink.take() == []
    vent.unpause()
    _wait_items(sink, 4)
    assert len(_drain(vent, sink)) == 26
    vent.stop()


def _shrink_run(module, ventilator_cls):
    model = module.PieceCostModel()
    model.seed({i: (100.0 if i in (4, 5, 6) else 1.0) for i in range(8)})
    policy = module.AdaptiveDispatchPolicy(model, window=12, early_limit=None)
    sink = Sink() if ventilator_cls is ConcurrentVentilator else _JaxSink()
    vent = ventilator_cls(ventilate_fn=sink, items=[(i, 0) for i in range(8)], iterations=1,
                          max_ventilation_queue_size=4, dispatch_policy=policy)
    sink.vent = vent
    vent.start()
    _wait_items(sink, 4)
    first = {i.position for i in sink.take()}
    got = set(first)
    vent.processed_item(0)
    vent.set_max_inflight(2)
    expect = 1
    deadline = time.monotonic() + 5.0
    while expect < 8 and time.monotonic() < deadline:
        got.update(i.position for i in sink.take())
        if expect in got:
            vent.processed_item(expect)
            expect += 1
        else:
            time.sleep(0.002)
    vent.stop()
    return first, expect, vent.max_inflight


class _JaxSink(Sink):
    def __call__(self, item):
        with self._lock:
            self.items.append(item)


def test_a_shrunk_bound_keeps_the_frontier_live_as_jax():
    from petastorm_tpu.workers_pool.ventilator import ConcurrentVentilator as JaxVentilator
    got = _shrink_run(sched, ConcurrentVentilator)
    assert got == _shrink_run(jax_sched, JaxVentilator) == ({0, 4, 5, 6}, 8, 2)


def test_the_ack_s_decode_seconds_reach_the_cost_model():
    model = sched.PieceCostModel()
    policy = sched.AdaptiveDispatchPolicy(model, window=4)
    sink = Sink()
    vent = ConcurrentVentilator(ventilate_fn=sink, items=[(i, 0) for i in range(8)],
                                iterations=1, dispatch_policy=policy)
    sink.vent = vent
    vent.start()
    deadline = time.monotonic() + 5.0
    acked = 0
    while acked < 8 and time.monotonic() < deadline:
        for item in sink.take():
            vent.processed_item(item.position, elapsed=0.05)
            assert vent.take_dispatch_meta(item.position)['policy'] == 'adaptive'
            acked += 1
        time.sleep(0.001)
    vent.stop()
    assert model.observations == 8 and model.predict(3) == pytest.approx(0.05)


def test_the_dispatch_listener_sees_the_dispatch_order_and_a_raise_disables_it():
    seen = []
    vent, sink = _make([(i,) for i in range(6)], iterations=1,
                       dispatch_listener=lambda item: seen.append(item.position))
    vent.start()
    assert len(_drain(vent, sink)) == 6
    vent.stop()
    assert seen == list(range(6))

    def boom(item):
        raise RuntimeError('listener')
    vent, sink = _make([(i,) for i in range(6)], iterations=1, dispatch_listener=boom)
    vent.start()
    assert len(_drain(vent, sink)) == 6
    vent.stop()


# -- through the readers --------------------------------------------------------------

@pytest.mark.parametrize('pool,workers', [('thread', 4), ('dummy', 1), ('process', 2)])
def test_adaptive_delivery_equals_fifo_and_jax(skewed, pool, workers):
    common = dict(shuffle_row_groups=True, seed=11, num_epochs=1 if pool == 'process' else 2)
    fifo, _ = _ids(make_reader, skewed, reader_pool_type='dummy', scheduling='fifo', **common)
    got, mode = _ids(make_reader, skewed, reader_pool_type=pool, workers_count=workers,
                     scheduling='adaptive', **common)
    want, _ = _ids(petastorm_tpu.make_reader, skewed,
                   reader_pool_type='thread' if pool == 'process' else pool,
                   workers_count=workers, scheduling='adaptive', **common)
    assert mode == 'adaptive'
    assert got == fifo == want


def test_an_adaptive_resume_token_round_trips_as_jax(skewed):
    def run(factory):
        common = dict(schema_fields=['idx'], shuffle_row_groups=True, seed=7, num_epochs=1,
                      workers_count=4, scheduling='adaptive')
        with factory(skewed, **common) as reader:
            got = []
            for i, row in enumerate(reader):
                got.append(int(row.idx))
                if i == 29:
                    break
            got.extend(int(r.idx) for r in reader.drain_in_flight())
            token = reader.state_dict()
        with factory(skewed, resume_state=token, **common) as reader:
            return got, [int(r.idx) for r in reader], token
    got, resumed, token = run(make_reader)
    want, jax_resumed, jax_token = run(petastorm_tpu.make_reader)
    fifo, _ = _ids(make_reader, skewed, reader_pool_type='dummy', scheduling='fifo',
                   shuffle_row_groups=True, seed=7, num_epochs=1)
    assert got + resumed == want + jax_resumed == fifo
    assert (token['epoch'], token['cursor']) == (jax_token['epoch'], jax_token['cursor'])


def test_auto_the_kill_switch_and_the_small_cases(skewed, monkeypatch):
    assert _ids(make_reader, skewed, workers_count=4)[1] == 'adaptive'
    monkeypatch.setenv('PETASTORM_TPU_NO_ADAPTIVE_SCHED', '1')
    assert _ids(make_reader, skewed, workers_count=4, scheduling='adaptive')[1] == 'fifo'
    monkeypatch.delenv('PETASTORM_TPU_NO_ADAPTIVE_SCHED')
    assert _ids(make_reader, skewed, workers_count=4, piece_indices=[0, 1])[1] == 'fifo'
    assert _ids(make_reader, skewed, workers_count=1)[1] == 'fifo'
    with pytest.raises(ValueError, match='scheduling must be one of'):
        make_reader(skewed, scheduling='sometimes')


def test_adaptive_diagnostics(skewed):
    with make_reader(skewed, schema_fields=['idx'], workers_count=4,
                     scheduling='adaptive') as reader:
        list(reader)
        d = reader.diagnostics
        assert (d['scheduling'], d['reorder_pending'], d['ventilated_count']) == \
            ('adaptive', 0, 12)
        assert reader.cost_model.observations == 12
    with make_reader(skewed, schema_fields=['idx'], workers_count=2,
                     scheduling='fifo') as reader:
        assert reader.diagnostics['scheduling'] == 'fifo' and reader.cost_model is None


def test_the_adaptive_in_flight_bound_scales_with_the_pool_as_jax(tmp_path):
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path / 'many')
    with DatasetWriter(url, Unischema('Many', [UnischemaField('idx', np.int64, (), None,
                                                              False)]),
                       rows_per_rowgroup=1) as w:
        for i in range(80):
            w.write({'idx': np.int64(i)})
    for factory in (make_reader, petastorm_tpu.make_reader):
        with factory(url, workers_count=2, scheduling='adaptive', num_epochs=1) as reader:
            assert reader._ventilator.max_inflight == 32
            assert sorted(int(r.idx) for r in reader) == list(range(80))


def test_the_cost_prior_is_the_byte_sizes_and_capped_by_file_count(skewed, monkeypatch):
    import petastorm_tpu_torch.reader as port_reader
    with make_reader(skewed, workers_count=4, scheduling='adaptive',
                     schema_fields=['idx']) as reader:
        weights = reader._scheduling_weights()
    with petastorm_tpu.make_reader(skewed, workers_count=4, scheduling='adaptive',
                                   schema_fields=['idx']) as reader:
        assert weights == reader._scheduling_weights()
    assert weights[0] > 100 * weights[1]   # the wide row groups weigh more
    calls = []
    monkeypatch.setattr(sched, 'MAX_PRIOR_SCAN_FILES', 0)
    monkeypatch.setattr(port_reader, 'read_row_group_byte_sizes',
                        lambda fs, paths: calls.append(paths) or {})
    with make_reader(skewed, workers_count=4, scheduling='adaptive', num_epochs=1,
                     schema_fields=['idx']) as reader:
        assert sorted(int(r.idx) for r in reader) == list(range(ROWS))
        assert reader._scheduling_weights() == {i: 8 for i in range(12)}
    assert not calls


# -- through the loader ---------------------------------------------------------------

def _loader_gauges(factory, loader_cls, url, **loader_kwargs):
    with factory(url, workers_count=4, scheduling='adaptive', num_epochs=1,
                 shuffle_row_groups=False, schema_fields=['idx']) as reader:
        loader = loader_cls(reader, batch_size=8, **loader_kwargs)
        ids = [i for b in loader.iter_host_batches() for i in np.asarray(b['idx']).tolist()]
        gauges = loader.metrics.snapshot()['gauges']
    return ids, {k: v for k, v in gauges.items() if k.startswith('sched_')}


def test_the_loader_s_tuner_publishes_the_sched_gauges_as_jax(skewed):
    got = _loader_gauges(make_reader, DataLoader, skewed, device='cpu')
    want = _loader_gauges(petastorm_tpu.make_reader, JaxDataLoader, skewed, transfer=False)
    assert got == want
    assert set(got[1]) == {'sched_window', 'sched_max_inflight', 'sched_prefetch',
                           'sched_ingest_window'}
    assert got[0] == list(range(ROWS))


def test_the_loader_s_tuner_rebinds_after_a_reset(skewed):
    with make_reader(skewed, workers_count=4, scheduling='adaptive', num_epochs=1,
                     shuffle_row_groups=False, schema_fields=['idx']) as reader:
        loader = DataLoader(reader, batch_size=8, device='cpu')
        for _ in loader.iter_host_batches():
            pass
        first = loader._tuner
        assert first is not None
        reader.reset()
        for _ in loader.iter_host_batches():
            pass
        assert loader._tuner is not first and loader._tuner._cost_model is reader.cost_model


@pytest.mark.parametrize('autotune,scheduling,setters', [
    (True, 'fifo', {'prefetch'}), ('auto', 'fifo', None), (False, 'adaptive', None),
    ('auto', 'adaptive', {'window', 'max_inflight', 'prefetch'})])
def test_which_knobs_the_loader_binds_equals_jax(skewed, autotune, scheduling, setters):
    found = []
    for factory, loader_cls, kwargs in ((make_reader, DataLoader, dict(device='cpu')),
                                        (petastorm_tpu.make_reader, JaxDataLoader,
                                         dict(transfer=False))):
        with factory(skewed, workers_count=4, scheduling=scheduling, num_epochs=1,
                     shuffle_row_groups=False, schema_fields=['idx']) as reader:
            loader = loader_cls(reader, batch_size=8, autotune=autotune, **kwargs)
            for _ in loader.iter_host_batches():
                pass
            found.append(None if loader._tuner is None else set(loader._knobs._setters))
    assert found == [setters, setters]


def test_an_attached_stall_monitor_reaches_the_tuner(skewed):
    monitor = _Monitor(wait_time=5.0, step_time=1.0)
    with make_reader(skewed, workers_count=4, scheduling='adaptive', num_epochs=1,
                     schema_fields=['idx']) as reader:
        loader = DataLoader(reader, batch_size=8, device='cpu')
        loader.attach_stall_monitor(monitor)
        for _ in loader.iter_host_batches():
            pass
        assert loader._tuner._stall_monitor is monitor
        assert loader._tuner._last_wait == 5.0

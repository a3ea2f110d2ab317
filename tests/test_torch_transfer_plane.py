"""The port's transfer plane (``petastorm_tpu_torch.gpu.transfer``) and its
pumped loader against the JAX package's, on the CPU.

Both planes run forced on (``transfer=True``), as the JAX package's own
tests run theirs.  What arrives must equal the JAX plane's output bit for
bit, dtypes included (the bfloat16 wire too: torch's round to nearest even
against ml_dtypes'), and the pumped loader must deliver the inline loader's
and the JAX loader's batches for columnar, row and packed readers.  The
sharded put is not ported yet.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

import petastorm_tpu.native
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.jax import DeviceInMemDataLoader as JaxDeviceInMemDataLoader
from petastorm_tpu.jax import PackedDataLoader as JaxPackedDataLoader
from petastorm_tpu.jax import transfer as jax_transfer
from petastorm_tpu.telemetry import attribute_stalls as jax_attribute_stalls

from petastorm_tpu_torch.benchmark import TraceRecorder
from petastorm_tpu_torch.gpu import DataLoader, DeviceInMemDataLoader, PackedDataLoader
from petastorm_tpu_torch.gpu import transfer
from petastorm_tpu_torch.telemetry import attribute_stalls
from petastorm_tpu_torch.train_lm import write_var_token_dataset

from torch_plane_common import (assert_batches_equal, jax_reader, port_reader, to_numpy,
                                write_dataset)


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_plane'))


@pytest.fixture(scope='module')
def token_url(tmp_path_factory):
    return write_var_token_dataset('file://%s' % tmp_path_factory.mktemp('plane_tokens'),
                                   num_docs=48)


def _tree():
    rng = np.random.default_rng(0)
    return {'image': rng.integers(0, 256, (16, 8, 8, 3)).astype(np.uint8),
            'x': rng.standard_normal((16, 4)).astype(np.float32),
            'wide': rng.integers(-2 ** 50, 2 ** 50, (16,)).astype(np.int64),
            'flag': rng.random(16) < 0.5,
            'small': rng.integers(-100, 100, (16,)).astype(np.int8),
            'unsigned': rng.integers(0, 2 ** 40, (16,)).astype(np.uint64),
            'nested': {'y': rng.standard_normal((16,)).astype(np.float64)}}


def _put(plane, tree):
    out = plane.put(tree)
    return None if out is None else plane.ready(*out)


# -- policy -------------------------------------------------------------------

def test_plane_enabled_policy_matches_jax(monkeypatch):
    assert jax.default_backend() == 'cpu'
    for mode in (True, False, None, 'auto'):
        assert transfer.plane_enabled(mode, 'cpu') is jax_transfer.plane_enabled(mode)
    # 'auto' is on for the card (the port's default device) and off on the CPU
    assert transfer.plane_enabled('auto', 'cuda') is True
    assert transfer.plane_enabled('auto') is True
    monkeypatch.setenv(transfer.KILL_SWITCH, '1')
    assert transfer.KILL_SWITCH == jax_transfer.KILL_SWITCH
    for mode in (True, 'auto'):
        assert transfer.plane_enabled(mode, 'cuda') is False
        assert jax_transfer.plane_enabled(mode) is False


def test_refusals_match_jax(url):
    for bad in ('off', 'false', 'disabled'):
        with pytest.raises(ValueError, match='transfer must be'):
            jax_transfer.plane_enabled(bad)
        with pytest.raises(ValueError, match='transfer must be'):
            transfer.plane_enabled(bad)
    with pytest.raises(ValueError, match='wire_dtypes'):
        jax_transfer.TransferPlane(wire_dtypes='yes please')
    with pytest.raises(ValueError, match='wire_dtypes'):
        transfer.TransferPlane('cpu', wire_dtypes='yes please')
    with port_reader(url, True) as reader:
        with pytest.raises(ValueError, match='transfer must be'):
            DataLoader(reader, 16, transfer='off', device='cpu')


# -- the coalesced slab -------------------------------------------------------

@pytest.mark.parametrize('policy', [None, 'auto', {'x': 'bfloat16', 'nested': 'bfloat16'},
                                   {'y': torch.bfloat16, 'wide': 'int16'}])
def test_coalesced_round_trip_matches_jax(policy):
    """One slab per put, unpacked on the device: the JAX plane's values and
    dtypes bit for bit (int64 -> int32, uint64 -> uint32, float64 ->
    float32; bfloat16 on the wire where the policy narrows), and the same
    byte counts."""
    tree = _tree()
    jax_policy = policy if not isinstance(policy, dict) else {
        k: ('bfloat16' if v is torch.bfloat16 else v) for k, v in policy.items()}
    jax_plane = jax_transfer.TransferPlane(ring_slots=2, wire_dtypes=jax_policy)
    plane = transfer.TransferPlane('cpu', ring_slots=2, wire_dtypes=policy)
    want = jax_plane.put(tree)
    got = _put(plane, tree)
    assert_batches_equal([got], [want])
    assert got['nested']['y'].dtype == torch.float32 and got['wide'].dtype == torch.int32
    jd, pd = jax_plane.metrics.as_dict(), plane.metrics.as_dict()
    for key in ('h2d_batches', 'h2d_degraded', 'h2d_bytes_wire', 'h2d_bytes_logical',
                'h2d_stage_count', 'h2d_dispatch_count'):
        assert pd[key] == jd[key], key
    assert pd['h2d_batches'] == 1 and pd['h2d_degraded'] == 0
    assert plane.last_put['outcome'] == jax_plane.last_put['outcome']
    if policy in (None, 'auto'):   # 64-byte alignment pads the full-width slab
        assert (pd['h2d_bytes_wire'] < pd['h2d_bytes_logical']) == (policy == 'auto')


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_bfloat16_wire_rounds_as_ml_dtypes(dtype):
    """Round to nearest even at ties, subnormals, infinities, the largest
    finite values and overflow to infinity: the delivered values equal the
    JAX plane's bit for bit."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x00008000, 0x00018000, 0x7F7FFFFF,
                     0x7F7F8000, 0xFF7F7FFF, 0x7F800000, 0xFF800000, 0x80000001, 0x3EAAAAAB],
                    np.uint32)
    special = bits.view(np.float32).astype(dtype)
    rng = np.random.default_rng(3)
    values = np.concatenate([special, (rng.standard_normal(500) * 10.0 ** rng.integers(
        -30, 30, 500)).astype(dtype)])
    tree = {'v': values, 'ids': np.arange(values.size, dtype=np.int32)}
    want = jax_transfer.TransferPlane(ring_slots=2, wire_dtypes='auto').put(tree)
    got = _put(transfer.TransferPlane('cpu', ring_slots=2, wire_dtypes='auto'), tree)
    assert_batches_equal([got], [want])
    np.testing.assert_array_equal(got['v'].numpy().view(np.uint32) & 0xFFFF, 0)


# -- the degrade matrix ---------------------------------------------------------

DEGRADE_CASES = {
    'datetime': ({'t': np.array(['2020-01-01'], 'datetime64[s]'),
                  'x': np.zeros((4,), np.float32)}, None, None),
    'single_full_width': ({'only': np.zeros((16, 4), np.float32)}, None, None),
    'zero_size': ({'a': np.zeros((4, 0), np.float32), 'b': np.zeros((4,), np.float32)},
                  None, None),
    'empty': ({}, None, None),
    'single_narrowable_rides': ({'only': np.ones((16, 4), np.float32)}, 'auto', None),
    'single_int64_is_full_width': ({'tokens': np.ones((8, 32), np.int64)}, None, None),
    'over_the_staging_cap': ({'a': np.zeros((64,), np.float32),
                              'b': np.zeros((64,), np.float32)}, None, 64),
}


@pytest.mark.parametrize('case', sorted(DEGRADE_CASES))
def test_degrade_matrix_matches_jax(case):
    tree, policy, cap = DEGRADE_CASES[case]
    jax_out = jax_transfer.TransferPlane(ring_slots=2, wire_dtypes=policy,
                                         max_staging_bytes=cap).put(tree)
    plane = transfer.TransferPlane('cpu', ring_slots=2, wire_dtypes=policy,
                                   max_staging_bytes=cap)
    got = plane.put(tree)
    assert (got is None) == (jax_out is None)
    assert plane.metrics.counter('h2d_degraded').value == int(got is None)
    if got is None:
        assert plane.last_put == {'outcome': 'degraded'}
        if case not in ('datetime', 'empty'):   # the inline put takes the numeric ones
            inline, event = plane.put_inline(tree)
            assert event is None and sorted(inline) == sorted(tree)
    else:
        assert_batches_equal([plane.ready(*got)], [jax_out])


def test_kill_switch_forces_the_inline_path(url, monkeypatch):
    monkeypatch.setenv(transfer.KILL_SWITCH, '1')
    with DataLoader(port_reader(url, True), 16, transfer=True, device='cpu') as loader:
        killed = list(loader)
        assert loader._pump is None and loader._plane is None
        assert loader.diagnostics['h2d_batches'] == 0
    monkeypatch.delenv(transfer.KILL_SWITCH)
    with DataLoader(port_reader(url, True), 16, transfer=False, device='cpu') as loader:
        inline = list(loader)
    assert_batches_equal(killed, inline)


def test_ring_cycling_never_tears_a_value():
    """A 2-slot ring through 16 distinct batches: no delivered batch holds a
    later batch's bytes, and every slot reuse waited (``h2d_commit``)."""
    plane = transfer.TransferPlane('cpu', ring_slots=2)
    delivered = [_put(plane, {'a': np.full((2048,), i, np.int32),
                              'b': np.full((64,), float(i), np.float32)}) for i in range(16)]
    for i, batch in enumerate(delivered):
        assert torch.equal(batch['a'], torch.full((2048,), i, dtype=torch.int32))
        assert torch.equal(batch['b'], torch.full((64,), float(i)))
    assert plane.metrics.as_dict()['h2d_commit_count'] >= 14
    plane.close()


# -- the pumped loader ----------------------------------------------------------

def _squeeze(batch):
    return {'matrix': batch['matrix']}


LOADER_CASES = {
    'columnar': dict(columnar=True),
    'columnar_transform': dict(columnar=True, transform=True),
    'row': dict(columnar=False),
    'row_ragged_tail': dict(columnar=False, batch_size=10, drop_last=False),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_pumped_equals_inline_equals_jax(url, case):
    spec = LOADER_CASES[case]
    kwargs = dict(drop_last=spec.get('drop_last', True),
                  transform_fn=_squeeze if spec.get('transform') else None)
    batch_size = spec.get('batch_size', 16)
    with petastorm_tpu.native.disabled():
        with JaxDataLoader(jax_reader(url, spec['columnar']), batch_size, transfer=True,
                           **kwargs) as loader:
            want = [to_numpy(b) for b in loader]
    runs = {}
    for mode in (True, False):
        with DataLoader(port_reader(url, spec['columnar']), batch_size, transfer=mode,
                        device='cpu', **kwargs) as loader:
            runs[mode] = list(loader)
            diag = loader.diagnostics
        assert diag['batches'] == len(want) == loader.stats['batches']
        assert diag['h2d_batches'] + diag.get('h2d_degraded', 0) == (len(want) if mode else 0)
    assert_batches_equal(runs[True], want)
    assert_batches_equal(runs[False], want)
    assert 'sensor_name' not in runs[True][0]


def test_packed_loader_pumped_equals_inline_equals_jax(token_url):
    def run(cls, reader, **kwargs):
        with reader:
            return [to_numpy(b) for b in cls(reader, 'tokens', max_len=512, rows_per_batch=2,
                                              drop_last=False, **kwargs)]
    want = run(JaxPackedDataLoader, jax_reader(token_url, False), transfer=True)
    pumped = run(PackedDataLoader, port_reader(token_url, False), transfer=True, device='cpu')
    inline = run(PackedDataLoader, port_reader(token_url, False), transfer=False, device='cpu')
    assert len(want) > 3
    assert_batches_equal(pumped, want)
    assert_batches_equal(inline, want)


def test_degraded_structure_rides_the_pump_thread(url):
    """A structure the plane refuses (one full-width leaf, as L1's tokens)
    is counted and moved column by column, on the pump thread."""
    recorder = TraceRecorder()
    with DataLoader(port_reader(url, True), 16, transform_fn=_squeeze, transfer=True,
                    device='cpu', trace_recorder=recorder) as loader:
        pumped = list(loader)
        pump_tid = loader._pump._thread.ident
        diag = loader.diagnostics
    with DataLoader(port_reader(url, True), 16, transform_fn=_squeeze, transfer=False,
                    device='cpu') as loader:
        assert_batches_equal(pumped, list(loader))
    assert diag['h2d_degraded'] == len(pumped) == 4 and diag['h2d_batches'] == 0
    puts = [e for e in recorder.events if e['name'] == 'device_put']
    assert len(puts) == 4 and {e['tid'] for e in puts} == {pump_tid}


def test_the_pump_thread_runs_pull_transform_and_stage(url):
    """With the plane on, ``host_batch``, ``transform`` and ``h2d/stage`` run
    on the dispatch thread; the consuming thread only waits."""
    from petastorm_tpu_torch.benchmark import StallMonitor
    recorder = TraceRecorder()
    monitor = StallMonitor(warmup_steps=0, trace_recorder=recorder)
    with DataLoader(port_reader(url, True), 16, transform_fn=lambda b: b, transfer=True,
                    device='cpu', trace_recorder=recorder) as loader:
        assert sum(1 for _ in monitor.wrap(loader)) == 4
        pump_tid = loader._pump._thread.ident
    me = threading.get_ident()
    assert pump_tid != me
    by_name = {}
    for event in recorder.events:
        by_name.setdefault(event['name'], set()).add(event['tid'])
    for name in ('host_batch', 'transform', 'h2d/stage', 'h2d/dispatch'):
        assert by_name[name] == {pump_tid}, name
    assert by_name['data_wait'] == by_name['step'] == {me}
    assert 'device_put' not in by_name


def test_early_break_leaves_no_pump_thread(url):
    with DataLoader(port_reader(url, True, num_epochs=None), 16, transfer=True,
                    device='cpu') as loader:
        for i, _ in enumerate(loader):
            if i == 2:
                break
    assert loader._pump is not None and not loader._pump.alive
    assert not [t for t in threading.enumerate() if t.name.endswith('h2d-dispatch')]


def test_a_pump_error_reaches_the_consumer(url):
    calls = {'n': 0}

    def boom(batch):
        calls['n'] += 1
        if calls['n'] == 3:
            raise RuntimeError('transform died')
        return batch

    got = []
    with DataLoader(port_reader(url, True), 16, transform_fn=boom, transfer=True,
                    device='cpu') as loader:
        with pytest.raises(RuntimeError, match='transform died'):
            for batch in loader:
                got.append(batch)
    assert len(got) == 2   # the batches queued before the error are served first
    assert not loader._pump.alive


def test_pause_quiesces_the_pump():
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield i

    pump = transfer.DispatchPump(source(), lambda x: x * 10, prefetch=2).start()
    assert pump.get() == 0
    pump.pause()
    pump.pause()   # pauses nest
    frozen = len(pulled)
    served = [pump.get() for _ in range(len(pump.pending))]
    time.sleep(0.05)
    assert len(pulled) == frozen and not pump.pending
    pump.resume()
    time.sleep(0.05)
    assert len(pulled) == frozen   # still paused once
    pump.resume()
    rest = []
    while True:
        item = pump.get()
        if item is transfer.DONE:
            break
        rest.append(item)
    assert [0] + served + rest == [10 * i for i in range(100)]
    pump.join()
    assert not pump.alive


def test_scan_batches_goes_through_the_plane(url):
    def step(carry, batch):
        return carry + batch['matrix'].sum(), batch['id']

    def run(mode):
        with DataLoader(port_reader(url, True), 16, transfer=mode, device='cpu') as loader:
            outs = [outs.numpy() for _, outs in loader.scan_batches(
                step, torch.zeros(()), steps_per_call=2)]
            return outs, loader.diagnostics
    with petastorm_tpu.native.disabled():
        with JaxDataLoader(jax_reader(url, True), 16, transfer=True) as loader:
            want = [np.asarray(outs) for _, outs in loader.scan_batches(
                lambda c, b: (c + b['matrix'].sum(), b['id']), np.zeros((), np.float32),
                steps_per_call=2)]
    planed, diag = run(True)
    inline, inline_diag = run(False)
    for got in (planed, inline):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert diag['h2d_batches'] == 2 and diag['batches'] == 4
    assert inline_diag['h2d_batches'] == 0


def test_device_inmem_materializes_through_put_once(url):
    def run(cls, reader, **kwargs):
        with reader:
            loader = cls(reader, 16, num_epochs=1, shuffle=False, **kwargs)
            return [to_numpy(b) for b in loader], loader
    with petastorm_tpu.native.disabled():
        want, _ = run(JaxDeviceInMemDataLoader, jax_reader(url, True), transfer=True)
    got, loader = run(DeviceInMemDataLoader, port_reader(url, True), transfer=True,
                      device='cpu')
    inline, inline_loader = run(DeviceInMemDataLoader, port_reader(url, True), transfer=False,
                                device='cpu')
    assert_batches_equal(got, want)
    assert_batches_equal(inline, want)
    assert loader.metrics.counter('h2d_batches').value == 1
    assert inline_loader.metrics.counter('h2d_batches').value == 0


# -- telemetry ------------------------------------------------------------------

def test_plane_spans_reach_the_recorder(url):
    recorder = TraceRecorder()
    with DataLoader(port_reader(url, True), 16, transfer=True, device='cpu',
                    trace_recorder=recorder) as loader:
        list(loader)
    names = {e['name'] for e in recorder.events if e.get('ph') == 'X'}
    assert {'h2d/stage', 'h2d/dispatch', 'h2d/commit', 'host_batch'} <= names
    # a coalesced batch has no device_put span around its h2d/* spans
    assert 'device_put' not in names


STALL_EVENTS = {
    'link_bound': [
        {'name': 'data_wait', 'ph': 'X', 'ts': 0, 'dur': 100},
        {'name': 'h2d/stage', 'ph': 'X', 'ts': 0, 'dur': 20},
        {'name': 'h2d/dispatch', 'ph': 'X', 'ts': 20, 'dur': 10},
        {'name': 'h2d/commit', 'ph': 'X', 'ts': 30, 'dur': 60}],
    'staging_bound': [
        {'name': 'data_wait', 'ph': 'X', 'ts': 0, 'dur': 50},
        {'name': 'data_wait', 'ph': 'X', 'ts': 100, 'dur': 50},
        {'name': 'h2d/stage', 'ph': 'X', 'ts': 10, 'dur': 120},
        {'name': 'device_put', 'ph': 'X', 'ts': 140, 'dur': 5},
        {'name': 'data_wait_warmup', 'ph': 'X', 'ts': 200, 'dur': 500}],
    'starved': [
        {'name': 'data_wait', 'ph': 'X', 'ts': 0, 'dur': 80},
        {'name': 'service/split_wait', 'ph': 'X', 'ts': 0, 'dur': 80},
        {'name': 'pool/process', 'ph': 'X', 'ts': 40, 'dur': 10},
        {'name': 'host_batch', 'ph': 'X', 'ts': 0, 'dur': 80}],
    'no_waits': [{'name': 'step', 'ph': 'X', 'ts': 0, 'dur': 10}],
}


@pytest.mark.parametrize('case', sorted(STALL_EVENTS))
def test_attribute_stalls_matches_jax(case):
    events = STALL_EVENTS[case]
    assert attribute_stalls(events) == jax_attribute_stalls(events)
    if case == 'link_bound':
        result = attribute_stalls(events)
        assert result['pct']['h2d'] == 70.0 and result['pct']['h2d_stage'] == 20.0
        assert result['top'] == 'h2d'
    if case == 'staging_bound':
        assert attribute_stalls(events)['top'] == 'h2d_stage'

"""The port's trace recorder, stall monitor spans and bottleneck advisor
against the JAX package's, on the CPU.

``TraceRecorder`` mirrors ``tests/test_trace.py`` (spans compose, the ring,
instants, concurrent appends, the disk-cache loader's spans); ``diagnose``
and ``format_report`` give the JAX package's regime, evidence and report
text for the same loader stats, pool diagnostics and monitor in each regime
(the remedies are the port's own); ``StallMonitor.report()`` has the JAX
monitor's keys.
"""

import json
import threading

import numpy as np
import pytest
import torch

import petastorm_tpu.native
from petastorm_tpu.benchmark import StallMonitor as JaxStallMonitor
from petastorm_tpu.benchmark import TraceRecorder as JaxTraceRecorder
from petastorm_tpu.benchmark import diagnose as jax_diagnose
from petastorm_tpu.benchmark import format_report as jax_format_report
from petastorm_tpu.jax import DataLoader as JaxDataLoader

from petastorm_tpu_torch.benchmark import StallMonitor, TraceRecorder, diagnose, format_report
from petastorm_tpu_torch.gpu import DataLoader, DiskCachedDataLoader

from torch_plane_common import jax_reader, port_reader, write_dataset

ROWS = 64
BATCH = 8


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_trace'))


def _spans_by_name(events):
    out = {}
    for ev in events:
        out.setdefault(ev['name'], []).append(ev)
    return out


@pytest.mark.parametrize('transfer', [False, True])
def test_loader_and_monitor_spans_compose(url, tmp_path, transfer):
    rec = TraceRecorder()
    mon = StallMonitor(warmup_steps=0, trace_recorder=rec)
    with port_reader(url, True) as reader:
        loader = DataLoader(reader, BATCH, trace_recorder=rec, transform_fn=lambda b: b,
                            transfer=transfer, device='cpu')
        n = sum(1 for _ in mon.wrap(loader))
    assert n == ROWS // BATCH
    spans = _spans_by_name(rec.events)
    assert len(spans['host_batch']) == len(spans['transform']) == n
    if transfer:   # the plane's spans, and no device_put around them
        assert len(spans['h2d/stage']) == len(spans['h2d/dispatch']) == n
        assert 'device_put' not in spans
    else:
        assert len(spans['device_put']) == n and 'h2d/stage' not in spans
    assert len(spans['data_wait']) == len(spans['step']) == n
    for ev in rec.events:
        assert ev['ph'] == 'X' and ev['ts'] >= 0 and ev['dur'] >= 0 and ev['pid'] and ev['tid']
    path = tmp_path / 'timeline.json'
    count = rec.dump(str(path))
    doc = json.loads(path.read_text())
    assert count == len(doc['traceEvents']) == len(rec.events)
    assert doc['displayTimeUnit'] == 'ms'


def test_scan_batches_spans(url):
    rec = TraceRecorder()
    with port_reader(url, True) as reader:
        loader = DataLoader(reader, BATCH, trace_recorder=rec, transfer=False, device='cpu')
        chunks = sum(1 for _ in loader.scan_batches(
            lambda c, b: (c, b['id'].sum()), None, steps_per_call=2))
    assert chunks == (ROWS // BATCH) // 2
    spans = _spans_by_name(rec.events)
    assert len(spans['host_batch']) == ROWS // BATCH
    assert len(spans['device_put']) == chunks
    assert all(ev['args']['chunk'] == 2 for ev in spans['device_put'])


def test_ring_keeps_latest_and_instant_markers():
    for cls in (TraceRecorder, JaxTraceRecorder):
        rec = cls(max_events=10)
        for i in range(25):
            rec.event('e', 0.0, 0.001, i=i)
        assert [ev['args']['i'] for ev in rec.events] == list(range(15, 25))
        rec.instant('epoch_boundary', epoch=3)
        assert rec.events[-1]['ph'] == 'i' and rec.events[-1]['args'] == {'epoch': 3}
        rec.set_process_label(42, 'worker w1')
        assert rec.events[-1] == {'name': 'process_name', 'ph': 'M', 'pid': 42, 'tid': 0,
                                  'args': {'name': 'worker w1'}}
        rec.clear()
        assert rec.events == []


def test_thread_safety_under_concurrent_append():
    rec = TraceRecorder(max_events=50_000)
    errs = []

    def hammer():
        try:
            for _ in range(5_000):
                rec.event('t', 0.0, 0.001)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(rec.events) == 20_000


def test_disk_cached_loader_traces(url, tmp_path):
    rec = TraceRecorder()
    with port_reader(url, True) as reader:
        loader = DiskCachedDataLoader(reader, BATCH, decoded_cache_dir=str(tmp_path / 'dc'),
                                      num_epochs=2, shuffle=False, trace_recorder=rec,
                                      transfer=False, device='cpu')
        n = sum(1 for _ in loader)
    assert n == 2 * (ROWS // BATCH)
    spans = _spans_by_name(rec.events)
    # epoch 0 (decode and write) and epoch 1 (served from the files)
    assert len(spans['host_batch']) == len(spans['device_put']) == n


# -- the advisor ----------------------------------------------------------------

class _Reader(object):
    def __init__(self, diagnostics):
        self._diagnostics = diagnostics

    @property
    def diagnostics(self):
        if self._diagnostics is None:
            raise RuntimeError('stopped')
        return self._diagnostics


class _Loader(object):
    def __init__(self, stats, diagnostics=None, reader=True):
        self.stats = stats
        self.reader = _Reader(diagnostics) if reader else None


class _Monitor(object):
    def __init__(self, report):
        self._report = report

    def report(self):
        return dict(self._report)


def _stats(host, transform, put, batches=10):
    return {'host_batch_s': host, 'transform_s': transform, 'device_put_s': put,
            'batches': batches}


REGIMES = {
    'no_batches': (_stats(0.0, 0.0, 0.0, batches=0), {'pool': 'thread'}, None),
    'chip_bound': (_stats(0.5, 0.1, 0.1), {'pool': 'thread', 'decode_utilization': 0.3},
                   {'stall_pct': 1.2, 'steps': 9, 'step_s': 0.9}),
    'decode_bound': (_stats(2.0, 0.1, 0.3), {'pool': 'thread', 'decode_utilization': 0.93},
                     {'stall_pct': 40.0, 'steps': 9, 'step_s': 0.5}),
    'io_bound': (_stats(2.0, 0.1, 0.3), {'pool': 'process', 'decode_utilization': 0.21},
                 {'stall_pct': 40.0, 'steps': 0, 'step_s': 0.0}),
    'transform_bound': (_stats(0.2, 1.5, 0.3), {'pool': 'dummy', 'decode_utilization': 0.5},
                        None),
    'transport_bound': (_stats(0.2, 0.1, 0.9), None, {'stall_pct': 12.5, 'steps': 4,
                                                     'step_s': 0.123456}),
    'no_host_time': (_stats(0.0, 0.0, 0.0), {}, None),
    'no_reader': (_stats(0.4, 0.0, 0.1), False, {'stall_pct': 3.0, 'steps': 2,
                                                  'step_s': 0.2}),
}


@pytest.mark.parametrize('case', sorted(REGIMES))
def test_diagnose_gives_the_jax_regime_evidence_and_report(case):
    stats, diag, report = REGIMES[case]
    loader = _Loader(stats, diag, reader=diag is not False)
    monitor = _Monitor(report) if report is not None else None
    got, want = diagnose(loader, monitor), jax_diagnose(loader, monitor)
    assert got['regime'] == want['regime']
    assert got['evidence'] == want['evidence']
    assert len(got['suggestions']) >= 1
    assert format_report(want) == jax_format_report(want)
    assert format_report(got).splitlines()[:2] == jax_format_report(want).splitlines()[:2]
    if case != 'no_batches':
        assert got['regime'] == case.replace('no_host_time', 'unknown').replace(
            'no_reader', 'decode_bound')


def test_diagnose_reads_a_real_loader(url):
    """The port's loader and pool expose what the advisor reads: ``stats``
    and ``decode_utilization``."""
    monitor = StallMonitor(warmup_steps=1)
    with port_reader(url, True, reader_pool_type='thread', workers_count=2) as reader:
        loader = DataLoader(reader, BATCH, transfer=True, device='cpu')
        for _ in monitor.wrap(loader):
            pass
    result = diagnose(loader, monitor)
    assert result['evidence']['batches'] == ROWS // BATCH
    assert result['evidence']['pool'] == 'thread'
    assert 0.0 < result['evidence']['decode_utilization'] <= 1.0
    diag = reader.diagnostics
    for key in ('decode_busy_s', 'decode_utilization', 'decode_p50_ms', 'decode_p99_ms',
                'items_processed', 'workers_count', 'inflight'):
        assert key in diag, key
    assert diag['items_processed'] == reader._pool.items_processed == ROWS // 8
    assert reader._pool.busy_time > 0 and diag['decode_p99_ms'] >= diag['decode_p50_ms']
    assert format_report(result).startswith('pipeline regime: ')


def test_stall_monitor_report_has_the_jax_keys(url):
    reports = {}
    for name, monitor_cls, recorder_cls in (('port', StallMonitor, TraceRecorder),
                                            ('jax', JaxStallMonitor, JaxTraceRecorder)):
        rec = recorder_cls()
        monitor = monitor_cls(warmup_steps=1, trace_recorder=rec)
        if name == 'port':
            with port_reader(url, True) as reader:
                loader = DataLoader(reader, BATCH, trace_recorder=rec, transfer=True,
                                    device='cpu')
                for _ in monitor.wrap(loader):
                    torch.ones(64, 64).sum()
        else:
            with petastorm_tpu.native.disabled(), jax_reader(url, True) as reader:
                loader = JaxDataLoader(reader, BATCH, trace_recorder=rec, transfer=True)
                for _ in monitor.wrap(loader):
                    np.ones((64, 64)).sum()
        reports[name] = monitor.report()
        names = {e['name'] for e in rec.events}
        assert {'data_wait', 'data_wait_warmup', 'step', 'step_warmup'} <= names
    assert sorted(reports['port']) == sorted(reports['jax'])
    assert sorted(reports['port']['stall_breakdown']) == sorted(reports['jax']['stall_breakdown'])
    assert reports['port']['steps'] == reports['jax']['steps'] == ROWS // BATCH - 1

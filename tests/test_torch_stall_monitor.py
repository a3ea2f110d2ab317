"""The port's StallMonitor against the JAX package's, on one fake clock:
the same wait and step times give the same report (``stall_pct`` first in
the port's)."""

import itertools
import time

import pytest

from petastorm_tpu.benchmark import StallMonitor as JaxStallMonitor

from petastorm_tpu_torch.benchmark import StallMonitor


def _report(monitor_cls, monkeypatch, annotate, batches=6):
    # three clock reads per batch: each wait takes 2 ms, each step 3 ms
    ticks = itertools.accumulate(itertools.cycle([0.002, 0.003, 0.0]), initial=100.0)
    monkeypatch.setattr(time, 'monotonic', lambda: next(ticks))
    monitor = monitor_cls(annotate=annotate, warmup_steps=2)
    seen = [batch for batch in monitor.wrap(range(batches))]
    monkeypatch.undo()
    assert seen == list(range(batches))
    return monitor.report()


@pytest.mark.parametrize('annotate', [False, True])
def test_stall_monitor_matches_jax(monkeypatch, annotate):
    got = _report(StallMonitor, monkeypatch, annotate)
    want = _report(JaxStallMonitor, monkeypatch, False)
    assert got == want
    assert list(got)[0] == 'stall_pct'
    assert got['steps'] == 4 and got['stall_pct'] == pytest.approx(40.0)

"""Step-time data-stall monitor: the share of wall time a training loop
spends waiting for its next batch.

Counterpart of ``petastorm_tpu/benchmark/stall_profiler.py::StallMonitor``.
The monitor wraps any batch iterator and attributes wall time to waiting
for data (inside ``__next__``) or to the step (between yields)::

    monitor = StallMonitor()
    for batch in monitor.wrap(loader):
        train_step(batch)            # counted as step time
    print(monitor.report())          # {'stall_pct': ..., ...}

PyTorch launches device work asynchronously, so the card is stalled only
while ``__next__`` blocks, which is what this measures.  With
``annotate=True`` each wait is a ``torch.profiler.record_function`` range
named ``petastorm_tpu.data_wait`` in a profiler trace.
"""

import time

import torch

__all__ = ['StallMonitor']


class StallMonitor(object):
    """Wait and step time of a wrapped iterator; the first
    ``warmup_steps`` pairs (pipeline fill, first compiles) are skipped."""

    def __init__(self, annotate=False, warmup_steps=1):
        self._annotate = annotate
        self._warmup_steps = warmup_steps
        self.reset()

    def reset(self):
        self.wait_time = 0.0
        self.step_time = 0.0
        self.steps = 0
        self._skipped = 0

    def wrap(self, iterable):
        iterator = iter(iterable)
        while True:
            wait_start = time.monotonic()
            try:
                if self._annotate:
                    with torch.profiler.record_function('petastorm_tpu.data_wait'):
                        batch = next(iterator)
                else:
                    batch = next(iterator)
            except StopIteration:
                return
            wait_end = time.monotonic()
            yield batch
            step_end = time.monotonic()
            if self._skipped < self._warmup_steps:
                self._skipped += 1
                continue
            self.wait_time += wait_end - wait_start
            self.step_time += step_end - wait_end
            self.steps += 1

    @property
    def stall_fraction(self):
        total = self.wait_time + self.step_time
        return (self.wait_time / total) if total > 0 else 0.0

    def report(self):
        return {
            'stall_pct': round(100.0 * self.stall_fraction, 2),
            'steps': self.steps,
            'data_wait_s': round(self.wait_time, 4),
            'step_s': round(self.step_time, 4),
        }

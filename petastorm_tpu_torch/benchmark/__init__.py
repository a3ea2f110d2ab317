"""Measurement of the training loop: the step-time data-stall monitor.

Counterpart of ``petastorm_tpu.benchmark`` (its ``StallMonitor``); the
trace recorder, ``diagnose`` and the benchmark harness are later slices.
"""

from petastorm_tpu_torch.benchmark.stall_profiler import StallMonitor

__all__ = ['StallMonitor']

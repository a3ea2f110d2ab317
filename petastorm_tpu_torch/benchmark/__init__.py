"""Measurement of the training loop: the step-time data-stall monitor, the
Chrome-trace recorder and the bottleneck advisor.

Counterpart of ``petastorm_tpu.benchmark`` (its ``StallMonitor``,
``TraceRecorder``, ``diagnose`` and ``format_report``); the benchmark
harness is a later slice.
"""

from petastorm_tpu_torch.benchmark.advisor import diagnose, format_report
from petastorm_tpu_torch.benchmark.stall_profiler import StallMonitor
from petastorm_tpu_torch.benchmark.trace import TraceRecorder

__all__ = ['StallMonitor', 'TraceRecorder', 'diagnose', 'format_report']

"""Counters, histograms, spans, decisions, provenance and health of the
data path.

Counterpart of ``petastorm_tpu.telemetry``: the metrics registry, its
Prometheus text and snapshot algebra
(:mod:`~petastorm_tpu_torch.telemetry.registry`), the scrape endpoint
(:mod:`~petastorm_tpu_torch.telemetry.scrape`), the spans that cross
process boundaries and the attribution of a consumer's data wait to them
(:mod:`~petastorm_tpu_torch.telemetry.spans`), the control plane's decision
journal (:mod:`~petastorm_tpu_torch.telemetry.decisions`), per-batch
provenance with the SLO watchdog
(:mod:`~petastorm_tpu_torch.telemetry.provenance`), the flight recorder
(:mod:`~petastorm_tpu_torch.telemetry.flight`), the health engine
(:mod:`~petastorm_tpu_torch.telemetry.health`), and the explaining tools,
each run as ``python -m petastorm_tpu_torch.telemetry.<tool>``:
``explain`` (a batch's causal chain), ``diagnose`` (verdicts over a live
fleet, a flight dump or a crash dump), ``why`` (a control-plane decision)
and ``top`` (the live fleet).  Nothing here loads torch: the service's
workers and the decode children import it.
"""

import sys

from petastorm_tpu_torch.telemetry import decisions  # noqa: F401
from petastorm_tpu_torch.telemetry import flight  # noqa: F401
from petastorm_tpu_torch.telemetry import health  # noqa: F401
from petastorm_tpu_torch.telemetry import provenance  # noqa: F401
from petastorm_tpu_torch.telemetry.registry import (Counter, Histogram, MetricsRegistry,
                                                    hist_quantile, merge_snapshots, snapshot_all,
                                                    snapshot_delta, summarize_hist)
from petastorm_tpu_torch.telemetry.spans import (STALL_COMPONENTS, SpanBuffer, attribute_stalls,
                                                 current_buffer, measure_clock_offset,
                                                 merge_into_recorder)

__all__ = ['Counter', 'Histogram', 'MetricsRegistry', 'STALL_COMPONENTS', 'SpanBuffer',
           'attribute_stalls', 'current_buffer', 'measure_clock_offset', 'merge_into_recorder',
           'hist_quantile', 'merge_snapshots', 'snapshot_all', 'snapshot_delta', 'summarize_hist',
           'dump_state', 'decisions', 'flight', 'health', 'provenance']


def dump_state():
    """One JSON-able dict of this process's telemetry, the JAX package's
    keys: every live registry's snapshot, every live trace recorder's
    events, the span buffer's residue, the flight recorder's dump, and the
    provenance and decision journals (what ``diagnose --artifact``,
    ``explain --artifact`` and ``why --artifact`` read)."""
    # a process that never imported the trace module has no recorder, and
    # importing it here would load torch (its package's stall monitor)
    trace = sys.modules.get('petastorm_tpu_torch.benchmark.trace')
    return {'registries': snapshot_all(),
            'trace_events': trace.all_recorder_events() if trace is not None else [],
            'span_residue': current_buffer().peek(),
            'flight': flight.dump_current(),
            'provenance': provenance.dump_journals(),
            'decisions': decisions.dump_journals()}

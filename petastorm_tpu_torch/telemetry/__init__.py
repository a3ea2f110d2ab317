"""Counters, histograms, spans and decisions of the data path.

Counterpart of ``petastorm_tpu.telemetry``, cut to what the loader, the
transfer plane, the stall monitor and the data service use: the metrics
registry and its Prometheus text
(:mod:`~petastorm_tpu_torch.telemetry.registry`), the scrape endpoint
(:mod:`~petastorm_tpu_torch.telemetry.scrape`), the spans that cross
process boundaries and the attribution of a consumer's data wait to them
(:mod:`~petastorm_tpu_torch.telemetry.spans`), and the control plane's
decision journal (:mod:`~petastorm_tpu_torch.telemetry.decisions`).  The
flight recorder, the health engine, provenance and the explaining tools
(``diagnose``, ``explain``, ``why``, ``top``) are not ported
(``ROADMAP.md``, Queue A item 7, the telemetry bullet).  Nothing here loads
torch: the service's workers import it.
"""

from petastorm_tpu_torch.telemetry.registry import Counter, Histogram, MetricsRegistry
from petastorm_tpu_torch.telemetry.spans import (STALL_COMPONENTS, SpanBuffer, attribute_stalls,
                                                 measure_clock_offset, merge_into_recorder)

__all__ = ['Counter', 'Histogram', 'MetricsRegistry', 'STALL_COMPONENTS', 'SpanBuffer',
           'attribute_stalls', 'measure_clock_offset', 'merge_into_recorder']

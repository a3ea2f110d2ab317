"""Counters, histograms and stall attribution of the data path.

Counterpart of ``petastorm_tpu.telemetry``, cut to what the loader, the
transfer plane and the stall monitor use: the metrics registry
(:mod:`~petastorm_tpu_torch.telemetry.registry`) and the attribution of a
consumer's data wait to the pipeline's spans
(:mod:`~petastorm_tpu_torch.telemetry.spans`).
"""

from petastorm_tpu_torch.telemetry.registry import Counter, Histogram, MetricsRegistry
from petastorm_tpu_torch.telemetry.spans import STALL_COMPONENTS, attribute_stalls

__all__ = ['Counter', 'Histogram', 'MetricsRegistry', 'STALL_COMPONENTS', 'attribute_stalls']

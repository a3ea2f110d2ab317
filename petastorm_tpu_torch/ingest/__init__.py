"""The async byte-range ingest plane under the decode workers.

Counterpart of ``petastorm_tpu/ingest``: :mod:`~petastorm_tpu_torch.ingest.
planner` turns footer metadata and the selected columns into bounded,
coalesced byte ranges; :mod:`~petastorm_tpu_torch.ingest.plane` is the
dispatch-ordered fetch pump (readahead window, hedging, per-piece degrade)
that the readers mount with ``make_reader(ingest=...)``.
"""

from petastorm_tpu_torch.ingest.plane import (INGEST_MODES, KILL_SWITCH,  # noqa: F401
                                              IngestPlane, resolve_ingest)
from petastorm_tpu_torch.ingest.planner import (IngestMissError,  # noqa: F401
                                                IngestPlanError, SparseFile, coalesce,
                                                column_chunk_ranges, plan_stats, read_exact,
                                                read_footer)

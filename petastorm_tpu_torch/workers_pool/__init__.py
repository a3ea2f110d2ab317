"""Execution plane: worker pools + ventilator.

Counterpart of ``petastorm_tpu/workers_pool/__init__.py``.
"""

DEFAULT_TIMEOUT_S = 60


class EmptyResultError(RuntimeError):
    """Raised by ``get_results`` when all work is done and queues are drained."""


class TimeoutWaitingForResultError(RuntimeError):
    """Raised by ``get_results`` when no result arrived within the timeout."""

"""Execution plane: worker pools + ventilator.

Counterpart of ``petastorm_tpu/workers_pool/__init__.py``.
"""

from collections import namedtuple

DEFAULT_TIMEOUT_S = 60


class EmptyResultError(RuntimeError):
    """Raised by ``get_results`` when all work is done and queues are drained."""


class TimeoutWaitingForResultError(RuntimeError):
    """Raised by ``get_results`` when no result arrived within the timeout."""


#: A work item and its global position, as the ventilator hands it to a pool;
#: the pool acks the position once the item's results are published.
VentilatedItem = namedtuple('VentilatedItem', ['position', 'args'])


def unpack_item(args):
    """``(position, args)`` of what a pool's ``ventilate`` received: a
    :class:`VentilatedItem`, or bare arguments (position None)."""
    if len(args) == 1 and isinstance(args[0], VentilatedItem):
        return args[0].position, tuple(args[0].args)
    return None, args

"""Retry and backoff for the data service's control-plane loops.

Counterpart of ``petastorm_tpu/utils/backoff.py``, cut to what the worker
and the client use.  Fixed retry intervals are harmless alone and a
thundering herd together: after a dispatcher blip every worker fails at the
same instant and retries in lockstep.  :class:`BackoffPolicy` is a jittered
exponential schedule; :class:`Backoff` is one retry episode of it.  Jitter
is full jitter, a delay drawn uniformly from ``[base_s, envelope]``;
:func:`jittered` spreads the cadence of healthy periodic work (heartbeats,
discovery polls).  Standard library only: the decode worker imports it.
"""

import random

__all__ = ['BackoffPolicy', 'Backoff', 'jittered', 'HEARTBEAT_POLICY', 'DISCOVERY_POLICY']


def jittered(value, spread=0.25):
    """``value`` +/- a ``spread`` fraction, uniform: a fleet configured with
    one interval must not beat in phase."""
    return value * (1.0 + spread * (2.0 * random.random() - 1.0))


class BackoffPolicy(object):
    """One retry schedule: the ``attempt``-th delay is drawn from ``[base_s,
    min(cap_s, base_s * factor ** attempt)]``; an episode gives up after
    ``max_attempts`` delays (None: never)."""

    __slots__ = ('base_s', 'cap_s', 'factor', 'max_attempts')

    def __init__(self, base_s, cap_s, factor=2.0, max_attempts=None):
        if base_s <= 0 or cap_s < base_s or factor < 1.0:
            raise ValueError('need 0 < base_s <= cap_s and factor >= 1, got base_s=%r cap_s=%r '
                             'factor=%r' % (base_s, cap_s, factor))
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self.max_attempts = None if max_attempts is None else int(max_attempts)

    def delay(self, attempt):
        ceiling = min(self.cap_s, self.base_s * (self.factor ** attempt))
        return self.base_s + (ceiling - self.base_s) * random.random()

    def episode(self):
        return Backoff(self)


class Backoff(object):
    """One retry episode: the caller sleeps (or folds into its poll timeout)
    :meth:`next_delay`, and takes its terminal path once :meth:`give_up`."""

    __slots__ = ('policy', 'attempts')

    def __init__(self, policy):
        self.policy = policy
        self.attempts = 0

    def next_delay(self):
        """The delay before the next retry, in seconds; counts the attempt."""
        delay = self.policy.delay(self.attempts)
        self.attempts += 1
        return delay

    def give_up(self):
        return self.policy.max_attempts is not None and self.attempts >= self.policy.max_attempts


#: Worker heartbeat and re-register retries: the base well under the
#: heartbeat cadence, the cap at a typical lease TTL.  ``max_attempts``
#: bounds an episode, not the worker: an exhausted episode counts one
#: ``retry_giveups`` and a fresh one begins.
HEARTBEAT_POLICY = BackoffPolicy(base_s=0.2, cap_s=5.0, factor=2.0, max_attempts=8)

#: Client discovery polls: ``base_s`` is the healthy cadence (1 Hz,
#: jittered); failures widen it toward ``cap_s``.
DISCOVERY_POLICY = BackoffPolicy(base_s=1.0, cap_s=8.0, factor=2.0)

"""Bounded shuffling reservoirs decoupling read order from delivery order.

Counterpart of ``petastorm_tpu/reader_impl/shuffling_buffer.py``:
``add_many``/``retrieve`` with ``can_add``/``can_retrieve`` flow control,
uniform draws once the buffer holds more than ``min_after_retrieve`` items,
and ``state_dict``/``load_state_dict`` (the contents and the generator's
``bit_generator.state``) for exact checkpoints.  The same seed and the same
items give the JAX package's retrieval order.
"""

from collections import deque

import numpy as np


class NoopShufflingBuffer(object):
    """FIFO passthrough."""

    def __init__(self):
        self._items = deque()
        self._done = False

    @property
    def size(self):
        return len(self._items)

    def add_many(self, items):
        self._items.extend(items)

    def retrieve(self):
        return self._items.popleft()

    def can_add(self):
        return not self._done

    def can_retrieve(self):
        return len(self._items) > 0

    def finish(self):
        self._done = True

    @property
    def finished(self):
        return self._done and not self._items

    def state_dict(self):
        return {'items': list(self._items), 'done': self._done}

    def load_state_dict(self, state):
        self._items = deque(state['items'])
        self._done = bool(state['done'])


class RandomShufflingBuffer(object):
    """Uniform-without-replacement reservoir.

    ``shuffling_buffer_capacity`` is a soft cap: ``can_add`` turns False at
    or above it.  Until ``finish()``, retrieval is allowed only while more
    than ``min_after_retrieve`` items remain, which keeps a minimum mixing
    radius.  Draws come from ``np.random.default_rng(seed)``.
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve=0, extra_capacity=0,
                 seed=None):
        if min_after_retrieve >= shuffling_buffer_capacity:
            raise ValueError('min_after_retrieve must be < capacity')
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._items = []
        self._done = False
        self._rng = np.random.default_rng(seed)

    @property
    def size(self):
        return len(self._items)

    def add_many(self, items):
        self._items.extend(items)

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError('retrieve() called when can_retrieve() is False')
        idx = int(self._rng.integers(len(self._items)))
        # O(1) removal: swap with the last item
        self._items[idx], self._items[-1] = self._items[-1], self._items[idx]
        return self._items.pop()

    def can_add(self):
        return len(self._items) < self._capacity and not self._done

    def can_retrieve(self):
        if self._done:
            return len(self._items) > 0
        return len(self._items) > self._min_after_retrieve

    def finish(self):
        self._done = True

    @property
    def finished(self):
        return self._done and not self._items

    def state_dict(self):
        """Contents and the generator's state: restoring reproduces the draws
        a seeded uninterrupted run would have made."""
        return {'items': list(self._items), 'done': self._done,
                'rng_state': self._rng.bit_generator.state}

    def load_state_dict(self, state):
        self._items = list(state['items'])
        self._done = bool(state['done'])
        self._rng.bit_generator.state = state['rng_state']

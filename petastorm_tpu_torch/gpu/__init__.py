"""The device side of the data path: loader, transfer to the card, augment,
and the step graphs that replay a step as one launch.

Counterpart of ``petastorm_tpu.jax``.
"""

from petastorm_tpu_torch.gpu import augment, graphs, packing
from petastorm_tpu_torch.gpu.loader import (DataLoader, DeviceInMemDataLoader, InMemDataLoader,
                                            PackedDataLoader)
from petastorm_tpu_torch.gpu.transfer import resolve_device

__all__ = ['DataLoader', 'InMemDataLoader', 'DeviceInMemDataLoader', 'PackedDataLoader',
           'augment', 'graphs', 'packing', 'resolve_device']

"""The device side of the data path: loader, transfer to the card, augment.

Counterpart of ``petastorm_tpu.jax``.
"""

from petastorm_tpu_torch.gpu import augment, packing
from petastorm_tpu_torch.gpu.loader import (DataLoader, DeviceInMemDataLoader, InMemDataLoader,
                                            PackedDataLoader)
from petastorm_tpu_torch.gpu.transfer import resolve_device

__all__ = ['DataLoader', 'InMemDataLoader', 'DeviceInMemDataLoader', 'PackedDataLoader',
           'augment', 'packing', 'resolve_device']

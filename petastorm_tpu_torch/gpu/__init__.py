"""The device side of the data path: loader, transfer to the card, augment,
the resident tier, and the step graphs that replay a step as one launch.

Counterpart of ``petastorm_tpu.jax``.
"""

from petastorm_tpu_torch.gpu import augment, graphs, packing, residency
from petastorm_tpu_torch.gpu.loader import (DataLoader, DeviceInMemDataLoader,
                                            DiskCachedDataLoader, InMemDataLoader,
                                            PackedDataLoader, ResidentDataLoader, make_loader)
from petastorm_tpu_torch.gpu.transfer import resolve_device

__all__ = ['DataLoader', 'InMemDataLoader', 'DeviceInMemDataLoader', 'ResidentDataLoader',
           'DiskCachedDataLoader', 'PackedDataLoader', 'make_loader',
           'augment', 'graphs', 'packing', 'residency', 'resolve_device']

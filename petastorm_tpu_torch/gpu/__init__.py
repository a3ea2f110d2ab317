"""The device side of the data path: loader, transfer to the card, augment.

Counterpart of ``petastorm_tpu.jax``.
"""

from petastorm_tpu_torch.gpu import augment
from petastorm_tpu_torch.gpu.loader import DataLoader
from petastorm_tpu_torch.gpu.transfer import resolve_device

__all__ = ['DataLoader', 'augment', 'resolve_device']

"""petastorm_tpu_torch — the PyTorch/CUDA port of petastorm_tpu.

A second package beside ``petastorm_tpu`` (the JAX reference, which it is
held against and never imports): the same readers (``make_reader`` over
petastorm datasets, NGram windows over timestamped rows included,
``make_batch_reader`` over any Parquet store, with predicates, ``filters``
and ``shard_seed``; stores written by upstream petastorm open as they are)
and decode plane, a
loader that moves batches to an NVIDIA GPU (streaming, or from an epoch
cache in host or device memory, or from a resident tier of the dataset in
HBM in its wire dtypes, or packed into fixed-shape LM batches),
on-device augmentation, exact data checkpoints (every loader's
``state_dict``/``resume_state``, ``checkpoint.TrainStateManager``, and
their elastic reshard onto another shard count), the data service's
single-tenant core (``service``: dispatcher, decode workers,
``ServiceDataLoader``), the
ResNet-50, ViT, MNIST MLP, DLRM and decoder-only LM models (with KV-cache
generation), the pandas DataFrame converter, and the flash-attention kernels as hand-written CUDA for
Hopper (``csrc/``).  Entry points run on the card unless the caller passes
``device='cpu'``.

Imports are lazy (PEP 562) so ``import petastorm_tpu_torch`` stays cheap.
"""

__version__ = '0.1.0'

_LAZY = {
    'make_reader': 'petastorm_tpu_torch.reader',
    'make_batch_reader': 'petastorm_tpu_torch.reader',
    'Reader': 'petastorm_tpu_torch.reader',
    'NGram': 'petastorm_tpu_torch.ngram',
    'TransformSpec': 'petastorm_tpu_torch.transform',
    'Unischema': 'petastorm_tpu_torch.unischema',
    'UnischemaField': 'petastorm_tpu_torch.unischema',
    'NoDataAvailableError': 'petastorm_tpu_torch.errors',
    'DataLoader': 'petastorm_tpu_torch.gpu.loader',
    'InMemDataLoader': 'petastorm_tpu_torch.gpu.loader',
    'DeviceInMemDataLoader': 'petastorm_tpu_torch.gpu.loader',
    'ResidentDataLoader': 'petastorm_tpu_torch.gpu.loader',
    'DiskCachedDataLoader': 'petastorm_tpu_torch.gpu.loader',
    'PackedDataLoader': 'petastorm_tpu_torch.gpu.loader',
    'make_loader': 'petastorm_tpu_torch.gpu.loader',
    'StallMonitor': 'petastorm_tpu_torch.benchmark.stall_profiler',
    'TraceRecorder': 'petastorm_tpu_torch.benchmark.trace',
    'train': 'petastorm_tpu_torch.train',
    'TrainStateManager': 'petastorm_tpu_torch.checkpoint',
    'reshard_reader_states': 'petastorm_tpu_torch.elastic',
    'reshard_loader_states': 'petastorm_tpu_torch.elastic',
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError('module %r has no attribute %r' % (__name__, name))

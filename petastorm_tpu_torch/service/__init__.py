"""The data service: decode on other processes or hosts, train on the card.

Counterpart of ``petastorm_tpu/service/``, cut to its single-tenant core:

* :class:`~petastorm_tpu_torch.service.dispatcher.Dispatcher`, the control
  plane: cuts the row-group list into splits, leases them to workers and
  reassigns a split when its lease expires (a worker died).
* :class:`~petastorm_tpu_torch.service.worker.Worker`, the decode plane:
  reads each leased split with the port's reader and streams its chunks
  (Arrow IPC or pickle, or shm descriptors to a consumer on the same host)
  under credit-based backpressure.  It loads neither torch nor JAX.
* :class:`~petastorm_tpu_torch.service.client.ServiceDataLoader`, the
  delivery plane: a :class:`~petastorm_tpu_torch.gpu.DataLoader` whose
  reader is the service, committing whole splits exactly once, with the
  loaders' resume tokens.
* :class:`~petastorm_tpu_torch.service.config.ServiceConfig`, the job.

Tenancy, the durable ledger, the cluster cache, the autoscaler and the
command line are not ported yet (``ROADMAP.md``, Queue A item 7).  Imports
are lazy, so that a worker process that imports this package loads no
torch.
"""

_LAZY = {
    'Dispatcher': 'petastorm_tpu_torch.service.dispatcher',
    'Worker': 'petastorm_tpu_torch.service.worker',
    'ServiceConfig': 'petastorm_tpu_torch.service.config',
    'ServiceReader': 'petastorm_tpu_torch.service.client',
    'ServiceDataLoader': 'petastorm_tpu_torch.service.client',
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError('module %r has no attribute %r' % (__name__, name))

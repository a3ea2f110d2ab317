"""The data service: decode on other processes or hosts, train on the card.

Counterpart of ``petastorm_tpu/service/``:

* :class:`~petastorm_tpu_torch.service.dispatcher.Dispatcher`, the control
  plane: cuts each job's row groups into splits, leases them to workers
  (the tenant by weighted fair share, then the split, with cache affinity),
  reassigns a split when its lease expires (a worker died), and with a
  ledger survives its own restart;
* :class:`~petastorm_tpu_torch.service.worker.Worker`, the decode plane:
  reads each leased split with the port's reader (through the cache plane
  when the job has it, or straight from the plane or a peer's with the
  cluster cache) and streams its chunks (Arrow IPC or pickle, or shm
  descriptors to a consumer on the same host) under credit-based
  backpressure and per-tenant quotas.  It loads neither torch nor JAX;
* :class:`~petastorm_tpu_torch.service.client.ServiceDataLoader`, the
  delivery plane: a :class:`~petastorm_tpu_torch.gpu.DataLoader` whose
  reader is the service, committing whole splits exactly once, with the
  loaders' resume tokens; ``register_tenant_job`` adds a tenant's job to a
  running fleet;
* :class:`~petastorm_tpu_torch.service.config.ServiceConfig`, the job;
  :mod:`~petastorm_tpu_torch.service.tenancy`,
  :mod:`~petastorm_tpu_torch.service.ledger` and
  :mod:`~petastorm_tpu_torch.service.cluster`, the shared fleet's parts;
* :mod:`~petastorm_tpu_torch.service.autoscaler`, the closed-loop
  autoscaler the dispatcher ticks; :mod:`~petastorm_tpu_torch.service.cli`,
  the command line (``python -m petastorm_tpu_torch.service.cli
  dispatcher|worker|status|drain|stop|clock``).

Every control law records its decisions in the journal
(:mod:`petastorm_tpu_torch.telemetry.decisions`), the workers ship their
spans to the clients' traces and each split's provenance record to the
client's journal, the dispatcher keeps the fleet's flight recorder and
reports its health in ``stats``, and the chaos plane's seams
(:mod:`petastorm_tpu_torch.test_util.chaos`) sit in the RPCs, the chunk
sends and the decodes.  Imports are lazy, so that a worker process that
imports this package loads no torch.
"""

_LAZY = {
    'Dispatcher': 'petastorm_tpu_torch.service.dispatcher',
    'Worker': 'petastorm_tpu_torch.service.worker',
    'ServiceConfig': 'petastorm_tpu_torch.service.config',
    'ServiceReader': 'petastorm_tpu_torch.service.client',
    'ServiceDataLoader': 'petastorm_tpu_torch.service.client',
    'register_tenant_job': 'petastorm_tpu_torch.service.client',
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError('module %r has no attribute %r' % (__name__, name))

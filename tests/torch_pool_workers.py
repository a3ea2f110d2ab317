"""Process-pool workers for the port's tests, in a module of their own: a
child unpickles a worker by importing its module, and this one imports
neither torch nor JAX, so a child starts in about a second."""

import numpy as np

from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class ArangeWorker(WorkerBase):
    """Publishes a column dict that depends on the item alone."""

    def process(self, item):
        self.publish_func({'x': np.arange(item * 10, dtype=np.int64)})

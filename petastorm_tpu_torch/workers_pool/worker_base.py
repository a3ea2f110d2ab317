"""Worker contract shared by all pools.

Counterpart of ``petastorm_tpu/workers_pool/worker_base.py``.
"""


class WorkerBase(object):
    """A unit-of-work processor owned by one pool slot.

    ``publish_func(result)`` pushes zero or more results per work item to the
    pool's results queue.  Subclasses implement ``process(*args)``.
    """

    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    def process(self, *args, **kwargs):
        raise NotImplementedError()

    def shutdown(self):
        """Called once when the pool stops; release per-worker resources."""

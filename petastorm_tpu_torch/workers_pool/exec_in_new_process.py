"""Start a function in a brand-new Python interpreter (not a fork).

Counterpart of ``petastorm_tpu/workers_pool/exec_in_new_process.py``: a
fresh ``exec`` inherits none of the parent's threads, CUDA context or
allocator state, which a forked child of a training process would.
"""

import os
import pickle
import subprocess
import sys
import tempfile


def exec_in_new_process(func, *args, **kwargs):
    """Start ``func(*args, **kwargs)`` in a new interpreter; returns the
    ``Popen``.

    The callable and its arguments must be picklable by import path (no
    lambdas or closures).  The child sees no card (``CUDA_VISIBLE_DEVICES``
    is empty): the pool's children decode on the host and never touch it.
    """
    fd, payload_path = tempfile.mkstemp(suffix='.pkl', prefix='pstpu_torch_spawn_')
    try:
        with os.fdopen(fd, 'wb') as f:
            # The parent's sys.path goes first: the child extends its own with
            # it before it unpickles (imports) the function.
            pickle.dump(sys.path, f, protocol=4)
            pickle.dump((func, args, kwargs), f, protocol=4)
        program = (
            'import os, pickle, sys\n'
            'with open(sys.argv[1], "rb") as f:\n'
            '    parent_path = pickle.load(f)\n'
            '    sys.path[:0] = [p for p in parent_path if p not in sys.path]\n'
            '    func, args, kwargs = pickle.load(f)\n'
            'os.remove(sys.argv[1])\n'
            'func(*args, **kwargs)\n'
        )
        env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
        return subprocess.Popen([sys.executable, '-c', program, payload_path], env=env)
    except BaseException:
        # The child removes the payload file once it starts; until the spawn
        # succeeds the file is still this process's to remove.
        os.unlink(payload_path)
        raise

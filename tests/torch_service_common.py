"""Shared by the port's data-service tests: a watchdog for every test that
runs the wire, decode workers in processes of their own, polling with a
deadline, and a plain Parquet store whose chunks are large enough for the
shm plane."""

import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
from petastorm_tpu_torch.service.worker import Worker
worker = Worker(sys.argv[1], cache_plane_dir=sys.argv[3] or None)
worker.install_signal_handlers()
worker.run()
assert 'torch' not in sys.modules and 'jax' not in sys.modules
"""


def watched(timeout_s):
    """Run the test body on a thread and fail it after ``timeout_s``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            errors = []

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — raised on the test's thread
                    errors.append(e)
            thread = threading.Thread(target=body, daemon=True)
            thread.start()
            thread.join(timeout_s)
            if thread.is_alive():
                raise AssertionError('%s wedged for more than %ss' % (fn.__name__, timeout_s))
            if errors:
                raise errors[0]
        return run
    return wrap


def spawn_worker(dispatcher_addr, cache_plane_dir=None, env=None):
    """A port decode worker in a process of its own (SIGTERM drains it)."""
    env = dict(os.environ if env is None else env, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    return subprocess.Popen([sys.executable, '-c', _WORKER_CHILD, dispatcher_addr, REPO,
                             cache_plane_dir or ''],
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def reap(*procs):
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def wait_for(predicate, timeout_s, what):
    """Poll ``predicate`` until it holds; fail after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError('timed out waiting for %s' % what)


def host_ids(loader):
    with loader:
        return [i for b in loader.iter_host_batches() for i in np.asarray(b['id']).tolist()]


def write_raw(path, rows=96, group=16, seed=0):
    """Plain Parquet of ids and 64x64x3 uint8 images in row groups of
    ``group``: ~200 kB chunks, above the shm plane's floor."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(path, exist_ok=True)
    img = np.random.default_rng(seed).integers(0, 255, (rows, 64 * 64 * 3), dtype=np.uint8)
    pq.write_table(pa.table({'id': np.arange(rows), 'img': list(img)}),
                   os.path.join(path, 'data.parquet'), row_group_size=group)
    return 'file://%s' % path


_DISPATCHER_CHILD = r"""
import json, sys, threading
sys.path.insert(0, sys.argv[1])
from petastorm_tpu_torch.service.config import ServiceConfig
from petastorm_tpu_torch.service.dispatcher import Dispatcher
dispatcher = Dispatcher(ServiceConfig(**json.loads(sys.argv[3])), bind=sys.argv[2]).start()
print('READY', flush=True)
dispatcher.join()
assert 'torch' not in sys.modules and 'jax' not in sys.modules
"""


def free_tcp_addr():
    """A ``tcp://127.0.0.1:<port>`` free now (a restarted dispatcher binds the
    same address)."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return 'tcp://127.0.0.1:%d' % s.getsockname()[1]


def spawn_dispatcher(addr, config_kwargs):
    """A port dispatcher in a process of its own, bound to ``addr``; returns
    once it serves."""
    import json
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    proc = subprocess.Popen([sys.executable, '-c', _DISPATCHER_CHILD, REPO, addr,
                             json.dumps(config_kwargs)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    line = proc.stdout.readline()
    if line.strip() != b'READY':
        proc.kill()
        raise AssertionError('the dispatcher did not start: %s'
                             % proc.stderr.read().decode()[-2000:])
    return proc


def drop_hot_tiers(root):
    """Remove the /dev/shm hot tiers of every cache plane under ``root``, the
    port's and the JAX package's (a hot tier outlives the test that made it)."""
    import shutil

    from petastorm_tpu_torch.cache_plane.plane import default_ram_dir
    for where, dirs, _ in os.walk(str(root)):
        for d in [where] + [os.path.join(where, d) for d in dirs]:
            hot = default_ram_dir(d)
            # and the JAX package's, which names it with its own prefix
            for path in (hot, hot.replace('pstpu-torch-cache-', 'pstpu-cache-')):
                shutil.rmtree(path, ignore_errors=True)

"""Decode workers in processes of their own, over ZeroMQ PUSH/PULL sockets.

Counterpart of ``petastorm_tpu/workers_pool/process_pool.py`` (its metrics
registry, reorder stage and provenance records are not ported; three plain
counters stand in for the registry).  The parent binds a work PUSH socket
and a sink PULL socket; each worker is a fresh interpreter
(:func:`~.exec_in_new_process.exec_in_new_process`) that takes pickled work
items and sends back its results: pickled row lists and column dicts, Arrow
IPC for tables (``reader_impl/*_serializer.py``).

Work items go out only once every worker has connected, and one at a time
to a worker with room (high-water mark 1 at both ends of the work socket):
a PUSH socket otherwise queues them all at the first worker to connect.

Results go through the **shared-memory plane** (``workers_pool/shm_plane.py``)
when the host has a usable ``/dev/shm``: a worker places the payload in a
slab and sends only its descriptor, and the parent maps views of it.  A
small result or a full arena falls back to the byte path per message.

Decode then runs outside the training process's interpreter lock: the
thread that launches the step shares the lock with nothing but the pool's
receive loop.
"""

import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import uuid

import zmq

from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.workers_pool import (DEFAULT_TIMEOUT_S, EmptyResultError,
                                              TimeoutWaitingForResultError, shm_plane,
                                              unpack_item)
from petastorm_tpu_torch.workers_pool.exec_in_new_process import exec_in_new_process
from petastorm_tpu_torch.workers_pool.process_worker import worker_main


class ProcessPool(object):
    """``workers_count`` worker processes; the pool's own surface is the
    thread pool's (``start``, ``ventilate``, ``get_results``, ``stop``,
    ``join``).

    Results go through the shm plane when ``/dev/shm`` is usable, each
    worker's arena holding :data:`shm_plane.DEFAULT_CAPACITY_BYTES`.
    ``zmq_copy_buffers=False`` sends byte-path payloads without ZeroMQ's
    copy.
    """

    def __init__(self, workers_count=10, results_queue_size=50, zmq_copy_buffers=True):
        self.workers_count = workers_count
        self.results_queue_size = results_queue_size
        self._zmq_copy_buffers = zmq_copy_buffers
        #: Work items acked by the workers.
        self.items_processed = 0
        #: Seconds the workers spent in ``worker.process``, summed.
        self.busy_time = 0.0
        #: The items after each worker's first, and their busy seconds: a
        #: first item also pays the fresh interpreter's imports and first
        #: touches, so these two read a warm pool.
        self.warm_items = 0
        self.warm_busy_time = 0.0
        #: Results that arrived as shm descriptors (the rest took the byte path).
        self.shm_results = 0
        self._context = None
        self._work_socket = None
        self._sink_socket = None
        self._poller = None
        self._connections = None   # monitor of the work socket's accepted connections
        self._connected = 0
        self._endpoint_dir = None
        self._processes = []
        self._ventilator = None
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._stopped = False
        self._started_at = None
        self._stopped_at = None

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        """Spawn the workers.  Raises, with nothing left bound or spawned,
        when ``worker_class`` or ``worker_setup_args`` cannot be pickled
        (a transform that is a closure, say)."""
        self._started_at = time.monotonic()
        self._pickle_ser = PickleSerializer()
        self._arrow_ser = ArrowTableSerializer()
        endpoint_dir = tempfile.mkdtemp(prefix='pstpu_torch_zmq_')
        work_addr = 'ipc://%s' % os.path.join(endpoint_dir, 'work_' + uuid.uuid4().hex[:8])
        sink_addr = 'ipc://%s' % os.path.join(endpoint_dir, 'sink_' + uuid.uuid4().hex[:8])
        try:
            # The parent's pid rides the payload: a child that read
            # getppid() after its start-up could see a reaper's pid if the
            # parent died meanwhile.
            setup_payload = pickle.dumps(
                (worker_class, worker_setup_args, work_addr, sink_addr,
                 self._zmq_copy_buffers, shm_plane.available(), shm_plane.DEFAULT_CAPACITY_BYTES,
                 os.getpid()), protocol=4)
        except Exception:
            shutil.rmtree(endpoint_dir, ignore_errors=True)
            raise
        self._endpoint_dir = endpoint_dir
        self._context = zmq.Context()
        self._work_socket = self._context.socket(zmq.PUSH)
        # A PUSH socket deals each item to the next worker whose pipe has
        # room: a high-water mark of 1 (here and at the workers' end) keeps
        # items off a busy worker's queue while another one idles.
        self._work_socket.setsockopt(zmq.SNDHWM, 1)
        self._connections = self._work_socket.get_monitor_socket(zmq.EVENT_ACCEPTED)
        self._work_socket.bind(work_addr)
        self._sink_socket = self._context.socket(zmq.PULL)
        self._sink_socket.set_hwm(self.results_queue_size)
        self._sink_socket.bind(sink_addr)
        self._poller = zmq.Poller()
        self._poller.register(self._sink_socket, zmq.POLLIN)
        for worker_id in range(self.workers_count):
            self._processes.append(exec_in_new_process(worker_main, setup_payload, worker_id))
        self._ventilator = ventilator
        if ventilator is not None:
            ventilator.start()

    def ventilate(self, *args, **kwargs):
        with self._inflight_lock:
            self._inflight += 1
        # the position rides the work message and comes back in the ack
        position, args = unpack_item(args)
        message = pickle.dumps((position, args, kwargs), protocol=4)
        self._await_workers()
        # A send blocks while no worker has room: poll, so that stop() ends
        # the ventilator whatever the workers do.
        while not self._stopped:
            try:
                self._work_socket.send(message, flags=zmq.NOBLOCK)
                return
            except zmq.Again:
                time.sleep(0.005)

    def _await_workers(self):
        """Until every worker has connected (or one died, or stop()): items
        sent earlier would all queue at the first worker to connect, the
        others idling while it works through them."""
        while self._connected < len(self._processes) and not self._stopped:
            if self._connections.poll(50):
                self._connections.recv_multipart()
                self._connected += 1
            elif any(p.poll() is not None for p in self._processes):
                return

    def get_results(self, timeout=DEFAULT_TIMEOUT_S):
        """Next result; EmptyResultError once the ventilator completed and
        every item is acked.  A worker's exception is raised here."""
        waited_ms = 0
        while True:
            if self._poller.poll(50):
                frames = self._sink_socket.recv_multipart()
                tag, payload = frames[0], frames[1]
                if tag == b'R':
                    return self._pickle_ser.deserialize(payload)
                if tag == b'A':
                    return self._arrow_ser.deserialize(payload)
                if tag in (b'P', b'T'):
                    try:
                        result = shm_plane.read_payload(pickle.loads(payload))
                    except shm_plane.SegmentVanishedError as e:
                        # Workers unlink slabs only at stop: a vanished one
                        # means its writer died after publishing.
                        raise shm_plane.SegmentVanishedError(
                            e.errno, 'shm result slab vanished before the parent read it: '
                            'did a worker process die? (%s)' % e)
                    self.shm_results += 1
                    return result
                if tag == b'K':
                    position, busy_s, first = pickle.loads(payload)
                    with self._inflight_lock:
                        self._inflight -= 1
                    self.items_processed += 1
                    self.busy_time += busy_s
                    if not first:
                        self.warm_items += 1
                        self.warm_busy_time += busy_s
                    if self._ventilator is not None:
                        self._ventilator.processed_item(position)
                    continue
                if tag == b'E':
                    exc, tb_str = pickle.loads(payload)
                    sys.stderr.write(tb_str)
                    raise exc
                raise RuntimeError('unknown sink tag %r' % (tag,))
            if self._all_done():
                raise EmptyResultError()
            dead = [p for p in self._processes if p.poll() is not None]
            with self._inflight_lock:
                inflight = self._inflight
            if dead and inflight > 0:
                raise TimeoutWaitingForResultError(
                    '%d worker process(es) died (exit codes %s) with %d items in flight'
                    % (len(dead), [p.returncode for p in dead], inflight))
            waited_ms += 50
            if waited_ms >= timeout * 1000:
                raise TimeoutWaitingForResultError(
                    'no results within %ss; %d in flight, %d of %d workers alive'
                    % (timeout, inflight, sum(p.poll() is None for p in self._processes),
                       len(self._processes)))

    def _all_done(self):
        if self._ventilator is not None and not self._ventilator.completed():
            return False
        with self._inflight_lock:
            return self._inflight == 0

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self._stopped_at = time.monotonic()
        if self._ventilator is not None:
            self._ventilator.stop()
        self._send_stops(len(self._processes))

    def _send_stops(self, count):
        if self._work_socket is None:
            return
        for _ in range(count):
            try:
                self._work_socket.send_multipart([b'', b'STOP'], flags=zmq.NOBLOCK)
            except zmq.Again:
                return   # no worker connected

    def join(self, timeout=10.0):
        """Wait for every worker, killing those still alive after
        ``timeout`` seconds; reclaim the slabs of any that died; close the
        sockets."""
        deadline = time.monotonic() + timeout
        alive = [p for p in self._processes if p.poll() is None]
        while alive and time.monotonic() < deadline:
            # A PUSH socket deals each STOP to one of the workers connected
            # when it was sent: one that connected later got none.
            self._send_stops(len(alive))
            time.sleep(0.05)
            alive = [p for p in alive if p.poll() is None]
        for process in alive:
            process.kill()
            process.wait()
        # Workers unlink their own arenas on STOP; the sweep is for killed ones.
        if self._processes:
            shm_plane.sweep_orphans()
        if self._connections is not None:
            self._work_socket.disable_monitor()
            self._connections.close(0)
            self._connections = None
        if self._work_socket is not None:
            self._work_socket.close(0)
        if self._sink_socket is not None:
            self._sink_socket.close(0)
        if self._context is not None:
            self._context.term()
        self._work_socket = self._sink_socket = self._context = None
        if self._endpoint_dir is not None:
            shutil.rmtree(self._endpoint_dir, ignore_errors=True)
            self._endpoint_dir = None

    @property
    def diagnostics(self):
        end = self._stopped_at if self._stopped_at is not None else time.monotonic()
        wall = (end - self._started_at) if self._started_at else 0.0
        return {'pool': 'process', 'workers_count': self.workers_count,
                # the workers' busy share of their wall time since start (to
                # stop), their start-up included, as the JAX pool reads it
                'decode_utilization': round(self.busy_time / (wall * self.workers_count), 4)
                if wall else 0.0,
                'items_processed': self.items_processed, 'busy_time': self.busy_time,
                'warm_items': self.warm_items, 'warm_busy_time': self.warm_busy_time,
                'shm_results': self.shm_results,
                'worker_pids': [p.pid for p in self._processes],
                'workers_alive': sum(p.poll() is None for p in self._processes)}

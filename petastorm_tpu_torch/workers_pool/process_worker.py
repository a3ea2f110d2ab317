"""Child-process main loop of :class:`~.process_pool.ProcessPool`.

Counterpart of ``petastorm_tpu/workers_pool/process_worker.py`` (its
registry snapshots and spans on the ack are not ported).  The child
connects to the parent's ZeroMQ sockets, takes pickled work items,
publishes each result, and acks each item so that the parent's ventilator
can refill.  Multipart framing:

  work (parent -> worker):  [pickle((position, args, kwargs))] | [b'', b'STOP']
  sink (worker -> parent):  [tag, payload]
      tag b'R'  pickle-serialized result
      tag b'A'  Arrow-IPC-serialized ``pyarrow.Table`` result
      tag b'P'  shm descriptor of a result (``workers_pool/shm_plane.py``):
                a dict of columns as ``write_columns``, anything else as a
                protocol-5 pickle with its array buffers in the slab
      tag b'T'  shm descriptor of an Arrow-IPC-written ``pyarrow.Table``
      tag b'K'  ack: pickle((position, busy_seconds, first)), the wall time
                of ``worker.process`` for the item, and whether it was this
                worker's first (whose time holds the worker's cold start)
      tag b'E'  error: pickle((exception, traceback_str))

A result message (``R``, ``A``, ``P``, ``T``) may carry trailing frames:

  [tag, payload, pickle(position)]                      a reorder stage
  [tag, payload, pickle(position), pickle(record)]      provenance on

The position frame lets the parent restore the epoch order; it rides
whenever the pool has a reorder stage or provenance is on (the parent then
pairs the record with its result).  The record frame is the item's
provenance record (its piece, this child's pid and host, the cache
outcome, the transport, ``shm`` or ``bytes``, and the ``decode`` and
``ipc`` windows).  Under ``PETASTORM_TPU_NO_PROVENANCE=1`` the child sends
neither the record frame nor, without a reorder stage, the position frame:
the framing and the payload frames are those without provenance, byte for
byte.

The shm tags are per message: a small result, a full arena or an unusable
``/dev/shm`` sends that message with the matching byte tag, and the parent
reads all four at all times.

Importing this module, or unpickling the reader's worker, loads no
``torch``: a child decodes on the host and starts in about a second.
"""

import os
import pickle
import time
import traceback


def worker_main(setup_payload, worker_id):
    import pyarrow as pa
    import zmq

    from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
    from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
    from petastorm_tpu_torch.telemetry import provenance
    from petastorm_tpu_torch.workers_pool import shm_plane

    payload = pickle.loads(setup_payload)
    worker_class, worker_args, work_addr, sink_addr, copy_buffers, use_shm, \
        shm_capacity, parent_pid = payload[:8]
    # positioned result frames for the parent's reorder stage (a payload
    # without the flag has none)
    reorder = payload[8] if len(payload) > 8 else False
    current_position = [None]
    prov_on = provenance.enabled()
    current_started = [None]     # the item's start
    current_args = [None]        # the item's arguments (its piece)
    current_publish_t = [None]   # the start of the publish being sent
    cache_before = [None]        # the cache's counters before the item

    context = zmq.Context()
    work_socket = context.socket(zmq.PULL)
    work_socket.setsockopt(zmq.RCVHWM, 1)   # see ProcessPool.start
    work_socket.connect(work_addr)
    sink_socket = context.socket(zmq.PUSH)
    sink_socket.connect(sink_addr)

    pickle_ser = PickleSerializer()
    arrow_ser = ArrowTableSerializer()
    arena = shm_plane.ShmArena(capacity_bytes=shm_capacity) \
        if use_shm and shm_plane.available() else None

    def cache_stats():
        return provenance.cache_stats(getattr(worker, '_a', None))

    def send(frames, transport, copy=True):
        if reorder or prov_on:
            frames = frames + [pickle.dumps(current_position[0], protocol=4)]
        if prov_on:
            now = time.monotonic()
            t_pub = current_publish_t[0] or now
            stages = {'ipc': [t_pub, now]}
            if current_started[0] is not None:
                stages['decode'] = [current_started[0], t_pub]
            record = provenance.make_record(
                'pool', position=current_position[0], worker_pid=os.getpid(),
                worker_host=provenance.host(),
                pieces=provenance.piece_info(getattr(worker, '_a', None), current_args[0]),
                cache=provenance.cache_outcome(cache_before[0], cache_stats()),
                transport=transport, stages=stages)
            record['_staged_t'] = now
            frames = frames + [pickle.dumps(record, protocol=4)]
        sink_socket.send_multipart(frames, copy=copy)

    def publish(result):
        current_publish_t[0] = time.monotonic()
        if isinstance(result, pa.Table):
            desc = shm_plane.write_table(arena, result, arrow_ser) if arena else None
            if desc is not None:
                send([b'T', pickle.dumps(desc, protocol=4)], 'shm')
            else:
                send([b'A', arrow_ser.serialize(result)], 'bytes', copy=copy_buffers)
            return
        desc = None
        if arena is not None:
            desc = shm_plane.write_columns(arena, result) if isinstance(result, dict) \
                else shm_plane.write_pickled(arena, result, pickle_ser)
        if desc is not None:
            send([b'P', pickle.dumps(desc, protocol=4)], 'shm')
        else:
            send([b'R', pickle_ser.serialize(result)], 'bytes', copy=copy_buffers)

    worker = worker_class(worker_id, publish, worker_args)
    # A parent killed with SIGKILL never sends STOP: poll with a timeout and
    # leave once the parent is gone (getppid() no longer the pool's pid,
    # which rides the payload because a child that read getppid() after its
    # slow start-up could record the reaper's pid instead).
    poller = zmq.Poller()
    poller.register(work_socket, zmq.POLLIN)
    first = True
    try:
        while True:
            if not dict(poller.poll(2000)):
                if os.getppid() != parent_pid:
                    break
                continue
            frames = work_socket.recv_multipart()
            if frames[-1] == b'STOP':
                break
            position, args, kwargs = pickle.loads(frames[0])
            current_position[0] = position
            started = time.monotonic()
            if prov_on:
                current_started[0] = started
                current_args[0] = args
                current_publish_t[0] = None
                cache_before[0] = cache_stats()
            sleep_before = getattr(worker, 'retry_sleep_s', 0.0)
            try:
                worker.process(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — shipped to the parent
                sink_socket.send_multipart([b'E', pickle.dumps((e, traceback.format_exc()))])
            finally:
                # retry back-off sleeps are waiting, not decoding
                slept = getattr(worker, 'retry_sleep_s', 0.0) - sleep_before
                busy = max(0.0, time.monotonic() - started - slept)
                sink_socket.send_multipart([b'K', pickle.dumps((position, busy, first))])
                first = False
    finally:
        worker.shutdown()
        if arena is not None:
            # A clean shutdown leaves no /dev/shm entry; the parent's
            # mappings keep the pages of any payload it still reads.
            arena.stop()
        work_socket.close(0)
        sink_socket.close(0)
        context.term()

"""Host -> device transfer of loader batches.

Counterpart of ``petastorm_tpu/jax/transfer.py``.  A batch (a dict of numpy
columns) reaches the card in four steps:

1. each column is copied into a page-locked (pinned) staging buffer of a
   small ring, narrowed on the way by the JAX package's dtype rule (int64
   -> int32, uint64 -> uint32, float64 -> float32: ``jax.dtypes.
   canonicalize_dtype`` without x64, transfer.py:235); uint8 images stay
   uint8;
2. a ``non_blocking`` copy on a dedicated copy stream moves it to the card,
   so the copy of batch N+1 overlaps the training step on batch N;
3. an event recorded on the copy stream is what the consumer's stream
   waits on before it touches the batch (:meth:`TransferPlane.ready`);
4. a ring slot is rewritten only after the copy that last read it finished.

On the CPU (``device='cpu'``, the tests) the batch is only narrowed and
wrapped.  Wire-dtype narrowing to bf16, coalescing into one slab, sharding
and the telemetry spans are later slices.
"""

import numpy as np
import torch

__all__ = ['resolve_device', 'canonical_dtype', 'TransferPlane']

_CANONICAL = {np.dtype('int64'): np.dtype('int32'),
              np.dtype('uint64'): np.dtype('uint32'),
              np.dtype('float64'): np.dtype('float32')}


def resolve_device(device=None):
    """The port's entry points run on the card: ``None`` means ``cuda``, and
    asking for the card where there is none raises.  Pass ``device='cpu'``
    to run on the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; petastorm_tpu_torch runs on the '
                           'card by default: pass device="cpu" to run on the CPU')
    return device


def canonical_dtype(dtype):
    """The dtype a column has on the device (JAX's rule without x64)."""
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


class TransferPlane(object):
    """Moves host batches to ``device`` through a ring of ``ring_slots``
    pinned staging slots and a dedicated copy stream."""

    def __init__(self, device, ring_slots=4):
        self.device = torch.device(device)
        self._cuda = self.device.type == 'cuda'
        self._slots = [{'buffers': {}, 'event': None} for _ in range(max(2, int(ring_slots)))]
        self._next = 0
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None

    def put(self, host_batch):
        """Start moving ``{name: ndarray}`` to the device; returns
        ``(batch, event)`` for :meth:`ready` (event is None on the CPU)."""
        if not self._cuda:
            return {name: torch.from_numpy(np.asarray(arr).astype(canonical_dtype(arr.dtype)))
                    for name, arr in host_batch.items()}, None
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot['event'] is not None:
            slot['event'].synchronize()   # the copy that last read this slot is done
        out = {}
        with torch.cuda.stream(self._stream):
            for name, arr in host_batch.items():
                arr = np.asarray(arr)
                dtype = canonical_dtype(arr.dtype)
                buf = slot['buffers'].get(name)
                if buf is None or tuple(buf.shape) != arr.shape \
                        or buf.numpy().dtype != dtype:
                    buf = torch.from_numpy(np.empty(arr.shape, dtype)).pin_memory()
                    slot['buffers'][name] = buf
                np.copyto(buf.numpy(), arr, casting='unsafe')
                out[name] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot['event'] = event
        return out, event

    def ready(self, batch, event):
        """Make the current stream wait for ``batch``'s copy and hand it over."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for tensor in batch.values():
                # allocated on the copy stream, used on this one: keep the
                # allocator from reusing the memory before this stream is done
                tensor.record_stream(stream)
        return batch

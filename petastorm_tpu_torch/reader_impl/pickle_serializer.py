"""Pickle wire format for cross-process results.

Counterpart of ``petastorm_tpu/reader_impl/pickle_serializer.py``.  The
``_oob`` pair is the shm plane's form of the same framing: protocol-5
pickling with the large (numpy) buffers taken out of band, so
``workers_pool/shm_plane.py`` can place their raw bytes in a shared-memory
slab and the consumer can rebuild zero-copy views over the mapping.
"""

import pickle


class PickleSerializer(object):
    def serialize(self, rows):
        return pickle.dumps(rows, protocol=4)

    def serialize_oob(self, rows):
        """``(head, buffers)``: a small in-band pickle plus the raw
        out-of-band buffers (C-contiguous array payloads)."""
        buffers = []
        head = pickle.dumps(rows, protocol=5, buffer_callback=buffers.append)
        return head, [b.raw() for b in buffers]

    def deserialize_oob(self, head, buffers):
        """Inverse of :meth:`serialize_oob`; arrays come back as views over
        ``buffers``."""
        return pickle.loads(head, buffers=buffers)

    def deserialize(self, serialized_rows):
        return pickle.loads(serialized_rows)

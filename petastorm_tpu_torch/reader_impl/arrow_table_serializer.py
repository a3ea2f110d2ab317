"""Arrow IPC stream wire format for ``pyarrow.Table`` results.

Counterpart of ``petastorm_tpu/reader_impl/arrow_table_serializer.py``.
The shm plane (``workers_pool/shm_plane.py``) writes the same stream in
place: :meth:`serialized_size` sizes it with a counting pass,
:meth:`serialize_into` writes the table's buffers straight into the slab,
and :meth:`deserialize` over the mapped view gives a table whose buffers
reference the shared pages.
"""

import pyarrow as pa


class ArrowTableSerializer(object):
    def serialize(self, table):
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.getvalue()

    def serialized_size(self, table):
        """Exact IPC stream size, from a pass that writes nothing."""
        sink = pa.MockOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.size()

    def serialize_into(self, table, buf):
        """IPC-write ``table`` into ``buf`` (a writable buffer of at least
        ``serialized_size(table)`` bytes), with no intermediate buffer."""
        sink = pa.FixedSizeBufferWriter(pa.py_buffer(buf))
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)

    def deserialize(self, serialized):
        with pa.ipc.open_stream(pa.BufferReader(serialized)) as reader:
            return reader.read_all()

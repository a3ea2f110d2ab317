"""Byte-range fetch planning from Parquet footer metadata.

Counterpart of ``petastorm_tpu/ingest/planner.py``: the pure-planning half
of the ingest plane.  Given a file's footer metadata and the selected
columns it names the byte ranges a row group's decode touches (column-chunk
offsets, dictionary pages included), merges near ranges into bounded reads
(:func:`coalesce`), and provides the in-memory file view
(:class:`SparseFile`) that lets pyarrow decode from fetched bytes alone.
Nothing here touches a filesystem: :func:`read_footer` reads only the
handle it is given.
"""

import pyarrow.parquet as pq

__all__ = ['IngestMissError', 'IngestPlanError', 'SparseFile', 'coalesce',
           'column_chunk_ranges', 'plan_stats', 'read_footer', 'read_exact']

PARQUET_MAGIC = b'PAR1'

#: First guess at how much file tail covers footer + magic.  64 KiB
#: covers every footer this repo writes; bigger footers trigger exactly
#: one follow-up read of the precise length.
FOOTER_TAIL_GUESS = 64 << 10

#: Ranges closer than this merge into one GET: reading the gap is
#: cheaper than a second request's first-byte latency on object stores.
DEFAULT_MERGE_GAP = 64 << 10

#: No single GET grows past this — bounds per-request memory and keeps
#: a hedged retry of one range affordable.
DEFAULT_MAX_RANGE_BYTES = 16 << 20


class IngestPlanError(RuntimeError):
    """The footer could not be parsed into a fetch plan (not a Parquet
    file, truncated tail, row group out of range)."""


class IngestMissError(RuntimeError):
    """A decode read landed outside the fetched ranges — the plan missed
    bytes the reader needed.  Deliberately NOT an OSError: the retry
    layer treats OSErrors as transient wire failures, and a plan miss
    must degrade to the synchronous path instead of burning retries."""


def read_exact(handle, nbytes):
    """Read exactly ``nbytes`` (looping over short reads); raises
    OSError on EOF — a truncated remote body is a fetch failure."""
    out = []
    remaining = int(nbytes)
    while remaining > 0:
        data = handle.read(remaining)
        if not data:
            raise OSError('short read: %d bytes missing' % remaining)
        out.append(data)
        remaining -= len(data)
    return b''.join(out)


def read_footer(handle, size):
    """Read + parse a Parquet footer from an open binary handle.

    Returns ``(metadata, tail_offset, tail_bytes)`` — the parsed
    ``FileMetaData`` plus the raw tail segment, which every piece's
    :class:`SparseFile` re-uses so ``pq.ParquetFile`` can re-parse the
    footer from memory (no second remote read, and version-proof against
    ParquetFile constructors that insist on reading it themselves).
    """
    size = int(size)
    if size < 12:
        raise IngestPlanError('file too small to be Parquet (%d bytes)' % size)
    tail_len = min(size, FOOTER_TAIL_GUESS)
    handle.seek(size - tail_len)
    tail = read_exact(handle, tail_len)
    if tail[-4:] != PARQUET_MAGIC:
        raise IngestPlanError('missing Parquet magic in file tail')
    footer_len = int.from_bytes(tail[-8:-4], 'little')
    need = footer_len + 8
    if need > size:
        raise IngestPlanError('footer length %d exceeds file size %d'
                              % (footer_len, size))
    if need > tail_len:
        handle.seek(size - need)
        tail = read_exact(handle, need)
        tail_len = need
    tail_offset = size - tail_len
    try:
        metadata = pq.read_metadata(SparseFile(size, {tail_offset: tail}))
    except Exception as e:
        raise IngestPlanError('unparseable Parquet footer: %s' % e) from e
    return metadata, tail_offset, tail


def column_chunk_ranges(metadata, row_group, columns=None):
    """Raw (uncoalesced) ``(offset, length)`` ranges of one row group's
    column chunks, restricted to the top-level ``columns`` names when
    given (``None`` = all).

    Nested columns match on the root of ``path_in_schema`` so a selected
    list/struct column brings all of its leaves.  When a non-empty
    selection matches NOTHING (schema drift between the footer and the
    caller's view), the whole row group is planned instead — over-fetch
    is correct, a missing page is not.
    """
    if not 0 <= int(row_group) < metadata.num_row_groups:
        raise IngestPlanError('row group %d out of range [0, %d)'
                              % (row_group, metadata.num_row_groups))
    rg = metadata.row_group(int(row_group))
    ranges = []
    for i in range(rg.num_columns):
        col = rg.column(i)
        if columns is not None:
            root = col.path_in_schema.split('.', 1)[0]
            if root not in columns:
                continue
        start = col.data_page_offset
        dictionary = col.dictionary_page_offset
        if dictionary is not None and 0 <= dictionary < start:
            start = dictionary
        length = col.total_compressed_size
        if length and length > 0:
            ranges.append((int(start), int(length)))
    if columns is not None and not ranges:
        return column_chunk_ranges(metadata, row_group, None)
    return ranges


def coalesce(ranges, merge_gap=DEFAULT_MERGE_GAP,
             max_range_bytes=DEFAULT_MAX_RANGE_BYTES):
    """Merge nearby ``(offset, length)`` ranges into bounded GETs.

    Adjacent or ``merge_gap``-close ranges merge (the gap bytes are
    fetched too — cheaper than another request); no merged range grows
    past ``max_range_bytes``, and a single oversize range is SPLIT into
    ``max_range_bytes`` reads so one giant column chunk can't turn into
    one unbounded transfer.
    """
    merge_gap = int(merge_gap)
    max_range_bytes = max(1, int(max_range_bytes))
    merged = []
    for start, length in sorted((int(s), int(n)) for s, n in ranges):
        if length <= 0:
            continue
        end = start + length
        if merged:
            last_start, last_end = merged[-1]
            if start - last_end <= merge_gap \
                    and max(end, last_end) - last_start <= max_range_bytes:
                merged[-1] = (last_start, max(last_end, end))
                continue
        merged.append((start, end))
    out = []
    for start, end in merged:
        while end - start > max_range_bytes:
            out.append((start, max_range_bytes))
            start += max_range_bytes
        out.append((start, end - start))
    return out


def plan_stats(raw_ranges, coalesced_ranges):
    """Gap/waste accounting of one coalesced plan vs its raw ranges.

    ``needed_bytes`` is what the columns actually occupy (the raw
    chunks); ``fetched_bytes`` is what the coalesced GETs transfer;
    their difference is ``waste_bytes`` — merge-gap filler plus any
    layout-induced interleaving the merge had to ride over.  It feeds the
    ingest plane's waste counters and gauge.
    """
    needed = sum(int(n) for _, n in raw_ranges)
    fetched = sum(int(n) for _, n in coalesced_ranges)
    waste = max(0, fetched - needed)
    return {'needed_bytes': needed,
            'fetched_bytes': fetched,
            'waste_bytes': waste,
            'requests': len(coalesced_ranges),
            'waste_pct': round(100.0 * waste / fetched, 2) if fetched
            else 0.0}


class SparseFile(object):
    """Read-only file view over a dict of fetched byte segments.

    ``segments`` maps absolute file offset -> bytes-like.  Reads are
    served from the segments (overlapping segments are fine — small
    files' footer tails overlap their data ranges); a read touching any
    byte NO segment covers raises :class:`IngestMissError`, which the
    decode worker turns into a per-piece fallback to the synchronous
    path.  Implements exactly the seek/read protocol pyarrow's
    ``PythonFile`` wrapper drives.
    """

    def __init__(self, size, segments):
        self._size = int(size)
        self._segments = sorted((int(off), memoryview(buf))
                                for off, buf in segments.items())
        self._pos = 0
        self._closed = False

    # -- file protocol -------------------------------------------------------

    def read(self, nbytes=-1):
        if nbytes is None or nbytes < 0:
            nbytes = self._size - self._pos
        n = min(int(nbytes), self._size - self._pos)
        if n <= 0:
            return b''
        pos, end = self._pos, self._pos + n
        parts = []
        for offset, buf in self._segments:
            if offset + len(buf) <= pos:
                continue
            if offset > pos:
                break
            take = min(end, offset + len(buf)) - pos
            parts.append(bytes(buf[pos - offset:pos - offset + take]))
            pos += take
            if pos >= end:
                break
        if pos < end:
            raise IngestMissError(
                'read [%d, %d) not covered by fetched ranges (plan missed '
                '%d bytes)' % (self._pos, end, end - pos))
        self._pos = end
        return b''.join(parts)

    def seek(self, offset, whence=0):
        if whence == 0:
            self._pos = int(offset)
        elif whence == 1:
            self._pos += int(offset)
        elif whence == 2:
            self._pos = self._size + int(offset)
        else:
            raise ValueError('invalid whence %r' % (whence,))
        return self._pos

    def tell(self):
        return self._pos

    def size(self):
        return self._size

    def readable(self):
        return True

    def seekable(self):
        return True

    def writable(self):
        return False

    def flush(self):
        pass

    def close(self):
        self._closed = True

    @property
    def closed(self):
        return self._closed

"""Attribution of a consumer's data wait to the pipeline's spans.

Counterpart of the stall-attribution part of
``petastorm_tpu/telemetry/spans.py``: the ``data_wait`` windows a
:class:`~petastorm_tpu_torch.benchmark.StallMonitor` records are intersected
with the spans of each component (decode, IPC, the transfer's link and its
staging copy, ...), on any thread, so a wait on the training thread is
split by what the loader's other threads were doing meanwhile.
"""

__all__ = ['attribute_stalls', 'STALL_COMPONENTS']

#: Component -> span names that evidence it.  Parallel stages can overlap
#: the same wait, so the percentages may sum past 100.
STALL_COMPONENTS = {
    'decode': ('service/decode_split', 'pool/process'),
    'ipc': ('service/serialize', 'service/shm_publish', 'pool/publish'),
    'cache_fill': ('cache/fill',),
    # the link (the inline put, the plane's dispatch and commit waits)
    # apart from the host's staging copy into the slab
    'h2d': ('device_put', 'h2d/dispatch', 'h2d/commit'),
    'h2d_stage': ('h2d/stage',),
    'ingest_fetch': ('ingest/fetch', 'ingest/hedge'),
}

#: Spans that cover a whole wait by construction: only the part of them no
#: component covers counts, as ``lease_wait`` (starvation).
_WAIT_WRAPPERS = ('service/split_wait', 'service/lease_wait')


def attribute_stalls(events, wait_name='data_wait'):
    """Split the ``wait_name`` time of Chrome-trace ``events`` by component.

    Returns ``{'total_wait_s': ..., 'pct': {component: pct, ...,
    'lease_wait': pct, 'other': pct}, 'top': component}``, or None when no
    wait spans exist.  ``other`` is the wait no span accounts for.
    """
    waits = _intervals(events, (wait_name,))
    if not waits:
        return None
    total = sum(e - s for s, e in waits)
    if total <= 0.0:
        return None
    pct = {}
    covered = []
    for component, names in STALL_COMPONENTS.items():
        overlap = _clip(_intervals(events, names), waits)
        covered.extend(overlap)
        pct[component] = round(100.0 * sum(e - s for s, e in overlap) / total, 2)
    stage_union = _union(covered)
    starved = _subtract(_clip(_intervals(events, _WAIT_WRAPPERS), waits), stage_union)
    pct['lease_wait'] = round(100.0 * sum(e - s for s, e in starved) / total, 2)
    accounted = _union(stage_union + starved)
    uncovered = total - sum(e - s for s, e in accounted)
    pct['other'] = round(100.0 * max(0.0, uncovered) / total, 2)
    top = max(pct, key=pct.get)
    return {'total_wait_s': round(total / 1e6, 4), 'pct': pct, 'top': top}


def _intervals(events, names):
    """Merged [start, end) us intervals of the named 'X' spans."""
    return _union([(ev['ts'], ev['ts'] + ev['dur']) for ev in events
                   if ev.get('ph') == 'X' and ev.get('name') in names])


def _union(ivals):
    out = []
    for start, end in sorted(ivals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _clip(ivals, windows):
    """Merged intervals intersected with merged windows."""
    out = []
    for start, end in ivals:
        for w0, w1 in windows:
            lo, hi = max(start, w0), min(end, w1)
            if hi > lo:
                out.append((lo, hi))
    return _union(out)


def _subtract(ivals, holes):
    """Merged intervals minus merged holes."""
    out = []
    for start, end in ivals:
        cursor = start
        for h0, h1 in holes:
            if h1 <= cursor or h0 >= end:
                continue
            if h0 > cursor:
                out.append((cursor, h0))
            cursor = max(cursor, h1)
            if cursor >= end:
                break
        if cursor < end:
            out.append((cursor, end))
    return out

"""Pipeline bottleneck advisor: name the regime, point at the fix.

Counterpart of ``petastorm_tpu/benchmark/advisor.py``: the same regimes
from the same counters, with the port's remedies.  Every signal is already
collected on the hot path (``DataLoader.stats`` per-stage wall time, the
pool's ``decode_utilization``, the ``StallMonitor``'s wait and step time);
:func:`diagnose` only reads them::

    monitor = StallMonitor()
    for batch in monitor.wrap(loader):
        step(batch)
    print(format_report(diagnose(loader, monitor)))
"""

__all__ = ['diagnose', 'format_report', 'HEALTHY_STALL_PCT']

#: stall_pct at or below this means the card is the bottleneck (the north
#: star of the JAX package's BASELINE.json).
HEALTHY_STALL_PCT = 2.0


def diagnose(loader, monitor=None):
    """Classify the pipeline's bottleneck regime from live counters.

    Args:
        loader: a loader of :mod:`petastorm_tpu_torch.gpu` that has been
            iterated; its ``reader`` supplies the pool's diagnostics.
        monitor: optional ``StallMonitor`` that wrapped the iteration;
            without it the report covers stage balance only.

    Returns ``{'regime', 'evidence', 'suggestions'}``: the regime is one of
    ``chip_bound``, ``decode_bound``, ``io_bound``, ``transport_bound``,
    ``transform_bound`` and ``unknown``; the evidence holds the numbers that
    picked it; the suggestions come most effective first.
    """
    stats = dict(getattr(loader, 'stats', None) or {})
    batches = stats.get('batches', 0)
    evidence = {'batches': batches}
    if not batches:
        return {'regime': 'unknown', 'evidence': evidence,
                'suggestions': ['iterate the loader before diagnosing']}

    per_batch = {
        'host_batch_ms': 1000.0 * stats.get('host_batch_s', 0.0) / batches,
        'transform_ms': 1000.0 * stats.get('transform_s', 0.0) / batches,
        'device_put_ms': 1000.0 * stats.get('device_put_s', 0.0) / batches,
    }
    evidence.update({k: round(v, 3) for k, v in per_batch.items()})

    decode_util = None
    reader = getattr(loader, 'reader', None)
    if reader is not None:
        try:
            diag = reader.diagnostics
            decode_util = diag.get('decode_utilization')
            evidence['decode_utilization'] = decode_util
            evidence['pool'] = diag.get('pool')
        except Exception:  # noqa: BLE001 — the reader may be stopped
            pass

    stall_pct = None
    if monitor is not None:
        report = monitor.report()
        stall_pct = report.get('stall_pct')
        evidence['stall_pct'] = stall_pct
        if report.get('steps'):
            evidence['step_ms'] = round(1000.0 * report['step_s'] / report['steps'], 3)

    if stall_pct is not None and stall_pct <= HEALTHY_STALL_PCT:
        return {'regime': 'chip_bound', 'evidence': evidence,
                'suggestions': ['healthy: the card is the bottleneck; spend effort on the '
                                'model, not the loader']}

    dominant = max(per_batch, key=per_batch.get)
    if sum(per_batch.values()) <= 0:
        return {'regime': 'unknown', 'evidence': evidence,
                'suggestions': ['no host time recorded; wrap the iteration with StallMonitor '
                                'for a card-side verdict']}

    if dominant == 'host_batch_ms':
        if decode_util is not None and decode_util < 0.5:
            return {'regime': 'io_bound', 'evidence': evidence, 'suggestions': [
                'decode workers are starved (decode_utilization %.2f): raise workers_count / '
                'results_queue_size' % decode_util,
                'check storage throughput (disk, network file system)']}
        return {'regime': 'decode_bound', 'evidence': evidence, 'suggestions': [
            'decode saturates the host: more decode workers on more host cores '
            "(reader_pool_type='process' decodes outside this interpreter's lock)",
            'declared resizes fuse natively: ResizeImages',
            'multi-epoch runs: DiskCachedDataLoader (decode once, stream later epochs) or '
            'DeviceInMemDataLoader if the dataset fits in device memory']}
    if dominant == 'transform_ms':
        return {'regime': 'transform_bound', 'evidence': evidence, 'suggestions': [
            'move the transform into the worker pool (TransformSpec) so it parallelizes and '
            'overlaps the step',
            'image resizes: ResizeImages fuses into the native decode',
            'normalization/augmentation: do it on the card inside the step '
            '(petastorm_tpu_torch.gpu.augment)']}
    return {'regime': 'transport_bound', 'evidence': evidence, 'suggestions': [
        'fuse steps per transfer: scan_batches(step_fn, carry, k) moves k batches in one copy '
        'and replays one graph; scan_epochs removes the transfer for epochs cached on the card',
        'transfer the smallest dtype (uint8 images; cast/normalize on the card, or '
        "wire_dtypes='auto'), and check the host-device link (PCIe generation and width)"]}


def format_report(result):
    """One human-readable block from a :func:`diagnose` result."""
    lines = ['pipeline regime: %s' % result['regime']]
    ev = result['evidence']
    lines.append('  evidence: ' + ', '.join(
        '%s=%s' % (k, ev[k]) for k in sorted(ev) if ev[k] is not None))
    for i, s in enumerate(result['suggestions'], 1):
        lines.append('  %d. %s' % (i, s))
    return '\n'.join(lines)

"""FIFO against adaptive dispatch over the emulated cold store, in both
packages, read from their provenance records (CPU; no card).

Writes a store of uniform row groups, then reads it with each package's
``make_reader`` (8 threads, columnar, the same seed) over its own
``BandwidthLimitedFilesystem`` (each row group takes ``--fetch-s`` seconds
through one handle), once with ``scheduling='fifo'`` and once with
``'adaptive'``, two epochs each, and prints per run:

* the dispatch order: positions sorted by their ``ventilate`` start (the
  ventilator's dispatch time), against epoch order;
* the delivery order: positions as the records come out;
* each position's ``release`` stage (published until delivered: the
  results queue plus, under adaptive dispatch, the reorder stage's wait
  for every earlier position), its mean, p50, p90 and max in ms;
* the records' ``sched`` policies and early launches, and the run's wall.

Run from the root of a checkout::

    JAX_PLATFORMS=cpu python reorder_wait.py [--fetch-s 0.2] [--groups 24] [--repeats 2]

The last line is one JSON object of every run's numbers.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def write_store(url, groups, rows_per_group=8):
    from petastorm_tpu_torch import codecs, unischema
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
    schema = unischema.Unischema('ReorderSchema', [
        unischema.UnischemaField('id', np.int64, (), None, False),
        unischema.UnischemaField('matrix', np.float32, (64, 256), codecs.NdarrayCodec(), False)])
    rng = np.random.default_rng(0)
    with DatasetWriter(url, schema, rows_per_rowgroup=rows_per_group) as writer:
        for i in range(groups * rows_per_group):
            writer.write({'id': np.int64(i),
                          'matrix': rng.standard_normal((64, 256)).astype(np.float32)})


def mean_group_bytes(path):
    import pyarrow.parquet as pq
    sizes = []
    for name in sorted(os.listdir(path)):
        if name.endswith('.parquet'):
            meta = pq.ParquetFile(os.path.join(path, name)).metadata
            sizes += [meta.row_group(i).total_byte_size for i in range(meta.num_row_groups)]
    return float(np.mean(sizes)), len(sizes)


def run(package, url, scheduling, bps, seed=5):
    if package == 'port':
        from petastorm_tpu_torch.fs_utils import LocalFilesystem
        from petastorm_tpu_torch.reader import make_reader
        from petastorm_tpu_torch.test_util.emulation import BandwidthLimitedFilesystem
        inner = LocalFilesystem()
    else:
        import fsspec
        from petastorm_tpu import make_reader
        from petastorm_tpu.test_util.emulation import BandwidthLimitedFilesystem
        inner = fsspec.filesystem('file')
    fs = BandwidthLimitedFilesystem(inner, bps=bps)
    records = []
    t0 = time.monotonic()
    with make_reader(url, schema_fields=['id', 'matrix'], workers_count=8, columnar_decode=True,
                     seed=seed, num_epochs=2, filesystem=fs, scheduling=scheduling,
                     ingest='off') as reader:
        for _ in reader:
            records.extend(reader.take_provenance())
        resolved = reader.diagnostics.get('scheduling')
    wall = time.monotonic() - t0
    release = np.array([1e3 * (r['stages']['release'][1] - r['stages']['release'][0])
                        for r in records if 'release' in r['stages']])
    dispatched = [r['position'] for r in sorted(
        (r for r in records if 'ventilate' in r['stages']),
        key=lambda r: r['stages']['ventilate'][0])]
    delivered = [r['position'] for r in records]
    return {'package': package, 'scheduling': resolved, 'records': len(records),
            'wall_s': round(wall, 3),
            'dispatch_in_epoch_order': dispatched == sorted(dispatched),
            'dispatch_order_head': dispatched[:12],
            'delivery_in_epoch_order': delivered == sorted(delivered),
            'delivery_order_head': delivered[:12],
            'release_ms': {'mean': round(float(release.mean()), 3),
                           'p50': round(float(np.percentile(release, 50)), 3),
                           'p90': round(float(np.percentile(release, 90)), 3),
                           'max': round(float(release.max()), 3)},
            'policies': sorted({(r.get('sched') or {}).get('policy') for r in records}),
            'early': sum(1 for r in records if (r.get('sched') or {}).get('early'))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--fetch-s', type=float, default=0.2,
                        help='seconds one row group takes through one handle')
    parser.add_argument('--groups', type=int, default=24)
    parser.add_argument('--repeats', type=int, default=2)
    args = parser.parse_args(argv)
    os.environ.pop('PETASTORM_TPU_NO_PROVENANCE', None)
    out = []
    with tempfile.TemporaryDirectory(prefix='reorder_wait_') as tmp:
        path = os.path.join(tmp, 'store')
        write_store('file://' + path, args.groups)
        mean, groups = mean_group_bytes(path)
        bps = mean / args.fetch_s
        print('store: %d row groups, mean %.0f bytes; %.0f B/s a handle' % (groups, mean, bps))
        for repeat in range(args.repeats):
            for scheduling in ('fifo', 'adaptive'):
                for package in ('port', 'jax'):
                    result = dict(run(package, 'file://' + path, scheduling, bps),
                                  repeat=repeat)
                    print(json.dumps(result))
                    out.append(result)
    print(json.dumps({'fetch_s': args.fetch_s, 'groups': groups, 'runs': out}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

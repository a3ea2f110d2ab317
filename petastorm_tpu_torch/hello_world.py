"""The hello-world examples (BASELINE.json config #2) on the card.

Counterpart of ``examples/hello_world``: :func:`generate_petastorm_dataset`
writes the petastorm-format dataset of ``HelloWorldSchema`` (an int64
``id``, a 128x256x3 PNG ``image1`` and a wildcard ``array_4d``) with the
port's writer, and :func:`petastorm_hello_world` reads ``id`` and
``image1`` with ``make_reader`` into a
:class:`~petastorm_tpu_torch.gpu.DataLoader` on the card
(``petastorm_dataset/jax_hello_world.py``; where the native plane lacks
libpng the PNG decodes with cv2).  :func:`generate_external_dataset`
writes a plain three-column Parquet store with pyarrow, and
:func:`python_hello_world` reads it with ``make_batch_reader``
(``external_dataset/python_hello_world.py``).  Both print what the
reference's scripts print.  Run ``python -m petastorm_tpu_torch.hello_world
[--flow petastorm|external|both] [--root DIR] [--device cpu]``.
"""

import argparse
import os
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path
from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['HelloWorldSchema', 'row_generator', 'generate_petastorm_dataset',
           'generate_external_dataset', 'petastorm_hello_world', 'python_hello_world', 'main']

HelloWorldSchema = Unischema('HelloWorldSchema', [
    UnischemaField('id', np.int64, (), None, False),
    UnischemaField('image1', np.uint8, (128, 256, 3), CompressedImageCodec('png'), False),
    UnischemaField('array_4d', np.uint8, (None, 128, 30, 4), NdarrayCodec(), False),
])


def row_generator(idx, rng):
    return {
        'id': np.int64(idx),
        'image1': rng.integers(0, 255, (128, 256, 3), dtype=np.uint8),
        'array_4d': rng.integers(0, 255, (int(rng.integers(1, 5)), 128, 30, 4),
                                 dtype=np.uint8),
    }


def generate_petastorm_dataset(output_url, rows_count=10):
    """``rows_count`` rows of ``HelloWorldSchema`` in row groups of 5."""
    rng = np.random.default_rng(0)
    with DatasetWriter(output_url, HelloWorldSchema, rows_per_rowgroup=5) as writer:
        writer.write_many(row_generator(i, rng) for i in range(rows_count))
    return output_url


def generate_external_dataset(output_url, rows_count=100):
    """A plain Parquet store (``id`` int64, ``value1``/``value2`` float64)
    in row groups of 25, no petastorm metadata."""
    fs, path = get_filesystem_and_path(output_url)
    fs.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(0)
    table = pa.table({
        'id': pa.array(np.arange(rows_count, dtype=np.int64)),
        'value1': pa.array(rng.standard_normal(rows_count)),
        'value2': pa.array(rng.standard_normal(rows_count)),
    })
    with fs.open(path + '/data.parquet', 'wb') as f:
        pq.write_table(table, f, row_group_size=25)
    return output_url


def petastorm_hello_world(dataset_url, device=None, **reader_kwargs):
    """``id`` and ``image1`` (``array_4d`` has a wildcard dimension, so it
    does not batch) through the loader, 4 rows a batch; prints and returns
    each batch's ids and image shape."""
    seen = []
    with make_reader(dataset_url, schema_fields=['id', 'image1'], **reader_kwargs) as reader:
        for batch in DataLoader(reader, batch_size=4, device=device):
            ids = batch['id'].cpu().numpy()
            shape = tuple(batch['image1'].shape)
            print('id:', ids, 'image1:', shape, 'on', batch['image1'].device)
            seen.append((ids, shape))
    return seen


def python_hello_world(dataset_url, **reader_kwargs):
    """The plain store's batches, one per row group; prints and returns
    each one's ids."""
    seen = []
    with make_batch_reader(dataset_url, **reader_kwargs) as reader:
        for batch in reader:
            print('batch of %d: ids %s...' % (len(batch.id), batch.id[:5]))
            seen.append(batch.id)
    return seen


def main(argv=None):
    parser = argparse.ArgumentParser(description='The hello-world flows on the card.')
    parser.add_argument('--flow', choices=('petastorm', 'external', 'both'), default='both')
    parser.add_argument('--root', default=None,
                        help='where to write the datasets (default: a new temporary directory)')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix='hello_world_')
    out = {}
    if args.flow in ('petastorm', 'both'):
        url = generate_petastorm_dataset('file://' + os.path.join(root, 'hello_world_dataset'))
        out['petastorm'] = petastorm_hello_world(url, device=args.device)
    if args.flow in ('external', 'both'):
        url = generate_external_dataset('file://' + os.path.join(root, 'external_dataset'))
        out['external'] = python_hello_world(url)
    return out


if __name__ == '__main__':
    main()

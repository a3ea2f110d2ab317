"""The port's pandas DataFrame converter and hello-world flows against the
JAX package's, on the CPU.

The same frame names the same cache directory (the content hash, and the
directory under one fixed ``uuid4``) and materializes the same Parquet,
row groups included, in both packages; the port's converter loader gives
the JAX converter's ``make_jax_loader`` batches bit for bit; ``delete``
removes the directory; the options outside the slice raise.  The
converter example trains its logistic regression on the CPU.  Both
hello-world flows print the ids and shapes the reference's scripts print,
over datasets their generators write alike.
"""

import contextlib
import importlib.util
import io
import os
import re
import sys
import uuid

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.spark.spark_dataset_converter as jax_conv

import petastorm_tpu_torch.spark.spark_dataset_converter as conv
from petastorm_tpu_torch import hello_world
from petastorm_tpu_torch.spark import converter_example

from torch_plane_common import assert_batches_equal, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(rows=512, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        'features': [rng.standard_normal(16) for _ in range(rows)],
        'label': rng.integers(0, 2, rows).astype(np.int64),
        'weight': rng.standard_normal(rows),
        'name': ['r%d' % i for i in range(rows)],
    })


@contextlib.contextmanager
def _fixed_uuid(monkeypatch, hexes):
    """``uuid.uuid4`` returns these values, in order, in both packages."""
    values = iter(hexes)
    monkeypatch.setattr(uuid, 'uuid4', lambda: uuid.UUID(next(values)))
    yield


def _files(url):
    path = url[len('file://'):]
    return sorted(f for f in os.listdir(path))


def test_the_same_frame_names_the_same_cache_and_parquet(tmp_path, monkeypatch):
    parent = 'file://%s' % tmp_path
    fixed = '%032x' % 12345
    with _fixed_uuid(monkeypatch, [fixed, fixed]):
        port = conv.make_pandas_converter(_frame(), parent, parquet_row_group_size_bytes=8 << 10)
        port_dir = port.cache_dir_url
        port_key = [k for k, m in conv._CACHED_CONVERTERS.items()
                    if m.cache_dir_url == port_dir]
        port_table = pq.read_table(port_dir[len('file://'):] + '/part_00000.parquet')
        port_groups = pq.ParquetFile(port_dir[len('file://'):] + '/part_00000.parquet').metadata
        port_groups = [port_groups.row_group(i).num_rows for i in range(port_groups.num_row_groups)]
        port.delete()
        ref = jax_conv.make_pandas_converter(_frame(), parent,
                                             parquet_row_group_size_bytes=8 << 10)
    ref_key = [k for k, m in jax_conv._CACHED_CONVERTERS.items()
               if m.cache_dir_url == ref.cache_dir_url]
    try:
        assert port_dir == ref.cache_dir_url == '%s/%s' % (parent, fixed)
        assert port_key == ref_key and len(port_key) == 1
        assert len(port) == len(ref) == 512
        path = ref.cache_dir_url[len('file://'):] + '/part_00000.parquet'
        assert pq.read_table(path).equals(port_table)
        meta = pq.ParquetFile(path).metadata
        assert [meta.row_group(i).num_rows for i in range(meta.num_row_groups)] == port_groups
        assert len(port_groups) > 1
    finally:
        ref.delete()


def test_a_changed_frame_or_setting_names_another_cache(tmp_path):
    parent = 'file://%s' % tmp_path
    a = conv.make_pandas_converter(_frame(64), parent)
    try:
        assert conv.make_pandas_converter(_frame(64), parent).cache_dir_url == a.cache_dir_url
        other = conv.make_pandas_converter(_frame(64, seed=1), parent)
        setting = conv.make_pandas_converter(_frame(64), parent, compression_codec='gzip')
        assert len({a.cache_dir_url, other.cache_dir_url, setting.cache_dir_url}) == 3
        other.delete()
        setting.delete()
    finally:
        a.delete()


@pytest.mark.parametrize('transfer', [False, True])
def test_converter_loaders_give_the_jax_batches(tmp_path, transfer):
    parent = 'file://%s' % tmp_path
    reader_kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    ref = jax_conv.make_pandas_converter(_frame(), parent, parquet_row_group_size_bytes=8 << 10)
    port = conv.make_pandas_converter(_frame(), parent, parquet_row_group_size_bytes=8 << 10)
    try:
        with ref.make_jax_loader(batch_size=48, num_epochs=2, scheduling='fifo', ingest='off',
                                 loader_kwargs=dict(transfer=False), **reader_kwargs) as loader:
            want = [to_numpy(b) for b in loader]
        with port.make_loader(batch_size=48, num_epochs=2,
                              loader_kwargs=dict(device='cpu', transfer=transfer),
                              **reader_kwargs) as loader:
            got = [to_numpy(b) for b in loader]
        assert_batches_equal(got, want)
        assert got[0]['features'].shape == (48, 16) and got[0]['features'].dtype == np.float32
        assert 'name' not in got[0]
    finally:
        ref.delete()
        port.delete()


def test_delete_removes_the_directory_and_the_registration(tmp_path):
    c = conv.make_pandas_converter(_frame(32), 'file://%s' % tmp_path)
    path = c.cache_dir_url[len('file://'):]
    assert os.path.isdir(path) and _files(c.cache_dir_url) == ['part_00000.parquet']
    c.delete()
    assert not os.path.exists(path)
    assert all(m.cache_dir_url != c.cache_dir_url for m in conv._CACHED_CONVERTERS.values())
    c.delete()   # a second delete finds nothing and passes
    again = conv.make_pandas_converter(_frame(32), 'file://%s' % tmp_path)
    assert again.cache_dir_url != c.cache_dir_url
    conv._cleanup_cache_dirs()   # the interpreter-exit cleanup
    assert not os.path.exists(again.cache_dir_url[len('file://'):])


def test_options_outside_the_slice_raise(tmp_path):
    c = conv.SparkDatasetConverter('file://%s' % tmp_path, 0)
    for call in (lambda: conv.make_spark_converter(None), c.make_tf_dataset,
                 c.make_torch_dataloader):
        with pytest.raises(ValueError, match='ROADMAP.md, Queue A item 7'):
            call()


def test_converter_example_trains_and_deletes(tmp_path, capsys):
    result = converter_example.main(['--device', 'cpu', '--parent-cache-dir-url',
                                     'file://%s' % tmp_path])
    out = capsys.readouterr().out
    assert 'materialized 512 rows to' in out and out.rstrip().endswith('cache deleted')
    assert result['steps'] == 16 and np.isfinite(result['losses']).all()
    assert result['losses'][-1] < result['losses'][0]
    assert not os.path.exists(result['cache_dir_url'][len('file://'):])


# -- hello world ----------------------------------------------------------------

def _example(relpath):
    path = os.path.join(REPO, 'examples', 'hello_world', relpath)
    spec = importlib.util.spec_from_file_location('hw_' + os.path.basename(relpath)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ordered(factory):
    """``factory`` reading with the dummy pool and no shuffle."""
    def make(url, **kwargs):
        return factory(url, reader_pool_type='dummy', shuffle_row_groups=False, **kwargs)
    return make


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    # the device names differ by package (TFRT_CPU_0 / cpu)
    return [re.sub(r' on \S+$', '', line) for line in buf.getvalue().splitlines()]


def test_petastorm_hello_world_prints_the_references_lines(tmp_path, monkeypatch):
    gen = _example('petastorm_dataset/generate_petastorm_dataset.py')
    ref = _example('petastorm_dataset/jax_hello_world.py')
    ref_url = gen.generate_petastorm_dataset('file://%s' % (tmp_path / 'ref'))
    port_url = hello_world.generate_petastorm_dataset('file://%s' % (tmp_path / 'port'))
    monkeypatch.setattr(ref, 'make_reader', _ordered(ref.make_reader))
    want = _printed(ref.jax_hello_world, ref_url or 'file://%s' % (tmp_path / 'ref'))
    got = _printed(hello_world.petastorm_hello_world, port_url, device='cpu',
                   reader_pool_type='dummy', shuffle_row_groups=False)
    assert got == want == ['id: [0 1 2 3] image1: (4, 128, 256, 3)',
                           'id: [4 5 6 7] image1: (4, 128, 256, 3)']
    # the generators write the same rows, the wildcard array_4d included
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu_torch import make_reader
    with jax_make_reader('file://%s' % (tmp_path / 'ref'), reader_pool_type='dummy',
                         shuffle_row_groups=False) as r:
        want_rows = [row._asdict() for row in r]
    with make_reader(port_url, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        got_rows = [row._asdict() for row in r]
    assert len(got_rows) == len(want_rows) == 10
    for g, w in zip(got_rows, want_rows):
        for key in ('id', 'image1', 'array_4d'):
            np.testing.assert_array_equal(g[key], w[key])
    assert hello_world.HelloWorldSchema.array_4d.shape == (None, 128, 30, 4)


def test_external_hello_world_prints_the_references_lines(tmp_path, monkeypatch):
    gen = _example('external_dataset/generate_external_dataset.py')
    ref = _example('external_dataset/python_hello_world.py')
    gen.generate_external_dataset('file://%s' % (tmp_path / 'ref'))
    port_url = hello_world.generate_external_dataset('file://%s' % (tmp_path / 'port'))
    assert pq.read_table(str(tmp_path / 'ref' / 'data.parquet')).equals(
        pq.read_table(port_url[len('file://'):] + '/data.parquet'))
    monkeypatch.setattr(ref, 'make_batch_reader', _ordered(ref.make_batch_reader))
    want = _printed(ref.python_hello_world, 'file://%s' % (tmp_path / 'ref'))
    got = _printed(hello_world.python_hello_world, port_url, reader_pool_type='dummy',
                   shuffle_row_groups=False)
    assert got == want and len(got) == 4 and got[0] == 'batch of 25: ids [0 1 2 3 4]...'


def test_hello_world_main_runs_both_flows(tmp_path, capsys):
    out = hello_world.main(['--root', str(tmp_path), '--device', 'cpu'])
    assert len(out['petastorm']) == 2 and len(out['external']) == 4
    assert sorted(np.concatenate(out['external']).tolist()) == list(range(100))
    assert 'image1: (4, 128, 256, 3)' in capsys.readouterr().out

"""Stores written by upstream petastorm open in the port, on the CPU.

The frozen fixture ``tests/data/reference_unischema_footer.b64`` holds a
footer as upstream petastorm pickles it: ``petastorm.unischema`` and
``petastorm.codecs`` classes, and ``ScalarCodec`` state holding Spark SQL
types.  The port's footer reader maps those module names onto its own
modules before any import (so neither ``petastorm`` nor ``petastorm_tpu``
is ever loaded) and stubs the Spark types when pyspark is absent.  The
port is held against the JAX package on the cases of
``tests/test_reference_compat.py``: the fixture unpickles into the same
schema, a store with the fixture spliced in as its footer reads the same
rows through both packages' ``make_reader`` (every codec column decoded)
and the same columns through both ``make_batch_reader``, and unknown
modules still fail.  The fixture is only read.
"""

import base64
import hashlib
import os
import pickle
import subprocess
import sys
import textwrap
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.etl import dataset_metadata as jax_dm

from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                        NdarrayCodec, ScalarCodec)
from petastorm_tpu_torch.etl import dataset_metadata as dm
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.unischema import Unischema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'data', 'reference_unischema_footer.b64')


def _fixture_bytes():
    with open(FIXTURE) as f:
        return base64.b64decode(f.read())


@pytest.fixture()
def no_pyspark(monkeypatch):
    """A host without pyspark (an import of it raises), whatever is
    installed here."""
    for mod in ('pyspark', 'pyspark.sql', 'pyspark.sql.types'):
        monkeypatch.setitem(sys.modules, mod, None)


def test_frozen_reference_footer_unpickles_without_pyspark(no_pyspark):
    blob = _fixture_bytes()
    assert b'petastorm_tpu' not in blob and b'pyspark' in blob
    schema = dm._loads_schema(blob)
    assert isinstance(schema, Unischema)
    assert schema.name == 'RefSchema'
    assert sorted(schema.fields) == ['id', 'image', 'label', 'matrix', 'price', 'sparse']
    assert isinstance(schema.fields['id'].codec, ScalarCodec)
    assert schema.fields['id'].codec.arrow_dtype() == pa.int32()
    assert schema.fields['label'].codec.arrow_dtype() == pa.string()
    assert schema.fields['price'].codec.arrow_dtype() == pa.decimal128(10, 2)
    assert type(schema.fields['matrix'].codec) is NdarrayCodec
    assert isinstance(schema.fields['sparse'].codec, CompressedNdarrayCodec)
    image_codec = schema.fields['image'].codec
    assert isinstance(image_codec, CompressedImageCodec)
    assert image_codec.image_codec == 'png' and image_codec.quality == 80
    assert schema.fields['matrix'].shape == (4, 3)
    assert schema.fields['label'].nullable is True
    assert schema.make_namedtuple(id=1, image=None, label='a', matrix=None, price=None,
                                  sparse=None).label == 'a'


def test_the_schema_is_the_jax_packages(no_pyspark):
    """Field for field, the port's unpickled schema is the JAX package's:
    names, dtypes, shapes, nullability, codec kinds and arrow types."""
    port = dm._loads_schema(_fixture_bytes())
    ref = jax_dm._loads_schema(_fixture_bytes())
    assert list(port.fields) == list(ref.fields)
    for name, field in port.fields.items():
        want = ref.fields[name]
        assert (np.dtype(field.numpy_dtype), field.shape, field.nullable) == \
            (np.dtype(want.numpy_dtype), want.shape, want.nullable)
        assert type(field.codec).__name__ == type(want.codec).__name__
        assert field.codec.arrow_dtype() == want.codec.arrow_dtype()
        assert field.codec.__dict__ == want.codec.__dict__


def _rows():
    rng = np.random.default_rng(7)
    return [{'id': np.int32(i),
             'label': 'item-%d' % i if i % 3 else None,
             'price': Decimal('%d.%02d' % (i, i)),
             'matrix': rng.standard_normal((4, 3)).astype(np.float32),
             'sparse': rng.standard_normal(8).astype(np.float64),
             'image': rng.integers(0, 255, (6, 5, 3), dtype=np.uint8)}
            for i in range(12)]


def write_reference_store(path, rows):
    """The store of ``tests/test_reference_compat.py``: ``rows`` written by
    the port's writer, then its footer's schema replaced by the frozen
    upstream bytes."""
    url = 'file://' + path
    with DatasetWriter(url, dm._loads_schema(_fixture_bytes()), rows_per_rowgroup=4) as w:
        w.write_many(rows)
    meta_path = os.path.join(path, '_common_metadata')
    arrow_schema = pq.read_schema(meta_path)
    metadata = dict(arrow_schema.metadata)
    metadata[dm.UNISCHEMA_KEY] = _fixture_bytes()
    pq.write_metadata(arrow_schema.with_metadata(metadata), meta_path)
    return url


@pytest.fixture()
def reference_url(tmp_path, no_pyspark):
    return write_reference_store(str(tmp_path / 'refds'), _rows())


def _by_id(rows):
    return sorted(rows, key=lambda r: int(r['id']))


def _assert_written(got):
    assert len(got) == 12
    for want, have in zip(_rows(), _by_id(got)):
        assert int(have['id']) == int(want['id'])
        assert have['label'] == want['label']
        assert Decimal(have['price']) == want['price']
        for name in ('matrix', 'sparse', 'image'):
            assert have[name].dtype == want[name].dtype
            np.testing.assert_array_equal(have[name], want[name])


@pytest.mark.parametrize('pool', ['dummy', 'thread', 'process'])
def test_make_reader_decodes_every_column_as_the_jax_reader(reference_url, pool):
    with make_reader(reference_url, reader_pool_type=pool, workers_count=2,
                     shuffle_row_groups=False) as reader:
        assert reader.schema.name == 'RefSchema'
        got = [r._asdict() for r in reader]
    _assert_written(got)
    with jax_make_reader(reference_url, reader_pool_type='dummy', shuffle_row_groups=False,
                         scheduling='fifo', ingest='off') as reader:
        want = [r._asdict() for r in reader]
    for have, ref in zip(_by_id(got), _by_id(want)):
        assert sorted(have) == sorted(ref)
        for name, value in ref.items():
            if isinstance(value, np.ndarray):
                assert have[name].dtype == value.dtype
                np.testing.assert_array_equal(have[name], value)
            else:
                assert have[name] == value and type(have[name]) is type(value), name


def test_make_batch_reader_takes_the_stored_schema_as_the_jax_reader(reference_url):
    """The stored schema, not one inferred: the same namedtuple type and
    the same columns as the JAX batch reader (which decodes no codecs)."""
    with make_batch_reader(reference_url, reader_pool_type='dummy',
                           shuffle_row_groups=False) as reader:
        assert reader.schema.name == 'RefSchema'
        got = list(reader)
    with jax_make_batch_reader(reference_url, reader_pool_type='dummy',
                               shuffle_row_groups=False, scheduling='fifo',
                               ingest='off') as reader:
        want = list(reader)
    assert len(got) == len(want) == 3
    for have, ref in zip(got, want):
        assert type(have).__name__ == type(ref).__name__ == 'RefSchema'
        assert have._fields == ref._fields
        for name in ref._fields:
            a, b = getattr(have, name), getattr(ref, name)
            assert a.dtype == b.dtype, name
            assert list(a) == list(b), name
    ids = np.concatenate([b.id for b in got])
    assert ids.tolist() == list(range(12))


def test_jax_packages_module_names_still_map(tmp_path):
    """A footer pickled with the JAX package's classes (``petastorm_tpu.*``)
    reads in the port, rows included."""
    from petastorm_tpu.etl.dataset_metadata import DatasetWriter as JaxDatasetWriter
    url = 'file://' + str(tmp_path / 'jaxds')
    schema = jax_dm._loads_schema(_fixture_bytes())
    with JaxDatasetWriter(url, schema, rows_per_rowgroup=4) as w:
        w.write_many(_rows())
    blob = pq.read_schema(str(tmp_path / 'jaxds' / '_common_metadata')).metadata[
        dm.UNISCHEMA_KEY]
    assert b'petastorm_tpu.unischema' in blob
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        _assert_written([r._asdict() for r in reader])


def test_unknown_modules_still_fail_loudly():
    blob = pickle.dumps(np.float64(1.0), protocol=0).replace(b'numpy', b'nonexistent_mod')
    with pytest.raises(ModuleNotFoundError):
        dm._loads_schema(blob)


def test_only_pyspark_sql_types_is_stubbed(no_pyspark):
    blob = pickle.dumps(np.float64(1.0), protocol=0).replace(b'numpy', b'pyspark.rdd')
    with pytest.raises(Exception):
        dm._loads_schema(blob)


def test_a_host_without_petastorm_reads_the_store(tmp_path):
    """With ``petastorm``, ``petastorm_tpu`` and ``pyspark`` unimportable, the
    port reads the store through both readers; afterwards none of them, nor
    ``jax``, is loaded."""
    script = textwrap.dedent('''
        import sys
        for mod in ('petastorm', 'petastorm_tpu', 'pyspark', 'jax'):
            sys.modules[mod] = None
        sys.path.insert(0, sys.argv[2])
        import test_torch_reference_compat as t
        t.FIXTURE = sys.argv[3]
        url = t.write_reference_store(sys.argv[1], t._rows())
        with t.make_reader(url, reader_pool_type='dummy') as reader:
            t._assert_written([r._asdict() for r in reader])
        with t.make_batch_reader(url, reader_pool_type='dummy') as reader:
            assert sum(len(b.id) for b in reader) == 12
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in
                        ('petastorm', 'petastorm_tpu', 'pyspark', 'jax')
                        and sys.modules[m] is not None)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''')
    # the test module imports the JAX package at its top: load only what
    # the script uses, from a copy without those imports
    source = open(os.path.abspath(__file__)).read()
    head, _, rest = source.partition('from petastorm_tpu import make_batch_reader')
    _, _, rest = rest.partition('from petastorm_tpu_torch.codecs')
    (tmp_path / 'mod').mkdir()
    (tmp_path / 'mod' / 'test_torch_reference_compat.py').write_text(
        head + 'from petastorm_tpu_torch.codecs' + rest)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ds'),
                           str(tmp_path / 'mod'), FIXTURE], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_the_fixture_is_only_read(reference_url):
    """Every read above leaves the frozen bytes as they are."""
    digest = hashlib.sha256(open(FIXTURE, 'rb').read()).hexdigest()
    dm._loads_schema(_fixture_bytes())
    with make_reader(reference_url, reader_pool_type='dummy') as reader:
        assert len(list(reader)) == 12
    assert hashlib.sha256(open(FIXTURE, 'rb').read()).hexdigest() == digest

"""The port's batch path against the JAX package's, on the CPU.

``make_batch_reader`` over plain Parquet (no petastorm metadata): the
port's batches equal ``petastorm_tpu.make_batch_reader``'s, values and
dtypes, on the seeded dummy pool with no shuffle, for the cases of
``tests/test_batch_reader.py`` and more (list columns, regex projection,
predicates, a pandas ``TransformSpec``, shards with and without
``shard_seed``, hive partitions, a list of URLs, ``filters``, nullable
ints and timestamps), and as multisets on the thread and process pools.
Then the predicates on their own, ``make_reader``'s predicate path (rows
and ``columnar_decode``), the refusals, and the loader over both packages'
batch readers: bit for bit pumped and inline, through ``scan_batches``,
and cut and resumed from the port's token and from the JAX loader's.
"""

import hashlib
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu.predicates as jax_predicates
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu.unischema import Unischema as JaxUnischema

import petastorm_tpu_torch.predicates as port_predicates
from petastorm_tpu_torch import make_batch_reader, make_loader, make_reader
from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.workers_pool import shm_plane

from torch_plane_common import assert_batches_equal, to_numpy, write_dataset

ROWS = 100
PER_GROUP = 20


def _frame(rows=ROWS, offset=0, width=4):
    rng = np.random.default_rng(offset)
    idx = np.arange(offset, offset + rows, dtype=np.int64)
    return pd.DataFrame({
        'idx': idx,
        'value': idx * 0.5,
        'name': ['row_%d' % i for i in idx],
        'vec': [np.arange(width, dtype=np.float32) + i for i in idx],
        'ragged': [np.arange(1 + i % 3, dtype=np.int64) for i in idx],
        'small': rng.integers(0, 5, rows).astype(np.int32),
        'nint': pd.array([None if i % 7 == 3 else int(i) for i in idx], dtype='Int64'),
        'ts': pd.to_datetime(idx, unit='s'),
    })


def _write(path, frame, per_group=PER_GROUP):
    os.makedirs(path, exist_ok=True)
    pq.write_table(pa.Table.from_pandas(frame, preserve_index=False),
                   os.path.join(path, 'data.parquet'), row_group_size=per_group)
    return 'file://' + path


@pytest.fixture(scope='module')
def plain(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp('plain')), _frame())


#: The wide store's rows: row groups of 300 rows whose tables exceed the
#: shared-memory plane's smallest payload, so the process pool's results
#: come through /dev/shm.
WIDE_ROWS = 1200


@pytest.fixture(scope='module')
def wide(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp('wide')), _frame(WIDE_ROWS, width=128),
                  per_group=300)


@pytest.fixture(scope='module')
def plain_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('pair'))
    return [_write(os.path.join(root, 'a'), _frame(60)),
            _write(os.path.join(root, 'b'), _frame(40, offset=60))]


@pytest.fixture(scope='module')
def hive(tmp_path_factory):
    """Rows 0..59 split by ``part`` (``part=a``/``part=b``/``part=c``)."""
    root = str(tmp_path_factory.mktemp('hive'))
    frame = _frame(60)[['idx', 'value']]
    frame['part'] = np.array(['a', 'b', 'c'])[np.arange(60) % 3]
    pq.write_to_dataset(pa.Table.from_pandas(frame, preserve_index=False), root,
                        partition_cols=['part'], row_group_size=10)
    return 'file://' + root


def _collect(reader):
    with reader:
        return [b._asdict() for b in reader]


def _both(url, port_kwargs, jax_kwargs=None):
    """The two packages' batches on the dummy pool without shuffle."""
    common = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    jax_batches = _collect(jax_make_batch_reader(url, scheduling='fifo', ingest='off',
                                                 **dict(common, **(jax_kwargs or port_kwargs))))
    port_batches = _collect(make_batch_reader(url, **dict(common, **port_kwargs)))
    return port_batches, jax_batches


def _assert_cells_equal(got, want):
    """Batches of numpy arrays (object arrays of arrays or strings
    included), dtypes and values, NaN equal to NaN."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, (key, g[key].dtype, w[key].dtype)
            assert g[key].shape == w[key].shape, key
            if w[key].dtype == object:
                for a, b in zip(g[key], w[key]):
                    if isinstance(b, np.ndarray):
                        assert a.dtype == b.dtype and np.array_equal(a, b), key
                    else:
                        assert a == b, key
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _double(df):
    df = df.copy()
    df['value'] = df['value'] * 2
    return df


def _drop_odd(df):
    return df[df['idx'] % 2 == 0]


#: (case id, kwargs builder over a package's (predicates module, TransformSpec))
CASES = [
    ('all_rows', lambda p, T: {}),
    ('list_columns', lambda p, T: dict(schema_fields=['idx', 'vec', 'ragged'])),
    ('regex_projection', lambda p, T: dict(schema_fields=['va.*', 'id.', 'n.*'])),
    ('in_lambda', lambda p, T: dict(predicate=p.in_lambda(['idx'], lambda v: v['idx'] < 30))),
    ('in_set', lambda p, T: dict(predicate=p.in_set({3, 25, 77}, 'idx'),
                                 schema_fields=['value', 'name'])),
    ('transform', lambda p, T: dict(transform_spec=T(_double, removed_fields=['name'],
                                                     selected_fields=['idx', 'value']))),
    ('transform_drops_rows', lambda p, T: dict(transform_spec=T(_drop_odd,
                                                                removed_fields=['ts']))),
    ('shard', lambda p, T: dict(cur_shard=1, shard_count=3)),
    ('shard_seed', lambda p, T: dict(cur_shard=1, shard_count=3, shard_seed=7)),
    ('filter_eq', lambda p, T: dict(filters=[('idx', '=', 45)])),
    ('filter_lt', lambda p, T: dict(filters=[('idx', '<', 30)])),
    ('filter_in', lambda p, T: dict(filters=[('idx', 'in', [5, 85])])),
    ('filter_or_of_ands', lambda p, T: dict(filters=[[('idx', '>=', 20), ('idx', '<', 40)],
                                                     [('idx', '>', 90)]])),
]


@pytest.mark.parametrize('case', [c for _, c in CASES], ids=[i for i, _ in CASES])
def test_batches_equal_the_jax_batch_reader(plain, case):
    got, want = _both(plain, case(port_predicates, TransformSpec),
                      case(jax_predicates, JaxTransformSpec))
    assert got
    _assert_cells_equal(got, want)


def test_dtypes_of_the_plain_store(plain):
    """A rectangular list column is 2-D (float64 from a float32 list, as in
    the JAX package, which stacks the cells' Python floats; the loader
    narrows it back), a ragged one and strings are objects, a nullable int
    column with nulls is float64 with NaN (int64 in a row group without
    nulls), a timestamp is datetime64[ns]."""
    got, _ = _both(plain, {})
    first = got[0]
    assert first['vec'].shape == (PER_GROUP, 4) and first['vec'].dtype == np.float64
    assert first['ragged'].dtype == object and first['name'].dtype == object
    assert first['nint'].dtype == np.float64 and np.isnan(first['nint'][3])
    assert first['ts'].dtype.kind == 'M'   # the unit pandas wrote
    assert all(b[k].flags.writeable for b in got for k in b)


def test_inferred_schema_equals_the_jax_packages(plain):
    arrow_schema = pq.read_schema(plain[len('file://'):] + '/data.parquet')
    port, ref = Unischema.from_arrow_schema(arrow_schema), JaxUnischema.from_arrow_schema(
        arrow_schema)
    assert list(port.fields) == list(ref.fields)
    for name, f in ref.fields.items():
        g = port.fields[name]
        assert (np.dtype(g.numpy_dtype), g.shape, g.nullable) == \
            (np.dtype(f.numpy_dtype), f.shape, f.nullable), name
    with pytest.raises(ValueError, match='Unsupported arrow type'):
        Unischema.from_arrow_schema(pa.schema([('s', pa.struct([('a', pa.int32())]))]),
                                    omit_unsupported_fields=False)


@pytest.mark.parametrize('filters', [None, [('part', '=', 'b')], [('part', 'in', ['a', 'c'])]])
def test_hive_partitioned_directory(hive, filters):
    got, want = _both(hive, dict(filters=filters))
    assert got
    _assert_cells_equal(got, want)
    idx = np.concatenate([b['idx'] for b in got])
    if filters == [('part', '=', 'b')]:
        assert sorted(idx % 3) == [1] * len(idx)


def test_a_list_of_urls(plain_pair):
    got, want = _both(plain_pair, dict(schema_fields=['idx', 'vec']))
    _assert_cells_equal(got, want)
    assert sorted(np.concatenate([b['idx'] for b in got]).tolist()) == list(range(100))
    with pytest.raises(ValueError, match='share a scheme'):
        make_batch_reader([plain_pair[0], 'hdfs://nn/x'])


def _digests(batches):
    """One digest per row group: its fields' bytes in name order."""
    out = []
    for b in batches:
        h = hashlib.sha256()
        for k in sorted(b):
            h.update(np.ascontiguousarray(b[k]).tobytes() if b[k].dtype != object
                     else repr([np.asarray(c).tolist() for c in b[k]]).encode())
        out.append(h.hexdigest())
    return sorted(out)


@pytest.mark.parametrize('pool,workers', [('thread', 3), ('process', 2)])
def test_pools_deliver_the_dummy_pools_multiset(wide, pool, workers):
    """The thread and process pools deliver the dummy pool's row groups
    (the order is the threads'); the process pool's tables come through
    /dev/shm and leave no slab behind, and a predicate crosses to its
    children."""
    kwargs = dict(schema_fields=['idx', 'value', 'vec', 'name'],
                  predicate=port_predicates.in_set(set(range(0, WIDE_ROWS, 3)), 'idx'))
    want = _collect(make_batch_reader(wide, reader_pool_type='dummy', **kwargs))
    reader = make_batch_reader(wide, reader_pool_type=pool, workers_count=workers, **kwargs)
    got = _collect(reader)
    assert _digests(got) == _digests(want)
    if pool == 'process':
        diag = reader.diagnostics
        assert diag['shm_results'] > 0, diag
        assert shm_plane.residue(diag['worker_pids']) == set()


def test_in_pseudorandom_split_puts_values_in_the_jax_buckets():
    values = list(range(200)) + ['a', 'b', 'key_%d' % 7, 3.5, b'bytes', None, (1, 2)]
    for fractions, index in (([0.3, 0.7], 0), ([0.3, 0.7], 1), ([0.2, 0.2, 0.5], 2)):
        port = port_predicates.in_pseudorandom_split(fractions, index, 'f')
        ref = jax_predicates.in_pseudorandom_split(fractions, index, 'f')
        got = [port.do_include({'f': v}) for v in values]
        assert got == [ref.do_include({'f': v}) for v in values]
        assert 0 < sum(got) < len(values)
    combined = port_predicates.in_reduce([port_predicates.in_set({1, 2, 3}, 'a'),
                                          port_predicates.in_negate(
                                              port_predicates.in_set({2}, 'a'))], all)
    assert [combined.do_include({'a': v}) for v in range(5)] == [False, True, False, True, False]
    assert port_predicates.in_intersection({4}, 'l').do_include({'l': [1, 4]})


def test_predicate_fields_absent_raise(plain):
    for factory, preds in ((make_batch_reader, port_predicates),
                           (jax_make_batch_reader, jax_predicates)):
        with pytest.raises(Exception, match='not present'):
            _collect(factory(plain, reader_pool_type='dummy',
                             predicate=preds.in_set({1}, 'missing')))


def test_options_outside_the_slice_raise(plain):
    for kwargs in (dict(scheduling='adaptive'), dict(ingest='plane'),
                   dict(storage_options={'a': 1})):
        with pytest.raises(ValueError, match='ROADMAP.md, Queue A item'):
            make_batch_reader(plain, **kwargs)
    with pytest.raises(ValueError, match='regex strings'):
        make_batch_reader(plain, schema_fields=[object()])


def test_the_local_disk_cache_serves_the_second_epoch_as_jax(plain, tmp_path):
    """``cache_type='local-disk'``: the second epoch comes from the cache and
    equals the first and the JAX reader's under its own cache."""
    epochs = []
    for _ in range(2):
        reader = make_batch_reader(plain, reader_pool_type='dummy', shuffle_row_groups=False,
                                   cache_type='local-disk', cache_location=str(tmp_path / 'port'))
        epochs.append(_collect(reader))
    _, want = _both(plain, {}, dict(cache_type='local-disk',
                                    cache_location=str(tmp_path / 'jax')))
    assert reader.diagnostics['cache_hits'] == len(epochs[1]) > 0
    for got in epochs:
        _assert_cells_equal(got, want)


def test_transform_may_change_row_count(plain, tmp_path):
    with make_batch_reader(plain, reader_pool_type='dummy',
                           transform_spec=TransformSpec(_drop_odd)) as reader:
        assert reader.transform_may_change_row_count
    with jax_make_batch_reader(plain, reader_pool_type='dummy',
                               transform_spec=JaxTransformSpec(_drop_odd)) as reader:
        assert reader.transform_may_change_row_count
    with make_batch_reader(plain, reader_pool_type='dummy') as reader:
        assert not reader.transform_may_change_row_count
    url = write_dataset('file://%s' % tmp_path)
    with make_reader(url, reader_pool_type='dummy',
                     transform_spec=TransformSpec(lambda r: r)) as reader:
        assert not reader.transform_may_change_row_count


def test_hive_partition_fields_of_a_petastorm_dataset_are_injected(tmp_path):
    """A petastorm dataset whose schema holds a hive partition key that its
    files do not store (``part=3/``, ``part=7/``): the port reads the key
    from the directory names (row and columnar paths, as the field's
    dtype); the JAX package's row worker asks the files for the column and
    raises, on both paths (ROADMAP.md, Queue C)."""
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter, _write_common_metadata
    from petastorm_tpu_torch.fs_utils import LocalFilesystem
    from petastorm_tpu_torch.unischema import UnischemaField
    stored = Unischema('S', [UnischemaField('id', np.int64, (), None, False)])
    full = Unischema('S', [UnischemaField('id', np.int64, (), None, False),
                           UnischemaField('part', np.int32, (), None, False)])
    for part in (3, 7):
        with DatasetWriter('file://%s/part=%d' % (tmp_path, part), stored,
                           rows_per_rowgroup=4) as writer:
            writer.write_many({'id': np.int64(part * 100 + i)} for i in range(8))
        os.remove(str(tmp_path / ('part=%d' % part) / '_common_metadata'))
    _write_common_metadata(LocalFilesystem(), str(tmp_path), full)
    url = 'file://%s' % tmp_path
    common = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    rows = _rows(make_reader(url, **common))
    assert [(int(r['id']), r['part']) for r in rows] == \
        [(p * 100 + i, p) for p in (3, 7) for i in range(8)]
    assert all(isinstance(r['part'], np.int32) for r in rows)
    chunks = _rows(make_reader(url, columnar_decode=True, **common))
    np.testing.assert_array_equal(np.concatenate([c['part'] for c in chunks]),
                                  np.repeat(np.int32([3, 7]), 8))
    for columnar in (False, True):
        with pytest.raises(KeyError, match='part'):
            _rows(jax_make_reader(url, columnar_decode=columnar, scheduling='fifo',
                                  ingest='off', **common))


# -- make_reader's predicate, filters and shard_seed ---------------------------

@pytest.fixture(scope='module')
def petastorm_url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('rows'))


def _rows(reader):
    with reader:
        return [r._asdict() for r in reader]


ROW_CASES = [
    ('predicate_in_view', lambda p: dict(predicate=p.in_lambda(['id'], lambda v: v['id'] % 3 == 0),
                                         schema_fields=['id', 'matrix'])),
    ('predicate_only_field', lambda p: dict(predicate=p.in_set({'sensor_1'}, 'sensor_name'),
                                            schema_fields=['id', 'embedding'])),
    ('pseudorandom_split', lambda p: dict(predicate=p.in_pseudorandom_split([0.5, 0.5], 1,
                                                                            'id'))),
    ('filters_and_shard_seed', lambda p: dict(filters=[('id', '>=', 16)], cur_shard=0,
                                              shard_count=2, shard_seed=3)),
]


@pytest.mark.parametrize('columnar', [False, True])
@pytest.mark.parametrize('case', [c for _, c in ROW_CASES], ids=[i for i, _ in ROW_CASES])
def test_make_reader_predicate_rows_equal_the_jax_readers(petastorm_url, case, columnar):
    common = dict(reader_pool_type='dummy', shuffle_row_groups=False, columnar_decode=columnar)
    want = _rows(jax_make_reader(petastorm_url, scheduling='fifo', ingest='off',
                                 **dict(common, **case(jax_predicates))))
    got = _rows(make_reader(petastorm_url, **dict(common, **case(port_predicates))))
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key


def test_shard_seed_permutes_before_the_split(petastorm_url):
    """Shards with a seed are disjoint and complete, differ from the
    unseeded split, and the token carries the seed and its scheme."""
    def ids(**kw):
        rows = _rows(make_reader(petastorm_url, reader_pool_type='dummy',
                                 shuffle_row_groups=False, schema_fields=['id'], **kw))
        return [int(r['id']) for r in rows]
    seeded = [ids(cur_shard=s, shard_count=3, shard_seed=11) for s in range(3)]
    assert sorted(sum(seeded, [])) == list(range(64))
    assert seeded != [ids(cur_shard=s, shard_count=3) for s in range(3)]
    with make_batch_reader(petastorm_url, reader_pool_type='dummy', cur_shard=1, shard_count=2,
                           shard_seed=5) as reader:
        state = reader.state_dict()
    assert (state['shard_seed'], state['shard_scheme']) == (5, 'rs-perm-v1')


# -- the loader over batch readers ---------------------------------------------

LOADER_FIELDS = ['idx', 'value', 'vec', 'name', 'nint', 'small']


def _jax_loader_batches(url, batch_size, **loader_kwargs):
    reader = jax_make_batch_reader(url, schema_fields=LOADER_FIELDS, reader_pool_type='dummy',
                                   shuffle_row_groups=False, scheduling='fifo', ingest='off')
    with JaxDataLoader(reader, batch_size, transfer=False, **loader_kwargs) as loader:
        return [to_numpy(b) for b in loader]


@pytest.mark.parametrize('transfer', [False, True])
@pytest.mark.parametrize('batch_size,drop_last', [(16, True), (20, True), (30, False)])
def test_loader_batches_equal_the_jax_loaders(plain, transfer, batch_size, drop_last, caplog):
    """Bit for bit, pumped and inline: 2-D list leaves, int64 -> int32,
    float64 -> float32, NaN where the nullable ints were null, the same
    batch boundaries across row groups; strings dropped with one warning."""
    want = _jax_loader_batches(plain, batch_size, drop_last=drop_last)
    with caplog.at_level(logging.WARNING, logger='petastorm_tpu_torch.gpu.loader'):
        with make_loader(plain, batch_size, schema_fields=LOADER_FIELDS,
                         reader_pool_type='dummy', shuffle_row_groups=False,
                         loader_kwargs=dict(device='cpu', transfer=transfer,
                                            drop_last=drop_last)) as loader:
            got = [to_numpy(b) for b in loader]
    assert_batches_equal(got, want)
    assert got[0]['vec'].shape == (batch_size, 4) and got[0]['idx'].dtype == np.int32
    assert 'name' not in got[0]
    assert sum('Field name' in r.message for r in caplog.records) == 1


@pytest.mark.parametrize('transfer', [False, True])
def test_a_datetime_column_refuses_as_in_jax(plain, transfer):
    """JAX cannot hold datetime64: its loader raises TypeError, and so does
    the port's, pumped and inline."""
    reader = jax_make_batch_reader(plain, schema_fields=['idx', 'ts'], reader_pool_type='dummy',
                                   scheduling='fifo', ingest='off')
    with pytest.raises(TypeError, match='datetime64'):
        with JaxDataLoader(reader, 10, transfer=False) as loader:
            list(loader)
    with pytest.raises(TypeError, match='datetime64'):
        with make_loader(plain, 10, schema_fields=['idx', 'ts'], reader_pool_type='dummy',
                         loader_kwargs=dict(device='cpu', transfer=transfer)) as loader:
            list(loader)


@pytest.mark.parametrize('steps_per_call', [1, 3])
def test_scan_batches_over_the_batch_reader_matches_jax(plain, steps_per_call):
    def jax_step(carry, batch):
        return carry + batch['idx'].sum(), batch['vec']

    def port_step(carry, batch):
        return carry + batch['idx'].sum(), batch['vec']

    reader = jax_make_batch_reader(plain, schema_fields=LOADER_FIELDS, reader_pool_type='dummy',
                                   shuffle_row_groups=False, scheduling='fifo', ingest='off')
    with JaxDataLoader(reader, 16, transfer=False) as loader:
        want = [jax.tree.map(np.asarray, co) for co in loader.scan_batches(
            jax_step, jnp.int32(0), steps_per_call=steps_per_call, donate_carry=False)]
    with make_loader(plain, 16, schema_fields=LOADER_FIELDS, reader_pool_type='dummy',
                     shuffle_row_groups=False, loader_kwargs=dict(device='cpu')) as loader:
        got = list(loader.scan_batches(port_step, torch.tensor(0, dtype=torch.int32),
                                       steps_per_call=steps_per_call))
    assert len(got) == len(want)
    for (carry, outs), (want_carry, want_outs) in zip(got, want):
        assert int(carry) == int(want_carry)
        assert outs.numpy().dtype == want_outs.dtype
        np.testing.assert_array_equal(outs.numpy(), want_outs)


def _port_batch_loader(url, resume_state=None, transfer=False, pool='dummy'):
    reader = make_batch_reader(url, schema_fields=LOADER_FIELDS, reader_pool_type=pool,
                               shuffle_row_groups=True, seed=3, num_epochs=2,
                               workers_count=2 if pool != 'dummy' else 10,
                               resume_state=None if resume_state is None
                               else resume_state['reader'])
    return DataLoader(reader, 16, device='cpu', transfer=transfer, resume_state=resume_state)


@pytest.mark.parametrize('transfer', [False, True])
def test_batch_loader_cut_and_resumed_gives_the_rest(plain, transfer):
    with _port_batch_loader(plain, transfer=transfer) as loader:
        full = [to_numpy(b) for b in loader]
    loader = _port_batch_loader(plain, transfer=transfer)
    with loader:
        it = iter(loader)
        consumed = [to_numpy(next(it)) for _ in range(4)]
        token = pickle.loads(pickle.dumps(loader.state_dict()))
        it.close()
    with _port_batch_loader(plain, resume_state=token, transfer=transfer) as loader:
        rest = [to_numpy(b) for b in loader]
    assert_batches_equal(consumed + rest, full)


def test_process_pool_token_carries_owned_tables(wide):
    """A snapshot of a process-pool batch loader drains tables that are
    views of shared-memory slabs; the token owns copies, so it reads back
    after the pool is gone."""
    loader = _port_batch_loader(wide, pool='process')
    with loader:
        it = iter(loader)
        consumed = [to_numpy(next(it)) for _ in range(2)]
        token = loader.state_dict()
        it.close()
    blob = pickle.dumps(token)
    for chunk in token['pushback']:
        assert all(v.flags.owndata or v.base is None or isinstance(v.base, np.ndarray)
                   for v in chunk.values())
    assert loader.reader.diagnostics['shm_results'] > 0
    with _port_batch_loader(wide, resume_state=pickle.loads(blob)) as resumed:
        rest = [to_numpy(b) for b in resumed]
    rows = np.concatenate([b['idx'] for b in consumed + rest])
    # two epochs, each row at most twice; drop_last leaves out < 16 rows
    counts = np.bincount(rows, minlength=WIDE_ROWS)
    assert counts.max() <= 2 and len(rows) == (2 * WIDE_ROWS // 16) * 16


def test_a_jax_batch_loader_token_resumes_the_port(plain):
    def jax_loader(resume=None):
        reader = jax_make_batch_reader(plain, schema_fields=LOADER_FIELDS,
                                       reader_pool_type='dummy', shuffle_row_groups=True,
                                       seed=3, num_epochs=2, scheduling='fifo', ingest='off',
                                       resume_state=None if resume is None else resume['reader'])
        return JaxDataLoader(reader, 16, transfer=False, resume_state=resume)

    with jax_loader() as loader:
        full = [to_numpy(b) for b in loader]
    loader = jax_loader()
    it = iter(loader)
    consumed = [to_numpy(next(it)) for _ in range(5)]
    token = pickle.loads(pickle.dumps(loader.state_dict()))
    loader.reader.stop()
    loader.reader.join()
    assert_batches_equal(consumed, full[:5])
    with _port_batch_loader(plain, resume_state=token) as resumed:
        assert_batches_equal([to_numpy(b) for b in resumed], full[5:])
    with _port_batch_loader(plain) as loader:
        it = iter(loader)
        next(it)
        port_token = loader.state_dict()
        it.close()
    assert sorted(port_token) == sorted(token)
    assert sorted(port_token['reader']) == sorted(token['reader'])

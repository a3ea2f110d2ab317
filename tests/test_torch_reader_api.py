"""The rest of the reader's and loader's public API, against the JAX package.

``Reader.reset`` (after the last row only), ``num_local_rows``, ``next``,
the ``predicate`` and ``transform_spec`` properties and
``last_row_consumed``; ``Unischema.make_namedtuple`` and
``insert_explicit_nulls``; every argument name of the JAX ``make_reader``
(each option outside the port's slice raises ``ValueError`` naming ROADMAP
Queue A item 7 when it asks for more than its default, never
``TypeError``); and ``DataLoader(min_after_retrieve=)``, whose buffer
order is the JAX loader's at the same seed.
"""

import inspect
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.jax import DataLoader as JaxDataLoader

from petastorm_tpu_torch import unischema as port_unischema
from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.transform import TransformSpec

from torch_plane_common import (ROWS, assert_batches_equal, jax_reader, port_reader, to_numpy,
                                write_dataset)
from torch_service_common import drop_hot_tiers


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_reader_api'))


def _ids(reader):
    return [int(r.id) for r in reader]


# -- Reader ------------------------------------------------------------------

@pytest.mark.parametrize('pool', ['dummy', 'thread', 'process'])
def test_reset_after_the_last_row_reads_again(url, pool):
    with port_reader(url, False, reader_pool_type=pool, workers_count=2,
                     shuffle_row_groups=True, seed=3) as reader:
        first = _ids(reader)
        assert reader.last_row_consumed
        reader.reset()
        assert not reader.last_row_consumed
        second = _ids(reader)
    assert sorted(first) == sorted(second) == list(range(ROWS))
    if pool == 'dummy':
        assert first == second
        with jax_reader(url, False, shuffle_row_groups=True, seed=3) as reader:
            want = _ids(reader)
            reader.reset()
            assert _ids(reader) == want
        assert first == want


@pytest.mark.parametrize('columnar', [False, True])
def test_reset_mid_iteration_raises_as_the_jax_reader(url, columnar):
    for make in (port_reader, jax_reader):
        with make(url, columnar) as reader:
            next(reader)
            with pytest.raises(NotImplementedError, match='mid-iteration'):
                reader.reset()


def test_next_is_dunder_next(url):
    with port_reader(url, False) as reader, jax_reader(url, False) as ref:
        for _ in range(3):
            assert int(reader.next().id) == int(ref.next().id)


NUM_ROWS_CASES = {
    'plain': dict(),
    'shard_1_of_3': dict(cur_shard=1, shard_count=3),
    'shard_seeded': dict(cur_shard=0, shard_count=2, shard_seed=5),
    'predicate': dict(predicate=in_lambda(['id'], lambda v: v['id'] % 2 == 0)),
}


@pytest.mark.parametrize('case', sorted(NUM_ROWS_CASES))
def test_num_local_rows_equals_the_jax_readers(url, case):
    kwargs = dict(NUM_ROWS_CASES[case])
    jax_kwargs = dict(kwargs)
    if 'predicate' in kwargs:
        from petastorm_tpu.predicates import in_lambda as jax_in_lambda
        jax_kwargs['predicate'] = jax_in_lambda(['id'], lambda v: v['id'] % 2 == 0)
    with port_reader(url, False, **kwargs) as reader, \
            jax_reader(url, False, **jax_kwargs) as ref:
        got = reader.num_local_rows()
        assert got == ref.num_local_rows()
        assert reader.num_local_rows() is got or reader.num_local_rows() == got
        delivered = len(list(reader))
    assert delivered <= got   # an upper bound under a predicate
    if case == 'plain':
        assert got == delivered == ROWS


def test_num_local_rows_of_a_plain_store_reads_the_footers(tmp_path):
    (tmp_path / 'plain').mkdir()
    for i in range(2):
        pq.write_table(pa.table({'a': np.arange(i * 30, i * 30 + 25)}),
                       str(tmp_path / 'plain' / ('part%d.parquet' % i)), row_group_size=10)
    store = 'file://%s' % (tmp_path / 'plain')
    with make_batch_reader(store, reader_pool_type='dummy', cur_shard=1, shard_count=2) as r, \
            jax_make_batch_reader(store, reader_pool_type='dummy', cur_shard=1, shard_count=2,
                                  scheduling='fifo', ingest='off') as ref:
        assert r.num_local_rows() == ref.num_local_rows() == 25


def test_predicate_and_transform_spec_properties(url):
    predicate = in_lambda(['id'], lambda v: v['id'] < 10)
    spec = TransformSpec(lambda row: row)
    with port_reader(url, False, predicate=predicate, transform_spec=spec) as reader:
        assert reader.predicate is predicate and reader.transform_spec is spec
        assert not reader.transform_may_change_row_count
        assert sorted(_ids(reader)) == list(range(10))
    with port_reader(url, False) as reader:
        assert reader.predicate is None and reader.transform_spec is None


# -- make_reader's argument names ------------------------------------------

def test_make_reader_takes_every_argument_name_of_the_jax_reader():
    ours = inspect.signature(make_reader).parameters
    ref = inspect.signature(petastorm_tpu.make_reader).parameters
    assert set(ref) <= set(ours), sorted(set(ref) - set(ours))
    for name in ('cache_location', 'cache_size_limit', 'cache_row_size_estimate',
                 'cache_extra_settings', 'storage_options', 'filesystem', 'hdfs_driver',
                 'ingest_window'):
        assert ours[name].default == ref[name].default, name


OUTSIDE_THE_SLICE = {
    'storage_options': dict(storage_options={'anon': True}),
    'filesystem': dict(filesystem=object()),
    'hdfs_driver': dict(hdfs_driver='libhdfs3'),
    'ingest_window': dict(ingest_window=8),
}


@pytest.mark.parametrize('factory', ['make_reader', 'make_batch_reader'])
@pytest.mark.parametrize('name', sorted(OUTSIDE_THE_SLICE))
def test_an_option_outside_the_slice_names_queue_a_item_7(url, factory, name):
    make = make_reader if factory == 'make_reader' else make_batch_reader
    with pytest.raises(ValueError, match='Queue A item 7') as raised:
        make(url, **OUTSIDE_THE_SLICE[name])
    assert name in str(raised.value)


#: the cache options, each with a cache that reads it
CACHE_OPTIONS = {
    'cache_location': dict(cache_type='local-disk'),
    'cache_size_limit': dict(cache_type='plane', cache_size_limit=1 << 30),
    'cache_row_size_estimate': dict(cache_type='local-disk', cache_row_size_estimate=1024),
    'cache_extra_settings': dict(cache_type='plane', cache_extra_settings={'cleanup': True}),
}


def _cached_ids(make, url, kwargs):
    with make(url, reader_pool_type='dummy', shuffle_row_groups=False, **kwargs) as reader:
        ids = [int(i) for item in reader
               for i in (item.id.tolist() if reader.batched_output else [item.id])]
    return ids, reader.diagnostics.get('cache_hits')


@pytest.mark.parametrize('factory', ['make_reader', 'make_batch_reader'])
@pytest.mark.parametrize('name', sorted(CACHE_OPTIONS))
def test_a_cache_option_works_as_in_jax(url, tmp_path, factory, name):
    """Two epochs through the cache the option configures: the same rows as
    JAX's reader under the same option; the second epoch from the cache,
    unless ``cleanup`` emptied it when the first reader closed."""
    make, jax_make = ((make_reader, petastorm_tpu.make_reader) if factory == 'make_reader'
                      else (make_batch_reader, jax_make_batch_reader))
    kwargs = dict(CACHE_OPTIONS[name], cache_location=str(tmp_path / 'port'))
    (first, cold), (second, warm) = (_cached_ids(make, url, kwargs) for _ in range(2))
    ref = dict(kwargs, cache_location=str(tmp_path / 'jax'), scheduling='fifo', ingest='off')
    want, _ = _cached_ids(jax_make, url, ref)
    assert first == second == want and sorted(want) == list(range(ROWS))
    assert cold == 0
    cleanup = name == 'cache_extra_settings'
    assert warm == (0 if cleanup else ROWS // 8)
    left = [f for f in os.listdir(str(tmp_path / 'port')) if f.endswith(('.cpe', '.pkl'))]
    drop_hot_tiers(tmp_path)
    assert (not left) if cleanup else left


def test_the_defaults_of_those_options_read(url):
    with make_reader(url, reader_pool_type='dummy', cache_location=None, cache_size_limit=None,
                     cache_row_size_estimate=None, cache_extra_settings=None,
                     storage_options=None, filesystem=None, hdfs_driver='libhdfs',
                     ingest_window=None) as reader:
        assert len(_ids(reader)) == ROWS


# -- Unischema ---------------------------------------------------------------

def _schemas():
    out = []
    for u in (jax_unischema, port_unischema):
        out.append(u.Unischema('S', [
            u.UnischemaField('id', np.int64, (), None, False),
            u.UnischemaField('name', np.str_, (), None, True),
            u.UnischemaField('score', np.float32, (), None, True),
        ]))
    return out


def test_make_namedtuple_as_the_jax_package():
    ref, ours = _schemas()
    got = ours.make_namedtuple(id=3, name='a', score=None)
    want = ref.make_namedtuple(id=3, name='a', score=None)
    assert got._fields == want._fields and tuple(got) == tuple(want)
    assert type(got).__name__ == type(want).__name__ == 'S'
    assert type(ours.make_namedtuple(id=1, name=None, score=1.0)) is type(got)
    with pytest.raises(TypeError):
        ours.make_namedtuple(id=1)


@pytest.mark.parametrize('row', [{'id': 1}, {'id': 1, 'name': 'x'}, {'id': 2, 'score': None},
                                 {'id': 3, 'name': 'y', 'score': 0.5}])
def test_insert_explicit_nulls_as_the_jax_package(row):
    ref, ours = _schemas()
    want = jax_unischema.insert_explicit_nulls(ref, dict(row))
    got_row = dict(row)
    got = port_unischema.insert_explicit_nulls(ours, got_row)
    assert got is got_row and got == want


def test_insert_explicit_nulls_refuses_a_missing_required_field():
    ref, ours = _schemas()
    for module, schema in ((jax_unischema, ref), (port_unischema, ours)):
        with pytest.raises(ValueError, match="'id' is not nullable"):
            module.insert_explicit_nulls(schema, {'name': 'x'})


# -- DataLoader(min_after_retrieve=) ----------------------------------------

@pytest.mark.parametrize('min_after_retrieve', [None, 0, 5, 30])
@pytest.mark.parametrize('transfer', [False, True])
def test_min_after_retrieve_draws_the_jax_loaders_order(url, min_after_retrieve, transfer):
    kwargs = dict(shuffling_queue_capacity=32, min_after_retrieve=min_after_retrieve, seed=11,
                  drop_last=False)
    with JaxDataLoader(jax_reader(url, False), 8, transfer=False, **kwargs) as loader:
        want = [to_numpy(b) for b in loader]
    with DataLoader(port_reader(url, False), 8, device='cpu', transfer=transfer,
                    **kwargs) as loader:
        got = [to_numpy(b) for b in loader]
    assert_batches_equal(got, want)
    assert sorted(np.concatenate([b['id'] for b in got]).tolist()) == list(range(ROWS))


def test_min_after_retrieve_changes_the_order(url):
    orders = []
    for mar in (0, 30):
        with DataLoader(port_reader(url, False), 8, device='cpu', shuffling_queue_capacity=32,
                        min_after_retrieve=mar, seed=11) as loader:
            orders.append(np.concatenate([to_numpy(b)['id'] for b in loader]).tolist())
    assert orders[0] != orders[1]
    with pytest.raises(ValueError, match='min_after_retrieve must be < capacity'):
        with DataLoader(port_reader(url, False), 8, device='cpu', shuffling_queue_capacity=32,
                        min_after_retrieve=32, transfer=False) as loader:
            next(iter(loader))

"""Row-group selectors and row-drop partitions of the port
(``petastorm_tpu_torch.selectors``, ``etl.rowgroup_indexing``,
``etl.rowgroup_indexers`` and the readers' ``rowgroup_selector`` and
``shuffle_row_drop_partitions``) against the JAX package's, on the CPU.

On one store written once per module (numpy from a seed): an index built by
either package is read by the other (the port through its mapping unpickler,
an upstream-named index too) and the single, intersect and union selectors
select the same row groups; ``make_reader`` and ``make_batch_reader`` with a
selector deliver JAX's rows; ``shuffle_row_drop_partitions`` 2 and 3 deliver
JAX's rows item by item with JAX's ``piece_cache_key`` strings; a checkpoint
taken under row-drop partitions reshards 2 -> 3 into JAX's tokens and
resumes to every row exactly once.  The reference's cases in
``tests/test_end_to_end.py``, ``tests/test_query_shaping.py`` and
``tests/test_elastic.py`` are the model.
"""

import pickle
import shutil
import zlib
from collections import Counter

import numpy as np
import pytest

from petastorm_tpu import elastic as jax_elastic
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import py_dict_reader_worker as jax_worker
from petastorm_tpu import selectors as jax_selectors
from petastorm_tpu.etl import rowgroup_indexers as jax_indexers
from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
from petastorm_tpu.etl.dataset_metadata import DatasetWriter as JaxDatasetWriter

from petastorm_tpu_torch import elastic, py_dict_reader_worker, selectors
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl import rowgroup_indexers, rowgroup_indexing
from petastorm_tpu_torch.etl.dataset_metadata import get_schema, load_row_groups
from petastorm_tpu_torch.fs_utils import LocalFilesystem
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

from test_common import TestSchema, make_test_rows

ROWS = 60
PER_GROUP = 5           # 12 row groups


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """``{'plain', 'port', 'jax'}`` -> path: the store, and copies indexed
    by the port's and by JAX's ``build_rowgroup_index`` (``id2`` constant
    per row group, ``sensor_name`` varying within one)."""
    root = tmp_path_factory.mktemp('torch_selectors')
    rows = make_test_rows(ROWS, seed=2)
    for i, row in enumerate(rows):
        row['id2'] = np.int32(i // PER_GROUP % 3)
        row['sensor_name'] = 'sensor_%d' % (i // PER_GROUP % 4 if i % 2 else i % 3)
    plain = str(root / 'plain')
    with JaxDatasetWriter('file://' + plain, TestSchema, rows_per_rowgroup=PER_GROUP) as w:
        w.write_many(rows)
    out = {'plain': plain}
    for label, indexing, indexers in (('port', rowgroup_indexing, rowgroup_indexers),
                                      ('jax', jax_indexing, jax_indexers)):
        out[label] = str(root / label)
        shutil.copytree(plain, out[label])
        indexing.build_rowgroup_index('file://' + out[label], indexers=[
            indexers.SingleFieldIndexer('id2_idx', 'id2'),
            indexers.SingleFieldIndexer('sensor_idx', 'sensor_name')])
    return out


def _selector_cases(mod):
    return [mod.SingleIndexSelector('id2_idx', [0, 2]),
            mod.SingleIndexSelector('sensor_idx', ['sensor_3']),
            mod.IntersectIndexSelector([mod.SingleIndexSelector('id2_idx', [1, 2]),
                                        mod.SingleIndexSelector('sensor_idx', ['sensor_1'])]),
            mod.UnionIndexSelector([mod.SingleIndexSelector('id2_idx', [1]),
                                    mod.SingleIndexSelector('sensor_idx', ['sensor_3'])])]


@pytest.mark.parametrize('builder', ['port', 'jax'])
def test_an_index_of_either_package_selects_alike_in_both(stores, builder):
    path = stores[builder]
    ours = rowgroup_indexing.get_row_group_indexes(LocalFilesystem(), path)
    import fsspec
    ref = jax_indexing.get_row_group_indexes(fsspec.filesystem('file'), path)
    assert sorted(ours) == sorted(ref) == ['id2_idx', 'sensor_idx']
    assert all(isinstance(ix, rowgroup_indexers.SingleFieldIndexer) for ix in ours.values())
    for name in ours:
        assert ours[name].index_field == ref[name].index_field
        assert sorted(ours[name].indexed_values()) == sorted(ref[name].indexed_values())
        assert ours[name].get_row_group_indexes() == ref[name].get_row_group_indexes()
    selected = []
    for sel, jax_sel in zip(_selector_cases(selectors), _selector_cases(jax_selectors)):
        got = sel.select_row_groups(ours)
        assert got == jax_sel.select_row_groups(ref) == jax_sel.select_row_groups(ours)
        assert sel.get_index_names() == jax_sel.get_index_names()
        selected.append(got)
    assert all(0 < len(s) < ROWS // PER_GROUP for s in selected), selected


def test_the_indexes_blob_holds_the_writers_class_path(stores):
    blobs = {}
    for label in ('port', 'jax'):
        meta = rowgroup_indexing._read_common_metadata(LocalFilesystem(), stores[label])
        blobs[label] = zlib.decompress(meta.metadata[rowgroup_indexing.ROWGROUPS_INDEX_KEY])
    assert b'petastorm_tpu_torch.etl.rowgroup_indexers' in blobs['port']
    assert b'petastorm_tpu.etl.rowgroup_indexers' in blobs['jax']
    assert b'petastorm_tpu_torch' not in blobs['jax']
    # the store's schema and row groups read as before the index
    fs = LocalFilesystem()
    assert list(get_schema(fs, stores['port']).fields) == list(TestSchema.fields)
    assert len(load_row_groups(fs, stores['port'])) == ROWS // PER_GROUP


def test_an_upstream_index_reads_and_other_globals_are_refused(stores, tmp_path):
    """An index pickled by upstream petastorm names
    ``petastorm.etl.rowgroup_indexers`` and keeps the field as
    ``_column_name``; the port reads it as its own class.  A blob naming any
    other global raises."""
    fs = LocalFilesystem()
    ref = jax_indexing.get_row_group_indexes(fs, stores['jax'])
    blob = pickle.dumps(ref, protocol=2)   # text globals: renamable in place
    assert blob.count(b'petastorm_tpu.etl.rowgroup_indexers\n') >= 1
    upstream = blob.replace(b'petastorm_tpu.etl.rowgroup_indexers\n',
                            b'petastorm.etl.rowgroup_indexers\n')
    upstream = upstream.replace(b'_index_field', b'_column_name')
    assert b'_column_name' in upstream
    got = rowgroup_indexing._loads_index(zlib.compress(upstream))
    assert got['id2_idx'].index_field == 'id2'
    for sel, jax_sel in zip(_selector_cases(selectors), _selector_cases(jax_selectors)):
        assert sel.select_row_groups(got) == jax_sel.select_row_groups(ref)

    class Evil(object):
        def __reduce__(self):
            return (shutil.rmtree, (str(tmp_path / 'never'),))
    with pytest.raises(pickle.UnpicklingError, match='shutil'):
        rowgroup_indexing._loads_index(zlib.compress(pickle.dumps({'x': Evil()})))
    with pytest.raises(MetadataError, match='build_rowgroup_index'):
        rowgroup_indexing.get_row_group_indexes(fs, stores['plain'])
    with pytest.raises(ValueError, match='no index named'):
        selectors.SingleIndexSelector('nope', [1]).select_row_groups(got)
    with pytest.raises(ValueError, match='not in schema'):
        rowgroup_indexing.build_rowgroup_index(
            'file://' + stores['plain'],
            indexers=[rowgroup_indexers.SingleFieldIndexer('x', 'no_such_field')])


def _ids(rows):
    return [int(r.id) for r in rows]


@pytest.mark.parametrize('case', range(4))
@pytest.mark.parametrize('columnar', [False, True])
def test_make_reader_with_a_selector_delivers_jax_s_rows(stores, case, columnar):
    url = 'file://' + stores['port']
    kw = dict(num_epochs=1, shuffle_row_groups=True, seed=3, reader_pool_type='dummy',
              columnar_decode=columnar, schema_fields=['id', 'id2', 'matrix'])
    with make_reader(url, rowgroup_selector=_selector_cases(selectors)[case], **kw) as r:
        ours = list(r)
    with jax_make_reader(url, rowgroup_selector=_selector_cases(jax_selectors)[case],
                         **kw) as r:
        ref = list(r)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        for name in ('id', 'id2', 'matrix'):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_make_batch_reader_with_a_selector_delivers_jax_s_rows(stores):
    """The JAX batch reader takes no selector: its rows over the selected
    row groups (``piece_indices``) are the reference."""
    url = 'file://' + stores['port']
    fs = LocalFilesystem()
    for sel, jax_sel in zip(_selector_cases(selectors), _selector_cases(jax_selectors)):
        keep = sorted(jax_sel.select_row_groups(
            jax_indexing.get_row_group_indexes(fs, stores['port'])))
        with make_batch_reader(url, rowgroup_selector=sel, schema_fields=['id', 'id2'],
                               shuffle_row_groups=False, reader_pool_type='dummy') as r:
            ours = [(b.id.tolist(), b.id2.tolist()) for b in r]
        with jax_make_batch_reader(url, piece_indices=keep, schema_fields=['id', 'id2'],
                                   shuffle_row_groups=False, reader_pool_type='dummy') as r:
            ref = [(b.id.tolist(), b.id2.tolist()) for b in r]
        assert ours == ref and len(ours) == len(keep)
    with pytest.raises(ValueError, match='rowgroup_selector/filters would renumber'):
        make_batch_reader(url, rowgroup_selector=_selector_cases(selectors)[0],
                          piece_indices=[0])


def test_a_selector_then_filters_compose_as_jax_s(stores):
    url = 'file://' + stores['port']
    kw = dict(num_epochs=1, shuffle_row_groups=False, reader_pool_type='dummy',
              schema_fields=['id'], filters=[('id', '>=', 20)])
    with make_reader(url, rowgroup_selector=_selector_cases(selectors)[0], **kw) as r:
        ours = _ids(r)
    with jax_make_reader(url, rowgroup_selector=_selector_cases(jax_selectors)[0], **kw) as r:
        ref = _ids(r)
    assert ours == ref and ours and min(ours) >= 20
    with pytest.raises(ValueError, match='rowgroup_selector/filters would renumber'):
        make_reader(url, rowgroup_selector=_selector_cases(selectors)[0], piece_indices=[0])


@pytest.mark.parametrize('partitions', [2, 3])
@pytest.mark.parametrize('columnar', [False, True])
def test_row_drop_partitions_deliver_jax_s_rows_item_by_item(stores, partitions, columnar):
    url = 'file://' + stores['plain']
    kw = dict(num_epochs=1, shuffle_row_groups=True, seed=5, reader_pool_type='dummy',
              shuffle_row_drop_partitions=partitions, columnar_decode=columnar,
              schema_fields=['id', 'embedding', 'sensor_name'])
    with make_reader(url, **kw) as r:
        ours = list(r)
        token = r.state_dict()
    with jax_make_reader(url, **kw) as r:
        ref = list(r)
        ref_token = r.state_dict()
    assert token == ref_token and token['drop_partitions'] == partitions
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for name in ('id', 'embedding', 'sensor_name'):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)))
    ids = [i for row in ours for i in np.atleast_1d(np.asarray(row.id)).tolist()]
    assert sorted(ids) == list(range(ROWS))   # each row once: N reads, disjoint slices


def test_row_drop_keys_are_jax_s(stores):
    from petastorm_tpu.etl.dataset_metadata import load_row_groups as jax_load_row_groups
    from petastorm_tpu.transform import TransformSpec as JaxTransformSpec

    from petastorm_tpu_torch.transform import TransformSpec
    fs = LocalFilesystem()
    pieces = load_row_groups(fs, stores['plain'])
    ref_pieces = jax_load_row_groups(fs, stores['plain'])
    schema = get_schema(fs, stores['plain'])
    view = schema.create_schema_view(['id', 'matrix'])
    ref_view = TestSchema.create_schema_view(['id', 'matrix'])
    for spec, ref_spec in ((None, None), (TransformSpec(selected_fields=['id']),
                                          JaxTransformSpec(selected_fields=['id']))):
        for piece, ref_piece in zip(pieces, ref_pieces):
            for part in range(3):
                assert py_dict_reader_worker.piece_cache_key(piece, view, spec, part) == \
                    jax_worker.piece_cache_key(ref_piece, ref_view, ref_spec, part)
    assert py_dict_reader_worker.piece_cache_key(pieces[0], view, None).split(':')[2] == '0'


def test_a_row_drop_checkpoint_reshards_two_to_three_as_jax_s(stores):
    url = 'file://' + stores['plain']
    kw = dict(num_epochs=1, shuffle_row_groups=True, seed=11, reader_pool_type='dummy',
              shuffle_row_drop_partitions=2, schema_fields=['id'])
    consumed, states = [], []
    for shard in range(2):
        reader = make_reader(url, cur_shard=shard, shard_count=2, **kw)
        consumed.append(next(iter(reader)))
        consumed.extend(reader.drain_in_flight())
        states.append(reader.state_dict())
        reader.stop()
        reader.join()
    assert all(s['drop_partitions'] == 2 for s in states)
    tokens = elastic.reshard_reader_states(states, 3)
    assert tokens == jax_elastic.reshard_reader_states(states, 3)
    assert any(p for token in tokens for _, p in token.get('prologue') or ())
    after = {}
    for m, token in enumerate(tokens):
        with make_reader(url, cur_shard=m, shard_count=3, resume_state=token, **kw) as r:
            after[m] = _ids(r)
        with jax_make_reader(url, cur_shard=m, shard_count=3, resume_state=token, **kw) as r:
            assert _ids(r) == after[m], m
    total = Counter(_ids(consumed)) + Counter(i for ids in after.values() for i in ids)
    assert total == Counter({i: 1 for i in range(ROWS)})


def test_a_selector_checkpoint_reshards_as_jax_s(stores):
    """Global piece indices name the pruned list: resharding under the same
    selector reproduces the remaining work."""
    url = 'file://' + stores['port']
    kw = dict(num_epochs=1, shuffle_row_groups=True, seed=4, reader_pool_type='dummy',
              schema_fields=['id'])

    def reader(mod_reader, mod, shard, count, token=None):
        return mod_reader(url, cur_shard=shard, shard_count=count, resume_state=token,
                          rowgroup_selector=mod.SingleIndexSelector('id2_idx', [0, 1]), **kw)

    states, consumed = [], []
    for shard in range(2):
        r = reader(make_reader, selectors, shard, 2)
        consumed.append(next(iter(r)))
        consumed.extend(r.drain_in_flight())
        states.append(r.state_dict())
        r.stop()
        r.join()
    tokens = elastic.reshard_reader_states(states, 3)
    assert tokens == jax_elastic.reshard_reader_states(states, 3)
    after = []
    for m, token in enumerate(tokens):
        with reader(make_reader, selectors, m, 3, token) as r:
            ours = _ids(r)
        with reader(jax_make_reader, jax_selectors, m, 3, token) as r:
            assert _ids(r) == ours
        after.extend(ours)
    with make_reader(url, rowgroup_selector=selectors.SingleIndexSelector('id2_idx', [0, 1]),
                     **kw) as r:
        truth = Counter(_ids(r))
    assert Counter(_ids(consumed)) + Counter(after) == truth and sum(truth.values()) < ROWS

"""The port's materialization plane (``petastorm_tpu_torch.materialize``) against
the JAX package's, on the CPU.

Mirrors ``tests/test_materialize.py``: on one small store (numpy from a seed,
written once per module) the port's controller and JAX's warm two planes,
which must hold the same entries (digests, so cache keys and plane contexts)
with equal values; a first epoch over the port's warm plane decodes nothing
and delivers what a direct read delivers.  Then ledger resume and a foreign
ledger, the kill switch, lease expiry and the attempt ceiling, release
without burn, ``admit_publish`` refusing hot victims and the controller's
refusal keeping attempts intact, the wire entries (the narrowed bfloat16
bits, ``widen_entry``, ``policy_token`` and ``wire_key`` equal to JAX's),
``rewrite_layout`` and ``layout_stats`` against JAX's on the same store, the
writer's geometry against JAX's writer, ``derive_candidates``' ranking, the
dispatcher's deferred drain (and the deadline over a stuck pass), row-drop
partitions' entries, and ``materialize_kill`` end to end.
"""

import os
import time

import numpy as np
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.cache_plane.plane import CachePlane as JaxCachePlane
from petastorm_tpu.materialize import MaterializeController as JaxController
from petastorm_tpu.materialize import controller as jax_controller
from petastorm_tpu.materialize import rewrite as jax_rewrite
from petastorm_tpu.materialize import transcode as jax_transcode
from petastorm_tpu.service.dispatcher import Dispatcher as JaxDispatcher

from petastorm_tpu_torch.cache_plane.plane import CachePlane, decode_entry
from petastorm_tpu_torch.materialize import (MATERIALIZE_LEDGER_KIND, MaterializeController,
                                             controller, layout_stats, rewrite_layout,
                                             transcode)
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.service.config import ServiceConfig
from petastorm_tpu_torch.service.dispatcher import Dispatcher

from test_common import TestSchema, create_test_dataset, make_test_rows
from torch_service_common import drop_hot_tiers

ROWS = 24
ROWS_PER_GROUP = 4      # 6 pieces
PIECES = ROWS // ROWS_PER_GROUP
#: No hot tier in /dev/shm for the planes of this file.
NO_RAM = dict(cache_plane_ram_bytes=0)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp('torch_matds')
    return create_test_dataset('file://' + str(path), num_rows=ROWS,
                               rows_per_rowgroup=ROWS_PER_GROUP)


@pytest.fixture
def planes(tmp_path):
    yield tmp_path
    drop_hot_tiers(tmp_path)


def _entries(plane_dir):
    """``{entry file name: decoded value}`` of a plane directory."""
    out = {}
    for name in sorted(os.listdir(plane_dir)):
        if name.endswith('.cpe'):
            with open(os.path.join(plane_dir, name), 'rb') as f:
                out[name] = decode_entry(f.read())
    return out


def _assert_values_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_values_equal(a[k], b[k])
    elif isinstance(a, np.ndarray) and a.dtype != object:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert list(np.asarray(a, dtype=object).ravel()) == \
            list(np.asarray(b, dtype=object).ravel())


def _warm_both(url, root, **kwargs):
    """The port's and JAX's controllers, each run on a plane of its own;
    ``(port summary, jax summary, port plane dir, jax plane dir)``."""
    port_dir, jax_dir = str(root / 'plane_port'), str(root / 'plane_jax')
    with MaterializeController(url, port_dir, **dict(NO_RAM, **kwargs)) as c:
        ours = c.run()
    with JaxController(url, jax_dir, **dict(NO_RAM, **kwargs)) as c:
        ref = c.run()
    return ours, ref, port_dir, jax_dir


def _summary_sans_time(summary):
    return {k: v for k, v in summary.items() if k not in ('elapsed_s', 'published_bytes')}


def _read_columns(url, plane_dir=None, reader=make_reader, **kwargs):
    """One first epoch through the consumer's decode path; ``({id: row},
    diagnostics)``."""
    if plane_dir is not None:
        kwargs.update(cache_type='plane', cache_location=plane_dir,
                      cache_extra_settings={'ram_bytes': 0})
    cols = {}
    with reader(url, num_epochs=1, shuffle_row_groups=False, workers_count=2,
                columnar_decode=True, **kwargs) as r:
        for batch in r:
            d = batch._asdict()
            for i, row_id in enumerate(np.asarray(d['id'])):
                cols[int(row_id)] = {k: np.asarray(v)[i] for k, v in d.items()}
        diag = dict(r.diagnostics)
    return cols, diag


# -- warm once: the first epoch decodes nothing --------------------------------

def test_warm_first_epoch_serves_without_decodes(dataset, planes):
    ours, ref, port_dir, jax_dir = _warm_both(dataset.url, planes)
    assert ours['ok'] and ours['total_pieces'] == PIECES
    assert ours['done'] == PIECES and not ours['failed_pieces'] and ours['published_bytes'] > 0
    assert _summary_sans_time(ours) == _summary_sans_time(ref)
    # the same entries under the same digests (cache keys and plane context
    # equal to JAX's), with equal values
    port_entries, jax_entries = _entries(port_dir), _entries(jax_dir)
    assert sorted(port_entries) == sorted(jax_entries) and len(port_entries) == PIECES
    for name in port_entries:
        _assert_values_equal(port_entries[name], jax_entries[name])

    served, diag = _read_columns(dataset.url, plane_dir=port_dir)
    assert diag.get('cache_misses') == 0, diag
    assert diag.get('cache_hits') >= PIECES, diag
    truth, _ = _read_columns(dataset.url, reader=jax_make_reader)
    assert sorted(served) == sorted(truth) == list(range(ROWS))
    for row_id in truth:
        for field in ('matrix', 'embedding', 'image_png', 'id2'):
            np.testing.assert_array_equal(served[row_id][field], truth[row_id][field])


def test_the_identitys_keys_and_digests_equal_jax(dataset, planes):
    with MaterializeController(dataset.url, str(planes / 'p'), **NO_RAM) as c, \
            JaxController(dataset.url, str(planes / 'j'), **NO_RAM) as ref:
        assert c.identity.plane.context == ref.identity.plane.context
        for index in range(PIECES):
            assert c.identity.piece_digests(index) == ref.identity.piece_digests(index)
            assert controller.wire_digests(c.identity, index) == \
                jax_controller.wire_digests(ref.identity, index)
        assert c._context_token == ref._context_token


# -- the ledger ------------------------------------------------------------------

def test_ledger_resume_is_attempt_intact(dataset, planes):
    results = {}
    for label, cls in (('port', MaterializeController), ('jax', JaxController)):
        plane, ledger = str(planes / ('plane_' + label)), str(planes / ('ledger_%s.json' % label))
        with cls(dataset.url, plane, ledger_path=ledger, **NO_RAM) as c:
            first = c.run(max_pieces=2)
        with cls(dataset.url, plane, ledger_path=ledger, **NO_RAM) as c:
            resumed = c.resumed_pieces
            second = c.run()
        results[label] = (_summary_sans_time(first), resumed, _summary_sans_time(second))
    first, resumed, second = results['port']
    assert first['done'] == 2 and first['pending'] == PIECES - 2
    assert resumed == 2 and second['resumed'] == 2
    assert second['done'] == PIECES and second['warmed'] == PIECES - 2
    assert not second['failed_pieces']
    assert results['port'] == results['jax']


def test_foreign_ledger_cold_starts(dataset, planes):
    """A ledger written under another identity or geometry cold-starts."""
    from petastorm_tpu_torch.service.ledger import DispatcherLedger
    ledger = str(planes / 'ledger.json')
    foreign = DispatcherLedger(ledger, kind=MATERIALIZE_LEDGER_KIND)
    assert foreign.acquire()
    foreign.save({'context': 'not-this-dataset', 'dataset_url': 'file:///elsewhere',
                  'splits': [[2, 1]] * 99})
    foreign.release()
    with MaterializeController(dataset.url, str(planes / 'plane'), ledger_path=ledger,
                               **NO_RAM) as c:
        assert c.resumed_pieces == 0
        assert c.run()['done'] == PIECES


def test_a_jax_ledger_resumes_in_the_port(dataset, planes):
    """Both packages write the same ledger for the same job: the port's
    controller resumes the progress of JAX's."""
    plane, ledger = str(planes / 'plane'), str(planes / 'ledger.json')
    with JaxController(dataset.url, plane, ledger_path=ledger, **NO_RAM) as c:
        c.run(max_pieces=3)
    with MaterializeController(dataset.url, plane, ledger_path=ledger, **NO_RAM) as c:
        assert c.resumed_pieces == 3
        summary = c.run()
    assert summary['warmed'] == PIECES - 3 and summary['done'] == PIECES


def test_kill_switch_disables_every_entry_point(dataset, planes, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_NO_MATERIALIZE', '1')
    for cls in (MaterializeController, JaxController):
        with cls(dataset.url, str(planes / 'plane'), **NO_RAM) as c:
            assert c.run() == {'ok': False, 'reason': 'kill_switch'}
            assert c.lease('w0', n=6) == []
            assert c.offer_drain_candidate('w0') is False
    assert not list((planes / 'plane').glob('*.cpe'))


# -- the lease protocol ----------------------------------------------------------

def _lease_story(cls, url, plane_dir):
    out = []
    with cls(url, plane_dir, lease_ttl_s=0.05, max_piece_attempts=2, **NO_RAM) as c:
        total = c.summary()['total_pieces']
        g1 = c.lease('w1', n=2)
        g2 = c.lease('w2', n=total)
        out += [g1, g2, c.lease('w3', n=total)]
        time.sleep(0.1)                       # every lease expires: requeued
        g3 = c.lease('w3', n=total)
        out.append(g3)
        for index in g3:
            c.release('w3', index)            # burned: crashing pieces
        out += [c.lease('w4', n=total), c.summary()]
    return out


def test_lease_expiry_requeues_and_ceiling_poisons(dataset, planes):
    ours = _lease_story(MaterializeController, dataset.url, str(planes / 'p'))
    g1, g2, none, g3, after_ceiling, summary = ours
    assert len(g1) == 2 and len(g2) == PIECES - 2 and set(g1).isdisjoint(g2)
    assert none == [] and sorted(g3) == list(range(PIECES))
    assert after_ceiling == [] and summary['failed_pieces'] == PIECES
    assert ours == _lease_story(JaxController, dataset.url, str(planes / 'j'))


def test_release_without_burn_refunds_the_attempt(dataset, planes):
    with MaterializeController(dataset.url, str(planes / 'plane'), **NO_RAM) as c:
        (index,) = c.lease('w1', n=1)
        assert c._piece_state[index][1] == 1
        c.release('w1', index, burn_attempt=False)
        assert c._piece_state[index][1] == 0
        assert c.summary()['pending'] == c.summary()['total_pieces']
        c.fail('w1', c.lease('w1', n=1)[0])
        assert c._piece_state[index][1] == 1 and c.summary()['pending'] == PIECES


# -- eviction-aware admission -------------------------------------------------------

def _admission_story(plane):
    out = [plane.publish_blob(plane.digest('resident'), b'x' * 2048)]
    for nbytes in (1024, 16384):
        est = dict(plane.disk.eviction_estimate(nbytes))
        out.append((est.pop('victim_newest_age_s') is None, est))
    out.append(plane.admit_publish(1024)[0])
    out.append(plane.admit_publish(16384, hot_window_s=300.0)[0])
    out.append(plane.admit_publish(16384, hot_window_s=0.0)[0])
    (entry,) = [os.path.join(plane.disk.root, n) for n in os.listdir(plane.disk.root)
                if n.endswith('.cpe')]
    old = time.time() - 1000.0
    os.utime(entry, (old, old))               # aged past the hot window
    admitted, est = plane.admit_publish(16384, hot_window_s=300.0)
    out.append((admitted, est['victim_newest_age_s'] >= 300.0))
    return out


def test_admit_publish_refuses_hot_victims(planes):
    ours = _admission_story(CachePlane(str(planes / 'p'), disk_capacity_bytes=8192,
                                       ram_capacity_bytes=0))
    stored, (no_age, fits), (aged, evicts), small, hot, zero_window, cooled = ours
    assert stored and no_age and fits == {'fits': True, 'victims': 0, 'victim_bytes': 0,
                                          'total_bytes': 2048}
    assert not aged and evicts['victims'] == 1 and evicts['victim_bytes'] == 2048
    assert small and not hot and zero_window and cooled == (True, True)
    assert ours == _admission_story(JaxCachePlane(str(planes / 'j'), disk_capacity_bytes=8192,
                                                  ram_capacity_bytes=0))


def test_controller_admission_refusal_is_attempt_intact(dataset, planes):
    """A hot resident fills a small plane: every piece is refused, released
    with its attempt refunded and left pending; the resident survives."""
    for label, cls in (('port', MaterializeController), ('jax', JaxController)):
        with cls(dataset.url, str(planes / label), cache_plane_disk_bytes=28672,
                 **NO_RAM) as c:
            plane = c.identity.plane
            assert plane.publish_blob(plane.digest('hot-resident'), b'x' * 24576)
            summary = c.run()
            assert summary['done'] == 0 and summary['admission_refused'] >= 1, label
            assert summary['pending'] == summary['total_pieces']
            assert not summary['failed_pieces']
            assert all(rec[1] == 0 for rec in c._piece_state)
            assert plane.has_digest(plane.digest('hot-resident'))


# -- wire entries ------------------------------------------------------------------

def _wire_columns(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 5)) * 10.0 ** rng.integers(-30, 30, (64, 5))).astype(np.float32)
    x.ravel()[:10] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 3.4e38,
                      65504.0]
    return {'x': x, 'd': rng.standard_normal(64) * 1e5, 'i': np.arange(64, dtype=np.int64),
            'u': rng.integers(0, 255, (64, 3), dtype=np.uint8), 'b': rng.random(64) > 0.5}


@pytest.mark.parametrize('policy', ['auto', {'x': 'bfloat16', 'd': 'float16'},
                                    {'d': np.float32, 'i': 'int16'}])
def test_wire_entry_bits_and_widening_equal_jax(policy):
    cols = _wire_columns()
    ours, ref = transcode.wire_entry(cols, policy), jax_transcode.wire_entry(cols, policy)
    assert transcode.is_wire_entry(ours) and ours['policy'] == ref['policy']
    assert ours['out'] == ref['out'] and set(ours['columns']) == set(ref['columns'])
    for name, col in ref['columns'].items():
        if col.dtype.name == 'bfloat16':
            assert ours['wire'][name] == 'bfloat16'
            np.testing.assert_array_equal(ours['columns'][name], col.view(np.uint16))
        else:
            assert ours['columns'][name].dtype == col.dtype
            assert ours['columns'][name].tobytes() == col.tobytes()
    widened, ref_widened = transcode.widen_entry(ours), jax_transcode.widen_entry(ref)
    for name in ref_widened:
        assert widened[name].dtype == ref_widened[name].dtype
        assert widened[name].tobytes() == ref_widened[name].tobytes(), name
    assert transcode.verify_wire_identity(cols, ours, policy)
    # JAX's check compares without equal_nan, so it refuses an entry with a
    # NaN in any column (a known difference: the port's accepts it);
    # without the NaNs both accept
    assert not jax_transcode.verify_wire_identity(cols, ref, policy)
    finite = dict(cols, x=np.nan_to_num(cols['x'], nan=1.0))
    assert transcode.verify_wire_identity(finite, transcode.wire_entry(finite, policy), policy)
    assert jax_transcode.verify_wire_identity(finite, jax_transcode.wire_entry(finite, policy),
                                              policy)
    # a corrupted narrow fails the check
    bad = dict(ours, columns=dict(ours['columns']))
    bad['columns']['x'] = bad['columns']['x'] ^ np.uint16(0x10) \
        if ours['wire']['x'] == 'bfloat16' else bad['columns']['x'] + 1
    assert not transcode.verify_wire_identity(cols, bad, policy)


def test_wire_entry_degrades_to_none():
    for cols in ({'u': np.zeros(4, np.uint8), 'i': np.arange(4, dtype=np.int32)}, {}, [1, 2],
                 {'s': np.array(['a', 'b'], dtype=object)}):
        assert transcode.wire_entry(cols) is None
        assert jax_transcode.wire_entry(cols) is None
    assert not transcode.is_wire_entry({'columns': {}})


def test_wire_key_and_policy_token_equal_jax():
    import ml_dtypes
    assert transcode.wire_key('piece:0', 'auto') == 'piece:0:w{auto}'
    for policy in (None, 'auto', {'x': 'float16', 'y': np.float32},
                   {'y': np.float32, 'x': 'float16'}, ('odd',)):
        assert transcode.policy_token(policy) == jax_transcode.policy_token(policy)
        assert transcode.wire_key('k', policy) == jax_transcode.wire_key('k', policy)
    assert transcode.policy_token({'x': 'bfloat16'}) == \
        jax_transcode.policy_token({'x': ml_dtypes.bfloat16})


def test_controller_publishes_wire_siblings_for_numeric_views(dataset, planes):
    """A float view gets a second, narrowed entry per piece under JAX's
    digest, whose bits are JAX's sibling's."""
    fields = ['id', 'matrix', 'embedding']
    ours, ref, port_dir, jax_dir = _warm_both(dataset.url, planes,
                                              reader_kwargs={'schema_fields': fields})
    assert ours['done'] == PIECES and ours['wire_published'] == PIECES
    assert _summary_sans_time(ours) == _summary_sans_time(ref)
    port_entries, jax_entries = _entries(port_dir), _entries(jax_dir)
    assert sorted(port_entries) == sorted(jax_entries) and len(port_entries) == 2 * PIECES
    wires = 0
    for name, value in port_entries.items():
        ref_value = jax_entries[name]
        if not transcode.is_wire_entry(value):
            _assert_values_equal(value, ref_value)
            continue
        wires += 1
        for col in ('matrix', 'embedding'):
            np.testing.assert_array_equal(value['columns'][col],
                                          ref_value['columns'][col].view(np.uint16))
        widened, ref_widened = transcode.widen_entry(value), jax_transcode.widen_entry(ref_value)
        for col in widened:
            assert widened[col].tobytes() == ref_widened[col].tobytes()
    assert wires == PIECES


def test_full_schema_skips_wire_sibling(dataset, planes):
    """String columns cannot ride the wire: the raw entry covers the serve."""
    with MaterializeController(dataset.url, str(planes / 'plane'), **NO_RAM) as c:
        summary = c.run()
    assert summary['done'] == PIECES and summary['wire_published'] == 0
    assert c.metrics.counter('materialize_wire_skipped').value == PIECES


def test_row_drop_partitions_publish_jax_s_entries(dataset, planes):
    """A row-drop job decodes and publishes once per partition, under JAX's
    digests; a row-drop consumer over the warm plane decodes nothing."""
    kwargs = {'shuffle_row_drop_partitions': 2}
    ours, ref, port_dir, jax_dir = _warm_both(dataset.url, planes, reader_kwargs=kwargs)
    assert ours['done'] == PIECES
    assert _summary_sans_time(ours) == _summary_sans_time(ref)
    port_entries, jax_entries = _entries(port_dir), _entries(jax_dir)
    assert sorted(port_entries) == sorted(jax_entries) and len(port_entries) == 2 * PIECES
    for name in port_entries:
        _assert_values_equal(port_entries[name], jax_entries[name])
    served, diag = _read_columns(dataset.url, plane_dir=port_dir, **kwargs)
    assert diag.get('cache_misses') == 0 and diag.get('cache_hits') == 2 * PIECES, diag
    assert sorted(served) == list(range(ROWS))


# -- the layout rewrite and the writer -------------------------------------------

def test_rewrite_layout_drives_waste_down_and_preserves_rows(dataset, planes):
    columns = ('id', 'matrix')
    assert layout_stats(dataset.url, columns=list(columns)) == \
        jax_rewrite.layout_stats(dataset.url, columns=list(columns))
    assert layout_stats(dataset.url) == jax_rewrite.layout_stats(dataset.url)
    out_url = 'file://' + str(planes / 'resharded')
    # JAX's rewrite decodes and encodes again through its reader: with one
    # decode thread its rows come in the store's order, as the port's copy
    # does, and the lossless codecs here encode to the same bytes
    summary = rewrite_layout(dataset.url, out_url, rows_per_rowgroup=8, columns=columns)
    ref = jax_rewrite.rewrite_layout(dataset.url, 'file://' + str(planes / 'jax_resharded'),
                                     rows_per_rowgroup=8, columns=columns,
                                     reader_kwargs={'reader_pool_type': 'dummy'})
    assert summary['rows'] == ROWS and summary['before'] == ref['before']
    assert summary['after'] == ref['after'] and summary['columns'] == ref['columns']
    assert summary['before']['waste_bytes'] > 0
    assert summary['after']['waste_bytes'] < summary['before']['waste_bytes']
    assert summary['waste_bytes_saved'] == ref['waste_bytes_saved'] > 0
    assert summary['after']['rows_per_row_group']['max'] <= 8
    assert layout_stats(out_url, columns=list(columns)) == summary['after'] == \
        jax_rewrite.layout_stats(out_url, columns=list(columns))
    # the layout changed, the data did not; JAX reads the port's rewrite
    for reader in (make_reader, jax_make_reader):
        with reader(out_url, num_epochs=1, shuffle_row_groups=False) as r:
            got = {int(row.id): np.asarray(row.matrix) for row in r}
        assert sorted(got) == list(range(ROWS))
        for row in dataset.data:
            np.testing.assert_array_equal(got[int(row['id'])], row['matrix'])
    with pytest.raises(ValueError, match='overwrite'):
        rewrite_layout(dataset.url, out_url, rows_per_rowgroup=8, columns=columns)
    assert rewrite_layout(dataset.url, out_url, rows_per_rowgroup=6, columns=columns,
                          overwrite=True)['after']['row_groups'] == ROWS // 6
    with pytest.raises(ValueError, match='runs no reader'):
        rewrite_layout(dataset.url, out_url, 8, overwrite=True,
                       reader_kwargs={'workers_count': 2})


def test_rewrite_layout_with_a_predicate_keeps_jax_s_rows(dataset, planes):
    from petastorm_tpu.predicates import in_lambda as jax_in_lambda

    from petastorm_tpu_torch.predicates import in_lambda
    out = {}

    def even(v):
        return v['id2'] % 2 == 0
    for label, fn, pred in (('port', rewrite_layout, in_lambda(['id2'], even)),
                            ('jax', jax_rewrite.rewrite_layout, jax_in_lambda(['id2'], even))):
        kw = {} if label == 'port' else {'reader_kwargs': {'reader_pool_type': 'dummy'}}
        url = 'file://' + str(planes / label)
        out[label] = fn(dataset.url, url, rows_per_rowgroup=5, predicate=pred, **kw)
        with jax_make_reader(url, num_epochs=1, shuffle_row_groups=False,
                             reader_pool_type='dummy') as r:
            out[label]['ids'] = [int(row.id) for row in r]
    assert out['port']['ids'] == out['jax']['ids'] == \
        [r['id'] for r in dataset.data if r['id2'] % 2 == 0]
    assert out['port']['after'] == out['jax']['after']


def test_rewrite_layout_keeps_jpeg_cells(tmp_path):
    """A JPEG store rewritten: the port copies the stored cells, so every
    image decodes to the same pixels; the JAX package's rewrite encodes the
    decoded image again, and JPEG's loss changes pixels."""
    import pickle

    from petastorm_tpu.codecs import CompressedImageCodec
    from petastorm_tpu.etl.dataset_metadata import DatasetWriter as JaxDatasetWriter
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('Jpeg', [UnischemaField('id', np.int64, (), None, False),
                                UnischemaField('image', np.uint8, (None, None, 3),
                                               CompressedImageCodec('jpeg'), False)])
    rng = np.random.default_rng(9)
    src = 'file://' + str(tmp_path / 'src')
    with JaxDatasetWriter(src, schema, rows_per_rowgroup=3) as w:
        for i in range(12):
            w.write({'id': np.int64(i),
                     'image': rng.integers(0, 256, (24 + i, 20, 3), dtype=np.uint8)})

    def images(url):
        with make_reader(url, num_epochs=1, shuffle_row_groups=False,
                         reader_pool_type='dummy') as r:
            return {int(row.id): np.asarray(row.image) for row in r}
    original = images(src)
    summary = rewrite_layout(src, 'file://' + str(tmp_path / 'port'), rows_per_rowgroup=6)
    assert summary['rows'] == 12 and summary['after']['row_groups'] == 2
    got = images('file://' + str(tmp_path / 'port'))
    assert sorted(got) == list(range(12))
    assert all(np.array_equal(got[i], original[i]) for i in original)
    jax_rewrite.rewrite_layout(src, 'file://' + str(tmp_path / 'jax'), rows_per_rowgroup=6,
                               reader_kwargs={'reader_pool_type': 'dummy'})
    theirs = images('file://' + str(tmp_path / 'jax'))
    assert not all(np.array_equal(theirs[i], original[i]) for i in original)
    assert pickle.dumps(sorted(theirs)) == pickle.dumps(sorted(got))


def _geometry(path):
    """``[(file name, [rows per row group])]`` and every file's column
    compression, of a written store."""
    out = []
    for name in sorted(os.listdir(path)):
        if name.endswith('.parquet'):
            md = pq.ParquetFile(os.path.join(path, name)).metadata
            out.append((name, [md.row_group(i).num_rows for i in range(md.num_row_groups)],
                        sorted({(md.row_group(0).column(c).path_in_schema,
                                 md.row_group(0).column(c).compression)
                                for c in range(md.num_columns)})))
    return out


@pytest.mark.parametrize('geometry', [dict(rows_per_rowgroup=5, rows_per_file=10),
                                      dict(rowgroup_size_mb=0.002),
                                      dict(rows_per_rowgroup=7, compression='gzip')])
def test_write_rows_gives_jax_s_row_groups(tmp_path, geometry):
    import pickle

    from petastorm_tpu_torch.etl.dataset_metadata import _loads_schema, get_schema
    from petastorm_tpu_torch.fs_utils import LocalFilesystem
    from petastorm_tpu_torch.materialize import write_rows
    rows = make_test_rows(23, seed=4)
    port_schema = _loads_schema(pickle.dumps(TestSchema))
    assert write_rows('file://' + str(tmp_path / 'port'), port_schema, iter(rows),
                      **geometry) == 23
    assert jax_rewrite.write_rows('file://' + str(tmp_path / 'jax'), TestSchema, iter(rows),
                                  **geometry) == 23
    ours, ref = _geometry(str(tmp_path / 'port')), _geometry(str(tmp_path / 'jax'))
    assert ours == ref and sum(sum(g) for _, g, _ in ours) == 23
    assert list(get_schema(LocalFilesystem(), str(tmp_path / 'port')).fields) == \
        list(TestSchema.fields)
    with jax_make_reader('file://' + str(tmp_path / 'port'), num_epochs=1,
                         shuffle_row_groups=False, reader_pool_type='dummy') as r:
        assert [int(row.id) for row in r] == list(range(23))
    with pytest.raises(ValueError, match='storage bullet'):
        write_rows('file://' + str(tmp_path / 'x'), port_schema, iter(rows),
                   storage_options={'anon': True})


# -- warming candidates ------------------------------------------------------------

def test_derive_candidates_ranks_cold_roots():
    class _Journal(object):
        def __init__(self, records):
            self._records = records

        def records(self):
            return self._records

    def record(root, cache, tenant=None, row_groups=(0,)):
        return {'cache': cache, 'tenant': tenant,
                'pieces': [{'path': root + '/part0.parquet', 'row_group': rg}
                           for rg in row_groups]}

    journals = [_Journal([record('/data/hot', 'decode', tenant='t1', row_groups=(0, 1)),
                          record('/data/hot', 'degraded', tenant='t2'),
                          record('/data/mild', 'decode'), record('/data/mild', 'plane'),
                          record('/data/cached', 'plane')]),
                _Journal([record('/data/hot', 'decode', tenant='t1')])]
    candidates = controller.derive_candidates(journals=journals)
    assert candidates == jax_controller.derive_candidates(journals=journals)
    assert [c['root'] for c in candidates] == ['/data/hot', '/data/mild']
    hot = candidates[0]
    assert hot['cold'] == 3 and hot['records'] == 3 and hot['pieces'] == 2
    assert hot['tenants'] == {'t1': 2, 't2': 1}

    class _Broken(object):
        def records(self):
            raise RuntimeError('torn journal')

    assert controller.derive_candidates(journals=[_Broken()]) == []
    assert controller.derive_candidates(journals=journals, top_k=1) == [hot]


def test_derive_candidates_over_a_loaders_journal(dataset, planes):
    """A port loader's own provenance journal of a cold epoch over an empty
    plane (each record's cache outcome a decode) names the store's root."""
    from petastorm_tpu_torch.gpu import DataLoader
    with make_reader(dataset.url, schema_fields=['id', 'matrix'], columnar_decode=True,
                     workers_count=2, shuffle_row_groups=False, cache_type='plane',
                     cache_location=str(planes / 'empty'),
                     cache_extra_settings={'ram_bytes': 0}) as reader:
        loader = DataLoader(reader, 8, device='cpu')
        with loader:
            list(loader)
    (candidate,) = controller.derive_candidates(journals=[loader.provenance])
    assert candidate['root'] == dataset.path and candidate['pieces'] == PIECES
    assert candidate['cold'] == candidate['records'] >= 1
    assert candidate == jax_controller.derive_candidates(journals=[loader.provenance])[0]


# -- the dispatcher's hand-off of scale-in victims ---------------------------------

def test_dispatcher_defers_drain_until_warming_pass_done(dataset, planes):
    config = ServiceConfig(dataset.url, num_consumers=1, rowgroups_per_split=2,
                           lease_ttl_s=2.0)
    dispatcher = Dispatcher(config, num_pieces=2)   # no serve thread needed
    w0 = dispatcher._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    assert Dispatcher.DRAIN_WARM_DEADLINE_S == JaxDispatcher.DRAIN_WARM_DEADLINE_S
    with MaterializeController(dataset.url, str(planes / 'plane'), **NO_RAM) as c:
        dispatcher.attach_materializer(c)
        assert c.offer_drain_candidate(w0, deadline_s=Dispatcher.DRAIN_WARM_DEADLINE_S)
        dispatcher._deferred_drains[w0] = time.monotonic() + Dispatcher.DRAIN_WARM_DEADLINE_S
        dispatcher.materialize_handoffs += 1
        if not c.drain_ready(w0):
            # while the pass runs the drain is deferred, not done
            dispatcher._tick_deferred_drains(time.monotonic())
            assert not dispatcher._workers[w0].get('draining')
        deadline = time.monotonic() + 30.0
        while not c.drain_ready(w0):
            assert time.monotonic() < deadline, 'the warming pass never finished'
            time.sleep(0.05)
        dispatcher._tick_deferred_drains(time.monotonic())
        assert w0 not in dispatcher._deferred_drains
        assert dispatcher._workers[w0]['draining']
        # the offered capacity warmed the pieces before the drain
        assert c.summary()['done'] == c.summary()['total_pieces']
        assert c.metrics.counter('materialize_drain_passes').value == 1
        assert c.offer_drain_candidate(w0) is False   # nothing pending
    assert dispatcher._fleet_snapshot()['counters']['materialize_handoffs'] == 1


def test_the_autoscale_tick_hands_a_victim_over(dataset, planes):
    """A scale-in decision of the autoscaler goes to the attached controller
    first, and the drain follows its pass."""
    config = ServiceConfig(dataset.url, num_consumers=1, rowgroups_per_split=2,
                           lease_ttl_s=2.0)
    dispatcher = Dispatcher(config, num_pieces=2)
    w0 = dispatcher._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']

    class _Scaler(object):
        enabled = True

        def maybe_tick(self, observation, now=None):
            return ('scale_in', w0)

    dispatcher.autoscaler = _Scaler()
    with MaterializeController(dataset.url, str(planes / 'plane'), **NO_RAM) as c:
        dispatcher.attach_materializer(c)
        dispatcher._autoscale_tick()
        assert dispatcher.materialize_handoffs == 1 and w0 in dispatcher._deferred_drains
        deadline = time.monotonic() + 30.0
        while not c.drain_ready(w0):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        dispatcher.autoscaler = type('Idle', (), {'enabled': True,
                                                  'maybe_tick': lambda *a, **k: None})()
        dispatcher._autoscale_tick()
        assert dispatcher._workers[w0]['draining'] and not dispatcher._deferred_drains


def test_deferred_drain_deadline_wins_over_a_stuck_pass(dataset):
    """Warming can delay a drain, never veto it."""
    class _StuckMaterializer(object):
        def drain_ready(self, worker_id):
            return False

    config = ServiceConfig(dataset.url, num_consumers=1, rowgroups_per_split=2,
                           lease_ttl_s=2.0)
    dispatcher = Dispatcher(config, num_pieces=2)
    w0 = dispatcher._op_register_worker({'data_addr': 'tcp://x:1'})['worker_id']
    dispatcher.attach_materializer(_StuckMaterializer())
    dispatcher._deferred_drains[w0] = time.monotonic() + 60.0
    dispatcher._tick_deferred_drains(time.monotonic())
    assert not dispatcher._workers[w0].get('draining')
    dispatcher._deferred_drains[w0] = time.monotonic() - 1.0   # the deadline passed
    dispatcher._tick_deferred_drains(time.monotonic())
    assert dispatcher._workers[w0]['draining'] and w0 not in dispatcher._deferred_drains


# -- chaos: SIGKILL mid-publish ----------------------------------------------------

def test_materialize_kill_scenario_end_to_end(tmp_path):
    """The controller SIGKILLed mid-publish: no torn entry, the ledger
    resumes attempt-intact, and the consumer's digest through the half, then
    fully, warmed plane is the ground truth's (and JAX's runner's)."""
    from petastorm_tpu.test_util import chaos as jax_chaos

    from petastorm_tpu_torch.test_util import chaos
    scenario = chaos.SCENARIOS['materialize_kill']
    assert scenario['runner'] == 'materialize' and scenario['throttle_s'] > 0
    assert 'materialize_kill' not in chaos.SMOKE_SCENARIOS
    url, rows = chaos.make_chaos_dataset(str(tmp_path / 'ds'), seed=13)
    report = chaos.run_scenario('materialize_kill', url, rows, str(tmp_path), seed=13)
    assert report['ok'], chaos.render_report([report])
    for name in ('zero_torn_entries', 'ledger_progress', 'resume', 'digest',
                 'served_from_plane', 'zero_residue'):
        assert report['checks'][name].startswith('ok'), (name, report['checks'])
    assert report['digest'] == jax_chaos.direct_read_digest(url)
    # the port's warm entries are JAX's: JAX's consumer reads them all as hits
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    with jax_make_batch_reader(url, num_epochs=1, shuffle_row_groups=False, workers_count=1,
                               cache_type='plane',
                               cache_location=str(tmp_path / 'mat_plane_materialize_kill'),
                               cache_extra_settings={'ram_bytes': 0}) as reader:
        assert sum(len(b.id) for b in reader) == rows
        assert reader.diagnostics['cache_misses'] == 0


def test_rewrite_layout_writes_hive_partition_values_as_cells(tmp_path):
    """A store whose schema holds a hive partition key its files lack
    (``part=3/``, ``part=7/``): the rewrite stores the directory's value as
    a cell of the field's dtype, and a predicate on it selects rows (the
    JAX package's reader raises on such a store: ROADMAP.md, Queue C)."""
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter, _write_common_metadata
    from petastorm_tpu_torch.fs_utils import LocalFilesystem
    from petastorm_tpu_torch.predicates import in_set
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    stored = Unischema('S', [UnischemaField('id', np.int64, (), None, False)])
    full = Unischema('S', [UnischemaField('id', np.int64, (), None, False),
                           UnischemaField('part', np.int32, (), None, False)])
    src = tmp_path / 'src'
    for part in (3, 7):
        with DatasetWriter('file://%s/part=%d' % (src, part), stored,
                           rows_per_rowgroup=4) as writer:
            writer.write_many({'id': np.int64(part * 100 + i)} for i in range(8))
        os.remove(str(src / ('part=%d' % part) / '_common_metadata'))
    _write_common_metadata(LocalFilesystem(), str(src), full)
    out = 'file://' + str(tmp_path / 'out')
    summary = rewrite_layout('file://' + str(src), out, rows_per_rowgroup=16,
                             predicate=in_set([7], 'part'))
    assert summary['rows'] == 8 and summary['after']['row_groups'] == 1
    with make_reader(out, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        rows = [(int(row.id), row.part) for row in r]
    assert rows == [(700 + i, 7) for i in range(8)]
    assert pq.ParquetFile(str(tmp_path / 'out' / 'part_00000.parquet')).schema_arrow \
        .field('part').type == 'int32'

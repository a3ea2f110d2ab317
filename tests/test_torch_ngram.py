"""NGram windows of the port against the JAX package's, on the CPU.

Every golden of ``tests/test_ngram.py`` runs on both packages' ``NGram``
(sliding windows, ``delta_threshold``, both ``timestamp_overlap`` modes with
irregular and duplicate timestamps, sparse and negative offsets, regex
errors, windows that never span row groups).  Then the example's path
(``examples/ngram_sensor/jax_example.py``) on a small store of its own
generator: the port's reader gives the JAX reader's windows on the dummy,
thread and process pools; the port's loader gives the JAX loader's nested
batches, and after ``collate`` its batches, bit for bit, shuffled or not,
pumped or inline; ``predict_speed`` agrees; a token of either package
resumes the port's loader bit for bit; ``echo`` repeats as the JAX loader
does; the epoch-cache loaders refuse an NGram reader; and the command line
prints the example's lines.
"""

import hashlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import ngram as jax_ngram
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.etl.dataset_metadata import DatasetWriter as JaxDatasetWriter
from petastorm_tpu.jax import DataLoader as JaxDataLoader

from petastorm_tpu_torch import ngram as port_ngram
from petastorm_tpu_torch import ngram_sensor
from petastorm_tpu_torch import unischema as port_unischema
from petastorm_tpu_torch.codecs import NdarrayCodec as PortNdarrayCodec
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter as PortDatasetWriter
from petastorm_tpu_torch.gpu import (DataLoader, DeviceInMemDataLoader, DiskCachedDataLoader,
                                     InMemDataLoader)
from petastorm_tpu_torch.gpu.transfer import TransferPlane
from petastorm_tpu_torch.reader import make_reader

from torch_plane_common import assert_batches_equal, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Each package's NGram, Unischema, UnischemaField, NdarrayCodec, writer and
#: make_reader.
IMPLS = {
    'jax': (jax_ngram.NGram, jax_unischema, JaxNdarrayCodec, JaxDatasetWriter,
            lambda url, **kw: jax_make_reader(url, scheduling='fifo', ingest='off', **kw)),
    'torch': (port_ngram.NGram, port_unischema, PortNdarrayCodec, PortDatasetWriter,
              make_reader),
}


def _impl(name):
    NGram, u, codec, writer, reader = IMPLS[name]
    schema = u.Unischema('SensorSchema', [
        u.UnischemaField('ts', np.int64, (), None, False),
        u.UnischemaField('lidar', np.float32, (4,), codec(), False),
        u.UnischemaField('speed', np.float64, (), None, False),
    ])
    return NGram, schema, writer, reader


def _rows(timestamps):
    return [{'ts': np.int64(t), 'lidar': np.full(4, t, np.float32), 'speed': float(t) * 0.1}
            for t in timestamps]


def _ngram(impl, fields=None, delta=1, overlap=True):
    NGram, schema, _, _ = _impl(impl)
    fields = fields or {0: ['ts', 'lidar'], 1: ['ts', 'speed']}
    ng = NGram(fields=fields, delta_threshold=delta, timestamp_field='ts',
               timestamp_overlap=overlap)
    ng.resolve_regex_field_names(schema)
    return ng, schema


IMPL = pytest.mark.parametrize('impl', ['jax', 'torch'])


# -- the goldens of tests/test_ngram.py, on both packages -------------------

@IMPL
def test_sliding_windows_and_projection(impl):
    ng, schema = _ngram(impl)
    windows = ng.form_sequences(_rows([3, 1, 2, 4]), schema)  # unsorted input
    assert len(windows) == 3
    first = windows[0]
    assert set(first) == {0, 1}
    assert set(first[0]) == {'ts', 'lidar'}
    assert set(first[1]) == {'ts', 'speed'}
    assert [w[0]['ts'] for w in windows] == [1, 2, 3]
    assert [w[1]['ts'] for w in windows] == [2, 3, 4]
    assert ng.length == 2


@IMPL
def test_delta_threshold_rejects_gappy_windows(impl):
    ng, schema = _ngram(impl, delta=1)
    windows = ng.form_sequences(_rows([1, 2, 10, 11]), schema)
    assert [(w[0]['ts'], w[1]['ts']) for w in windows] == [(1, 2), (10, 11)]
    ng, schema = _ngram(impl, delta=None)
    assert len(ng.form_sequences(_rows([1, 2, 10, 11]), schema)) == 3


# (timestamps, fields, delta, overlap, expected (first offset ts, last offset ts))
GOLDENS = {
    'overlap_false_is_disjoint': ([1, 2, 3, 4, 5], None, 1, False, [(1, 2), (3, 4)]),
    # stable pairs (10,11) (11,12) (12,13); (11,12) starts at 11 <= 11
    'overlap_false_irregular': ([0, 10, 11, 12, 13, 30], None, 5, False, [(10, 11), (12, 13)]),
    # (1,1) and (1,2) start at 1 <= 1: a time-range overlap
    'overlap_false_duplicates': ([0, 1, 1, 2, 3], None, None, False, [(0, 1), (2, 3)]),
    'overlap_false_gap': ([1, 2, 3, 20, 21, 22], {0: ['ts', 'lidar'], 1: ['ts'],
                                                  2: ['ts', 'speed']}, 1, False,
                          [(1, 3), (20, 22)]),
    'overlap_true_every_stable_window': ([0, 1, 1, 2, 3], None, None, True,
                                         [(0, 1), (1, 1), (1, 2), (2, 3)]),
}


@IMPL
@pytest.mark.parametrize('case', sorted(GOLDENS))
def test_timestamp_overlap_goldens(impl, case):
    timestamps, fields, delta, overlap, expected = GOLDENS[case]
    ng, schema = _ngram(impl, fields=fields, delta=delta, overlap=overlap)
    last = max(ng.fields)
    windows = ng.form_sequences(_rows(timestamps), schema)
    assert [(w[0]['ts'], w[last]['ts']) for w in windows] == expected


@pytest.mark.parametrize('case', sorted(GOLDENS))
def test_goldens_agree_window_for_window(case):
    """Beyond the timestamps: both packages emit the same windows, cells
    included."""
    timestamps, fields, delta, overlap, _ = GOLDENS[case]
    got = [_ngram(impl, fields=fields, delta=delta, overlap=overlap) for impl in IMPLS]
    (jax_ng, jax_schema), (port_ng, port_schema) = got
    want = jax_ng.form_sequences(_rows(timestamps), jax_schema)
    have = port_ng.form_sequences(_rows(timestamps), port_schema)
    assert len(have) == len(want)
    for h, w in zip(have, want):
        assert sorted(h) == sorted(w)
        for offset in w:
            assert sorted(h[offset]) == sorted(w[offset])
            for name in w[offset]:
                np.testing.assert_array_equal(h[offset][name], w[offset][name])


@IMPL
def test_sparse_and_negative_offsets(impl):
    ng, schema = _ngram(impl, fields={-1: ['lidar'], 1: ['speed']}, delta=2)
    windows = ng.form_sequences(_rows([1, 2, 3]), schema)
    assert len(windows) == 1
    assert set(windows[0]) == {-1, 1}
    np.testing.assert_array_equal(windows[0][-1]['lidar'], np.full(4, 1, np.float32))
    assert windows[0][1]['speed'] == pytest.approx(0.3)
    assert ng.length == 3


@IMPL
def test_regex_field_resolution_and_errors(impl):
    NGram, schema, _, _ = _impl(impl)
    ng = NGram(fields={0: ['li.*'], 1: ['speed']}, delta_threshold=1, timestamp_field='ts')
    ng.resolve_regex_field_names(schema)
    assert ng.get_field_names_at_timestep(0) == ['lidar']
    assert ng.timestamp_field_name == 'ts'
    bad = NGram(fields={0: ['nomatch.*']}, delta_threshold=1, timestamp_field='ts')
    with pytest.raises(ValueError, match='matches nothing'):
        bad.resolve_regex_field_names(schema)
    with pytest.raises(ValueError, match='integers'):
        NGram(fields={'a': ['x']}, delta_threshold=1, timestamp_field='ts')
    two = NGram(fields={0: ['lidar']}, delta_threshold=1, timestamp_field='.*')
    with pytest.raises(ValueError, match='exactly one'):
        two.resolve_regex_field_names(schema)


@IMPL
def test_end_to_end_reader_windows_stay_within_row_groups(impl, tmp_path):
    NGram, schema, writer, reader_fn = _impl(impl)
    url = 'file://' + str(tmp_path / 'sensor')
    with writer(url, schema, rows_per_rowgroup=5) as w:
        w.write_many(_rows(range(10)))  # row groups: ts 0-4 and 5-9
    ng = NGram(fields={0: ['ts', 'lidar'], 1: ['ts', 'speed']}, delta_threshold=1,
               timestamp_field='ts')
    with reader_fn(url, schema_fields=ng, reader_pool_type='dummy',
                   shuffle_row_groups=False) as reader:
        assert reader.ngram is ng
        windows = list(reader)
    starts = sorted(int(w[0].ts) for w in windows)
    assert starts == [0, 1, 2, 3, 5, 6, 7, 8]   # no (4, 5) window
    one = next(w for w in windows if int(w[0].ts) == 2)
    np.testing.assert_array_equal(np.asarray(one[0].lidar), np.full(4, 2, np.float32))
    assert float(one[1].speed) == pytest.approx(0.3)
    assert type(one[0]).__name__ != type(one[1]).__name__ or one[0]._fields != one[1]._fields


def test_ngram_pickles_for_process_workers():
    ng, schema = _ngram('torch', fields={-2: ['lidar'], 0: ['ts', 'speed']}, delta=3)
    back = pickle.loads(pickle.dumps(ng))
    rows = _rows([5, 6, 7, 9, 20])
    assert [sorted(w) for w in back.form_sequences(rows, schema)] == \
        [sorted(w) for w in ng.form_sequences(rows, schema)]
    assert back.get_field_names_at_all_timesteps() == ['lidar', 'speed', 'ts']


# -- the example's path ------------------------------------------------------

ROWS = 400   # 4 row groups of 100, a dropout every 50 rows


def _jax_example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'ngram_sensor_jax_example', os.path.join(REPO, 'examples', 'ngram_sensor',
                                                 'jax_example.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def sensor_url(tmp_path_factory):
    """The store as the JAX example writes it (the JAX package's classes in
    its footer, which both readers resolve)."""
    url = 'file://%s' % tmp_path_factory.mktemp('ngram_sensor_jax')
    _jax_example().generate(url, rows=ROWS)
    return url


def test_the_ports_generator_writes_the_examples_store(sensor_url, tmp_path):
    port_url = ngram_sensor.generate('file://%s' % (tmp_path / 'port'), rows=ROWS)
    assert _port_windows(port_url, 'dummy') == _port_windows(sensor_url, 'dummy')


def _example_ngram(package, timestamp=False):
    NGram = jax_ngram.NGram if package == 'jax' else port_ngram.NGram
    fields = {-2: ['lidar'], -1: ['lidar'], 0: ['lidar', 'velocity']}
    if timestamp:
        fields[0] = fields[0] + ['timestamp']
    return NGram(fields=fields, delta_threshold=10, timestamp_field='timestamp')


def _window_key(window):
    """A window as a hashable value: each offset's cells, by name."""
    h = hashlib.blake2b(digest_size=16)
    for offset in sorted(window):
        cells = window[offset]._asdict() if hasattr(window[offset], '_asdict') \
            else window[offset]
        for name in sorted(cells):
            h.update(repr((offset, name)).encode())
            h.update(np.ascontiguousarray(cells[name]).tobytes())
    return h.digest()


def _jax_windows(url, pool, **kwargs):
    with jax_make_reader(url, schema_fields=_example_ngram('jax'), reader_pool_type=pool,
                         workers_count=2, shuffle_row_groups=False, scheduling='fifo',
                         ingest='off', **kwargs) as reader:
        return [_window_key(w) for w in reader]


def _port_windows(url, pool, **kwargs):
    with make_reader(url, schema_fields=_example_ngram('torch'), reader_pool_type=pool,
                     workers_count=2, shuffle_row_groups=False, **kwargs) as reader:
        windows = list(reader)
        assert reader.ngram is not None
    for w in windows:
        assert sorted(w) == [-2, -1, 0]
        assert w[-2]._fields == ('lidar',) and w[0]._fields == ('lidar', 'velocity')
    return [_window_key(w) for w in windows]


def test_reader_windows_equal_the_jax_readers_on_the_dummy_pool(sensor_url):
    want = _jax_windows(sensor_url, 'dummy')
    # 98 windows a row group, less those across the dropout at row 50
    assert len(want) == 4 * 96
    assert _port_windows(sensor_url, 'dummy') == want


@pytest.mark.parametrize('pool', ['thread', 'process'])
def test_reader_windows_equal_the_jax_readers_on_the_pools(sensor_url, pool):
    want = _jax_windows(sensor_url, pool)
    got = _port_windows(sensor_url, pool)
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(_jax_windows(sensor_url, 'dummy'))


def test_reader_resets_and_counts_rows(sensor_url):
    with make_reader(sensor_url, schema_fields=_example_ngram('torch'), reader_pool_type='dummy',
                     shuffle_row_groups=False) as reader:
        first = [_window_key(w) for w in reader]
        reader.reset()
        assert [_window_key(w) for w in reader] == first
        assert reader.num_local_rows() == ROWS   # an upper bound of the windows


def test_columnar_decode_refuses_ngram(sensor_url):
    with pytest.raises(ValueError, match='columnar_decode is incompatible with NGram'):
        make_reader(sensor_url, schema_fields=_example_ngram('torch'), columnar_decode=True)


def _jax_batches(url, collate=True, timestamp=False, **loader_kwargs):
    with jax_make_reader(url, schema_fields=_example_ngram('jax', timestamp),
                         reader_pool_type='dummy', shuffle_row_groups=False,
                         scheduling='fifo', ingest='off') as reader:
        loader_kwargs.setdefault('transform_fn', ngram_sensor.collate if collate else None)
        with JaxDataLoader(reader, 32, transfer=False, **loader_kwargs) as loader:
            return [to_numpy(b) for b in loader]


def _port_batches(url, collate=True, timestamp=False, **loader_kwargs):
    with make_reader(url, schema_fields=_example_ngram('torch', timestamp),
                     reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        loader_kwargs.setdefault('transform_fn', ngram_sensor.collate if collate else None)
        with DataLoader(reader, 32, device='cpu', **loader_kwargs) as loader:
            return [to_numpy(b) for b in loader]


LOADER_CASES = {
    'ordered': dict(),
    'shuffled': dict(shuffling_queue_capacity=64, seed=3),
    'shuffled_min_after_retrieve': dict(shuffling_queue_capacity=64, min_after_retrieve=10,
                                        seed=4),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
@pytest.mark.parametrize('transfer', [False, True])
def test_nested_batches_equal_the_jax_loaders(sensor_url, case, transfer):
    """Before ``collate``: ``{offset: {field: (32, ...)}}``, dtypes included
    (the int64 timestamp arrives as int32, as JAX canonicalizes it)."""
    kwargs = LOADER_CASES[case]
    want = _jax_batches(sensor_url, collate=False, timestamp=True, **kwargs)
    got = _port_batches(sensor_url, collate=False, timestamp=True, transfer=transfer, **kwargs)
    assert len(want) == 4 * 96 // 32
    assert sorted(got[0]) == [-2, -1, 0] and sorted(got[0][0]) == ['lidar', 'timestamp', 'velocity']
    assert got[0][0]['timestamp'].dtype == np.int32 and got[0][-1]['lidar'].shape == (32, 32)
    assert_batches_equal(got, want)


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
@pytest.mark.parametrize('transfer', [False, True])
def test_collated_batches_equal_the_jax_loaders(sensor_url, case, transfer):
    kwargs = LOADER_CASES[case]
    want = _jax_batches(sensor_url, **kwargs)
    got = _port_batches(sensor_url, transfer=transfer, **kwargs)
    assert got[0]['history'].shape == (32, 2, 32) and got[0]['velocity'].shape == (32, 3)
    assert_batches_equal(got, want)


def test_predict_speed_agrees_with_jax(sensor_url):
    import jax.numpy as jnp
    for batch in _port_batches(sensor_url)[:4]:
        got = ngram_sensor.predict_speed(torch.from_numpy(batch['history']),
                                         torch.from_numpy(batch['velocity']))
        want = jnp.mean(batch['history'], axis=(1, 2)) + \
            jnp.linalg.norm(batch['velocity'], axis=1)
        assert got.dtype == torch.float32 and tuple(got.shape) == (32,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_the_example_runs_on_the_cpu(sensor_url, capsys):
    result = ngram_sensor.run(sensor_url, device='cpu',
                              reader_kwargs=dict(reader_pool_type='dummy'))
    out = capsys.readouterr().out.splitlines()
    assert out == ['window batch: history (32, 2, 32) velocity (32, 3) -> (32,)', 'done']
    assert (result['batches'], result['windows'], result['cuda_graph']) == (12, 384, False)
    assert result['windows_per_s'] > 0 and 0 <= result['stall_pct'] <= 100
    want = _port_batches(sensor_url)
    for out, batch in zip(result['outputs'], want):
        expected = ngram_sensor.predict_speed(torch.from_numpy(batch['history']),
                                              torch.from_numpy(batch['velocity']))
        assert torch.equal(out, expected)


def _resume_run(url, k, token_from, transfer, **loader_kwargs):
    """The port's batches after a token taken at batch ``k`` by the port's
    loader or the JAX loader, and the uninterrupted run's."""
    reader_kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=2,
                         num_epochs=2)
    if token_from == 'jax':
        make_jax = lambda: jax_make_reader(url, schema_fields=_example_ngram('jax'),  # noqa
                                           scheduling='fifo', ingest='off', **reader_kwargs)
        with JaxDataLoader(make_jax(), 32, transfer=False, **loader_kwargs) as loader:
            full = [to_numpy(b) for b in loader]
        reader = make_jax()
        loader = JaxDataLoader(reader, 32, transfer=False, **loader_kwargs)
    else:
        make_port = lambda: make_reader(url, schema_fields=_example_ngram('torch'),  # noqa
                                        **reader_kwargs)
        with DataLoader(make_port(), 32, device='cpu', transfer=transfer,
                        **loader_kwargs) as loader:
            full = [to_numpy(b) for b in loader]
        reader = make_port()
        loader = DataLoader(reader, 32, device='cpu', transfer=transfer, **loader_kwargs)
    it = iter(loader)
    consumed = [to_numpy(next(it)) for _ in range(k)]
    token = pickle.loads(pickle.dumps(loader.state_dict()))
    it.close()
    reader.stop()
    reader.join()
    assert_batches_equal(consumed, full[:k])
    resumed = make_reader(url, schema_fields=_example_ngram('torch'),
                          resume_state=token['reader'], **reader_kwargs)
    with DataLoader(resumed, 32, device='cpu', transfer=transfer, resume_state=token,
                    **loader_kwargs) as loader:
        rest = [to_numpy(b) for b in loader]
    return rest, full[k:]


@pytest.mark.parametrize('token_from', ['torch', 'jax'])
@pytest.mark.parametrize('collate', [False, True])
def test_a_token_of_either_package_resumes_bit_for_bit(sensor_url, token_from, collate):
    kwargs = dict(shuffling_queue_capacity=128, seed=9)
    if collate:
        kwargs['transform_fn'] = ngram_sensor.collate
    rest, want = _resume_run(sensor_url, 5, token_from, transfer=token_from == 'torch',
                             **kwargs)
    assert len(want) == 2 * 4 * 96 // 32 - 5
    assert_batches_equal(rest, want)


def _echo_stream(package, url, **loader_kwargs):
    if package == 'jax':
        return _jax_batches(url, **loader_kwargs)
    return _port_batches(url, **loader_kwargs)


@pytest.mark.parametrize('transfer', [False, True])
def test_echo_repeats_as_the_jax_loader_does(sensor_url, transfer):
    calls = []

    def collate(batch):
        calls.append(batch)
        return ngram_sensor.collate(batch)

    want = _echo_stream('jax', sensor_url, echo=2, shuffling_queue_capacity=64, seed=1)
    got = _port_batches(sensor_url, collate=False, echo=2, shuffling_queue_capacity=64, seed=1,
                        transfer=transfer, transform_fn=collate)
    assert len(got) == 2 * 12 and len(calls) == 2 * 12
    assert_batches_equal(got, want)
    for a, b in zip(got[::2], got[1::2]):
        assert_batches_equal([a], [b])
    # each repeat is a tree of its own (the transform ran on each), with
    # the same arrays
    assert calls[0] is not calls[1] and calls[0][-2] is not calls[1][-2]
    assert calls[0][-2]['lidar'] is calls[1][-2]['lidar']


def _jax_resumed(url, k, **loader_kwargs):
    """The JAX loader's own batches after its token at batch ``k``."""
    reader_kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=2,
                         num_epochs=2, scheduling='fifo', ingest='off')
    reader = jax_make_reader(url, schema_fields=_example_ngram('jax'), **reader_kwargs)
    loader = JaxDataLoader(reader, 32, transfer=False, **loader_kwargs)
    it = iter(loader)
    for _ in range(k):
        next(it)
    token = loader.state_dict()
    it.close()
    reader.stop()
    reader.join()
    resumed = jax_make_reader(url, schema_fields=_example_ngram('jax'),
                              resume_state=token['reader'], **reader_kwargs)
    with JaxDataLoader(resumed, 32, transfer=False, resume_state=token,
                       **loader_kwargs) as loader:
        return [to_numpy(b) for b in loader]


@pytest.mark.parametrize('token_from', ['torch', 'jax'])
def test_a_mid_echo_token_resumes_at_the_batch(sensor_url, token_from):
    """Taken between a batch's two repeats, a token resumes at the batches,
    not at the repeat: the repeat the loader had not made yet is not made
    (echo is a schedule over the data), exactly as the JAX loader resumes
    its own token."""
    kwargs = dict(echo=2, transform_fn=ngram_sensor.collate)
    rest, want_full = _resume_run(sensor_url, 3, token_from, transfer=False, **kwargs)
    jax_rest = _jax_resumed(sensor_url, 3, **kwargs)
    assert len(rest) == len(want_full) - 1
    assert_batches_equal(rest, jax_rest)
    # the stream after the token less one repeat: either copy of one pair
    keys = [b['velocity'].tobytes() for b in want_full]
    got = [b['velocity'].tobytes() for b in rest]
    missing = [i for i in range(len(keys)) if keys[:i] + keys[i + 1:] == got]
    assert len(missing) == 2 and keys[missing[0]] == keys[missing[1]]


def test_wire_dtypes_name_nested_leaves_by_their_last_key(sensor_url):
    """``wire_dtypes={'lidar': 'bfloat16'}`` narrows the ``lidar`` leaf of
    every offset of a window batch on the wire (cast back to float32 on the
    device), as the JAX plane does; ``velocity`` travels at full width."""
    import jax.numpy as jnp

    def as_f32(tree):
        return {k: as_f32(v) if isinstance(v, dict) else
                (v.float().numpy() if isinstance(v, torch.Tensor) else
                 np.asarray(jnp.asarray(v, jnp.float32))) for k, v in tree.items()}

    policy = {'lidar': 'bfloat16'}
    with jax_make_reader(sensor_url, schema_fields=_example_ngram('jax'),
                         reader_pool_type='dummy', shuffle_row_groups=False, scheduling='fifo',
                         ingest='off') as reader:
        with JaxDataLoader(reader, 32, transfer=True, wire_dtypes=policy) as loader:
            want = [as_f32(b) for b in loader]
    with make_reader(sensor_url, schema_fields=_example_ngram('torch'),
                     reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        with DataLoader(reader, 32, device='cpu', transfer=True, wire_dtypes=policy) as loader:
            got = list(loader)
    low_bits = [b[o]['lidar'].numpy().view(np.uint32) & 0xFFFF for b in got for o in (-2, -1, 0)]
    assert not any(bits.any() for bits in low_bits)   # bfloat16 values
    assert any((b[0]['velocity'].numpy().view(np.uint32) & 0xFFFF).any() for b in got)
    assert_batches_equal([as_f32(b) for b in got], want)


def test_the_inline_put_keeps_the_nesting():
    plane = TransferPlane('cpu')
    batch = {-1: {'a': np.arange(4, dtype=np.int64)}, 0: {'a': np.ones(4), 'b': np.zeros(2)},
             'flat': np.arange(3, dtype=np.uint8)}
    out, event = plane.put_inline(batch)
    assert event is None and sorted(out, key=str) == sorted(batch, key=str)
    assert out[-1]['a'].dtype == torch.int32 and out[0]['a'].dtype == torch.float32
    assert out['flat'].dtype == torch.uint8 and out[0]['b'].shape == (2,)


def test_echo_must_be_positive(sensor_url):
    with make_reader(sensor_url, reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError, match='echo must be >= 1'):
            DataLoader(reader, 32, device='cpu', echo=0)


def test_epoch_cache_loaders_refuse_ngram(sensor_url, tmp_path):
    with make_reader(sensor_url, schema_fields=_example_ngram('torch'),
                     reader_pool_type='dummy') as reader:
        for cls in (InMemDataLoader, DeviceInMemDataLoader):
            with pytest.raises(ValueError, match='InMemDataLoader does not support NGram'):
                cls(reader, 32, device='cpu')
        with pytest.raises(ValueError, match='DiskCachedDataLoader does not support NGram'):
            DiskCachedDataLoader(reader, 32, str(tmp_path / 'cache'), device='cpu')


def test_command_line_prints_the_examples_lines(tmp_path):
    """``python -m petastorm_tpu_torch.ngram_sensor`` prints what
    ``tests/test_examples_smoke.py::test_ngram_sensor`` expects of the JAX
    example, and the example's first line."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.ngram_sensor',
                           '--dataset-url', 'file://' + str(tmp_path / 'ngram'),
                           '--device', 'cpu'],
                          env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines == ['window batch: history (32, 2, 32) velocity (32, 3) -> (32,)', 'done']

"""The port's resident tier (``petastorm_tpu_torch.gpu.residency``) and its
``ResidentDataLoader`` against the JAX package's, on the CPU.

The same store is read through each package's reader (dummy pool, no
row-group shuffle; the JAX side with FIFO scheduling, no ingest plane and
no native decode) and both loaders get the same seed and arguments.  Epoch
orders, wire plans, delivered batches (values and dtypes), the residency
counters and gauges after each pass, and resume tokens must be equal
exactly: streamed, served warm, under the kill switch, under a budget that
cannot hold the dataset, and with the tier dropped mid-epoch.  The cases of
``tests/test_residency.py`` that this slice covers are ported beside them,
with the tier's provenance outcomes and decision records (the doctor cases
wait for the doctor).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

import petastorm_tpu.native
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.jax import ResidentDataLoader as JaxResidentDataLoader
from petastorm_tpu.jax import residency as jax_residency
from petastorm_tpu.telemetry import MetricsRegistry as JaxMetricsRegistry

from petastorm_tpu_torch import codecs, random, unischema
from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
from petastorm_tpu_torch.gpu import ResidentDataLoader, residency
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry

ROWS = 60     # 3 full batches of 16 and a ragged tail of 12
BATCH = 16


def _schema():
    return unischema.Unischema('ResidencySchema', [
        unischema.UnischemaField('id', np.int64, (), codecs.ScalarCodec(pa.int64()), False),
        unischema.UnischemaField('image', np.uint8, (4, 4, 3), codecs.NdarrayCodec(), False),
        unischema.UnischemaField('feat', np.float32, (4,), codecs.NdarrayCodec(), False),
        unischema.UnischemaField('weight', np.float64, (), codecs.ScalarCodec(pa.float64()),
                                 False),
        unischema.UnischemaField('name', np.str_, (), codecs.ScalarCodec(pa.string()), False),
    ])


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    url = 'file://%s/ds' % tmp_path_factory.mktemp('torch_residency')
    rng = np.random.default_rng(0)
    with DatasetWriter(url, _schema(), rows_per_rowgroup=8) as writer:
        for i in range(ROWS):
            writer.write({'id': np.int64(i),
                          'image': rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
                          'feat': rng.normal(0, 3, 4).astype(np.float32),
                          # bf16 rounding of a float64 goes through float32
                          'weight': np.float64(1 + 2 ** -8 + 2 ** -30) if i == 5
                          else np.float64(rng.normal()),
                          'name': 'n%d' % i})
    return url


def _jax_loader(url, **kwargs):
    reader = jax_make_reader(url, reader_pool_type='dummy', scheduling='fifo', ingest='off',
                             columnar_decode=True, num_epochs=1, shuffle_row_groups=False)
    return JaxResidentDataLoader(reader, kwargs.pop('batch_size', BATCH), **kwargs)


def _port_loader(url, **kwargs):
    reader = make_reader(url, reader_pool_type='dummy', columnar_decode=True, num_epochs=1,
                         shuffle_row_groups=False)
    return ResidentDataLoader(reader, kwargs.pop('batch_size', BATCH), device='cpu', **kwargs)


def _host(batch):
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            for k, v in batch.items()}


def _pull(loader, passes=1):
    """Every batch of ``passes`` passes, and the residency counters and gauges
    after each pass."""
    batches, stats = [], []
    with petastorm_tpu.native.disabled(), loader:
        for _ in range(passes):
            batches.extend(_host(b) for b in loader)
            stats.append(_stats(loader))
    return batches, stats


def _stats(loader):
    snap = loader.metrics.snapshot()
    return dict(loader.residency_stats,
                **{name: snap['gauges'][name] for name in residency.GAUGE_NAMES})


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.fixture
def no_kill(monkeypatch):
    monkeypatch.delenv(residency.KILL_SWITCH, raising=False)
    return monkeypatch


# -- 1. epoch orders ----------------------------------------------------------------

SEEDS = [0, 7, 2 ** 31 - 1, 2 ** 32 + 3]


@pytest.mark.parametrize('data', [0, 1, 3, 2 ** 31, 2 ** 32 - 1])
@pytest.mark.parametrize('seed', SEEDS)
def test_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = random.fold_in(random.PRNGKey(seed), data)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_fold_in_known_value_and_key_low_word():
    np.testing.assert_array_equal(random.fold_in(random.PRNGKey(7), 3), [276534068, 1641862660])
    np.testing.assert_array_equal(random.PRNGKey(2 ** 32 + 3), [0, 3])
    np.testing.assert_array_equal(random.PRNGKey(2 ** 32 + 3),
                                  np.asarray(jax.random.PRNGKey(2 ** 32 + 3)))


@pytest.mark.parametrize('n', [1, 1009, 1 << 20])
@pytest.mark.parametrize('seed', SEEDS)
def test_epoch_permutation_matches_jax(seed, n):
    for epoch in range(4):
        np.testing.assert_array_equal(residency.epoch_key(seed, epoch),
                                      np.asarray(jax_residency.epoch_key(seed, epoch)))
        want = np.asarray(jax_residency.epoch_permutation(seed, epoch, n))
        got = residency.epoch_permutation(seed, epoch, n)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_epoch_permutation_is_pure_function_of_seed_and_epoch():
    a = residency.epoch_permutation(7, 3, 32)
    np.testing.assert_array_equal(a, residency.epoch_permutation(7, 3, 32))
    assert sorted(a.tolist()) == list(range(32))
    assert not np.array_equal(a, residency.epoch_permutation(7, 4, 32))
    assert not np.array_equal(a, residency.epoch_permutation(8, 3, 32))


@pytest.mark.parametrize('shuffle', [True, False])
def test_loader_epoch_orders_equal_jax_as_int64(url, shuffle):
    with petastorm_tpu.native.disabled():
        jax_loader = _jax_loader(url, seed=11, shuffle=shuffle)
        port = _port_loader(url, seed=11, shuffle=shuffle)
        iter(jax_loader), iter(port)   # fixes the seed of the epoch orders
        for epoch in range(4):
            want = np.asarray(jax_loader._epoch_order(epoch, ROWS))
            got = port._epoch_order(epoch, ROWS)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
            if not shuffle:
                np.testing.assert_array_equal(got, np.arange(ROWS))
        jax_loader.__exit__(None, None, None)
        port.__exit__(None, None, None)


# -- 2. the wire plan -------------------------------------------------------------------

def _tree():
    return {'image': (np.arange(12 * 8, dtype=np.int64) % 251).astype(np.uint8).reshape(12, 8),
            'feat': np.linspace(-2.0, 2.0, 12 * 4, dtype=np.float32).reshape(12, 4),
            'id': np.arange(12, dtype=np.int64)}


def _wide_tree():
    tree = _tree()
    tree.update(f64=np.array([1 + 2 ** -8 + 2 ** -30, -3.75, 1e30, 2 ** -130] * 3, np.float64),
                flag=np.arange(12) % 3 == 0,
                u16=np.arange(12, dtype=np.uint16).reshape(12, 1) * 5000,
                half=np.linspace(-1, 1, 12, dtype=np.float16))
    return tree


def _np_name(dtype):
    """A torch dtype's numpy name (bfloat16's too)."""
    return str(dtype).replace('torch.', '')


POLICIES = {'auto': 'auto', 'none': None,
            'dict': {'feat': 'float16', 'f64': 'bfloat16', 'id': 'int16', 'u16': 'uint8'}}


@pytest.mark.parametrize('policy', sorted(POLICIES))
def test_wire_plan_and_round_trip_equal_jax(policy):
    tree, policy = _wide_tree(), POLICIES[policy]
    want = jax_residency.wire_plan(tree, policy)
    got = residency.wire_plan(tree, policy)
    assert list(got.fields) == list(want.fields) == sorted(tree)
    for name, f in want.fields.items():
        assert _np_name(got.fields[name].wire) == np.dtype(f.wire).name, name
        assert _np_name(got.fields[name].out) == np.dtype(f.out).name, name
        assert got.fields[name].row_shape == f.row_shape
    assert (got.wire_row_nbytes, got.logical_row_nbytes, got.narrowed) == \
        (want.wire_row_nbytes, want.logical_row_nbytes, want.narrowed)
    assert residency.estimate_budget(tree, policy) == jax_residency.estimate_budget(tree, policy)
    jax_out = want.widen({k: jax.device_put(v) for k, v in want.narrow(tree).items()})
    port_out = got.widen(got.narrow(tree))
    for name in tree:
        assert port_out[name].dtype != torch.bfloat16
        w = np.asarray(jax_out[name])
        g = port_out[name].numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('policy', sorted(POLICIES))
def test_narrow_gathers_rows_into_one_aligned_buffer(policy):
    tree = _wide_tree()
    plan = residency.wire_plan(tree, POLICIES[policy])
    idx = np.array([7, 0, 11, 3, 3])
    wire = plan.narrow(tree, idx)
    want = plan.narrow({k: v[idx] for k, v in tree.items()})
    buf = wire.buffer
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    for name, t in wire.items():
        assert t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        assert (t.storage_offset() * t.element_size()) % 64 == 0
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name
    assert plan.to_device(wire, 'cpu') is wire
    # what the card gets: the buffer copied once, cut into the same views
    moved = residency.WirePlan.to_device(wire, 'meta')
    for name, t in wire.items():
        assert moved[name].device.type == 'meta'
        assert (moved[name].dtype, moved[name].shape) == (t.dtype, t.shape)
        assert moved[name].storage_offset() == t.storage_offset()


def test_float64_narrows_to_bfloat16_through_float32():
    plan = residency.wire_plan({'x': np.zeros(2, np.float64)}, 'auto')
    out = plan.widen(plan.narrow({'x': np.array([1 + 2 ** -8 + 2 ** -30, 1.0])}))['x']
    assert out.dtype == torch.float32 and out.tolist() == [1.0, 1.0]


@pytest.mark.parametrize('tree', [
    {},
    {'ok': np.zeros((4, 2), np.float32), 'when': np.zeros(4, dtype='datetime64[s]')},
    {'z': np.zeros(4, np.complex64)},
    {'scalar': np.float32(3.0)},
], ids=['empty', 'datetime', 'complex', 'no_rows_axis'])
def test_wire_plan_none_where_jax_gives_none(tree):
    assert jax_residency.wire_plan(tree, 'auto') is None
    assert residency.wire_plan(tree, 'auto') is None
    assert residency.estimate_budget(tree) is None


def test_wire_plan_none_for_an_unsupported_wire_dtype():
    tree = {'id': np.arange(4, dtype=np.int64)}
    assert jax_residency.wire_plan(tree, {'id': 'complex64'}) is None
    assert residency.wire_plan(tree, {'id': 'complex64'}) is None


def test_widen_uint8_and_int_exact():
    tree = _tree()
    plan = residency.wire_plan(tree, 'auto')
    assert plan is not None and plan.narrowed
    out = plan.widen(plan.narrow(tree))
    np.testing.assert_array_equal(out['image'].numpy(), tree['image'])
    # int64 travels and arrives as int32, exactly
    np.testing.assert_array_equal(out['id'].numpy(), tree['id'].astype(np.int32))
    assert out['image'].dtype == torch.uint8 and out['id'].dtype == torch.int32


def test_widen_bf16_error_bounded():
    tree = _tree()
    plan = residency.wire_plan(tree, 'auto')
    assert plan.fields['feat'].wire == torch.bfloat16
    feat = plan.widen(plan.narrow(tree))['feat'].numpy()
    assert feat.dtype == np.float32
    err = np.max(np.abs(feat - tree['feat']) / np.maximum(np.abs(tree['feat']), 1e-6))
    assert err <= 1.0 / 256.0
    assert np.abs(feat - tree['feat']).max() > 0   # it did narrow


def test_wire_plan_no_policy_is_passthrough():
    plan = residency.wire_plan(_tree(), None)
    assert plan is not None and not plan.narrowed
    wire = plan.narrow(_tree())
    assert plan.widen(wire) is wire


def test_estimate_budget_math():
    est = residency.estimate_budget(_tree(), 'auto')
    # image 8 u8 + feat 4 x (4 -> 2) + id (8 -> 4): wire 20, logical 28
    assert est['wire_bytes_per_row'] == 20
    assert est['logical_bytes_per_row'] == 28
    assert est['narrowed'] and 1.0 < est['hbm_ratio'] < 2.0


# -- 4 and 6. the tier ---------------------------------------------------------------

def _counters():
    return residency.ensure_counters(MetricsRegistry('test_residency'))


def _admit(tier, plan, tree, start, rows):
    ids = np.arange(start, start + rows)
    return tier.admit(ids, plan.narrow({k: v[start:start + rows] for k, v in tree.items()}))


def test_tier_admit_gather_roundtrip():
    tree = _tree()
    plan = residency.wire_plan(tree, 'auto')
    tier = residency.ResidencyTier(plan, 12, 4, None, _counters())
    assert tier.slabs is None   # allocated at the first admission
    for start in (0, 4, 8):
        assert _admit(tier, plan, tree, start, 4) == 'admitted'
    assert tier.fully_resident and tier.serving_ok()
    for name, f in plan.fields.items():
        assert tier.slabs[name].shape == (12,) + f.row_shape
        assert tier.slabs[name].dtype == f.wire
    order = torch.from_numpy(residency.epoch_permutation(0, 1, 12).astype(np.int64))
    onp = order.numpy()
    batch = tier.gather(order, 4)
    np.testing.assert_array_equal(batch['image'].numpy(), tree['image'][onp[4:8]])
    np.testing.assert_array_equal(batch['id'].numpy(), tree['id'][onp[4:8]].astype(np.int32))
    tail = tier.gather_tail(order, 10)
    np.testing.assert_array_equal(tail['image'].numpy(), tree['image'][onp[10:]])


def test_tier_writes_in_place_and_copies_the_slot_map_only_after_a_change():
    tree = _tree()
    plan = residency.wire_plan(tree, 'auto')
    tier = residency.ResidencyTier(plan, 12, 4, 8 * plan.wire_row_nbytes, _counters())
    _admit(tier, plan, tree, 0, 4)
    ptrs = {k: v.data_ptr() for k, v in tier.slabs.items()}
    _admit(tier, plan, tree, 4, 4)
    _admit(tier, plan, tree, 8, 4)   # evicts rows 0-3 and reuses their range
    assert {k: v.data_ptr() for k, v in tier.slabs.items()} == ptrs
    np.testing.assert_array_equal(tier.slabs['image'][:4].numpy(), tree['image'][8:12])
    first = tier._slot_map()
    assert tier._slot_map() is first
    assert _admit(tier, plan, tree, 8, 4) == 'admitted'   # resident already: nothing written
    assert tier._slot_map() is first
    _admit(tier, plan, tree, 0, 4)
    assert tier._slot_map() is not first


def test_tier_lru_eviction_under_tight_budget():
    tree = _tree()
    plan = residency.wire_plan(tree, 'auto')
    c = _counters()
    tier = residency.ResidencyTier(plan, 12, 4, 8 * plan.wire_row_nbytes, c)
    assert tier.capacity_rows == 8 and not tier.can_hold_dataset
    assert _admit(tier, plan, tree, 0, 4) == 'admitted'
    assert _admit(tier, plan, tree, 4, 4) == 'admitted'
    assert _admit(tier, plan, tree, 8, 4) == 'evicted'
    assert (int(c.admitted.value), int(c.evictions.value), int(c.thrash.value)) == (3, 1, 1)
    assert not tier.fully_resident and tier.resident_rows == 8
    big = residency.ResidencyTier(plan, 12, 4, 2 * plan.wire_row_nbytes, c)
    assert _admit(big, plan, tree, 0, 4) == 'bypass'


def test_tier_drop_releases_and_stops_serving():
    tree = _tree()
    plan = residency.wire_plan(tree, 'auto')
    c = _counters()
    tier = residency.ResidencyTier(plan, 12, 4, None, c)
    for start in (0, 4, 8):
        _admit(tier, plan, tree, start, 4)
    assert tier.serving_ok()
    tier.drop()
    assert not tier.serving_ok() and not tier.fully_resident and tier.slabs is None
    assert int(c.rows.value) == 0 and int(c.bytes.value) == 0
    assert int(c.evictions.value) == 3   # the live entries
    tier.drop()
    assert _admit(tier, plan, tree, 0, 4) == 'bypass'


def _jax_counters():
    return jax_residency.ensure_counters(JaxMetricsRegistry('test_residency'))


def _values(c):
    return [int(x.value) for x in (c.admitted, c.evictions, c.hits, c.bypass, c.thrash,
                                   c.rows, c.bytes, c.budget)]


@pytest.mark.parametrize('budget_rows', [None, 12, 8, 6, 3])
def test_tier_bookkeeping_equals_jax(budget_rows):
    """One admission sequence (batches of 4 and the ragged 2, re-sights,
    rows admitted again elsewhere) through both tiers: every outcome,
    counter, gauge and slot map equal, and the gathers equal."""
    tree = dict(_tree(), id=np.arange(12, dtype=np.int64))
    want_plan = jax_residency.wire_plan(tree, 'auto')
    plan = residency.wire_plan(tree, 'auto')
    budget = None if budget_rows is None else budget_rows * plan.wire_row_nbytes
    jc, c = _jax_counters(), _counters()
    jax_tier = jax_residency.ResidencyTier(want_plan, 12, 4, budget, jc)
    tier = residency.ResidencyTier(plan, 12, 4, budget, c)
    sequence = [(0, 4), (4, 4), (8, 4), (0, 4), (10, 2), (2, 4), (4, 4), (6, 4), (0, 2)]
    for start, rows in sequence:
        ids = np.arange(start, start + rows)
        rows_of = {k: v[start:start + rows] for k, v in tree.items()}
        want = jax_tier.admit(ids, {k: jax.device_put(v)
                                    for k, v in want_plan.narrow(rows_of).items()})
        assert tier.admit(ids, plan.narrow(rows_of)) == want, (start, rows)
        assert _values(c) == _values(jc)
        np.testing.assert_array_equal(tier._slot_of_row, jax_tier._slot_of_row)
        assert tier.resident_rows == jax_tier.resident_rows
        assert tier.fully_resident == jax_tier.fully_resident
    if tier.fully_resident:
        order = residency.epoch_permutation(3, 1, 12)
        got = tier.gather(torch.from_numpy(order.astype(np.int64)), 4)
        want = jax_tier.gather(jnp.asarray(order), 4)
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    tier.drop()
    jax_tier.drop()
    assert _values(c) == _values(jc)


@pytest.mark.parametrize('seed', range(6))
def test_tier_random_admissions_equal_jax(seed):
    """Random batches (overlapping, of mixed sizes) under a random budget:
    the same outcomes, counters, gauges and slot map as the JAX tier."""
    rng = np.random.default_rng(seed)
    tree = dict(_tree(), id=np.arange(12, dtype=np.int64))
    want_plan, plan = jax_residency.wire_plan(tree, 'auto'), residency.wire_plan(tree, 'auto')
    budget = int(rng.integers(3, 13)) * plan.wire_row_nbytes
    jc, c = _jax_counters(), _counters()
    jax_tier = jax_residency.ResidencyTier(want_plan, 12, 4, budget, jc)
    tier = residency.ResidencyTier(plan, 12, 4, budget, c)
    for _ in range(40):
        ids = rng.permutation(12)[:int(rng.integers(1, 5))]
        rows_of = {k: v[ids] for k, v in tree.items()}
        want = jax_tier.admit(ids, {k: jax.device_put(v)
                                    for k, v in want_plan.narrow(rows_of).items()})
        assert tier.admit(ids, plan.narrow(rows_of)) == want
        assert _values(c) == _values(jc)
        np.testing.assert_array_equal(tier._slot_of_row, jax_tier._slot_of_row)
        assert tier.resident_rows == int((tier._slot_of_row >= 0).sum())
        held = tier._slot_of_row >= 0
        for k in tree:   # every resident row's slot holds its wire bytes
            got = tier.slabs[k][torch.from_numpy(tier._slot_of_row[held].astype(np.int64))]
            np.testing.assert_array_equal(got.to(plan.fields[k].out).numpy(),
                                          np.asarray(plan.widen(plan.narrow(
                                              {k2: tree[k2][held] for k2 in tree}))[k]))


def test_tier_admissions_and_a_drop_from_many_threads():
    """The transfer thread admits while the training thread may drop: 24
    threads admit random batches under a tight budget, with the interpreter
    switching threads every microsecond, and one drops the tier midway.  No
    update is lost: every call is counted once, the resident count is the
    slot map's, and every admission after the drop bypasses."""
    import sys
    import threading
    tree = {'x': np.arange(64 * 3, dtype=np.float32).reshape(64, 3),
            'y': np.arange(64, dtype=np.int64)}
    plan = residency.wire_plan(tree, 'auto')
    c = _counters()
    tier = residency.ResidencyTier(plan, 64, 4, 24 * plan.wire_row_nbytes, c)
    outcomes, dropped = [], threading.Event()

    def admit(seed):
        rng = np.random.default_rng(seed)
        for i in range(60):
            ids = rng.permutation(64)[:4]
            # read before the call: an admission that returned just before
            # the drop may be recorded after it
            after = dropped.is_set()
            out = tier.admit(ids, plan.narrow(tree, ids))
            outcomes.append((out, after))
            if seed == 0 and i == 30:
                tier.drop()
                dropped.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=admit, args=(s,)) for s in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(outcomes) == 24 * 60   # a thread that raised left calls out
    count = {k: sum(1 for out, _ in outcomes if out == k)
             for k in ('admitted', 'evicted', 'bypass')}
    assert int(c.bypass.value) == count['bypass'] and int(c.thrash.value) == count['evicted']
    # 'admitted' is also the answer for rows resident already, which writes nothing
    assert count['evicted'] <= int(c.admitted.value) <= count['admitted'] + count['evicted']
    assert all(out == 'bypass' for out, after in outcomes if after)
    assert tier.dropped and tier.resident_rows == int((tier._slot_of_row >= 0).sum()) == 0
    assert int(c.rows.value) == 0


# -- 3, 4. the loader's batches and bookkeeping against JAX ---------------------------

WIRE = {'auto': 'auto', 'none': None, 'dict': {'feat': 'float16', 'weight': 'bfloat16'}}


@pytest.mark.parametrize('killed', [False, True])
@pytest.mark.parametrize('drop_last', [True, False])
@pytest.mark.parametrize('wire', sorted(WIRE))
def test_loader_equals_jax(url, monkeypatch, wire, drop_last, killed):
    """Three epochs, then a second pass over the same loader: the same
    batches (dtypes included), counters and gauges after each pass."""
    if killed:
        monkeypatch.setenv(residency.KILL_SWITCH, '1')
    else:
        monkeypatch.delenv(residency.KILL_SWITCH, raising=False)
    kwargs = dict(num_epochs=3, seed=7, wire_dtypes=WIRE[wire], drop_last=drop_last)
    want, want_stats = _pull(_jax_loader(url, **kwargs), passes=2)
    got, got_stats = _pull(_port_loader(url, **kwargs), passes=2)
    _assert_same(got, want)
    assert got_stats == want_stats
    per_epoch = ROWS // BATCH if drop_last else -(-ROWS // BATCH)
    assert len(got) == 2 * 3 * per_epoch
    _assert_same(got[:3 * per_epoch], got[3 * per_epoch:])   # the second pass replays
    assert 'name' not in got[0] and got[0]['id'].dtype == np.int32
    if killed:
        assert got_stats[-1]['host_batches'] == 6 * per_epoch
        assert got_stats[-1]['admitted'] == got_stats[-1]['hits'] == 0
    else:
        # epoch 0 of the first pass streams; everything after is warm
        assert got_stats[0]['host_batches'] == per_epoch
        assert got_stats[-1]['hits'] == 5 * per_epoch
        assert got_stats[-1]['residency_rows'] == ROWS
    if wire == 'auto':
        assert got[0]['weight'].dtype == np.float32 and got[0]['feat'].dtype == np.float32


@pytest.mark.parametrize('budget_rows', [0, 20, 36, 48])
def test_loader_under_a_budget_equals_jax(url, no_kill, budget_rows):
    """A budget below the dataset: every epoch streams, the LRU churns (the
    cases of ``test_tight_budget_streams_every_epoch`` and
    ``test_partial_budget_evicts_and_never_serves_warm``)."""
    plan = residency.wire_plan(_first_rows(url), 'auto')
    budget = max(1, budget_rows * plan.wire_row_nbytes)
    kwargs = dict(num_epochs=3, seed=5, hbm_budget_bytes=budget, drop_last=False)
    want, want_stats = _pull(_jax_loader(url, **kwargs))
    got, got_stats = _pull(_port_loader(url, **kwargs))
    _assert_same(got, want)
    assert got_stats == want_stats
    stats = got_stats[-1]
    assert stats['hits'] == 0 and stats['host_batches'] == 12
    reference, _ = _pull(_port_loader(url, num_epochs=3, seed=5, drop_last=False))
    _assert_same(got, reference)
    if budget_rows >= BATCH:
        assert stats['evictions'] > 0
        # at 48 rows the ragged 12 never finds a range of its size: its
        # admissions evict everything and still bypass, with no thrash
        assert (stats['thrash'] > 0) == (budget_rows < 48)
    else:
        assert stats['bypass'] == 12 and stats['admitted'] == 0


def _first_rows(url):
    with make_reader(url, reader_pool_type='dummy', columnar_decode=True, num_epochs=1,
                     schema_fields=['id', 'image', 'feat', 'weight']) as reader:
        return next(iter(reader))._asdict()


@pytest.mark.parametrize('cut', [5, 6, 7])
def test_drop_tier_mid_epoch_equals_jax(url, no_kill, cut):
    """The tier dropped inside a warm epoch: the rest of the pass streams,
    the same batches as an uninterrupted run and the JAX loader's, and the
    same counters."""
    def run(loader):
        got = []
        with petastorm_tpu.native.disabled(), loader:
            it = iter(loader)
            for _ in range(cut):
                got.append(_host(next(it)))
            loader.drop_resident_tier()
            got.extend(_host(b) for b in it)
            return got, _stats(loader)

    kwargs = dict(num_epochs=3, seed=3, drop_last=False)
    want, want_stats = run(_jax_loader(url, **kwargs))
    got, got_stats = run(_port_loader(url, **kwargs))
    _assert_same(got, want)
    assert got_stats == want_stats
    reference, _ = _pull(_port_loader(url, **kwargs))
    _assert_same(got, reference)
    assert got_stats['hits'] == cut - 4
    assert got_stats['bypass'] == 12 - cut
    assert got_stats['evictions'] == 4 and got_stats['residency_rows'] == 0


@pytest.mark.parametrize('budget_rows', [None, 36])
def test_records_and_decisions_equal_jax(url, no_kill, budget_rows):
    """Each delivered batch's provenance record carries the tier's outcome
    (``admitted``/``evicted`` streamed, ``hit`` warm, ``bypass``), and each
    admission that allocates, each bypass and the drop at exit is a
    ``residency`` record of the process's decision journal: the same
    outcomes step by step and the same records (action, rule, inputs,
    slot) as the JAX loader's, and every record replays to its action."""
    from petastorm_tpu.telemetry import decisions as jax_decisions
    from petastorm_tpu_torch.telemetry import decisions
    no_kill.delenv('PETASTORM_TPU_NO_PROVENANCE', raising=False)
    no_kill.delenv(decisions.KILL_SWITCH, raising=False)
    plan = residency.wire_plan(_first_rows(url), 'auto')
    budget = None if budget_rows is None else budget_rows * plan.wire_row_nbytes
    kwargs = dict(num_epochs=2, seed=5, hbm_budget_bytes=budget, drop_last=False)
    runs = {}
    for name, make, module in (('port', _port_loader, decisions),
                               ('jax', _jax_loader, jax_decisions)):
        journal = module.default_journal()
        before = max((r['seq'] for r in journal.records()), default=-1)
        loader = make(url, **kwargs)
        _pull(loader)
        records = loader.provenance.records()
        made = [(r['actor'], r['action'], r['rule'], r['inputs'], r['suppressed'],
                 r.get('slot')) for r in journal.records()
                if r['seq'] > before and r['actor'] == 'residency']
        replays = [module.replay_decision(r)['verdict'] for r in journal.records()
                   if r['seq'] > before and r['actor'] == 'residency']
        runs[name] = ([r.get('residency') for r in records], [r['step'] for r in records],
                      made, replays)
    assert runs['port'] == runs['jax']
    outcomes, steps, made, replays = runs['port']
    assert steps == list(range(8))
    if budget_rows is None:
        assert outcomes == ['admitted'] * 4 + ['hit'] * 4
    else:
        assert 'evicted' in outcomes and 'hit' not in outcomes
    assert made and {m[1] for m in made} <= {'admitted', 'evicted', 'bypass', 'drop'}
    assert 'match' in replays and set(replays) <= {'match', 'unchecked'}


def test_resident_epochs_bit_identical_to_streamed(url, monkeypatch):
    monkeypatch.delenv(residency.KILL_SWITCH, raising=False)
    ldr = _port_loader(url, num_epochs=3, seed=7, wire_dtypes=None)
    resident, _ = _pull(ldr)
    stats = ldr.residency_stats
    monkeypatch.setenv(residency.KILL_SWITCH, '1')
    killed, _ = _pull(_port_loader(url, num_epochs=3, seed=7, wire_dtypes=None))
    _assert_same(resident, killed)
    assert len(resident) == 9
    assert stats['host_batches'] == 3 and stats['hits'] == 6
    # drop_last never streams the tail: the backfill admits it
    assert stats['admitted'] == 4 and stats['evictions'] == 0


def test_kill_switch_counters_keep_full_shape(url, monkeypatch):
    monkeypatch.setenv(residency.KILL_SWITCH, '1')
    ldr = _port_loader(url, num_epochs=2, seed=1)
    _pull(ldr)
    assert ldr.residency_stats == {'admitted': 0, 'evictions': 0, 'hits': 0, 'bypass': 0,
                                   'thrash': 0, 'host_batches': 6}
    assert ldr.tier is None
    snap = ldr.metrics.snapshot()
    for name in residency.COUNTER_NAMES:
        assert name in snap['counters']
    for name in residency.GAUGE_NAMES:
        assert name in snap['gauges'] and name in ldr.metrics.as_dict()


def test_kill_switch_keeps_wire_narrowing(url, monkeypatch):
    monkeypatch.delenv(residency.KILL_SWITCH, raising=False)
    on_ldr = _port_loader(url, num_epochs=2, seed=4, wire_dtypes='auto')
    on, _ = _pull(on_ldr)
    assert on_ldr._plan is not None and on_ldr._plan.narrowed
    monkeypatch.setenv(residency.KILL_SWITCH, '1')
    off, _ = _pull(_port_loader(url, num_epochs=2, seed=4, wire_dtypes='auto'))
    _assert_same(on, off)
    full, _ = _pull(_port_loader(url, num_epochs=2, seed=4, wire_dtypes=None))
    assert not np.array_equal(on[0]['feat'], full[0]['feat'])


def test_narrowed_warm_epoch_matches_cold(url, no_kill):
    ldr = _port_loader(url, num_epochs=2, shuffle=False, wire_dtypes='auto')
    batches, _ = _pull(ldr)
    _assert_same(batches[:3], batches[3:])
    assert ldr.residency_stats['hits'] == 3
    assert ldr._plan is not None and ldr._plan.narrowed


def test_shuffle_covers_all_rows_and_varies_by_epoch(url, no_kill):
    batches, _ = _pull(_port_loader(url, num_epochs=2, seed=11, drop_last=False))
    e0 = np.concatenate([b['id'] for b in batches[:4]])
    e1 = np.concatenate([b['id'] for b in batches[4:]])
    assert sorted(e0.tolist()) == sorted(e1.tolist()) == list(range(ROWS))
    assert not np.array_equal(e0, e1)


def test_unseeded_loader_replays_its_epochs(url, no_kill):
    ldr = _port_loader(url, num_epochs=2)
    batches, _ = _pull(ldr, passes=2)
    _assert_same(batches[:6], batches[6:])


def test_plan_none_streams_full_width_like_jax(url, no_kill):
    """A wire dtype outside the matrix: no plan, no tier; every epoch streams
    at the device dtypes, as the JAX loader's ``device_put`` gives them."""
    kwargs = dict(num_epochs=2, seed=2, wire_dtypes={'id': 'complex64'})
    want, want_stats = _pull(_jax_loader(url, **kwargs))
    port = _port_loader(url, **kwargs)
    got, got_stats = _pull(port)
    _assert_same(got, want)
    assert got_stats == want_stats and port._plan is None and port.tier is None
    assert got[0]['weight'].dtype == np.float32 and got[0]['id'].dtype == np.int32


def test_constructor_refusals(url):
    with make_reader(url, reader_pool_type='dummy', columnar_decode=True) as reader:
        for kwargs in (dict(transform_fn=lambda b: b), dict(shuffling_queue_capacity=20)):
            with pytest.raises(ValueError, match='ResidentDataLoader does not support'):
                ResidentDataLoader(reader, BATCH, device='cpu', **kwargs)
        with pytest.raises(ValueError, match='wire_dtypes'):
            ResidentDataLoader(reader, BATCH, device='cpu', wire_dtypes='bf16')
        with pytest.raises(ValueError, match='echo'):
            ResidentDataLoader(reader, BATCH, device='cpu', echo=2)
        with pytest.raises(ValueError, match="'resident'"):
            ResidentDataLoader(reader, BATCH, device='cpu',
                               resume_state={'version': 1, 'device_inmem': {}})


# -- 5. resume tokens ---------------------------------------------------------------

def _token_after(loader, k):
    with petastorm_tpu.native.disabled(), loader:
        it = iter(loader)
        for _ in range(k):
            next(it)
        return loader.state_dict()


@pytest.mark.parametrize('k', [0, 1, 3, 4, 6, 11, 12])
@pytest.mark.parametrize('drop_last', [True, False])
def test_token_equals_jax_after_k_batches(url, no_kill, k, drop_last):
    kwargs = dict(num_epochs=3, seed=9, drop_last=drop_last, deterministic_cache_order=True)
    k = min(k, 9 if drop_last else 12)
    want = _token_after(_jax_loader(url, **kwargs), k)
    got = _token_after(_port_loader(url, **kwargs), k)
    assert got == want
    assert sorted(got['resident']) == ['batch_size', 'drop_last', 'epochs_done', 'seed',
                                       'steps_into_epoch']


@pytest.mark.parametrize('k', [2, 3, 4, 6])
def test_jax_token_resumes_the_port(url, no_kill, k):
    kwargs = dict(num_epochs=3, seed=9, deterministic_cache_order=True, drop_last=False)
    token = _token_after(_jax_loader(url, **kwargs), k)
    want, want_stats = _pull(_jax_loader(url, resume_state=token, **kwargs))
    got, got_stats = _pull(_port_loader(url, resume_state=token, **kwargs))
    _assert_same(got, want)
    assert got_stats == want_stats
    reference, _ = _pull(_port_loader(url, **kwargs))
    _assert_same(got, reference[k:])


def test_resume_token_mid_epoch_and_warm_restart(url, no_kill):
    kwargs = dict(num_epochs=3, seed=9, wire_dtypes=None, deterministic_cache_order=True)
    reference, _ = _pull(_port_loader(url, **kwargs))
    first = _port_loader(url, **kwargs)
    got = []
    with first:
        it = iter(first)
        for _ in range(5):   # into epoch 1, two warm batches deep
            got.append(_host(next(it)))
        token = first.state_dict()
    second = _port_loader(url, resume_state=token, **kwargs)
    rest, _ = _pull(second)
    got.extend(rest)
    _assert_same(got, reference)
    # epoch 1's rest streamed (an empty tier), the backfill filled it, and
    # epoch 2 was served warm
    assert second.residency_stats['hits'] == 3


def _refusal(factory):
    with pytest.raises(ValueError) as err:
        factory()
    return str(err.value)


def test_refusals_word_for_word(url, no_kill):
    """Each refusal of the JAX loader, with the same message."""
    det = dict(deterministic_cache_order=True)
    mid = _token_after(_jax_loader(url, num_epochs=3, seed=9, **det), 2)
    cases = [
        # a token taken with another seed, and none at all
        lambda mk: mk(url, num_epochs=3, seed=10, resume_state=mid, **det),
        lambda mk: mk(url, num_epochs=3, resume_state=mid, **det),
        # another batch size mid-epoch
        lambda mk: mk(url, num_epochs=3, seed=9, batch_size=8, resume_state=mid, **det),
        # a mid-epoch token without the canonical cache order
        lambda mk: mk(url, num_epochs=3, seed=9, resume_state=mid),
        # a cursor past the epoch's steps
        lambda mk: list(mk(url, num_epochs=3, seed=9, resume_state=dict(
            mid, resident=dict(mid['resident'], steps_into_epoch=5)), **det)),
        # a token of an unseeded loader
        lambda mk: _token_after(mk(url, num_epochs=3), 1),
        # a mid-epoch token of a loader without the canonical cache order
        lambda mk: _token_after(mk(url, num_epochs=3, seed=9), 1),
    ]
    for case in cases:
        with petastorm_tpu.native.disabled():
            want = _refusal(lambda: case(_jax_loader))
        got = _refusal(lambda: case(_port_loader))
        assert got == want


def test_token_at_a_boundary_needs_no_canonical_order(url, no_kill):
    token = _token_after(_port_loader(url, num_epochs=3, seed=9), 3)
    assert token['resident']['epochs_done'] == 1 and token['resident']['steps_into_epoch'] == 0
    batches, _ = _pull(_port_loader(url, num_epochs=3, seed=9, resume_state=token))
    assert len(batches) == 6

"""The port's cache plane (``petastorm_tpu_torch.cache_plane``), its
local-disk cache and the readers' ``cache_type`` against the JAX package's,
on the CPU.

Against JAX: an entry encoded by either package decodes in the other to
equal values, and equal values encode to equal bytes; ``dataset_fingerprint``
and ``spec_token`` are JAX's for the same files, columns, predicate and a
transform defined here; both readers under ``cache_type='plane'`` and
``'local-disk'`` deliver a second epoch equal to the first and to JAX's
reader under the same cache, the second served from the cache.  The port
alone: a hit is read-only views (and a loader over them copies, with no
warning), single-flight holds across two processes, a SIGKILLed writer's
residue is swept, and a full plane decodes directly.
"""

import os
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.cache_plane import dataset_fingerprint as jax_dataset_fingerprint
from petastorm_tpu.cache_plane import spec_token as jax_spec_token
from petastorm_tpu.cache_plane.plane import decode_entry as jax_decode_entry
from petastorm_tpu.cache_plane.plane import encode_entry as jax_encode_entry
from petastorm_tpu.fs_utils import get_filesystem_and_path_or_paths as jax_fs
from petastorm_tpu.predicates import in_set as jax_in_set
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec

from petastorm_tpu_torch import make_batch_reader
from petastorm_tpu_torch.cache_plane import CachePlane, dataset_fingerprint, spec_token, \
    sweep_residue
from petastorm_tpu_torch.cache_plane.plane import ENTRY_SUFFIX, decode_entry, encode_entry
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
from petastorm_tpu_torch.gpu import DataLoader
from petastorm_tpu_torch.predicates import in_set
from petastorm_tpu_torch.transform import TransformSpec

from torch_plane_common import jax_reader, port_reader, write_dataset
from torch_service_common import drop_hot_tiers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 48   # 6 row groups of 8


@pytest.fixture(autouse=True)
def _no_hot_tier_left(tmp_path):
    yield
    drop_hot_tiers(tmp_path)


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    return write_dataset('file://%s' % tmp_path_factory.mktemp('torch_plane_ds'), rows=ROWS)


def _double(row):
    row['decimal_like'] = row['decimal_like'] * 2
    return row


# -- entries and fingerprints --------------------------------------------------

_VALUES = {
    'columns': lambda: {'a': np.arange(6, dtype=np.float32).reshape(2, 3),
                        'b': np.array(['x', None], dtype=object),
                        'c': np.arange(5, dtype=np.int64), 'empty': np.zeros((0, 4), np.uint8)},
    'arrow': lambda: pa.table({'x': [1, 2, 3], 's': ['a', 'b', None]}),
    'pickle': lambda: [{'r': 1, 'v': np.arange(3)}],
    'none': lambda: None,
}


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and list(a.ravel()) == list(b.ravel())
    if isinstance(a, pa.Table):
        return a.equals(b)
    return a == b


@pytest.mark.parametrize('kind', sorted(_VALUES))
def test_entries_cross_between_the_packages(kind):
    value = _VALUES[kind]()
    ours, ref = bytes(encode_entry(value)), bytes(jax_encode_entry(value))
    assert ours == ref
    assert _equal(decode_entry(ref), value) and _equal(jax_decode_entry(ours), value)


def test_fingerprints_equal_jax(url, tmp_path):
    fs, path = get_filesystem_and_path_or_paths(url)
    jfs, _ = jax_fs(url)
    files = [os.path.join(path, f) for f in os.listdir(path) if f.endswith('.parquet')]
    assert dataset_fingerprint(fs, files) == jax_dataset_fingerprint(jfs, files)
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema
    schema = get_schema(fs, path)
    from petastorm_tpu.etl.dataset_metadata import get_schema as jax_get_schema
    jschema = jax_get_schema(jfs, path)
    view, jview = (s.create_schema_view(['id', 'matrix', 'decimal_like'])
                   for s in (schema, jschema))
    for args, jargs in (
            ((), ()),
            ((view,), (jview,)),
            ((view, in_set({1, 5, 9}, 'id')), (jview, jax_in_set({1, 5, 9}, 'id'))),
            ((view, None, TransformSpec(_double)), (jview, None, JaxTransformSpec(_double))),
            ((view, None, TransformSpec(_double, removed_fields=['matrix'])),
             (jview, None, JaxTransformSpec(_double, removed_fields=['matrix'])))):
        assert spec_token(*args) == jax_spec_token(*jargs)
    assert spec_token(view) != spec_token(view, None, TransformSpec(_double))
    os.utime(files[0], (1, 1))
    assert dataset_fingerprint(fs, files) == jax_dataset_fingerprint(jfs, files)


# -- the readers ---------------------------------------------------------------

def _epoch(factory, url, cache_type, where, **kwargs):
    kwargs.update(cache_type=cache_type, cache_location=where)
    if factory == 'make_reader':
        reader = port_reader(url, True, **kwargs)
    else:
        reader = make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                                   **kwargs)
    with reader:
        chunks = [{k: np.array(v) for k, v in c._asdict().items()} for c in reader]
    stats = {k: v for k, v in reader.diagnostics.items() if k in ('cache_hits', 'cache_misses')}
    return chunks, stats


def _jax_epoch(factory, url, cache_type, where):
    kwargs = dict(cache_type=cache_type, cache_location=where)
    if factory == 'make_reader':
        reader = jax_reader(url, True, **kwargs)
    else:
        reader = jax_make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                                       scheduling='fifo', ingest='off', **kwargs)
    with reader:
        return [{k: np.array(v) for k, v in c._asdict().items()} for c in reader]


@pytest.mark.parametrize('cache_type', ['plane', 'local-disk'])
@pytest.mark.parametrize('factory', ['make_reader', 'make_batch_reader'])
def test_a_cached_epoch_equals_the_first_and_jax(url, tmp_path, factory, cache_type):
    where = str(tmp_path / 'port_cache')
    first, cold = _epoch(factory, url, cache_type, where)
    second, warm = _epoch(factory, url, cache_type, where)
    want = _jax_epoch(factory, url, cache_type, str(tmp_path / 'jax_cache'))
    again = _jax_epoch(factory, url, cache_type, str(tmp_path / 'jax_cache'))
    assert len(first) == len(second) == len(want) == len(again) == ROWS // 8
    for got in (first, second):
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert all(_equal(w, a) for w, a in zip(want, again))
    assert cold == {'cache_hits': 0, 'cache_misses': 6}
    assert warm == {'cache_hits': 6, 'cache_misses': 0}


def test_a_loader_over_plane_hits_copies_them(url, tmp_path):
    """A hit is read-only views of a mapping; the loader's batches are its
    own memory, equal to the first epoch's, with no warning on the way."""
    where = str(tmp_path / 'plane')
    epochs = []
    for _ in range(2):
        reader = port_reader(url, True, cache_type='plane', cache_location=where,
                             schema_fields=['id', 'image_png', 'matrix', 'embedding'])
        with warnings.catch_warnings():
            warnings.simplefilter('error')
            with DataLoader(reader, batch_size=16, device='cpu') as loader:
                batches = list(loader)
        epochs.append(batches)
        assert all(b['image_png'].is_contiguous() for b in batches)
    for a, b in zip(*epochs):
        for key in a:
            assert a[key].equal(b[key]), key
    batches[0]['matrix'].add_(1.0)   # the loader's own memory: writable
    hit = CachePlane(where).lookup_digest(next(iter(CachePlane(where).held_digests())))
    assert not next(iter(hit.values())).flags.writeable


# -- across processes ----------------------------------------------------------

_FLIGHT_CHILD = r'''
import os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[4])
from petastorm_tpu_torch.cache_plane import CachePlane

plane = CachePlane(sys.argv[1], ram_capacity_bytes=0)

def fill():
    open(os.path.join(sys.argv[2], 'fill.%d' % os.getpid()), 'w').close()
    time.sleep(0.4)   # hold the flight long enough that the other must wait
    return {'x': np.arange(32, dtype=np.int64)}

value = plane.get_or_fill(sys.argv[3], fill)
assert np.array_equal(value['x'], np.arange(32)), value
assert 'torch' not in sys.modules and 'jax' not in sys.modules
print('FILLED' if os.path.exists(os.path.join(sys.argv[2], 'fill.%d' % os.getpid())) else 'HIT')
'''


def _env():
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    return env


def test_single_flight_holds_across_two_processes(tmp_path):
    plane_dir, markers = str(tmp_path / 'p'), str(tmp_path / 'm')
    os.makedirs(markers)
    procs = [subprocess.Popen([sys.executable, '-c', _FLIGHT_CHILD, plane_dir, markers, 'key',
                               REPO], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e.decode()[-800:] for _, e in outs]
    assert len(os.listdir(markers)) == 1
    assert sorted(o.decode().strip() for o, _ in outs) == ['FILLED', 'HIT']


_KILL_CHILD = r'''
import fcntl, os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[2])
from petastorm_tpu_torch.cache_plane import CachePlane
from petastorm_tpu_torch.cache_plane.plane import encode_entry

plane = CachePlane(sys.argv[1])
plane.get_or_fill('survivor', lambda: {'x': np.arange(16)})
blob = bytes(encode_entry({'x': np.zeros(4096)}))
for tier in [t for t in (plane.ram, plane.disk) if t is not None]:
    fd = os.open(os.path.join(tier.root, '.tmp.%d.dead' % os.getpid()),
                 os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    fcntl.flock(fd, fcntl.LOCK_SH | fcntl.LOCK_NB)
    os.write(fd, blob[:100])   # a publish cut short, its fd held until the kill
fcntl.flock(os.open(os.path.join(plane.disk.root, plane.digest('wedged') + '.lock'),
                    os.O_CREAT | os.O_RDWR), fcntl.LOCK_EX)
print('READY', flush=True)
time.sleep(120)
'''


def test_a_sigkilled_writers_residue_is_swept(tmp_path):
    plane_dir = str(tmp_path / 'p')
    child = subprocess.Popen([sys.executable, '-c', _KILL_CHILD, plane_dir, REPO], env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        assert child.stdout.readline().strip() == b'READY', child.stderr.read().decode()[-800:]
    finally:
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=30)
    plane = CachePlane(plane_dir)   # its construction sweeps both tiers
    roots = [t.root for t in (plane.ram, plane.disk) if t is not None]
    assert isinstance(sweep_residue(plane_dir), dict)
    for root in roots:
        assert not [f for f in os.listdir(root) if f.startswith('.tmp.')], root
    np.testing.assert_array_equal(plane.get_or_fill('survivor', lambda: 'MISS')['x'],
                                  np.arange(16))
    t0 = time.monotonic()
    assert plane.get_or_fill('wedged', lambda: 'fresh') == 'fresh'   # the lock died with it
    assert time.monotonic() - t0 < 5.0
    plane.clear()


def test_a_full_plane_decodes_directly(tmp_path):
    plane = CachePlane(str(tmp_path / 'p'), disk_capacity_bytes=64, ram_capacity_bytes=0)
    t0 = time.monotonic()
    for i in range(5):
        assert plane.get_or_fill('k%d' % i, lambda i=i: {'x': np.full(4096, i)})['x'][0] == i
    assert time.monotonic() - t0 < 5.0
    assert plane.degraded == 5 and plane.misses == 5
    assert not [f for f in os.listdir(plane.disk.root) if f.endswith(ENTRY_SUFFIX)]
    lru = CachePlane(str(tmp_path / 'lru'), disk_capacity_bytes=300_000, ram_capacity_bytes=0)
    for i in range(10):
        lru.get_or_fill('key%d' % i, lambda: {'x': np.zeros(10_000)})
    assert lru.evictions > 0 and isinstance(lru.get_or_fill('key9', lambda: 'EVICTED'), dict)

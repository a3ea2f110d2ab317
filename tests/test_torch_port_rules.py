"""Rules the port keeps: it imports nothing of JAX or of the JAX package, its
entry points run on the card unless asked for the CPU, and its kernels
never fall back to another implementation."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, 'petastorm_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'petastorm_tpu', 'petastorm')


def _port_sources():
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PACKAGE):
        paths.extend(os.path.join(root, f) for f in files if f.endswith('.py'))
    return sorted(paths)


def _imported_modules(tree):
    """Every module an ``import``/``from`` statement or an
    ``importlib.import_module``/``__import__`` call with a literal names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and (getattr(node.func, 'attr', None) == 'import_module'
                     or getattr(node.func, 'id', None) == '__import__'):
            yield node.args[0].value


def test_port_imports_nothing_of_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    for module in ('native.py', 'train_transform.py', 'workers_pool/process_pool.py',
                   'workers_pool/process_worker.py', 'workers_pool/shm_plane.py',
                   'workers_pool/exec_in_new_process.py', 'reader_impl/pickle_serializer.py',
                   'reader_impl/arrow_table_serializer.py', 'gpu/transfer.py', 'gpu/loader.py',
                   'telemetry/__init__.py', 'telemetry/registry.py', 'telemetry/spans.py',
                   'benchmark/trace.py', 'benchmark/advisor.py', 'benchmark/stall_profiler.py',
                   'train.py', 'train_mnist.py', 'checkpoint.py', 'models/mlp.py',
                   'reader_impl/shuffling_buffer.py', 'arrow_reader_worker.py', 'predicates.py',
                   'etl/rowgroup_filtering.py', 'models/dlrm.py', 'optim.py', 'train_dlrm.py',
                   'hello_world.py', 'spark/spark_dataset_converter.py',
                   'spark/converter_example.py', 'ngram.py', 'ngram_sensor.py',
                   'gpu/residency.py', 'random.py', 'parallel/__init__.py', 'parallel/mesh.py',
                   'parallel/ring_attention.py', 'elastic.py', 'service/__init__.py',
                   'service/backoff.py', 'service/config.py', 'service/dispatcher.py',
                   'service/worker.py', 'service/client.py', 'service/tenancy.py',
                   'service/ledger.py', 'service/cluster.py', 'cache_plane/__init__.py',
                   'cache_plane/fingerprint.py', 'cache_plane/plane.py',
                   'local_disk_cache.py'):
        assert os.path.join(PACKAGE, module) in sources, module
    offenders = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for module in _imported_modules(tree):
            if module.split('.')[0] in FORBIDDEN:
                offenders.append('%s: %s' % (os.path.relpath(path, REPO), module))
    assert not offenders, offenders


def test_training_on_cpu_never_loads_jax(tmp_path):
    """ViT and ResNet-50 training on the CPU, streaming and from the epoch
    cache, and the MNIST example with a checkpoint and a resume, load nothing
    of JAX (nor orbax, nor optax)."""
    script = textwrap.dedent('''
        import sys
        import numpy as np, pyarrow as pa
        import petastorm_tpu_torch
        from petastorm_tpu_torch import codecs, unischema
        from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
        schema = unischema.Unischema('S', [
            unischema.UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(pa.string()), False),
            unischema.UnischemaField('image', np.uint8, (None, None, 3),
                                     codecs.CompressedImageCodec('jpeg'), False)])
        url = 'file://' + sys.argv[1]
        rng = np.random.default_rng(0)
        with DatasetWriter(url, schema, rows_per_rowgroup=4) as w:
            for i in range(12):
                w.write({'noun_id': 'n%d' % i,
                         'image': rng.integers(0, 256, (32, 40 if i % 2 else 32, 3),
                                               dtype=np.uint8)})
        # (losses expected, train kwargs): streaming runs take exactly the
        # steps asked for; the HBM cache runs whole epochs, and one epoch of
        # 12 rows at batch 4 is 3 steps.
        runs = [(2, dict(model_name='vit', model_kwargs=dict(num_layers=1, d_model=32,
                                                             num_heads=2, d_ff=64))),
                (2, dict(model_name='resnet50')),
                (3, dict(model_name='resnet50', hbm_cache=True))]
        for expected, kwargs in runs:
            result = petastorm_tpu_torch.train(url, steps=2, batch_size=4, image_hw=(32, 32),
                                               device='cpu', **kwargs)
            assert len(result['losses']) == expected and all(np.isfinite(result['losses'])), \
                result
            assert result['batch_devices'] == ['cpu']
        from petastorm_tpu_torch import train_mnist
        mnist = train_mnist.write_mnist_dataset(url + '_mnist', 256)
        ckpt = sys.argv[1] + '_ckpt'
        cut = train_mnist.train(mnist, epochs=1, device='cpu', checkpoint_dir=ckpt,
                                save_every=1, stop_after_step=0)
        rest = train_mnist.train(mnist, epochs=1, device='cpu', checkpoint_dir=ckpt)
        assert (cut['steps_run'], rest['resumed_at'], rest['steps_run']) == (1, 0, 1), rest
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ds')], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_pumped_disk_cached_traced_training_on_cpu(tmp_path):
    """The example's last flags on the CPU: ``train`` streaming through the
    pumped loader (``transfer=True``) from a decoded disk cache (built, then
    read with no reader) with a trace, and ``--scan-steps``: nothing of JAX
    is loaded, no transfer thread outlives a run, and the trace holds the
    monitor's ``data_wait``, the loader's ``host_batch`` and the plane's
    ``h2d/stage`` spans, the loader's on the transfer thread."""
    script = textwrap.dedent('''
        import json, sys, threading
        import numpy as np, pyarrow as pa
        import petastorm_tpu_torch
        from petastorm_tpu_torch import codecs, unischema
        from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
        schema = unischema.Unischema('S', [
            unischema.UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(pa.string()), False),
            unischema.UnischemaField('image', np.uint8, (None, None, 3),
                                     codecs.CompressedImageCodec('jpeg'), False)])
        root = sys.argv[1]
        url = 'file://' + root + '/ds'
        rng = np.random.default_rng(0)
        with DatasetWriter(url, schema, rows_per_rowgroup=4) as w:
            for i in range(12):
                w.write({'noun_id': 'n%d' % i,
                         'image': rng.integers(0, 256, (32, 40 if i % 2 else 32, 3),
                                               dtype=np.uint8)})
        vit = dict(model_name='vit', model_kwargs=dict(num_layers=1, d_model=32, num_heads=2,
                                                       d_ff=64))
        cache = root + '/cache'
        for i, extra in enumerate([dict(decoded_cache_dir=cache), dict(decoded_cache_dir=cache),
                                   dict(scan_steps=2)]):
            trace = root + '/trace%d.json' % i
            result = petastorm_tpu_torch.train(url, steps=4, batch_size=4, image_hw=(32, 32),
                                               device='cpu', transfer=True, trace_path=trace,
                                               **dict(vit, **extra))
            assert len(result['losses']) == 4 and all(np.isfinite(result['losses'])), result
            assert result['report'].startswith('pipeline regime: ')
            # a batch per put streaming, a chunk of two per put with scan_steps=2
            assert result['loader_metrics']['h2d_batches'] >= (2 if i == 2 else 4), \
                result['loader_metrics']
            assert petastorm_tpu_torch.DiskCachedDataLoader.cache_complete(cache)
            events = json.load(open(trace))['traceEvents']
            assert result['trace_events'] == len(events)
            tids = {}
            for e in events:
                tids.setdefault(e['name'], set()).add(e['tid'])
            want = {'host_batch', 'h2d/stage'} | ({'data_wait'} if i < 2 else set())
            assert want <= set(tids), sorted(tids)
            if i < 2:
                assert not (tids['host_batch'] | tids['h2d/stage']) & tids['data_wait']
                assert result['stall_top_component'] is not None
            left = [t.name for t in threading.enumerate() if t.name.endswith('h2d-dispatch')]
            assert not left, left
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_decode_workers_load_neither_torch_nor_jax(tmp_path):
    """What a process-pool child imports and unpickles (its main loop, the
    reader's worker and its arguments, the image example's transform, the
    native plane) loads neither torch nor JAX."""
    import pickle
    from petastorm_tpu_torch.py_dict_reader_worker import PyDictReaderWorker, RowWorkerArgs
    from petastorm_tpu_torch.train import make_transform
    from petastorm_tpu_torch.transform import ResizeImages
    from petastorm_tpu_torch.workers_pool.process_worker import worker_main
    payload = tmp_path / 'payload.pkl'
    payload.write_bytes(pickle.dumps(
        (worker_main, PyDictReaderWorker,
         RowWorkerArgs(pieces=[], schema_view=None, transform_spec=make_transform((32, 32))),
         ResizeImages({'image': (8, 8)}))))
    script = textwrap.dedent('''
        import pickle, sys
        import petastorm_tpu_torch.py_dict_reader_worker
        import petastorm_tpu_torch.workers_pool.process_worker
        from petastorm_tpu_torch import native
        with open(sys.argv[1], 'rb') as f:
            worker_main, worker, args, resize = pickle.load(f)
        assert args.transform_spec.func({'image': __import__('numpy').zeros((4, 4, 3), 'uint8'),
                                         'noun_id': 'n0'})['image'].shape == (32, 32, 3)
        native.capabilities()
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN + ('torch',))
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(payload)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_a_service_worker_reads_a_split_loading_neither_torch_nor_jax(tmp_path):
    """A data-service worker process (the worker module, the service package,
    its config and dispatcher) reads a split through ``piece_indices``, on
    the thread pool, and serializes its chunks, with neither torch nor JAX
    in ``sys.modules``."""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from torch_plane_common import write_dataset
    url = write_dataset('file://%s' % (tmp_path / 'ds'), rows=32)
    script = textwrap.dedent('''
        import queue, sys
        import petastorm_tpu_torch.service
        from petastorm_tpu_torch.service.config import ServiceConfig
        from petastorm_tpu_torch.service.dispatcher import Dispatcher
        from petastorm_tpu_torch.service.worker import Worker, deserialize_chunk
        job = ServiceConfig(sys.argv[1], reader_kwargs={'workers_count': 2}).job_info(2)
        assert Dispatcher(ServiceConfig(sys.argv[1]))._num_pieces == 4
        decode_in, decode_out = queue.Queue(), queue.Queue()
        decode_in.put({'split_id': 1, 'indices': [2, 3], 'consumer': 0, 'attempt': 0})
        decode_in.put(None)
        Worker('tcp://127.0.0.1:1')._decode_loop(job, decode_in, decode_out)
        items = [decode_out.get_nowait() for _ in range(decode_out.qsize())]
        assert [i[0] for i in items] == ['chunk', 'chunk', 'end'] and items[-1][3] == 16, items
        ids = [int(v) for i in items[:2] for v in deserialize_chunk(*i[3:5])['id']]
        assert sorted(ids) == list(range(16, 32)), ids
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN + ('torch',))
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, url], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_the_shared_fleets_worker_side_loads_neither_torch_nor_jax(tmp_path):
    """What a worker process of a shared fleet imports and runs (the worker
    with a cache plane of its own and the cluster cache's state, the
    ledger, tenancy, a dispatcher restored from a ledger) leaves neither
    torch nor JAX in ``sys.modules``."""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from torch_plane_common import write_dataset
    url = write_dataset('file://%s' % (tmp_path / 'ds'), rows=32)
    script = textwrap.dedent('''
        import queue, sys
        import petastorm_tpu_torch.service
        from petastorm_tpu_torch.service import cluster, tenancy
        from petastorm_tpu_torch.service.config import ServiceConfig
        from petastorm_tpu_torch.service.dispatcher import Dispatcher
        from petastorm_tpu_torch.service.ledger import DispatcherLedger
        from petastorm_tpu_torch.service.worker import Worker
        url, tmp = sys.argv[1], sys.argv[2]
        config = ServiceConfig(url, cache_plane=True, cache_plane_dir=tmp + '/plane',
                               ledger_path=tmp + '/ledger.json', tenant_shm_quota_bytes=1)
        job = config.job_info(2)
        state = cluster.ClusterWorkerState(job)
        assert state.wait_ready(60) and state.identity.num_pieces == 4
        worker = Worker('tcp://127.0.0.1:1', cache_plane_dir=tmp + '/plane')
        decode_in, decode_out = queue.Queue(), queue.Queue()
        for _ in range(2):   # a miss, then a hit
            decode_in.put({'split_id': 1, 'indices': [2, 3], 'consumer': 0, 'attempt': 0,
                           'tenant': 'default'})
        decode_in.put(None)
        worker._decode_loop(job, decode_in, decode_out)
        items = [decode_out.get_nowait() for _ in range(decode_out.qsize())]
        assert [i[0] for i in items].count('end') == 2, items
        assert worker.diagnostics['cache_hits'] == 2 and worker.diagnostics['cache_misses'] == 2
        assert state.identity.missing_digests([2, 3]) == []
        dispatcher = Dispatcher(config)
        dispatcher._ledger.release()
        assert Dispatcher(config).ledger_restores == 1
        assert tenancy.QuotaLedger().charge('t', 1)
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN + ('torch',))
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, url, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=120)
    from torch_service_common import drop_hot_tiers
    drop_hot_tiers(tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_batch_path_on_cpu_never_loads_jax(tmp_path):
    """The Criteo trainer (streaming and ``--scan-steps``, with the process
    pool's batch workers), both hello-world flows and the converter example
    on the CPU load nothing of JAX, flax or optax."""
    script = textwrap.dedent('''
        import sys
        import numpy as np
        from petastorm_tpu_torch import hello_world, train_dlrm
        from petastorm_tpu_torch.spark import converter_example
        root = sys.argv[1]
        url = train_dlrm.generate_criteo_parquet('file://' + root + '/criteo', rows_count=1024,
                                                 rows_per_group=256)
        for scan in (0, 2):
            result = train_dlrm.train(url, batch_size=128, scan_steps=scan, device='cpu',
                                      reader_kwargs=dict(reader_pool_type='process',
                                                         workers_count=2))
            assert len(result['losses']) == 8 and np.isfinite(result['losses']).all(), result
        out = hello_world.main(['--root', root, '--device', 'cpu'])
        assert len(out['petastorm']) == 2 and len(out['external']) == 4
        result = converter_example.main(['--device', 'cpu', '--parent-cache-dir-url',
                                         'file://' + root + '/cache'])
        assert result['steps'] == 16
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_batch_decode_workers_load_neither_torch_nor_jax(tmp_path):
    """What a process-pool child of ``make_batch_reader`` imports and
    unpickles (the batch worker, its arguments with an inferred schema, a
    predicate and a pandas transform, the row-group filters) loads neither
    torch nor JAX; and a batch reader on the process pool delivers."""
    import pickle
    import pyarrow as pa
    from petastorm_tpu_torch.arrow_reader_worker import ArrowReaderWorker, BatchWorkerArgs
    from petastorm_tpu_torch.predicates import in_set
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.transform import TransformSpec
    from petastorm_tpu_torch.unischema import Unischema
    from petastorm_tpu_torch.workers_pool.process_worker import worker_main
    schema = Unischema.from_arrow_schema(pa.schema([('a', pa.int64()),
                                                    ('b', pa.list_(pa.float32()))]))
    payload = tmp_path / 'payload.pkl'
    payload.write_bytes(pickle.dumps(
        (worker_main, ArrowReaderWorker,
         BatchWorkerArgs(pieces=[], schema_view=schema, predicate=in_set({1}, 'a'),
                         transform_spec=TransformSpec(removed_fields=['b'])))))
    script = textwrap.dedent('''
        import pickle, sys
        import petastorm_tpu_torch.arrow_reader_worker
        import petastorm_tpu_torch.etl.rowgroup_filtering
        import petastorm_tpu_torch.workers_pool.process_worker
        with open(sys.argv[1], 'rb') as f:
            worker_main, worker, args = pickle.load(f)
        assert worker.DATAFRAME_TRANSFORM and args.predicate.do_include({'a': 1})
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN + ('torch',))
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(payload)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout
    import pyarrow.parquet as pq
    (tmp_path / 'ds').mkdir()
    pq.write_table(pa.table({'a': list(range(40))}), str(tmp_path / 'ds' / 'data.parquet'),
                   row_group_size=10)
    with make_batch_reader('file://%s' % (tmp_path / 'ds'), reader_pool_type='process',
                           workers_count=2, predicate=in_set({1, 15}, 'a')) as reader:
        assert sorted(int(v) for b in reader for v in b.a) == [1, 15]


def test_ngram_path_on_cpu_never_loads_jax(tmp_path):
    """The NGram sensor example on the CPU (its command line's ``main``,
    then the loader over the process pool, pumped, and a footer of upstream
    petastorm's) loads nothing of JAX, flax, optax or the JAX package."""
    script = textwrap.dedent('''
        import base64, sys
        from petastorm_tpu_torch import ngram_sensor
        from petastorm_tpu_torch.etl import dataset_metadata
        url = 'file://' + sys.argv[1]
        result = ngram_sensor.main(url, device='cpu')
        assert (result['batches'], result['windows']) == (18, 576), result
        again = ngram_sensor.run(url, device='cpu', verbose=False,
                                 reader_kwargs=dict(reader_pool_type='process', workers_count=2),
                                 loader_kwargs=dict(transfer=True, echo=2))
        assert (again['batches'], again['windows']) == (36, 1152), again
        with open(sys.argv[2]) as f:
            schema = dataset_metadata._loads_schema(base64.b64decode(f.read()))
        assert schema.name == 'RefSchema'
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    fixture = os.path.join(REPO, 'tests', 'data', 'reference_unischema_footer.b64')
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ngram'), fixture],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_ngram_decode_workers_load_neither_torch_nor_jax(tmp_path):
    """What a process-pool child of an NGram reader unpickles (the row
    worker and its arguments with a resolved ``NGram``) loads neither torch
    nor JAX, and forms the windows there."""
    import pickle
    from petastorm_tpu_torch.ngram_sensor import SensorSchema, make_ngram
    from petastorm_tpu_torch.py_dict_reader_worker import PyDictReaderWorker, RowWorkerArgs
    from petastorm_tpu_torch.workers_pool.process_worker import worker_main
    ngram = make_ngram()
    ngram.resolve_regex_field_names(SensorSchema)
    payload = tmp_path / 'payload.pkl'
    payload.write_bytes(pickle.dumps(
        (worker_main, PyDictReaderWorker,
         RowWorkerArgs(pieces=[], schema_view=SensorSchema, ngram=ngram))))
    script = textwrap.dedent('''
        import pickle, sys
        import numpy as np
        import petastorm_tpu_torch.py_dict_reader_worker
        import petastorm_tpu_torch.workers_pool.process_worker
        with open(sys.argv[1], 'rb') as f:
            worker_main, worker, args = pickle.load(f)
        rows = [{'timestamp': np.int64(t), 'lidar': np.zeros(32, np.float32),
                 'velocity': np.zeros(3, np.float32)} for t in (1, 2, 3, 50, 51)]
        windows = args.ngram.form_sequences(rows, args.schema_view)
        assert len(windows) == 1 and sorted(windows[0]) == [-2, -1, 0]
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN + ('torch',))
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(payload)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_process_pool_training_on_cpu_equals_the_thread_pools(tmp_path):
    """ViT (one layer) trained 2 steps on the CPU with the process pool
    gives the thread pool's losses, one worker each (one data order), under
    one PYTHONHASHSEED for the parent and its children (the example's label
    is ``hash(noun_id) % 1000``); its batches came through ``/dev/shm``,
    and no slab or child is left behind."""
    script = textwrap.dedent('''
        import sys
        import numpy as np, pyarrow as pa
        import petastorm_tpu_torch
        from petastorm_tpu_torch import codecs, unischema
        from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
        from petastorm_tpu_torch.workers_pool import shm_plane
        schema = unischema.Unischema('S', [
            unischema.UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(pa.string()),
                                     False),
            unischema.UnischemaField('image', np.uint8, (None, None, 3),
                                     codecs.CompressedImageCodec('png'), False)])
        url = 'file://' + sys.argv[1]
        rng = np.random.default_rng(0)
        with DatasetWriter(url, schema, rows_per_rowgroup=12) as w:
            for i in range(24):
                w.write({'noun_id': 'n%d' % i,
                         'image': rng.integers(0, 256, (32, 40 if i % 2 else 32, 3),
                                               dtype=np.uint8)})
        results = {}
        for pool in ('thread', 'process'):
            results[pool] = petastorm_tpu_torch.train(
                url, steps=2, batch_size=4, image_hw=(32, 32), device='cpu', model_name='vit',
                model_kwargs=dict(num_layers=1), reader_pool_type=pool, workers_count=1)
        print('LOSSES', results['thread']['losses'], results['process']['losses'])
        assert results['thread']['losses'] == results['process']['losses']
        thread_diag = results['thread']['reader_diagnostics']
        assert thread_diag['pool'] == 'thread' and 'shm_results' not in thread_diag
        diag = results['process']['reader_diagnostics']
        assert diag['shm_results'] > 0, diag
        assert shm_plane.residue(diag['worker_pids']) == set()
    ''')
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED='0')
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ds')], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lm_training_and_sampling_on_cpu_never_load_jax(tmp_path):
    """The LM paths on the CPU (long-context training, packed training
    with dense and flash attention, KV-cache sampling) load nothing of
    JAX: the same subprocess check, in a process of its own."""
    script = textwrap.dedent('''
        import sys
        import numpy as np
        import petastorm_tpu_torch.train_lm as lm
        url = 'file://' + sys.argv[1]
        small = dict(d_model=32, num_heads=4, num_layers=1, d_ff=64)
        lm.LONG_CONTEXT_LM.update(small)
        lm.PACKED_LM.update(small)
        lm.write_token_dataset(url + '_tokens', num_docs=8)
        result = lm.train_lm(url + '_tokens', steps=2, batch_size=2, device='cpu')
        assert len(result['losses']) == 2 and all(np.isfinite(result['losses'])), result
        assert result['batch_devices'] == ['cpu']
        lm.write_var_token_dataset(url + '_var_tokens', num_docs=16)
        for attn in ('dense', 'flash'):
            result = lm.train_packed(url + '_var_tokens', steps=2, attn=attn, device='cpu')
            assert len(result['losses']) == 2 and all(np.isfinite(result['losses'])), result
            assert result['step_ms'] > 0 and result['step_tokens_per_s'] > 0, result
            assert result['batch_devices'] == ['cpu'] and 0 < result['packing_utilization'] <= 1
        prompt, tokens = lm.sample(result['model'], max_new=4)
        assert prompt.shape == (2, 8) and tuple(tokens.shape) == (2, 4)
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ds')], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_a_two_rank_ring_step_never_loads_jax(tmp_path):
    """Two spawned ranks of a gloo group run a ring-attention step, forward
    and backward, and load nothing of JAX (each rank is a fresh process)."""
    from torch_dist_ranks import run_ranks
    for modules in run_ranks(tmp_path, 2, 'ring_step_imports', {}):
        assert 'petastorm_tpu_torch.parallel.ring_attention' in modules
        assert not [m for m in modules if m.split('.')[0] in FORBIDDEN]


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from petastorm_tpu_torch.gpu import (DataLoader, DeviceInMemDataLoader, InMemDataLoader,
                                         PackedDataLoader, resolve_device)
    from petastorm_tpu_torch.train import main, train
    import petastorm_tpu_torch.train_lm as lm

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')

    class ColumnarReader(object):
        batched_output = True

    for loader in (DataLoader, InMemDataLoader, DeviceInMemDataLoader):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            loader(ColumnarReader(), 4)
        assert loader(ColumnarReader(), 4, device='cpu').device.type == 'cpu'
    for kwargs in (dict(), dict(model_name='resnet50'), dict(model_name='vit'),
                   dict(hbm_cache=True)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            train('file://%s' % tmp_path, steps=1, **kwargs)
    for flags in ([], ['--model', 'vit'], ['--hbm-cache']):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(['--dataset-url', 'file://%s' % tmp_path, '--steps', '1'] + flags)

    class RowReader(object):
        batched_output = False

    with pytest.raises(RuntimeError, match='device="cpu"'):
        PackedDataLoader(RowReader(), 'tokens', 64, 4)
    assert PackedDataLoader(RowReader(), 'tokens', 64, 4, device='cpu').device.type == 'cpu'
    for entry in (lm.train_lm, lm.train_packed):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry('file://%s' % tmp_path, steps=1)
    for flags in ([], ['--packed'], ['--packed', '--strategy', 'flash', '--sample']):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            lm.main(['--dataset-url', 'file://%s' % tmp_path, '--steps', '1'] + flags)


def test_batch_path_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                                       tmp_path):
    from petastorm_tpu_torch import hello_world, make_loader, train_dlrm
    from petastorm_tpu_torch.spark import converter_example
    from petastorm_tpu_torch.spark.spark_dataset_converter import SparkDatasetConverter
    url = hello_world.generate_external_dataset('file://%s' % (tmp_path / 'ext'))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_loader(url, 4)
    with make_loader(url, 4, loader_kwargs=dict(device='cpu')) as loader:
        assert next(iter(loader))['id'].device.type == 'cpu'
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SparkDatasetConverter(url, 100).make_loader(4)
    for entry in (lambda: train_dlrm.train(url), lambda: train_dlrm.main(['--dataset-url', url]),
                  lambda: converter_example.main([]),
                  lambda: hello_world.main(['--root', str(tmp_path), '--flow', 'petastorm'])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry()


def test_resident_loader_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    from petastorm_tpu_torch import ResidentDataLoader as Lazy
    from petastorm_tpu_torch.gpu import ResidentDataLoader

    class ColumnarReader(object):
        batched_output = True

    assert Lazy is ResidentDataLoader
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for kwargs in (dict(), dict(device='cuda'), dict(hbm_budget_bytes=1 << 20, seed=3)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ResidentDataLoader(ColumnarReader(), 4, **kwargs)
    assert ResidentDataLoader(ColumnarReader(), 4, device='cpu').device.type == 'cpu'


def test_resident_loader_on_cpu_never_loads_jax(tmp_path):
    """The resident loader on the CPU (streamed epoch, warm epochs, a tight
    budget, the kill switch, a resume token) loads nothing of JAX or of the
    JAX package."""
    script = textwrap.dedent('''
        import os, sys
        from petastorm_tpu_torch import train_dlrm
        from petastorm_tpu_torch.gpu import ResidentDataLoader, residency
        from petastorm_tpu_torch.reader import make_batch_reader
        url = train_dlrm.generate_criteo_parquet('file://' + sys.argv[1], rows_count=1000,
                                                 rows_per_group=250)

        def loader(**kwargs):
            reader = make_batch_reader(url, workers_count=2, num_epochs=1)
            return ResidentDataLoader(reader, 128, num_epochs=3, seed=5, device='cpu',
                                      deterministic_cache_order=True, **kwargs)

        with loader() as warm:
            first = [b['dense_0'] for b in warm]
        assert warm.residency_stats['hits'] == 14, warm.residency_stats
        with loader(hbm_budget_bytes=100 * 134) as tight:
            assert all((a == b['dense_0']).all() for a, b in zip(first, tight))
        os.environ[residency.KILL_SWITCH] = '1'
        with loader() as killed:
            it = iter(killed)
            assert all((first[i] == next(it)['dense_0']).all() for i in range(9))
            token = killed.state_dict()
        with loader(resume_state=token) as resumed:
            assert all((a == b['dense_0']).all() for a, b in zip(first[9:], resumed))
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
        print('LOADED', loaded)
        sys.exit(1 if loaded else 0)
    ''').replace('FORBIDDEN', repr(FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop('PETASTORM_TPU_NO_RESIDENCY', None)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'criteo')], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_ngram_sensor_needs_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from petastorm_tpu_torch import ngram_sensor
    url = ngram_sensor.generate('file://%s' % (tmp_path / 'ngram'), rows=200)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for entry in (lambda: ngram_sensor.main(url), lambda: ngram_sensor.run(url),
                  lambda: ngram_sensor._cli(['--dataset-url', url])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry()
    assert ngram_sensor.run(url, device='cpu', verbose=False)['batches'] == 6


def test_kernel_wrappers_never_fall_back():
    """No ``try`` anywhere in the kernel module (so nothing catches a failed
    launch), every wrapper launches, each route of each wrapper (tensor
    cores, CUDA cores) reaches its own launch, and nothing in the package
    reaches PyTorch's fused attention or torch.compile."""
    path = os.path.join(PACKAGE, 'ops', 'flash_attention.py')
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    wrappers = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')}
    assert sorted(wrappers) == ['flash_bwd_dkv', 'flash_bwd_dq', 'flash_fwd']
    routes = {'flash_fwd': ['pt_flash_fwd', 'pt_flash_fwd_sm90'],
              'flash_bwd_dq': ['pt_flash_bwd_dq', 'pt_flash_bwd_dq_sm90'],
              'flash_bwd_dkv': ['pt_flash_bwd_dkv', 'pt_flash_bwd_dkv_sm90']}
    for name, fn in wrappers.items():
        launched = sorted(c.args[0].value for c in ast.walk(fn)
                          if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                          and c.func.id == '_launch' and isinstance(c.args[0], ast.Constant))
        assert launched == routes[name], name
    for source in _port_sources():
        if source.endswith('chip_smoke.py'):
            continue   # times one library call as a yardstick, outside the package
        with open(source) as f:
            text = f.read()
        for banned in ('scaled_dot_product_attention', 'torch.compile', 'cudnn_attention'):
            assert banned not in text, (source, banned)
